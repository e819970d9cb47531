"""ham_soft: Strang-split integrator on the extended phase space
(q, p, eps, pi), batched.

Counterpart of ``nbodysimproject_tpu/integrators/hamsoft.py``:

  H_ext = T(p) + V_grav(q, eps) + S_bar(eps) + pi^2/(2 mu)
          + (k/2) (eps - eps*(q))^2

and the Strang step S(h/2) V(h/2) T(h) V(h/2) S(h/2) with the exact
spring rotation and J-capped impulse (S), the gravity and dV/deps kicks
(V) and the drift (T); barrier policies "soft" (wall kicks on pi) and
"reflection" (folds of (eps, pi) around each flow).  Every function
takes a batched state (``(B, N, d)`` bodies, ``(B,)`` scalars) and a
(B,) step ``h``; this is the scan engine that ``integrators/step.py``
drives and that the fused kernels are held against.

(eps*, grad) routing follows the JAX package's ``_esg_vmap_fn``: with
``cfg.fused_eps_grad``, a float32 CUDA batch of at most 16 body slots
goes to the eps kernel (``ops/eps_kernels.py``), everything else to the
autograd evaluation (``ops/eps_model.py::eps_star_and_grad``).  The JAX
gate's ``B % 1024 == 0`` is the TPU tile's; the CUDA kernel takes any B.
The kernel runs all 8 SPH iterations, so on the card the scan's eps*
differs from the CPU route's, which keeps the convergence freeze, by at
most the freeze tolerance (1e-6 relative).
"""

from __future__ import annotations

import torch

from ..ops import eps_model as epsmod
from ..ops import softening as legacy_soft
from ..ops.barrier import barrier_force
from ..ops.forces import dV_d_epsilon, gravitational_force
from ..ops.eps_kernels import MAX_SLOTS, eps_star_and_grad_fused
from ..ops.reflection import reflect_if_needed


def policy_is_soft(cfg) -> bool:
    """barrier_policy resolution (HSI:447-474): "soft" iff
    cfg.use_soft_barrier and not cfg.disable_barrier."""
    return bool(cfg.use_soft_barrier) and not bool(cfg.disable_barrier)


def _barrier_on(cfg) -> bool:
    return policy_is_soft(cfg) and cfg.k_wall > 0.0 \
        and cfg.barrier_exponent >= 2


def _reflecting(cfg) -> bool:
    return not policy_is_soft(cfg) and not cfg.disable_barrier


def sin_cos_stable(theta):
    """Taylor-stabilised sin/cos for |theta| < 1e-8
    (hamsoft_flows.py:575-585)."""
    th2 = theta * theta
    th3 = th2 * theta
    th4 = th2 * th2
    th5 = th4 * theta
    s_ser = theta - th3 / 6.0 + th5 / 120.0
    c_ser = 1.0 - th2 / 2.0 + th4 / 24.0
    small = torch.abs(theta) < 1.0e-8
    return (torch.where(small, s_ser, torch.sin(theta)),
            torch.where(small, c_ser, torch.cos(theta)))


def eps_target(state, dyn, cfg, q=None):
    """eps* (B,) honouring the fixed/legacy/production mode selection
    (hamsoft_eps_model.py:78-91)."""
    q = state.pos if q is None else q
    if cfg.fixed_eps_star:
        v = cfg.eps_star_value
        if v is not None and v == v:
            return torch.full(q.shape[:-2], float(v), dtype=q.dtype,
                              device=q.device)
        return dyn.s0
    if cfg.use_legacy_eps_star:
        return legacy_soft.eps_target(q, lam=cfg.lambda_softening,
                                      mask=state.mask)
    return epsmod.eps_target_production(
        q, state.mass, h0=state.eps, alpha=dyn.alpha_run,
        eps_min=dyn.min_softening, eps_max=dyn.max_softening, eta=cfg.eta,
        clamp=policy_is_soft(cfg), mask=state.mask)


def uses_eps_kernel(q, cfg) -> bool:
    """Whether the scan sends (eps*, grad) of ``q`` to the eps kernel."""
    return (bool(cfg.fused_eps_grad) and q.device.type == "cuda"
            and q.dtype == torch.float32 and q.dim() == 3
            and q.shape[-2] <= MAX_SLOTS)


def eps_star_and_grad(state, dyn, cfg, q=None):
    """(eps*, grad) for the spring flow: the production target
    unconditionally, as the reference's ``EpsilonModel.eps_star_and_grad``
    (hamsoft_eps_model.py:94-234) does.  The "reference" gradient mode
    takes the degeneracy fallback on both routes."""
    q = state.pos if q is None else q
    kwargs = dict(eta=cfg.eta, clamp=policy_is_soft(cfg),
                  lam_align=cfg.lambda_softening,
                  use_fallback=(cfg.eps_grad_mode == "reference"))
    if uses_eps_kernel(q, cfg):
        return eps_star_and_grad_fused(
            q, state.mass, state.eps, dyn.alpha_run, dyn.min_softening,
            dyn.max_softening, state.mask, **kwargs)
    return epsmod.eps_star_and_grad(
        q, state.mass, h0=state.eps, alpha=dyn.alpha_run,
        eps_min=dyn.min_softening, eps_max=dyn.max_softening, mask=state.mask,
        **kwargs)


def grad_eps_target(state, dyn, cfg, q=None):
    """HSI._grad_eps_target (HSI:665-745): the Omega-corrected SPH
    gradient, sign-aligned against the legacy gradient."""
    q = state.pos if q is None else q
    return epsmod.aligned_omega_grad(
        q, state.mass, h0=state.eps, alpha=dyn.alpha_run,
        eps_min=dyn.min_softening, eps_max=dyn.max_softening, eta=cfg.eta,
        lam_align=cfg.lambda_softening, mask=state.mask)


def _bar_force(cfg, dyn, eps):
    return barrier_force(eps, dyn.min_softening, dyn.max_softening,
                         k_wall=dyn.k_wall, n=cfg.barrier_exponent)


def _fold(cfg, dyn, eps, pi):
    """Reflection fold used around flows when policy == reflection
    (hamsoft_barrier_controller.py:27-69 with h = 0)."""
    return reflect_if_needed(eps, pi, dyn.min_softening, dyn.max_softening)


def _row_max_norm(x, mask=None):
    """max over bodies of |x_i| (B,), 0 on masked bodies."""
    r2 = (x * x).sum(-1)
    pos = r2 > 0.0
    r = torch.where(pos, torch.sqrt(torch.where(pos, r2, torch.ones_like(r2))),
                    torch.zeros_like(r2))
    if mask is not None:
        r = torch.where(mask, r, torch.zeros_like(r))
    return r.amax(-1)


def _with_eps(state, e, p):
    return state.replace(eps=e, pi=p, s=e, step_s2=e * e)


def spring_half(state, dyn, cfg, h, es_grad=None):
    """S(h/2): exact harmonic rotation + J-capped momentum impulse
    (hamsoft_flows.py:427-759 via hamsoft_stepper.py:47-133)."""
    out, _cache = spring_half_cached(state, dyn, cfg, h, es_grad)
    return out


def spring_half_cached(state, dyn, cfg, h, es_grad=None):
    """spring_half returning (state, (eps*, grad)); a given ``es_grad``
    (the evaluation at the same positions) skips the SPH solve."""
    refl = _reflecting(cfg)
    eps0, pi0 = state.eps, state.pi
    if refl:
        eps0, pi0 = _fold(cfg, dyn, eps0, pi0)  # s_half pre-fold (:107-117)

    if cfg.freeze_s_subsystem:
        return _with_eps(state, eps0, pi0), es_grad

    dt_f = 0.5 * h
    p = state.mass[..., None] * state.vel
    if es_grad is None:
        eps_star, grad = eps_star_and_grad(state, dyn, cfg)
    else:
        eps_star, grad = es_grad

    one, zero = torch.ones_like(eps0), torch.zeros_like(eps0)
    mu = dyn.mu_soft
    mu = torch.where(torch.isfinite(mu) & (mu != 0.0), mu, one)
    k_s = torch.where(torch.isfinite(dyn.k_soft), dyn.k_soft, zero)
    k_eff = k_s  # the curvature branch is dead code in the reference
    has_spring = (k_eff > 0.0) & (mu > 0.0)
    omega = torch.sqrt(torch.where(has_spring, k_eff / mu, zero))
    theta = omega * dt_f
    sin_t, cos_t = sin_cos_stable(theta)

    barrier = _barrier_on(cfg)
    pi_kick1 = 0.5 * dt_f * _bar_force(cfg, dyn, eps0) if barrier else zero
    Delta0 = eps0 - eps_star
    pi_in = pi0 + pi_kick1

    rotating = has_spring & (omega != 0.0)
    om_safe = torch.where(rotating, omega, one)
    mu_omega = torch.sqrt(mu * torch.clamp_min(k_eff, 0.0))
    denom = torch.where(rotating, mu * om_safe * om_safe, one)
    delta_t = torch.where(rotating,
                          Delta0 * cos_t + (pi_in / (mu * om_safe)) * sin_t,
                          Delta0)
    eta_t = torch.where(rotating, pi_in * cos_t - mu_omega * Delta0 * sin_t,
                        pi_in)
    I_tau = torch.where(rotating, (Delta0 / om_safe) * sin_t
                        + (pi_in / denom) * (1.0 - cos_t), zero)
    eps_rot = eps_star + delta_t
    pi_kick2 = 0.5 * dt_f * _bar_force(cfg, dyn, eps_rot) if barrier else zero
    pi_out = eta_t + pi_kick2

    # J-cap (hamsoft_flows.py:692-738)
    J = k_s * I_tau
    p_scale = torch.clamp_min(_row_max_norm(p, state.mask), 1.0e-12)
    dp_inf = _row_max_norm(J[..., None, None] * grad, state.mask)
    threshold = cfg.j_max_cap * p_scale
    scale = torch.where(dp_inf > threshold,
                        threshold / torch.clamp_min(dp_inf, 1e-300), one)
    J_applied = J * scale
    p_new = p + J_applied[..., None, None] * grad

    eps_fin, pi_fin = eps_rot, pi_out
    if refl:
        eps_fin, pi_fin = _fold(cfg, dyn, eps_fin, pi_fin)  # post-fold

    m_safe = torch.where(state.mask, state.mass, torch.ones_like(state.mass))
    vel = p_new / m_safe[..., None]
    vel = torch.where(state.mask[..., None], vel, state.vel)
    out = state.replace(vel=vel, eps=eps_fin, pi=pi_fin, s=eps_fin,
                        step_s2=eps_fin * eps_fin)
    return out, (eps_star, grad)


def v_half_kick(state, dyn, cfg, h):
    """V(h/2): momentum kick at the current eps plus the conjugate pi
    kick (hamsoft_stepper.py:543-663)."""
    h_half = 0.5 * h
    F = gravitational_force(state.pos, state.mass, state.eps, dyn.G,
                            mask=state.mask)
    m_safe = torch.where(state.mask, state.mass, torch.ones_like(state.mass))
    vel = state.vel + h_half[..., None, None] * F / m_safe[..., None]
    vel = torch.where(state.mask[..., None], vel, state.vel)
    if cfg.freeze_s_subsystem:
        return state.replace(vel=vel)
    dU = dV_d_epsilon(state.pos, state.mass, state.eps, dyn.G,
                      mask=state.mask)
    dUbar = -_bar_force(cfg, dyn, state.eps) if _barrier_on(cfg) \
        else torch.zeros_like(dU)
    return state.replace(vel=vel, pi=state.pi - (dU + dUbar) * h_half)


def t_drift(state, dyn, cfg, h):
    """T(h): q += h v (hamsoft_stepper.py:242)."""
    return state.replace(pos=state.pos + h[..., None, None] * state.vel)


def strang_substep(state, dyn, cfg, h):
    """One full Strang substep (hamsoft_stepper.py:247-308)."""
    out, _cache = strang_substep_cached(state, dyn, cfg, h, None)
    return out


def strang_substep_cached(state, dyn, cfg, h, es_grad=None):
    """Strang substep threading the (eps*, grad) cache: the incoming
    cache feeds the leading S-flow; the trailing S-flow's evaluation is
    returned for the next substep (only T moves q)."""
    refl = _reflecting(cfg)
    if refl:
        state = _with_eps(state, *_fold(cfg, dyn, state.eps, state.pi))

    if cfg._validate_S_only:
        state, es_grad = spring_half_cached(state, dyn, cfg, h, es_grad)
        state, es_grad = spring_half_cached(state, dyn, cfg, h, es_grad)
        if refl:
            state = _with_eps(state, *_fold(cfg, dyn, state.eps, state.pi))
        return state, es_grad

    state, _eg = spring_half_cached(state, dyn, cfg, h, es_grad)
    state = v_half_kick(state, dyn, cfg, h)
    state = t_drift(state, dyn, cfg, h)
    state = v_half_kick(state, dyn, cfg, h)
    state, es_grad_out = spring_half_cached(state, dyn, cfg, h, None)
    if refl:
        state = _with_eps(state, *_fold(cfg, dyn, state.eps, state.pi))
    return state, es_grad_out


def canonical_eom(state, dyn, cfg):
    """The exact canonical equations of motion, for validation
    (HSI:897-982): (qdot, pdot, epsdot, pidot), the first two (B, N, d),
    the others (B,).  The "reference" gradient mode takes the
    sign-aligned Omega gradient (HSI:942), the others the eps* gradient
    of the spring flow."""
    m_safe = torch.where(state.mask, state.mass, torch.ones_like(state.mass))
    qdot = state.momenta() / m_safe[..., None]
    F_grav = gravitational_force(state.pos, state.mass, state.eps, dyn.G,
                                 mask=state.mask)
    dVgrav = dV_d_epsilon(state.pos, state.mass, state.eps, dyn.G,
                          mask=state.mask)
    eps_star = eps_target(state, dyn, cfg)
    if cfg.eps_grad_mode == "reference":
        grad = grad_eps_target(state, dyn, cfg)
    else:
        grad = eps_star_and_grad(state, dyn, cfg)[1]
    Delta = state.eps - eps_star
    pdot = F_grav + (dyn.k_soft * Delta)[..., None, None] * grad
    epsdot = torch.where(dyn.mu_soft != 0.0, state.pi / dyn.mu_soft,
                         torch.zeros_like(state.pi))
    dUbar = -_bar_force(cfg, dyn, state.eps) if _barrier_on(cfg) \
        else torch.zeros_like(dVgrav)
    pidot = -dVgrav - dyn.k_soft * Delta - dUbar
    return qdot, pdot, epsdot, pidot
