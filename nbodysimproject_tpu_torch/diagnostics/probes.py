"""Flow probes: the quantities the reference's sub-flows log, recomputed
from a state on demand.

Counterpart of ``nbodysimproject_tpu/diagnostics/probes.py``.  The
reference records ``_last_s_info`` / ``_last_vkick`` /
``_last_strang_schedule_info`` as side effects of each sub-flow
(hamsoft_flows.py:740-754, hamsoft_stepper.py:656-662, HSI:1105-1118);
these pure functions give the same quantities for a batched state, one
value per system (``grad_used`` (B, N, d)), for the facade's integrator
shim to read.
"""

from __future__ import annotations

import torch

from ..integrators import hamsoft as hs
from ..ops.forces import dV_d_epsilon


def spring_probe(state, dyn, cfg, h):
    """What spring_half logs for a sub-flow of h/2: I_tau, J, J_applied,
    eps*, omega, theta, the barrier kicks, k_eff
    (hamsoft_flows.py:740-754)."""
    dt_f = 0.5 * h
    eps_star, grad = hs.eps_star_and_grad(state, dyn, cfg)
    one = torch.ones_like(dyn.mu_soft)
    zero = torch.zeros_like(dyn.mu_soft)
    mu = torch.where(torch.isfinite(dyn.mu_soft) & (dyn.mu_soft != 0.0),
                     dyn.mu_soft, one)
    k_s = torch.where(torch.isfinite(dyn.k_soft), dyn.k_soft, zero)
    has = (k_s > 0.0) & (mu > 0.0)
    omega = torch.sqrt(torch.where(has, k_s / mu, zero))
    theta = omega * dt_f
    sin_t, cos_t = hs.sin_cos_stable(theta)

    k1 = 0.5 * dt_f * hs._bar_force(cfg, dyn, state.eps) \
        if hs._barrier_on(cfg) else torch.zeros_like(state.eps)
    Delta0 = state.eps - eps_star
    pi_in = state.pi + k1
    om = torch.where(has & (omega != 0.0), omega, one)
    denom = torch.where(has, mu * om * om, one)
    I_tau = torch.where(has & (omega != 0.0),
                        (Delta0 / om) * sin_t + (pi_in / denom) * (1 - cos_t),
                        zero)
    J = k_s * I_tau
    p_scale = torch.clamp_min(hs._row_max_norm(state.momenta(), state.mask),
                              1e-12)
    dp_inf = hs._row_max_norm(J[..., None, None] * grad, state.mask)
    thr = cfg.j_max_cap * p_scale
    J_applied = J * torch.where(dp_inf > thr,
                                thr / torch.clamp_min(dp_inf, 1e-300), one)
    if hs._barrier_on(cfg):
        eps_rot = eps_star + Delta0 * cos_t + (pi_in / (mu * om)) * sin_t
        k2 = 0.5 * dt_f * hs._bar_force(cfg, dyn, eps_rot)
    else:
        k2 = torch.zeros_like(state.eps)
    return dict(I_tau=I_tau, J=J, J_applied=J_applied, grad_used=grad,
                eps_star=eps_star, omega=omega, theta=theta,
                sin=sin_t, cos=cos_t, one_minus_cos=1.0 - cos_t,
                barrier_kick1=k1, barrier_kick2=k2, k_eff=k_s)


def vkick_probe(state, dyn, cfg, h):
    """What v_half_kick logs: the eps used and the dV/deps terms
    (hamsoft_stepper.py:656-662)."""
    dU = dV_d_epsilon(state.pos, state.mass, state.eps, dyn.G,
                      mask=state.mask)
    dUbar = -hs._bar_force(cfg, dyn, state.eps) if hs._barrier_on(cfg) \
        else torch.zeros_like(dU)
    return dict(epsilon_used=state.eps, dVgrav_deps=dU, dSbar_deps=dUbar,
                dV_total_deps=dU + dUbar, dt_half=0.5 * h)


def schedule_probe(state, dyn, cfg, dt):
    """The frozen-schedule record (HSI:1105-1118)."""
    n_sub = torch.clamp_min(dyn.n_sub, 1)
    h_piece = torch.abs(dt) / n_sub.to(state.pos.dtype)
    return dict(dt=torch.abs(dt), n_sub=n_sub, h_piece=h_piece,
                omega_eff=dyn.omega_spr0,
                theta_sub_half=0.5 * dyn.omega_spr0 * h_piece,
                k_soft=dyn.k_soft, mu_soft=dyn.mu_soft,
                h_sub_ref=dyn.h_sub_ref)
