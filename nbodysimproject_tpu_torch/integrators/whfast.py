"""Wisdom–Holman (WHFast) integrator in Jacobi coordinates, batched.

Counterpart of ``nbodysimproject_tpu/integrators/whfast.py`` (parity:
``minbody/whfast_scheme.py`` and the Jacobi transforms of
``minbody/simulation.py:487-534``), with the JAX package's corrections
kept: slot 0 is anchored at the centre of mass (an exact Hamiltonian
flow) and the interaction kick is -grad V_int / m of the splitting
H = H_kep + H_int, in closed form.  Every function takes a batched
``(B, N, d)`` state; ``h``/``dt`` are (B,) tensors.  Bodies are ordered
with the dominant mass first (the Jacobi convention).

The interaction kick's direct force takes the large-N engines for many
planets (``force_mode`` other than ``"direct"``: the tiled kernel of
``ops/force_kernels.py``, or P3M with the star split off) and the tiled
kernel under ``cfg.use_pallas_forces``.  The fused multi-step kernel of
the same scheme is ``ops/whfast_kernels.py``.
"""

from __future__ import annotations

import torch

from ..ops.forces import force_auto
from ..ops.kepler import kepler_propagate, kepler_propagate_fixed
from .largen import make_force_fn


def to_jacobi(m, pos, vel):
    """Jacobi coordinates: jac_0 = pos_0, jac_i = pos_i - COM(bodies < i),
    by exclusive prefix sums (simulation.py:487-507)."""
    csum_m = torch.cumsum(m, -1)
    M_prev = torch.cat([m[..., :1], csum_m[..., :-1]], -1)
    R = torch.cumsum(m[..., None] * pos, -2)
    V = torch.cumsum(m[..., None] * vel, -2)
    R_prev = torch.cat([m[..., :1, None] * pos[..., :1, :], R[..., :-1, :]],
                       -2)
    V_prev = torch.cat([m[..., :1, None] * vel[..., :1, :], V[..., :-1, :]],
                       -2)
    jac_pos = pos - R_prev / M_prev[..., None]
    jac_vel = vel - V_prev / M_prev[..., None]
    jac_pos = torch.cat([pos[..., :1, :], jac_pos[..., 1:, :]], -2)
    jac_vel = torch.cat([vel[..., :1, :], jac_vel[..., 1:, :]], -2)
    return jac_pos, jac_vel


def from_jacobi(m, jac_pos, jac_vel):
    """Inverse transform in closed form: pos_i = j_i + exclusive prefix
    sum of m j / M (simulation.py:509-534)."""
    M = torch.cumsum(m, -1)[..., None]
    s_pos = torch.cumsum(m[..., None] * jac_pos / M, -2)
    s_vel = torch.cumsum(m[..., None] * jac_vel / M, -2)
    zero = torch.zeros_like(jac_pos[..., :1, :])
    pos = jac_pos + torch.cat([zero, s_pos[..., :-1, :]], -2)
    vel = jac_vel + torch.cat([zero, s_vel[..., :-1, :]], -2)
    return pos, vel


def wh_kepler_drift(state, dyn, dt, kepler_iters: int = 0):
    """Drift of H_kep for ``dt`` (B,): the centre of mass linearly,
    bodies i >= 1 on Kepler orbits in Jacobi coordinates with
    mu_i = G cum_i (whfast_scheme.py:22-37), slot 0 anchored at the
    centre of mass.  ``kepler_iters > 0`` selects the fixed-depth
    Laguerre–Conway solver, 0 the adaptive Newton solver."""
    m = state.mass
    cum = torch.cumsum(m, -1)
    jac_pos, jac_vel = to_jacobi(m, state.pos, state.vel)
    M = cum[..., -1:]
    com_q = (m[..., None] * state.pos).sum(-2) / M
    com_v = (m[..., None] * state.vel).sum(-2) / M
    mu = dyn.G[..., None] * cum
    dt1 = dt[..., None]
    if kepler_iters > 0:
        r_new, v_new = kepler_propagate_fixed(
            jac_pos[..., 1:, :], jac_vel[..., 1:, :], mu[..., 1:], dt1,
            iters=kepler_iters)
    else:
        r_new, v_new = kepler_propagate(jac_pos[..., 1:, :],
                                        jac_vel[..., 1:, :], mu[..., 1:],
                                        dt1)
    zero = torch.zeros_like(jac_pos[..., :1, :])
    pos0, vel0 = from_jacobi(m, torch.cat([zero, r_new], -2),
                             torch.cat([zero, v_new], -2))
    dq = (com_q + com_v * dt1) - (m[..., None] * pos0).sum(-2) / M
    dv = com_v - (m[..., None] * vel0).sum(-2) / M
    return state.replace(pos=pos0 + dq[..., None, :],
                         vel=vel0 + dv[..., None, :])


def _direct_part(state, dyn, cfg):
    """The softened direct force F of the interaction kick
    (``integrators/whfast.py:207-241`` of the JAX package).

    With ``cfg.force_mode`` other than "direct" and n >= 3, the
    many-planet route shares the large-N force engines of
    ``integrators/largen.py``; every slot is taken as live (no mask:
    masked slots would enter the mesh bounds and deposit).  Under "p3m"
    the star is split off: body 0 (the dominant mass, Jacobi order) gets
    the exact O(N) pair force and the mesh sees only the planets (its
    TSC-smeared near field of the star would enter the kick and must
    cancel exactly against the Kepler gradient).  Below n = 3, or with
    "direct", ``ops/forces.py::force_auto``."""
    m, q = state.mass, state.pos
    n, d = q.shape[-2:]
    eps = torch.sqrt(state.step_s2)
    mode = "direct" if cfg is None else cfg.force_mode
    if mode == "direct" or n < 3:
        return force_auto(q, m, eps, dyn.G, state.mask, cfg)
    if mode != "p3m":
        return _per_system(make_force_fn(cfg, n, d), q, m, eps, dyn.G)
    F_pp = _per_system(make_force_fn(cfg, n - 1, d), q[..., 1:, :],
                       m[..., 1:], eps, dyn.G)
    d0 = q[..., 1:, :] - q[..., :1, :]
    r2_0 = (d0 * d0).sum(-1) + state.step_s2[..., None]
    ok = r2_0 > 0
    r0 = torch.sqrt(torch.where(ok, r2_0, torch.ones_like(r2_0)))
    w0 = torch.where(ok, (dyn.G * m[..., 0])[..., None] * m[..., 1:]
                     / (r0 * r0 * r0), torch.zeros_like(r0))
    F_sp = -w0[..., None] * d0          # pull toward the star
    return torch.cat([-F_sp.sum(-2, keepdim=True), F_pp + F_sp], -2)


def _per_system(force_fn, q, m, eps, G):
    """A force of ``integrators/largen.py::make_force_fn`` on (B, N, d):
    the direct engines take the batch, P3M one system at a time."""
    if force_fn.mode != "p3m":
        return force_fn(q, m, eps, G)[0]
    return torch.stack([force_fn(q[b], m[b], eps[b], G[b])[0]
                        for b in range(q.shape[0])])


def wh_interaction_accel(state, dyn, cfg=None):
    """a_int = -grad V_int / m in closed form: the softened direct
    acceleration plus, with w_i = G m_i jac_i / (|jac_i|^2 + s2)^{3/2}
    (zero for i = 0), grad_k V_kep / m_k = (Mprev_k / m_k) w_k -
    sum_{i > k} w_i (an exclusive suffix sum)."""
    m, q = state.mass, state.pos
    s2 = state.step_s2
    n = q.shape[-2]
    F = _direct_part(state, dyn, cfg)
    msafe = torch.where(m > 0.0, m, torch.ones_like(m))
    a_direct = F / msafe[..., None]

    jac_pos, _ = to_jacobi(m, q, q)
    cum = torch.cumsum(m, -1)
    Mprev = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], -1)
    live = (torch.arange(n, device=q.device) >= 1) & (m > 0.0)
    jr2 = (jac_pos * jac_pos).sum(-1) + s2[..., None]
    jr = torch.sqrt(torch.where(live, jr2, torch.ones_like(jr2)))
    w = torch.where(live, dyn.G[..., None] * m / (jr * jr * jr),
                    torch.zeros_like(jr))[..., None] * jac_pos
    cw = torch.cumsum(w, -2)
    S = cw[..., -1:, :] - cw
    a_kep_grad = (Mprev / msafe)[..., None] * w - S
    return torch.where((m > 0.0)[..., None], a_direct + a_kep_grad,
                       torch.zeros_like(a_direct))


def _kepler_iters(cfg) -> int:
    return int(getattr(cfg, "whfast_kepler_iters", 8))


def whfast_substep(state, dyn, cfg, h):
    """Kepler half-drift, interaction kick, Kepler half-drift
    (whfast_scheme.py:71-93)."""
    dt2 = 0.5 * h
    iters = _kepler_iters(cfg)
    state = wh_kepler_drift(state, dyn, dt2, kepler_iters=iters)
    acc = wh_interaction_accel(state, dyn, cfg)
    state = state.replace(vel=state.vel + h[..., None, None] * acc)
    return wh_kepler_drift(state, dyn, dt2, kepler_iters=iters)


def whfast_corrector(state, dyn, cfg, h_ref):
    """WHFast start-up corrector: a half-kick of the interaction
    acceleration (whfast_scheme.py:95-123)."""
    acc = wh_interaction_accel(state, dyn, cfg)
    return state.replace(vel=state.vel + 0.5 * h_ref[..., None, None] * acc)
