"""Kepler-split fast path for tight-binary-dominated systems, batched.

Counterpart of ``nbodysimproject_tpu/integrators/kepler_split.py`` (the
JAX package's module docstring gives the design): the Hamiltonian is
split around the dominating pair (i, j),

    H_fast = T + V_point(i, j) + V_soft(pairs != (i, j)),

and integrated with kick(h/2; F_pert) -> drift(h) -> kick(h/2; F_pert),
where the drift propagates the pair's relative coordinate exactly
through the universal-variable Kepler solver (``ops/kepler.py``) and
the pair's barycentre and every other body drift linearly.  eps and pi
stay frozen.  The dominant pair is re-identified from the current
positions every substep, as boolean one-hots of its members.

Every function takes a batched state ``(B, N, d)``; ``h`` is a (B,)
tensor.  This is integrator mode ``"kepler_split"``; the tail policy
that sends systems here lives in ``analysis/batch.py``.
"""

from __future__ import annotations

import math

import torch

from ..ops.forces import gravitational_force
from ..ops.geometry import pair_diff, pair_mask, triu_pairs
from ..ops.kepler import kepler_propagate, kepler_propagate_fixed
from ..utils.summation import kahan_sum


def pair_timescales_sq(q, m, G, mask=None):
    """Dominant-pair identification from squared two-body timescales
    tau^2_ij = r_ij^3 / (G (m_i + m_j)) over valid pairs.  Returns
    (ei, ej, tau_min_sq, tau_second_sq): boolean (B, N) one-hots of the
    tightest pair's members (the first minimum of the flattened N x N
    matrix, so i < j) and the minimum over every other pair (+inf with
    fewer than two pairs)."""
    n = q.shape[-2]
    diff = pair_diff(q)
    r2 = (diff * diff).sum(-1)
    pm = pair_mask(n, mask, q.device)
    denom = G[..., None, None] * (m[..., :, None] + m[..., None, :])
    valid = pm & (denom > 0.0) & (r2 > 0.0)
    one = torch.ones_like(r2)
    r2s = torch.where(valid, r2, one)
    tau2 = torch.where(valid, r2s * torch.sqrt(r2s)
                       / torch.where(valid, denom, one),
                       torch.full_like(r2, math.inf))
    flat = tau2.reshape(tau2.shape[:-2] + (n * n,))
    k = torch.argmin(flat, -1)
    i, j = k // n, k % n
    tau_min_sq = flat.gather(-1, k[..., None])[..., 0]
    idx = torch.arange(n * n, device=q.device)
    excl = (idx == (i * n + j)[..., None]) | (idx == (j * n + i)[..., None])
    tau_second_sq = torch.where(excl, torch.full_like(flat, math.inf),
                                flat).amin(-1)
    ar = torch.arange(n, device=q.device)
    return (ar == i[..., None], ar == j[..., None], tau_min_sq,
            tau_second_sq)


def _pair_scalars(ei, ej, q, v, m):
    """The pair's (m_i, m_j, q_i, q_j, v_i, v_j) by one-hot contraction."""
    w_i = ei.to(q.dtype)
    w_j = ej.to(q.dtype)
    pick = lambda w, x: (w[..., None] * x).sum(-2)
    return ((w_i * m).sum(-1), (w_j * m).sum(-1), pick(w_i, q),
            pick(w_j, q), pick(w_i, v), pick(w_j, v))


def _pert_force(q, m, eps, G, mask, ei, ej):
    """The softened force field with the dominant pair's own (softened)
    interaction removed: the forces of V_soft(pairs != (i, j))."""
    F = gravitational_force(q, m, eps, G, mask=mask)
    w_i = ei.to(q.dtype)
    w_j = ej.to(q.dtype)
    mi = (w_i * m).sum(-1)
    mj = (w_j * m).sum(-1)
    d = (w_i[..., None] * q).sum(-2) - (w_j[..., None] * q).sum(-2)
    r2 = (d * d).sum(-1) + eps * eps
    inv_r3 = 1.0 / torch.clamp_min(r2 * torch.sqrt(r2), 1e-300)
    f_on_i = (-G * mi * mj)[..., None] * d * inv_r3[..., None]
    f_on_i = f_on_i[..., None, :]
    return F - w_i[..., None] * f_on_i + w_j[..., None] * f_on_i


def kepler_split_substep(state, dyn, cfg, h):
    """One kick-drift-kick substep of H_fast."""
    q, v, m, msk = state.pos, state.vel, state.mass, state.mask
    eps = torch.sqrt(torch.clamp_min(state.step_s2, 0.0))
    G = dyn.G
    ei, ej, _tmin2, _tsec2 = pair_timescales_sq(q, m, G, msk)
    m_safe = torch.where(msk, torch.clamp_min(m, 1e-300),
                         torch.ones_like(m))
    h3 = h[..., None, None]

    def kick(q, v, hh):
        acc = _pert_force(q, m, eps, G, msk, ei, ej) / m_safe[..., None]
        return torch.where(msk[..., None], v + hh * acc, v)

    v = kick(q, v, 0.5 * h3)

    mi, mj, qi, qj, vi, vj = _pair_scalars(ei, ej, q, v, m)
    M = mi + mj
    M_safe = torch.where(M > 0.0, M, torch.ones_like(M))
    r_rel = qi - qj
    v_rel = vi - vj
    Rc = (mi[..., None] * qi + mj[..., None] * qj) / M_safe[..., None]
    Vc = (mi[..., None] * vi + mj[..., None] * vj) / M_safe[..., None]
    mu = G * M
    mu_safe = torch.where(mu > 0.0, mu, torch.ones_like(mu))
    iters = int(getattr(cfg, "tail_kepler_iters", 8))
    if iters > 0:
        r_new, v_new = kepler_propagate_fixed(r_rel, v_rel, mu_safe, h,
                                              iters=iters)
    else:
        r_new, v_new = kepler_propagate(r_rel, v_rel, mu_safe, h)
    ok = (mu > 0.0)[..., None]
    h1 = h[..., None]
    r_new = torch.where(ok, r_new, r_rel + h1 * v_rel)
    v_new = torch.where(ok, v_new, v_rel)

    Rc = Rc + h1 * Vc
    fi = (mj / M_safe)[..., None]
    fj = (mi / M_safe)[..., None]
    qi_n = Rc + fi * r_new
    qj_n = Rc - fj * r_new
    vi_n = Vc + fi * v_new
    vj_n = Vc - fj * v_new

    q_lin = torch.where(msk[..., None], q + h3 * v, q)
    e_i, e_j = ei[..., None], ej[..., None]
    q = torch.where(e_i, qi_n[..., None, :],
                    torch.where(e_j, qj_n[..., None, :], q_lin))
    v = torch.where(e_i, vi_n[..., None, :],
                    torch.where(e_j, vj_n[..., None, :], v))

    v = kick(q, v, 0.5 * h3)
    return state.replace(pos=q, vel=v)


def split_hamiltonian(state, dyn, cfg=None):
    """H_fast = T + V_soft(pairs != dominant) + V_point(dominant), with
    compensated sums: the conserved quantity of the split map, which the
    stability verdict measures for tail systems (eps, pi, spring and
    barrier terms are frozen constants on this path and left out)."""
    m, q = state.mass, state.pos
    v2 = (state.vel * state.vel).sum(-1)
    tk = torch.where(state.mask, m * v2, torch.zeros_like(v2))
    T = 0.5 * kahan_sum(tk)

    n = q.shape[-2]
    eps = torch.sqrt(torch.clamp_min(state.step_s2, 0.0))
    iu, ju = triu_pairs(n, q.device)
    diff = pair_diff(q)
    r2 = (diff * diff).sum(-1)[..., iu, ju]
    pair_ok = pair_mask(n, state.mask)[..., iu, ju]
    r2u = torch.where(pair_ok, r2, torch.ones_like(r2))
    zero = torch.zeros_like(r2u)
    inv_r_soft = torch.where(
        pair_ok, 1.0 / torch.sqrt(r2u + (eps * eps)[..., None]), zero)
    mprod = m[..., iu] * m[..., ju]
    ei, ej, _t1, _t2 = pair_timescales_sq(q, m, dyn.G, state.mask)
    dom = (ei[..., :, None] & ej[..., None, :]) \
        | (ej[..., :, None] & ei[..., None, :])
    inv_r_point = torch.where(
        pair_ok, 1.0 / torch.sqrt(torch.clamp_min(r2u, 1e-300)), zero)
    inv_r = torch.where(dom[..., iu, ju], inv_r_point, inv_r_soft)
    V = -dyn.G * kahan_sum(mprod * inv_r)
    return T + V
