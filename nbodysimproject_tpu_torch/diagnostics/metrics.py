"""Step metrics, batched.

Counterpart of ``step_metrics`` and ``tidal_trace`` of
``nbodysimproject_tpu/diagnostics/metrics.py`` (parity:
``minbody/diagnostics.py:241-285``) on a batched state: one value per
system for COM drift, J_eps, theta_eps, the angular-momentum statistics,
the tidal trace and (optionally) the energy breakdown.  d = 2 takes the
reference's scalar L_z statistics, d = 3 the JAX package's vector
branch (L_tot = |sum m q x v|, var_L of the per-body |L_i|, cos_theta
the tilt of L against L0).
"""

from __future__ import annotations

import math

import torch

from . import energy as E
from ..ops.geometry import pair_diff, pair_mask


def tidal_trace(state, dyn, cfg=None):
    """Trace of the Hessian of the softened potential:
    2 G sum_{i<j} m_i m_j (d (r^2+eps^2) - 3 r^2) / (r^2+eps^2)^{5/2},
    with the force softening in use (eps for ham_soft, sqrt(step_s2)
    for the classical modes)."""
    diff = pair_diff(state.pos)
    r2 = (diff * diff).sum(-1)
    if cfg is not None and getattr(cfg, "integrator_mode", None) \
            != "ham_soft":
        eps2 = state.step_s2
    else:
        eps2 = state.eps * state.eps
    s = r2 + eps2[..., None, None]
    pm = pair_mask(state.pos.shape[-2], state.mask)
    mm = state.mass[..., :, None] * state.mass[..., None, :]
    num = state.pos.shape[-1] * s - 3.0 * r2
    contrib = torch.where(pm, mm * num / torch.clamp_min(s, 1e-300) ** 2.5,
                          torch.zeros_like(s))
    return dyn.G * contrib.sum((-2, -1))  # i != j double counts


def _l_stats_2d(m, pos, vel, msk, L0, nan):
    """Scalar L_z statistics, the reference's semantics."""
    zero = torch.zeros_like(m)
    L_i = m * (pos[..., 0] * vel[..., 1] - pos[..., 1] * vel[..., 0])
    L_i = torch.where(msk, L_i, zero)
    L_tot = L_i.sum(-1)
    nb = torch.clamp_min(msk.to(L_i.dtype).sum(-1), 1.0)
    L_mean = L_tot / nb
    var_L = torch.where(msk, (L_i - L_mean[..., None]) ** 2, zero).sum(-1) / nb
    if L0 is None:
        L0 = L_tot
    cos_ok = (L0 != 0.0) & (L_tot != 0.0)
    cos_theta = torch.where(cos_ok, (L_tot * L0)
                            / (torch.abs(L_tot) * torch.abs(L0)), nan)
    return L_tot, var_L, cos_theta


def _l_stats_3d(m, pos, vel, msk, L0, nan):
    """Vector angular momentum (metrics.py:95-110 of the JAX package):
    L_tot the magnitude of the total, var_L the variance of the per-body
    |L_i|, cos_theta the tilt of L against L0.  The floor 1e-300 of the
    tilt's denominator is taken in the working dtype, as there: 0 in
    float32."""
    L_iv = torch.where(msk[..., None],
                       m[..., None] * torch.linalg.cross(pos, vel, dim=-1),
                       torch.zeros_like(pos))
    L_vec = L_iv.sum(-2)
    L_tot = torch.sqrt((L_vec * L_vec).sum(-1))
    l_i = torch.sqrt((L_iv * L_iv).sum(-1))
    zero = torch.zeros_like(l_i)
    nb = torch.clamp_min(msk.to(l_i.dtype).sum(-1), 1.0)
    l_mean = torch.where(msk, l_i, zero).sum(-1) / nb
    var_L = torch.where(msk, (l_i - l_mean[..., None]) ** 2, zero).sum(-1) / nb
    L0v = L_vec if L0 is None else L0
    L0n = torch.sqrt((L0v * L0v).sum(-1))
    cos_ok = (L0n != 0.0) & (L_tot != 0.0)
    den = torch.maximum(L_tot * L0n, L_tot.new_tensor(1e-300))
    cos_theta = torch.where(cos_ok, (L_vec * L0v).sum(-1) / den, nan)
    return L_tot, var_L, cos_theta


def step_metrics(state, dyn, cfg, L0=None, megno_slope_median=None,
                 energies: bool = True):
    """dict of (B,) step metrics (diagnostics.py:241-285).  ``L0`` is the
    first-seen total angular momentum: L_z (B,) for d = 2, the L vector
    (B, 3) for d = 3; ``energies=False`` leaves out the energy breakdown
    (an eps* solve), which callers reading only the metric columns do
    not need."""
    m, pos, vel, msk = state.mass, state.pos, state.vel, state.mask

    com_vec = torch.where(msk[..., None], m[..., None] * pos,
                          torch.zeros_like(pos)).sum(-2)
    com_drift = torch.sqrt((com_vec * com_vec).sum(-1))

    mu = dyn.mu_soft
    J_eps = state.eps * state.pi / torch.where(mu != 0.0, mu,
                                               torch.ones_like(mu))
    denom_ok = (mu * state.eps != 0.0) | (state.pi != 0.0)
    nan = torch.full_like(state.eps, math.nan)
    theta_eps = torch.where(denom_ok, torch.atan2(state.pi, mu * state.eps),
                            nan)

    if pos.shape[-1] == 2:
        L_tot, var_L, cos_theta = _l_stats_2d(m, pos, vel, msk, L0, nan)
    else:
        L_tot, var_L, cos_theta = _l_stats_3d(m, pos, vel, msk, L0, nan)

    out = dict(
        com_drift=com_drift, J_eps=J_eps, L_tot=L_tot, var_L=var_L,
        cos_theta=cos_theta, tr_hessian=tidal_trace(state, dyn, cfg),
        megno_slope_med=(nan if megno_slope_median is None
                         else megno_slope_median),
        theta_eps=theta_eps)
    if energies:
        out.update(E.energy_breakdown(state, dyn, cfg))
    return out
