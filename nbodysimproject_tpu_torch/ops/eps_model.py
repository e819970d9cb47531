"""Production eps* model: SPH softmin of per-particle smoothing lengths.

Counterpart of ``nbodysimproject_tpu/ops/eps_model.py`` (parity:
``minbody/hamsoft_eps_model.py``), batched over a leading system axis.

  h_i solves h_i = eta * sqrt(m_i / Sigma_i(h_i)),
  Sigma_i = sum_{j != i} m_j W(r_ij, h_i),  W(r, h) = exp(-r^2/h^2)/(pi h^2),
  <= 8 iterations with a per-system early stop at max relative change
  < 1e-6 (emulated by freezing the iterate), h clamped to
  [eps_floor, eps_cap] every iteration;
  eps* = -alpha * logsumexp(-h_i / alpha).

This module holds the value of eps*, the calibration, and
``eps_star_and_grad``: the value with its autograd gradient and, in the
"reference" gradient mode, the reference's degeneracy fallback (the
sign-aligned Omega gradient), the counterpart of the JAX package's XLA
evaluation, which the ham_soft scan uses wherever the eps kernel
(``ops/eps_kernels.py``) does not apply.
The kernels' own gradient is the hand-written reverse sweep in
``csrc/hamsoft_physics.cuh`` (autograd through the 8 iterations in their
plain versions, ``ops/hamsoft_kernels.py``).
"""

from __future__ import annotations

import math

import torch

from . import softening as legacy_soft
from .geometry import pair_diff, pair_mask, triu_pairs

_SOLVE_HI_MAX_ITER = 8
_SOLVE_HI_TOL = 1.0e-6


def _kernel_sigma(r2, pm, m, h):
    """Sigma_i at smoothing lengths h (B, N) for precomputed geometry
    (gather form: row i uses h_i)."""
    hj = torch.clamp_min(h, 1.0e-12)
    c = 1.0 / (math.pi * hj * hj)
    W = c[..., None] * torch.exp(-r2 / (hj * hj)[..., None]) * pm
    return (W * m[..., None, :]).sum(-1)


def solve_hi(q, m, *, h0, eps_floor, eps_cap, eta: float = 1.35, mask=None):
    """Fixed-point solve for per-particle smoothing lengths (B, N).

    ``h0``, ``eps_floor``, ``eps_cap`` are (B,).  Mirrors
    minbody/hamsoft_eps_model.py:316-400: h initialised to the clipped
    current epsilon, <= 8 iterations with the global early stop, h
    clamped every iteration, non-finite or non-positive updates keep
    the previous iterate."""
    n = q.shape[-2]
    h = torch.minimum(torch.maximum(h0, eps_floor), eps_cap)[..., None] \
        .expand(*q.shape[:-2], n).clone()
    diff = pair_diff(q)
    r2 = (diff * diff).sum(-1)
    pm = pair_mask(n, mask, q.device).to(q.dtype)
    lo, hi = eps_floor[..., None], eps_cap[..., None]
    done = torch.zeros(q.shape[:-2], dtype=torch.bool, device=q.device)
    for _ in range(_SOLVE_HI_MAX_ITER):
        Si = torch.clamp_min(_kernel_sigma(r2, pm, m, h), 1.0e-30)
        h_new = eta * torch.sqrt(m / Si)
        h_new = torch.where(torch.isfinite(h_new) & (h_new > 0.0), h_new, h)
        h_new = torch.minimum(torch.maximum(h_new, lo), hi)
        rel = (torch.abs(h_new - h) / torch.clamp_min(h, 1.0e-12)).amax(-1)
        h = torch.where(done[..., None], h, h_new)
        done = done | (rel < _SOLVE_HI_TOL)
    return h


def softmin(h, alpha, mask=None):
    """eps* = -alpha * logsumexp(-h/alpha) over the valid bodies
    (minbody/hamsoft_eps_model.py:263-274)."""
    t = -h / alpha[..., None]
    if mask is not None:
        t = torch.where(mask, t, torch.full_like(t, -math.inf))
    t_max = t.amax(-1)
    s = torch.exp(t - t_max[..., None]).sum(-1)
    return -alpha * (t_max + torch.log(s))


def eps_target_production(q, m, *, h0, alpha, eps_min, eps_max,
                          eta: float = 1.35, clamp: bool = False, mask=None):
    """Production eps* (minbody/hamsoft_eps_model.py:240-289); ``clamp``
    is the soft-barrier policy's clamp to [eps_min, eps_max]."""
    a = torch.minimum(eps_min, eps_max)
    b = torch.maximum(eps_min, eps_max)
    eps_floor = torch.clamp_min(a, 1.0e-12)
    eps_cap = torch.maximum(eps_floor, b)
    h = solve_hi(q, m, h0=h0, eps_floor=eps_floor, eps_cap=eps_cap,
                 eta=eta, mask=mask)
    es = softmin(h, alpha, mask=mask)
    if clamp:
        es = torch.minimum(torch.maximum(es, a), b)
    return es


def masked_median(x, mask=None):
    """Median over the valid entries of the last axis (numpy
    convention: mean of the two middle order statistics)."""
    if mask is None:
        xs = torch.sort(x, dim=-1).values
        n = x.shape[-1]
        return 0.5 * (xs[..., (n - 1) // 2] + xs[..., n // 2])
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, big)),
                    dim=-1).values
    cnt = mask.to(torch.int64).sum(-1)
    lo = torch.clamp_min(torch.div(cnt - 1, 2, rounding_mode="floor"), 0)
    hi = torch.clamp_min(cnt // 2, 0)
    return 0.5 * (xs.gather(-1, lo[..., None])[..., 0]
                  + xs.gather(-1, hi[..., None])[..., 0])


def calibrate_from_initial_conditions(q0, m, *, eps0, eps_min0, eps_max,
                                      alpha_cfg, eta: float = 1.35,
                                      c_alpha: float = 0.3,
                                      c_min: float = 0.25, mask=None):
    """EpsilonModel.calibrate_from_initial_conditions
    (minbody/hamsoft_eps_model.py:645-729), per system.

    Returns (alpha_run, eps_min_new, eps_new)."""
    alpha_seed = torch.where(alpha_cfg > 0.0, alpha_cfg,
                             torch.clamp_min(eps0, 1.0e-12))
    eps_floor = torch.clamp_min(eps_min0, 1.0e-12)
    eps_cap = torch.maximum(eps_floor, eps_max)
    h0 = solve_hi(q0, m, h0=eps0, eps_floor=eps_floor, eps_cap=eps_cap,
                  eta=eta, mask=mask)
    med_h = masked_median(h0, mask)
    med_h = torch.where(torch.isfinite(med_h) & (med_h > 0.0), med_h,
                        alpha_seed)

    alpha_run = c_alpha * med_h
    alpha_run = torch.where(torch.isfinite(alpha_run) & (alpha_run > 0.0),
                            alpha_run, alpha_seed)

    candidate_floor = torch.minimum(c_min * med_h, eps_max)
    eps_min_new = torch.minimum(torch.maximum(eps_min0, candidate_floor),
                                eps_max)
    eps_new = torch.maximum(eps0, eps_min_new)
    return alpha_run, eps_min_new, eps_new


def _row_norm_max(g, mask=None):
    """max over the valid bodies of |g_i|, (B,)."""
    r = torch.sqrt((g * g).sum(-1))
    if mask is not None:
        r = torch.where(mask, r, torch.zeros_like(r))
    return r.amax(-1)


def pair_distance_median(q, mask=None):
    """Median of the valid pair distances r_ij, i < j, per system, in
    numpy's ``nanmedian`` convention (the mean of the two middle order
    statistics); 0 where a system has no valid pair or the median is not
    finite (ops/eps_model.py:336-341 of the JAX package)."""
    n = q.shape[-2]
    if n < 2:
        return torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)
    i, j = triu_pairs(n, q.device)
    diff = q[..., i, :] - q[..., j, :]
    r = torch.sqrt((diff * diff).sum(-1))
    valid = (pair_mask(n, mask, q.device)[..., i, j] & ~torch.isnan(r)) \
        .expand(r.shape)
    med = masked_median(r, valid)
    ok = valid.any(-1) & torch.isfinite(med)
    return torch.where(ok, med, torch.zeros_like(med))


def degenerate_grad(g, q, mask=None):
    """The "reference" gradient mode's degeneracy test of the gradient
    ``g`` at positions ``q``: (degenerate, gmax, threshold), (B,) each.
    gmax is the largest valid row norm, threshold 1e-9 times the median
    pair distance, and a system degenerates where gmax <= 1e-12 or gmax
    <= threshold (ops/eps_model.py:334-345 of the JAX package)."""
    gmax = _row_norm_max(g, mask)
    thr = 1.0e-9 * pair_distance_median(q, mask)
    return (gmax <= 1.0e-12) | (gmax <= thr), gmax, thr


def eps_star_and_grad(q, m, *, h0, alpha, eps_min, eps_max,
                      eta: float = 1.35, clamp: bool = False, mask=None,
                      lam_align: float = 0.3, use_fallback: bool = True):
    """(eps*, d eps*/dq) of ``eps_target_production`` on (B, N, d)
    positions, with the reference's fallback semantics
    (ops/eps_model.py:308-358 of the JAX package, its XLA evaluation).

    The gradient is autograd through the 8 SPH iterations (convergence
    freeze included), non-finite entries zeroed and masked rows zeroed.
    With ``use_fallback`` (the "reference" gradient mode), a system whose
    gradient degenerates (largest valid row norm <= 1e-12, or <= 1e-9
    times the median pair distance) takes the Omega-corrected SPH
    gradient instead, sign-aligned against the legacy gradient of
    strength ``lam_align`` (``aligned_omega_grad``)."""
    with torch.enable_grad():
        qg = q.detach().requires_grad_(True)
        es = eps_target_production(qg, m, h0=h0, alpha=alpha,
                                   eps_min=eps_min, eps_max=eps_max, eta=eta,
                                   clamp=clamp, mask=mask)
        (g,) = torch.autograd.grad(es.sum(), qg)
    g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    if mask is not None:
        g = g * mask[..., None].to(g.dtype)
    if not use_fallback:
        return es.detach(), g
    degenerate = degenerate_grad(g, q, mask)[0]
    g_fb = aligned_omega_grad(q, m, h0=h0, alpha=alpha, eps_min=eps_min,
                              eps_max=eps_max, eta=eta, lam_align=lam_align,
                              mask=mask)
    return es.detach(), torch.where(degenerate[..., None, None], g_fb, g)


def aligned_omega_grad(q, m, *, h0, alpha, eps_min, eps_max,
                       eta: float = 1.35, lam_align: float = 0.3, mask=None):
    """``production_grad_omega`` with its sign flipped where its dot
    product with the legacy gradient (``ops/softening.py``, the
    reference's sign convention) is negative (hamsoft_eps_model.py:
    218-227): the reference's fallback gradient."""
    g = production_grad_omega(q, m, h0=h0, alpha=alpha, eps_min=eps_min,
                              eps_max=eps_max, eta=eta, mask=mask)
    g_ref = legacy_soft.grad_eps_target(q, lam=lam_align, mask=mask)
    dot = (g * g_ref).sum((-2, -1))
    flip = (torch.isfinite(dot) & (dot < 0.0))[..., None, None]
    return torch.where(flip, -g, g)


def production_grad_omega(q, m, *, h0, alpha, eps_min, eps_max,
                          eta: float = 1.35, mask=None):
    """The reference's Omega-corrected SPH gradient
    (hamsoft_eps_model.py:451-556) on (B, N, d) positions: from the
    unclamped SPH derivative chain, omega_i = softmax(-h_i/alpha),
    Omega_i = 1 + h_i Sd_i / (2 Sigma_i), P_i = -h_i / (2 Sigma_i Omega_i)
    and the pairwise-antisymmetric accumulation of s_i m_j gradW(r_ij, h_i)
    with s_i = -omega_i P_i."""
    a = torch.minimum(eps_min, eps_max)
    b = torch.maximum(eps_min, eps_max)
    eps_floor = torch.clamp_min(a, 1.0e-12)
    eps_cap = torch.maximum(eps_floor, b)
    h = solve_hi(q, m, h0=h0, eps_floor=eps_floor, eps_cap=eps_cap, eta=eta,
                 mask=mask)
    h_clamp_min = torch.clamp_min(0.1 * torch.clamp_min(eps_min, 1e-12),
                                  1.0e-12)
    hj = torch.maximum(h, h_clamp_min[..., None])

    t = -h / alpha[..., None]
    if mask is not None:
        t = torch.where(mask, t, torch.full_like(t, -math.inf))
    et = torch.exp(t - t.amax(-1, keepdim=True))
    omega = et / torch.clamp_min(et.sum(-1, keepdim=True), 1e-300)

    diff = pair_diff(q)
    r2 = (diff * diff).sum(-1)
    pm = pair_mask(q.shape[-2], mask, q.device).to(q.dtype)
    c = 1.0 / (math.pi * hj * hj)
    W = c[..., None] * torch.exp(-r2 / (hj * hj)[..., None]) * pm
    dWh = W * (-2.0 / hj[..., None] + 2.0 * r2 / (hj ** 3)[..., None])
    Sigma = torch.clamp_min((W * m[..., None, :]).sum(-1), 1e-30)
    Sd = (dWh * m[..., None, :]).sum(-1)

    Omega = 1.0 + hj * Sd / (2.0 * Sigma)
    Omega = torch.where(torch.isfinite(Omega) & (Omega != 0.0), Omega,
                        torch.ones_like(Omega))
    P = -hj / (2.0 * Sigma * Omega)
    s = -omega * P

    coef = (-2.0 * W / (hj * hj)[..., None]) * (s[..., :, None]
                                                * m[..., None, :])
    A = coef[..., None] * diff
    g = A.sum(-2) - A.sum(-3)
    g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    if mask is not None:
        g = g * mask[..., None].to(q.dtype)
    return g
