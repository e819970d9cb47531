"""Legacy eps* target: harmonic mean over pair distances, batched.

Counterpart of ``nbodysimproject_tpu/ops/softening.py`` (parity:
``minbody/softening.py``).  eps* = lam * M / sum_{i<j} 1/(r_ij + delta)
with M the number of valid bodies and delta = 1e-12.  The value serves
``cfg.use_legacy_eps_star``; the gradient aligns the sign of
``integrators/hamsoft.py::grad_eps_target``.
"""

from __future__ import annotations

import torch

from .geometry import pair_diff, pair_mask

_DELTA = 1.0e-12


def eps_target(q, *, lam: float = 0.3, mask=None):
    n = q.shape[-2]
    diff = pair_diff(q)
    r = torch.sqrt((diff * diff).sum(-1))
    pm = pair_mask(n, mask, q.device)
    inv_den = torch.where(pm, 1.0 / (r + _DELTA), torch.zeros_like(r))
    D = 0.5 * inv_den.sum((-2, -1))
    if mask is not None:
        M = mask.to(q.dtype).sum(-1)
    else:
        M = torch.full(q.shape[:-2], float(n), dtype=q.dtype, device=q.device)
    eps_star = lam * M / D
    good = torch.isfinite(D) & (D > 0.0) & torch.isfinite(eps_star)
    return torch.where(good, eps_star, torch.zeros_like(eps_star))


def grad_eps_target(q, *, lam: float = 0.3, mask=None):
    """Gradient of the legacy target with the reference's sign convention
    (minbody/softening.py:86-131); (B, N, d)."""
    n = q.shape[-2]
    diff = pair_diff(q)
    r = torch.sqrt((diff * diff).sum(-1))
    pm = pair_mask(n, mask, q.device)
    zero = torch.zeros_like(r)
    r_safe = torch.clamp_min(r, 1.0e-15)
    den = r_safe + _DELTA
    D = 0.5 * torch.where(pm, 1.0 / den, zero).sum((-2, -1))
    if mask is not None:
        M = mask.to(q.dtype).sum(-1)
    else:
        M = torch.full(q.shape[:-2], float(n), dtype=q.dtype, device=q.device)
    c_pref = lam * M / (D * D)
    A = torch.where(pm, 1.0 / (r_safe * den * den), zero)
    grad = -c_pref[..., None, None] * (A[..., None] * diff).sum(-2)
    good = (torch.isfinite(D) & (D > 0.0))[..., None, None]
    grad = torch.where(good, grad, torch.zeros_like(grad))
    return torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
