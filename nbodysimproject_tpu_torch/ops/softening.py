"""Legacy eps* target: harmonic mean over pair distances, batched.

Counterpart of ``nbodysimproject_tpu/ops/softening.py`` (parity:
``minbody/softening.py``).  eps* = lam * M / sum_{i<j} 1/(r_ij + delta)
with M the number of valid bodies and delta = 1e-12.  Only the value is
on this slice's path (``cfg.use_legacy_eps_star``); the legacy gradient
feeds the "reference" gradient mode, which is not ported yet.
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
