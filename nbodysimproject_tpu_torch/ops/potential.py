"""Softened gravitational potential, batched.

Counterpart of ``nbodysimproject_tpu/ops/potential.py`` (parity:
``minbody/potential.py``).
"""

from __future__ import annotations

import torch

from .forces import dV_d_epsilon
from .geometry import pair_diff, pair_mask


def softened_potential(q, m, G, eps, mask=None):
    """U = -G sum_{i<j} m_i m_j / sqrt(r_ij^2 + eps^2) per system;
    ``G`` and ``eps`` are (B,) tensors or floats."""
    n = q.shape[-2]
    e = torch.as_tensor(eps, dtype=q.dtype, device=q.device)
    if e.dim():
        e = e[..., None, None]
    diff = pair_diff(q)
    r2 = (diff * diff).sum(-1) + e * e
    pm = pair_mask(n, mask, q.device)
    valid = pm & (r2 > 0.0)
    one = torch.ones_like(r2)
    inv_r = torch.where(valid, 1.0 / torch.sqrt(torch.where(valid, r2, one)),
                        torch.zeros_like(r2))
    mprod = m[..., :, None] * m[..., None, :]
    return -0.5 * G * (mprod * inv_r).sum((-2, -1))


def dU_d_eps(q, m, G, eps, mask=None):
    return dV_d_epsilon(q, m, eps, G, mask=mask)
