"""Pairwise geometry on batched systems.

Counterpart of ``nbodysimproject_tpu/ops/geometry.py`` with a leading
system axis: positions are ``(B, N, d)``, masks ``(B, N)``.
"""

from __future__ import annotations

import torch


def pair_mask(n: int, mask=None, device=None):
    """(B, N, N) (or (N, N) without a mask) boolean mask of valid
    interacting pairs: off-diagonal, both endpoints valid."""
    dev = mask.device if mask is not None else device
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    if mask is None:
        return off
    m = mask.to(torch.bool)
    return m[..., :, None] & m[..., None, :] & off


def pair_diff(pos):
    """diff[..., i, j, :] = pos[..., i, :] - pos[..., j, :]."""
    return pos[..., :, None, :] - pos[..., None, :, :]


def pairwise_geometry(pos, eps=0.0, mask=None):
    """(diff, r2, inv_r3) — r2 unsoftened, inv_r3 = (r2 + eps^2)^{-3/2}
    zeroed on the diagonal and on masked pairs.  ``eps`` is a float or
    a (B,) tensor."""
    n = pos.shape[-2]
    diff = pair_diff(pos)
    r2 = (diff * diff).sum(-1)
    pm = pair_mask(n, mask, pos.device)
    e = torch.as_tensor(eps, dtype=pos.dtype, device=pos.device)
    if e.dim():
        e = e[..., None, None]
    r2_soft = r2 + e * e
    valid = pm & (r2_soft > 0.0)
    safe = torch.where(valid, r2_soft, torch.ones_like(r2_soft))
    inv_r3 = torch.where(valid, safe ** (-1.5), torch.zeros_like(safe))
    return diff, r2, inv_r3


def geometry_buffers(pos, eps=0.0, mask=None):
    """``pairwise_geometry`` under the reference's name."""
    return pairwise_geometry(pos, eps=eps, mask=mask)


def triu_pairs(n: int, device=None):
    """Row-major i < j pair indices (``jnp.triu_indices(n, 1)``)."""
    return torch.triu_indices(n, n, 1, device=device).unbind(0)


def pairwise_r2(pos, mask=None):
    """Unsoftened pairwise squared distances with ``inf`` on the diagonal
    and on masked pairs (the reference's ``fill_diagonal(r2, inf)``)."""
    diff = pair_diff(pos)
    r2 = (diff * diff).sum(-1)
    pm = pair_mask(pos.shape[-2], mask, pos.device)
    return torch.where(pm, r2, torch.full_like(r2, float("inf")))


def min_separation(pos, mask=None):
    """Minimum pairwise distance per system, floored at 1e-12
    (minbody/simulation.py:659-665)."""
    r2 = pairwise_r2(pos, mask)
    return torch.clamp_min(torch.sqrt(r2.amin((-2, -1))), 1e-12)
