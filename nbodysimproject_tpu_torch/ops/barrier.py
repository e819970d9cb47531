"""Power-law wall potential confining eps in [eps_min, eps_max].

Counterpart of ``nbodysimproject_tpu/ops/barrier.py`` (parity:
``minbody/barrier.py``); elementwise on tensors of any shape.

U(eps) = (k_wall / (n-1)) (max(0, a-eps)^{n-1} + max(0, eps-b)^{n-1})
F(eps) = k_wall (max(0, a-eps)^{n-2} - max(0, eps-b)^{n-2})
K(eps) = k_wall (n-2) (max(0, a-eps)^{n-3} + max(0, eps-b)^{n-3})
"""

from __future__ import annotations

import torch


def _k_eff(k_wall, like):
    k = torch.as_tensor(k_wall, dtype=like.dtype, device=like.device)
    return torch.where(torch.isfinite(k) & (k > 0.0), k, torch.zeros_like(k))


def _powm(x, e: int):
    """x**e with the reference's e == 0 convention: only strictly
    positive overhangs contribute 1 (minbody/barrier.py:98-106)."""
    if e == 0:
        return (x > 0.0).to(x.dtype)
    return x ** e


def barrier_energy(eps, eps_min, eps_max, *, k_wall=1.0e9, n: int = 5):
    if n < 2:
        return torch.zeros_like(eps)
    a = torch.minimum(eps_min, eps_max)
    b = torch.maximum(eps_min, eps_max)
    left = torch.clamp_min(a - eps, 0.0)
    right = torch.clamp_min(eps - b, 0.0)
    power = n - 1
    return (_k_eff(k_wall, eps) / power) * (left ** power + right ** power)


def barrier_force(eps, eps_min, eps_max, *, k_wall=1.0e9, n: int = 5):
    if n < 2:
        return torch.zeros_like(eps)
    # the reference does NOT sort the bounds here (minbody/barrier.py:90)
    left = torch.clamp_min(eps_min - eps, 0.0)
    right = torch.clamp_min(eps - eps_max, 0.0)
    e = n - 2
    return _k_eff(k_wall, eps) * (_powm(left, e) - _powm(right, e))


def barrier_curvature(eps, eps_min, eps_max, *, k_wall=1.0e9, n: int = 5):
    """d2U/deps2; zero for n < 3 (minbody/barrier.py:116-144, whose plain
    power makes n == 3 give 2 k_wall everywhere: 0**0 == 1)."""
    if n < 3:
        return torch.zeros_like(eps)
    a = torch.minimum(eps_min, eps_max)
    b = torch.maximum(eps_min, eps_max)
    left = torch.clamp_min(a - eps, 0.0)
    right = torch.clamp_min(eps - b, 0.0)
    return _k_eff(k_wall, eps) * (n - 2) * (left ** (n - 3)
                                            + right ** (n - 3))
