"""Running-moment helpers of the stability analysis.

Counterpart of the helpers of ``nbodysimproject_tpu/analysis/stability.py``
that the fused engine uses; the JAX package's scan engine
(``analyze_system``/``analyze_batch_jit``) is not part of this slice.
Elementwise on (B,) tensors.
"""

from __future__ import annotations

import torch


def _running_update(acc, x):
    """(count, sum, sumsq, max, min) running-moment update."""
    cnt, s, s2, mx, mn = acc
    return (cnt + 1.0, s + x, s2 + x * x, torch.maximum(mx, x),
            torch.minimum(mn, x))


def _mean(acc):
    return acc[1] / torch.clamp_min(acc[0], 1.0)


def _std(acc):
    cnt = torch.clamp_min(acc[0], 1.0)
    m = acc[1] / cnt
    return torch.sqrt(torch.clamp_min(acc[2] / cnt - m * m, 0.0))


def _rel_drift(x1, x0):
    """abs((x1-x0)/x0) with the reference's fallbacks
    (stability_analyzer.py:147-175)."""
    ok_rel = torch.isfinite(x0) & (torch.abs(x0) > 0.0) & torch.isfinite(x1)
    ok_abs = torch.isfinite(x0) & torch.isfinite(x1)
    rel = torch.abs((x1 - x0) / torch.where(x0 != 0, x0, torch.ones_like(x0)))
    return torch.where(ok_rel, rel,
                       torch.where(ok_abs, torch.abs(x1 - x0),
                                   torch.full_like(x0, float("inf"))))
