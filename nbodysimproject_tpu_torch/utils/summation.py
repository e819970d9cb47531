"""Compensated summation.

Counterpart of ``nbodysimproject_tpu/utils/summation.py``: the
reference's float128 energy sums become float64 + Kahan summation.
"""

from __future__ import annotations

import torch


def two_sum(a, b):
    """Error-free transform: (s, err) with a + b = s + err exactly
    (minbody/softening_manager.py:91-96)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def kahan_sum(x):
    """Kahan-compensated sum over the last axis, in element order
    (minbody/hamsoft_utils.py:214).  Meant for the short pair lists of
    few-body systems, batched over the leading axes."""
    # zeros derived from the data, as the JAX version's carry: a
    # non-finite element makes the whole sum non-finite
    s = x.sum(-1) * 0.0
    c = s.clone()
    for k in range(x.shape[-1]):
        y = x[..., k] - c
        t = s + y
        c = (t - s) - y
        s = t
    return s


def pairwise_sum(x):
    """Pairwise (cascade) sum of all elements (minbody/hamsoft_utils.py:
    188-201): zero-padded to the next power of two, then halves added
    level by level, as the JAX version does."""
    x = torch.as_tensor(x).reshape(-1)
    n = x.shape[0]
    if n == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    p = 1
    while p < n:
        p *= 2
    x = torch.cat([x, x.new_zeros(p - n)])
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]
