"""Compensated summation.

Counterpart of ``nbodysimproject_tpu/utils/summation.py``: the
reference's float128 energy sums become float64 + Kahan summation.
"""

from __future__ import annotations

import torch


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
