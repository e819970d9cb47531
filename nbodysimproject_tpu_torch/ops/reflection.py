"""eps-wall reflection for the extended phase space (eps, pi), batched.

Counterpart of ``reflect_if_needed`` of
``nbodysimproject_tpu/ops/reflection.py`` (parity:
``minbody/hamsoft_utils.py:159-184``): the closed-form triangle-wave fold
of eps into [eps_min, eps_max] with period 2 (eps_max - eps_min), pi
flipped on odd reflections.  Elementwise on tensors of any shape.  The
billiard-flight variants (``symplectic_bounce`` and the functions built
on it) are not on the ported paths.
"""

from __future__ import annotations

import torch


def reflect_if_needed(eps, pi, eps_min, eps_max):
    """Fold (eps, pi) into [a, b]; a degenerate interval (b <= a or a
    non-finite width) returns (a, -pi), as the reference does."""
    a, b = eps_min, eps_max
    R = b - a
    P = 2.0 * R
    y = torch.where(P > 0.0, torch.remainder(eps - a, P), torch.zeros_like(R))
    on_up = y <= R
    e_out = torch.where(on_up, a + y, b - (y - R))
    p_out = torch.where(on_up, pi, -pi)
    ok = torch.isfinite(R) & (R > 0.0)
    return torch.where(ok, e_out, a), torch.where(ok, p_out, -pi)
