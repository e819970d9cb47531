"""eps-wall reflection for the extended phase space (eps, pi), batched.

Counterpart of ``reflect_if_needed`` of
``nbodysimproject_tpu/ops/reflection.py`` (parity:
``minbody/hamsoft_utils.py:159-184``): the closed-form triangle-wave fold
of eps into [eps_min, eps_max] with period 2 (eps_max - eps_min), pi
flipped on odd reflections, and the billiard-flight variants built on it
(``symplectic_bounce`` :31, ``symplectic_reflect_eps`` :105 and
``reflect_and_limit_eps`` :234), in the same closed form: fold, fly
freely, fold again.  Elementwise on tensors of any shape; the
billiard-flight functions also take Python floats (float64 on the
CPU).
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


def _tensors(*xs):
    """``xs`` as tensors of the first tensor's dtype and device (float64
    on the CPU when every one is a Python number)."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    kw = dict(dtype=torch.float64) if like is None else \
        dict(dtype=like.dtype, device=like.device)
    return [torch.as_tensor(x, **kw) for x in xs]


def symplectic_bounce(eps, pi, eps_min, eps_max, h, mu):
    """Exact billiard flight for time h at velocity pi/mu inside
    [eps_min, eps_max] (minbody/hamsoft_utils.py:31-101): fold the
    incoming point, advance freely, fold again."""
    eps, pi, a, b, h, mu = _tensors(eps, pi, eps_min, eps_max, h, mu)
    mu = torch.where(mu == 0.0, torch.ones_like(mu), mu)
    ok = torch.isfinite(a) & torch.isfinite(b) & (b > a)
    eps0, pi0 = reflect_if_needed(eps, pi, a, b)
    e_out, pi_out = reflect_if_needed(eps0 + (pi0 / mu) * h, pi0, a, b)
    return torch.where(ok, e_out, a), torch.where(ok, pi_out, -pi)


def symplectic_reflect_eps(eps, pi, eps_min, eps_max, h=0.0, mu=1.0):
    """Fold, then bounce if h != 0 and pi != 0
    (minbody/hamsoft_utils.py:105-144)."""
    eps, pi, a, b, h, mu = _tensors(eps, pi, eps_min, eps_max, h, mu)
    e1, p1 = reflect_if_needed(eps, pi, a, b)
    e2, p2 = symplectic_bounce(e1, p1, a, b, h, mu)
    move = (torch.abs(h) > 0.0) & (p1 != 0.0)
    return torch.where(move, e2, e1), torch.where(move, p2, p1)


#: alias parity (minbody/hamsoft_utils.py:146-156)
reflect_eps_symplectic = symplectic_reflect_eps


def reflect_and_limit_eps(eps, pi, eps_min, eps_max, h, mu, *,
                          max_ratio: float = 2.0):
    """The bounded-ratio variant (minbody/hamsoft_utils.py:234-261)."""
    eps, pi, a, b, h, mu = _tensors(eps, pi, eps_min, eps_max, h, mu)
    e_new, p_new = symplectic_reflect_eps(eps, pi, a, b, h, mu)
    e_new = torch.minimum(torch.maximum(e_new, eps / max_ratio),
                          eps * max_ratio)
    return reflect_if_needed(e_new, p_new, a, b)
