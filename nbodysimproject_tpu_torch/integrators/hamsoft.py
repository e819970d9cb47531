"""ham_soft pieces that construction and the energy diagnostic call.

Counterpart of part of ``nbodysimproject_tpu/integrators/hamsoft.py``:
the barrier-policy resolution and the eps* target.  The Strang flows
themselves run inside the analysis kernels (``ops/hamsoft_kernels.py``);
the JAX package's scan engine is not part of this slice.
"""

from __future__ import annotations

import torch

from ..ops import eps_model as epsmod
from ..ops import softening as legacy_soft


def policy_is_soft(cfg) -> bool:
    """barrier_policy resolution (HSI:447-474): "soft" iff
    cfg.use_soft_barrier and not cfg.disable_barrier."""
    return bool(cfg.use_soft_barrier) and not bool(cfg.disable_barrier)


def eps_target(state, dyn, cfg, q=None):
    """eps* (B,) honouring the fixed/legacy/production mode selection
    (hamsoft_eps_model.py:78-91)."""
    q = state.pos if q is None else q
    if cfg.fixed_eps_star:
        v = cfg.eps_star_value
        if v is not None and v == v:
            return torch.full(q.shape[:-2], float(v), dtype=q.dtype,
                              device=q.device)
        return dyn.s0
    if cfg.use_legacy_eps_star:
        return legacy_soft.eps_target(q, lam=cfg.lambda_softening,
                                      mask=state.mask)
    return epsmod.eps_target_production(
        q, state.mass, h0=state.eps, alpha=dyn.alpha_run,
        eps_min=dyn.min_softening, eps_max=dyn.max_softening, eta=cfg.eta,
        clamp=policy_is_soft(cfg), mask=state.mask)
