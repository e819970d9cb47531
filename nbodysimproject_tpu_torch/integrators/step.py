"""Macro step: the substep loop with the softening-manager protocol,
batched.

Counterpart of ``nbodysimproject_tpu/integrators/step.py`` (parity:
integrator.py:78-104 and :200-227, softening_manager.py:186-372,
HSI:496-557).  Every function takes a batched state; ``dt`` is a float
or a (B,) tensor.

* ``macro_step`` / ``integrate``: a static substep count for every
  system;
* ``macro_step_dynamic`` / ``integrate_dynamic``: each system runs its
  own ``dyn.n_sub`` substeps of h = dt / n_sub.  The loop runs to the
  largest count present (at most ``n_sub_max``), and trip i updates
  only the systems with i < n_sub (identity elsewhere), as the JAX
  package's masked scan does; trips no system is active in are exact
  identities and are skipped.

ham_soft threads the (eps*, grad) cache across substep boundaries
(``strang_substep_cached``).  Every integrator mode of the JAX package
has its substep: verlet, yoshida4, ham_soft, whfast
(``integrators/whfast.py``) and the Kepler-split tail's kepler_split
(``integrators/kepler_split.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from .classical import adaptive_softening_refresh, verlet_kernel, \
    yoshida4_kernel
from .hamsoft import strang_substep, strang_substep_cached
from .kepler_split import kepler_split_substep
from .whfast import whfast_substep


def begin_step(state, cfg):
    """softening_manager.begin_step (:186-199): ham_soft mirrors eps into
    s; classical freezes step_s2 = s^2; the history records s."""
    s = state.eps if cfg.integrator_mode == "ham_soft" else state.s
    state = state.replace(s=s, step_s2=s * s)
    return state.replace(hist_count=state.hist_count + 1.0,
                         hist_sum=state.hist_sum + s,
                         hist_sumsq=state.hist_sumsq + s * s)


def finish_step(state, cfg):
    """softening_manager.finish_step (:355-372)."""
    if cfg.integrator_mode == "ham_soft":
        return state.replace(s=state.eps, step_s2=state.eps * state.eps)
    return state


def substep_fn(cfg):
    """The substep body for the integrator mode (integrator.py:200-227).
    kepler_split freezes eps, so no adaptive refresh applies to it."""
    mode = cfg.integrator_mode
    if mode == "ham_soft":
        return strang_substep
    if mode == "kepler_split":
        return kepler_split_substep
    kernel = {"yoshida4": yoshida4_kernel,
              "whfast": whfast_substep}.get(mode, verlet_kernel)
    if not cfg.adaptive_softening:
        return kernel

    def with_refresh(state, dyn, cfg, h):
        state = kernel(state, dyn, cfg, h)
        return adaptive_softening_refresh(state, dyn, cfg)

    return with_refresh


def _per_system(dt, like):
    t = torch.as_tensor(dt, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(t, like.shape[:1])


def _select(active, new, old):
    """Field by field: ``new`` on the active systems, ``old`` elsewhere
    (``None`` for an empty (eps*, grad) cache: ``freeze_s_subsystem``
    runs no SPH solve)."""
    if new is None:
        return old

    def sel(a, b):
        if a is b:
            return a
        c = active.reshape(active.shape + (1,) * (a.dim() - 1))
        return torch.where(c, a, b)

    if isinstance(new, tuple):
        return tuple(sel(a, b) for a, b in zip(new, old))
    return new.replace(**{f.name: sel(getattr(new, f.name),
                                      getattr(old, f.name))
                          for f in dataclasses.fields(new)})


def macro_step(state, dyn, cfg, dt, n_sub: int):
    """One sim.step(dt) with the same static substep count everywhere."""
    dt = _per_system(dt, state.eps)
    h = dt / n_sub
    state = begin_step(state, cfg)
    if cfg.integrator_mode == "ham_soft":
        state, cache = strang_substep_cached(state, dyn, cfg, h, None)
        for _ in range(n_sub - 1):
            state, cache = strang_substep_cached(state, dyn, cfg, h, cache)
        return finish_step(state, cfg)
    body = substep_fn(cfg)
    for _ in range(n_sub):
        state = body(state, dyn, cfg, h)
    return finish_step(state, cfg)


def _trips(n_sub, n_sub_max: int) -> int:
    if n_sub.numel() == 0:
        return 0
    return min(int(n_sub_max), int(n_sub.max()))


def macro_step_dynamic(state, dyn, cfg, dt, n_sub_max: int, trips=None):
    """One sim.step(dt) with per-system n_sub = dyn.n_sub: trip i updates
    the systems with i < n_sub, each with its own h = dt / n_sub.
    ``trips`` (the loop length, read off ``dyn.n_sub`` when None) lets a
    caller read it once for many steps."""
    n_sub = torch.clamp_min(dyn.n_sub, 1)
    h = _per_system(dt, state.eps) / n_sub.to(state.pos.dtype)
    if trips is None:
        trips = _trips(n_sub, n_sub_max)
    state = begin_step(state, cfg)
    if cfg.integrator_mode == "ham_soft":
        # trip 0 is never masked (n_sub >= 1); a masked system's q is
        # unchanged, so its carried cache stays valid
        state, cache = strang_substep_cached(state, dyn, cfg, h, None)
        for i in range(1, trips):
            new, new_cache = strang_substep_cached(state, dyn, cfg, h, cache)
            keep = i < n_sub
            state = _select(keep, new, state)
            cache = _select(keep, new_cache, cache)
        return finish_step(state, cfg)
    body = substep_fn(cfg)
    for i in range(trips):
        state = _select(i < n_sub, body(state, dyn, cfg, h), state)
    return finish_step(state, cfg)


def integrate(state, dyn, cfg, dt, n_steps: int, n_sub: int):
    """n_steps macro steps with a static substep count."""
    for _ in range(int(n_steps)):
        state = macro_step(state, dyn, cfg, dt, n_sub)
    return state


def integrate_dynamic(state, dyn, cfg, dt, n_steps: int, n_sub_max: int):
    """n_steps macro steps with per-system n_sub."""
    trips = _trips(torch.clamp_min(dyn.n_sub, 1), n_sub_max)
    for _ in range(int(n_steps)):
        state = macro_step_dynamic(state, dyn, cfg, dt, n_sub_max, trips)
    return state
