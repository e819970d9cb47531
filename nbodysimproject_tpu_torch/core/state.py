"""Simulation state and per-system dynamic parameters.

Counterpart of ``nbodysimproject_tpu/core/state.py``.  The JAX package
keeps one system unbatched and vmaps; here both dataclasses hold
batched tensors with a leading system axis B:

* ``SimState``  — everything that evolves during integration:
  ``mass (B, N)``, ``pos``/``vel (B, N, d)``, per-system scalars
  ``(B,)`` and ``mask (B, N)`` bool.
* ``DynParams`` — per-system scalars fixed at construction and
  calibration, each ``(B,)`` (``n_sub`` int32).

Field names are the JAX package's, so a state built there carries over
with ``state_from_numpy``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass(frozen=True)
class SimState:
    mass: Any
    pos: Any
    vel: Any
    eps: Any
    pi: Any
    s: Any
    step_s2: Any
    softening_energy_delta: Any
    hist_count: Any
    hist_sum: Any
    hist_sumsq: Any
    mask: Any

    @property
    def n_slots(self) -> int:
        return self.pos.shape[-2]

    @property
    def dim(self) -> int:
        return self.pos.shape[-1]

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    def take(self, idx) -> "SimState":
        """Rows ``idx`` of every field (a gather along the system axis)."""
        return SimState(**{f.name: getattr(self, f.name)[idx]
                           for f in dataclasses.fields(self)})

    def momenta(self):
        return self.mass[..., :, None] * self.vel


@dataclass(frozen=True)
class DynParams:
    G: Any
    s0: Any
    min_softening: Any
    max_softening: Any
    softening_scale: Any
    k_soft: Any
    mu_soft: Any
    chi_eps: Any
    k_wall: Any
    alpha_run: Any
    omega_spr0: Any
    h_sub_ref: Any
    n_sub: Any              # int32
    frozen_dt: Any

    def replace(self, **kw) -> "DynParams":
        return dataclasses.replace(self, **kw)

    def take(self, idx) -> "DynParams":
        return DynParams(**{f.name: getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)})


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))
DYN_FIELDS = tuple(f.name for f in dataclasses.fields(DynParams))


def state_from_numpy(arrays: dict, *, device=None, dtype=None):
    """Build the port's batched ``(SimState, DynParams)`` from a dict of
    numpy arrays keyed by field name — e.g. the JAX package's built
    ``states``/``dyns`` converted with ``np.asarray``, for any integrator
    mode (the classical modes' ``h_sub_ref``, ``frozen_dt`` and ``n_sub``
    are fields like the others).  Float fields are cast to ``dtype``
    (default: the dtype of ``pos``), ``mask`` to bool and ``n_sub`` to
    int32.  ``device`` defaults to the CPU because the
    arrays come from the host."""
    dev = torch.device("cpu" if device is None else device)
    if dtype is None:
        dtype = torch.from_numpy(
            np.zeros(0, np.asarray(arrays["pos"]).dtype)).dtype

    def conv(name):
        a = np.asarray(arrays[name])
        if name == "mask":
            return torch.as_tensor(a.astype(bool), device=dev)
        if name == "n_sub":
            return torch.as_tensor(a.astype(np.int32), device=dev)
        return torch.as_tensor(a, dtype=dtype, device=dev)

    state = SimState(**{k: conv(k) for k in STATE_FIELDS})
    dyn = DynParams(**{k: conv(k) for k in DYN_FIELDS})
    return state, dyn


def build_state(masses, positions, velocities, *, eps, n_slots=None,
                dim=None, dtype=torch.float64, device=None):
    """A padded one-system batch (B = 1) from array-likes, the JAX
    package's ``build_state`` (parity: simulation_state.py:98-144) with
    the port's leading system axis: velocities broadcast from one (d,)
    vector; padding slots get mass 0 and ``mask`` False.  ``device=None``
    is the card."""
    from .device import resolve_device

    dev = resolve_device(device)
    m = np.asarray(masses, dtype=np.float64).ravel()
    q = np.atleast_2d(np.asarray(positions, dtype=np.float64))
    v = np.asarray(velocities, dtype=np.float64)
    n = m.size
    d = q.shape[1] if dim is None else dim
    if v.ndim == 1:
        v = np.broadcast_to(v, (n, d)).copy()
    v = np.atleast_2d(v)
    slots = n if n_slots is None else int(n_slots)
    if slots < n:
        raise ValueError(f"n_slots={slots} < n_bodies={n}")

    def pad(a):
        out = np.zeros((1, slots) + a.shape[1:], dtype=np.float64)
        out[0, :n] = a
        return torch.as_tensor(out, dtype=dtype, device=dev)

    mask = torch.zeros((1, slots), dtype=torch.bool, device=dev)
    mask[0, :n] = True
    full = lambda x: torch.full((1,), float(x), dtype=dtype, device=dev)
    eps = float(eps)
    return SimState(
        mass=pad(m), pos=pad(q), vel=pad(v), eps=full(eps), pi=full(0.0),
        s=full(eps), step_s2=full(eps * eps),
        softening_energy_delta=full(0.0), hist_count=full(1.0),
        hist_sum=full(eps), hist_sumsq=full(eps * eps), mask=mask)


def remove_center_of_mass_velocity(mass, vel, mask=None):
    """Project out the COM velocity per system (B, N, d)
    (minbody/physics_utils.py:16-26)."""
    if mask is not None:
        mass = mass * mask.to(mass.dtype)
    M = mass.sum(-1)
    vcom = (mass[..., None] * vel).sum(-2) / torch.where(
        M > 0, M, torch.ones_like(M))[..., None]
    out = vel - vcom[..., None, :]
    if mask is not None:
        out = torch.where(mask[..., None], out, vel)
    return out
