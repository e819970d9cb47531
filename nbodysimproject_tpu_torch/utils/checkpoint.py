"""Checkpoint and resume for simulation state.

Counterpart of ``nbodysimproject_tpu/utils/checkpoint.py`` (parity: the
reference keeps only in-memory snapshot dicts, simulation.py:324-484):
a batched ``(SimState, DynParams)`` and a JSON ``meta`` dict in one
NumPy ``.npz`` archive, in the JAX package's layout, so a checkpoint
written by either package loads in the other bit for bit:

    state.<field>   one array per ``SimState`` field (``mass``, ``pos``,
                    ..., ``mask``), as stored
    dyn.<field>     one array per ``DynParams`` field (``n_sub`` int32)
    __meta__        the JSON of ``meta`` as uint8 bytes

The JAX package's Orbax pair (``save_checkpoint_orbax`` /
``load_checkpoint_orbax``) writes a JAX-only format and is not ported,
like ``utils/aot_cache.py`` (``jax.export`` programs).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.state import DynParams, SimState


def save_checkpoint(path: str, states: SimState, dyns: DynParams,
                    meta: dict | None = None) -> None:
    """Write (states, dyns, meta); ``path`` gets ``.npz``."""
    payload = {}
    for prefix, tree in (("state", states), ("dyn", dyns)):
        for f in dataclasses.fields(tree):
            leaf = getattr(tree, f.name)
            payload[f"{prefix}.{f.name}"] = (
                leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                else np.asarray(leaf))
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path if path.endswith(".npz") else path + ".npz", **payload)


def load_checkpoint(path: str, dtype=None, device=None):
    """(states, dyns, meta) as tensors on ``device`` (``None``: the
    card; ``"cpu"`` the CPU); ``dtype`` (a torch dtype) casts the
    floating fields."""
    dev = resolve_device(device)
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as z:
        meta = (json.loads(bytes(z["__meta__"]).decode())
                if "__meta__" in z else {})

        def build(cls, prefix):
            kwargs = {}
            for f in dataclasses.fields(cls):
                t = torch.from_numpy(np.array(z[f"{prefix}.{f.name}"]))
                if dtype is not None and t.is_floating_point():
                    t = t.to(dtype)
                kwargs[f.name] = t.to(dev)
            return cls(**kwargs)

        return build(SimState, "state"), build(DynParams, "dyn"), meta
