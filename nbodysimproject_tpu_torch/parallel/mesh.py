"""Device-mesh helpers.

Counterpart of ``nbodysimproject_tpu/parallel/mesh.py``: the batch axis
is data-parallel over a 1-D mesh; systems are independent, so the only
collectives are dataset-level reductions.  Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the processes of the
default process group, one device per process (each process's current
card unless the caller passes ``device="cpu"``, as the JAX package's
mesh spans the accelerators), and a batch is placed on that device with
``DTensor`` placements:
``Shard(0)`` (each process holds its contiguous block of systems) or
``Replicate()``.  As in the JAX package, the batch axis must divide by
the mesh size (``pad_to_multiple`` pads it).

Under the port's gloo group a mesh on the card places data and no
more: its DTensors' collectives (``full_tensor``, ``redistribute``)
go through gloo's all-gather of card tensors, which crashed the process
(a segmentation fault, torch 2.11 on an H100).  Each process reads its
shard with ``to_local()``; the dataset path needs nothing else.

A batch is a tensor, a ``SimState`` / ``DynParams`` (any dataclass of
tensors), or a dict, list or tuple of them.
"""

from __future__ import annotations

import dataclasses

import torch

DATA_AXIS = "data"


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _leaves(tree):
    out = []
    _tree_map(lambda x: out.append(x) or x, tree)
    return out


def _dtensor():
    try:
        from torch.distributed.tensor import DTensor, Replicate, Shard
    except ImportError:  # torch < 2.5
        from torch.distributed._tensor import DTensor, Replicate, Shard
    return DTensor, Replicate, Shard


def make_mesh(n_devices: int | None = None, device=None):
    """A 1-D mesh named ``DATA_AXIS`` over the first ``n_devices``
    processes (default: all) of the initialised default process group
    (``parallel/distributed.py::initialize_distributed``), whose shards
    live on ``device`` (``None``: the card).  Placing a batch needs no
    collective, so the mesh may be "cuda" under the port's gloo group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..core.device import resolve_device

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(initialize_distributed): one process per "
                           "device")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return DeviceMesh(resolve_device(device).type, list(range(n)),
                      mesh_dim_names=(DATA_AXIS,))


def _local(x, mesh):
    """``x`` on this process's device of the mesh (its current card)."""
    return x.to(mesh.device_type)


def shard_batch(tree, mesh):
    """Every tensor of ``tree`` (the same global batch on every process)
    as a ``DTensor`` whose leading axis is sharded over the mesh: this
    process keeps its contiguous block of rows, on the mesh's device."""
    DTensor, _Replicate, Shard = _dtensor()
    n = mesh.size()
    i = mesh.get_local_rank()

    def put(x):
        if x.shape[0] % n:
            raise ValueError(f"batch axis {x.shape[0]} does not divide by "
                             f"the mesh size {n}: pad_to_multiple first")
        local = _local(x.chunk(n, dim=0)[i].contiguous(), mesh)
        return DTensor.from_local(local, mesh, [Shard(0)], run_check=False)

    return _tree_map(put, tree)


def replicate(tree, mesh):
    DTensor, Replicate, _Shard = _dtensor()
    return _tree_map(lambda x: DTensor.from_local(
        _local(x, mesh), mesh, [Replicate()], run_check=False), tree)


def pad_to_multiple(tree, multiple: int):
    """Pad the leading batch axis to a multiple of ``multiple`` by
    repeating the last row (edge padding), returning (padded_tree,
    original_B)."""
    B = _leaves(tree)[0].shape[0]
    rem = (-B) % multiple
    if rem == 0:
        return tree, B
    return _tree_map(lambda x: torch.cat(
        [x, x[-1:].expand((rem,) + tuple(x.shape[1:]))]), tree), B
