"""Tiled exact O(N^2) softened force for large-N systems.

Counterpart of ``nbodysimproject_tpu/ops/pallas_kernels.py``:
``pairwise_force`` replaces the TPU kernel ``pairwise_force_pallas``
(body ``_force_kernel``).  It computes, for each system of a batch,

    F_i = m_i G sum_j -m_j (q_i - q_j) / (r_ij^2 + eps^2)^{3/2},

a pair counting only where i != j and r_ij^2 + eps^2 > 0, with the sum
taken in two levels as the TPU kernel takes it: a partial sum over each
tile of ``TJ`` sources, subtracted from a running accumulator, then G,
then m_i.  The system is taken as unpadded (no mask, as in the JAX
package): a zero-mass slot adds nothing to the other bodies' forces and
receives F = 0.  ``eps`` and ``G`` are per system.  Its callers are
``ops/forces.py::force_auto`` (``cfg.use_pallas_forces``), the
``direct_pallas`` route of ``integrators/largen.py`` and the many-planet
WHFast kick.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/pairwise_force.cu`` (d = 2 or 3; see its source note for what
bounds it), splitting the sources into ``source_slices`` slices where
the grid would leave SMs idle.  The kernel computes in float32, as the
compiled JAX path does: a float64 CUDA tensor is cast to float32 and the
result cast back.
On a CPU tensor the wrapper runs the plain PyTorch version beside it,
in the input's dtype.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = "pairwise_force.cu"
#: sources per tile of the two-level sum (the kernel's kTJ and the TPU
#: kernel's default tj)
TJ = 512
#: target bodies per block (the kernel's kTI)
TI = 256
#: source slices start on multiples of SG sources (the kernel's kSG)
SG = 64
#: dimensions the kernel is built for
DIMS = (2, 3)
#: elements of the plain version's largest (rows, TJ, d) block
_PLAIN_BLOCK = 1 << 24

_P = ctypes.c_void_p
_I = ctypes.c_int


def build_jobs():
    """(source, N, d) build jobs: the kernel takes any N, so N is 0."""
    return [(SOURCE, 0, d) for d in DIMS]


@functools.lru_cache(maxsize=None)
def _library(d: int):
    lib = cuda_build.load(SOURCE, 0, d)
    lib.hs_pairwise_force.argtypes = [_P] * 6 + [_I, _I, _I, _P]
    lib.hs_pairwise_force.restype = _I
    for name in ("hs_pairwise_tile_j", "hs_pairwise_block_i",
                 "hs_pairwise_slice_granule", "hs_pairwise_blocks_per_sm"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _I
    if (lib.hs_pairwise_tile_j(), lib.hs_pairwise_block_i(),
            lib.hs_pairwise_slice_granule()) != (TJ, TI, SG):
        raise RuntimeError("pairwise_force: the kernel's tiles differ from "
                           f"TJ = {TJ}, TI = {TI}, SG = {SG}")
    return lib


def source_slices(n: int, B: int, n_sm: int, per_sm: int) -> int:
    """Slices of the sources for B systems of n bodies on a card of
    ``n_sm`` SMs that each hold ``per_sm`` blocks of the kernel: the most
    slices whose ceil(n / TI) B S blocks still fit in one wave, at least
    1 and at most the number of SG-source granules (each slice holds
    whole granules).  A function of its arguments alone, so a run is
    deterministic on a given card."""
    blocks = -(-n // TI) * B
    granules = -(-n // SG)
    return max(1, min(granules, (n_sm * per_sm) // max(blocks, 1)))


@functools.lru_cache(maxsize=None)
def _card_slots(index: int, d: int):
    """(SMs, blocks of the d kernel per SM) of card ``index``."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, _library(d).hs_pairwise_blocks_per_sm()


def _per_system(x, B, like):
    """A (B,) tensor like ``like`` from a scalar, 0-d or (B,) value."""
    t = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(t, (B,)).contiguous()


def _batched(pos, mass):
    """(pos (B, N, d), mass (B, N), whether a batch axis was added)."""
    if pos.dim() == 2:
        return pos[None], mass[None], True
    if pos.dim() != 3 or tuple(mass.shape) != tuple(pos.shape[:2]):
        raise ValueError(f"pairwise_force: pos must be (N, d) or (B, N, d) "
                         f"and mass its leading shape; got "
                         f"{tuple(pos.shape)} and {tuple(mass.shape)}")
    return pos, mass, False


def pairwise_force_plain(pos, mass, eps, G, *, tj: int = TJ, rows=None):
    """The plain PyTorch version of ``pairwise_force``, on any device and
    in the input's dtype.

    Loops over source tiles of ``tj`` and takes the kernel's two-level
    sum; target rows go in chunks, so memory stays bounded at large N.
    ``rows`` (1-D indices) computes only those target rows of every
    system: the result is then (B, len(rows), d)."""
    pos, mass, squeeze = _batched(pos, mass)
    B, n, d = pos.shape
    eps = _per_system(eps, B, pos)
    G = _per_system(G, B, pos)
    eps2 = (eps * eps)[:, None, None]
    idx = torch.arange(n, device=pos.device) if rows is None else \
        torch.as_tensor(rows, device=pos.device).reshape(-1)
    out = torch.empty((B, idx.numel(), d), dtype=pos.dtype,
                      device=pos.device)
    chunk = max(1, _PLAIN_BLOCK // (B * tj * d))
    for r0 in range(0, idx.numel(), chunk):
        ii = idx[r0:r0 + chunk]
        xi = pos[:, ii]                                   # (B, R, d)
        acc = torch.zeros_like(xi)
        for j0 in range(0, n, tj):
            xj = pos[:, j0:j0 + tj]                       # (B, T, d)
            mj = mass[:, None, j0:j0 + tj]                # (B, 1, T)
            dx = xi[:, :, None, :] - xj[:, None, :, :]    # (B, R, T, d)
            d2 = dx[..., 0] * dx[..., 0]
            for a in range(1, d):
                d2 = d2 + dx[..., a] * dx[..., a]
            r2 = d2 + eps2
            jj = torch.arange(j0, j0 + xj.shape[1], device=pos.device)
            valid = (ii[:, None] != jj[None, :]) & (r2 > 0.0)
            inv_r = torch.rsqrt(torch.where(valid, r2, torch.ones_like(r2)))
            w = torch.where(valid, mj * inv_r * inv_r * inv_r,
                            torch.zeros_like(r2))
            acc = acc - (w[..., None] * dx).sum(2)
        out[:, r0:r0 + chunk] = (G[:, None, None] * acc) \
            * mass[:, ii, None]
    return out[0] if squeeze else out


def magnitude_sum(pos, mass, eps, G, *, rows=None):
    """S_i = G m_i sum_{j != i} m_j / (r_ij^2 + eps^2) of the target rows
    (B, len(rows)): it bounds the sum of the pair terms' magnitudes of
    F_i, so a row's rounding error is measured against it.  Chunked as
    ``pairwise_force_plain``."""
    pos, mass, squeeze = _batched(pos, mass)
    B, n, d = pos.shape
    eps2 = (_per_system(eps, B, pos) ** 2)[:, None, None]
    G = _per_system(G, B, pos)
    idx = torch.arange(n, device=pos.device) if rows is None else \
        torch.as_tensor(rows, device=pos.device).reshape(-1)
    out = torch.empty((B, idx.numel()), dtype=pos.dtype, device=pos.device)
    chunk = max(1, _PLAIN_BLOCK // (B * n))
    jj = torch.arange(n, device=pos.device)
    for r0 in range(0, idx.numel(), chunk):
        ii = idx[r0:r0 + chunk]
        diff = pos[:, ii, None, :] - pos[:, None, :, :]
        r2 = (diff * diff).sum(-1) + eps2
        terms = torch.where((ii[:, None] != jj[None, :]) & (r2 > 0.0),
                            mass[:, None, :] / r2, torch.zeros_like(r2))
        out[:, r0:r0 + chunk] = G[:, None] * mass[:, ii] * terms.sum(-1)
    return out[0] if squeeze else out


def pairwise_force(pos, mass, eps, G):
    """Softened direct forces (N, d) or (B, N, d) of unpadded systems:
    the CUDA kernel for CUDA tensors (float32; float64 is cast to float32
    and back, as the compiled JAX path does), the plain version for CPU
    tensors.  ``eps`` and ``G`` are scalars or (B,) tensors."""
    if pos.device.type == "cpu":
        return pairwise_force_plain(pos, mass, eps, G)
    if pos.device.type != "cuda":
        raise RuntimeError(f"pairwise_force: unsupported device {pos.device}")
    p3, m2, squeeze = _batched(pos, mass)
    B, n, d = p3.shape
    if d not in DIMS:
        raise NotImplementedError(
            f"pairwise_force: the kernel is built for d in {DIMS}; got d = "
            f"{d}")
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pairwise_force: float32 or float64 positions, got "
                        f"{pos.dtype}")
    f32 = lambda x: x.to(torch.float32).contiguous()
    p3, m2 = f32(p3), f32(m2)
    eps_b, G_b = (_per_system(x, B, p3) for x in (eps, G))
    lib = _library(d)
    out = torch.empty_like(p3)
    S = source_slices(n, B, *_card_slots(p3.device.index, d))
    part = out if S == 1 else torch.empty((S, B, n, d), dtype=torch.float32,
                                          device=p3.device)
    code = lib.hs_pairwise_force(
        *cuda_build.pointers(p3, m2, eps_b, G_b, out, part), B, n, S,
        cuda_build.stream_of(p3))
    cuda_build.check_launch(lib, code, "pairwise_force")
    pairwise_force.launches += 1
    out = out.to(pos.dtype)
    return out[0] if squeeze else out


pairwise_force.launches = 0
