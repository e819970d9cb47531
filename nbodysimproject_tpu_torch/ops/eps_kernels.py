"""Fused (eps*, d eps*/dq) kernel for the ham_soft scan path.

Counterpart of ``nbodysimproject_tpu/ops/pallas_eps.py``:
``eps_star_and_grad_fused`` replaces the TPU kernel of the same name
(``_eps_grad_kernel``).  The ham_soft scan (``integrators/hamsoft.py``)
evaluates (eps*, grad) on every substep; on a float32 CUDA batch with at
most ``MAX_SLOTS`` body slots it calls this kernel instead of the
autograd evaluation of ``ops/eps_model.py``.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/eps_grad.cu`` (one thread per system on the physics of
``csrc/hamsoft_physics.cuh`` at N <= 3, one lane per body from N = 4;
see the source note for what bounds it) and nothing else: the kernel
reads the mask and the per-system rows where they lie.  On a CPU
tensor it runs the plain PyTorch version beside it, which is the
analysis kernels' plain physics (autograd through the 8 SPH
iterations).  There is no fallback from one to the other.

Semantics are the TPU kernel's: the 8 SPH iterations seeded from ``h0``
with no convergence freeze (a <= 1e-6 relative eps* difference from the
autograd evaluation, which keeps the freeze), the exact gradient of the
truncated map, with ``clamp`` the soft policy's value clamp with the
gradient zeroed where it saturates, and then, with ``use_fallback`` (the
"reference" gradient mode), the degeneracy fallback: where the gradient's
largest row norm is <= 1e-12 or <= 1e-9 times the median pair distance,
the Omega gradient on the final SPH iterate, sign-aligned against the
legacy gradient of strength ``lam_align``.  Masked slots carry mass 0.
The fallback is a build variant of the kernel (``"ref"``), so the exact
build holds none of it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .hamsoft_kernels import _Physics

SOURCE = "eps_grad.cu"
#: the scan path's gate (the JAX package's N <= 16)
MAX_SLOTS = 16
#: body-slot counts built ahead by ``build_jobs`` (any N <= MAX_SLOTS is
#: built on first use)
BUILD_SLOTS = (3, 8)
#: the dimensions the kernel takes
DIMS = (2, 3)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong


def build_jobs(slots=BUILD_SLOTS):
    return [(SOURCE, n, d) for d in DIMS for n in slots]


def variant(use_fallback: bool) -> str:
    """The build variant (``cuda_build.VARIANT_FLAGS``) of ``use_fallback``."""
    return "ref" if use_fallback else ""


@functools.lru_cache(maxsize=None)
def _library(n: int, d: int, var: str = ""):
    lib = cuda_build.load(SOURCE, n, d, var)
    lib.hs_eps_grad.argtypes = [_P] * 8 + [_I, _F, _F, _I, _P]
    lib.hs_eps_grad.restype = _I
    return lib


def _check(q) -> None:
    if q.dim() != 3 or q.shape[-1] not in DIMS:
        raise NotImplementedError(
            f"eps_star_and_grad_fused: ported for (B, N, d), d in {DIMS}; "
            f"got {tuple(q.shape)}")


def _rows(x, like):
    """A (B,) row like ``like`` from a tensor or scalar."""
    return torch.broadcast_to(torch.as_tensor(x, dtype=like.dtype,
                                              device=like.device),
                              like.shape[:1]).contiguous()


def _row_arg(x, B: int, device):
    """(pointer, element stride, value) of a per-system row for the
    kernel: a (B,), (1,) or () float32 tensor on ``device`` is read in
    place (stride 0 where it broadcasts), a Python number is passed by
    value.  No copy, no elementwise pass."""
    if not torch.is_tensor(x):
        return None, 0, float(x)
    if x.device != device or x.dtype != torch.float32:
        raise TypeError(f"eps kernel: per-system rows must be float32 on "
                        f"{device}; got {x.dtype} on {x.device}")
    if x.dim() == 0 or tuple(x.shape) == (1,):
        return x.data_ptr(), 0, 0.0
    if tuple(x.shape) != (B,):
        raise ValueError(f"eps kernel: a per-system row must be (B,) = "
                         f"({B},), (1,) or a scalar; got {tuple(x.shape)}")
    return x.data_ptr(), x.stride(0), 0.0


def eps_star_and_grad_fused_plain(q, m, h0, alpha, eps_min, eps_max, mask, *,
                                  eta: float = 1.35, clamp: bool = False,
                                  use_fallback: bool = True,
                                  lam_align: float = 0.3):
    """The plain PyTorch version of ``eps_star_and_grad_fused`` (same
    arguments, same outputs), on any device."""
    _check(q)
    maskf = mask.to(q.dtype)
    m_eff = m.to(q.dtype) * maskf
    h0, alpha, emin, emax = (_rows(x, q) for x in (h0, alpha, eps_min,
                                                   eps_max))
    a = torch.minimum(emin, emax)
    b = torch.maximum(emin, emax)
    flo = torch.clamp_min(a, 1e-12)
    cap = torch.maximum(flo, b)
    one = torch.ones_like(h0)
    ph = _Physics(m_eff, h0, one, one, alpha, flo, cap, G=1.0, k_wall=0.0,
                  eta=float(eta), jcap=0.02, bexp=5,
                  grad_mode="reference" if use_fallback else "exact",
                  lam_align=float(lam_align),
                  clamp_bounds=(a, b) if clamp else None)
    es, g = ph.eps_star_and_grad(q)
    return es, g * maskf[..., None]


def eps_star_and_grad_fused(q, m, h0, alpha, eps_min, eps_max, mask, *,
                            eta: float = 1.35, clamp: bool = False,
                            use_fallback: bool = True,
                            lam_align: float = 0.3):
    """Batched (eps*, grad) on a (B, N, d) float32 population, d = 2 or
    3: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.

    Per-system h0 (the SPH seed; the scan passes state.eps), alpha,
    eps_min, eps_max: (B,) tensors or scalars (on the card: float32
    tensors of shape (B,), (1,) or (), or Python numbers); m (B, N)
    (float32 on the card); mask (B, N) bool.  ``use_fallback`` (the JAX
    signature's default, True) takes the "reference" fallback, whose
    sign alignment uses ``lam_align``.  Any B is taken (the TPU kernel's
    B % 8 tiling has no counterpart here).  Returns (es (B,), grad
    (B, N, d))."""
    args = dict(eta=eta, clamp=clamp, use_fallback=use_fallback,
                lam_align=lam_align)
    if q.device.type == "cpu":
        return eps_star_and_grad_fused_plain(q, m, h0, alpha, eps_min,
                                             eps_max, mask, **args)
    if q.device.type != "cuda":
        raise RuntimeError(f"eps kernel: unsupported device {q.device}")
    _check(q)
    B, n, d = q.shape
    if n > MAX_SLOTS:
        raise NotImplementedError(
            f"eps_star_and_grad_fused: N = {n} > {MAX_SLOTS} slots")
    if q.dtype != torch.float32:
        raise TypeError(f"eps kernel: q must be float32, got {q.dtype}")
    if tuple(mask.shape) != (B, n) or tuple(m.shape) != (B, n):
        raise ValueError("eps kernel: m and mask must be (B, N)")
    if m.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("eps kernel: m must be float32 and mask bool")
    q, m, mask = q.contiguous(), m.contiguous(), mask.contiguous()
    rows = [_row_arg(x, B, q.device) for x in (h0, alpha, eps_min, eps_max)]
    lib = _library(n, d, variant(use_fallback))
    es = torch.empty((B,), dtype=q.dtype, device=q.device)
    grad = torch.empty_like(q)
    code = lib.hs_eps_grad(
        *cuda_build.pointers(q, m, mask),
        (_P * 4)(*(r[0] for r in rows)), (_LL * 4)(*(r[1] for r in rows)),
        (_F * 4)(*(r[2] for r in rows)),
        *cuda_build.pointers(es, grad),
        B, float(eta), float(lam_align), int(bool(clamp)),
        cuda_build.stream_of(q))
    cuda_build.check_launch(lib, code, "eps_star_and_grad_fused")
    eps_star_and_grad_fused.launches += 1
    # the kernel zeroes the gradient of every slot whose mask is off
    return es, grad


eps_star_and_grad_fused.launches = 0
