"""Fused multi-step kick-drift composition kernel (Verlet, Yoshida4).

Counterpart of ``nbodysimproject_tpu/ops/pallas_batch.py``:
``composition_multistep`` replaces the TPU kernel of the same name
(``_composition_multistep_kernel``), with ``verlet_multistep`` and
``yoshida4_multistep`` as its two schemes.  It advances a batch of
few-body systems ``n_steps`` steps with a softened direct acceleration
(G folded into the masses, rsqrt in the pair term) and the same stage
table as the TPU kernel: the velocity lives at the first stage's
half-step, so adjacent half-kicks of consecutive stages and steps fuse
into one kick.  This is the ``bench.py`` headline kernel.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/composition.cu`` (see its source note for what bounds it); on a
CPU tensor it runs the plain PyTorch version beside it, which repeats
the kernel's operations in the kernel's order, pair by pair, but rounds
each product on its own where the kernel contracts it into an FMA (a
few ulps a step apart).  There is no fallback from one to the other.  The kernel has no mask: every slot
is a body, and the wrapper refuses a mask.  Both routes take any N from
2 to ``MAX_SLOTS`` bodies in d = 2 or 3 (``DIMS``); the CUDA route
builds the library of each (N, d) on first use, and ``build_jobs``
builds ahead the shapes of ``BUILD_AHEAD``.  The TPU kernel also takes
N > 16 (still to port) and N = 1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = "composition.cu"
#: the body counts and dimensions taken: 2 <= N <= MAX_SLOTS, d in DIMS
MAX_SLOTS = 16
DIMS = (2, 3)
#: (N, d) built ahead by ``build_jobs``: the bench's 3-body system and
#: chip_smoke.py's 8-body compare case in 3-D
BUILD_AHEAD = ((3, 2), (8, 3))

#: symplectic composition stages as (drift_coef, kick_coef) pairs in
#: units of h (pallas_batch.py:37-46): Yoshida's triple jump
#: w1 = 1/(2 - 2^{1/3}), w2 = -2^{1/3} w1 in kick-drift form
_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_W2 = -(2.0 ** (1.0 / 3.0)) * _W1
SCHEME_STAGES = {
    "verlet": ((1.0, 1.0),),
    "yoshida4": ((_W1, 0.5 * (_W1 + _W2)),
                 (_W2, 0.5 * (_W1 + _W2)),
                 (_W1, _W1)),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def build_jobs(shapes=BUILD_AHEAD):
    return [(SOURCE, n, d) for n, d in shapes]


def _check_shape(n: int, d: int) -> None:
    if not 2 <= n <= MAX_SLOTS or d not in DIMS:
        raise NotImplementedError(
            f"composition kernel: ported for 2 <= N <= {MAX_SLOTS} bodies "
            f"and d in {DIMS}; got N = {n}, d = {d}")


@functools.lru_cache(maxsize=None)
def _library(n: int, d: int):
    _check_shape(n, d)
    lib = cuda_build.load(SOURCE, n, d)
    lib.hs_composition.argtypes = [_P] * 6 + [_I, _I, _F, _P, _P, _I, _F, _P]
    lib.hs_composition.restype = _I
    return lib


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the kernel holds its coefficients."""
    return torch.tensor(x, dtype=torch.float32).item()


def _coefficients(scheme: str, h: float):
    """(drift h, kick h) per stage and the opening half-kick, each rounded
    to float32 (the TPU kernel's ``np.float32(d * h)``)."""
    if scheme not in SCHEME_STAGES:
        raise ValueError(f"unknown composition scheme {scheme!r}")
    stages = SCHEME_STAGES[scheme]
    dh = [_f32(d * h) for d, _ in stages]
    kh = [_f32(k * h) for _, k in stages]
    return dh, kh, _f32(0.5 * stages[0][0] * h)


def _check(pos, mask) -> None:
    if mask is not None:
        raise ValueError("composition kernel: no mask is taken; every slot "
                         "must hold a body")
    if pos.dim() != 3:
        raise ValueError(f"composition kernel: pos must be (B, N, d), got "
                         f"{tuple(pos.shape)}")
    _check_shape(pos.shape[1], pos.shape[2])


def _accel(pos, gmass, eps2):
    """The kernel's softened acceleration, pair by pair in its order:
    a list of (B, d) rows, one per body."""
    n = pos.shape[1]
    acc = [torch.zeros_like(pos[:, 0]) for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            dx = pos[:, i] - pos[:, j]
            r2 = eps2
            for a in range(pos.shape[2]):
                r2 = r2 + dx[:, a] * dx[:, a]
            inv_r = torch.rsqrt(r2)
            w = (inv_r * inv_r * inv_r)[:, None]
            acc[i] = acc[i] - (gmass[:, j, None] * w) * dx
            acc[j] = acc[j] + (gmass[:, i, None] * w) * dx
    return torch.stack(acc, 1)


def composition_multistep_plain(pos, vel, mass, eps2, *, h: float, G: float,
                                n_steps: int, scheme: str = "verlet",
                                mask=None):
    """The plain PyTorch version of ``composition_multistep`` (same
    arguments, same outputs), on any device."""
    _check(pos, mask)
    dh, kh, k_half = _coefficients(scheme, float(h))
    gmass = _f32(G) * mass
    acc = _accel(pos, gmass, eps2)
    vel = vel + k_half * acc
    for _step in range(int(n_steps)):
        for s in range(len(dh)):
            pos = pos + dh[s] * vel
            acc = _accel(pos, gmass, eps2)
            vel = vel + kh[s] * acc
    return pos, vel - k_half * acc


def composition_multistep(pos, vel, mass, eps2, *, h: float, G: float,
                          n_steps: int, scheme: str = "verlet", mask=None):
    """Advance a (B, N, d) float32 batch ``n_steps`` composition steps
    (``scheme`` "verlet" or "yoshida4") with softening eps2 (B,): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  ``h`` and
    ``G`` are floats.  Any B is taken.  Returns (pos, vel)."""
    if pos.device.type == "cpu":
        return composition_multistep_plain(pos, vel, mass, eps2, h=h, G=G,
                                           n_steps=n_steps, scheme=scheme,
                                           mask=mask)
    if pos.device.type != "cuda":
        raise RuntimeError(f"composition kernel: unsupported device "
                           f"{pos.device}")
    _check(pos, mask)
    B, n, d = pos.shape
    lib = _library(n, d)
    for name, t, shape in (("pos", pos, (B, n, d)), ("vel", vel, (B, n, d)),
                           ("mass", mass, (B, n)), ("eps2", eps2, (B,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != pos.device:
            raise ValueError(f"composition kernel: {name} must be float32 "
                             f"{shape} on {pos.device}")
    dh, kh, k_half = _coefficients(scheme, float(h))
    ns = len(dh)
    pos, vel = pos.contiguous(), vel.contiguous()
    mass, eps2 = mass.contiguous(), eps2.contiguous()
    out_pos, out_vel = torch.empty_like(pos), torch.empty_like(vel)
    code = lib.hs_composition(
        *cuda_build.pointers(pos, vel, mass, eps2, out_pos, out_vel),
        B, int(n_steps), _f32(G), (ctypes.c_float * ns)(*dh),
        (ctypes.c_float * ns)(*kh), ns, k_half, cuda_build.stream_of(pos))
    cuda_build.check_launch(lib, code, "composition_multistep")
    composition_multistep.launches += 1
    return out_pos, out_vel


composition_multistep.launches = 0


def verlet_multistep(pos, vel, mass, eps2, *, h, G, n_steps, mask=None):
    return composition_multistep(pos, vel, mass, eps2, h=h, G=G,
                                 n_steps=n_steps, scheme="verlet", mask=mask)


def yoshida4_multistep(pos, vel, mass, eps2, *, h, G, n_steps, mask=None):
    return composition_multistep(pos, vel, mass, eps2, h=h, G=G,
                                 n_steps=n_steps, scheme="yoshida4",
                                 mask=mask)
