"""Fused multi-step batched WHFast (Wisdom–Holman) kernel.

Counterpart of ``nbodysimproject_tpu/ops/pallas_whfast.py``:
``whfast_multistep`` replaces the TPU kernel of the same name
(``_whfast_multistep_kernel``, with ``_kepler_lc_blocks`` and
``_stumpff23``).  It advances a batch of few-body systems ``n_steps``
Wisdom–Holman steps, D(h/2) [K(h) D(h)]^{n-1} K(h) D(h/2): Jacobi
transforms as prefix sums, the fixed-depth Laguerre–Conway Kepler drift
with the centre of mass anchored in slot 0, and the softened interaction
kick with its Jacobi back-reaction.  This is the fused leg of
``bench.py``'s WHFast benchmark; the scan of the same scheme is
``integrators/whfast.py``.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/whfast.cu`` (see its source note for what bounds it); on a CPU
tensor it runs the plain PyTorch version beside it, which keeps the
Pallas kernel's expressions: every constant rounded to float32,
reciprocal interior masses, cosh and sinh through ``exp``, ``rsqrt``
with its 1e-30 floor, both Stumpff forms evaluated and selected.  The
kernel branches to the Stumpff form it takes, sums the series in Horner
form and contracts its multiply-adds into FMAs, so it rounds apart from
the plain version by a few ulps a step.  There is no fallback from one
to the other.  Zero-mass slots are inert (padding);
the CUDA route takes d = 2 or 3 and N <= ``MAX_SLOTS`` body slots: the
Jacobi sums, the Kepler drift (r . v and |r| over the d coordinates) and
the kick are written per coordinate.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

SOURCE = "whfast.cu"
#: body-slot counts built ahead by ``build_jobs`` (the bench's 3-body
#: system); any N <= MAX_SLOTS is built on first use
BUILD_SLOTS = (3,)
MAX_SLOTS = 8
#: the dimensions the kernel takes
DIMS = (2, 3)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def build_jobs(slots=BUILD_SLOTS):
    return [(SOURCE, n, d) for d in DIMS for n in slots]


@functools.lru_cache(maxsize=None)
def _library(n: int, d: int):
    if d not in DIMS or not 2 <= n <= MAX_SLOTS:
        raise NotImplementedError(
            f"whfast kernel is built for d in {DIMS} and 2 <= N <= "
            f"{MAX_SLOTS}; got N = {n}, d = {d}")
    lib = cuda_build.load(SOURCE, n, d)
    lib.hs_whfast.argtypes = [_P] * 6 + [_I, _I, _F, _F, _F, _I, _P]
    lib.hs_whfast.restype = _I
    lib.hs_whfast_stumpff.argtypes = [_P, _P, _I, _P]
    lib.hs_whfast_stumpff.restype = _I
    return lib


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the kernel holds its constants."""
    return torch.tensor(x, dtype=torch.float32).item()


_CUT = _f32(0.3)
_TINY_R = _f32(1e-14)
_TINY_A = _f32(1e-12)
_FLOOR = _f32(1e-30)
_SIXTH = _f32(1.0 / 6.0)


def _stumpff23(z):
    """c2(z), c3(z) as the kernel computes them: the series for
    |z| <= 0.3, else cos/sin of sqrt(z) or cosh/sinh of sqrt(-z) through
    exp with the argument clamped at 88."""
    small = torch.abs(z) <= _CUT
    zs = torch.where(small, z, torch.zeros_like(z))
    z2 = zs * zs
    z3 = z2 * zs
    z4 = z2 * z2
    z5 = z4 * zs
    c2_s = (0.5 - zs / 24.0 + z2 / 720.0 - z3 / 40320.0 + z4 / 3628800.0
            - z5 / 479001600.0)
    c3_s = (_SIXTH - zs / 120.0 + z2 / 5040.0 - z3 / 362880.0
            + z4 / 39916800.0 - z5 / 6227020800.0)
    one = torch.ones_like(z)
    pos = z > 0.0
    s_e = torch.sqrt(torch.where(pos, z, one))
    s_h = torch.clamp_max(torch.sqrt(torch.where(pos, one, -z)), 88.0)
    e_h = torch.exp(s_h)
    inv_e = 1.0 / e_h
    c0 = torch.where(pos, torch.cos(s_e), 0.5 * (e_h + inv_e))
    c1 = torch.where(pos, torch.sin(s_e) / s_e, 0.5 * (e_h - inv_e) / s_h)
    z_safe = torch.where(small, one, z)
    return (torch.where(small, c2_s, (1.0 - c0) / z_safe),
            torch.where(small, c3_s, (1.0 - c1) / z_safe))


def _add(tally, **counts):
    for key, x in counts.items():
        tally[key] = tally.get(key, 0) + x


def _kepler_lc(r, v, mu, dt: float, iters: int, tally=None):
    """Laguerre–Conway propagation of per-coordinate (B,) rows ``r``,
    ``v`` under ``mu`` (B,) for the float32 ``dt``; ``tally`` as in
    ``whfast_multistep_plain``."""
    dim = len(r)
    r0sq, rv, v2 = r[0] * r[0], r[0] * v[0], v[0] * v[0]
    for a in range(1, dim):
        r0sq = r0sq + r[a] * r[a]
        rv = rv + r[a] * v[a]
        v2 = v2 + v[a] * v[a]
    one = torch.ones_like(r0sq)
    r0 = torch.sqrt(r0sq)
    degenerate = r0 < _TINY_R
    r0s = torch.where(degenerate, one, r0)
    vr0 = rv / r0s
    alpha = 2.0 / r0s - v2 / mu
    sqrt_mu = torch.sqrt(mu)
    chi0 = torch.where(torch.abs(alpha) > _TINY_A,
                       sqrt_mu * torch.abs(alpha) * dt, sqrt_mu * dt / r0s)
    hyp = alpha < -_TINY_A
    alpha_h = torch.where(hyp, alpha, -one)
    sgn_dt = 1.0 if dt >= 0.0 else -1.0
    log_num = -2.0 * mu * alpha_h * dt
    log_den = (r0s * vr0
               + sgn_dt * torch.sqrt(-mu / alpha_h) * (1.0 - r0s * alpha_h))
    log_arg = log_num / torch.where(log_den == 0.0, one, log_den)
    hyp_ok = hyp & (log_den != 0.0) & (log_arg > 0.0)
    chi0_hyp = sgn_dt * torch.sqrt(-1.0 / alpha_h) * \
        torch.log(torch.where(hyp_ok, log_arg, one))
    chi = torch.where(hyp_ok, chi0_hyp, chi0)
    if tally is not None:
        _add(tally, hyp=hyp.sum(), solves=hyp.numel())

    def stumpff(z):
        if tally is not None:
            _add(tally, z_pos=(z > _CUT).sum(), z_neg=(z < -_CUT).sum(),
                 z=z.numel())
        return _stumpff23(z)

    a1 = r0s * vr0 / sqrt_mu
    a2 = 1.0 - alpha * r0s
    smudt = sqrt_mu * dt
    for _ in range(int(iters)):
        z = alpha * chi * chi
        c2, c3 = stumpff(z)
        chi2 = chi * chi
        f = a1 * chi2 * c2 + a2 * chi2 * chi * c3 + r0s * chi - smudt
        fp = a1 * chi * (1.0 - z * c3) + a2 * chi2 * c2 + r0s
        fpp = a1 * (1.0 - z * c2) + a2 * chi * (1.0 - z * c3)
        disc = torch.sqrt(torch.abs(16.0 * fp * fp - 20.0 * f * fpp))
        den = fp + torch.where(fp >= 0.0, disc, -disc)
        den_bad = den == 0.0
        step = 5.0 * f / torch.where(den_bad, one, den)
        chi = chi - torch.where(den_bad, torch.zeros_like(step), step)

    z = alpha * chi * chi
    c2, c3 = stumpff(z)
    chi2 = chi * chi
    ff = 1.0 - chi2 * c2 / r0s
    gg = dt - chi2 * chi * c3 / sqrt_mu
    r_new = [ff * r[a] + gg * v[a] for a in range(dim)]
    rn2 = r_new[0] * r_new[0]
    for a in range(1, dim):
        rn2 = rn2 + r_new[a] * r_new[a]
    rn = torch.sqrt(rn2)
    rn_zero = rn == 0.0
    rns = torch.where(rn_zero, one, rn)
    fdot = sqrt_mu / (rns * r0s) * (alpha * chi2 * chi * c3 - chi)
    gdot = 1.0 - chi2 * c2 / rns
    v_new = [torch.where(rn_zero, v[a], fdot * r[a] + gdot * v[a])
             for a in range(dim)]
    r_out = [torch.where(degenerate, r[a] + v[a] * dt, r_new[a])
             for a in range(dim)]
    v_out = [torch.where(degenerate, v[a], v_new[a]) for a in range(dim)]
    return r_out, v_out


class _System:
    """Per-system constants of a batch and the kernel's three pieces on
    per-body lists of per-coordinate (B,) rows."""

    def __init__(self, mass, eps2, G: float):
        self.n = mass.shape[1]
        self.mass = [mass[:, i] for i in range(self.n)]
        self.eps2 = eps2
        self.G = G
        self.cm = [self.mass[0]]
        for i in range(1, self.n):
            self.cm.append(self.cm[-1] + self.mass[i])
        self.inv_cm = [1.0 / c for c in self.cm]
        self.mu = [G * c for c in self.cm]
        self.live = [m > 0.0 for m in self.mass]
        self.msafe = [torch.where(lv, m, torch.ones_like(m))
                      for lv, m in zip(self.live, self.mass)]

    def to_jacobi(self, x):
        jx = [list(b) for b in x]
        Rs = [self.mass[0] * c for c in x[0]]
        for i in range(1, self.n):
            jx[i] = [x[i][a] - Rs[a] * self.inv_cm[i - 1]
                     for a in range(len(Rs))]
            if i < self.n - 1:
                Rs = [Rs[a] + self.mass[i] * x[i][a] for a in range(len(Rs))]
        return jx

    def from_jacobi(self, jx):
        d = len(jx[0])
        s = [torch.zeros_like(jx[0][0]) for _ in range(d)]
        x = []
        for i in range(self.n):
            x.append([jx[i][a] + s[a] for a in range(d)])
            if i < self.n - 1:
                w = self.mass[i] * self.inv_cm[i]
                s = [s[a] + w * jx[i][a] for a in range(d)]
        return x

    def _com(self, x):
        d = len(x[0])
        out = []
        for a in range(d):
            acc = self.mass[0] * x[0][a]
            for i in range(1, self.n):
                acc = acc + self.mass[i] * x[i][a]
            out.append(acc)
        return out

    def drift(self, pos, vel, dt: float, iters: int, tally=None):
        """D(dt) with slot 0 anchored at the centre of mass."""
        jp, jv = self.to_jacobi(pos), self.to_jacobi(vel)
        invM = self.inv_cm[-1]
        comq = [c * invM for c in self._com(pos)]
        comv = [c * invM for c in self._com(vel)]
        d = len(comq)
        jp[0] = [torch.zeros_like(c) for c in jp[0]]
        jv[0] = [torch.zeros_like(c) for c in jv[0]]
        for i in range(1, self.n):
            jp[i], jv[i] = _kepler_lc(jp[i], jv[i], self.mu[i], dt, iters,
                                      tally)
        x, v = self.from_jacobi(jp), self.from_jacobi(jv)
        sq, sv = self._com(x), self._com(v)
        for a in range(d):
            dq = comq[a] + comv[a] * dt - sq[a] * invM
            dv = comv[a] - sv[a] * invM
            for i in range(self.n):
                x[i][a] = x[i][a] + dq
                v[i][a] = v[i][a] + dv
        return x, v

    def accel(self, pos):
        """Softened direct acceleration plus the Jacobi back-reaction."""
        n, d, G = self.n, len(pos[0]), self.G
        acc = [[torch.zeros_like(pos[0][0]) for _ in range(d)]
               for _ in range(n)]
        for i in range(n):
            for j in range(i + 1, n):
                r2 = self.eps2
                dxs = []
                for a in range(d):
                    dx = pos[i][a] - pos[j][a]
                    dxs.append(dx)
                    r2 = r2 + dx * dx
                inv_r = torch.rsqrt(torch.clamp_min(r2, _FLOOR))
                w = inv_r * inv_r * inv_r
                wi = (G * self.mass[j]) * w
                wj = (G * self.mass[i]) * w
                for a in range(d):
                    acc[i][a] = acc[i][a] - wi * dxs[a]
                    acc[j][a] = acc[j][a] + wj * dxs[a]
        jp = self.to_jacobi(pos)
        zero = torch.zeros_like(pos[0][0])
        wvec = [[zero] * d]
        for i in range(1, n):
            jr2 = self.eps2
            for a in range(d):
                jr2 = jr2 + jp[i][a] * jp[i][a]
            inv_jr = torch.rsqrt(torch.clamp_min(jr2, _FLOOR))
            wfac = torch.where(self.live[i], G * self.mass[i] * inv_jr
                               * inv_jr * inv_jr, zero)
            wvec.append([wfac * jp[i][a] for a in range(d)])
        S = [zero] * d
        for i in range(n - 1, -1, -1):
            prev = self.cm[i - 1] if i >= 1 else torch.ones_like(zero)
            mprev_over_m = torch.where(self.live[i], prev / self.msafe[i],
                                       zero)
            for a in range(d):
                acc[i][a] = torch.where(
                    self.live[i],
                    acc[i][a] + mprev_over_m * wvec[i][a] - S[a], zero)
                S[a] = S[a] + wvec[i][a]
        return acc


def _check(pos, n_steps: int) -> None:
    if pos.dim() != 3:
        raise ValueError(f"whfast kernel: pos must be (B, N, d), got "
                         f"{tuple(pos.shape)}")
    if pos.shape[-1] not in DIMS:
        raise NotImplementedError(f"whfast kernel: takes d in {DIMS}, got "
                                  f"d = {pos.shape[-1]}")
    if int(n_steps) < 1:
        raise ValueError("whfast kernel: n_steps must be >= 1")


def whfast_multistep_plain(pos, vel, mass, eps2, *, h: float, G: float,
                           n_steps: int, iters: int = 8, tally=None):
    """The plain PyTorch version of ``whfast_multistep`` (same arguments,
    same outputs), on any device and in the inputs' dtype, with the
    kernel's float32 constants.  ``tally``, a dict, if given, gains the
    counts of the branches the kernel takes, as 0-d tensors: Stumpff
    evaluations with z > 0.3 ("z_pos") and z < -0.3 ("z_neg") among all
    ("z"), Kepler solves that take the hyperbolic seed ("hyp") among all
    ("solves")."""
    _check(pos, n_steps)
    n, d = pos.shape[1], pos.shape[2]
    hf, half = _f32(h), _f32(0.5 * h)
    sysm = _System(mass, eps2, _f32(G))
    p = [[pos[:, i, a] for a in range(d)] for i in range(n)]
    v = [[vel[:, i, a] for a in range(d)] for i in range(n)]

    def kick(p, v):
        acc = sysm.accel(p)
        return [[v[i][a] + hf * acc[i][a] for a in range(d)]
                for i in range(n)]

    p, v = sysm.drift(p, v, half, iters, tally)
    for _ in range(int(n_steps) - 1):
        v = kick(p, v)
        p, v = sysm.drift(p, v, hf, iters, tally)
    v = kick(p, v)
    p, v = sysm.drift(p, v, half, iters, tally)
    stack = lambda x: torch.stack([torch.stack(b, -1) for b in x], 1)
    return stack(p), stack(v)


def whfast_multistep(pos, vel, mass, eps2, *, h: float, G: float,
                     n_steps: int, iters: int = 8):
    """Advance a (B, N, d) float32 batch ``n_steps`` Wisdom–Holman steps
    with softening eps2 (B,) and ``iters`` Laguerre–Conway updates per
    Kepler solve: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``h`` and ``G`` are floats; bodies are ordered with the
    dominant mass first; any B is taken.  Returns (pos, vel)."""
    if pos.device.type == "cpu":
        return whfast_multistep_plain(pos, vel, mass, eps2, h=h, G=G,
                                      n_steps=n_steps, iters=iters)
    if pos.device.type != "cuda":
        raise RuntimeError(f"whfast kernel: unsupported device {pos.device}")
    _check(pos, n_steps)
    B, n, d = pos.shape
    lib = _library(n, d)
    for name, t, shape in (("pos", pos, (B, n, d)), ("vel", vel, (B, n, d)),
                           ("mass", mass, (B, n)), ("eps2", eps2, (B,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != pos.device:
            raise ValueError(f"whfast kernel: {name} must be float32 "
                             f"{shape} on {pos.device}")
    if int(iters) < 0:
        raise ValueError("whfast kernel: iters must be >= 0")
    pos, vel = pos.contiguous(), vel.contiguous()
    mass, eps2 = mass.contiguous(), eps2.contiguous()
    out_pos, out_vel = torch.empty_like(pos), torch.empty_like(vel)
    code = lib.hs_whfast(
        *cuda_build.pointers(pos, vel, mass, eps2, out_pos, out_vel),
        B, int(n_steps), _f32(h), _f32(0.5 * h), _f32(G), int(iters),
        cuda_build.stream_of(pos))
    cuda_build.check_launch(lib, code, "whfast_multistep")
    whfast_multistep.launches += 1
    return out_pos, out_vel


whfast_multistep.launches = 0


def stumpff_probe(z):
    """The kernel's Stumpff functions on a (B,) float32 CUDA tensor ``z``,
    for the tests: (B, 3, 2), per z the (c2, c3) of the branch the kernel
    takes, of its series and of its closed form.  Not a launch of the
    kernel: ``whfast_multistep.launches`` does not count it."""
    if z.device.type != "cuda" or z.dtype != torch.float32 or z.dim() != 1:
        raise ValueError("stumpff_probe: z must be a (B,) float32 CUDA "
                         "tensor")
    lib = _library(BUILD_SLOTS[0], 2)
    z = z.contiguous()
    out = torch.empty((z.shape[0], 3, 2), dtype=torch.float32,
                      device=z.device)
    code = lib.hs_whfast_stumpff(*cuda_build.pointers(z, out), z.shape[0],
                                 cuda_build.stream_of(z))
    cuda_build.check_launch(lib, code, "stumpff_probe")
    return out
