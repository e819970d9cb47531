"""Fused multi-step ham_soft kernels: analysis, MEGNO and plain integration.

Counterpart of ``nbodysimproject_tpu/ops/pallas_hamsoft.py``:

* ``hamsoft_analysis_multistep`` replaces the TPU kernel of the same
  name (``_hamsoft_analysis_kernel``): ``n_steps`` macro steps, each
  system running its own ``n_sub`` Strang trips, with the com_drift /
  cos_theta / var_L / tr_hessian moments sampled after step i when
  ``i % interval == 0`` and the (eps, pi) sample rows stored;
* ``hamsoft_megno_multistep`` replaces ``_hamsoft_megno_kernel``: the
  MEGNO continuation with the tangent map, one Y_t row per step;
* ``hamsoft_multistep`` replaces ``_hamsoft_multistep_kernel``: the same
  integration with no sampling (the ``use_fused_metrics=False`` engine
  and the ham_soft leg of ``bench.py``).

On a CUDA tensor each wrapper launches the hand-written kernel
(``csrc/hamsoft.cu`` for the first two, on the lane-split physics of
``csrc/hamsoft_physics_warp.cuh``: four lanes of a warp per body up to
N = 8 and two from N = 9 to 16, so that a system keeps to one warp, the
SPH kernel terms kept from the forward pass; ``csrc/hamsoft_multistep.cu``
for the third, on the same lane-split physics from N = 4 and one thread
per system on ``csrc/hamsoft_physics.cuh`` at N = 2 and 3, the kernel
terms kept there too; see the source notes for what bounds them and
what their design does about that) at any N from 2 to 16 body slots
(``check_slots``; N > 16 raises); on a CPU tensor it runs the plain
PyTorch version beside it, which loops over the macro steps and
``n_sub_max`` masked trips on ``(B, N, d)`` tensors and takes the exact
eps* gradient by autograd through the 8 SPH iterations (``_Physics``).
There is no fallback from one to the other.  The wrappers hand their kernel the systems deepest first
(``deepest_first``); each output comes back at the system's own index.

Every kernel takes the three barrier policies (``"soft"``, the dataset
pipeline's wall kicks; ``"reflection"``, closed-form folds of (eps, pi);
``"none"``) and both eps* gradient modes (``"exact"``; ``"reference"``,
the reference's degeneracy fallback: where the exact gradient's largest
row norm is <= 1e-12 or <= 1e-9 times the median pair distance, the
Omega gradient on the final SPH iterate, sign-aligned against the
legacy gradient), at d = 2 and 3.  As in the TPU kernels, all 8 SPH
iterations always run (no convergence freeze: a <= 1e-6 relative eps*
perturbation, below float32 resolution), and the fallback takes the
final clipped iterate, not the XLA path's frozen one.

The libraries are built with plain ``nvcc`` into ``_build/``
(git-ignored), one shared object per source, body-slot count, dimension
and build variant (``variant``: the reflection fold and the "reference"
gradient are compile-time branches, so the default builds hold neither),
and loaded with ``ctypes`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build
from . import eps_model as epsmod
from . import softening as legacy_soft

#: metric order of the analysis kernel's accumulator rows (count, then
#: sum, sumsq, max, min per metric)
ACC_METRICS = ("com_drift", "cos_theta", "var_L", "tr_hessian")
_ACC_ROWS = 1 + 4 * len(ACC_METRICS)
_INV_PI = 0.31830987334251404  # float32(1 / pi), exactly (as the JAX kernels)
_ITERS = 8

#: the body-slot counts the kernels take, N = SLOTS[0] .. SLOTS[1]; each
#: (N, d) is built on first use
SLOTS = (2, 16)
#: body-slot counts ``build_jobs`` builds ahead (8: the pipeline's slot
#: bucket; 3 and 4: the small systems of tests and comparisons)
BUILD_SLOTS = (3, 4, 8)
#: the analysis and MEGNO kernels, and the plain multi-step kernel
SOURCES = ("hamsoft.cu", "hamsoft_multistep.cu")
#: the dimensions every source is built for
DIMS = (2, 3)
#: the barrier policies and eps* gradient modes the kernels take
POLICIES = ("soft", "reflection", "none")
GRAD_MODES = ("exact", "reference")


def build_jobs(slots=BUILD_SLOTS):
    """(source, n, d) of the default libraries of this module (the soft
    and no-barrier policies, and for the multi-step kernel the
    reflection policy too, with the exact gradient) at d = 2 and 3."""
    return [(src, n, d) for src in SOURCES for d in DIMS for n in slots]


def variant(source: str, policy: str, grad_mode: str,
            one_thread: bool = False) -> str:
    """The build variant of ``source`` (``cuda_build.VARIANT_FLAGS``) that
    runs ``policy`` and ``grad_mode``: "" for the default build; "refl"
    for the analysis and MEGNO kernels' reflection fold (the multi-step
    kernel holds both folds in every build); "ref" for the "reference"
    gradient; "thread" for the multi-step kernel's one-thread layout at
    every N (``one_thread``)."""
    parts = []
    if policy == "reflection" and source == SOURCES[0]:
        parts.append("refl")
    if grad_mode == "reference":
        parts.append("ref")
    if one_thread:
        parts.append("thread")
    return "_".join(parts)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def check_slots(n: int, d: int) -> None:
    """Raise unless the kernels take N = ``n`` body slots at d = ``d``
    (N from 2 to 16, d = 2 or 3)."""
    lo, hi = SLOTS
    if d not in DIMS or not lo <= n <= hi:
        raise NotImplementedError(
            f"the ham_soft kernels take N from {lo} to {hi} body slots and "
            f"d in {DIMS}; got N = {n}, d = {d}")


@functools.lru_cache(maxsize=None)
def _library(n: int, d: int, var: str = ""):
    """The bound analysis/MEGNO library for (n, d) in build variant
    ``var``, built on first use."""
    check_slots(n, d)
    lib = cuda_build.load(SOURCES[0], n, d, var)
    lib.hs_analysis.argtypes = [_P] * 21 + [_I] * 4 + [_F] * 5 + [_I, _I, _P]
    lib.hs_analysis.restype = _I
    lib.hs_megno.argtypes = [_P] * 23 + [_I] * 3 + [_F] * 5 + [_I, _I, _P]
    lib.hs_megno.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _multistep_library(n: int, d: int, var: str = ""):
    """The bound multi-step library for (n, d) in build variant ``var``,
    built on first use."""
    check_slots(n, d)
    lib = cuda_build.load(SOURCES[1], n, d, var)
    lib.hs_multistep.argtypes = [_P] * 17 + [_I] * 3 + [_F] * 5 \
        + [_I, _I, _I, _P]
    lib.hs_multistep.restype = _I
    return lib


def occupancy(source: str, n: int, d: int, var: str = ""):
    """{kernel: (shared bytes per block, resident warps per
    multiprocessor)} of the build of ``source`` for (n, d) in variant
    ``var``, as its launches run it (on the current card; building it if
    it is not built): "analysis" and "megno" for ``hamsoft.cu``, "soft"
    and "reflection" (the two instances) for ``hamsoft_multistep.cu``."""
    lib = (_library if source == SOURCES[0] else _multistep_library)(
        n, d, var)
    lib.hs_occupancy.argtypes = [_P]
    lib.hs_occupancy.restype = _I
    out = (ctypes.c_int * 4)()
    cuda_build.check_launch(lib, lib.hs_occupancy(out), "hs_occupancy")
    names = (("analysis", "megno") if source == SOURCES[0]
             else ("soft", "reflection"))
    return {k: (out[2 * i], out[2 * i + 1]) for i, k in enumerate(names)}


def _check_config(policy: str, grad_mode: str) -> None:
    if policy not in POLICIES:
        raise NotImplementedError(
            f"hamsoft kernels: barrier policy {policy!r} is not one of "
            f"{POLICIES}")
    if grad_mode not in GRAD_MODES:
        raise NotImplementedError(
            f"hamsoft kernels: eps_grad_mode {grad_mode!r} is not one of "
            f"{GRAD_MODES}")


def _barrier_on(k_wall: float, bexp: int) -> bool:
    return k_wall > 0.0 and bexp >= 2


def _wall_kicks(kw) -> bool:
    """Whether the kernel kicks pi off the soft walls (the soft policy)."""
    return kw["policy"] == "soft" and _barrier_on(kw["k_wall"], kw["bexp"])


def _launch_floats(kw):
    """G, k_wall, eta, jcap and lam_align, as the kernels take them."""
    return kw["G"], kw["k_wall"], kw["eta"], kw["jcap"], kw["lam_align"]


# --------------------------------------------------------------------------
# plain PyTorch version of the physics (the kernels' reference)
# --------------------------------------------------------------------------

def _finite_or_zero(g):
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


class _Physics:
    """The shared ham_soft physics of the two kernels on (B, N, d)
    tensors — ``_build_physics`` of the TPU kernel, vectorised over
    bodies instead of unrolled."""

    def __init__(self, mass, eps_seed, k_s, mu, alpha, flo, cap, *, G,
                 k_wall, eta, jcap, bexp, policy="soft", grad_mode="exact",
                 lam_align=0.3, clamp_bounds=None):
        self.mass = mass
        self.valid = mass > 0.0
        zero = torch.zeros_like(mass)
        self.mval = torch.where(self.valid, mass, zero)
        self.inv_m = torch.where(self.valid,
                                 1.0 / torch.clamp_min(mass, 1e-30), zero)
        n = mass.shape[-1]
        self.off = ~torch.eye(n, dtype=torch.bool, device=mass.device)
        self.pairv = self.valid[:, :, None] & self.valid[:, None, :] & self.off
        self.upper = torch.ones(n, n, dtype=torch.bool,
                                device=mass.device).triu(1)
        self.eps_seed, self.k_s, self.mu, self.alpha = eps_seed, k_s, mu, alpha
        self.flo, self.cap = flo, cap
        self.G, self.k_wall, self.eta, self.jcap = G, k_wall, eta, jcap
        self.bexp = bexp
        # wall kicks under the soft policy, folds under the reflection one
        self.barrier_on = policy == "soft" and _barrier_on(k_wall, bexp)
        self.refl = policy == "reflection"
        self.ref = grad_mode == "reference"
        self.lam_align = lam_align
        self.clamp_bounds = clamp_bounds

    # ---------------- eps* and its gradient -----------------------------
    def eps_star_and_grad(self, pos):
        """(eps*, d eps*/dq): the exact gradient (``exact_eps_grad``);
        with ``clamp_bounds`` (a, b) eps* clipped to [a, b] and the
        gradient zeroed where the clip saturates; then, in the
        "reference" gradient mode, the degeneracy switch
        (``reference_switch``), as in ``_build_physics``."""
        es, g, h_fin = self.exact_eps_grad(pos)
        if self.clamp_bounds is not None:
            lo, hi = self.clamp_bounds
            gate = (es >= lo) & (es <= hi)
            g = torch.where(gate[:, None, None], g, torch.zeros_like(g))
            es = torch.minimum(torch.maximum(es, lo), hi)
        if self.ref:
            g = self.reference_switch(pos, h_fin, g)
        return es, g

    def exact_eps_grad(self, pos):
        """(eps*, d eps*/dq, final iterate h): the 8 clipped SPH
        iterations from the entry eps, the softmin, and autograd back
        through them.  The backward zeroes non-finite cotangents on Sigma
        (the float32 backward overflows on saturated lanes, where the
        true gradient is zero) and passes the clip only strictly inside
        its bounds, as the kernel's reverse sweep does."""
        flo, cap = self.flo[:, None], self.cap[:, None]
        with torch.enable_grad():
            q = pos.detach().requires_grad_(True)
            diff = q[:, :, None, :] - q[:, None, :, :]
            r2 = diff[..., 0] * diff[..., 0]
            for a in range(1, q.shape[-1]):
                r2 = r2 + diff[..., a] * diff[..., a]
            h0 = torch.minimum(torch.maximum(self.eps_seed, self.flo),
                               self.cap)
            h = h0[:, None].expand_as(self.mval)
            mw = torch.where(self.off, self.mval[:, None, :],
                             torch.zeros_like(r2))
            for _ in range(_ITERS):
                ih2 = 1.0 / torch.clamp_min(h * h, 1e-24)
                w = (_INV_PI * ih2)[..., None] * torch.exp(-r2 * ih2[..., None])
                S = (mw * w).sum(-1)
                Ssafe = torch.clamp_min(S, 1e-30)
                Ssafe.register_hook(_finite_or_zero)
                hn = self.eta * torch.sqrt(self.mval / Ssafe)
                gate = ((hn > flo) & (hn < cap)).detach()
                h = torch.where(gate, hn,
                                torch.minimum(torch.maximum(hn, flo),
                                              cap).detach())
            t = torch.where(self.valid, -h / self.alpha[:, None],
                            torch.full_like(h, -1e30))
            tmax = t.detach().amax(-1, keepdim=True)
            s = torch.exp(t - tmax).sum(-1)
            es = -self.alpha * (tmax[:, 0] + torch.log(s))
            (g,) = torch.autograd.grad(es.sum(), q)
        ok = self.valid[..., None] & torch.isfinite(g)
        return es.detach(), torch.where(ok, g, torch.zeros_like(g)), \
            h.detach()

    # ---------- the "reference" gradient's fallback (_build_physics) ----
    def reference_switch(self, pos, h_fin, g):
        """Where the gradient ``g`` degenerates (its largest valid row
        norm <= 1e-12, or <= 1e-9 times the median pair distance), the
        Omega gradient on the final iterate ``h_fin``, its sign aligned
        against the legacy gradient's; ``g`` elsewhere."""
        degenerate = epsmod.degenerate_grad(g, pos, self.valid)[0]
        g_fb = self.omega_grad(pos, h_fin)
        g_ref = legacy_soft.grad_eps_target(pos, lam=self.lam_align,
                                            mask=self.valid)
        dot = (g_fb * g_ref).sum((-2, -1))
        flip = torch.isfinite(dot) & (dot < 0.0)
        g_fb = torch.where(flip[:, None, None], -g_fb, g_fb)
        return torch.where(degenerate[:, None, None], g_fb, g)

    def omega_grad(self, pos, h_fin):
        """The Omega-corrected SPH gradient (ops/eps_model.py:237-298 of
        the JAX package) on the final iterate, with the softmin's weights
        and the h floor max(1e-12, 0.1 max(flo, 1e-12)), in the kernels'
        expressions: Omega cancels to O(r^2 / h^2) on clustered systems,
        so ``eps_model.production_grad_omega``'s algebraically equal ones
        would round a float32 run apart from the kernels'."""
        d = pos[:, :, None, :] - pos[:, None, :, :]  # q_i - q_j
        r2 = (d * d).sum(-1)
        t = torch.where(self.valid, -h_fin / self.alpha[:, None],
                        torch.full_like(h_fin, -1e30))
        e = torch.exp(t - t.amax(-1, keepdim=True))
        omega = e / e.sum(-1, keepdim=True)
        floor = torch.clamp_min(0.1 * torch.clamp_min(self.flo, 1e-12), 1e-12)
        hj = torch.maximum(h_fin, floor[:, None])
        ih2 = 1.0 / torch.clamp_min(hj * hj, 1e-24)
        w = (_INV_PI * ih2)[..., None] * torch.exp(-r2 * ih2[..., None])
        mw = torch.where(self.off, self.mval[:, None, :] * w,
                         torch.zeros_like(w))
        S = mw.sum(-1)
        # each term divided by h, as the kernels do: Omega = 1 + h Sd /
        # (2 S) cancels to O(r^2 / h^2) on clustered systems, so it
        # magnifies every rounding of Sd
        Sd = (mw * (-2.0 + 2.0 * r2 * ih2[..., None])
              / torch.clamp_min(hj, 1e-12)[..., None]).sum(-1)
        Ssafe = torch.clamp_min(S, 1e-30)
        Om = 1.0 + hj * Sd / (2.0 * Ssafe)
        Om = torch.where(torch.isfinite(Om) & (Om != 0.0), Om,
                         torch.ones_like(Om))
        P = -hj / (2.0 * Ssafe * Om)
        coeff = (-omega * P)[..., None] * mw * (-2.0 * ih2)[..., None]
        term = coeff[..., None] * d
        g = term.sum(-2) - term.sum(-3)
        ok = self.valid[..., None] & torch.isfinite(g)
        return torch.where(ok, g, torch.zeros_like(g))

    def bar_force(self, e):
        left = torch.clamp_min(self.flo - e, 0.0)
        right = torch.clamp_min(e - self.cap, 0.0)
        le = torch.ones_like(e)
        re = torch.ones_like(e)
        for _ in range(self.bexp - 2):
            le = le * left
            re = re * right
        return self.k_wall * (le - re)

    def fold(self, e, p):
        """Closed-form reflection fold of (eps, pi) into [flo, cap]
        (ops/reflection.py:19-35, the Pallas kernel's ``fold``)."""
        R = self.cap - self.flo
        Pw = 2.0 * R
        Psafe = torch.where(Pw > 0.0, Pw, torch.ones_like(Pw))
        x = e - self.flo
        y = x - Psafe * torch.floor(x / Psafe)
        y = torch.where(Pw > 0.0, y, torch.zeros_like(y))
        on_up = y <= R
        e_out = torch.where(on_up, self.flo + y, self.cap - (y - R))
        p_out = torch.where(on_up, p, -p)
        ok = torch.isfinite(R) & (R > 0.0)
        return torch.where(ok, e_out, self.flo), torch.where(ok, p_out, -p)

    # ---------------- S(h/2): spring rotation + J-capped impulse --------
    def s_half(self, vel, eps, pi, es, grad, hh):
        if self.refl:
            eps, pi = self.fold(eps, pi)
        dt_f = 0.5 * hh
        omega = torch.sqrt(self.k_s / self.mu)
        theta = omega * dt_f
        th2 = theta * theta
        s_ser = theta * (1.0 - th2 / 6.0 * (1.0 - th2 / 20.0))
        c_ser = 1.0 - th2 / 2.0 * (1.0 - th2 / 12.0)
        small = torch.abs(theta) < 1e-8
        sin_t = torch.where(small, s_ser, torch.sin(theta))
        cos_t = torch.where(small, c_ser, torch.cos(theta))

        pi_in = pi + 0.5 * dt_f * self.bar_force(eps) if self.barrier_on \
            else pi
        Delta0 = eps - es
        mu_om = torch.sqrt(self.mu * self.k_s)
        delta_t = Delta0 * cos_t + (pi_in / (self.mu * omega)) * sin_t
        eta_t = pi_in * cos_t - mu_om * Delta0 * sin_t
        I_tau = (Delta0 / omega) * sin_t \
            + (pi_in / (self.mu * omega * omega)) * (1.0 - cos_t)
        eps_new = es + delta_t
        pi_new = eta_t + 0.5 * dt_f * self.bar_force(eps_new) \
            if self.barrier_on else eta_t

        # J-cap (hamsoft_flows.py:692-738)
        J = self.k_s * I_tau
        pv = self.mass[..., None] * vel
        pnorm = torch.sqrt((pv * pv).sum(-1))
        gnorm = torch.sqrt((grad * grad).sum(-1))
        zero = torch.zeros_like(pnorm)
        p_scale = torch.where(self.valid, pnorm, zero).amax(-1)
        dp_inf = torch.where(self.valid, torch.abs(J)[:, None] * gnorm,
                             zero).amax(-1)
        p_scale = torch.clamp_min(p_scale, 1e-12)
        thr = self.jcap * p_scale
        scale = torch.where(dp_inf > thr, thr / torch.clamp_min(dp_inf, 1e-30),
                            torch.ones_like(dp_inf))
        Ja = J * scale
        vel = vel + Ja[:, None, None] * grad * self.inv_m[..., None]
        if self.refl:
            eps_new, pi_new = self.fold(eps_new, pi_new)
        return vel, eps_new, pi_new

    # ---------------- V(h/2): gravity kick on p, dV/deps kick on pi ----
    def v_half_kick(self, pos, vel, eps, pi, hh):
        h2 = 0.5 * hh
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        r2 = (eps * eps)[:, None, None]
        for a in range(pos.shape[-1]):
            r2 = r2 + diff[..., a] * diff[..., a]
        inv_r = torch.rsqrt(r2)
        w = inv_r * inv_r * inv_r
        zero = torch.zeros_like(w)
        pairm = self.mass[:, :, None] * self.mass[:, None, :]
        ddU = torch.where(self.pairv & self.upper, pairm * w, zero).sum((-2, -1))
        wj = torch.where(self.off, self.mval[:, None, :] * w, zero)
        acc = -(wj[..., None] * diff).sum(-2)
        vel = vel + (h2 * self.G)[:, None, None] * acc
        dU = self.G * eps * ddU
        if self.barrier_on:
            pi = pi - h2 * (dU - self.bar_force(eps))
        else:
            pi = pi - h2 * dU
        return vel, pi

    def strang_trip(self, pos, vel, eps, pi, es, grad, h, active):
        """One Strang substep S V T V S where ``active``; identity
        elsewhere.  The (eps*, grad) cache carries across trips; the
        reflection policy folds (eps, pi) around the substep too."""
        eps0, pi0 = self.fold(eps, pi) if self.refl else (eps, pi)
        vel1, eps1, pi1 = self.s_half(vel, eps0, pi0, es, grad, h)
        vel1, pi1 = self.v_half_kick(pos, vel1, eps1, pi1, h)
        pos1 = pos + h[:, None, None] * vel1
        vel1, pi1 = self.v_half_kick(pos1, vel1, eps1, pi1, h)
        es1, grad1 = self.eps_star_and_grad(pos1)
        vel1, eps1, pi1 = self.s_half(vel1, eps1, pi1, es1, grad1, h)
        if self.refl:
            eps1, pi1 = self.fold(eps1, pi1)
        a3 = active[:, None, None]
        return (torch.where(a3, pos1, pos), torch.where(a3, vel1, vel),
                torch.where(active, eps1, eps), torch.where(active, pi1, pi),
                torch.where(active, es1, es), torch.where(a3, grad1, grad))

    def tangent_accel(self, pos, dr, eps):
        """delta_a_i = G sum_j m_j [ddx/r^3 - 3 (dx . ddx) dx / r^5] with
        softened r^2 = |q_j - q_i|^2 + eps^2 over valid pairs."""
        dx = pos[:, None, :, :] - pos[:, :, None, :]     # q_j - q_i
        ddx = dr[:, None, :, :] - dr[:, :, None, :]
        r2 = (eps * eps)[:, None, None]
        for a in range(pos.shape[-1]):
            r2 = r2 + dx[..., a] * dx[..., a]
        inv_r2 = 1.0 / r2
        inv_r3 = inv_r2 * torch.rsqrt(r2)
        dot = (dx * ddx).sum(-1)
        coeff = 3.0 * dot * inv_r2 * inv_r3
        term = ddx * inv_r3[..., None] - coeff[..., None] * dx
        contrib = (self.G * self.mval[:, None, :, None]) * term
        return torch.where(self.pairv[..., None], contrib,
                           torch.zeros_like(contrib)).sum(-2)

    def metrics_of(self, pos, vel, eps, L0, nb):
        """com_drift, cos_theta, var_L, tr_hessian (metrics.py:56-123):
        L0 is L_z (B,) at d = 2, the L vector (B, 3) at d = 3."""
        com = (self.mval[..., None] * pos).sum(-2)
        com_drift = torch.sqrt((com * com).sum(-1))
        nan = torch.full_like(nb, math.nan)
        if pos.shape[-1] == 2:
            L_i = self.mval * (pos[..., 0] * vel[..., 1]
                               - pos[..., 1] * vel[..., 0])
            L_tot = L_i.sum(-1)
            d0 = L_i - (L_tot / nb)[:, None]
            cos_ok = (L0 != 0.0) & (L_tot != 0.0)
            cos_theta = torch.where(cos_ok, (L_tot * L0)
                                    / (torch.abs(L_tot) * torch.abs(L0)),
                                    nan)
        else:
            # per-body L_i = m q x v; the tilt's denominator floored at
            # 1e-300 in the working dtype (0 in float32), as the TPU
            # kernel does
            c = self.mval[..., None] * torch.linalg.cross(pos, vel, dim=-1)
            Lv = c.sum(-2)
            L_tot = torch.sqrt((Lv * Lv).sum(-1))
            l_i = torch.sqrt((c * c).sum(-1))
            zero = torch.zeros_like(l_i)
            l_mean = torch.where(self.valid, l_i, zero).sum(-1) / nb
            d0 = l_i - l_mean[:, None]
            L0n = torch.sqrt((L0 * L0).sum(-1))
            cos_ok = (L0n != 0.0) & (L_tot != 0.0)
            den = torch.maximum(L_tot * L0n, L_tot.new_tensor(1e-300))
            cos_theta = torch.where(cos_ok, (Lv * L0).sum(-1) / den, nan)
        var_L = torch.where(self.valid, d0 * d0,
                            torch.zeros_like(d0)).sum(-1) / nb
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        r2 = (diff * diff).sum(-1)
        s = r2 + (eps * eps)[:, None, None]
        num = pos.shape[-1] * s - 3.0 * r2
        ssafe = torch.clamp_min(s, 0.0)
        den = ssafe * ssafe * torch.sqrt(ssafe)
        pairm = self.mass[:, :, None] * self.mass[:, None, :]
        tr = torch.where(self.pairv & self.upper, pairm * num / den,
                         torch.zeros_like(s)).sum((-2, -1))
        return com_drift, cos_theta, var_L, self.G * 2.0 * tr


def _n_trips(n_sub, n_sub_max: int) -> int:
    """Trips per macro step the plain version has to run: a trip no
    lane is active in is an exact identity, so the loop stops at the
    largest lane count below ``n_sub_max``."""
    if n_sub.numel() == 0:
        return 0
    return min(int(n_sub_max), int(torch.clamp_min(n_sub, 1).max()))


def _analysis_loop(pos, vel, mass, eps, pi, L0, *, k_soft, mu, alpha,
                   eps_min, eps_max, h, n_sub, n_steps: int, n_sub_max: int,
                   interval: int, G, k_wall, eta, jcap, bexp, policy,
                   grad_mode, lam_align):
    """The analysis kernel's loop on (B, N, d) tensors."""
    ph = _Physics(mass, eps, k_soft, mu, alpha, eps_min, eps_max, G=G,
                  k_wall=k_wall, eta=eta, jcap=jcap, bexp=bexp, policy=policy,
                  grad_mode=grad_mode, lam_align=lam_align)
    nsub = torch.clamp_min(n_sub, 1)
    trips = _n_trips(n_sub, n_sub_max)
    nb = torch.clamp_min(ph.valid.to(pos.dtype).sum(-1), 1.0)
    es, grad = ph.eps_star_and_grad(pos)
    zero = torch.zeros_like(eps)
    cnt = zero
    acc = [[zero, zero, torch.full_like(eps, -math.inf),
            torch.full_like(eps, math.inf)] for _ in ACC_METRICS]
    n_samples = -(-n_steps // interval)
    eps_s = torch.empty((n_samples,) + eps.shape, dtype=eps.dtype,
                        device=eps.device)
    pi_s = torch.empty_like(eps_s)
    for step in range(n_steps):
        for sub in range(trips):
            pos, vel, eps, pi, es, grad = ph.strang_trip(
                pos, vel, eps, pi, es, grad, h, sub < nsub)
        if step % interval == 0:
            cnt = cnt + 1.0
            for a, x in zip(acc, ph.metrics_of(pos, vel, eps, L0, nb)):
                a[0] = a[0] + x
                a[1] = a[1] + x * x
                a[2] = torch.maximum(a[2], x)
                a[3] = torch.minimum(a[3], x)
            eps_s[step // interval] = eps
            pi_s[step // interval] = pi
    accs = {k: (cnt, *a) for k, a in zip(ACC_METRICS, acc)}
    return pos, vel, eps, pi, accs, eps_s, pi_s


def _megno_loop(pos, vel, mass, eps, pi, dr, dv, *, k_soft, mu, alpha,
                eps_min, eps_max, h, n_sub, dt, n_steps: int, n_sub_max: int,
                G, k_wall, eta, jcap, bexp, policy, grad_mode, lam_align):
    """The MEGNO kernel's loop on (B, N, d) tensors: returns
    (pos, vel, eps, pi, accum, t, ys)."""
    ph = _Physics(mass, eps, k_soft, mu, alpha, eps_min, eps_max, G=G,
                  k_wall=k_wall, eta=eta, jcap=jcap, bexp=bexp, policy=policy,
                  grad_mode=grad_mode, lam_align=lam_align)
    nsub = torch.clamp_min(n_sub, 1)
    trips = _n_trips(n_sub, n_sub_max)
    es, grad = ph.eps_star_and_grad(pos)
    accum = torch.zeros_like(eps)
    tt = torch.zeros_like(eps)
    ys = torch.empty((n_steps,) + eps.shape, dtype=eps.dtype,
                     device=eps.device)
    dt3 = dt[:, None, None]
    for step in range(n_steps):
        for sub in range(trips):
            pos, vel, eps, pi, es, grad = ph.strang_trip(
                pos, vel, eps, pi, es, grad, h, sub < nsub)
        dr = dr + dv * dt3
        dv = dv + ph.tangent_accel(pos, dr, eps) * dt3
        tt = tt + dt
        norm_r = torch.sqrt((dr * dr).sum((-2, -1)))
        # reference quirk: divides by the tiny norm, then treats it as 1
        tiny = norm_r < 1e-12
        scale = torch.where(tiny, norm_r, torch.ones_like(norm_r))
        dr = dr / scale[:, None, None]
        dv = dv / scale[:, None, None]
        norm_r = torch.where(tiny, torch.ones_like(norm_r), norm_r)
        norm_v = torch.sqrt((dv * dv).sum((-2, -1)))
        accum = accum + (norm_v / norm_r) * tt * dt
        ys[step] = 2.0 * accum / tt
    return pos, vel, eps, pi, accum, tt, ys


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _per_system(x, like):
    """A (B,) row like ``like`` from a tensor, array or scalar.  A Python
    scalar becomes a fill on the device, not a host-to-device copy (which
    would wait for the stream)."""
    if isinstance(x, (int, float)):
        return torch.full(like.shape[:1], float(x), dtype=like.dtype,
                          device=like.device)
    return torch.broadcast_to(torch.as_tensor(x, dtype=like.dtype,
                                              device=like.device),
                              like.shape[:1]).contiguous()


def _coord_major(x):
    """(B, N, d) -> (N*d, B) contiguous: neighbouring threads read
    neighbouring addresses."""
    return x.reshape(x.shape[0], -1).t().contiguous()


def _from_coord_major(x, B, n, d):
    return x.t().contiguous().reshape(B, n, d)


def _check_cuda_inputs(pos, mass, bodies, per_system):
    """Device, dtype and shape of everything a kernel reads: float32
    (B, N, d) body tensors, (B, N) masses, (B,) per-system rows (n_sub
    int32)."""
    B, n, d = pos.shape
    want = {**{k: (B, n, d) for k in bodies}, "mass": (B, n),
            **{k: (B,) for k in per_system}}
    tensors = {"pos": pos, "mass": mass, **bodies, **per_system}
    for name, t in tensors.items():
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
        if tuple(t.shape) != want.get(name, (B, n, d)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want.get(name, (B, n, d))}")
        dt_want = torch.int32 if name == "n_sub" else torch.float32
        if t.dtype != dt_want:
            raise TypeError(f"{name} must be {dt_want}, got {t.dtype}")


def _kernel_scalars(B, like, n_sub, *xs):
    out = [_per_system(x, like) for x in xs]
    ns = torch.broadcast_to(torch.as_tensor(n_sub, device=like.device),
                            (B,)).to(torch.int32).contiguous()
    return out, ns


def _l0_rows(L0, pos):
    """L0 as a (B,) row (L_z, d = 2) or a (B, 3) tensor (the L vector,
    d = 3) like ``pos``."""
    B, _, d = pos.shape
    if d == 2:
        return _per_system(L0, pos)
    return torch.broadcast_to(torch.as_tensor(L0, dtype=pos.dtype,
                                              device=pos.device),
                              (B, 3)).contiguous()


def _physics_kw(G, k_wall, eta, jcap, bexp, policy, grad_mode, lam_align):
    """The checked configuration shared by the three kernels."""
    _check_config(policy, grad_mode)
    return dict(G=float(G), k_wall=float(k_wall), eta=float(eta),
                jcap=float(jcap), bexp=int(bexp), policy=policy,
                grad_mode=grad_mode, lam_align=float(lam_align))


def _check_dim(pos, what):
    if pos.shape[-1] not in DIMS:
        raise NotImplementedError(f"the {what} kernel takes d in {DIMS}; "
                                  f"got d = {pos.shape[-1]}")


def _analysis_args(pos, n_sub, L0, scalars, n_steps, n_sub_max, interval,
                   G, k_wall, eta, jcap, bexp, policy, grad_mode, lam_align):
    kw = _physics_kw(G, k_wall, eta, jcap, bexp, policy, grad_mode,
                     lam_align)
    _check_dim(pos, "analysis")
    vals, ns = _kernel_scalars(pos.shape[0], pos, n_sub, *scalars)
    kw.update(n_sub=ns, n_steps=int(n_steps), n_sub_max=int(n_sub_max),
              interval=int(interval))
    return _l0_rows(L0, pos), vals, kw


def _accs_of(out_acc):
    return {name: (out_acc[0],) + tuple(out_acc[1 + 4 * k + r]
                                        for r in range(4))
            for k, name in enumerate(ACC_METRICS)}


def hamsoft_analysis_multistep_plain(pos, vel, mass, eps, pi, L0, *, k_soft,
                                     mu, alpha, eps_min, eps_max, h, n_sub,
                                     n_steps: int, n_sub_max: int,
                                     interval: int, G: float = 1.0,
                                     k_wall: float = 1e9, eta: float = 1.35,
                                     jcap: float = 0.02, bexp: int = 5,
                                     policy: str = "soft",
                                     grad_mode: str = "exact",
                                     lam_align: float = 0.3):
    """The plain PyTorch version of ``hamsoft_analysis_multistep`` (same
    arguments, same outputs), on any device."""
    L0, (eps, pi, k_soft, mu, alpha, eps_min, eps_max, h), kw = \
        _analysis_args(pos, n_sub, L0, (eps, pi, k_soft, mu, alpha, eps_min,
                                        eps_max, h), n_steps, n_sub_max,
                       interval, G, k_wall, eta, jcap, bexp, policy,
                       grad_mode, lam_align)
    return _analysis_loop(pos, vel, mass, eps, pi, L0, k_soft=k_soft, mu=mu,
                          alpha=alpha, eps_min=eps_min, eps_max=eps_max,
                          h=h, **kw)


def deepest_first(n_sub, n_sub_max: int):
    """The kernels' launch order: system indices by descending trip count
    min(max(n_sub, 1), n_sub_max), stable (ties keep their batch order),
    as an int32 tensor on n_sub's device.  Warp slot w runs system
    ``order[w]`` and writes its outputs at that index, so the deepest
    systems start in the first wave and the outputs stay in the caller's
    order."""
    trips = torch.clamp(n_sub, 1, max(1, int(n_sub_max)))
    return torch.argsort(trips, descending=True, stable=True).to(torch.int32)


def hamsoft_analysis_multistep(pos, vel, mass, eps, pi, L0, *, k_soft, mu,
                               alpha, eps_min, eps_max, h, n_sub,
                               n_steps: int, n_sub_max: int, interval: int,
                               G: float = 1.0, k_wall: float = 1e9,
                               eta: float = 1.35, jcap: float = 0.02,
                               bexp: int = 5, policy: str = "soft",
                               grad_mode: str = "exact",
                               lam_align: float = 0.3):
    """Advance a (B, N, d) float32 ham_soft batch ``n_steps`` macro steps
    with the analysis metric sampling fused in: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.

    Per-system (B,) inputs: eps, pi, k_soft, mu, alpha, eps_min,
    eps_max, h, n_sub (each system runs min(n_sub, n_sub_max) trips per
    step); L0 is L_z (B,) at d = 2 and the L vector (B, 3) at d = 3.
    ``policy`` is "soft" (wall kicks), "reflection" (folds) or "none";
    ``grad_mode`` "exact" or "reference" (the degeneracy fallback, its
    legacy gradient of strength ``lam_align``).
    Returns (pos, vel, eps, pi, accs, eps_samples, pi_samples): ``accs``
    maps each of ``ACC_METRICS`` to a (count, sum, sumsq, max, min)
    tuple of (B,) tensors and the sample tensors are (n_samples, B),
    n_samples = ceil(n_steps / interval)."""
    args = dict(k_soft=k_soft, mu=mu, alpha=alpha, eps_min=eps_min,
                eps_max=eps_max, h=h, n_sub=n_sub, n_steps=n_steps,
                n_sub_max=n_sub_max, interval=interval, G=G, k_wall=k_wall,
                eta=eta, jcap=jcap, bexp=bexp, policy=policy,
                grad_mode=grad_mode, lam_align=lam_align)
    if pos.device.type == "cpu":
        return hamsoft_analysis_multistep_plain(pos, vel, mass, eps, pi, L0,
                                                **args)
    if pos.device.type != "cuda":
        raise RuntimeError(f"hamsoft kernels: unsupported device {pos.device}")
    L0, (eps, pi, k_soft, mu, alpha, eps_min, eps_max, h), kw = \
        _analysis_args(pos, n_sub, L0, (eps, pi, k_soft, mu, alpha, eps_min,
                                        eps_max, h), n_steps, n_sub_max,
                       interval, G, k_wall, eta, jcap, bexp, policy,
                       grad_mode, lam_align)
    B, n, d = pos.shape
    ns = kw["n_sub"]
    _check_cuda_inputs(pos, mass, dict(vel=vel), dict(
        eps=eps, pi=pi, k_soft=k_soft, mu=mu, alpha=alpha,
        eps_min=eps_min, eps_max=eps_max, h=h, n_sub=ns))
    order = deepest_first(ns, kw["n_sub_max"])
    # L0 as 1 (d = 2) or 3 (d = 3) coordinate rows of B
    L0_c = L0.reshape(B, -1).t().contiguous()
    pos_c, vel_c = _coord_major(pos), _coord_major(vel)
    mass_c = mass.t().contiguous()
    n_samples = -(-kw["n_steps"] // kw["interval"])
    new = lambda *shape: torch.empty(shape, dtype=pos.dtype, device=pos.device)
    out_pos, out_vel = new(n * d, B), new(n * d, B)
    out_eps, out_pi = new(B), new(B)
    out_acc = new(_ACC_ROWS, B)
    out_es, out_ps = new(n_samples, B), new(n_samples, B)
    lib = _library(n, d, variant(SOURCES[0], policy, grad_mode))
    code = lib.hs_analysis(
        *cuda_build.pointers(
            pos_c, vel_c, mass_c, eps, pi, k_soft, mu, alpha, eps_min,
            eps_max, h, ns, order, L0_c, out_pos, out_vel, out_eps, out_pi,
            out_acc, out_es, out_ps),
        B, kw["n_steps"], kw["n_sub_max"], kw["interval"], *_launch_floats(kw),
        kw["bexp"], int(_wall_kicks(kw)), cuda_build.stream_of(pos))
    cuda_build.check_launch(lib, code, "hamsoft_analysis_multistep")
    hamsoft_analysis_multistep.launches += 1
    return (_from_coord_major(out_pos, B, n, d),
            _from_coord_major(out_vel, B, n, d), out_eps, out_pi,
            _accs_of(out_acc), out_es, out_ps)


hamsoft_analysis_multistep.launches = 0


def _megno_summary(accum, tt, ys, dt: float):
    """Final MEGNO, Lyapunov time and the median per-step slope
    (megno.py:92-100).  The median averages the two middle slopes, as
    ``jnp.median`` does, and is NaN where any slope is."""
    Y = 2.0 * accum / torch.clamp_min(tt, 1e-300)
    lyap = torch.where(Y == 0.0, torch.full_like(Y, math.inf),
                       tt / torch.abs(Y))
    n_steps = ys.shape[0]
    if n_steps >= 2:
        slopes = (ys[1:] - ys[:-1]) / dt
        srt = torch.sort(slopes, dim=0).values
        m = slopes.shape[0]
        med = (srt[(m - 1) // 2] + srt[m // 2]) * 0.5
        slope_med = torch.where(torch.isnan(slopes).any(0),
                                torch.full_like(med, math.nan), med)
    else:
        slope_med = torch.zeros_like(Y)
    return Y, lyap, slope_med


def _megno_args(pos, n_sub, scalars, n_steps, n_sub_max, G, k_wall, eta,
                jcap, bexp, policy, grad_mode, lam_align):
    kw = _physics_kw(G, k_wall, eta, jcap, bexp, policy, grad_mode,
                     lam_align)
    _check_dim(pos, "MEGNO")
    vals, ns = _kernel_scalars(pos.shape[0], pos, n_sub, *scalars)
    kw.update(n_sub=ns, n_steps=int(n_steps), n_sub_max=int(n_sub_max))
    return vals, kw


def hamsoft_megno_multistep_plain(pos, vel, mass, eps, pi, dr, dv, *, k_soft,
                                  mu, alpha, eps_min, eps_max, h, n_sub, dt,
                                  n_steps: int, n_sub_max: int,
                                  G: float = 1.0, k_wall: float = 1e9,
                                  eta: float = 1.35, jcap: float = 0.02,
                                  bexp: int = 5, policy: str = "soft",
                                  grad_mode: str = "exact",
                                  lam_align: float = 0.3):
    """The plain PyTorch version of ``hamsoft_megno_multistep`` (same
    arguments, same outputs), on any device."""
    (eps, pi, k_soft, mu, alpha, eps_min, eps_max, h, dt_b), kw = \
        _megno_args(pos, n_sub, (eps, pi, k_soft, mu, alpha, eps_min,
                                 eps_max, h, dt), n_steps, n_sub_max, G,
                    k_wall, eta, jcap, bexp, policy, grad_mode, lam_align)
    po, vo, eo, pio, accum, tt, ys = _megno_loop(
        pos, vel, mass, eps, pi, dr, dv, k_soft=k_soft, mu=mu, alpha=alpha,
        eps_min=eps_min, eps_max=eps_max, h=h, dt=dt_b, **kw)
    return (po, vo, eo, pio) + _megno_summary(accum, tt, ys, float(dt))


def hamsoft_megno_multistep(pos, vel, mass, eps, pi, dr, dv, *, k_soft, mu,
                            alpha, eps_min, eps_max, h, n_sub, dt,
                            n_steps: int, n_sub_max: int, G: float = 1.0,
                            k_wall: float = 1e9, eta: float = 1.35,
                            jcap: float = 0.02, bexp: int = 5,
                            policy: str = "soft", grad_mode: str = "exact",
                            lam_align: float = 0.3):
    """MEGNO continuation: advance the batch ``n_steps`` macro steps with
    the tangent map fused in: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``dr``/``dv`` are the (B, N, d) initial
    tangent vectors, ``dt`` the macro step (a float); the configuration
    arguments as ``hamsoft_analysis_multistep``'s.  Returns
    (pos, vel, eps, pi, megno, lyapunov_time, slope_med)."""
    args = dict(k_soft=k_soft, mu=mu, alpha=alpha, eps_min=eps_min,
                eps_max=eps_max, h=h, n_sub=n_sub, dt=dt, n_steps=n_steps,
                n_sub_max=n_sub_max, G=G, k_wall=k_wall, eta=eta, jcap=jcap,
                bexp=bexp, policy=policy, grad_mode=grad_mode,
                lam_align=lam_align)
    if pos.device.type == "cpu":
        return hamsoft_megno_multistep_plain(pos, vel, mass, eps, pi, dr, dv,
                                             **args)
    if pos.device.type != "cuda":
        raise RuntimeError(f"hamsoft kernels: unsupported device {pos.device}")
    (eps, pi, k_soft, mu, alpha, eps_min, eps_max, h, dt_b), kw = \
        _megno_args(pos, n_sub, (eps, pi, k_soft, mu, alpha, eps_min,
                                 eps_max, h, dt), n_steps, n_sub_max, G,
                    k_wall, eta, jcap, bexp, policy, grad_mode, lam_align)
    B, n, d = pos.shape
    ns = kw["n_sub"]
    _check_cuda_inputs(pos, mass, dict(vel=vel, dr=dr, dv=dv), dict(
        eps=eps, pi=pi, k_soft=k_soft, mu=mu, alpha=alpha, eps_min=eps_min,
        eps_max=eps_max, h=h, n_sub=ns, dt=dt_b))
    order = deepest_first(ns, kw["n_sub_max"])
    pos_c, vel_c = _coord_major(pos), _coord_major(vel)
    dr_c, dv_c = _coord_major(dr), _coord_major(dv)
    mass_c = mass.t().contiguous()
    new = lambda *shape: torch.empty(shape, dtype=pos.dtype, device=pos.device)
    out_pos, out_vel = new(n * d, B), new(n * d, B)
    out_eps, out_pi, out_accum, out_t = new(B), new(B), new(B), new(B)
    out_ys = new(kw["n_steps"], B)
    lib = _library(n, d, variant(SOURCES[0], policy, grad_mode))
    code = lib.hs_megno(
        *cuda_build.pointers(
            pos_c, vel_c, mass_c, eps, pi, k_soft, mu, alpha, eps_min,
            eps_max, h, ns, order, dt_b, dr_c, dv_c, out_pos, out_vel,
            out_eps, out_pi, out_accum, out_t, out_ys),
        B, kw["n_steps"], kw["n_sub_max"], *_launch_floats(kw), kw["bexp"],
        int(_wall_kicks(kw)), cuda_build.stream_of(pos))
    cuda_build.check_launch(lib, code, "hamsoft_megno_multistep")
    hamsoft_megno_multistep.launches += 1
    return (_from_coord_major(out_pos, B, n, d),
            _from_coord_major(out_vel, B, n, d), out_eps, out_pi) \
        + _megno_summary(out_accum, out_t, out_ys, float(dt))


hamsoft_megno_multistep.launches = 0


def _multistep_loop(pos, vel, mass, eps, pi, *, k_soft, mu, alpha, eps_min,
                    eps_max, h, n_sub, n_steps: int, n_sub_max: int, G,
                    k_wall, eta, jcap, bexp, policy, grad_mode, lam_align):
    """The multi-step kernel's loop on (B, N, d) tensors."""
    ph = _Physics(mass, eps, k_soft, mu, alpha, eps_min, eps_max, G=G,
                  k_wall=k_wall, eta=eta, jcap=jcap, bexp=bexp, policy=policy,
                  grad_mode=grad_mode, lam_align=lam_align)
    nsub = torch.clamp_min(n_sub, 1)
    trips = _n_trips(n_sub, n_sub_max)
    es, grad = ph.eps_star_and_grad(pos)
    for _step in range(n_steps):
        for sub in range(trips):
            pos, vel, eps, pi, es, grad = ph.strang_trip(
                pos, vel, eps, pi, es, grad, h, sub < nsub)
    return pos, vel, eps, pi


def _multistep_args(pos, n_sub, scalars, n_steps, n_sub_max, G, k_wall, eta,
                    jcap, bexp, policy, grad_mode, lam_align):
    kw = _physics_kw(G, k_wall, eta, jcap, bexp, policy, grad_mode,
                     lam_align)
    _check_dim(pos, "multi-step")
    vals, ns = _kernel_scalars(pos.shape[0], pos, n_sub, *scalars)
    kw.update(n_sub=ns, n_steps=int(n_steps), n_sub_max=int(n_sub_max))
    return vals, kw


def hamsoft_multistep_plain(pos, vel, mass, eps, pi, *, k_soft, mu, alpha,
                            eps_min, eps_max, h, n_sub, n_steps: int,
                            n_sub_max: int, G: float = 1.0,
                            k_wall: float = 1e9, eta: float = 1.35,
                            jcap: float = 0.02, bexp: int = 5,
                            policy: str = "soft", grad_mode: str = "exact",
                            lam_align: float = 0.3):
    """The plain PyTorch version of ``hamsoft_multistep`` (same arguments,
    same outputs), on any device."""
    (eps, pi, k_soft, mu, alpha, eps_min, eps_max, h), kw = _multistep_args(
        pos, n_sub, (eps, pi, k_soft, mu, alpha, eps_min, eps_max, h),
        n_steps, n_sub_max, G, k_wall, eta, jcap, bexp, policy, grad_mode,
        lam_align)
    return _multistep_loop(pos, vel, mass, eps, pi, k_soft=k_soft, mu=mu,
                           alpha=alpha, eps_min=eps_min, eps_max=eps_max,
                           h=h, **kw)


def hamsoft_multistep(pos, vel, mass, eps, pi, *, k_soft, mu, alpha, eps_min,
                      eps_max, h, n_sub, n_steps: int, n_sub_max: int,
                      G: float = 1.0, k_wall: float = 1e9, eta: float = 1.35,
                      jcap: float = 0.02, bexp: int = 5, policy: str = "soft",
                      grad_mode: str = "exact", lam_align: float = 0.3,
                      one_thread: bool = False):
    """Advance a (B, N, d) float32 ham_soft batch ``n_steps`` macro steps,
    each system running min(n_sub, n_sub_max) Strang substeps of size
    ``h``, with no sampling: the CUDA kernel (``csrc/hamsoft_multistep.cu``)
    for CUDA tensors, the plain version for CPU tensors.

    Per-system (B,) inputs: eps, pi, k_soft, mu, alpha, eps_min, eps_max,
    h, n_sub; d = 2 or 3; the configuration arguments as
    ``hamsoft_analysis_multistep``'s.  The SPH solve is seeded from the
    entry eps for the whole call, as in the TPU kernel.  ``one_thread``
    runs the kernel's one-thread layout at any N (the order its warp
    layout keeps, so the same bits; spilling and slow from N = 4, a
    witness of the warp layout, not a route).  Returns (pos, vel, eps,
    pi)."""
    args = dict(k_soft=k_soft, mu=mu, alpha=alpha, eps_min=eps_min,
                eps_max=eps_max, h=h, n_sub=n_sub, n_steps=n_steps,
                n_sub_max=n_sub_max, G=G, k_wall=k_wall, eta=eta, jcap=jcap,
                bexp=bexp, policy=policy, grad_mode=grad_mode,
                lam_align=lam_align)
    if pos.device.type == "cpu":
        return hamsoft_multistep_plain(pos, vel, mass, eps, pi, **args)
    if pos.device.type != "cuda":
        raise RuntimeError(f"hamsoft kernels: unsupported device {pos.device}")
    (eps, pi, k_soft, mu, alpha, eps_min, eps_max, h), kw = _multistep_args(
        pos, n_sub, (eps, pi, k_soft, mu, alpha, eps_min, eps_max, h),
        n_steps, n_sub_max, G, k_wall, eta, jcap, bexp, policy, grad_mode,
        lam_align)
    B, n, d = pos.shape
    ns = kw["n_sub"]
    _check_cuda_inputs(pos, mass, dict(vel=vel), dict(
        eps=eps, pi=pi, k_soft=k_soft, mu=mu, alpha=alpha, eps_min=eps_min,
        eps_max=eps_max, h=h, n_sub=ns))
    lib = _multistep_library(n, d, variant(SOURCES[1], policy, grad_mode,
                                            one_thread))
    order = deepest_first(ns, kw["n_sub_max"])
    pos_c, vel_c = _coord_major(pos), _coord_major(vel)
    mass_c = mass.t().contiguous()
    new = lambda *shape: torch.empty(shape, dtype=pos.dtype, device=pos.device)
    out_pos, out_vel, out_eps, out_pi = new(n * d, B), new(n * d, B), \
        new(B), new(B)
    code = lib.hs_multistep(
        *cuda_build.pointers(
            pos_c, vel_c, mass_c, eps, pi, k_soft, mu, alpha, eps_min,
            eps_max, h, ns, order, out_pos, out_vel, out_eps, out_pi),
        B, kw["n_steps"], kw["n_sub_max"], *_launch_floats(kw), kw["bexp"],
        int(_wall_kicks(kw)), int(policy == "reflection"),
        cuda_build.stream_of(pos))
    cuda_build.check_launch(lib, code, "hamsoft_multistep")
    hamsoft_multistep.launches += 1
    return (_from_coord_major(out_pos, B, n, d),
            _from_coord_major(out_vel, B, n, d), out_eps, out_pi)


hamsoft_multistep.launches = 0
