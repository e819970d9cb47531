"""Universal-variable (Stiefel–Scheifele) two-body propagation, batched.

Counterpart of ``nbodysimproject_tpu/ops/kepler.py`` (parity:
``minbody/kepler_solver.py``): closed-form Stumpff functions with a
series window, the adaptive Newton solver capped at the reference's 64
iterations, the fixed-depth Laguerre–Conway solver and the shared f/g
epilogue, on tensors with any leading batch shape.  ``r``, ``v`` are
``(..., d)``; ``mu`` and ``dt`` broadcast against ``r[..., 0]`` (a
float ``dt`` is taken as well).

The JAX solver's ``while_loop`` runs, under ``vmap``, until every lane is
frozen.  Here the same masked update runs on the whole batch, and the
host asks whether every lane is done only once every ``_DONE_CHECK``
iterations (each question is a device-to-host sync); a frozen lane does
not move, so the extra iterations change nothing.
"""

from __future__ import annotations

import math

import torch

_NEWTON_ITERS = 64
_SERIES_CUTOFF = 0.3
#: iterations of the adaptive solver between two host checks of
#: "every lane done" (divides _NEWTON_ITERS)
_DONE_CHECK = 8


def stumpff(z):
    """c0(z), c1(z), c2(z), c3(z) elementwise (kepler_solver.py:25-46):
    trig for z > 0, hyperbolic for z < 0 (the argument clamped where
    cosh/sinh would overflow: s <= 700 in float64, 88 in float32), the
    Taylor series for |z| <= 0.3."""
    small = torch.abs(z) <= _SERIES_CUTOFF
    zs = torch.where(small, z, torch.zeros_like(z))
    z2 = zs * zs
    z3 = z2 * zs
    z4 = z2 * z2
    z5 = z4 * zs
    z6 = z4 * z2
    c0_s = (1 - zs / 2 + z2 / 24 - z3 / 720 + z4 / 40320 - z5 / 3628800
            + z6 / 479001600)
    c1_s = (1 - zs / 6 + z2 / 120 - z3 / 5040 + z4 / 362880
            - z5 / 39916800 + z6 / 6227020800)
    c2_s = (0.5 - zs / 24 + z2 / 720 - z3 / 40320 + z4 / 3628800
            - z5 / 479001600)
    c3_s = (1 / 6 - zs / 120 + z2 / 5040 - z3 / 362880 + z4 / 39916800
            - z5 / 6227020800)

    one = torch.ones_like(z)
    pos = z > 0
    s_e = torch.sqrt(torch.where(pos, z, one))
    s_h = torch.sqrt(torch.where(pos, one, -z))
    s_cap = 700.0 if z.dtype == torch.float64 else 88.0
    s_h = torch.clamp_max(s_h, s_cap)
    c0_t = torch.where(pos, torch.cos(s_e), torch.cosh(s_h))
    c1_t = torch.where(pos, torch.sin(s_e) / s_e, torch.sinh(s_h) / s_h)
    z_safe = torch.where(small, one, z)
    c2_t = (1.0 - c0_t) / z_safe
    c3_t = (1.0 - c1_t) / z_safe
    return (torch.where(small, c0_s, c0_t), torch.where(small, c1_s, c1_t),
            torch.where(small, c2_s, c2_t), torch.where(small, c3_s, c3_t))


def _as_lane(x, like):
    """``mu`` or ``dt`` as a tensor broadcast to the lane shape."""
    return torch.broadcast_to(torch.as_tensor(x, dtype=like.dtype,
                                              device=like.device)
                              if not torch.is_tensor(x) else x, like.shape)


def _kepler_prologue(r, v, mu, dt):
    """Orbit invariants and the Newton/Halley seed (per lane)."""
    r0 = torch.sqrt((r * r).sum(-1))
    degenerate = r0 < 1e-14
    r0s = torch.where(degenerate, torch.ones_like(r0), r0)
    vr0 = (r * v).sum(-1) / r0s
    v2 = (v * v).sum(-1)
    alpha = 2.0 / r0s - v2 / mu
    sqrt_mu = torch.sqrt(mu)
    chi0 = torch.where(torch.abs(alpha) > 1e-12,
                       sqrt_mu * torch.abs(alpha) * dt, sqrt_mu * dt / r0s)
    return r0s, degenerate, vr0, alpha, sqrt_mu, chi0


def _kepler_epilogue(r, v, mu, dt, chi, r0s, degenerate, alpha, sqrt_mu):
    """f/g and fdot/gdot update from the converged chi (the reference's
    fdot slip, kepler_solver.py:88, corrected as in the JAX package)."""
    z = alpha * chi * chi
    _c0, _c1, c2, c3 = stumpff(z)
    f = 1 - chi * chi * c2 / r0s
    g = dt - chi * chi * chi * c3 / sqrt_mu
    r_vec = f[..., None] * r + g[..., None] * v
    rn = torch.sqrt((r_vec * r_vec).sum(-1))
    rn_zero = rn == 0.0
    rns = torch.where(rn_zero, torch.ones_like(rn), rn)
    fdot = sqrt_mu / (rns * r0s) * (alpha * chi * chi * chi * c3 - chi)
    gdot = 1 - chi * chi * c2 / rns
    v_vec = torch.where(rn_zero[..., None], v,
                        fdot[..., None] * r + gdot[..., None] * v)
    deg = degenerate[..., None]
    r_out = torch.where(deg, r + v * dt[..., None], r_vec)
    v_out = torch.where(deg, v, v_vec)
    return r_out, v_out


def kepler_propagate(r, v, mu, dt):
    """Propagate (r, v) for time dt under GM = mu with the adaptive
    Newton solver: a lane freezes when chi repeats, enters a 2-cycle or
    f' == 0, and no lane takes more than 64 iterations (the reference's
    cap, kepler_solver.py:64-79).  Returns (r, v)."""
    mu = _as_lane(mu, r[..., 0])
    dt = _as_lane(dt, r[..., 0])
    r0s, degenerate, vr0, alpha, sqrt_mu, chi = _kepler_prologue(r, v, mu,
                                                                 dt)
    a1 = r0s * vr0 / sqrt_mu
    a2 = 1 - alpha * r0s
    prev1 = torch.full_like(chi, math.nan)
    prev2 = prev1.clone()
    done = torch.zeros(chi.shape, dtype=torch.bool, device=chi.device)
    for it in range(_NEWTON_ITERS):
        z = alpha * chi * chi
        _c0, _c1, c2, c3 = stumpff(z)
        f = (a1 * chi * chi * c2 + a2 * chi * chi * chi * c3 + r0s * chi
             - sqrt_mu * dt)
        fp = (a1 * chi * (1 - alpha * chi * chi * c3) + a2 * chi * chi * c2
              + r0s)
        fp_zero = fp == 0.0
        one = torch.ones_like(fp)
        chi_new = torch.where(fp_zero, chi,
                              chi - f / torch.where(fp_zero, one, fp))
        converged = (chi_new == chi) | (chi_new == prev2)
        chi_out = torch.where(done | fp_zero, chi, chi_new)
        prev2 = torch.where(done, prev2, prev1)
        prev1 = torch.where(done, prev1, chi_new)
        done = done | fp_zero | converged
        chi = chi_out
        if (it + 1) % _DONE_CHECK == 0 and bool(done.all()):
            break
    return _kepler_epilogue(r, v, mu, dt, chi, r0s, degenerate, alpha,
                            sqrt_mu)


def kepler_propagate_fixed(r, v, mu, dt, iters: int = 8):
    """Fixed-depth Laguerre–Conway variant (n = 5, Conway 1986) with
    Vallado's logarithmic seed on hyperbolic lanes: ``iters`` updates
    with no convergence branch (ops/kepler.py:208-300 of the JAX
    package).  Returns (r, v)."""
    mu = _as_lane(mu, r[..., 0])
    dt = _as_lane(dt, r[..., 0])
    r0s, degenerate, vr0, alpha, sqrt_mu, chi0 = _kepler_prologue(r, v, mu,
                                                                  dt)
    one = torch.ones_like(chi0)
    hyp = alpha < -1e-12
    alpha_h = torch.where(hyp, alpha, -one)
    sgn_dt = torch.where(dt >= 0.0, one, -one)
    log_num = -2.0 * mu * alpha_h * dt
    log_den = (r0s * vr0
               + sgn_dt * torch.sqrt(-mu / alpha_h) * (1.0 - r0s * alpha_h))
    log_arg = log_num / torch.where(log_den == 0.0, one, log_den)
    hyp_ok = hyp & (log_den != 0.0) & (log_arg > 0.0)
    chi0_hyp = sgn_dt * torch.sqrt(-1.0 / alpha_h) * \
        torch.log(torch.where(hyp_ok, log_arg, one))
    chi = torch.where(hyp_ok, chi0_hyp, chi0)

    a1 = r0s * vr0 / sqrt_mu
    a2 = 1 - alpha * r0s
    ln = 5.0
    for _ in range(int(iters)):
        z = alpha * chi * chi
        _c0, _c1, c2, c3 = stumpff(z)
        chi2 = chi * chi
        f = a1 * chi2 * c2 + a2 * chi2 * chi * c3 + r0s * chi \
            - sqrt_mu * dt
        fp = a1 * chi * (1 - z * c3) + a2 * chi2 * c2 + r0s
        fpp = a1 * (1 - z * c2) + a2 * chi * (1 - z * c3)
        disc = torch.sqrt(torch.abs((ln - 1.0) ** 2 * fp * fp
                                    - ln * (ln - 1.0) * f * fpp))
        den = fp + torch.where(fp >= 0.0, disc, -disc)
        den_bad = den == 0.0
        step = ln * f / torch.where(den_bad, one, den)
        chi = chi - torch.where(den_bad, torch.zeros_like(step), step)
    return _kepler_epilogue(r, v, mu, dt, chi, r0s, degenerate, alpha,
                            sqrt_mu)


class UniversalVariableKeplerSolver:
    """API-parity view (kepler_solver.py:24): ``propagate`` takes one
    (d,) state or an (N, d) batch (:94-107), as tensors or arrays (a
    NumPy input gives float64 tensors on the CPU)."""

    def propagate(self, r, v, mu, dt):
        r = torch.as_tensor(r)
        v = torch.as_tensor(v, dtype=r.dtype, device=r.device)
        return kepler_propagate(r, v, mu, dt)
