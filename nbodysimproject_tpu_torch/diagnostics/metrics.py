"""Step metrics, batched, and the facade's ``Diagnostics``.

Counterpart of ``step_metrics``, ``tidal_trace`` and ``Diagnostics`` of
``nbodysimproject_tpu/diagnostics/metrics.py`` (parity:
``minbody/diagnostics.py:241-285``) on a batched state: one value per
system for COM drift, J_eps, theta_eps, the angular-momentum statistics,
the tidal trace and (optionally) the energy breakdown.  d = 2 takes the
reference's scalar L_z statistics, d = 3 the JAX package's vector
branch (L_tot = |sum m q x v|, var_L of the per-body |L_i|, cos_theta
the tilt of L against L0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import energy as E
from ..ops.geometry import pair_diff, pair_mask


def tidal_trace(state, dyn, cfg=None):
    """Trace of the Hessian of the softened potential:
    2 G sum_{i<j} m_i m_j (d (r^2+eps^2) - 3 r^2) / (r^2+eps^2)^{5/2},
    with the force softening in use (eps for ham_soft, sqrt(step_s2)
    for the classical modes)."""
    diff = pair_diff(state.pos)
    r2 = (diff * diff).sum(-1)
    if cfg is not None and getattr(cfg, "integrator_mode", None) \
            != "ham_soft":
        eps2 = state.step_s2
    else:
        eps2 = state.eps * state.eps
    s = r2 + eps2[..., None, None]
    pm = pair_mask(state.pos.shape[-2], state.mask)
    mm = state.mass[..., :, None] * state.mass[..., None, :]
    num = state.pos.shape[-1] * s - 3.0 * r2
    contrib = torch.where(pm, mm * num / torch.clamp_min(s, 1e-300) ** 2.5,
                          torch.zeros_like(s))
    return dyn.G * contrib.sum((-2, -1))  # i != j double counts


def _l_stats_2d(m, pos, vel, msk, L0, nan):
    """Scalar L_z statistics, the reference's semantics."""
    zero = torch.zeros_like(m)
    L_i = m * (pos[..., 0] * vel[..., 1] - pos[..., 1] * vel[..., 0])
    L_i = torch.where(msk, L_i, zero)
    L_tot = L_i.sum(-1)
    nb = torch.clamp_min(msk.to(L_i.dtype).sum(-1), 1.0)
    L_mean = L_tot / nb
    var_L = torch.where(msk, (L_i - L_mean[..., None]) ** 2, zero).sum(-1) / nb
    if L0 is None:
        L0 = L_tot
    cos_ok = (L0 != 0.0) & (L_tot != 0.0)
    cos_theta = torch.where(cos_ok, (L_tot * L0)
                            / (torch.abs(L_tot) * torch.abs(L0)), nan)
    return L_tot, var_L, cos_theta


def _l_stats_3d(m, pos, vel, msk, L0, nan):
    """Vector angular momentum (metrics.py:95-110 of the JAX package):
    L_tot the magnitude of the total, var_L the variance of the per-body
    |L_i|, cos_theta the tilt of L against L0.  The floor 1e-300 of the
    tilt's denominator is taken in the working dtype, as there: 0 in
    float32."""
    L_iv = torch.where(msk[..., None],
                       m[..., None] * torch.linalg.cross(pos, vel, dim=-1),
                       torch.zeros_like(pos))
    L_vec = L_iv.sum(-2)
    L_tot = torch.sqrt((L_vec * L_vec).sum(-1))
    l_i = torch.sqrt((L_iv * L_iv).sum(-1))
    zero = torch.zeros_like(l_i)
    nb = torch.clamp_min(msk.to(l_i.dtype).sum(-1), 1.0)
    l_mean = torch.where(msk, l_i, zero).sum(-1) / nb
    var_L = torch.where(msk, (l_i - l_mean[..., None]) ** 2, zero).sum(-1) / nb
    L0v = L_vec if L0 is None else L0
    L0n = torch.sqrt((L0v * L0v).sum(-1))
    cos_ok = (L0n != 0.0) & (L_tot != 0.0)
    den = torch.maximum(L_tot * L0n, L_tot.new_tensor(1e-300))
    cos_theta = torch.where(cos_ok, (L_vec * L0v).sum(-1) / den, nan)
    return L_tot, var_L, cos_theta


def step_metrics(state, dyn, cfg, L0=None, megno_slope_median=None,
                 energies: bool = True):
    """dict of (B,) step metrics (diagnostics.py:241-285).  ``L0`` is the
    first-seen total angular momentum: L_z (B,) for d = 2, the L vector
    (B, 3) for d = 3; ``energies=False`` leaves out the energy breakdown
    (an eps* solve), which callers reading only the metric columns do
    not need."""
    m, pos, vel, msk = state.mass, state.pos, state.vel, state.mask

    com_vec = torch.where(msk[..., None], m[..., None] * pos,
                          torch.zeros_like(pos)).sum(-2)
    com_drift = torch.sqrt((com_vec * com_vec).sum(-1))

    mu = dyn.mu_soft
    J_eps = state.eps * state.pi / torch.where(mu != 0.0, mu,
                                               torch.ones_like(mu))
    denom_ok = (mu * state.eps != 0.0) | (state.pi != 0.0)
    nan = torch.full_like(state.eps, math.nan)
    theta_eps = torch.where(denom_ok, torch.atan2(state.pi, mu * state.eps),
                            nan)

    if pos.shape[-1] == 2:
        L_tot, var_L, cos_theta = _l_stats_2d(m, pos, vel, msk, L0, nan)
    else:
        L_tot, var_L, cos_theta = _l_stats_3d(m, pos, vel, msk, L0, nan)

    out = dict(
        com_drift=com_drift, J_eps=J_eps, L_tot=L_tot, var_L=var_L,
        cos_theta=cos_theta, tr_hessian=tidal_trace(state, dyn, cfg),
        megno_slope_med=(nan if megno_slope_median is None
                         else megno_slope_median),
        theta_eps=theta_eps)
    if energies:
        out.update(E.energy_breakdown(state, dyn, cfg))
    return out


class Diagnostics:
    """The facade's diagnostics (diagnostics.py:33): conserved
    quantities, the extended Hamiltonian, the step metrics and the
    runtime energy guard of one simulation, as host floats (each a
    device-to-host read on the card)."""

    #: occurrences of each rate-limited message, shared by every instance
    #: (diagnostics.py:387-421)
    _GLOBAL_DIAG_COUNTS: dict = {}

    def __init__(self, simulation, integrator=None):
        self.sim = simulation
        self._integ = integrator
        pref = getattr(simulation.cfg, "energy_tol_pref", None)
        self._tol_pref = float(pref) if pref is not None else 1e-7
        self._H0_mod = None
        self._step_idx = 0

    def _args(self):
        return self.sim._state, self.sim._dyn, self.sim.cfg

    # -- conserved quantities -------------------------------------------
    def kinetic_energy(self) -> float:
        return float(E.kinetic_energy(self.sim._state))

    def potential_energy(self) -> float:
        return float(E.potential_energy(self.sim._state, self.sim._dyn))

    def energy(self) -> float:
        return float(E.energy(*self._args()))

    def energy_breakdown(self) -> dict:
        return {k: float(v) for k, v in E.energy_breakdown(*self._args())
                .items()}

    def angular_momentum(self) -> float:
        return float(E.angular_momentum_z(self.sim._state))

    def linear_momentum(self):
        p = E.linear_momentum(self.sim._state)[0].cpu().numpy()
        return float(p[0]), float(p[1])

    def center_of_mass(self):
        x, v = (t[0].cpu().numpy() for t in E.center_of_mass(self.sim._state))
        return (float(x[0]), float(x[1])), (float(v[0]), float(v[1]))

    def compute_extended_hamiltonian(self) -> float:
        return float(E.extended_hamiltonian(*self._args()))

    # -- step metrics -----------------------------------------------------
    def step_metrics(self, megno_slope_history=None) -> dict:
        """The step metrics with L0 = the first call's L_z (at d = 3, as
        in the JAX package, L_z stands for the L vector's every
        component in the tilt)."""
        st = self.sim._state
        med = None
        if megno_slope_history:
            med = torch.full_like(st.eps,
                                  float(np.median(megno_slope_history)))
        if not hasattr(self, "_L0"):
            self._L0 = float(E.angular_momentum_z(st))
        L0 = torch.full_like(st.eps, self._L0)
        if st.pos.shape[-1] == 3:
            L0 = L0[..., None]
        d = step_metrics(st, self.sim._dyn, self.sim.cfg, L0=L0,
                         megno_slope_median=med)
        return {k: float(v) for k, v in d.items()}

    # -- rate-limited diagnostics (diagnostics.py:387-421) ----------------
    def _rate_limited_diag_print(self, key: str, msg: str) -> None:
        cfg = getattr(self.sim, "cfg", None)
        if cfg is not None and not getattr(cfg, "diag_prints", True):
            return
        limit = max(int(getattr(cfg, "diag_print_limit", 3)) if cfg else 3,
                    0)
        interval = max(int(getattr(cfg, "diag_print_interval", 1000))
                       if cfg else 1000, 1)
        counts = Diagnostics._GLOBAL_DIAG_COUNTS
        c = counts.get(key, 0) + 1
        counts[key] = c
        if c <= limit:
            print(msg)
        elif c % interval == 0:
            print(f"{msg} (occurrence #{c})")

    # -- runtime energy guard (diagnostics.py:288-384) --------------------
    def energy_guard(self, dt: float) -> None:
        cfg = self.sim.cfg
        if not cfg.enable_runtime_guard:
            return
        self._step_idx += 1
        if self._step_idx % int(cfg.invariant_check_interval):
            return
        H_now = self.compute_extended_hamiltonian()
        if self._H0_mod is None:
            self._H0_mod = H_now
            return
        tol = self._tol_pref * dt * dt
        if abs(H_now - self._H0_mod) > tol:
            print(f"[energy_guard] |dH_ext| = {abs(H_now - self._H0_mod):.3e}"
                  f" > tol = {tol:.3e}")
