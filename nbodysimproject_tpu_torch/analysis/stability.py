"""Stability analysis on the scan engine, batched, and the facade's
single-system analyzer.

Counterpart of ``nbodysimproject_tpu/analysis/stability.py``
(``analyze_batch_jit``, ``analyze_system``, ``_track_max_radius_jit``,
``StabilityAnalyzer``; parity:
``minbody/stability_analyzer.py:69-259``): the running-moment helpers
the fused engine shares, and ``analyze_batch``, the scan engine, which
integrates every system of a batch with ``integrators/step.py`` (each
its own n_sub, as masked trips), samples the step metrics every
``max(1, n_steps // 100)`` steps, runs the MEGNO continuation and
returns the verdict columns.  ``analysis/batch.py`` runs here the
analysis tail's kepler_split lanes and every lane of a configuration
that the fused engine does not cover, as the JAX package runs both on
its scan engine.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _running_update(acc, x):
    """(count, sum, sumsq, max, min) running-moment update."""
    cnt, s, s2, mx, mn = acc
    return (cnt + 1.0, s + x, s2 + x * x, torch.maximum(mx, x),
            torch.minimum(mn, x))


def _mean(acc):
    return acc[1] / torch.clamp_min(acc[0], 1.0)


def _std(acc):
    cnt = torch.clamp_min(acc[0], 1.0)
    m = acc[1] / cnt
    return torch.sqrt(torch.clamp_min(acc[2] / cnt - m * m, 0.0))


def _rel_drift(x1, x0):
    """abs((x1-x0)/x0) with the reference's fallbacks
    (stability_analyzer.py:147-175)."""
    ok_rel = torch.isfinite(x0) & (torch.abs(x0) > 0.0) & torch.isfinite(x1)
    ok_abs = torch.isfinite(x0) & torch.isfinite(x1)
    rel = torch.abs((x1 - x0) / torch.where(x0 != 0, x0, torch.ones_like(x0)))
    return torch.where(ok_rel, rel,
                       torch.where(ok_abs, torch.abs(x1 - x0),
                                   torch.full_like(x0, float("inf"))))


def _angular_momentum(states):
    """L0 of the verdict and the tilt: L_z (B,) for d = 2, the L vector
    (B, 3) for d = 3 (stability.py:97-101 of the JAX package)."""
    from ..diagnostics import energy as E

    if states.pos.shape[-1] == 2:
        return E.angular_momentum_z(states)
    return E.angular_momentum_vector(states)


def _ang_mom_drift(state, L0):
    """Relative drift of L_z (d = 2) or of |L| (d = 3)."""
    L1 = _angular_momentum(state)
    if L1.dim() == 1:
        return _rel_drift(L1, L0)
    norm = lambda x: torch.sqrt((x * x).sum(-1))
    return _rel_drift(norm(L1), norm(L0))


def _running_init(like):
    z = torch.zeros_like(like)
    return (z, z, z, torch.full_like(z, -math.inf),
            torch.full_like(z, math.inf))


#: the step metrics whose sampled running moments feed the columns
_SAMPLED = ("com_drift", "J_eps", "theta_eps", "cos_theta", "var_L",
            "tr_hessian")


def analyze_batch(states, dyns, cfg, n_steps: int, dt, mode: str,
                  n_sub_max: int, megno_steps: int = 0, tangent=None,
                  trips=None):
    """Analyse a batch of systems on the scan engine; returns (result
    columns dict of (B,) tensors, final state).

    ``mode``: "minimal" (the energy verdict alone: ``is_stable`` and
    ``energy_drift``, no sampled metrics, as the JAX package's
    analysis/stability.py:85-95), "core" or "full"; ``megno_steps`` > 0 runs
    the MEGNO continuation in full mode from ``tangent`` = (dr0, dv0),
    the (B, N, d) initial tangent vectors.  ``dt`` is a float or a (B,)
    tensor.  ``trips`` is the substep loop length (at most
    ``n_sub_max``; read off ``dyns.n_sub`` when None, which costs a
    device-to-host read).  The step metrics are evaluated on the
    sampled steps only: the JAX package computes them on every step and
    discards the others."""
    from ..diagnostics import energy as E
    from ..diagnostics.megno import megno_scan
    from ..diagnostics.metrics import step_metrics
    from ..integrators.step import _per_system, _trips, macro_step_dynamic

    if mode not in ("minimal", "core", "full"):
        raise ValueError(f"analyze_batch: unknown mode {mode!r}")
    dtype = states.pos.dtype
    dtv = _per_system(dt, states.eps)
    if trips is None:
        trips = _trips(torch.clamp_min(dyns.n_sub, 1), n_sub_max)
    step = lambda s: macro_step_dynamic(s, dyns, cfg, dtv, n_sub_max, trips)
    H0 = E.extended_hamiltonian(states, dyns, cfg)
    state = states
    if mode == "minimal":
        for _ in range(int(n_steps)):
            state = step(state)
        drift = _rel_drift(E.extended_hamiltonian(state, dyns, cfg), H0)
        return {"is_stable": (drift < 0.01).to(dtype),
                "energy_drift": drift}, state
    L0 = _angular_momentum(states)
    sample_interval = max(1, int(n_steps) // 100)
    accs = {k: _running_init(states.eps) for k in _SAMPLED}
    for i in range(int(n_steps)):
        state = step(state)
        if i % sample_interval == 0:
            met = step_metrics(state, dyns, cfg, L0=L0, energies=False)
            accs = {k: _running_update(accs[k], met[k]) for k in accs}

    energy_drift = _rel_drift(E.extended_hamiltonian(state, dyns, cfg), H0)
    ang_mom_drift = _ang_mom_drift(state, L0)
    if mode == "full" and megno_steps > 0:
        state, megno, lyap, slope_med = megno_scan(
            state, dyns, cfg, tangent[0], tangent[1], megno_steps, dtv,
            n_sub_max, trips)
    else:
        megno = torch.full_like(H0, 2.0)
        lyap = torch.full_like(H0, math.inf)
        slope_med = torch.zeros_like(H0)

    com_mean = _mean(accs["com_drift"])
    is_stable = ((energy_drift < 0.01) & (ang_mom_drift < 0.01)
                 & (com_mean < 1.0) & (megno < 10.0))
    return {
        "is_stable": is_stable.to(dtype),
        "energy_drift": energy_drift,
        "angular_momentum_drift": ang_mom_drift,
        "com_drift_mean": com_mean,
        "com_drift_max": accs["com_drift"][3],
        "j_eps_mean": _mean(accs["J_eps"]),
        "j_eps_std": _std(accs["J_eps"]),
        "theta_eps_mean": _mean(accs["theta_eps"]),
        "theta_eps_std": _std(accs["theta_eps"]),
        "cos_theta_mean": _mean(accs["cos_theta"]),
        "cos_theta_min": accs["cos_theta"][4],
        "ang_mom_var_mean": _mean(accs["var_L"]),
        "ang_mom_var_max": accs["var_L"][3],
        "tidal_trace_mean": _mean(accs["tr_hessian"]),
        "tidal_trace_max": accs["tr_hessian"][3],
        "MEGNO": megno,
        "lyapunov_time": lyap,
        "megno_slope_med": slope_med,
    }, state


def analyze_system(state, dyn, cfg, *, n_steps: int, dt, mode: str,
                   n_sub_max: int, megno_steps: int = 0, tangent=None):
    """One system's analysis (the JAX package's ``analyze_system`` /
    ``analyze_system_jit``): ``analyze_batch`` on its B = 1 batch.
    Returns (result dict of (1,) tensors, final state)."""
    return analyze_batch(state, dyn, cfg, n_steps, dt, mode, n_sub_max,
                         megno_steps, tangent=tangent, trips=n_sub_max)


def track_max_radius(state, dyn, cfg, dt, n_steps: int, n_sub_max: int):
    """Integrate ``n_steps`` tracking max_i |q_i| over the run, per system
    (stability_analyzer.py:279-285; the JAX package's
    ``_track_max_radius_jit``).  Returns (final state, (B,) max radius)."""
    from ..integrators.step import _per_system, _trips, macro_step_dynamic

    dtv = _per_system(dt, state.eps)
    trips = _trips(torch.clamp_min(dyn.n_sub, 1), n_sub_max)
    max_r = torch.zeros_like(state.eps)
    for _ in range(int(n_steps)):
        state = macro_step_dynamic(state, dyn, cfg, dtv, n_sub_max, trips)
        r = torch.sqrt((state.pos * state.pos).sum(-1))
        r = torch.where(state.mask, r, torch.zeros_like(r))
        max_r = torch.maximum(max_r, r.amax(-1))
    return state, max_r


class StabilityAnalyzer:
    """The facade's single-system analyzer (stability_analyzer.py:33),
    on a copy of the simulation and on its device: the scan engine at
    the simulation's own substep count.

    MEGNO tangent vectors: drawn from a CPU ``torch.Generator`` seeded
    by ``seed`` (``run_stability_analysis`` draws the same vectors on
    every call, as the JAX package reuses its key there; the
    alternate paths advance the generator, as it splits its key), or
    ``tangent=(dr0, dv0)``, finished (n_slots, d) vectors used on every
    MEGNO run (e.g. the JAX package's ``init_tangent`` draws, which
    torch cannot reproduce)."""

    def __init__(self, sim, n_steps: int = 1000, dt: float = 0.01,
                 mode: str = "core", seed: int = 0, tangent=None):
        self.sim = sim
        self.n_steps = max(1, int(n_steps))
        self.dt = float(dt)
        self.mode = mode
        self.seed = int(seed)
        self._initial_mass = sim._mass.copy()
        self._initial_pos = sim._pos.copy()
        self._initial_vel = sim._vel.copy()
        self._tangent = tangent
        self._gen = torch.Generator().manual_seed(self.seed)

    def _megno_steps(self) -> int:
        n_samp = min(50, self.n_steps // 2)
        return min(100, n_samp) if n_samp > 0 else 0

    def run_stability_analysis(self) -> dict:
        from ..diagnostics import features as F
        from ..diagnostics.megno import tangent_for

        sim_copy = self.sim.copy()  # stability_analyzer.py:70
        n_sub = sim_copy._n_sub_for(self.dt)
        st = sim_copy._state
        megno_steps = self._megno_steps() if self.mode == "full" else 0
        tangent = tangent_for(st, torch.Generator().manual_seed(self.seed),
                              self._tangent) if megno_steps else None
        res, _state = analyze_system(
            st, sim_copy._dyn.replace(n_sub=torch.full_like(
                sim_copy._dyn.n_sub, n_sub)),
            sim_copy.cfg, n_steps=self.n_steps, dt=sim_copy._as_dtype(self.dt),
            mode=self.mode, n_sub_max=n_sub, megno_steps=megno_steps,
            tangent=tangent)
        # in the JAX package's order: its jitted result dict comes back
        # with the keys sorted
        out = {k: float(res[k]) for k in sorted(res)}
        out["mode"] = self.mode
        if self.mode == "full":
            initial = F.extract_all(self.sim._state, self.sim._dyn,
                                    self.sim.cfg)
            for k, v in initial.items():
                out[f"initial_{k}"] = float(v)
        return out

    # ------------------------------------------------------------------
    # alternate analysis paths (stability_analyzer.py:262-519): virial
    # radius, crossing time, the 10 T_cr horizon, escape counting, the
    # Lyapunov / T_cr >= 50 criterion
    # ------------------------------------------------------------------

    def _energy_drift_tolerance(self) -> float:
        """stability_analyzer.py:63-67."""
        dt_factor = (self.dt / 0.01) ** 1.5
        soft_factor = (self.sim.softening / 0.05) ** 0.5
        return 3e-4 * dt_factor * soft_factor

    def _quick_virial_radius(self) -> float:
        """stability_analyzer.py:49-61 (the pair-distance form with the
        +1e-12 regulariser)."""
        m, pos, G = self.sim._mass, self.sim._pos, self.sim.G
        U = 0.0
        for i in range(len(m) - 1):
            for j in range(i + 1, len(m)):
                r = np.linalg.norm(pos[j] - pos[i]) + 1e-12
                U -= G * m[i] * m[j] / r
        tot = float(m.sum())
        return abs(-G * tot ** 2 / (2 * U)) if U else 1.0

    def _compute_virial_radius(self) -> float:
        """stability_analyzer.py:361-379 (the softened-potential form
        with the mean-distance fallback)."""
        from ..diagnostics.metrics import Diagnostics

        PE = Diagnostics(self.sim).potential_energy()
        total_mass = float(np.sum(self.sim._mass))
        if PE != 0:
            return abs(-self.sim.G * total_mass ** 2 / (2 * PE))
        pos, n = self.sim._pos, self.sim.n_bodies
        dists = [np.linalg.norm(pos[j] - pos[i])
                 for i in range(n) for j in range(i + 1, n)]
        return float(np.mean(dists)) if dists else 1.0

    def _crossing_time(self) -> float:
        R_vir = self._compute_virial_radius()
        v_rms = float(np.sqrt(np.mean(np.sum(self._initial_vel ** 2,
                                             axis=1))))
        return R_vir / v_rms if v_rms > 0 else float("inf")

    def _determine_stability(self, energy_drift, max_radius, R_vir,
                             lyapunov_time, T_cr) -> bool:
        """stability_analyzer.py:386-392."""
        rate = energy_drift / (self.n_steps * self.dt)
        good_energy = rate < 1.2 * self._energy_drift_tolerance()
        good_escape = max_radius <= 10.0 * R_vir
        good_chaos = lyapunov_time >= 50.0 * T_cr
        return bool(good_energy and good_escape and good_chaos)

    def _horizon(self, T_cr) -> int:
        """Steps to 10 crossing times, at least n_steps."""
        t_target = 10.0 * T_cr if np.isfinite(T_cr) and T_cr > 0 \
            else self.n_steps * self.dt
        return max(self.n_steps, int(np.ceil(t_target / self.dt)))

    def _tracked(self, sim, n_iter: int, n_sub: int) -> float:
        """``sim`` run ``n_iter`` steps in place, each system at its own
        frozen n_sub within ``n_sub`` trips, as the JAX package's
        ``_track_max_radius_jit`` runs it; returns the maximum radial
        excursion."""
        st, max_r = track_max_radius(sim._state, sim._dyn, sim.cfg,
                                     sim._as_dtype(self.dt), n_iter, n_sub)
        sim._state = st
        return float(max_r)

    def _run_core_analysis(self) -> dict:
        """stability_analyzer.py:262-312: integrate to 10 crossing times
        tracking the maximum radial excursion, then 100 MEGNO steps."""
        from ..diagnostics.megno import megno_static, tangent_for
        from ..diagnostics.metrics import Diagnostics

        sim = self.sim.copy()
        R_vir = self._compute_virial_radius()
        T_cr = self._crossing_time()
        n_iter = self._horizon(T_cr)
        n_sub = sim._n_sub_for(self.dt)
        E0 = Diagnostics(sim).energy()
        max_r = self._tracked(sim, n_iter, n_sub)
        E1 = Diagnostics(sim).energy()
        energy_drift = abs((E1 - E0) / E0) if E0 != 0 else 0.0

        dr0, dv0 = tangent_for(sim._state, self._gen, self._tangent)
        st, megno, lyap, _slope = megno_static(
            sim._state, sim._dyn, sim.cfg, dr0, dv0, 100,
            sim._as_dtype(self.dt), n_sub)
        sim._state = st
        old_n = self.n_steps
        self.n_steps = n_iter
        is_stable = self._determine_stability(energy_drift, max_r, R_vir,
                                              float(lyap), T_cr)
        self.n_steps = old_n
        return {
            "mode": "core",
            "energy_drift": energy_drift,
            "max_radial_distance": max_r,
            "virial_radius": R_vir,
            "MEGNO": float(megno),
            "lyapunov_time": float(lyap),
            "crossing_time": T_cr,
            "is_stable": float(is_stable),
            "n_steps": float(n_iter),
            "dt": self.dt,
            "total_time": n_iter * self.dt,
        }

    def _run_full_analysis(self) -> dict:
        """stability_analyzer.py:314-346: the core horizon plus the escape
        fraction and the ML feature set."""
        from ..diagnostics import features as F

        res = self._run_core_analysis()
        sim = self.sim.copy()
        self._tracked(sim, int(res["n_steps"]), sim._n_sub_for(self.dt))
        final_r = np.sqrt((sim._pos ** 2).sum(1))
        escaped = int(np.sum(final_r > 5 * res["virial_radius"]))
        feats = F.extract_all(self.sim._state, self.sim._dyn, self.sim.cfg)
        out = dict(res)
        out["mode"] = "full"
        out["escaped_bodies"] = float(escaped)
        out["escape_fraction"] = escaped / sim.n_bodies
        for k, v in feats.items():
            out[k] = float(v)
        return out

    def serialize_to_dict(self, diagnostics: dict, max_bodies=None) -> dict:
        """Per-body initial conditions as columns
        (stability_analyzer.py:521-561)."""
        sim = self.sim
        data = {
            "n_bodies": sim.n_bodies,
            "G": sim.G,
            "softening": sim.softening,
            "min_softening": sim._min_softening,
            "adaptive": float(sim._adaptive),
            "integrator_mode": sim._integrator_mode,
        }
        m, p, v = self._initial_mass, self._initial_pos, self._initial_vel
        if max_bodies is not None and sim.n_bodies > max_bodies:
            for name, arr in (("mass", m), ("x", p[:, 0]), ("y", p[:, 1]),
                              ("vx", v[:, 0]), ("vy", v[:, 1])):
                data[f"{name}_min"] = float(np.min(arr))
                data[f"{name}_max"] = float(np.max(arr))
                data[f"{name}_mean"] = float(np.mean(arr))
                data[f"{name}_std"] = float(np.std(arr))
        else:
            for i, mass in enumerate(m):
                data[f"mass_{i}"] = float(mass)
            for i in range(len(p)):
                data[f"x_{i}"] = float(p[i, 0])
                data[f"y_{i}"] = float(p[i, 1])
            for i in range(len(v)):
                data[f"vx_{i}"] = float(v[i, 0])
                data[f"vy_{i}"] = float(v[i, 1])
        data.update(diagnostics)
        return data

    def save_to_csv(self, filename: str, diagnostics: dict = None):
        import pandas as pd

        if diagnostics is None:
            diagnostics = self.run_stability_analysis()
        pd.DataFrame([self.serialize_to_dict(diagnostics)]).to_csv(
            filename, index=False)
