"""Stability analysis on the scan engine, batched.

Counterpart of ``nbodysimproject_tpu/analysis/stability.py``
(``analyze_system`` / ``analyze_batch_jit``; parity:
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
