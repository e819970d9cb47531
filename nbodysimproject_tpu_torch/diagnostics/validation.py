"""ham_soft acceptance validation.

Counterpart of ``nbodysimproject_tpu/diagnostics/validation.py`` on the
port's facade.  Parity: ``minbody/hamsoft_validation.py:30-121``
(validate_ham_soft): (1) extended-Hamiltonian drift <= energy_tol_pref
* h^2 over n_steps, (2) numerical dpi/dt and deps/dt vs the analytic canonical EOM,
(3) pi stays put at equilibrium with G = 0.

Like the reference, failures print and return (print-and-continue
convention); the test suite asserts on the returned report dict, which
the reference does not provide.
"""

from __future__ import annotations

import time


def validate_ham_soft(integrator_or_sim, n_steps: int = 256, dt: float = 1e-3,
                      *, energy_tol: float = 1e-8, canon_tol: float = 1e-10,
                      pi_tol: float = 1e-12) -> dict:
    from ..facade.simulation import NBodySimulation
    from .metrics import Diagnostics

    sim = getattr(integrator_or_sim, "_sim", None) or getattr(
        integrator_or_sim, "sim", integrator_or_sim)

    t0 = time.perf_counter()
    report = {}

    diag = Diagnostics(sim)
    H0 = diag.compute_extended_hamiltonian()
    for _ in range(n_steps):
        sim.step(dt)
    H1 = diag.compute_extended_hamiltonian()
    tol_pref = float(getattr(sim.cfg, "energy_tol_pref", 1e-7))
    abs_bound = tol_pref * dt * dt
    report["dH"] = abs(H1 - H0)
    report["dH_bound"] = abs_bound
    report["energy_ok"] = abs(H1 - H0) <= abs_bound
    if not report["energy_ok"]:
        print("Extended Hamiltonian |dH| exceeds C*h^2 bound")

    # --- canonical EOM consistency (:49-99) ---------------------------
    snap = sim.snapshot()
    sim_c = NBodySimulation.restore(snap, device=sim.device)
    int_c = sim_c._integrator

    eps0, pi0 = sim_c._epsilon, sim_c._pi
    qd, pd, deps_dt_exp, dpi_dt_exp = int_c.canonical_eom()

    sim_c.step(dt)
    dpi_dt_num = (sim_c._pi - pi0) / dt
    deps_dt_num = (sim_c._epsilon - eps0) / dt

    def rel(a, b):
        return abs(a - b) / max(abs(a), abs(b), 1e-30)

    report["dpi_rel_err"] = rel(dpi_dt_num, dpi_dt_exp)
    report["deps_rel_err"] = rel(deps_dt_num, deps_dt_exp)
    report["canon_ok"] = (report["dpi_rel_err"] <= canon_tol
                          and report["deps_rel_err"] <= canon_tol)
    if report["dpi_rel_err"] > canon_tol:
        print("dpi/dt mismatch exceeds tolerance")
    if report["deps_rel_err"] > canon_tol:
        print("deps/dt mismatch exceeds tolerance")

    # --- equilibrium pi drift with G = 0 (:102-116) ---------------------
    sim_eq = NBodySimulation.restore(snap, device=sim.device)
    sim_eq.G = 0.0
    sim_eq._dyn = sim_eq._dyn.replace(G=sim_eq._as_dtype(0.0))
    eps_eq = sim_eq._integrator._eps_target()
    sim_eq._epsilon = float(eps_eq)
    sim_eq._pi = 0.123456789
    pi_start = sim_eq._pi
    for _ in range(n_steps):
        sim_eq.step(dt)
    report["pi_drift"] = abs(sim_eq._pi - pi_start)
    report["pi_ok"] = report["pi_drift"] <= pi_tol
    if not report["pi_ok"]:
        print("pi drift detected at equilibrium")

    if time.perf_counter() - t0 > 1.0:
        print("[warning] validate_ham_soft took longer than 1 s")
    report["ok"] = bool(report["energy_ok"] and report["canon_ok"]
                        and report["pi_ok"])
    return report
