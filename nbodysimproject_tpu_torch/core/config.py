"""Static simulation configuration.

Counterpart of ``nbodysimproject_tpu/core/config.py``: the same frozen
dataclass with every field and default, so that a configuration compares
one to one between the two packages (the JAX package's file documents
each field).  Parity: ``minbody/sim_config.py:27`` plus the "shadow"
knobs the reference reads via ``getattr``.  Fields that steer parts of
the JAX build this port does not have (Pallas forces, the fused eps
kernel, the scan engine) are kept and ignored here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

@dataclass(frozen=True)
class SimConfig:
    # --- declared reference fields (sim_config.py:28-57) ---------------
    safety_factor: float = 0.20
    theta_cap: float = 0.1
    theta_imp: float = 0.5
    k_soft: float = 1.0e3
    enable_runtime_guard: bool = False
    split_n_max: int = 50
    fast_float32: bool = False
    adaptive_timestep: bool = False
    adaptive_softening: bool = False
    softening_scale: float = 1.0
    integrator_mode: str = "ham_soft"
    use_energy_spring: bool = True
    use_soft_barrier: bool = True
    initial_dt: float = 0.01
    max_fraction_of_dt: float = 0.1
    corrector_order: int = 5
    disable_barrier: bool = False
    barrier_exponent: int = 5
    k_wall: float = 1.0e9
    n_wall: int = 4
    alpha: float = 0.1
    eta: float = 1.35
    guard_dt_ref: float = 1e-3
    energy_drift_abort_threshold: float = 1e-6
    ang_mom_drift_abort_threshold: float = 1e-5
    abort_on_violation: bool = True
    fixed_substeps: bool = True
    invariant_check_interval: int = 2000
    energy_tol_pref: float = 1e-8
    freeze_s_subsystem: bool = False

    # --- shadow flags read via getattr in the reference ----------------
    j_max_cap: float = 0.02              # hamsoft_stepper.py:33-45
    chi_pi: float = 0.2                  # hamiltonian_softening_integrator.py:216-221
    fixed_eps_star: bool = False         # hamsoft_eps_model.py:82
    eps_star_value: float | None = None  # hamsoft_eps_model.py:83
    use_legacy_eps_star: bool = False    # hamsoft_eps_model.py:87
    lambda_softening: float = 0.3        # hamsoft_constants.py:35 (env LAMBDA_SOFTENING)
    include_barrier_curvature_in_S: bool = False  # hamsoft_stepper.py:167
    diag_prints: bool = True             # diagnostics.py:395
    diag_print_limit: int = 3
    diag_print_interval: int = 1000
    _validate_S_only: bool = False       # hamiltonian_softening_integrator.py:804
    _allow_v_eps_override: bool = False  # hamsoft_stepper.py:554

    # --- extensions of the JAX package (see its core/config.py) ----
    dim: int = 2                         # reference hard-codes 2; we parameterise
    eps_grad_mode: str = "exact"
    use_pallas_forces: bool = False
    pallas_force_min_n: int = 1024
    fused_eps_grad: bool = True
    slot_bucket: int = 1
    analysis_n_sub_cap: int = 0
    early_exit_probe: float = 0.0
    early_exit_min_n_sub: int = 8
    analysis_tail_policy: str = "kepler"
    tail_min_n_sub: int = 64
    tail_dominance_margin: float = 3.0
    tail_min_gain: int = 8
    analysis_group_quantum: int = 0
    analysis_bucket_packing: bool = True
    tail_kepler_iters: int = 8
    use_fused_analysis: bool = False
    use_fused_megno: bool = True
    use_fused_metrics: bool = True
    force_mode: str = "direct"
    whfast_kepler_iters: int = 0
    pm_grid: int = 256                   # P3M mesh cells per side
    pm_r_cut_cells: float = 4.0          # short-range split radius
    pm_auto_min_n: int = 32768

    def copy(self) -> "SimConfig":
        """Shallow copy, API parity with sim_config.py:59-62."""
        return dataclasses.replace(self)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
