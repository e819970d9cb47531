"""Batched ham_soft analysis driven by the fused kernels.

Counterpart of ``nbodysimproject_tpu/analysis/fused.py``.  Two ways to
the metric moments, as in the JAX package:

* ``cfg.use_fused_metrics`` (the dataset pipeline's): one analysis
  kernel call for the whole sampled horizon, the metric moments
  accumulated in-kernel, J_eps and theta_eps derived here from the
  sampled (eps, pi) rows;
* otherwise: the plain multi-step kernel in chunks of [1, interval,
  interval, ...] steps, ``diagnostics/metrics.py::step_metrics`` after
  each chunk, and an unsampled tail.  Each chunk seeds its SPH solve
  from its own entry eps (the fused call seeds once), so the two ways
  agree to the fused-vs-scan tolerances, not bit for bit.

Both keep the scan path's sampling semantics: after macro step i, sample
when ``i % interval == 0``.  ``cfg.use_fused_megno`` runs the MEGNO
continuation in its own kernel; otherwise the MEGNO scan
(``diagnostics/megno.py::megno_scan``) continues from the final state,
as the JAX package's analysis/fused.py:203-208 does.

The JAX package falls back to its scan engine on the CPU
(``fused_path_applicable``); here the engine runs wherever the
configuration is covered (``fused_config_covered``: every barrier policy
and both eps* gradient modes, as the JAX fused engine), and on the CPU
the kernel wrappers run their plain versions because the tensors lie
there.  At d = 3
L0 is the (B, 3) L vector, ``angular_momentum_drift`` the relative drift
of |L| and cos_theta the tilt of L against L0 (the JAX package's
analysis/fused.py:98-108, :172-182).
"""

from __future__ import annotations

import math

import torch

from ..diagnostics import energy as E
from ..diagnostics.megno import megno_scan
from ..diagnostics.metrics import step_metrics
from ..ops.hamsoft_kernels import (check_slots, hamsoft_analysis_multistep,
                                   hamsoft_megno_multistep,
                                   hamsoft_multistep)
from .stability import (_ang_mom_drift, _angular_momentum, _mean,
                        _rel_drift, _running_update, _std)


def _kernel_policy(cfg) -> str:
    """The cfg barrier flags as the kernels' policy name
    (integrators/hamsoft.py policy_is_soft + refl)."""
    if bool(cfg.use_soft_barrier) and not bool(cfg.disable_barrier):
        return "soft"
    if not bool(cfg.disable_barrier):
        return "reflection"
    return "none"


def _states_with(states, quad):
    pos, vel, eps, pi = quad
    return states.replace(pos=pos, vel=vel, eps=eps, pi=pi, s=eps,
                          step_s2=eps * eps)


def _moments(x):
    """(count, sum, sumsq, max, min) over the sample rows of x (S, B),
    folded row by row, so a lane's value does not depend on how many
    lanes share the call."""
    zero = torch.zeros_like(x[0])
    acc = (zero, zero, zero, torch.full_like(zero, -math.inf),
           torch.full_like(zero, math.inf))
    for row in x:
        acc = _running_update(acc, row)
    return acc


def analyze_batch_fused(states, dyns, cfg, n_steps: int, dt, mode: str,
                        n_sub_max: int, megno_steps: int, tangent=None,
                        g_static: float = 1.0,
                        analysis_fn=hamsoft_analysis_multistep,
                        megno_fn=hamsoft_megno_multistep,
                        multistep_fn=hamsoft_multistep):
    """Analyse a batch of systems on the fused kernels (ham_soft, float32
    on the card; the plain versions on the CPU).

    ``states``/``dyns`` are batched with leading axis B; G must be the
    uniform ``g_static`` (checked by the caller).  ``tangent`` is the
    (dr0, dv0) pair of (B, N, d) initial MEGNO tangent vectors, required
    in full mode.  ``analysis_fn``/``megno_fn``/``multistep_fn`` default
    to the kernel wrappers; a comparison passes their plain versions,
    which take the same arguments.  On the card the kernels take N from
    2 to 16 body slots: any other N raises before anything is launched.
    Returns (result columns dict of (B,) tensors, final state)."""
    B = states.pos.shape[0]
    if states.pos.device.type == "cuda":
        check_slots(*states.pos.shape[1:])
    dtype = states.pos.dtype
    n_sub = torch.clamp_min(dyns.n_sub, 1)
    h = float(dt) / n_sub.to(dtype)
    kern = dict(k_soft=dyns.k_soft, mu=dyns.mu_soft, alpha=dyns.alpha_run,
                eps_min=dyns.min_softening, eps_max=dyns.max_softening, h=h,
                n_sub=n_sub, n_sub_max=n_sub_max, G=g_static,
                k_wall=float(cfg.k_wall), eta=float(cfg.eta),
                jcap=float(cfg.j_max_cap), bexp=int(cfg.barrier_exponent),
                policy=_kernel_policy(cfg), grad_mode=str(cfg.eps_grad_mode),
                lam_align=float(cfg.lambda_softening))

    H0 = E.extended_hamiltonian(states, dyns, cfg)
    L0 = _angular_momentum(states)

    sample_interval = max(1, n_steps // 100)
    if getattr(cfg, "use_fused_metrics", False):
        po, vo, eo, pio, accs, eps_s, pi_s = analysis_fn(
            states.pos, states.vel, states.mass, states.eps, states.pi, L0,
            n_steps=n_steps, interval=sample_interval, **kern)
        mu_b = dyns.mu_soft[None, :]
        j_s = eps_s * pi_s / torch.where(mu_b != 0.0, mu_b,
                                         torch.ones_like(mu_b))
        ok = (mu_b * eps_s != 0.0) | (pi_s != 0.0)
        # atan2 in float64, rounded back: the CPU's vectorised float32
        # atan2 rounds the last elements of a tensor apart from the
        # others, which would make a lane's value depend on the lanes
        # that share the call (the tail's rows leave it)
        th = torch.atan2(pi_s.double(), (mu_b * eps_s).double()).to(dtype)
        th_s = torch.where(ok, th, torch.full_like(eps_s, math.nan))
        accs = dict(accs, J_eps=_moments(j_s), theta_eps=_moments(th_s))
        quad = (po, vo, eo, pio)
    else:
        quad, accs = _chunked_samples(states, dyns, cfg, L0, n_steps,
                                      sample_interval, multistep_fn, kern)

    po, vo, eo, pio = quad
    st1 = _states_with(states, (po, vo, eo, pio))
    H1 = E.extended_hamiltonian(st1, dyns, cfg)
    energy_drift = _rel_drift(H1, H0)
    ang_mom_drift = _ang_mom_drift(st1, L0)

    if mode == "full" and megno_steps > 0:
        dr0, dv0 = tangent
        if cfg.use_fused_megno:
            po, vo, eo, pio, megno, lyap, slope_med = megno_fn(
                st1.pos, st1.vel, states.mass, st1.eps, st1.pi, dr0, dv0,
                dt=float(dt), n_steps=megno_steps, **kern)
            st1 = _states_with(states, (po, vo, eo, pio))
        else:
            # the MEGNO scan from the analysis kernel's final state
            st1, megno, lyap, slope_med = megno_scan(
                st1, dyns, cfg, dr0, dv0, megno_steps, float(dt), n_sub_max)
    else:
        megno = torch.full((B,), 2.0, dtype=dtype, device=h.device)
        lyap = torch.full((B,), math.inf, dtype=dtype, device=h.device)
        slope_med = torch.zeros((B,), dtype=dtype, device=h.device)

    com_mean = _mean(accs["com_drift"])
    is_stable = ((energy_drift < 0.01) & (ang_mom_drift < 0.01)
                 & (com_mean < 1.0) & (megno < 10.0))
    result = {
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
    }
    return result, st1


def _chunked_samples(states, dyns, cfg, L0, n_steps: int,
                     sample_interval: int, multistep_fn, kern):
    """The ``use_fused_metrics=False`` way: chunk 0 of one step, then
    ``n_samples - 1`` chunks of ``sample_interval`` steps, each followed
    by ``step_metrics``, then the unsampled tail.  Returns the final
    (pos, vel, eps, pi) and the running moments."""
    n_samples = -(-n_steps // sample_interval)  # the i % k == 0 count
    tail = n_steps - 1 - (n_samples - 1) * sample_interval
    z = torch.zeros_like(states.eps)
    acc0 = (z, z, z, torch.full_like(z, -math.inf),
            torch.full_like(z, math.inf))
    accs = {k: acc0 for k in ("com_drift", "J_eps", "theta_eps",
                              "cos_theta", "var_L", "tr_hessian")}

    def run(quad, steps):
        pos, vel, eps, pi = quad
        return multistep_fn(pos, vel, states.mass, eps, pi, n_steps=steps,
                            **kern)

    def sample(quad, accs):
        met = step_metrics(_states_with(states, quad), dyns, cfg, L0=L0,
                           energies=False)
        return {k: _running_update(accs[k], met[k]) for k in accs}

    quad = run((states.pos, states.vel, states.eps, states.pi), 1)
    accs = sample(quad, accs)
    for _ in range(n_samples - 1):
        quad = run(quad, sample_interval)
        accs = sample(quad, accs)
    if tail > 0:
        quad = run(quad, tail)
    return quad, accs


def fused_config_covered(cfg, mode: str, dtype) -> bool:
    """The configurations the fused engine covers: the conditions of the
    JAX package's ``fused_path_applicable`` but its device and lane
    tests (the ham_soft production eps* in float32, core or full mode,
    any barrier policy, the "exact" or "reference" gradient, d = 2 or 3,
    either ``use_fused_metrics``, either ``use_fused_megno``).  Every
    other configuration runs the scan engine
    (``analysis/batch.py::analyze_population``)."""
    return (bool(getattr(cfg, "use_fused_analysis", False))
            and cfg.integrator_mode == "ham_soft"
            and mode in ("core", "full")
            and dtype == torch.float32
            and not cfg.use_legacy_eps_star
            and not cfg.fixed_eps_star
            and cfg.eps_grad_mode in ("exact", "reference")
            and not cfg.freeze_s_subsystem
            and not cfg._validate_S_only)
