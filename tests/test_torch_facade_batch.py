"""PyTorch port vs the JAX package: the facade's batch analyzer and the
sim-list views of the generators, on the CPU.

* ``BatchStabilityAnalyzer.analyze_batch`` on 8 mixed simulations
  (float64 ham_soft, verlet with 3 and 4 bodies padded to one group,
  fast-mode ham_soft; full mode, 20 steps) against the JAX
  ``analyze_batch``, the port given the JAX package's per-group MEGNO
  tangents: the same columns in the same order with the same dtypes,
  the schedule and tag columns equal, the analysis columns per
  group within ``torch_scan_route.F64_TOL`` (float64: relative 1e-9 /
  absolute 1e-12) or the fused-vs-scan ``_TOL`` (float32, is_stable
  equal), the IC columns (the state after the start-up corrector) and
  the ``initial_*`` features within 1e-12 / 1e-14 (float64) or 1e-5 /
  1e-6 (float32), ``initial_softening_std`` to its cancellation
  residue as in ``torch_scan_route.assert_other_columns``.  The ham_soft groups have one body count each:
  the JAX scan zeroes the eps* gradient of systems with a padded slot
  (ROADMAP.md Queue 3), which the port does not.
* The sim-list views (``MLTrainingPipeline.generate_diverse_dataset``,
  ``generate_focused_dataset``, ``quick_test_pipeline``,
  ``InitialConditionGenerator.create_simulation``): their frames have
  the JAX package's columns (its views run on its own draws, which
  torch cannot reproduce), and their rows equal the port's own
  ``BatchStabilityAnalyzer`` / ``StabilityAnalyzer`` on the same draws.
"""

import numpy as np

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
import torch_scan_route as sr
from test_torch_hamsoft_kernels import _TOL
from torch_facade import system

STEPS = 20


def _mixed(pkg, **kw):
    """8 simulations: 3 float64 ham_soft (3 bodies), 3 verlet (3, 4, 4
    bodies), 2 fast-mode ham_soft (3 bodies)."""
    rng = np.random.default_rng(11)
    sims = []
    for i in range(8):
        if i < 3:
            m, q, v = system("golden_hs")
            cfg, mode, n = {}, "ham_soft", 3
        elif i < 6:
            m, q, v = system("cluster")
            cfg, mode, n = {}, "verlet", (3, 4, 4)[i - 3]
        else:
            m, q, v = system("three")
            cfg, mode, n = dict(fast_float32=True), "ham_soft", 3
        q = q[:n] + 0.02 * rng.normal(size=q[:n].shape)
        sims.append(pkg.NBodySimulation(
            config=pkg.SimConfig(**cfg), masses=m[:n], positions=q,
            velocities=v[:n], integrator_mode=mode, softening=0.05, **kw))
    return sims


def _jax_group_tangents(sims, seed):
    """The JAX analyze_batch's tangents, one (n_slots, d) pair per
    simulation in its group's padded shape."""
    import jax
    from collections import defaultdict

    from nbodysimproject_tpu.analysis.batch import stack_sims
    from nbodysimproject_tpu.diagnostics.megno import init_tangent

    groups = defaultdict(list)
    for i, s in enumerate(sims):
        groups[s.cfg].append(i)
    out = [None] * len(sims)
    for idxs in groups.values():
        states, _ = stack_sims([sims[i] for i in idxs])
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                   idxs[0]), len(idxs))
        dr, dv = jax.vmap(init_tangent)(keys, states)
        for j, i in enumerate(idxs):
            out[i] = (np.asarray(dr[j]), np.asarray(dv[j]))
    return out


def test_batch_stability_analyzer_matches():
    sims_j = _mixed(nb)
    sims_t = _mixed(nt, device="cpu")
    ref = nb.BatchStabilityAnalyzer(n_steps=STEPS, dt=0.01, mode="full",
                                    seed=5).analyze_batch(
        sims_j, show_progress=False)
    got = nt.BatchStabilityAnalyzer(n_steps=STEPS, dt=0.01, mode="full",
                                    seed=5).analyze_batch(
        sims_t, show_progress=False,
        tangent=_jax_group_tangents(sims_j, 5))
    assert list(got.columns) == list(ref.columns)
    assert (got.dtypes == ref.dtypes).all(), got.dtypes[got.dtypes
                                                        != ref.dtypes]
    f64 = np.arange(6)
    f32 = np.arange(6, 8)
    for rows, tol, frt, fat, dt in ((f64, sr.F64_TOL, 1e-12, 1e-14,
                                     np.float64),
                                    (f32, _TOL, 1e-5, 1e-6, np.float32)):
        r, g = ref.iloc[rows].reset_index(drop=True), \
            got.iloc[rows].reset_index(drop=True)
        sr.assert_analysis_columns(r, g, tol)
        for c in r.columns:
            a, b = r[c].to_numpy(), g[c].to_numpy()
            if c in _TOL:
                continue
            if a.dtype.kind != "f":
                np.testing.assert_array_equal(b, a, err_msg=c)
                continue
            atol = fat
            if c == "initial_softening_std":
                atol = np.sqrt(np.finfo(dt).eps) * \
                    r["initial_softening_mean"].max()
            np.testing.assert_allclose(b, a, rtol=frt, atol=atol, err_msg=c)
    assert got["n_sub"].max() >= 1 and set(got["softening_policy"]) == {
        "adaptive-ham", "static"}
