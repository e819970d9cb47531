"""The facade's large-N branch (``force_mode`` other than "direct" under
verlet: ``NBodySimulation._largen_run``, a call of
``integrators/largen.py::largen_rollout``) on the CPU in float64, on
the numpy-seeded N = 512 cloud of ``tests/test_torch_largen.py``.

* "p3m" and "auto" (below ``pallas_force_min_n``, so the dense force)
  against the JAX facade, which on the CPU runs exactly these (its
  branch calls ``largen_rollout`` without ``interpret``): positions and
  velocities after ``run`` and ``step`` within rtol 1e-10 / atol 1e-12,
  the tolerance of ``tests/test_torch_largen.py`` (summation orders and,
  for P3M, torch's and XLA's FFTs); ``n_dropped_max`` equal.
* "direct_pallas" (the tiled force kernel's route; its plain version on
  the CPU) bit for bit the port's own ``largen_rollout`` on the same
  inputs.
* d = 3 under "direct_pallas" and "auto", bit for bit likewise.
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt

N, DT = 512, 1e-3
P3M = dict(pm_grid=64, pm_r_cut_cells=6.0)


def _cloud(N, d=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1.0, (N, d))
    m = np.abs(rng.normal(1, 0.3, N)) / N
    v = rng.normal(0, 0.3, (N, d))
    return m, q, v


def _pair(mode, d=2, **extra):
    m, q, v = _cloud(N, d)
    cfg = dict(force_mode=mode, dim=d, **extra)
    kw = dict(masses=m, positions=q, velocities=v, integrator_mode="verlet",
              softening=0.05)
    return (nb.NBodySimulation(config=nb.SimConfig(**cfg), **kw),
            nt.NBodySimulation(config=nt.SimConfig(**cfg), device="cpu", **kw))


@pytest.mark.parametrize("mode, extra", [("p3m", P3M), ("auto", {})])
def test_largen_branch_matches_the_jax_facade(mode, extra):
    sj, st = _pair(mode, **extra)
    assert st._largen and sj._largen
    for run in (lambda s: s.run(DT, 4), lambda s: s.step(DT)):
        run(sj)
        run(st)
        for a, b in ((sj.pos, st.pos), (sj.vel, st.vel)):
            np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-12)
    assert int(st.largen_info.n_dropped_max) == \
        int(sj.largen_info.n_dropped_max)
    np.testing.assert_allclose(float(st.largen_info.kinetic),
                               float(sj.largen_info.kinetic), rtol=1e-10)


@pytest.mark.parametrize("mode, d", [("direct_pallas", 2),
                                     ("direct_pallas", 3), ("auto", 3)])
def test_largen_branch_is_largen_rollout(mode, d):
    m, q, v = _cloud(N, d)
    cfg = nt.SimConfig(force_mode=mode, dim=d)
    sim = nt.NBodySimulation(config=cfg, masses=m, positions=q,
                             velocities=v, integrator_mode="verlet",
                             softening=0.05, device="cpu")
    v0 = v - (m[:, None] * v).sum(0) / m.sum()  # the facade's recenter
    sim.run(DT, 3)
    qr, vr, _ = nt.largen_rollout(torch.as_tensor(q), torch.as_tensor(v0),
                                  torch.as_tensor(m), 0.05, 1.0, DT, 3, cfg)
    assert torch.equal(torch.as_tensor(sim.pos), qr)
    assert torch.equal(torch.as_tensor(sim.vel), vr)
