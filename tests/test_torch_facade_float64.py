"""PyTorch port vs the JAX package: the facade ``NBodySimulation`` in
float64 on the CPU, at d = 2 (``test_torch_facade_float64_3d.py`` runs
the same scenarios at d = 3).

For verlet, yoshida4, ham_soft (soft and reflection barrier policies),
WHFast, verlet with adaptive softening and verlet without the start-up
corrector (``tests/torch_facade.py``'s scenarios), both packages build
the simulation from the same numpy inputs; after construction, after
three ``step(0.01)`` calls and after ``run(0.01, 10)`` the positions,
velocities, eps, pi, the softening ledger, ``accelerations()`` and every
``Diagnostics`` quantity (energies, H_ext, momenta, COM, the energy
breakdown and the step metrics) agree to round-off: relative 1e-12,
absolute 1e-12 (``torch_facade.F64``).  The mode demotions and the
adaptive-softening replay ledger are held too.
"""

import numpy as np
import pytest

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from torch_facade import (SCENARIOS, assert_sims_close, check_scenario,
                          make_pair)


@pytest.mark.parametrize("label", sorted(SCENARIOS))
def test_step_run_and_diagnostics_match(label):
    check_scenario(label, 2)


@pytest.mark.parametrize("kw, mode", [
    (dict(integrator_mode="whfast", softening=0.05), "verlet"),
    (dict(integrator_mode="whfast", softening=0.0, min_softening=0.0,
          adaptive_softening=True), "verlet"),
    (dict(integrator_mode="yoshida4", G=0.0), "verlet"),
    (dict(integrator_mode="ham_soft", adaptive_softening=True), "ham_soft"),
])
def test_mode_resolution_matches(kw, mode):
    m, q, v = np.array([1.0, 1e-3]), np.array([[0.0, 0.0], [1.0, 0.0]]), \
        np.array([[0.0, 0.0], [0.0, 1.0]])
    sj = nb.NBodySimulation(masses=m, positions=q, velocities=v, **kw)
    st = nt.NBodySimulation(masses=m, positions=q, velocities=v,
                            device="cpu", **kw)
    assert st.integrator_mode == sj.integrator_mode == mode
    assert st.adaptive_softening == sj.adaptive_softening
    assert st._adaptive == sj._adaptive
    assert (st._s0, st._min_softening, st._max_softening) == \
        (sj._s0, sj._min_softening, sj._max_softening)


def test_adaptive_ledger_replays_like_the_jax_one():
    sj, st = make_pair("verlet_adaptive")
    for _ in range(5):
        sj.step(0.01)
        st.step(0.01)
    sj.manager.refresh_softening(0.04)
    st.manager.refresh_softening(0.04)
    assert len(st._eps_ledger["entries"]) == len(sj._eps_ledger["entries"])
    np.testing.assert_allclose(np.array(st._eps_ledger["entries"]),
                               np.array(sj._eps_ledger["entries"]),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(st.manager.history, sj.manager.history,
                               rtol=1e-12)
    assert_sims_close(sj, st, what="after refresh")


def test_disabled_and_body_views():
    st = nt.NBodySimulation(masses=[1.0, -1.0], positions=[[0, 0], [1, 0]],
                            device="cpu")
    assert st._disabled and st.n_bodies == 0
    st.step(0.01)  # no-op
    sj, st = make_pair("verlet")
    for sim in (sj, st):
        b = sim.bodies[1]
        b.x = 1.25
        b.vy = 0.75
    assert_sims_close(sj, st, what="body views")
    assert st.bodies[1].z == 0.0
    with pytest.raises(ValueError):
        st.bodies[1].z = 1.0
    bodies = [nt.Body(mass=1.0, x=0.0, y=0.0),
              nt.Body(mass=0.5, x=1.0, y=0.0, vy=1.0)]
    sb = nt.NBodySimulation(bodies=bodies, device="cpu")
    jb = nb.NBodySimulation(bodies=[nb.Body(**vars(b)) for b in bodies])
    assert_sims_close(jb, sb, what="from bodies")


def test_mode_switch_and_softening_bounds():
    sj, st = make_pair("verlet")
    for s in (sj, st):
        s.run(0.01, 3)
        s.set_integrator_mode("ham_soft")
        s.step(0.01)
        s.set_softening_bounds(0.004, 0.02)
        s.step(0.01)
    assert st.get_integrator_name() == sj.get_integrator_name() == \
        "ham_soft"
    assert (st._min_softening, st._max_softening) == \
        (sj._min_softening, sj._max_softening)
    assert_sims_close(sj, st, what="after the switches")
