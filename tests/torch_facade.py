"""Shared scenarios and checks of the facade tests
(``tests/test_torch_facade_*.py``): the port's ``NBodySimulation`` held
against the JAX package's on the CPU, from the same numpy inputs.

Scenarios (numpy inputs, made from a seeded generator where drawn):

* ``three``: bench.py's 3-body system (masses 1, 0.5, 0.1);
* ``golden_hs``: ``tests/test_golden_regression.py``'s ham_soft system;
* ``planets``: a star with two planets (WHFast needs a dominant mass
  and zero softening);
* ``cluster``: 4 bodies drawn with numpy (seed 7), softening 0.05;
* at d = 3 each gains a z column drawn with numpy (seed 3).

``SCENARIOS`` maps a label to (system, constructor keywords):
verlet, yoshida4, ham_soft (soft and reflection), whfast, verlet with
adaptive softening, verlet with the start-up corrector off, and
yoshida4 with the corrector (``corrector_order`` > 0 is the default).
"""

import numpy as np

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu.diagnostics import Diagnostics as DiagJ

#: float64 parity: round-off, relative 1e-12 with an absolute 1e-12 for
#: quantities near 0 (the COM and total momentum)
F64 = (1e-12, 1e-12)
#: float32 parity: ``tests/test_torch_integrate.py``'s TOL32 (the fused
#: kernels' float32 tolerances against the scan), its position tolerance
#: also for the accelerations and the energies
TOL32 = {"pos": (2e-5, 2e-6), "vel": (2e-5, 2e-5), "eps": (1e-5, 1e-6),
         "pi": (1e-3, 5e-5)}


def _z(n, seed=3):
    rng = np.random.default_rng(seed)
    return 0.1 * rng.normal(size=(n, 1)), 0.05 * rng.normal(size=(n, 1))


def system(name, d=2):
    """(masses, positions, velocities) of a scenario's system."""
    if name == "three":
        m = [1.0, 0.5, 0.1]
        q = [[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]]
        v = [[0.0, 0.0], [0.0, 1.0], [-0.5, 0.0]]
    elif name == "golden_hs":
        m = [1.0, 1.0, 0.5]
        q = [[-0.6, 0.05], [0.55, -0.02], [9.2, 0.3]]
        v = [[0.0, -0.7], [0.0, 0.72], [0.02, 0.5]]
    elif name == "planets":
        m = [1.0, 1e-3, 3e-4]
        q = [[0.0, 0.0], [1.0, 0.0], [2.5, 0.0]]
        v = [[0.0, 0.0], [0.0, 1.0], [0.0, 0.64]]
    else:
        rng = np.random.default_rng(7)
        m = rng.uniform(0.5, 1.5, 4)
        q = rng.normal(size=(4, 2))
        v = 0.3 * rng.normal(size=(4, 2))
    m, q, v = (np.asarray(a, np.float64) for a in (m, q, v))
    if d == 3:
        zq, zv = _z(len(m))
        q, v = np.concatenate([q, zq], 1), np.concatenate([v, zv], 1)
    return m, q, v


SCENARIOS = {
    "verlet": ("three", dict(integrator_mode="verlet", softening=1e-3)),
    "yoshida4": ("cluster", dict(integrator_mode="yoshida4",
                                 softening=0.05)),
    "ham_soft": ("golden_hs", dict(integrator_mode="ham_soft",
                                   softening=0.05)),
    "ham_soft_reflection": ("three", dict(
        integrator_mode="ham_soft", softening=0.05,
        config=dict(use_soft_barrier=False))),
    "whfast": ("planets", dict(integrator_mode="whfast", softening=0.0,
                               min_softening=0.0)),
    "verlet_adaptive": ("cluster", dict(integrator_mode="verlet",
                                        softening=0.05,
                                        adaptive_softening=True)),
    "verlet_no_corrector": ("three", dict(integrator_mode="verlet",
                                          softening=1e-3,
                                          skip_init_corrector=True)),
}


def make_pair(label, d=2, fast=False, n_bodies=None, **extra):
    """(JAX simulation, port simulation on the CPU) of a scenario."""
    name, kw = SCENARIOS[label]
    kw = dict(kw, **extra)
    cfg = dict(kw.pop("config", {}), dim=d, fast_float32=fast)
    m, q, v = system(name, d)
    if n_bodies is not None:
        m, q, v = m[:n_bodies], q[:n_bodies], v[:n_bodies]
    args = dict(masses=m, positions=q, velocities=v, **kw)
    sj = nb.NBodySimulation(config=nb.SimConfig(**cfg), **args)
    st = nt.NBodySimulation(config=nt.SimConfig(**cfg), device="cpu", **args)
    return sj, st


def diagnostics(sim, diag_cls):
    """Every Diagnostics quantity of a simulation, flattened to floats."""
    d = diag_cls(sim)
    out = dict(kinetic=d.kinetic_energy(), potential=d.potential_energy(),
               energy=d.energy(), H_ext=d.compute_extended_hamiltonian(),
               L_z=d.angular_momentum())
    out.update({f"p{i}": x for i, x in enumerate(d.linear_momentum())})
    (cx, cv) = d.center_of_mass()
    out.update({f"com_x{i}": x for i, x in enumerate(cx)})
    out.update({f"com_v{i}": x for i, x in enumerate(cv)})
    out.update({f"breakdown_{k}": x
                for k, x in d.energy_breakdown().items()})
    out.update({f"metric_{k}": x for k, x in d.step_metrics().items()})
    return out


def assert_sims_close(sj, st, tol=None, what="", diag=True):
    """State, accelerations and (``diag``) the diagnostics of two
    simulations agree: float64 to ``F64``, float32 (``tol=TOL32``) to
    TOL32."""
    f32 = tol is not None
    t = lambda k: (tol or {}).get(k, tol["pos"]) if f32 else F64
    close = lambda a, b, k, name: np.testing.assert_allclose(
        np.asarray(b, np.float64), np.asarray(a, np.float64), rtol=t(k)[0],
        atol=t(k)[1], err_msg=f"{what} {name}")
    assert st.integrator_mode == sj.integrator_mode, what
    close(sj.pos, st.pos, "pos", "pos")
    close(sj.vel, st.vel, "vel", "vel")
    close(sj._epsilon, st._epsilon, "eps", "eps")
    close(sj._pi, st._pi, "pi", "pi")
    close(sj.softening, st.softening, "eps", "softening")
    close(sj.get_current_softening_squared(),
          st.get_current_softening_squared(), "eps", "step_s2")
    close(sj.softening_energy_delta, st.softening_energy_delta, "pos",
          "softening_energy_delta")
    close(sj.accelerations(), st.accelerations(), "pos", "accelerations")
    if not diag:
        return
    dj, dt = diagnostics(sj, DiagJ), diagnostics(st, nt.Diagnostics)
    assert dj.keys() == dt.keys()
    for k in dj:
        close(dj[k], dt[k], "pos", k)


def jax_tangent(sim, key_seed, dtype=np.float64):
    """The JAX package's MEGNO tangent draw for a facade simulation
    (``init_tangent(PRNGKey(seed), state)``), as (n_slots, d) arrays."""
    import jax

    from nbodysimproject_tpu.diagnostics.megno import init_tangent

    dr, dv = init_tangent(jax.random.PRNGKey(key_seed), sim._state)
    return np.asarray(dr, dtype), np.asarray(dv, dtype)


def check_scenario(label, d):
    """Build, three ``step(0.01)`` calls and ``run(0.01, 10)`` of a
    scenario in both packages, held together in float64 after each
    (the diagnostics at the end)."""
    sj, st = make_pair(label, d)
    assert st.n_bodies == sj.n_bodies and st.pos.shape[1] == d
    assert_sims_close(sj, st, what=f"{label} d={d} built", diag=False)
    for _ in range(3):
        sj.step(0.01)
        st.step(0.01)
    assert_sims_close(sj, st, what=f"{label} d={d} stepped", diag=False)
    sj.run(0.01, 10)
    st.run(0.01, 10)
    assert_sims_close(sj, st, what=f"{label} d={d} run")
