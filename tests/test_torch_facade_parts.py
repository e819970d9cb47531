"""PyTorch port vs the JAX package: the facade's parts on the CPU, in
float64 (relative 1e-12 / absolute 1e-12, ``torch_facade.F64``, unless
stated).

* the integrator and manager shims (``_IntegratorShim``:
  the eps* evaluation, ``canonical_eom``, H_ext and the flow probes of
  ``diagnostics/probes.py``; ``_ManagerShim``: the softening refresh with
  its energy bookkeeping, the ledger check, the base reset) at d = 2
  and 3; ``TangentMap`` and ``DynamicalFeatures``;
* ``SimulationValidator``.

``test_torch_facade_flows.py`` holds ``EvolutionFeatures``,
``validate_ham_soft``, the flow-map API and the ``compat`` views;
``test_torch_facade_dispatch.py`` holds the rest: the dispatch spies,
``quick_test_pipeline``, ``create_simulation`` and the flat namespace.
"""

import numpy as np
import pytest

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from torch_facade import F64, assert_sims_close, make_pair


def _close(a, b, what=""):
    if isinstance(a, dict):
        assert list(b) == list(a), what
        for k in a:
            _close(a[k], b[k], f"{what} {k}")
    elif isinstance(a, (str, bool, np.bool_)) or a is None:
        assert a == b, what
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=F64[0],
                                   atol=F64[1], err_msg=what)


@pytest.mark.parametrize("d", [2, 3])
def test_integrator_shim_and_probes(d):
    sj, st = make_pair("ham_soft", d)
    for s in (sj, st):
        s.run(0.01, 3)
    ij, it = sj._integrator, st._integrator
    for name in ("k_soft", "mu_soft", "chi_eps", "k_wall", "h_sub_ref",
                 "split_n_max", "barrier_policy"):
        _close(getattr(ij, name), getattr(it, name), name)
    for name in ("_eps_target", "eps_star_and_grad", "canonical_eom",
                 "compute_extended_hamiltonian", "report_epsilon_policies",
                 "last_eps_star_probe", "_last_vkick_probe",
                 "last_spring_probe", "last_strang_schedule_info"):
        _close(getattr(ij, name)(), getattr(it, name)(), name)
    q = sj.pos + 0.01
    _close(ij.eps_star_and_grad(q), it.eps_star_and_grad(q), "at q")
    _close(ij._eps_target(q), it._eps_target(q), "target at q")


def test_manager_shim():
    sj, st = make_pair("verlet_adaptive")
    for s in (sj, st):
        s.run(0.01, 2)
        m = s.manager
        m.refresh_softening(m.softening_from_min_sep(0.03))
        m.refresh_softening(0.06)
        m.begin_step()
        m.finish_step()
    _close(sj.manager.debug_info(), st.manager.debug_info(), "debug_info")
    for name in ("s0", "s", "s2", "softening", "step_s2",
                 "pending_energy_delta", "history"):
        _close(getattr(sj.manager, name), getattr(st.manager, name), name)
    assert_sims_close(sj, st, what="after refreshes", diag=False)
    st.manager.validate_energy()
    for s in (sj, st):
        s.manager.update_base_softening(False)
        s.adaptive_softening = False
    assert_sims_close(sj, st, what="base reset", diag=False)
    assert st._eps_ledger == sj._eps_ledger


def test_tangent_map_and_features():
    sj, st = make_pair("yoshida4", 3)
    dr = np.random.default_rng(2).normal(size=sj.pos.shape)
    _close(nb.TangentMap(sj).variational_accel(dr),
           nt.TangentMap(st).variational_accel(dr), "tangent")
    _close(nb.DynamicalFeatures(sj).extract_all(),
           nt.DynamicalFeatures(st).extract_all(), "features")


@pytest.mark.parametrize("args", [
    ([1.0, 2.0], [[0, 0], [1, 0]], [[0, 0], [0, 1]], 0.1, 2),
    ([1.0, -2.0], [[0, 0], [1, 0]], [[0, 0], [0, 1]], 0.1, 2),
    ([1.0], [[0, 0, 0]], [[0, 0, 0]], 0.1, 2),
    ([1.0], [[0, 0, 0]], [[0, 0, np.nan]], -1.0, 3)])
def test_simulation_validator(args):
    *a, dim = args
    assert nt.SimulationValidator.state_is_valid(*a, dim=dim) == \
        nb.SimulationValidator.state_is_valid(*a, dim=dim)
    assert nt.SimulationValidator.report_invalid_state(*a, dim=dim) == \
        nb.SimulationValidator.report_invalid_state(*a, dim=dim)
