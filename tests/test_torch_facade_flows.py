"""PyTorch port vs the JAX package: more of the facade's parts on the
CPU, in float64 (relative 1e-12 / absolute 1e-12, ``torch_facade.F64``,
unless stated):

* ``EvolutionFeatures`` (the port given the tangents of the JAX key's
  first split), which advances the simulation;
* ``validate_ham_soft``'s report: the same keys and verdicts, its
  numbers within relative 1e-9 / absolute 1e-12 (differences of
  extended Hamiltonians and finite-difference rates);
* the flow-map API (``PhaseState``, ``spring_oscillation`` with and
  without a facade integrator and under the reflection policy,
  ``strang_softening_step``, ``extended_hamiltonian``);
* the ``compat`` views (``IntegratorConstants``, ``TimestepManager``,
  ``HamSoftParams``, ``HamSoftBarrier``, ``HamSoftStepper``,
  ``SimulationState``).
"""

import numpy as np

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from test_torch_facade_parts import _close
from torch_facade import assert_sims_close, make_pair


def test_evolution_features():
    import jax

    from nbodysimproject_tpu.diagnostics.megno import init_tangent

    sj, st = make_pair("ham_soft")
    sub = jax.random.split(jax.random.PRNGKey(4))[1]
    tan = tuple(np.asarray(a) for a in init_tangent(sub, sj._state))
    ref = nb.EvolutionFeatures(sj, n_samples=6, dt=0.01, seed=4)
    got = nt.EvolutionFeatures(st, n_samples=6, dt=0.01, tangent=tan)
    _close(ref.extract_all(), got.extract_all(), "evolution")
    _close(ref.last_megno_slope_med, got.last_megno_slope_med, "slope")
    assert_sims_close(sj, st, what="advanced", diag=False)


def test_validate_ham_soft():
    sj, st = make_pair("ham_soft_reflection")
    ref = nb.validate_ham_soft(sj, n_steps=6, dt=1e-3)
    got = nt.validate_ham_soft(st, n_steps=6, dt=1e-3)
    assert list(got) == list(ref)
    for k, a in ref.items():
        if isinstance(a, (bool, np.bool_)):
            assert got[k] == a, k
        else:
            np.testing.assert_allclose(got[k], a, rtol=1e-9, atol=1e-12,
                                       err_msg=k)


def test_flows_api():
    q = np.array([[0.0, 0.0], [1.0, 0.0], [0.3, 0.8]])
    p = np.array([[0.0, -0.1], [0.0, 0.1], [0.05, 0.0]])
    m = np.array([1.0, 1.0, 0.5])
    kw = dict(mu=2.0, eps_min=0.1, eps_max=1.0)
    ps_j = nb.PhaseState(q=q, p=p, epsilon=0.3, pi=0.05, m=m)
    ps_t = nt.PhaseState(q=q, p=p, epsilon=0.3, pi=0.05, m=m)
    sj, st = make_pair("ham_soft_reflection")
    as_dict = lambda s: dict(q=s.q, p=s.p, epsilon=s.epsilon, pi=s.pi,
                             m=s.m)
    for extra_j, extra_t in (({}, {}),
                             (dict(integrator=sj._integrator),
                              dict(integrator=st._integrator)),
                             (dict(cfg=nb.SimConfig(use_soft_barrier=False)),
                              dict(cfg=nt.SimConfig(use_soft_barrier=False)))):
        a = nb.spring_oscillation(ps_j, 0.001, 100.0, **kw, **extra_j)
        b = nt.spring_oscillation(ps_t, 0.001, 100.0, **kw, **extra_t)
        _close(as_dict(a), as_dict(b), "spring")
    hk = dict(k_soft=100.0, mu=2.0, eps_min=0.1, eps_max=0.25)
    _close(as_dict(nb.strang_softening_step(ps_j, 0.05, **hk)),
           as_dict(nt.strang_softening_step(ps_t, 0.05, **hk)), "strang")
    ek = dict(G=1.0, k_soft=100.0, mu_soft=2.0, eps_star=0.35, eps_min=0.1,
              eps_max=1.0)
    _close(nb.extended_hamiltonian(ps_j, **ek),
           nt.extended_hamiltonian(ps_t, **ek), "H")
    _close(nb.extended_hamiltonian(ps_j, integrator=sj._integrator, **ek),
           nt.extended_hamiltonian(ps_t, integrator=st._integrator, **ek),
           "H soft")


def test_compat_views():
    from nbodysimproject_tpu.facade import compat as cj
    from nbodysimproject_tpu_torch.facade import compat as ct

    for name in ("safety_factor", "theta_cap", "k_soft", "split_n_max",
                 "initial_dt", "corrector_order", "barrier_exponent",
                 "k_wall", "CHI_EPS", "LAMBDA_SOFTENING", "unknown"):
        assert getattr(ct.IntegratorConstants, name) == \
            getattr(cj.IntegratorConstants, name), name
    sj, st = make_pair("ham_soft_reflection")
    tj, tt = cj.TimestepManager(sj._integrator), \
        ct.TimestepManager(st._integrator)
    for f in ("determine_substeps", "predict_min_separation"):
        _close(getattr(tj, f)(0.01), getattr(tt, f)(0.01), f)
    _close(tj.get_cached_min_sep(), tt.get_cached_min_sep(), "min sep")
    tj.init_substep_schedule(0.01)
    tt.init_substep_schedule(0.01)
    _close(tj.h_sub_ref, tt.h_sub_ref, "h_sub_ref")
    pj, pt = cj.HamSoftParams(sj._integrator), \
        ct.HamSoftParams(st._integrator)
    for name in ("k_soft", "mu_soft", "chi_eps", "k_wall",
                 "barrier_exponent"):
        _close(getattr(pj, name), getattr(pt, name), name)
    bj, bt = cj.HamSoftBarrier(sj._integrator), \
        ct.HamSoftBarrier(st._integrator)
    for eps, pi in ((0.01, 0.3), (0.7, -0.2), (0.003, 0.0)):
        _close(bj.reflect_and_bounce(eps, pi, 1e-3),
               bt.reflect_and_bounce(eps, pi, 1e-3), "bounce")
        _close(bj.reflect_if_active(eps, pi), bt.reflect_if_active(eps, pi),
               "fold")
    stj, stt = cj.HamSoftStepper(sj._integrator), \
        ct.HamSoftStepper(st._integrator)
    for f in ("s_half", "v_half_kick", "t_drift", "strang_step"):
        getattr(stj, f)(0.01)
        getattr(stt, f)(0.01)
    assert stt._get_j_max_cap() == stj._get_j_max_cap()
    assert_sims_close(sj, st, what="stepper", diag=False)
    built = ct.SimulationState.build_state(bodies=[nt.Body(1.0, 0.0, 0.0),
                                                   nt.Body(2.0, 1.0, 0.0)],
                                           eps=0.1, device="cpu")
    assert tuple(built.pos.shape) == (1, 2, 2) and built.mask.all()
    ct.SimulationState.restore_to_sim(
        {"sim_state": {"_epsilon": 0.2, "_pi": 0.5}}, st)
    assert (st._epsilon, st._pi) == (0.2, 0.5)
