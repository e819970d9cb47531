"""The facade reaches the kernels only through the batched path's
dispatch, on the CPU with spies, and the rest of the facade's surface.

* ``integrators/hamsoft.py::uses_eps_kernel`` decides every (eps*, grad)
  evaluation of a fast-mode ham_soft simulation's ``step`` / ``run``, of
  ``StabilityAnalyzer`` and of ``BatchStabilityAnalyzer``: with the spy
  answering as on the card (True for a float32 CUDA batch of at most 16
  slots), each goes to the eps kernel's wrapper
  (``eps_star_and_grad_fused``, its plain version for these CPU
  tensors) on the simulation's one-system batch, and never to the
  autograd evaluation; the float64 facade's calls are all answered
  False by the real function.
* ``ops/forces.py::force_auto`` serves the classical step and, under
  ``use_pallas_forces``, takes the tiled kernel's wrapper
  (``force_kernels.pairwise_force``); the large-N branch resolves its
  engine with ``integrators/largen.py::make_force_fn`` and, on
  "direct_pallas", calls the same wrapper once per step and once before.
* ``quick_test_pipeline`` and ``create_simulation`` (the rules of
  ``test_torch_facade_views.py``; ``quick_test_pipeline`` seeds 41 in
  place of its 42, whose draw holds a system at 55437 substeps a step,
  minutes of the eager scan on the CPU).
* The flat namespace: every name of the JAX package's ``__all__``, and
  of its ``ml``, ``parallel`` and ``utils`` packages' ``__all__``.
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.generators import pipeline as tpipe
from nbodysimproject_tpu_torch.integrators import classical, hamsoft, largen
from nbodysimproject_tpu_torch.ops import eps_model, force_kernels
from torch_facade import make_pair, system

STEPS = 2
WAITING = set()


class _Spy:
    def __init__(self, fn, answer=None):
        self.fn, self.answer, self.calls = fn, answer, []

    def __call__(self, *args, **kw):
        self.calls.append(args)
        out = self.fn(*args, **kw)
        return out if self.answer is None else self.answer


@pytest.fixture
def eps_spies(monkeypatch):
    """(dispatch, kernel wrapper, autograd path) spies, the dispatch
    answering as on the card."""
    dispatch = _Spy(hamsoft.uses_eps_kernel, answer=True)
    kernel = _Spy(hamsoft.eps_star_and_grad_fused)
    plain = _Spy(eps_model.eps_star_and_grad)
    monkeypatch.setattr(hamsoft, "uses_eps_kernel", dispatch)
    monkeypatch.setattr(hamsoft, "eps_star_and_grad_fused", kernel)
    monkeypatch.setattr(eps_model, "eps_star_and_grad", plain)
    return dispatch, kernel, plain


def _fast_sim():
    return make_pair("ham_soft", fast=True)[1]


@pytest.mark.parametrize("path", ["step", "run", "stability_analyzer",
                                  "batch_analyzer"])
def test_fast_mode_reaches_the_eps_kernel_through_its_dispatch(eps_spies,
                                                               path):
    dispatch, kernel, plain = eps_spies
    sim = _fast_sim()
    n0 = len(kernel.calls)
    if path == "step":
        sim.step(0.01)
    elif path == "run":
        sim.run(0.01, 2)
    elif path == "stability_analyzer":
        nt.StabilityAnalyzer(sim, STEPS, 0.01, mode="full").\
            run_stability_analysis()
    else:
        nt.BatchStabilityAnalyzer(STEPS, 0.01, mode="full").analyze_batch(
            [sim, _fast_sim()], show_progress=False)
    assert len(kernel.calls) > n0 and not plain.calls
    assert len(dispatch.calls) == len(kernel.calls)
    B = 2 if path == "batch_analyzer" else 1
    for (q, *_rest) in kernel.calls[n0:]:
        assert q.dim() == 3 and q.shape[0] == B and q.dtype == torch.float32


def test_float64_facade_is_answered_by_the_real_dispatch(monkeypatch):
    dispatch = _Spy(hamsoft.uses_eps_kernel)
    monkeypatch.setattr(hamsoft, "uses_eps_kernel", dispatch)
    sim = make_pair("ham_soft")[1]
    sim.step(0.01)
    assert dispatch.calls and not any(
        hamsoft.uses_eps_kernel.fn(q, cfg) for q, cfg in dispatch.calls)


def test_classical_step_takes_force_auto(monkeypatch):
    auto = _Spy(classical.force_auto)
    tiled = _Spy(force_kernels.pairwise_force)
    monkeypatch.setattr(classical, "force_auto", auto)
    monkeypatch.setattr(force_kernels, "pairwise_force", tiled)
    m, q, v = system("cluster")
    sim = nt.NBodySimulation(
        config=nt.SimConfig(use_pallas_forces=True, pallas_force_min_n=4),
        masses=m, positions=q, velocities=v, integrator_mode="verlet",
        softening=0.05, device="cpu")
    n_corr = len(auto.calls)
    sim.step(0.01)
    assert n_corr > 0 and len(auto.calls) > n_corr
    assert len(tiled.calls) == len(auto.calls)


def test_largen_branch_takes_make_force_fn(monkeypatch):
    resolve = _Spy(largen.make_force_fn)
    tiled = _Spy(force_kernels.pairwise_force)
    monkeypatch.setattr(largen, "make_force_fn", resolve)
    monkeypatch.setattr(force_kernels, "pairwise_force", tiled)
    rng = np.random.default_rng(0)
    sim = nt.NBodySimulation(
        config=nt.SimConfig(force_mode="direct_pallas"),
        masses=np.full(64, 1 / 64), positions=rng.normal(size=(64, 2)),
        integrator_mode="verlet", softening=0.05, device="cpu")
    sim.run(1e-3, 5)
    assert [c[1:] for c in resolve.calls] == [(64, 2)]
    assert len(tiled.calls) == 6


def test_entry_points_need_a_card_unless_given_the_cpu():
    m, q, v = system("three")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.NBodySimulation(masses=m, positions=q, velocities=v)
    sim = nt.NBodySimulation(masses=m, positions=q, velocities=v,
                             device="cpu")
    assert sim.copy().device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.NBodySimulation.restore(sim.snapshot())
def test_quick_test_pipeline_view(monkeypatch):
    from nbodysimproject_tpu_torch.analysis import stability
    from nbodysimproject_tpu_torch.utils import seeding

    made = []

    class Shallow(stability.StabilityAnalyzer):
        def __init__(self, sim, n_steps=1000, dt=0.01, mode="core", seed=0):
            super().__init__(sim, STEPS, dt, mode, seed)
            made.append(sim)

    monkeypatch.setattr(stability, "StabilityAnalyzer", Shallow)
    seed = seeding.set_global_seed
    monkeypatch.setattr(seeding, "set_global_seed", lambda s=42: seed(41))
    df = tpipe.MLTrainingPipeline(n_systems=10, device="cpu") \
        .quick_test_pipeline()
    assert len(df) == 10 and df["system_id"].tolist() == list(range(10))
    assert [s.n_bodies for s in made] == [3 + (i % 3) for i in range(10)]
    for i in (0, 4):
        row = nt.StabilityAnalyzer(made[i], STEPS, 0.01, mode="core") \
            .run_stability_analysis()
        assert {k: df[k][i] for k in row} == row
    sj = nb.NBodySimulation(masses=made[0].mass, positions=made[0].pos,
                            velocities=made[0].vel)
    keys = nb.StabilityAnalyzer(sj, STEPS, 0.01, mode="core") \
        .run_stability_analysis()
    assert list(df.columns) == list(keys) + ["system_id"]


def test_create_simulation():
    cfg = tpipe._PIPE_CFG
    gen = nt.InitialConditionGenerator(nt.GeneratorConfig(seed=5),
                                       sim_config=cfg, device="cpu")
    sim = gen.create_simulation(4, integrator_mode="ham_soft")
    draw = nt.InitialConditionGenerator(nt.GeneratorConfig(seed=5),
                                        device="cpu").generate_single(4)
    assert sim.cfg == cfg and sim.n_bodies == 4 and sim.device.type == "cpu"
    assert sim._state.n_slots == 8
    np.testing.assert_array_equal(sim.mass, draw[0].astype(np.float32))
    sj = nb.InitialConditionGenerator(
        nb.GeneratorConfig(seed=5),
        sim_config=nb.generators.pipeline._PIPE_CFG).create_simulation(4)
    assert (sj.n_bodies, sj._state.n_slots, sj.integrator_mode) == \
        (sim.n_bodies, sim._state.n_slots, sim.integrator_mode)


def test_flat_namespace():
    missing = [n for n in nb.__all__ if n not in WAITING
               and not hasattr(nt, n)]
    assert not missing, missing
    assert WAITING <= set(nb.__all__)
    assert not [n for n in WAITING if hasattr(nt, n)]
    assert set(nt.__all__) >= set(nb.__all__) - WAITING
    import nbodysimproject_tpu.ml
    import nbodysimproject_tpu.parallel
    import nbodysimproject_tpu.utils
    import nbodysimproject_tpu_torch.ml
    import nbodysimproject_tpu_torch.parallel
    import nbodysimproject_tpu_torch.utils

    for sub in ("ml", "parallel", "utils"):
        ref = getattr(nb, sub).__all__
        port = getattr(nt, sub)
        assert [n for n in ref if not hasattr(port, n)] == [], sub
        assert set(port.__all__) >= set(ref), sub
