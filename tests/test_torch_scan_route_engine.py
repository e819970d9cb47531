"""The engine choice of the port's ``analyze_population``
(``analysis/batch.py``, the JAX package's ``_engine_for`` without its TPU
lane test), on the CPU with spies on both engines.

* A configuration ``fused_config_covered`` takes never reaches the scan
  engine in core or full mode: the pipeline's configuration, the
  reflection and no-barrier policies, the "reference" gradient,
  ``use_fused_metrics=False`` and ``use_fused_megno=False`` (the
  configurations of ``test_fused_path_gate`` in
  ``tests/test_torch_analysis.py`` that it covers).
* Every other configuration runs its lanes on the scan engine and never
  the fused engine: float64, ``use_fused_analysis=False``, verlet,
  yoshida4, WHFast, the legacy and fixed eps*, ``freeze_s_subsystem``,
  mode "minimal" and non-uniform G.
* With the pipeline's tail policy, only the tail's lanes reach the scan
  engine (under kepler_split).
* A kernel that raises (as the card's kernels raise at a slot count
  outside their builds) is not caught and rerouted to the scan engine.
"""

import numpy as np
import pytest

import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.analysis import batch as nb_batch
from test_torch_analysis import PIPE, _raw_population


class _Spy:
    def __init__(self, fn):
        self.fn, self.cfgs = fn, []

    def __call__(self, states, dyns, cfg, *args, **kw):
        self.cfgs.append(cfg)
        return self.fn(states, dyns, cfg, *args, **kw)


@pytest.fixture
def spies(monkeypatch):
    scan = _Spy(nb_batch.analyze_batch)
    fused = _Spy(nb_batch.analyze_batch_fused)
    monkeypatch.setattr(nb_batch, "analyze_batch", scan)
    monkeypatch.setattr(nb_batch, "analyze_batch_fused", fused)
    return scan, fused


def _small(cfg_kw, mode="full", G=1.0, pop=None, n_steps=2):
    m, q, v, mask = _raw_population(3, False, B=4) if pop is None else pop
    return nt.analyze_population(
        m, q, v, mask, nt.SimConfig(**{**PIPE, **cfg_kw}), G=G,
        n_steps=n_steps, mode=mode, show_progress=False, device="cpu")


@pytest.mark.parametrize("change", [
    {}, {"use_soft_barrier": False}, {"disable_barrier": True},
    {"eps_grad_mode": "reference"}, {"use_fused_metrics": False},
    {"use_fused_megno": False}])
@pytest.mark.parametrize("mode", ["core", "full"])
def test_covered_configs_never_reach_the_scan(spies, change, mode):
    scan, fused = spies
    _small(change, mode)
    assert scan.cfgs == [] and len(fused.cfgs) == 1


@pytest.mark.parametrize("change,mode,G", [
    ({"fast_float32": False}, "full", 1.0),
    ({"use_fused_analysis": False}, "full", 1.0),
    ({"integrator_mode": "verlet"}, "full", 1.0),
    ({"integrator_mode": "yoshida4"}, "core", 1.0),
    ({"integrator_mode": "whfast"}, "full", 1.0),
    ({"use_legacy_eps_star": True}, "full", 1.0),
    ({"fixed_eps_star": True}, "core", 1.0),
    ({"freeze_s_subsystem": True}, "full", 1.0),
    ({}, "minimal", 1.0),
    ({}, "full", np.array([1.0, 1.0, 1.05, 1.0]))])
def test_other_configs_run_the_scan(spies, change, mode, G):
    scan, fused = spies
    df = _small(change, mode, G)
    assert fused.cfgs == [] and len(scan.cfgs) == 1
    assert scan.cfgs[0].integrator_mode == change.get("integrator_mode",
                                                      "ham_soft")
    assert len(df) == 4 and np.isfinite(df["energy_drift"]).all()


def test_tail_alone_reaches_the_scan(spies):
    """Under the pipeline's tail policy the covered lanes stay on the
    fused engine and only the tail's lanes reach the scan engine."""
    from test_torch_analysis_tail import SOFT, _mixed

    scan, fused = spies
    m, q, v, mask = _mixed()
    tm = {}
    df = nt.analyze_population(
        m, q, v, mask, nt.SimConfig(**{**PIPE,
                                       "analysis_tail_policy": "kepler"}),
        softening=SOFT, n_steps=2, mode="full", show_progress=False,
        device="cpu", timing_out=tm)
    assert df["tail_fast_path"].sum() == 4
    assert [c.integrator_mode for c in scan.cfgs] == ["kepler_split"]
    assert len(fused.cfgs) == 1
    assert tm["scan_lanes"] == 0 and tm["n_tail"] == 4
    assert tm["fused_lanes"] == 4


def test_kernel_error_is_not_rerouted(monkeypatch, spies):
    scan, _fused = spies

    def unbuilt(*args, **kw):
        raise NotImplementedError("hamsoft.cu is built for N in (3, 4, 8)")

    monkeypatch.setattr(nb_batch, "hamsoft_analysis_multistep", unbuilt)
    with pytest.raises(NotImplementedError, match="built for"):
        _small({})
    assert scan.cfgs == []
