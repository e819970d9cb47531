"""PyTorch port vs the JAX package: the dataset pipeline's batched entry
point, ``MLTrainingPipeline.generate_diverse_dataset_batched``, on the
CPU: 10 systems (every cohort present), ``n_steps`` clamped to 500 as
in the JAX package.  The frame has one row per system, a
``system_type`` column in cohort order, the tail and the fused engine
both used, and it equals ``analyze_population`` run on the same draw
bit for bit.  Seed 66 is the one whose fused lanes are shallow (n_sub
<= 2, two systems on the tail), which keeps the 500 steps of the CPU
plain versions to seconds.  The sim-list views run on the facade (2
steps deep; ``tests/test_torch_facade_views*.py`` hold them further),
and the port's ``_PIPE_CFG`` is the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.generators import pipeline as tpipe

SEED = 66


def test_batched_dataset_on_the_cpu():
    pipe = tpipe.MLTrainingPipeline(n_systems=10, n_steps=100, seed=SEED,
                                    device="cpu")
    assert pipe.n_steps == 500
    tm = {}
    df = pipe.generate_diverse_dataset_batched(timing_out=tm)
    sizes = tpipe.cohort_sizes(10)
    assert min(sizes.values()) >= 1 and len(df) == 10
    assert df["system_type"].tolist() == sum(
        ([k] * v for k, v in sizes.items()), [])
    assert tm["n_tail"] > 0 and tm["n_tail"] < 10
    assert np.isfinite(df["is_stable"]).all()
    assert set(df["n_bodies"][df["system_type"] == "hierarchical"]) == {3}
    # the entry point is the draw followed by analyze_population
    gen = torch.Generator().manual_seed(SEED)
    m, q, v, mask, soft, types = tpipe.diverse_population(gen, 10,
                                                          device="cpu")
    ref = nt.analyze_population(m, q, v, mask, tpipe._PIPE_CFG, G=1.0,
                                softening=soft, min_softening=0.0, dt=0.01,
                                n_steps=500, mode="full", seed=SEED,
                                show_progress=False, device="cpu")
    for c in ref.columns:
        np.testing.assert_array_equal(df[c].to_numpy(), ref[c].to_numpy(),
                                      err_msg=c)


@pytest.mark.parametrize("view, extra, rows", [
    ("generate_diverse_dataset", "system_type", 4),
    ("generate_focused_dataset", "dataset_focus", 4),
    ("quick_test_pipeline", "system_id", 10)])
def test_sim_list_views_run(view, extra, rows, monkeypatch):
    from nbodysimproject_tpu_torch.analysis import stability
    from nbodysimproject_tpu_torch.utils import seeding

    class Shallow(stability.StabilityAnalyzer):
        def __init__(self, sim, n_steps=1000, dt=0.01, mode="core", seed=0):
            super().__init__(sim, 2, dt, mode, seed)

    # 2 steps deep; quick_test_pipeline's seed 42 draws a system at 55437
    # substeps a step, so seed 41 stands in for it
    monkeypatch.setattr(stability, "StabilityAnalyzer", Shallow)
    seed = seeding.set_global_seed
    monkeypatch.setattr(seeding, "set_global_seed", lambda s=42: seed(41))
    np.random.seed(3)
    pipe = tpipe.MLTrainingPipeline(n_systems=4, device="cpu")
    pipe.batch_analyzer = nt.BatchStabilityAnalyzer(n_steps=2, dt=0.01,
                                                    mode="full")
    df = getattr(pipe, view)()
    assert len(df) == rows and extra in df.columns
    assert np.isin(df["is_stable"], (0.0, 1.0)).all()


def _pipe_cfgs():
    from nbodysimproject_tpu.generators.pipeline import _PIPE_CFG

    return _PIPE_CFG, tpipe._PIPE_CFG


def test_pipe_cfg_is_the_jax_one():
    cfg_j, cfg_t = _pipe_cfgs()
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
