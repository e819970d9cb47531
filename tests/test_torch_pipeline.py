"""PyTorch port vs the JAX package: the dataset pipeline's batched entry
point, ``MLTrainingPipeline.generate_diverse_dataset_batched``, on the
CPU: 10 systems (every cohort present), ``n_steps`` clamped to 500 as
in the JAX package.  The frame has one row per system, a
``system_type`` column in cohort order, the tail and the fused engine
both used, and it equals ``analyze_population`` run on the same draw
bit for bit.  Seed 66 is the one whose fused lanes are shallow (n_sub
<= 2, two systems on the tail), which keeps the 500 steps of the CPU
plain versions to seconds.  The sim-list views raise (they need the
facade), and the port's ``_PIPE_CFG`` is the JAX package's.
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


@pytest.mark.parametrize("view", ["generate_diverse_dataset",
                                  "generate_focused_dataset",
                                  "quick_test_pipeline"])
def test_sim_list_views_need_the_facade(view):
    pipe = tpipe.MLTrainingPipeline(n_systems=4, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        getattr(pipe, view)()


def _pipe_cfgs():
    from nbodysimproject_tpu.generators.pipeline import _PIPE_CFG

    return _PIPE_CFG, tpipe._PIPE_CFG


def test_pipe_cfg_is_the_jax_one():
    cfg_j, cfg_t = _pipe_cfgs()
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
