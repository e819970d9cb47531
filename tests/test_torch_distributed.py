"""The port's ``parallel/distributed.py`` and ``parallel/mesh.py`` on the
CPU (``tests/test_distributed.py`` of the JAX package, on
``torch.distributed``):

* ``shard_bounds``, ``feature_statistics``, ``statistics_summary``,
  ``merge_statistics`` and ``merge_shards`` on shards the JAX package
  wrote: the JAX package's results bit for bit;
* the port's sharded generation: the union of 2 shards equals the
  single-process run bit for bit in every column (32 systems, 20
  steps, a Kepler tail among them), which needs the MEGNO tangents of
  the whole population (``analyze_population``'s ``n_population``);
* two gloo processes (each with its own timeout): the float64
  all-reduce of ``reduce_statistics_global`` equals
  ``merge_statistics`` of the two ranks' statistics bit for bit, and
  ``make_mesh`` / ``shard_batch`` / ``replicate`` / ``pad_to_multiple``
  place a padded batch whose shards integrate to the unsharded run
  (the mesh on the CPU; ``tests/test_torch_mesh_cuda.py`` puts it on
  the card).
"""

import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from nbodysimproject_tpu.ml.dataset import StabilityDataset as JaxDataset
from nbodysimproject_tpu.parallel import distributed as jd
from nbodysimproject_tpu_torch import SimConfig, build_batch, integrate_batch
from nbodysimproject_tpu_torch.diagnostics.megno import population_normals
from nbodysimproject_tpu_torch.generators.pipeline import _PIPE_CFG
from nbodysimproject_tpu_torch.parallel import distributed as td

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_dist_worker import population, rank_frame, run_workers  # noqa: E402

#: the sharded-generation test's configuration: the dataset pipeline's
#: with the substep cap cut to 32 (the JAX package's two-process test
#: does the same) so the CPU's plain kernels stay shallow; seed 1 then
#: sends 3 of its 32 systems to the Kepler tail
SHARD_CFG = _PIPE_CFG.replace(analysis_n_sub_cap=32, tail_min_n_sub=16)
WORKER_TIMEOUT = 120


def test_shard_bounds_match():
    for n, p in ((10, 3), (7, 7), (5, 8), (100, 4), (4096, 2), (0, 3)):
        spans = [td.shard_bounds(n, i, p) for i in range(p)]
        assert spans == [jd.shard_bounds(n, i, p) for i in range(p)]
        assert spans[0][0] == 0 and spans[-1][1] == n


def _jax_written_shards(out_dir, n_shards=3):
    """Shards written by the JAX package's ``StabilityDataset.save``:
    float32 and float64 columns with NaN and inf, integer and string
    columns, rows out of simulation_id order."""
    rng = np.random.default_rng(7)
    ids = rng.permutation(90)
    for i in range(n_shards):
        sel = ids[i * 30:(i + 1) * 30]
        df = pd.DataFrame({
            "simulation_id": sel,
            "energy_drift": (rng.normal(size=30) * 1e-3).astype(np.float32),
            "MEGNO": rng.normal(size=30) * 10.0 ** rng.integers(-5, 5, 30),
            "n_sub": rng.integers(1, 300, 30),
            "is_stable": (rng.uniform(size=30) < 0.5).astype(float),
            "system_type": rng.choice(["random", "polygon"], 30)})
        df.loc[df.index[:3], "MEGNO"] = [np.nan, np.inf, -np.inf]
        JaxDataset.save(os.path.join(out_dir, f"shard_{i:05d}.csv.gz"), df)


def test_statistics_and_merge_on_jax_written_shards(tmp_path):
    _jax_written_shards(str(tmp_path))
    got, ref = td.merge_shards(str(tmp_path)), jd.merge_shards(str(tmp_path))
    pd.testing.assert_frame_equal(got, ref, check_exact=True)
    assert list(got["simulation_id"]) == list(range(90))
    st_got, st_ref = td.feature_statistics(got), jd.feature_statistics(ref)
    assert st_got["feature_cols"] == st_ref["feature_cols"]
    for k in ("count", "sum", "sumsq"):
        assert np.array_equal(st_got[k], st_ref[k]), k
    assert td.statistics_summary(st_got) == jd.statistics_summary(st_ref)
    parts = [got.iloc[i::3] for i in range(3)]
    m_got = td.merge_statistics([td.feature_statistics(p) for p in parts])
    m_ref = jd.merge_statistics([jd.feature_statistics(p) for p in parts])
    for k in ("count", "sum", "sumsq"):
        assert np.array_equal(m_got[k], m_ref[k]), k


def test_single_process_runtime_is_a_no_op():
    st = td.feature_statistics(rank_frame(0))
    assert td.reduce_statistics_global(st) is st
    assert td.initialize_distributed(None, 1, 0) is False


def test_tangent_draws_need_the_population_size():
    """Why ``generate_dataset_sharded`` passes ``n_population``: the
    second normal draw of a pair starts after the first's n_total draws,
    so a shard drawn with its own size gets other tangents."""
    shape = (8, 2)
    whole = population_normals(0, 32, shape, torch.float32)
    part = population_normals(0, 16, shape, torch.float32)
    assert not torch.equal(part[1], whole[1][:16])


def test_union_of_shards_equals_single_process(tmp_path):
    kw = dict(n_steps=20, reduce_stats=False, show_progress=False,
              cfg=SHARD_CFG, device="cpu")
    tm = {}
    df1, st1 = td.generate_dataset_sharded(
        1, 32, out_dir=str(tmp_path / "one"), process_index=0,
        process_count=1, timing_out=tm, **kw)
    assert tm["n_tail"] > 0 and tm["fused_lanes"] > 0
    stats = []
    for i in range(2):
        _df, st = td.generate_dataset_sharded(
            1, 32, out_dir=str(tmp_path / "two"), process_index=i,
            process_count=2, **kw)
        stats.append(st)
    merged, ref = (td.merge_shards(str(tmp_path / "two")),
                   td.merge_shards(str(tmp_path / "one")))
    assert list(merged.columns) == list(ref.columns)
    num = [c for c in ref.columns if pd.api.types.is_numeric_dtype(ref[c])]
    x = merged[num].to_numpy(np.float64)
    y = ref[num].to_numpy(np.float64)
    eq = (x == y) | (np.isnan(x) & np.isnan(y))
    assert eq.all(), [num[c] for c in np.unique(np.nonzero(~eq)[1])]
    assert (merged["system_type"] == ref["system_type"]).all()
    assert merged["tail_fast_path"].sum() == tm["n_tail"]
    with open(tmp_path / "one" / "stats_00000.json") as f:
        assert json.load(f) == td.statistics_summary(st1)
    m = td.merge_statistics(stats)
    assert np.array_equal(m["count"], st1["count"])
    np.testing.assert_allclose(m["sum"], st1["sum"], rtol=1e-12, atol=1e-12)


def test_two_gloo_processes(tmp_path):
    res = run_workers(str(tmp_path), "cpu", WORKER_TIMEOUT)
    local = [{"feature_cols": 0, **{k: z[f"local_{k}"] for k in
                                    ("count", "sum", "sumsq")}} for z in res]
    merged = td.merge_statistics(local)
    for z in res:
        for k in ("count", "sum", "sumsq"):
            assert z[f"reduced_{k}"].dtype == np.float64
            assert np.array_equal(z[f"reduced_{k}"], merged[k]), k

    # the mesh: edge padding 5 -> 6, 3 rows a rank, the gathered batch
    cfg = SimConfig(integrator_mode="verlet")
    st, dy = build_batch(*population(), cfg, 1.0, 1e-3, 0.0, 0.01)
    full = torch.cat([st.pos, st.pos[-1:]]).numpy()
    ref = integrate_batch(st, dy, cfg, 0.01, 20, 1).pos.numpy()
    for r, z in enumerate(res):
        assert int(z["B"]) == 5 and int(z["mesh_size"]) == 2
        assert list(z["devices"]) == ["cpu", "cpu"]
        assert np.array_equal(z["local_pos"], full[3 * r:3 * r + 3])
        assert z["local_mask"].all() and z["local_mask"].shape == (3, 3)
        assert np.array_equal(z["full_pos"], full)
        assert np.array_equal(z["replicated_pos"], full)
    together = np.concatenate([z["integrated_pos"] for z in res])[:5]
    np.testing.assert_allclose(together, ref, rtol=1e-12, atol=1e-14)

