"""Multi-process scale-out: ``torch.distributed`` initialisation and
process-sharded dataset generation.

Counterpart of ``nbodysimproject_tpu/parallel/distributed.py``.  A
dataset run scales over processes by

1. ``initialize_distributed()``: ``torch.distributed.init_process_group``
   from explicit arguments or torch's standard ``MASTER_ADDR`` /
   ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` variables (a no-op for a
   single process), then a first all-reduce, so the transport is up
   while the processes are still in step;
2. ``generate_dataset_sharded``: every process draws the SAME global
   population from one seed (a draw is cheap; regenerating beats
   communicating), analyses only its contiguous shard with the port's
   ``analyze_population``, and writes ``shard_{i:05d}.csv.gz``;
3. the feature statistics (count, sum, sum of squares) are all-reduced
   in float64 when a process group is up, else kept local; either way
   they equal the single-process run's, because the population and the
   shard partition are functions of (seed, n_systems, process count).

``merge_shards`` concatenates the shard CSVs back into one frame sorted
by simulation_id, for training.  The collectives ride gloo on host
tensors: the only data they carry are the float64 statistics, and a
gloo group lets several processes share one card (NCCL refuses two
ranks on one GPU).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _rank() -> int:
    d = _dist()
    return d.get_rank() if d else 0


def _world() -> int:
    d = _dist()
    return d.get_world_size() if d else 1


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> bool:
    """Join (or find) the process group, over gloo: the collectives carry
    host tensors.  ``coordinator_address``: "host:port" or an init-method
    URL (default ``MASTER_ADDR`` / ``MASTER_PORT``).  Returns True when a
    multi-process group is (already or newly) live."""
    import torch.distributed as dist

    if _dist() is not None:
        return dist.get_world_size() > 1
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _warmup_collective()
    return True


def _warmup_collective():
    """A first all-reduce: it makes the transport's connections now, not
    at the end of an asymmetric analysis where the peers may have drifted
    apart."""
    _dist().all_reduce(torch.ones(1))


def shard_bounds(n: int, process_index: int, process_count: int
                 ) -> Tuple[int, int]:
    """Contiguous [lo, hi) partition of n items over process_count
    processes (the first ``n % p`` shards get the extra item)."""
    base, extra = divmod(n, process_count)
    lo = process_index * base + min(process_index, extra)
    hi = lo + base + (1 if process_index < extra else 0)
    return lo, hi


def feature_statistics(df, feature_cols=None) -> dict:
    """Per-feature (count, sum, sumsq) over finite entries: the moments
    whose reduction is exact across shards."""
    from ..ml.dataset import StabilityDataset

    if feature_cols is None:
        feature_cols = StabilityDataset.feature_columns(df)
    X = df[feature_cols].to_numpy(np.float64)
    finite = np.isfinite(X)
    Xz = np.where(finite, X, 0.0)
    return {
        "feature_cols": list(feature_cols),
        "count": finite.sum(0).astype(np.float64),
        "sum": Xz.sum(0),
        "sumsq": (Xz * Xz).sum(0),
    }


def reduce_statistics_global(stats: dict) -> dict:
    """All-reduce (SUM) the moment vectors over every process, in
    float64: a float32 round trip would cost ~1e-7 relative, which the
    variance summary amplifies by mean^2 / var under cancellation.
    Returns the input untouched without a multi-process group."""
    d = _dist()
    if _world() <= 1:
        return stats
    out = dict(stats)
    for k in ("count", "sum", "sumsq"):
        # a copy: as_tensor would share the caller's numpy buffer, and
        # the all-reduce works in place
        t = torch.tensor(np.asarray(stats[k], np.float64))
        d.all_reduce(t, op=d.ReduceOp.SUM)
        out[k] = t.numpy()
    return out


def statistics_summary(stats: dict) -> dict:
    cnt = np.maximum(stats["count"], 1.0)
    mean = stats["sum"] / cnt
    var = np.maximum(stats["sumsq"] / cnt - mean * mean, 0.0)
    return {
        "feature_cols": stats["feature_cols"],
        "count": stats["count"].tolist(),
        "mean": mean.tolist(),
        "std": np.sqrt(var).tolist(),
    }


def generate_dataset_sharded(seed: int, n_systems: int, *, out_dir: str,
                             n_steps: int = 1000, dt: float = 0.01,
                             mode: str = "full",
                             process_index: int | None = None,
                             process_count: int | None = None,
                             reduce_stats: bool = True,
                             show_progress: bool = True,
                             cfg=None, device=None, timing_out=None):
    """Generate and analyse this process's shard of the global population
    and write ``<out_dir>/shard_{i:05d}.csv.gz`` plus
    ``stats_{i:05d}.json``; returns (frame, statistics).

    The global population is ``diverse_population`` of a
    ``torch.Generator`` on ``device`` (``None``: the card) seeded with
    ``seed``; shard i of p covers a contiguous index range, so the union
    over any p equals the single-process dataset row for row
    (simulation_id is the GLOBAL index), bit for bit: the fused kernels'
    lanes are independent, the eager Kepler tail's batched ops compute
    each lane alone, and the MEGNO tangents are the whole population's
    draws (``analyze_population``'s ``n_population``).  ``timing_out``
    is passed to ``analyze_population``.
    """
    from ..analysis.batch import analyze_population
    from ..core.device import resolve_device
    from ..generators.pipeline import _PIPE_CFG, diverse_population
    from ..ml.dataset import StabilityDataset

    if process_index is None:
        process_index = _rank()
    if process_count is None:
        process_count = _world()
    if cfg is None:
        cfg = _PIPE_CFG
    dev = resolve_device(device)

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    mass, pos, vel, mask, soft, types = diverse_population(
        gen, n_systems, n_slots=8, device=dev)
    lo, hi = shard_bounds(n_systems, process_index, process_count)

    df = analyze_population(mass[lo:hi], pos[lo:hi], vel[lo:hi],
                            mask[lo:hi], cfg, G=1.0, softening=soft[lo:hi],
                            min_softening=0.0, dt=dt, n_steps=n_steps,
                            mode=mode, seed=seed, id_offset=lo,
                            n_population=n_systems,
                            show_progress=show_progress, device=dev,
                            timing_out=timing_out)
    df["system_type"] = types[lo:hi]
    df["simulation_id"] = np.arange(lo, hi)

    os.makedirs(out_dir, exist_ok=True)
    shard_path = os.path.join(out_dir, f"shard_{process_index:05d}.csv.gz")
    StabilityDataset.save(shard_path, df)

    stats = feature_statistics(df)
    if reduce_stats:
        stats = reduce_statistics_global(stats)
    with open(os.path.join(out_dir, f"stats_{process_index:05d}.json"),
              "w") as f:
        json.dump(statistics_summary(stats), f)
    return df, stats


def merge_shards(out_dir: str):
    """Concatenate every shard CSV in out_dir into one frame ordered by
    the global simulation_id."""
    import glob

    import pandas as pd

    paths = sorted(glob.glob(os.path.join(out_dir, "shard_*.csv.gz")))
    # float_precision="round_trip": pandas' default fast parser loses the
    # last ulp, which would break the bitwise sharded == single contract
    # through the shard files (values are written in shortest round-trip
    # form, so the exact parser recovers them)
    frames = [pd.read_csv(p, comment="#", float_precision="round_trip")
              for p in paths]
    df = pd.concat(frames, ignore_index=True)
    return df.sort_values("simulation_id").reset_index(drop=True)


def merge_statistics(stats_list) -> dict:
    """Host-side exact reduction of per-shard moment statistics (what
    ``reduce_statistics_global`` computes without a process group)."""
    out = dict(stats_list[0])
    for s in stats_list[1:]:
        assert s["feature_cols"] == out["feature_cols"]
        for k in ("count", "sum", "sumsq"):
            out[k] = np.asarray(out[k]) + np.asarray(s[k])
    return out
