"""One process of ``tests/test_torch_distributed.py``'s two-process gloo
run (the port only, no JAX):

    python tests/torch_dist_worker.py PORT RANK WORLD OUT_DIR [DEVICE]

It joins the group with ``initialize_distributed``, all-reduces a
rank-dependent set of feature statistics with
``reduce_statistics_global``, places a padded host batch on a
``make_mesh(device=DEVICE)`` mesh (DEVICE "cpu" by default, or "cuda")
with ``shard_batch`` / ``replicate`` and integrates its own shard, and
writes what it saw to ``OUT_DIR/rank_<RANK>.npz``.  ``run_workers``
starts the processes and collects what they wrote.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nbodysimproject_tpu_torch import SimConfig, build_batch, integrate_batch  # noqa: E402
from nbodysimproject_tpu_torch.parallel import (make_mesh, pad_to_multiple,  # noqa: E402
                                                replicate, shard_batch)
from nbodysimproject_tpu_torch.parallel.distributed import (  # noqa: E402
    feature_statistics, initialize_distributed, reduce_statistics_global)


def rank_frame(rank):
    """A frame with NaN and inf entries whose moments differ by rank."""
    rng = np.random.default_rng(100 + rank)
    X = rng.normal(size=(50, 4)) * 10.0 ** rng.integers(-3, 6, 4)
    X[rng.uniform(size=X.shape) < 0.1] = np.nan
    X[3, 1] = np.inf
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(4)])
    df["is_stable"] = (X[:, 0] > 0).astype(float)
    return df


def population(B=5):
    """A (B, 3, 2) float64 population of perturbed triples."""
    g = torch.Generator().manual_seed(0)
    q = (torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]],
                      dtype=torch.float64)[None]
         + 0.01 * torch.randn((B, 3, 2), generator=g, dtype=torch.float64))
    m = torch.tensor([1.0, 0.5, 0.1], dtype=torch.float64).expand(B, 3)
    v = torch.tensor([[0.0, 0.0], [0.0, 1.0], [-0.5, 0.0]],
                     dtype=torch.float64).expand(B, 3, 2)
    return m.clone(), q, v.clone(), torch.ones(B, 3, dtype=torch.bool)


def run_workers(out_dir, device, timeout, world=2):
    """``world`` of these workers in one gloo group on a free localhost
    port, their mesh on ``device``; returns what each wrote (raises if
    one fails or outlasts ``timeout`` seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(here))
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(r),
         str(world), out_dir, device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"worker {r} (rc {p.returncode}):\n{out}"
              for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return [dict(np.load(os.path.join(out_dir, f"rank_{r}.npz")))
            for r in range(world)]


def main():
    import faulthandler

    faulthandler.enable()
    port, rank, world, out_dir = sys.argv[1:5]
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    rank, world = int(rank), int(world)
    assert initialize_distributed(f"localhost:{port}", world, rank)
    assert initialize_distributed()  # already up: still True
    out = {}

    local = feature_statistics(rank_frame(rank))
    reduced = reduce_statistics_global(local)
    for k in ("count", "sum", "sumsq"):
        out[f"local_{k}"] = local[k]
        out[f"reduced_{k}"] = reduced[k]

    cfg = SimConfig(integrator_mode="verlet")
    st, dy = build_batch(*population(), cfg, 1.0, 1e-3, 0.0, 0.01)
    (st_p, dy_p), B = pad_to_multiple((st, dy), world)
    mesh = make_mesh(device=device)
    st_s, dy_s = shard_batch(st_p, mesh), shard_batch(dy_p, mesh)
    rep = replicate(st_p, mesh).pos.to_local()
    out["B"] = B
    out["mesh_size"] = mesh.size()
    out["devices"] = [st_s.pos.to_local().device.type, rep.device.type]
    out["local_pos"] = st_s.pos.to_local().cpu().numpy()
    out["local_mask"] = st_s.mask.to_local().cpu().numpy()
    if device == "cpu":
        # a card mesh's DTensor collectives crash under gloo (mesh.py)
        out["full_pos"] = st_s.pos.full_tensor().numpy()
    out["replicated_pos"] = rep.cpu().numpy()
    # data-parallel integration: each process steps its own block (on
    # the CPU, where the reference integrates)
    loc = lambda tree: type(tree)(**{k: getattr(tree, k).to_local().cpu()
                                     for k in tree.__dataclass_fields__})
    out["integrated_pos"] = integrate_batch(
        loc(st_s), loc(dy_s), cfg, 0.01, 20, 1).pos.numpy()
    np.savez(os.path.join(out_dir, f"rank_{rank}.npz"), **out)

    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
