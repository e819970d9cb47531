"""Blow-up labels of the port against the JAX package and the dataset.

    JAX_PLATFORMS=cpu python tests/torch_label_parity.py [n_rows]

A diagnostic, not a test (pytest does not collect it; it takes about
two minutes on a CPU).  It takes the first ``n_rows`` (default 256)
systems of ``data/stability_131k.csv.gz`` whose frozen schedule needs
at most 2 substeps, runs core-mode analysis at the dataset's horizon
(1000 steps, dt 0.01) under the dataset pipeline's configuration with
the tail policy off (the tail cannot touch these rows), and prints how
often ``pathological_energy`` (energy drift non-finite or above 10) and
``is_stable`` agree between every pair of:

* the port on the CPU (the kernels' plain versions);
* the JAX fused engine with its Pallas kernels in interpret mode, the
  engine that made the dataset, here on the CPU;
* the JAX package's ``analyze_population`` on the CPU (its scan engine);
* the dataset's own columns (the fused engine on a TPU).
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

import nbodysimproject_tpu as nb  # noqa: E402
import nbodysimproject_tpu_torch as nt  # noqa: E402
from nbodysimproject_tpu.analysis.batch import (  # noqa: E402
    _engine_cfg, analyze_population)
from nbodysimproject_tpu.analysis.fused import analyze_batch_fused  # noqa: E402
from nbodysimproject_tpu.integrators import calibration as calib  # noqa: E402
from nbodysimproject_tpu.parallel.batch_engine import build_batch  # noqa: E402

DATA = os.path.join(os.path.dirname(HERE), "data", "stability_131k.csv.gz")
PIPE = dict(slot_bucket=8, fast_float32=True, analysis_n_sub_cap=256,
            use_fused_analysis=True, analysis_group_quantum=1024,
            analysis_tail_policy="off")
N_SLOTS, N_STEPS, DT = 8, 1000, 0.01


def load(n_rows):
    import pandas as pd

    cols = [f"{p}_{i}" for p in ("mass", "x", "y", "vx", "vy")
            for i in range(N_SLOTS)]
    df = pd.read_csv(DATA, comment="#", nrows=16384, usecols=cols + [
        "G", "softening", "min_softening", "n_sub", "is_stable",
        "pathological_energy"])
    df = df[df["n_sub"] <= 2].iloc[:n_rows]
    get = lambda p: df[[f"{p}_{i}" for i in range(N_SLOTS)]].to_numpy(
        np.float64)
    mass = get("mass")
    mask = np.isfinite(mass)
    clean = lambda a: np.where(np.isfinite(a), a, 0.0)
    pos = clean(np.stack([get("x"), get("y")], -1))
    vel = clean(np.stack([get("vx"), get("vy")], -1))
    ics = (clean(mass), pos, vel, mask)
    scal = {k: df[k].to_numpy(np.float64)
            for k in ("G", "softening", "min_softening")}
    labels = {k: df[k].to_numpy(bool)
              for k in ("is_stable", "pathological_energy")}
    return ics, scal, labels


def fused_interpret(ics, scal):
    """The JAX fused engine (Pallas kernels in interpret mode), built as
    the JAX analyze_population builds a group."""
    mass, pos, vel, mask = ics
    B = mass.shape[0]
    cfg = _engine_cfg(nb.SimConfig(**PIPE))
    f = lambda a: jnp.asarray(a, jnp.float32)
    states, dyns = build_batch(f(mass), f(pos), f(vel), jnp.asarray(mask),
                               cfg, f(scal["G"]), f(scal["softening"]),
                               f(scal["min_softening"]), DT)
    mu = calib.calibrate_mu_from_pi_budget(
        dyns.mu_soft, dyns.k_soft, jnp.float32(DT),
        jnp.float32(cfg.theta_imp))
    n_sub = jnp.minimum(dyns.n_sub, cfg.analysis_n_sub_cap)
    dyns = dyns.replace(mu_soft=mu, n_sub=n_sub)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i))(
        jnp.arange(B, dtype=jnp.uint32))
    r, _ = analyze_batch_fused(states, dyns, cfg, keys, N_STEPS, DT, "core",
                               int(n_sub.max()), 0, lanes=B // 8,
                               g_static=float(scal["G"][0]), interpret=True)
    drift = np.asarray(r["energy_drift"], np.float64)
    patho = ~np.isfinite(drift) | (np.abs(drift) > 10.0)
    return {"is_stable": np.asarray(r["is_stable"], bool) & ~patho,
            "pathological_energy": patho}


def frame_labels(df):
    return {k: df[k].to_numpy(bool)
            for k in ("is_stable", "pathological_energy")}


def main():
    n_rows = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    ics, scal, dataset = load(n_rows)
    assert ics[0].shape[0] % 8 == 0, "n_rows must be a multiple of 8"
    kw = dict(dt=DT, n_steps=N_STEPS, mode="core", show_progress=False,
              **scal)
    runs = {}
    t0 = time.perf_counter()
    runs["port"] = frame_labels(nt.analyze_population(
        *ics, nt.SimConfig(**PIPE), device="cpu", **kw))
    t1 = time.perf_counter()
    runs["jax fused (interpret)"] = fused_interpret(ics, scal)
    t2 = time.perf_counter()
    runs["jax scan"] = frame_labels(analyze_population(
        *ics, nb.SimConfig(**PIPE), **kw))
    t3 = time.perf_counter()
    runs["dataset"] = dataset
    print(f"{ics[0].shape[0]} systems with n_sub <= 2, {N_STEPS} steps; "
          f"port {t1 - t0:.1f}s, jax fused {t2 - t1:.1f}s, jax scan "
          f"{t3 - t2:.1f}s")
    names = list(runs)
    for col in ("pathological_energy", "is_stable"):
        print(f"{col}: share " + ", ".join(
            f"{n} {runs[n][col].mean():.4f}" for n in names))
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                x, y = runs[a][col], runs[b][col]
                print(f"  {a} vs {b}: agree {(x == y).mean():.4f} "
                      f"({int((x & ~y).sum())} only {a}, "
                      f"{int((~x & y).sum())} only {b})")


if __name__ == "__main__":
    main()
