"""Blow-up labels of the port against the JAX package and the dataset.

    JAX_PLATFORMS=cpu python tests/torch_label_parity.py [n_rows]
    JAX_PLATFORMS=cpu python tests/torch_label_parity.py --d3 [n_rows]
    JAX_PLATFORMS=cpu python tests/torch_label_parity.py --d3-fused [n_rows]

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

With ``--d3`` it takes the first ``n_rows`` (default 256) rows of
``data/stability_3d_131k.csv.gz`` as they come (any schedule), runs
full-mode analysis at the dataset's horizon under the dataset pipeline's
configuration unmodified (``_PIPE_CFG``, the Kepler tail on) with the
JAX package's ``analyze_population`` on the CPU (its scan engine),
prints how its labels and the verdict's inputs agree with the dataset's
own columns, and how many of the dataset's ``cos_theta_mean`` lie outside
[-1, 1] (a cosine cannot: the round-3 fused path's z-only L0 in the
vector branch), and writes the JAX package's columns to
``data/labels_3d_jax_<n_rows>.npz`` (``rows``, ``is_stable``,
``pathological_energy``, ``energy_drift``, ``angular_momentum_drift``,
``MEGNO``, ``tail_fast_path``).  That engine's XLA eps* gradient is NaN,
and so zeroed, on every system with a masked slot of mass 0 (every row
of the dataset), where the JAX fused kernels, which made the dataset,
and the port take the finite gradient.  So ``--d3-fused`` runs the JAX
fused engine itself (Pallas kernels in interpret mode, full mode) on the
first ``n_rows`` rows with at most 2 substeps (none on the tail), prints
its labels, ``angular_momentum_drift`` and ``cos_theta_mean`` beside
the dataset's, and writes ``data/labels_3d_jax_fused_<n_rows>.npz``,
the labels ``chip_smoke.py`` gates the card's against (about 6 minutes
on a CPU for 256 rows).
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
DATA3 = os.path.join(os.path.dirname(HERE), "data", "stability_3d_131k.csv.gz")
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


D3_COLS = ("is_stable", "pathological_energy", "energy_drift",
           "angular_momentum_drift", "MEGNO", "tail_fast_path")


def load_3d(n_rows):
    import pandas as pd

    cols = [f"{p}_{i}" for p in ("mass", "x", "y", "z", "vx", "vy", "vz")
            for i in range(N_SLOTS)]
    df = pd.read_csv(DATA3, comment="#", nrows=n_rows, usecols=cols + [
        "G", "softening", "min_softening", "n_sub", "cos_theta_mean"]
        + list(D3_COLS))
    df = df.astype({c: np.float64 for c in ("cos_theta_mean",
                                            "angular_momentum_drift")})
    get = lambda p: df[[f"{p}_{i}" for i in range(N_SLOTS)]].to_numpy(
        np.float64)
    mass = get("mass")
    mask = np.isfinite(mass)
    clean = lambda a: np.where(np.isfinite(a), a, 0.0)
    pos = clean(np.stack([get(a) for a in ("x", "y", "z")], -1))
    vel = clean(np.stack([get(a) for a in ("vx", "vy", "vz")], -1))
    scal = {k: df[k].to_numpy(np.float64)
            for k in ("G", "softening", "min_softening")}
    return (clean(mass), pos, vel, mask), scal, df


def main_3d(n_rows):
    from nbodysimproject_tpu.generators.pipeline import _PIPE_CFG

    ics, scal, data = load_3d(n_rows)
    kw = dict(dt=DT, n_steps=N_STEPS, mode="full", show_progress=True)
    t0 = time.perf_counter()
    ref = analyze_population(*ics, _PIPE_CFG, **scal, **kw)
    t1 = time.perf_counter()
    runs = {"jax": {c: ref[c].to_numpy() for c in D3_COLS},
            "dataset": {c: data[c].to_numpy() for c in D3_COLS}}
    tail = runs["jax"]["tail_fast_path"].astype(bool)
    print(f"{n_rows} rows of the 3-D dataset, {N_STEPS} steps, full mode, "
          f"tail on; jax {t1 - t0:.1f}s; tail rows: jax {int(tail.sum())}, "
          f"dataset {int(runs['dataset']['tail_fast_path'].sum())}")
    for col in ("pathological_energy", "is_stable"):
        x, y = (runs[n][col].astype(bool) for n in ("jax", "dataset"))
        print(f"{col}: share jax {x.mean():.4f}, dataset {y.mean():.4f}; "
              f"agree {(x == y).mean():.4f} ({int((x & ~y).sum())} only "
              f"jax, {int((~x & y).sum())} only the dataset), on the "
              f"non-tail rows {(x == y)[~tail].mean():.4f}")
    for col in ("energy_drift", "angular_momentum_drift", "MEGNO"):
        a, c = (runs[n][col].astype(np.float64) for n in ("jax", "dataset"))
        med = np.nanmedian(np.abs(c - a) / np.maximum(np.abs(a), 1e-30))
        print(f"{col}: median |dataset - jax| / |jax| {med:.3e}")
    ct = data["cos_theta_mean"].to_numpy(np.float64)
    print(f"the dataset's cos_theta_mean: {int((np.abs(ct) > 1.0 + 1e-6).sum())}"
          f" of {n_rows} outside [-1, 1], {int(np.isnan(ct).sum())} NaN; "
          f"the JAX package's: "
          f"{int((np.abs(ref['cos_theta_mean'].to_numpy()) > 1.0 + 1e-6).sum())}"
          f" outside, {int(ref['cos_theta_mean'].isna().sum())} NaN")
    out = os.path.join(os.path.dirname(HERE), "data",
                       f"labels_3d_jax_{n_rows}.npz")
    np.savez_compressed(out, rows=np.arange(n_rows), **{
        c: runs["jax"][c] for c in D3_COLS})
    print(f"wrote {out}")


def main_3d_fused(n_rows):
    """The JAX fused engine (Pallas kernels in interpret mode, full mode,
    the engine that made the dataset) on the first ``n_rows`` rows of the
    3-D dataset whose frozen schedule needs at most 2 substeps (none of
    them goes to the tail), built as the JAX analyze_population builds a
    group, MEGNO tangents from the global row ids."""
    from nbodysimproject_tpu.generators.pipeline import _PIPE_CFG

    ics, scal, data = load_3d(16384)
    rows = np.nonzero(data["n_sub"].to_numpy() <= 2)[0][:n_rows]
    assert len(rows) % 8 == 0, "n_rows must be a multiple of 8"
    mass, pos, vel, mask = (a[rows] for a in ics)
    cfg = _engine_cfg(_PIPE_CFG)
    f = lambda a: jnp.asarray(a, jnp.float32)
    states, dyns = build_batch(f(mass), f(pos), f(vel), jnp.asarray(mask),
                               cfg, f(scal["G"][rows]),
                               f(scal["softening"][rows]),
                               f(scal["min_softening"][rows]), DT)
    mu = calib.calibrate_mu_from_pi_budget(
        dyns.mu_soft, dyns.k_soft, jnp.float32(DT),
        jnp.float32(cfg.theta_imp))
    n_sub = jnp.minimum(dyns.n_sub, cfg.analysis_n_sub_cap)
    dyns = dyns.replace(mu_soft=mu, n_sub=n_sub)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i))(
        jnp.asarray(rows, jnp.uint32))
    t0 = time.perf_counter()
    r, _ = analyze_batch_fused(states, dyns, cfg, keys, N_STEPS, DT, "full",
                               int(n_sub.max()), min(100, min(50,
                                                              N_STEPS // 2)),
                               lanes=len(rows) // 8,
                               g_static=float(scal["G"][0]), interpret=True)
    drift = np.asarray(r["energy_drift"], np.float64)
    patho = ~np.isfinite(drift) | (np.abs(drift) > 10.0)
    stable = np.asarray(r["is_stable"], bool) & ~patho
    ds = data["is_stable"].to_numpy(bool)[rows]
    print(f"{len(rows)} rows with n_sub <= 2 (the last is row {rows[-1]}), "
          f"JAX fused engine (interpret) {time.perf_counter() - t0:.1f}s; "
          f"stable share {stable.mean():.4f}, the dataset's {ds.mean():.4f}; "
          f"agree {(stable == ds).mean():.4f}")
    for col in ("angular_momentum_drift", "cos_theta_mean"):
        a = np.asarray(r[col], np.float64)
        c = data[col].to_numpy(np.float64)[rows]
        with np.errstate(invalid="ignore"):
            med = np.nanmedian(np.abs(c - a) / np.maximum(np.abs(a), 1e-30))
        print(f"{col}: median |dataset - jax| / |jax| {med:.3e}"
              + (f"; outside [-1, 1]: jax {int((np.abs(a) > 1 + 1e-6).sum())}"
                 f", the dataset {int((np.abs(c) > 1 + 1e-6).sum())}"
                 if col == "cos_theta_mean" else ""))
    out = os.path.join(os.path.dirname(HERE), "data",
                       f"labels_3d_jax_fused_{n_rows}.npz")
    np.savez_compressed(out, rows=rows, is_stable=stable,
                        pathological_energy=patho, energy_drift=drift,
                        angular_momentum_drift=np.asarray(
                            r["angular_momentum_drift"], np.float64),
                        MEGNO=np.asarray(r["MEGNO"], np.float64))
    print(f"wrote {out}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--d3":
        main_3d(int(sys.argv[2]) if len(sys.argv) > 2 else 256)
    elif len(sys.argv) > 1 and sys.argv[1] == "--d3-fused":
        main_3d_fused(int(sys.argv[2]) if len(sys.argv) > 2 else 256)
    else:
        main()
