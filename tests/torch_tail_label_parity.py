"""Kepler-tail labels of the port against the JAX package and the dataset.

    JAX_PLATFORMS=cpu python tests/torch_tail_label_parity.py [n_rows]

A diagnostic, not a test (pytest does not collect it; about a minute on
a CPU for the default 64 rows).  It builds the first 16384 systems of
``data/stability_131k.csv.gz`` with the port under the dataset
pipeline's configuration unmodified (``_PIPE_CFG``, tail policy
"kepler"), takes the first ``n_rows`` systems the tail selects, and runs
them through the tail's engine, the scan analysis under
``integrator_mode="kepler_split"`` at their n_tail, at the dataset's
horizon (full mode, 1000 steps, dt 0.01, 50 MEGNO steps):

* the JAX package's ``analyze_batch_jit`` in float32 on the CPU, from
  the port's float32 build and with the JAX package's MEGNO tangents;
* the port's ``analysis/stability.py::analyze_batch`` in float32 and in
  float64 on the same inputs.

It prints the stable share of each, how often ``is_stable`` agrees
between them and with the dataset's own column, and the medians of the
verdict's inputs.
"""

import dataclasses
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import nbodysimproject_tpu as nb  # noqa: E402
import nbodysimproject_tpu_torch as nt  # noqa: E402
from nbodysimproject_tpu.analysis.stability import \
    analyze_batch_jit  # noqa: E402
from nbodysimproject_tpu.core.state import DynParams, SimState  # noqa: E402
from nbodysimproject_tpu.diagnostics.megno import init_tangent  # noqa: E402
from nbodysimproject_tpu.generators.pipeline import _PIPE_CFG  # noqa: E402
from nbodysimproject_tpu_torch.analysis.batch import (  # noqa: E402
    _tail_selection, prepare_population)
from nbodysimproject_tpu_torch.analysis.stability import \
    analyze_batch  # noqa: E402

DATA = os.path.join(os.path.dirname(HERE), "data", "stability_131k.csv.gz")
N_SLOTS, N_STEPS, DT, B = 8, 1000, 0.01, 16384
MEGNO_STEPS = min(100, min(50, N_STEPS // 2))


def load():
    import pandas as pd

    cols = [f"{p}_{i}" for p in ("mass", "x", "y", "vx", "vy")
            for i in range(N_SLOTS)]
    df = pd.read_csv(DATA, comment="#", nrows=B, usecols=cols + [
        "G", "softening", "min_softening", "is_stable"])
    get = lambda p: df[[f"{p}_{i}" for i in range(N_SLOTS)]].to_numpy(
        np.float64)
    mass = get("mass")
    mask = np.isfinite(mass)
    clean = lambda a: np.where(np.isfinite(a), a, 0.0)
    pos = np.stack([get("x"), get("y")], -1)
    vel = np.stack([get("vx"), get("vy")], -1)
    return (clean(mass), clean(pos), clean(vel), mask, df["G"].to_numpy(),
            df["softening"].to_numpy(), df["min_softening"].to_numpy(),
            df["is_stable"].to_numpy())


def _double(x):
    return x.replace(**{f.name: getattr(x, f.name).double()
                        for f in dataclasses.fields(x)
                        if torch.is_floating_point(getattr(x, f.name))})


def main(n_rows: int) -> None:
    mass, pos, vel, mask, G, soft, min_soft, ref = load()
    cfg = nt.SimConfig(**dataclasses.asdict(_PIPE_CFG))
    st, dy, n_raw = prepare_population(mass, pos, vel, mask, cfg, G=G,
                                       softening=soft,
                                       min_softening=min_soft, dt=DT,
                                       device="cpu")
    sel, n_tail = _tail_selection(st, dy, cfg, n_raw, DT)
    rows = np.nonzero(sel)[0][:n_rows]
    print(f"{int(sel.sum())} of {B} systems on the tail; the first "
          f"{len(rows)} analysed (n_tail {sorted(set(n_tail[rows]))})")
    lanes = torch.as_tensor(rows)
    st, dy = st.take(lanes), dy.take(lanes).replace(
        n_sub=torch.as_tensor(n_tail[rows].astype(np.int32)))
    trips = int(n_tail[rows].max())
    cfg_t = cfg.replace(integrator_mode="kepler_split")

    as_jax = lambda x, cls: cls(**{f.name: jnp.asarray(
        getattr(x, f.name).numpy()) for f in dataclasses.fields(x)})
    js, jd = as_jax(st, SimState), as_jax(dy, DynParams)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(0),
                                                 i))(
        jnp.asarray(rows, jnp.uint32))
    dr0, dv0 = jax.vmap(init_tangent)(keys, js)
    tan = tuple(torch.as_tensor(np.array(x)) for x in (dr0, dv0))
    cfg_j = nb.SimConfig(**dataclasses.asdict(cfg_t))

    out = {}
    t0 = time.perf_counter()
    r, _ = analyze_batch_jit(js, jd, cfg_j, keys, N_STEPS, jnp.float32(DT),
                             "full", trips, MEGNO_STEPS)
    out["jax float32"] = {k: np.asarray(v, np.float64) for k, v in r.items()}
    print(f"JAX scan engine, float32: {time.perf_counter() - t0:.1f}s")
    for label, s, d, tg in (("port float32", st, dy, tan),
                            ("port float64", _double(st), _double(dy),
                             tuple(x.double() for x in tan))):
        t0 = time.perf_counter()
        r, _ = analyze_batch(s, d, cfg_t, N_STEPS, DT, "full", trips,
                             MEGNO_STEPS, tangent=tg, trips=trips)
        out[label] = {k: v.double().numpy() for k, v in r.items()}
        print(f"{label}: {time.perf_counter() - t0:.1f}s")
    out["dataset"] = {"is_stable": ref[rows].astype(np.float64)}

    names = list(out)
    for nm in names:
        print(f"  {nm:13s} stable share {out[nm]['is_stable'].mean():.4f}")
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            agree = (out[a]["is_stable"] == out[b]["is_stable"]).mean()
            print(f"  is_stable {a} vs {b}: agrees on {agree:.4f}")
    for col in ("energy_drift", "angular_momentum_drift", "com_drift_mean",
                "MEGNO"):
        print(f"  {col}: " + ", ".join(
            f"{nm} finite {np.isfinite(out[nm][col]).mean():.3f} median "
            f"{np.nanmedian(out[nm][col]):.4g}" for nm in names[:3]))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
