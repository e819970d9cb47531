"""Shared inputs and checks of the scan-route tests
(``tests/test_torch_scan_route_*.py``): the port's ``analyze_population``
on the CPU for the configurations the fused engine does not cover, held
against the JAX package's ``analyze_population`` on the CPU, which runs
every configuration on its scan engine (``analyze_batch_jit``).

Populations:

* ``masked()``: ``tests/test_torch_analysis.py``'s B = 16, N = 4
  population with a masked slot (mass 0), and ``synthetic()`` the same
  systems with the masked slot removed (N = 3), which the JAX package
  runs: its eps* sits at the clamp, so its gradient is 0;
* ``dataset_rows()``: the first 16 rows of ``data/stability_131k.csv.gz``
  with three bodies in slots 0-2 and a frozen n_sub of at most 2, in
  their 8 slots (five masked, zero mass) and cut to 3: eps* leaves its
  clamp during the run there, so the eps* gradient drives the spring
  impulse;
* ``probe_population()``: the synthetic population with two rows
  replaced by clustered systems that blow up in the first 10 steps at
  ``analysis_n_sub_cap=2`` (their drift is non-finite at the probe's
  horizon in float32; in float64 one of them is finite but above 3e7).

The MEGNO tangents are the JAX package's ``init_tangent`` draws, in the
run's dtype, so both packages start MEGNO from the same vectors.
"""

import os

import numpy as np

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from test_torch_analysis import PIPE, _raw_population
from test_torch_hamsoft_kernels import _TOL

T = 12
#: float64 rows to round-off: relative 1e-9, and an absolute 1e-12 for
#: the drift columns, which are differences of O(1) quantities and so
#: carry O(1e-16) absolute error on values that may be near 0
F64_TOL = (1e-9, 1e-12)
#: the MEGNO chaos columns; an aborted probe row leaves them NaN
CHAOS = ("MEGNO", "lyapunov_time", "megno_slope_med")
DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "stability_131k.csv.gz")


def masked():
    return _raw_population(4, True)


def unmasked(pop, n=3):
    """The systems of a masked population with their masked slots (the
    last ones) removed."""
    assert pop[3][:, :n].all() and not pop[3][:, n:].any()
    return tuple(a[:, :n] for a in pop)


def synthetic():
    return unmasked(masked())


def dataset_rows(k=16):
    """(the 8-slot population, softening, min_softening) of the first
    ``k`` dataset rows with three bodies in slots 0-2 and n_sub <= 2."""
    import pandas as pd

    n = 8
    cols = [f"{p}_{i}" for p in ("mass", "x", "y", "vx", "vy")
            for i in range(n)]
    df = pd.read_csv(DATA, comment="#", nrows=2000, usecols=cols + [
        "softening", "min_softening", "n_sub"])
    get = lambda p: df[[f"{p}_{i}" for i in range(n)]].to_numpy(np.float64)
    mass = get("mass")
    mask = np.isfinite(mass)
    clean = lambda a: np.where(np.isfinite(a), a, 0.0)
    pos = clean(np.stack([get("x"), get("y")], -1))
    vel = clean(np.stack([get("vx"), get("vy")], -1))
    pick = ((mask.sum(1) == 3) & mask[:, :3].all(1)
            & (df["n_sub"].to_numpy() <= 2))
    idx = np.nonzero(pick)[0][:k]
    assert len(idx) == k
    pop = (clean(mass)[idx], pos[idx], vel[idx], mask[idx])
    return (pop, df["softening"].to_numpy(np.float64)[idx],
            df["min_softening"].to_numpy(np.float64)[idx])


#: rows of the clustered draw below that blow up at n_sub 2 (their
#: drift at 10 steps is non-finite in float32, above 3e7 or non-finite in
#: float64), and where they go in the probe population
_BLOW_UP = (18, 50)
PROBE_ROWS = (3, 11)
#: the probe population's n_sub cap, which under-integrates those rows
PROBE_CAP = 2


def probe_population():
    m, q, v, mask = (a.copy() for a in synthetic())
    rng = np.random.default_rng(6)
    qc = 0.1 * rng.normal(size=(64, 3, 2))
    vc = 0.2 * rng.normal(size=(64, 3, 2))
    for row, src in zip(PROBE_ROWS, _BLOW_UP):
        m[row], q[row], v[row] = np.linspace(1.0, 0.2, 3), qc[src], vc[src]
    return m, q, v, mask


def jax_tangents(pop, cfg_kw, seed=0):
    """The MEGNO tangents the JAX analyze_population draws (per-system
    keys from the global system id), in the run's dtype."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.diagnostics.megno import init_tangent
    from nbodysimproject_tpu.parallel.batch_engine import build_batch

    cfg = nb.SimConfig(**{**PIPE, **cfg_kw})
    dt_ = jnp.float32 if cfg.fast_float32 else jnp.float64
    m, q, v, mask = pop
    f = lambda a: jnp.asarray(a, dt_)
    states, _ = build_batch(f(m), f(q), f(v), jnp.asarray(mask), cfg, 1.0,
                            5e-2, 0.0, 0.01)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 i))(
        jnp.arange(m.shape[0], dtype=jnp.uint32))
    dr0, dv0 = jax.vmap(init_tangent)(keys, states)
    return np.asarray(dr0), np.asarray(dv0)


def pad_tangents(tangent, n):
    """(B, N, d) tangents padded with zero rows to n slots."""
    pad = lambda a: np.concatenate(
        [a, np.zeros((a.shape[0], n - a.shape[1], a.shape[2]), a.dtype)], 1)
    return pad(tangent[0]), pad(tangent[1])


def run_jax(pop, cfg_kw, *, mode="full", n_steps=T, G=1.0, softening=5e-2,
            min_softening=0.0):
    from nbodysimproject_tpu.analysis.batch import analyze_population

    return analyze_population(*pop, nb.SimConfig(**{**PIPE, **cfg_kw}), G=G,
                              softening=softening,
                              min_softening=min_softening, dt=0.01,
                              n_steps=n_steps, mode=mode, show_progress=False)


def run_port(pop, cfg_kw, tangent=None, *, mode="full", n_steps=T, G=1.0,
             softening=5e-2, min_softening=0.0, timing_out=None):
    return nt.analyze_population(
        *pop, nt.SimConfig(**{**PIPE, **cfg_kw}), G=G, softening=softening,
        min_softening=min_softening, dt=0.01, n_steps=n_steps, mode=mode,
        show_progress=False, device="cpu", tangent=tangent,
        timing_out=timing_out)


def assert_analysis_columns(ref, got, tol, rows=None):
    """is_stable equal row by row and every other analysis column of
    ``ref`` within ``tol`` (a (rtol, atol) pair, or a dict of them per
    column), finite where ``ref`` is."""
    rows = np.ones(len(ref), bool) if rows is None else rows
    cols = [c for c in ref.columns if c in _TOL]
    assert cols and "is_stable" in cols
    for c in cols:
        a = ref[c].to_numpy(np.float64)[rows]
        b = got[c].to_numpy(np.float64)[rows]
        if c == "is_stable":
            np.testing.assert_array_equal(b, a)
            continue
        fin = np.isfinite(a)
        np.testing.assert_array_equal(np.isfinite(b), fin, err_msg=c)
        rtol, atol = tol[c] if isinstance(tol, dict) else tol
        np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=atol,
                                   err_msg=c)


def assert_other_columns(ref, got, feature_rtol, feature_atol):
    """The same columns in the same order; the IC, schedule and tag
    columns exact; the ``initial_*`` features to the given tolerance,
    but ``initial_softening_std``, the square root of the cancellation
    residue of sumsq/n - mean^2 for a one-entry history, which is held
    to sqrt(eps) of the dtype times the softening mean."""
    assert list(got.columns) == list(ref.columns)
    for c in ref.columns:
        if c in _TOL:
            continue
        a, b = ref[c].to_numpy(), got[c].to_numpy()
        if not c.startswith("initial_"):
            np.testing.assert_array_equal(b, a, err_msg=c)
            continue
        atol = feature_atol
        if c == "initial_softening_std":
            eps = np.finfo(b.dtype).eps
            atol = np.sqrt(eps) * ref["initial_softening_mean"].max()
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   rtol=feature_rtol, atol=atol, err_msg=c)
