"""PyTorch port vs the JAX package: ``analyze_population`` on the scan
route at d = 3, which the scan route's other tests leave out (the
facade's ``StabilityAnalyzer`` runs the same engine at d = 3), and, in
``test_torch_scan_route_s_only.py``, under ``_validate_S_only``.

* d = 3: ``tests/torch_scan_route.py``'s synthetic population (B = 16,
  N = 3) with a z column drawn with numpy (seed 9), under ham_soft in
  float64, verlet in float64 and ham_soft in float32 with
  ``use_fused_analysis=False`` (12 steps, 6 MEGNO steps, the JAX
  tangents), and the first 8 rows of ``data/stability_3d_131k.csv.gz``
  with three bodies in slots 0-2 and n_sub <= 2, cut to 3 slots (their
  eps* leaves its clamp, so the eps* gradient drives the spring), in
  float32.
Each against the JAX package's ``analyze_population`` on the CPU:
``is_stable`` row by row, the analysis columns within ``F64_TOL``
(float64: rtol 1e-9, atol 1e-12) or the fused-vs-scan ``_TOL``
(float32), the other columns as the scan route's float64 / float32
tests hold them; every lane on the scan engine.
"""

import os

import numpy as np
import pytest

import torch_scan_route as sr
from test_torch_hamsoft_kernels import _TOL

DATA3 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "stability_3d_131k.csv.gz")


def synthetic_3d():
    m, q, v, mask = sr.synthetic()
    rng = np.random.default_rng(9)
    z = lambda s: s * rng.normal(size=q.shape[:2] + (1,))
    return m, np.concatenate([q, z(0.1)], -1), np.concatenate([v, z(0.05)],
                                                              -1), mask


def dataset_rows_3d(k=8):
    """(population cut to 3 slots, softening, min_softening) of the
    first ``k`` 3-D dataset rows with three bodies in slots 0-2 and
    n_sub <= 2."""
    import pandas as pd

    n = 8
    cols = [f"{p}_{i}" for p in ("mass", "x", "y", "z", "vx", "vy", "vz")
            for i in range(n)]
    df = pd.read_csv(DATA3, comment="#", nrows=2000, usecols=cols + [
        "softening", "min_softening", "n_sub"])
    get = lambda p: df[[f"{p}_{i}" for i in range(n)]].to_numpy(np.float64)
    mass = get("mass")
    mask = np.isfinite(mass)
    pick = ((mask.sum(1) == 3) & mask[:, :3].all(1)
            & (df["n_sub"].to_numpy() <= 2))
    idx = np.nonzero(pick)[0][:k]
    assert len(idx) == k
    vec = lambda ax: np.stack([get(a) for a in ax], -1)[idx, :3]
    pop = (mass[idx, :3], vec("xyz"), vec(("vx", "vy", "vz")),
           mask[idx, :3])
    return (pop, df["softening"].to_numpy(np.float64)[idx],
            df["min_softening"].to_numpy(np.float64)[idx])


CASES = {
    "d3 ham_soft float64": (synthetic_3d, dict(fast_float32=False, dim=3)),
    "d3 verlet float64": (synthetic_3d, dict(integrator_mode="verlet",
                                             fast_float32=False, dim=3)),
    "d3 ham_soft float32 unfused": (synthetic_3d, dict(
        use_fused_analysis=False, dim=3)),
    "d3 dataset rows float32 unfused": (dataset_rows_3d, dict(
        use_fused_analysis=False, dim=3)),
}


def check_case(make, cfg_kw):
    out = make()
    pop, kw = (out[0], dict(softening=out[1], min_softening=out[2])) \
        if len(out) == 3 else (out, {})
    ref = sr.run_jax(pop, cfg_kw, **kw)
    tm = {}
    got = sr.run_port(pop, cfg_kw, sr.jax_tangents(pop, cfg_kw),
                      timing_out=tm, **kw)
    assert tm["engine"] == "scan" and tm["fused_lanes"] == 0
    f64 = cfg_kw.get("fast_float32", True) is False
    sr.assert_analysis_columns(ref, got, sr.F64_TOL if f64 else _TOL)
    sr.assert_other_columns(ref, got, *((1e-12, 1e-14) if f64
                                        else (1e-5, 1e-6)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_route_against_jax(case):
    check_case(*CASES[case])
