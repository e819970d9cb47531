"""PyTorch port vs the JAX package at d = 3: the pre-integration feature
frame and the 3-D headline classifiers, on the CPU.

Rows: the first 256 rows of ``data/stability_3d_131k.csv.gz`` (3-5
bodies in 8 slots, the random cohort), with the dataset's own
softening, G and min_softening.

* ``export_artifacts`` run afresh reproduces the arrays of the committed
  ``data/headline3d_pre_torch.npz`` bit for bit.
* ``ic_feature_frame`` at d = 3 against the JAX one: the column names
  (the x, y, z and vx, vy, vz columns of every slot; 89 columns, the 88
  model features and ``integrator_mode``) equal, the IC and schedule
  columns exactly, the ``initial_*`` columns in float32 to rtol 1e-5 /
  atol 1e-6 (``tests/test_torch_ml_serving.py``'s tolerances, the
  softening std to sqrt(eps) of the softening mean, |L_z| with 8 eps of
  sum_i |L_z,i| more: a cancelled sum) and in float64 to rtol 1e-12 /
  atol 1e-12.  The angular features keep the JAX package's
  z-only form (``angular_momentum_z``, |x vy - y vx|), on which the 3-D
  models were trained.
* On the JAX frame, both 3-D predictors' ``predict_frame`` with the
  random cohort: the MLP's probabilities (raw and calibrated) within
  1e-5 of the JAX package's with equal verdicts wherever the calibrated
  probability lies more than 1e-5 from its operating point; the GBDT's
  raw scores equal to sklearn's ``_raw_predict`` bit for bit and its
  probabilities within 1e-15 (``tests/test_torch_ml_serving.py``).
"""

import dataclasses
import os

import numpy as np
import pytest

import nbodysimproject_tpu as nb
from nbodysimproject_tpu_torch.analysis.batch import ic_feature_frame
from nbodysimproject_tpu_torch.core.config import SimConfig
from nbodysimproject_tpu_torch.generators.pipeline import _PIPE_CFG
from nbodysimproject_tpu_torch.ml import artifacts
from nbodysimproject_tpu_torch.ml.predict import StabilityPredictor
from test_torch_3d_core import dataset_rows_3d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = os.path.join(REPO, "data", "headline3d_pre_")
NPZ = PREFIX + "torch.npz"
MLP_TOL = 1e-5
GBDT_TOL = 1e-15
B = 256


def _rows(dtype=np.float32):
    (m, q, v, mask, G, soft, msoft), _ = dataset_rows_3d()
    cast = lambda a: a[:B].astype(dtype)
    return ((cast(m), cast(q), cast(v), mask[:B]),
            dict(G=G[:B], softening=cast(soft), min_softening=msoft[:B],
                 dt=0.01))


def _frames(cfg_t, dtype):
    from nbodysimproject_tpu.analysis.batch import ic_feature_frame as jicf

    pop, kw = _rows(dtype)
    cfg_j = nb.SimConfig(**dataclasses.asdict(cfg_t))
    ref = jicf(*pop, cfg_j, **kw)
    got = ic_feature_frame(*pop, cfg_t, device="cpu", **kw)
    return ref, got


@pytest.fixture(scope="module")
def frame():
    ref, _ = _frames(_PIPE_CFG, np.float32)
    return ref


def test_export_reproduces_the_committed_file(tmp_path):
    out = artifacts.export_artifacts(PREFIX, str(tmp_path / "x.npz"))
    got, want = artifacts.load_artifacts(out), artifacts.load_artifacts(NPZ)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_ic_feature_frame_3d_matches_jax(precision):
    if precision == "float32":
        cfg_t, dtype = _PIPE_CFG, np.float32
        rtol, atol, eps = 1e-5, 1e-6, np.finfo(np.float32).eps
    else:
        cfg_t, dtype = SimConfig(slot_bucket=8), np.float64
        rtol, atol, eps = 1e-12, 1e-12, np.finfo(np.float64).eps
    ref, got = _frames(cfg_t, dtype)
    (m, q, v, _mask), _ = _rows(np.float64)
    # |L_z| is a cancelled sum: its rounding scales with sum_i |L_z,i|
    lz_scale = np.abs(m * (q[..., 0] * v[..., 1] - q[..., 1] * v[..., 0])
                      ).sum(-1)
    assert list(got.columns) == list(ref.columns)
    assert len(got.columns) == 89
    assert {"z_7", "vz_0"} <= set(got.columns)
    feats = [c for c in ref.columns if c.startswith("initial_")]
    assert len(feats) == 25
    for c in ref.columns:
        a, b = ref[c].to_numpy(), got[c].to_numpy()
        if c not in feats:
            np.testing.assert_array_equal(b, a, err_msg=c)
            continue
        at = atol
        if c == "initial_softening_std":
            at = np.sqrt(eps) * ref["initial_softening_mean"].to_numpy().max()
        if c == "initial_total_angular_momentum":
            at = atol + 8.0 * eps * lz_scale
        a, b = a.astype(np.float64), b.astype(np.float64)
        bad = np.abs(b - a) > at + rtol * np.abs(a)
        assert not bad.any(), (c, np.nonzero(bad)[0], a[bad], b[bad])


def test_models_take_the_frame_columns(frame):
    for kind in ("mlp", "gbdt"):
        p = StabilityPredictor(prefix=PREFIX, model=kind, device="cpu")
        assert len(p.feature_names) == 88
        assert set(p.feature_names) <= set(frame.columns)
        assert "z_0" in p.feature_names and "vz_7" in p.feature_names


@pytest.mark.parametrize("kind", ["mlp", "gbdt"])
def test_predict_frame_3d_matches_jax(frame, kind):
    from nbodysimproject_tpu.ml.predict import StabilityPredictor as JP

    types = ["random"] * len(frame)
    jp = JP(prefix=PREFIX, model=kind)
    tp = StabilityPredictor(prefix=PREFIX, model=kind, device="cpu")
    assert tp.calibration == jp.calibration
    assert tp.threshold == jp.threshold
    assert tp.cohort_thresholds == jp.cohort_thresholds
    pj, sj, rj = jp.predict_frame(frame, cohorts=types, return_raw=True)
    pt, st, rt = tp.predict_frame(frame, cohorts=types, return_raw=True)
    assert rt.dtype == rj.dtype and st.dtype == bool
    assert 0.0 < st.mean() < 1.0
    if kind == "mlp":
        np.testing.assert_allclose(rt, rj, rtol=0, atol=MLP_TOL)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=MLP_TOL)
        # legacy metadata (no calibration block): the raw probability
        # against the cohort's threshold
        thr = tp.cohort_thresholds.get("random", tp.threshold)
        clear = np.abs(pj - thr) > MLP_TOL
        np.testing.assert_array_equal(st[clear], sj[clear])
    else:
        from nbodysimproject_tpu.ml.predict import feature_matrix

        Xs = jp._scaler.transform(feature_matrix(frame, jp.feature_names))
        np.testing.assert_array_equal(tp.raw_score(frame),
                                      jp._model._raw_predict(Xs)[:, 0])
        np.testing.assert_allclose(rt, rj, rtol=0, atol=GBDT_TOL)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=GBDT_TOL)
        np.testing.assert_array_equal(st, sj)
