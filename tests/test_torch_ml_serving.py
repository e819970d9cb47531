"""PyTorch port vs the JAX package: the classifiers' serving path.

* ``export_artifacts`` run afresh reproduces the arrays of the committed
  ``data/headline_pre_torch.npz`` bit for bit (the arrays, not the zip
  bytes); ``read_flax_msgpack`` + ``mlp_state_dict_from_flax`` equal the
  parameters the JAX package's ``MLPTrainer.load_model`` restores.
* On one frame (the JAX package's ``ic_feature_frame`` of a population
  it drew), both predictors' ``predict_frame`` with cohorts: the MLP's
  probabilities (raw and calibrated) within 1e-5 of the JAX package's
  and equal verdicts wherever the calibrated probability lies more than
  1e-5 from its operating point; the GBDT's raw scores equal to
  sklearn's ``_raw_predict`` bit for bit and its probabilities within
  1e-15; both calibrated through the shipped ``calibration`` block.
* ``ic_feature_frame`` against the JAX one: float64 to rtol 1e-12 /
  atol 1e-12 (the atol for entries that cancel to ~0: the COM offset of
  a recentred system, a variance of equal values; the softening std, a
  square root of a cancellation residue, to sqrt(eps) of the softening
  mean, as ``tests/test_torch_analysis.py`` holds it in float32),
  float32 to ``tests/test_torch_analysis.py``'s ``initial_*`` tolerances (rtol 1e-5 / atol 1e-6), the IC and schedule columns
  exactly; and bit for bit the port's own ``analyze_population``
  pre-integration columns (as ``tests/test_predict.py`` holds the JAX
  package's).
* ``predict_population`` end to end against the JAX package's on a
  float64 population.
* The predictor loads and scores in a process where sklearn, flax and
  msgpack cannot be imported; a missing ``.npz`` raises.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nbodysimproject_tpu_torch.analysis.batch import (analyze_population,
                                                      ic_feature_frame)
from nbodysimproject_tpu_torch.core.config import SimConfig
from nbodysimproject_tpu_torch.generators.pipeline import _PIPE_CFG
from nbodysimproject_tpu_torch.ml import artifacts
from nbodysimproject_tpu_torch.ml.model_zoo import MLP, make_mlp
from nbodysimproject_tpu_torch.ml.predict import StabilityPredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = os.path.join(REPO, "data", "headline_pre_")
NPZ = PREFIX + "torch.npz"
KW = dict(G=1.0, min_softening=0.0, dt=0.01)
MLP_TOL = 1e-5
GBDT_TOL = 1e-15


@functools.lru_cache(maxsize=None)
def _jax_population(B=256, seed=3):
    """A diverse population drawn by the JAX package (float32 numpy
    arrays) and its cohort tags (cached: the tests share two draws)."""
    import jax

    from nbodysimproject_tpu.generators.pipeline import diverse_population

    m, q, v, mask, soft, types = diverse_population(jax.random.PRNGKey(seed),
                                                    B, n_slots=8)
    return tuple(np.asarray(a) for a in (m, q, v, mask, soft)), tuple(types)


@pytest.fixture(scope="module")
def frame():
    from nbodysimproject_tpu.analysis.batch import ic_feature_frame as jicf
    from nbodysimproject_tpu.generators.pipeline import _PIPE_CFG as JCFG

    (m, q, v, mask, soft), types = _jax_population()
    return jicf(m, q, v, mask, JCFG, softening=soft, **KW), types


def test_export_reproduces_the_committed_file(tmp_path):
    out = artifacts.export_artifacts(PREFIX, str(tmp_path / "x.npz"))
    got, want = artifacts.load_artifacts(out), artifacts.load_artifacts(NPZ)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_flax_reader_matches_the_jax_trainer():
    from nbodysimproject_tpu.ml.train_mlp import MLPTrainer

    params = MLPTrainer.load_model(prefix=PREFIX).params["params"]
    tree = artifacts.read_flax_msgpack(PREFIX + "mlp_model.msgpack")
    for name, layer in params.items():
        for k, a in layer.items():
            b = tree["params"][name][k]
            assert b.dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(b, np.asarray(a))
    sd = artifacts.mlp_state_dict_from_flax(tree)
    model = MLP(sd["fc1.weight"].shape[1])
    model.load_state_dict(sd)
    for i in range(3):
        np.testing.assert_array_equal(
            sd[f"fc{i + 1}.weight"].numpy(),
            np.asarray(params[f"Dense_{i}"]["kernel"]).T)


def test_gbdt_export_refuses_what_it_cannot_walk():
    import copy
    import pickle

    with open(PREFIX + "gbdt_gbdt_model.pkl", "rb") as f:
        model = pickle.load(f)
    bad = copy.deepcopy(model)
    bad.n_trees_per_iteration_ = 2
    with pytest.raises(ValueError):
        artifacts.gbdt_arrays_from_sklearn(bad)
    bad = copy.deepcopy(model)
    bad._predictors[0][0].nodes["is_categorical"][0] = 1
    with pytest.raises(ValueError):
        artifacts.gbdt_arrays_from_sklearn(bad)


@pytest.mark.parametrize("kind", ["mlp", "gbdt"])
def test_predict_frame_matches_jax(frame, kind):
    from nbodysimproject_tpu.ml.calibrate import calibrated_probability
    from nbodysimproject_tpu.ml.predict import StabilityPredictor as JP

    df, types = frame
    jp = JP(prefix=PREFIX, model=kind)
    tp = StabilityPredictor(prefix=PREFIX, model=kind, device="cpu")
    assert tp.calibration == jp.calibration and tp.calibration
    assert tp.threshold == jp.threshold
    pj, sj, rj = jp.predict_frame(df, cohorts=types, return_raw=True)
    pt, st, rt = tp.predict_frame(df, cohorts=types, return_raw=True)
    assert rt.dtype == rj.dtype and st.dtype == bool
    # the shipped calibration block, applied to the port's raw scores
    np.testing.assert_array_equal(
        pt, calibrated_probability(rt, types, tp.calibration))
    points = tp.calibration["cohort_operating_points"]
    thr = np.asarray([points.get(c, tp.calibration["global_threshold"])
                      for c in types])
    np.testing.assert_array_equal(st, pt > thr)
    if kind == "mlp":
        np.testing.assert_allclose(rt, rj, rtol=0, atol=MLP_TOL)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=MLP_TOL)
        clear = np.abs(pj - thr) > MLP_TOL
        np.testing.assert_array_equal(st[clear], sj[clear])
    else:
        from nbodysimproject_tpu.ml.predict import feature_matrix

        Xs = jp._scaler.transform(feature_matrix(df, jp.feature_names))
        np.testing.assert_array_equal(tp.raw_score(df),
                                      jp._model._raw_predict(Xs)[:, 0])
        np.testing.assert_allclose(rt, rj, rtol=0, atol=GBDT_TOL)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=GBDT_TOL)
        np.testing.assert_array_equal(st, sj)
    # without cohorts: the pooled curve and the global operating point
    pt0, st0 = tp.predict_frame(df)
    pj0, sj0 = jp.predict_frame(df)
    np.testing.assert_allclose(pt0, pj0, rtol=0, atol=MLP_TOL)


def _frames_both(pop, cfg_j, cfg_t, soft):
    from nbodysimproject_tpu.analysis.batch import ic_feature_frame as jicf

    ref = jicf(*pop, cfg_j, softening=soft, **KW)
    got = ic_feature_frame(*pop, cfg_t, softening=soft, device="cpu", **KW)
    assert list(got.columns) == list(ref.columns)
    return ref, got


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_ic_feature_frame_matches_jax(precision):
    import dataclasses

    import nbodysimproject_tpu as nb

    (m, q, v, mask, soft), _ = _jax_population(B=64, seed=7)
    if precision == "float64":
        cfg_t = SimConfig(slot_bucket=8)
        m, q, v, soft = (a.astype(np.float64) for a in (m, q, v, soft))
        rtol, atol, eps = 1e-12, 1e-12, np.finfo(np.float64).eps
    else:
        cfg_t = _PIPE_CFG
        rtol, atol, eps = 1e-5, 1e-6, np.finfo(np.float32).eps
    cfg_j = nb.SimConfig(**dataclasses.asdict(cfg_t))
    ref, got = _frames_both((m, q, v, mask), cfg_j, cfg_t, soft)
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
        np.testing.assert_allclose(b.astype(np.float64),
                                   a.astype(np.float64), rtol=rtol,
                                   atol=at, err_msg=c)


def test_ic_feature_frame_is_the_analysis_pre_columns():
    (m, q, v, mask, soft), _ = _jax_population(B=16, seed=9)
    df_ic = ic_feature_frame(m, q, v, mask, _PIPE_CFG, softening=soft,
                             device="cpu", **KW)
    df_an = analyze_population(m, q, v, mask, _PIPE_CFG, softening=soft,
                               n_steps=2, mode="full", show_progress=False,
                               device="cpu", **KW)
    assert len(df_ic.columns) > 40
    for c in df_ic.columns:
        a, b = df_ic[c].to_numpy(), df_an[c].to_numpy()
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a, b, err_msg=c)
        else:
            assert (a == b).all(), c


def test_ic_feature_frame_takes_tensors():
    """Tensors go through as arrays do (the generators hand the analysis
    tensors on their device)."""
    (m, q, v, mask, soft), _ = _jax_population(B=16, seed=9)
    a = ic_feature_frame(m, q, v, mask, _PIPE_CFG, softening=soft,
                         device="cpu", **KW)
    b = ic_feature_frame(*(torch.as_tensor(np.array(x))
                           for x in (m, q, v, mask)), _PIPE_CFG,
                         softening=torch.as_tensor(np.array(soft)),
                         device="cpu", **KW)
    for c in a.columns:
        np.testing.assert_array_equal(a[c].to_numpy(), b[c].to_numpy(),
                                      err_msg=c)


@pytest.mark.parametrize("kind", ["mlp", "gbdt"])
def test_predict_population_matches_jax(kind):
    import nbodysimproject_tpu as nb
    from nbodysimproject_tpu.ml.predict import StabilityPredictor as JP

    (m, q, v, mask, soft), types = _jax_population(B=64, seed=7)
    m, q, v, soft = (a.astype(np.float64) for a in (m, q, v, soft))
    kw = dict(G=1.0, softening=soft, min_softening=0.0, dt=0.01,
              cohorts=list(types))
    pj, sj = JP(prefix=PREFIX, model=kind).predict_population(
        m, q, v, mask, nb.SimConfig(slot_bucket=8), **kw)
    pt, st = StabilityPredictor(prefix=PREFIX, model=kind,
                                device="cpu").predict_population(
        m, q, v, mask, SimConfig(slot_bucket=8), **kw)
    assert pt.shape == (64,) and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=MLP_TOL)
    np.testing.assert_array_equal(st, sj)


_NO_SKLEARN = r"""
import sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("sklearn", "flax", "msgpack", "jax"):
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, Block())
import numpy as np
import pandas as pd
from nbodysimproject_tpu_torch.ml.predict import StabilityPredictor
for kind in ("mlp", "gbdt"):
    p = StabilityPredictor(prefix=sys.argv[1], model=kind, device="cpu")
    df = pd.DataFrame({c: np.zeros(3) for c in p.feature_names})
    prob, stable = p.predict_frame(df, cohorts=["random"] * 3)
    assert prob.shape == (3,) and np.isfinite(prob).all()
assert not any(m.split(".")[0] in ("sklearn", "flax", "msgpack", "jax")
               for m in sys.modules)
print("ok")
"""


def test_predictor_needs_no_sklearn_flax_or_msgpack():
    out = subprocess.run([sys.executable, "-c", _NO_SKLEARN, PREFIX],
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_missing_npz_raises(tmp_path):
    import shutil

    prefix = str(tmp_path / "p_")
    shutil.copy(PREFIX + "model_metadata.json", prefix + "model_metadata.json")
    with pytest.raises(FileNotFoundError):
        StabilityPredictor(prefix=prefix, model="mlp", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            StabilityPredictor(prefix=PREFIX, model="gbdt")


def test_make_mlp_is_seeded():
    a, b = make_mlp(7, seed=1, device="cpu"), make_mlp(7, seed=1,
                                                        device="cpu")
    c = make_mlp(7, seed=2, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert list(sa) == ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias",
                        "fc3.weight", "fc3.bias"]
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["fc1.weight"], sc["fc1.weight"])
    w = sa["fc1.weight"]
    assert (sa["fc1.bias"] == 0).all()
    assert w.abs().max() <= 2.0 * np.sqrt(1 / 7) / .87962566103423978
