"""The calibration fits of the port's ``ml/calibrate.py`` against the JAX
package's (which fits with sklearn; the port needs none), bit for bit on
the CPU: isotonic curves and ROC AUC (also against sklearn itself), the
per-cohort calibration with its fallback rules, the balanced-accuracy
operating point, the recall-floor points (single and pooled cohorts,
the ``min_pos`` skip, ``counts_out``), the reports of
``evaluate_policy``, and a fitted block applied by the port's
``StabilityPredictor``: its decisions are ``policy_decisions``' row for
row (the inputs of ``tests/test_calibration.py``)."""

import os

import numpy as np
import pandas as pd
import pytest

from nbodysimproject_tpu.ml import calibrate as jc
from nbodysimproject_tpu_torch.ml import calibrate as tc
from nbodysimproject_tpu_torch.ml.predict import StabilityPredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COHORTS = ("random", "hierarchical", "hierarchical_boundary",
           "close_encounter", "close_encounter_boundary", "polygon")


def _synthetic(n, rng, miscal):
    raw = rng.uniform(0.01, 0.99, n)
    y = (rng.uniform(size=n) < raw ** miscal).astype(np.float64)
    return raw, y


def _population(seed, n=6000):
    """Raw scores, labels and cohorts: each cohort its own distortion,
    close encounters rare-positive, one cohort too small for a curve."""
    rng = np.random.RandomState(seed)
    cohorts = np.asarray(rng.choice(COHORTS, n, p=[.3, .25, .1, .2, .1, .05]))
    miscal = {c: 0.5 + i for i, c in enumerate(COHORTS)}
    raw = rng.uniform(0.01, 0.99, n)
    p = np.asarray([raw[i] ** miscal[c] for i, c in enumerate(cohorts)])
    p[np.char.startswith(cohorts, "close")] *= 0.05
    y = (rng.uniform(size=n) < p).astype(np.float64)
    return raw, y, cohorts


@pytest.mark.parametrize("seed,miscal", [(0, 3.0), (1, 0.5), (2, 1.0)])
def test_isotonic_curve_bitwise(seed, miscal):
    raw, y = _synthetic(5000, np.random.RandomState(seed), miscal)
    assert tc.fit_isotonic_curve(raw, y) == jc.fit_isotonic_curve(raw, y)


def test_sklearn_free_fits_are_sklearns():
    """The port's isotonic fit and ROC AUC need no sklearn and give its
    bits: scores with ties, rounded and float32 scores, rare classes."""
    from sklearn.isotonic import IsotonicRegression
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(1)
    for t in range(60):
        n = int(rng.integers(3, 4000))
        y = (rng.uniform(size=n) < rng.uniform(0.01, 0.99)).astype(float)
        s = rng.uniform(size=n)
        s = (np.round(s, 2), s.astype(np.float32), s)[t % 3]
        if len(np.unique(y)) == 2:
            assert tc.roc_auc(y, s) == roc_auc_score(y, s)
        else:
            assert np.isnan(tc.roc_auc(y, s))
        iso = IsotonicRegression(y_min=0.0, y_max=1.0, out_of_bounds="clip")
        iso.fit(np.asarray(s, np.float64), y)
        curve = tc.fit_isotonic_curve(s, y)
        assert curve == {"x": iso.X_thresholds_.tolist(),
                         "y": iso.y_thresholds_.tolist()}


@pytest.mark.parametrize("seed", [3, 4])
def test_cohort_calibration_and_policy_bitwise(seed):
    raw, y, cohorts = _population(seed)
    calib = tc.fit_cohort_calibration(raw, y, cohorts)
    assert calib == jc.fit_cohort_calibration(raw, y, cohorts)
    assert set(calib["cohorts"]) < set(COHORTS)  # fallbacks happen
    pc = tc.calibrated_probability(raw, cohorts, calib)
    assert np.array_equal(pc, jc.calibrated_probability(raw, cohorts, calib))
    thr = tc.choose_global_threshold(pc, y)
    assert thr == jc.choose_global_threshold(pc, y)
    floors = {"close_encounter": 0.8,
              ("close_encounter", "close_encounter_boundary"): 0.9,
              "polygon": 0.5}
    counts_t, counts_j = {}, {}
    pts = tc.choose_recall_floor_thresholds(pc, y, cohorts, floors,
                                            counts_out=counts_t)
    assert pts == jc.choose_recall_floor_thresholds(
        pc, y, cohorts, floors, counts_out=counts_j)
    assert counts_t == counts_j and pts
    calib["cohort_operating_points"] = pts
    rep = tc.evaluate_policy(raw, y, cohorts, calib, thr)
    assert rep == jc.evaluate_policy(raw, y, cohorts, calib, thr)
    assert {"__overall__", "__hierarchical_union__",
            "__close_encounter_union__"} <= set(rep)
    assert rep == jc.evaluate_policy(raw, y, cohorts, calib, thr,
                                     cohort_points=pts)
    none = tc.evaluate_policy(raw, y, cohorts, calib, thr, cohort_points={})
    assert none == jc.evaluate_policy(raw, y, cohorts, calib, thr,
                                      cohort_points={})
    # the decisions behind the report
    prob, stable = tc.policy_decisions(raw, cohorts, calib, thr)
    assert np.array_equal(prob, pc)
    ov = rep["__overall__"]
    assert ov["tpr"] == stable[y == 1].sum() / (y == 1).sum()
    assert ov["n"] == len(y)


def test_recall_floor_skips_and_binary_report():
    rng = np.random.RandomState(5)
    n = 2000
    y = (rng.uniform(size=n) < 0.004).astype(np.float64)
    prob = np.clip(rng.normal(0.2 + 0.5 * y, 0.15), 0, 1)
    cohorts = np.array(["close_encounter"] * n)
    for kw in ({}, {"min_pos": 3}, {"min_pos": 100}):
        assert tc.choose_recall_floor_thresholds(
            prob, y, cohorts, {"close_encounter": 0.9}, **kw) == \
            jc.choose_recall_floor_thresholds(
                prob, y, cohorts, {"close_encounter": 0.9}, **kw)
    pred = prob > 0.4
    for args in ((y, pred), (y, pred, prob), (np.ones(5), np.ones(5), None)):
        assert tc._binary_report(*args) == jc._binary_report(*args)


def test_fitted_block_served_row_for_row():
    """A block fitted on the headline GBDT's own raw scores, applied by
    the port's predictor: its calibrated probabilities and decisions are
    ``policy_decisions``' bit for bit."""
    pred = StabilityPredictor(os.path.join(REPO, "data", "headline_pre_"),
                              model="gbdt", device="cpu")
    rng = np.random.RandomState(6)
    n = 4000
    df = pd.DataFrame(rng.normal(size=(n, len(pred.feature_names))),
                      columns=pred.feature_names)
    cohorts = rng.choice(COHORTS, n)
    pred.calibration = None
    _p, _s, raw = pred.predict_frame(df, return_raw=True)
    y = (rng.uniform(size=n) < raw).astype(np.float64)
    calib = tc.fit_cohort_calibration(raw, y, cohorts, min_rows=300,
                                      min_class=20)
    assert calib["cohorts"]
    pc = tc.calibrated_probability(raw, cohorts, calib)
    calib["global_threshold"] = tc.choose_global_threshold(pc, y)
    calib["cohort_operating_points"] = tc.choose_recall_floor_thresholds(
        pc, y, cohorts, {"close_encounter": 0.9})
    pred.calibration = calib
    prob, stable = pred.predict_frame(df, cohorts=cohorts)
    ref_prob, ref_stable = tc.policy_decisions(raw, cohorts, calib,
                                               calib["global_threshold"])
    assert np.array_equal(prob, ref_prob)
    assert np.array_equal(stable, ref_stable)
    assert 0 < stable.sum() < n
