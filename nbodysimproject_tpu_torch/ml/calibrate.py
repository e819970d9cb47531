"""Per-cohort probability calibration for the stability classifiers.

Counterpart of ``nbodysimproject_tpu/ml/calibrate.py``: isotonic
regression per cohort maps a model's raw score to a cohort-conditional
P(stable | x), and one operating point on the calibrated probability
(the balanced-accuracy optimum, with optional recall-floor points per
cohort) serves every cohort.  The JAX package fits with sklearn's
``IsotonicRegression`` and scores with its ``roc_auc_score``; the port
needs no sklearn: ``fit_isotonic_curve`` does sklearn's fit (sorted
points, duplicates averaged, ``scipy.optimize.isotonic_regression``,
clipped to [0, 1], the inner points of flat runs dropped) and
``roc_auc`` sklearn's ROC curve and trapezoid area, bit for bit.  All on
the host in float64; applying a curve is ``np.interp``.

The shipped metadata schema (the ``calibration`` block, schema_version
2, which the port's ``StabilityPredictor`` applies)::

    {"schema_version": 2, "method": "isotonic",
     "global_threshold": t,                    # on CALIBRATED prob
     "cohorts": {name: {"x": [...], "y": [...]}},
     "__pooled__": {"x": [...], "y": [...]},   # fallback curve
     "cohort_operating_points": {name: t}}     # optional

Curves are stored as interpolation breakpoints (the isotonic fit's
unique thresholds).
"""

from __future__ import annotations

import numpy as np


def _make_unique(x, y):
    """sklearn's ``_make_unique`` at unit weights: runs of sorted ``x``
    within float64 resolution (1e-15) of their first value become one
    point, its target the mean of theirs (summed in order)."""
    eps = np.finfo(np.float64).resolution
    xs, ys, ws = [], [], []
    cur_x, cur_y, cur_w = float(x[0]), 0.0, 0.0
    for xj, yj in zip(x.tolist(), y.tolist()):
        if xj - cur_x >= eps:
            xs.append(cur_x)
            ws.append(cur_w)
            ys.append(cur_y / cur_w)
            cur_x, cur_y, cur_w = xj, yj * 1.0, 1.0
        else:
            cur_w += 1.0
            cur_y += yj * 1.0
    xs.append(cur_x)
    ws.append(cur_w)
    ys.append(cur_y / cur_w)
    return np.asarray(xs), np.asarray(ys), np.asarray(ws)


def fit_isotonic_curve(prob, y) -> dict:
    """Fit isotonic P(y=1 | prob) on [0, 1] and return its interp
    breakpoints: sklearn's ``IsotonicRegression(y_min=0, y_max=1)``
    ``X_thresholds_`` / ``y_thresholds_``."""
    from scipy.optimize import isotonic_regression

    x = np.asarray(prob, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    order = np.lexsort((y, x))
    ux, uy, uw = _make_unique(x[order], y[order])
    fit = np.asarray(isotonic_regression(uy, weights=uw, increasing=True).x,
                     dtype=np.float64)
    np.clip(fit, 0.0, 1.0, fit)
    keep = np.ones(len(fit), bool)
    keep[1:-1] = (fit[1:-1] != fit[:-2]) | (fit[1:-1] != fit[2:])
    return {"x": [float(v) for v in ux[keep]],
            "y": [float(v) for v in fit[keep]]}


def roc_auc(y_true, y_score) -> float:
    """sklearn's ``roc_auc_score`` of binary labels (1 positive): the ROC
    curve at each distinct score (collinear points dropped), then its
    trapezoid area; NaN with one class only."""
    y_true = np.asarray(y_true)
    if len(np.unique(y_true)) != 2:
        return float("nan")
    score = np.asarray(y_score)
    order = np.argsort(score, kind="stable")[::-1]
    score = score[order]
    pos = (y_true[order] == 1).astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(score))[0], len(pos) - 1]
    tps = np.cumsum(pos, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    if len(fps) > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                     True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0,
                        dtype=np.float64))


def apply_curve(prob, curve) -> np.ndarray:
    x = np.asarray(curve["x"], np.float64)
    yv = np.asarray(curve["y"], np.float64)
    if len(x) == 0:
        return np.asarray(prob, np.float64)
    return np.interp(np.asarray(prob, np.float64), x, yv)


def fit_cohort_calibration(prob, y, cohorts, *, min_rows: int = 500,
                           min_class: int = 25) -> dict:
    """Isotonic curves per cohort plus the pooled fallback.  A cohort
    gets its own curve only with at least ``min_rows`` rows and
    ``min_class`` of each class; the others take the pooled curve."""
    prob = np.asarray(prob, np.float64)
    y = np.asarray(y, np.float64)
    cohorts = np.asarray([str(c) for c in cohorts])
    calib = {"schema_version": 2, "method": "isotonic",
             "__pooled__": fit_isotonic_curve(prob, y), "cohorts": {}}
    for c in sorted(set(cohorts.tolist())):
        sel = cohorts == c
        ys = y[sel]
        n_pos = int((ys == 1).sum())
        n_neg = int((ys == 0).sum())
        if sel.sum() >= min_rows and min(n_pos, n_neg) >= min_class:
            calib["cohorts"][c] = fit_isotonic_curve(prob[sel], ys)
    return calib


def calibrated_probability(prob, cohorts, calib) -> np.ndarray:
    """Map raw scores through the cohort's curve (pooled fallback)."""
    prob = np.asarray(prob, np.float64)
    out = apply_curve(prob, calib["__pooled__"])
    if cohorts is None:
        return out
    cohorts = np.asarray([str(c) for c in cohorts])
    for c, curve in calib.get("cohorts", {}).items():
        sel = cohorts == c
        if sel.any():
            out[sel] = apply_curve(prob[sel], curve)
    return out


def _binary_report(y, pred, prob=None) -> dict:
    y = np.asarray(y, np.float64)
    pred = np.asarray(pred, np.float64)
    tp = float(((pred == 1) & (y == 1)).sum())
    tn = float(((pred == 0) & (y == 0)).sum())
    fp = float(((pred == 1) & (y == 0)).sum())
    fn = float(((pred == 0) & (y == 1)).sum())
    tpr = tp / max(tp + fn, 1.0)
    tnr = tn / max(tn + fp, 1.0)
    out = {"n": int(len(y)), "stable_fraction": float(y.mean()),
           "tpr": tpr, "tnr": tnr,
           "precision": tp / max(tp + fp, 1.0),
           "balanced_accuracy": 0.5 * (tpr + tnr),
           "accuracy": (tp + tn) / max(len(y), 1)}
    if prob is not None and 0.0 < y.mean() < 1.0:
        out["auroc"] = roc_auc(y, prob)
    return out


def choose_global_threshold(prob_cal, y, *, grid_points: int = 199) -> float:
    """Operating point on the CALIBRATED probability: the overall
    balanced accuracy's maximum over a quantile grid."""
    prob_cal = np.asarray(prob_cal, np.float64)
    y = np.asarray(y, np.float64)
    best_t, best_ba = 0.5, -1.0
    qs = np.unique(np.quantile(prob_cal,
                               np.linspace(0.005, 0.995, grid_points)))
    for t in qs:
        pred = prob_cal > t
        tpr = pred[y == 1].mean() if (y == 1).any() else 0.0
        tnr = 1.0 - pred[y == 0].mean() if (y == 0).any() else 0.0
        ba = 0.5 * (tpr + tnr)
        if ba > best_ba:
            best_ba, best_t = ba, float(t)
    return best_t


def choose_recall_floor_thresholds(prob_cal, y, cohorts, floors, *,
                                   min_pos: int = 10,
                                   counts_out: dict | None = None) -> dict:
    """Per-cohort operating points on the CALIBRATED probability: for
    each cohort of ``floors`` (cohort -> minimum TPR; a tuple key pools
    its cohorts' positives and gives each member the same point), the
    largest threshold whose within-cohort TPR meets the floor.  Cohorts
    with fewer than ``min_pos`` positives are skipped; ``counts_out``
    receives {cohort: positives used} for every point returned."""
    prob_cal = np.asarray(prob_cal, np.float64)
    y = np.asarray(y, np.float64)
    cohorts = np.asarray([str(c) for c in cohorts])
    points = {}
    for key, floor in floors.items():
        members = (key,) if isinstance(key, str) else tuple(key)
        sel = np.isin(cohorts, members) & (y == 1)
        n_pos = int(sel.sum())
        if n_pos < int(min_pos):
            if n_pos:
                print(f"[calibrate] recall floor for {members} skipped: "
                      f"{n_pos} positive(s) < min_pos={min_pos}")
            continue
        pos = np.sort(prob_cal[sel])[::-1]
        k = int(np.ceil(float(floor) * len(pos)))
        k = min(max(k, 1), len(pos))
        # pred = prob > thr is strict: step just below the k-th largest
        # positive score to include it
        thr = float(np.nextafter(pos[k - 1], -np.inf))
        for c in members:
            points[c] = thr
            if counts_out is not None:
                counts_out[c] = n_pos
    return points


def policy_decisions(prob_raw, cohorts, calib, thr, cohort_points=None):
    """(calibrated probability, is_stable) at the shipped policy:
    calibrated probability > thr, a cohort's operating point of
    ``cohort_points`` (default ``calib["cohort_operating_points"]``)
    replacing ``thr`` for its rows."""
    cohorts = np.asarray([str(c) for c in cohorts])
    pc = calibrated_probability(prob_raw, cohorts, calib)
    if cohort_points is None:
        cohort_points = calib.get("cohort_operating_points", {})
    thr_vec = np.full(len(pc), float(thr))
    for c, t in (cohort_points or {}).items():
        thr_vec[cohorts == c] = float(t)
    return pc, pc > thr_vec


def evaluate_policy(prob_raw, y, cohorts, calib, thr,
                    cohort_points=None) -> dict:
    """Per-cohort, union and overall test reports at the shipped policy
    (``policy_decisions``)."""
    cohorts = np.asarray([str(c) for c in cohorts])
    pc, stable = policy_decisions(prob_raw, cohorts, calib, thr,
                                  cohort_points)
    pred = stable.astype(np.float64)
    report = {}
    for c in sorted(set(cohorts.tolist())):
        sel = cohorts == c
        report[c] = _binary_report(y[sel], pred[sel], pc[sel])
        report[c]["calibrated"] = c in calib.get("cohorts", {})
    for stem in ("hierarchical", "close_encounter"):
        sel = np.array([c.startswith(stem) for c in cohorts])
        if sel.any():
            report[f"__{stem}_union__"] = _binary_report(
                y[sel], pred[sel], pc[sel])
    report["__overall__"] = _binary_report(y, pred, pc)
    report["__overall__"]["threshold"] = float(thr)
    return report
