"""Gradient-boosted-tree stability classifier.

Counterpart of ``nbodysimproject_tpu/ml/train_lightgbm.py`` (parity:
``minbody/train_lightgbm.py:27-111``): a binary GBDT chosen by
GridSearchCV over leaves x learning rate, stratified k-fold CV, roc_auc
scoring, the test metrics and the artifacts.  lightgbm is absent where
the port runs, so the estimator is sklearn's
``HistGradientBoostingClassifier`` over (max_leaf_nodes [31, 50, 70,
100] x learning_rate [0.01, 0.05, 0.1, 0.2]), as the JAX package takes
when lightgbm is absent.  ``NB_GBDT_GRID=fast`` fits the single known
winner (100 leaves, lr 0.1) and ``NB_GBDT_CV`` overrides the fold count,
as in the JAX package.

Fitting is host sklearn, as in the JAX package.  The fitted trees are
written with ``ml/artifacts.py::gbdt_arrays_from_sklearn`` into
``<prefix>torch.npz`` (``gbdt_*`` keys and ``gbdt_scaler_mean`` /
``gbdt_scaler_scale``; an MLP's arrays in the same file are kept), which
the port's ``StabilityPredictor(prefix, model="gbdt")`` walks on the
device (``ml/gbdt.py``; the feature names from the prefix's
``model_metadata.json``, as for the shipped headline models): nothing
needs sklearn or a pickle to load them.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.seeding import set_global_seed
from .artifacts import gbdt_arrays_from_sklearn, store_artifacts
from .data_utils import DataUtils
from .dataset import StabilityDataset


def _make_estimator_and_grid():
    """(estimator, grid); ``NB_GBDT_GRID=fast``: the single known-good
    configuration (100 leaves, lr 0.1) of the JAX package."""
    from sklearn.ensemble import HistGradientBoostingClassifier

    fast = os.environ.get("NB_GBDT_GRID") == "fast"
    est = HistGradientBoostingClassifier(random_state=42)
    grid = {"max_leaf_nodes": [100] if fast else [31, 50, 70, 100],
            "learning_rate": [0.1] if fast else [0.01, 0.05, 0.1, 0.2]}
    return est, grid


def train_gbdt(csv_path: str = "stability_data.csv", cv: int = 5,
               prefix: str = "", features: str = "all",
               hold_out_val: bool = False, return_probs: bool = False):
    """Train the GBDT.  ``hold_out_val=True`` keeps the validation split
    out of the fit so operating thresholds can be calibrated on it; the
    default refits on train+val like the reference's direct split.
    ``return_probs=True`` returns (metrics, extras) with the val/test
    probabilities for downstream calibration (and the fitted ``model``)."""
    from sklearn.metrics import (accuracy_score, balanced_accuracy_score,
                                 f1_score, precision_score, recall_score,
                                 roc_auc_score)
    from sklearn.model_selection import GridSearchCV, StratifiedKFold

    X, y, feature_names = StabilityDataset.load(csv_path, features=features)
    if len(X) == 0:
        print("[error] No data loaded")
        return None

    out = DataUtils.split_and_scale(X, y, test_size=0.15, val_size=0.15,
                                    seed=42)
    X_train, X_val, X_test, y_train, y_val, y_test, scaler = out

    if hold_out_val:
        X_fit, y_fit = X_train, y_train
    else:
        X_fit = np.concatenate([X_train, X_val])
        y_fit = np.concatenate([y_train, y_val])

    est, grid = _make_estimator_and_grid()
    cv = int(os.environ.get("NB_GBDT_CV", cv))
    n_splits = min(cv, max(2, int(min(np.sum(y_fit == 0),
                                      np.sum(y_fit == 1)))))
    gs = GridSearchCV(est, grid, scoring="roc_auc",
                      cv=StratifiedKFold(n_splits=n_splits, shuffle=True,
                                         random_state=42),
                      n_jobs=-1)
    gs.fit(X_fit, y_fit)
    print(f"Best params: {gs.best_params_}  (cv roc_auc={gs.best_score_:.4f})")

    model = gs.best_estimator_
    probs = model.predict_proba(X_test)[:, 1]
    preds = (probs > 0.5).astype(int)
    metrics = dict(
        accuracy=float(accuracy_score(y_test, preds)),
        precision=float(precision_score(y_test, preds, zero_division=0)),
        recall=float(recall_score(y_test, preds, zero_division=0)),
        f1=float(f1_score(y_test, preds, zero_division=0)),
        auroc=float(roc_auc_score(y_test, probs)) if len(set(y_test)) > 1
        else float("nan"),
    )
    metrics["balanced_accuracy"] = float(
        balanced_accuracy_score(y_test, preds))
    print("Test metrics:", {k: round(v, 4) for k, v in metrics.items()})

    arrays = {f"gbdt_{k}": v
              for k, v in gbdt_arrays_from_sklearn(model).items()}
    arrays["gbdt_scaler_mean"] = np.asarray(scaler.mean_, np.float64)
    arrays["gbdt_scaler_scale"] = np.asarray(scaler.scale_, np.float64)
    store_artifacts(prefix + "torch.npz", arrays, "gbdt")
    print(f"Model + scaler saved to {prefix}torch.npz")
    if return_probs:
        extras = dict(prob_val=model.predict_proba(X_val)[:, 1],
                      y_val=y_val, prob_test=probs, y_test=y_test,
                      model=model)
        return metrics, extras
    return metrics


def main():
    set_global_seed(42)
    return train_gbdt()


if __name__ == "__main__":
    main()
