"""The GBDT that ``chip_smoke.py`` phase 24 (d) walks on the card:
``data/port_gbdt_pre_torch.npz``, the trees the port's ``train_gbdt``
fitted on ``data/stability_131k.csv.gz`` (fast grid, cv 3,
``hold_out_val``), and ``data/port_gbdt_pre_reference.npz``,
scikit-learn's scores of that fit's test split (both written by
``python3 chip_smoke.py --fit-gbdt-reference``).  On the CPU the port's
split and scaler remake the fit's, its ``TreeEnsemble`` gives sklearn's
raw scores bit for bit, their sigmoid sklearn's probabilities bit for
bit, and the port's ROC AUC sklearn's.
"""

import os

import numpy as np
import torch
from scipy.special import expit

from nbodysimproject_tpu_torch.ml import DataUtils
from nbodysimproject_tpu_torch.ml.artifacts import load_artifacts
from nbodysimproject_tpu_torch.ml.calibrate import roc_auc
from nbodysimproject_tpu_torch.ml.dataset import StabilityDataset
from nbodysimproject_tpu_torch.ml.gbdt import TreeEnsemble

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data", "stability_131k.csv.gz")
PREFIX = os.path.join(ROOT, "data", "port_gbdt_pre_")


def test_committed_gbdt_is_sklearns_fit():
    ref = dict(np.load(PREFIX + "reference.npz"))
    arrays = load_artifacts(PREFIX + "torch.npz")
    X, y, names = StabilityDataset.load(DATA, features="pre")
    assert list(names) == list(ref["feature_names"])
    _tr, _va, X_test, _ytr, _yva, y_test, scaler = DataUtils.split_and_scale(
        X, y, test_size=0.15, val_size=0.15, seed=42)
    assert np.array_equal(y_test, ref["y_test"])
    assert np.array_equal(scaler.mean_, arrays["gbdt_scaler_mean"])
    assert np.array_equal(scaler.scale_, arrays["gbdt_scaler_scale"])
    ens = TreeEnsemble(arrays, "cpu")
    raw = ens.raw_predict(torch.as_tensor(X_test)).numpy()
    assert np.array_equal(raw, ref["raw_test"])
    assert np.array_equal(expit(raw), ref["prob_test"])
    auroc = roc_auc(y_test, expit(raw))
    assert auroc == float(ref["auroc"]) and auroc >= 0.97
