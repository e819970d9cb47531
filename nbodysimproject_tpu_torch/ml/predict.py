"""Stability inference on fresh initial conditions.

Counterpart of ``nbodysimproject_tpu/ml/predict.py``: the product's
headline capability (minbody/README.md:56: ML stability prediction
>= 1e5x faster than direct integration).  Build the pre-integration
feature frame of a new (B, N, d) population without integrating
(``analysis/batch.py::ic_feature_frame``), align it to a trained
model's feature schema, and score it, with the shipped calibration and
per-cohort operating points applied when the caller knows the cohort.

Artifacts read (numpy and ``json`` only; no flax, msgpack or sklearn):
  <prefix>model_metadata.json   feature_names, optimal_threshold,
                                cohort_thresholds, calibration
  <prefix>gbdt_metadata.json    the GBDT's cohort_thresholds and
                                calibration (model="gbdt")
  <prefix>torch.npz             both models' weights and scalers
                                (``ml/artifacts.py``); missing, it raises

The MLP runs on the device in float32 with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` False and
``torch.get_float32_matmul_precision()`` "highest" while it runs); the
GBDT walks its trees on the device in float64 (``ml/gbdt.py``).  The
calibration is numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from ..core.device import resolve_device
from .artifacts import load_artifacts
from .data_utils import ScalerUtils
from .gbdt import TreeEnsemble
from .model_zoo import MLP


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def feature_matrix(df, feature_names):
    """Align a frame (e.g. from ``ic_feature_frame``) to a trained
    model's feature schema; NaN -> 0 exactly like the dataset loader
    (ml/dataset.py)."""
    missing = [c for c in feature_names if c not in df.columns]
    if missing:
        raise ValueError(f"frame is missing model features: {missing}")
    X = df[list(feature_names)].to_numpy(np.float64)
    return np.nan_to_num(X, nan=0.0)


@contextlib.contextmanager
def full_float32_matmul():
    """float32 products without TF32 for the block, the flags restored
    after."""
    prev = (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]


class StabilityPredictor:
    """Score (B, N, d) populations with a trained headline model on
    ``device`` (``None``: the card)."""

    def __init__(self, prefix: str = "data/headline_pre_",
                 model: str = "gbdt", device=None):
        if model not in ("gbdt", "mlp"):
            raise ValueError(f"unknown model kind: {model}")
        self.device = resolve_device(device)
        meta = _load_json(prefix + "model_metadata.json")
        self.feature_names = meta["feature_names"]
        self.threshold = float(meta.get("optimal_threshold", 0.5))
        self.cohort_thresholds = dict(meta.get("cohort_thresholds", {}))
        #: schema v2: per-cohort isotonic curves + one operating point on
        #: the calibrated probability (ml/calibrate.py of the JAX package)
        self.calibration = meta.get("calibration")
        self.model_kind = model
        arrays = load_artifacts(prefix + "torch.npz")
        if not any(k.startswith(model + "_") for k in arrays):
            raise KeyError(f"{prefix}torch.npz holds no {model} model")
        self._scaler = ScalerUtils.rebuild_scaler(
            arrays[f"{model}_scaler_mean"], arrays[f"{model}_scaler_scale"])
        if model == "gbdt":
            gmeta_path = prefix + "gbdt_metadata.json"
            if os.path.exists(gmeta_path):
                gmeta = _load_json(gmeta_path)
                self.cohort_thresholds = dict(
                    gmeta.get("cohort_thresholds", self.cohort_thresholds))
                self.threshold = float(self.cohort_thresholds.get(
                    "__global__", self.threshold))
                self.calibration = gmeta.get("calibration",
                                             self.calibration)
            self._model = TreeEnsemble(arrays, self.device)
        else:
            sd = {k[4:]: torch.from_numpy(v) for k, v in arrays.items()
                  if k.startswith("mlp.")}
            self._model = MLP(sd["fc1.weight"].shape[1])
            self._model.load_state_dict(sd)
            self._model.to(self.device).eval()

    def _logits(self, df) -> torch.Tensor:
        """The model's log-odds of stability on the device: the MLP's
        float32 logit, the GBDT's float64 raw score."""
        X = torch.as_tensor(feature_matrix(df, self.feature_names),
                            device=self.device)
        Xs = self._scaler.transform(X)
        if self.model_kind == "gbdt":
            return self._model.raw_predict(Xs)
        with torch.no_grad(), full_float32_matmul():
            return self._model(Xs.float())[:, 0]

    def raw_score(self, df) -> np.ndarray:
        """The model's log-odds of stability before the sigmoid (for the
        GBDT, sklearn's ``_raw_predict`` bit for bit)."""
        return self._logits(df).cpu().numpy()

    def predict_frame(self, df, cohorts=None, return_raw=False):
        """(prob, is_stable) for a pre-integration feature frame.

        With a ``calibration`` block (schema v2) the probability is the
        cohort-calibrated P(stable | x) (the pooled curve when the cohort
        is unknown or has no curve) and the verdict applies the shipped
        operating point, per cohort where one is shipped; legacy metadata
        applies the per-cohort raw thresholds.  ``return_raw=True`` also
        returns the uncalibrated model probability (the sigmoid of
        ``raw_score``, in the model's dtype)."""
        raw = torch.sigmoid(self._logits(df)).cpu().numpy()
        if self.calibration:
            from .calibrate import calibrated_probability

            prob = calibrated_probability(raw, cohorts, self.calibration)
            thr = float(self.calibration.get("global_threshold",
                                             self.threshold))
            points = self.calibration.get("cohort_operating_points") or {}
            if cohorts is not None and points:
                thr_vec = np.full(len(prob), thr)
                cs = np.asarray([str(c) for c in cohorts])
                for c, t in points.items():
                    thr_vec[cs == c] = float(t)
                out = (prob, prob > thr_vec)
            else:
                out = (prob, prob > thr)
        else:
            thr = np.full(len(raw), self.threshold)
            if cohorts is not None and self.cohort_thresholds:
                thr = np.asarray([
                    float(self.cohort_thresholds.get(str(c),
                                                     self.threshold))
                    for c in cohorts])
            out = (raw, raw > thr)
        return out + (raw,) if return_raw else out

    def predict_population(self, mass, pos, vel, mask, cfg, *, G=1.0,
                           softening=0.05, min_softening=0.0, dt=0.01,
                           cohorts=None):
        """End to end: ICs -> pre-integration features -> (prob,
        is_stable), no integration anywhere, on the predictor's device.
        The headline models expect the slot-padded layout of the
        pipeline generators, n_slots = 8."""
        from ..analysis.batch import ic_feature_frame

        df = ic_feature_frame(mass, pos, vel, mask, cfg, G=G,
                              softening=softening,
                              min_softening=min_softening, dt=dt,
                              device=self.device)
        return self.predict_frame(df, cohorts=cohorts)
