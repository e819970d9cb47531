"""Feature scaling for serving.

Counterpart of the serving half of ``nbodysimproject_tpu/ml/data_utils.py``
(parity: ``minbody/scaler_utils.py``): a standard scaler and
``ScalerUtils.rebuild_scaler``, which rebuilds one from saved
statistics.  The port's scaler is its own and never sklearn's, so a
model loads where sklearn is absent.  Fitting it and
``DataUtils.split_and_scale`` are training and are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


class StandardScaler:
    """(X - mean_) / scale_, the sklearn arithmetic: on numpy arrays in
    float64, and on tensors in their own dtype on their own device
    (float64 gives numpy's bits, since both are IEEE subtraction and
    division)."""

    def __init__(self):
        self.mean_ = None
        self.scale_ = None

    def transform(self, X):
        if isinstance(X, torch.Tensor):
            as_t = lambda a: torch.as_tensor(a, dtype=X.dtype,
                                             device=X.device)
            return (X - as_t(self.mean_)) / as_t(self.scale_)
        return (np.asarray(X, np.float64) - self.mean_) / self.scale_


class ScalerUtils:
    @staticmethod
    def rebuild_scaler(mean, scale) -> StandardScaler:
        """A fitted scaler from saved statistics (scaler_utils.py:20-29)."""
        sc = StandardScaler()
        sc.mean_ = np.asarray(mean, dtype=np.float64)
        sc.scale_ = np.asarray(scale, dtype=np.float64)
        return sc
