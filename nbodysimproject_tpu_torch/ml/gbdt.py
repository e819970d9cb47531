"""The gradient-boosted tree ensemble, evaluated in PyTorch.

In the JAX package the headline GBDT is scikit-learn's
``HistGradientBoostingClassifier``, scored on the host
(``ml/predict.py``).  Here its exported trees (``ml/artifacts.py``) are
walked on the given device in float64: every tree at once, one gather
per level of depth, going left where ``x[f] <= num_threshold`` and by
``missing_go_to_left`` on a NaN, as sklearn's ``_predict_from_raw_data``
does.  The leaf values are added one tree after another in sklearn's
order, starting from the baseline, so the raw scores are sklearn's
``_raw_predict`` bit for bit; the predictor takes their sigmoid.  This
is plain PyTorch: no TPU kernel computes it.
"""

from __future__ import annotations

import numpy as np
import torch


def _max_depth(left, right, is_leaf, n_nodes) -> int:
    """The deepest leaf's depth over all trees (sklearn stores each
    child after its parent)."""
    deepest = 0
    for t in range(left.shape[0]):
        depth = np.zeros(int(n_nodes[t]), np.int64)
        for i in range(int(n_nodes[t])):
            if not is_leaf[t, i]:
                assert left[t, i] > i and right[t, i] > i
                depth[left[t, i]] = depth[right[t, i]] = depth[i] + 1
        deepest = max(deepest, int(depth.max()))
    return deepest


class TreeEnsemble:
    """The exported trees of ``arrays`` (``load_artifacts``' ``gbdt_*``
    keys) on ``device``."""

    def __init__(self, arrays: dict, device):
        a = lambda k: arrays["gbdt_" + k]
        T, M = a("feature_idx").shape
        self.n_trees, self.max_depth = T, _max_depth(
            a("left"), a("right"), a("is_leaf"), a("n_nodes"))
        dev = torch.device(device)
        t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt,
                                          device=dev).reshape(-1)
        # nodes numbered over the whole ensemble: tree t's node i is t*M+i
        offs = (np.arange(T, dtype=np.int64) * M)[:, None]
        self.feature = t(a("feature_idx"), torch.int64)
        self.threshold = t(a("num_threshold"), torch.float64)
        self.missing_left = t(a("missing_go_to_left"), torch.bool)
        self.left = t(a("left") + offs, torch.int64)
        self.right = t(a("right") + offs, torch.int64)
        self.is_leaf = t(a("is_leaf"), torch.bool)
        self.value = t(a("value"), torch.float64)
        self.roots = t(offs, torch.int64)[:, None]
        self.baseline = float(a("baseline")[0])
        self.device = dev

    def raw_predict(self, X: torch.Tensor) -> torch.Tensor:
        """(B,) float64 raw scores of (B, F) float64 features."""
        XT = X.to(self.device, torch.float64).T.contiguous()
        node = self.roots.expand(self.n_trees, XT.shape[1])
        for _ in range(self.max_depth):
            x = XT.gather(0, self.feature[node])
            go_left = torch.where(torch.isnan(x), self.missing_left[node],
                                  x <= self.threshold[node])
            nxt = torch.where(go_left, self.left[node], self.right[node])
            node = torch.where(self.is_leaf[node], node, nxt)
        leaves = self.value[node]
        raw = torch.full((XT.shape[1],), self.baseline, dtype=torch.float64,
                         device=self.device)
        for t in range(self.n_trees):
            raw = raw + leaves[t]
        return raw
