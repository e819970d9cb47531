"""Train/val/test splitting and scaling.

Counterpart of ``nbodysimproject_tpu/ml/data_utils.py`` (parity:
``minbody/data_utils.py:26-89`` and ``minbody/scaler_utils.py``):
``DataUtils.split_and_scale`` (stratified splits, degrading to
unstratified when a class is too small, and a standard scaler fitted on
the training split only) and ``ScalerUtils.rebuild_scaler``, which
rebuilds a scaler from saved statistics.

The JAX package splits with sklearn's ``train_test_split`` (and with
``_np_split``, other rows, where sklearn is absent).  The port needs no
sklearn: ``_train_test_split`` draws sklearn's rows from the same
``np.random.RandomState`` (``ShuffleSplit`` and
``StratifiedShuffleSplit`` with ``_approximate_mode``) everywhere, so it
has no fallback, and the port's
scaler does the arithmetic of sklearn's ``StandardScaler.fit`` (the
corrected two-pass variance of ``_incremental_mean_and_var``), so both
packages give the same rows and statistics bit for bit.
"""

from __future__ import annotations

from math import ceil

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

    def fit(self, X):
        """Mean and standard deviation of each column over its non-NaN
        entries, as sklearn's ``StandardScaler.fit`` computes them (no
        sample weights): the mean from the column sums, the variance by
        the corrected two-pass algorithm, and a scale of 1 for a column
        whose variance is within rounding of 0."""
        X = np.asarray(X, np.float64)
        nan = np.isnan(X)
        total = np.nansum if nan.any() else np.sum
        n = X.shape[0] - total(nan.astype(np.float64), axis=0)
        col_sum = total(X, axis=0)
        self.mean_ = (0.0 + col_sum) / n
        temp = X - col_sum / n
        correction = total(temp, axis=0)
        temp **= 2
        var = total(temp, axis=0)
        var -= correction ** 2 / n
        var = var / n
        eps = np.finfo(np.float64).eps
        constant = var <= n * eps * var + (n * self.mean_ * eps) ** 2
        self.scale_ = np.sqrt(var)
        self.scale_[constant] = 1.0
        return self

    def transform(self, X):
        if isinstance(X, torch.Tensor):
            as_t = lambda a: torch.as_tensor(a, dtype=X.dtype,
                                             device=X.device)
            return (X - as_t(self.mean_)) / as_t(self.scale_)
        return (np.asarray(X, np.float64) - self.mean_) / self.scale_

    def fit_transform(self, X):
        return self.fit(X).transform(X)


class DataUtils:
    @staticmethod
    def split_indices(y, test_size: float = 0.2, val_size: float = 0.2,
                      seed: int = 42):
        """(train, val, test) row indices of ``split_and_scale``'s split
        of labels ``y``: the rows depend only on (len(y), y, the sizes,
        seed)."""
        y = np.asarray(y, dtype=np.float64)

        def split(idx, frac):
            ya = y[idx]
            strat = ya if _stratifiable(ya, frac) else None
            rest, held = _train_test_split(len(idx), frac, seed, strat)
            return idx[rest], idx[held]

        rest, test = split(np.arange(len(y)), test_size)
        train, val = split(rest, val_size / (1.0 - test_size))
        return train, val, test

    @staticmethod
    def split_and_scale(X, y, test_size: float = 0.2, val_size: float = 0.2,
                        seed: int = 42):
        """(X_train, X_val, X_test, y_train, y_val, y_test, scaler).

        Stratified when both classes have >= 2 members in every split
        stage, else unstratified (data_utils.py:34-66)."""
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if len(X) == 0:
            print("[error] empty dataset")
            return None, None, None, None, None, None, None
        tr, va, te = DataUtils.split_indices(y, test_size, val_size, seed)
        scaler = StandardScaler()
        X_train = scaler.fit_transform(X[tr])
        return (X_train, scaler.transform(X[va]), scaler.transform(X[te]),
                y[tr], y[va], y[te], scaler)


def _stratifiable(y, frac) -> bool:
    vals, counts = np.unique(y, return_counts=True)
    if len(vals) < 2:
        return False
    n_small = int(np.floor(len(y) * frac))
    return counts.min() >= 2 and n_small >= len(vals)


def _approximate_mode(class_counts, n_draws, rng):
    """sklearn's ``_approximate_mode``: per-class draws that sum to
    ``n_draws``, the largest remainders first, ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _train_test_split(n, test_size, seed, stratify=None):
    """(train, test) row indices of sklearn's ``train_test_split(...,
    test_size=test_size, random_state=seed, stratify=stratify)`` over
    ``n`` rows: ``ShuffleSplit``'s permutation, or
    ``StratifiedShuffleSplit``'s per-class draws, from
    ``np.random.RandomState(seed)``."""
    n_test = ceil(test_size * n)
    n_train = n - n_test
    rng = np.random.RandomState(seed)
    if stratify is None:
        perm = rng.permutation(n)
        return perm[n_test:n_test + n_train], perm[:n_test]
    classes, y_idx, counts = np.unique(stratify, return_inverse=True,
                                       return_counts=True)
    if counts.min() < 2 or n_train < len(classes) or n_test < len(classes):
        raise ValueError("too few members of a class to stratify")
    class_indices = np.split(np.argsort(y_idx, kind="stable"),
                             np.cumsum(counts)[:-1])
    n_i = _approximate_mode(counts, n_train, rng)
    t_i = _approximate_mode(counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


class ScalerUtils:
    @staticmethod
    def rebuild_scaler(mean, scale) -> StandardScaler:
        """A fitted scaler from saved statistics (scaler_utils.py:20-29)."""
        sc = StandardScaler()
        sc.mean_ = np.asarray(mean, dtype=np.float64)
        sc.scale_ = np.asarray(scale, dtype=np.float64)
        return sc
