"""Per-cohort probability calibration, the serving half.

Counterpart of ``apply_curve`` and ``calibrated_probability`` in
``nbodysimproject_tpu/ml/calibrate.py`` (whose docstring describes the
shipped ``calibration`` block, schema_version 2): isotonic curves stored
as interpolation breakpoints, applied with ``np.interp`` on the host in
float64.  The fitting functions are training and are not ported yet.
"""

from __future__ import annotations

import numpy as np


def apply_curve(prob, curve) -> np.ndarray:
    x = np.asarray(curve["x"], np.float64)
    yv = np.asarray(curve["y"], np.float64)
    if len(x) == 0:
        return np.asarray(prob, np.float64)
    return np.interp(np.asarray(prob, np.float64), x, yv)


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
