"""Softening constants.

Parity: ``minbody/hamsoft_constants.py:24-38`` — LAMBDA_SOFTENING with
environment-variable override, CHI_EPS, and the LAMBDA_SIGMA_STAR
compatibility alias.
"""

from __future__ import annotations

import os
from typing import Final


def _parse_lambda(default: float = 0.3) -> float:
    raw = os.getenv("LAMBDA_SOFTENING", "")
    try:
        v = float(raw)
        return v if v == v else default
    except (TypeError, ValueError):
        return default


LAMBDA_SOFTENING: Final[float] = _parse_lambda()
CHI_EPS: float = 0.9
LAMBDA_SIGMA_STAR: float = LAMBDA_SOFTENING
