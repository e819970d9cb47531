"""PyTorch port vs the JAX package: ``analyze_population`` on the scan
route under ``_validate_S_only`` (ham_soft with only the spring flow
and one substep a step, ``integrators/hamsoft.py::
strang_substep_cached``'s S-only branch), on ``tests/torch_scan_route.py``'s
synthetic population (B = 16, N = 3, d = 2, 12 steps, 6 MEGNO steps, the
JAX tangents), in float64 and float32, under the rules of
``test_torch_scan_route_d3.py``: ``is_stable`` row by row, the analysis
columns within ``F64_TOL`` (float64) or ``_TOL`` (float32), every lane
on the scan engine.
"""

import pytest

import torch_scan_route as sr
from test_torch_scan_route_d3 import check_case


@pytest.mark.parametrize("fast", [False, True])
def test_s_only_against_jax(fast):
    check_case(sr.synthetic, dict(fast_float32=fast, _validate_S_only=True))
