"""PyTorch port vs the JAX package: ``analyze_population`` on the scan
route in float64, held to round-off.

The verlet, yoshida4, WHFast and ham_soft integrators with
``fast_float32=False`` under the dataset pipeline's configuration
otherwise (tail off): none is covered by the fused engine, so every lane
runs the port's scan engine (``timing_out["engine"] == "scan"``).  On
``tests/torch_scan_route.py``'s synthetic population (B = 16, N = 3,
12 steps, 6 MEGNO steps, the JAX tangents in float64), each against the
JAX package's ``analyze_population`` on the CPU: ``is_stable`` equal
row by row, the analysis columns within ``F64_TOL`` (rtol 1e-9, atol
1e-12), the ``initial_*`` features within rtol 1e-12 / atol 1e-14, the
IC, schedule and tag columns (``softening_policy`` among them) exactly.
The same systems in 4 slots with the last masked (mass 0) give the
analysis columns of the 3-slot JAX run within ``F64_TOL``: a masked slot
adds only exact zeros.
"""

import numpy as np
import pytest

import torch_scan_route as sr

CONFIGS = {
    "verlet": dict(integrator_mode="verlet", fast_float32=False),
    "yoshida4": dict(integrator_mode="yoshida4", fast_float32=False),
    "whfast": dict(integrator_mode="whfast", fast_float32=False),
    "ham_soft": dict(fast_float32=False),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def frames(request):
    cfg_kw = CONFIGS[request.param]
    pop = sr.synthetic()
    ref = sr.run_jax(pop, cfg_kw)
    tangent = sr.jax_tangents(pop, cfg_kw)
    tm = {}
    got = sr.run_port(pop, cfg_kw, tangent, timing_out=tm)
    return request.param, cfg_kw, pop, tangent, ref, got, tm


def test_runs_the_scan_engine(frames):
    _name, _kw, _pop, _tan, _ref, _got, tm = frames
    assert tm["engine"] == "scan"
    assert tm["scan_lanes"] == 16 and tm["fused_lanes"] == 0
    assert tm["fused_ms"] == 0.0


def test_analysis_columns_to_round_off(frames):
    _name, _kw, _pop, _tan, ref, got, _tm = frames
    assert got["energy_drift"].dtype == np.float64
    sr.assert_analysis_columns(ref, got, sr.F64_TOL)


def test_other_columns(frames):
    name, _kw, _pop, _tan, ref, got, _tm = frames
    sr.assert_other_columns(ref, got, 1e-12, 1e-14)
    want = "adaptive-ham" if name == "ham_soft" else "static"
    assert (got["softening_policy"] == want).all()


def test_masked_slot_adds_nothing(frames):
    _name, cfg_kw, _pop, tangent, ref, _got, _tm = frames
    got4 = sr.run_port(sr.masked(), cfg_kw, sr.pad_tangents(tangent, 4))
    sr.assert_analysis_columns(ref, got4, sr.F64_TOL)
