"""PyTorch port vs the JAX package: ``analyze_population(mode="core")``.

Core mode runs the analysis kernel only: no MEGNO continuation (the
fixed MEGNO 2, Lyapunov time inf and slope 0 of a skipped
continuation) and no ``initial_*`` features.  The port on the CPU (the
analysis kernel's plain version) against the JAX package on the CPU
(its scan engine), on the populations and tolerances of
``test_torch_analysis.py``.
"""

import numpy as np
import pytest

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from test_torch_analysis import CASES, PIPE, T, _raw_population
from test_torch_hamsoft_kernels import _TOL


@pytest.fixture(scope="module", params=sorted(CASES))
def frames(request):
    from nbodysimproject_tpu.analysis.batch import analyze_population

    pop = _raw_population(**CASES[request.param])
    kw = dict(G=1.0, softening=5e-2, min_softening=0.0, dt=0.01, n_steps=T,
              mode="core", show_progress=False)
    ref = analyze_population(*pop, nb.SimConfig(**PIPE), **kw)
    got = nt.analyze_population(*pop, nt.SimConfig(**PIPE), device="cpu",
                                **kw)
    return ref, got


def test_core_same_columns(frames):
    ref, got = frames
    assert list(got.columns) == list(ref.columns)
    assert not any(c.startswith("initial_") for c in got.columns)
    assert (got["mode"] == "core").all()


def test_core_is_stable_row_by_row(frames):
    ref, got = frames
    np.testing.assert_array_equal(got["is_stable"].to_numpy(),
                                  ref["is_stable"].to_numpy())


@pytest.mark.parametrize("col", sorted(set(_TOL) - {"is_stable"}))
def test_core_analysis_column(frames, col):
    ref, got = frames
    a = ref[col].to_numpy(np.float64)
    b = got[col].to_numpy(np.float64)
    np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a),
                                  err_msg=col)
    fin = np.isfinite(a)
    rtol, atol = _TOL[col]
    np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=atol,
                               err_msg=col)
    np.testing.assert_array_equal(b[~fin], a[~fin], err_msg=col)


def test_core_megno_columns_fixed(frames):
    """The skipped continuation's values, in both packages."""
    ref, got = frames
    for frame in (ref, got):
        assert (frame["MEGNO"] == 2.0).all()
        assert np.isinf(frame["lyapunov_time"]).all()
        assert (frame["megno_slope_med"] == 0.0).all()


def test_core_ic_and_schedule_columns_exact(frames):
    ref, got = frames
    cols = [c for c in ref.columns if c not in _TOL]
    assert "n_sub" in cols and "mass_0" in cols
    for c in cols:
        np.testing.assert_array_equal(got[c].to_numpy(), ref[c].to_numpy(),
                                      err_msg=c)
