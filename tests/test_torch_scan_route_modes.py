"""PyTorch port vs the JAX package: the MEGNO scan after the analysis
kernel, mode "minimal" and the early-exit probe; and the engine choice.

On the CPU, against the JAX package's ``analyze_population`` (its scan
engine), under the dataset pipeline's configuration (tail off) with the
JAX tangents:

* ``use_fused_megno=False`` (``tests/torch_scan_route.py``'s synthetic
  population, 12 steps): the port's fused engine runs the analysis
  kernel's plain version and then the MEGNO scan, as the JAX fused
  engine does; every column within the fused-vs-scan ``_TOL``.
* mode "minimal" (the same population): the scan engine; the JAX
  package's columns, ``is_stable`` equal, ``energy_drift`` within
  ``_TOL``.
* the early-exit probe (``early_exit_probe=0.1``,
  ``early_exit_min_n_sub=1`` so that every row is probed, 20 steps so
  the probe runs 10) on ``probe_population``, whose two blown-up rows
  (``analysis_n_sub_cap=2``) are aborted: the ``early_exit`` column
  equal to the JAX package's and true on those rows alone; their drift
  non-finite or above 10 and their chaos columns NaN in both; the
  survivors within ``_TOL`` of the JAX package and bit for bit the
  port's own run without the probe, on the fused engine here and on the
  scan engine under ``use_fused_analysis=False``.

The engine choice is tested in ``tests/test_torch_scan_route_engine.py``.
"""

import numpy as np
import pytest

import torch_scan_route as sr
from test_torch_hamsoft_kernels import _TOL

PROBE = dict(early_exit_probe=0.1, early_exit_min_n_sub=1,
             analysis_n_sub_cap=sr.PROBE_CAP)
PROBE_STEPS = 20


@pytest.fixture(scope="module")
def megno_scan_frames():
    cfg_kw = dict(use_fused_megno=False)
    pop = sr.synthetic()
    tm = {}
    got = sr.run_port(pop, cfg_kw, sr.jax_tangents(pop, cfg_kw),
                      timing_out=tm)
    return sr.run_jax(pop, cfg_kw), got, tm


def test_megno_scan_after_the_analysis_kernel(megno_scan_frames):
    ref, got, tm = megno_scan_frames
    assert tm["engine"] == "fused" and tm["fused_lanes"] == 16
    sr.assert_analysis_columns(ref, got, _TOL)
    sr.assert_other_columns(ref, got, 1e-5, 1e-6)


def test_minimal_mode():
    pop = sr.synthetic()
    tm = {}
    got = sr.run_port(pop, {}, mode="minimal", timing_out=tm)
    ref = sr.run_jax(pop, {}, mode="minimal")
    assert tm["engine"] == "scan" and tm["scan_lanes"] == 16
    assert "MEGNO" not in got.columns and "j_eps_mean" not in got.columns
    sr.assert_analysis_columns(ref, got, _TOL)
    sr.assert_other_columns(ref, got, 1e-5, 1e-6)


@pytest.fixture(scope="module")
def probe_frames():
    pop = sr.probe_population()
    tangent = sr.jax_tangents(pop, PROBE)
    tm = {}
    got = sr.run_port(pop, PROBE, tangent, n_steps=PROBE_STEPS,
                      timing_out=tm)
    ref = sr.run_jax(pop, PROBE, n_steps=PROBE_STEPS)
    plain = sr.run_port(pop, dict(PROBE, early_exit_probe=0.0), tangent,
                        n_steps=PROBE_STEPS)
    return pop, tangent, ref, got, plain, tm


def test_probe_aborts_the_blown_up_rows(probe_frames):
    _pop, _tan, ref, got, _plain, tm = probe_frames
    want = np.zeros(16, bool)
    want[list(sr.PROBE_ROWS)] = True
    np.testing.assert_array_equal(ref["early_exit"].to_numpy(), want)
    np.testing.assert_array_equal(got["early_exit"].to_numpy(), want)
    assert tm["engine"] == "fused" and tm["probe_lanes"] == 16
    assert tm["n_early_exit"] == 2 and tm["fused_lanes"] == 14
    for df in (ref, got):
        drift = df["energy_drift"].to_numpy(np.float64)[want]
        assert (~np.isfinite(drift) | (np.abs(drift) > 10.0)).all()
        for c in sr.CHAOS:
            assert np.isnan(df[c].to_numpy()[want]).all(), c
        assert (df["is_stable"].to_numpy()[want] == 0.0).all()
        assert df["pathological_energy"].to_numpy()[want].all()


def test_probe_survivors_against_jax(probe_frames):
    _pop, _tan, ref, got, _plain, _tm = probe_frames
    keep = ~ref["early_exit"].to_numpy()
    sr.assert_analysis_columns(ref, got, _TOL, rows=keep)
    assert list(got.columns) == list(ref.columns)


def _bitwise_survivors(got, plain):
    keep = ~got["early_exit"].to_numpy()
    assert keep.sum() == 14
    assert [c for c in got.columns if c != "early_exit"] \
        == list(plain.columns)
    for c in plain.columns:
        a, b = plain[c].to_numpy()[keep], got[c].to_numpy()[keep]
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(b, a, err_msg=c)
        else:
            assert (a == b).all(), c


def test_probe_survivors_bitwise_without_the_probe(probe_frames):
    _pop, _tan, _ref, got, plain, _tm = probe_frames
    _bitwise_survivors(got, plain)


def test_probe_on_the_scan_engine(probe_frames):
    pop, tangent, _ref, got_fused, _plain, _tm = probe_frames
    kw = dict(PROBE, use_fused_analysis=False)
    tm = {}
    got = sr.run_port(pop, kw, tangent, n_steps=PROBE_STEPS, timing_out=tm)
    plain = sr.run_port(pop, dict(kw, early_exit_probe=0.0), tangent,
                        n_steps=PROBE_STEPS)
    assert tm["engine"] == "scan" and tm["n_early_exit"] == 2
    np.testing.assert_array_equal(got["early_exit"].to_numpy(),
                                  got_fused["early_exit"].to_numpy())
    _bitwise_survivors(got, plain)
