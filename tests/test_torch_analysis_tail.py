"""PyTorch port vs the JAX package: ``analyze_population`` under the
dataset pipeline's configuration unmodified (``_PIPE_CFG`` of
``nbodysimproject_tpu/generators/pipeline.py``, Kepler tail policy
``"kepler"``), on the CPU.

Population: four hierarchical triples with a tight inner binary
(``hier_triple`` of ``tests/test_tail_fast_path.py``, a_in 0.01-0.013)
and four wide triples, numpy-seeded perturbations, softening 5e-3, so
that the binaries' frozen schedules (444-531 substeps, capped at 256)
send them to the tail at n_tail = 1 and the wide triples (n_sub 1) stay
on the fused engine.  Full mode, 20 steps (10 MEGNO steps); the port
gets the JAX package's MEGNO tangents.

* ``tail_fast_path``, ``n_sub`` and ``n_sub_capped`` equal the JAX
  package's, and so do the column names.
* Tail rows agree with the JAX package within the fused-vs-scan ``_TOL``
  plus ten times the row's float32 rounding sensitivity: the distance
  between the port's scan engine on those lanes in float32 and in
  float64.  The binaries sit ~3 from the origin with a separation of
  0.01, so float32 relative coordinates carry ~2e-5 relative error, and
  the MEGNO tangent recurrence over two orbits per step amplifies it:
  on these rows the port's own float32 and float64 runs differ by up to
  8e-6 in energy_drift and 2 in MEGNO (of ~300), more than ``_TOL``
  admits between two float32 implementations.
* Non-tail rows agree with the JAX package within ``_TOL``.
* Non-tail rows are bitwise equal to the port's own run with the tail
  off (the JAX package's contract), and the ``initial_*`` features of
  every row are computed with the ham_soft configuration (bitwise equal
  to the tail-off run's), at 4 steps.
* The tail issued right after the analysis kernel's launch
  (``tail_stream=True``, the default) and after the fused call give
  bitwise-equal frames.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nbodysimproject_tpu_torch as nt
from test_tail_fast_path import _population, hier_triple
from test_torch_analysis import _jax_tangents
from test_torch_hamsoft_kernels import _TOL

T = 20
SOFT = 5e-3
SENS_FACTOR = 10.0


def _pipe_cfgs():
    from nbodysimproject_tpu.generators.pipeline import _PIPE_CFG

    return _PIPE_CFG, nt.SimConfig(**dataclasses.asdict(_PIPE_CFG))


def _mixed(seed=7):
    rng = np.random.default_rng(seed)
    ics = [hier_triple(a_in=0.01 * (1 + 0.1 * k)) for k in range(4)]
    ics += [hier_triple(a_in=1.2 + 0.1 * k, a_out=12.0) for k in range(4)]
    return _population([(m, q + rng.normal(0, 1e-5, q.shape), v)
                        for m, q, v in ics], None)


def _kw(n_steps):
    return dict(G=1.0, softening=SOFT, min_softening=0.0, dt=0.01,
                n_steps=n_steps, mode="full", show_progress=False)


def _port(pop, tangent, cfg, n_steps, **kw):
    return nt.analyze_population(*pop, cfg, device="cpu", tangent=tangent,
                                 **_kw(n_steps), **kw)


def _sensitivity(pop, tangent, cfg, tail, softening=SOFT):
    """|float32 - float64| of the port's scan engine on the tail lanes,
    per column: the float32 rounding floor of those rows."""
    from nbodysimproject_tpu_torch.analysis.batch import (
        _tail_selection, prepare_population)
    from nbodysimproject_tpu_torch.analysis.stability import analyze_batch

    st, dy, n_raw = prepare_population(*pop, cfg, G=np.float64(1.0),
                                       softening=softening,
                                       min_softening=0.0,
                                       dt=0.01, device="cpu")
    sel, n_tail = _tail_selection(st, dy, cfg, n_raw, 0.01)
    assert np.array_equal(sel, tail)
    idx = torch.as_tensor(np.nonzero(sel)[0])
    st, dy = st.take(idx), dy.take(idx).replace(
        n_sub=torch.as_tensor(n_tail[sel].astype(np.int32)))
    tan = tuple(torch.as_tensor(x)[idx] for x in tangent)
    cfg_t = cfg.replace(integrator_mode="kepler_split")

    def f64(x):
        return x.replace(**{f.name: getattr(x, f.name).double()
                            for f in dataclasses.fields(x)
                            if torch.is_floating_point(getattr(x, f.name))})

    n_tr = int(n_tail[sel].max())
    r32, _ = analyze_batch(st, dy, cfg_t, T, 0.01, "full", n_tr, T // 2,
                           tangent=tan)
    r64, _ = analyze_batch(f64(st), f64(dy), cfg_t, T, 0.01, "full", n_tr,
                           T // 2, tangent=tuple(x.double() for x in tan))
    return {k: np.nan_to_num(np.abs(r32[k].double().numpy()
                                    - r64[k].numpy())) for k in r32}


@pytest.fixture(scope="module")
def frames():
    from nbodysimproject_tpu.analysis.batch import analyze_population

    cfg_j, cfg_t = _pipe_cfgs()
    pop = _mixed()
    ref = analyze_population(*pop, cfg_j, **_kw(T))
    tangent = _jax_tangents(*pop, cfg_j)
    tm = {}
    got = _port(pop, tangent, cfg_t, T, timing_out=tm)
    tail = got["tail_fast_path"].to_numpy()
    return dict(pop=pop, tangent=tangent, cfg=cfg_t, ref=ref, got=got,
                timing=tm, sens=_sensitivity(pop, tangent, cfg_t, tail))


def test_pipe_cfg_is_the_dataset_configuration():
    cfg_j, cfg_t = _pipe_cfgs()
    assert cfg_t.analysis_tail_policy == "kepler"
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)


def test_tail_and_schedule_columns_equal(frames):
    ref, got = frames["ref"], frames["got"]
    assert list(got.columns) == list(ref.columns)
    for c in ("tail_fast_path", "n_sub", "n_sub_capped"):
        np.testing.assert_array_equal(got[c].to_numpy(), ref[c].to_numpy(),
                                      err_msg=c)
    tail = got["tail_fast_path"].to_numpy()
    assert tail[:4].all() and not tail[4:].any()
    assert (got["n_sub"].to_numpy()[:4] > 256).all()
    assert frames["timing"]["n_tail"] == 4
    assert frames["timing"]["n_dispatches"] == 2


@pytest.mark.parametrize("col", sorted(_TOL))
def test_tail_rows(frames, col):
    ref, got = frames["ref"], frames["got"]
    tail = got["tail_fast_path"].to_numpy()
    a = ref[col].to_numpy(np.float64)[tail]
    b = got[col].to_numpy(np.float64)[tail]
    fin = np.isfinite(a)
    np.testing.assert_array_equal(np.isfinite(b), fin, err_msg=col)
    rtol, atol = _TOL[col]
    bound = atol + rtol * np.abs(a) + SENS_FACTOR * frames["sens"][col]
    assert (np.abs(b - a)[fin] <= bound[fin]).all(), (col, a, b)


@pytest.mark.parametrize("col", sorted(_TOL))
def test_non_tail_rows(frames, col):
    ref, got = frames["ref"], frames["got"]
    keep = ~got["tail_fast_path"].to_numpy()
    a = ref[col].to_numpy(np.float64)[keep]
    b = got[col].to_numpy(np.float64)[keep]
    fin = np.isfinite(a)
    np.testing.assert_array_equal(np.isfinite(b), fin, err_msg=col)
    rtol, atol = _TOL[col]
    np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=atol,
                               err_msg=col)


def _bitwise(a, b, rows, cols):
    for c in cols:
        x, y = a[c].to_numpy()[rows], b[c].to_numpy()[rows]
        if x.dtype.kind == "f":
            assert np.array_equal(x, y, equal_nan=True), c
        else:
            np.testing.assert_array_equal(x, y, err_msg=c)


def test_non_tail_rows_bitwise_equal_to_the_tail_off_run(frames):
    pop, tan, cfg = frames["pop"], frames["tangent"], frames["cfg"]
    on = _port(pop, tan, cfg, 4)
    off = _port(pop, tan, cfg.replace(analysis_tail_policy="off"), 4)
    tail = on["tail_fast_path"].to_numpy()
    assert tail.any() and "tail_fast_path" not in off.columns
    _bitwise(on, off, ~tail, [c for c in off.columns])
    feats = [c for c in off.columns if c.startswith("initial_")]
    assert len(feats) == 25
    _bitwise(on, off, tail, feats)


def test_tail_stream_and_serial_runs_are_bitwise_equal(frames):
    pop, tan, cfg = frames["pop"], frames["tangent"], frames["cfg"]
    tm = {}
    serial = _port(pop, tan, cfg, 4, tail_stream=False, timing_out=tm)
    on_stream = _port(pop, tan, cfg, 4)
    _bitwise(serial, on_stream, np.ones(len(serial), bool), serial.columns)
    assert tm["fused_ms"] > 0 and tm["tail_ms"] > 0
