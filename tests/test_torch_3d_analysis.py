"""PyTorch port vs the JAX package at d = 3: ``analyze_population`` under
the dataset pipeline's configuration unmodified (``_PIPE_CFG``, Kepler
tail policy on), full mode, on the CPU.

Rows: the first 12 rows of ``data/stability_3d_131k.csv.gz`` whose
frozen schedule needs at most 6 substeps and the first 4 rows the
dataset sent to the Kepler tail (3-5 bodies in 8 slots, masked slots of
mass 0), 20 steps (10 MEGNO steps), the JAX package's MEGNO tangents.

The JAX package on the CPU runs its scan engine, whose XLA eps*
gradient (``ops/eps_model.py``, autodiff through the SPH update
``eta sqrt(m_i / Sigma_i)``) is NaN on every system with a masked slot
of mass 0: the backward of ``sqrt(0)`` is infinite, and the zero
cotangent of the masked body times it is NaN, which reaches every entry
and is then zeroed.  So on these rows its spring impulse is 0.  The JAX
fused kernels (the engine that made the dataset) and the port take the
finite gradient (the port's agrees with a central difference).  Hence:

* ``tail_fast_path``, ``n_sub``, ``n_sub_capped``, the IC columns and
  the column names equal the JAX package's, the ``initial_*`` columns to
  rtol 1e-5 / atol 1e-6 (float32; the softening std, the square root of
  a cancellation residue, to sqrt(eps) of the softening mean).
* The port with its eps* gradient zeroed as the JAX scan engine's is
  (the plain kernels' ``_Physics.eps_star_and_grad`` patched) agrees
  with the JAX package on every row: each column within the
  fused-vs-scan ``_TOL``, ``is_stable`` row by row.  On the tail rows
  the tolerance is widened by ten times the row's float32 rounding
  sensitivity (the port's tail engine in float32 against float64,
  ``tests/test_torch_analysis_tail.py::_sensitivity``), as that file does: their tight binaries turn
  twice a step, and MEGNO amplifies the rounding (27.181 against 27.211
  on the first tail row, 1.1e-3 relative).
* The port as it is agrees with the JAX package, within ``_TOL`` and
  ``is_stable`` row by row, on every row where zeroing the gradient
  does not move the port's own columns beyond ``_TOL``, and these are
  at least 3 of 4 rows; the tail rows (which freeze eps and pi) among
  them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
from test_torch_3d_core import dataset_rows_3d
from test_torch_analysis import _jax_tangents
from test_torch_analysis_tail import SENS_FACTOR, T, _sensitivity
from test_torch_hamsoft_kernels import _TOL


def _rows():
    (m, q, v, mask, G, soft, msoft), df = dataset_rows_3d()
    ns, tail = df["n_sub"].to_numpy(), df["tail_fast_path"].to_numpy(bool)
    idx = np.concatenate([np.nonzero((ns <= 6) & ~tail)[0][:12],
                          np.nonzero(tail)[0][:4]])
    assert (G[idx] == 1.0).all() and (msoft[idx] == 0.0).all()
    return idx, (m[idx], q[idx], v[idx], mask[idx]), soft[idx]


def _kw(soft):
    return dict(G=1.0, softening=soft, min_softening=0.0, dt=0.01,
                n_steps=T, mode="full", show_progress=False)


@pytest.fixture(scope="module")
def frames():
    from nbodysimproject_tpu.analysis.batch import analyze_population
    from nbodysimproject_tpu.generators.pipeline import _PIPE_CFG

    _idx, pop, soft = _rows()
    ref = analyze_population(*pop, _PIPE_CFG, **_kw(soft))
    cfg = nt.SimConfig(**dataclasses.asdict(_PIPE_CFG))
    tan = _jax_tangents(*pop, _PIPE_CFG)
    got = nt.analyze_population(*pop, cfg, device="cpu", tangent=tan,
                                **_kw(soft))
    orig = hk._Physics.eps_star_and_grad

    def zeroed(self, pos):
        es, g = orig(self, pos)
        return es, torch.zeros_like(g)

    hk._Physics.eps_star_and_grad = zeroed
    try:
        zero = nt.analyze_population(*pop, cfg, device="cpu", tangent=tan,
                                     **_kw(soft))
    finally:
        hk._Physics.eps_star_and_grad = orig
    # the tail rows' float32 rounding floor, 0 on the other rows
    tail = got["tail_fast_path"].to_numpy()
    sens = {k: np.zeros(len(tail)) for k in _TOL}
    for k, v in _sensitivity(pop, tan, cfg, tail, softening=soft).items():
        sens[k][tail] = v
    return ref, got, zero, sens


def _outside(a, b, col, sens=None):
    """Rows where b lies outside col's tolerance of a, plus SENS_FACTOR
    times ``sens`` (or differs in finiteness)."""
    rtol, atol = _TOL[col]
    a, b = a[col].to_numpy(np.float64), b[col].to_numpy(np.float64)
    both = np.isfinite(a) & np.isfinite(b)
    err = np.where(both, np.abs(b - a), 0.0)
    widen = 0.0 if sens is None else SENS_FACTOR * sens[col]
    return (err > atol + rtol * np.abs(np.where(both, a, 0.0)) + widen) \
        | (np.isfinite(a) != np.isfinite(b))


def test_schedule_ic_and_feature_columns_equal(frames):
    ref, got, _, _ = frames
    assert list(got.columns) == list(ref.columns)
    tail = got["tail_fast_path"].to_numpy()
    assert tail.sum() == 4 and tail[-4:].all()
    assert "z_0" in got.columns and "vz_7" in got.columns
    for c in ref.columns:
        if c in _TOL:
            continue
        a, b = ref[c].to_numpy(), got[c].to_numpy()
        if c.startswith("initial_"):
            # the softening std is the square root of a cancellation
            # residue: sqrt(eps) of the mean (tests/test_torch_ml_serving.py)
            at = 1e-6 if c != "initial_softening_std" else np.sqrt(
                np.finfo(np.float32).eps) \
                * ref["initial_softening_mean"].to_numpy().max()
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64), rtol=1e-5,
                                       atol=at, err_msg=c)
        elif a.dtype.kind == "f":
            np.testing.assert_array_equal(b, a, err_msg=c)
        else:
            assert (a == b).all(), c


@pytest.mark.parametrize("col", sorted(_TOL))
def test_zeroed_gradient_matches_jax_every_row(frames, col):
    ref, _, zero, sens = frames
    bad = _outside(ref, zero, col, sens)
    assert not bad.any(), (col, np.nonzero(bad)[0], ref[col].to_numpy()[bad],
                           zero[col].to_numpy()[bad])


def _gradient_blind_rows(got, zero):
    """Rows whose columns the eps* gradient moves by less than _TOL."""
    moved = np.zeros(len(got), bool)
    for col in _TOL:
        moved |= _outside(zero, got, col)
    return ~moved


@pytest.mark.parametrize("col", sorted(_TOL))
def test_port_matches_jax_where_the_gradient_is_immaterial(frames, col):
    ref, got, zero, sens = frames
    rows = _gradient_blind_rows(got, zero)
    tail = got["tail_fast_path"].to_numpy()
    assert rows.mean() >= 0.75 and rows[tail].all()
    bad = _outside(ref, got, col, sens) & rows
    assert not bad.any(), (col, np.nonzero(bad)[0])
