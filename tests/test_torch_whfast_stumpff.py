"""The WHFast kernel's Stumpff functions as redesigned for the card.

``csrc/whfast.cu::stumpff23`` branches where the Pallas kernel
(``nbodysimproject_tpu/ops/pallas_whfast.py::_stumpff23``) selects: a
TPU lane evaluates the series (|z| <= 0.3) and the closed form for every
z and keeps one, a CUDA thread evaluates only the one it keeps, and a
NaN z takes the closed form (``!(fabsf(z) <= 0.3f)``), as the select
does.  The series runs in Horner form, ten FMAs on float32 reciprocal
factorials, where the JAX source divides by each factorial; the closed
form takes sin and cos of one argument together.  This file models the
device function in numpy float32, an FMA rounded once from its exact
value (``fma``), and holds it, over z in [-50, 50] with the window's
edges +-0.3, their float32 neighbours, 0 and NaN:

* to the port's plain version (``ops/whfast_kernels.py::_stumpff23``,
  PyTorch float32 on the CPU, the JAX source's expressions): within 1
  ulp in the window (Horner with FMAs against five divided terms, each
  rounded once); outside it within 16 rounding units of 1 - c0 (or
  1 - c1) over |z|, the cancellation that sets the closed form's error
  (numpy's and PyTorch's float32 cos, sin and exp differ by an ulp or
  two, and the difference of that from 1 is divided by z);
* to the JAX kernel's own ``_stumpff23`` on the CPU in float32: the same
  two tolerances.  What that run gives, stated here: XLA's CPU build
  rounds the series neither as the five divisions of its source nor as
  products with the reciprocals on a few points of the window (its own
  contraction), within 1 ulp of both; its closed form differs from
  PyTorch's by up to ~40 ulps of the result where 1 - c0 cancels;
* on the card (marker ``cuda``; ``whfast_kernels.stumpff_probe`` runs the
  kernel's own device functions): the branch the kernel takes equals,
  bit for bit and NaN included, the select of its two forms evaluated
  everywhere, so branching changes no value; its series equals the
  Horner model bit for bit at every z; its closed form lies within the
  16 units above of the numpy closed form.

The file imports JAX only in the test that runs it, so the card's test
runs where only PyTorch is installed (``--noconftest``).
"""

import numpy as np
import pytest
import torch

from nbodysimproject_tpu_torch.ops import whfast_kernels as wk

f32, f64 = np.float32, np.float64
#: 1 / k! as float32, as the kernel's constants are rounded
INV = {k: f32(1) / f32(v) for k, v in (
    (6, 6.0), (24, 24.0), (120, 120.0), (720, 720.0), (5040, 5040.0),
    (40320, 40320.0), (362880, 362880.0), (3628800, 3628800.0),
    (39916800, 39916800.0), (479001600, 479001600.0),
    (6227020800, 6227020800.0))}
#: tolerances (see the module note): ulps of the result in the window,
#: rounding units of the cancellation 1 - c0 outside it
WINDOW_ULPS = 1
CLOSED_UNITS = 16


def fma(a, b, c):
    """float32 fma(a, b, c), rounded once from the exact a b + c.  The
    float64 product of float32 operands is exact, the float64 sum t is
    off by e (computed exactly, two-sum); rounding t to float32 then
    rounds a b + c itself unless t lies exactly halfway between two
    float32 values and e != 0, where it rounds toward e instead."""
    a, b, c = (np.asarray(x, f32).astype(f64) for x in (a, b, c))
    with np.errstate(all="ignore"):
        p = a * b
        t = p + c
        bp = t - p
        e = (p - (t - bp)) + (c - bp)
        r = t.astype(f32)
        r64 = r.astype(f64)
        other = np.where(t > r64, np.nextafter(r, f32(np.inf)),
                         np.nextafter(r, f32(-np.inf))).astype(f64)
        mid = (t != r64) & ((r64 + other) / 2 == t) & (e != 0)
        toward_e = np.where(e > 0, np.maximum(r64, other),
                            np.minimum(r64, other)).astype(f32)
    return np.where(mid, toward_e, r)


def series(z):
    """The window's Horner form, as the kernel evaluates it."""
    p = fma(z, -INV[479001600], INV[3628800])
    p = fma(z, p, -INV[40320])
    p = fma(z, p, INV[720])
    p = fma(z, p, -INV[24])
    c2 = fma(z, p, f32(0.5))
    p = fma(z, -INV[6227020800], INV[39916800])
    p = fma(z, p, -INV[362880])
    p = fma(z, p, INV[5040])
    p = fma(z, p, -INV[120])
    c3 = fma(z, p, INV[6])
    return c2, c3


def closed(z):
    """The closed form: cos and sin of sqrt(z) for z > 0, cosh and sinh
    through exp of sqrt(-z) clamped at 88 otherwise."""
    z = np.asarray(z, f32)
    with np.errstate(all="ignore"):
        pos = z > 0
        s_e = np.sqrt(np.where(pos, z, f32(1)))
        s_h = np.sqrt(np.where(pos, f32(1), -z))
        s_h = np.where(s_h > f32(88), f32(88), s_h)
        e_h = np.exp(s_h)
        inv_e = f32(1) / e_h
        c0 = np.where(pos, np.cos(s_e), f32(0.5) * (e_h + inv_e))
        c1 = np.where(pos, np.sin(s_e) / s_e, f32(0.5) * (e_h - inv_e) / s_h)
        return (f32(1) - c0) / z, (f32(1) - c1) / z


def stumpff_branch(z):
    """The device function, one z at a time: the closed form where
    !(|z| <= 0.3), else the series."""
    out = np.empty((2, len(z)), f32)
    for n, x in enumerate(np.asarray(z, f32)):
        c = closed(np.array([x])) if not abs(x) <= f32(0.3) \
            else series(np.array([x]))
        out[:, n] = c[0][0], c[1][0]
    return out[0], out[1]


def _grid():
    edge = f32(0.3)
    pts = [edge, -edge, np.nextafter(edge, f32(1)),
           np.nextafter(-edge, f32(-1)), np.nextafter(edge, f32(0)),
           np.nextafter(-edge, f32(0)), f32(0), f32(np.nan)]
    return np.concatenate([np.linspace(-50, 50, 20001, dtype=f32),
                           np.linspace(-0.3, 0.3, 2001, dtype=f32),
                           np.array(pts, f32)])


def _bits(x):
    return np.ascontiguousarray(x, f32).view(np.uint32)


def _assert_close(got, ref, z, what):
    """WINDOW_ULPS ulps of ref in the window, CLOSED_UNITS rounding units
    of 1 - c0 over |z| outside it; NaN exactly where ref is NaN."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), what)
    fin = ~np.isnan(ref)
    got, ref, z = got[fin], ref[fin], z[fin]
    err = np.abs(np.asarray(got, f64) - np.asarray(ref, f64))
    small = np.abs(z) <= f32(0.3)
    ulp = np.spacing(np.abs(ref)).astype(f64)
    assert (err[small] <= WINDOW_ULPS * ulp[small]).all(), (
        f"{what}: window error {(err[small] / ulp[small]).max():.1f} ulps")
    with np.errstate(over="ignore"):
        c0 = np.cosh(np.sqrt(np.maximum(-np.asarray(z[~small], f64), 0.0)))
    unit = np.spacing(np.maximum(1.0, c0).astype(f32)).astype(f64) \
        / np.abs(np.asarray(z[~small], f64))
    worst = (err[~small] / unit).max()
    assert worst <= CLOSED_UNITS, f"{what}: closed form {worst:.1f} units"


@pytest.mark.parametrize("which", ["port plain", "JAX"])
def test_model_against_the_both_forms_kernels(which):
    z = _grid()
    if which == "port plain":
        ref = [x.numpy() for x in wk._stumpff23(torch.from_numpy(z))]
    else:
        import jax
        import jax.numpy as jnp

        from nbodysimproject_tpu.ops.pallas_whfast import \
            _stumpff23 as jax_stumpff

        with jax.default_device(jax.devices("cpu")[0]):
            ref = [np.asarray(x, f32)
                   for x in jax.jit(jax_stumpff)(jnp.asarray(z))]
    for name, got, r in zip(("c2", "c3"), stumpff_branch(z), ref):
        _assert_close(got, r, z, f"{name} vs {which}")


def test_window_edges_are_continuous():
    """Either side of |z| = 0.3 the two forms agree to the closed form's
    cancellation error, so the branch leaves no step in c2 and c3."""
    e = f32(0.3)
    for x in (e, -e):
        inside = series(np.array([x]))
        outside = closed(np.array([np.nextafter(x, f32(np.sign(x)))]))
        for a, b in zip(inside, outside):
            assert abs(float(a[0]) - float(b[0])) < 1e-6


def _same_bits(got, ref, what):
    """Equal bits, or NaN in both (the card's NaN is another pattern)."""
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan, what)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(ref[~nan]), what)


@pytest.mark.cuda
def test_device_stumpff_is_the_model():
    """The kernel's stumpff23 on the card: its branch is the select of
    its two forms bit for bit, its series the Horner model bit for bit,
    its closed form within CLOSED_UNITS of the numpy closed form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    z = _grid()
    out = wk.stumpff_probe(torch.from_numpy(z).cuda()).cpu().numpy()
    branch, ser, clo = out[:, 0], out[:, 1], out[:, 2]
    small = np.abs(z) <= f32(0.3)
    _same_bits(branch, np.where(small[:, None], ser, clo), "branch")
    out_ = ~small
    for k, name in enumerate(("c2", "c3")):
        _same_bits(ser[:, k], series(z)[k], f"{name} series")
        _assert_close(clo[out_, k], closed(z)[k][out_], z[out_],
                      f"{name} closed form")
