"""PyTorch port vs the JAX package at d = 3: construction, the ham_soft
scan, the step metrics, MEGNO and the Kepler-split tail, on the CPU.

Inputs: the first rows of ``data/stability_3d_131k.csv.gz`` (3-5 bodies
in 8 slots, the 3-D dataset's random cohort) whose frozen schedule needs
at most 3 substeps, and hierarchical triples of
``tests/test_tail_fast_path.py`` tilted out of the x-y plane (a tight
inner binary and a wide triple each), with numpy-seeded perturbations.

* ``build_batch`` (ham_soft and verlet construction), the ham_soft scan
  (``integrate_batch``, 4 steps), ``angular_momentum_vector`` and the
  extended Hamiltonian agree with the JAX package in float64 to
  round-off (rtol 1e-10 / atol 1e-12); n_sub exactly.
* ``step_metrics``' vector branch (L_tot, var_L, cos_theta, and every
  other metric) in float64 to round-off, in float32 to rtol 1e-5 /
  atol 1e-6 (a few float32 ulps of two reduction orders; the JAX
  package's floor ``1e-300`` of the tilt's denominator is 0 in float32).
  Systems scaled so that L_tot |L0| ~ 1e-302 hold the floor in float64,
  where it binds.
* ``megno_scan`` with the JAX package's tangents, ``pair_timescales_sq``,
  3 kepler_split macro steps and the scan analysis engine under
  kepler_split (``analyze_batch`` against ``analyze_batch_jit``, full
  mode, 8 steps, 4 MEGNO steps) in float64 to round-off.
"""

import functools
import importlib
import os

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.diagnostics import energy as tE
from nbodysimproject_tpu_torch.diagnostics.metrics import step_metrics
from test_tail_fast_path import hier_triple

JE = importlib.import_module("nbodysimproject_tpu.diagnostics.energy")
RTOL, ATOL = 1e-10, 1e-12
DATA3 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "stability_3d_131k.csv.gz")
N_SLOTS = 8


@functools.lru_cache(maxsize=None)
def dataset_rows_3d(n_rows=16384):
    """(mass, pos, vel, mask, G, softening, min_softening) and the
    dataset's own columns of the first ``n_rows`` rows of the 3-D
    dataset, read as ``chip_smoke.py`` reads them."""
    import pandas as pd

    cols = [f"{p}_{i}" for p in ("mass", "x", "y", "z", "vx", "vy", "vz")
            for i in range(N_SLOTS)]
    df = pd.read_csv(DATA3, comment="#", nrows=n_rows, usecols=cols + [
        "G", "softening", "min_softening", "n_sub", "tail_fast_path",
        "is_stable"])
    get = lambda p: df[[f"{p}_{i}" for i in range(N_SLOTS)]].to_numpy(
        np.float64)
    mass = get("mass")
    mask = np.isfinite(mass)
    clean = lambda a: np.where(np.isfinite(a), a, 0.0)
    pos = clean(np.stack([get(a) for a in ("x", "y", "z")], -1))
    vel = clean(np.stack([get(a) for a in ("vx", "vy", "vz")], -1))
    return (clean(mass), pos, vel, mask, df["G"].to_numpy(np.float64),
            df["softening"].to_numpy(np.float64),
            df["min_softening"].to_numpy(np.float64)), df


def shallow_rows(k=8, n_sub_max=3):
    """The first ``k`` dataset rows whose frozen schedule needs at most
    ``n_sub_max`` substeps."""
    (m, q, v, mask, *_), df = dataset_rows_3d()
    idx = np.nonzero(df["n_sub"].to_numpy() <= n_sub_max)[0][:k]
    return m[idx], q[idx], v[idx], mask[idx]


def tilt(x, inc, node):
    """x (N, 3) rotated by ``node`` about the z axis, then by ``inc``
    about the x axis."""
    ci, si, cn, sn = np.cos(inc), np.sin(inc), np.cos(node), np.sin(node)
    rx = np.array([[1, 0, 0], [0, ci, -si], [0, si, ci]])
    rz = np.array([[cn, -sn, 0], [sn, cn, 0], [0, 0, 1]])
    return x @ (rx @ rz).T


def triples_3d(seed=7):
    """Four tilted hierarchical triples with a tight inner binary and four
    wide ones, 3 slots, perturbed."""
    rng = np.random.default_rng(seed)
    ics = [hier_triple(a_in=0.01 * (1 + 0.1 * k)) for k in range(4)]
    ics += [hier_triple(a_in=1.0 + 0.1 * k, a_out=12.0) for k in range(4)]
    m, q, v = [], [], []
    for k, (mk, qk, vk) in enumerate(ics):
        inc, node = 0.3 + 0.2 * k, 0.5 * k
        pad = lambda x: np.concatenate([x, np.zeros((3, 1))], 1)
        m.append(mk)
        q.append(tilt(pad(qk), inc, node) + rng.normal(0, 1e-5, (3, 3)))
        v.append(tilt(pad(vk), inc, node))
    m, q, v = np.stack(m), np.stack(q), np.stack(v)
    return m, q, v, np.ones(m.shape, bool)


def _builds(ics, mode="ham_soft", dtype=np.float64, softening=5e-2):
    """Both packages' builds of ``ics`` (``softening`` a scalar or one
    per system)."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import build_batch as jbuild

    kw = dict(integrator_mode=mode, fast_float32=dtype == np.float32)
    cj, ct = nb.SimConfig(**kw), nt.SimConfig(**kw)
    m, q, v, mask = ics
    sj, dj = jbuild(*(jnp.asarray(a, dtype) for a in (m, q, v)),
                    jnp.asarray(mask), cj, 1.0, jnp.asarray(softening, dtype),
                    0.0, 0.01)
    tt = lambda a: torch.as_tensor(np.asarray(a, dtype))
    st, dt = nt.build_batch(tt(m), tt(q), tt(v), torch.as_tensor(mask), ct,
                            1.0, tt(softening), 0.0, 0.01)
    return (cj, sj, dj), (ct, st, dt)


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a),
                                  err_msg=f"finiteness: {msg}")
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=atol,
                               err_msg=msg)


def _fields(x):
    import dataclasses

    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


@pytest.mark.parametrize("mode", ["ham_soft", "verlet"])
def test_build_batch_3d_matches_float64(mode):
    (_cj, sj, dj), (_ct, st, dt) = _builds(shallow_rows(), mode)
    assert st.pos.shape == (8, N_SLOTS, 3)
    for name, a in _fields(dj).items():
        if name == "n_sub":
            np.testing.assert_array_equal(dt.n_sub.numpy(), np.asarray(a))
        else:
            _close(a, getattr(dt, name), msg=name)
    for name, a in _fields(sj).items():
        if name == "mask":
            np.testing.assert_array_equal(st.mask.numpy(), np.asarray(a))
        else:
            _close(a, getattr(st, name), msg=name)


def test_hamsoft_scan_and_energy_3d_match_float64():
    """The ham_soft flows (``integrate_batch``, masked 8-slot rows), the L
    vector and the extended Hamiltonian at d = 3."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import integrate_batch as jint

    (cj, sj, dj), (ct, st, dt) = _builds(shallow_rows())
    nsm = int(np.asarray(dj.n_sub).max())
    ref = jint(sj, dj, cj, jnp.float64(0.01), 4, nsm)
    got = nt.integrate_batch(st, dt, ct, 0.01, 4, nsm)
    for name in ("pos", "vel", "eps", "pi", "s", "step_s2"):
        _close(getattr(ref, name), getattr(got, name), msg=name)
    _close(jax.vmap(JE.angular_momentum_vector)(ref),
           tE.angular_momentum_vector(got), msg="L vector")
    _close(jax.vmap(lambda s, d: JE.extended_hamiltonian(s, d, cj))(ref, dj),
           tE.extended_hamiltonian(got, dt, ct), msg="H_ext")


def _metric_states(dtype):
    """Both packages' builds of the shallow rows, a state 4 steps on (the
    port's, copied into the JAX package's), and L0 of the build."""
    import jax
    import jax.numpy as jnp

    (cj, sj, dj), (ct, st, dt) = _builds(shallow_rows(), dtype=dtype)
    L0 = jax.vmap(JE.angular_momentum_vector)(sj)
    nsm = int(dt.n_sub.max())
    st1 = nt.integrate_batch(st, dt, ct, 0.01, 4, nsm)
    sj1 = sj.replace(**{k: jnp.asarray(getattr(st1, k).numpy())
                        for k in ("pos", "vel", "eps", "pi", "s", "step_s2")})
    return (cj, sj1, dj), (ct, st1, dt), L0


def _step_metrics_both(cj, sj, dj, ct, st, dt, L0):
    import jax

    from nbodysimproject_tpu.diagnostics.metrics import \
        step_metrics as jstep_metrics

    ref = jax.vmap(lambda s, d, l0: jstep_metrics(s, d, cj, L0=l0))(sj, dj,
                                                                   L0)
    got = step_metrics(st, dt, ct, L0=torch.as_tensor(np.asarray(L0)))
    return ref, got


@pytest.mark.parametrize("dtype,rtol,atol", [(np.float64, RTOL, ATOL),
                                             (np.float32, 1e-5, 1e-6)])
def test_step_metrics_3d_match(dtype, rtol, atol):
    (cj, sj, dj), (ct, st, dt), L0 = _metric_states(dtype)
    ref, got = _step_metrics_both(cj, sj, dj, ct, st, dt, L0)
    assert set(ref) == set(got)
    for k in sorted(ref):
        assert got[k].dtype == torch.float32 if dtype == np.float32 else True
        _close(ref[k], got[k], rtol, atol, msg=k)
    # the vector branch is exercised: the L vector tilts, var_L is not 0
    assert (np.asarray(ref["cos_theta"]) < 1.0).any()
    assert (np.asarray(ref["var_L"]) > 0.0).all()


def test_step_metrics_3d_float64_tilt_floor():
    """Systems scaled so that L_tot |L0| ~ 1e-302, below the JAX package's
    floor ``1e-300`` of the tilt's denominator: in float64 the floor
    binds (cos_theta ~ 0.01), and the port gives the same values.  (In
    float32 the floor is 0 and never binds: the float32 case above.)"""
    import jax.numpy as jnp

    (cj, sj, dj), (ct, st, dt), L0 = _metric_states(np.float64)
    L0 = np.asarray(L0)
    L_now = tE.angular_momentum_vector(st).numpy()
    den0 = np.linalg.norm(L_now, axis=-1) * np.linalg.norm(L0, axis=-1)
    scale = (1e-302 / den0) ** 0.25
    sc = torch.as_tensor(scale)[:, None, None]
    pos, vel = st.pos * sc, st.vel * sc
    st = st.replace(pos=pos, vel=vel)
    sj = sj.replace(pos=jnp.asarray(pos.numpy()), vel=jnp.asarray(vel.numpy()))
    L0 = L0 * (scale * scale)[:, None]
    ref, got = _step_metrics_both(cj, sj, dj, ct, st, dt, L0)
    a = np.asarray(ref["cos_theta"])
    assert np.isfinite(a).all() and (np.abs(a) < 0.05).all()
    _close(a, got["cos_theta"], msg="cos_theta")


def _tail_builds(n_sub):
    import jax.numpy as jnp

    (cj, sj, dj), (ct, st, dt) = _builds(triples_3d(), softening=5e-3)
    mode = dict(integrator_mode="kepler_split")
    dj = dj.replace(n_sub=jnp.asarray(n_sub, jnp.int32))
    dt = dt.replace(n_sub=torch.as_tensor(n_sub, dtype=torch.int32))
    return (cj.replace(**mode), sj, dj), (ct.replace(**mode), st, dt)


N_SUB = np.array([1, 2, 3, 1, 2, 1, 3, 1])


def test_kepler_split_3d_matches_float64():
    """``pair_timescales_sq``, 3 kepler_split macro steps and the split
    Hamiltonian on the tilted triples (the tight binaries amplify a
    round-off difference about 30-fold a step)."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.integrators.kepler_split import (
        pair_timescales_sq, split_hamiltonian)
    from nbodysimproject_tpu.parallel import integrate_batch as jint
    from nbodysimproject_tpu_torch.integrators import kepler_split as tks

    (cj, sj, dj), (ct, st, dt) = _tail_builds(N_SUB)
    ref = jax.vmap(lambda s, d: pair_timescales_sq(s.pos, s.mass, d.G,
                                                   s.mask))(sj, dj)
    got = tks.pair_timescales_sq(st.pos, st.mass, dt.G, st.mask)
    for k in range(2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    _close(ref[2], got[2], msg="tau_min_sq")
    _close(ref[3], got[3], msg="tau_second_sq")
    out_j = jint(sj, dj, cj, jnp.float64(0.01), 3, 3)
    out_t = nt.integrate_batch(st, dt, ct, 0.01, 3, 3)
    for name in ("pos", "vel", "eps", "pi"):
        _close(getattr(out_j, name), getattr(out_t, name), msg=name)
    H = jax.vmap(lambda s, d: split_hamiltonian(s, d, cj))(out_j, dj)
    _close(H, tks.split_hamiltonian(out_t, dt, ct), msg="H_fast")
    assert np.abs(np.asarray(out_j.pos)[..., 2]).max() > 1.0  # out of plane
    assert np.abs(np.asarray(out_j.vel)[:4, :2, 2]).min() > 0.1


def _jax_keys(B):
    import jax
    import jax.numpy as jnp

    return jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i))(
        jnp.arange(B, dtype=jnp.uint32))


def test_megno_scan_3d_matches_float64():
    """``megno_scan`` on the ham_soft scan with the JAX package's
    tangents, 6 steps on the shallow dataset rows."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.diagnostics.megno import init_tangent
    from nbodysimproject_tpu.diagnostics.megno import megno_scan as jmegno
    from nbodysimproject_tpu_torch.diagnostics.megno import megno_scan

    (cj, sj, dj), (ct, st, dt) = _builds(shallow_rows())
    nsm = int(dt.n_sub.max())
    keys = _jax_keys(8)
    ref = jax.vmap(lambda s, d, k: jmegno(s, d, cj, k, 6, jnp.float64(0.01),
                                          n_sub_max=nsm))(sj, dj, keys)
    dr0, dv0 = jax.vmap(init_tangent)(keys, sj)
    got = megno_scan(st, dt, ct, torch.as_tensor(np.array(dr0)),
                     torch.as_tensor(np.array(dv0)), 6, 0.01, nsm)
    _close(ref[0].pos, got[0].pos, msg="final pos")
    for name, a, b in zip(("MEGNO", "lyapunov_time", "megno_slope_med"),
                          ref[1:], got[1:]):
        _close(a, b, msg=name)


def test_scan_engine_3d_kepler_split_matches_analyze_batch_jit():
    """The tail's engine at d = 3: the vector L0, the |L| drift and the
    tilt, with MEGNO, under kepler_split."""
    import jax

    from nbodysimproject_tpu.analysis.stability import analyze_batch_jit
    from nbodysimproject_tpu.diagnostics.megno import init_tangent
    from nbodysimproject_tpu_torch.analysis.stability import analyze_batch

    import jax.numpy as jnp

    (cj, sj, dj), (ct, st, dt) = _tail_builds(N_SUB)
    keys = _jax_keys(8)
    ref, fin_j = analyze_batch_jit(sj, dj, cj, keys, 8, jnp.float64(0.01),
                                   "full", 3, 4)
    dr0, dv0 = jax.vmap(init_tangent)(keys, sj)
    tan = tuple(torch.as_tensor(np.array(x)) for x in (dr0, dv0))
    got, fin_t = analyze_batch(st, dt, ct, 8, 0.01, "full", 3, 4,
                               tangent=tan)
    assert sorted(got) == sorted(ref)
    for k in sorted(ref):
        _close(ref[k], got[k], msg=k)
    _close(fin_j.pos, fin_t.pos, msg="final pos")

