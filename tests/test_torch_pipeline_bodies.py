"""PyTorch port vs the JAX package: body counts the dataset rows never
gave the analysis kernels' plain versions.

6- and 7-body polygons (``polygon_batch``) and close encounters
(``generate_population`` at the close-encounter cohort's
hyperparameters), drawn by the JAX package in float32, go through both
packages' ``analyze_population`` under ``_PIPE_CFG`` unmodified, full
mode, 12 steps (6 MEGNO steps; a dozen, as ``tests/test_torch_analysis.py``,
to keep the file under a minute); the port gets the JAX package's MEGNO
tangents.  Of 64 drawn close encounters the test keeps the first four
the tail takes and the four shallowest fused ones (n_sub 21-39; the
deeper ones cost minutes in the CPU plain versions).

Held as ``tests/test_torch_analysis_tail.py`` holds its population: the
tail and schedule columns and the column names equal, ``is_stable`` row
by row, every analysis column within the fused-vs-scan ``_TOL`` plus
ten times the row's rounding sensitivity, which here is measured on
every row as ``chip_smoke.py``'s top-bucket case measures it: how far
the port's own float32 run moves when rerun in float64 or with the body
slots reversed.  The close encounters are chaotic at softening 1e-3,
so two float32 runs of one such row part by far more than ``_TOL``; the
polygons stay within ``_TOL``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.generators import pipeline as tpipe
from test_torch_analysis import _jax_tangents
from test_torch_hamsoft_kernels import _TOL

T = 12
SENS_FACTOR = 10.0


def _pipe_cfgs():
    from nbodysimproject_tpu.generators.pipeline import _PIPE_CFG

    return _PIPE_CFG, tpipe._PIPE_CFG


def _population():
    """(mass, pos, vel, mask, softening) numpy arrays: 6- and 7-body
    polygons and close encounters, drawn by the JAX package."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.generators.ic_generator import (
        generate_population, sample_body_counts)
    from nbodysimproject_tpu.generators.specialized import polygon_batch
    from nbodysimproject_tpu_torch.analysis.batch import (_tail_selection,
                                                          prepare_population)

    k_poly, k_n, k_gen = jax.random.split(jax.random.PRNGKey(12), 3)
    k1, k2 = jax.random.split(k_poly)
    hp = jax.random.uniform(k1, (2, 8), jnp.float32)
    poly = polygon_batch(6 + jax.random.randint(k2, (8,), 0, 2),
                         0.5 + hp[0] * 2.5, hp[1], n_slots=8,
                         dtype=jnp.float32)
    close = generate_population(
        k_gen, sample_body_counts(k_n, 64, (3, 4)), n_slots=8,
        position_scale=0.1, virial_fraction=1.5, perturbation=0.3,
        softening=0.001, dtype=jnp.float32)
    close = [np.asarray(a) for a in close]
    st, dy, n_raw = prepare_population(*close, tpipe._PIPE_CFG,
                                       G=np.float64(1.0), softening=0.001,
                                       min_softening=0.0, dt=0.01,
                                       device="cpu")
    sel, _ = _tail_selection(st, dy, tpipe._PIPE_CFG, n_raw, 0.01)
    fused = np.nonzero(~sel)[0]
    rows = np.concatenate([np.nonzero(sel)[0][:4],
                           fused[np.argsort(n_raw[fused], kind="stable")[:4]]])
    pop = [np.concatenate([np.asarray(a), b[rows]])
           for a, b in zip(poly, close)]
    soft = np.concatenate([np.full(8, 0.05), np.full(len(rows), 0.001)])
    return (*pop, soft.astype(np.float32))


def _kw(soft, n_steps=T):
    return dict(G=1.0, softening=soft, min_softening=0.0, dt=0.01,
                n_steps=n_steps, mode="full", show_progress=False)


def _f64(x):
    return x.replace(**{f.name: getattr(x, f.name).double()
                        for f in dataclasses.fields(x)
                        if torch.is_floating_point(getattr(x, f.name))})


def _sensitivity(pop, soft, tangent, cfg, got):
    """Per row and column, how far the port's own float32 run (``got``)
    moves when rerun in float64 and with the body slots reversed, the
    larger of the two (``chip_smoke.py``'s rounding sensitivity): the
    scan engine under kepler_split on the tail lanes, the fused engine's
    plain version on the others (each row is independent of the lanes
    beside it, so these reruns reproduce ``got`` in float32)."""
    from nbodysimproject_tpu_torch.analysis.batch import (_tail_selection,
                                                          prepare_population)
    from nbodysimproject_tpu_torch.analysis.fused import analyze_batch_fused
    from nbodysimproject_tpu_torch.analysis.stability import analyze_batch

    st, dy, n_raw = prepare_population(*pop, cfg, G=np.float64(1.0),
                                       softening=soft, min_softening=0.0,
                                       dt=0.01, device="cpu")
    sel, n_tail = _tail_selection(st, dy, cfg, n_raw, 0.01)
    assert np.array_equal(sel, got["tail_fast_path"].to_numpy())
    tan = tuple(torch.as_tensor(np.array(x)) for x in tangent)
    out = {}

    def engine(s, d, tn, tail):
        if tail:
            n_tr = int(d.n_sub.max())
            r, _ = analyze_batch(s, d, cfg.replace(
                integrator_mode="kepler_split"), T, 0.01, "full", n_tr,
                T // 2, tangent=tn)
        else:
            r, _ = analyze_batch_fused(s, d, cfg, T, 0.01, "full",
                                       int(d.n_sub.max()), T // 2,
                                       tangent=tn)
        return r

    for tail in (True, False):
        rows = np.nonzero(sel == tail)[0]
        idx = torch.as_tensor(rows)
        s, d, tn = st.take(idx), dy.take(idx), tuple(x[idx] for x in tan)
        if tail:
            d = d.replace(n_sub=torch.as_tensor(
                n_tail[rows].astype(np.int32)))
        r64 = engine(_f64(s), _f64(d), tuple(x.double() for x in tn), tail)
        s_rev = s.replace(mass=s.mass.flip(1), pos=s.pos.flip(1),
                          vel=s.vel.flip(1), mask=s.mask.flip(1))
        r_rev = engine(s_rev, d, tuple(x.flip(1) for x in tn), tail)
        for k in r64:
            a = got[k].to_numpy(np.float64)[rows]
            dist = np.maximum(np.abs(a - r64[k].numpy()),
                              np.abs(a - r_rev[k].double().numpy()))
            out.setdefault(k, np.zeros(len(sel)))[rows] = np.nan_to_num(
                dist)
    return out


@pytest.fixture(scope="module")
def frames():
    from nbodysimproject_tpu.analysis.batch import analyze_population

    cfg_j, cfg_t = _pipe_cfgs()
    *pop, soft = _population()
    ref = analyze_population(*pop, cfg_j, **_kw(soft))
    tangent = _jax_tangents(*pop, cfg_j)
    got = nt.analyze_population(*pop, cfg_t, device="cpu", tangent=tangent,
                                **_kw(soft))
    return dict(pop=pop, ref=ref, got=got,
                tail=got["tail_fast_path"].to_numpy(),
                sens=_sensitivity(pop, soft, tangent, cfg_t, got))


def test_population_shapes(frames):
    got, tail = frames["got"], frames["tail"]
    n = got["n_bodies"].to_numpy()
    assert set(n[:8]) == {6, 7} and set(n[8:]) <= {3, 4}
    assert tail[8:12].all() and not tail[:8].any() and not tail[12:].any()
    for c in ("tail_fast_path", "n_sub", "n_sub_capped"):
        np.testing.assert_array_equal(got[c].to_numpy(),
                                      frames["ref"][c].to_numpy(), err_msg=c)
    assert list(got.columns) == list(frames["ref"].columns)


def test_is_stable_row_by_row(frames):
    np.testing.assert_array_equal(frames["got"]["is_stable"].to_numpy(),
                                  frames["ref"]["is_stable"].to_numpy())


@pytest.mark.parametrize("col", sorted(set(_TOL) - {"is_stable"}))
def test_analysis_columns(frames, col):
    ref, got = frames["ref"], frames["got"]
    a = ref[col].to_numpy(np.float64)
    b = got[col].to_numpy(np.float64)
    fin = np.isfinite(a)
    np.testing.assert_array_equal(np.isfinite(b), fin, err_msg=col)
    rtol, atol = _TOL[col]
    bound = atol + rtol * np.abs(a) + SENS_FACTOR * frames["sens"][col]
    assert (np.abs(b - a)[fin] <= bound[fin]).all(), (col, a, b)

