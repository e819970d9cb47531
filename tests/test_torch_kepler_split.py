"""PyTorch port vs the JAX package: the Kepler-split tail integrator
(``integrators/kepler_split.py``) and the scan analysis engine that runs
it (``analysis/stability.py::analyze_batch``), on the CPU in float64.

Inputs: the hierarchical triples of ``tests/test_tail_fast_path.py``
(tight inner binaries, a_in 0.01-0.013, and wide triples), numpy-seeded
perturbations, built by each package from the same arrays with the
ham_soft construction and then run under ``integrator_mode=
"kepler_split"``, as the analysis tail does.

* ``pair_timescales_sq`` (one-hots, tau_min^2, tau_second^2), 5
  ``kepler_split_substep`` macro steps with per-system n_sub 1-3 (masked
  trips) and ``split_hamiltonian`` agree to round-off (rtol 1e-10 /
  atol 1e-12), with the fixed LC-8 and the adaptive solver.  The tight
  binaries (two orbits per macro step) amplify a round-off difference
  about 30-fold per step, so the horizon is short: after 20 steps their
  velocities differ by ~5e-9 relative, the wide triples' still by 1e-16.
* The conservation contract of the JAX package's
  ``test_split_map_conservation``: over 500 steps of a dominated triple
  H_fast holds to 1e-8 relative, P to 1e-12, L to 1e-12, and eps and pi
  stay frozen.
* ``analyze_batch`` in full mode (8 steps, 4 MEGNO steps, the JAX
  package's tangents) against ``analyze_batch_jit``: every column and
  the final positions to rtol 1e-10 / atol 1e-12 (the final velocities
  of the tight binaries, 12 steps on, differ by ~3e-9 relative, as
  above).
"""

import functools

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.diagnostics import energy as tE
from nbodysimproject_tpu_torch.integrators import kepler_split as tks
from test_tail_fast_path import _population, hier_triple

RTOL, ATOL = 1e-10, 1e-12


def _triples(seed=7):
    rng = np.random.default_rng(seed)
    ics = [hier_triple(a_in=0.01 * (1 + 0.1 * k)) for k in range(4)]
    ics += [hier_triple(a_in=1.0 + 0.1 * k, a_out=12.0) for k in range(4)]
    return _population([(m, q + rng.normal(0, 1e-5, q.shape), v)
                        for m, q, v in ics], None)


@functools.lru_cache(maxsize=None)
def _built(softening=5e-3):
    """Both packages' builds of the triples under the ham_soft
    construction (built once: the JAX build compiles)."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import build_batch as jbuild

    m, q, v, mask = _triples()
    cj, ct = nb.SimConfig(), nt.SimConfig()
    sj, dj = jbuild(*(jnp.asarray(a) for a in (m, q, v)), jnp.asarray(mask),
                    cj, 1.0, softening, 0.0, 0.01)
    st, dt = nt.build_batch(*(torch.as_tensor(a) for a in (m, q, v, mask)),
                            ct, 1.0, softening, 0.0, 0.01)
    return (cj, sj, dj), (ct, st, dt)


def _build(n_sub, iters=8):
    """The builds with their n_sub replaced, and the kepler_split
    configurations with ``iters`` Laguerre-Conway updates (0: the
    adaptive solver)."""
    import jax.numpy as jnp

    (cj, sj, dj), (ct, st, dt) = _built()
    dj = dj.replace(n_sub=jnp.asarray(n_sub, jnp.int32))
    dt = dt.replace(n_sub=torch.as_tensor(n_sub, dtype=torch.int32))
    mode = dict(integrator_mode="kepler_split", tail_kepler_iters=iters)
    return ((cj.replace(**mode), sj, dj), (ct.replace(**mode), st, dt))


N_SUB = np.array([1, 2, 3, 1, 2, 1, 3, 1])


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(b.numpy() if torch.is_tensor(b) else b,
                               np.asarray(a), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_pair_timescales_match():
    import jax

    from nbodysimproject_tpu.integrators.kepler_split import \
        pair_timescales_sq

    (_cj, sj, dj), (_ct, st, dt) = _build(N_SUB)
    ref = jax.vmap(lambda s, d: pair_timescales_sq(s.pos, s.mass, d.G,
                                                   s.mask))(sj, dj)
    got = tks.pair_timescales_sq(st.pos, st.mass, dt.G, st.mask)
    for k in range(2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    _close(ref[2], got[2], msg="tau_min_sq")
    _close(ref[3], got[3], msg="tau_second_sq")
    # the inner pair is the tightest, members i < j
    assert got[0][:4, 0].all() and got[1][:4, 1].all()


def test_pair_timescales_two_body_and_masked_slot():
    q = torch.tensor([[[0.0, 0.0], [0.01, 0.0], [0.0, 0.0]]],
                     dtype=torch.float64)
    m = torch.tensor([[1.0, 1.0, 0.0]], dtype=torch.float64)
    mask = torch.tensor([[True, True, False]])
    ei, ej, t1, t2 = tks.pair_timescales_sq(q, m, torch.ones(1,
                                                             dtype=q.dtype),
                                            mask)
    assert torch.isfinite(t1).all() and torch.isinf(t2).all()
    assert ei[0].tolist() == [True, False, False]
    assert ej[0].tolist() == [False, True, False]


@pytest.mark.parametrize("iters", [8, 0])
def test_substeps_and_split_hamiltonian_match_float64(iters):
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.integrators.kepler_split import \
        split_hamiltonian
    from nbodysimproject_tpu.parallel import integrate_batch as jint

    (cj, sj, dj), (ct, st, dt) = _build(N_SUB, iters=iters)
    H0j = jax.vmap(lambda s, d: split_hamiltonian(s, d, cj))(sj, dj)
    _close(H0j, tks.split_hamiltonian(st, dt, ct), msg="H_fast")
    _close(H0j, tE.extended_hamiltonian(st, dt, ct), msg="H_ext branch")
    ref = jint(sj, dj, cj, jnp.float64(0.01), 5, 3)
    got = nt.integrate_batch(st, dt, ct, 0.01, 5, 3)
    for name in ("pos", "vel", "eps", "pi", "s", "step_s2"):
        _close(getattr(ref, name), getattr(got, name), msg=name)
    H1j = jax.vmap(lambda s, d: split_hamiltonian(s, d, cj))(ref, dj)
    _close(H1j, tks.split_hamiltonian(got, dt, ct), msg="H_fast after")


def test_split_map_conservation():
    """H_fast, P and L of a dominated triple over 500 steps (the JAX
    package's test_split_map_conservation, with its bounds)."""
    m, q, v = hier_triple()
    cfg = nt.SimConfig(integrator_mode="ham_soft")
    t = lambda a: torch.as_tensor(np.asarray(a)[None])
    st, dy = nt.build_batch(t(m), t(q), t(v), t(np.ones(3, bool)), cfg, 1.0,
                            0.05, 0.0, 0.01)
    cfg = cfg.replace(integrator_mode="kepler_split")
    dy = dy.replace(n_sub=torch.ones(1, dtype=torch.int32))
    H0 = float(tks.split_hamiltonian(st, dy, cfg))
    P0 = (st.mass[..., None] * st.vel).sum(-2)
    L0 = float(tE.angular_momentum_z(st))
    st1 = nt.integrate_batch(st, dy, cfg, 0.01, 500, 1)
    H1 = float(tks.split_hamiltonian(st1, dy, cfg))
    P1 = (st1.mass[..., None] * st1.vel).sum(-2)
    L1 = float(tE.angular_momentum_z(st1))
    assert abs((H1 - H0) / H0) < 1e-8
    assert float((P1 - P0).abs().max()) < 1e-12
    assert abs((L1 - L0) / L0) < 1e-12
    assert torch.equal(st1.eps, st.eps) and torch.equal(st1.pi, st.pi)


def test_scan_engine_matches_analyze_batch_jit():
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.analysis.stability import analyze_batch_jit
    from nbodysimproject_tpu.diagnostics.megno import init_tangent

    from nbodysimproject_tpu_torch.analysis.stability import analyze_batch

    (cj, sj, dj), (ct, st, dt) = _build(N_SUB)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i))(
        jnp.arange(8, dtype=jnp.uint32))
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
