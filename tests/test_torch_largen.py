"""PyTorch port vs the JAX package: the large-N slice on the CPU, in
float64.

* ``largen_rollout`` (``integrators/largen.py``) for the "direct",
  "direct_pallas", "p3m" and "auto" force modes on the numpy-seeded
  clouds of ``tests/test_largen.py`` (N = 96 to 512, 5 to 20 steps):
  positions and velocities within rtol 1e-10 / atol 1e-12 (different
  summation orders, and for P3M torch's and XLA's FFTs), ``n_dropped_max``
  equal.  The JAX side runs the tiled kernel in interpret mode, as its
  own tests do.
* ``make_force_fn`` resolves the cases of
  ``tests/test_largen.py::test_auto_resolution`` to the same engines.
* verlet through ``build_batch`` -> ``integrate_batch`` with
  ``use_pallas_forces=True`` (``pallas_force_min_n=16``; N = 32, B = 2),
  where the JAX package runs the tiled kernel in interpret mode under
  vmap, to rtol 1e-10 / atol 1e-12.
* the many-planet WHFast kick (``wh_interaction_accel``) and 5 substeps
  for ``force_mode`` "direct_pallas" and "p3m" (the star split) on the
  256-planet system of ``tests/test_largen.py::TestWHFastLargeN``, to
  rtol 1e-10 / atol 1e-12 (the kick at 1e-10 of its largest value).
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.integrators import largen as tl
from nbodysimproject_tpu_torch.integrators import whfast as tw

RTOL, ATOL = 1e-10, 1e-12
P3M = dict(pm_grid=128, pm_r_cut_cells=6.0)


def _cloud(N, seed=0, vscale=0.3):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1.0, (N, 2))
    m = np.abs(rng.normal(1, 0.3, N)) / N
    v = rng.normal(0, vscale, (N, 2))
    v -= (m[:, None] * v).sum(0) / m.sum()
    return m, q, v


def _close(ref, got, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("mode,N,steps,seed,extra", [
    ("direct", 128, 20, 1, {}),
    ("direct_pallas", 96, 5, 3, {}),
    ("p3m", 512, 20, 0, P3M),
    ("auto", 256, 10, 4, dict(P3M, pm_auto_min_n=200)),
    ("auto", 200, 5, 5, dict(pm_auto_min_n=1000, pallas_force_min_n=100)),
])
def test_rollout_matches_jax(mode, N, steps, seed, extra):
    import jax.numpy as jnp

    from nbodysimproject_tpu.integrators.largen import largen_rollout

    m, q, v = _cloud(N, seed=seed)
    kw = dict(integrator_mode="verlet", force_mode=mode, **extra)
    qj, vj, ij = largen_rollout(jnp.asarray(q), jnp.asarray(v),
                                jnp.asarray(m), 0.05, 1.0, 1e-3, steps,
                                nb.SimConfig(**kw), interpret=True)
    qt, vt, it = nt.largen_rollout(q, v, m, 0.05, 1.0, 1e-3, steps,
                                   nt.SimConfig(**kw), device="cpu")
    assert qt.device.type == "cpu" and qt.dtype == torch.float64
    _close(qj, qt, msg="pos")
    _close(vj, vt, msg="vel")
    assert int(it.n_dropped_max) == int(ij.n_dropped_max)
    _close(ij.kinetic, it.kinetic, msg="kinetic")


def test_rollout_runs_where_its_tensors_lie():
    m, q, v = (torch.as_tensor(a) for a in _cloud(64, seed=2))
    cfg = nt.SimConfig(force_mode="direct_pallas")
    qt, vt, info = nt.largen_rollout(q, v, m, 0.05, 1.0, 1e-3, 3, cfg)
    assert qt.device.type == "cpu" and torch.isfinite(qt).all()
    assert int(info.n_dropped_max) == 0


def test_auto_resolution():
    cfg = nt.SimConfig(force_mode="auto", pm_auto_min_n=1000,
                       pallas_force_min_n=100)
    assert tl.make_force_fn(cfg, 2000, 2).mode == "p3m"
    assert tl.make_force_fn(cfg, 2000, 3).mode == "direct_pallas"
    assert tl.make_force_fn(cfg, 10, 2).mode == "direct"
    with pytest.raises(ValueError):
        tl.make_force_fn(nt.SimConfig(force_mode="p3m"), 100, 3)
    with pytest.raises(ValueError, match="unknown force_mode"):
        tl.make_force_fn(nt.SimConfig(force_mode="tree"), 100, 2)


def test_verlet_integrate_batch_with_the_tiled_kernel():
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import build_batch as jbuild
    from nbodysimproject_tpu.parallel import integrate_batch as jint

    B, N = 2, 32
    rng = np.random.default_rng(8)
    q = rng.normal(0, 1.0, (B, N, 2))
    v = rng.normal(0, 0.3, (B, N, 2))
    m = rng.uniform(0.5, 1.5, (B, N)) / N
    mask = np.ones((B, N), bool)
    kw = dict(integrator_mode="verlet", use_pallas_forces=True,
              pallas_force_min_n=16)
    cj, ct = nb.SimConfig(**kw), nt.SimConfig(**kw)
    sj, dj = jbuild(*(jnp.asarray(a) for a in (m, q, v, mask)), cj, 1.0,
                    0.05, 0.0, 0.01)
    st, dt = nt.build_batch(*(torch.as_tensor(a) for a in (m, q, v, mask)),
                            ct, 1.0, 0.05, 0.0, 0.01)
    nsm = int(np.asarray(dj.n_sub).max())
    assert np.array_equal(dt.n_sub.numpy(), np.asarray(dj.n_sub))
    ref = jint(sj, dj, cj, jnp.float64(0.01), 5, nsm)
    got = nt.integrate_batch(st, dt, ct, 0.01, 5, nsm)
    _close(ref.pos, got.pos, msg="pos")
    _close(ref.vel, got.vel, msg="vel")


def _planetary(n_planets, seed=0):
    rng = np.random.default_rng(seed)
    n = n_planets + 1
    m = np.full((n,), 1e-4)
    m[0] = 1.0
    a = np.linspace(1.0, 1.0 + 0.5 * n_planets, n - 1)
    th = rng.uniform(0, 2 * np.pi, n - 1)
    q = np.zeros((n, 2))
    v = np.zeros((n, 2))
    q[1:, 0] = a * np.cos(th)
    q[1:, 1] = a * np.sin(th)
    vc = 1.0 / np.sqrt(a)
    v[1:, 0] = -vc * np.sin(th)
    v[1:, 1] = vc * np.cos(th)
    return m, q, v


@pytest.mark.parametrize("force_mode,extra", [
    ("direct_pallas", {}), ("p3m", P3M)])
def test_many_planet_whfast_kick_and_substeps(force_mode, extra):
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.integrators import whfast as jw
    from nbodysimproject_tpu.parallel import build_batch as jbuild

    m, q, v = _planetary(256)
    mask = np.ones((1, len(m)), bool)
    kw = dict(integrator_mode="whfast", force_mode=force_mode,
              whfast_kepler_iters=8, **extra)
    cj, ct = nb.SimConfig(**kw), nt.SimConfig(**kw)
    sj, dj = jbuild(*(jnp.asarray(a[None]) for a in (m, q, v)),
                    jnp.asarray(mask), cj, 1.0, 0.0, 0.0, 0.01)
    st, dt = nt.build_batch(*(torch.as_tensor(a[None]) for a in (m, q, v)),
                            torch.as_tensor(mask), ct, 1.0, 0.0, 0.0, 0.01)
    a_ref = jax.vmap(lambda s, d: jw.wh_interaction_accel(s, d, cj))(sj, dj)
    a_got = tw.wh_interaction_accel(st, dt, ct)
    scale = float(np.abs(np.asarray(a_ref)).max())
    _close(a_ref, a_got, rtol=0.0, atol=RTOL * scale, msg="kick")

    @jax.jit
    def run(s, d):
        def one(s1, d1):
            return jax.lax.fori_loop(
                0, 5, lambda _, x: jw.whfast_substep(x, d1, cj,
                                                     jnp.float64(0.01)), s1)
        return jax.vmap(one)(s, d)

    ref = run(sj, dj)
    got = st
    h = torch.full((1,), 0.01, dtype=torch.float64)
    for _ in range(5):
        got = tw.whfast_substep(got, dt, ct, h)
    _close(ref.pos, got.pos, msg="pos")
    _close(ref.vel, got.vel, msg="vel")
