"""PyTorch port vs the JAX package: WHFast on the CPU.

Inputs: the planetary systems of ``tests/test_pallas_whfast.py`` (a unit
central mass and 1e-3 planets on near-circular orbits at radii 1, 2,
...; N = 3, d = 2, B = 16; numpy-seeded perturbations), built by each
package from the same arrays.

* float64, round-off (rtol 1e-10 / atol 1e-12): the Jacobi transforms,
  ``wh_interaction_accel`` (against the JAX closed form and its
  autodiff form ``wh_interaction_accel_ad``, whose rounding differs:
  rtol 1e-9), and ``build_batch`` -> ``integrate_batch`` / ``step_batch``
  with the adaptive Newton solver (``whfast_kepler_iters=0``, the
  default) and with the fixed-depth LC-8 solver.
* ``force_mode`` other than ``"direct"`` (the large-N slice's routes)
  runs; ``build_batch`` at d = 3 equals the JAX package's in float64;
  P3M at d = 3 raises.

The fused kernel's plain version is held to the JAX Pallas kernel in
``tests/test_torch_whfast_kernel.py``.
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.integrators import whfast as tw
from test_torch_integrate import assert_build_3d_matches

RTOL, ATOL = 1e-10, 1e-12


def _planets(B=16, n=3, d=2, seed=0):
    rng = np.random.default_rng(seed)
    base_q = np.zeros((n, d))
    base_v = np.zeros((n, d))
    for i in range(1, n):
        base_q[i, 0] = float(i)
        base_v[i, 1] = 1.0 / np.sqrt(float(i))
    m = np.concatenate([[1.0], np.full(n - 1, 1e-3)])
    q = base_q[None] + 0.005 * rng.normal(size=(B, n, d))
    v = base_v[None] + 0.005 * rng.normal(size=(B, n, d))
    return (np.broadcast_to(m, (B, n)).copy(), q, v, np.ones((B, n), bool))


def _build(iters, dtype=np.float64, B=16):
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import build_batch as jbuild

    kw = dict(integrator_mode="whfast", whfast_kepler_iters=iters,
              fast_float32=(dtype == np.float32))
    cj, ct = nb.SimConfig(**kw), nt.SimConfig(**kw)
    m, q, v, mask = _planets(B)
    sj, dj = jbuild(*(jnp.asarray(a, dtype) for a in (m, q, v)),
                    jnp.asarray(mask), cj, 1.0, 1e-3, 0.0, 0.01)
    tt = lambda a: torch.as_tensor(np.asarray(a, dtype))
    st, dt = nt.build_batch(tt(m), tt(q), tt(v), torch.as_tensor(mask), ct,
                            1.0, 1e-3, 0.0, 0.01)
    return (cj, sj, dj), (ct, st, dt)


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(b.numpy() if torch.is_tensor(b) else b,
                               np.asarray(a), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_jacobi_transforms_and_round_trip():
    import jax

    from nbodysimproject_tpu.integrators import whfast as jw

    m, q, v, _ = _planets()
    jp, jv = jax.vmap(jw.to_jacobi)(m, q, v)
    tp, tv = tw.to_jacobi(*(torch.as_tensor(a) for a in (m, q, v)))
    _close(jp, tp, msg="jac pos")
    _close(jv, tv, msg="jac vel")
    bp, bv = tw.from_jacobi(torch.as_tensor(m), tp, tv)
    _close(q, bp, rtol=1e-13, atol=1e-14, msg="round trip pos")
    _close(v, bv, rtol=1e-13, atol=1e-14, msg="round trip vel")
    rp, rv = jax.vmap(jw.from_jacobi)(m, np.asarray(jp), np.asarray(jv))
    _close(rp, bp, msg="from_jacobi pos")


def test_interaction_accel_matches_closed_form_and_autodiff():
    import jax

    from nbodysimproject_tpu.integrators import whfast as jw

    (cj, sj, dj), (ct, st, dt) = _build(0)
    got = tw.wh_interaction_accel(st, dt, ct)
    ref = jax.vmap(lambda s, d: jw.wh_interaction_accel(s, d, cj))(sj, dj)
    _close(ref, got, msg="closed form")
    ad = jax.vmap(jw.wh_interaction_accel_ad)(sj, dj)
    _close(ad, got, rtol=1e-9, atol=1e-12, msg="autodiff form")


@pytest.mark.parametrize("iters", [0, 8])
def test_integrate_batch_matches_float64(iters):
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import integrate_batch as jint
    from nbodysimproject_tpu.parallel import step_batch as jstep

    (cj, sj, dj), (ct, st, dt) = _build(iters)
    assert np.array_equal(dt.n_sub.numpy(), np.asarray(dj.n_sub))
    ref = jint(sj, dj, cj, jnp.float64(0.01), 25, 1)
    got = nt.integrate_batch(st, dt, ct, 0.01, 25, 1)
    for name in ("pos", "vel", "s", "step_s2", "hist_sum"):
        _close(getattr(ref, name), getattr(got, name), msg=name)
    ref1 = jstep(sj, dj, cj, jnp.float64(0.01), 1)
    got1 = nt.step_batch(st, dt, ct, 0.01, 1)
    _close(ref1.pos, got1.pos, msg="step_batch pos")
    _close(ref1.vel, got1.vel, msg="step_batch vel")


def test_force_mode_other_than_direct_raises():
    """The many-planet force routes run since the large-N slice: P3M with
    the star split and the tiled kernel give finite states, P3M's equal
    to the JAX package's in float64.  The construction at d = 3 equals
    the JAX package's; P3M at d = 3 still raises."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import integrate_batch as jint
    from nbodysimproject_tpu_torch.integrators.largen import make_force_fn

    (cj, sj, dj), (ct, st, dt) = _build(0, B=4)
    for mode in ("p3m", "direct_pallas"):
        out = nt.integrate_batch(st, dt, ct.replace(force_mode=mode), 0.01,
                                 1, 1)
        assert torch.isfinite(out.pos).all() and torch.isfinite(out.vel).all()
        if mode == "p3m":
            ref = jint(sj, dj, cj.replace(force_mode=mode),
                       jnp.float64(0.01), 1, 1)
            _close(ref.pos, out.pos, msg="p3m pos")
            _close(ref.vel, out.vel, msg="p3m vel")
    assert_build_3d_matches(dict(integrator_mode="whfast",
                                 whfast_kepler_iters=0), *_planets(4, d=3),
                            1e-3)
    with pytest.raises(ValueError, match="d=2 only"):
        make_force_fn(ct.replace(force_mode="p3m"), 3, 3)
