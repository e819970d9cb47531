"""PyTorch port vs the JAX package: batched construction and integration
(``parallel/batch_engine.py``: ``build_batch`` -> ``integrate_batch`` /
``step_batch``) for verlet, yoshida4 and ham_soft (soft and reflection
barrier policies), d = 2, on the CPU.

Initial conditions are ``bench.py``'s 3-body system (masses
[1.0, 0.5, 0.1]) with 1% Gaussian perturbations drawn with numpy
(B = 16), and a 4-slot population with a masked slot.  Both packages
build their own batch from the same numpy arrays.

* float64: every SimState and DynParams field of the build and the
  final states of 20 macro steps (and one ``step_batch``) agree to
  round-off, rtol 1e-10 / atol 1e-12.
* float32: the final states agree within the tolerances that
  ``tests/test_pallas_batch.py`` holds the fused kernels to against the
  scan (pos rtol 2e-5 / atol 2e-6, vel 2e-5 / 2e-5, eps 1e-5 / 1e-6,
  pi 1e-3 / 5e-5): the same operations in other reduction orders.
* The JAX package's states carry over with ``state_from_numpy`` and
  equal the port's own build (classical and ham_soft fields).
* whfast and kepler_split build and integrate (their parity tests are
  ``test_torch_whfast.py`` and ``test_torch_kepler_split.py``), WHFast
  also on its large-N force routes; the ham_soft scan under the
  "reference" gradient in float64 to round-off.  ``build_batch`` at
  d = 3 (the same systems with a drawn z column) equals the JAX
  package's in float64 to round-off, for whfast, kepler_split and
  ham_soft.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.parallel.batch_engine import (build_batch,
                                                             integrate_batch,
                                                             step_batch)

MODES = {"verlet": dict(integrator_mode="verlet"),
         "yoshida4": dict(integrator_mode="yoshida4"),
         "ham_soft": dict(integrator_mode="ham_soft"),
         "ham_soft_reflection": dict(integrator_mode="ham_soft",
                                     use_soft_barrier=False),
         "verlet_adaptive": dict(integrator_mode="verlet",
                                 adaptive_softening=True)}
TOL32 = {"pos": (2e-5, 2e-6), "vel": (2e-5, 2e-5), "eps": (1e-5, 1e-6),
         "pi": (1e-3, 5e-5)}
STATE_OUT = ("pos", "vel", "eps", "pi", "s", "step_s2",
             "softening_energy_delta", "hist_count", "hist_sum",
             "hist_sumsq")


def _bench_ics(B=16, seed=0):
    rng = np.random.default_rng(seed)
    base_q = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]])
    base_v = np.array([[0.0, 0.0], [0.0, 1.0], [-0.5, 0.0]])
    q = base_q[None] + 0.01 * rng.normal(size=(B, 3, 2))
    v = base_v[None] + 0.01 * rng.normal(size=(B, 3, 2))
    m = np.broadcast_to([1.0, 0.5, 0.1], (B, 3)).copy()
    return m, q, v, np.ones((B, 3), bool)


def _masked_ics(B=8, seed=4):
    rng = np.random.default_rng(seed)
    q = np.zeros((B, 4, 2))
    q[:, :, 0] = np.arange(4) * 0.9
    q += 0.05 * rng.normal(size=q.shape)
    v = 0.3 * rng.normal(size=q.shape)
    m = rng.uniform(0.3, 1.0, (B, 4))
    mask = np.ones((B, 4), bool)
    mask[:, -1] = False
    m[:, -1] = 0.0
    return m, q, v, mask


def _soft(mode):
    return 5e-2 if mode.startswith("ham_soft") else 1e-3


def _build_both(mode, ics, dtype):
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import build_batch as jbuild

    kw = dict(MODES[mode], fast_float32=(dtype == np.float32))
    cj, ct = nb.SimConfig(**kw), nt.SimConfig(**kw)
    m, q, v, mask = ics
    sj, dj = jbuild(*(jnp.asarray(a, dtype) for a in (m, q, v)),
                    jnp.asarray(mask), cj, 1.0, _soft(mode), 0.0, 0.01)
    tt = lambda a: torch.as_tensor(np.asarray(a, dtype))
    st, dt = build_batch(tt(m), tt(q), tt(v), torch.as_tensor(mask), ct,
                         1.0, _soft(mode), 0.0, 0.01)
    return (cj, sj, dj), (ct, st, dt)


def _fields(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def _assert_state(jstate, tstate, names, rtol, atol, tag):
    for name in names:
        a = np.asarray(getattr(jstate, name))
        b = getattr(tstate, name).numpy()
        r, at = (rtol, atol) if not isinstance(rtol, dict) else rtol[name]
        np.testing.assert_allclose(b, a, rtol=r, atol=at,
                                   err_msg=f"{tag}: {name}")


ICS = {"bench": _bench_ics, "masked4": _masked_ics}


def lift_3d(q, v, seed=9):
    """(B, N, 2) positions and velocities with a drawn z column."""
    rng = np.random.default_rng(seed)
    z = lambda x: np.concatenate([x, 0.1 * rng.normal(size=x.shape[:2]
                                                      + (1,))], -1)
    return z(q), z(v)


def assert_build_3d_matches(cfg_kw, m, q3, v3, mask, softening):
    """build_batch at d = 3 in float64 against the JAX package's: every
    DynParams and SimState field to round-off, n_sub exactly."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import build_batch as jbuild

    cj, ct = nb.SimConfig(**cfg_kw), nt.SimConfig(**cfg_kw)
    sj, dj = jbuild(*(jnp.asarray(a) for a in (m, q3, v3)),
                    jnp.asarray(mask), cj, 1.0, softening, 0.0, 0.01)
    t = lambda a: torch.as_tensor(np.asarray(a))
    st, dt = build_batch(t(m), t(q3), t(v3), t(mask), ct, 1.0, softening,
                         0.0, 0.01)
    assert st.pos.shape[-1] == 3
    for name, a in _fields(dj).items():
        b = getattr(dt, name)
        if name == "n_sub":
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10,
                                       atol=1e-12, err_msg=name)
    _assert_state(sj, st, [f for f in _fields(sj) if f != "mask"], 1e-10,
                  1e-12, "build d = 3")


@pytest.mark.parametrize("ics", sorted(ICS))
@pytest.mark.parametrize("mode", ["verlet", "yoshida4", "ham_soft"])
def test_build_batch_matches_float64(mode, ics):
    (_cj, sj, dj), (_ct, st, dt) = _build_both(mode, ICS[ics](), np.float64)
    for name, a in _fields(dj).items():
        b = getattr(dt, name)
        if name == "n_sub":
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10,
                                       atol=1e-12, err_msg=name)
    _assert_state(sj, st, [f for f in _fields(sj) if f != "mask"], 1e-10,
                  1e-12, "build")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_integrate_batch_matches_float64(mode):
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import integrate_batch as jint
    from nbodysimproject_tpu.parallel import step_batch as jstep

    ics = _masked_ics() if mode == "ham_soft" else _bench_ics()
    (cj, sj, dj), (ct, st, dt) = _build_both(mode, ics, np.float64)
    nsm = int(np.asarray(dj.n_sub).max())
    _assert_state(jint(sj, dj, cj, jnp.float64(0.01), 20, nsm),
                  integrate_batch(st, dt, ct, 0.01, 20, nsm), STATE_OUT,
                  1e-10, 1e-12, f"{mode} integrate")
    _assert_state(jstep(sj, dj, cj, jnp.float64(0.01), nsm),
                  step_batch(st, dt, ct, 0.01, nsm), STATE_OUT, 1e-10,
                  1e-12, f"{mode} step")


@pytest.mark.parametrize("mode", ["verlet", "yoshida4", "ham_soft",
                                  "ham_soft_reflection"])
def test_integrate_batch_matches_float32(mode):
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import integrate_batch as jint

    (cj, sj, dj), (ct, st, dt) = _build_both(mode, _bench_ics(), np.float32)
    np.testing.assert_array_equal(dt.n_sub.numpy(), np.asarray(dj.n_sub))
    nsm = int(np.asarray(dj.n_sub).max())
    out = integrate_batch(st, dt, ct, 0.01, 20, nsm)
    assert out.pos.dtype == torch.float32
    _assert_state(jint(sj, dj, cj, jnp.float32(0.01), 20, nsm), out,
                  tuple(TOL32), TOL32, None, f"{mode} float32")


@pytest.mark.parametrize("mode", ["verlet", "ham_soft"])
def test_state_from_numpy_carries_the_jax_build(mode):
    (_cj, sj, dj), (_ct, st, dt) = _build_both(mode, _masked_ics(),
                                               np.float64)
    arrays = {**{k: np.asarray(v) for k, v in _fields(sj).items()},
              **{k: np.asarray(v) for k, v in _fields(dj).items()}}
    s2, d2 = nt.state_from_numpy(arrays)
    assert d2.n_sub.dtype == torch.int32 and s2.mask.dtype == torch.bool
    for mine, carried in ((st, s2), (dt, d2)):
        for name, a in _fields(carried).items():
            b = getattr(mine, name)
            if a.dtype in (torch.bool, torch.int32):
                assert torch.equal(a, b), name
            else:
                torch.testing.assert_close(b, a, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode", ["whfast", "kepler_split"])
def test_unported_modes_raise(mode):
    """Both modes are ported (tests/test_torch_whfast.py and
    tests/test_torch_kepler_split.py hold them to the JAX package) and
    build, integrate and step here, WHFast also on its large-N force
    routes; their construction at d = 3 equals the JAX package's."""
    m, q, v, mask = (torch.as_tensor(a) for a in _bench_ics(B=4))
    cfg = nt.SimConfig(integrator_mode=mode)
    st, dt = build_batch(m, q, v, mask, cfg, 1.0, 1e-3, 0.0, 0.01)
    out = integrate_batch(st, dt, cfg, 0.01, 2, 1)
    assert torch.isfinite(out.pos).all()
    assert torch.isfinite(step_batch(st, dt, cfg, 0.01, 1).vel).all()
    if mode == "whfast":
        out = step_batch(st, dt, cfg.replace(force_mode="p3m"), 0.01, 1)
        assert torch.isfinite(out.pos).all() and torch.isfinite(out.vel).all()
    q3, v3 = lift_3d(q.numpy(), v.numpy())
    assert_build_3d_matches(dict(integrator_mode=mode), m.numpy(), q3, v3,
                            mask.numpy(), 1e-3)


def test_reference_gradient_and_d3_raise():
    """The "reference" gradient, once refused: the ham_soft scan under it
    (its XLA-path fallback) equals the JAX package's over 10 macro steps
    in float64 to round-off, and the fallback changes the run; the
    ham_soft construction at d = 3 equals the JAX package's."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import integrate_batch as jint

    ics = _bench_ics(B=8)
    (cj, sj, dj), (ct, st, dt) = _build_both("ham_soft", ics, np.float64)
    cj = cj.replace(eps_grad_mode="reference")
    ref_cfg = ct.replace(eps_grad_mode="reference")
    nsm = int(np.asarray(dj.n_sub).max())
    out = integrate_batch(st, dt, ref_cfg, 0.01, 10, nsm)
    _assert_state(jint(sj, dj, cj, jnp.float64(0.01), 10, nsm), out,
                  STATE_OUT, 1e-10, 1e-12, "ham_soft reference integrate")
    exact = integrate_batch(st, dt, ct, 0.01, 10, nsm)
    assert not torch.equal(exact.vel, out.vel)
    m, q, v, mask = (torch.as_tensor(a) for a in ics)
    q3, v3 = lift_3d(q.numpy(), v.numpy())
    assert_build_3d_matches(dict(integrator_mode="ham_soft"), m.numpy(), q3,
                            v3, mask.numpy(), 5e-2)


@pytest.mark.parametrize("mode", ["verlet", "ham_soft"])
def test_static_n_sub_integrate_matches_float64(mode):
    """``integrate`` with one static substep count for every system
    (the facade's path) against the JAX package's, vmapped."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.integrators.step import integrate as jintegrate

    from nbodysimproject_tpu_torch.integrators.step import integrate

    (cj, sj, dj), (ct, st, dt) = _build_both(mode, _bench_ics(B=8),
                                             np.float64)
    ref = jax.vmap(lambda s, d: jintegrate(s, d, cj, jnp.float64(0.01), 5,
                                           2))(sj, dj)
    _assert_state(ref, integrate(st, dt, ct, 0.01, 5, 2), STATE_OUT, 1e-10,
                  1e-12, f"{mode} static")
