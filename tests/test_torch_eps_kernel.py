"""PyTorch port vs the JAX package: the (eps*, d eps*/dq) evaluations.

* ``ops/eps_kernels.py::eps_star_and_grad_fused`` (plain version, on the
  CPU) against the JAX Pallas kernel ``ops/pallas_eps.py`` run with
  ``interpret=True``, in float32, under both clamp settings at N = 3
  (the masked 8-slot case is in ``tests/test_torch_eps_kernel_masked.py``,
  which keeps each file's run short).
  Tolerance rtol 1e-6 on eps*, rtol 1e-5 / atol 1e-5 on the gradient
  (whose entries reach ~20): the same truncated-map arithmetic, autograd
  against the hand-written reverse sweep, a few float32 ulps apart.
* ``ops/eps_model.py::eps_star_and_grad`` (the autograd evaluation the
  scan uses off the card) against the JAX package's XLA evaluation in
  float64, to round-off (rtol 1e-12 / atol 1e-12).
* ``production_grad_omega``, the legacy gradient and
  ``integrators/hamsoft.py::grad_eps_target`` in float64, to round-off.
* The "reference" gradient fallback on both routes (the plain kernel
  against the interpret-mode kernel, the autograd evaluation against the
  XLA one in float64); d = 3 at N = 3 against the interpret-mode kernel,
  with the float32 tolerances above.  The other tests pass
  ``use_fallback=False``, the exact gradient.

Positions are drawn clustered (scale 0.05 against smoothing lengths of
0.01-5), so the SPH clip does not saturate everywhere and the gradients
are not all zero.
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.integrators import hamsoft as ths
from nbodysimproject_tpu_torch.ops import eps_kernels as ek
from nbodysimproject_tpu_torch.ops import eps_model as tem
from nbodysimproject_tpu_torch.ops import softening as tsoft

CASES = {"n3": (3, 3), "n8_masked5": (8, 5)}


def _inputs(n, n_valid, clamp, B=16, seed=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = 0.05 * rng.normal(size=(B, n, 2))
    m = rng.uniform(0.2, 1.0, (B, n))
    mask = np.ones((B, n), bool)
    mask[:, n_valid:] = False
    h0 = rng.uniform(0.05, 0.2, B)
    alpha = rng.uniform(0.01, 0.05, B)
    emin = rng.uniform(0.01, 0.05, B)
    emax = emin * 100.0
    if clamp:
        emax[:4] = emin[:4] * 1.01  # lanes where the value clamp saturates
    return tuple(np.asarray(a, dtype) for a in (q, m, h0, alpha, emin,
                                                emax)) + (mask,)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("case,clamp", [("n3", False), ("n3", True)])
def test_fused_plain_matches_pallas_interpret(case, clamp):
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pallas_eps import eps_star_and_grad_fused

    n, n_valid = CASES[case]
    args = _inputs(n, n_valid, clamp)
    es_ref, g_ref = eps_star_and_grad_fused(
        *(jnp.asarray(a) for a in args), eta=1.35, clamp=clamp,
        use_fallback=False, lanes=2, interpret=True)
    es, g = ek.eps_star_and_grad_fused(*(_t(a) for a in args), eta=1.35,
                                       clamp=clamp, use_fallback=False)
    g_ref = np.asarray(g_ref)
    assert np.abs(g_ref).max() > 0.1  # gradients are exercised
    np.testing.assert_allclose(es.numpy(), np.asarray(es_ref), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5, atol=1e-5)
    assert not g.numpy()[~args[-1]].any()  # masked slots carry no gradient


def _xla(args, clamp):
    import jax

    from nbodysimproject_tpu.ops import eps_model as jem

    q, m, h0, alpha, emin, emax, mask = args
    f = jax.vmap(lambda q_, m_, h_, a_, lo, hi, mk: jem.eps_star_and_grad(
        q_, m_, h0=h_, alpha=a_, eps_min=lo, eps_max=hi, eta=1.35,
        clamp=clamp, mask=mk, use_fallback=False))
    es, g = f(q, m, h0, alpha, emin, emax, mask)
    return np.asarray(es), np.asarray(g)


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_evaluation_matches_xla_float64(case, clamp):
    n, n_valid = CASES[case]
    args = _inputs(n, n_valid, clamp, dtype=np.float64)
    es_ref, g_ref = _xla(args, clamp)
    q, m, h0, alpha, emin, emax, mask = (_t(a) for a in args)
    es, g = tem.eps_star_and_grad(q, m, h0=h0, alpha=alpha, eps_min=emin,
                                  eps_max=emax, eta=1.35, clamp=clamp,
                                  mask=mask, use_fallback=False)
    assert np.abs(g_ref).max() > 0.1
    np.testing.assert_allclose(es.numpy(), es_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-12, atol=1e-12)


def test_omega_and_legacy_gradients_match_float64():
    import jax

    from nbodysimproject_tpu.ops import eps_model as jem
    from nbodysimproject_tpu.ops import softening as jsoft

    q, m, h0, alpha, emin, emax, mask = _inputs(8, 5, False,
                                                dtype=np.float64)
    ref_om = jax.vmap(lambda q_, m_, h_, a_, lo, hi, mk:
                      jem.production_grad_omega(
                          q_, m_, h0=h_, alpha=a_, eps_min=lo, eps_max=hi,
                          eta=1.35, mask=mk))(q, m, h0, alpha, emin, emax,
                                              mask)
    got_om = tem.production_grad_omega(_t(q), _t(m), h0=_t(h0),
                                       alpha=_t(alpha), eps_min=_t(emin),
                                       eps_max=_t(emax), eta=1.35,
                                       mask=_t(mask))
    np.testing.assert_allclose(got_om.numpy(), np.asarray(ref_om),
                               rtol=1e-12, atol=1e-12)
    ref_lg = jax.vmap(lambda q_, mk: jsoft.grad_eps_target(
        q_, alpha=1.0, lam=0.3, mask=mk))(q, mask)
    got_lg = tsoft.grad_eps_target(_t(q), lam=0.3, mask=_t(mask))
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(ref_lg),
                               rtol=1e-12, atol=1e-12)


def test_grad_eps_target_matches_float64():
    """The sign-aligned Omega gradient of the ham_soft flows, on a state
    built by each package from the same initial conditions."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.integrators import hamsoft as jhs
    from nbodysimproject_tpu.parallel import build_batch as jbuild

    from nbodysimproject_tpu_torch.parallel.batch_engine import build_batch

    rng = np.random.default_rng(9)
    B, n = 8, 4
    q = 0.3 * rng.normal(size=(B, n, 2))
    v = 0.2 * rng.normal(size=(B, n, 2))
    m = rng.uniform(0.2, 1.0, (B, n))
    mask = np.ones((B, n), bool)
    mask[:, -1] = False
    cfg_j, cfg_t = nb.SimConfig(), nt.SimConfig()
    sj, dj = jbuild(jnp.asarray(m), jnp.asarray(q), jnp.asarray(v),
                    jnp.asarray(mask), cfg_j, 1.0, 0.05, 0.0, 0.01)
    st, dt = build_batch(_t(m), _t(q), _t(v), _t(mask), cfg_t, 1.0, 0.05,
                         0.0, 0.01)
    ref = jax.vmap(lambda s, d: jhs.grad_eps_target(s, d, cfg_j))(sj, dj)
    got = ths.grad_eps_target(st, dt, cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_reference_fallback_and_d3_raise():
    """The "reference" fallback, once refused, on both routes: the plain
    kernel against the JAX Pallas kernel in interpret mode with the
    tolerances above, and the autograd evaluation against the JAX XLA
    evaluation in float64 to round-off, both with ``use_fallback=True``
    on these clustered inputs (where it fires on some systems); d = 3
    (the same inputs with a drawn z column) held to the interpret-mode
    kernel with the tolerances above."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pallas_eps import eps_star_and_grad_fused

    args = _inputs(3, 3, False)
    es_ref, g_ref = eps_star_and_grad_fused(
        *(jnp.asarray(a) for a in args), eta=1.35, clamp=False,
        use_fallback=True, lanes=2, interpret=True)
    es, g = ek.eps_star_and_grad_fused(*(_t(a) for a in args), eta=1.35,
                                       use_fallback=True)
    np.testing.assert_allclose(es.numpy(), np.asarray(es_ref), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-5)
    _, g_exact = ek.eps_star_and_grad_fused(*(_t(a) for a in args),
                                            eta=1.35, use_fallback=False)
    assert bool(((g - g_exact).abs().amax((1, 2)) > 0).any())
    args64 = _inputs(3, 3, False, dtype=np.float64)
    es_x, g_x = _xla_fallback(args64)
    q, m, h0, alpha, emin, emax, mask = (_t(a) for a in args64)
    es, g = tem.eps_star_and_grad(q, m, h0=h0, alpha=alpha, eps_min=emin,
                                  eps_max=emax, eta=1.35, mask=mask,
                                  use_fallback=True)
    np.testing.assert_allclose(es.numpy(), es_x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_x, rtol=1e-12, atol=1e-12)
    z = 0.05 * np.random.default_rng(11).normal(size=args[0].shape[:2] + (1,))
    args3 = (np.concatenate([args[0], z.astype(np.float32)], -1),) + args[1:]
    es_ref, g_ref = eps_star_and_grad_fused(
        *(jnp.asarray(a) for a in args3), eta=1.35, clamp=False,
        use_fallback=False, lanes=2, interpret=True)
    es, g = ek.eps_star_and_grad_fused(*(_t(a) for a in args3), eta=1.35,
                                       use_fallback=False)
    g_ref = np.asarray(g_ref)
    assert g.shape == args3[0].shape and np.abs(g_ref[..., 2]).max() > 0.1
    np.testing.assert_allclose(es.numpy(), np.asarray(es_ref), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5, atol=1e-5)


def _xla_fallback(args):
    import jax

    from nbodysimproject_tpu.ops import eps_model as jem

    q, m, h0, alpha, emin, emax, mask = args
    f = jax.vmap(lambda q_, m_, h_, a_, lo, hi, mk: jem.eps_star_and_grad(
        q_, m_, h0=h_, alpha=a_, eps_min=lo, eps_max=hi, eta=1.35,
        mask=mk, use_fallback=True))
    es, g = f(q, m, h0, alpha, emin, emax, mask)
    return np.asarray(es), np.asarray(g)
