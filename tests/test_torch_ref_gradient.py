"""PyTorch port vs the JAX package: the "reference" eps* gradient, the
reference's degeneracy fallback (``eps_grad_mode="reference"``).

* ``ops/eps_model.py::eps_star_and_grad(use_fallback=True)`` (the ham_soft
  scan's evaluation off the card) against the JAX package's XLA
  evaluation of the same name, in float64 to round-off (rtol 1e-10 /
  atol 1e-12), under both clamps, on unmasked 3-body systems: bench.py's
  system perturbed, the clustered systems of
  ``tests/test_torch_eps_kernel.py`` and the sparse geometry of
  ``tests/test_hamsoft_variants.py::_saturated_population`` (drawn here
  with numpy), where the SPH clip saturates and the exact gradient
  degenerates.  The fallback fires on some systems and not on all.
* ``ops/eps_kernels.py::eps_star_and_grad_fused(use_fallback=True)``
  (the plain version, on the CPU) against the JAX eps kernel: at N = 3
  (d = 2 and 3) ``eps_star_and_grad_fused(interpret=True)``; at N = 8
  with masked slots (d = 2 and 3) the body that kernel runs,
  ``pallas_hamsoft._build_physics(...).eps_star_and_grad``, evaluated
  eagerly on the same (1, B) blocks, because interpret mode compiles
  the 8-slot fallback for 3-5 minutes on this CPU.  Tolerances those of
  ``tests/test_torch_eps_kernel.py`` (rtol 1e-6 on eps*, rtol 1e-5 /
  atol 1e-5 on the gradient).
* The reference's fault on masked slots (ROADMAP.md Queue 3): the JAX
  XLA gradient of a system with a zero-mass slot is NaN, so zeroed, so
  in reference mode its fallback takes every such system, where the
  port takes it only where the exact gradient degenerates.  Recorded
  with its size.
"""

import numpy as np
import pytest
import torch

from nbodysimproject_tpu_torch.ops import eps_kernels as ek
from nbodysimproject_tpu_torch.ops import eps_model as tem

import test_torch_eps_kernel as te


def _population(kind, B=16, seed=0, d=2):
    """(q, m, h0, alpha, eps_min, eps_max, mask) of B unmasked 3-body
    systems in float64."""
    rng = np.random.default_rng(seed)
    if kind == "bench":
        base = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]])
        q = base[None] + 0.01 * rng.normal(size=(B, 3, 2))
        h0 = np.full(B, 5e-2)
    elif kind == "saturated":
        base = np.array([[0.0, 0.0], [25.0, 0.0], [0.0, 40.0]])
        q = base[None] + 0.5 * rng.normal(size=(B, 3, 2))
        h0 = np.full(B, 5e-2)
    else:  # clustered
        q = 0.05 * rng.normal(size=(B, 3, 2))
        h0 = rng.uniform(0.05, 0.2, B)
    if d == 3:
        q = np.concatenate([q, 0.05 * rng.normal(size=(B, 3, 1))], -1)
    m = np.broadcast_to(np.array([1.0, 0.5, 0.1]), (B, 3)).copy()
    alpha = rng.uniform(0.01, 0.05, B)
    emin = rng.uniform(0.01, 0.05, B)
    emax = emin * rng.choice([1.01, 10.0, 100.0], B)
    return q, m, h0, alpha, emin, emax, np.ones((B, 3), bool)


def _mixed():
    """The three kinds side by side, so some systems degenerate and
    others do not."""
    parts = [_population(k, seed=i) for i, k in enumerate(
        ("bench", "clustered", "saturated"))]
    return tuple(np.concatenate(x, 0) for x in zip(*parts))


def _jax_xla(args, clamp, use_fallback, lam=0.3):
    import jax

    from nbodysimproject_tpu.ops import eps_model as jem

    f = jax.vmap(lambda q, m, h0, a, lo, hi, mk: jem.eps_star_and_grad(
        q, m, h0=h0, alpha=a, eps_min=lo, eps_max=hi, eta=1.35, clamp=clamp,
        mask=mk, lam_align=lam, use_fallback=use_fallback))
    es, g = f(*args)
    return np.asarray(es), np.asarray(g)


def _port(args, clamp, use_fallback, lam=0.3):
    q, m, h0, alpha, lo, hi, mask = (torch.as_tensor(a) for a in args)
    es, g = tem.eps_star_and_grad(q, m, h0=h0, alpha=alpha, eps_min=lo,
                                  eps_max=hi, eta=1.35, clamp=clamp,
                                  mask=mask, lam_align=lam,
                                  use_fallback=use_fallback)
    return es.numpy(), g.numpy()


@pytest.mark.parametrize("clamp", [False, True])
def test_fallback_matches_xla_float64(clamp):
    args = _mixed()
    es_ref, g_ref = _jax_xla(args, clamp, True)
    es, g = _port(args, clamp, True)
    np.testing.assert_allclose(es, es_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(g, g_ref, rtol=1e-10, atol=1e-12)
    # the fallback fires on some systems and not on all, and where it
    # fires the result is the sign-aligned Omega gradient
    _, g_exact = _port(args, clamp, False)
    fired = np.abs(g - g_exact).max(axis=(1, 2)) > 0
    assert 0 < fired.sum() < len(fired)
    assert np.abs(g_ref).max() > 0.1
    q, m, h0, alpha, lo, hi, mask = (torch.as_tensor(a) for a in args)
    g_fb = tem.aligned_omega_grad(q, m, h0=h0, alpha=alpha, eps_min=lo,
                                  eps_max=hi, eta=1.35, lam_align=0.3,
                                  mask=mask).numpy()
    np.testing.assert_array_equal(g[fired], g_fb[fired])


def _f32(args):
    return tuple(np.asarray(a, np.float32) if a.dtype != bool else a
                 for a in args)


@pytest.mark.parametrize("d,clamp", [(2, False), (3, True)])
def test_plain_kernel_fallback_matches_pallas_interpret_n3(d, clamp):
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pallas_eps import eps_star_and_grad_fused

    parts = [_population(k, seed=i, d=d) for i, k in enumerate(
        ("clustered", "saturated"))]
    args = _f32(tuple(np.concatenate(x, 0) for x in zip(*parts)))
    es_ref, g_ref = eps_star_and_grad_fused(
        *(jnp.asarray(a) for a in args), eta=1.35, clamp=clamp,
        use_fallback=True, lanes=4, interpret=True)
    es, g = ek.eps_star_and_grad_fused(*(torch.as_tensor(a) for a in args),
                                       eta=1.35, clamp=clamp,
                                       use_fallback=True)
    np.testing.assert_allclose(es.numpy(), np.asarray(es_ref), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-5)
    _, g_exact = ek.eps_star_and_grad_fused(
        *(torch.as_tensor(a) for a in args), eta=1.35, clamp=clamp,
        use_fallback=False)
    fired = (g - g_exact).abs().amax((1, 2)) > 0
    assert 0 < int(fired.sum()) < len(fired)


def _kernel_body(args, clamp, use_fallback):
    """What ``_eps_grad_kernel`` computes, evaluated eagerly: the JAX
    kernel's physics closure on (1, B) blocks."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pallas_hamsoft import _build_physics

    q, m, h0, alpha, emin, emax, mask = (jnp.asarray(a) for a in args)
    B, n, d = q.shape
    m_eff = m * mask.astype(jnp.float32)
    pos = [q[:, i, a][None] for i in range(n) for a in range(d)]
    mass = [m_eff[:, i][None] for i in range(n)]
    valid = [x > 0.0 for x in mass]
    inv_m = [jnp.where(v, 1.0 / jnp.maximum(x, 1e-30), 0.0)
             for x, v in zip(mass, valid)]
    a = jnp.minimum(emin, emax)[None]
    b = jnp.maximum(emin, emax)[None]
    flo = jnp.maximum(a, 1e-12)
    cap = jnp.maximum(flo, b)
    one = jnp.ones_like(flo)
    ops = _build_physics(
        n, d, mass, valid, inv_m, one, one, alpha[None], flo, cap, h0[None],
        G=1.0, k_wall=0.0, eta=1.35, jcap=0.02, bexp=5, policy="soft",
        grad_mode="reference" if use_fallback else "exact", lam_align=0.3,
        clamp_bounds=(a, b) if clamp else None)
    es, g = ops.eps_star_and_grad(pos)
    g = jnp.stack([x[0] for x in g], 1).reshape(B, n, d)
    return np.asarray(es[0]), np.asarray(g * mask[:, :, None])


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("clamp", [False, True])
def test_plain_kernel_fallback_matches_kernel_body_n8_masked(d, clamp):
    args = te._inputs(8, 5, clamp, B=16, seed=7)
    if d == 3:
        z = 0.05 * np.random.default_rng(12).normal(size=(16, 8, 1))
        args = (np.concatenate([args[0], z.astype(np.float32)], -1),) \
            + args[1:]
    # spread half of the systems out so the SPH clip saturates there
    q = args[0].copy()
    q[8:] *= np.float32(200.0)
    args = (q,) + args[1:]
    es_ref, g_ref = _kernel_body(args, clamp, True)
    es, g = ek.eps_star_and_grad_fused(*(torch.as_tensor(a) for a in args),
                                       eta=1.35, clamp=clamp,
                                       use_fallback=True)
    np.testing.assert_allclose(es.numpy(), es_ref, rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5, atol=1e-5)
    assert not g.numpy()[~args[-1]].any()  # masked slots carry no gradient
    _, g_exact = ek.eps_star_and_grad_fused(
        *(torch.as_tensor(a) for a in args), eta=1.35, clamp=clamp,
        use_fallback=False)
    fired = (g - g_exact).abs().amax((1, 2)) > 0
    assert 0 < int(fired.sum()) < len(fired)


def test_xla_fallback_takes_every_masked_slot_system():
    """The reference's fault (ROADMAP.md Queue 3) in reference mode: on
    clustered systems with zero-mass slots, where the exact gradient is
    finite and well above the degeneracy threshold, the JAX XLA path's
    gradient is zeroed (its NaN), so it returns the sign-aligned Omega
    gradient on every system; the port returns the exact gradient.  The
    size of the difference: the rows differ by O(1) of their scale."""
    q, m, h0, alpha, lo, hi, mask = (
        np.asarray(a, np.float64) if a.dtype != bool else a
        for a in te._inputs(8, 5, False, B=8, seed=3))
    m = np.where(mask, m, 0.0)  # masked slots carry mass 0, as the dataset's
    args = (q, m, h0, alpha, lo, hi, mask)
    _, g_port_exact = _port(args, False, False)
    _, g_jax_exact = _jax_xla(args, False, False)
    scale = np.abs(g_port_exact).max(axis=(1, 2))
    assert (scale > 0.1).all()
    assert not g_jax_exact.any()
    _, g_port = _port(args, False, True)
    _, g_jax = _jax_xla(args, False, True)
    np.testing.assert_allclose(g_port, g_port_exact, rtol=0, atol=0)
    q, m, h0, alpha, lo, hi, mask = (torch.as_tensor(a) for a in args)
    g_fb = tem.aligned_omega_grad(q, m, h0=h0, alpha=alpha, eps_min=lo,
                                  eps_max=hi, eta=1.35, lam_align=0.3,
                                  mask=mask).numpy()
    np.testing.assert_allclose(g_jax, g_fb, rtol=1e-10, atol=1e-12)
    rel = np.abs(g_jax - g_port).max(axis=(1, 2)) / scale
    assert (rel > 0.1).all(), rel
