"""PyTorch port vs the JAX package: the composition kernel (Verlet and
Yoshida4 multi-step).

On the CPU ``nbodysimproject_tpu_torch.ops.batch_kernels`` runs its plain
PyTorch version.  It is held against the JAX Pallas kernel
``ops/pallas_batch.py::composition_multistep`` run with
``interpret=True`` on ``tests/test_pallas_batch.py``'s population
(N = 3, d = 2, B = 16, numpy seed 0, softening 1e-3):

* in float32, 40 steps: rtol 1e-5 / atol 1e-6 — both run the same
  operation sequence, so they differ only where XLA's CPU rsqrt and
  PyTorch's round differently, a few float32 ulps carried through 40
  steps of a 3-body orbit;
* in float64, 40 steps, against the JAX package's own scan engine
  (``integrate_batch``): rtol 1e-7 / atol 1e-8, the tolerance of
  ``tests/test_pallas_batch.py::test_matches_xla_scan`` (the kernel's
  stage coefficients are rounded to float32, as in the TPU kernel).

The same comparisons run at other body counts and in 3-D, on a ring
population (``_ring_population``: N bodies on a ring of radius 1.5 plus
0.01 noise, masses linspace(1, 0.1), velocities 0.3 normal, numpy seed
1, softening 1e-3 through the JAX ``build_batch``): against the
interpret-mode kernel in float32 at (N, d) in ``SHAPES``, 20 steps, with
the same tolerances, and against ``integrate_batch`` in float64 at
N = 8, d = 3.

The CUDA kernel is held against this plain version on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
from nbodysimproject_tpu_torch.ops import batch_kernels as bk

SCHEMES = ("verlet", "yoshida4")
#: (N, d) of the ring-population cases
SHAPES = ((3, 2), (4, 2), (8, 3))


def _population(B=16, n=3, d=2, seed=0, dtype=np.float64):
    """tests/test_pallas_batch.py's population, built by the JAX package."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import build_batch

    cfg = nb.SimConfig(integrator_mode="verlet")
    rng = np.random.default_rng(seed)
    base_q = np.zeros((n, d))
    base_q[1, 0] = 1.0
    base_q[2, 1] = 2.0
    q = base_q[None] + 0.01 * rng.normal(size=(B, n, d))
    m = np.broadcast_to(np.linspace(1.0, 0.1, n), (B, n)).copy()
    v = rng.normal(size=(B, n, d)) * 0.3
    mask = np.ones((B, n), bool)
    f = lambda a: jnp.asarray(a, dtype)
    return cfg, build_batch(f(m), f(q), f(v), jnp.asarray(mask), cfg, 1.0,
                            1e-3, 0.0, 0.01)


def _ring_population(n, d, B=16, seed=1, dtype=np.float64):
    """N bodies on a ring of radius 1.5 (in the x-y plane) plus 0.01
    noise, masses linspace(1, 0.1), velocities 0.3 normal; built by the
    JAX package with softening 1e-3."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import build_batch

    cfg = nb.SimConfig(integrator_mode="verlet")
    rng = np.random.default_rng(seed)
    ang = 2.0 * np.pi * np.arange(n) / n
    base = np.zeros((n, d))
    base[:, 0], base[:, 1] = 1.5 * np.cos(ang), 1.5 * np.sin(ang)
    q = base[None] + 0.01 * rng.normal(size=(B, n, d))
    m = np.broadcast_to(np.linspace(1.0, 0.1, n), (B, n)).copy()
    v = 0.3 * rng.normal(size=(B, n, d))
    mask = np.ones((B, n), bool)
    f = lambda a: jnp.asarray(a, dtype)
    return cfg, build_batch(f(m), f(q), f(v), jnp.asarray(mask), cfg, 1.0,
                            1e-3, 0.0, 0.01)


def _t(x):
    return torch.as_tensor(np.array(x))


def _args(states):
    return (_t(states.pos), _t(states.vel), _t(states.mass),
            _t(states.step_s2))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_plain_matches_pallas_interpret_float32(scheme):
    from nbodysimproject_tpu.ops.pallas_batch import composition_multistep

    _cfg, (states, _dyns) = _population(dtype=np.float32)
    ref = composition_multistep(states.pos, states.vel, states.mass,
                                states.step_s2, h=0.01, G=1.0, n_steps=40,
                                lanes=2, scheme=scheme, interpret=True)
    got = bk.composition_multistep(*_args(states), h=0.01, G=1.0,
                                   n_steps=40, scheme=scheme)
    assert got[0].dtype == torch.float32
    for name, a, b in zip(("pos", "vel"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_plain_matches_jax_scan_float64(scheme):
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import integrate_batch

    cfg, (states, dyns) = _population()
    ref = integrate_batch(states, dyns, cfg.replace(integrator_mode=scheme),
                          jnp.float64(0.01), 40, 1)
    po, vo = bk.composition_multistep(*_args(states), h=0.01, G=1.0,
                                      n_steps=40, scheme=scheme)
    np.testing.assert_allclose(po.numpy(), np.asarray(ref.pos), rtol=1e-7,
                               atol=1e-8)
    np.testing.assert_allclose(vo.numpy(), np.asarray(ref.vel), rtol=1e-7,
                               atol=1e-8)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"N{s[0]}d{s[1]}")
@pytest.mark.parametrize("scheme", SCHEMES)
def test_plain_matches_pallas_interpret_shapes(scheme, shape):
    from nbodysimproject_tpu.ops.pallas_batch import composition_multistep

    _cfg, (states, _dyns) = _ring_population(*shape, dtype=np.float32)
    ref = composition_multistep(states.pos, states.vel, states.mass,
                                states.step_s2, h=0.01, G=1.0, n_steps=20,
                                lanes=2, scheme=scheme, interpret=True)
    got = bk.composition_multistep(*_args(states), h=0.01, G=1.0,
                                   n_steps=20, scheme=scheme)
    assert got[0].shape == (16,) + shape
    for name, a, b in zip(("pos", "vel"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_plain_matches_jax_scan_float64_3d(scheme):
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel import integrate_batch

    cfg, (states, dyns) = _ring_population(8, 3)
    ref = integrate_batch(states, dyns, cfg.replace(integrator_mode=scheme),
                          jnp.float64(0.01), 40, 1)
    po, vo = bk.composition_multistep(*_args(states), h=0.01, G=1.0,
                                      n_steps=40, scheme=scheme)
    np.testing.assert_allclose(po.numpy(), np.asarray(ref.pos), rtol=1e-7,
                               atol=1e-8)
    np.testing.assert_allclose(vo.numpy(), np.asarray(ref.vel), rtol=1e-7,
                               atol=1e-8)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_momentum_conserved(scheme):
    _cfg, (states, _dyns) = _population(B=8)
    pos, vel, mass, eps2 = _args(states)
    p0 = (mass[..., None] * vel).sum(1)
    _po, vo = bk.composition_multistep(pos, vel, mass, eps2, h=0.01, G=1.0,
                                       n_steps=100, scheme=scheme)
    assert float(((mass[..., None] * vo).sum(1) - p0).abs().max()) < 1e-12


def test_named_schemes_and_refusals():
    _cfg, (states, _dyns) = _population(B=8)
    args = _args(states)
    for fn, scheme in ((bk.verlet_multistep, "verlet"),
                       (bk.yoshida4_multistep, "yoshida4")):
        a = fn(*args, h=0.01, G=1.0, n_steps=3)
        b = bk.composition_multistep(*args, h=0.01, G=1.0, n_steps=3,
                                     scheme=scheme)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="mask"):
        bk.verlet_multistep(*args, h=0.01, G=1.0, n_steps=1,
                            mask=torch.ones(8, 3, dtype=torch.bool))
    with pytest.raises(ValueError, match="scheme"):
        bk.composition_multistep(*args, h=0.01, G=1.0, n_steps=1,
                                 scheme="leapfrog")
    with pytest.raises(NotImplementedError, match="N <= 16"):
        bk._library(17, 2)  # beyond the port's body count
    z = lambda x: torch.cat([x, torch.zeros_like(x[..., :2])], -1)
    with pytest.raises(NotImplementedError, match="d in"):  # d = 4
        bk.verlet_multistep(z(args[0]), z(args[1]), args[2], args[3],
                            h=0.01, G=1.0, n_steps=1)
