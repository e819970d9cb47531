"""PyTorch port vs the JAX package: rows 3 and 6 at d = 3.

* ``hamsoft_multistep``'s plain version (on the CPU) against the JAX
  Pallas kernel in interpret mode at d = 3 (N = 3 systems of
  ``tests/test_torch_hamsoft_kernels.py``'s geometry with a z column,
  built by the JAX package in float32) under the reflection policy and
  the "reference" gradient, 6 macro steps,
  ``tests/test_hamsoft_variants.py::_assert_parity``'s tolerances.
* ``whfast_multistep``'s plain version against the JAX Pallas kernel in
  interpret mode on an inclined planetary batch (a unit central mass
  and 1e-3 planets near radii 1 and 2, their orbits tilted by up to 0.1
  rad; N = 3, d = 3; numpy-seeded perturbations; eps^2 = 1e-6), 40
  steps in float32 within rtol 1e-5 / atol 1e-7 and 10 in float64 to
  rtol 1e-10 / atol 1e-12, the tolerances of
  ``tests/test_torch_whfast_kernel.py`` (the JAX kernel writes its Jacobi
  sums, Kepler drift and kick per coordinate, pallas_whfast.py:81-206).
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
from nbodysimproject_tpu_torch.ops import whfast_kernels as wk

import test_torch_hamsoft_kernels as base
from test_torch_kernel_variants import state_close
from test_torch_whfast import _close


def _population_3d(B=16, seed=8):
    """N = 3 systems of ``_population``'s geometry with a z column, built
    by the JAX package in float32."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel.batch_engine import build_batch

    cfg = nb.SimConfig(integrator_mode="ham_soft", fast_float32=True)
    rng = np.random.default_rng(seed)
    base_q = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.1], [0.0, 2.0, -0.1]])
    q = base_q[None] + 0.01 * rng.normal(size=(B, 3, 3))
    v = 0.2 * rng.normal(size=(B, 3, 3))
    m = np.broadcast_to(np.linspace(1.0, 0.2, 3), (B, 3))
    states, dyns = build_batch(
        jnp.asarray(m, jnp.float32), jnp.asarray(q, jnp.float32),
        jnp.asarray(v, jnp.float32), jnp.ones((B, 3), bool), cfg, 1.0, 5e-2,
        0.0, 0.01)
    return cfg, states, dyns, None, None


def test_multistep_d3_variant_matches_pallas_interpret():
    from nbodysimproject_tpu.ops.pallas_hamsoft import hamsoft_multistep

    cfg, states, dyns, _keys, _tan = _population_3d()
    kw = base._kernel_kw(cfg, dyns)
    B = states.pos.shape[0]
    ref = hamsoft_multistep(states.pos, states.vel, states.mass, states.eps,
                            states.pi, n_steps=6, lanes=B // 8,
                            interpret=True, policy="reflection",
                            grad_mode="reference", lam_align=0.3, **kw)
    got = hk.hamsoft_multistep(
        base._t(states.pos), base._t(states.vel), base._t(states.mass),
        base._t(states.eps), base._t(states.pi), n_steps=6,
        policy="reflection", grad_mode="reference", lam_align=0.3,
        **base._torch_kw(kw))
    state_close(ref, got, "d3 reflection reference")


def _inclined_planets(B, dtype, seed=17):
    rng = np.random.default_rng(seed)
    m = np.broadcast_to(np.array([1.0, 1e-3, 1e-3]), (B, 3)).copy()
    inc = rng.uniform(0.0, 0.1, (B, 2))
    q = np.zeros((B, 3, 3))
    v = np.zeros((B, 3, 3))
    for k, r in enumerate((1.0, 2.0)):
        c, s = np.cos(inc[:, k]), np.sin(inc[:, k])
        vc = np.sqrt(1.0 / r)
        q[:, k + 1] = np.stack([r * c, np.zeros(B), r * s], -1)
        v[:, k + 1] = np.stack([np.zeros(B), vc * np.ones(B),
                                np.zeros(B)], -1)
    q[:, 1:] += 0.01 * rng.normal(size=(B, 2, 3))
    v[:, 1:] += 0.01 * rng.normal(size=(B, 2, 3))
    return [np.asarray(a, dtype) for a in (q, v, m, np.full(B, 1e-6))]


@pytest.mark.parametrize("dtype,n_steps,rtol,atol", [
    (np.float32, 40, 1e-5, 1e-7), (np.float64, 10, 1e-10, 1e-12)])
def test_whfast_d3_matches_pallas_interpret(dtype, n_steps, rtol, atol):
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pallas_whfast import whfast_multistep

    args = _inclined_planets(16, dtype)
    po, vo = whfast_multistep(*(jnp.asarray(a) for a in args), h=0.01,
                              G=1.0, n_steps=n_steps, lanes=2,
                              interpret=True)
    tp, tv = wk.whfast_multistep(*(torch.as_tensor(a) for a in args),
                                 h=0.01, G=1.0, n_steps=n_steps)
    assert float(np.abs(np.asarray(po)[..., 2]).max()) > 0.05  # inclined
    _close(po, tp, rtol=rtol, atol=atol, msg="pos")
    _close(vo, tv, rtol=rtol, atol=atol, msg="vel")
