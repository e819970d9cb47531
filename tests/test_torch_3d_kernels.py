"""PyTorch port vs the JAX package at d = 3: the plain version of the
analysis kernel against the JAX Pallas kernel in interpret mode, on the
CPU, in float32 (the MEGNO kernel's test is in
``tests/test_torch_3d_megno_kernel.py`` and the eps kernel's at d = 3 in
``tests/test_torch_eps_kernel.py``, which keeps each file's run short).

Population: ``tests/test_pallas_batch.py``'s fused-engine population at
d = 3 (its third body lifted to z = 0.5), N = 3, and N = 4 with a masked
slot, B = 16, the JAX package's build and MEGNO tangents; 20 analysis
steps (interval 2).

The final pos, vel, eps and pi agree to rtol 1e-4 / atol 1e-5
(``tests/test_torch_hamsoft_kernels.py``'s state tolerance: float32
rounding of two reduction orders and of autograd against the
hand-written reverse sweep), the moments (the vector-L cos_theta and
var_L among them) to rtol 1e-3 / atol 1e-5 and the sampled (eps, pi)
rows to the state tolerance.
"""

import importlib

import numpy as np
import pytest

import nbodysimproject_tpu as nb
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
from test_torch_hamsoft_kernels import (_TOL, _close, _kernel_kw, _t,
                                        _torch_kw)

JE = importlib.import_module("nbodysimproject_tpu.diagnostics.energy")
T, INTERVAL, MEGNO_T = 20, 2, 20
CASES = {"n3": dict(n=3, masked=False), "n4_masked": dict(n=4, masked=True)}


def _population(n, masked, B=16, seed=5):
    """tests/test_pallas_batch.py's population at d = 3, built by the JAX
    package in float32, with its MEGNO tangents."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.diagnostics.megno import init_tangent
    from nbodysimproject_tpu.parallel.batch_engine import build_batch

    cfg = nb.SimConfig(integrator_mode="ham_soft", fast_float32=True)
    rng = np.random.default_rng(seed)
    base_q = np.zeros((n, 3))
    base_q[1, 0] = 1.0
    base_q[2, 1] = 2.0
    base_q[2, 2] = 0.5
    q = base_q[None] + 0.01 * rng.normal(size=(B, n, 3))
    m = np.broadcast_to(np.linspace(1.0, 0.2, n), (B, n)).copy()
    v = rng.normal(size=(B, n, 3)) * 0.2
    mask = np.ones((B, n), bool)
    if masked:
        mask[:, -1] = False
        m[:, -1] = 0.0
    states, dyns = build_batch(
        jnp.asarray(m, jnp.float32), jnp.asarray(q, jnp.float32),
        jnp.asarray(v, jnp.float32), jnp.asarray(mask), cfg, 1.0, 5e-2,
        0.0, 0.01)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(31), jnp.arange(B, dtype=jnp.uint32))
    dr0, dv0 = jax.vmap(init_tangent)(keys, states)
    return cfg, states, dyns, keys, (dr0, dv0)


@pytest.fixture(scope="module", params=sorted(CASES))
def pop(request):
    return _population(**CASES[request.param])


def test_analysis_plain_matches_pallas_interpret_3d(pop):
    import jax

    from nbodysimproject_tpu.ops.pallas_hamsoft import (
        hamsoft_analysis_multistep as jax_analysis)

    cfg, states, dyns, _keys, _tan = pop
    L0 = np.asarray(jax.vmap(JE.angular_momentum_vector)(states))
    assert L0.shape == (16, 3)
    kw = _kernel_kw(cfg, dyns)
    B = states.pos.shape[0]
    ref = jax_analysis(states.pos, states.vel, states.mass, states.eps,
                       states.pi, L0, n_steps=T, interval=INTERVAL,
                       lanes=B // 8, interpret=True, **kw)
    got = hk.hamsoft_analysis_multistep(
        _t(states.pos), _t(states.vel), _t(states.mass), _t(states.eps),
        _t(states.pi), _t(L0), n_steps=T, interval=INTERVAL,
        **_torch_kw(kw))
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, name)
    for metric in hk.ACC_METRICS:
        for stat, a, b in zip(("count", "sum", "sumsq", "max", "min"),
                              ref[4][metric], got[4][metric]):
            _close(a, b, f"{metric}.{stat}", rtol=1e-3, atol=1e-5)
    _close(ref[5], got[5], "eps_samples")
    _close(ref[6], got[6], "pi_samples")
    # the vector branch: L tilts away from L0, the |L_i| spread is not 0
    assert (np.asarray(ref[4]["cos_theta"][4]) < 1.0).any()
    assert (np.asarray(ref[4]["var_L"][1]) > 0.0).all()
