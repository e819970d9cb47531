"""PyTorch port vs the JAX package: the ham_soft analysis kernel's other
branches, the reflection and no-barrier policies and the "reference" eps*
gradient.

The plain PyTorch version of ``hamsoft_analysis_multistep`` (on the CPU)
is held in float32 against the JAX Pallas kernel run with
``interpret=True`` under the same policy and gradient mode, on the
population of ``tests/test_torch_hamsoft_kernels.py`` (N = 3; d = 2;
B = 16) and on the sparse geometry of
``tests/test_hamsoft_variants.py::_saturated_population`` (drawn here with
numpy), where the SPH clip saturates, the exact gradient degenerates and
the reference's fallback takes over.  8 analysis steps, a sample every 2.

Tolerances: the final state those of
``tests/test_hamsoft_variants.py::_assert_parity`` (pos rtol 2e-5 / atol
2e-6, vel 2e-5 / 2e-5, eps 1e-5 / 1e-6, pi 1e-3 / 5e-5); the metric
moments and the (eps, pi) samples those of
``tests/test_torch_hamsoft_kernels.py`` (rtol 1e-3 / atol 1e-5, and its
state tolerance rtol 1e-4 / atol 1e-5).  The MEGNO kernel's branches are
in ``tests/test_torch_kernel_variants_megno.py``, the multi-step kernel's
in ``tests/test_torch_kernel_variants_multistep.py``, rows 3 and 6 at
d = 3 in ``tests/test_torch_d3_variants.py``; the analysis kernel's
masked (N = 4) and d = 3 cases in
``tests/test_torch_kernel_variants_masked.py``.
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
from nbodysimproject_tpu_torch.ops.eps_model import degenerate_grad

import test_torch_hamsoft_kernels as base

#: tests/test_hamsoft_variants.py::_assert_parity, (rtol, atol)
PARITY = {"pos": (2e-5, 2e-6), "vel": (2e-5, 2e-5), "eps": (1e-5, 1e-6),
          "pi": (1e-3, 5e-5)}


def saturated_population(B=16, seed=5):
    """The 3-body geometry of ``_saturated_population``: bodies near
    (0, 0), (25, 0), (0, 40), so the SPH update exceeds eps_max on every
    lane; built by the JAX package in float32."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.diagnostics.megno import init_tangent
    from nbodysimproject_tpu.parallel.batch_engine import build_batch

    cfg = nb.SimConfig(integrator_mode="ham_soft", fast_float32=True)
    rng = np.random.default_rng(seed)
    base_q = np.array([[0.0, 0.0], [25.0, 0.0], [0.0, 40.0]])
    base_v = np.array([[0.0, 0.0], [0.0, 0.2], [-0.1, 0.0]])
    q = base_q[None] + 0.5 * rng.normal(size=(B, 3, 2))
    v = base_v[None] + 0.02 * rng.normal(size=(B, 3, 2))
    m = np.broadcast_to(np.array([1.0, 0.5, 0.1]), (B, 3))
    states, dyns = build_batch(
        jnp.asarray(m, jnp.float32), jnp.asarray(q, jnp.float32),
        jnp.asarray(v, jnp.float32), jnp.ones((B, 3), bool), cfg, 1.0, 5e-2,
        0.0, 0.01)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(31), jnp.arange(B, dtype=jnp.uint32))
    dr0, dv0 = jax.vmap(init_tangent)(keys, states)
    return cfg, states, dyns, keys, (dr0, dv0)


POPULATIONS = {"n3": lambda: base._population(n=3, masked=False),
               "n4_masked": lambda: base._population(n=4, masked=True),
               "saturated": saturated_population}


def state_close(ref, got, what):
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref, got):
        base._close(a, b, f"{what}.{name}", *PARITY[name])


def fallback_taken(pop):
    """Per system, whether the reference's fallback takes the entry
    gradient (the plain physics at t = 0: the exact gradient's largest
    valid row norm <= 1e-12 or <= 1e-9 times the median pair distance)."""
    cfg, states, dyns, _keys, _tan = pop
    kw = base._torch_kw(base._kernel_kw(cfg, dyns))
    ph = hk._Physics(base._t(states.mass), base._t(states.eps), kw["k_soft"],
                     kw["mu"], kw["alpha"], kw["eps_min"], kw["eps_max"],
                     G=1.0, k_wall=kw["k_wall"], eta=kw["eta"],
                     jcap=kw["jcap"], bexp=kw["bexp"])
    pos = base._t(states.pos)
    _es, g, _h = ph.exact_eps_grad(pos)
    return degenerate_grad(g, pos, ph.valid)[0]


def check_analysis_variant(pop, case, policy, grad_mode, L0):
    """The plain analysis kernel against the JAX Pallas kernel in
    interpret mode on ``pop`` (L0 its angular momentum, L_z at d = 2, the
    vector at d = 3) under ``policy`` and ``grad_mode``; where the
    reference's fallback runs, it is shown to fire."""
    from nbodysimproject_tpu.ops.pallas_hamsoft import (
        hamsoft_analysis_multistep as jax_analysis)

    cfg, states, dyns, _keys, _tan = pop
    kw = base._kernel_kw(cfg, dyns)
    B = states.pos.shape[0]
    T, interval = 8, 2
    ref = jax_analysis(states.pos, states.vel, states.mass, states.eps,
                       states.pi, L0, n_steps=T, interval=interval,
                       lanes=B // 8, interpret=True, policy=policy,
                       grad_mode=grad_mode, lam_align=0.3, **kw)
    got = hk.hamsoft_analysis_multistep(
        base._t(states.pos), base._t(states.vel), base._t(states.mass),
        base._t(states.eps), base._t(states.pi), base._t(L0), n_steps=T,
        interval=interval, policy=policy, grad_mode=grad_mode,
        lam_align=0.3, **base._torch_kw(kw))
    state_close(ref[:4], got[:4], f"{case} {policy} {grad_mode}")
    for metric in hk.ACC_METRICS:
        for stat, a, b in zip(("count", "sum", "sumsq", "max", "min"),
                              ref[4][metric], got[4][metric]):
            base._close(a, b, f"{metric}.{stat}", rtol=1e-3, atol=1e-5)
    base._close(ref[5], got[5], "eps_samples")
    base._close(ref[6], got[6], "pi_samples")
    if grad_mode == "reference":
        assert fallback_taken(pop).any()
    if policy == "reflection":
        lo = torch.as_tensor(np.asarray(kw["eps_min"]))
        hi = torch.as_tensor(np.asarray(kw["eps_max"]))
        assert bool(((got[2] >= lo) & (got[2] <= hi)).all())
    return got, kw


@pytest.mark.parametrize("case,policy,grad_mode", [
    ("n3", "reflection", "exact"), ("n3", "none", "reference"),
    ("saturated", "reflection", "reference")])
def test_analysis_variant_matches_pallas_interpret(case, policy, grad_mode):
    pop = POPULATIONS[case]()
    _cfg, states, _dyns, _keys, _tan = pop
    L0 = base._lz(states)
    got, kw = check_analysis_variant(pop, case, policy, grad_mode, L0)
    if grad_mode == "reference" and case == "n3":
        # there the Omega gradient is not zero, and moves the systems
        exact = hk.hamsoft_analysis_multistep(
            base._t(states.pos), base._t(states.vel), base._t(states.mass),
            base._t(states.eps), base._t(states.pi), base._t(L0), n_steps=8,
            interval=2, policy=policy, **base._torch_kw(kw))
        assert not torch.equal(exact[1], got[1])
