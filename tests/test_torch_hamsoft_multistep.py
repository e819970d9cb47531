"""PyTorch port vs the JAX package: the plain multi-step ham_soft kernel.

On the CPU ``hamsoft_kernels.hamsoft_multistep`` runs its plain PyTorch
version; it is held in float32 against the JAX Pallas kernel of the
same name run with ``interpret=True``, under both barrier policies, on
the population of ``tests/test_torch_hamsoft_kernels.py`` (N = 3;
d = 2; B = 16; 6 macro steps).  For the reflection policy the wall
interval is narrowed to the entry eps +- 0.1%, so the folds act (the
test checks that the result differs from the no-barrier run and stays
inside the walls).

Tolerance: pos, vel, eps, pi to rtol 1e-4 / atol 1e-5 — float32
rounding of two reduction orders and of autograd versus the
hand-written reverse sweep, as for the analysis kernel.  The same
tolerance holds the "reference" gradient and d = 3 (a drawn z column)
to the interpret-mode kernel; other branches are in
``tests/test_torch_kernel_variants_multistep.py``.
"""

import numpy as np
import pytest
import torch

import test_torch_hamsoft_kernels as base
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk


@pytest.fixture(scope="module")
def pop():
    return base._population(n=3, masked=False)


@pytest.mark.parametrize("policy", ["soft", "reflection"])
def test_multistep_plain_matches_pallas_interpret(pop, policy):
    from nbodysimproject_tpu.ops.pallas_hamsoft import hamsoft_multistep

    cfg, states, dyns, _keys, _tan = pop
    kw = base._kernel_kw(cfg, dyns)
    if policy == "reflection":
        # a narrow wall interval around the entry eps, so the folds act
        eps = np.asarray(states.eps)
        kw["eps_min"] = (eps * 0.999).astype(np.float32)
        kw["eps_max"] = (eps * 1.001).astype(np.float32)
    T = 6
    B = states.pos.shape[0]
    ref = hamsoft_multistep(states.pos, states.vel, states.mass, states.eps,
                            states.pi, n_steps=T, lanes=B // 8,
                            interpret=True, policy=policy, **kw)
    args = (base._t(states.pos), base._t(states.vel), base._t(states.mass),
            base._t(states.eps), base._t(states.pi))
    got = hk.hamsoft_multistep(*args, n_steps=T, policy=policy,
                               **base._torch_kw(kw))
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref, got):
        base._close(a, b, f"{policy}.{name}")
    if policy == "reflection":
        free = hk.hamsoft_multistep(*args, n_steps=T, policy="none",
                                    **base._torch_kw(kw))
        assert not torch.equal(free[2], got[2])  # the folds acted
        lo, hi = torch.as_tensor(kw["eps_min"]), torch.as_tensor(kw["eps_max"])
        assert bool(((got[2] >= lo) & (got[2] <= hi)).all())


def test_multistep_refusals(pop):
    """The "reference" gradient and d = 3, once refused, held to the JAX
    Pallas kernel in interpret mode with the tolerance above (d = 3: the
    population with a drawn z column, built by the JAX package); an
    unknown policy still raises."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pallas_hamsoft import hamsoft_multistep
    from nbodysimproject_tpu.parallel.batch_engine import build_batch

    cfg, states, dyns, _keys, _tan = pop
    kw = base._kernel_kw(cfg, dyns)
    B = states.pos.shape[0]
    args = (base._t(states.pos), base._t(states.vel), base._t(states.mass),
            base._t(states.eps), base._t(states.pi))
    ref = hamsoft_multistep(states.pos, states.vel, states.mass, states.eps,
                            states.pi, n_steps=4, lanes=B // 8,
                            interpret=True, grad_mode="reference", **kw)
    got = hk.hamsoft_multistep(*args, n_steps=4, grad_mode="reference",
                               **base._torch_kw(kw))
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref, got):
        base._close(a, b, f"reference.{name}")
    with pytest.raises(NotImplementedError):
        hk.hamsoft_multistep(*args, n_steps=1, policy="bounce",
                             **base._torch_kw(kw))
    z = np.random.default_rng(13).normal(size=states.pos.shape[:2] + (1,))
    q3 = np.concatenate([np.asarray(states.pos), 0.05 * z], -1)
    v3 = np.concatenate([np.asarray(states.vel), 0.1 * z], -1)
    st3, dy3 = build_batch(states.mass, jnp.asarray(q3, jnp.float32),
                           jnp.asarray(v3, jnp.float32), states.mask, cfg,
                           1.0, 5e-2, 0.0, 0.01)
    kw3 = base._kernel_kw(cfg, dy3)
    ref = hamsoft_multistep(st3.pos, st3.vel, st3.mass, st3.eps, st3.pi,
                            n_steps=4, lanes=B // 8, interpret=True, **kw3)
    got = hk.hamsoft_multistep(base._t(st3.pos), base._t(st3.vel),
                               base._t(st3.mass), base._t(st3.eps),
                               base._t(st3.pi), n_steps=4,
                               **base._torch_kw(kw3))
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref, got):
        base._close(a, b, f"d3.{name}")
