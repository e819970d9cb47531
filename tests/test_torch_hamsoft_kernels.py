"""PyTorch port vs the JAX package: the ham_soft analysis kernel.

On the CPU each wrapper in ``nbodysimproject_tpu_torch.ops.hamsoft_kernels``
runs its plain PyTorch version; it is held in float32 against the JAX
Pallas kernel of the same name run with ``interpret=True``, under the
soft barrier policy and the exact eps* gradient, on the small
populations ``tests/test_pallas_batch.py`` uses (N = 3, and N = 4 with a
masked slot; d = 2; B = 16; 12 analysis steps, 6 MEGNO steps).  The
MEGNO tangents are the JAX package's ``init_tangent`` draws.

Tolerances: the raw kernel state (pos, vel, eps, pi) agrees to
rtol 1e-4 / atol 1e-5 — float32 rounding (eps 1.2e-7) of two different
reduction orders and of autograd versus the hand-written reverse sweep,
carried through ~50 Strang trips; the engine-level columns agree within
the fused-vs-scan ``_TOL`` of ``tests/test_pallas_batch.py``.

The MEGNO kernel's tests are in ``tests/test_torch_megno_kernel.py``;
the CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk

JE = importlib.import_module("nbodysimproject_tpu.diagnostics.energy")

STATE_RTOL, STATE_ATOL = 1e-4, 1e-5

#: per-column (rtol, atol), copied from tests/test_pallas_batch.py
#: (TestHamsoftAnalysisFusedEngine._TOL, fused-vs-scan agreement)
_TOL = {
    "is_stable": (0.0, 0.0),
    "energy_drift": (0.05, 1e-5),
    "angular_momentum_drift": (0.05, 1e-5),
    "com_drift_mean": (1e-3, 1e-5),
    "com_drift_max": (1e-3, 1e-5),
    "j_eps_mean": (2e-3, 1e-6),
    "j_eps_std": (2e-3, 1e-6),
    "theta_eps_mean": (2e-3, 1e-3),
    "theta_eps_std": (2e-3, 1e-3),
    "cos_theta_mean": (1e-4, 1e-5),
    "cos_theta_min": (1e-4, 1e-5),
    "ang_mom_var_mean": (2e-3, 1e-7),
    "ang_mom_var_max": (2e-3, 1e-7),
    "tidal_trace_mean": (2e-3, 1e-3),
    "tidal_trace_max": (2e-3, 1e-3),
    "MEGNO": (1e-3, 1e-4),
    "lyapunov_time": (1e-2, 0.0),
    "megno_slope_med": (5e-3, 1e-3),
}

CASES = {"n3": dict(n=3, masked=False), "n4_masked": dict(n=4, masked=True)}


def _population(n, masked, B=16, d=2, seed=5):
    """tests/test_pallas_batch.py's fused-engine population, built by
    the JAX package in float32."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.diagnostics.megno import init_tangent
    from nbodysimproject_tpu.parallel.batch_engine import build_batch

    cfg = nb.SimConfig(integrator_mode="ham_soft", fast_float32=True)
    rng = np.random.default_rng(seed)
    base_q = np.zeros((n, d))
    base_q[1, 0] = 1.0
    base_q[2, 1] = 2.0
    q = base_q[None] + 0.01 * rng.normal(size=(B, n, d))
    m = np.broadcast_to(np.linspace(1.0, 0.2, n), (B, n)).copy()
    v = rng.normal(size=(B, n, d)) * 0.2
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


def _lz(states):
    import jax

    return np.asarray(jax.vmap(JE.angular_momentum_z)(states))


def _t(x):
    return torch.as_tensor(np.array(x))


def _kernel_kw(cfg, dyns, dt=0.01):
    """Per-system arguments shared by both packages' wrappers."""
    n_sub = np.maximum(np.asarray(dyns.n_sub), 1)
    return dict(k_soft=np.asarray(dyns.k_soft), mu=np.asarray(dyns.mu_soft),
                alpha=np.asarray(dyns.alpha_run),
                eps_min=np.asarray(dyns.min_softening),
                eps_max=np.asarray(dyns.max_softening),
                h=(np.float32(dt) / n_sub.astype(np.float32)),
                n_sub=n_sub, n_sub_max=int(n_sub.max()), G=1.0,
                k_wall=float(cfg.k_wall), eta=float(cfg.eta),
                jcap=float(cfg.j_max_cap), bexp=int(cfg.barrier_exponent))


def _torch_kw(kw):
    return {k: (_t(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


def _close(a, b, name, rtol=STATE_RTOL, atol=STATE_ATOL):
    a = np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                  err_msg=f"finiteness: {name}")
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=atol,
                               err_msg=name)


def test_analysis_plain_matches_pallas_interpret(pop):
    from nbodysimproject_tpu.ops.pallas_hamsoft import (
        hamsoft_analysis_multistep as jax_analysis)

    cfg, states, dyns, _keys, _tan = pop
    L0 = _lz(states)
    kw = _kernel_kw(cfg, dyns)
    B = states.pos.shape[0]
    T, interval = 12, 2
    ref = jax_analysis(states.pos, states.vel, states.mass, states.eps,
                       states.pi, L0, n_steps=T, interval=interval,
                       lanes=B // 8, interpret=True, **kw)
    got = hk.hamsoft_analysis_multistep(
        _t(states.pos), _t(states.vel), _t(states.mass), _t(states.eps),
        _t(states.pi), _t(L0), n_steps=T, interval=interval, **_torch_kw(kw))
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, name)
    for metric in hk.ACC_METRICS:
        for stat, a, b in zip(("count", "sum", "sumsq", "max", "min"),
                              ref[4][metric], got[4][metric]):
            _close(a, b, f"{metric}.{stat}", rtol=1e-3, atol=1e-5)
    _close(ref[5], got[5], "eps_samples")
    _close(ref[6], got[6], "pi_samples")


@pytest.mark.parametrize("policy,grad_mode", [("reflection", "exact"),
                                              ("soft", "reference")])
def test_uncovered_variants_raise(pop, policy, grad_mode):
    """The analysis and MEGNO kernels' reflection policy and "reference"
    gradient, which the port once refused, held to the port's scan engine
    (``integrate_batch`` under the same configuration: the folds around
    each flow, the XLA path's fallback) over 3 macro steps on the
    unmasked bodies, as ``tests/test_hamsoft_variants.py`` holds the JAX
    kernels to the JAX scan, with its ``_assert_parity`` tolerances.  The JAX kernels
    themselves are held in ``tests/test_torch_kernel_variants*.py``."""
    import dataclasses

    from nbodysimproject_tpu_torch.core.state import state_from_numpy
    from nbodysimproject_tpu_torch.parallel.batch_engine import \
        integrate_batch

    parity = {"pos": (2e-5, 2e-6), "vel": (2e-5, 2e-5), "eps": (1e-5, 1e-6),
              "pi": (1e-3, 5e-5)}
    cfg, states, dyns, _keys, (dr0, dv0) = pop
    kw = _torch_kw(_kernel_kw(cfg, dyns))
    T = 3
    arrays = {f.name: np.asarray(getattr(x, f.name))
              for x in (states, dyns) for f in dataclasses.fields(x)}
    st, dy = state_from_numpy(arrays)
    cfg_t = nt.SimConfig(integrator_mode="ham_soft", fast_float32=True,
                         use_soft_barrier=policy == "soft",
                         eps_grad_mode=grad_mode)
    scan = integrate_batch(st, dy, cfg_t, 0.01, T, kw["n_sub_max"])
    args = (_t(states.pos), _t(states.vel), _t(states.mass), _t(states.eps),
            _t(states.pi))
    ana = hk.hamsoft_analysis_multistep(*args, _t(_lz(states)), n_steps=T,
                                        interval=1, policy=policy,
                                        grad_mode=grad_mode, **kw)
    meg = hk.hamsoft_megno_multistep(*args, _t(dr0), _t(dv0), dt=0.01,
                                     n_steps=T, policy=policy,
                                     grad_mode=grad_mode, **kw)
    # masked slots are padding, which the kernels drift and the scan
    # holds: the bodies are compared where the mask is on
    on = np.asarray(states.mask)
    for what, out in (("analysis", ana), ("megno", meg)):
        for name, got in zip(("pos", "vel", "eps", "pi"), out[:4]):
            ref, got = getattr(scan, name).numpy(), got.numpy()
            if ref.ndim == 3:
                ref, got = ref[on], got[on]
            _close(ref, got, f"{what}.{name}", *parity[name])
