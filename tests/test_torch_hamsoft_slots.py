"""PyTorch port vs the JAX package: the ham_soft kernels' plain versions at
slot counts other than 3, 4 and 8, on the CPU.

The CUDA kernels take every N from 2 to 16 (four lanes a body up to
N = 8, two from N = 9 to 16, ``csrc/hamsoft_physics_warp.cuh``); on the
card they are held to these plain versions by
``tests/test_torch_cuda_slots.py``.  Here, in float32, on populations
drawn with numpy and built by the port's ``build_batch`` (d = 2, B = 16,
masked slots):

* the plain analysis kernel (row 1) at N = 5 (3-5 bodies) against the
  JAX Pallas kernel in interpret mode, 12 steps, with the tolerances of
  ``tests/test_torch_hamsoft_kernels.py`` (the state to rtol 1e-4 /
  atol 1e-5, the accumulators to rtol 1e-3);
* at N = 5 and N = 12 (9-12 bodies, the LPB-2 layout class), two Strang
  trips of the plain physics (``hamsoft_kernels._Physics``) against the
  JAX kernels' own physics, ``_build_physics(...).strang_trip``, run
  eagerly, and the MEGNO kernel's tangent map (``tangent_accel``) against
  the JAX kernels' (both to rtol 1e-4 / atol 1e-5, and 1e-5 relative to
  the largest entry of the tangent acceleration);
* the plain multi-step kernel (row 3) at N = 2 and N = 12: its final
  states bit for bit the plain analysis kernel's on the same inputs;
* ``hamsoft_kernels.check_slots``: every N from 2 to 16 at d = 2 and 3,
  N = 1 and 17 refused with N in the message;
* the multi-step kernel's one-thread layout at any N (``one_thread``,
  the build variant "thread", a witness of the warp layout on the card):
  its variant name and macro under every policy and gradient mode, and
  on the CPU the same plain version, bit for bit.

The JAX kernels in interpret mode take ~30 s a configuration to trace
and compile at N = 5 on the CPU and ~15 minutes at N = 12 (the unrolled
body grows as N^2), so N = 12 is held through the kernels'
physics run eagerly instead, and the MEGNO kernel through its tangent
map: its plain version at N = 5 and 12 runs the same trips and the same
per-step update as at N = 3, 4 and 8
(``tests/test_torch_megno_kernel.py``).  Torch runs on one intra-op
thread here (tiny tensors beside the other test workers).
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.ops import cuda_build
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
from nbodysimproject_tpu_torch.parallel.batch_engine import build_batch
from test_torch_hamsoft_kernels import _close

#: (n, least bodies) of the populations
POPS = {5: 3, 12: 9, 2: 2}
B, D, DT = 16, 2, 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _population(n, lo, seed=23):
    """A (B, n, 2) float32 population of lo to n bodies a system (the
    rest masked) on a line 1.2 apart with small offsets, built by the
    port: (states, dyns, kernel keywords)."""
    rng = np.random.default_rng(seed + n)
    counts = rng.integers(lo, n + 1, B)
    mask = np.arange(n)[None, :] < counts[:, None]
    q = 0.05 * rng.normal(size=(B, n, D))
    q[..., 0] += np.arange(n) * 1.2
    v = 0.2 * rng.normal(size=(B, n, D))
    m = rng.uniform(0.2, 1.0, size=(B, n))
    m = np.where(mask, m, 0.0)
    q, v = (np.where(mask[..., None], a, 0.0) for a in (q, v))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)
    cfg = nt.SimConfig(fast_float32=True)
    st, dy = build_batch(f(m), f(q), f(v), torch.as_tensor(mask), cfg, 1.0,
                         0.05, 0.0, DT)
    n_sub = torch.clamp(dy.n_sub, 1, 2)
    kw = dict(k_soft=dy.k_soft, mu=dy.mu_soft, alpha=dy.alpha_run,
              eps_min=dy.min_softening, eps_max=dy.max_softening,
              h=DT / n_sub.to(torch.float32), n_sub=n_sub,
              n_sub_max=int(n_sub.max()), G=1.0, k_wall=float(cfg.k_wall),
              eta=float(cfg.eta), jcap=float(cfg.j_max_cap),
              bexp=int(cfg.barrier_exponent))
    return st, dy, kw


@pytest.fixture(scope="module")
def pops():
    return {n: _population(n, lo) for n, lo in POPS.items()}


def _np(kw):
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in kw.items()}


def _lz(st):
    q, v = st.pos, st.vel
    return (st.mass * (q[..., 0] * v[..., 1] - q[..., 1] * v[..., 0])).sum(-1)


def test_analysis_plain_matches_pallas_interpret_n5(pops):
    """Row 1 at N = 5 (LPB 4, SPL 2: the N = 8 lanes with the upper slots
    unused) against the JAX kernel in interpret mode."""
    from nbodysimproject_tpu.ops.pallas_hamsoft import (
        hamsoft_analysis_multistep as jax_analysis)

    st, _dy, kw = pops[5]
    assert int(st.mask.sum(1).min()) == 3 and not bool(st.mask.all())
    T, interval = 12, 2
    args = (st.pos, st.vel, st.mass, st.eps, st.pi, _lz(st))
    ref = jax_analysis(*(a.numpy() for a in args), n_steps=T,
                       interval=interval, lanes=B // 8, interpret=True,
                       **_np(kw))
    got = hk.hamsoft_analysis_multistep(*args, n_steps=T, interval=interval,
                                        **kw)
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, name)
    for metric in hk.ACC_METRICS:
        for stat, a, b in zip(("count", "sum", "sumsq", "max", "min"),
                              ref[4][metric], got[4][metric]):
            _close(a, b, f"{metric}.{stat}", rtol=1e-3, atol=1e-5)
    _close(ref[5], got[5], "eps_samples")
    _close(ref[6], got[6], "pi_samples")


def _jax_ops(st, kw):
    """``_build_physics`` of the JAX kernels on (B,) float32 rows."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pallas_hamsoft import _build_physics

    n = st.pos.shape[1]
    f = lambda x: jnp.asarray(np.asarray(x, np.float32))
    mass = [f(st.mass[:, i]) for i in range(n)]
    valid = [x > 0.0 for x in mass]
    inv_m = [jnp.where(v, 1.0 / jnp.maximum(x, 1e-30), 0.0)
             for x, v in zip(mass, valid)]
    return _build_physics(n, D, mass, valid, inv_m, f(kw["k_soft"]),
                          f(kw["mu"]), f(kw["alpha"]), f(kw["eps_min"]),
                          f(kw["eps_max"]), f(st.eps), G=kw["G"],
                          k_wall=kw["k_wall"], eta=kw["eta"], jcap=kw["jcap"],
                          bexp=kw["bexp"]), f


def _coords(x):
    """(B, N, d) -> the JAX kernels' per-coordinate (B,) rows"""
    return [x[:, i, a] for i in range(x.shape[1]) for a in range(D)]


def _stacked(rows, n):
    return np.stack([np.asarray(r) for r in rows], 1).reshape(B, n, D)


@pytest.mark.parametrize("n", (5, 12))
def test_trips_and_tangent_map_match_jax_physics(pops, n):
    """Two Strang trips and the tangent acceleration of the plain physics
    against the JAX kernels' physics, eagerly, at N = 5 and 12."""
    st, _dy, kw = pops[n]
    ops, f = _jax_ops(st, kw)
    ph = hk._Physics(st.mass, st.eps, kw["k_soft"], kw["mu"], kw["alpha"],
                     kw["eps_min"], kw["eps_max"], G=kw["G"],
                     k_wall=kw["k_wall"], eta=kw["eta"], jcap=kw["jcap"],
                     bexp=kw["bexp"])
    active = torch.ones(B, dtype=torch.bool)
    state = (st.pos, st.vel, st.eps, st.pi) + ph.eps_star_and_grad(st.pos)
    es, g = ops.eps_star_and_grad([f(x) for x in _coords(st.pos)])
    jstate = ([f(x) for x in _coords(st.pos)],
              [f(x) for x in _coords(st.vel)], f(st.eps), f(st.pi), es, g)
    for _ in range(2):
        state = ph.strang_trip(*state, kw["h"], active)
        jstate = ops.strang_trip(*jstate, f(kw["h"]), active.numpy())
    for name, a, b in (("pos", _stacked(jstate[0], n), state[0]),
                       ("vel", _stacked(jstate[1], n), state[1]),
                       ("eps", jstate[2], state[2]),
                       ("pi", jstate[3], state[3])):
        _close(np.asarray(a), b, f"N={n} {name}")
    rng = np.random.default_rng(n)
    dr = torch.as_tensor(rng.normal(size=(B, n, D)), dtype=torch.float32)
    dr = torch.where(st.mask[..., None], dr, torch.zeros_like(dr))
    acc = ph.tangent_accel(state[0], dr, state[2])
    ref = _stacked(ops.tangent_accel([f(x) for x in _coords(state[0])],
                                     [f(x) for x in _coords(dr)],
                                     f(state[2])), n)
    scale = float(np.abs(ref).max())
    assert scale > 0.0
    _close(ref, acc, f"N={n} tangent_accel", atol=1e-5 * scale)


@pytest.mark.parametrize("n", (2, 12))
def test_multistep_plain_is_analysis_final_state(pops, n):
    """Row 3's plain version moves the state as row 1's does, bit for
    bit, at N = 2 (one thread a system on the card) and N = 12."""
    st, _dy, kw = pops[n]
    args = (st.pos, st.vel, st.mass, st.eps, st.pi)
    ana = hk.hamsoft_analysis_multistep(*args, _lz(st), n_steps=6,
                                        interval=2, **kw)
    got = hk.hamsoft_multistep(*args, n_steps=6, **kw)
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ana[:4], got):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), name
    assert not torch.equal(got[0], st.pos)


@pytest.mark.parametrize("d", hk.DIMS)
@pytest.mark.parametrize("n", range(hk.SLOTS[0], hk.SLOTS[1] + 1))
def test_check_slots_takes_2_to_16(n, d):
    hk.check_slots(n, d)


@pytest.mark.parametrize("n", (1, 17))
def test_check_slots_refuses_other_counts(n):
    with pytest.raises(NotImplementedError, match=f"N = {n}, d = 2"):
        hk.check_slots(n, 2)


@pytest.mark.parametrize("grad_mode", hk.GRAD_MODES)
@pytest.mark.parametrize("policy", hk.POLICIES)
def test_one_thread_build_variant(policy, grad_mode):
    """``one_thread`` names the multi-step kernel's build variant "thread"
    (macro HS_THREAD) beside the gradient's, a library of its own."""
    src = hk.SOURCES[1]
    base = hk.variant(src, policy, grad_mode)
    var = hk.variant(src, policy, grad_mode, one_thread=True)
    assert var == "_".join(p for p in (base, "thread") if p)
    assert "-DHS_THREAD=1" in cuda_build._defines(var)
    assert "-DHS_THREAD=1" not in cuda_build._defines(base)
    assert cuda_build.lib_path(src, 16, 2, var) \
        != cuda_build.lib_path(src, 16, 2, base)


def test_one_thread_on_the_cpu_is_the_plain_version(pops):
    st, _dy, kw = pops[12]
    args = (st.pos, st.vel, st.mass, st.eps, st.pi)
    a = hk.hamsoft_multistep(*args, n_steps=2, **kw)
    b = hk.hamsoft_multistep(*args, n_steps=2, one_thread=True, **kw)
    for name, x, y in zip(("pos", "vel", "eps", "pi"), a, b):
        assert torch.equal(x, y), name
