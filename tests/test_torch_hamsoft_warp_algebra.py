"""The lane-split (eps*, grad) algebra of the analysis and MEGNO kernels,
on the CPU.

``csrc/hamsoft_physics_warp.cuh`` splits each system over the lanes of a
warp: lane l works for body i = l // LPB and holds SPL = ceil(N / LPB)
neighbour slots j, LPB = min(4, 32 / NP) lanes per body (NP the power of
two >= N): four up to N = 8, two from N = 9 to 16, so that a system keeps
to one warp.  Where a body's group has fewer lanes than quotients to split
(``group_div``) or dimensions to add up (``group_rows``, d = 3 at LPB 2),
lane c takes c, c + LPB, ... in rounds.  Each lane computes its slots' terms; a sum over a
body's slots, over bodies or over pairs reads every term by shuffle and
adds them in ascending order, as the one-thread physics
(``csrc/hamsoft_physics.cuh``) does.  The forward SPH solve keeps W_ij,
dS_i/dh, -G_raw / (2 S_i), the clip gate and -2 / h^2 of every iterate,
and the reverse sweep runs on them without a single exp: the lane of
(i, j) writes coeff_ijk (q_i - q_j) into body i's row and its negation
into body j's row of a table, at the place where the one-thread sweep
adds it to g_i or takes it from g_j, and one lane per body and dimension
adds its row up.  No CUDA runs here, so this file re-implements that
algebra lane by lane in numpy (``warp_eps_star_and_grad``) and holds it

* in float32, bit for bit to the one-thread sweep's order, re-implemented
  loop by loop from ``hamsoft_physics.cuh`` (``one_thread_eps_star_and_grad``);
  the kernels' trajectory is the multi-step kernel's for that reason;
* in float64, to 1e-12 relative (the gradient also 1e-12 of the row's
  largest entry) of the JAX package's ``_build_physics(...).eps_star_and_grad``
  (``ops/pallas_hamsoft.py:271``, run eagerly on the CPU) and of the
  port's plain version (``ops/hamsoft_kernels.py::_Physics``);
* in float32, within STATE_TOL (rtol 1e-4, atol 1e-5) of the same two,
  the tolerance ``chip_smoke.py`` and the CPU kernel tests hold the final
  states to.

Systems: the first 64 rows of ``data/stability_131k.csv.gz`` (3-5
bodies in 8 slots, the rest masked) built by the JAX package's
``build_batch``; 64 seeded clusters of 8 bodies, none masked; its 3-body rows in 3 slots and its 3- and 4-body rows
in 4 slots (the 3-body ones masked); and the dataset rows with the clip gate
saturated (eps_max = 1.01 eps_min on every other row) and with the
bodies spread 300-fold (Sigma underflows, so the float32 backward
overflows and the finite guard zeroes it).  The other slot counts, built
by the port's ``build_batch`` from numpy draws (no JAX program is
compiled for them): LPB 4 at N = 2 (seeded two-body clusters) and N = 5
(the dataset's rows in their first 5 slots, masked); LPB 2 at N = 12 and
16, d = 2 and 3, seeded clusters of N bodies and of 9 to N bodies (the
rest masked).  Also: the kernels' launch
order (``hamsoft_kernels.deepest_first``) is a stable deepest-first
permutation.
"""

import math

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk

#: the constants as the kernels hold them (float32 values)
ETA = float(np.float32(1.35))
INV_PI = float(np.float32(1.0 / math.pi))
STATE_TOL = (1e-4, 1e-5)
DATA = "data/stability_131k.csv.gz"
N_ROWS = 64


def _next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def lanes_per_body(n):
    """``Lay<N>::LPB`` of the kernels: four lanes a body while a system
    of them fits in a warp, two from N = 9 to 16."""
    return min(4, 32 // _next_pow2(n))


def _maxf(a, b):
    """``maxf``: a where a > b or a is NaN, else b."""
    return np.where((a > b) | np.isnan(a), a, b)


def _slot_sum(T, i, N, SPL, LPB):
    """``slot_sum``: every lane of a body's group adds the terms of the
    body's slots j = 0..N-1 (j != i) in ascending j, each read from the
    lane holding it.  T: (B, SYS, SPL) terms."""
    group = (np.arange(T.shape[1]) // LPB) * LPB
    acc = np.zeros(T.shape[:2], T.dtype)
    for j in range(N):
        x = T[:, group + j // SPL, j % SPL]
        acc = np.where(i == j, acc, acc + x)
    return acc


def _group_div(a, b, LPB):
    """``group_div<LPB, K>``: the K quotients a[k] / b[k] of each body's
    group (lists of (B, SYS) arrays), lane c of the group dividing
    k = c, c + LPB, ... (one round per LPB quotients), every lane then
    reading quotient k from lane k % LPB of its group, round k // LPB."""
    K = len(a)
    SYS = a[0].shape[1]
    sub = np.arange(SYS) % LPB
    group = np.arange(SYS) - sub
    x = []
    for r in range(-(-K // LPB)):
        num, den = a[r * LPB], b[r * LPB]
        for c in range(1, LPB):
            if r * LPB + c < K:
                num = np.where(sub == c, a[r * LPB + c], num)
                den = np.where(sub == c, b[r * LPB + c], den)
        x.append(num / den)
    return [x[k // LPB][:, group + k % LPB] for k in range(K)]


def _group_rows(row_sum, body, LPB, D):
    """``group_rows``: lane c of a body's group adds the table rows of
    dimensions a = c, c + LPB, ... (``row_sum(lanes, a)``, (B, len(lanes))
    sums of those lanes' bodies' rows), and every lane of the group reads
    dimension a from lane a % LPB, round a // LPB.  (B, SYS, D)."""
    SYS = body.shape[0]
    sub = np.arange(SYS) % LPB
    group = np.arange(SYS) - sub
    ga = []
    for r in range(-(-D // LPB)):
        a = sub + r * LPB
        acc = None
        for a_ in range(D):     # the lanes whose round r is dimension a_
            lanes = np.nonzero(body & (a == a_))[0]
            part = row_sum(lanes, a_)
            if acc is None:
                acc = np.zeros((part.shape[0], SYS), part.dtype)
            acc[:, lanes] = part
        ga.append(acc)
    return np.stack([ga[a // LPB][:, group + a % LPB] for a in range(D)], -1)


def warp_eps_star_and_grad(q, m, eps_seed, alpha, flo, cap, *,
                           dtype=np.float64, eta=ETA):
    """(eps*, grad, info) of a (B, N, d) batch computed as the kernel's
    lanes compute it.  ``m`` is 0 on masked slots.  ``info``: the share
    of (lane, iterate) clip gates that are open and the number of
    non-finite reverse-sweep coefficients the guard zeroed."""
    f = lambda x: np.asarray(x, dtype)
    q, m = f(q), f(m)
    B, N, D = q.shape
    LPB = lanes_per_body(N)
    SPL = -(-N // LPB)
    SYS = _next_pow2(N) * LPB
    assert SYS <= 32
    lane = np.arange(SYS)
    i = lane // LPB
    j = (lane % LPB)[:, None] * SPL + np.arange(SPL)[None, :]
    body = i < N
    real = body[:, None] & (j < N) & (j != i[:, None])
    ib, jb = np.minimum(i, N - 1), np.minimum(j, N - 1)
    qi = np.where(body[None, :, None], q[:, ib], f(0))     # (B, SYS, D)
    qj = q[:, jb]                                          # (B, SYS, SPL, D)
    mi = np.where(body[None, :], m[:, ib], f(0))
    valid_i = mi > 0
    mval_i = np.where(valid_i, mi, f(0))
    mj = m[:, jb]
    mval_j = np.where(mj > 0, mj, f(0))
    col = lambda x: f(x)[:, None]
    flo, cap, alpha = col(flo), col(cap), col(alpha)
    zero = np.zeros((B, SYS), dtype)
    heads = np.arange(N) * LPB          # the first lane of each body

    with np.errstate(over="ignore", invalid="ignore", divide="ignore",
                     under="ignore"):
        r2 = np.zeros((B, SYS, SPL), dtype)
        for a in range(D):
            dx = qi[:, :, None, a] - qj[..., a]
            r2 = r2 + dx * dx
        h = np.minimum(np.maximum(col(eps_seed) + zero, flo), cap)
        one = np.ones_like(h)
        ih2, inv_hs = _group_div(
            [one, one], [np.maximum(h * h, f(1e-24)), np.maximum(h, f(1e-12))],
            LPB)
        store = []
        for _k in range(8):
            w = np.where(real, (f(INV_PI) * ih2)[..., None]
                         * np.exp(-r2 * ih2[..., None]), f(0))
            tS = mval_j * w
            tSd = mval_j * w * (f(-2) + f(2) * r2 * ih2[..., None]) \
                * inv_hs[..., None]
            S = _slot_sum(tS, i, N, SPL, LPB)
            Sd = _slot_sum(tSd, i, N, SPL, LPB)
            Ssafe = np.maximum(S, f(1e-30))
            G_raw = f(eta) * np.sqrt(mval_i / Ssafe)
            gate = (G_raw > flo) & (G_raw < cap)
            M2 = f(-2) * ih2
            h = np.minimum(np.maximum(G_raw, flo), cap)
            # the next iterate's 1 / h^2 and 1 / h, and this one's
            # -G_raw / (2 Ssafe), split across the group's lanes
            ih2, inv_hs, X = _group_div(
                [one, one, -G_raw],
                [np.maximum(h * h, f(1e-24)), np.maximum(h, f(1e-12)),
                 f(2) * Ssafe], LPB)
            store.append(dict(W=w, X=X, Sd=Sd, M2=M2, gate=gate))

        # softmin: body values in body order, every lane alike
        t_ = np.where(valid_i, -h / alpha, f(-1e30))
        tmax = t_[:, heads[0]]
        for b in heads[1:]:
            tmax = _maxf(tmax, t_[:, b])
        e = np.exp(t_ - tmax[:, None])
        ssum = np.zeros(B, dtype)
        for b in heads:
            ssum = ssum + e[:, b]
        es = -alpha[:, 0] * (tmax + np.log(ssum))
        u = e / ssum[:, None]

        # the reverse sweep's table: rows[k, b, a, p] in the order the
        # one-thread sweep adds the terms to g_b
        L = 2 * (N - 1)
        rows = np.full((B, 8, N, D, L), np.nan, dtype)
        guarded = 0
        for k in reversed(range(8)):
            st = store[k]
            c = np.where(st["gate"], u, f(0)) * st["X"]
            guarded += int((~np.isfinite(c) & body).sum())
            c = np.where(np.isfinite(c), c, f(0))
            for l_ in range(SYS):
                for t in range(SPL):
                    if not real[l_, t]:
                        continue
                    il, jl = int(i[l_]), int(j[l_, t])
                    coeff = (c[:, l_] * mval_j[:, l_, t] * st["W"][:, l_, t]
                             * st["M2"][:, l_])
                    out = il + (jl if jl < il else jl - 1)
                    inn = il if il < jl else il + N - 2
                    for a in range(D):
                        term = coeff * (qi[:, l_, a] - qj[:, l_, t, a])
                        rows[:, k, il, a, out] = term
                        rows[:, k, jl, a, inn] = -term
            u = c * st["Sd"]
        assert not np.isnan(rows).any() or np.isnan(q).any()

        def row_sum(lanes, a):
            """the rows (k = 8, ..., 1; in table order) of dimension a
            of the bodies of ``lanes``"""
            acc = np.zeros((B, len(lanes)), dtype)
            for k in reversed(range(8)):
                for p_ in range(L):
                    acc = acc + rows[:, k, i[lanes], a, p_]
            return acc

        gl = _group_rows(row_sum, body, LPB, D)      # (B, SYS, D)
        g = gl[:, heads]                             # each body's lanes agree
        assert all(np.array_equal(gl[:, heads + c], g, equal_nan=True)
                   for c in range(LPB))
        valid = m > 0
        g = np.where(valid[..., None] & np.isfinite(g), g, f(0))

    gates = np.stack([st["gate"] for st in store])[:, :, body & (lane % LPB == 0)]
    info = {"gate_open": float(gates.mean()), "guarded": guarded}
    return es, g, info


def one_thread_eps_star_and_grad(q, m, eps_seed, alpha, flo, cap, *,
                                 dtype=np.float32, eta=ETA):
    """``eps_star_and_grad`` of ``csrc/hamsoft_physics.cuh``, loop by
    loop (vectorised over the batch only)."""
    f = lambda x: np.asarray(x, dtype)
    q, m = f(q), f(m)
    B, N, D = q.shape
    flo, cap, alpha = f(flo), f(cap), f(alpha)
    valid = m > 0
    mval = np.where(valid, m, f(0))
    with np.errstate(over="ignore", invalid="ignore", divide="ignore",
                     under="ignore"):
        r2 = {}
        for a_ in range(N):
            for b_ in range(a_ + 1, N):
                acc = np.zeros(B, dtype)
                for a in range(D):
                    dx = q[:, a_, a] - q[:, b_, a]
                    acc = acc + dx * dx
                r2[a_, b_] = r2[b_, a_] = acc

        def terms(hi, i_):
            ih2 = f(1) / np.maximum(hi * hi, f(1e-24))
            inv_hs = f(1) / np.maximum(hi, f(1e-12))
            S, Sd, W = np.zeros(B, dtype), np.zeros(B, dtype), {}
            for j_ in range(N):
                if j_ == i_:
                    continue
                w = f(INV_PI) * ih2 * np.exp(-r2[i_, j_] * ih2)
                W[j_] = w
                S = S + mval[:, j_] * w
                Sd = Sd + mval[:, j_] * w * (f(-2) + f(2) * r2[i_, j_]
                                             * ih2) * inv_hs
            return S, Sd, W, ih2

        def solve(hi, i_):
            S = terms(hi, i_)[0]
            hn = f(eta) * np.sqrt(mval[:, i_] / np.maximum(S, f(1e-30)))
            return np.minimum(np.maximum(hn, flo), cap)

        H = [[np.minimum(np.maximum(f(eps_seed), flo), cap)] * N]
        for _k in range(8):
            H.append([solve(H[-1][i_], i_) for i_ in range(N)])
        t = [np.where(valid[:, i_], -H[8][i_] / alpha, f(-1e30))
             for i_ in range(N)]
        tmax = t[0]
        for i_ in range(1, N):
            tmax = _maxf(tmax, t[i_])
        ssum = np.zeros(B, dtype)
        for i_ in range(N):
            ssum = ssum + np.exp(t[i_] - tmax)
        es = -alpha * (tmax + np.log(ssum))
        u = [np.exp(t[i_] - tmax) / ssum for i_ in range(N)]
        g = np.zeros((B, N, D), dtype)
        for k in range(8, 0, -1):
            for i_ in range(N):
                S, Sd, W, ih2 = terms(H[k - 1][i_], i_)
                Ssafe = np.maximum(S, f(1e-30))
                G_raw = f(eta) * np.sqrt(mval[:, i_] / Ssafe)
                gate = (G_raw > flo) & (G_raw < cap)
                c = np.where(gate, u[i_], f(0)) * (-G_raw / (f(2) * Ssafe))
                c = np.where(np.isfinite(c), c, f(0))
                for j_ in range(N):
                    if j_ == i_:
                        continue
                    coeff = c * mval[:, j_] * W[j_] * (f(-2) * ih2)
                    for a in range(D):
                        d = q[:, i_, a] - q[:, j_, a]
                        g[:, i_, a] = g[:, i_, a] + coeff * d
                        g[:, j_, a] = g[:, j_, a] - coeff * d
                u[i_] = c * Sd
        g = np.where(valid[..., None] & np.isfinite(g), g, f(0))
    return es, g


def _jax_eps_grad(q, m, eps_seed, alpha, flo, cap, dtype):
    """``_build_physics(...).eps_star_and_grad`` of the JAX kernels,
    run eagerly on (B,) arrays."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pallas_hamsoft import _build_physics

    B, n, d = q.shape
    f = lambda x: jnp.asarray(np.asarray(x, dtype))
    mass = [f(m[:, i]) for i in range(n)]
    valid = [x > 0.0 for x in mass]
    inv_m = [jnp.where(v, 1.0 / jnp.maximum(x, 1e-30), 0.0)
             for x, v in zip(mass, valid)]
    one = jnp.ones((B,), dtype)
    ops = _build_physics(n, d, mass, valid, inv_m, one, one, f(alpha),
                         f(flo), f(cap), f(eps_seed), G=1.0, k_wall=0.0,
                         eta=ETA, jcap=0.02, bexp=5)
    es, g = ops.eps_star_and_grad([f(q[:, i, a]) for i in range(n)
                                   for a in range(d)])
    g = np.stack([np.asarray(x) for x in g], 1).reshape(B, n, d)
    return np.asarray(es), g


def _plain_eps_grad(q, m, eps_seed, alpha, flo, cap, dtype):
    """The port's plain (autograd) evaluation."""
    t = lambda x: torch.as_tensor(np.array(x, dtype))
    ph = hk._Physics(t(m), t(eps_seed), t(np.ones_like(alpha)),
                     t(np.ones_like(alpha)), t(alpha), t(flo), t(cap),
                     G=1.0, k_wall=0.0, eta=ETA, jcap=0.02, bexp=5)
    es, g = ph.eps_star_and_grad(t(q))
    return es.numpy(), g.numpy()


def _jax_built(m, q, v, mask, dtype):
    """(q, m, eps_seed, alpha, eps_min, eps_max) of a population built by
    the JAX package's ``build_batch``."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel.batch_engine import build_batch

    cfg = nb.SimConfig(integrator_mode="ham_soft",
                       fast_float32=dtype == np.float32)
    f = lambda x: jnp.asarray(np.asarray(x, dtype))
    st, dy = build_batch(f(m), f(q), f(v), jnp.asarray(mask), cfg, 1.0, 5e-2,
                         0.0, 0.01)
    mass = np.where(np.asarray(st.mask), np.asarray(st.mass), 0.0)
    return (np.asarray(st.pos, dtype), mass.astype(dtype),
            np.asarray(st.eps, dtype), np.asarray(dy.alpha_run, dtype),
            np.asarray(dy.min_softening, dtype),
            np.asarray(dy.max_softening, dtype))


def _dataset_rows():
    import pandas as pd

    cols = [f"{p}_{i}" for p in ("mass", "x", "y", "vx", "vy")
            for i in range(8)]
    df = pd.read_csv(DATA, comment="#", nrows=N_ROWS, usecols=cols)
    get = lambda p: df[[f"{p}_{i}" for i in range(8)]].to_numpy(np.float64)
    mass = get("mass")
    mask = np.isfinite(mass)
    clean = lambda a: np.where(np.isfinite(a), a, 0.0)
    pos = np.stack([get("x"), get("y")], -1)
    vel = np.stack([get("vx"), get("vy")], -1)
    return clean(mass), clean(pos), clean(vel), mask


def _saturated(inputs):
    """The clip gate shut on every other row (eps_max = 1.01 eps_min)
    and the bodies of every fourth row spread 300-fold."""
    q, m, eps, alpha, flo, cap = (np.array(x) for x in inputs)
    cap[::2] = flo[::2] * 1.01
    q[1::4] *= 300.0
    return q, m, eps, alpha, flo, cap


def _full8(B=64, seed=5):
    """Eight bodies in every system, none masked: a seeded cluster at a
    radius where about 40% of the clip gates are open."""
    rng = np.random.default_rng(seed)
    q = 0.2 * rng.normal(size=(B, 8, 2))
    v = 0.3 * rng.normal(size=(B, 8, 2))
    m = rng.uniform(0.2, 1.0, size=(B, 8))
    return m, q, v, np.ones((B, 8), bool)


def _port_built(m, q, v, mask, dtype):
    """The same inputs as ``_jax_built``, built by the port's
    ``build_batch`` on the CPU."""
    from nbodysimproject_tpu_torch.parallel.batch_engine import \
        build_batch as port_build

    cfg = nt.SimConfig(integrator_mode="ham_soft",
                       fast_float32=dtype == np.float32)
    t = lambda x: torch.as_tensor(np.asarray(x, dtype))
    st, dy = port_build(t(m), t(q), t(v), torch.as_tensor(mask), cfg, 1.0,
                        5e-2, 0.0, 0.01)
    mass = torch.where(st.mask, st.mass, torch.zeros_like(st.mass))
    return tuple(x.numpy().astype(dtype) for x in (
        st.pos, mass, st.eps, dy.alpha_run, dy.min_softening,
        dy.max_softening))


def _cluster(n, d, lo=None, B=64, seed=9, scale=0.2):
    """Seeded clusters of n bodies at d (``_full8``'s draw); with ``lo``
    each system keeps its first lo to n bodies, the rest masked."""
    rng = np.random.default_rng(seed + 100 * n + d)
    q = scale * rng.normal(size=(B, n, d))
    v = 0.3 * rng.normal(size=(B, n, d))
    m = rng.uniform(0.2, 1.0, size=(B, n))
    count = np.full(B, n) if lo is None else rng.integers(lo, n + 1, B)
    mask = np.arange(n)[None, :] < count[:, None]
    return (np.where(mask, m, 0.0), np.where(mask[..., None], q, 0.0),
            np.where(mask[..., None], v, 0.0), mask)


#: the other slot counts: (n, d, least bodies or None, cluster scale),
#: built by the port (LPB 4 at N = 2; LPB 2 at N = 12 and 16)
PORT_CASES = {
    "n2": (2, 2, None, 0.01),
    **{f"n{n}_d{d}{'_masked' if lo else ''}": (n, d, lo, 0.3)
       for n in (12, 16) for d in (2, 3) for lo in (None, 9)},
}
CASES = ("dataset8", "full8", "n3", "n4_masked", "saturated", "n5_masked") \
    + tuple(PORT_CASES)


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def populations():
    """{(case, dtype): the eps* inputs of the case, built by JAX}"""
    out = {}
    for dtype in (np.float64, np.float32):
        m, q, v, mask = _dataset_rows()
        ds = _jax_built(m, q, v, mask, dtype)
        out[("dataset8", dtype)] = ds
        out[("saturated", dtype)] = _saturated(ds)
        out[("full8", dtype)] = _jax_built(*_full8(), dtype)
        count = mask.sum(1)
        for case, n, rows in (("n3", 3, count == 3),
                              ("n4_masked", 4, count <= 4)):
            out[(case, dtype)] = _jax_built(m[rows, :n], q[rows, :n],
                                            v[rows, :n], mask[rows, :n],
                                            dtype)
        rows = ~mask[:, 5:].any(1)     # the bodies in the first 5 slots
        out[("n5_masked", dtype)] = _port_built(
            m[rows, :5], q[rows, :5], v[rows, :5], mask[rows, :5], dtype)
        for case, (n, d, lo, scale) in PORT_CASES.items():
            out[(case, dtype)] = _port_built(*_cluster(n, d, lo,
                                                       scale=scale), dtype)
    return out


def _assert_grad_close(got, ref, rtol, what):
    """|got - ref| <= rtol (|ref| + the row's largest |ref|)"""
    scale = np.abs(ref).reshape(len(ref), -1).max(1)[:, None, None]
    err = np.abs(got - ref)
    bad = err > rtol * (np.abs(ref) + scale)
    assert not bad.any(), (f"{what}: {int(bad.sum())} entries off, "
                           f"max error {err.max():.3e}")


@pytest.mark.parametrize("case", CASES)
def test_warp_algebra_float64(populations, case):
    inputs = populations[(case, np.float64)]
    es, g, info = warp_eps_star_and_grad(*inputs)
    assert 0.0 < info["gate_open"] < 1.0
    assert np.abs(g).max() > 1e-3  # gradients are exercised
    for name, (es_r, g_r) in (
            ("JAX", _jax_eps_grad(*inputs, np.float64)),
            ("port plain", _plain_eps_grad(*inputs, np.float64))):
        np.testing.assert_allclose(es, es_r, rtol=1e-12, atol=0.0,
                                   err_msg=f"eps* vs {name}")
        _assert_grad_close(g, g_r, 1e-12, f"grad vs {name}")
    if case == "saturated":
        # rows whose clip saturates at every iterate carry no gradient
        assert not g[::2].any()


@pytest.mark.parametrize("case", CASES)
def test_warp_algebra_float32(populations, case):
    inputs = populations[(case, np.float32)]
    es, g, info = warp_eps_star_and_grad(*inputs, dtype=np.float32)
    assert es.dtype == np.float32 and g.dtype == np.float32
    if case == "saturated":
        assert info["guarded"] > 0  # the finite guard fired
        assert not g[::2].any()
    rtol, atol = STATE_TOL
    for name, (es_r, g_r) in (
            ("JAX", _jax_eps_grad(*inputs, np.float32)),
            ("port plain", _plain_eps_grad(*inputs, np.float32))):
        assert np.isfinite(es_r).all() and np.isfinite(g_r).all()
        np.testing.assert_allclose(es, es_r, rtol=rtol, atol=atol,
                                   err_msg=f"eps* vs {name}")
        np.testing.assert_allclose(g, g_r, rtol=rtol, atol=atol,
                                   err_msg=f"grad vs {name}")


@pytest.mark.parametrize("case", CASES)
def test_warp_algebra_is_the_one_thread_order(populations, case):
    """float32: the lanes' ordered sums and the reverse sweep's table
    give eps* and the gradient bit for bit as the one-thread loops."""
    inputs = populations[(case, np.float32)]
    es, g, info = warp_eps_star_and_grad(*inputs, dtype=np.float32)
    es_r, g_r = one_thread_eps_star_and_grad(*inputs, dtype=np.float32)
    assert info["gate_open"] > 0.0 and np.abs(g).max() > 1e-3
    np.testing.assert_array_equal(_bits(es), _bits(es_r))
    np.testing.assert_array_equal(_bits(g), _bits(g_r))


@pytest.mark.parametrize("n_sub_max", (1, 64, 256))
def test_deepest_first_is_a_stable_descending_permutation(n_sub_max):
    """Trip counts min(max(n_sub, 1), n_sub_max), deepest first; systems
    with equal counts (every system at n_sub_max = 1) keep their batch
    order."""
    rng = np.random.default_rng(7)
    n_sub = torch.as_tensor(rng.integers(-2, 400, 3000), dtype=torch.int32)
    order = hk.deepest_first(n_sub, n_sub_max)
    assert order.dtype == torch.int32
    o = order.numpy().astype(np.int64)
    assert np.array_equal(np.sort(o), np.arange(len(o)))
    trips = np.clip(n_sub.numpy(), 1, n_sub_max)[o]
    assert np.all(np.diff(trips) <= 0)                # deepest first
    ties = np.diff(trips) == 0
    assert np.all(np.diff(o)[ties] > 0)               # ties keep their order
    assert trips[0] == n_sub_max and trips[-1] == 1
    if n_sub_max == 1:
        assert np.array_equal(o, np.arange(len(o)))
