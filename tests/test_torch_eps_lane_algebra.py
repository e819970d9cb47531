"""The eps kernel's lane layout, one lane per body, as algebra on the CPU.

``csrc/eps_grad.cu`` runs systems of N >= 4 body slots (the dataset's
8-slot systems) one lane per body, floor(32 / N) systems a warp: body
i's 8-iterate SPH chain needs only h_i and the pair distances, so the
lane of body i runs it alone and keeps only its own kernel terms.  Two
sums cross the lanes:

* the softmin: every lane reads t_j and exp(t_j - t_max) of the system's
  bodies by shuffle and takes their maximum and sum in ascending j, as
  the one-thread loop does;
* the reverse sweep's coefficient c = u X of body i: the kernel divides
  for X = -G_raw / (2 S) only where the clip gate is open and takes
  c = 0 where it is shut, where the one-thread sweep takes 0 X (a zero of
  either sign, or a NaN that its finite guard zeroes): no bit of eps* or
  the gradient changes, which the saturated rows show;
* the reverse sweep's scatter: the lane of body i computes coeff_ijk for
  its slots j != i; in rotation r = 1..N-1 every lane sends its coeff for
  body (i + r) % N and receives coeff_{src,i} from src = (i - r) % N; then
  each lane adds its own body's gradient terms in the one-thread order:
  for each iterate k descending, -coeff_{src,i} (q_src - q_i) for
  src < i, +coeff_{i,j} (q_i - q_j) for j ascending, -coeff_{src,i}
  (q_src - q_i) for src > i.

No CUDA runs here, so this file re-implements the layout lane by lane in
numpy float32 (``lane_eps_star_and_grad``, the shuffles as index reads)
and holds it bit for bit to the one-thread kernel's loops, re-implemented
from ``csrc/hamsoft_physics.cuh`` (``one_thread_eps_star_and_grad`` of
``tests/test_torch_hamsoft_warp_algebra.py``, the parent kernel's
recomputing sweep, and ``kept_eps_star_and_grad`` of
``tests/test_torch_hamsoft_trip_algebra.py``, the kept-term form that the
N <= 3 layout runs), under both clamp settings: that is why the N = 3
and N = 8 builds give the same bits on a 3-body system.  The layout is
written for any N, so it is held at N = 3 as well as at 4 and 8.
Systems (built by the JAX package's ``build_batch``): the dataset's
3-body rows in 3 slots, seeded 3-body clusters, the 3-body rows with the
clip gate saturated and their bodies spread 300-fold (the finite guard
fires), the dataset's 3- and 4-body rows in 4 slots and seeded 8-body
clusters.  The kernel on the card is held to the same bits by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

from test_torch_hamsoft_trip_algebra import kept_eps_star_and_grad
from test_torch_hamsoft_warp_algebra import (ETA, INV_PI, _bits, _full8,
                                             _jax_built, _maxf, _saturated,
                                             one_thread_eps_star_and_grad,
                                             populations)

f32 = np.float32
assert populations  # the module fixture, used by name below


def _minf(a, b):
    return np.where((a < b) | np.isnan(a), a, b)


def lane_eps_star_and_grad(q, m, eps_seed, alpha, emin, emax, *,
                           clamp=False, eta=ETA):
    """``eps_grad_lane`` of ``csrc/eps_grad.cu``, lane by lane: lane i of
    a system holds q of all bodies, its own body's slots j != i (slot t
    is body t for t < i, t + 1 for t >= i) and only its own body's kept
    terms; a shuffle from lane j is a read of lane j's value.  Returns
    (es, grad) as the kernel writes them."""
    q, m = f32(q), f32(m)
    B, N, D = q.shape
    emin, emax, alpha = f32(emin), f32(emax), f32(alpha)
    lo, hi = _minf(emin, emax), _maxf(emin, emax)
    flo = _maxf(lo, f32(1e-12))
    cap = _maxf(flo, hi)
    valid = m > 0
    mval = np.where(valid, m, f32(0))
    slots = [[t if t < i else t + 1 for t in range(N - 1)] for i in range(N)]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore",
                     under="ignore"):
        lanes = []
        for i in range(N):  # each lane's forward chain, on its own
            r2 = []
            for j in slots[i]:
                acc = np.zeros(B, f32)
                for a in range(D):
                    dx = q[:, i, a] - q[:, j, a]  # dx^2 is even in dx
                    acc = acc + dx * dx
                r2.append(acc)
            h = _minf(_maxf(f32(eps_seed), flo), cap)
            W, Sd, X, M2, gate = [], [], [], [], []
            for _k in range(8):
                ih2 = f32(1) / _maxf(h * h, f32(1e-24))
                inv_hs = f32(1) / _maxf(h, f32(1e-12))
                S, sd, Wk = np.zeros(B, f32), np.zeros(B, f32), []
                for t, j in enumerate(slots[i]):
                    w = f32(INV_PI) * ih2 * np.exp(-r2[t] * ih2)
                    Wk.append(w)
                    S = S + mval[:, j] * w
                    sd = sd + mval[:, j] * w * (f32(-2) + f32(2) * r2[t]
                                                * ih2) * inv_hs
                Ssafe = _maxf(S, f32(1e-30))
                G_raw = f32(eta) * np.sqrt(mval[:, i] / Ssafe)
                open_ = (G_raw > flo) & (G_raw < cap)
                gate.append(open_)
                # the kernel divides only where the gate is open
                X.append(np.where(open_, -G_raw / (f32(2) * Ssafe), f32(0)))
                Sd.append(sd)
                M2.append(f32(-2) * ih2)
                W.append(Wk)
                h = _minf(_maxf(G_raw, flo), cap)
            lanes.append(dict(h=h, W=W, Sd=Sd, X=X, M2=M2, gate=gate))
        # the softmin: every lane reads t_j, then e_j, from lane j
        t = [np.where(valid[:, i], -lanes[i]["h"] / alpha, f32(-1e30))
             for i in range(N)]
        tmax = t[0]
        for j in range(1, N):
            tmax = _maxf(tmax, t[j])
        e = [np.exp(t[i] - tmax) for i in range(N)]
        ssum = np.zeros(B, f32)
        for j in range(N):
            ssum = ssum + e[j]
        es = -alpha * (tmax + np.log(ssum))
        u = [e[i] / ssum for i in range(N)]
        g = [[np.zeros(B, f32) for _ in range(D)] for _ in range(N)]
        for k in range(7, -1, -1):
            coeff = []
            for i in range(N):
                L = lanes[i]
                c = np.where(L["gate"][k], u[i] * L["X"][k], f32(0))
                c = np.where(np.isfinite(c), c, f32(0))
                coeff.append([c * mval[:, j] * L["W"][k][t_] * L["M2"][k]
                              for t_, j in enumerate(slots[i])])
                u[i] = c * L["Sd"][k]
            # rotation r: lane i sends coeff[i][slot of (i + r) % N] and
            # receives it from lane (i - r) % N
            recv = [[None] * N for _ in range(N)]
            for r in range(1, N):
                send = [coeff[s][slots[s].index((s + r) % N)]
                        for s in range(N)]
                for i in range(N):
                    recv[i][r] = send[(i - r) % N]
            for i in range(N):
                for src in range(N):
                    if src == i:
                        for t_, j in enumerate(slots[i]):
                            for a in range(D):
                                g[i][a] = g[i][a] + coeff[i][t_] * (
                                    q[:, i, a] - q[:, j, a])
                    else:
                        cf = recv[i][(i - src) % N]
                        for a in range(D):
                            g[i][a] = g[i][a] - cf * (q[:, src, a]
                                                      - q[:, i, a])
        g = np.stack([np.stack(gi, -1) for gi in g], 1)
        g = np.where(valid[..., None] & np.isfinite(g), g, f32(0))
        if clamp:
            open_ = (es >= lo) & (es <= hi)
            g = np.where(open_[:, None, None], g, f32(0))
            es = _minf(_maxf(es, lo), hi)
    return es, g


def _one_thread(inputs, clamp, sweep=one_thread_eps_star_and_grad):
    """The one-thread kernel's (es, grad), its bound resolution and clamp
    (``csrc/eps_grad.cu`` of the parent layout) around ``sweep``."""
    q, m, seed, alpha, emin, emax = inputs
    emin, emax = f32(emin), f32(emax)
    lo, hi = _minf(emin, emax), _maxf(emin, emax)
    flo = _maxf(lo, f32(1e-12))
    cap = _maxf(flo, hi)
    if sweep is one_thread_eps_star_and_grad:
        es, g = sweep(q, m, seed, alpha, flo, cap, dtype=np.float32)
    else:
        es, g = sweep(q, m, seed, alpha, flo, cap)
    if clamp:
        open_ = (es >= lo) & (es <= hi)
        g = np.where(open_[:, None, None], g, f32(0))
        es = _minf(_maxf(es, lo), hi)
    return es, g


def _cluster3(B=64, seed=9):
    """Seeded 3-body clusters, none masked, at a radius where the clip
    gates are partly open."""
    rng = np.random.default_rng(seed)
    q = 0.3 * rng.normal(size=(B, 3, 2))
    v = 0.3 * rng.normal(size=(B, 3, 2))
    m = rng.uniform(0.2, 1.0, size=(B, 3))
    return m, q, v, np.ones((B, 3), bool)


@pytest.fixture(scope="module")
def lane_cases(populations):
    n3 = populations[("n3", np.float32)]
    return {"dataset3": n3,
            "clusters3": _jax_built(*_cluster3(), np.float32),
            "saturated3": _saturated(n3),
            "dataset4_masked": populations[("n4_masked", np.float32)],
            "clusters8": _jax_built(*_full8(), np.float32)}


CASES = ("dataset3", "clusters3", "saturated3", "dataset4_masked",
         "clusters8")


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_lane_layout_is_the_one_thread_kernel(lane_cases, case, clamp):
    """float32: the lanes' chains, the shuffled softmin and the rotated
    scatter give eps* and the gradient bit for bit as the one-thread
    kernel, with its recomputing sweep and with its kept terms."""
    inputs = lane_cases[case]
    es, g = lane_eps_star_and_grad(*inputs, clamp=clamp)
    assert es.dtype == np.float32 and g.dtype == np.float32
    for sweep in (one_thread_eps_star_and_grad, kept_eps_star_and_grad):
        es_r, g_r = _one_thread(inputs, clamp, sweep)
        np.testing.assert_array_equal(_bits(es), _bits(es_r))
        np.testing.assert_array_equal(_bits(g), _bits(g_r))
    if case == "saturated3":
        # rows whose clip saturates at every iterate carry no gradient
        assert not g[::2].any()
    else:
        assert np.abs(g).max() > 1e-3  # the scatter is exercised


def test_lane_cases_exercise_the_guards(lane_cases):
    """The populations reach what the layout must keep: open and shut
    clip gates at N = 3, the clamp saturating on some rows, and the
    float32 backward overflowing on the spread rows (the finite guard)."""
    q, m, seed, alpha, emin, emax = lane_cases["saturated3"]
    es, g = lane_eps_star_and_grad(q, m, seed, alpha, emin, emax)
    spread = np.zeros(len(q), bool)
    spread[1::4] = True
    assert not g[spread].any()
    es_c, _ = lane_eps_star_and_grad(q, m, seed, alpha, emin, emax,
                                     clamp=True)
    assert (es_c != es).any() and (es_c == es).any()
    _, g3 = lane_eps_star_and_grad(*lane_cases["clusters3"])
    rows = (np.abs(g3).reshape(len(g3), -1).max(1) > 0)
    assert 0 < rows.sum() < len(rows)
