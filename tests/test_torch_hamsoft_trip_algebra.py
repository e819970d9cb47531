"""The multi-step kernel's two layouts, as algebra, on the CPU.

``csrc/hamsoft_multistep.cu`` runs one thread per system at N = 3
(``csrc/hamsoft_physics.cuh``, whose forward SPH pass now keeps the kernel
terms W_ij, dS_i/dh, -G_raw / (2 S_i), the clip gate and -2 / h^2 for the
reverse sweep; ``csrc/eps_grad.cu`` shares it at N <= 3) and a warp per
system at N = 4 and 8 (``csrc/hamsoft_physics_warp.cuh``, which now folds
(eps, pi) under the reflection policy).  No CUDA runs here, so this file
re-implements the Strang trip in numpy float32, loop by loop as the
kernels run it:

* ``kept_eps_star_and_grad``: the one-thread eps* gradient with kept
  terms.  Bit for bit the recomputing sweep it replaces
  (``one_thread_eps_star_and_grad`` of
  ``tests/test_torch_hamsoft_warp_algebra.py``, the parent kernel's
  loops), on dataset rows in 8, 4 and 3 slots, seeded 8-body clusters
  and saturated-gate rows.
* ``trip``: the one-thread trip (S V T V S, the folds of the reflection
  policy, the soft wall), with either sweep, run for several trips at
  N = 3 and 4 under the soft and reflection policies: the kept-term
  trajectory equals the recomputing one bit for bit and lies within
  STATE_TOL (rtol 1e-4, atol 1e-5) of ``hamsoft_multistep_plain``, the
  plain PyTorch version, run in float64.  The plain version's autograd
  sums run in another order than the sweep's, so no float32 run of it
  has the kernels' bits; near the soft wall its own float32 run lies
  1.4e-5 from its float64 run in pi, where the kept-term trip lies
  7.5e-6 from it.
* ``warp_trip``: the same trip as the warp's lanes compute it: the
  lane-split eps* gradient (``warp_eps_star_and_grad``), the kicks as
  slot sums and pair sums over the lanes' terms, the J-cap's maxima over
  the lanes and the fold on the (eps, pi) every lane holds.  Under the
  reflection policy it equals the one-thread trip bit for bit at N = 8
  and N = 3, and a 3-body system in 8 slots (5 masked) moves its bodies
  bit for bit as in 3 slots.
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
from nbodysimproject_tpu_torch.parallel.batch_engine import build_batch
from test_torch_hamsoft_warp_algebra import (ETA, INV_PI, STATE_TOL, _bits,
                                             _dataset_rows, _maxf,
                                             lanes_per_body,
                                             one_thread_eps_star_and_grad,
                                             populations,
                                             warp_eps_star_and_grad)

f32 = np.float32
assert populations  # the module fixture, used by name below
CASES = ("dataset8", "full8", "n3", "n4_masked", "saturated")


def _minf(a, b):
    return np.where((a < b) | np.isnan(a), a, b)


def kept_eps_star_and_grad(q, m, eps_seed, alpha, flo, cap, *, eta=ETA):
    """``eps_star_and_grad`` of ``csrc/hamsoft_physics.cuh``: the forward
    pass keeps each iterate's kernel terms (-G_raw / (2 S) only where the
    clip gate is open: elsewhere the sweep's c is 0 without it), the
    reverse sweep reads them (float32, vectorised over the batch only)."""
    q, m = f32(q), f32(m)
    B, N, D = q.shape
    flo, cap, alpha = f32(flo), f32(cap), f32(alpha)
    valid = m > 0
    mval = np.where(valid, m, f32(0))
    with np.errstate(over="ignore", invalid="ignore", divide="ignore",
                     under="ignore"):
        r2 = {}
        for a_ in range(N):
            for b_ in range(a_ + 1, N):
                acc = np.zeros(B, f32)
                for a in range(D):
                    dx = q[:, a_, a] - q[:, b_, a]
                    acc = acc + dx * dx
                r2[a_, b_] = r2[b_, a_] = acc
        h = [_minf(_maxf(f32(eps_seed), flo), cap)] * N
        W, Sd, X, M2, gate = {}, {}, {}, {}, {}
        for k in range(8):
            hn = []
            for i in range(N):
                ih2 = f32(1) / _maxf(h[i] * h[i], f32(1e-24))
                inv_hs = f32(1) / _maxf(h[i], f32(1e-12))
                S, sd = np.zeros(B, f32), np.zeros(B, f32)
                for j in range(N):
                    if j == i:
                        continue
                    w = f32(INV_PI) * ih2 * np.exp(-r2[i, j] * ih2)
                    W[k, i, j] = w
                    S = S + mval[:, j] * w
                    sd = sd + mval[:, j] * w * (f32(-2) + f32(2) * r2[i, j]
                                                * ih2) * inv_hs
                Ssafe = _maxf(S, f32(1e-30))
                G_raw = f32(eta) * np.sqrt(mval[:, i] / Ssafe)
                gate[k, i] = (G_raw > flo) & (G_raw < cap)
                # divided only where the gate is open
                X[k, i] = np.where(gate[k, i], -G_raw / (f32(2) * Ssafe),
                                   f32(0))
                Sd[k, i] = sd
                M2[k, i] = f32(-2) * ih2
                hn.append(_minf(_maxf(G_raw, flo), cap))
            h = hn
        t = [np.where(valid[:, i], -h[i] / alpha, f32(-1e30))
             for i in range(N)]
        tmax = t[0]
        for i in range(1, N):
            tmax = _maxf(tmax, t[i])
        ssum = np.zeros(B, f32)
        for i in range(N):
            ssum = ssum + np.exp(t[i] - tmax)
        es = -alpha * (tmax + np.log(ssum))
        u = [np.exp(t[i] - tmax) / ssum for i in range(N)]
        g = np.zeros((B, N, D), f32)
        for k in range(7, -1, -1):
            for i in range(N):
                c = np.where(gate[k, i], u[i] * X[k, i], f32(0))
                c = np.where(np.isfinite(c), c, f32(0))
                for j in range(N):
                    if j == i:
                        continue
                    coeff = c * mval[:, j] * W[k, i, j] * M2[k, i]
                    for a in range(D):
                        d = q[:, i, a] - q[:, j, a]
                        g[:, i, a] = g[:, i, a] + coeff * d
                        g[:, j, a] = g[:, j, a] - coeff * d
                u[i] = c * Sd[k, i]
        g = np.where(valid[..., None] & np.isfinite(g), g, f32(0))
    return es, g


class Sys:
    """A batch's per-system constants as the kernels hold them."""

    def __init__(self, m, eps_seed, kw, policy):
        self.mass = f32(m)
        self.valid = self.mass > 0
        self.mval = np.where(self.valid, self.mass, f32(0))
        self.inv_m = np.where(self.valid,
                              f32(1) / _maxf(self.mass, f32(1e-30)), f32(0))
        self.eps_seed = f32(eps_seed)
        for k in ("k_soft", "mu", "alpha", "eps_min", "eps_max", "h"):
            setattr(self, k, f32(kw[k]))
        self.flo, self.cap = self.eps_min, self.eps_max
        self.G, self.k_wall, self.eta, self.jcap = (
            f32(kw[k]) for k in ("G", "k_wall", "eta", "jcap"))
        self.bexp = int(kw["bexp"])
        self.barrier_on = policy == "soft" and kw["k_wall"] > 0 \
            and self.bexp >= 2
        self.refl = policy == "reflection"


def _rsqrt(x):
    return (1.0 / np.sqrt(x.astype(np.float64))).astype(f32)


def bar_force(s, e):
    left = _maxf(f32(0), s.flo - e)
    right = _maxf(f32(0), e - s.cap)
    le, re = np.ones_like(e), np.ones_like(e)
    for _ in range(s.bexp - 2):
        le = le * left
        re = re * right
    return s.k_wall * (le - re)


def fold(s, e, p):
    """``fold_eps`` of ``csrc/hamsoft_physics.cuh``."""
    R = s.cap - s.flo
    Pw = f32(2) * R
    Psafe = np.where(Pw > 0, Pw, f32(1))
    x = e - s.flo
    y = x - Psafe * np.floor(x / Psafe)
    y = np.where(Pw > 0, y, f32(0))
    on_up = y <= R
    e_out = np.where(on_up, s.flo + y, s.cap - (y - R))
    p_out = np.where(on_up, p, -p)
    ok = np.isfinite(R) & (R > 0)
    return np.where(ok, e_out, s.flo), np.where(ok, p_out, -p)


def spring(s, eps, pi, es):
    """The S(h/2) rotation: (eps_new, pi_new, J)."""
    dt_f = f32(0.5) * s.h
    omega = np.sqrt(s.k_soft / s.mu)
    theta = omega * dt_f
    th2 = theta * theta
    s_ser = theta * (f32(1) - th2 / f32(6) * (f32(1) - th2 / f32(20)))
    c_ser = f32(1) - th2 / f32(2) * (f32(1) - th2 / f32(12))
    small = np.abs(theta) < f32(1e-8)
    sin_t = np.where(small, s_ser, np.sin(theta))
    cos_t = np.where(small, c_ser, np.cos(theta))
    pi_in = pi + f32(0.5) * dt_f * bar_force(s, eps) if s.barrier_on else pi
    D0 = eps - es
    mu_om = np.sqrt(s.mu * s.k_soft)
    delta_t = D0 * cos_t + (pi_in / (s.mu * omega)) * sin_t
    eta_t = pi_in * cos_t - mu_om * D0 * sin_t
    I_tau = (D0 / omega) * sin_t + (pi_in / (s.mu * omega * omega)) \
        * (f32(1) - cos_t)
    eps_new = es + delta_t
    pi_new = eta_t + f32(0.5) * dt_f * bar_force(s, eps_new) \
        if s.barrier_on else eta_t
    return eps_new, pi_new, s.k_soft * I_tau


def s_half(s, vel, eps, pi, es, grad):
    """``s_half`` of the one-thread physics."""
    if s.refl:
        eps, pi = fold(s, eps, pi)
    eps_new, pi_new, J = spring(s, eps, pi, es)
    absJ = np.abs(J)
    B, N, D = vel.shape
    p_scale, dp_inf = np.zeros(B, f32), np.zeros(B, f32)
    for i in range(N):
        p2, g2 = np.zeros(B, f32), np.zeros(B, f32)
        for a in range(D):
            pv = s.mass[:, i] * vel[:, i, a]
            p2 = p2 + pv * pv
            g2 = g2 + grad[:, i, a] * grad[:, i, a]
        p_scale = _maxf(p_scale, np.where(s.valid[:, i], np.sqrt(p2),
                                          f32(0)))
        dp_inf = _maxf(dp_inf, np.where(s.valid[:, i], absJ * np.sqrt(g2),
                                        f32(0)))
    p_scale = _maxf(p_scale, f32(1e-12))
    thr = s.jcap * p_scale
    scale = np.where(dp_inf > thr, thr / _maxf(dp_inf, f32(1e-30)), f32(1))
    Ja = J * scale
    vel = vel + Ja[:, None, None] * grad * s.inv_m[..., None]
    if s.refl:
        eps_new, pi_new = fold(s, eps_new, pi_new)
    return vel, eps_new, pi_new


def v_half_kick(s, pos, vel, eps, pi):
    """``v_half_kick`` of the one-thread physics: the pair loop."""
    B, N, D = pos.shape
    h2 = f32(0.5) * s.h
    eps2 = eps * eps
    acc = np.zeros((B, N, D), f32)
    ddU = np.zeros(B, f32)
    for i in range(N):
        for j in range(i + 1, N):
            r2 = eps2
            dx = [pos[:, i, a] - pos[:, j, a] for a in range(D)]
            for a in range(D):
                r2 = r2 + dx[a] * dx[a]
            inv_r = _rsqrt(r2)
            w = inv_r * inv_r * inv_r
            pairm = np.where(s.valid[:, i] & s.valid[:, j],
                             s.mass[:, i] * s.mass[:, j], f32(0))
            ddU = ddU + pairm * w
            wi = np.where(s.valid[:, j], s.mass[:, j], f32(0)) * w
            wj = np.where(s.valid[:, i], s.mass[:, i], f32(0)) * w
            for a in range(D):
                acc[:, i, a] = acc[:, i, a] - wi * dx[a]
                acc[:, j, a] = acc[:, j, a] + wj * dx[a]
    vel = vel + (h2 * s.G)[:, None, None] * acc
    dU = s.G * eps * ddU
    pi = pi - h2 * (dU - bar_force(s, eps)) if s.barrier_on else pi - h2 * dU
    return vel, pi


def trip(s, pos, vel, eps, pi, es, grad, eps_grad):
    """``strang_trip`` of the one-thread physics, with the eps* gradient
    ``eps_grad(pos)``."""
    if s.refl:
        eps, pi = fold(s, eps, pi)
    vel, eps, pi = s_half(s, vel, eps, pi, es, grad)
    vel, pi = v_half_kick(s, pos, vel, eps, pi)
    pos = pos + s.h[:, None, None] * vel
    vel, pi = v_half_kick(s, pos, vel, eps, pi)
    es, grad = eps_grad(pos)
    vel, eps, pi = s_half(s, vel, eps, pi, es, grad)
    if s.refl:
        eps, pi = fold(s, eps, pi)
    return pos, vel, eps, pi, es, grad


def _warp_slots(N):
    """(body i, slot bodies j, real, slots per lane, lanes per body) of
    a system's lanes."""
    LPB = lanes_per_body(N)
    SPL = -(-N // LPB)
    SYS = 1
    while SYS < N:
        SYS *= 2
    lane = np.arange(SYS * LPB)
    i = lane // LPB
    j = (lane % LPB)[:, None] * SPL + np.arange(SPL)[None, :]
    real = (i[:, None] < N) & (j < N) & (j != i[:, None])
    return i, j, real, SPL, LPB


def warp_s_half(s, vel, eps, pi, es, grad):
    """``s_half_w``: the per-system scalars as every lane holds them, the
    J-cap's maxima over the bodies' lanes."""
    if s.refl:
        eps, pi = fold(s, eps, pi)
    eps_new, pi_new, J = spring(s, eps, pi, es)
    absJ = np.abs(J)
    B, N, D = vel.shape
    p2 = np.zeros((B, N), f32)
    g2 = np.zeros((B, N), f32)
    for a in range(D):
        pv = s.mass * vel[..., a]
        p2 = p2 + pv * pv
        g2 = g2 + grad[..., a] * grad[..., a]
    take = s.valid
    p_scale = np.where(take, np.sqrt(p2), f32(0)).max(1)
    dp_inf = np.where(take, absJ[:, None] * np.sqrt(g2), f32(0)).max(1)
    p_scale = _maxf(p_scale, f32(1e-12))
    thr = s.jcap * p_scale
    scale = np.where(dp_inf > thr, thr / _maxf(dp_inf, f32(1e-30)), f32(1))
    Ja = J * scale
    vel = vel + Ja[:, None, None] * grad * s.inv_m[..., None]
    if s.refl:
        eps_new, pi_new = fold(s, eps_new, pi_new)
    return vel, eps_new, pi_new


def warp_v_half_kick(s, pos, vel, eps, pi):
    """``v_half_kick_w``: each lane's slot terms -m_j w (q_i - q_j) and
    m_i m_j w, added in ascending j per body (slot_sum) and over the
    pairs i < j (pair_sum)."""
    B, N, D = pos.shape
    i, j, real, SPL, LPB = _warp_slots(N)
    ib, jb = np.minimum(i, N - 1), np.minimum(j, N - 1)
    h2 = f32(0.5) * s.h
    eps2 = eps * eps
    qi, qj = pos[:, ib], pos[:, jb]          # (B, L, D), (B, L, S, D)
    dx = qi[:, :, None, :] - qj
    r2 = np.broadcast_to(eps2[:, None, None], dx.shape[:3]).astype(f32)
    for a in range(D):
        r2 = r2 + dx[..., a] * dx[..., a]
    inv_r = _rsqrt(r2)
    w = inv_r * inv_r * inv_r
    mval_j = s.mval[:, jb]
    valid_i = s.valid[:, ib] & (i < N)[None, :]
    pw = np.where(valid_i[..., None] & (mval_j > 0),
                  s.mass[:, ib][..., None] * mval_j, f32(0)) * w
    f = -((mval_j * w)[..., None] * dx)                # (B, L, S, D)
    head = np.arange(N) * LPB                         # a body's first lane
    acc = np.zeros((B, N, D), f32)
    for b_ in range(N):
        for jj in range(N):                           # ascending j != b
            if jj == b_:
                continue
            acc[:, b_] = acc[:, b_] + f[:, head[b_] + jj // SPL, jj % SPL]
    ddU = np.zeros(B, f32)
    for a_ in range(N):
        for b_ in range(a_ + 1, N):
            ddU = ddU + pw[:, head[a_] + b_ // SPL, b_ % SPL]
    vel = vel + (h2 * s.G)[:, None, None] * acc
    dU = s.G * eps * ddU
    pi = pi - h2 * (dU - bar_force(s, eps)) if s.barrier_on else pi - h2 * dU
    return vel, pi


def warp_trip(s, pos, vel, eps, pi, es, grad, eps_grad):
    """``strang_trip_w`` with the reflection folds."""
    if s.refl:
        eps, pi = fold(s, eps, pi)
    vel, eps, pi = warp_s_half(s, vel, eps, pi, es, grad)
    vel, pi = warp_v_half_kick(s, pos, vel, eps, pi)
    pos = pos + s.h[:, None, None] * vel
    vel, pi = warp_v_half_kick(s, pos, vel, eps, pi)
    es, grad = eps_grad(pos)
    vel, eps, pi = warp_s_half(s, vel, eps, pi, es, grad)
    if s.refl:
        eps, pi = fold(s, eps, pi)
    return pos, vel, eps, pi, es, grad


# --------------------------------------------------------------------------

def _system(n, policy, trips=6, rows=48):
    """Dataset rows in n slots (3-body rows at n = 3, <= 4 bodies at
    n = 4, all at n = 8), built by the port in float32: (Sys, pos, vel,
    eps, pi, plain kwargs).  Under reflection the bounds sit 0.1% around
    the entry eps, so the folds act on most trips."""
    m, q, v, mask = _dataset_rows()
    cnt, tight = mask.sum(1), ~mask[:, n:].any(1)
    pick = {3: (cnt == 3) & tight, 4: (cnt <= 4) & tight}.get(n, tight)
    idx = np.nonzero(pick)[0][:rows]
    f = lambda a: torch.as_tensor(a[idx, :n], dtype=torch.float32)
    st, dy = build_batch(f(m), f(q), f(v), torch.as_tensor(mask[idx, :n]),
                         nt.SimConfig(fast_float32=True), 1.0, 0.05, 0.0,
                         0.01)
    cfg = nt.SimConfig()
    kw = dict(k_soft=dy.k_soft, mu=dy.mu_soft, alpha=dy.alpha_run,
              eps_min=dy.min_softening, eps_max=dy.max_softening,
              h=torch.full_like(st.eps, 0.01 / trips), G=1.0,
              k_wall=float(cfg.k_wall), eta=float(cfg.eta),
              jcap=float(cfg.j_max_cap), bexp=int(cfg.barrier_exponent))
    if policy == "reflection":
        kw.update(eps_min=st.eps * 0.999, eps_max=st.eps * 1.001)
    npkw = {k: (x.numpy() if torch.is_tensor(x) else x)
            for k, x in kw.items()}
    s = Sys(st.mass.numpy(), st.eps.numpy(), npkw, policy)
    return (s, st.pos.numpy(), st.vel.numpy(), st.eps.numpy(),
            st.pi.numpy(), kw, st)


def _grad_fn(s, which):
    args = (s.mass, s.eps_seed, s.alpha, s.flo, s.cap)
    if which == "kept":
        return lambda pos: kept_eps_star_and_grad(pos, *args)
    if which == "recomputed":
        return lambda pos: one_thread_eps_star_and_grad(pos, *args)
    return lambda pos: warp_eps_star_and_grad(pos, *args, dtype=np.float32)[:2]


def _run(step, s, pos, vel, eps, pi, trips, eps_grad):
    es, grad = eps_grad(pos)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore",
                     under="ignore"):
        for _ in range(trips):
            pos, vel, eps, pi, es, grad = step(s, pos, vel, eps, pi, es,
                                               grad, eps_grad)
    return pos, vel, eps, pi


def _assert_bits(got, ref, what):
    for name, a, b in zip(("pos", "vel", "eps", "pi"), got, ref):
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", CASES)
def test_kept_terms_are_the_recomputing_sweep(populations, case):
    """float32: the kept-term sweep gives eps* and the gradient bit for
    bit as the parent kernel's recomputing sweep."""
    inputs = populations[(case, np.float32)]
    es, g = kept_eps_star_and_grad(*inputs)
    es_r, g_r = one_thread_eps_star_and_grad(*inputs, dtype=np.float32)
    assert np.abs(g).max() > 1e-3
    np.testing.assert_array_equal(_bits(es), _bits(es_r))
    np.testing.assert_array_equal(_bits(g), _bits(g_r))


@pytest.mark.parametrize("policy", ["soft", "reflection"])
@pytest.mark.parametrize("n", [3, 4])
def test_one_thread_trip_with_kept_terms(n, policy):
    """Six trips of the N = 3 / 4 layout's trip: the kept-term
    trajectory is the recomputing one bit for bit, and within STATE_TOL
    of the plain version in float64."""
    trips = 6
    s, pos, vel, eps, pi, kw, st = _system(n, policy, trips)
    got = _run(trip, s, pos, vel, eps, pi, trips, _grad_fn(s, "kept"))
    ref = _run(trip, s, pos, vel, eps, pi, trips, _grad_fn(s, "recomputed"))
    _assert_bits(got, ref, f"N={n} {policy}")
    n_sub = torch.full(st.eps.shape, trips, dtype=torch.int32)
    d64 = lambda x: x.double() if torch.is_tensor(x) else x
    plain = hk.hamsoft_multistep_plain(
        *(d64(x) for x in (st.pos, st.vel, st.mass, st.eps, st.pi)),
        n_sub=n_sub, n_steps=1, n_sub_max=trips, policy=policy,
        **{k: d64(x) for k, x in kw.items()})
    rtol, atol = STATE_TOL
    for name, a, b in zip(("pos", "vel", "eps", "pi"), got, plain):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"N={n} {policy}: {name}")
    if policy == "reflection":
        lo, hi = kw["eps_min"].numpy(), kw["eps_max"].numpy()
        assert ((got[2] >= lo) & (got[2] <= hi)).all()  # folded into range
        assert not np.array_equal(got[3], pi)          # and pi moved


@pytest.mark.parametrize("n", [8, 3])
def test_warp_trip_with_the_reflection_fold(n):
    """Six trips under reflection as the warp's lanes run them equal the
    one-thread trip bit for bit."""
    trips = 6
    s, pos, vel, eps, pi, _kw, _st = _system(n, "reflection", trips)
    got = _run(warp_trip, s, pos, vel, eps, pi, trips, _grad_fn(s, "warp"))
    ref = _run(trip, s, pos, vel, eps, pi, trips, _grad_fn(s, "kept"))
    _assert_bits(got, ref, f"N={n} reflection")


@pytest.mark.parametrize("policy", ["reflection", "soft"])
def test_three_bodies_in_eight_slots(policy):
    """A 3-body system padded to 8 slots (mass 0) moves its bodies, eps
    and pi on the warp trip bit for bit as in 3 slots on the one-thread
    trip: the padded slots add exact zeros."""
    trips = 6
    s, pos, vel, eps, pi, kw, st = _system(3, policy, trips)
    pad = lambda x: np.concatenate(
        [x, np.zeros(x.shape[:1] + (5,) + x.shape[2:], f32)], 1)
    s8 = Sys(pad(s.mass), eps, {k: (x.numpy() if torch.is_tensor(x) else x)
                                for k, x in kw.items()}, policy)
    got = _run(warp_trip, s8, pad(pos), pad(vel), eps, pi, trips,
               _grad_fn(s8, "warp"))
    ref = _run(trip, s, pos, vel, eps, pi, trips, _grad_fn(s, "kept"))
    _assert_bits((got[0][:, :3], got[1][:, :3], got[2], got[3]), ref,
                 f"3 in 8 slots {policy}")
