"""The tiled force kernel's summation order, on the CPU.

``csrc/pairwise_force.cu`` writes each pair with explicit FMAs (r^2 and
the accumulation), sums a tile of ``TJ`` sources in 8 interleaved
accumulators (the tile's remainder into the first) added pairwise, and,
where the grid would leave SMs idle, splits the sources into slices of
whole 64-source granules, each staged a tile at a time from its start,
whose running accumulators a second pass adds in slice order.  No
CUDA runs here, so ``sliced_force`` emulates that order in numpy: float32
throughout, an FMA modelled as the float64 product and add rounded once
to float32 (so a few pairs round twice, well inside the tolerance) and
rsqrtf as the float64 1 / sqrt rounded to float32.  The emulation is held
as ``chip_smoke.py`` holds the kernel: each row's largest error from the
float64 plain version over its magnitude sum S_i, at most
FORCE_ERR_FACTOR times the float32 plain version's worst and at most
FORCE_ERR_MAX.  ``source_slices`` is held to its contract: at least 1, at
most the granule count, one wave of blocks, deterministic, and the slices
it gives cover the sources exactly once.
"""

import numpy as np
import pytest
import torch

from nbodysimproject_tpu_torch.ops import force_kernels as fk

#: chip_smoke.py's gate on the kernel
FORCE_ERR_FACTOR, FORCE_ERR_MAX = 4.0, 1e-4
#: the H100's SMs and the blocks of the d = 2 kernel an SM holds there
H100_SMS, PER_SM = 132, 5
#: the kernel's interleaved accumulators (kU)
KU = 8

f32 = np.float32


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(f32)


def slice_bounds(n, S, sg=fk.SG):
    """[j_lo, j_hi) of each slice, as the kernel computes them."""
    granules = -(-n // sg)
    return [((s * granules // S) * sg, min(n, ((s + 1) * granules // S) * sg))
            for s in range(S)]


def sliced_force(q, m, eps, G, S):
    """The kernel's order for (B, n, d) float32 systems in S slices."""
    B, n, d = q.shape
    out = np.empty_like(q)
    i_idx = np.arange(n)
    for b in range(B):
        xi, eps2 = q[b], f32(eps[b]) * f32(eps[b])
        accs = []
        for j_lo, j_hi in slice_bounds(n, S):
            acc = np.zeros((n, d), f32)
            for j0 in range(j_lo, j_hi, fk.TJ):
                k_end = min(fk.TJ, j_hi - j0)
                whole = k_end // KU * KU
                part = np.zeros((KU, n, d), f32)
                for k in range(k_end):
                    j = j0 + k
                    dx = xi - q[b, j]
                    r2 = _fma(dx[:, 0], dx[:, 0], eps2)
                    for a in range(1, d):
                        r2 = _fma(dx[:, a], dx[:, a], r2)
                    valid = (i_idx != j) & (r2 > 0)
                    inv_r = (1.0 / np.sqrt(np.where(valid, r2, f32(1)).astype(
                        np.float64))).astype(f32)
                    w = np.where(valid, m[b, j] * inv_r * inv_r * inv_r,
                                 f32(0))
                    u = k % KU if k < whole else 0
                    part[u] = _fma(w[:, None], dx, part[u])
                w_ = KU // 2
                while w_ > 0:
                    part[:w_] = part[:w_] + part[w_:2 * w_]
                    w_ //= 2
                acc = acc - part[0]
            accs.append(acc)
        tot = accs[0] if S == 1 else np.zeros((n, d), f32)
        if S > 1:
            for acc in accs:
                tot = tot + acc
        out[b] = (f32(G[b]) * tot) * m[b][:, None]
    return out


def _cloud(B, n, d, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, n, d)) * 3).astype(f32),
            rng.uniform(0.1, 2.0, (B, n)).astype(f32),
            rng.uniform(0.01, 0.1, B).astype(f32),
            rng.uniform(0.5, 2.0, B).astype(f32))


def _worst(X, P64, S_i):
    """The largest row error over S_i, on the rows with S_i > 0 (a
    zero-mass body has S_i = 0 and F = 0)."""
    err = (torch.as_tensor(X, dtype=torch.float64) - P64).abs().amax(-1)
    return float((err / S_i)[S_i > 0].max())


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [17, 4097])
def test_sliced_order_within_the_kernel_gate(n, d):
    q, m, eps, G = _cloud(1, n, d, seed=n + d)
    slices = fk.source_slices(n, 1, H100_SMS, PER_SM)
    assert slices == min(-(-n // fk.SG), H100_SMS * PER_SM // -(-n // fk.TI))
    a64 = [torch.as_tensor(x, dtype=torch.float64) for x in (q, m, eps, G)]
    P64 = fk.pairwise_force_plain(*a64)
    S_i = fk.magnitude_sum(*a64)
    P32 = fk.pairwise_force_plain(*[torch.as_tensor(x) for x in (q, m, eps,
                                                                 G)])
    e_plain = _worst(P32.numpy(), P64, S_i)
    for S in sorted({1, slices}):
        e = _worst(sliced_force(q, m, eps, G, S), P64, S_i)
        assert e <= FORCE_ERR_FACTOR * e_plain and e <= FORCE_ERR_MAX, \
            (S, e, e_plain)


def test_sliced_order_unsoftened_and_zero_mass():
    """eps = 0 (the WHFast kick) and a zero-mass slot: the diagonal and
    the padded body add nothing, and the padded body gets F = 0."""
    q, m, _eps, G = _cloud(2, 700, 2, seed=3)
    m[1, 5] = 0.0
    eps = np.zeros(2, f32)
    out = sliced_force(q, m, eps, G, 2)
    assert np.isfinite(out).all() and not out[1, 5].any()
    a64 = [torch.as_tensor(x, dtype=torch.float64) for x in (q, m, eps, G)]
    P64 = fk.pairwise_force_plain(*a64)
    e = _worst(out, P64, fk.magnitude_sum(*a64))
    assert e <= FORCE_ERR_MAX


@pytest.mark.parametrize("n,B,want", [(4096, 1, 41), (4097, 1, 38),
                                      (65537, 1, 2), (100_000, 1, 1),
                                      (1_000_000, 1, 1), (2048, 4, 20),
                                      (4096, 96, 1), (17, 1, 1), (1, 1, 1)])
def test_source_slices_contract(n, B, want):
    S = fk.source_slices(n, B, H100_SMS, PER_SM)
    assert S == want
    assert S == fk.source_slices(n, B, H100_SMS, PER_SM)  # deterministic
    granules = -(-n // fk.SG)
    blocks = -(-n // fk.TI) * B
    assert 1 <= S <= granules
    assert S == 1 or blocks * S <= H100_SMS * PER_SM  # one wave
    assert S == granules or blocks * (S + 1) > H100_SMS * PER_SM  # the most
    covered = np.zeros(n, int)
    for lo, hi in slice_bounds(n, S):
        assert lo < hi and lo % fk.SG == 0  # whole granules, none empty
        covered[lo:hi] += 1
    assert (covered == 1).all()
