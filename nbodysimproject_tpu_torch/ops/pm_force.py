"""Particle-mesh (PM) and P3M forces for the large-N regime (d = 2).

Counterpart of ``nbodysimproject_tpu/ops/pm_force.py``, function by
function, on one (N, 2) system.  The force of the Plummer-softened pair
kernel k(r) = -G r / (|r|^2 + eps^2)^{3/2} is a convolution of the mass
field with k:

* ``pm_force``: masses deposited on an Ng x Ng grid (TSC or CIC),
  zero-padded to (2 Ng)^2 (open boundaries), convolved with the exact
  kernel sampled on the padded grid by FFT, gathered back with the same
  weights;
* ``p3m_force``: the kernel split as k g + k (1 - g) with g a C^2
  smoothstep over [0, r_cut]: the smooth k g on the mesh (TSC, with the
  sinc^6 deconvolution capped at 1e-4), the exact k (1 - g) summed over
  a banded window of particles sorted by r_cut-row, pairs beyond the
  window counted in ``n_dropped``.

This is XLA code in the JAX package, not a Pallas kernel, so it stays
plain PyTorch on every device: deposits with ``index_put_(...,
accumulate=True)`` (atomics on the card, so two runs there can differ
in the last bits), ``torch.fft.rfft2`` / ``irfft2`` for the mesh, and
the short-range pass as a gather of each tile's window followed by its
(tile, window) block of pair distances, computed in chunks of tiles so
that no intermediate exceeds ``PP_CHUNK_BYTES``; the pair terms are
taken only on the pairs nearer than a hair over r_cut (``nonzero``, one
host synchronisation per chunk) and summed into their rows with
``index_add_``.  The details that fix the
result are the JAX package's: a stable argsort, round half to even, a
left searchsorted, the clip constants, the 1e30 padding of sorted
positions, ``n_rows`` and the ``pp_window`` default.
"""

from __future__ import annotations

import math

import torch

#: largest (tiles, tile, window) intermediate of the short-range pass
PP_CHUNK_BYTES = 1 << 31


def _cic_indices_weights(q, lo, cell, Ng):
    """(idx0, frac): lower-cell index (N, d) and the fractional offset
    (N, d) for cloud-in-cell deposits and gathers."""
    u = torch.clamp((q - lo) / cell, 0.0, Ng - 1.000001)
    i0 = torch.floor(u)
    return i0.long(), u - i0


def _tsc_axis(q1, lo1, cell, Ng):
    """(idx, w): per-axis TSC stencil, the centre index (N,) and the
    3-point weights (N, 3) at offsets (-1, 0, +1)."""
    u = torch.clamp((q1 - lo1) / cell, 1.0, Ng - 2.000001)
    ic = torch.round(u)
    d = u - ic
    w = torch.stack([0.5 * (0.5 - d) ** 2, 0.75 - d * d,
                     0.5 * (0.5 + d) ** 2], dim=1)
    return ic.long(), w


def _deposit_tsc(q, m, lo, cell, Ng):
    ix, wx = _tsc_axis(q[:, 0], lo[0], cell, Ng)
    iy, wy = _tsc_axis(q[:, 1], lo[1], cell, Ng)
    rho = torch.zeros((Ng, Ng), dtype=q.dtype, device=q.device)
    for a in range(3):
        for b in range(3):
            rho.index_put_((ix + (a - 1), iy + (b - 1)),
                           m * wx[:, a] * wy[:, b], accumulate=True)
    return rho


def _gather_tsc(field, q, lo, cell, Ng):
    ix, wx = _tsc_axis(q[:, 0], lo[0], cell, Ng)
    iy, wy = _tsc_axis(q[:, 1], lo[1], cell, Ng)
    out = torch.zeros(q.shape[0], dtype=field.dtype, device=field.device)
    for a in range(3):
        for b in range(3):
            out = out + field[ix + (a - 1), iy + (b - 1)] \
                * wx[:, a] * wy[:, b]
    return out


def _cic_axes(q, lo, cell, Ng):
    """The four corners (ix, iy, wx, wy) of the CIC stencil, in the JAX
    package's order."""
    i0, f = _cic_indices_weights(q, lo, cell, Ng)
    for dx in (0, 1):
        wx = (1.0 - f[:, 0]) if dx == 0 else f[:, 0]
        ix = torch.clamp_max(i0[:, 0] + dx, Ng - 1)
        for dy in (0, 1):
            wy = (1.0 - f[:, 1]) if dy == 0 else f[:, 1]
            iy = torch.clamp_max(i0[:, 1] + dy, Ng - 1)
            yield ix, iy, wx, wy


def _deposit_cic(q, m, lo, cell, Ng):
    """CIC mass deposit onto an (Ng, Ng) grid."""
    rho = torch.zeros((Ng, Ng), dtype=q.dtype, device=q.device)
    for ix, iy, wx, wy in _cic_axes(q, lo, cell, Ng):
        rho.index_put_((ix, iy), m * wx * wy, accumulate=True)
    return rho


def _gather_cic(field, q, lo, cell, Ng):
    """CIC interpolation of a grid field at particle positions."""
    out = torch.zeros(q.shape[0], dtype=field.dtype, device=field.device)
    for ix, iy, wx, wy in _cic_axes(q, lo, cell, Ng):
        out = out + field[ix, iy] * wx * wy
    return out


def _offsets(Ng, cell, dtype, device):
    """Signed grid offsets of the zero-padded (2 Ng) axis in wraparound
    order (0, 1, ..., Ng - 1, -Ng, ..., -1) times ``cell``: (rx, ry)."""
    Np = 2 * Ng
    ax = torch.arange(Np, device=device)
    off = torch.where(ax < Ng, ax, ax - Np).to(dtype) * cell
    return off[:, None], off[None, :]


def _force_kernel_ffts(Ng, cell, eps, G, dtype):
    """FFTs of the softened force-kernel components sampled on the
    zero-padded (2 Ng, 2 Ng) grid, so that the circular convolution of
    the padded fields is the linear one."""
    rx, ry = _offsets(Ng, cell, dtype, cell.device)
    r2 = rx * rx + ry * ry + eps * eps
    inv = r2 ** (-1.5)
    kx = -G * rx * inv
    ky = -G * ry * inv
    return torch.fft.rfft2(kx), torch.fft.rfft2(ky)


def _mesh_frame(q, Ng, bounds):
    """(lo (2,), cell): the mesh's square frame around the
    particles (or ``bounds``), padded by 1% of the span."""
    dtype = q.dtype
    if bounds is None:
        lo2 = q.min(0).values
        hi2 = q.max(0).values
    else:
        lo2, hi2 = (torch.as_tensor(b, dtype=dtype, device=q.device)
                    for b in bounds)
    span = torch.clamp_min((hi2 - lo2).max(), 1e-6)
    pad = 0.01 * span
    lo = (lo2.min() - pad).repeat(2)
    cell = (span + 2 * pad) / Ng
    return lo, cell


def _mesh_field(rho, K, Ng):
    """The (Ng, Ng) field of the mass grid ``rho`` convolved with the
    kernel whose padded rfft2 is ``K``."""
    Np = 2 * Ng
    rho_p = torch.zeros((Np, Np), dtype=rho.dtype, device=rho.device)
    rho_p[:Ng, :Ng] = rho
    R = torch.fft.rfft2(rho_p)
    return [torch.fft.irfft2(R * k, s=(Np, Np))[:Ng, :Ng] for k in K]


def pm_force(q, m, eps, G=1.0, *, Ng: int = 256, bounds=None,
             assignment: str = "tsc"):
    """Plummer-softened pairwise forces by exact-kernel PM.

    q: (N, 2) positions, m: (N,) masses.  ``bounds`` optionally fixes
    (lo, hi) per axis; by default the particles' bounding box.  Returns
    (N, 2) forces, the same quantity as ``ops.forces.gravitational_force``.
    """
    dtype = q.dtype
    lo, cell = _mesh_frame(q, Ng, bounds)
    deposit = _deposit_tsc if assignment == "tsc" else _deposit_cic
    gather = _gather_tsc if assignment == "tsc" else _gather_cic
    rho = deposit(q, m, lo, cell, Ng)
    eps = torch.as_tensor(eps, dtype=dtype, device=q.device)
    Gt = torch.as_tensor(G, dtype=dtype, device=q.device)
    fx_grid, fy_grid = _mesh_field(
        rho, _force_kernel_ffts(Ng, cell, eps, Gt, dtype), Ng)
    fx = gather(fx_grid, q, lo, cell, Ng)
    fy = gather(fy_grid, q, lo, cell, Ng)
    return m[:, None] * torch.stack([fx, fy], dim=1)


# ----------------------------------------------------------------------
# P3M: smooth-split kernel + sort-based banded short-range pass
# ----------------------------------------------------------------------

def _smoothstep(s):
    """C^2 smoothstep 0 -> 1 on [0, 1]."""
    s = torch.clamp(s, 0.0, 1.0)
    return s * s * s * (10.0 + s * (-15.0 + 6.0 * s))


def _split_kernel_ffts(Ng, cell, eps, G, r_cut, dtype):
    """FFTs of the long-range kernel k(r) g(|r| / r_cut), smooth at the
    origin and exact beyond r_cut, divided by the TSC window applied
    twice (deposit and gather), sinc^6 per axis, capped at 1e-4."""
    Np = 2 * Ng
    rx, ry = _offsets(Ng, cell, dtype, cell.device)
    r2 = rx * rx + ry * ry
    g = _smoothstep(torch.sqrt(r2) / r_cut)
    # the r = 0 sample: g -> 0 there, but with eps = 0 (the unsoftened
    # WHFast route) the bare kernel is inf and 0 * inf would poison the
    # FFT, so the origin is selected out
    pos = r2 > 0
    r2_safe = torch.where(pos, r2, torch.ones_like(r2))
    inv = torch.where(pos, (r2_safe + eps * eps) ** (-1.5) * g,
                      torch.zeros_like(r2))
    KX = torch.fft.rfft2(-G * rx * inv)
    KY = torch.fft.rfft2(-G * ry * inv)

    def sinc3(f):
        x = math.pi * f.to(dtype) / Np
        zero = f == 0
        one = torch.ones_like(x)
        s = torch.where(zero, one, torch.sin(x) / torch.where(zero, one, x))
        return s * s * s

    ax = torch.arange(Np, device=cell.device)
    fx = torch.minimum(ax, Np - ax)
    fy = torch.arange(Np // 2 + 1, device=cell.device)
    w2 = (sinc3(fx)[:, None] * sinc3(fy)[None, :]) ** 2
    w2 = torch.clamp_min(w2, 1e-4)
    return KX / w2, KY / w2


def _pp_short_range_banded(q, m, eps, G, r_cut, lo, n_rows: int, ti: int,
                           W: int):
    """Short-range pass over row bands and contiguous windows.

    Particles are sorted by their r_cut-sized row; a tile of ``ti``
    consecutive sorted particles interacts with the contiguous window of
    particles of its rows +- 1, capped at ``W`` (the overflow is counted,
    not silently dropped).  Returns ((N, 2) forces, n_dropped)."""
    dev, dtype = q.device, q.dtype
    N = q.shape[0]
    rows = torch.clamp(torch.floor((q[:, 0] - lo[0]) / r_cut), 0,
                       n_rows - 1).to(torch.int32)
    order = torch.argsort(rows, stable=True)
    qs, ms, rs = q[order], m[order], rows[order]

    n_tiles = -(-N // ti)
    Npad = n_tiles * ti
    W = min(W, Npad)
    pad = Npad - N
    if pad:
        qs = torch.cat([qs, torch.full((pad, 2), 1e30, dtype=dtype,
                                       device=dev)])
        ms = torch.cat([ms, torch.zeros(pad, dtype=dtype, device=dev)])
        rs = torch.cat([rs, torch.full((pad,), n_rows - 1, dtype=rs.dtype,
                                       device=dev)])

    row_start = torch.searchsorted(
        rs, torch.arange(n_rows + 1, dtype=rs.dtype, device=dev),
        side="left")
    t_ids = torch.arange(n_tiles, device=dev)
    rmin = rs[t_ids * ti].long()
    rmax = rs[torch.clamp_max((t_ids + 1) * ti - 1, Npad - 1)].long()
    j_start = row_start[torch.clamp_min(rmin - 1, 0)]
    j_end = row_start[torch.clamp_max(rmax + 2, n_rows)]
    n_dropped = torch.clamp_min(j_end - j_start - W, 0).sum()
    j_start = torch.clamp_max(j_start, max(Npad - W, 0))

    qx, qy = qs[:, 0].contiguous(), qs[:, 1].contiguous()
    eps2 = eps * eps
    # a superset of the pairs with r < r_cut (sqrt rounds by far less
    # than the margin): the exact test and the pair terms run on these
    # candidates only, a few in a thousand of the window's pairs
    r2_cand = (r_cut * (1.0 + 1e-5)) ** 2
    F = torch.zeros((Npad, 2), dtype=dtype, device=dev)
    tc = max(1, PP_CHUNK_BYTES // (ti * W * q.element_size()))
    ar_ti = torch.arange(ti, device=dev)
    ar_w = torch.arange(W, device=dev)
    for t0 in range(0, n_tiles, tc):
        ii = (torch.arange(t0, min(t0 + tc, n_tiles), device=dev)
              * ti)[:, None] + ar_ti                      # (tc, ti)
        jj = j_start[t0:t0 + tc, None] + ar_w             # (tc, W)
        dx = qx[ii][:, :, None] - qx[jj][:, None, :]      # (tc, ti, W)
        dy = qy[ii][:, :, None] - qy[jj][:, None, :]
        r2 = dx * dx
        r2 += dy * dy
        t, a, b = torch.nonzero(r2 < r2_cand, as_tuple=True)
        i_p, j_p = ii[t, a], jj[t, b]
        dx, dy, r2 = dx[t, a, b], dy[t, a, b], r2[t, a, b]
        r = torch.sqrt(r2)
        w = (1.0 - _smoothstep(r / r_cut)) * (r2 + eps2) ** (-1.5)
        keep = (j_p < j_end[t0 + t]) & (j_p != i_p) & (r < r_cut)
        w = torch.where(keep, ms[j_p] * w, torch.zeros_like(w))
        F.index_add_(0, i_p, torch.stack([w * dx, w * dy], dim=1))
    F_sorted = -G * F[:N]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N, device=dev)
    return F_sorted[inv], n_dropped


def p3m_force(q, m, eps, G=1.0, *, Ng: int = 256, r_cut_cells: float = 4.0,
              bounds=None, pp_tile: int = 256, pp_window: int = 0):
    """Plummer-softened forces by particle-particle particle-mesh.

    The mesh carries the smooth k g (TSC deposits); the exact k (1 - g)
    is summed over the banded windows of ``pp_tile``-particle tiles.
    Returns ((N, 2) forces, n_dropped): n_dropped counts the pairs
    beyond ``pp_window`` (0 when the cap is adequate; the default is
    ~2x the expected band width)."""
    dtype = q.dtype
    N = q.shape[0]
    lo, cell = _mesh_frame(q, Ng, bounds)
    r_cut = r_cut_cells * cell
    eps = torch.as_tensor(eps, dtype=dtype, device=q.device)
    Gc = torch.as_tensor(G, dtype=dtype, device=q.device)

    # mesh (long-range) part
    rho = _deposit_tsc(q, m, lo, cell, Ng)
    fx_grid, fy_grid = _mesh_field(
        rho, _split_kernel_ffts(Ng, cell, eps, Gc, r_cut, dtype), Ng)
    F = torch.stack([_gather_tsc(fx_grid, q, lo, cell, Ng),
                     _gather_tsc(fy_grid, q, lo, cell, Ng)], dim=1)

    # short-range banded-window pass
    n_rows = pp_rows(Ng, r_cut_cells)
    if pp_window <= 0:
        pp_window = default_pp_window(N, n_rows)
    F_sr, n_dropped = _pp_short_range_banded(q, m, eps, Gc, r_cut, lo,
                                             n_rows, pp_tile, pp_window)
    return m[:, None] * (F + F_sr), n_dropped


def pp_rows(Ng: int, r_cut_cells: float) -> int:
    """Rows of the short-range pass: r_cut-sized bands of the mesh."""
    return max(int(Ng // r_cut_cells), 1)


def default_pp_window(N: int, n_rows: int) -> int:
    """The default short-range window: a 3-row band with headroom for
    centrally concentrated clouds (a 2-D Gaussian's peak row carries
    ~2.4x the mean; 16/3 ~ 5.3x keeps drops at zero well past it)."""
    est = 16 * N // n_rows + 512
    return min(-(-est // 512) * 512, max(N, 512))
