"""Large-N integration: leapfrog rollouts over the P3M and tiled direct
force engines.

Counterpart of ``nbodysimproject_tpu/integrators/largen.py``.  One
(N, d) system advances by kick-drift-kick leapfrog with end-of-step
force reuse (one force evaluation per step), its force from
``cfg.force_mode``:

* ``"p3m"``: ``ops/pm_force.py::p3m_force`` (d = 2), the mesh bounds
  taken from the live positions at every step;
* ``"direct_pallas"``: the tiled exact kernel,
  ``ops/force_kernels.py::pairwise_force`` (d = 2 or 3 on the card);
* ``"direct"``: the dense O(N^2) force;
* ``"auto"``: p3m for d = 2 and N >= ``cfg.pm_auto_min_n``, else the
  tiled kernel for N >= ``cfg.pallas_force_min_n``, else dense.

The short-range window overflow of P3M is counted and its maximum over
the steps returned (``LargeNInfo.n_dropped_max``, kept on the device:
no host synchronisation per step).  The rollout runs where its tensors
lie; NumPy inputs go to the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.device import resolve_device


class LargeNInfo(NamedTuple):
    n_dropped_max: torch.Tensor  # max short-range window overflow (p3m)
    kinetic: torch.Tensor        # final kinetic energy (cheap sanity)


def _direct_force_xla(q, m, eps, G):
    """Dense O(N^2) force of (..., N, d) systems (the JAX package's XLA
    einsum; small N or the CPU); ``eps`` and ``G`` scalars or one per
    system."""
    eps = torch.as_tensor(eps, dtype=q.dtype, device=q.device)
    G = torch.as_tensor(G, dtype=q.dtype, device=q.device)
    diff = q[..., :, None, :] - q[..., None, :, :]
    r2 = (diff * diff).sum(-1) + (eps * eps)[..., None, None]
    inv_r = torch.rsqrt(r2)
    w = inv_r * inv_r * inv_r
    w.diagonal(dim1=-2, dim2=-1).zero_()
    gm = G[..., None] * m
    acc = -torch.einsum("...ij,...ijd,...j->...id", w, diff, gm)
    return m[..., None] * acc


def make_force_fn(cfg, n: int, d: int):
    """Resolve ``cfg.force_mode`` for an (n, d) system to a function
    (q, m, eps, G) -> (force, n_dropped); its ``mode`` attribute names the
    resolved engine.  The p3m function takes one (N, 2) system; the
    direct ones also take (B, N, d) batches with per-system eps and G."""
    mode = cfg.force_mode
    if mode == "auto":
        mode = "p3m" if (d == 2 and n >= cfg.pm_auto_min_n) else \
            ("direct_pallas" if n >= cfg.pallas_force_min_n else "direct")

    if mode == "p3m":
        if d != 2:
            raise ValueError("force_mode='p3m' supports d=2 only "
                             f"(got d={d}); use 'direct_pallas'")
        from ..ops.pm_force import p3m_force

        def force(q, m, eps, G):
            return p3m_force(q, m, eps, G, Ng=int(cfg.pm_grid),
                             r_cut_cells=float(cfg.pm_r_cut_cells))
    elif mode == "direct_pallas":
        from ..ops.force_kernels import pairwise_force

        def force(q, m, eps, G):
            return pairwise_force(q, m, eps, G), _no_drops(q)
    elif mode == "direct":
        def force(q, m, eps, G):
            return _direct_force_xla(q, m, eps, G), _no_drops(q)
    else:
        raise ValueError(f"unknown force_mode {mode!r}")
    force.mode = mode
    return force


def _no_drops(q):
    return torch.zeros((), dtype=torch.int64, device=q.device)


def largen_rollout(pos, vel, mass, eps, G, dt, n_steps: int, cfg,
                   device=None):
    """Advance one (N, d) system ``n_steps`` KDK leapfrog steps with the
    force engine that ``cfg.force_mode`` selects.

    Tensors run where they lie; NumPy inputs go to
    ``core/device.py::resolve_device(device)``.  ``eps``, ``G`` and
    ``dt`` are scalars or 0-d tensors.  Returns (pos, vel, LargeNInfo).
    """
    dev = pos.device if isinstance(pos, torch.Tensor) \
        else resolve_device(device)
    pos = torch.as_tensor(pos, device=dev)
    vel, mass = (torch.as_tensor(x, dtype=pos.dtype, device=dev)
                 for x in (vel, mass))
    n, d = pos.shape
    eps, G, dtf = (torch.as_tensor(x, dtype=pos.dtype, device=dev)
                   for x in (eps, G, dt))
    force_fn = make_force_fn(cfg, n, d)
    h2 = 0.5 * dtf
    inv_m = torch.where(mass > 0, 1.0 / torch.clamp_min(mass, 1e-300),
                        torch.zeros_like(mass))[:, None]

    q, v = pos, vel
    f, dropped = force_fn(q, mass, eps, G)
    for _ in range(int(n_steps)):
        v = v + h2 * f * inv_m
        q = q + dtf * v
        f, drop = force_fn(q, mass, eps, G)
        v = v + h2 * f * inv_m
        dropped = torch.maximum(dropped, drop)
    kin = 0.5 * (mass * (v * v).sum(-1)).sum()
    return q, v, LargeNInfo(n_dropped_max=dropped, kinetic=kin)
