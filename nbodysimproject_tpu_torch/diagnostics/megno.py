"""MEGNO: the tangent vectors and the scan continuation.

Counterpart of ``nbodysimproject_tpu/diagnostics/megno.py`` (parity:
``minbody/evolution_features.py:34-66``): random COM-free unit tangent
vectors (``init_tangent``) and the MEGNO steps fused with the integrator
on the scan engine (``megno_scan``; ``megno_static``, the facade's
static-n_sub path).  The fused engine's MEGNO continuation runs in the
MEGNO kernel (``ops/hamsoft_kernels.py::hamsoft_megno_multistep``).

``jax.random`` streams cannot be reproduced in PyTorch, so the normal
draws come from a ``torch.Generator``: one ``(B, N, d)`` pair for the
whole population, indexed by global system id, so that a system's draw
does not depend on the chunk it lands in.  Callers that need the JAX
package's draws pass the finished tangents instead.
"""

from __future__ import annotations

import numpy as np
import torch


def population_normals(seed: int, n_total: int, shape, dtype):
    """Two (n_total, N, d) standard-normal tensors from ``seed``, drawn
    on the CPU so the numbers do not depend on the device."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    z1 = torch.randn((n_total,) + tuple(shape), generator=gen, dtype=dtype)
    z2 = torch.randn((n_total,) + tuple(shape), generator=gen, dtype=dtype)
    return z1, z2


def init_tangent(z1, z2, state):
    """COM-free, masked, unit-norm tangent vectors (dr0, dv0) from raw
    normal draws (B, N, d) for the batched ``state``."""
    mask = state.mask[..., None]
    m = torch.where(state.mask, state.mass, torch.zeros_like(state.mass))
    M = torch.clamp_min(m.sum(-1), 1e-300)

    def make(d):
        d = torch.where(mask, d, torch.zeros_like(d))
        com = (m[..., None] * d).sum(-2) / M[..., None]
        d = torch.where(mask, d - com[..., None, :], torch.zeros_like(d))
        norm = torch.sqrt((d * d).sum((-2, -1)))
        return d / torch.clamp_min(norm, 1e-300)[..., None, None]

    return make(z1), make(z2)


def megno_scan(state, dyn, cfg, dr0, dv0, n_steps: int, dt,
               n_sub_max: int, trips=None):
    """``n_steps`` MEGNO steps fused with the integrator on the
    dynamic-n_sub path (megno.py:47-106 of the JAX package): per step a
    macro step of every system's own n_sub, the tangent update with
    ``diagnostics/tangent.py``, the reference's norm_r < 1e-12 quirk, and
    the running accumulator.  ``dr0``/``dv0`` are the initial tangents
    (``init_tangent``); ``dt`` a float or (B,) tensor; ``trips`` the
    substep loop length (read off ``dyn.n_sub`` when None).  Returns
    (final state, Y, lyapunov_time, slope_med), each (B,)."""
    from ..integrators.step import _per_system, _trips, macro_step_dynamic
    from ..ops.hamsoft_kernels import _megno_summary
    from .tangent import variational_accel_state

    dtv = _per_system(dt, state.eps)
    if trips is None:
        trips = _trips(torch.clamp_min(dyn.n_sub, 1), n_sub_max)
    dt3 = dtv[..., None, None]
    dr, dv = dr0, dv0
    accum = torch.zeros_like(dtv)
    t = torch.zeros_like(dtv)
    ys = []
    for _ in range(int(n_steps)):
        state = macro_step_dynamic(state, dyn, cfg, dtv, n_sub_max, trips)
        dr = dr + dv * dt3
        da = variational_accel_state(state, dyn, cfg, dr)
        dv = dv + da * dt3
        t = t + dtv
        norm_r = torch.sqrt((dr * dr).sum((-2, -1)))
        tiny = norm_r < 1e-12
        scale = torch.where(tiny, torch.clamp_min(norm_r, 1e-300),
                            torch.ones_like(norm_r))[..., None, None]
        dr = dr / scale
        dv = dv / scale
        norm_r = torch.where(tiny, torch.ones_like(norm_r), norm_r)
        norm_v = torch.sqrt((dv * dv).sum((-2, -1)))
        accum = accum + (norm_v / torch.clamp_min(norm_r, 1e-300)) * t * dtv
        ys.append(2.0 * accum / torch.clamp_min(t, 1e-300))
    ys = torch.stack(ys) if ys else torch.zeros((0,) + dtv.shape,
                                                dtype=dtv.dtype,
                                                device=dtv.device)
    Y, lyap, slope_med = _megno_summary(accum, t, ys, dtv)
    return state, Y, lyap, slope_med


def draw_tangent(generator, state):
    """COM-free unit tangent vectors (dr0, dv0) for the batched
    ``state``, from two normal draws of its shape taken from the CPU
    ``torch.Generator`` ``generator`` (on the CPU, so the numbers do not
    depend on the device)."""
    shape, dev = tuple(state.pos.shape), state.pos.device
    z1, z2 = (torch.randn(shape, generator=generator, dtype=state.pos.dtype)
              for _ in range(2))
    return init_tangent(z1.to(dev), z2.to(dev), state)


def tangent_for(state, generator, tangent=None):
    """The (dr0, dv0) of a facade view's MEGNO run on the one-system
    ``state``: ``draw_tangent(generator, state)``, or the given finished
    (n_slots, d) vectors ``tangent`` on the state's device and dtype."""
    if tangent is None:
        return draw_tangent(generator, state)
    return tuple(torch.as_tensor(np.array(t), dtype=state.pos.dtype,
                                 device=state.pos.device)[None]
                 for t in tangent)


def megno_static(state, dyn, cfg, dr0, dv0, n_steps: int, dt, n_sub: int):
    """``megno_scan`` with one substep count ``n_sub`` for every system:
    the JAX package's ``megno_jit``, the facade's path.  Every trip is
    active, so it runs the static macro step's arithmetic."""
    dyn = dyn.replace(n_sub=torch.full_like(dyn.n_sub, int(n_sub)))
    return megno_scan(state, dyn, cfg, dr0, dv0, n_steps, dt, int(n_sub),
                      int(n_sub))
