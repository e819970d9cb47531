"""Variational (tangent-map) acceleration for chaos indicators, batched.

Counterpart of ``nbodysimproject_tpu/diagnostics/tangent.py`` (parity:
``minbody/tangent_map.py:21-59``):

    delta_a_i = G sum_j m_j [ d_diff / r^3 - 3 (diff . d_diff) diff / r^5 ]

with diff = q_j - q_i, d_diff = delta_j - delta_i and the softened
r^2 = |q_j - q_i|^2 + s2, on ``(B, N, d)`` positions and tangents;
masked pairs contribute nothing.
"""

from __future__ import annotations

import math

import torch

from ..ops.geometry import pair_mask


def variational_accel(pos, mass, delta_r, G, s2, mask=None):
    """(B, N, d) tangent acceleration; ``G`` and ``s2`` are (B,)."""
    n = pos.shape[-2]
    diff = pos[..., None, :, :] - pos[..., :, None, :]
    r2 = (diff * diff).sum(-1) + s2[..., None, None]
    pm = pair_mask(n, mask, pos.device)
    r2s = torch.where(pm, r2, torch.full_like(r2, math.inf))
    inv_r2 = 1.0 / r2s
    inv_r3 = inv_r2 * torch.sqrt(inv_r2)
    d_diff = delta_r[..., None, :, :] - delta_r[..., :, None, :]
    dot = (diff * d_diff).sum(-1)
    coeff = 3.0 * dot * inv_r2 * inv_r3
    term = d_diff * inv_r3[..., None] - coeff[..., None] * diff
    return G[..., None, None] * (mass[..., None, :, None] * term).sum(-2)


def variational_accel_state(state, dyn, cfg, delta_r):
    """At the softening the step froze (step_s2; tangent_map.py:32)."""
    return variational_accel(state.pos, state.mass, delta_r, dyn.G,
                             state.step_s2, mask=state.mask)


class TangentMap:
    """The facade's view (tangent_map.py:16): the tangent acceleration
    of one simulation's bodies for an (n_bodies, d) ``delta_r``."""

    def __init__(self, sim):
        self.sim = sim

    def variational_accel(self, delta_r):
        import numpy as np

        st = self.sim._state
        d = torch.as_tensor(np.asarray(delta_r, dtype=np.float64),
                            dtype=st.pos.dtype, device=st.pos.device)
        full = torch.zeros_like(st.pos)
        full[0, : d.shape[0]] = d
        out = variational_accel_state(st, self.sim._dyn, self.sim.cfg, full)
        return out[0, : self.sim.n_bodies].cpu().numpy()
