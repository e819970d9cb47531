"""MEGNO tangent-vector initialisation.

Counterpart of ``init_tangent`` in
``nbodysimproject_tpu/diagnostics/megno.py`` (parity:
``minbody/evolution_features.py:37-44``): random COM-free unit tangent
vectors.  The MEGNO continuation itself runs in the MEGNO kernel
(``ops/hamsoft_kernels.py::hamsoft_megno_multistep``).

``jax.random`` streams cannot be reproduced in PyTorch, so the normal
draws come from a ``torch.Generator``: one ``(B, N, d)`` pair for the
whole population, indexed by global system id, so that a system's draw
does not depend on the chunk it lands in.  Callers that need the JAX
package's draws pass the finished tangents instead.
"""

from __future__ import annotations

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
