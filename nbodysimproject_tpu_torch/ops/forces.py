"""Plummer-softened pairwise gravity, batched.

Counterpart of ``nbodysimproject_tpu/ops/forces.py`` (parity:
``minbody/forces.py``) on ``(B, N, d)`` positions; ``eps`` and ``G``
are per-system ``(B,)`` tensors.
"""

from __future__ import annotations

from .geometry import pairwise_geometry


def gravitational_force(q, m, eps, G, mask=None):
    """F_i = -sum_j G m_i m_j (q_i - q_j) / (r_ij^2 + eps^2)^{3/2}."""
    diff, _r2, inv_r3 = pairwise_geometry(q, eps=eps, mask=mask)
    mprod = m[..., :, None] * m[..., None, :]
    coeff = -(G[..., None, None] * mprod) * inv_r3
    return (coeff[..., None] * diff).sum(-2)


#: the reference's alias (minbody/forces.py:116); the tiled large-N kernel
#: is ``ops/force_kernels.py::pairwise_force``
pairwise_force = gravitational_force


def force_auto(q, m, eps, G, mask, cfg):
    """Config-driven force dispatch shared by the classical and WHFast
    paths (``ops/forces.py:34-52`` of the JAX package): the tiled kernel
    of ``ops/force_kernels.py`` when ``cfg.use_pallas_forces`` and
    N >= ``cfg.pallas_force_min_n``, the dense ``gravitational_force``
    otherwise.  The tiled route ignores ``mask``, as the JAX route does:
    it takes the system as unpadded, and a padded slot, which carries
    zero mass, adds nothing to the other bodies' forces and receives
    F = 0."""
    n = q.shape[-2]
    if cfg is not None and cfg.use_pallas_forces \
            and n >= cfg.pallas_force_min_n:
        from .force_kernels import pairwise_force

        return pairwise_force(q, m, eps, G)
    return gravitational_force(q, m, eps, G, mask=mask)


def dV_d_epsilon(q, m, eps, G, mask=None):
    """dV/d(eps) = G eps sum_{i<j} m_i m_j / (r_ij^2 + eps^2)^{3/2}
    per system (minbody/forces.py:77-112)."""
    _diff, _r2, inv_r3 = pairwise_geometry(q, eps=eps, mask=mask)
    mprod = m[..., :, None] * m[..., None, :]
    return 0.5 * G * eps * (mprod * inv_r3).sum((-2, -1))


def softened_forces(q, m, G, eps, mask=None):
    """``gravitational_force`` in the reference's other argument order
    (minbody/forces.py:35-59)."""
    return gravitational_force(q, m, eps, G, mask=mask)


def dU_depsilon_plummer(pos, mass, G, epsilon, mask=None):
    """``dV_d_epsilon`` under the reference's alias
    (minbody/hamsoft_utils.py:225-231)."""
    return dV_d_epsilon(pos, mass, epsilon, G, mask=mask)
