"""Specialized deterministic configurations.

Counterpart of ``nbodysimproject_tpu/generators/specialized.py``
(capability parity: ``minbody/specialized_generators.py``,
``generate_hierarchical_triple`` :22-64 and
``generate_equal_mass_polygon`` :66-94): batch builders that turn (B,)
parameter tensors into whole ``(B, N, d)`` cohorts, and the
reference-shaped per-system static methods.  Nothing here draws: the
builders are held against the JAX ones directly.  ``device=None`` is
the card.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.device import resolve_device
from .ic_generator import com_momentum_projection, com_recenter, per_system


def hierarchical_triple_batch(mass_ratio1, mass_ratio2, separation_ratio,
                              *, G=1.0, n_slots: int = 3,
                              dtype=torch.float64,
                              min_separation: float = 5.0,
                              inclination=None, device=None):
    """(B,) parameters -> (mass, pos, vel, mask) for hierarchical
    triples: an inner circular binary of unit semi-major axis and an
    outer body at max(separation, min_separation) on a circular orbit
    around the total mass, COM momentum projected out, COM recentred.

    ``min_separation`` defaults to the reference's floor of 5; the
    boundary cohort lowers it.  ``inclination`` (B,) makes the system
    three-dimensional: the outer velocity rotated about the x-axis,
    the inner binary in the xy-plane."""
    dev = resolve_device(device)
    r1 = torch.as_tensor(mass_ratio1, dtype=dtype, device=dev)
    B = r1.shape[0]
    r2 = per_system(mass_ratio2, B, dtype, dev)
    sep = per_system(separation_ratio, B, dtype, dev)
    Gb = per_system(G, B, dtype, dev)

    m1 = torch.ones((B,), dtype=dtype, device=dev)
    m2, m3 = r1, r2
    m12 = m1 + m2
    a_outer = torch.clamp_min(sep, min_separation)

    x1 = -m2 / m12
    x2 = m1 / m12
    v_inner = torch.sqrt(Gb * m12)
    vy1 = -m2 * v_inner / m12
    vy2 = m1 * v_inner / m12
    v_outer = torch.sqrt(Gb * (m12 + m3) / a_outer)

    zeros = torch.zeros_like(m1)
    mass = torch.stack([m1, m2, m3], 1)
    pos = torch.stack([torch.stack([x1, zeros], 1),
                       torch.stack([x2, zeros], 1),
                       torch.stack([a_outer, zeros], 1)], 1)
    vel = torch.stack([torch.stack([zeros, vy1], 1),
                       torch.stack([zeros, vy2], 1),
                       torch.stack([zeros, v_outer], 1)], 1)
    if inclination is not None:
        inc = torch.as_tensor(inclination, dtype=dtype, device=dev)
        pos = torch.cat([pos, torch.zeros((B, 3, 1), dtype=dtype,
                                          device=dev)], -1)
        one = torch.ones_like(inc)
        vy_new = vel[..., 1] * torch.stack([one, one, torch.cos(inc)], 1)
        vz = torch.stack([zeros, zeros, v_outer * torch.sin(inc)], 1)
        vel = torch.stack([vel[..., 0], vy_new, vz], -1)
    pad = n_slots - 3
    if pad > 0:
        mass = torch.nn.functional.pad(mass, (0, pad))
        pos = torch.nn.functional.pad(pos, (0, 0, 0, pad))
        vel = torch.nn.functional.pad(vel, (0, 0, 0, pad))
    mask = torch.broadcast_to(torch.arange(n_slots, device=dev)[None, :] < 3,
                              (B, n_slots)).clone()
    vel = com_momentum_projection(mass, vel, mask)
    pos = com_recenter(mass, pos, mask)
    return mass, pos, vel, mask


def polygon_batch(n_bodies, radius, rotation_fraction, *, G=1.0,
                  n_slots: int = 8, dtype=torch.float64, tilt=None,
                  device=None):
    """(B,) parameters -> (mass, pos, vel, mask) for rotating equal-mass
    polygons with per-system body counts (masked slots), COM momentum
    projected out.  ``tilt`` (B,) embeds the ring in d = 3, rotated
    about the x-axis."""
    dev = resolve_device(device)
    n = torch.as_tensor(n_bodies, device=dev).to(torch.int64)
    B = n.shape[0]
    R = per_system(radius, B, dtype, dev)
    rot = per_system(rotation_fraction, B, dtype, dev)
    Gb = per_system(G, B, dtype, dev)

    k = torch.arange(n_slots, dtype=dtype, device=dev)[None, :]
    nf = n.to(dtype)[:, None]
    mask = torch.arange(n_slots, device=dev)[None, :] < n[:, None]
    theta = 2.0 * math.pi * k / torch.clamp_min(nf, 1.0)

    mass = torch.where(mask, torch.ones((), dtype=dtype, device=dev),
                       torch.zeros((), dtype=dtype, device=dev))
    pos = torch.stack([R[:, None] * torch.cos(theta),
                       R[:, None] * torch.sin(theta)], -1)
    v_scale = torch.sqrt(Gb * nf[:, 0] / R) * rot
    vel = torch.stack([-v_scale[:, None] * torch.sin(theta),
                       v_scale[:, None] * torch.cos(theta)], -1)
    if tilt is not None:
        t = torch.as_tensor(tilt, dtype=dtype, device=dev)[:, None]
        ct, st = torch.cos(t), torch.sin(t)

        def rot_x(a):
            x, y = a[..., 0], a[..., 1]
            return torch.stack([x, y * ct, y * st], -1)

        pos, vel = rot_x(pos), rot_x(vel)
    zero = torch.zeros_like(pos)
    pos = torch.where(mask[..., None], pos, zero)
    vel = torch.where(mask[..., None], vel, zero)
    vel = com_momentum_projection(mass, vel, mask)
    return mass, pos, vel, mask


class SpecializedGenerators:
    """The reference's per-system surface (numpy arrays out)."""

    @staticmethod
    def generate_hierarchical_triple(
        mass_ratio1: float = 1.0,
        mass_ratio2: float = 0.5,
        separation_ratio: float = 10.0,
        G: float = 1.0,
        device=None,
    ) -> Tuple:
        m, q, v, _ = hierarchical_triple_batch(
            [mass_ratio1], [mass_ratio2], [separation_ratio], G=G,
            n_slots=3, device=device)
        return tuple(x[0].cpu().numpy() for x in (m, q, v))

    @staticmethod
    def generate_equal_mass_polygon(
        n_bodies: int,
        radius: float = 1.0,
        rotation_fraction: float = 0.5,
        G: float = 1.0,
        device=None,
    ) -> Tuple:
        m, q, v, _ = polygon_batch([n_bodies], [radius], [rotation_fraction],
                                   G=G, n_slots=int(n_bodies),
                                   device=device)
        return tuple(x[0].cpu().numpy() for x in (m, q, v))
