"""Initial-condition generation, batch-first, from ``torch.Generator``s.

Counterpart of ``nbodysimproject_tpu/generators/ic_generator.py``
(capability parity: ``minbody/initial_condition_generator.py:29-169``):
uniform or log-uniform masses, Gaussian position clouds, velocities at
a virial-ratio target with random directions, perturbation noise with
the COM momentum projected out before and after, random body counts,
and system validation.  A whole ``(B, N, d)`` population is drawn at
once, ragged body counts as slot masks, per-system hyperparameters as
``(B,)`` tensors.

Each random function is split in two: a transform that takes its random
draws as tensors (``_generate_one``, ``virial_velocities``), which the
tests hold against the JAX package on draws replayed from its keys, and
a drawing wrapper (``generate_population``, ``sample_body_counts``) that
draws those tensors from a ``torch.Generator`` in a fixed, documented
order.  ``torch.Generator`` cannot reproduce ``jax.random`` streams: a
draw is reproducible for a given seed, device, shape and dtype, and a
draw on the card is not the CPU's draw for the same seed.

Two physics conventions are the reference's spec, kept as the JAX
package keeps them: the generator's virial potential uses ``r + eps``
(not Plummer ``sqrt(r^2 + eps^2)``), initial_condition_generator.py:70-78;
every body gets the same speed ``v_char`` in a random direction, then
Gaussian noise of ``v_char * perturbation``, :80-97.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device

_TINY = 1.0e-300


@dataclass
class GeneratorConfig:
    mass_range: Tuple[float, float] = (0.1, 10.0)
    use_log_mass: bool = False
    position_scale: float = 1.0
    velocity_virial_fraction: float = 1.0
    velocity_perturbation: float = 0.1
    softening: float = 0.05
    G: float = 1.0
    seed: Optional[int] = None


def check_generator(generator, device: torch.device) -> torch.Generator:
    """The generator to draw with on ``device``: ``generator`` itself,
    which must lie on that device (a generator on another device
    raises), or for ``None`` torch's default generator of the device
    (which ``utils/seeding.py::set_global_seed`` seeds)."""
    if generator is None:
        if device.type == "cuda":
            idx = device.index if device.index is not None \
                else torch.cuda.current_device()
            return torch.cuda.default_generators[idx]
        return torch.default_generator
    gd = generator.device
    if gd.type != device.type or (device.index is not None
                                  and gd.index is not None
                                  and gd.index != device.index):
        raise ValueError(f"the generator lies on {gd}, the draw is asked "
                         f"for on {device}")
    return generator


def per_system(x, B: int, dtype, device) -> torch.Tensor:
    """A scalar, array or tensor broadcast to a (B,) tensor."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return torch.broadcast_to(t, (B,)).clone()


# ----------------------------------------------------------------------
# transforms (batched over the leading system axis)
# ----------------------------------------------------------------------

def com_momentum_projection(m, v, mask):
    """Project out the centre-of-mass velocity (masked): ``m``/``mask``
    (B, N), ``v`` (B, N, d)."""
    mm = torch.where(mask, m, torch.zeros_like(m))
    M = torch.clamp_min(mm.sum(-1), _TINY)
    com = (mm[..., None] * v).sum(-2) / M[..., None]
    return torch.where(mask[..., None], v - com[..., None, :],
                       torch.zeros_like(v))


def com_recenter(m, q, mask):
    """Shift positions so the mass-weighted centre sits at the origin.

    A deliberate deviation of the JAX package from the reference
    generators (see its ``com_recenter``): the stability verdict needs
    |sum m q| < 1, so un-recentred cohorts would be labelled unstable
    by construction."""
    mm = torch.where(mask, m, torch.zeros_like(m))
    M = torch.clamp_min(mm.sum(-1), _TINY)
    com = (mm[..., None] * q).sum(-2) / M[..., None]
    return torch.where(mask[..., None], q - com[..., None, :],
                       torch.zeros_like(q))


def _pair_stats(q, m, mask, softening, G):
    """(U_gen, mean_sep) per system: the generator's r + eps potential
    and the mean pair distance, both over valid pairs only."""
    n = q.shape[-2]
    diff = q[..., :, None, :] - q[..., None, :, :]
    r = torch.sqrt((diff * diff).sum(-1))
    eye = torch.eye(n, dtype=torch.bool, device=q.device)
    pmf = ((mask[..., :, None] & mask[..., None, :]) & ~eye).to(q.dtype)
    mm = m[..., :, None] * m[..., None, :]
    # i != j double-counts every pair, hence the 0.5
    U = -0.5 * G * (pmf * mm / (r + softening[..., None, None]
                                + _TINY)).sum((-2, -1))
    npairs = torch.clamp_min(pmf.sum((-2, -1)), 1.0)
    mean_sep = (pmf * r).sum((-2, -1)) / npairs
    mean_sep = torch.where(mean_sep > 0.0, mean_sep,
                           torch.ones_like(mean_sep))
    return U, mean_sep


def virial_speed(m, q, mask, *, G, softening, virial_fraction):
    """The common speed v_char that puts each system at its requested
    virial ratio: K_target = -U/2 * fraction, v = sqrt(2 K / M); if the
    target is not positive, sqrt(G M / <r>).  Per-system arguments are
    (B,) tensors."""
    U, mean_sep = _pair_stats(q, m, mask, softening, G)
    M = torch.clamp_min(torch.where(mask, m, torch.zeros_like(m)).sum(-1),
                        _TINY)
    K_target = -0.5 * U * virial_fraction
    return torch.where(K_target > 0.0, torch.sqrt(2.0 * K_target / M),
                       torch.sqrt(G * M / mean_sep))


def virial_velocities(z_dir, z_noise, m, q, mask, *, G, softening,
                      virial_fraction, perturbation):
    """Random-direction velocities at the virial speed, perturbed, with
    the COM momentum projected out before and after the noise.
    ``z_dir``/``z_noise``: the direction and noise normals, (B, N, d)."""
    v_char = virial_speed(m, q, mask, G=G, softening=softening,
                          virial_fraction=virial_fraction)[..., None, None]
    speed = torch.sqrt((z_dir * z_dir).sum(-1, keepdim=True))
    v = torch.where(speed > 0.0, z_dir / torch.clamp_min(speed, _TINY)
                    * v_char, z_dir)
    v = com_momentum_projection(m, v, mask)
    v = v + z_noise * v_char * perturbation[..., None, None]
    v = torch.where(mask[..., None], v, torch.zeros_like(v))
    return com_momentum_projection(m, v, mask)


def _generate_one(u, z_pos, z_dir, z_noise, mask, p):
    """Systems from their draws: ``u`` the uniform mass draw (B, N),
    ``z_pos`` the position normals, ``z_dir``/``z_noise`` the velocity
    direction and noise normals (B, N, d); ``p`` a dict of (B,)
    hyperparameters (``log_mass`` boolean).  Returns (m, q, v)."""
    col = lambda k: p[k][:, None]
    lo, hi = col("mass_lo"), col("mass_hi")
    m_lin = lo + u * (hi - lo)
    m_log = torch.exp(torch.log(lo) + u * (torch.log(hi) - torch.log(lo)))
    m = torch.where(col("log_mass"), m_log, m_lin)
    m = torch.where(mask, m, torch.zeros_like(m))

    q = z_pos * p["position_scale"][:, None, None]
    q = torch.where(mask[..., None], q, torch.zeros_like(q))
    q = com_recenter(m, q, mask)

    v = virial_velocities(z_dir, z_noise, m, q, mask, G=p["G"],
                          softening=p["softening"],
                          virial_fraction=p["virial_fraction"],
                          perturbation=p["perturbation"])
    return m, q, v


_PARAM_NAMES = ("mass_lo", "mass_hi", "log_mass", "position_scale",
                "virial_fraction", "perturbation", "softening", "G")


# ----------------------------------------------------------------------
# drawing wrappers
# ----------------------------------------------------------------------

def generate_population(generator, n_bodies, *, n_slots: int, dim: int = 2,
                        mass_lo=0.1, mass_hi=10.0, log_mass=False,
                        position_scale=1.0, virial_fraction=1.0,
                        perturbation=0.1, softening=0.05, G=1.0,
                        dtype=torch.float64, device=None):
    """Draw a whole (B, n_slots, dim) population.

    ``n_bodies`` is a (B,) integer array or tensor; every other
    hyperparameter a scalar or (B,).  Draws from ``generator`` (on
    ``device``; ``None`` the device's default generator), in this
    order: the uniform mass draw (B, n_slots), the position normals,
    the velocity direction normals, the velocity noise normals (each
    (B, n_slots, dim)), all in ``dtype``.  ``device=None`` is the card.
    Returns (mass, pos, vel, mask)."""
    dev = resolve_device(device)
    gen = check_generator(generator, dev)
    n_bodies = torch.as_tensor(n_bodies, device=dev).to(torch.int64)
    B = n_bodies.shape[0]
    mask = torch.arange(n_slots, device=dev)[None, :] < n_bodies[:, None]
    u = torch.rand((B, n_slots), generator=gen, dtype=dtype, device=dev)
    shape = (B, n_slots, dim)
    z_pos, z_dir, z_noise = (torch.randn(shape, generator=gen, dtype=dtype,
                                         device=dev) for _ in range(3))
    vals = (mass_lo, mass_hi, log_mass, position_scale, virial_fraction,
            perturbation, softening, G)
    p = {k: per_system(x, B, torch.bool if k == "log_mass" else dtype, dev)
         for k, x in zip(_PARAM_NAMES, vals)}
    m, q, v = _generate_one(u, z_pos, z_dir, z_noise, mask, p)
    return m, q, v, mask


def sample_body_counts(generator, B: int, n_range: Tuple[int, int], *,
                       device=None):
    """(B,) body counts uniform over the inclusive range (int64)."""
    dev = resolve_device(device)
    return torch.randint(int(n_range[0]), int(n_range[1]) + 1, (B,),
                         generator=check_generator(generator, dev),
                         device=dev)


# ----------------------------------------------------------------------
# reference-shaped surface over the batched functions
# ----------------------------------------------------------------------

class InitialConditionGenerator:
    """API-parity view: the reference's per-system methods, by slicing
    the batch-first functions.  ``device=None`` draws on the card."""

    def __init__(self, config: GeneratorConfig | None = None,
                 sim_config=None, device=None):
        self.config = config or GeneratorConfig()
        self.sim_config = sim_config
        self.device = resolve_device(device)
        seed = self.config.seed
        if seed is None:
            # tie unseeded generators into the global numpy stream so
            # set_global_seed reproduces whole pipelines
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

    def _params(self) -> Dict:
        c = self.config
        return dict(mass_lo=c.mass_range[0], mass_hi=c.mass_range[1],
                    log_mass=c.use_log_mass,
                    position_scale=c.position_scale,
                    virial_fraction=c.velocity_virial_fraction,
                    perturbation=c.velocity_perturbation,
                    softening=c.softening, G=c.G)

    def _draw(self, counts, n_slots):
        return generate_population(self._gen, counts, n_slots=int(n_slots),
                                   device=self.device, **self._params())

    def generate_single(self, n_bodies: int):
        m, q, v, _ = self._draw([int(n_bodies)], n_bodies)
        return tuple(x[0].cpu().numpy() for x in (m, q, v))

    def generate_batch(self, n_systems: int,
                       n_bodies_range: Tuple[int, int] = (3, 5)) -> List:
        counts = sample_body_counts(self._gen, n_systems, n_bodies_range,
                                    device=self.device)
        m, q, v, _ = self._draw(counts, n_bodies_range[1])
        m, q, v = (x.cpu().numpy() for x in (m, q, v))
        return [(m[i, :n], q[i, :n], v[i, :n])
                for i, n in enumerate(counts.cpu().numpy())]

    def generate_batch_arrays(self, n_systems: int,
                              n_bodies_range: Tuple[int, int] = (3, 5),
                              n_slots: int | None = None):
        """Padded + masked (B, N, d) tensors for the batched engine."""
        counts = sample_body_counts(self._gen, n_systems, n_bodies_range,
                                    device=self.device)
        return self._draw(counts, n_slots or n_bodies_range[1])

    def create_simulation(self, n_bodies: int, *, integrator_mode=None,
                          adaptive_softening=None):
        """A facade simulation of one drawn system, on this generator's
        device, under ``sim_config`` where one was given."""
        from ..facade.simulation import NBodySimulation

        m, q, v = self.generate_single(n_bodies)
        kwargs: Dict = dict(masses=m, positions=q, velocities=v,
                            G=self.config.G, softening=self.config.softening,
                            device=self.device)
        if self.sim_config is not None:
            kwargs["config"] = self.sim_config
        if integrator_mode is not None:
            kwargs["integrator_mode"] = integrator_mode
        if adaptive_softening is not None:
            kwargs["adaptive_softening"] = adaptive_softening
        return NBodySimulation(**kwargs)

    def validate_system(self, masses, positions, velocities) -> Dict[str, float]:
        """Energy/virial/momentum report computed on the arrays in
        float64 (the COM velocity projected out first, as facade
        construction would)."""
        f64 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                        device=self.device)
        m, q = f64(masses), f64(positions)
        mask = torch.ones(m.shape, dtype=torch.bool, device=self.device)
        v = com_momentum_projection(m[None], f64(velocities)[None],
                                    mask[None])[0]
        G, eps = self.config.G, self.config.softening

        KE = float(0.5 * (m[:, None] * v * v).sum())
        diff = q[:, None, :] - q[None, :, :]
        r2 = (diff * diff).sum(-1)
        i, j = torch.triu_indices(m.shape[0], m.shape[0], 1,
                                  device=self.device)
        PE = float(-G * ((m[:, None] * m[None, :])[i, j]
                         / torch.sqrt(r2[i, j] + eps * eps)).sum())
        E_tot = KE + PE
        L = float((m * (q[:, 0] * v[:, 1] - q[:, 1] * v[:, 0])).sum())
        M = float(m.sum())
        com_q = ((m[:, None] * q).sum(0) / max(M, _TINY)).cpu().numpy()
        com_v = ((m[:, None] * v).sum(0) / max(M, _TINY)).cpu().numpy()
        return {
            "kinetic_energy": KE,
            "potential_energy": PE,
            "total_energy": E_tot,
            "virial_ratio": (2.0 * KE / abs(PE)) if PE else float("inf"),
            "angular_momentum": L,
            "com_position": float(np.linalg.norm(com_q)),
            "com_velocity": float(np.linalg.norm(com_v)),
            "is_bound": bool(E_tot < 0),
        }
