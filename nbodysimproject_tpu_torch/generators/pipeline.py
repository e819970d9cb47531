"""ML dataset orchestration: the batched pipeline and its sim-list views.

Counterpart of ``nbodysimproject_tpu/generators/pipeline.py``
(capability parity: ``minbody/ml_training_pipeline.py:30-235``): the
four-cohort diverse mixture (40% random with alternating log-mass, 30%
hierarchical triples with velocity noise, 20% rotating polygons, the
rest close encounters), the two stability-edge cohorts, the headline v3
mixture, and ``MLTrainingPipeline.generate_diverse_dataset_batched``,
which draws a population and analyses it with ``analyze_population``.

Each cohort is drawn by one batched call from a ``torch.Generator``
(``generator``, on ``device``; ``device=None`` is the card), with the
JAX package's hyperparameter distributions and cohort order.  The
draws are reproducible for a given seed, device and dtype, not across
devices, and never the JAX package's (``jax.random`` streams cannot be
reproduced in PyTorch): the tests compare cohort statistics
distributionally and the transforms on replayed draws.

The sim-list views (``generate_diverse_dataset``,
``generate_focused_dataset``, ``quick_test_pipeline``) build facade
simulations (``facade/simulation.py``) on the pipeline's device and
analyse them with the facade's analyzers, as the JAX package's do
(ml_training_pipeline.py:39-235).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..analysis.batch import BatchStabilityAnalyzer
from ..core.config import SimConfig
from ..core.device import resolve_device
from .ic_generator import (GeneratorConfig, InitialConditionGenerator,
                           _pair_stats, check_generator, generate_population,
                           sample_body_counts)
from .specialized import hierarchical_triple_batch, polygon_batch

#: the dataset pipeline's configuration (the JAX package's
#: ``generators/pipeline.py:40-51``, which documents each choice):
#: body slots bucketed to 8, float32, n_sub capped at 256, the fused
#: analysis engine, 1024-lane dispatch quantum, the Kepler tail policy
_PIPE_CFG = SimConfig(slot_bucket=8, fast_float32=True,
                      analysis_n_sub_cap=256, use_fused_analysis=True,
                      analysis_group_quantum=1024)

#: cohort mixture of the reference pipeline (ml_training_pipeline.py:39-135)
COHORT_FRACTIONS = {"random": 0.4, "hierarchical": 0.3, "polygon": 0.2}
#: inclusive body-count range of each cohort of the diverse mixture
COHORT_BODY_COUNTS = {"random": (3, 5), "hierarchical": (3, 3),
                      "polygon": (3, 7), "close_encounter": (3, 4)}


def cohort_sizes(n_systems: int) -> dict:
    n_random = int(COHORT_FRACTIONS["random"] * n_systems)
    n_hier = int(COHORT_FRACTIONS["hierarchical"] * n_systems)
    n_poly = int(COHORT_FRACTIONS["polygon"] * n_systems)
    return {"random": n_random, "hierarchical": n_hier, "polygon": n_poly,
            "close_encounter": n_systems - n_random - n_hier - n_poly}


def _cat(parts):
    """(mass, pos, vel, mask, softening, types) of cohorts in order."""
    out = tuple(torch.cat([p[i] for p in parts]) for i in range(5))
    return out + (sum((list(p[5]) for p in parts), []),)


def diverse_population(generator, n_systems: int, *, n_slots: int = 8,
                       dtype=torch.float32, dim: int = 2, device=None):
    """Draw the four-cohort diverse population as (B, N, d) tensors.

    Returns (mass, pos, vel, mask, softening, types): padded + masked
    tensors, the per-system force softening and the cohort tag list, the
    cohorts in the JAX package's order with its distributions:

    * random (40%): n in [3, 5], log-mass on alternating systems,
      position scale U(0.5, 2), virial fraction U(0.8, 1.2),
      perturbation U(0.05, 0.2), softening U(0.001, 0.1);
    * hierarchical (30%): mass ratios U(0.1, 1) / U(0.1, 2), separation
      U(3, 50), Gaussian velocity noise 0.05, softening 0.01;
    * polygon (20%): n in [3, 7], radius U(0.5, 3), rotation U(0, 1),
      softening 0.05;
    * close encounter (rest): n in [3, 4], scale 0.1, virial 1.5,
      perturbation 0.3, softening 0.001.

    ``dim=3`` draws the random and close-encounter cohorts in 3-D,
    gives the triples an isotropic mutual inclination (cos i ~ U(-1, 1))
    and the polygons a tilt U(0, pi).

    Draw order from ``generator``: random (body counts, the (4, B)
    hyperparameter uniforms, ``generate_population``'s draws);
    hierarchical (the (3, B) uniforms, at d = 3 the (B,) cos i uniforms,
    the velocity noise normals); polygon (body counts, the (2, B)
    uniforms, at d = 3 the (B,) tilt uniforms); close encounter (body
    counts, ``generate_population``'s draws).
    """
    dev = resolve_device(device)
    gen = check_generator(generator, dev)
    sizes = cohort_sizes(n_systems)
    uni = lambda shape: torch.rand(shape, generator=gen, dtype=dtype,
                                   device=dev)
    full = lambda B, x: torch.full((B,), x, dtype=dtype, device=dev)
    kw = dict(n_slots=n_slots, dim=dim, dtype=dtype, device=dev)
    parts = []

    B = sizes["random"]
    if B:
        counts = sample_body_counts(gen, B, COHORT_BODY_COUNTS["random"],
                                    device=dev)
        hp = uni((4, B))
        soft = 0.001 + hp[3] * (0.1 - 0.001)
        m, q, v, mask = generate_population(
            gen, counts, log_mass=torch.arange(B, device=dev) % 2 == 0,
            position_scale=0.5 + hp[0] * 1.5,
            virial_fraction=0.8 + hp[1] * 0.4,
            perturbation=0.05 + hp[2] * 0.15, softening=soft, **kw)
        parts.append((m, q, v, mask, soft, ["random"] * B))

    B = sizes["hierarchical"]
    if B:
        hp = uni((3, B))
        inc = None
        if dim == 3:
            inc = torch.arccos(-1.0 + uni((B,)) * 2.0)
        m, q, v, mask = hierarchical_triple_batch(
            0.1 + hp[0] * 0.9, 0.1 + hp[1] * 1.9, 3.0 + hp[2] * 47.0,
            n_slots=n_slots, dtype=dtype, inclination=inc, device=dev)
        v = v + torch.randn(v.shape, generator=gen, dtype=dtype,
                            device=dev) * 0.05
        v = torch.where(mask[..., None], v, torch.zeros_like(v))
        parts.append((m, q, v, mask, full(B, 0.01), ["hierarchical"] * B))

    B = sizes["polygon"]
    if B:
        counts = sample_body_counts(gen, B, COHORT_BODY_COUNTS["polygon"],
                                    device=dev)
        hp = uni((2, B))
        tilt = uni((B,)) * math.pi if dim == 3 else None
        m, q, v, mask = polygon_batch(counts, 0.5 + hp[0] * 2.5, hp[1],
                                      n_slots=n_slots, dtype=dtype,
                                      tilt=tilt, device=dev)
        parts.append((m, q, v, mask, full(B, 0.05), ["polygon"] * B))

    B = sizes["close_encounter"]
    if B:
        counts = sample_body_counts(
            gen, B, COHORT_BODY_COUNTS["close_encounter"], device=dev)
        m, q, v, mask = generate_population(
            gen, counts, position_scale=0.1, virial_fraction=1.5,
            perturbation=0.3, softening=0.001, **kw)
        parts.append((m, q, v, mask, full(B, 0.001),
                      ["close_encounter"] * B))
    return _cat(parts)


def boundary_hier_population(generator, n_systems: int, *, n_slots: int = 8,
                             dtype=torch.float32, sep_range=(2.0, 10.0),
                             noise_range=(0.05, 0.3), device=None):
    """Hierarchical triples straddling the Mardling-Aarseth stability
    edge: separation U(sep_range) floored at its low end, velocity
    noise of amplitude U(noise_range).  Draw order: the (3, B)
    hyperparameter uniforms, the noise normals, the (B, 1, 1) amplitude
    uniforms.  Returns (mass, pos, vel, mask, softening, types)."""
    dev = resolve_device(device)
    gen = check_generator(generator, dev)
    s_lo, s_hi = float(sep_range[0]), float(sep_range[1])
    a_lo, a_hi = float(noise_range[0]), float(noise_range[1])
    uni = lambda shape: torch.rand(shape, generator=gen, dtype=dtype,
                                   device=dev)
    hp = uni((3, n_systems))
    m, q, v, mask = hierarchical_triple_batch(
        0.1 + hp[0] * 0.9, 0.1 + hp[1] * 1.9, s_lo + hp[2] * (s_hi - s_lo),
        n_slots=n_slots, dtype=dtype, min_separation=s_lo, device=dev)
    noise = torch.randn(v.shape, generator=gen, dtype=dtype, device=dev)
    amp = a_lo + uni((n_systems, 1, 1)) * (a_hi - a_lo)
    v = v + noise * amp
    v = torch.where(mask[..., None], v, torch.zeros_like(v))
    soft = torch.full((n_systems,), 0.01, dtype=dtype, device=dev)
    return m, q, v, mask, soft, ["hierarchical_boundary"] * n_systems


def boundary_close_population(generator, n_systems: int, *, n_slots: int = 8,
                              dtype=torch.float32, dim: int = 2,
                              device=None):
    """Close encounters straddling the stability edge: virial fraction
    U(0.6, 1.4), scale U(0.1, 0.5), perturbation U(0.05, 0.3), softening
    logU(1e-3, 3e-2).  Draw order: body counts, the (4, B)
    hyperparameter uniforms, ``generate_population``'s draws."""
    dev = resolve_device(device)
    gen = check_generator(generator, dev)
    counts = sample_body_counts(gen, n_systems, (3, 4), device=dev)
    hp = torch.rand((4, n_systems), generator=gen, dtype=dtype, device=dev)
    lo, hi = math.log(1e-3), math.log(3e-2)
    soft = torch.exp(lo + hp[3] * (hi - lo))
    m, q, v, mask = generate_population(
        gen, counts, n_slots=n_slots, dim=dim,
        position_scale=0.1 + hp[0] * 0.4, virial_fraction=0.6 + hp[1] * 0.8,
        perturbation=0.05 + hp[2] * 0.25, softening=soft, dtype=dtype,
        device=dev)
    return m, q, v, mask, soft, ["close_encounter_boundary"] * n_systems


#: headline v3 mixture: the four reference cohorts plus the two
#: stability-edge slices
HEADLINE_V3_FRACTIONS = {"random": 0.35, "hierarchical": 0.15,
                         "hierarchical_boundary": 0.15, "polygon": 0.15,
                         "close_encounter": 0.10}


def _select(types, budget):
    """Indices of ``types`` taken in order while their cohort's budget
    lasts (the budget is consumed in place)."""
    keep = []
    for i, ty in enumerate(types):
        if budget.get(ty, 0) > 0:
            keep.append(i)
            budget[ty] -= 1
    return keep


def headline_population(generator, n_systems: int, *, n_slots: int = 8,
                        dtype=torch.float32, dim: int = 2, device=None):
    """The headline mixture: random 35%, hierarchical 15%,
    hierarchical_boundary 15% (separation U(1.5, 5), velocity noise
    U(0.1, 0.5)), polygon 15%, close_encounter 10%,
    close_encounter_boundary (the rest).  The four standard cohorts are
    trimmed from a ``diverse_population`` draw of 75% of the size and
    topped up from a second one, in the JAX package's order (so that
    ``types`` lines up with the rows).  Draw order: the first diverse
    draw, the second if a cohort is short, the hierarchical boundary
    cohort, the close boundary cohort.  Returns (mass, pos, vel, mask,
    softening, types)."""
    dev = resolve_device(device)
    gen = check_generator(generator, dev)
    fr = HEADLINE_V3_FRACTIONS
    n_r = int(fr["random"] * n_systems)
    n_h = int(fr["hierarchical"] * n_systems)
    n_hb = int(fr["hierarchical_boundary"] * n_systems)
    n_p = int(fr["polygon"] * n_systems)
    n_c = int(fr["close_encounter"] * n_systems)
    n_cb = n_systems - n_r - n_h - n_hb - n_p - n_c
    n_div = n_r + n_h + n_p + n_c
    kw = dict(n_slots=n_slots, dtype=dtype, dim=dim, device=dev)

    first = diverse_population(gen, n_div, **kw)
    budget = {"random": n_r, "hierarchical": n_h, "polygon": n_p,
              "close_encounter": n_c}
    keep = _select(first[5], budget)
    short = {k: n for k, n in budget.items() if n > 0}
    take = lambda pop, idx: tuple(
        a[torch.as_tensor(idx, dtype=torch.int64, device=dev)]
        for a in pop[:5]) + ([pop[5][i] for i in idx],)
    parts = [take(first, keep)]
    if short:
        second = diverse_population(gen, n_div, **kw)
        parts.append(take(second, _select(second[5], short)))
    if n_hb:
        hb = boundary_hier_population(gen, n_hb, n_slots=n_slots,
                                      dtype=dtype, sep_range=(1.5, 5.0),
                                      noise_range=(0.1, 0.5), device=dev)
        if dim == 3:
            # the planar boundary triples embedded in 3-D (z = 0)
            pad = lambda a: torch.cat([a, torch.zeros(
                a.shape[:-1] + (1,), dtype=a.dtype, device=dev)], -1)
            hb = (hb[0], pad(hb[1]), pad(hb[2])) + hb[3:]
        parts.append(hb)
    if n_cb:
        parts.append(boundary_close_population(gen, n_cb, **kw))
    return _cat(parts)


def population_statistics(mass, pos, vel, mask, softening, G=1.0):
    """Per-system (B,) tensors of total mass, virial ratio 2 K / |U|
    (U the generator's r + eps potential) and mean pair separation: the
    statistics the tests compare between the JAX package's draws and
    the port's."""
    B = mass.shape[0]
    soft = torch.as_tensor(softening, dtype=pos.dtype,
                           device=pos.device).broadcast_to((B,))
    Gb = torch.full((B,), float(G), dtype=pos.dtype, device=pos.device)
    m = torch.where(mask, mass, torch.zeros_like(mass))
    U, mean_sep = _pair_stats(pos, m, mask, soft, Gb)
    K = 0.5 * (m[..., None] * vel * vel).sum((-2, -1))
    return {"total_mass": m.sum(-1), "virial_ratio": 2.0 * K / U.abs(),
            "mean_separation": mean_sep}


class MLTrainingPipeline:
    """The diverse mixture drawn and analysed in one batched pass, and
    the sim-list views over the facade.  ``device=None`` runs on the
    card."""

    def __init__(self, n_systems: int = 1000, n_steps: int = 1000,
                 dt: float = 0.01, seed: int = 0, device=None):
        self.n_systems = n_systems
        self.n_steps = max(500, min(2000, n_steps))
        self.dt = dt
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.ic_generator = InitialConditionGenerator(sim_config=_PIPE_CFG,
                                                      device=self.device)
        self.batch_analyzer = BatchStabilityAnalyzer(
            n_steps=self.n_steps, dt=self.dt, mode="full")

    def _population(self, dtype=torch.float32):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        return diverse_population(gen, self.n_systems, n_slots=8,
                                  dtype=dtype, device=self.device)

    def generate_diverse_dataset_batched(self, timing_out=None):
        """The four cohorts drawn as (B, N, d) tensors and analysed by
        ``analyze_population`` (full mode) under ``_PIPE_CFG``; the
        frame gets a ``system_type`` column in cohort order."""
        from ..analysis.batch import analyze_population

        print(f"Generating {self.n_systems} diverse N-body systems "
              f"(batched)...")
        mass, pos, vel, mask, soft, types = self._population()
        df = analyze_population(
            mass, pos, vel, mask, _PIPE_CFG, G=1.0, softening=soft,
            min_softening=0.0, dt=self.dt, n_steps=self.n_steps,
            mode="full", seed=self.seed, device=self.device,
            timing_out=timing_out)
        df["system_type"] = types
        return df

    def _sim(self, m, p, v, **kw):
        """A facade simulation under ``_PIPE_CFG`` (the JAX package's
        pipeline builds every one of its simulations so)."""
        from ..facade.simulation import NBodySimulation

        return NBodySimulation(config=_PIPE_CFG, masses=m, positions=p,
                               velocities=v, device=self.device, **kw)

    def generate_diverse_dataset(self):
        """The sim-list view of the diverse mixture: the same population
        drawn on the device, one facade simulation per system, analysed
        by the facade's batch analyzer (ml_training_pipeline.py:39-135)."""
        sizes = cohort_sizes(self.n_systems)
        print(f"Generating {self.n_systems} diverse N-body systems "
              f"({', '.join(f'{v} {k}' for k, v in sizes.items())})...")
        mass, pos, vel, mask, soft, types = self._population()
        mass, pos, vel, soft = (x.cpu().numpy()
                                for x in (mass, pos, vel, soft))
        counts = mask.sum(1).cpu().numpy()
        simulations = [
            self._sim(mass[i, :n], pos[i, :n], vel[i, :n], G=1.0,
                      softening=float(soft[i]))
            for i, n in enumerate(counts)]
        print(f"\nAnalyzing {len(simulations)} systems...")
        results_df = self.batch_analyzer.analyze_batch(simulations,
                                                       show_progress=True)
        results_df["system_type"] = types
        return results_df

    def generate_focused_dataset(self, focus: str = "boundary"):
        """Simulations focused on the stability boundary, on stable
        hierarchies or on chaotic clusters, their hyperparameters drawn
        from numpy's global stream as in the JAX package
        (ml_training_pipeline.py:137-196)."""
        from .specialized import SpecializedGenerators as SG

        print(f"Generating {self.n_systems} systems focused on {focus} "
              f"cases...")
        dev = self.device
        icg = lambda cfg: InitialConditionGenerator(cfg, sim_config=_PIPE_CFG,
                                                    device=dev)
        simulations = []
        for i in range(self.n_systems):
            if focus == "boundary" and i % 3 == 0:
                sim = self._sim(*SG.generate_hierarchical_triple(
                    separation_ratio=np.random.uniform(5, 15), device=dev))
            elif focus == "boundary" and i % 3 == 1:
                sim = icg(GeneratorConfig(
                    velocity_virial_fraction=1.0,
                    velocity_perturbation=np.random.uniform(0.1, 0.3))
                ).create_simulation(np.random.randint(3, 5))
            elif focus == "boundary":
                sim = self._sim(*SG.generate_equal_mass_polygon(
                    np.random.randint(4, 7),
                    rotation_fraction=np.random.uniform(0.3, 0.7),
                    device=dev))
            elif focus == "stable":
                m, p, v = SG.generate_hierarchical_triple(
                    separation_ratio=np.random.uniform(20, 100), device=dev)
                v = v + np.random.randn(*v.shape) * 0.01
                sim = self._sim(m, p, v, softening=0.01)
            else:
                sim = icg(GeneratorConfig(
                    position_scale=0.1,
                    velocity_virial_fraction=np.random.uniform(1.5, 2.0),
                    velocity_perturbation=0.5, softening=0.001)
                ).create_simulation(np.random.randint(3, 6))
            simulations.append(sim)
        results_df = self.batch_analyzer.analyze_batch(simulations)
        results_df["dataset_focus"] = focus
        return results_df

    def quick_test_pipeline(self):
        """Ten systems of 3-5 bodies, each through the single-system
        analyzer in core mode for 100 steps
        (ml_training_pipeline.py:198-235)."""
        import pandas as pd

        from ..analysis.stability import StabilityAnalyzer
        from ..utils.seeding import set_global_seed

        set_global_seed(42)
        print("Running quick test with 10 systems...")
        generator = InitialConditionGenerator(device=self.device)
        test_sims = [generator.create_simulation(3 + (i % 3))
                     for i in range(10)]
        print("\nTesting unified analyzer in core mode...")
        results = []
        for i, sim in enumerate(test_sims):
            result = StabilityAnalyzer(sim, n_steps=100, dt=0.01,
                                       mode="core").run_stability_analysis()
            result["system_id"] = i
            results.append(result)
            status = "STABLE" if result["is_stable"] else "UNSTABLE"
            print(f"System {i}: {status} "
                  f"(E_drift={result['energy_drift']:.2e})")
        test_df = pd.DataFrame(results)
        n_stable = int(sum(test_df["is_stable"]))
        print(f"\nTest complete. {n_stable} stable, "
              f"{len(test_df) - n_stable} unstable")
        return test_df
