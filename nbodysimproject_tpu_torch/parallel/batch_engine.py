"""Batched system construction.

Counterpart of ``nbodysimproject_tpu/parallel/batch_engine.py``
(``build_batch``, ``init_system``, ``_init_hamsoft``, ``refreeze_jit``):
COM removal, eps-model calibration, k/mu calibration and the frozen
schedule (the simulation.py:39-162 + HSI:47-141 cascade) as tensor
operations over a leading system axis — no per-system host loop — the
facade's one-system construction and schedule refreeze, and
``integrate_batch``
/ ``step_batch`` (``integrate_dynamic`` / ``macro_step_dynamic`` of
``integrators/step.py`` on the whole batch: the JAX package's vmap is
the batch axis here).  Integrator modes ham_soft, verlet and yoshida4
and, with the classical construction, whfast and kepler_split, at d = 2
or 3.
"""

from __future__ import annotations

import torch

from ..core.config import SimConfig
from ..core.state import DynParams, SimState, remove_center_of_mass_velocity
from ..integrators import calibration as calib
from ..integrators import hamsoft as hs
from ..ops import eps_model as epsmod
from ..integrators.step import integrate_dynamic, macro_step_dynamic


def _per_system(x, B, like):
    """A scalar, array or tensor broadcast to a (B,) tensor like ``like``."""
    t = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(t, (B,)).clone()


def build_batch(mass, pos, vel, mask, cfg: SimConfig, G, softening,
                min_softening, dt, skip_cm_recenter: bool = False):
    """Construct batched (SimState, DynParams) for a (B, N[, d])
    population; ``G`` / ``softening`` / ``min_softening`` may be scalars
    or (B,) arrays.  The tensors' device and dtype come from ``pos``."""
    B = pos.shape[0]
    f = lambda x: _per_system(x, B, pos)
    if not skip_cm_recenter:
        vel = remove_center_of_mass_velocity(mass, vel, mask)

    min_softening = torch.clamp_min(f(min_softening), 0.0)
    softening = f(softening)
    softening = torch.where(softening < 0.0, min_softening, softening)
    min_softening = torch.where((min_softening == 0.0) & (softening > 0.0),
                                0.1 * softening, min_softening)
    s0 = torch.maximum(softening, min_softening)
    max_softening = 10.0 * s0
    zero = f(0.0)

    state = SimState(
        mass=mass, pos=pos, vel=vel, eps=s0, pi=zero, s=s0,
        step_s2=s0 * s0, softening_energy_delta=zero,
        hist_count=f(1.0), hist_sum=s0, hist_sumsq=s0 * s0, mask=mask)
    dyn = DynParams(
        G=f(G), s0=s0, min_softening=min_softening,
        max_softening=max_softening, softening_scale=f(cfg.softening_scale),
        k_soft=zero, mu_soft=f(1.0), chi_eps=f(1.0), k_wall=f(cfg.k_wall),
        alpha_run=f(1.0), omega_spr0=zero, h_sub_ref=zero,
        n_sub=torch.ones(B, dtype=torch.int32, device=pos.device),
        frozen_dt=f(dt))
    if cfg.integrator_mode == "ham_soft":
        return _init_hamsoft(state, dyn, cfg, f(dt))
    return _init_classical(state, dyn, cfg, f(dt))


def _init_classical(state, dyn, cfg, dt):
    """The verlet/yoshida4 schedule (timestep_manager.py:139-253,
    integrator.py:91)."""
    eps_star = torch.where(dyn.s0 > 0.0, dyn.s0,
                           torch.where(dyn.softening_scale > 0.0,
                                       dyn.softening_scale, state.eps))
    h_sub = calib.init_substep_schedule(
        state.pos, state.mass, state.vel, dyn.G, eps_cur=state.eps,
        pi=state.pi, k_soft=dyn.k_soft, mu_soft=dyn.mu_soft,
        min_softening=dyn.min_softening, max_softening=dyn.max_softening,
        eps_star=eps_star, grad_norm=torch.zeros_like(eps_star),
        theta_cap=float(cfg.theta_cap), dt_user=dt,
        split_n_max=int(cfg.split_n_max), mask=state.mask)
    n_sub = calib.classical_n_sub(dt, h_sub, int(cfg.split_n_max))
    return state, dyn.replace(h_sub_ref=h_sub, n_sub=n_sub,
                              frozen_dt=torch.abs(dt))


def _init_hamsoft(state, dyn, cfg, dt):
    f = lambda x: torch.full_like(dt, float(x))
    if cfg.fixed_eps_star and cfg.eps_star_value is not None \
            and cfg.eps_star_value == cfg.eps_star_value:
        # fixed-eps* override (hamsoft_eps_model.py:645-667, HSI:71-86)
        vf = f(cfg.eps_star_value)
        min_soft = torch.where(dyn.min_softening > vf, vf, dyn.min_softening)
        alpha_run = f(cfg.alpha if (cfg.alpha or 0) > 0 else 1.0)
        state = state.replace(eps=vf, s=vf, step_s2=vf * vf,
                              pi=torch.zeros_like(vf))
    else:
        # eps-model calibration (hamsoft_eps_model.py:645-729)
        alpha_run, min_soft, eps_new = \
            epsmod.calibrate_from_initial_conditions(
                state.pos, state.mass, eps0=state.eps,
                eps_min0=dyn.min_softening, eps_max=dyn.max_softening,
                alpha_cfg=f(cfg.alpha or -1.0), eta=cfg.eta, mask=state.mask)
        state = state.replace(eps=eps_new, s=eps_new,
                              step_s2=eps_new * eps_new)
    dyn = dyn.replace(alpha_run=alpha_run, min_softening=min_soft)

    # k_soft (cfg value, autoset when <= 0; HSI:110-118)
    eps_min_eff = torch.where(
        torch.isfinite(dyn.min_softening) & (dyn.min_softening > 0.0),
        dyn.min_softening, torch.clamp_min(dyn.s0 * 0.1, 1e-12))
    k_soft = calib.autoset_k_soft(f(cfg.k_soft), dyn.G, state.mass,
                                  eps_min_eff, mask=state.mask)
    dyn = dyn.replace(k_soft=k_soft)

    mu, omega = calib.calibrate_mu_from_timescales(
        state.pos, state.mass, dyn.G, state.eps, dyn.k_soft, mask=state.mask)
    dyn = dyn.replace(mu_soft=mu, omega_spr0=omega)

    eps_star = hs.eps_target(state, dyn, cfg)
    h_sub, n_sub, omega = calib.freeze_production_schedule(
        state.pos, state.mass, dyn.G, eps0=state.eps, eps_star=eps_star,
        k_soft=dyn.k_soft, mu_soft=dyn.mu_soft, omega_spr0=dyn.omega_spr0,
        dt_user=dt, theta_cap=f(cfg.theta_cap), chi_pi=f(cfg.chi_pi),
        s0=dyn.s0, eps_min=dyn.min_softening, eps_max=dyn.max_softening,
        k_wall=dyn.k_wall, barrier_n=int(cfg.barrier_exponent),
        include_barrier=hs.policy_is_soft(cfg), mask=state.mask)
    # pi-budget mu raise applied at step time in the facade; here once
    mu2 = calib.calibrate_mu_from_pi_budget(dyn.mu_soft, dyn.k_soft,
                                            torch.abs(dt), f(cfg.theta_imp))
    dyn = dyn.replace(h_sub_ref=h_sub, n_sub=n_sub, omega_spr0=omega,
                      mu_soft=mu2, frozen_dt=torch.abs(dt))
    return state, dyn


def init_system(mass, pos, vel, mask, cfg: SimConfig, *, G, softening,
                min_softening, dt, skip_cm_recenter: bool = False):
    """One system's construction (the JAX package's ``init_system`` /
    ``init_system_jit``, which the facade calls): ``mass``/``mask``
    (N,), ``pos``/``vel`` (N, d) tensors in, a B = 1 batch out, so that
    the batched step functions apply to it unchanged."""
    return build_batch(mass[None], pos[None], vel[None], mask[None], cfg, G,
                       softening, min_softening, dt,
                       skip_cm_recenter=skip_cm_recenter)


def refreeze(states, dyns, cfg: SimConfig, dt):
    """The ham_soft frozen schedule recomputed for a new ``dt`` (a
    float or (B,) tensor): the JAX package's ``refreeze_jit``
    (HSI:862-864)."""
    dt = _per_system(dt, states.pos.shape[0], states.pos)
    f = lambda x: torch.full_like(dt, float(x))
    h_sub, n_sub, omega = calib.freeze_production_schedule(
        states.pos, states.mass, dyns.G, eps0=states.eps,
        eps_star=hs.eps_target(states, dyns, cfg), k_soft=dyns.k_soft,
        mu_soft=dyns.mu_soft, omega_spr0=dyns.omega_spr0, dt_user=dt,
        theta_cap=f(cfg.theta_cap), chi_pi=f(cfg.chi_pi), s0=dyns.s0,
        eps_min=dyns.min_softening, eps_max=dyns.max_softening,
        k_wall=dyns.k_wall, barrier_n=int(cfg.barrier_exponent),
        include_barrier=hs.policy_is_soft(cfg), mask=states.mask)
    return dyns.replace(h_sub_ref=h_sub, n_sub=n_sub, omega_spr0=omega,
                        frozen_dt=torch.abs(dt))


def integrate_batch(states, dyns, cfg, dt, n_steps: int, n_sub_max: int):
    """``n_steps`` macro steps for every system, each with its own
    n_sub <= ``n_sub_max`` substeps; ``dt`` a float or (B,) tensor."""
    return integrate_dynamic(states, dyns, cfg, dt, n_steps, n_sub_max)


def step_batch(states, dyns, cfg, dt, n_sub_max: int):
    """One macro step for every system."""
    return macro_step_dynamic(states, dyns, cfg, dt, n_sub_max)
