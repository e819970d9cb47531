"""Functional flow-map API parity layer.

Counterpart of ``nbodysimproject_tpu/integrators/flows_api.py``: the
reference's ``PhaseState``, ``spring_oscillation`` and
``strang_softening_step`` (minbody/__init__.py:42-46,
hamsoft_flows.py:40-112) and ``extended_hamiltonian``
(hamsoft_energy.py:48), on top of the batched core.  These take and
return host values: each call runs one system in float64 on the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.config import SimConfig
from ..core.state import DYN_FIELDS, DynParams, SimState
from ..ops.barrier import barrier_energy
from ..ops.reflection import reflect_if_needed
from . import hamsoft as hs


@dataclass(frozen=True)
class PhaseState:
    """Frozen extended-phase-space snapshot (hamsoft_flows.py:40-46)."""

    q: Any
    p: Any
    epsilon: float
    pi: float
    m: Any


def _f64(x):
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=torch.float64)


def _to_simstate(state: PhaseState) -> SimState:
    """A one-system float64 batch on the CPU."""
    q, p, m = _f64(state.q)[None], _f64(state.p)[None], _f64(state.m)[None]
    eps = torch.full((1,), float(state.epsilon), dtype=torch.float64)
    one = torch.ones_like(eps)
    return SimState(
        mass=m, pos=q, vel=p / m[..., None], eps=eps,
        pi=torch.full_like(eps, float(state.pi)), s=eps, step_s2=eps * eps,
        softening_energy_delta=torch.zeros_like(eps), hist_count=one,
        hist_sum=eps, hist_sumsq=eps * eps,
        mask=torch.ones(m.shape, dtype=torch.bool))


def _dyn_for(*, G, k_soft, mu_soft, eps_min, eps_max, k_wall):
    f = lambda x: torch.full((1,), float(x), dtype=torch.float64)
    return DynParams(
        G=f(G), s0=f(eps_max / 10.0), min_softening=f(eps_min),
        max_softening=f(eps_max), softening_scale=f(1.0), k_soft=f(k_soft),
        mu_soft=f(mu_soft), chi_eps=f(1.0), k_wall=f(k_wall),
        alpha_run=f(1.0), omega_spr0=f(0.0), h_sub_ref=f(0.0),
        n_sub=torch.ones(1, dtype=torch.int32), frozen_dt=f(0.0))


def _host_dyn(dyn) -> DynParams:
    """A simulation's DynParams on the CPU in float64 (n_sub int32)."""
    return DynParams(**{k: getattr(dyn, k).detach().cpu().to(
        torch.int32 if k == "n_sub" else torch.float64) for k in DYN_FIELDS})


def _phase(out: SimState) -> PhaseState:
    return PhaseState(q=out.pos[0].numpy(), p=out.momenta()[0].numpy(),
                      epsilon=float(out.eps), pi=float(out.pi),
                      m=out.mass[0].numpy())


def spring_oscillation(state: PhaseState, dt: float, k_soft: float, *,
                       mu: float = 1.0, eps_min: float = 0.0,
                       eps_max: float = 1.0, cfg: SimConfig | None = None,
                       G: float = 1.0, integrator=None,
                       eps_star_override=None, grad_override=None,
                       **_ignored) -> PhaseState:
    """Exact spring rotation with the momentum impulse
    (hamsoft_flows.py:427-759); ``dt`` is the sub-flow's time (the
    stepper passes h/2).

    With ``integrator=None`` and no overrides, eps* resolves to the
    current epsilon with a zero gradient, as in the reference
    (hamsoft_flows.py:472-496): the rotation acts on (0, pi) and no
    impulse is applied.  A facade simulation's integrator (or the
    overrides) engages the production eps* model."""
    cfg = cfg or SimConfig()
    st = _to_simstate(state)
    dyn = _dyn_for(G=G, k_soft=k_soft, mu_soft=mu, eps_min=eps_min,
                   eps_max=eps_max, k_wall=cfg.k_wall)

    if integrator is not None and eps_star_override is None:
        sim = getattr(integrator, "sim", None) or getattr(integrator, "_sim",
                                                          None)
        if sim is not None:
            es, gg = hs.eps_star_and_grad(st, _host_dyn(sim._dyn), sim.cfg)
            eps_star_override = float(es)
            grad_override = gg[0].numpy()

    if eps_star_override is None:
        eps_star_override = float(state.epsilon)
    if grad_override is None:
        grad_override = np.zeros_like(np.asarray(state.q, dtype=float))
    return _phase(_spring_half_fixed_star(
        st, dyn, cfg, 2.0 * float(dt), eps_star_override,
        _f64(grad_override)[None]))


def _spring_half_fixed_star(st, dyn, cfg, h, eps_star, grad):
    """spring_half with an explicit (eps*, grad), the override path of
    hamsoft_flows.py:499-511, through the one spring flow
    (``hamsoft.spring_half_cached``).  The raw spring_oscillation never
    reflects (the fold belongs to strang_softening_step and the
    stepper, hamsoft_flows.py:93-104), so a reflection-policy cfg runs
    as no-barrier: that policy applies no soft kicks inside the flow
    either."""
    if not hs.policy_is_soft(cfg) and not cfg.disable_barrier:
        cfg = dataclasses.replace(cfg, disable_barrier=True)
    es = torch.full((1,), float(eps_star), dtype=torch.float64)
    h = torch.full((1,), float(h), dtype=torch.float64)
    out, _cache = hs.spring_half_cached(st, dyn, cfg, h, es_grad=(es, grad))
    return out


def strang_softening_step(state: PhaseState, dt: float, *, k_soft: float,
                          eps_min: float, eps_max: float,
                          k_wall: float = 1.0e9, n_exp: int | None = None,
                          mu: float = 1.0, cfg: SimConfig | None = None,
                          **_ignored) -> PhaseState:
    """One S-flow and the reflection fold (hamsoft_flows.py:48-112)."""
    out = spring_oscillation(state, dt, k_soft, mu=mu, eps_min=eps_min,
                             eps_max=eps_max, cfg=cfg)
    cfg = cfg or SimConfig()
    if not hs.policy_is_soft(cfg) and not cfg.disable_barrier:
        e, p = reflect_if_needed(*(torch.tensor(float(x), dtype=torch.float64)
                                   for x in (out.epsilon, out.pi, eps_min,
                                             eps_max)))
        out = PhaseState(q=out.q, p=out.p, epsilon=float(e), pi=float(p),
                         m=out.m)
    return out


def extended_hamiltonian(state: PhaseState, *, G: float, k_soft: float,
                         mu_soft: float, eps_star: float, eps_min: float,
                         eps_max: float, k_wall: float = 1.0e9,
                         n_exp: int = 5, integrator=None,
                         barrier_enabled: bool = True) -> float:
    """H_ext = T + U_plummer + S_bar + k/2 (eps - eps*)^2 + pi^2/(2 mu)
    (hamsoft_energy.py:48-162), in numpy."""
    q = np.asarray(state.q, dtype=float)
    p = np.asarray(state.p, dtype=float)
    m = np.asarray(state.m, dtype=float)
    eps = float(state.epsilon)
    pi = float(state.pi)

    a, b = min(eps_min, eps_max), max(eps_min, eps_max)
    if not np.isfinite(eps_star):
        eps_star = eps
    eps_star = min(max(eps_star, a), b)

    T = 0.5 * float(np.sum(np.sum(p * p, axis=1) / m))
    n = q.shape[0]
    U = 0.0
    if n >= 2 and G != 0.0:
        diff = q[:, None, :] - q[None, :, :]
        r2 = np.sum(diff * diff, axis=-1) + eps * eps
        iu = np.triu_indices(n, 1)
        U = -G * float(np.sum(m[iu[0]] * m[iu[1]] / np.sqrt(r2[iu])))

    if mu_soft == 0.0 or not np.isfinite(mu_soft):
        return 1e300
    d = eps - eps_star
    Hs = 0.5 * k_soft * d * d
    Ke = 0.5 * pi * pi / mu_soft

    # the wall term enters only under an explicit soft-policy integrator
    # (hamsoft_energy.py:131-152: with integrator=None the policy stays
    # "reflection" and U_bar is zero)
    pol_soft = integrator is not None and getattr(
        integrator, "barrier_policy", "reflection") == "soft"
    U_bar = 0.0
    if barrier_enabled and pol_soft and k_wall > 0.0 and n_exp >= 2:
        t = lambda x: torch.tensor(float(x), dtype=torch.float64)
        U_bar = float(barrier_energy(t(eps), t(a), t(b), k_wall=k_wall,
                                     n=n_exp))
    return T + U + U_bar + Hs + Ke
