"""Energy and angular-momentum diagnostics, batched.

Counterpart of ``nbodysimproject_tpu/diagnostics/energy.py`` (parity:
``minbody/diagnostics.py``, ``minbody/hamsoft_energy.py``): every
function takes a batched ``SimState`` and returns one value per system.
The reference's float128 Kahan sums become Kahan sums in the working
dtype.
"""

from __future__ import annotations

import torch

from ..integrators import hamsoft as hs
from ..integrators.kepler_split import split_hamiltonian
from ..ops.barrier import barrier_energy
from ..ops.geometry import pair_diff, pair_mask, triu_pairs
from ..utils.summation import kahan_sum


def kinetic_energy(state):
    """T = 1/2 sum m |v|^2 (diagnostics.py:63-67)."""
    t = state.mass * (state.vel * state.vel).sum(-1)
    t = torch.where(state.mask, t, torch.zeros_like(t))
    return 0.5 * t.sum(-1)


def _pair_potential(state, G, eps):
    n = state.pos.shape[-2]
    diff = pair_diff(state.pos)
    r2 = (diff * diff).sum(-1) + (eps * eps)[..., None, None]
    pm = pair_mask(n, state.mask)
    one = torch.ones_like(r2)
    inv_r = torch.where(pm, 1.0 / torch.sqrt(torch.where(pm, r2, one)),
                        torch.zeros_like(r2))
    mprod = state.mass[..., :, None] * state.mass[..., None, :]
    return -0.5 * G * (mprod * inv_r).sum((-2, -1))


def potential_energy(state, dyn):
    """Classical potential at eps^2 = step_s2 (diagnostics.py:69-78)."""
    eps = torch.sqrt(torch.clamp_min(state.step_s2, 0.0))
    return _pair_potential(state, dyn.G, eps)


def spring_terms(state, dyn, eps_star):
    """K_eps = pi^2/(2 mu), S_spring = k/2 (eps - eps*)^2."""
    mu = torch.where(dyn.mu_soft != 0.0, dyn.mu_soft,
                     torch.ones_like(dyn.mu_soft))
    K_eps = 0.5 * state.pi * state.pi / mu
    d = state.eps - eps_star
    return K_eps, 0.5 * dyn.k_soft * d * d


def barrier_term(state, dyn, cfg):
    """S_bar — soft policy only (hamsoft_energy.py:131-160)."""
    if hs.policy_is_soft(cfg) and cfg.k_wall > 0 \
            and cfg.barrier_exponent >= 2:
        return barrier_energy(state.eps, dyn.min_softening,
                              dyn.max_softening, k_wall=dyn.k_wall,
                              n=cfg.barrier_exponent)
    return torch.zeros_like(state.eps)


def energy(state, dyn, cfg):
    """H_ext with the pair potential at eps = state.eps, the
    'physical-facing' extended energy (diagnostics.py:81-155)."""
    T = kinetic_energy(state)
    V = _pair_potential(state, dyn.G, state.eps)
    K_eps, S_spring = spring_terms(state, dyn, hs.eps_target(state, dyn, cfg))
    return T + V + barrier_term(state, dyn, cfg) + K_eps + S_spring


def energy_breakdown(state, dyn, cfg):
    """dict(T, V, K_eps, PE_spring, H) (diagnostics.py:158-235); classical
    modes evaluate V at step_s2, ham_soft at eps^2."""
    T = kinetic_energy(state)
    s2 = state.eps * state.eps if cfg.integrator_mode == "ham_soft" \
        else state.step_s2
    V = _pair_potential(state, dyn.G, torch.sqrt(torch.clamp_min(s2, 0.0)))
    K_eps, S_spring = spring_terms(state, dyn, hs.eps_target(state, dyn, cfg))
    S_spring = torch.where(dyn.k_soft > 0.0, S_spring,
                           torch.zeros_like(S_spring))
    return dict(T=T, V=V, K_eps=K_eps, PE_spring=S_spring,
                H=T + V + K_eps + S_spring)


def extended_hamiltonian(state, dyn, cfg, eps_star=None):
    """H_ext with Kahan-compensated kinetic and pair sums
    (diagnostics.py:457-549).  The kepler_split tail conserves another
    Hamiltonian (point-mass dominant pair, frozen eps and pi), so its
    analysis measures that one (``integrators/kepler_split.py``)."""
    if cfg.integrator_mode == "kepler_split":
        return split_hamiltonian(state, dyn, cfg)
    tk = state.mass * (state.vel * state.vel).sum(-1)
    tk = torch.where(state.mask, tk, torch.zeros_like(tk))
    T = 0.5 * kahan_sum(tk)

    n = state.pos.shape[-2]
    iu, ju = triu_pairs(n, state.pos.device)
    diff = pair_diff(state.pos)
    r2 = (diff * diff).sum(-1) + (state.eps * state.eps)[..., None, None]
    pair_ok = pair_mask(n, state.mask)[..., iu, ju]
    r2u = torch.where(pair_ok, r2[..., iu, ju], torch.ones_like(r2[..., iu, ju]))
    inv_r = torch.where(pair_ok, 1.0 / torch.sqrt(r2u), torch.zeros_like(r2u))
    mprod = state.mass[..., iu] * state.mass[..., ju]
    V = -dyn.G * kahan_sum(mprod * inv_r)

    if eps_star is None:
        eps_star = hs.eps_target(state, dyn, cfg)
    K_eps, S_spring = spring_terms(state, dyn, eps_star)
    S_bar = barrier_term(state, dyn, cfg)
    return T + V + K_eps + S_spring + S_bar


def extended_hamiltonian_of_sim(sim) -> float:
    """The facade's H_ext (Integrator.compute_extended_hamiltonian,
    integrator.py:144-147)."""
    return float(extended_hamiltonian(sim._state, sim._dyn, sim.cfg))


def angular_momentum_z(state):
    """L_z = sum m (x vy - y vx) (diagnostics.py:553-557)."""
    q, v = state.pos, state.vel
    lz = state.mass * (q[..., 0] * v[..., 1] - q[..., 1] * v[..., 0])
    lz = torch.where(state.mask, lz, torch.zeros_like(lz))
    return lz.sum(-1)


def angular_momentum_vector(state):
    """Total angular momentum: (B, 3) for d = 3, L_z as (B, 1) for d = 2."""
    q, v = state.pos, state.vel
    if q.shape[-1] == 2:
        return angular_momentum_z(state)[..., None]
    L_i = state.mass[..., None] * torch.linalg.cross(q, v, dim=-1)
    L_i = torch.where(state.mask[..., None], L_i, torch.zeros_like(L_i))
    return L_i.sum(-2)


def linear_momentum(state):
    """(B, d) total momentum (diagnostics.py:559-565)."""
    p = state.mass[..., None] * state.vel
    return torch.where(state.mask[..., None], p, torch.zeros_like(p)).sum(-2)


def center_of_mass(state):
    """((B, d), (B, d)) COM position and velocity (diagnostics.py:567-583)."""
    m = torch.where(state.mask, state.mass, torch.zeros_like(state.mass))
    M = m.sum(-1)
    Ms = torch.where(M > 0.0, M, torch.ones_like(M))[..., None]
    x = (m[..., None] * state.pos).sum(-2) / Ms
    v = (m[..., None] * state.vel).sum(-2) / Ms
    pos_m = (M > 0.0)[..., None]
    return (torch.where(pos_m, x, torch.zeros_like(x)),
            torch.where(pos_m, v, torch.zeros_like(v)))
