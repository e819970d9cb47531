"""Classical integrators: velocity-Verlet and Yoshida4 substeps, batched.

Counterpart of ``nbodysimproject_tpu/integrators/classical.py`` (parity:
integration_scheme_base.py:129-149, yoshida4_scheme.py:18-25, and the
classical adaptive-softening refresh of integrator.py:126-134 +
softening_manager.py:100-103, :424-471, :541-547) on ``(B, N, d)``
states.  Each substep is ``(state, dyn, cfg, h) -> state`` with ``h`` a
(B,) tensor; the acceleration uses eps_eff = sqrt(step_s2)
(simulation.py:558-581).  These are the scan path's plain tensor
operations (the JAX package leaves them to XLA); the fused kernel of the
same schemes is ``ops/batch_kernels.py``.
"""

from __future__ import annotations

import torch

from ..ops.barrier import barrier_energy
from ..ops.forces import force_auto
from ..ops.geometry import min_separation, pair_diff, pair_mask

CBRT2 = 2.0 ** (1.0 / 3.0)
_W1 = 1.0 / (2.0 - CBRT2)
_W2 = -CBRT2 / (2.0 - CBRT2)


def _force(state, dyn, cfg, eps):
    """Force dispatch (``ops/forces.py::force_auto``): the dense pairwise
    force for few-body systems, the tiled large-N kernel for unpadded
    systems when ``cfg.use_pallas_forces`` (shared with the WHFast
    interaction kick)."""
    return force_auto(state.pos, state.mass, eps, dyn.G, state.mask, cfg)


def _div_mass(F, state):
    m_safe = torch.where(state.mask, state.mass, torch.ones_like(state.mass))
    return F / m_safe[..., None]


def classical_accel(state, dyn, cfg):
    """a_i = F_i / m_i with eps_eff = sqrt(max(step_s2, 0))
    (simulation.py:558-581)."""
    eps_eff = torch.sqrt(torch.clamp_min(state.step_s2, 0.0))
    return _div_mass(_force(state, dyn, cfg, eps_eff), state)


def hamsoft_accel(state, dyn, cfg):
    """a_i with eps = state.eps, the ham_soft force softening
    (simulation.py:549-556)."""
    return _div_mass(_force(state, dyn, cfg, state.eps), state)


def verlet_kernel(state, dyn, cfg, h):
    """One velocity-Verlet kick-drift-kick
    (integration_scheme_base.py:129-149)."""
    h3 = h[..., None, None]
    acc = classical_accel(state, dyn, cfg)
    vel = state.vel + 0.5 * h3 * acc
    pos = state.pos + h3 * vel
    state = state.replace(pos=pos, vel=vel)
    acc2 = classical_accel(state, dyn, cfg)
    return state.replace(vel=state.vel + 0.5 * h3 * acc2)


def yoshida4_kernel(state, dyn, cfg, h):
    """Triple-jump composition w1, w2, w1 (yoshida4_scheme.py:18-25)."""
    state = verlet_kernel(state, dyn, cfg, _W1 * h)
    state = verlet_kernel(state, dyn, cfg, _W2 * h)
    return verlet_kernel(state, dyn, cfg, _W1 * h)


# --------------------------------------------------------------------------
# classical adaptive softening (adaptive-classic policy)
# --------------------------------------------------------------------------

def softening_from_min_sep(state, dyn):
    """Proposal clamp(max(min_soft, min_sep/softening_scale), <= 10 s0),
    limited to a factor 2 per refresh (softening_manager.py:541-547,
    :100-103)."""
    min_sep = min_separation(state.pos, state.mask)
    proposed = torch.maximum(dyn.min_softening,
                             min_sep / dyn.softening_scale)
    proposed = torch.minimum(proposed, 10.0 * dyn.s0)
    limited = torch.maximum(state.s / 2.0,
                            torch.minimum(state.s * 2.0, proposed))
    ok = torch.isfinite(min_sep) & (min_sep > 0.0)
    return torch.where(ok, limited, state.s)


def _energy_correction(state, dyn, cfg, s_old, s_new):
    """SofteningManager._compute_energy_correction
    (softening_manager.py:424-471): the gravitational pair-inverse delta
    (sign per reference), no spring term (classical k_soft = 0,
    integrator.py:33), the barrier delta."""
    n = state.pos.shape[-2]
    diff = pair_diff(state.pos)
    r2 = (diff * diff).sum(-1)
    pm = pair_mask(n, state.mask)
    one, zero = torch.ones_like(r2), torch.zeros_like(r2)

    def inv(s):
        s2 = (s * s)[..., None, None]
        return torch.where(pm, 1.0 / torch.sqrt(torch.where(pm, r2 + s2, one)),
                           zero)

    mprod = state.mass[..., :, None] * state.mass[..., None, :]
    dE_grav = dyn.G * 0.5 * (mprod * (inv(s_new) - inv(s_old))).sum((-2, -1))
    kw, n_exp = cfg.k_wall, cfg.barrier_exponent
    dE_bar = (barrier_energy(s_new, dyn.min_softening, dyn.max_softening,
                             k_wall=kw, n=n_exp)
              - barrier_energy(s_old, dyn.min_softening, dyn.max_softening,
                               k_wall=kw, n=n_exp))
    return dE_grav + dE_bar


def adaptive_softening_refresh(state, dyn, cfg):
    """refresh_softening with energy bookkeeping
    (integrator.py:126-134, softening_manager.py:298-336)."""
    s_new = softening_from_min_sep(state, dyn)
    dE = _energy_correction(state, dyn, cfg, state.s, s_new)
    dE = torch.where(torch.isfinite(dE), dE, torch.zeros_like(dE))
    return state.replace(s=s_new, step_s2=s_new * s_new,
                         softening_energy_delta=state.softening_energy_delta
                         + dE)


def apply_corrector(state, dyn, cfg, h_ref):
    """Start-up corrector: one half-kick of ``h_ref`` (B,)
    (integration_scheme_base.py:154-192; the order-dependent force
    refreshes there change no state)."""
    acc = classical_accel(state, dyn, cfg)
    return state.replace(vel=state.vel + 0.5 * h_ref[..., None, None] * acc)
