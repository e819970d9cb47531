"""Timestep / spring calibration on batched systems.

Counterpart of ``nbodysimproject_tpu/integrators/calibration.py``: the
classical substep schedule (``init_substep_schedule``,
``classical_n_sub``) and the ham_soft calibration (k_soft autoset, mu
from the timescales and from the pi budget, the frozen production
schedule).  Inputs are per-system
``(B,)`` tensors and ``(B, N[, d])`` bodies; ``n_sub`` is int32.
"""

from __future__ import annotations

import math

import torch

from ..ops.barrier import barrier_force
from ..ops.forces import dV_d_epsilon
from ..ops.geometry import pair_diff, pair_mask

CHI_GRAV = 0.9   # chi in timestep_manager.py:48 / HSI:1052
C_OMEGA = 8.0    # omega_spr = 8 / tau_grav (HSI:283)
C_KSOFT = 8.0    # k_soft autoset coefficient (HSI:117)


def _ok(x):
    return torch.isfinite(x) & (x > 0.0)


def tau_grav_min(q, m, G, eps=0.0, mask=None, *, softened: bool):
    """Minimum two-body gravitational timescale per system.

    softened=True:  min over pairs sqrt((r^2 + eps^2)^{3/2} / (G (m_i + m_j)))
      (HSI:997-1018, :262-276); ``eps`` is a (B,) tensor or a float.
    softened=False: min over pairs sqrt(r^3 / (G (m_i + m_j)))
      (timestep_manager.py:150-165) — the same formula at eps = 0.
    +inf without a valid pair or with G == 0."""
    n = q.shape[-2]
    diff = pair_diff(q)
    r2 = (diff * diff).sum(-1)
    if softened:
        e = torch.as_tensor(eps, dtype=q.dtype, device=q.device)
        if e.dim():
            e = e[..., None, None]
        r2 = r2 + e * e
    pm = pair_mask(n, mask, q.device)
    denom = G[..., None, None] * (m[..., :, None] + m[..., None, :])
    valid = pm & (denom > 0.0) & (r2 > 0.0)
    one = torch.ones_like(r2)
    r2s = torch.where(valid, r2, one)
    r3 = r2s * torch.sqrt(r2s)
    tau = torch.where(valid, torch.sqrt(r3 / torch.where(valid, denom, one)),
                      torch.full_like(r2, math.inf))
    return tau.amin((-2, -1))


def init_substep_schedule(q, m, vel, G, *, eps_cur, pi, k_soft, mu_soft,
                          min_softening, max_softening, eps_star, grad_norm,
                          theta_cap, dt_user, split_n_max: int, mask=None):
    """h_sub_ref from four timescales (timestep_manager.py:139-253):
    h_sub = min(0.9 tau_grav, tau_spr, tau_eps, tau_imp), fallback
    dt_user (or 1.0), then capped so ceil(dt_user/h_sub) <= split_n_max.
    Per-system (B,) inputs; ``theta_cap`` a float or (B,)."""
    dt_user = torch.abs(dt_user)
    inf = torch.full_like(dt_user, math.inf)
    tau_grav = tau_grav_min(q, m, G, mask=mask, softened=False)

    omega = torch.sqrt(torch.clamp_min(k_soft, 0.0)
                       / torch.clamp_min(mu_soft, 1e-300))
    theta_cap = torch.as_tensor(theta_cap, dtype=q.dtype, device=q.device)
    tcap = torch.where(theta_cap > 0.0, theta_cap,
                       torch.full_like(theta_cap, 0.25))
    tau_spr = torch.where((k_soft > 0.0) & (mu_soft > 0.0) & (omega > 0.0),
                          tcap / torch.clamp_min(omega, 1e-300), inf)

    eps_safe = 0.1 * torch.clamp_min(max_softening - min_softening, 0.0)
    v_eps = torch.abs(pi / torch.where(mu_soft != 0.0, mu_soft,
                                       torch.ones_like(mu_soft)))
    tau_eps = torch.where((pi != 0.0) & (mu_soft != 0.0) & (eps_safe > 0.0),
                          CHI_GRAV * eps_safe / torch.clamp_min(v_eps, 1e-300),
                          inf)

    theta_imp = 0.1  # hard-coded in timestep_manager.py:199
    eps_p = 1e-12
    p = m[..., None] * vel
    pn = torch.sqrt((p * p).sum(-1))
    if mask is not None:
        pn = torch.where(mask, pn, torch.zeros_like(pn))
    p_max = pn.amax(-1) if pn.shape[-1] else torch.zeros_like(dt_user)
    p_max = torch.where(torch.isfinite(p_max), p_max, torch.zeros_like(p_max))
    delta = torch.abs(eps_cur - eps_star)
    den = k_soft * delta * grad_norm
    tau_imp = torch.where((k_soft > 0.0) & (grad_norm > 0.0) & (delta > 0.0)
                          & (den > 0.0) & torch.isfinite(den),
                          (2.0 * theta_imp * (p_max + eps_p))
                          / torch.clamp_min(den, 1e-300), inf)

    h_sub = torch.minimum(torch.minimum(CHI_GRAV * tau_grav, tau_spr),
                          torch.minimum(tau_eps, tau_imp))
    fallback = torch.where(dt_user > 0.0, dt_user, torch.ones_like(dt_user))
    h_sub = torch.where(_ok(h_sub), h_sub, fallback)

    if split_n_max > 0:
        n_need = torch.ceil(dt_user / torch.clamp_min(h_sub, 1e-30))
        h_sub = torch.where(n_need > split_n_max, dt_user / split_n_max,
                            h_sub)
    return h_sub


def classical_n_sub(dt, h_sub_ref, split_n_max: int):
    """n_sub = clamp(ceil(|dt|/h_sub_ref), 1, split_n_max), int32
    (integrator.py:91)."""
    n = torch.ceil(torch.abs(dt) / torch.clamp_min(h_sub_ref, 1e-300))
    return torch.clamp(n.to(torch.int32), 1, split_n_max)


def autoset_k_soft(k_cfg, G, m, eps_min, mask=None):
    """k_soft = 8 G M_tot^2 / eps_min^3 when the configured value is
    non-positive (HSI:110-118)."""
    mm = m if mask is None else m * mask.to(m.dtype)
    M_tot = mm.sum(-1)
    e = torch.clamp_min(eps_min, 1e-12)
    auto = C_KSOFT * G * M_tot * M_tot / (e * e * e)
    return torch.where(k_cfg > 0.0, k_cfg, auto)


def calibrate_mu_from_timescales(q, m, G, eps0, k_soft, mask=None):
    """mu from omega_spr = 8 / tau_grav (HSI:251-296).  Returns
    (mu_soft, omega_spr0)."""
    tau = tau_grav_min(q, m, G, eps=eps0, mask=mask, softened=True)
    tau = torch.where(_ok(tau), tau, torch.ones_like(tau))
    omega_spr = C_OMEGA / tau
    one = torch.ones_like(tau)
    mu = torch.where((omega_spr > 0.0) & (k_soft > 0.0),
                     k_soft / (omega_spr * omega_spr), one)
    mu = torch.where(_ok(mu), mu, one)
    return mu, omega_spr


def calibrate_mu_from_pi_budget(mu_cur, k_soft, dt, theta_imp):
    """Raise mu to at least k (dt/theta_imp)^2 (HSI:145-246).  ``dt``
    and ``theta_imp`` are floats or tensors broadcastable to mu."""
    like = mu_cur
    ti = torch.as_tensor(theta_imp, dtype=like.dtype, device=like.device)
    ti = torch.where((ti > 0.0) & torch.isfinite(ti), ti,
                     torch.full_like(ti, 0.5))
    dt = torch.as_tensor(dt, dtype=like.dtype, device=like.device)
    mu_macro = k_soft * (torch.abs(dt) / ti) ** 2
    mu = torch.where(_ok(mu_cur), mu_cur, torch.ones_like(mu_cur))
    ok = torch.isfinite(k_soft) & (k_soft > 0.0)
    return torch.where(ok & (mu < mu_macro), mu_macro, mu)


def estimate_pi_budget_h(q, m, G, *, eps, eps_star, k_soft, s0, chi_pi,
                         dt_abs, eps_min, eps_max, k_wall, barrier_n: int,
                         include_barrier: bool, mask=None):
    """h_pi = 2 chi_pi sqrt(k) max(|eps-eps*|, 1e-4 s0) / |dV/deps + dB/deps|
    (HSI:1125-1221)."""
    chi = torch.where((chi_pi > 0.0) & torch.isfinite(chi_pi), chi_pi,
                      torch.full_like(chi_pi, 0.2))
    s0_eff = torch.where(_ok(s0), s0, torch.ones_like(s0))
    delta_eff = torch.maximum(torch.abs(eps - eps_star), 1e-4 * s0_eff)
    dV = dV_d_epsilon(q, m, eps, G, mask=mask)
    if include_barrier and barrier_n >= 2:
        dB = -barrier_force(eps, eps_min, eps_max, k_wall=k_wall, n=barrier_n)
    else:
        dB = torch.zeros_like(dV)
    deps_eff = torch.clamp_min(torch.abs(dV + dB), 1e-16)
    sqrtk = torch.sqrt(torch.clamp_min(k_soft, 0.0))
    h_pi = 2.0 * chi * sqrtk * delta_eff / deps_eff
    h_pi = torch.where(torch.isfinite(h_pi) & (h_pi >= 0.0), h_pi, dt_abs)
    return torch.where(k_soft > 0.0, h_pi, dt_abs)


def freeze_production_schedule(q, m, G, *, eps0, eps_star, k_soft, mu_soft,
                               omega_spr0, dt_user, theta_cap, chi_pi, s0,
                               eps_min, eps_max, k_wall, barrier_n: int,
                               include_barrier: bool, mask=None):
    """The ham_soft frozen schedule (HSI:986-1119):
    h_sub = min(0.9 tau_grav, theta_cap/omega_spr, h_pi);
    n_sub = ceil(dt/h_sub); h_sub_ref = dt/n_sub.
    Returns (h_sub_ref, n_sub int32, omega_spr)."""
    dt_abs = torch.abs(dt_user)
    dt_abs = torch.where(_ok(dt_abs), dt_abs, torch.full_like(dt_abs, 1e-2))

    tau_grav = tau_grav_min(q, m, G, eps=eps0, mask=mask, softened=True)
    tau_grav = torch.where(_ok(tau_grav), tau_grav, dt_abs)

    omega_spr = torch.where(_ok(omega_spr0), omega_spr0, C_OMEGA / tau_grav)

    tcap = torch.where(_ok(theta_cap), theta_cap,
                       torch.full_like(theta_cap, 0.1))
    h_theta_grav = CHI_GRAV * tau_grav
    h_theta_osc = torch.where(omega_spr > 0.0,
                              tcap / torch.clamp_min(omega_spr, 1e-300),
                              torch.full_like(omega_spr, math.inf))
    h_theta = torch.where(_ok(h_theta_osc),
                          torch.minimum(h_theta_grav, h_theta_osc),
                          h_theta_grav)

    h_pi = estimate_pi_budget_h(
        q, m, G, eps=eps0, eps_star=eps_star, k_soft=k_soft, s0=s0,
        chi_pi=chi_pi, dt_abs=dt_abs, eps_min=eps_min, eps_max=eps_max,
        k_wall=k_wall, barrier_n=barrier_n, include_barrier=include_barrier,
        mask=mask)
    h_pi = torch.where(_ok(h_pi), h_pi, dt_abs)

    h_sub = torch.minimum(h_theta, h_pi)
    h_sub = torch.where(_ok(h_sub), h_sub, dt_abs)

    n_sub = torch.clamp_min(torch.ceil(dt_abs / h_sub).to(torch.int32), 1)
    h_sub_ref = dt_abs / n_sub.to(dt_abs.dtype)
    return h_sub_ref, n_sub, omega_spr
