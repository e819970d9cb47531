"""Static dynamical features for ML, batched.

Counterpart of ``nbodysimproject_tpu/diagnostics/features.py`` (parity:
``minbody/dynamical_features.py:27-155``): the same 25 features with the
same names, computed with masked reductions over a leading system axis.
"""

from __future__ import annotations

import torch

from ..ops.geometry import pair_diff, pair_mask, triu_pairs
from . import energy as E


def _masked_mean(x, m):
    cnt = torch.clamp_min(m.sum(-1), 1.0)
    return torch.where(m > 0, x, torch.zeros_like(x)).sum(-1) / cnt


def _masked_var(x, m):
    mu = _masked_mean(x, m)
    return _masked_mean((x - mu[..., None]) ** 2, m)


def extract_all(state, dyn, cfg) -> dict:
    m, q, v, mask = state.mass, state.pos, state.vel, state.mask
    msk = mask.to(m.dtype)
    n = q.shape[-2]
    zero_m = torch.zeros_like(m)

    # --- mass features (:37-48) -------------------------------------
    big = torch.finfo(m.dtype).max
    m_min = torch.where(mask, m, torch.full_like(m, big)).amin(-1)
    m_max = torch.where(mask, m, zero_m).amax(-1)
    total_mass = torch.where(mask, m, zero_m).sum(-1)
    mass_ratio_max = torch.where(
        m_min > 0.0, m_max / torch.clamp_min(m_min, 1e-300),
        torch.ones_like(m_min))
    com_pos, _com_vel = E.center_of_mass(state)
    feats = {
        "total_mass": total_mass,
        "mass_variance": _masked_var(m, msk),
        "mass_ratio_max": mass_ratio_max,
        "mass_center_offset": torch.sqrt((com_pos * com_pos).sum(-1)),
    }

    # --- distance features (:50-79) ----------------------------------
    iu, ju = triu_pairs(n, q.device)
    diff = pair_diff(q)
    rv = torch.sqrt((diff * diff).sum(-1))[..., iu, ju]
    pv = pair_mask(n, mask)[..., iu, ju].to(m.dtype)
    npairs = torch.clamp_min(pv.sum(-1), 1.0)
    mean_d = (rv * pv).sum(-1) / npairs
    var_d = (((rv - mean_d[..., None]) ** 2) * pv).sum(-1) / npairs
    min_d = torch.where(pv > 0, rv, torch.full_like(rv, big)).amin(-1)
    max_d = torch.where(pv > 0, rv, torch.zeros_like(rv)).amax(-1)
    has_pairs = pv.sum(-1) > 0
    zero = torch.zeros_like(mean_d)
    min_d = torch.where(has_pairs, min_d, zero)
    feats.update({
        "mean_separation": torch.where(has_pairs, mean_d, zero),
        "std_separation": torch.where(has_pairs, torch.sqrt(var_d), zero),
        "min_separation": min_d,
        "max_separation": max_d,
        "separation_ratio": torch.where(
            min_d > 0, max_d / torch.clamp_min(min_d, 1e-300),
            torch.ones_like(min_d)),
    })

    # --- velocity features (:81-105) ----------------------------------
    speeds = torch.sqrt((v * v).sum(-1))
    dvel = pair_diff(v)
    dv = torch.sqrt((dvel * dvel).sum(-1))[..., iu, ju]
    mean_rel = (dv * pv).sum(-1) / npairs
    feats.update({
        "mean_speed": _masked_mean(speeds, msk),
        "std_speed": torch.sqrt(_masked_var(speeds, msk)),
        "max_speed": torch.where(mask, speeds, torch.zeros_like(speeds))
        .amax(-1),
        "mean_relative_velocity": torch.where(has_pairs, mean_rel, zero),
        "max_relative_velocity": torch.where(pv > 0, dv, torch.zeros_like(dv))
        .amax(-1),
    })

    # --- energy features (:107-122) ------------------------------------
    KE = E.kinetic_energy(state)
    PE = E.potential_energy(state, dyn)
    E_tot = KE + PE
    feats.update({
        "kinetic_energy": KE,
        "potential_energy": PE,
        "total_energy": E_tot,
        "virial_ratio": torch.where(PE != 0.0, 2.0 * KE / torch.abs(PE),
                                    torch.zeros_like(PE)),
        "energy_per_mass": E_tot / torch.clamp_min(total_mass, 1e-300),
        "is_bound": (E_tot < 0).to(m.dtype),
    })

    # --- angular features (:124-137) -----------------------------------
    L_tot = E.angular_momentum_z(state)
    li_spec = torch.abs(q[..., 0] * v[..., 1] - q[..., 1] * v[..., 0])
    feats.update({
        "total_angular_momentum": torch.abs(L_tot),
        "mean_specific_angular_momentum": _masked_mean(li_spec, msk),
        "angular_momentum_variance": _masked_var(li_spec, msk),
    })

    # --- softening features (:143-155) via running history moments -----
    cnt = torch.clamp_min(state.hist_count, 1.0)
    smean = state.hist_sum / cnt
    svar = torch.clamp_min(state.hist_sumsq / cnt - smean * smean, 0.0)
    feats.update({
        "softening_mean": smean,
        "softening_std": torch.sqrt(svar),
    })
    return feats


FEATURE_NAMES = [
    "total_mass", "mass_variance", "mass_ratio_max", "mass_center_offset",
    "mean_separation", "std_separation", "min_separation", "max_separation",
    "separation_ratio",
    "mean_speed", "std_speed", "max_speed", "mean_relative_velocity",
    "max_relative_velocity",
    "kinetic_energy", "potential_energy", "total_energy", "virial_ratio",
    "energy_per_mass", "is_bound",
    "total_angular_momentum", "mean_specific_angular_momentum",
    "angular_momentum_variance",
    "softening_mean", "softening_std",
]


class DynamicalFeatures:
    """The facade's view (dynamical_features.py:22): the 25 features of
    one simulation as floats."""

    def __init__(self, sim):
        self.sim = sim

    def extract_all(self) -> dict:
        d = extract_all(self.sim._state, self.sim._dyn, self.sim.cfg)
        return {k: float(v) for k, v in d.items()}
