"""Name-parity views of the reference's internal component classes.

Counterpart of ``nbodysimproject_tpu/facade/compat.py``: each class the
component inventory names is a thin view over the facade's state, so
that reference-style introspection keeps working.

  SimulationState      -> core.state.SimState (+ build helpers)
  IntegratorConstants  -> static mirror of SimConfig defaults
  TimestepManager      -> integrators.calibration schedules
  HamSoftParams        -> DynParams fields (k_soft/mu/chi/k_wall)
  HamSoftBarrier       -> ops.reflection folds
  HamSoftStepper       -> integrators.hamsoft flows
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import SimConfig
from ..core.state import build_state
from ..integrators import calibration as calib
from ..integrators import hamsoft as hs
from ..ops.reflection import reflect_if_needed, symplectic_reflect_eps


class SimulationState:
    """Builder/snapshot view (simulation_state.py:27-292): the arrays
    live in the ``SimState``; this class names its construction and
    restore entry points."""

    @staticmethod
    def build_state(bodies=None, masses=None, positions=None,
                    velocities=None, *, eps=0.0, dtype=torch.float64,
                    device=None):
        if bodies is not None:
            masses = [b.mass for b in bodies]
            positions = [[b.x, b.y] for b in bodies]
            velocities = [[b.vx, b.vy] for b in bodies]
        return build_state(masses, positions, velocities, eps=eps,
                           dtype=dtype, device=device)

    @staticmethod
    def restore_to_sim(snapshot: dict, sim) -> None:
        """Reapply the evolving scalars of a snapshot dict to a facade
        simulation (simulation_state.py:231-280)."""
        flags = snapshot.get("sim_state", {})
        if "_epsilon" in flags:
            sim._epsilon = float(flags["_epsilon"])
        if "_pi" in flags:
            sim._pi = float(flags["_pi"])


class _ConstantsMeta(type):
    def __getattr__(cls, name):
        # unknown attributes read as 0.0 (integrator_constants.py:22-24)
        return 0.0


class IntegratorConstants(metaclass=_ConstantsMeta):
    """Static mirror of the default SimConfig (integrator_constants.py:27)."""

    _cfg = SimConfig()
    safety_factor = _cfg.safety_factor
    theta_cap = _cfg.theta_cap
    k_soft = _cfg.k_soft
    split_n_max = _cfg.split_n_max
    initial_dt = _cfg.initial_dt
    corrector_order = _cfg.corrector_order
    barrier_exponent = _cfg.barrier_exponent
    k_wall = _cfg.k_wall
    CHI_EPS = 0.9
    LAMBDA_SOFTENING = 0.3


class TimestepManager:
    """Schedule view (timestep_manager.py:25) over the schedule functions
    of ``integrators/calibration.py``."""

    def __init__(self, integrator):
        self.integ = integrator
        self.h_sub_ref = float(getattr(integrator, "h_sub_ref", 0.0))

    def get_cached_min_sep(self) -> float:
        return self.integ.sim._get_min_separation()

    def determine_substeps(self, dt_abs: float) -> int:
        return self.integ.sim._n_sub_for(abs(float(dt_abs)))

    def init_substep_schedule(self, dt_user: float) -> None:
        sim = self.integ.sim
        st, dyn, cfg = sim._state, sim._dyn, sim.cfg
        eps_star = sim._as_dtype(
            sim._classical_eps_target() if cfg.integrator_mode != "ham_soft"
            else float(hs.eps_target(st, dyn, cfg)))
        h = calib.init_substep_schedule(
            st.pos, st.mass, st.vel, dyn.G, eps_cur=st.eps, pi=st.pi,
            k_soft=dyn.k_soft, mu_soft=dyn.mu_soft,
            min_softening=dyn.min_softening, max_softening=dyn.max_softening,
            eps_star=eps_star, grad_norm=torch.zeros_like(eps_star),
            theta_cap=float(cfg.theta_cap), dt_user=sim._as_dtype(dt_user),
            split_n_max=int(cfg.split_n_max), mask=st.mask)
        self.h_sub_ref = float(h)

    def predict_min_separation(self, dt: float) -> float:
        """Closest-approach estimate over the step
        (timestep_manager.py:294-316)."""
        sim = self.integ.sim
        pos, vel = sim._pos, sim._vel
        if len(pos) < 2:
            return float("inf")
        r0 = pos[:, None, :] - pos[None, :, :]
        dv = vel[:, None, :] - vel[None, :, :]
        dt = abs(float(dt))
        d_now = np.linalg.norm(r0, axis=-1)
        d_dt = np.linalg.norm(r0 + dv * dt, axis=-1)
        vv = np.sum(dv * dv, axis=-1) + 1e-30
        t_star = -np.sum(r0 * dv, axis=-1) / vv
        in_window = (t_star > 0.0) & (t_star < dt)
        r_star = np.linalg.norm(r0 + dv * t_star[..., None], axis=-1)
        d_min = np.where(in_window,
                         np.minimum(np.minimum(d_now, d_dt), r_star),
                         np.minimum(d_now, d_dt))
        np.fill_diagonal(d_min, np.inf)
        return float(max(d_min.min(), 1e-12))


class HamSoftParams:
    """Parameter view (hamsoft_params.py:22)."""

    def __init__(self, integ, **_kw):
        self._integ = integ

    def _dyn_float(name):
        return property(lambda self: float(getattr(self._integ._sim._dyn,
                                                   name)))

    k_soft = _dyn_float("k_soft")
    mu_soft = _dyn_float("mu_soft")
    chi_eps = _dyn_float("chi_eps")
    k_wall = _dyn_float("k_wall")
    del _dyn_float

    @property
    def barrier_exponent(self):
        return int(self._integ._sim.cfg.barrier_exponent)


def _owner_sim(owner):
    return owner.sim if hasattr(owner, "sim") else owner


class HamSoftBarrier:
    """Reflection-policy boundary handler view
    (hamsoft_barrier_controller.py:21), on host floats."""

    def __init__(self, owner):
        self._owner = owner

    def _bounds(self):
        sim = _owner_sim(self._owner)
        return float(sim._min_softening), float(sim._max_softening)

    def _inactive(self):
        cfg = _owner_sim(self._owner).cfg
        return hs.policy_is_soft(cfg) or cfg.disable_barrier

    def reflect_and_bounce(self, eps, pi, h):
        if self._inactive():
            return float(eps), float(pi)
        sim = _owner_sim(self._owner)
        mu = float(sim._dyn.mu_soft) or 1.0
        e, p = symplectic_reflect_eps(float(eps), float(pi), *self._bounds(),
                                      float(h), mu)
        return float(e), float(p)

    def reflect_if_active(self, eps, pi):
        if self._inactive():
            return float(eps), float(pi)
        t = lambda x: torch.tensor(float(x), dtype=torch.float64)
        e, p = reflect_if_needed(t(eps), t(pi), *map(t, self._bounds()))
        return float(e), float(p)


class HamSoftStepper:
    """Strang sub-flow view (hamsoft_stepper.py:29): runs the functional
    flows on the owning simulation's state."""

    def __init__(self, owner):
        self.integ = owner

    def _sim(self):
        return _owner_sim(self.integ)

    def _apply(self, fn, h):
        sim = self._sim()
        sim._state = fn(sim._state, sim._dyn, sim.cfg, sim._as_dtype(h))

    def s_half(self, h):
        self._apply(hs.spring_half, h)

    def v_half_kick(self, h, eps_override=None):
        self._apply(hs.v_half_kick, h)

    def t_drift(self, h):
        self._apply(hs.t_drift, h)

    def strang_step(self, h):
        self._apply(hs.strang_substep, h)

    def _get_j_max_cap(self) -> float:
        v = getattr(self._sim().cfg, "j_max_cap", 0.02)
        return float(v) if math.isfinite(v) and v > 0 else 0.02
