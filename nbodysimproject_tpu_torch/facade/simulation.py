"""NBodySimulation, the user-facing facade, and its component shims.

Counterpart of ``nbodysimproject_tpu/facade/simulation.py`` (API
parity: ``minbody/simulation.py:37``: constructor, properties,
step/run/snapshot/restore, Jacobi transforms, accelerations,
set_integrator_mode, softening bounds, copy, min separation).

A thin host-side shell over the batched functional core: the state is a
one-system batch (``SimState`` / ``DynParams`` with B = 1, on
``device``) and a static ``SimConfig``, so that every batched step
function and the eps kernel's dispatch (``integrators/hamsoft.py::
uses_eps_kernel``) apply to it unchanged.  Construction-time
calibration (mode demotions, softening defaults, the ham_soft cascade)
happens here with concrete values, as simulation.py:39-162 and
hamiltonian_softening_integrator.py:47-141 do.

The dtype rule is the JAX package's: float32 only under
``cfg.fast_float32``.  So the default float64 facade runs no kernel on
the card, and a fast-mode ham_soft facade there takes the eps kernel on
every substep.  The large-N branch (``cfg.force_mode`` other than
"direct" under verlet) is a thin call of ``integrators/largen.py::
largen_rollout``, which takes the tiled force kernel on
"direct_pallas".  Each host accessor (``pos``, ``softening``, the
per-step ``softening_energy_delta`` read, the ham_soft schedule check)
is a device-to-host read, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..core.config import SimConfig
from ..core.device import resolve_device
from ..core.state import DynParams, build_state
from ..integrators import calibration as calib
from ..integrators import hamsoft as hs
from ..integrators import step as step_mod
from ..integrators.classical import (apply_corrector, classical_accel,
                                     hamsoft_accel)
from ..integrators.whfast import from_jacobi as _from_jac
from ..integrators.whfast import to_jacobi as _to_jac
from ..integrators.whfast import whfast_corrector
from ..ops.geometry import min_separation
from .body import BodyView

#: the integrator modes a user may select (core/config.py of the JAX
#: package)
_ALLOWED_MODES = {"verlet", "yoshida4", "whfast", "ham_soft"}


def _host(t) -> np.ndarray:
    """A host copy of a tensor (never a view of the state)."""
    return np.array(t.detach().cpu().numpy())


class NBodySimulation:
    def __init__(
        self,
        config: Optional[SimConfig] = None,
        bodies=None,
        masses=None,
        positions=None,
        velocities=None,
        G: float = 1.0,
        softening: float = 1e-3,
        min_softening: float = 0.0,
        adaptive: bool = False,
        adaptive_timestep: Optional[bool] = None,
        adaptive_softening: Optional[bool] = None,
        skip_init_corrector: bool = False,
        skip_cm_recenter: bool = False,
        integrator_mode: Optional[str] = None,
        device=None,
    ):
        self.cfg = config.copy() if config else SimConfig()
        self._dev = resolve_device(device)

        # --- adaptivity flags (simulation.py:62-74) ---------------------
        if adaptive_timestep is not None:
            self._adaptive_timestep = bool(adaptive_timestep)
        elif adaptive is not None:
            self._adaptive_timestep = bool(adaptive)
        else:
            self._adaptive_timestep = bool(self.cfg.adaptive_timestep)
        if adaptive_softening is not None:
            self._adaptive_softening = bool(adaptive_softening)
        else:
            self._adaptive_softening = bool(self.cfg.adaptive_softening)
        if self._adaptive_softening and not self._adaptive_timestep:
            self._adaptive_timestep = True

        # --- state construction (simulation_state.py:98-144) ------------
        arrays = self._coerce_inputs(bodies, masses, positions, velocities)
        if arrays is None:
            self._disabled = True
            self._make_empty()
            return
        self._disabled = False
        m_np, q_np, v_np = arrays

        self._dtype = torch.float32 if self.cfg.fast_float32 \
            else torch.float64

        # --- COM recenter (simulation.py:85-86) --------------------------
        if not skip_cm_recenter and m_np.size:
            M = m_np.sum()
            if M > 0:
                v_np = v_np - (m_np[:, None] * v_np).sum(0) / M

        # --- softening defaults (simulation.py:88-94) --------------------
        min_softening = max(0.0, float(min_softening))
        softening = float(softening)
        if softening < 0.0:
            softening = min_softening
        if min_softening == 0.0 and softening > 0.0:
            min_softening = 0.1 * softening
        self._min_softening = float(min_softening)
        # the construction-time floor, before any ham_soft calibration
        # raise: snapshot/restore reproduces the calibration from it
        self._min_softening_init = float(min_softening)
        self._softening_scale = float(self.cfg.softening_scale)

        # --- mode resolution (simulation.py:96-120) ----------------------
        if integrator_mode is not None:
            self.cfg = self.cfg.replace(integrator_mode=str(integrator_mode))
        mode = self.cfg.integrator_mode
        self.G = float(G)
        if self.G == 0.0 and mode != "ham_soft":
            mode = "verlet"
        if mode == "whfast":
            if self._adaptive_softening:
                print("[info] WHFast incompatible with adaptive softening; "
                      "using Verlet")
                mode = "verlet"
            elif m_np.size > 0 and float(np.max(m_np) / np.sum(m_np)) < 0.2:
                mode = "verlet"

        # --- softening manager scalars (softening_manager.py:38-70) ------
        s0 = float(max(softening, min_softening))
        self._s0 = s0
        self._max_softening = 10.0 * s0
        if s0 > 0.0 and mode == "whfast":
            mode = "verlet"  # simulation.py:119-120
        if mode == "ham_soft":
            self._adaptive_softening = False  # simulation.py:132-133
        self._integrator_mode = mode
        # the step functions read the mode and adaptivity from cfg
        self.cfg = self.cfg.replace(
            integrator_mode=mode,
            adaptive_softening=self._adaptive_softening,
            adaptive_timestep=self._adaptive_timestep)

        self.softening_energy_delta = 0.0
        self._has_integrated = False
        self._in_integration = False
        self._acc_cached = False
        self._last_dt = None

        bucket = max(1, int(self.cfg.slot_bucket))
        n_slots = -(-m_np.size // bucket) * bucket
        self._state = build_state(m_np, q_np, v_np, eps=s0, n_slots=n_slots,
                                  dtype=self._dtype, device=self._dev)
        self._n_bodies = int(m_np.size)

        # --- integrator construction -------------------------------------
        # the large-N engines (P3M, the tiled direct force) skip the
        # few-body calibration: its dense (N, N) intermediates do not fit
        # at N >= 1e5, and its schedules target few-body encounters
        self._largen = (self.cfg.force_mode != "direct"
                        and mode == "verlet")
        if self._largen:
            self._init_largen()
        elif mode == "ham_soft":
            self._init_hamsoft()
        else:
            self._init_classical()

        self._top_dt = float(self.cfg.initial_dt)

        # --- startup corrector (simulation.py:150-157) --------------------
        if (not skip_init_corrector
                and not self._largen
                and self.G != 0.0
                and not self._adaptive_softening
                and not self._adaptive_timestep
                and mode != "ham_soft"
                and self.cfg.corrector_order > 0
                and self._n_bodies >= (2 if mode == "whfast" else 1)):
            corrector = whfast_corrector if mode == "whfast" \
                else apply_corrector
            self._state = corrector(self._state, self._dyn, self.cfg,
                                    self._as_dtype(self._top_dt))

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _as_dtype(self, x):
        """``x`` as the (1,) per-system tensor of the state's dtype."""
        return torch.full((1,), float(x), dtype=self._dtype, device=self._dev)

    def _as_scalar(self, x):
        return torch.tensor(float(x), dtype=self._dtype, device=self._dev)

    def _coerce_inputs(self, bodies, masses, positions, velocities):
        d = int(self.cfg.dim)
        if bodies is not None:
            m = np.array([b.mass for b in bodies], dtype=np.float64)
            if d == 3:
                q = np.array([[b.x, b.y, getattr(b, "z", 0.0)]
                              for b in bodies], dtype=np.float64)
                v = np.array([[b.vx, b.vy, getattr(b, "vz", 0.0)]
                              for b in bodies], dtype=np.float64)
            else:
                q = np.array([[b.x, b.y] for b in bodies], dtype=np.float64)
                v = np.array([[b.vx, b.vy] for b in bodies],
                             dtype=np.float64)
        elif masses is not None:
            m = np.asarray(masses, dtype=np.float64).ravel()
            q = np.atleast_2d(np.asarray(positions, dtype=np.float64))
            if velocities is None:
                v = np.zeros_like(q)
            else:
                v = np.asarray(velocities, dtype=np.float64)
                if v.ndim == 1:
                    v = np.broadcast_to(v, q.shape).copy()
        else:
            return None
        if m.size == 0 or q.shape[0] != m.size:
            print("[error] invalid state arrays; simulation disabled")
            return None
        if not (np.all(np.isfinite(m)) and np.all(m > 0)
                and np.all(np.isfinite(q)) and np.all(np.isfinite(v))):
            print("[error] non-finite or non-positive inputs; simulation "
                  "disabled")
            return None
        if q.shape[1] != d:
            print(f"[error] positions must be (N, {d}); simulation disabled")
            return None
        return m, q, v

    def _make_empty(self):
        self._n_bodies = 0
        self._dtype = torch.float64
        self.G = 0.0
        self._integrator_mode = "verlet"
        self._largen = False
        self._state = None
        self._dyn = None
        self.softening_energy_delta = 0.0

    def _init_largen(self):
        """The large-N engine's parameters: fixed softening and step, no
        pairwise calibration (O(N^2) dense, and meaningless for mesh
        forces); h and n_sub come from the requested dt."""
        f, z = self._as_dtype, self._as_dtype(0.0)
        self._dyn = DynParams(
            G=f(self.G), s0=f(self._s0),
            min_softening=f(self._min_softening),
            max_softening=f(self._max_softening),
            softening_scale=f(self._softening_scale),
            k_soft=f(self.cfg.k_soft), mu_soft=z, chi_eps=z,
            k_wall=f(self.cfg.k_wall), alpha_run=z, omega_spr0=z,
            h_sub_ref=f(self.cfg.initial_dt),
            n_sub=torch.ones(1, dtype=torch.int32, device=self._dev),
            frozen_dt=f(self.cfg.initial_dt))
        self.h_sub_ref = float(self.cfg.initial_dt)
        self.largen_info = None

    def _init_classical(self):
        """Integrator.__init__ (integrator.py:37-61) through the batched
        construction."""
        self._run_init()
        self.h_sub_ref = float(self._dyn.h_sub_ref)

    def _classical_eps_target(self) -> float:
        """Integrator._eps_target's fallback chain s0 -> softening_scale
        -> eps (integrator.py:165-189)."""
        if self._s0 > 0.0:
            return self._s0
        if self._softening_scale > 0.0:
            return self._softening_scale
        return float(self._state.eps)

    def _init_hamsoft(self):
        """HamiltonianSofteningIntegrator.__init__'s cascade (HSI:47-141)
        through the batched construction."""
        cfg = self.cfg
        self._run_init()
        self._min_softening = float(self._dyn.min_softening)
        if cfg.fixed_eps_star and cfg.eps_star_value is not None \
                and math.isfinite(cfg.eps_star_value):
            self.force_epsilon_override = float(cfg.eps_star_value)
        else:
            self.force_epsilon_override = None
        self.force_adaptive_timestep = bool(self._adaptive_timestep)
        self._frozen_n_sub = int(self._dyn.n_sub)
        self._frozen_dt = abs(float(cfg.initial_dt))
        self.h_sub_ref = float(self._dyn.h_sub_ref)

    def _run_init(self):
        """One construction call (``parallel/batch_engine.py::
        init_system``): the COM removal was applied on the host and the
        mode demotions resolved into cfg before this point."""
        from ..parallel.batch_engine import init_system

        st = self._state
        f = self._as_dtype
        self._state, self._dyn = init_system(
            st.mass[0], st.pos[0], st.vel[0], st.mask[0], self.cfg,
            G=f(self.G), softening=f(self._s0),
            min_softening=f(self._min_softening),
            dt=f(self.cfg.initial_dt), skip_cm_recenter=True)

    def _refreeze(self, dt: float):
        from ..parallel.batch_engine import refreeze

        self._dyn = refreeze(self._state, self._dyn, self.cfg,
                             self._as_dtype(dt))
        self._frozen_n_sub = int(self._dyn.n_sub)
        self._frozen_dt = abs(float(dt))

    # ------------------------------------------------------------------
    # properties (simulation.py:164-274)
    # ------------------------------------------------------------------

    @property
    def integrator_mode(self) -> str:
        return str(self._integrator_mode)

    @property
    def n_bodies(self) -> int:
        return self._n_bodies

    @property
    def device(self) -> torch.device:
        return self._dev

    def _get_array(self, name) -> np.ndarray:
        return _host(getattr(self._state, name)[0, : self._n_bodies])

    @property
    def _mass(self) -> np.ndarray:
        return self._get_array("mass")

    @_mass.setter
    def _mass(self, value) -> None:
        self._set_array("mass", value)

    mass = _mass

    @property
    def _pos(self) -> np.ndarray:
        return self._get_array("pos")

    @_pos.setter
    def _pos(self, value) -> None:
        self._set_array("pos", value)

    pos = _pos

    @property
    def _vel(self) -> np.ndarray:
        return self._get_array("vel")

    @_vel.setter
    def _vel(self, value) -> None:
        self._set_array("vel", value)

    vel = _vel

    def _set_array(self, name, value):
        cur = getattr(self._state, name)
        arr = torch.as_tensor(np.asarray(value, dtype=np.float64),
                              dtype=cur.dtype, device=cur.device)
        if arr.shape != cur[0, : self._n_bodies].shape:
            print(f"[error] shape mismatch setting {name}; ignored")
            return
        full = cur.clone()
        full[0, : self._n_bodies] = arr
        self._state = self._state.replace(**{name: full})

    @property
    def _acc(self) -> np.ndarray:
        return self.accelerations()

    @property
    def acc(self) -> np.ndarray:
        return self.accelerations()

    @property
    def _epsilon(self) -> float:
        return float(self._state.eps)

    @_epsilon.setter
    def _epsilon(self, v: float) -> None:
        v = self._as_dtype(float(v))
        self._state = self._state.replace(eps=v, s=v, step_s2=v * v)

    @property
    def _pi(self) -> float:
        return float(self._state.pi)

    @_pi.setter
    def _pi(self, v: float) -> None:
        self._state = self._state.replace(pi=self._as_dtype(float(v)))

    @property
    def soft(self) -> float:
        return float(self._state.s)

    softening = soft
    s = soft

    @property
    def max_softening(self) -> float:
        return self._max_softening

    @property
    def adaptive_softening(self) -> bool:
        return self._adaptive_softening

    @adaptive_softening.setter
    def adaptive_softening(self, value: bool) -> None:
        new_val = bool(value)
        if new_val == self._adaptive_softening:
            return
        self._adaptive_softening = new_val
        self.cfg = self.cfg.replace(adaptive_softening=new_val)
        if not new_val:
            # update_base_softening (softening_manager.py:392-407)
            s0 = self._as_dtype(self._s0)
            self._state = self._state.replace(
                s=s0, step_s2=s0 * s0,
                softening_energy_delta=self._as_dtype(0.0),
                hist_count=self._as_dtype(1.0), hist_sum=s0,
                hist_sumsq=s0 * s0)
            self.softening_energy_delta = 0.0
            self._max_softening = 10.0 * self._s0

    @property
    def _adaptive(self) -> bool:
        return self._adaptive_timestep

    @property
    def bodies(self) -> List[BodyView]:
        return [BodyView(self, i) for i in range(self._n_bodies)]

    def set_adaptive(self, value: bool) -> None:
        self._adaptive_timestep = bool(value)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _n_sub_for(self, dt: float) -> int:
        """Substeps of a macro step of dt (integrator.py:91 for the
        classical modes, the frozen schedule HSI:781-888 for ham_soft)."""
        if self._integrator_mode == "ham_soft":
            return self._hamsoft_schedule(dt)
        h_sub = float(self._dyn.h_sub_ref)
        if not (math.isfinite(h_sub) and h_sub > 0.0):
            h_sub = abs(dt)
        return int(max(1, min(self.cfg.split_n_max,
                              math.ceil(abs(dt) / h_sub))))

    def _advance(self, fn, dt: float) -> None:
        """One step call ``fn(state, n_sub)`` with the classical
        adaptive-softening ledger around it (simulation.py:667-676)."""
        self._top_dt = abs(dt)
        n_sub = self._n_sub_for(dt)
        record = self._adaptive_softening \
            and self._integrator_mode != "ham_soft"
        if record:
            old_s = float(self._state.s)
            old_sed = self.softening_energy_delta
        self._state = fn(self._state, n_sub)
        self._has_integrated = True
        self._last_dt = dt
        self.softening_energy_delta = float(
            self._state.softening_energy_delta)
        if record:
            new_s = float(self._state.s)
            dE = self.softening_energy_delta - old_sed
            if dE != 0.0 or new_s != old_s:
                self._ledger_append(old_s, new_s, dE)

    def step(self, dt: float) -> None:
        """simulation.py:667-676 -> integrator.step / HSI.step."""
        if dt == 0.0 or self._n_bodies == 0 or self._disabled:
            return
        if self._largen:
            self._largen_run(float(dt), 1)
            return
        dt = float(dt)
        self._advance(lambda st, n_sub: step_mod.macro_step(
            st, self._dyn, self.cfg, self._as_dtype(dt), n_sub), dt)

    def run(self, dt: float, n_steps: int) -> None:
        """``n_steps`` macro steps in one call; under the adaptive
        ledger, one aggregated entry (the run exposes no per-step
        deltas)."""
        if dt == 0.0 or n_steps <= 0 or self._n_bodies == 0 \
                or self._disabled:
            return
        if self._largen:
            self._largen_run(float(dt), int(n_steps))
            return
        dt = float(dt)
        self._advance(lambda st, n_sub: step_mod.integrate(
            st, self._dyn, self.cfg, self._as_dtype(dt), int(n_steps),
            n_sub), dt)

    def _largen_run(self, dt: float, n_steps: int) -> None:
        """The large-N leapfrog rollout (``integrators/largen.py``) with
        the force engine of ``cfg.force_mode``."""
        from ..integrators.largen import largen_rollout

        self._top_dt = abs(dt)
        st = self._state
        q, v, info = largen_rollout(
            st.pos[0], st.vel[0], st.mass[0], self._as_scalar(self._s0),
            self._as_scalar(self.G), self._as_scalar(dt), n_steps, self.cfg)
        self._state = st.replace(pos=q[None], vel=v[None])
        self.largen_info = info
        self._has_integrated = True
        self._last_dt = dt

    def _hamsoft_schedule(self, dt: float) -> int:
        """strang_substeps (HSI:781-888): the pi-budget mu raise on each
        call, the frozen n_sub reused while |dt| is within 1% of the
        frozen dt."""
        mu_new = calib.calibrate_mu_from_pi_budget(
            self._dyn.mu_soft, self._dyn.k_soft, self._as_dtype(abs(dt)),
            self._as_dtype(self.cfg.theta_imp))
        self._dyn = self._dyn.replace(mu_soft=mu_new)
        if self.cfg._validate_S_only:
            return 1
        prev = getattr(self, "_frozen_dt", None)
        if prev is not None and prev > 0.0 \
                and abs(abs(dt) - prev) / prev <= 0.01:
            return max(1, self._frozen_n_sub)
        self._refreeze(dt)
        return max(1, self._frozen_n_sub)

    # ------------------------------------------------------------------
    # kinematics / helpers
    # ------------------------------------------------------------------

    def accelerations(self) -> np.ndarray:
        if self._n_bodies < 2 or self.G == 0.0:
            return np.zeros((self._n_bodies, int(self.cfg.dim)))
        accel = hamsoft_accel if self.cfg.integrator_mode == "ham_soft" \
            else classical_accel
        return _host(accel(self._state, self._dyn, self.cfg)[
            0, : self._n_bodies])

    def _accel(self, *, pos=None, s2=None) -> np.ndarray:
        return self.accelerations()

    _compute_accelerations = _accel

    def _host_tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=torch.float64)

    def to_jacobi(self):
        """Jacobi coordinates of the bodies, computed in float64 on the
        host copies (simulation.py:487-507)."""
        jp, jv = _to_jac(*(self._host_tensor(a)
                           for a in (self._mass, self._pos, self._vel)))
        return jp.numpy(), jv.numpy()

    def from_jacobi(self, jac_pos, jac_vel):
        p, v = _from_jac(*(self._host_tensor(a)
                           for a in (self._mass, jac_pos, jac_vel)))
        return p.numpy(), v.numpy()

    def _get_min_separation(self) -> float:
        if self._n_bodies < 2:
            return float("inf")
        return float(min_separation(self._state.pos, self._state.mask))

    def get_current_softening_squared(self) -> float:
        return float(self._state.step_s2)

    def get_integrator_name(self) -> str:
        return self._integrator_mode

    def set_integrator_mode(self, mode: str) -> None:
        """simulation.py:281-303: rebuilds the integrator stack."""
        if self.G == 0.0:
            mode = "verlet"
        if mode not in _ALLOWED_MODES:
            return
        self._integrator_mode = mode
        self.cfg = self.cfg.replace(integrator_mode=mode)
        if mode == "ham_soft":
            self._adaptive_softening = False
            self._init_hamsoft()
        else:
            self._init_classical()

    def set_fast_mode(self, *, float32: bool = True, barrier: bool = True):
        self.cfg = self.cfg.replace(fast_float32=bool(float32),
                                    disable_barrier=not barrier)

    def set_softening_bounds(self, eps_min: float, eps_max: float, *,
                             clamp_epsilon: bool = True,
                             reset_pi_on_clamp: bool = True) -> None:
        """simulation.py:679-728."""
        a = float(eps_min) if math.isfinite(eps_min) else 0.0
        b = float(eps_max) if math.isfinite(eps_max) else a
        if b < a:
            a, b = b, a
        a = max(a, 0.0)
        self._min_softening = a
        self._max_softening = b
        self._dyn = self._dyn.replace(min_softening=self._as_dtype(a),
                                      max_softening=self._as_dtype(b))
        if clamp_epsilon:
            eps_now = self._epsilon
            new_eps = min(max(eps_now, a), b)
            if new_eps != eps_now:
                self._epsilon = new_eps
                if reset_pi_on_clamp:
                    self._pi = -self._pi

    # ------------------------------------------------------------------
    # snapshot / restore (simulation.py:324-484)
    # ------------------------------------------------------------------

    def commit_state(self) -> None:
        """The reference re-kicks velocities here (simulation.py:319-322);
        the state is kept pure, so snapshot/restore is an exact round
        trip."""
        return

    def snapshot(self) -> dict:
        """The JAX facade's snapshot dict; ``cfg`` is this port's
        ``SimConfig``."""
        st = self._state
        s = float(st.s)
        soft_state = {
            "s0": self._s0,
            "min_softening_init": self._min_softening_init,
            "s": s,
            "s2": s ** 2,
            "step_s2": float(st.step_s2),
            "_step_s2": float(st.step_s2),
            "min_softening": self._min_softening,
            "_pending_energy_delta": 0.0,
            "_history": [self._s0],
            "_hist_moments": (float(st.hist_count), float(st.hist_sum),
                              float(st.hist_sumsq)),
            "_step_finished": True,
        }
        int_state = {
            "dt_prev": None,
            "eps_prev": None,
            "_top_dt": self._top_dt,
            "_last_update_tick": 0,
            "_cached_min_sep": None,
            "k_soft": float(self._dyn.k_soft),
            "mu_soft": float(self._dyn.mu_soft),
        }
        sim_flags = {
            "_acc_cached": False,
            "_in_integration": False,
            "softening_energy_delta": self.softening_energy_delta,
            "_adaptive_timestep": self._adaptive_timestep,
            "_adaptive_softening": self._adaptive_softening,
            "_epsilon": self._epsilon,
            "_pi": self._pi,
            "_min_softening": self._min_softening,
            "_max_softening": self._max_softening,
        }
        m, q, v = self._mass, self._pos, self._vel
        return {
            "masses": m,
            "positions": q,
            "velocities": v,
            "softening": soft_state["s"],
            "softening_s2": soft_state["s2"],
            "pending_energy": self.softening_energy_delta,
            "integrator_state": int_state,
            "softening_mgr_state": soft_state,
            "sim_state": sim_flags,
            "cfg": self.cfg.copy(),
            "has_integrated": self._has_integrated,
            "G": self.G,
            "sim": {"masses": m.copy(), "positions": q.copy(),
                    "velocities": v.copy(), "flags": sim_flags},
            "integrator": int_state,
            "softening_mgr": soft_state,
        }

    @classmethod
    def restore(cls, state: dict, device=None) -> "NBodySimulation":
        """A simulation from a snapshot dict: this port's or the JAX
        facade's, whose ``cfg`` may be given as a mapping of
        ``SimConfig`` fields.  ``device=None`` is the card."""
        cfg_in = state.get("cfg", state.get("sim", {}).get("cfg"))
        if isinstance(cfg_in, dict):
            cfg = SimConfig(**cfg_in)
        else:
            cfg = cfg_in.copy() if cfg_in else SimConfig()
        sim_data = state.get("sim", state)
        soft_data = state.get("softening_mgr_state",
                              state.get("softening_mgr", {}))
        sim_flags = state.get("sim_state", sim_data.get("flags", {}))

        s0_snap = soft_data.get("s0")
        if s0_snap is None:
            hist = soft_data.get("_history") or []
            if hist and np.isfinite(hist[0]):
                s0_snap = float(hist[0])
            else:
                s0_snap = float(state.get("softening",
                                          soft_data.get("s", 1e-3)))

        # rebuilt with the construction-time floor, so the ham_soft
        # calibration reproduces the original's; the evolved bounds are
        # laid over it below
        min_snap = soft_data.get("min_softening_init")
        if min_snap is None:
            min_snap = 0.1 * s0_snap if s0_snap > 0 else 0.0

        sim = cls(
            config=cfg,
            masses=sim_data["masses"],
            positions=sim_data["positions"],
            velocities=sim_data["velocities"],
            G=float(state.get("G", 1.0)),
            softening=float(s0_snap),
            min_softening=float(min_snap),
            adaptive_timestep=bool(sim_flags.get("_adaptive_timestep",
                                                 False)),
            adaptive_softening=bool(sim_flags.get("_adaptive_softening",
                                                  False)),
            skip_init_corrector=True,
            skip_cm_recenter=True,
            integrator_mode=getattr(cfg, "integrator_mode", None),
            device=device,
        )

        # the evolving scalars
        f = sim._as_dtype
        eps_now = float(sim_flags.get("_epsilon", soft_data.get("s", s0_snap)))
        sim._epsilon = eps_now
        sim._pi = float(sim_flags.get("_pi", 0.0))
        s = float(soft_data.get("s", eps_now))
        step_s2 = float(soft_data.get("step_s2", s * s))
        sed = float(sim_flags.get("softening_energy_delta", 0.0))
        sim.softening_energy_delta = sed
        sim._state = sim._state.replace(s=f(s), step_s2=f(step_s2),
                                        softening_energy_delta=f(sed))
        hm = soft_data.get("_hist_moments")
        if hm:
            sim._state = sim._state.replace(
                hist_count=f(hm[0]), hist_sum=f(hm[1]), hist_sumsq=f(hm[2]))
        ints = state.get("integrator_state", state.get("integrator", {}))
        for k in ("k_soft", "mu_soft"):
            if ints and ints.get(k) is not None:
                sim._dyn = sim._dyn.replace(**{k: f(ints[k])})
        # the evolved softening bounds (e.g. set_softening_bounds)
        ms = sim_flags.get("_min_softening")
        if ms is not None:
            sim._min_softening = float(ms)
            sim._dyn = sim._dyn.replace(min_softening=f(ms))
        mx = sim_flags.get("_max_softening")
        if mx is not None:
            sim._max_softening = float(mx)
            sim._dyn = sim._dyn.replace(max_softening=f(mx))
        else:
            sim._max_softening = 10.0 * float(sim._s0)
        sim._has_integrated = bool(state.get("has_integrated", False))
        return sim

    def copy(self, *, deep: bool = True) -> "NBodySimulation":
        """A deep copy on the same device (a snapshot restored: no tensor
        is shared with this simulation)."""
        if not deep:
            return self
        return NBodySimulation.restore(self.snapshot(), device=self._dev)

    def __copy__(self):
        return self.copy(deep=True)

    def __deepcopy__(self, memo=None):
        return self.copy(deep=True)

    #: bounded per-refresh delta ring depth (validate_energy's replay)
    _LEDGER_DEPTH = 512

    def _ledger_append(self, e_old: float, e_new: float, dE: float) -> None:
        """Record one softening-refresh energy delta in the bounded replay
        ring (the reference's ``_history`` deque); entries evicted past
        the depth fold their delta into ``base`` so the replayed total
        stays exact.  The ring is anchored to the accumulated delta
        before the entry, so a restored snapshot (which carries the
        delta but not the ring) stays consistent."""
        led = getattr(self, "_eps_ledger", None)
        if led is None:
            led = {"base": float(self.softening_energy_delta) - float(dE),
                   "entries": []}
            self._eps_ledger = led
        led["entries"].append((float(e_old), float(e_new), float(dE)))
        while len(led["entries"]) > self._LEDGER_DEPTH:
            led["base"] += led["entries"].pop(0)[2]

    def debug_adaptive_softening(self) -> dict:
        return {
            "current_s2": float(self._state.step_s2),
            "min_separation": self._get_min_separation(),
            "adaptive": bool(self._adaptive_softening),
        }

    # compatibility shims -------------------------------------------------
    @property
    def manager(self):
        return _ManagerShim(self)

    @property
    def _integrator(self):
        return _IntegratorShim(self)


class _ManagerShim:
    """Read-mostly stand-in for the SofteningManager's attributes
    (softening_manager.py:38-120) used by diagnostics and analyzers."""

    def __init__(self, sim: NBodySimulation):
        self._sim = sim

    @property
    def s0(self) -> float:
        return self._sim._s0

    @property
    def s(self) -> float:
        return float(self._sim._state.s)

    @s.setter
    def s(self, v: float) -> None:
        sim = self._sim
        sim._state = sim._state.replace(s=sim._as_dtype(float(v)))

    @property
    def s2(self) -> float:
        return float(self._sim._state.s) ** 2

    softening = s

    @property
    def step_s2(self) -> float:
        return float(self._sim._state.step_s2)

    @property
    def pending_energy_delta(self) -> float:
        return 0.0

    def update_continuous(self, eps_new: float) -> None:
        sim = self._sim
        v = sim._as_dtype(float(eps_new))
        sim._state = sim._state.replace(s=v, step_s2=v * v)

    def begin_step(self) -> None:
        sim = self._sim
        sim._state = step_mod.begin_step(sim._state, sim.cfg)

    def finish_step(self) -> None:
        sim = self._sim
        sim._state = step_mod.finish_step(sim._state, sim.cfg)

    def debug_info(self) -> dict:
        st = self._sim._state
        cnt = max(float(st.hist_count), 1.0)
        mean = float(st.hist_sum) / cnt
        var = max(float(st.hist_sumsq) / cnt - mean * mean, 0.0)
        return dict(softening=self.s, step_s2=self.step_s2,
                    history=self.history, history_mean=mean,
                    history_std=var ** 0.5, history_count=cnt,
                    pending_energy_delta=0.0)

    @staticmethod
    def _limited_softening(old_eps: float, proposed_eps: float, *,
                           factor: float = 2.0) -> float:
        """softening_manager.py:100-103."""
        return max(old_eps / factor, min(old_eps * factor, proposed_eps))

    def softening_from_min_sep(self, min_sep: float) -> float:
        """softening_manager.py:541-547."""
        if not math.isfinite(min_sep) or min_sep <= 0.0:
            return self.s
        proposed = max(self._sim._min_softening,
                       min_sep / self._sim._softening_scale)
        proposed = min(proposed, 10.0 * self.s0)
        return self._limited_softening(self.s, proposed)

    def refresh_softening(self, eps_new: float, sim=None) -> None:
        """softening_manager.py:298-336: a softening change with its
        energy bookkeeping (classical modes)."""
        from ..integrators.classical import _energy_correction

        s = self._sim
        if s._integrator_mode == "ham_soft":
            self.update_continuous(eps_new)
            return
        e_old = float(s._state.s)
        dE = float(_energy_correction(s._state, s._dyn, s.cfg, s._state.s,
                                      s._as_dtype(eps_new)))
        if math.isfinite(dE):
            s.softening_energy_delta += dE
            s._state = s._state.replace(softening_energy_delta=s._as_dtype(
                s.softening_energy_delta))
            s._ledger_append(e_old, float(eps_new), dE)
        self.update_continuous(eps_new)

    def validate_energy(self) -> None:
        """The ledger's self-check (softening_manager.py:376-389): replay
        the recorded per-refresh deltas (ring and evicted base, in the
        incremental ledger's order) against the accumulated
        ``softening_energy_delta``.  Tolerance: 1e-10 in float64; the
        float32 fast path accumulates the state-side ledger in float32,
        so its replay agrees to float32 rounding (1e-5 relative)."""
        s = self._sim
        ref = s.softening_energy_delta
        if not math.isfinite(ref):
            print(f"[warning] energy mismatch: softening ledger is {ref}")
            return
        led = getattr(s, "_eps_ledger", None)
        if led is None or len(led["entries"]) < 2:
            return  # the reference needs >= 2 history points
        total = led["base"]
        for _e_old, _e_new, dE in led["entries"]:
            total += dE
        err = abs(total - ref) if ref == 0.0 else abs((total - ref) / ref)
        tol = 1e-5 if s.cfg.fast_float32 else 1e-10
        if err > tol:
            print(f"[warning] energy mismatch: {err:.3g}")

    def update_base_softening(self, adaptive: bool) -> None:
        """softening_manager.py:392-407."""
        if adaptive:
            return
        s = self._sim
        s0 = s._as_dtype(s._s0)
        s._state = s._state.replace(
            s=s0, step_s2=s0 * s0, softening_energy_delta=s._as_dtype(0.0),
            hist_count=s._as_dtype(1.0), hist_sum=s0, hist_sumsq=s0 * s0)
        s.softening_energy_delta = 0.0
        s._max_softening = 10.0 * s._s0
        s._eps_ledger = {"base": 0.0, "entries": []}

    @property
    def history(self):
        """Recent eps values from the refresh ring (the reference's
        bounded ``_history`` deque)."""
        led = getattr(self._sim, "_eps_ledger", None)
        if not led or not led["entries"]:
            return []
        return [led["entries"][0][0]] + [e[1] for e in led["entries"]]


class _IntegratorShim:
    """Attribute-level stand-in for the reference integrator object."""

    def __init__(self, sim: NBodySimulation, **_kw):
        self._sim = sim

    @property
    def sim(self):
        return self._sim

    def step(self, dt: float) -> None:
        self._sim.step(dt)

    def _dyn_float(name):
        return property(lambda self: float(getattr(self._sim._dyn, name)))

    k_soft = _dyn_float("k_soft")
    mu_soft = _dyn_float("mu_soft")
    chi_eps = _dyn_float("chi_eps")
    k_wall = _dyn_float("k_wall")
    h_sub_ref = _dyn_float("h_sub_ref")
    del _dyn_float

    @property
    def split_n_max(self) -> int:
        return int(self._sim.cfg.split_n_max)

    @property
    def barrier_policy(self) -> str:
        return "soft" if hs.policy_is_soft(self._sim.cfg) else "reflection"

    def _barrier_n(self) -> int:
        return int(self._sim.cfg.barrier_exponent)

    def _state_at(self, q=None):
        """The sim's state, its first bodies' positions replaced by the
        (n, d) array ``q`` where one is given."""
        st = self._sim._state
        if q is None:
            return st
        qq = torch.as_tensor(np.asarray(q, dtype=np.float64),
                             dtype=st.pos.dtype, device=st.pos.device)
        full = st.pos.clone()
        full[0, : qq.shape[0]] = qq
        return st.replace(pos=full)

    def _eps_target(self, q=None, **kw) -> float:
        sim = self._sim
        if sim._integrator_mode == "ham_soft":
            return float(hs.eps_target(self._state_at(q), sim._dyn, sim.cfg))
        return sim._classical_eps_target()

    def eps_star_and_grad(self, q=None):
        sim = self._sim
        es, g = hs.eps_star_and_grad(self._state_at(q), sim._dyn, sim.cfg)
        return float(es), _host(g[0, : sim._n_bodies])

    def canonical_eom(self):
        sim = self._sim
        qd, pd, ed, pid = hs.canonical_eom(sim._state, sim._dyn, sim.cfg)
        n = sim._n_bodies
        return (_host(qd[0, :n]), _host(pd[0, :n]), float(ed), float(pid))

    def compute_extended_hamiltonian(self) -> float:
        from ..diagnostics.energy import extended_hamiltonian_of_sim

        return extended_hamiltonian_of_sim(self._sim)

    # --- probe accessors (HSI:300, :1242, :340) ---------------------------
    def report_epsilon_policies(self) -> dict:
        eps = self._sim._epsilon
        return {"eom_eps_eff": eps, "vkick_eps_eff": eps}

    def last_eps_star_probe(self) -> dict:
        es, grad = self.eps_star_and_grad()
        rn = np.sqrt((grad ** 2).sum(axis=1))
        return {"eps_star": float(es),
                "grad_norm_max": float(rn.max()) if rn.size else 0.0}

    def _probe(self, probe):
        sim = self._sim
        return probe(sim._state, sim._dyn, sim.cfg,
                     sim._as_dtype(sim._top_dt or sim.cfg.initial_dt))

    def _last_vkick_probe(self) -> dict:
        from ..diagnostics.probes import vkick_probe

        out = {k: float(v) for k, v in self._probe(vkick_probe).items()}
        out["eps_used"] = out["epsilon_used"]
        return out

    def last_spring_probe(self) -> dict:
        from ..diagnostics.probes import spring_probe

        return {k: (_host(v[0]) if v.dim() > 1 else float(v))
                for k, v in self._probe(spring_probe).items()}

    def last_strang_schedule_info(self) -> dict:
        from ..diagnostics.probes import schedule_probe

        out = {k: float(v) for k, v in self._probe(schedule_probe).items()}
        out["n_sub"] = int(out["n_sub"])
        out["barrier_policy"] = self.barrier_policy
        return out


class Integrator(_IntegratorShim):
    """Name-parity class (integrator.py:31): the integrator state lives
    in the sim's DynParams; this view exposes the reference's attributes
    over it."""

    def __init__(self, sim: NBodySimulation, *, split_n_max: int = 10000):
        super().__init__(sim)


class HamiltonianSofteningIntegrator(_IntegratorShim):
    """Name-parity class (hamiltonian_softening_integrator.py:40)."""

    def __init__(self, sim: NBodySimulation, *, split_n_max: int = 10000,
                 force_adaptive_timestep: bool = False):
        super().__init__(sim)


class SofteningManager(_ManagerShim):
    """Name-parity class (softening_manager.py:37); the softening state
    is carried in the SimState."""

    def __init__(self, sim: NBodySimulation, softening: float | None = None,
                 min_softening: float | None = None, history: int = 1024,
                 tol: float = 1e-12):
        super().__init__(sim)
