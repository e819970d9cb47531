"""State validity checks, on the host.

Counterpart of ``nbodysimproject_tpu/core/validation.py``.  Parity:
``minbody/simulation_validator.py:25-116`` (SimulationValidator):
positive finite masses, finite (N, d) positions/velocities,
non-negative softening, plus a printed report for invalid states.
"""

from __future__ import annotations

import numpy as np


class SimulationValidator:
    @staticmethod
    def state_is_valid(masses, positions, velocities, softening=0.0,
                       dim: int = 2) -> bool:
        try:
            m = np.asarray(masses, dtype=float).ravel()
            q = np.asarray(positions, dtype=float)
            v = np.asarray(velocities, dtype=float)
        except Exception:
            return False
        if m.size == 0:
            return False
        if not (np.all(np.isfinite(m)) and np.all(m > 0)):
            return False
        if q.ndim != 2 or q.shape != (m.size, dim):
            return False
        if v.shape != q.shape:
            return False
        if not (np.all(np.isfinite(q)) and np.all(np.isfinite(v))):
            return False
        if not (np.isfinite(softening) and softening >= 0.0):
            return False
        return True

    @staticmethod
    def report_invalid_state(masses, positions, velocities,
                             softening=0.0, dim: int = 2) -> str:
        msgs = []
        m = np.asarray(masses, dtype=float).ravel()
        q = np.asarray(positions, dtype=float)
        v = np.asarray(velocities, dtype=float)
        if m.size == 0:
            msgs.append("no bodies")
        if not np.all(np.isfinite(m)):
            msgs.append("non-finite masses")
        if np.any(m <= 0):
            msgs.append("non-positive masses")
        if q.ndim != 2 or (m.size and q.shape != (m.size, dim)):
            msgs.append(f"positions must be (N, {dim})")
        if v.shape != q.shape:
            msgs.append("velocity shape mismatch")
        elif not np.all(np.isfinite(v)):
            msgs.append("non-finite velocities")
        if q.ndim == 2 and not np.all(np.isfinite(q)):
            msgs.append("non-finite positions")
        if not (np.isfinite(softening) and softening >= 0.0):
            msgs.append("invalid softening")
        report = "; ".join(msgs) if msgs else "state is valid"
        print(f"[validator] {report}")
        return report
