"""Evolution features: MEGNO, the Lyapunov time and the current energy.

Counterpart of ``nbodysimproject_tpu/diagnostics/evolution.py``
(parity: ``minbody/evolution_features.py:26-87``): the facade's view
over the MEGNO scan at the simulation's own substep count
(``megno.py::megno_static``).  The tangent vectors come from a CPU
``torch.Generator`` seeded by ``seed`` and advanced on each MEGNO run
(the JAX package splits its key), or, with ``tangent=(dr0, dv0)``,
from finished (n_slots, d) vectors used on every run.
"""

from __future__ import annotations

import torch

from .features import DynamicalFeatures
from .megno import megno_static, tangent_for
from .metrics import Diagnostics


class EvolutionFeatures:
    def __init__(self, sim, n_samples: int = 20, dt: float = 0.01,
                 seed: int = 0, tangent=None):
        self.sim = sim
        self.n_samples = int(n_samples)
        self.dt = float(dt)
        self.diagnostics = Diagnostics(sim)
        self._gen = torch.Generator().manual_seed(int(seed))
        self._tangent = tangent

    def compute_megno(self, n_steps: int, dt: float):
        """(Y, lyapunov_time); advances the simulation, as the reference
        does (evolution_features.py:47-66 calls sim.step)."""
        sim = self.sim
        n_sub = sim._n_sub_for(dt)
        dr0, dv0 = tangent_for(sim._state, self._gen, self._tangent)
        st, Y, lyap, slope_med = megno_static(
            sim._state, sim._dyn, sim.cfg, dr0, dv0, int(n_steps),
            sim._as_dtype(dt), n_sub)
        sim._state = st
        sim._has_integrated = True
        self.last_megno_slope_med = float(slope_med)
        return float(Y), float(lyap)

    def extract_evolution_features(self) -> dict:
        feats = self.extract_all()
        return {k: feats[k] for k in
                ("MEGNO", "lyapunov_time", "current_total_energy")}

    def extract_all(self) -> dict:
        features = DynamicalFeatures(self.sim).extract_all()
        megno, lyap = self.compute_megno(self.n_samples, self.dt)
        features.update({
            "MEGNO": megno,
            "lyapunov_time": lyap,
            "current_total_energy": self.diagnostics.energy(),
        })
        return features
