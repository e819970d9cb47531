"""Compensated energy accumulator.

Counterpart of ``nbodysimproject_tpu/utils/accumulator.py`` (parity:
``minbody/energy_accumulator.py:19-83``): Kahan compensated
accumulation of softening, spring and barrier energy deltas.  Host-side
scalar bookkeeping in Python floats (float64); inside batched code the
same arithmetic lives in ``utils/summation.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class _Kahan:
    total: float = 0.0
    _comp: float = 0.0

    def add(self, x: float) -> None:
        y = float(x) - self._comp
        t = self.total + y
        self._comp = (t - self.total) - y
        self.total = t


@dataclass
class EnergyAccumulator:
    _acc: _Kahan = field(default_factory=_Kahan)

    def add(self, dE: float) -> None:
        self._acc.add(dE)

    def total(self) -> float:
        return self._acc.total

    def reset(self) -> None:
        self._acc = _Kahan()
