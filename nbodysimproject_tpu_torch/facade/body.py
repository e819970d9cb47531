"""Body record and per-body view of a simulation.

Counterpart of ``nbodysimproject_tpu/facade/body.py`` (parity:
``minbody/body.py:12`` Body and ``minbody/body_view.py:22`` BodyView):
z/vz extend both types to d = 3 configurations (``SimConfig(dim=3)``);
they default to 0.0 and are ignored for d = 2 simulations.  A view
reads and writes through the simulation's host accessors, so each
access on the card is a device-to-host copy.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Body:
    mass: float
    x: float
    y: float
    vx: float = 0.0
    vy: float = 0.0
    z: float = 0.0
    vz: float = 0.0


class BodyView:
    """Per-particle proxy over the simulation arrays
    (body_view.py:22-67)."""

    __slots__ = ("_sim", "_i")

    def __init__(self, sim, index: int):
        self._sim = sim
        self._i = int(index)

    @property
    def index(self) -> int:
        return self._i

    @property
    def mass(self) -> float:
        return float(self._sim._mass[self._i])

    @mass.setter
    def mass(self, v: float) -> None:
        m = self._sim._mass.copy()
        m[self._i] = float(v)
        self._sim._mass = m

    def _get_pos(self, axis: int) -> float:
        return float(self._sim._pos[self._i, axis])

    def _set_pos(self, axis: int, v: float) -> None:
        q = self._sim._pos.copy()
        q[self._i, axis] = float(v)
        self._sim._pos = q

    def _get_vel(self, axis: int) -> float:
        return float(self._sim._vel[self._i, axis])

    def _set_vel(self, axis: int, v: float) -> None:
        w = self._sim._vel.copy()
        w[self._i, axis] = float(v)
        self._sim._vel = w

    x = property(lambda s: s._get_pos(0), lambda s, v: s._set_pos(0, v))
    y = property(lambda s: s._get_pos(1), lambda s, v: s._set_pos(1, v))
    vx = property(lambda s: s._get_vel(0), lambda s, v: s._set_vel(0, v))
    vy = property(lambda s: s._get_vel(1), lambda s, v: s._set_vel(1, v))
    # d = 3 extension: reads return 0.0 on 2-D simulations; writes to a
    # 2-D simulation are rejected (there is no slot to store them)
    z = property(lambda s: s._get_pos(2) if s._dim() > 2 else 0.0,
                 lambda s, v: s._set_axis3(s._set_pos, v))
    vz = property(lambda s: s._get_vel(2) if s._dim() > 2 else 0.0,
                  lambda s, v: s._set_axis3(s._set_vel, v))

    def _set_axis3(self, setter, v: float) -> None:
        if self._dim() <= 2:
            raise ValueError("z/vz write requires SimConfig(dim=3); "
                             "this simulation is 2-D")
        setter(2, v)

    def _dim(self) -> int:
        return int(self._sim._pos.shape[1])

    def __repr__(self) -> str:  # pragma: no cover
        return (f"BodyView(i={self._i}, m={self.mass:g}, "
                f"x={self.x:g}, y={self.y:g}, vx={self.vx:g}, vy={self.vy:g})")
