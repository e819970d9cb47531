from .body import Body, BodyView
from .simulation import NBodySimulation

__all__ = ["Body", "BodyView", "NBodySimulation"]
