from .seeding import set_global_seed
from .summation import kahan_sum, pairwise_sum, two_sum
from .accumulator import EnergyAccumulator
from .checkpoint import save_checkpoint, load_checkpoint

__all__ = ["set_global_seed", "kahan_sum", "pairwise_sum", "two_sum",
           "EnergyAccumulator", "save_checkpoint", "load_checkpoint"]
