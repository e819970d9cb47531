from .mesh import make_mesh, shard_batch, replicate, pad_to_multiple, DATA_AXIS
from .batch_engine import (init_system, build_batch, integrate_batch,
                           step_batch)

__all__ = ["make_mesh", "shard_batch", "replicate", "pad_to_multiple",
           "DATA_AXIS", "init_system", "build_batch", "integrate_batch",
           "step_batch"]
