"""PyTorch/CUDA port of nbodysimproject_tpu.

The JAX package ``nbodysimproject_tpu`` stays the reference; this
package mirrors its layout (``core/``, ``ops/``, ``integrators/``,
``diagnostics/``, ``analysis/``, ``parallel/``) and imports neither JAX
nor the JAX package.  Ported so far: full- and core-mode
``analyze_population`` under the dataset pipeline's configuration (tail
policy off, d = 2), through hand-written CUDA kernels for the ham_soft
analysis and MEGNO loops (``ops/hamsoft_kernels.py``,
``csrc/hamsoft.cu``).  Entry points run on the current CUDA device
unless the caller passes ``device="cpu"``.
"""

from .analysis.batch import analyze_population
from .core.config import SimConfig
from .core.state import DynParams, SimState, state_from_numpy

__all__ = ["SimConfig", "SimState", "DynParams", "state_from_numpy",
           "analyze_population"]
