"""PyTorch/CUDA port of nbodysimproject_tpu.

The JAX package ``nbodysimproject_tpu`` stays the reference; this
package mirrors its layout (``core/``, ``ops/``, ``integrators/``,
``diagnostics/``, ``analysis/``, ``parallel/``) and imports neither JAX
nor the JAX package.  Ported so far (d = 2 unless stated):

* full- and core-mode ``analyze_population`` under the dataset
  pipeline's configuration, through hand-written CUDA kernels for the
  ham_soft analysis, MEGNO and plain multi-step loops
  (``ops/hamsoft_kernels.py``);
* batched integration, ``build_batch`` -> ``integrate_batch`` /
  ``step_batch`` for verlet, yoshida4 and ham_soft (both barrier
  policies; the ham_soft scan's eps* evaluation through
  ``ops/eps_kernels.py`` on the card), and the fused multi-step entry
  points ``verlet_multistep`` / ``yoshida4_multistep``
  (``ops/batch_kernels.py``) and ``hamsoft_multistep``;
* the Kepler slice: ``analyze_population`` under the dataset
  configuration unmodified, its Kepler tail (``analysis_tail_policy=
  "kepler"``) on the scan engine under ``integrator_mode=
  "kepler_split"``, and ``integrator_mode="whfast"`` through
  ``build_batch`` -> ``integrate_batch`` and the fused
  ``whfast_multistep`` (``ops/whfast_kernels.py``);
* the large-N slice: ``largen_rollout`` (``integrators/largen.py``) over
  P3M (``ops/pm_force.py``, plain PyTorch), the dense force or the
  tiled exact force kernel (``ops/force_kernels.py``, d = 2 and 3),
  which also serves verlet and yoshida4 under ``use_pallas_forces`` and
  the many-planet WHFast kick (``force_mode`` other than "direct").

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; the batched-integration functions run where their
tensors lie.
"""

from .analysis.batch import analyze_population
from .core.config import SimConfig
from .core.state import DynParams, SimState, state_from_numpy
from .integrators.largen import largen_rollout
from .ops.batch_kernels import verlet_multistep, yoshida4_multistep
from .ops.hamsoft_kernels import hamsoft_multistep
from .ops.whfast_kernels import whfast_multistep
from .parallel.batch_engine import build_batch, integrate_batch, step_batch

__all__ = ["SimConfig", "SimState", "DynParams", "state_from_numpy",
           "analyze_population", "build_batch", "integrate_batch",
           "step_batch", "verlet_multistep", "yoshida4_multistep",
           "hamsoft_multistep", "whfast_multistep", "largen_rollout"]
