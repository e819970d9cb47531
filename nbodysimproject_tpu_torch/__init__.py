"""PyTorch/CUDA port of nbodysimproject_tpu.

The JAX package ``nbodysimproject_tpu`` stays the reference; this
package mirrors its layout (``core/``, ``ops/``, ``integrators/``,
``diagnostics/``, ``analysis/``, ``parallel/``, ``generators/``,
``ml/``, ``utils/``) and imports neither JAX nor the JAX package.
Ported so far (d = 2 unless stated):

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
  the many-planet WHFast kick (``force_mode`` other than "direct");
* the generators and the serving path: ``diverse_population`` /
  ``headline_population`` (``generators/``, drawn from
  ``torch.Generator``s, d = 2 and 3), ``MLTrainingPipeline.
  generate_diverse_dataset_batched`` (a population drawn and analysed
  in one pass), ``ic_feature_frame`` (the pre-integration features, no
  integration) and ``StabilityPredictor`` (``ml/``: the headline MLP
  and GBDT read from ``data/headline_pre_torch.npz`` with numpy alone);
* the 3-D product path: ``analyze_population`` at d = 3 (the analysis,
  MEGNO and eps kernels take d = 3), ``ic_feature_frame`` at d = 3 and
  the 3-D headline models (``data/headline3d_pre_torch.npz``).

Entry points run on the current CUDA device unless the caller passes
``device="cpu"`` (the generators draw from a ``torch.Generator`` on that
device); the batched-integration functions run where their tensors lie.
"""

from .analysis.batch import analyze_population, ic_feature_frame
from .core.config import SimConfig
from .core.state import DynParams, SimState, state_from_numpy
from .generators.pipeline import (MLTrainingPipeline, diverse_population,
                                  headline_population)
from .integrators.largen import largen_rollout
from .ml.predict import StabilityPredictor
from .ops.batch_kernels import verlet_multistep, yoshida4_multistep
from .ops.hamsoft_kernels import hamsoft_multistep
from .ops.whfast_kernels import whfast_multistep
from .parallel.batch_engine import build_batch, integrate_batch, step_batch

__all__ = ["SimConfig", "SimState", "DynParams", "state_from_numpy",
           "analyze_population", "build_batch", "integrate_batch",
           "step_batch", "verlet_multistep", "yoshida4_multistep",
           "hamsoft_multistep", "whfast_multistep", "largen_rollout",
           "diverse_population", "headline_population", "MLTrainingPipeline",
           "ic_feature_frame", "StabilityPredictor"]
