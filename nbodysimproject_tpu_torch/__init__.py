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
  the 3-D headline models (``data/headline3d_pre_torch.npz``);
* the object API (``facade/``): ``NBodySimulation`` (a one-system batch
  on the batched step functions: a fast-mode ham_soft simulation takes
  the eps kernel on the card, its large-N branch the tiled force
  kernel), its component views and shims, ``Diagnostics``,
  ``StabilityAnalyzer`` / ``BatchStabilityAnalyzer`` on the scan
  engine, the sim-list views of the generators, the validators, probes
  and flow-map API, and the flat namespace below.

Entry points run on the current CUDA device unless the caller passes
``device="cpu"`` (the generators draw from a ``torch.Generator`` on that
device; a simulation and everything built from it run on its device);
the batched-integration functions run where their tensors lie.

* the dataset-to-classifier path: ``parallel/distributed.py``
  (``generate_dataset_sharded`` over ``torch.distributed`` processes,
  the float64 all-reduce of the feature statistics, ``merge_shards``),
  ``parallel/mesh.py`` (``DeviceMesh`` / ``DTensor`` placements), the
  trainers (``MLPTrainer`` on the device, ``train_gbdt`` /
  ``train_lightgbm_main`` on host sklearn, ``DataUtils.split_and_scale``),
  the calibration fits (``ml/calibrate.py``), and ``utils/``
  (``save_checkpoint`` / ``load_checkpoint`` in the JAX package's npz
  layout, ``EnergyAccumulator``).  The JAX package's Orbax checkpoints
  and ``utils/aot_cache.py`` are specific to JAX and not ported.
"""

from .analysis.batch import (BatchStabilityAnalyzer, analyze_population,
                             ic_feature_frame)
from .analysis.stability import StabilityAnalyzer
from .core.config import SimConfig
from .core.constants import CHI_EPS, LAMBDA_SIGMA_STAR, LAMBDA_SOFTENING
from .core.state import DynParams, SimState, build_state, state_from_numpy
from .core.validation import SimulationValidator
from .diagnostics.evolution import EvolutionFeatures
from .diagnostics.features import DynamicalFeatures
from .diagnostics.metrics import Diagnostics
from .diagnostics.tangent import TangentMap
from .diagnostics.validation import validate_ham_soft
from .facade import Body, BodyView, NBodySimulation
from .facade.compat import (HamSoftBarrier, HamSoftParams, HamSoftStepper,
                            IntegratorConstants, SimulationState,
                            TimestepManager)
from .facade.simulation import (HamiltonianSofteningIntegrator, Integrator,
                                SofteningManager)
from .generators import (GeneratorConfig, InitialConditionGenerator,
                         SpecializedGenerators)
from .generators.pipeline import (MLTrainingPipeline, diverse_population,
                                  headline_population)
from .integrators.flows_api import (PhaseState, extended_hamiltonian,
                                    spring_oscillation,
                                    strang_softening_step)
from .integrators.largen import largen_rollout
from .ml import (MLP, DataUtils, MLPTrainer, ScalerUtils, StabilityDataset,
                 make_mlp, train_lightgbm_main)
from .ml.predict import StabilityPredictor
from .ops.barrier import barrier_curvature, barrier_energy, barrier_force
from .ops.batch_kernels import verlet_multistep, yoshida4_multistep
from .ops.forces import (dU_depsilon_plummer, dV_d_epsilon,
                         gravitational_force, pairwise_force,
                         softened_forces)
from .ops.geometry import geometry_buffers, pairwise_geometry
from .ops.hamsoft_kernels import hamsoft_multistep
from .ops.kepler import UniversalVariableKeplerSolver
from .ops.potential import dU_d_eps, softened_potential
from .ops.reflection import (reflect_and_limit_eps, reflect_eps_symplectic,
                             reflect_if_needed, symplectic_bounce,
                             symplectic_reflect_eps)
from .ops.softening import eps_target, grad_eps_target
from .ops.whfast_kernels import whfast_multistep
from .parallel.batch_engine import build_batch, integrate_batch, step_batch
from .utils import (EnergyAccumulator, load_checkpoint, save_checkpoint,
                    set_global_seed)

__all__ = [
    # the reference's names (minbody/__init__.py:81-129)
    "set_global_seed", "SimConfig", "SimulationValidator",
    "SofteningManager", "grad_eps_target", "Body", "BodyView",
    "NBodySimulation", "Integrator", "HamiltonianSofteningIntegrator",
    "UniversalVariableKeplerSolver", "gravitational_force", "dV_d_epsilon",
    "geometry_buffers", "barrier_force", "barrier_energy",
    "barrier_curvature", "symplectic_bounce", "symplectic_reflect_eps",
    "reflect_if_needed", "reflect_eps_symplectic", "reflect_and_limit_eps",
    "dU_depsilon_plummer", "PhaseState", "spring_oscillation",
    "strang_softening_step", "extended_hamiltonian", "LAMBDA_SOFTENING",
    "CHI_EPS", "TangentMap", "Diagnostics", "validate_ham_soft",
    "DynamicalFeatures", "EvolutionFeatures", "StabilityAnalyzer",
    "BatchStabilityAnalyzer", "DataUtils", "ScalerUtils", "StabilityDataset",
    "InitialConditionGenerator", "GeneratorConfig", "SpecializedGenerators",
    "MLTrainingPipeline", "MLP", "make_mlp", "MLPTrainer",
    "train_lightgbm_main",
    # the component name-parity views
    "SimulationState", "IntegratorConstants", "TimestepManager",
    "HamSoftParams", "HamSoftBarrier", "HamSoftStepper", "EnergyAccumulator",
    # the JAX package's additions
    "SimState", "DynParams", "build_state", "save_checkpoint",
    "load_checkpoint", "LAMBDA_SIGMA_STAR",
    "pairwise_geometry", "pairwise_force", "softened_forces",
    "softened_potential", "dU_d_eps", "eps_target",
    # the port's batched entry points
    "state_from_numpy", "analyze_population", "build_batch",
    "integrate_batch", "step_batch", "verlet_multistep",
    "yoshida4_multistep", "hamsoft_multistep", "whfast_multistep",
    "largen_rollout", "diverse_population", "headline_population",
    "ic_feature_frame", "StabilityPredictor"]
