"""The port stands alone: no module of ``nbodysimproject_tpu_torch`` and
not ``chip_smoke.py`` imports JAX or the JAX package.

Checked by walking each source's import statements (``import x``,
``from x import y``, and ``importlib.import_module``/``__import__``
calls with a literal name), so a lazy import inside a function counts
too.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nbodysimproject_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nbodysimproject_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out.extend(os.path.join(root, f) for f in sorted(files)
                   if f.endswith(".py"))
    return sorted(out)


def _imported_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                yield node.args[0].value


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    assert os.path.exists(path), path
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_forbidden_matches_only_the_jax_package():
    assert _forbidden("jax.numpy") and _forbidden("nbodysimproject_tpu.ops")
    assert not _forbidden("nbodysimproject_tpu_torch.ops")
    assert not _forbidden("torch")


def test_walk_covers_the_batched_slice_modules():
    """The modules of the batched-integration slice are among the
    sources checked above."""
    names = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("integrators/classical.py", "integrators/step.py",
                "integrators/hamsoft.py", "parallel/batch_engine.py",
                "diagnostics/metrics.py", "ops/reflection.py",
                "ops/cuda_build.py", "ops/eps_kernels.py",
                "ops/batch_kernels.py", "ops/hamsoft_kernels.py"):
        assert mod in names, mod


def test_walk_covers_the_kepler_slice_modules():
    """The modules of the Kepler slice (WHFast, the Kepler-split tail
    and the scan analysis engine) are among the sources checked above."""
    names = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("ops/kepler.py", "ops/whfast_kernels.py",
                "integrators/whfast.py", "integrators/kepler_split.py",
                "diagnostics/tangent.py", "diagnostics/megno.py",
                "analysis/stability.py", "analysis/batch.py"):
        assert mod in names, mod


def test_walk_covers_the_large_n_slice_modules():
    """The modules of the large-N slice (the tiled force kernel's
    wrapper, P3M and the rollouts) are among the sources checked above."""
    names = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("ops/force_kernels.py", "ops/pm_force.py", "ops/forces.py",
                "integrators/largen.py", "integrators/whfast.py"):
        assert mod in names, mod


def test_walk_covers_the_generator_and_serving_modules():
    """The generators' and the serving path's modules are among the
    sources checked above (the predictor must load without flax)."""
    names = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("generators/ic_generator.py", "generators/specialized.py",
                "generators/pipeline.py", "ml/artifacts.py", "ml/gbdt.py",
                "ml/predict.py", "ml/model_zoo.py", "ml/dataset.py",
                "ml/data_utils.py", "ml/calibrate.py", "utils/seeding.py"):
        assert mod in names, mod


def test_walk_covers_the_facade_modules():
    """The object API's modules (the facade, its analyzers, the
    validators, probes, evolution features and the flow-map API) are
    among the sources checked above."""
    names = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("facade/__init__.py", "facade/simulation.py",
                "facade/body.py", "facade/compat.py", "core/validation.py",
                "diagnostics/validation.py", "diagnostics/probes.py",
                "diagnostics/evolution.py", "integrators/flows_api.py",
                "analysis/stability.py", "analysis/batch.py"):
        assert mod in names, mod


def test_walk_covers_the_training_and_scale_out_modules():
    """The dataset-to-classifier path's modules (the trainers, the
    calibration fits, the process-sharded generation, the mesh helpers,
    checkpoints and the accumulator) are among the sources checked
    above: training and scale-out need no JAX either."""
    names = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("ml/train_mlp.py", "ml/train_lightgbm.py",
                "ml/calibrate.py", "ml/data_utils.py", "ml/model_zoo.py",
                "ml/artifacts.py", "parallel/distributed.py",
                "parallel/mesh.py", "utils/checkpoint.py",
                "utils/accumulator.py", "utils/summation.py"):
        assert mod in names, mod
