"""PyTorch port vs the JAX package: the ham_soft analysis kernel's other
branches at d = 3.

The plain PyTorch version of ``hamsoft_analysis_multistep`` (on the CPU)
is held in float32 against the JAX Pallas kernel run with
``interpret=True`` under the reflection policy and the "reference" eps*
gradient, on ``tests/test_torch_d3_variants.py``'s N = 3 population at
d = 3 (L0 the angular momentum vector); the reference's fallback is
shown to fire.  8 analysis steps, a sample every 2; the tolerances of
``tests/test_torch_kernel_variants.py``.
"""

import importlib

import numpy as np
import pytest

from test_torch_d3_variants import _population_3d
from test_torch_kernel_variants import check_analysis_variant

JE = importlib.import_module("nbodysimproject_tpu.diagnostics.energy")


@pytest.mark.parametrize("policy,grad_mode", [("reflection", "reference")])
def test_analysis_variant_3d(policy, grad_mode):
    import jax

    pop = _population_3d()
    L0 = np.asarray(jax.vmap(JE.angular_momentum_vector)(pop[1]))
    assert L0.shape == (16, 3)
    check_analysis_variant(pop, "d3", policy, grad_mode, L0)
