"""PyTorch port vs the JAX package: the ham_soft analysis kernel's other
branches with a masked slot.

The plain PyTorch version of ``hamsoft_analysis_multistep`` (on the CPU)
is held in float32 against the JAX Pallas kernel run with
``interpret=True`` under the reflection policy and the "reference" eps*
gradient, on ``tests/test_torch_hamsoft_kernels.py``'s N = 4 population
with its last slot masked (d = 2); the reference's fallback is shown to
fire.  8 analysis steps, a sample every 2; the tolerances of
``tests/test_torch_kernel_variants.py`` (the final state
``tests/test_hamsoft_variants.py::_assert_parity``'s).  The d = 3 case is
in ``tests/test_torch_kernel_variants_3d.py``, the MEGNO kernel's masked
case in ``tests/test_torch_kernel_variants_megno_masked.py``.
"""

import numpy as np
import pytest

import test_torch_hamsoft_kernels as base
from test_torch_kernel_variants import POPULATIONS, check_analysis_variant


@pytest.mark.parametrize("case,policy,grad_mode", [
    ("n4_masked", "reflection", "reference")])
def test_analysis_variant_masked(case, policy, grad_mode):
    pop = POPULATIONS[case]()
    assert not np.asarray(pop[1].mask)[:, -1].any()
    check_analysis_variant(pop, case, policy, grad_mode, base._lz(pop[1]))
