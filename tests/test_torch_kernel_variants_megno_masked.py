"""PyTorch port vs the JAX package: the ham_soft MEGNO kernel's other
branches with a masked slot.

The plain PyTorch version of ``hamsoft_megno_multistep`` (on the CPU) is
held in float32 against the JAX Pallas kernel run with
``interpret=True`` under the reflection policy and the "reference" eps*
gradient, on ``tests/test_torch_hamsoft_kernels.py``'s N = 4 population
with its last slot masked (d = 2; 6 MEGNO steps, the JAX
``init_tangent`` draws), at the tolerances of
``tests/test_torch_kernel_variants_megno.py``; the reference's fallback
is shown to fire.
"""

import pytest

from test_torch_kernel_variants_megno import check_megno_variant


@pytest.mark.parametrize("case,policy,grad_mode", [
    ("n4_masked", "reflection", "reference")])
def test_megno_variant_masked(case, policy, grad_mode):
    check_megno_variant(case, policy, grad_mode)
