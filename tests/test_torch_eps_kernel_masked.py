"""PyTorch port vs the JAX package: the eps kernel's plain version on 8
slots holding 5 bodies (masked slots carry mass 0 inside the kernel),
against the JAX Pallas kernel in interpret mode, float32, with the soft
policy's value clamp (saturating on 4 lanes).

Inputs and tolerances are those of ``tests/test_torch_eps_kernel.py``
(rtol 1e-6 on eps*, rtol 1e-5 / atol 1e-5 on the gradient); this case
has a file of its own because the interpret-mode kernel at N = 8 takes
about half a minute to trace.
"""

import test_torch_eps_kernel as base


def test_fused_plain_matches_pallas_interpret_masked_8_slots():
    base.test_fused_plain_matches_pallas_interpret("n8_masked5", True)
