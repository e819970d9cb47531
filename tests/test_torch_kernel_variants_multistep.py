"""PyTorch port vs the JAX package: the plain multi-step ham_soft kernel's
"reference" gradient and d = 3 (row 3).

``hamsoft_multistep``'s plain version (on the CPU) against the JAX Pallas
kernel in interpret mode, float32: the "reference" gradient under the
reflection policy on the saturated geometry of
``tests/test_torch_kernel_variants.py``, and under the no-barrier policy
on N = 4 with a masked slot.  6 macro steps;
``tests/test_hamsoft_variants.py::_assert_parity``'s tolerances.  Row 3
at d = 3 is in ``tests/test_torch_d3_variants.py``.
"""

import numpy as np
import pytest
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk

import test_torch_hamsoft_kernels as base
from test_torch_kernel_variants import POPULATIONS, state_close


@pytest.mark.parametrize("case,policy,grad_mode", [
    ("saturated", "reflection", "reference"),
    ("n4_masked", "none", "reference")])
def test_multistep_variant_matches_pallas_interpret(case, policy, grad_mode):
    from nbodysimproject_tpu.ops.pallas_hamsoft import hamsoft_multistep

    pop = POPULATIONS[case]()
    cfg, states, dyns, _keys, _tan = pop
    kw = base._kernel_kw(cfg, dyns)
    B = states.pos.shape[0]
    ref = hamsoft_multistep(states.pos, states.vel, states.mass, states.eps,
                            states.pi, n_steps=6, lanes=B // 8,
                            interpret=True, policy=policy,
                            grad_mode=grad_mode, lam_align=0.3, **kw)
    got = hk.hamsoft_multistep(
        base._t(states.pos), base._t(states.vel), base._t(states.mass),
        base._t(states.eps), base._t(states.pi), n_steps=6, policy=policy,
        grad_mode=grad_mode, lam_align=0.3, **base._torch_kw(kw))
    state_close(ref, got, f"{case} {policy} {grad_mode}")
