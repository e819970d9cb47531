"""PyTorch port vs the JAX package: the ham_soft MEGNO kernel's other
branches, the reflection and no-barrier policies and the "reference" eps*
gradient.

The plain PyTorch version of ``hamsoft_megno_multistep`` (on the CPU) is
held in float32 against the JAX Pallas kernel run with
``interpret=True`` (6 MEGNO steps, the JAX ``init_tangent`` draws) on N = 3
and on the saturated geometry of
``tests/test_torch_kernel_variants.py``: the final state to
``tests/test_hamsoft_variants.py::_assert_parity``'s tolerances, the MEGNO
summaries within the fused-vs-scan ``_TOL`` of
``tests/test_torch_hamsoft_kernels.py``.  N = 4 with its last slot masked
is in ``tests/test_torch_kernel_variants_megno_masked.py``.
"""

import numpy as np
import pytest

from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk

import test_torch_hamsoft_kernels as base
from test_torch_kernel_variants import (POPULATIONS, fallback_taken,
                                        state_close)


def check_megno_variant(case, policy, grad_mode):
    """The plain MEGNO kernel against the JAX Pallas kernel in interpret
    mode on ``POPULATIONS[case]`` under ``policy`` and ``grad_mode``;
    where the reference's fallback runs, it is shown to fire."""
    from nbodysimproject_tpu.ops.pallas_hamsoft import (
        hamsoft_megno_multistep as jax_megno)

    pop = POPULATIONS[case]()
    cfg, states, dyns, _keys, (dr0, dv0) = pop
    kw = base._kernel_kw(cfg, dyns)
    B = states.pos.shape[0]
    dt = np.float32(0.01)
    ref = jax_megno(states.pos, states.vel, states.mass, states.eps,
                    states.pi, dr0, dv0, dt=dt, n_steps=6, lanes=B // 8,
                    interpret=True, policy=policy, grad_mode=grad_mode,
                    lam_align=0.3, **kw)
    got = hk.hamsoft_megno_multistep(
        base._t(states.pos), base._t(states.vel), base._t(states.mass),
        base._t(states.eps), base._t(states.pi), base._t(dr0), base._t(dv0),
        dt=float(dt), n_steps=6, policy=policy, grad_mode=grad_mode,
        lam_align=0.3, **base._torch_kw(kw))
    state_close(ref[:4], got[:4], f"{case} {policy} {grad_mode}")
    for name, a, b in zip(("MEGNO", "lyapunov_time", "megno_slope_med"),
                          ref[4:], got[4:]):
        base._close(a, b, name, *base._TOL[name])
    if grad_mode == "reference":
        assert fallback_taken(pop).any()


@pytest.mark.parametrize("case,policy,grad_mode", [
    ("n3", "reflection", "exact"), ("saturated", "none", "reference")])
def test_megno_variant_matches_pallas_interpret(case, policy, grad_mode):
    check_megno_variant(case, policy, grad_mode)
