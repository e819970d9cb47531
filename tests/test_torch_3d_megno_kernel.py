"""PyTorch port vs the JAX package at d = 3: the plain version of the
MEGNO kernel against the JAX Pallas kernel in interpret mode, on the
CPU, in float32, on the populations of ``tests/test_torch_3d_kernels.py``
(N = 3, and N = 4 with a masked slot, B = 16, the JAX package's MEGNO
tangents), 20 MEGNO steps: the final pos, vel, eps and pi to rtol 1e-4 /
atol 1e-5, the MEGNO summaries within the fused-vs-scan ``_TOL`` of
``tests/test_pallas_batch.py::TestHamsoftAnalysisFusedEngine``.
"""

import numpy as np
import pytest

from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
from test_torch_3d_kernels import CASES, MEGNO_T, _population
from test_torch_hamsoft_kernels import (_TOL, _close, _kernel_kw, _t,
                                        _torch_kw)


@pytest.fixture(scope="module", params=sorted(CASES))
def pop(request):
    return _population(**CASES[request.param])


def test_megno_plain_matches_pallas_interpret_3d(pop):
    from nbodysimproject_tpu.ops.pallas_hamsoft import (
        hamsoft_megno_multistep as jax_megno)

    cfg, states, dyns, _keys, (dr0, dv0) = pop
    kw = _kernel_kw(cfg, dyns)
    B = states.pos.shape[0]
    dt = np.float32(0.01)
    ref = jax_megno(states.pos, states.vel, states.mass, states.eps,
                    states.pi, dr0, dv0, dt=dt, n_steps=MEGNO_T,
                    lanes=B // 8, interpret=True, **kw)
    got = hk.hamsoft_megno_multistep(
        _t(states.pos), _t(states.vel), _t(states.mass), _t(states.eps),
        _t(states.pi), _t(dr0), _t(dv0), dt=float(dt), n_steps=MEGNO_T,
        **_torch_kw(kw))
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, name)
    for name, a, b in zip(("MEGNO", "lyapunov_time", "megno_slope_med"),
                          ref[4:], got[4:]):
        _close(a, b, name, *_TOL[name])
