"""PyTorch port vs the JAX package: the ham_soft MEGNO kernel.

The plain PyTorch version of ``hamsoft_megno_multistep`` is held in
float32 against the JAX Pallas kernel run with ``interpret=True``
(6 MEGNO steps, the JAX ``init_tangent`` draws), on the populations and
with the tolerances of ``tests/test_torch_hamsoft_kernels.py``: the raw
state to rtol 1e-4 / atol 1e-5, the MEGNO summaries within the
fused-vs-scan ``_TOL``.
"""

import numpy as np
import pytest

from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
from test_torch_hamsoft_kernels import (CASES, _TOL, _close, _kernel_kw,
                                        _population, _t, _torch_kw)


@pytest.fixture(scope="module", params=sorted(CASES))
def pop(request):
    return _population(**CASES[request.param])


def test_megno_plain_matches_pallas_interpret(pop):
    from nbodysimproject_tpu.ops.pallas_hamsoft import (
        hamsoft_megno_multistep as jax_megno)

    cfg, states, dyns, _keys, (dr0, dv0) = pop
    kw = _kernel_kw(cfg, dyns)
    B = states.pos.shape[0]
    dt = np.float32(0.01)
    ref = jax_megno(states.pos, states.vel, states.mass, states.eps,
                    states.pi, dr0, dv0, dt=dt, n_steps=6, lanes=B // 8,
                    interpret=True, **kw)
    got = hk.hamsoft_megno_multistep(
        _t(states.pos), _t(states.vel), _t(states.mass), _t(states.eps),
        _t(states.pi), _t(dr0), _t(dv0), dt=float(dt), n_steps=6,
        **_torch_kw(kw))
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, name)
    for name, a, b in zip(("MEGNO", "lyapunov_time", "megno_slope_med"),
                          ref[4:], got[4:]):
        _close(a, b, name, *_TOL[name])
