"""PyTorch port vs the JAX package: the facade ``NBodySimulation`` in
fast mode (``SimConfig(fast_float32=True)``, float32) on the CPU, at
d = 2 (``test_torch_facade_float32_3d.py``: d = 3).

The scenarios of ``tests/torch_facade.py``, built by both packages from
the same numpy inputs, three ``step(0.01)`` calls and ``run(0.01, 10)``:
positions, velocities, eps, pi, ``accelerations()`` and every
``Diagnostics`` quantity agree within ``torch_facade.TOL32``, the
float32 tolerances of ``tests/test_torch_integrate.py`` (pos rtol 2e-5 /
atol 2e-6, vel 2e-5 / 2e-5, eps 1e-5 / 1e-6, pi 1e-3 / 5e-5; the
position tolerance also for the accelerations and the diagnostics): the
same operations in other reduction orders.  The state stays float32.
"""

import numpy as np
import pytest

from torch_facade import SCENARIOS, TOL32, assert_sims_close, make_pair


def check_fast(label, d):
    sj, st = make_pair(label, d, fast=True)
    assert st._state.pos.dtype.itemsize == 4 and st.pos.dtype == np.float32
    assert_sims_close(sj, st, TOL32, f"{label} d={d} built", diag=False)
    for _ in range(3):
        sj.step(0.01)
        st.step(0.01)
    sj.run(0.01, 10)
    st.run(0.01, 10)
    assert_sims_close(sj, st, TOL32, f"{label} d={d} run")


@pytest.mark.parametrize("label", sorted(SCENARIOS))
def test_fast_mode_matches(label):
    check_fast(label, 2)
