"""PyTorch port vs the JAX package: the facade ``NBodySimulation`` in
float64 on the CPU at d = 3 (``SimConfig(dim=3)``; the systems of
``tests/torch_facade.py`` with a drawn z column), under the scenarios
and to the tolerance (relative 1e-12, absolute 1e-12) of
``test_torch_facade_float64.py``, and the Jacobi transforms there.
"""

import numpy as np
import pytest

from torch_facade import SCENARIOS, check_scenario, make_pair


@pytest.mark.parametrize("label", sorted(SCENARIOS))
def test_step_run_and_diagnostics_match_3d(label):
    check_scenario(label, 3)


@pytest.mark.parametrize("d", [2, 3])
def test_jacobi_transforms_match(d):
    sj, st = make_pair("whfast", d)
    jj, tj = sj.to_jacobi(), st.to_jacobi()
    for a, b in zip(jj, tj):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15)
    back_j, back_t = sj.from_jacobi(*jj), st.from_jacobi(*tj)
    for a, b in zip(back_j, back_t):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(back_t[0], st.pos, rtol=1e-12, atol=1e-14)
