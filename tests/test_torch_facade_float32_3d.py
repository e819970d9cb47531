"""PyTorch port vs the JAX package: the facade in fast mode (float32)
on the CPU at d = 3, under the scenarios and tolerances (TOL32) of
``test_torch_facade_float32.py``.
"""

import pytest

from test_torch_facade_float32 import check_fast
from torch_facade import SCENARIOS


@pytest.mark.parametrize("label", sorted(SCENARIOS))
def test_fast_mode_matches_3d(label):
    check_fast(label, 3)
