"""PyTorch port vs the JAX package: the fused analysis engine in full
mode under the reflection policy (``use_soft_barrier=False``),
as ``tests/test_torch_engine_variants.py`` holds it in core mode (the
same population, horizon and tolerances:
``TestHamsoftAnalysisFusedEngine._TOL`` of ``tests/test_pallas_batch.py``)."""

from test_torch_analysis_chunked import _assert_columns
from test_torch_engine_variants import BRANCHES, run_both


def test_fused_engine_full_mode_matches_jax():
    ref, got = run_both(BRANCHES["reflection"], "full")
    _assert_columns(ref, got)
