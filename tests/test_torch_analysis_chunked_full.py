"""The ``use_fused_metrics=False`` engine in full mode: the port against
the JAX package's same branch (interpret mode), and against its own
``use_fused_metrics=True`` engine, on the population and with the
tolerances of ``tests/test_torch_analysis_chunked.py``."""

import test_torch_analysis_chunked as base


def test_chunked_full_mode_matches_jax_and_fused_metrics():
    ref, got = base._run_both({}, "full", 6, flags=(False, True))
    base._assert_columns(ref, got[False])
    base._assert_columns(got[True], got[False])
