"""The ``use_fused_metrics=False`` engine in core mode under the
reflection barrier policy (folds of (eps, pi) in the multi-step kernel):
the port against the JAX package's same branch (interpret mode), on the
population and with the tolerances of
``tests/test_torch_analysis_chunked.py``."""

import test_torch_analysis_chunked as base


def test_chunked_core_mode_reflection_matches_jax():
    ref, got = base._run_both(dict(use_soft_barrier=False), "core", 0)
    base._assert_columns(ref, got[False])
