"""PyTorch port vs the JAX package: the facade's analyzers on the CPU.

* ``StabilityAnalyzer.run_stability_analysis`` in modes "minimal",
  "core" and "full" (float64 at d = 2, full mode at d = 3 for verlet
  and ham_soft; fast mode at d = 2, minimal and full), the
  port given the JAX package's MEGNO tangents (``init_tangent`` of its
  key): every column to round-off in float64 (``torch_scan_route.
  F64_TOL``, relative 1e-9 / absolute 1e-12, the scan route's float64
  tolerance), and in float32 within the fused-vs-scan ``_TOL`` with
  is_stable equal.
* The alternate paths ``_run_core_analysis`` / ``_run_full_analysis``
  (10 crossing times, the escape fraction) in float64, the port given
  the tangents of the JAX key's first split.

``test_torch_facade_batch.py`` holds ``BatchStabilityAnalyzer`` and the
sim-list views.
"""

import numpy as np
import pytest

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
import torch_scan_route as sr
from test_torch_hamsoft_kernels import _TOL
from torch_facade import jax_tangent, make_pair

STEPS = 20


def _close_dicts(ref, got, tol, what=""):
    assert list(got) == list(ref), what
    for k, a in ref.items():
        b = got[k]
        if isinstance(a, str):
            assert a == b, (what, k)
            continue
        if k == "is_stable":
            assert a == b, (what, k)
            continue
        rt, at = tol.get(k, tol["energy_drift"]) if isinstance(tol, dict) \
            else tol
        if k.startswith("initial_") and isinstance(tol, dict):
            rt, at = 1e-5, 1e-6
        np.testing.assert_allclose(b, a, rtol=rt, atol=at,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("label, d, fast, mode", [
    ("ham_soft", 2, False, "minimal"), ("ham_soft", 2, False, "core"),
    ("ham_soft", 2, False, "full"), ("verlet", 3, False, "full"),
    ("ham_soft", 3, False, "full"), ("ham_soft", 2, True, "minimal"),
    ("ham_soft", 2, True, "full")])
def test_stability_analyzer_matches(label, d, fast, mode):
    sj, st = make_pair(label, d, fast=fast)
    ref = nb.StabilityAnalyzer(sj, n_steps=STEPS, dt=0.01, mode=mode,
                               seed=3).run_stability_analysis()
    dtype = np.float32 if fast else np.float64
    got = nt.StabilityAnalyzer(st, n_steps=STEPS, dt=0.01, mode=mode,
                               tangent=jax_tangent(sj, 3, dtype)
                               ).run_stability_analysis()
    _close_dicts(ref, got, _TOL if fast else sr.F64_TOL,
                 f"{label} d={d} {mode}")
    # the analyzer works on a copy: the simulation did not move
    np.testing.assert_array_equal(st.pos, make_pair(label, d, fast=fast)[1]
                                  .pos)


def test_alternate_paths_match():
    import jax

    sj, st = make_pair("verlet_no_corrector")
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    from nbodysimproject_tpu.diagnostics.megno import init_tangent

    tan = tuple(np.asarray(a) for a in init_tangent(key, sj._state))
    aj = nb.StabilityAnalyzer(sj, n_steps=50, dt=0.01, mode="full")
    at = nt.StabilityAnalyzer(st, n_steps=50, dt=0.01, mode="full",
                              tangent=tan)
    ref, got = aj._run_full_analysis(), at._run_full_analysis()
    _close_dicts(ref, got, sr.F64_TOL, "full path")
    assert ref["n_steps"] > 50
    for f in ("_compute_virial_radius", "_quick_virial_radius",
              "_crossing_time", "_energy_drift_tolerance"):
        np.testing.assert_allclose(getattr(at, f)(), getattr(aj, f)(),
                                   rtol=1e-12)
    assert at.serialize_to_dict(got) == pytest.approx(
        aj.serialize_to_dict(got))
