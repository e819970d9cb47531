"""PyTorch port vs the JAX package: ``analyze_population`` on the scan
route in float32, for the ham_soft configurations outside the fused
engine.

On ``tests/torch_scan_route.py``'s synthetic population (B = 16, N = 3,
12 steps, the JAX tangents), under the dataset pipeline's configuration
(tail off) with one change each, against the JAX package's
``analyze_population`` on the CPU:

* the legacy eps* (``use_legacy_eps_star``) with per-system G drawn
  from a seeded numpy generator in [0.9, 1.1] (either alone sends every
  lane to the scan engine; one run holds both, to keep the JAX compiles
  few);
* the fixed eps* (``fixed_eps_star``);
* ``freeze_s_subsystem`` (no spring flow, no SPH solve).

``is_stable`` agrees row by row, the analysis columns within the
fused-vs-scan ``_TOL`` of ``tests/test_pallas_batch.py`` (float32
trajectory noise), the ``initial_*`` features within rtol 1e-5 / atol
1e-6, the IC, schedule and tag columns exactly.  The masked-slot rule:
the same systems in 4 slots with the last masked are held to the JAX
run on 3 slots within the same ``_TOL`` (the JAX scan zeroes the eps*
gradient of a system with a zero-mass slot, ROADMAP.md Queue 3; here the
gradient is 0 anyway, eps* sitting at its clamp, and
``tests/test_torch_scan_route_masked.py`` shows the difference where it
is not).

A fault found on this route and fixed: the substep loop's masked trips
(``integrators/step.py::_select``) took the (eps*, grad) cache apart
field by field, and ``freeze_s_subsystem`` carries none, so any system
with n_sub > 1 raised.
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu_torch as nt
import torch_scan_route as sr
from test_torch_hamsoft_kernels import _TOL

G_ROWS = np.random.default_rng(11).uniform(0.9, 1.1, 16)
CONFIGS = {
    "legacy_eps_star_per_system_G": (dict(use_legacy_eps_star=True), G_ROWS),
    "fixed_eps_star": (dict(fixed_eps_star=True), 1.0),
    "freeze_s_subsystem": (dict(freeze_s_subsystem=True), 1.0),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def frames(request):
    cfg_kw, G = CONFIGS[request.param]
    pop = sr.synthetic()
    ref = sr.run_jax(pop, cfg_kw, G=G)
    tangent = sr.jax_tangents(pop, cfg_kw)
    tm = {}
    got = sr.run_port(pop, cfg_kw, tangent, G=G, timing_out=tm)
    return cfg_kw, G, tangent, ref, got, tm


def test_runs_the_scan_engine(frames):
    *_rest, tm = frames
    assert tm["engine"] == "scan" and tm["scan_lanes"] == 16


def test_analysis_columns(frames):
    _kw, _G, _tan, ref, got, _tm = frames
    assert got["energy_drift"].dtype == np.float32
    sr.assert_analysis_columns(ref, got, _TOL)


def test_other_columns(frames):
    _kw, G, _tan, ref, got, _tm = frames
    sr.assert_other_columns(ref, got, 1e-5, 1e-6)
    np.testing.assert_array_equal(got["G"].to_numpy(),
                                  np.broadcast_to(G, 16))


def test_masked_slot_held_to_the_unmasked_jax_run(frames):
    cfg_kw, G, tangent, ref, _got, _tm = frames
    got4 = sr.run_port(sr.masked(), cfg_kw, sr.pad_tangents(tangent, 4),
                       G=G)
    sr.assert_analysis_columns(ref, got4, _TOL)


def test_freeze_s_subsystem_takes_masked_trips():
    """Systems at n_sub 1 and 3 in one batch under freeze_s_subsystem:
    the masked trips run (they raised before), the n_sub = 1 system's
    step equals its step alone, and eps and pi stay frozen."""
    from nbodysimproject_tpu_torch.integrators.step import (
        macro_step, macro_step_dynamic)

    cfg = nt.SimConfig(fast_float32=False, freeze_s_subsystem=True)
    m, q, v, mask = (torch.as_tensor(a) for a in sr.synthetic())
    st, dy = nt.build_batch(m[:2].double(), q[:2], v[:2], mask[:2], cfg,
                            torch.ones(2, dtype=torch.float64),
                            torch.full((2,), 5e-2, dtype=torch.float64),
                            torch.zeros(2, dtype=torch.float64), 0.01)
    dy = dy.replace(n_sub=torch.tensor([1, 3], dtype=torch.int32))
    out = macro_step_dynamic(st, dy, cfg, 0.01, 3)
    one = macro_step(st, dy, cfg, 0.01, 1)
    torch.testing.assert_close(out.pos[0], one.pos[0], rtol=0, atol=0)
    torch.testing.assert_close(out.eps, st.eps, rtol=0, atol=0)
    torch.testing.assert_close(out.pi, st.pi, rtol=0, atol=0)
    assert not torch.equal(out.pos[1], one.pos[1])
