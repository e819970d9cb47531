"""PyTorch port vs the JAX package: the fused analysis engine under the
reflection policy and the "reference" eps* gradient, and the
configurations it covers.

* ``analysis/fused.py::analyze_batch_fused`` on the CPU (the plain
  versions of the analysis and MEGNO kernels, ``use_fused_metrics`` on)
  against the JAX package's ``analyze_batch_fused(interpret=True)`` under
  ``use_soft_barrier=False`` and under ``eps_grad_mode="reference"``, in
  core mode here and in full mode in
  ``tests/test_torch_engine_variants_reflection.py`` and
  ``..._reference.py`` (each file under a minute), on the N = 3
  population of ``tests/test_torch_hamsoft_kernels.py`` (12 steps, 6
  MEGNO steps, the JAX ``init_tangent`` draws): every column within
  ``TestHamsoftAnalysisFusedEngine._TOL`` of ``tests/test_pallas_batch.py``
  (copied in ``tests/test_torch_hamsoft_kernels.py``), as that class's
  ``test_core_mode_parity_reflection_policy`` and
  ``test_core_mode_parity_reference_grads`` hold the JAX engine to its
  scan.
* ``fused_config_covered`` against the conditions of the JAX package's
  ``fused_path_applicable`` but its device and lane tests, over a grid
  of configurations: the port covers what the JAX fused engine covers,
  in full mode with the MEGNO kernel or, ``use_fused_megno=False``, the
  MEGNO scan after the analysis kernel.
"""

import itertools

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.analysis.fused import (analyze_batch_fused,
                                                      fused_config_covered)

import test_torch_hamsoft_kernels as base
from test_torch_analysis_chunked import _assert_columns, _port_states

T_STEPS, MEGNO_STEPS = 12, 6


def run_both(cfg_kw, mode):
    """(JAX columns, port columns) of the fused engine on the N = 3
    population under ``cfg_kw``, ``use_fused_metrics`` on."""
    import jax.numpy as jnp

    from nbodysimproject_tpu.analysis.fused import (
        analyze_batch_fused as jax_fused)

    cfg_j, states, dyns, keys, tan = base._population(n=3, masked=False)
    cfg_j = cfg_j.replace(use_fused_analysis=True, use_fused_metrics=True,
                          **cfg_kw)
    nsm = int(np.asarray(dyns.n_sub).max())
    B = states.pos.shape[0]
    megno = MEGNO_STEPS if mode == "full" else 0
    ref, _ = jax_fused(states, dyns, cfg_j, keys, T_STEPS, jnp.float32(0.01),
                       mode, nsm, megno, lanes=B // 8, g_static=1.0,
                       interpret=True)
    st, dy = _port_states(states, dyns)
    cfg_t = nt.SimConfig(fast_float32=True, use_fused_analysis=True,
                         use_fused_metrics=True, **cfg_kw)
    assert fused_config_covered(cfg_t, mode, torch.float32)
    got, _ = analyze_batch_fused(st, dy, cfg_t, T_STEPS, 0.01, mode, nsm,
                                 megno, tangent=(base._t(tan[0]),
                                                 base._t(tan[1])))
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


BRANCHES = {"reflection": dict(use_soft_barrier=False),
            "reference": dict(eps_grad_mode="reference")}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_fused_engine_core_mode_matches_jax(branch):
    ref, got = run_both(BRANCHES[branch], "core")
    _assert_columns(ref, got)


def _jax_conditions(cfg_kw, mode, dtype, monkeypatch):
    """``fused_path_applicable`` of the JAX package with its device test
    passed (a stand-in TPU device) and a whole number of lane tiles."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.analysis.fused import fused_path_applicable

    class _Tpu:
        platform = "tpu"

    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_Tpu()])
    cfg = nb.SimConfig(**cfg_kw)
    return fused_path_applicable(cfg, mode, 2048, {
        torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype])


GRID = {
    "integrator_mode": ("ham_soft", "verlet"),
    "use_soft_barrier": (True, False),
    "disable_barrier": (False, True),
    "eps_grad_mode": ("exact", "reference"),
    "use_fused_megno": (True, False),
}
FLAGS = ("use_legacy_eps_star", "fixed_eps_star", "freeze_s_subsystem",
         "_validate_S_only")


def test_covered_configs_match_the_jax_fused_engine(monkeypatch):
    seen = {True: 0, False: 0}
    for values in itertools.product(*GRID.values()):
        base_kw = dict(zip(GRID, values), use_fused_analysis=True)
        for flag in (None,) + FLAGS:
            kw = dict(base_kw, **({flag: True} if flag else {}))
            for mode in ("core", "full", "minimal"):
                for dtype in (torch.float32, torch.float64):
                    jax_ok = _jax_conditions(kw, mode, dtype, monkeypatch)
                    want = jax_ok
                    got = fused_config_covered(nt.SimConfig(**kw), mode,
                                               dtype)
                    assert got == want, (kw, mode, dtype)
                    seen[got] += 1
    kw = dict(use_fused_analysis=False)
    assert not fused_config_covered(nt.SimConfig(**kw), "core",
                                    torch.float32)
    assert seen[True] and seen[False]
