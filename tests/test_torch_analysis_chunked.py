"""PyTorch port vs the JAX package: the fused engine with
``use_fused_metrics=False`` (the plain multi-step kernel in chunks of
[1, interval, ...] steps, ``step_metrics`` after each, an unsampled
tail).

On the CPU the port's ``analysis/fused.py::analyze_batch_fused`` runs the
plain versions of the kernels; it is held against the JAX package's
``analyze_batch_fused`` on the same branch with its Pallas kernels in
interpret mode, on ``tests/test_torch_hamsoft_kernels.py``'s N = 3
population (B = 16, float32, 12 steps, interval 1), in core mode under
the soft policy here, under the reflection policy in
``tests/test_torch_analysis_chunked_reflection.py`` and in full mode (6
MEGNO steps with the JAX package's tangent draws) in
``tests/test_torch_analysis_chunked_full.py`` (one interpret-mode engine
per file keeps each file's run short).  Tolerance: the fused-vs-scan
``_TOL`` of ``tests/test_pallas_batch.py`` per column, ``is_stable``
exact.  The same population through ``use_fused_metrics=True`` agrees
with the chunked way to the same tolerance, as the JAX package's own
``test_fused_metrics_matches_chunked_sampling`` requires.
"""

import numpy as np
import torch

import test_torch_hamsoft_kernels as base
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.analysis.fused import (analyze_batch_fused,
                                                      fused_config_covered)
from nbodysimproject_tpu_torch.core.state import state_from_numpy

T_STEPS = 12


def _port_states(states, dyns):
    import dataclasses

    arrays = {f.name: np.asarray(getattr(states, f.name))
              for f in dataclasses.fields(states)}
    arrays.update({f.name: np.asarray(getattr(dyns, f.name))
                   for f in dataclasses.fields(dyns)})
    return state_from_numpy(arrays)


def _run_both(cfg_kw, mode, megno_steps, flags=(False,)):
    import jax.numpy as jnp

    from nbodysimproject_tpu.analysis.fused import (
        analyze_batch_fused as jax_fused)

    cfg_j, states, dyns, keys, tan = base._population(n=3, masked=False)
    cfg_j = cfg_j.replace(use_fused_metrics=False, **cfg_kw)
    nsm = int(np.asarray(dyns.n_sub).max())
    B = states.pos.shape[0]
    ref, _ = jax_fused(states, dyns, cfg_j, keys, T_STEPS, jnp.float32(0.01),
                       mode, nsm, megno_steps, lanes=B // 8, g_static=1.0,
                       interpret=True)
    st, dy = _port_states(states, dyns)
    tangent = (base._t(tan[0]), base._t(tan[1]))
    out = {}
    for flag in flags:
        cfg_t = nt.SimConfig(fast_float32=True, use_fused_analysis=True,
                             use_fused_metrics=flag, **cfg_kw)
        assert fused_config_covered(cfg_t, mode, torch.float32)
        r, _ = analyze_batch_fused(st, dy, cfg_t, T_STEPS, 0.01, mode, nsm,
                                   megno_steps, tangent=tangent)
        out[flag] = {k: v.numpy() for k, v in r.items()}
    return {k: np.asarray(v) for k, v in ref.items()}, out


def _assert_columns(ref, got):
    assert set(ref) == set(got)
    for k in sorted(ref):
        a, b = ref[k], got[k]
        if k == "is_stable":
            np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        rtol, atol = base._TOL[k]
        base._close(a, b, k, rtol=rtol, atol=atol)


def test_chunked_core_mode_matches_jax():
    ref, got = _run_both({}, "core", 0)
    _assert_columns(ref, got[False])


def test_full_mode_needs_the_soft_policy():
    """Full mode once needed the soft policy, then the MEGNO kernel;
    since the analysis and MEGNO kernels take every policy and the MEGNO
    scan continues after the analysis kernel, it needs neither, with
    either ``use_fused_metrics``."""
    cfg = nt.SimConfig(fast_float32=True, use_fused_analysis=True,
                       use_fused_metrics=False, use_soft_barrier=False)
    for fused_metrics in (False, True):
        c = cfg.replace(use_fused_metrics=fused_metrics)
        assert fused_config_covered(c, "core", torch.float32)
        assert fused_config_covered(c, "full", torch.float32)
        assert fused_config_covered(c.replace(use_fused_megno=False),
                                    "full", torch.float32)
