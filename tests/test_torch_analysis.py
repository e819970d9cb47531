"""PyTorch port vs the JAX package: the slice as a whole.

``analyze_population(mode="full", device="cpu")`` of the port (the fused
engine on the kernels' plain versions) against the JAX package's
``analyze_population`` on the CPU (its scan engine), both under the
dataset pipeline's configuration with the tail policy off, on the
populations of ``tests/test_pallas_batch.py`` (B = 16, d = 2, N = 3 and
N = 4 with a masked slot, 12 steps, so 6 MEGNO steps).  The port gets
the JAX package's MEGNO tangents.  ``is_stable`` agrees row by row, the
analysis columns within the fused-vs-scan ``_TOL``, the float32
``initial_*`` features to rtol 1e-5 / atol 1e-6 (summation order only),
and the IC and schedule columns exactly.
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from test_torch_hamsoft_kernels import _TOL

PIPE = dict(slot_bucket=8, fast_float32=True, analysis_n_sub_cap=256,
            use_fused_analysis=True, analysis_group_quantum=1024,
            analysis_tail_policy="off")
T = 12
CASES = {"n3": dict(n=3, masked=False), "n4_masked": dict(n=4, masked=True)}


def _raw_population(n, masked, B=16, d=2, seed=5):
    rng = np.random.default_rng(seed)
    base_q = np.zeros((n, d))
    base_q[1, 0] = 1.0
    base_q[2, 1] = 2.0
    q = base_q[None] + 0.01 * rng.normal(size=(B, n, d))
    m = np.broadcast_to(np.linspace(1.0, 0.2, n), (B, n)).copy()
    v = rng.normal(size=(B, n, d)) * 0.2
    mask = np.ones((B, n), bool)
    if masked:
        mask[:, -1] = False
        m[:, -1] = 0.0
    return m, q, v, mask


def _jax_tangents(m, q, v, mask, cfg, seed=0):
    """The MEGNO tangents the JAX analyze_population draws (per-system
    keys from the global system id)."""
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.diagnostics.megno import init_tangent
    from nbodysimproject_tpu.parallel.batch_engine import build_batch

    f = lambda a: jnp.asarray(a, jnp.float32)
    states, _ = build_batch(f(m), f(q), f(v), jnp.asarray(mask), cfg, 1.0,
                            5e-2, 0.0, 0.01)
    B = m.shape[0]
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 i))(
        jnp.arange(B, dtype=jnp.uint32))
    dr0, dv0 = jax.vmap(init_tangent)(keys, states)
    return np.asarray(dr0), np.asarray(dv0)


def _run_port(pop, tangent, **cfg_kw):
    m, q, v, mask = pop
    cfg = nt.SimConfig(**{**PIPE, **cfg_kw})
    return nt.analyze_population(m, q, v, mask, cfg, G=1.0, softening=5e-2,
                                 min_softening=0.0, dt=0.01, n_steps=T,
                                 mode="full", show_progress=False,
                                 device="cpu", tangent=tangent)


@pytest.fixture(scope="module", params=sorted(CASES))
def frames(request):
    from nbodysimproject_tpu.analysis.batch import analyze_population

    pop = _raw_population(**CASES[request.param])
    cfg = nb.SimConfig(**PIPE)
    ref = analyze_population(*pop, cfg, G=1.0, softening=5e-2,
                             min_softening=0.0, dt=0.01, n_steps=T,
                             mode="full", show_progress=False)
    tangent = _jax_tangents(*pop, cfg)
    return pop, tangent, ref, _run_port(pop, tangent)


def test_same_columns(frames):
    _pop, _tan, ref, got = frames
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref)


def test_is_stable_row_by_row(frames):
    _pop, _tan, ref, got = frames
    np.testing.assert_array_equal(got["is_stable"].to_numpy(),
                                  ref["is_stable"].to_numpy())


@pytest.mark.parametrize("col", sorted(set(_TOL) - {"is_stable"}))
def test_analysis_column(frames, col):
    _pop, _tan, ref, got = frames
    a = ref[col].to_numpy(np.float64)
    b = got[col].to_numpy(np.float64)
    fin = np.isfinite(a)
    np.testing.assert_array_equal(np.isfinite(b), fin, err_msg=col)
    rtol, atol = _TOL[col]
    np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=atol,
                               err_msg=col)


def test_initial_features(frames):
    """float32 features to rtol 1e-5 / atol 1e-6.  The softening std of
    a one-entry history is the square root of the cancellation residue
    of sumsq/n - mean^2, so it is held to sqrt(float32 eps) times the
    softening mean instead."""
    _pop, _tan, ref, got = frames
    cols = [c for c in ref.columns if c.startswith("initial_")]
    assert len(cols) == 25
    for c in cols:
        a = ref[c].to_numpy(np.float64)
        b = got[c].to_numpy(np.float64)
        atol = 1e-6
        if c == "initial_softening_std":
            atol = np.sqrt(np.finfo(np.float32).eps) \
                * ref["initial_softening_mean"].to_numpy().max()
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=atol, err_msg=c)


def test_ic_and_schedule_columns_exact(frames):
    _pop, _tan, ref, got = frames
    cols = [c for c in ref.columns
            if not c.startswith("initial_") and c not in _TOL]
    assert "n_sub" in cols and "mass_0" in cols
    for c in cols:
        np.testing.assert_array_equal(got[c].to_numpy(), ref[c].to_numpy(),
                                      err_msg=c)


def test_group_quantum_is_scheduling_only(frames):
    """analysis_group_quantum=1024 and 0 give bitwise-identical rows:
    the port's dispatch plan does not depend on the quantum."""
    pop, tangent, _ref, got = frames
    other = _run_port(pop, tangent, analysis_group_quantum=0)
    for c in got.columns:
        np.testing.assert_array_equal(other[c].to_numpy(),
                                      got[c].to_numpy(), err_msg=c)


def test_default_tangents_are_chunk_independent(frames):
    """Without tangents the draws come from ``seed`` and are indexed by
    global system id: a shard analysed with id_offset reproduces the
    rows of the whole population."""
    m, q, v, mask = frames[0]
    cfg = nt.SimConfig(**PIPE)
    kw = dict(G=1.0, softening=5e-2, min_softening=0.0, dt=0.01, n_steps=T,
              mode="full", show_progress=False, device="cpu", seed=3)
    whole = nt.analyze_population(m, q, v, mask, cfg, **kw)
    part = nt.analyze_population(m[8:], q[8:], v[8:], mask[8:], cfg,
                                 id_offset=8, **kw)
    for c in ("MEGNO", "megno_slope_med", "energy_drift"):
        np.testing.assert_array_equal(part[c].to_numpy(),
                                      whole[c].to_numpy()[8:], err_msg=c)


def test_tail_policy_kepler_raises():
    """The Kepler tail policy is ported (tests/test_torch_analysis_tail.py
    holds it to the JAX package), and so is the early-exit probe beside
    it, which once raised here: with the policy on, a population with no
    dominated deep-schedule system runs and carries the tail column, and
    with ``early_exit_probe`` it also carries the ``early_exit`` column
    (no row aborted: every drift is small).  n_steps >= 20 is the least
    horizon the probe runs at."""
    m, q, v, mask = _raw_population(3, False, B=4)
    cfg = nt.SimConfig(**{**PIPE, "analysis_tail_policy": "kepler"})
    df = nt.analyze_population(m, q, v, mask, cfg, n_steps=2, mode="full",
                               show_progress=False, device="cpu")
    assert "tail_fast_path" in df.columns
    assert not df["tail_fast_path"].any()
    tm = {}
    df = nt.analyze_population(
        m, q, v, mask, cfg.replace(early_exit_probe=0.1,
                                   early_exit_min_n_sub=1),
        n_steps=20, mode="full", show_progress=False, device="cpu",
        timing_out=tm)
    assert "early_exit" in df.columns and not df["early_exit"].any()
    assert tm["probe_lanes"] == 4 and tm["n_early_exit"] == 0
    assert np.isfinite(df["MEGNO"]).all()


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_entry_without_gpu_raises(monkeypatch, device):
    """With no card, an entry point asked for the GPU (explicitly or by
    default) raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m, q, v, mask = _raw_population(3, False, B=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.analyze_population(m, q, v, mask, nt.SimConfig(**PIPE),
                              n_steps=2, mode="full", show_progress=False,
                              device=device)


@pytest.mark.parametrize("change", [
    {}, {"use_soft_barrier": False}, {"eps_grad_mode": "reference"},
    {"fast_float32": False}, {"use_fused_analysis": False},
    {"use_fused_metrics": False}, {"use_fused_megno": False}])
def test_fused_path_gate(change):
    """The pipeline's configuration is covered with either way to the
    metric moments (use_fused_metrics True or False), and so are the
    reflection policy, the "reference" gradient and full mode with the
    MEGNO scan in place of the MEGNO kernel (the JAX fused engine's
    configurations); float64 and the scan engine are not, and run the
    scan route (tests/test_torch_scan_route_*.py)."""
    from nbodysimproject_tpu_torch.analysis.fused import fused_config_covered
    from nbodysimproject_tpu_torch.core.device import dtype_of

    cfg = nt.SimConfig(**{**PIPE, **change})
    outside = ({"fast_float32": False}, {"use_fused_analysis": False})
    covered = fused_config_covered(cfg, "full", dtype_of(cfg))
    assert covered == (change not in outside)
    assert fused_config_covered(cfg, "core", dtype_of(cfg)) == (
        change not in outside)
    assert not fused_config_covered(cfg, "minimal", dtype_of(cfg))
