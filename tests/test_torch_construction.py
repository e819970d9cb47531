"""PyTorch port vs the JAX package: construction, energy and features.

The same numpy-seeded populations go through ``build_batch``, the
pi-budget mu raise, ``extended_hamiltonian`` and ``extract_all`` of both
packages in float64 on the CPU; every field and column agrees to
rtol = 1e-10 (both run the same float64 formulas, so only summation
order separates them).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt

RTOL = 1e-10
ATOL = 1e-12

CASES = {
    "n3": dict(n=3, masked=False, seed=0),
    "n4_masked": dict(n=4, masked=True, seed=1),
    "n8_two_masked": dict(n=8, masked=True, seed=2),
}


def _population(n, masked, seed, B=16, d=2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, n, d)) * 1.5
    v = rng.normal(size=(B, n, d)) * 0.4
    m = rng.uniform(0.2, 5.0, size=(B, n))
    mask = np.ones((B, n), bool)
    if masked:
        mask[:, -1] = False
        if n >= 8:
            mask[::2, -2] = False
        m = np.where(mask, m, 0.0)
    soft = rng.uniform(0.01, 0.09, size=B)
    return m, q, v, mask, soft


def _jax_build(pop, cfg, dt=0.01):
    import jax.numpy as jnp

    from nbodysimproject_tpu.parallel.batch_engine import build_batch

    m, q, v, mask, soft = pop
    return build_batch(jnp.asarray(m), jnp.asarray(q), jnp.asarray(v),
                       jnp.asarray(mask), cfg, 1.0, jnp.asarray(soft), 0.0,
                       dt)


def _torch_build(pop, cfg, dt=0.01):
    from nbodysimproject_tpu_torch.parallel.batch_engine import build_batch

    m, q, v, mask, soft = pop
    f = lambda a: torch.as_tensor(a, dtype=torch.float64)
    return build_batch(f(m), f(q), f(v), torch.as_tensor(mask), cfg, 1.0,
                       soft, 0.0, dt)


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_close(a, b, name):
    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request):
    cfg = nb.SimConfig(slot_bucket=8)
    tcfg = nt.SimConfig(slot_bucket=8)
    pop = _population(**CASES[request.param])
    js, jd = _jax_build(pop, cfg)
    ts, td = _torch_build(pop, tcfg)
    return cfg, tcfg, pop, (js, jd), (ts, td)


def test_build_batch_state(built):
    _cfg, _tcfg, _pop, (js, _jd), (ts, _td) = built
    for k, a in _np_fields(js).items():
        _assert_close(a, getattr(ts, k).numpy(), f"state.{k}")


def test_build_batch_dyn(built):
    _cfg, _tcfg, _pop, (_js, jd), (_ts, td) = built
    for k, a in _np_fields(jd).items():
        _assert_close(a, getattr(td, k).numpy(), f"dyn.{k}")


def test_calibrate_mu_from_pi_budget(built):
    import jax.numpy as jnp

    from nbodysimproject_tpu.integrators import calibration as jcal
    from nbodysimproject_tpu_torch.integrators import calibration as tcal

    _cfg, _tcfg, _pop, (_js, jd), (_ts, td) = built
    for dt in (0.01, 0.05):
        ref = jcal.calibrate_mu_from_pi_budget(
            jd.mu_soft, jd.k_soft, jnp.asarray(dt), jnp.asarray(0.5))
        got = tcal.calibrate_mu_from_pi_budget(td.mu_soft, td.k_soft, dt, 0.5)
        _assert_close(ref, got.numpy(), f"mu at dt={dt}")


def test_extended_hamiltonian(built):
    import jax

    JE = importlib.import_module("nbodysimproject_tpu.diagnostics.energy")
    from nbodysimproject_tpu_torch.diagnostics import energy as TE

    cfg, tcfg, _pop, (js, jd), (ts, td) = built
    ref = jax.vmap(lambda s, d: JE.extended_hamiltonian(s, d, cfg))(js, jd)
    _assert_close(ref, TE.extended_hamiltonian(ts, td, tcfg).numpy(), "H_ext")
    _assert_close(jax.vmap(JE.angular_momentum_z)(js),
                  TE.angular_momentum_z(ts).numpy(), "L_z")


def test_extract_all(built):
    import jax

    JF = importlib.import_module("nbodysimproject_tpu.diagnostics.features")
    from nbodysimproject_tpu_torch.diagnostics import features as TF

    cfg, tcfg, _pop, (js, jd), (ts, td) = built
    ref = jax.vmap(lambda s, d: JF.extract_all(s, d, cfg))(js, jd)
    got = TF.extract_all(ts, td, tcfg)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _assert_close(ref[k], got[k].numpy(), k)


def test_state_from_numpy_roundtrip(built):
    _cfg, _tcfg, _pop, (js, jd), (_ts, _td) = built
    arrays = {**_np_fields(js), **_np_fields(jd)}
    st, dy = nt.state_from_numpy(arrays)
    assert st.pos.dtype == torch.float64 and st.mask.dtype == torch.bool
    assert dy.n_sub.dtype == torch.int32
    for k, a in arrays.items():
        obj = st if hasattr(st, k) else dy
        np.testing.assert_array_equal(getattr(obj, k).numpy(), a, err_msg=k)


@pytest.mark.parametrize("clamp", [False, True])
def test_eps_target_production(built, clamp):
    import jax

    from nbodysimproject_tpu.ops import eps_model as jeps
    from nbodysimproject_tpu_torch.ops import eps_model as teps

    _cfg, _tcfg, _pop, (js, jd), (ts, td) = built
    ref = jax.vmap(lambda s, d: jeps.eps_target_production(
        s.pos, s.mass, h0=s.eps, alpha=d.alpha_run, eps_min=d.min_softening,
        eps_max=d.max_softening, eta=1.35, clamp=clamp, mask=s.mask))(js, jd)
    got = teps.eps_target_production(
        ts.pos, ts.mass, h0=ts.eps, alpha=td.alpha_run,
        eps_min=td.min_softening, eps_max=td.max_softening, eta=1.35,
        clamp=clamp, mask=ts.mask)
    _assert_close(ref, got.numpy(), "eps*")


def test_calibrate_from_initial_conditions(built):
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops import eps_model as jeps
    from nbodysimproject_tpu_torch.ops import eps_model as teps

    _cfg, _tcfg, pop, (js, jd), (ts, td) = built
    ref = jax.vmap(lambda s, d: jeps.calibrate_from_initial_conditions(
        s.pos, s.mass, eps0=d.s0, eps_min0=d.s0 * 0.1,
        eps_max=d.max_softening, alpha_cfg=jnp.asarray(0.1), eta=1.35,
        mask=s.mask))(js, jd)
    got = teps.calibrate_from_initial_conditions(
        ts.pos, ts.mass, eps0=td.s0, eps_min0=td.s0 * 0.1,
        eps_max=td.max_softening, alpha_cfg=torch.full_like(td.s0, 0.1),
        eta=1.35, mask=ts.mask)
    for name, a, b in zip(("alpha_run", "eps_min", "eps"), ref, got):
        _assert_close(a, b.numpy(), name)


def test_simconfig_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(nb.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(nt.SimConfig)]
    assert tf == jf
    cfg = nt.SimConfig(slot_bucket=8).replace(fast_float32=True)
    assert cfg.slot_bucket == 8 and cfg.fast_float32
