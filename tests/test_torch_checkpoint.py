"""The port's ``utils/`` against the JAX package's, on the CPU:
checkpoints written by either package load in the other bit for bit
(the npz layout ``state.<field>`` / ``dyn.<field>`` / ``__meta__``), a
resumed integration continues exactly (``tests/test_aux_subsystems.py``'s
round trip), and ``EnergyAccumulator`` and the summation helpers give
the JAX package's bits."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbodysimproject_tpu as nb
import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu.utils import summation as jsum
from nbodysimproject_tpu_torch.utils import summation as tsum

M = [[1.0, 0.5, 0.1]] * 4
Q = [[[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]]] * 4
V = [[[0.0, 0.0], [0.0, 1.0], [-0.5, 0.0]]] * 4


def _jax_batch(mode):
    cfg = nb.SimConfig(integrator_mode=mode)
    from nbodysimproject_tpu.parallel import build_batch, integrate_batch

    st, dy = build_batch(jnp.asarray(M), jnp.asarray(Q), jnp.asarray(V),
                         jnp.ones((4, 3), bool), cfg, 1.0, 1e-3, 0.0, 0.01)
    return integrate_batch(st, dy, cfg, jnp.float64(0.01), 10, 1), dy


def _port_batch(mode):
    cfg = nt.SimConfig(integrator_mode=mode)
    t = lambda x: torch.tensor(x, dtype=torch.float64)
    st, dy = nt.build_batch(t(M), t(Q), t(V), torch.ones(4, 3, dtype=bool),
                            cfg, 1.0, 1e-3, 0.0, 0.01)
    return nt.integrate_batch(st, dy, cfg, 0.01, 10, 1), dy, cfg


def _fields(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            if not isinstance(getattr(tree, f.name), torch.Tensor)
            else getattr(tree, f.name).numpy()
            for f in dataclasses.fields(tree)}


def _same(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert fa[k].shape == fb[k].shape, k
        assert np.array_equal(fa[k], fb[k], equal_nan=fa[k].dtype.kind == "f"
                              ), k


@pytest.mark.parametrize("mode", ["verlet", "ham_soft"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, mode):
    st, dy = _jax_batch(mode)
    path = str(tmp_path / "jax_ckpt")
    nb.save_checkpoint(path, st, dy, meta={"step": 10, "mode": mode})
    s2, d2, meta = nt.load_checkpoint(path, device="cpu")
    assert meta == {"step": 10, "mode": mode}
    _same(s2, st)
    _same(d2, dy)
    s3, _d3, _ = nt.load_checkpoint(path + ".npz", dtype=torch.float32,
                                    device="cpu")
    assert s3.pos.dtype == torch.float32 and s3.mask.dtype == torch.bool


@pytest.mark.parametrize("mode", ["verlet", "ham_soft"])
def test_port_checkpoint_loads_in_jax(tmp_path, mode):
    st, dy, _cfg = _port_batch(mode)
    path = str(tmp_path / "port_ckpt.npz")
    nt.save_checkpoint(path, st, dy, meta={"step": 10})
    s2, d2, meta = nb.load_checkpoint(path)
    assert meta == {"step": 10}
    _same(s2, st)
    _same(d2, dy)


def test_resume_continues_identically(tmp_path):
    st, dy, cfg = _port_batch("verlet")
    path = str(tmp_path / "ckpt")
    nt.save_checkpoint(path, st, dy)
    s2, d2, meta = nt.load_checkpoint(path, device="cpu")
    assert meta == {}
    a = nt.integrate_batch(st, dy, cfg, 0.01, 5, 1)
    b = nt.integrate_batch(s2, d2, cfg, 0.01, 5, 1)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)


def test_energy_accumulator_bitwise():
    rng = np.random.default_rng(0)
    adds = np.concatenate([rng.normal(size=5000) * 10.0 ** rng.integers(
        -12, 6, 5000), [0.1] * 10000])
    ja, ta = nb.EnergyAccumulator(), nt.EnergyAccumulator()
    for x in adds:
        ja.add(x)
        ta.add(x)
    assert ta.total() == ja.total()
    assert ta.total() == pytest.approx(np.sum(adds.astype(np.longdouble)),
                                       rel=1e-15)
    ta.reset()
    assert ta.total() == 0.0


def test_summation_helpers_bitwise():
    rng = np.random.default_rng(1)
    for n in (1, 7, 64, 1000):
        x = rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n)
        assert float(tsum.pairwise_sum(torch.from_numpy(x))) == \
            float(jsum.pairwise_sum(jnp.asarray(x)))
        assert float(tsum.kahan_sum(torch.from_numpy(x))) == \
            float(jsum.kahan_sum(jnp.asarray(x)))
    a, b = rng.normal(size=50), rng.normal(size=50) * 1e-9
    ts, te = tsum.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    js, je = jsum.two_sum(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert float(tsum.pairwise_sum(torch.zeros(0))) == 0.0
