"""PyTorch port vs the JAX package: the tiled direct force
(``ops/force_kernels.py``) on the CPU.

Inputs: numpy-seeded clouds (positions normal x 3, masses uniform in
[0.1, 2]).  The plain version of ``pairwise_force`` against the Pallas
kernel ``pairwise_force_pallas`` in interpret mode, both with tiles of
256 sources (the JAX side with ti/tj = 128/256), in float64 to rtol
1e-10 / atol 1e-11 (the tolerance of ``tests/test_pallas.py``: the two
sum in different orders):

* N in {17, 300, 700}, d = 2 and d = 3;
* eps = 0 with two coincident bodies (the pair is skipped, r^2 = 0);
* B = 3 systems with their own eps and G, compared system by system;
* the row-subset argument against the same rows of the full result;
* the sum of the forces below 1e-10 max|F| (momentum);
* a zero-mass slot receives F = 0 and changes no other force.

On CPU tensors the wrapper runs the plain version (no launch).
"""

import numpy as np
import pytest
import torch

from nbodysimproject_tpu_torch.ops import force_kernels as fk

RTOL, ATOL = 1e-10, 1e-11


def _cloud(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)) * 3, rng.uniform(0.1, 2.0, n)


def _jax_force(q, m, eps, G):
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pallas_kernels import pairwise_force_pallas

    return np.asarray(pairwise_force_pallas(
        jnp.asarray(q), jnp.asarray(m), eps, G, ti=128, tj=256,
        interpret=True))


def _port_force(q, m, eps, G, **kw):
    return fk.pairwise_force_plain(torch.as_tensor(q), torch.as_tensor(m),
                                   eps, G, tj=256, **kw).numpy()


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n", [17, 300, 700])
def test_plain_matches_pallas_interpret(n, d):
    q, m = _cloud(n, d, seed=n + d)
    ref = _jax_force(q, m, 0.05, 1.3)
    np.testing.assert_allclose(_port_force(q, m, 0.05, 1.3), ref,
                               rtol=RTOL, atol=ATOL)


def test_unsoftened_coincident_bodies_are_skipped():
    q, m = _cloud(64, 2, seed=3)
    q[5] = q[9]
    ref = _jax_force(q, m, 0.0, 1.0)
    got = _port_force(q, m, 0.0, 1.0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_batch_with_per_system_eps_and_G():
    B, n = 3, 300
    qs, ms = zip(*(_cloud(n, 2, seed=20 + b) for b in range(B)))
    eps, G = np.array([0.01, 0.05, 0.2]), np.array([1.0, 0.5, 2.0])
    got = fk.pairwise_force(torch.as_tensor(np.stack(qs)),
                            torch.as_tensor(np.stack(ms)),
                            torch.as_tensor(eps), torch.as_tensor(G))
    for b in range(B):
        ref = _jax_force(qs[b], ms[b], float(eps[b]), float(G[b]))
        np.testing.assert_allclose(got[b].numpy(), ref, rtol=RTOL,
                                   atol=ATOL)


def test_row_subset_matches_the_full_rows():
    q, m = _cloud(700, 3, seed=5)
    rows = np.array([0, 3, 255, 256, 511, 699])
    full = _port_force(q, m, 0.05, 1.0)
    sub = _port_force(q, m, 0.05, 1.0, rows=torch.as_tensor(rows))
    np.testing.assert_array_equal(sub, full[rows])


def test_momentum_and_zero_mass_slot():
    q, m = _cloud(200, 2, seed=7)
    F = _port_force(q, m, 0.01, 1.0)
    assert np.abs(F.sum(0)).max() < 1e-10 * np.abs(F).max()
    m0 = m.copy()
    m0[17] = 0.0
    F0 = _port_force(q, m0, 0.01, 1.0)
    assert np.all(F0[17] == 0.0)
    keep = np.arange(200) != 17
    Fx = _port_force(q[keep], m[keep], 0.01, 1.0)
    np.testing.assert_allclose(F0[keep], Fx, rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_runs_the_plain_version():
    q, m = _cloud(40, 2)
    before = fk.pairwise_force.launches
    got = fk.pairwise_force(torch.as_tensor(q), torch.as_tensor(m), 0.05,
                            1.0)
    assert fk.pairwise_force.launches == before
    assert got.dtype == torch.float64 and got.shape == (40, 2)
    np.testing.assert_allclose(got.numpy(), _jax_force(q, m, 0.05, 1.0),
                               rtol=RTOL, atol=ATOL)
