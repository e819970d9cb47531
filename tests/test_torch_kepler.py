"""PyTorch port vs the JAX package: the universal-variable Kepler solvers
of ``ops/kepler.py`` on the CPU.

The same numpy-drawn two-body states go through the JAX functions
(``jax.vmap`` over lanes) and the port's batched ones: elliptic,
hyperbolic and near-parabolic orbits, r0 < 1e-14 (the straight-line
fallback), and negative time steps, with drifts of a fraction of an
orbit up to several orbits.  In float64 the port matches to round-off
(rtol 1e-10 / atol 1e-12 on r and v, 1e-12 on the Stumpff functions):
the same operations in the same order.  The adaptive solver's masked
loop with its host check every 8 iterations must give the JAX
``while_loop``'s result, including on lanes that need many iterations.
"""

import numpy as np
import pytest
import torch

from nbodysimproject_tpu_torch.ops import kepler as tk

RTOL, ATOL = 1e-10, 1e-12


def _cases(seed=3):
    """(r, v, mu, dt) float64 arrays of 7 x 16 lanes, d = 2: elliptic
    short and multi-orbit, hyperbolic, near-parabolic, degenerate r0,
    negative dt, and a mixed bag."""
    rng = np.random.default_rng(seed)
    out = {}
    n = 16

    def circ(rad, mu):
        r = np.stack([rad, np.zeros_like(rad)], -1)
        v = np.stack([np.zeros_like(rad), np.sqrt(mu / rad)], -1)
        return r, v

    mu = rng.uniform(0.5, 2.0, n)
    r, v = circ(rng.uniform(0.5, 2.0, n), mu)
    out["elliptic"] = (r, v * rng.uniform(0.6, 1.2, (n, 1)), mu,
                       rng.uniform(0.01, 0.5, n))
    out["elliptic_multi_orbit"] = (r, v * 0.9, mu, rng.uniform(10.0, 40.0, n))
    out["hyperbolic"] = (r, v * rng.uniform(1.6, 4.0, (n, 1)), mu,
                         rng.uniform(0.1, 5.0, n))
    out["near_parabolic"] = (r, v * np.sqrt(2.0) * (1 + rng.uniform(
        -1e-9, 1e-9, (n, 1))), mu, rng.uniform(0.05, 2.0, n))
    rd = rng.normal(size=(n, 2)) * 1e-16
    out["degenerate_r0"] = (rd, rng.normal(size=(n, 2)), mu,
                            rng.uniform(0.01, 0.1, n))
    out["negative_dt"] = (r, v * rng.uniform(0.6, 1.8, (n, 1)), mu,
                          -rng.uniform(0.01, 3.0, n))
    out["mixed"] = (rng.normal(size=(n, 2)), 1.3 * rng.normal(size=(n, 2)),
                    mu, rng.uniform(-0.5, 0.5, n))
    return out


CASES = _cases()


def _jax(fn, case, **kw):
    import jax
    import jax.numpy as jnp

    r, v, mu, dt = (jnp.asarray(a) for a in CASES[case])
    out = jax.vmap(lambda a, b, c, d: fn(a, b, c, d, **kw))(r, v, mu, dt)
    return [np.asarray(x) for x in out]


def _port(fn, case, **kw):
    r, v, mu, dt = (torch.as_tensor(a) for a in CASES[case])
    return [x.numpy() for x in fn(r, v, mu, dt, **kw)]


def test_stumpff_matches_float64():
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.kepler import stumpff

    z = np.concatenate([np.linspace(-0.3, 0.3, 61), [0.3000001, -0.3000001],
                        np.linspace(-600.0, 500.0, 97),
                        [-4e5, -5e5, 1e3, 7e3]])
    ref = stumpff(jnp.asarray(z))
    got = tk.stumpff(torch.as_tensor(z))
    for k, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                   atol=1e-12, err_msg=f"c{k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_kepler_propagate_fixed_matches_float64(case):
    from nbodysimproject_tpu.ops.kepler import kepler_propagate_fixed

    for iters in (3, 8):
        ref = _jax(kepler_propagate_fixed, case, iters=iters)
        got = _port(tk.kepler_propagate_fixed, case, iters=iters)
        for name, a, b in zip(("r", "v"), ref, got):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} LC-{iters} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_kepler_propagate_adaptive_matches_float64(case):
    from nbodysimproject_tpu.ops.kepler import kepler_propagate

    ref = _jax(kepler_propagate, case)
    got = _port(tk.kepler_propagate, case)
    for name, a, b in zip(("r", "v"), ref, got):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case} {name}")


def test_degenerate_lanes_drift_in_a_straight_line():
    r, v, mu, dt = (torch.as_tensor(a) for a in CASES["degenerate_r0"])
    for fn in (tk.kepler_propagate, tk.kepler_propagate_fixed):
        ro, vo = fn(r, v, mu, dt)
        torch.testing.assert_close(ro, r + v * dt[:, None], rtol=0, atol=0)
        torch.testing.assert_close(vo, v, rtol=0, atol=0)


def test_adaptive_solver_freezes_converged_lanes():
    """A batch whose lanes converge at different depths gives each lane
    the result it gets alone: the masked loop freezes a finished lane.
    (1e-13: the CPU's vectorised transcendental functions round the
    last elements of a tensor apart from the others.)"""
    r, v, mu, dt = (torch.as_tensor(a) for a in CASES["mixed"])
    ro, vo = tk.kepler_propagate(r, v, mu, dt)
    for i in range(0, r.shape[0], 5):
        r1, v1 = tk.kepler_propagate(r[i:i + 1], v[i:i + 1], mu[i:i + 1],
                                     dt[i:i + 1])
        torch.testing.assert_close(r1[0], ro[i], rtol=1e-13, atol=1e-15)
        torch.testing.assert_close(v1[0], vo[i], rtol=1e-13, atol=1e-15)


def test_scalar_mu_and_dt_broadcast():
    """A float ``dt`` and a scalar ``mu`` broadcast over the lanes."""
    r, v, _mu, _dt = (torch.as_tensor(a) for a in CASES["elliptic"])
    a = tk.kepler_propagate_fixed(r, v, 1.5, 0.1)
    full = lambda x: torch.full((r.shape[0],), x, dtype=r.dtype)
    b = tk.kepler_propagate_fixed(r, v, full(1.5), full(0.1))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-13, atol=1e-15)
