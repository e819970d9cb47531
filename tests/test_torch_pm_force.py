"""PyTorch port vs the JAX package: PM and P3M forces
(``ops/pm_force.py``) on the CPU, in float64.

Inputs: the numpy-seeded Gaussian clouds of ``tests/test_pm_force.py``
(positions normal, masses |normal(1, 0.3)|).  Forces agree within 1e-9
of max|F|: torch's pocketfft and XLA's FFT round apart, and the deposits
accumulate in another order.  ``n_dropped`` is equal exactly, also in
the overflow case of ``test_window_overflow_is_counted`` (``pp_window``
512 at N = 4096).
"""

import numpy as np
import pytest
import torch

from nbodysimproject_tpu_torch.ops import pm_force as tpm

REL = 1e-9


def _cloud(N, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1.0, (N, 2)), np.abs(rng.normal(1, 0.3, N))


def _close(ref, got):
    ref, got = np.asarray(ref), got.numpy()
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


@pytest.mark.parametrize("assignment", ["tsc", "cic"])
def test_pm_force_matches_jax(assignment):
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pm_force import pm_force

    q, m = _cloud(1024, seed=3)
    eps = 4.0 * float(q.max() - q.min()) * 1.02 / 128
    ref = pm_force(jnp.asarray(q), jnp.asarray(m), eps, 1.3, Ng=128,
                   assignment=assignment)
    got = tpm.pm_force(torch.as_tensor(q), torch.as_tensor(m), eps, 1.3,
                       Ng=128, assignment=assignment)
    _close(ref, got)


@pytest.mark.parametrize("N,seed,Ng,r_cut_cells,eps,pp_window,bounds", [
    (2048, 0, 256, 6.0, None, 0, None),
    (1000, 1, 128, 4.0, 0.0, 0, None),
    (300, 5, 128, 6.0, 0.05, 0, ((-4.0, -4.0), (4.0, 4.0))),
    (4096, 2, 256, 6.0, 0.02, 512, None),
])
def test_p3m_force_matches_jax(N, seed, Ng, r_cut_cells, eps, pp_window,
                               bounds):
    import jax.numpy as jnp

    from nbodysimproject_tpu.ops.pm_force import p3m_force

    q, m = _cloud(N, seed=seed)
    if eps is None:
        eps = float(q.max() - q.min()) * 1.02 / Ng
    kw = dict(Ng=Ng, r_cut_cells=r_cut_cells, pp_window=pp_window,
              bounds=bounds)
    ref, ref_drop = p3m_force(jnp.asarray(q), jnp.asarray(m), eps, 1.0, **kw)
    got, drop = tpm.p3m_force(torch.as_tensor(q), torch.as_tensor(m), eps,
                              1.0, **kw)
    assert int(drop) == int(ref_drop)
    if pp_window:
        assert int(drop) > 0
    _close(ref, got)


def test_short_range_chunks_do_not_change_the_result(monkeypatch):
    """The pass computed in chunks of one tile equals the pass in one
    chunk bitwise."""
    q, m = (torch.as_tensor(a) for a in _cloud(1500, seed=9))
    whole = tpm.p3m_force(q, m, 0.03, 1.0, Ng=128, r_cut_cells=6.0)
    monkeypatch.setattr(tpm, "PP_CHUNK_BYTES", 1)
    tiled = tpm.p3m_force(q, m, 0.03, 1.0, Ng=128, r_cut_cells=6.0)
    assert torch.equal(whole[0], tiled[0]) and int(whole[1]) == int(tiled[1])
