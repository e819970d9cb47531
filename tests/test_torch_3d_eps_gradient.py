"""The eps* gradient on the 3-D dataset's rows, whose masked slots carry
mass 0: the port's (``ops/eps_model.py::eps_star_and_grad``, the ham_soft
scan's evaluation off the card) against a central difference of its own
value in float64, and the JAX package's XLA gradient, which is NaN in
every entry there (and then zeroed by its finite guard): the fault of
the reference recorded in ROADMAP.md Queue 3, which
``tests/test_torch_3d_analysis.py`` accounts for.

Rows: the first 8 rows of ``data/stability_3d_131k.csv.gz`` with at
most 3 substeps, with their own softening, built by each package in
float64.  Central difference step 1e-6; agreement to 1e-6 of the
largest entry of the system's gradient (truncation and rounding of the
difference quotient).
"""

import numpy as np
import torch

from test_torch_3d_core import N_SLOTS, _builds, dataset_rows_3d


def test_eps_gradient_with_zero_mass_slots_matches_central_difference():
    import jax

    from nbodysimproject_tpu.ops import eps_model as jem
    from nbodysimproject_tpu_torch.ops import eps_model as tem

    (m, q, v, mask, _G, soft, _ms), df = dataset_rows_3d()
    idx = np.nonzero(df["n_sub"].to_numpy() <= 3)[0][:8]
    (_cj, sj, dj), (_ct, st, dt) = _builds(
        (m[idx], q[idx], v[idx], mask[idx]), softening=soft[idx])
    assert (st.mass[~st.mask] == 0).all() and (~st.mask).any(1).all()
    kw = dict(h0=st.eps, alpha=dt.alpha_run, eps_min=dt.min_softening,
              eps_max=dt.max_softening, eta=1.35, clamp=True, mask=st.mask)
    _es, g = tem.eps_star_and_grad(st.pos, st.mass, use_fallback=False, **kw)
    h = 1e-6
    fd = torch.zeros_like(g)
    for i in range(N_SLOTS):
        for a in range(3):
            dq = torch.zeros_like(st.pos)
            dq[:, i, a] = h
            up = tem.eps_target_production(st.pos + dq, st.mass, **kw)
            dn = tem.eps_target_production(st.pos - dq, st.mass, **kw)
            fd[:, i, a] = (up - dn) / (2 * h) * st.mask[:, i]
    scale = g.abs().amax((1, 2), keepdim=True)
    assert (scale > 0).any()  # the SPH clip saturates on the others
    assert ((g - fd).abs() <= 1e-6 * scale + 1e-12).all()
    raw = jax.vmap(lambda q_, m_, h0, al, lo, hi, mk: jax.grad(
        lambda x: jem.eps_target_production(
            x, m_, h0=h0, alpha=al, eps_min=lo, eps_max=hi, eta=1.35,
            clamp=True, mask=mk))(q_))(
        sj.pos, sj.mass, sj.eps, dj.alpha_run, dj.min_softening,
        dj.max_softening, sj.mask)
    assert np.isnan(np.asarray(raw)).all()
