"""PyTorch port vs the JAX package: the generators.

``torch.Generator`` cannot reproduce ``jax.random`` streams, so:

* the transforms are held against JAX on draws replayed from the JAX
  keys: ``generate_population``'s ``split(key, B)`` -> ``split(k, 3)`` ->
  the uniform mass draw and the position normals, ``split(k_v)`` -> the
  direction and noise normals, fed to the port's ``_generate_one``; in
  float64 to rtol 1e-12 (summation order only; atol 1e-12 for entries
  that cancel to ~0), at d = 2 and 3; in float32 to rtol 1e-5 / atol
  1e-5 (float32 ``log``/``exp`` on the log-mass path and the sums'
  order, a few ulps amplified by the COM projections);
* the deterministic builders (``hierarchical_triple_batch`` with
  ``min_separation`` and ``inclination``, ``polygon_batch`` with
  ``tilt``) are compared directly, to rtol 1e-12 / atol 1e-12;
* ``cohort_sizes`` and the cohort order of ``types`` exactly;
* the drawing functions structurally (shapes, masks, body counts,
  softening per cohort, recentred COM) and distributionally: a
  two-sample KS test of each cohort's total mass, virial ratio and mean
  separation, port (CPU draws) against JAX, at B = 4096 with fixed
  seeds, each p > 1e-3;
* ``data/bench_population_16384.npz`` (bench.py's population,
  ``diverse_population(PRNGKey(0), 16384, n_slots=8)`` drawn by the JAX
  package on the CPU in float32) is redrawn and compared to rtol 1e-6,
  so the file cannot go stale.  Rewrite it with
  ``JAX_PLATFORMS=cpu python tests/test_torch_generators.py``.
"""

import os

import numpy as np
import pytest
import torch

from nbodysimproject_tpu_torch.generators import ic_generator as tig
from nbodysimproject_tpu_torch.generators import pipeline as tpipe
from nbodysimproject_tpu_torch.generators import specialized as tspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_FILE = os.path.join(REPO, "data", "bench_population_16384.npz")
#: cohort codes of the committed bench population's ``types``
BENCH_COHORTS = ("random", "hierarchical", "polygon", "close_encounter")
KS_B = 4096
KS_P = 1e-3
STATS = ("total_mass", "virial_ratio", "mean_separation")
PARAMS = ("mass_lo", "mass_hi", "log_mass", "position_scale",
          "virial_fraction", "perturbation", "softening", "G")


def draw_bench_population():
    """bench.py's analysis population (bench.py:420-432), drawn by the
    JAX package on the CPU: a dict of numpy arrays with the cohorts as
    codes into ``BENCH_COHORTS``."""
    import jax

    from nbodysimproject_tpu.generators.pipeline import diverse_population

    m, q, v, mask, soft, types = diverse_population(
        jax.random.PRNGKey(0), 16384, n_slots=8)
    codes = np.asarray([BENCH_COHORTS.index(t) for t in types], np.int8)
    return dict(mass=np.asarray(m), pos=np.asarray(q), vel=np.asarray(v),
                mask=np.asarray(mask), softening=np.asarray(soft),
                types=codes, cohorts=np.asarray(BENCH_COHORTS))


def _replayed_draws(key, B, n_slots, dim, dtype):
    """The draws JAX's ``generate_population`` makes from ``key``."""
    import jax

    def one(k):
        k_m, k_q, k_v = jax.random.split(k, 3)
        k_dir, k_noise = jax.random.split(k_v)
        return (jax.random.uniform(k_m, (n_slots,), dtype),
                jax.random.normal(k_q, (n_slots, dim), dtype),
                jax.random.normal(k_dir, (n_slots, dim), dtype),
                jax.random.normal(k_noise, (n_slots, dim), dtype))

    return [np.asarray(a) for a in jax.vmap(one)(jax.random.split(key, B))]


def _hyper(B, seed=11):
    rng = np.random.default_rng(seed)
    return dict(mass_lo=rng.uniform(0.05, 0.5, B),
                mass_hi=rng.uniform(1.0, 10.0, B),
                log_mass=np.arange(B) % 2 == 0,
                position_scale=rng.uniform(0.1, 2.0, B),
                virial_fraction=rng.uniform(0.6, 1.5, B),
                perturbation=rng.uniform(0.05, 0.3, B),
                softening=rng.uniform(1e-3, 0.1, B),
                G=rng.uniform(0.5, 2.0, B))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_generate_one_matches_jax_on_replayed_draws(dim, precision):
    import jax
    import jax.numpy as jnp

    from nbodysimproject_tpu.generators.ic_generator import \
        generate_population

    B, n_slots = 64, 8
    jdt = jnp.float64 if precision == "float64" else jnp.float32
    tdt = getattr(torch, precision)
    key = jax.random.PRNGKey(5)
    counts = np.random.default_rng(2).integers(2, n_slots + 1, B)
    hp = _hyper(B)
    ref = generate_population(key, counts, n_slots=n_slots, dim=dim,
                              dtype=jdt, **hp)
    draws = [torch.tensor(a, dtype=tdt)
             for a in _replayed_draws(key, B, n_slots, dim, jdt)]
    mask = torch.arange(n_slots)[None, :] < torch.as_tensor(counts)[:, None]
    p = {k: torch.as_tensor(hp[k], dtype=torch.bool if k == "log_mass"
                            else tdt) for k in PARAMS}
    got = tig._generate_one(*draws, mask, p)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[3]))
    tol = dict(rtol=1e-12, atol=1e-12) if precision == "float64" \
        else dict(rtol=1e-5, atol=1e-5)
    for name, a, b in zip(("mass", "pos", "vel"), ref[:3], got):
        assert b.dtype == tdt
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **tol)


def test_generate_population_draw_order():
    """The drawing wrapper is the transform applied to its documented
    draws: the uniform mass draw, then the position, direction and noise
    normals."""
    B, n_slots, dim = 32, 8, 2
    counts = torch.randint(3, 8, (B,), generator=torch.Generator()
                           .manual_seed(1))
    hp = _hyper(B)
    gen = torch.Generator().manual_seed(9)
    got = tig.generate_population(gen, counts, n_slots=n_slots, dim=dim,
                                  device="cpu", **hp)
    gen = torch.Generator().manual_seed(9)
    u = torch.rand((B, n_slots), generator=gen, dtype=torch.float64)
    z = [torch.randn((B, n_slots, dim), generator=gen, dtype=torch.float64)
         for _ in range(3)]
    p = {k: torch.as_tensor(hp[k], dtype=torch.bool if k == "log_mass"
                            else torch.float64) for k in PARAMS}
    mask = torch.arange(n_slots)[None, :] < counts[:, None]
    want = tig._generate_one(u, *z, mask, p)
    for a, b in zip(want + (mask,), got):
        assert torch.equal(a, b)


def test_sample_body_counts_inclusive():
    c = tig.sample_body_counts(torch.Generator().manual_seed(0), 4000, (3, 5),
                               device="cpu")
    assert c.dtype == torch.int64
    assert set(c.tolist()) == {3, 4, 5}


def test_generator_device_checked():
    with pytest.raises(ValueError):
        tpipe.diverse_population(torch.Generator(), 10, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tpipe.diverse_population(torch.Generator(), 10)


@pytest.mark.parametrize("dim", [2, 3])
def test_hierarchical_triple_batch_matches_jax(dim):
    import jax.numpy as jnp

    from nbodysimproject_tpu.generators.specialized import \
        hierarchical_triple_batch

    rng = np.random.default_rng(3)
    B = 32
    r1, r2 = rng.uniform(0.1, 1.0, B), rng.uniform(0.1, 2.0, B)
    sep = rng.uniform(1.0, 12.0, B)
    inc = np.arccos(rng.uniform(-1, 1, B)) if dim == 3 else None
    for min_sep in (5.0, 1.5):
        ref = hierarchical_triple_batch(
            jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(sep), G=1.3,
            n_slots=8, min_separation=min_sep,
            inclination=None if inc is None else jnp.asarray(inc))
        got = tspec.hierarchical_triple_batch(
            r1, r2, sep, G=1.3, n_slots=8, min_separation=min_sep,
            inclination=inc, device="cpu")
        assert got[1].shape == (B, 8, dim)
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_polygon_batch_matches_jax(dim):
    import jax.numpy as jnp

    from nbodysimproject_tpu.generators.specialized import polygon_batch

    rng = np.random.default_rng(4)
    B = 40
    n = rng.integers(3, 9, B)
    R, rot = rng.uniform(0.5, 3.0, B), rng.uniform(0.0, 1.0, B)
    tilt = rng.uniform(0.0, np.pi, B) if dim == 3 else None
    ref = polygon_batch(jnp.asarray(n), jnp.asarray(R), jnp.asarray(rot),
                        G=0.7, n_slots=8,
                        tilt=None if tilt is None else jnp.asarray(tilt))
    got = tspec.polygon_batch(n, R, rot, G=0.7, n_slots=8, tilt=tilt,
                              device="cpu")
    assert got[1].shape == (B, 8, dim)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                   atol=1e-12)


def test_specialized_per_system_surface():
    from nbodysimproject_tpu.generators.specialized import \
        SpecializedGenerators as J

    T = tspec.SpecializedGenerators
    for a, b in zip(J.generate_hierarchical_triple(0.7, 0.4, 8.0),
                    T.generate_hierarchical_triple(0.7, 0.4, 8.0,
                                                   device="cpu")):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)
    for a, b in zip(J.generate_equal_mass_polygon(6, 1.5, 0.6),
                    T.generate_equal_mass_polygon(6, 1.5, 0.6,
                                                  device="cpu")):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [0, 1, 7, 10, 999, 4097, 16384])
def test_cohort_sizes(n):
    """The sizes exactly; the cohort order of ``types`` is held against
    the JAX package's draws in the distribution tests below (``_ks``)."""
    from nbodysimproject_tpu.generators import pipeline as jpipe

    assert tpipe.cohort_sizes(n) == jpipe.cohort_sizes(n)
    assert tpipe.COHORT_FRACTIONS == jpipe.COHORT_FRACTIONS
    assert tpipe.HEADLINE_V3_FRACTIONS == jpipe.HEADLINE_V3_FRACTIONS


#: (softening low, high) of each cohort
SOFTENING = {"random": (0.001, 0.1), "hierarchical": (0.01, 0.01),
             "polygon": (0.05, 0.05), "close_encounter": (0.001, 0.001),
             "hierarchical_boundary": (0.01, 0.01),
             "close_encounter_boundary": (1e-3, 3e-2)}
COUNTS = dict(tpipe.COHORT_BODY_COUNTS, hierarchical_boundary=(3, 3),
              close_encounter_boundary=(3, 4))
#: cohorts whose generator adds velocity noise after the COM projection
#: (as the JAX package does): their momentum is not zero
NOISY = ("hierarchical", "hierarchical_boundary")


def _check_structure(pop, n, n_slots, dim, dtype):
    mass, pos, vel, mask, soft, types = pop
    assert mass.shape == mask.shape == (n, n_slots) and len(types) == n
    assert pos.shape == vel.shape == (n, n_slots, dim)
    assert soft.shape == (n,)
    assert {a.dtype for a in (mass, pos, vel, soft)} == {dtype}
    assert mask.dtype == torch.bool
    # the valid slots come first
    assert not (mask[:, 1:] & ~mask[:, :-1]).any()
    for a in (mass[..., None], pos, vel):
        assert (a[~mask] == 0).all() and torch.isfinite(a).all()
    assert (mass[mask] > 0).all()
    types = np.asarray(types)
    counts = mask.sum(1).numpy()
    s = soft.double().numpy()
    m = mass.double()
    for cohort in np.unique(types):
        sel = types == cohort
        lo, hi = COUNTS[cohort]
        assert counts[sel].min() >= lo and counts[sel].max() <= hi, cohort
        lo, hi = SOFTENING[cohort]
        assert (s[sel] >= lo * (1 - 1e-6)).all(), cohort
        assert (s[sel] <= hi * (1 + 1e-6)).all(), cohort
        rows = torch.as_tensor(sel)
        for x, name in ((pos, "COM"), (vel, "momentum")):
            if name == "momentum" and cohort in NOISY:
                continue
            xs = x[rows].double()
            com = (m[rows][..., None] * xs).sum(1).norm(dim=-1)
            scale = (m[rows] * xs.norm(dim=-1)).sum(1)
            assert (com <= 1e-5 * scale + 1e-12).all(), (cohort, name)
    return types


@pytest.mark.parametrize("dim", [2, 3])
def test_diverse_population_structure(dim):
    n = 997
    pop = tpipe.diverse_population(torch.Generator().manual_seed(1), n,
                                   dim=dim, device="cpu")
    types = _check_structure(pop, n, 8, dim, torch.float32)
    sizes = tpipe.cohort_sizes(n)
    assert list(types) == sum(([k] * v for k, v in sizes.items()), [])


@pytest.mark.parametrize("dim", [2, 3])
def test_headline_population_structure(dim):
    n = 1003
    pop = tpipe.headline_population(torch.Generator().manual_seed(2), n,
                                    dim=dim, device="cpu",
                                    dtype=torch.float64)
    types = _check_structure(pop, n, 8, dim, torch.float64)
    fr = tpipe.HEADLINE_V3_FRACTIONS
    for k, f in fr.items():
        assert (types == k).sum() == int(f * n), k
    assert (types == "close_encounter_boundary").sum() == \
        n - sum(int(f * n) for f in fr.values())


def test_boundary_populations_structure():
    hb = tpipe.boundary_hier_population(torch.Generator().manual_seed(3), 300,
                                        device="cpu")
    _check_structure(hb, 300, 8, 2, torch.float32)
    sep = hb[1][:, 2, 0] - hb[1][:, :2, 0].mean(1)
    assert (sep.abs() > 1.0).all()
    cb = tpipe.boundary_close_population(torch.Generator().manual_seed(4),
                                         300, dim=3, device="cpu")
    _check_structure(cb, 300, 8, 3, torch.float32)


def _stats(pop):
    mass, pos, vel, mask, soft, types = (
        torch.tensor(np.asarray(a)) if i < 5 else a
        for i, a in enumerate(pop))
    st = tpipe.population_statistics(mass.double(), pos.double(),
                                     vel.double(), mask, soft.double())
    return {k: v.numpy() for k, v in st.items()}, np.asarray(types)


def _ks(port_pop, jax_pop):
    from scipy.stats import ks_2samp

    (sp, tp), (sj, tj) = _stats(port_pop), _stats(jax_pop)
    # the cohorts in the JAX package's order, row for row
    assert list(tp) == list(tj)
    out = {}
    for cohort in np.unique(tp):
        for k in STATS:
            a, b = sp[k][tp == cohort], sj[k][tj == cohort]
            if np.ptp(b) == 0.0:
                np.testing.assert_allclose(a, b, rtol=1e-5)
                continue
            out[(cohort, k)] = ks_2samp(a, b).pvalue
    bad = {k: p for k, p in out.items() if not p > KS_P}
    assert not bad, bad


@pytest.mark.parametrize("dim", [2, 3])
def test_diverse_population_distribution(dim):
    import jax

    from nbodysimproject_tpu.generators.pipeline import diverse_population

    _ks(tpipe.diverse_population(torch.Generator().manual_seed(21), KS_B,
                                 dim=dim, device="cpu"),
        diverse_population(jax.random.PRNGKey(21), KS_B, dim=dim))


def test_headline_population_distribution():
    import jax

    from nbodysimproject_tpu.generators.pipeline import headline_population

    _ks(tpipe.headline_population(torch.Generator().manual_seed(22), KS_B,
                                  device="cpu"),
        headline_population(jax.random.PRNGKey(22), KS_B))


def test_boundary_populations_distribution():
    import jax

    from nbodysimproject_tpu.generators import pipeline as jpipe

    _ks(tpipe.boundary_hier_population(torch.Generator().manual_seed(23),
                                       KS_B, device="cpu"),
        jpipe.boundary_hier_population(jax.random.PRNGKey(23), KS_B))
    _ks(tpipe.boundary_close_population(torch.Generator().manual_seed(24),
                                        KS_B, device="cpu"),
        jpipe.boundary_close_population(jax.random.PRNGKey(24), KS_B))


def test_bench_population_file_is_current():
    assert os.path.exists(BENCH_FILE)
    with np.load(BENCH_FILE, allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    want = draw_bench_population()
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(got[k], a, rtol=1e-6, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert got["mass"].shape == (16384, 8) and got["pos"].dtype == np.float32


def test_validate_system_matches_jax():
    from nbodysimproject_tpu.generators.ic_generator import \
        InitialConditionGenerator as J

    m, q, v = tspec.SpecializedGenerators.generate_hierarchical_triple(
        device="cpu")
    a = J().validate_system(m, q, v)
    b = tig.InitialConditionGenerator(device="cpu").validate_system(m, q, v)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=1e-14,
                                   err_msg=k)


def test_initial_condition_generator_surface():
    g = tig.InitialConditionGenerator(tig.GeneratorConfig(seed=3),
                                      device="cpu")
    m, q, v = g.generate_single(4)
    assert m.shape == (4,) and q.shape == (4, 2) and v.shape == (4, 2)
    sims = g.generate_batch(6, (3, 5))
    assert len(sims) == 6 and all(3 <= len(s[0]) <= 5 for s in sims)
    m, q, v, mask = g.generate_batch_arrays(5, (3, 4), n_slots=8)
    assert q.shape == (5, 8, 2) and mask.sum(1).min() >= 3
    sim = g.create_simulation(3)
    assert sim.n_bodies == 3 and sim.device.type == "cpu"


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(BENCH_FILE, **draw_bench_population())
    print(BENCH_FILE)
