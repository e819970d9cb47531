"""The CUDA kernels of the port against their plain PyTorch versions, on
the card: the analysis, MEGNO and plain multi-step ham_soft kernels, the
eps* kernel, the composition (Verlet/Yoshida4) kernel, the WHFast kernel
and the tiled large-N force kernel; the Kepler tail of
``analyze_population`` and ``largen_rollout`` on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; the file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch (``--noconftest`` skips
``tests/conftest.py``, which sets JAX up):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Inputs: numpy-seeded populations (N = 3, N = 4 with a masked slot, and
N = 8 slots holding 3-7 bodies; d = 2; B = 64) built by the port in
float32.  The raw kernel state agrees with the plain version to rtol
1e-4 / atol 1e-5 (float32 rounding of two reduction orders and of
autograd versus the hand-written reverse sweep over ~50 trips; also at
N = 8 with masked slots at n_sub 256, 512 trips), the analysis columns
within the fused-vs-scan tolerances of ``tests/test_pallas_batch.py``;
a random permutation of the input systems gives bitwise the same
per-system outputs of both kernels, and their final states equal the
multi-step kernel's bit for bit.  The composition kernel runs bench.py's
3-body system and, at N = 4, d = 2 and N = 8, d = 3, a ring population
(B = 4096, 20 steps; rtol 1e-5 / atol 1e-6: the same operations, which
its FMAs round apart from the plain version's by a few ulps a step),
its Verlet and Yoshida4 instances of one N = 3 library each within that
tolerance of the plain version's run of its scheme (at a step of 0.05,
where the two schemes' results lie far outside it), and so do systems
with eps2 0 or subnormal (the kernel's rsqrt flushes subnormals); the eps
kernel holds eps* to rtol 1e-6 and the gradient to rtol 1e-5 / atol
1e-5.  The WHFast kernel runs planetary systems (B = 4096, 20 steps;
rtol 1e-5 / atol 1e-6 against its plain version, whose expressions its
FMAs round apart from by a few ulps a step, on the live bodies; a padded
slot's distance to the float64 plain run within twice the float32 plain
version's; 1e-5 / 1e-7 against one substep of the LC-8 scan); the
tail's rows are bitwise equal between
its own stream and the serial run, and the non-tail rows to the
tail-off run.  The tiled force kernel (N = 4097 and d = 2, N = 1000 and
d = 3, B = 4 with per-system eps and G) is held, row by row, to the
float64 plain version relative to the row's magnitude sum: at most 4x the
float32 plain version's worst error and 1e-4, also at N = 4096 with B = 1
(where it splits the source tiles across blocks) and B = 96 (where it
does not); a float64 input gives the float32 result cast back, and
d = 4 raises.  The multi-step kernel's two layouts (one thread per
system at N = 3, a warp per system at N = 8) give bitwise equal final
states on 3-body systems in 3 and in 8 slots, under all three barrier
policies, and so do the eps kernel's (one thread per system at N = 3,
one lane per body at N = 8) under both clamps.  The kernels' other
branches (the end of the file): the analysis, MEGNO and multi-step
kernels under the reflection and no-barrier policies and the "reference"
gradient, and the multi-step and analysis kernels at d = 3, against
their plain versions with the tolerances above, their trips equal to the
multi-step kernel's bit for bit; the eps kernel's fallback against its
plain version and its two layouts bit for bit under it; the WHFast
kernel at d = 3 as at d = 2.  ``largen_rollout`` on the
tiled kernel matches the dense force for 5 steps (rtol 1e-5 / atol
1e-6).
"""

import numpy as np
import pytest
import torch

import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.analysis.fused import analyze_batch_fused
from nbodysimproject_tpu_torch.diagnostics.energy import angular_momentum_z
from nbodysimproject_tpu_torch.diagnostics.megno import (init_tangent,
                                                         population_normals)
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
from nbodysimproject_tpu_torch.parallel.batch_engine import build_batch

pytestmark = pytest.mark.cuda

STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
#: per-column (rtol, atol) of tests/test_pallas_batch.py:258-277
TOL = {
    "energy_drift": (0.05, 1e-5), "angular_momentum_drift": (0.05, 1e-5),
    "com_drift_mean": (1e-3, 1e-5), "com_drift_max": (1e-3, 1e-5),
    "j_eps_mean": (2e-3, 1e-6), "j_eps_std": (2e-3, 1e-6),
    "theta_eps_mean": (2e-3, 1e-3), "theta_eps_std": (2e-3, 1e-3),
    "cos_theta_mean": (1e-4, 1e-5), "cos_theta_min": (1e-4, 1e-5),
    "ang_mom_var_mean": (2e-3, 1e-7), "ang_mom_var_max": (2e-3, 1e-7),
    "tidal_trace_mean": (2e-3, 1e-3), "tidal_trace_max": (2e-3, 1e-3),
    "MEGNO": (1e-3, 1e-4), "lyapunov_time": (1e-2, 0.0),
    "megno_slope_med": (5e-3, 1e-3),
}
CASES = {"n3": (3, 3), "n4_masked": (4, 3), "n8_mixed": (8, None)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _population(n, n_bodies, B=64, seed=11):
    """A near-hierarchical configuration per system: bodies on a line
    with small random offsets and velocities; ``n_bodies`` valid slots
    (None: 3-7 per system)."""
    rng = np.random.default_rng(seed)
    counts = np.full(B, n_bodies) if n_bodies else rng.integers(3, 8, B)
    mask = np.arange(n)[None, :] < counts[:, None]
    q = np.zeros((B, n, 2))
    q[..., 0] = np.arange(n) * 1.2
    q += 0.05 * rng.normal(size=q.shape)
    v = 0.2 * rng.normal(size=q.shape)
    m = rng.uniform(0.2, 1.0, size=(B, n))
    m, q, v = (np.where(mask[..., None] if a.ndim == 3 else mask, a, 0.0)
               for a in (m, q, v))
    return m, q, v, mask


def _built(case, device):
    cfg = nt.SimConfig(fast_float32=True)
    m, q, v, mask = _population(*CASES[case])
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    states, dyns = build_batch(f(m), f(q), f(v),
                               torch.as_tensor(mask, device=device), cfg,
                               1.0, 0.05, 0.0, 0.01)
    z1, z2 = population_normals(5, m.shape[0], q.shape[1:], torch.float32)
    tangent = init_tangent(z1.to(device), z2.to(device), states)
    return cfg, states, dyns, tangent


def _kw(cfg, dyns, n_sub_max, dt=0.01):
    n_sub = torch.clamp_min(dyns.n_sub, 1)
    return dict(k_soft=dyns.k_soft, mu=dyns.mu_soft, alpha=dyns.alpha_run,
                eps_min=dyns.min_softening, eps_max=dyns.max_softening,
                h=dt / n_sub.to(torch.float32), n_sub=n_sub,
                n_sub_max=n_sub_max, G=1.0, k_wall=float(cfg.k_wall),
                eta=float(cfg.eta), jcap=float(cfg.j_max_cap),
                bexp=int(cfg.barrier_exponent))


def _close(a, b, name, rtol=STATE_RTOL, atol=STATE_ATOL):
    a = a.detach().cpu().numpy().astype(np.float64)
    b = b.detach().cpu().numpy().astype(np.float64)
    np.testing.assert_array_equal(np.isfinite(b), np.isfinite(a),
                                  err_msg=f"finiteness: {name}")
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_analysis_kernel_matches_plain(case, cuda_device):
    cfg, st, dy, _tan = _built(case, cuda_device)
    kw = _kw(cfg, dy, int(dy.n_sub.max()))
    args = (st.pos, st.vel, st.mass, st.eps, st.pi, angular_momentum_z(st))
    before = hk.hamsoft_analysis_multistep.launches
    ref = hk.hamsoft_analysis_multistep_plain(*args, n_steps=12, interval=2,
                                              **kw)
    got = hk.hamsoft_analysis_multistep(*args, n_steps=12, interval=2, **kw)
    torch.cuda.synchronize()
    assert hk.hamsoft_analysis_multistep.launches == before + 1
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, name)
    for metric in hk.ACC_METRICS:
        for stat, a, b in zip(("count", "sum", "sumsq", "max", "min"),
                              ref[4][metric], got[4][metric]):
            _close(a, b, f"{metric}.{stat}", rtol=1e-3)
    _close(ref[5], got[5], "eps_samples")
    _close(ref[6], got[6], "pi_samples")


@pytest.mark.parametrize("case", sorted(CASES))
def test_megno_kernel_matches_plain(case, cuda_device):
    cfg, st, dy, (dr0, dv0) = _built(case, cuda_device)
    kw = _kw(cfg, dy, int(dy.n_sub.max()))
    args = (st.pos, st.vel, st.mass, st.eps, st.pi, dr0, dv0)
    before = hk.hamsoft_megno_multistep.launches
    ref = hk.hamsoft_megno_multistep_plain(*args, dt=0.01, n_steps=6, **kw)
    got = hk.hamsoft_megno_multistep(*args, dt=0.01, n_steps=6, **kw)
    torch.cuda.synchronize()
    assert hk.hamsoft_megno_multistep.launches == before + 1
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, name)
    for name, a, b in zip(("MEGNO", "lyapunov_time", "megno_slope_med"),
                          ref[4:], got[4:]):
        _close(a, b, name, *TOL[name])


def _call(kernel, fn, st, tan, kw, n_steps):
    if kernel == "analysis":
        return fn(st.pos, st.vel, st.mass, st.eps, st.pi,
                  angular_momentum_z(st), n_steps=n_steps, interval=1, **kw)
    return fn(st.pos, st.vel, st.mass, st.eps, st.pi, *tan, dt=0.01,
              n_steps=n_steps, **kw)


def _flat(out):
    """The outputs of either wrapper as a list of tensors."""
    flat = []
    for x in out:
        if isinstance(x, dict):
            flat += [t for k in sorted(x) for t in x[k]]
        else:
            flat.append(x)
    return flat


@pytest.mark.parametrize("kernel", ["analysis", "megno"])
def test_kernel_matches_plain_n8_masked_deep(kernel, cuda_device):
    """N = 8 slots with masked bodies at the cap's n_sub = 256: the
    deepest lanes' 512 trips against the plain version."""
    cfg, st, dy, tan = _built("n8_mixed", cuda_device)
    assert not bool(st.mask.all())
    kw = _kw(cfg, dy, 256)
    kw["n_sub"] = torch.full_like(dy.n_sub, 256)
    kw["h"] = torch.full_like(st.eps, 0.01 / 256)
    fn = {"analysis": (hk.hamsoft_analysis_multistep_plain,
                       hk.hamsoft_analysis_multistep),
          "megno": (hk.hamsoft_megno_multistep_plain,
                    hk.hamsoft_megno_multistep)}[kernel]
    ref = _call(kernel, fn[0], st, tan, kw, 2)
    got = _call(kernel, fn[1], st, tan, kw, 2)
    torch.cuda.synchronize()
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, name)
    if kernel == "analysis":
        for metric in hk.ACC_METRICS:
            for stat, a, b in zip(("count", "sum", "sumsq", "max", "min"),
                                  ref[4][metric], got[4][metric]):
                _close(a, b, f"{metric}.{stat}", rtol=1e-3)
        _close(ref[5], got[5], "eps_samples")
        _close(ref[6], got[6], "pi_samples")
    else:
        for name, a, b in zip(("MEGNO", "lyapunov_time", "megno_slope_med"),
                              ref[4:], got[4:]):
            _close(a, b, name, *TOL[name])


@pytest.mark.parametrize("depth", ["built", "cap"])
@pytest.mark.parametrize("kernel", ["analysis", "megno"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_trajectory_is_the_multistep_kernels(case, kernel, depth,
                                                     cuda_device):
    """Every sum of a trip is added in the one-thread physics' order, so
    the final pos, vel, eps and pi equal the multi-step kernel's
    (``csrc/hamsoft_multistep.cu``, soft policy) bit for bit, at the
    built n_sub and at the cap's 256 trips a step."""
    cfg, st, dy, tan = _built(case, cuda_device)
    if depth == "cap":
        dy = dy.replace(n_sub=torch.full_like(dy.n_sub, 256))
    kw = _kw(cfg, dy, int(dy.n_sub.max()))
    fn = {"analysis": hk.hamsoft_analysis_multistep,
          "megno": hk.hamsoft_megno_multistep}[kernel]
    got = _call(kernel, fn, st, tan, kw, 3)
    ref = hk.hamsoft_multistep(st.pos, st.vel, st.mass, st.eps, st.pi,
                               n_steps=3, policy="soft", **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref, got[:4]):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name


@pytest.mark.parametrize("kernel", ["analysis", "megno"])
def test_kernel_outputs_do_not_depend_on_lane_order(kernel, cuda_device):
    """A random permutation of the input lanes gives bitwise the same
    per-system outputs: the kernel runs the systems deepest first and
    writes each at its own index."""
    cfg, st, dy, tan = _built("n8_mixed", cuda_device)
    rng = np.random.default_rng(3)
    B = st.pos.shape[0]
    # trip counts 1-12, several systems sharing each (ties keep order)
    n_sub = torch.as_tensor(rng.integers(1, 13, B), dtype=torch.int32,
                            device=cuda_device)
    dy = dy.replace(n_sub=n_sub)
    fn = {"analysis": hk.hamsoft_analysis_multistep,
          "megno": hk.hamsoft_megno_multistep}[kernel]
    ref = _flat(_call(kernel, fn, st, tan, _kw(cfg, dy, 12), 4))
    perm = torch.as_tensor(rng.permutation(B), device=cuda_device)
    st_p, dy_p = st.take(perm), dy.take(perm)
    got = _flat(_call(kernel, fn, st_p, (tan[0][perm], tan[1][perm]),
                      _kw(cfg, dy_p, 12), 4))
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(ref, got)):
        # (B, ...) outputs and the (rows, B) sample rows
        a_p = a[perm] if a.shape[0] == perm.shape[0] else a[:, perm]
        assert torch.equal(torch.isnan(a_p), torch.isnan(b)), k
        assert torch.equal(torch.nan_to_num(a_p), torch.nan_to_num(b)), k


def test_engine_columns_match_plain(cuda_device):
    """The fused engine on the kernels against the same engine on the
    plain versions, column by column."""
    cfg, st, dy, tan = _built("n8_mixed", cuda_device)
    nsm = int(dy.n_sub.max())
    rk, _ = analyze_batch_fused(st, dy, cfg, 12, 0.01, "full", nsm, 6,
                                tangent=tan)
    rp, _ = analyze_batch_fused(
        st, dy, cfg, 12, 0.01, "full", nsm, 6, tangent=tan,
        analysis_fn=hk.hamsoft_analysis_multistep_plain,
        megno_fn=hk.hamsoft_megno_multistep_plain)
    assert torch.equal(rk["is_stable"], rp["is_stable"])
    for k, (rtol, atol) in TOL.items():
        _close(rp[k], rk[k], k, rtol, atol)


PIPE = dict(slot_bucket=8, fast_float32=True, analysis_n_sub_cap=256,
            use_fused_analysis=True, analysis_group_quantum=1024,
            analysis_tail_policy="off")


def test_analyze_population_launches_both_kernels_once(cuda_device):
    m, q, v, mask = _population(8, None)
    a0 = hk.hamsoft_analysis_multistep.launches
    m0 = hk.hamsoft_megno_multistep.launches
    tm = {}
    df = nt.analyze_population(m, q, v, mask, nt.SimConfig(**PIPE),
                               n_steps=12, mode="full", show_progress=False,
                               timing_out=tm)
    assert len(df) == m.shape[0]
    assert tm["n_dispatches"] == 1
    assert hk.hamsoft_analysis_multistep.launches == a0 + 1
    assert hk.hamsoft_megno_multistep.launches == m0 + 1
    assert np.isfinite(df["is_stable"]).all()


def test_group_quantum_is_scheduling_only_on_the_card(cuda_device):
    """Quantum 1024 and 0 give bitwise-identical rows on the card."""
    m, q, v, mask = _population(8, None)
    kw = dict(n_steps=12, mode="full", show_progress=False)
    a = nt.analyze_population(m, q, v, mask, nt.SimConfig(**PIPE), **kw)
    b = nt.analyze_population(
        m, q, v, mask, nt.SimConfig(**{**PIPE, "analysis_group_quantum": 0}),
        **kw)
    for c in a.columns:
        np.testing.assert_array_equal(b[c].to_numpy(), a[c].to_numpy(),
                                      err_msg=c)


# --------------------------------------------------------------------------
# the kernels of the batched-integration slice
# --------------------------------------------------------------------------

def _bench_population(B, device, seed=13):
    """bench.py's 3-body system with 1% perturbations (numpy seed)."""
    rng = np.random.default_rng(seed)
    q = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]])[None] \
        + 0.01 * rng.normal(size=(B, 3, 2))
    v = np.array([[0.0, 0.0], [0.0, 1.0], [-0.5, 0.0]])[None] \
        + 0.01 * rng.normal(size=(B, 3, 2))
    m = np.broadcast_to([1.0, 0.5, 0.1], (B, 3)).copy()
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return f(m), f(q), f(v)


def _ring_population(B, n, d, device, seed=5):
    """n bodies on a ring of radius 1.5 plus 0.01 noise, masses
    linspace(1, 0.1), velocities 0.3 normal (numpy seed)."""
    rng = np.random.default_rng(seed)
    ang = 2.0 * np.pi * np.arange(n) / n
    base = np.zeros((n, d))
    base[:, 0], base[:, 1] = 1.5 * np.cos(ang), 1.5 * np.sin(ang)
    q = base[None] + 0.01 * rng.normal(size=(B, n, d))
    v = 0.3 * rng.normal(size=(B, n, d))
    m = np.broadcast_to(np.linspace(1.0, 0.1, n), (B, n)).copy()
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return f(m), f(q), f(v)


@pytest.mark.parametrize("shape", [(3, 2), (4, 2), (8, 3)],
                         ids=lambda s: f"N{s[0]}d{s[1]}")
@pytest.mark.parametrize("scheme", ["verlet", "yoshida4"])
def test_composition_kernel_matches_plain(scheme, shape, cuda_device):
    from nbodysimproject_tpu_torch.ops import batch_kernels as bk

    m, q, v = _bench_population(4096, cuda_device) if shape == (3, 2) \
        else _ring_population(4096, *shape, cuda_device)
    eps2 = torch.full((q.shape[0],), 1e-6, device=cuda_device)
    before = bk.composition_multistep.launches
    ref = bk.composition_multistep_plain(q, v, m, eps2, h=0.01, G=1.0,
                                         n_steps=20, scheme=scheme)
    got = bk.composition_multistep(q, v, m, eps2, h=0.01, G=1.0, n_steps=20,
                                   scheme=scheme)
    torch.cuda.synchronize()
    assert bk.composition_multistep.launches == before + 1
    for name, a, b in zip(("pos", "vel"), ref, got):
        _close(a, b, name, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        bk.composition_multistep(q, v, m, eps2, h=0.01, G=1.0, n_steps=1,
                                 mask=torch.ones_like(m, dtype=torch.bool))


@pytest.mark.parametrize("eps2_value", [0.0, 1e-39])
def test_composition_tiny_softening_matches_plain(eps2_value, cuda_device):
    """Systems whose eps2 is not a normal float (0, or subnormal), where
    the kernel's rsqrt.approx.ftz would flush a subnormal r^2: both
    schemes agree with the plain version (torch.rsqrt) within rtol 1e-5 /
    atol 1e-6."""
    from nbodysimproject_tpu_torch.ops import batch_kernels as bk

    m, q, v = _ring_population(4096, 4, 2, cuda_device)
    eps2 = torch.full((q.shape[0],), eps2_value, device=cuda_device)
    for scheme in ("verlet", "yoshida4"):
        kw = dict(h=0.01, G=1.0, n_steps=20, scheme=scheme)
        ref = bk.composition_multistep_plain(q, v, m, eps2, **kw)
        got = bk.composition_multistep(q, v, m, eps2, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("pos", "vel"), ref, got):
            _close(a, b, f"{scheme}.{name}", rtol=1e-5, atol=1e-6)


def test_composition_schemes_share_one_library(cuda_device):
    """One N = 3 library holds both schemes (the stage count is a
    template argument): its Verlet and Yoshida4 instances each give what
    the plain version gives for that scheme, within rtol 1e-5 / atol
    1e-6, and not each other's result.  The step is 0.05, where the two
    schemes' results lie ~9e-4 apart after 20 steps (float32 rounding
    ~1.4e-6, on the CPU); at 0.01 they lie within the tolerance."""
    from nbodysimproject_tpu_torch.ops import batch_kernels as bk

    m, q, v = _bench_population(4096, cuda_device)
    eps2 = torch.full((q.shape[0],), 1e-6, device=cuda_device)
    kw = dict(h=0.05, G=1.0, n_steps=20)
    got = {}
    for scheme in ("verlet", "yoshida4"):
        ref = bk.composition_multistep_plain(q, v, m, eps2, scheme=scheme,
                                             **kw)
        got[scheme] = bk.composition_multistep(q, v, m, eps2, scheme=scheme,
                                               **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("pos", "vel"), ref, got[scheme]):
            _close(a, b, f"{scheme}.{name}", rtol=1e-5, atol=1e-6)
    assert float((got["verlet"][0] - got["yoshida4"][0]).abs().max()) > 1e-4


@pytest.mark.parametrize("policy", ["soft", "reflection"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_multistep_kernel_matches_plain(case, policy, cuda_device):
    cfg, st, dy, _tan = _built(case, cuda_device)
    kw = _kw(cfg, dy, int(dy.n_sub.max()))
    if policy == "reflection":
        kw.update(eps_min=st.eps * 0.999, eps_max=st.eps * 1.001)
    args = (st.pos, st.vel, st.mass, st.eps, st.pi)
    before = hk.hamsoft_multistep.launches
    ref = hk.hamsoft_multistep_plain(*args, n_steps=12, policy=policy, **kw)
    got = hk.hamsoft_multistep(*args, n_steps=12, policy=policy, **kw)
    torch.cuda.synchronize()
    assert hk.hamsoft_multistep.launches == before + 1
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref, got):
        _close(a, b, f"{policy}.{name}")


@pytest.mark.parametrize("policy", ["soft", "reflection", "none"])
def test_multistep_layouts_run_the_same_trip(policy, cuda_device):
    """The multi-step kernel's two layouts, one thread per system at
    N = 3 and a warp per system at N = 8: 3-body systems in 3 slots and
    the same systems padded to 8 slots (mass 0) end with bitwise equal
    pos, vel, eps and pi (the padded slots add exact zeros)."""
    cfg, st, dy, _tan = _built("n3", cuda_device)
    kw = _kw(cfg, dy, int(dy.n_sub.max()))
    if policy == "reflection":
        kw.update(eps_min=st.eps * 0.999, eps_max=st.eps * 1.001)
    pad = lambda x: torch.cat([x, torch.zeros_like(x[:, :1]).expand(
        (-1, 5) + tuple(x.shape[2:]))], 1)
    three = hk.hamsoft_multistep(st.pos, st.vel, st.mass, st.eps, st.pi,
                                 n_steps=12, policy=policy, **kw)
    eight = hk.hamsoft_multistep(pad(st.pos), pad(st.vel), pad(st.mass),
                                 st.eps, st.pi, n_steps=12, policy=policy,
                                 **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("pos", "vel", "eps", "pi"), three,
                          (eight[0][:, :3], eight[1][:, :3], *eight[2:])):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eps_kernel_matches_plain(case, clamp, cuda_device):
    from nbodysimproject_tpu_torch.ops import eps_kernels as ek

    _cfg, st, dy, _tan = _built(case, cuda_device)
    args = (st.pos, st.mass, st.eps, dy.alpha_run, dy.min_softening,
            dy.max_softening, st.mask)
    before = ek.eps_star_and_grad_fused.launches
    es0, g0 = ek.eps_star_and_grad_fused_plain(*args, clamp=clamp,
                                               use_fallback=False)
    es1, g1 = ek.eps_star_and_grad_fused(*args, clamp=clamp,
                                         use_fallback=False)
    torch.cuda.synchronize()
    assert ek.eps_star_and_grad_fused.launches == before + 1
    _close(es0, es1, "eps*", rtol=1e-6, atol=0.0)
    _close(g0, g1, "grad", rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("clamp", [False, True])
def test_eps_layouts_give_the_same_bits(clamp, cuda_device):
    """The eps kernel's two layouts, one thread per system at N = 3 and
    one lane per body at N = 8: 3-body systems in 3 slots and the same
    systems padded to 8 (mass 0, mask off) give eps* and gradients equal
    in every bit, and a zero gradient in the padded slots; one launch a
    call."""
    from nbodysimproject_tpu_torch.ops import eps_kernels as ek

    # seeded clusters tight enough that some clip gates open (the
    # CASES populations saturate every gate: their gradient is 0)
    rng = np.random.default_rng(3)
    B = 256
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
    st, dy = build_batch(
        f(rng.uniform(0.2, 1.0, size=(B, 3))),
        f(0.05 * rng.normal(size=(B, 3, 2))),
        f(0.3 * rng.normal(size=(B, 3, 2))),
        torch.ones((B, 3), dtype=torch.bool, device=cuda_device),
        nt.SimConfig(fast_float32=True), 1.0, 0.05, 0.0, 0.01)
    pad = lambda x: torch.cat([x, torch.zeros_like(x[:, :1]).expand(
        (-1, 5) + tuple(x.shape[2:]))], 1)
    rows = (st.eps, dy.alpha_run, dy.min_softening, dy.max_softening)
    before = ek.eps_star_and_grad_fused.launches
    es3, g3 = ek.eps_star_and_grad_fused(st.pos, st.mass, *rows, st.mask,
                                         clamp=clamp, use_fallback=False)
    es8, g8 = ek.eps_star_and_grad_fused(pad(st.pos), pad(st.mass), *rows,
                                         pad(st.mask), clamp=clamp,
                                         use_fallback=False)
    torch.cuda.synchronize()
    assert ek.eps_star_and_grad_fused.launches == before + 2
    bits = lambda x: x.contiguous().view(torch.int32)
    assert torch.equal(bits(es3), bits(es8))
    assert torch.equal(bits(g3), bits(g8[:, :3]))
    assert not g8[:, 3:].any()
    assert g3.abs().max() > 0  # the gradient is exercised


@pytest.mark.parametrize("policy", ["soft", "reflection"])
def test_hamsoft_scan_goes_through_the_eps_kernel(policy, cuda_device):
    """integrate_batch on the card: every substep's (eps*, grad) comes
    from the eps kernel, and the trajectory matches the CPU route's
    within the float32 scan tolerances of tests/test_pallas_batch.py."""
    from nbodysimproject_tpu_torch.ops import eps_kernels as ek
    from nbodysimproject_tpu_torch.parallel.batch_engine import \
        integrate_batch

    cfg = nt.SimConfig(fast_float32=True,
                       use_soft_barrier=(policy == "soft"))
    m, q, v = _bench_population(256, cuda_device)
    mask = torch.ones(m.shape, dtype=torch.bool, device=cuda_device)
    st, dy = build_batch(m, q, v, mask, cfg, 1.0, 0.05, 0.0, 0.01)
    nsm = int(dy.n_sub.max())
    before = ek.eps_star_and_grad_fused.launches
    out = integrate_batch(st, dy, cfg, 0.01, 10, nsm)
    torch.cuda.synchronize()
    assert ek.eps_star_and_grad_fused.launches >= before + 10
    cpu = lambda x: x.replace(**{k: getattr(x, k).cpu() for k in
                                 x.__dataclass_fields__})
    ref = integrate_batch(cpu(st), cpu(dy), cfg, 0.01, 10, nsm)
    for name, (rtol, atol) in {"pos": (2e-5, 2e-6), "vel": (2e-5, 2e-5),
                               "eps": (1e-5, 1e-6),
                               "pi": (1e-3, 5e-5)}.items():
        _close(getattr(ref, name), getattr(out, name), name, rtol, atol)


def test_chunked_engine_columns_match_plain(cuda_device):
    """use_fused_metrics=False on the multi-step kernel against the same
    engine on its plain version, column by column."""
    cfg, st, dy, tan = _built("n8_mixed", cuda_device)
    cfg = cfg.replace(use_fused_metrics=False)
    nsm = int(dy.n_sub.max())
    rk, _ = analyze_batch_fused(st, dy, cfg, 12, 0.01, "full", nsm, 6,
                                tangent=tan)
    rp, _ = analyze_batch_fused(
        st, dy, cfg, 12, 0.01, "full", nsm, 6, tangent=tan,
        megno_fn=hk.hamsoft_megno_multistep_plain,
        multistep_fn=hk.hamsoft_multistep_plain)
    assert torch.equal(rk["is_stable"], rp["is_stable"])
    for k, (rtol, atol) in TOL.items():
        _close(rp[k], rk[k], k, rtol, atol)


def _planets(B, n, device, seed=17):
    """The WHFast planetary systems (unit central mass, 1e-3 planets at
    radii 1, 2, ...), float32 on the card; with ``n`` = 4 the last slot is
    a zero-mass padded body at the origin."""
    rng = np.random.default_rng(seed)
    live = min(n, 3)
    q = np.zeros((B, n, 2))
    v = np.zeros((B, n, 2))
    for i in range(1, live):
        q[:, i, 0] = float(i)
        v[:, i, 1] = 1.0 / np.sqrt(float(i))
    q[:, :live] += 0.01 * rng.normal(size=(B, live, 2))
    v[:, :live] += 0.01 * rng.normal(size=(B, live, 2))
    m = np.zeros((B, n))
    m[:, 0] = 1.0
    m[:, 1:live] = 1e-3
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return f(q), f(v), f(m), torch.full((B,), 1e-6, device=device)


#: the WHFast padded slot: the kernel's distance to the float64 plain
#: run, at the median system and at the worst, at most this many times
#: the float32 plain version's (chip_smoke.py holds the tiled force
#: kernel to its float64 plain version the same way, FORCE_ERR_FACTOR)
WH_PAD_FACTOR = 2.0


def _as_accurate_as_plain(p, k, p64, name):
    """``k`` finite exactly where the float32 plain version ``p`` is, and
    per system its largest distance to the float64 plain run ``p64``,
    at the median and at the worst system, within WH_PAD_FACTOR times
    that of ``p``."""
    assert torch.equal(torch.isfinite(k), torch.isfinite(p)), name
    dist = lambda x: torch.nan_to_num(
        (x.double() - p64.double()).abs(), nan=0.0).reshape(
            x.shape[0], -1).amax(1)
    dk, dp = dist(k), dist(p)
    for q in (0.5, 1.0):
        a, b = float(dk.quantile(q)), float(dp.quantile(q))
        assert a <= WH_PAD_FACTOR * b, (
            f"{name}: quantile {q} of the distance to float64: kernel "
            f"{a:.3e}, float32 plain {b:.3e}")


@pytest.mark.parametrize("n", [3, 4])
def test_whfast_kernel_matches_plain(n, cuda_device):
    """The WHFast kernel against its plain version (B = 4096, 20 steps;
    rtol 1e-5 / atol 1e-6: the kernel's FMAs and Horner-form Stumpff
    series round a few ulps a step apart from the plain version's
    expressions) on the three live bodies.  The N = 4 case's padded
    slot, a zero-mass body at the origin, falls almost radially past the
    central mass (Jacobi distance ~1e-2, period ~2e-3 < h): there the
    float32 plain version itself lies up to ~1e2 from its float64 run
    (on ~90% of the systems beyond rtol/atol), so no float32 run is a
    reference for it.  It is held to that float64 run instead, as
    accurately as the float32 plain version (``_as_accurate_as_plain``),
    and stays inert (the live bodies bitwise as in 3 slots)."""
    from nbodysimproject_tpu_torch.ops import whfast_kernels as wk

    q, v, m, e2 = _planets(4096, n, cuda_device)
    before = wk.whfast_multistep.launches
    kw = dict(h=0.01, G=1.0, n_steps=20, iters=8)
    k = wk.whfast_multistep(q, v, m, e2, **kw)
    p = wk.whfast_multistep_plain(q, v, m, e2, **kw)
    p64 = wk.whfast_multistep_plain(*(x.double() for x in (q, v, m, e2)),
                                    **kw)
    torch.cuda.synchronize()
    assert wk.whfast_multistep.launches == before + 1
    for name, a, b, c in zip(("pos", "vel"), p, k, p64):
        _close(a[:, :3], b[:, :3], name, 1e-5, 1e-6)
        if n == 4:
            _as_accurate_as_plain(a[:, 3:], b[:, 3:], c[:, 3:],
                                  f"{name} padded slot")
    if n == 4:
        k3 = wk.whfast_multistep(q[:, :3].contiguous(), v[:, :3].contiguous(),
                                 m[:, :3].contiguous(), e2, **kw)
        for a, b in zip(k3, k):
            assert torch.equal(a, b[:, :3])


def test_whfast_kernel_matches_lc8_scan_step(cuda_device):
    """One kernel step against one D(h/2) K(h) D(h/2) substep of the
    port's WHFast scan on the same LC-8 solver (rtol 1e-5 / atol 1e-7, as
    the JAX package's kernel-versus-scan test)."""
    from nbodysimproject_tpu_torch.ops import whfast_kernels as wk

    q, v, m, _e2 = _planets(4096, 3, cuda_device)
    cfg = nt.SimConfig(integrator_mode="whfast", fast_float32=True,
                       whfast_kepler_iters=8)
    mask = torch.ones(m.shape, dtype=torch.bool, device=cuda_device)
    st, dy = build_batch(m, q, v, mask, cfg, 1.0, 1e-3, 0.0, 0.01,
                         skip_cm_recenter=True)
    dy = dy.replace(n_sub=torch.ones_like(dy.n_sub))
    ref = nt.integrate_batch(st, dy, cfg, 0.01, 1, 1)
    po, vo = wk.whfast_multistep(st.pos, st.vel, st.mass, st.step_s2,
                                 h=0.01, G=1.0, n_steps=1, iters=8)
    _close(ref.pos, po, "pos", 1e-5, 1e-7)
    _close(ref.vel, vo, "vel", 1e-5, 1e-7)


def _hier_triples(reps, device):
    """Hierarchical triples with a tight inner binary (the Kepler tail's
    systems) and wide triples (the fused engine's), ``reps`` copies."""
    out = []
    for a_in, a_out in [(0.01 * (1 + 0.1 * k), 20.0) for k in range(4)] \
            + [(1.2 + 0.1 * k, 12.0) for k in range(4)]:
        m = np.array([1.0, 0.8, 0.3])
        mu = m[0] + m[1]
        vi = np.sqrt(mu / a_in)
        q = np.array([[-m[1] / mu * a_in, 0.0], [m[0] / mu * a_in, 0.0],
                      [a_out, 0.0]])
        v = np.array([[0.0, -m[1] / mu * vi], [0.0, m[0] / mu * vi],
                      [0.0, np.sqrt((mu + m[2]) / a_out)]])
        q -= (m[:, None] * q).sum(0) / m.sum()
        v -= (m[:, None] * v).sum(0) / m.sum()
        out.append((m, q, v))
    m, q, v = (np.concatenate([np.stack([x[i] for x in out])] * reps)
               for i in range(3))
    return m, q, v, np.ones(m.shape, bool)


def test_tail_path_on_the_card(cuda_device):
    """analyze_population under the dataset configuration (tail on): the
    tail's own stream and thread give the rows of the serial run, and
    the non-tail rows those of the tail-off run, bit for bit."""
    pop = _hier_triples(16, cuda_device)
    cfg = nt.SimConfig(slot_bucket=8, fast_float32=True,
                       analysis_n_sub_cap=256, use_fused_analysis=True,
                       analysis_group_quantum=1024)
    kw = dict(G=1.0, softening=5e-3, min_softening=0.0, dt=0.01,
              n_steps=20, mode="full", show_progress=False)
    tm = {}
    on = nt.analyze_population(*pop, cfg, timing_out=tm, **kw)
    serial = nt.analyze_population(*pop, cfg, tail_stream=False, **kw)
    off = nt.analyze_population(*pop, cfg.replace(
        analysis_tail_policy="off"), **kw)
    tail = on["tail_fast_path"].to_numpy()
    assert tm["n_tail"] == 64 == int(tail.sum())
    for c in serial.columns:
        a, b = on[c].to_numpy(), serial[c].to_numpy()
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), c
    for c in off.columns:
        a, b = on[c].to_numpy()[~tail], off[c].to_numpy()[~tail]
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), c


def _force_cloud(B, n, d, dev, seed=31):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (t(rng.normal(size=(B, n, d)) * 3), t(rng.uniform(0.1, 2.0, (B, n))),
            t(rng.uniform(0.01, 0.1, B)), t(rng.uniform(0.5, 2.0, B)))


@pytest.mark.parametrize("B,n,d", [(1, 4097, 2), (1, 1000, 3), (4, 2048, 2)])
def test_pairwise_force_kernel_matches_plain(B, n, d, cuda_device):
    """The tiled force kernel against its plain version: each row's error
    from the float64 plain version over its magnitude sum S_i, the
    kernel's worst at most 4x the float32 plain version's and 1e-4 (the
    two float32 versions sum in different orders)."""
    from nbodysimproject_tpu_torch.ops import force_kernels as fk

    q, m, eps, G = _force_cloud(B, n, d, cuda_device)
    before = fk.pairwise_force.launches
    F = fk.pairwise_force(q, m, eps, G)
    assert fk.pairwise_force.launches == before + 1
    P = fk.pairwise_force_plain(q, m, eps, G)
    a64 = [x.double() for x in (q, m, eps, G)]
    P64 = fk.pairwise_force_plain(*a64)
    S = fk.magnitude_sum(*a64)
    rel = lambda X: float(((X.double() - P64).abs().amax(-1) / S).max())
    assert rel(F) <= 4.0 * rel(P) and rel(F) <= 1e-4, (rel(F), rel(P))


@pytest.mark.parametrize("B,n,sliced", [(1, 4096, True), (96, 4096, False)])
def test_pairwise_force_source_slices(B, n, sliced, cuda_device):
    """N = 4096 and B = 1 (the classical route: 16 blocks) splits the
    source tiles across blocks; B = 96 fills the card without.  Either
    way the kernel passes the gate above, and a second run gives the
    same bits."""
    from nbodysimproject_tpu_torch.ops import force_kernels as fk

    q, m, eps, G = _force_cloud(B, n, 2, cuda_device)
    S = fk.source_slices(n, B, *fk._card_slots(q.device.index, 2))
    assert (S > 1) == sliced
    F = fk.pairwise_force(q, m, eps, G)
    assert torch.equal(F, fk.pairwise_force(q, m, eps, G))
    rows = torch.arange(0, n, 5, device=cuda_device)
    a64 = [x.double() for x in (q, m, eps, G)]
    P64 = fk.pairwise_force_plain(*a64, rows=rows)
    S_i = fk.magnitude_sum(*a64, rows=rows)
    P = fk.pairwise_force_plain(q, m, eps, G, rows=rows)
    rel = lambda X: float(((X.double() - P64).abs().amax(-1) / S_i).max())
    assert rel(F[:, rows]) <= 4.0 * rel(P) and rel(F[:, rows]) <= 1e-4


def test_pairwise_force_casts_float64_and_refuses_d4(cuda_device):
    from nbodysimproject_tpu_torch.ops import force_kernels as fk

    q, m, eps, G = _force_cloud(2, 700, 2, cuda_device)
    F32 = fk.pairwise_force(q, m, eps, G)
    F64 = fk.pairwise_force(q.double(), m.double(), eps.double(), G.double())
    assert F64.dtype == torch.float64
    assert torch.equal(F64, F32.double())
    with pytest.raises(NotImplementedError):
        fk.pairwise_force(torch.zeros((1, 10, 4), device=cuda_device),
                          torch.ones((1, 10), device=cuda_device), 0.1, 1.0)


def test_largen_rollout_direct_pallas_matches_direct(cuda_device):
    """Five KDK steps of a 2048-body cloud on the tiled kernel and on the
    dense force, float32 on the card: rtol 1e-5 / atol 1e-6 (the two
    forces sum in different orders)."""
    from nbodysimproject_tpu_torch.ops import force_kernels as fk

    rng = np.random.default_rng(2)
    N = 2048
    q = rng.normal(0, 1.0, (N, 2)).astype(np.float32)
    m = (np.abs(rng.normal(1, 0.3, N)) / N).astype(np.float32)
    v = rng.normal(0, 0.3, (N, 2)).astype(np.float32)
    out = {}
    for mode in ("direct_pallas", "direct"):
        before = fk.pairwise_force.launches
        out[mode] = nt.largen_rollout(q, v, m, 0.05, 1.0, 1e-3, 5,
                                      nt.SimConfig(force_mode=mode))
        launched = fk.pairwise_force.launches - before
        assert launched == (6 if mode == "direct_pallas" else 0)
    (qk, vk, _), (qd, vd, _) = out["direct_pallas"], out["direct"]
    assert qk.device.type == "cuda"
    torch.testing.assert_close(qk, qd, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(vk, vd, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the branches of rows 1-4 and 6 added with the reflection and no-barrier
# policies of the analysis and MEGNO kernels, the "reference" gradient and
# d = 3 of the multi-step and WHFast kernels
# ---------------------------------------------------------------------------

VARIANTS = [("reflection", "exact"), ("none", "exact"), ("soft", "reference"),
            ("reflection", "reference")]


@pytest.fixture(scope="module")
def variant_builds():
    """Every build variant these tests launch, compiled together (one
    nvcc each) before the first of them runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nbodysimproject_tpu_torch.ops import cuda_build
    from nbodysimproject_tpu_torch.ops import eps_kernels as ek

    jobs = {(src, n, d, hk.variant(src, p, g)) for src in hk.SOURCES
            for n in hk.BUILD_SLOTS for d in (2, 3) for p, g in VARIANTS}
    jobs |= {(ek.SOURCE, n, d, ek.variant(True)) for n in (3, 8)
             for d in (2, 3)}
    jobs |= {("whfast.cu", 3, 3)}
    cuda_build.build(sorted(jobs))


def _lift(st, dy, cfg, device):
    """The population with a drawn z column, built again by the port."""
    rng = np.random.default_rng(21)
    z = torch.as_tensor(0.05 * rng.normal(size=st.pos.shape[:2] + (1,)),
                        dtype=torch.float32, device=device)
    q = torch.cat([st.pos, z], -1)
    v = torch.cat([st.vel, 0.1 * z], -1)
    return build_batch(st.mass, q, v, st.mask, cfg, 1.0, 0.05, 0.0, 0.01)


@pytest.mark.parametrize("policy,grad_mode", VARIANTS)
@pytest.mark.parametrize("kernel", ["analysis", "megno", "multistep"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_variant_matches_plain(case, kernel, policy, grad_mode,
                                      cuda_device, variant_builds):
    """Each kernel in each policy and gradient mode against its plain
    version, with the tolerances of the soft and exact tests above; the
    reflection policy's walls narrowed around the entry eps so that the
    folds act."""
    cfg, st, dy, tan = _built(case, cuda_device)
    kw = _kw(cfg, dy, int(dy.n_sub.max()))
    kw.update(policy=policy, grad_mode=grad_mode)
    if policy == "reflection":
        kw.update(eps_min=st.eps * 0.999, eps_max=st.eps * 1.001)
    if kernel == "multistep":
        args = (st.pos, st.vel, st.mass, st.eps, st.pi)
        ref = hk.hamsoft_multistep_plain(*args, n_steps=12, **kw)
        got = hk.hamsoft_multistep(*args, n_steps=12, **kw)
    else:
        fn = {"analysis": (hk.hamsoft_analysis_multistep_plain,
                           hk.hamsoft_analysis_multistep),
              "megno": (hk.hamsoft_megno_multistep_plain,
                        hk.hamsoft_megno_multistep)}[kernel]
        ref = _call(kernel, fn[0], st, tan, kw, 6)
        got = _call(kernel, fn[1], st, tan, kw, 6)
    torch.cuda.synchronize()
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, f"{kernel} {policy} {grad_mode} {name}")
    if kernel == "megno":
        for name, a, b in zip(("MEGNO", "lyapunov_time", "megno_slope_med"),
                              ref[4:], got[4:]):
            _close(a, b, name, *TOL[name])
    if policy == "reflection":
        assert bool(((got[2] >= kw["eps_min"]) & (got[2] <= kw["eps_max"]))
                    .all())


@pytest.mark.parametrize("policy,grad_mode", VARIANTS)
@pytest.mark.parametrize("kernel", ["analysis", "megno"])
def test_kernel_variant_trajectory_is_the_multistep_kernels(
        kernel, policy, grad_mode, cuda_device, variant_builds):
    """Under every policy and gradient mode the analysis and MEGNO
    kernels' trips equal the multi-step kernel's bit for bit (N = 3: the
    warp physics against the one-thread physics; N = 8: the same warp
    physics)."""
    for case in ("n3", "n8_mixed"):
        cfg, st, dy, tan = _built(case, cuda_device)
        kw = _kw(cfg, dy, int(dy.n_sub.max()))
        kw.update(policy=policy, grad_mode=grad_mode)
        fn = {"analysis": hk.hamsoft_analysis_multistep,
              "megno": hk.hamsoft_megno_multistep}[kernel]
        got = _call(kernel, fn, st, tan, kw, 3)
        ref = hk.hamsoft_multistep(st.pos, st.vel, st.mass, st.eps, st.pi,
                                   n_steps=3, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("pos", "vel", "eps", "pi"), ref, got[:4]):
            assert torch.equal(torch.isnan(a), torch.isnan(b)), name
            assert torch.equal(torch.nan_to_num(a),
                               torch.nan_to_num(b)), (case, name)


@pytest.mark.parametrize("grad_mode", ["exact", "reference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_at_d3_match_plain(case, grad_mode, cuda_device,
                                   variant_builds):
    """The multi-step kernel at d = 3 (both layouts) and the analysis
    kernel at d = 3 in both gradient modes against their plain versions,
    and the analysis kernel's trip equal to the multi-step kernel's."""
    cfg, st, dy, _tan = _built(case, cuda_device)
    st, dy = _lift(st, dy, cfg, cuda_device)
    kw = _kw(cfg, dy, int(dy.n_sub.max()))
    kw.update(grad_mode=grad_mode)
    args = (st.pos, st.vel, st.mass, st.eps, st.pi)
    ref = hk.hamsoft_multistep_plain(*args, n_steps=6, **kw)
    got = hk.hamsoft_multistep(*args, n_steps=6, **kw)
    L0 = (st.mass[..., None] * torch.linalg.cross(st.pos, st.vel,
                                                  dim=-1)).sum(1)
    ana = hk.hamsoft_analysis_multistep(*args, L0, n_steps=6, interval=2,
                                        **kw)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("pos", "vel", "eps", "pi"), ref, got, ana):
        _close(a, b, f"d3 {grad_mode} {name}")
        assert torch.equal(torch.nan_to_num(b), torch.nan_to_num(c)), name


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eps_kernel_fallback_matches_plain(case, clamp, d, cuda_device,
                                           variant_builds):
    """The eps kernel's "reference" fallback (``use_fallback``) against
    its plain version, eps* to rtol 1e-6 and the gradient to rtol 1e-5 /
    atol 1e-5, on the populations above and on the same systems spread
    out 50 times (the SPH clip saturates there: the fallback fires)."""
    from nbodysimproject_tpu_torch.ops import eps_kernels as ek

    cfg, st, dy, _tan = _built(case, cuda_device)
    if d == 3:
        st, dy = _lift(st, dy, cfg, cuda_device)
    pos = torch.cat([st.pos, 50.0 * st.pos], 0)
    rows = (st.eps, dy.alpha_run, dy.min_softening, dy.max_softening)
    rows = tuple(torch.cat([x, x], 0) for x in rows)
    args = (pos, torch.cat([st.mass] * 2, 0), *rows,
            torch.cat([st.mask] * 2, 0))
    before = ek.eps_star_and_grad_fused.launches
    es0, g0 = ek.eps_star_and_grad_fused_plain(*args, clamp=clamp,
                                               use_fallback=True)
    es1, g1 = ek.eps_star_and_grad_fused(*args, clamp=clamp,
                                         use_fallback=True)
    _es, gx = ek.eps_star_and_grad_fused_plain(*args, clamp=clamp,
                                               use_fallback=False)
    torch.cuda.synchronize()
    assert ek.eps_star_and_grad_fused.launches == before + 1
    _close(es0, es1, "eps*", rtol=1e-6, atol=0.0)
    _close(g0, g1, "grad", rtol=1e-5, atol=1e-5)
    assert bool(((g0 - gx).abs().amax((1, 2)) > 0).any())


@pytest.mark.parametrize("clamp", [False, True])
def test_eps_layouts_give_the_same_bits_with_the_fallback(clamp, cuda_device,
                                                          variant_builds):
    """The eps kernel's two layouts under ``use_fallback``: 3-body systems
    in 3 slots and padded to 8 give equal bits, the fallback's median,
    Omega and legacy gradients included."""
    from nbodysimproject_tpu_torch.ops import eps_kernels as ek

    rng = np.random.default_rng(3)
    B = 256
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
    scale = np.where(np.arange(B) % 2 == 0, 0.05, 5.0)[:, None, None]
    st, dy = build_batch(
        f(rng.uniform(0.2, 1.0, size=(B, 3))),
        f(scale * rng.normal(size=(B, 3, 2))),
        f(0.3 * rng.normal(size=(B, 3, 2))),
        torch.ones((B, 3), dtype=torch.bool, device=cuda_device),
        nt.SimConfig(fast_float32=True), 1.0, 0.05, 0.0, 0.01)
    pad = lambda x: torch.cat([x, torch.zeros_like(x[:, :1]).expand(
        (-1, 5) + tuple(x.shape[2:]))], 1)
    rows = (st.eps, dy.alpha_run, dy.min_softening, dy.max_softening)
    es3, g3 = ek.eps_star_and_grad_fused(st.pos, st.mass, *rows, st.mask,
                                         clamp=clamp, use_fallback=True)
    es8, g8 = ek.eps_star_and_grad_fused(pad(st.pos), pad(st.mass), *rows,
                                         pad(st.mask), clamp=clamp,
                                         use_fallback=True)
    _e, gx = ek.eps_star_and_grad_fused(st.pos, st.mass, *rows, st.mask,
                                        clamp=clamp, use_fallback=False)
    torch.cuda.synchronize()
    bits = lambda x: x.contiguous().view(torch.int32)
    assert torch.equal(bits(es3), bits(es8))
    assert torch.equal(bits(g3), bits(g8[:, :3]))
    assert bool((g8[:, 3:] == 0).all())
    assert bool(((g3 - gx).abs().amax((1, 2)) > 0).any())


def test_whfast_kernel_d3_matches_plain(cuda_device, variant_builds):
    """The WHFast kernel at d = 3 on inclined planetary systems (B = 4096,
    20 steps) against its plain version, rtol 1e-5 / atol 1e-6 as at
    d = 2."""
    from nbodysimproject_tpu_torch.ops import whfast_kernels as wk

    q, v, m, e2 = _planets(4096, 3, cuda_device)
    rng = np.random.default_rng(9)
    inc = torch.as_tensor(rng.uniform(0.0, 0.1, (4096, 3, 1)),
                          dtype=torch.float32, device=cuda_device)
    q = torch.cat([q, q[..., :1] * inc], -1)
    v = torch.cat([v, v[..., 1:] * inc], -1)
    kw = dict(h=0.01, G=1.0, n_steps=20, iters=8)
    before = wk.whfast_multistep.launches
    k = wk.whfast_multistep(q, v, m, e2, **kw)
    p = wk.whfast_multistep_plain(q, v, m, e2, **kw)
    torch.cuda.synchronize()
    assert wk.whfast_multistep.launches == before + 1
    for name, a, b in zip(("pos", "vel"), p, k):
        _close(a, b, name, 1e-5, 1e-6)
