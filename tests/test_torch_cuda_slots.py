"""The ham_soft analysis, MEGNO and multi-step kernels at every slot count
from 2 to 16, on the card, against their plain PyTorch versions.

The kernels lay a system over the lanes of one warp: four lanes a body
up to N = 8 (two systems a warp at N = 3 and 4, four at N = 2), two from
N = 9 to 16 (a warp a system), the multi-step kernel one thread a system
at N = 2 and 3 (``csrc/hamsoft_physics_warp.cuh``,
``csrc/hamsoft_multistep.cu``).  Each (kernel, N, d), N = 2..16 and
d = 2, 3, runs a numpy-seeded population of B = 64 systems, each of
ceil(N / 2) to N bodies on a line (the other slots masked), built by the
port in float32 (n_sub capped at 4), and is held to its plain version
with the tolerances of
``tests/test_torch_cuda.py``: the final pos, vel, eps and pi to rtol
1e-4 / atol 1e-5, the analysis accumulators to rtol 1e-3, the MEGNO
summaries to the fused-vs-scan tolerances of ``tests/test_pallas_batch.py``.
``test_build_report`` prints each build's registers, spills, shared bytes
per block and resident warps per multiprocessor (``hamsoft_kernels.
occupancy``) and holds every build at N <= 8 to 0 bytes spilled.  The
reflection fold and the "reference" gradient (the "refl" and "ref"
build variants) are held the same way at N = 5, 12 and 16, d = 2 and 3
(``test_branch_at_new_slot_counts``).  The multi-step kernel's warp
layout keeps the one-thread order in every sum: at N = 5, 9 and 16 its
final states are bit for bit its one-thread layout's (the build variant
"thread"), under both policies (``test_warp_layout_is_one_thread_order``).

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one;
the file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_slots.py -m cuda --noconftest -s

The builds of the selected tests start together, 16 ``nvcc`` at a time,
before the first test runs.
"""

import re

import numpy as np
import pytest
import torch

import nbodysimproject_tpu_torch as nt
from nbodysimproject_tpu_torch.diagnostics.energy import angular_momentum_z
from nbodysimproject_tpu_torch.diagnostics.megno import (init_tangent,
                                                         population_normals)
from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
from nbodysimproject_tpu_torch.parallel.batch_engine import build_batch

pytestmark = pytest.mark.cuda

SLOTS = tuple(range(hk.SLOTS[0], hk.SLOTS[1] + 1))
DIMS = hk.DIMS
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
#: per-column (rtol, atol) of tests/test_pallas_batch.py:258-277
MEGNO_TOL = {"MEGNO": (1e-3, 1e-4), "lyapunov_time": (1e-2, 0.0),
             "megno_slope_med": (5e-3, 1e-3)}
#: nvcc processes at a time
BUILD_BATCH = 16
#: the trips a step of every test (h = dt / n_sub)
N_SUB_CAP = 4


def _jobs_of(item):
    """The builds a test of this file launches: (source, n, d, variant)."""
    spec = getattr(item, "callspec", None)
    if spec is None or "n" not in spec.params:
        return []
    p = spec.params
    jobs = [(src, p["n"], p["d"], hk.variant(src, p.get("policy", "soft"),
                                             p.get("grad_mode", "exact")))
            for src in hk.SOURCES]
    if item.originalname == "test_warp_layout_is_one_thread_order":
        jobs.append((hk.SOURCES[1], p["n"], p["d"],
                     hk.variant(hk.SOURCES[1], "soft", "exact", True)))
    return jobs


@pytest.fixture(scope="module")
def builds(request):
    """The libraries the selected tests of this file launch, built before
    the first: {(source, n, d, variant): ptxas report}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nbodysimproject_tpu_torch.ops import cuda_build

    jobs = sorted({j for item in request.session.items
                   if item.module is request.module for j in _jobs_of(item)})
    out = {}
    for k in range(0, len(jobs), BUILD_BATCH):
        built = cuda_build.build(jobs[k:k + BUILD_BATCH])
        out.update({job: report for job, (_p, _s, report) in built.items()})
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _population(n, d, B=64, seed=17):
    """Systems of ceil(n / 2) to n bodies (the rest masked) on a line
    1.2 apart with small random offsets and velocities, built by the
    port in float32 with their MEGNO tangents."""
    rng = np.random.default_rng(seed + 31 * n + d)
    counts = rng.integers(max(2, -(-n // 2)), n + 1, B)
    mask = np.arange(n)[None, :] < counts[:, None]
    q = 0.05 * rng.normal(size=(B, n, d))
    q[..., 0] += np.arange(n) * 1.2
    v = 0.2 * rng.normal(size=(B, n, d))
    m = rng.uniform(0.2, 1.0, size=(B, n))
    m = np.where(mask, m, 0.0)
    q, v = (np.where(mask[..., None], a, 0.0) for a in (q, v))
    dev = torch.device("cuda")
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    cfg = nt.SimConfig(fast_float32=True)
    states, dyns = build_batch(f(m), f(q), f(v),
                               torch.as_tensor(mask, device=dev), cfg, 1.0,
                               0.05, 0.0, 0.01)
    z1, z2 = population_normals(5, B, (n, d), torch.float32)
    return cfg, states, dyns, init_tangent(z1.to(dev), z2.to(dev), states)


def _kw(cfg, dyns, dt=0.01):
    """The kernels' arguments, n_sub capped at N_SUB_CAP (the 16-body
    lines ask for up to ~100 trips a step, which the plain version would
    run one eager trip at a time)."""
    n_sub = torch.clamp(dyns.n_sub, 1, N_SUB_CAP)
    return dict(k_soft=dyns.k_soft, mu=dyns.mu_soft, alpha=dyns.alpha_run,
                eps_min=dyns.min_softening, eps_max=dyns.max_softening,
                h=dt / n_sub.to(torch.float32), n_sub=n_sub,
                n_sub_max=int(n_sub.max()), G=1.0, k_wall=float(cfg.k_wall),
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


def _l0(states):
    """L0 as the kernels take it: L_z at d = 2, the L vector at d = 3."""
    if states.pos.shape[-1] == 2:
        return angular_momentum_z(states)
    m = torch.where(states.mask, states.mass, torch.zeros_like(states.mass))
    return (m[..., None] * torch.linalg.cross(states.pos, states.vel,
                                              dim=-1)).sum(-2)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", SLOTS)
def test_analysis_kernel_at_every_slot_count(n, d, builds, cuda_device):
    cfg, st, dy, _tan = _population(n, d)
    kw = _kw(cfg, dy)
    args = (st.pos, st.vel, st.mass, st.eps, st.pi, _l0(st))
    before = hk.hamsoft_analysis_multistep.launches
    ref = hk.hamsoft_analysis_multistep_plain(*args, n_steps=8, interval=2,
                                              **kw)
    got = hk.hamsoft_analysis_multistep(*args, n_steps=8, interval=2, **kw)
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


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", SLOTS)
def test_megno_kernel_at_every_slot_count(n, d, builds, cuda_device):
    cfg, st, dy, (dr0, dv0) = _population(n, d)
    kw = _kw(cfg, dy)
    args = (st.pos, st.vel, st.mass, st.eps, st.pi, dr0, dv0)
    before = hk.hamsoft_megno_multistep.launches
    ref = hk.hamsoft_megno_multistep_plain(*args, dt=0.01, n_steps=6, **kw)
    got = hk.hamsoft_megno_multistep(*args, dt=0.01, n_steps=6, **kw)
    torch.cuda.synchronize()
    assert hk.hamsoft_megno_multistep.launches == before + 1
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, name)
    for name, a, b in zip(MEGNO_TOL, ref[4:], got[4:]):
        _close(a, b, name, *MEGNO_TOL[name])


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", SLOTS)
def test_multistep_kernel_at_every_slot_count(n, d, builds, cuda_device):
    """Under the soft and the reflection policy (one build holds both);
    the analysis kernel's final state on the same inputs bit for bit."""
    cfg, st, dy, _tan = _population(n, d)
    kw = _kw(cfg, dy)
    args = (st.pos, st.vel, st.mass, st.eps, st.pi)
    for policy in ("soft", "reflection"):
        before = hk.hamsoft_multistep.launches
        ref = hk.hamsoft_multistep_plain(*args, n_steps=8, policy=policy,
                                         **kw)
        got = hk.hamsoft_multistep(*args, n_steps=8, policy=policy, **kw)
        torch.cuda.synchronize()
        assert hk.hamsoft_multistep.launches == before + 1
        for name, a, b in zip(("pos", "vel", "eps", "pi"), ref, got):
            _close(a, b, f"{policy} {name}")
    ana = hk.hamsoft_analysis_multistep(*args, _l0(st), n_steps=8,
                                        interval=2, **kw)
    got = hk.hamsoft_multistep(*args, n_steps=8, **kw)
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ana[:4], got):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name


def _ptxas(report):
    ints = lambda pat: [int(x) for x in re.findall(pat, report)]
    return (ints(r"Used (\d+) registers"),
            ints(r"(\d+) bytes spill (?:stores|loads)"))


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", SLOTS)
def test_build_report(n, d, builds, cuda_device):
    """Each build's registers, spills, shared bytes per block and
    resident warps per multiprocessor, printed; 0 bytes spilled at
    N <= 8."""
    card = torch.cuda.get_device_name(0)
    for src in hk.SOURCES:
        regs, spills = _ptxas(builds[(src, n, d, "")])
        occ = hk.occupancy(src, n, d)
        print(f"\n{card}: {src} N={n} d={d}: registers {regs}, spilled "
              f"{spills} bytes (stores, loads), shared bytes / resident "
              f"warps per SM {occ}")
        assert len(regs) == 2 and len(spills) == 4
        if n <= 8:
            assert not any(spills), f"{src} N={n} d={d} spills: {spills}"
        for smem, warps in occ.values():
            assert warps > 0, f"{src} N={n} d={d}: no block fits an SM"


#: the slot counts of the branch tests: one of each layout class outside
#: N = 3, 4 and 8 (``tests/test_torch_cuda.py`` holds those)
VARIANT_SLOTS = (5, 12, 16)
VARIANTS = [("reflection", "exact"), ("soft", "reference")]


@pytest.mark.parametrize("policy,grad_mode", VARIANTS)
@pytest.mark.parametrize("kernel", ["analysis", "megno", "multistep"])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", VARIANT_SLOTS)
def test_branch_at_new_slot_counts(n, d, kernel, policy, grad_mode, builds,
                                   cuda_device):
    """The reflection fold and the "reference" gradient (build variants
    "refl" and "ref") of each kernel against its plain version, as
    ``tests/test_torch_cuda.py`` holds them at N = 3, 4 and 8: the
    reflection policy's walls narrowed around the entry eps so that the
    folds act, the final eps inside them."""
    cfg, st, dy, tan = _population(n, d)
    kw = _kw(cfg, dy)
    kw.update(policy=policy, grad_mode=grad_mode)
    if policy == "reflection":
        kw.update(eps_min=st.eps * 0.999, eps_max=st.eps * 1.001)
    if kernel == "multistep":
        args = (st.pos, st.vel, st.mass, st.eps, st.pi)
        ref = hk.hamsoft_multistep_plain(*args, n_steps=8, **kw)
        got = hk.hamsoft_multistep(*args, n_steps=8, **kw)
    elif kernel == "analysis":
        args = (st.pos, st.vel, st.mass, st.eps, st.pi, _l0(st))
        ref = hk.hamsoft_analysis_multistep_plain(*args, n_steps=6,
                                                  interval=1, **kw)
        got = hk.hamsoft_analysis_multistep(*args, n_steps=6, interval=1,
                                            **kw)
    else:
        args = (st.pos, st.vel, st.mass, st.eps, st.pi, *tan)
        ref = hk.hamsoft_megno_multistep_plain(*args, dt=0.01, n_steps=6,
                                               **kw)
        got = hk.hamsoft_megno_multistep(*args, dt=0.01, n_steps=6, **kw)
        for name, a, b in zip(MEGNO_TOL, ref[4:], got[4:]):
            _close(a, b, name, *MEGNO_TOL[name])
    torch.cuda.synchronize()
    for name, a, b in zip(("pos", "vel", "eps", "pi"), ref[:4], got[:4]):
        _close(a, b, f"{kernel} {policy} {grad_mode} {name}")
    if policy == "reflection":
        assert bool(((got[2] >= kw["eps_min"]) & (got[2] <= kw["eps_max"]))
                    .all())


#: the slot counts of the layout test: one of each warp layout class
#: outside N = 4 and 8 (four lanes a body with fewer slots than lanes,
#: two lanes a body at its fewest and most slots); its one-thread builds
#: take minutes of ``nvcc`` at N = 16
LAYOUT_SLOTS = (5, 9, 16)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n", LAYOUT_SLOTS)
def test_warp_layout_is_one_thread_order(n, d, builds, cuda_device):
    """The multi-step kernel's warp layout against its one-thread layout
    (``one_thread=True``) on the same inputs, bit for bit, under the soft
    and the reflection policy."""
    cfg, st, dy, _tan = _population(n, d)
    kw = _kw(cfg, dy)
    args = (st.pos, st.vel, st.mass, st.eps, st.pi)
    for policy in ("soft", "reflection"):
        warp = hk.hamsoft_multistep(*args, n_steps=8, policy=policy, **kw)
        thread = hk.hamsoft_multistep(*args, n_steps=8, policy=policy,
                                      one_thread=True, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("pos", "vel", "eps", "pi"), warp, thread):
            assert torch.equal(torch.isnan(a), torch.isnan(b)), name
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), \
                f"{policy} {name}"
