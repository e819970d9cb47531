#!/usr/bin/env python3
"""Witnesses of the ham_soft kernels at N = 16 (two lanes a body), and
the analysis kernel's launch bound, on one NVIDIA GPU.

    python3 tools/hamsoft_slot_probe.py [witness] [bounds] [--steps S]

``witness`` (the default): ``chip_smoke.py``'s ``witness_case`` with
the one-thread layout added, reported and not gated, on the drawn
populations of its phase 25 (9 to 16 bodies in 16 slots, seeded; the
1024 shallowest systems) at d = 2 (soft barrier, exact gradient) and
d = 3 (the reflection fold; the "reference" gradient), S analysis steps
(default 20) and S / 2 MEGNO steps: the analysis and MEGNO kernels'
final states against the multi-step kernel's warp layout over the same
trips, and that against its one-thread layout (``one_thread=True``, the
order every layout keeps), bit for bit; each row's distance to the
float64 plain run from the kernel and from the float32 plain version in
three body orders; the rows each leaves non-finite.  The one-thread
builds at N = 16 take 3-5 minutes of ``nvcc`` each.

``bounds``: the analysis kernel at N = 3, 4 and 8 (d = 2 and 3) built
from the sources (one resident block a multiprocessor asked for) and
from a copy whose analysis kernel leaves the register count to ptxas:
the registers and spills of each, and at N = 8 and 3 the fused call of
``analyze_population`` (``_PIPE_CFG``, tail off, 100 steps) on the
dataset rows that fit, one warm-up run, then the sources, the copy, the
copy, the sources.

Prints a JSON line per part.
"""

import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: the witness populations: label, d, seed, SimConfig changes
POPS = (("d=2 soft exact", 2, cs.SLOT_POP_SEED, {}),
        ("d=3 refl", 3, cs.SLOT_POP_SEED + 2, dict(use_soft_barrier=False)),
        ("d=3 ref", 3, cs.SLOT_POP_SEED + 2,
         dict(eps_grad_mode="reference")))
WITNESS_JOBS = [("hamsoft.cu", 16, 2), ("hamsoft_multistep.cu", 16, 2),
                ("hamsoft_multistep.cu", 16, 2, "thread"),
                ("hamsoft.cu", 16, 3, "refl"), ("hamsoft.cu", 16, 3, "ref"),
                ("hamsoft_multistep.cu", 16, 3),
                ("hamsoft_multistep.cu", 16, 3, "ref"),
                ("hamsoft_multistep.cu", 16, 3, "thread"),
                ("hamsoft_multistep.cu", 16, 3, "ref_thread")]


def tangent_of(st):
    from nbodysimproject_tpu_torch.diagnostics.megno import (
        init_tangent, population_normals)

    z1, z2 = population_normals(7, st.pos.shape[0], tuple(st.pos.shape[1:]),
                                torch.float32)
    return init_tangent(z1.to(st.pos.device), z2.to(st.pos.device), st)


def report_builds(jobs):
    from nbodysimproject_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build(jobs)
    print(f"builds: {time.perf_counter() - t0:.1f}s wall", flush=True)
    for job in jobs:
        print(f"  {cuda_build.job_name(job)}: "
              + "; ".join(f"{k} {r} registers, {sp} bytes spilled"
                          for k, _f, r, sp in cs.ptxas_entries(
                              built[job][2])), flush=True)
    return built


def witness(steps, dev):
    from nbodysimproject_tpu_torch import SimConfig
    from nbodysimproject_tpu_torch.analysis.batch import prepare_population
    from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk

    report_builds(WITNESS_JOBS)
    for label, d, seed, over in POPS:
        cfg = SimConfig(**cs.PIPE_OFF).replace(**over)
        m, q, v, msk = cs.drawn_population(
            cs.SLOT_POP_B, cs.SLOT_POP_COUNTS, cs.SLOTS_PAD, d, seed, dev)
        st, dy, nsr = prepare_population(m, q, v, msk, cfg, G=1.0,
                                         softening=0.05, min_softening=0.0,
                                         dt=cs.DT, device=dev)
        res = cs.witness_case(label, st, dy, nsr, cfg, hk, tangent_of, steps,
                              one_thread=True, gate=False)
        print(json.dumps({"witness": label, **res}), flush=True)


BOUND_SLOTS = (3, 4, 8)
ONE_BLOCK = "__launch_bounds__(kBlock, 1) analysis_kernel("


def ptxas_choice_sources(dst):
    """A copy of the kernel sources whose analysis kernel leaves its
    register count to ptxas (no minimum of resident blocks)."""
    from nbodysimproject_tpu_torch.ops import cuda_build

    if os.path.isdir(dst):
        shutil.rmtree(dst)
    shutil.copytree(cuda_build.CSRC, dst)
    path = os.path.join(dst, "hamsoft.cu")
    with open(path) as fh:
        src = fh.read()
    if ONE_BLOCK not in src:
        raise SystemExit("bounds: the analysis kernel's launch bound is not "
                         "in hamsoft.cu as expected")
    with open(path, "w") as fh:
        fh.write(src.replace(ONE_BLOCK,
                             "__launch_bounds__(kBlock) analysis_kernel("))


def use_sources(csrc, hk, cuda_build):
    cuda_build.CSRC = csrc
    cuda_build.load.cache_clear()
    hk._library.cache_clear()


def bounds(dev):
    from nbodysimproject_tpu_torch import SimConfig, analyze_population
    from nbodysimproject_tpu_torch.ops import cuda_build
    from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk

    src = cuda_build.CSRC
    alt = os.path.join(cuda_build.BUILD_DIR, "ptxas_choice_csrc")
    ptxas_choice_sources(alt)
    jobs = [("hamsoft.cu", n, d) for n in BOUND_SLOTS for d in (2, 3)]
    regs = {}
    for name, csrc in (("sources", src), ("ptxas' choice", alt)):
        use_sources(csrc, hk, cuda_build)
        built = cuda_build.build(jobs)
        for job in jobs:
            regs[f"{name} {cuda_build.job_name(job)}"] = [
                (k, r, sp) for k, _f, r, sp in cs.ptxas_entries(
                    built[job][2])]
    print(json.dumps({"bounds ptxas": regs}), flush=True)

    (mass, pos, vel, mask, G, soft, min_soft), _ref = cs.load_population(
        cs.B_MAIN)
    cfg = SimConfig(**cs.PIPE_OFF)
    times = {}
    for n in (8, 3):
        rows = np.nonzero(~mask[:, n:].any(1))[0]
        cut = lambda a: a[rows, :n]
        per = lambda a: a[rows] if np.ndim(a) else a
        args = (cut(mass), cut(pos), cut(vel), cut(mask), cfg)
        kw = dict(G=per(G), softening=per(soft), min_softening=per(min_soft),
                  dt=cs.DT, n_steps=100, mode="full", show_progress=False)
        for name, csrc in (("warm-up", src), ("sources", src),
                           ("ptxas' choice", alt), ("ptxas' choice", alt),
                           ("sources", src)):
            use_sources(csrc, hk, cuda_build)
            tm = {}
            analyze_population(*args, timing_out=tm, **kw)
            times.setdefault(f"N={n} {name}", []).append(tm["fused_ms"])
        times[f"N={n} rows"] = len(rows)
    use_sources(src, hk, cuda_build)
    print(json.dumps({"bounds fused_ms": times}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("hamsoft_slot_probe: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    steps = int(args[args.index("--steps") + 1]) if "--steps" in args else 20
    parts = [a for a in args if a in ("witness", "bounds")] or ["witness"]
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    if "bounds" in parts:
        bounds(dev)
    if "witness" in parts:
        witness(steps, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
