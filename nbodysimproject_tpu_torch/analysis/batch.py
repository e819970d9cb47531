"""Batched stability analysis over a system population.

Counterpart of ``nbodysimproject_tpu/analysis/batch.py``
(``analyze_population``; parity:
``minbody/batch_stability_analyzer.py:30-102``).  The population is one
set of ``(B, N, d)`` tensors, built in one batched construction and
analysed by the fused engine in one call, its lanes ordered by n_sub
bucket on the ladder (``dispatch_plan``).  The kernels run each lane's
own n_sub, so a row does not depend on the lanes beside it.

Left out, because they are specific to the TPU or to ``jax.export``:
the group packing (``_pack_groups``) and the fixed-width chunk padding
(``_chunks``, ``analysis_group_quantum``), which on the TPU bound the
masked trips of a dispatch and here would only add duplicate lanes; the
``_pack_result``/``_drain_packed`` tunnel packing (the columns are
stacked on the device and fetched in one copy); the AOT program cache
(``utils/aot_cache.py``; PyTorch runs eagerly); the ``_STACK_MAX``
chunk stacking; and the early-exit probe (off in the dataset
configuration; ``early_exit_probe > 0`` raises).

The Kepler tail (``analysis_tail_policy="kepler"``, the dataset
configuration's default) takes the dominated tight binaries with a deep
frozen schedule off the fused call (``_tail_selection``): they run the
scan engine (``analysis/stability.py::analyze_batch``) under
``integrator_mode="kepler_split"`` at the outer timescale's n_sub, on
their own CUDA stream, while the fused kernel runs the other lanes
exactly as with the tail off.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..core.device import dtype_of, resolve_device
from ..diagnostics import features as F
from ..diagnostics.megno import init_tangent, population_normals
from ..integrators import calibration as calib
from ..integrators.kepler_split import pair_timescales_sq
from ..ops.hamsoft_kernels import hamsoft_analysis_multistep
from ..parallel.batch_engine import build_batch
from .fused import analyze_batch_fused, fused_config_covered
from .stability import analyze_batch


def _n_sub_cap(cfg) -> int:
    cap = int(getattr(cfg, "analysis_n_sub_cap", 0) or 0)
    return cap if cap > 0 else int(cfg.split_n_max)


#: substep-count bucket ladder (~1.5x steps; 1..4 exact)
_BUCKET_LADDER = np.asarray([1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64,
                             96, 128, 192, 256, 384, 512, 768, 1024])


def _bucket_ladder_values(n_subs: np.ndarray) -> np.ndarray:
    """Round each n_sub up to the next ladder value (exact above the
    ladder's top)."""
    n = np.maximum(np.asarray(n_subs, np.int64), 1)
    idx = np.searchsorted(_BUCKET_LADDER, n, side="left")
    return np.where(idx < len(_BUCKET_LADDER),
                    _BUCKET_LADDER[np.minimum(idx, len(_BUCKET_LADDER) - 1)],
                    n)


def dispatch_plan(n_sub_raw, cfg):
    """(rows, n_sub_max, n_groups) of the one engine call: the systems
    in n_sub-bucket order (stable, so a warp's lanes have similar
    depth), the largest capped n_sub, and the number of buckets."""
    n_subs = np.minimum(n_sub_raw, _n_sub_cap(cfg))
    buckets = _bucket_ladder_values(n_subs)
    return (np.argsort(buckets, kind="stable"), max(1, int(n_subs.max())),
            len(np.unique(buckets)))


def _pair_dominance(states, dyns):
    """(tau_min^2, tau_second^2) per system as float64 host arrays, for
    the tail's eligibility decision (integrators/kepler_split.py)."""
    _ei, _ej, t1, t2 = pair_timescales_sq(states.pos, states.mass, dyns.G,
                                          states.mask)
    return (t1.double().cpu().numpy(), t2.double().cpu().numpy())


def _tail_selection(states, dyns, cfg, n_sub_raw, dt):
    """The tail policy (batch.py:340-377 of the JAX package): which
    systems go to the kepler_split fast path, and with what substep
    count.  Eligible: frozen-schedule demand >= cfg.tail_min_n_sub and
    the tightest pair's timescale dominating every other pair's by
    cfg.tail_dominance_margin (a 2-body system always is).  The fast
    schedule resolves the outer timescale only,
    n = ceil(|dt| / 0.9 tau_second), capped; a system is rerouted only
    if n * cfg.tail_min_gain <= its capped demand.  Returns (sel, n_tail)
    host arrays."""
    B = n_sub_raw.shape[0]
    sel = np.zeros(B, bool)
    n_tail = np.ones(B, np.int64)
    if getattr(cfg, "analysis_tail_policy", "off") != "kepler":
        return sel, n_tail
    elig = n_sub_raw >= int(cfg.tail_min_n_sub)
    if not elig.any():
        return sel, n_tail
    t1, t2 = _pair_dominance(states, dyns)
    margin2 = float(cfg.tail_dominance_margin) ** 2
    dominated = t2 > margin2 * t1
    sel = elig & dominated & np.isfinite(t1) & (t1 > 0.0)
    with np.errstate(invalid="ignore", over="ignore"):
        h_out = 0.9 * np.sqrt(t2)
        n = np.ceil(np.abs(dt) / np.maximum(h_out, 1e-300))
    n = np.where(np.isfinite(n), n, 1.0)
    n_tail = np.clip(n, 1, _n_sub_cap(cfg)).astype(np.int64)
    gain = int(getattr(cfg, "tail_min_gain", 8))
    n_capped = np.minimum(n_sub_raw, _n_sub_cap(cfg))
    sel = sel & (n_tail * gain <= n_capped)
    return sel, n_tail


class _Clock:
    """Elapsed milliseconds of work issued between ``start`` and
    ``stop``: CUDA events on the current stream of a CUDA device (read
    after the work is done), the host clock on the CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            self.t1 = torch.cuda.Event(enable_timing=True)
            self.t1.record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            return self.t0.elapsed_time(self.t1)
        return 1e3 * (self.t1 - self.t0)


def serialize_ic_columns(mass, pos, vel, mask, *, G, softening,
                         min_softening, cfg) -> dict:
    """Per-body IC columns + sim metadata for a batched population
    (minbody/stability_analyzer.py:521-561): n_bodies, G, softening,
    min_softening, adaptive, integrator_mode, then mass_i, x_i, y_i,
    vx_i, vy_i per body slot (NaN on masked slots)."""
    mass, pos, vel, mask = (np.asarray(a) for a in (mass, pos, vel, mask))
    B, n_slots = mass.shape
    d = pos.shape[-1]
    axis_names = ("x", "y", "z")[:d]
    bc = lambda x: np.broadcast_to(np.asarray(x, np.float64), (B,)).copy()
    out = {
        "n_bodies": mask.sum(1).astype(np.int64),
        "G": bc(G),
        "softening": bc(softening),
        "min_softening": bc(min_softening),
        "adaptive": np.full(B, float(cfg.adaptive_softening
                                     or cfg.integrator_mode == "ham_soft")),
        "integrator_mode": np.full(B, cfg.integrator_mode, dtype=object),
    }
    nan = np.nan
    for i in range(n_slots):
        out[f"mass_{i}"] = np.where(mask[:, i], mass[:, i], nan)
    for i in range(n_slots):
        for a, name in enumerate(axis_names):
            out[f"{name}_{i}"] = np.where(mask[:, i], pos[:, i, a], nan)
    for i in range(n_slots):
        for a, name in enumerate(axis_names):
            out[f"v{name}_{i}"] = np.where(mask[:, i], vel[:, i, a], nan)
    return out


def _as_np(x):
    """A host numpy copy (for the host-side columns and schedule)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _on_device(x, dtype, device):
    """``x`` as a ``dtype`` tensor on ``device``: a tensor is converted
    where it lies and moved (no host round trip for a tensor already on
    the card), an array or scalar is copied there."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype, copy=True)
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def prepare_population(mass, pos, vel, mask, cfg, *, G, softening,
                       min_softening, dt, device):
    """Construction and schedule of a population, as the analysis runs
    it: ``build_batch``, the pi-budget mu raise for ``dt`` (ham_soft
    only, as in the JAX package) and the n_sub cap.  Inputs may be
    arrays or tensors on any device.  Returns (states, dyns, n_sub_raw)
    with the uncapped frozen n_sub as a host array."""
    dtype = dtype_of(cfg)
    t = lambda x, dt_=dtype: _on_device(x, dt_, device)
    states, dyns = build_batch(t(mass), t(pos), t(vel), t(mask, torch.bool),
                               cfg, t(G, torch.float64),
                               t(softening, torch.float64),
                               t(min_softening, torch.float64), dt)
    if cfg.integrator_mode == "ham_soft":
        mu_new = calib.calibrate_mu_from_pi_budget(
            dyns.mu_soft, dyns.k_soft, abs(dt), cfg.theta_imp)
        dyns = dyns.replace(mu_soft=mu_new)
    n_sub_raw = dyns.n_sub.cpu().numpy()
    dyns = dyns.replace(n_sub=torch.clamp_max(dyns.n_sub, _n_sub_cap(cfg)))
    return states, dyns, n_sub_raw


def ic_feature_frame(mass, pos, vel, mask, cfg, *, G=1.0, softening=0.05,
                     min_softening=0.0, dt=0.01, include_ics=True,
                     device=None):
    """The pre-integration feature frame of a fresh (B, N, d) population,
    with no integration: the per-body IC columns and sim metadata
    (``serialize_ic_columns``), the ``initial_*`` static features and
    the frozen-schedule columns (n_sub, n_sub_capped).  The JAX
    package's ``ic_feature_frame``: the same construction
    (``prepare_population``, whose mu raise is ham_soft-only there too)
    and the same host copies as ``analyze_population``, so these columns
    are bit for bit the ones ``analyze_population`` gives for the same
    population.  This is the fast path the product exists for: score
    new systems with a trained classifier (``ml/predict.py``) at
    feature-extraction cost.  ``device=None`` runs on the card."""
    import pandas as pd

    dev = resolve_device(device)
    g_np = np.asarray(_as_np(G), np.float64)
    states, dyns, n_sub_raw = prepare_population(
        mass, pos, vel, mask, cfg, G=g_np, softening=softening,
        min_softening=min_softening, dt=dt, device=dev)
    res_np = {}
    if include_ics:
        res_np.update(serialize_ic_columns(
            _as_np(states.mass), _as_np(states.pos),
            _as_np(_on_device(vel, dtype_of(cfg), dev)),
            _as_np(states.mask), G=g_np, softening=_as_np(softening),
            min_softening=_as_np(min_softening), cfg=cfg))
    feats = F.extract_all(states, dyns, cfg)
    res_np.update({f"initial_{k}": feats[k].cpu().numpy()
                   for k in sorted(feats)})
    res_np["n_sub"] = n_sub_raw.astype(np.int64)
    res_np["n_sub_capped"] = n_sub_raw > _n_sub_cap(cfg)
    return pd.DataFrame(res_np)


def analyze_population(mass, pos, vel, mask, cfg, *, G=1.0, softening=0.05,
                       min_softening=0.0, dt=0.01, n_steps=1000,
                       mode="core", seed=0, show_progress=True,
                       include_ics=True, id_offset=0, timing_out=None,
                       device=None, tangent=None, tail_stream=True):
    """Batched population analysis on the fused kernels, with the Kepler
    tail on the scan engine; returns a pandas DataFrame with the JAX
    package's columns.

    ``mass``/``mask`` (B, N), ``pos``/``vel`` (B, N, d) arrays or
    tensors; ``softening`` / ``G`` / ``min_softening`` scalars or (B,).
    ``device``: ``None`` runs on the current CUDA device and raises
    without one; ``"cpu"`` runs the kernels' plain versions.

    MEGNO tangent vectors: by default one ``(B, N, d)`` normal pair is
    drawn for the population from ``seed`` (``torch.Generator``) and
    indexed by global system id (``id_offset + i``), so a system's draw
    does not depend on its chunk.  ``tangent=(dr0, dv0)`` passes
    finished (B, N, d) tangent vectors instead (e.g. the JAX package's
    ``init_tangent`` draws, which torch cannot reproduce).

    With ``analysis_tail_policy="kepler"`` the systems of
    ``_tail_selection`` run the scan engine under kepler_split.  With
    ``tail_stream`` (the default) the fused analysis kernel is launched
    first and the tail is issued right after it, on a CUDA device on its
    own stream, so that its small kernels fill the SMs the fused launch
    leaves idle; ``tail_stream=False`` runs the tail after the fused
    call, on the same stream.  Rows do not depend on the choice.

    ``timing_out``: optional dict that receives the wall-clock phases
    setup_s (construction + scheduling), dispatch_s (the engine calls),
    drain_s (the device -> host copy, which waits for the device),
    frame_s (DataFrame assembly), n_groups (n_sub buckets),
    n_dispatches (engine calls), and the device milliseconds of the
    fused call (fused_ms) and of the tail engine (tail_ms, 0 without a
    tail) with the tail's system count (n_tail).
    """
    import pandas as pd

    t_setup0 = time.perf_counter()
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    if float(getattr(cfg, "early_exit_probe", 0.0) or 0.0) > 0.0:
        raise NotImplementedError(
            "analyze_population: the early-exit probe is not ported")
    if not fused_config_covered(cfg, mode, dtype):
        raise NotImplementedError(
            "analyze_population: only the fused engine's configurations "
            "are ported (ham_soft, float32, the production eps* with the "
            "exact or reference gradient, core/full mode, "
            "use_fused_analysis, use_fused_megno in full mode)")
    g_np = np.asarray(_as_np(G), np.float64)
    if not (g_np.size == 1 or bool((g_np == g_np.flat[0]).all())):
        raise NotImplementedError(
            "analyze_population: non-uniform G needs the scan engine for "
            "every lane, which the port does not route yet")

    B = pos.shape[0]
    if show_progress:
        print(f"Analyzing {B} systems (batched)...")
    states, dyns, n_sub_raw = prepare_population(
        mass, pos, vel, mask, cfg, G=g_np, softening=softening,
        min_softening=min_softening, dt=dt, device=dev)
    t = lambda x: _on_device(x, dtype, dev)

    megno_steps = 0
    if mode == "full":
        n_samp = min(50, n_steps // 2)
        megno_steps = min(100, n_samp) if n_samp > 0 else 0
        if tangent is None:
            z1, z2 = population_normals(seed, id_offset + B,
                                        tuple(states.pos.shape[1:]), dtype)
            tangent = init_tangent(z1[id_offset:].to(dev),
                                   z2[id_offset:].to(dev), states)
        else:
            tangent = (t(tangent[0]), t(tangent[1]))

    # the tail's systems and their outer-timescale n_sub; the rest go to
    # the fused call in n_sub-bucket order (the plain version masks each
    # lane's trips beyond its own n_sub, which are exact identities)
    tail_sel, n_tail = _tail_selection(states, dyns, cfg, n_sub_raw, dt)
    fused_idx = np.nonzero(~tail_sel)[0]
    tail_idx = np.nonzero(tail_sel)[0]
    n_subs = np.minimum(n_sub_raw, _n_sub_cap(cfg))
    n_groups = len(np.unique(_bucket_ladder_values(
        np.where(tail_sel, n_tail, n_subs))))
    fused = tail = None
    if len(fused_idx):
        order, n_sub_max, _ = dispatch_plan(n_sub_raw[fused_idx], cfg)
        rows = fused_idx[order]
        lanes = torch.as_tensor(rows, device=dev)
        fused = dict(
            rows=rows, states=states.take(lanes), dyns=dyns.take(lanes),
            n_sub_max=n_sub_max,
            tangent=None if tangent is None else (tangent[0][lanes],
                                                  tangent[1][lanes]))
    if len(tail_idx):
        lanes = torch.as_tensor(tail_idx, device=dev)
        nt_sel = n_tail[tail_idx]
        trips = int(nt_sel.max())
        tail = dict(
            rows=tail_idx, states=states.take(lanes),
            dyns=dyns.take(lanes).replace(n_sub=torch.as_tensor(
                nt_sel.astype(np.int32), device=dev)),
            dt=torch.full((len(tail_idx),), float(dt), dtype=dtype,
                          device=dev),
            trips=trips,
            tangent=None if tangent is None else (tangent[0][lanes],
                                                  tangent[1][lanes]))
    t_setup = time.perf_counter() - t_setup0

    t_disp0 = time.perf_counter()
    cfg_tail = cfg.replace(integrator_mode="kepler_split")
    fused_clock, tail_clock = _Clock(dev), _Clock(dev)

    def run_fused(between=None):
        """The fused call; ``between`` runs once, right after the analysis
        kernel is launched and before the fused call queues anything
        behind it.  Returns (output, whether ``between`` ran)."""
        ran = []

        def analysis_fn(*args, **kw):
            out = hamsoft_analysis_multistep(*args, **kw)
            if between is not None and not ran:
                ran.append(True)
                between()
            return out

        fused_clock.start()
        r, _ = analyze_batch_fused(
            fused["states"], fused["dyns"], cfg, int(n_steps), float(dt),
            mode, fused["n_sub_max"], megno_steps,
            tangent=fused["tangent"], g_static=float(g_np.flat[0]),
            analysis_fn=analysis_fn)
        names = sorted(r)
        out = (names, torch.stack([r[k] for k in names]))
        fused_clock.stop()
        return out, bool(ran)

    def run_tail():
        tail_clock.start()
        r, _ = analyze_batch(
            tail["states"], tail["dyns"], cfg_tail, int(n_steps),
            tail["dt"], mode, tail["trips"], megno_steps,
            tangent=tail["tangent"], trips=tail["trips"])
        names = sorted(r)
        out = (names, torch.stack([r[k] for k in names]))
        tail_clock.stop()
        return out

    parts = []
    if tail_stream and fused is not None and tail is not None:
        # the tail is issued between the analysis kernel's launch and the
        # fused call's follow-up work: queued behind the long kernel, that
        # work would fill the device's launch queue and stall the tail's
        # launches until the kernel ends
        side = None
        if dev.type == "cuda":
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(main)
        box = {}

        def tail_on_side():
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                box["out"] = run_tail()

        out, ran = run_fused(tail_on_side)
        if not ran:  # use_fused_metrics=False launches no analysis kernel
            tail_on_side()
        if side is not None:
            main.wait_stream(side)
        parts += [(fused["rows"], out), (tail["rows"], box["out"])]
    else:
        if fused is not None:
            parts.append((fused["rows"], run_fused()[0]))
        if tail is not None:
            parts.append((tail["rows"], run_tail()))
    t_disp = time.perf_counter() - t_disp0

    feats = F.extract_all(states, dyns, cfg) if mode == "full" else {}
    t_drain0 = time.perf_counter()
    res_rows = {}
    for rows, (names, packed) in parts:
        host = packed.cpu().numpy()
        for i, k in enumerate(names):
            res_rows.setdefault(k, np.empty(B, host.dtype))[rows] = host[i]
    feats_rows = {f"initial_{k}": feats[k].cpu().numpy()
                  for k in sorted(feats)}
    t_drain = time.perf_counter() - t_drain0

    t_frame0 = time.perf_counter()
    res_np = {}
    if include_ics:
        res_np.update(serialize_ic_columns(
            _as_np(states.mass), _as_np(states.pos), _as_np(t(vel)),
            _as_np(states.mask),
            G=g_np, softening=_as_np(softening),
            min_softening=_as_np(min_softening), cfg=cfg))
    res_np.update(res_rows)
    res_np.update(feats_rows)
    res_np["n_sub"] = n_sub_raw.astype(np.int64)
    res_np["n_sub_capped"] = n_sub_raw > _n_sub_cap(cfg)
    if getattr(cfg, "analysis_tail_policy", "off") == "kepler":
        res_np["tail_fast_path"] = tail_sel
    df = pd.DataFrame(res_np)
    df["mode"] = mode
    bad = (~np.isfinite(df["energy_drift"])) | (df["energy_drift"].abs() > 10)
    df["pathological_energy"] = bad
    df.loc[bad, "is_stable"] = 0.0
    df["softening_policy"] = "adaptive-ham"
    df["simulation_id"] = np.arange(B)
    if timing_out is not None:
        timing_out.update(
            setup_s=t_setup, dispatch_s=t_disp, drain_s=t_drain,
            frame_s=time.perf_counter() - t_frame0,
            n_groups=n_groups, n_dispatches=len(parts),
            fused_ms=fused_clock.ms() if fused is not None else 0.0,
            tail_ms=tail_clock.ms() if tail is not None else 0.0,
            n_tail=int(len(tail_idx)))
    if show_progress:
        print(f"Completed: {B} simulations analyzed")
    return df
