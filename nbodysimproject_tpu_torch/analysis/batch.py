"""Batched stability analysis over a system population, and the
facade's batch analyzer.

Counterpart of ``nbodysimproject_tpu/analysis/batch.py``
(``analyze_population``, ``stack_sims``, ``_scheduled_dyn``,
``BatchStabilityAnalyzer``; parity:
``minbody/batch_stability_analyzer.py:30-102``).  The population is one
set of ``(B, N, d)`` tensors, built in one batched construction.  Its
systems off the Kepler tail run one engine call: the fused engine where
it covers the configuration, the scan engine elsewhere (the JAX
package's ``_engine_for``), their lanes ordered by n_sub bucket on the
ladder (``dispatch_plan``).  Both engines run each lane's own n_sub, so
a row does not depend on the lanes beside it.

Left out, because they are specific to the TPU or to ``jax.export``:
the group packing (``_pack_groups``) and the fixed-width chunk padding
(``_chunks``, ``analysis_group_quantum``), which on the TPU bound the
masked trips of a dispatch and here would only add duplicate lanes; the
TPU lane test of ``_engine_for`` (``bsz % (8 * _LANES)``); the
``_pack_result``/``_drain_packed`` tunnel packing (the columns are
stacked on the device and fetched in one copy); the AOT program cache
(``utils/aot_cache.py``; PyTorch runs eagerly); and the ``_STACK_MAX``
chunk stacking.

The Kepler tail (``analysis_tail_policy="kepler"``, the dataset
configuration's default) takes the dominated tight binaries with a deep
frozen schedule off the other lanes (``_tail_selection``): they run the
scan engine (``analysis/stability.py::analyze_batch``) under
``integrator_mode="kepler_split"`` at the outer timescale's n_sub, on
their own CUDA stream beside the fused kernel, which runs the other
lanes exactly as with the tail off.
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


#: energy drift past which the early-exit probe aborts a row (the
#: pathological-energy threshold; the JAX package's analysis/batch.py:728)
_EARLY_EXIT_DRIFT = 10.0
#: the chaos columns an aborted row leaves NaN
_CHAOS_COLS = ("MEGNO", "lyapunov_time", "megno_slope_med")


def _softening_policy(cfg) -> str:
    """The frame's softening_policy tag (batch_stability_analyzer.py)."""
    if cfg.integrator_mode == "ham_soft":
        return "adaptive-ham"
    return "adaptive-classic" if cfg.adaptive_softening else "static"


def analyze_population(mass, pos, vel, mask, cfg, *, G=1.0, softening=0.05,
                       min_softening=0.0, dt=0.01, n_steps=1000,
                       mode="core", seed=0, show_progress=True,
                       include_ics=True, id_offset=0, timing_out=None,
                       device=None, tangent=None, tail_stream=True,
                       n_population=None):
    """Batched population analysis; returns a pandas DataFrame with the
    JAX package's columns.

    ``mass``/``mask`` (B, N), ``pos``/``vel`` (B, N, d) arrays or
    tensors; ``softening`` / ``G`` / ``min_softening`` scalars or (B,).
    ``mode``: "minimal", "core" or "full".  ``device``: ``None`` runs on
    the current CUDA device and raises without one; ``"cpu"`` runs the
    kernels' plain versions.

    The engine (the JAX package's ``_engine_for`` without its TPU lane
    test): the systems off the Kepler tail run the fused kernels
    (``analysis/fused.py``) exactly when ``fused_config_covered`` holds
    and G is uniform, and the scan engine (``analysis/stability.py::
    analyze_batch``) otherwise: the classical integrators and WHFast,
    float64, the legacy or fixed eps*, ``freeze_s_subsystem``,
    ``use_fused_analysis=False``, mode "minimal", per-system G.  The
    scan's lanes go in one call: the eager scan is bound by its
    launches, which follow the deepest lane's n_sub, and each lane runs
    its own n_sub as masked trips, so rows do not depend on the grouping.
    On the card the fused kernels take N from 2 to 16 body slots; a
    population the fused engine covers at another N raises (it is not
    sent to the scan engine instead).

    MEGNO tangent vectors: by default one ``(n_population, N, d)``
    normal pair is drawn for the whole population from ``seed`` (a CPU
    ``torch.Generator``) and indexed by global system id (``id_offset +
    i``), so a system's draw does not depend on its chunk as long as the
    chunks name the same ``n_population`` (default ``id_offset + B``: the
    second draw of the pair starts after the first's n_population draws,
    so a part analysed without it draws other tangents than the whole).
    ``tangent=(dr0, dv0)`` passes
    finished (B, N, d) tangent vectors instead (e.g. the JAX package's
    ``init_tangent`` draws, which torch cannot reproduce).

    With ``analysis_tail_policy="kepler"`` the systems of
    ``_tail_selection`` run the scan engine under kepler_split.  With
    ``tail_stream`` (the default) and the fused engine, the analysis
    kernel is launched first and the tail is issued right after it, on
    a CUDA device on its own stream, so that its small kernels fill the
    SMs the fused launch leaves idle; otherwise the tail runs after the
    other lanes, on the same stream.  Rows do not depend on the choice.

    ``cfg.early_exit_probe`` > 0 (the JAX package's analysis/batch.py:
    704-800): with n_steps >= 20 and mode "core" or "full", the systems
    off the tail whose n_sub bucket is at least
    ``cfg.early_exit_min_n_sub`` are first run in core mode for
    ``max(10, round(n_steps * probe))`` steps on their engine; a row
    whose drift is non-finite or above 10 keeps the probe's columns
    with NaN chaos columns, the others run again from scratch with the
    rest, so their rows are bit for bit those of a run without the
    probe.  The frame then has an ``early_exit`` column.

    ``timing_out``: optional dict that receives the wall-clock phases
    setup_s (construction + scheduling), dispatch_s (the engine calls),
    drain_s (the device -> host copy, which waits for the device),
    frame_s (DataFrame assembly), n_groups (n_sub buckets),
    n_dispatches (engine calls), engine ("fused" or "scan", the engine
    of the lanes off the tail), the lanes each engine ran over the whole
    horizon (fused_lanes, scan_lanes, n_tail), the probe's lanes and
    aborted rows (probe_lanes, n_early_exit), and the device
    milliseconds of each engine's call (fused_ms, scan_ms, tail_ms,
    probe_ms; 0 where it did not run).
    """
    import pandas as pd

    t_setup0 = time.perf_counter()
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    g_np = np.asarray(_as_np(G), np.float64)
    g_uniform = g_np.size == 1 or bool((g_np == g_np.flat[0]).all())
    fused_ok = g_uniform and fused_config_covered(cfg, mode, dtype)
    engine = "fused" if fused_ok else "scan"

    B = pos.shape[0]
    if show_progress:
        print(f"Analyzing {B} systems (batched)...")
        if (not fused_ok and getattr(cfg, "use_fused_analysis", False)
                and cfg.integrator_mode == "ham_soft"):
            why = "non-uniform G" if not g_uniform else "cfg gate"
            print(f"[analysis] the lanes off the tail run the scan engine "
                  f"instead of the fused kernels: {why}")
    states, dyns, n_sub_raw = prepare_population(
        mass, pos, vel, mask, cfg, G=g_np, softening=softening,
        min_softening=min_softening, dt=dt, device=dev)
    t = lambda x: _on_device(x, dtype, dev)

    megno_steps = 0
    if mode != "full":
        tangent = None  # only full mode runs MEGNO
    else:
        n_samp = min(50, n_steps // 2)
        megno_steps = min(100, n_samp) if n_samp > 0 else 0
        if tangent is None:
            n_pop = id_offset + B if n_population is None else n_population
            z1, z2 = population_normals(seed, n_pop,
                                        tuple(states.pos.shape[1:]), dtype)
            rows = slice(id_offset, id_offset + B)
            tangent = init_tangent(z1[rows].to(dev), z2[rows].to(dev),
                                   states)
        else:
            tangent = (t(tangent[0]), t(tangent[1]))

    # the tail's systems and their outer-timescale n_sub; the rest go to
    # their engine in n_sub-bucket order (the plain version masks each
    # lane's trips beyond its own n_sub, which are exact identities)
    tail_sel, n_tail = _tail_selection(states, dyns, cfg, n_sub_raw, dt)
    n_subs = np.minimum(n_sub_raw, _n_sub_cap(cfg))
    buckets = _bucket_ladder_values(np.where(tail_sel, n_tail, n_subs))
    n_groups = len(np.unique(buckets))
    main_idx = np.nonzero(~tail_sel)[0]
    tail_idx = np.nonzero(tail_sel)[0]

    def lanes_of(idx):
        """The systems at host indices ``idx`` as one engine call's
        batch, in n_sub-bucket order (stable, so a warp's lanes have
        similar depth)."""
        order, n_sub_max, _ = dispatch_plan(n_sub_raw[idx], cfg)
        rows = idx[order]
        lanes = torch.as_tensor(rows, device=dev)
        return dict(
            rows=rows, states=states.take(lanes), dyns=dyns.take(lanes),
            n_sub_max=n_sub_max,
            tangent=None if tangent is None else (tangent[0][lanes],
                                                  tangent[1][lanes]))

    clocks = {k: _Clock(dev) for k in ("fused", "scan", "tail", "probe")}
    ran = set()

    def packed(r):
        names = sorted(r)
        return names, torch.stack([r[k] for k in names])

    def run_fused(part, steps, mode_run, megno_run, clock, between=None):
        """The fused call; ``between`` runs once, right after the analysis
        kernel is launched and before the fused call queues anything
        behind it.  Returns (output, whether ``between`` ran)."""
        done = []

        def analysis_fn(*args, **kw):
            out = hamsoft_analysis_multistep(*args, **kw)
            if between is not None and not done:
                done.append(True)
                between()
            return out

        clocks[clock].start()
        r, _ = analyze_batch_fused(
            part["states"], part["dyns"], cfg, int(steps), float(dt),
            mode_run, part["n_sub_max"], megno_run, tangent=part["tangent"],
            g_static=float(g_np.flat[0]), analysis_fn=analysis_fn)
        out = packed(r)
        clocks[clock].stop()
        ran.add(clock)
        return out, bool(done)

    def run_scan(part, steps, mode_run, megno_run, clock, cfg_run=cfg,
                 dt_run=None):
        clocks[clock].start()
        nsm = part["n_sub_max"]
        r, _ = analyze_batch(
            part["states"], part["dyns"], cfg_run, int(steps),
            float(dt) if dt_run is None else dt_run, mode_run, nsm,
            megno_run, tangent=part["tangent"], trips=nsm)
        out = packed(r)
        clocks[clock].stop()
        ran.add(clock)
        return out

    def run_engine(part, steps, mode_run, megno_run, clock):
        if fused_ok:
            return run_fused(part, steps, mode_run, megno_run, clock)[0]
        return run_scan(part, steps, mode_run, megno_run, clock)

    # the early-exit probe: core mode on the deep buckets, on their engine
    probe = float(getattr(cfg, "early_exit_probe", 0.0) or 0.0)
    early = np.zeros(B, bool)
    parts = []
    probe_lanes = 0
    if probe > 0.0 and n_steps >= 20 and mode in ("core", "full"):
        pidx = main_idx[buckets[main_idx]
                        >= int(getattr(cfg, "early_exit_min_n_sub", 8))]
        if len(pidx):
            probe_lanes = len(pidx)
            part = lanes_of(pidx)
            names, res = run_engine(part, max(10, int(round(n_steps * probe))),
                                    "core", 0, "probe")
            res = res.cpu().numpy()
            drift = res[names.index("energy_drift")].astype(np.float64)
            with np.errstate(invalid="ignore"):
                bad = ~np.isfinite(drift) | (np.abs(drift) > _EARLY_EXIT_DRIFT)
            if bad.any():
                early[part["rows"][bad]] = True
                res = res[:, bad]
                for k in _CHAOS_COLS:
                    res[names.index(k)] = np.nan
                parts.append((part["rows"][bad], (names, res)))
            main_idx = main_idx[~early[main_idx]]

    main = lanes_of(main_idx) if len(main_idx) else None
    tail = None
    if len(tail_idx):
        lanes = torch.as_tensor(tail_idx, device=dev)
        nt_sel = n_tail[tail_idx]
        trips = int(nt_sel.max())
        tail = dict(
            rows=tail_idx, states=states.take(lanes),
            dyns=dyns.take(lanes).replace(n_sub=torch.as_tensor(
                nt_sel.astype(np.int32), device=dev)),
            n_sub_max=trips,
            tangent=None if tangent is None else (tangent[0][lanes],
                                                  tangent[1][lanes]))
    t_setup = time.perf_counter() - t_setup0

    t_disp0 = time.perf_counter()
    cfg_tail = cfg.replace(integrator_mode="kepler_split")
    run_tail = lambda: run_scan(
        tail, n_steps, mode, megno_steps, "tail", cfg_run=cfg_tail,
        dt_run=torch.full((len(tail_idx),), float(dt), dtype=dtype,
                          device=dev))

    if tail_stream and fused_ok and main is not None and tail is not None:
        # the tail is issued between the analysis kernel's launch and the
        # fused call's follow-up work: queued behind the long kernel, that
        # work would fill the device's launch queue and stall the tail's
        # launches until the kernel ends
        side = None
        if dev.type == "cuda":
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(cur)
        box = {}

        def tail_on_side():
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                box["out"] = run_tail()

        out, done = run_fused(main, n_steps, mode, megno_steps, "fused",
                              between=tail_on_side)
        if not done:  # use_fused_metrics=False launches no analysis kernel
            tail_on_side()
        if side is not None:
            cur.wait_stream(side)
        parts += [(main["rows"], out), (tail["rows"], box["out"])]
    else:
        if main is not None:
            parts.append((main["rows"], run_engine(
                main, n_steps, mode, megno_steps, engine)))
        if tail is not None:
            parts.append((tail["rows"], run_tail()))
    t_disp = time.perf_counter() - t_disp0

    feats = F.extract_all(states, dyns, cfg) if mode == "full" else {}
    t_drain0 = time.perf_counter()
    res_rows = {}
    for rows, (names, res) in parts:
        host = res.cpu().numpy() if isinstance(res, torch.Tensor) else res
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
    if probe > 0.0:
        res_np["early_exit"] = early
    df = pd.DataFrame(res_np)
    df["mode"] = mode
    bad = (~np.isfinite(df["energy_drift"])) | (df["energy_drift"].abs() > 10)
    df["pathological_energy"] = bad
    df.loc[bad, "is_stable"] = 0.0
    df["softening_policy"] = _softening_policy(cfg)
    df["simulation_id"] = np.arange(B)
    if timing_out is not None:
        n_main = 0 if main is None else len(main["rows"])
        timing_out.update(
            setup_s=t_setup, dispatch_s=t_disp, drain_s=t_drain,
            frame_s=time.perf_counter() - t_frame0,
            n_groups=n_groups, n_dispatches=len(ran), engine=engine,
            fused_lanes=n_main if fused_ok else 0,
            scan_lanes=0 if fused_ok else n_main,
            n_tail=int(len(tail_idx)), probe_lanes=probe_lanes,
            n_early_exit=int(early.sum()),
            **{f"{k}_ms": c.ms() if k in ran else 0.0
               for k, c in clocks.items()})
    if show_progress:
        print(f"Completed: {B} simulations analyzed")
    return df


# ----------------------------------------------------------------------
# the facade's batch analyzer (batch.py:31-84 and :884-1019 of the JAX
# package)
# ----------------------------------------------------------------------

def _pad_slots(x, k: int):
    """``x`` (1, N[, d]) with ``k`` zero (False) slots appended."""
    pad = torch.zeros((x.shape[0], k) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], 1)


def stack_sims(sims, dyns_list=None):
    """Facade simulations stacked into batched (states, dyns), their body
    slots padded (mass 0, mask False) to the largest count among them.
    ``dyns_list``: each simulation's DynParams, its own by default."""
    from ..core.state import DYN_FIELDS, STATE_FIELDS, DynParams, SimState

    n_slots = max(s._state.n_slots for s in sims)

    def padded(st):
        k = n_slots - st.n_slots
        if k == 0:
            return st
        return st.replace(**{f: _pad_slots(getattr(st, f), k)
                             for f in ("mass", "pos", "vel", "mask")})

    sts = [padded(s._state) for s in sims]
    dys = dyns_list if dyns_list is not None else [s._dyn for s in sims]
    states = SimState(**{f: torch.cat([getattr(s, f) for s in sts])
                         for f in STATE_FIELDS})
    dyns = DynParams(**{f: torch.cat([getattr(d, f) for d in dys])
                        for f in DYN_FIELDS})
    return states, dyns


def _scheduled_dyn(sim, dt: float, cap: bool = True):
    """The simulation's DynParams with the pi-budget mu raise and, where
    ``dt`` is not within 1% of the frozen dt, a refrozen schedule; the
    simulation is not changed.  ``cap`` applies the batch policy's n_sub
    cap (``cfg.analysis_n_sub_cap``; the reference runs the full n_pred,
    HSI:504-551)."""
    import math

    from ..parallel.batch_engine import refreeze

    dyn = sim._dyn
    if sim._integrator_mode != "ham_soft":
        h_sub = float(dyn.h_sub_ref)
        if not (math.isfinite(h_sub) and h_sub > 0.0):
            h_sub = abs(dt)
        n = int(max(1, min(sim.cfg.split_n_max,
                           math.ceil(abs(dt) / h_sub))))
        return dyn.replace(n_sub=torch.full_like(dyn.n_sub, n))
    dyn = dyn.replace(mu_soft=calib.calibrate_mu_from_pi_budget(
        dyn.mu_soft, dyn.k_soft, sim._as_dtype(abs(dt)),
        sim._as_dtype(sim.cfg.theta_imp)))
    prev = getattr(sim, "_frozen_dt", None)
    if prev is None or prev <= 0.0 or abs(abs(dt) - prev) / prev > 0.01:
        dyn = refreeze(sim._state, dyn, sim.cfg, sim._as_dtype(dt))
    if cap:
        dyn = dyn.replace(n_sub=torch.clamp_max(dyn.n_sub,
                                                _n_sub_cap(sim.cfg)))
    return dyn


def _group_generator(seed: int, first: int) -> torch.Generator:
    """The CPU generator of the group whose first simulation is
    ``first`` (the JAX package folds that index into its key)."""
    s = np.random.SeedSequence([int(seed), int(first)]).generate_state(1)
    return torch.Generator().manual_seed(int(s[0]))


class BatchStabilityAnalyzer:
    """The facade's batch analyzer (batch_stability_analyzer.py:30-102):
    the simulations grouped by (cfg, mode), each group padded to its
    largest body count and analysed in one scan-engine call
    (``analysis/stability.py::analyze_batch``) on the simulations'
    device, each system at its own (capped) n_sub.  The frame has the
    JAX package's columns: the result columns, the ``initial_*``
    features in full mode, the per-body IC columns, the pre-cap n_sub.

    MEGNO tangent vectors: drawn per group from a CPU ``torch.Generator``
    seeded by (``seed``, the group's first index), or passed to
    ``analyze_batch`` as ``tangent``, one (dr0, dv0) pair of (n_slots,
    d) arrays per simulation."""

    def __init__(self, n_steps: int = 1000, dt: float = 0.01,
                 mode: str = "core", seed: int = 0) -> None:
        self.n_steps = int(n_steps)
        self.dt = float(dt)
        self.mode = mode
        self.seed = int(seed)
        self.results: list = []

    def analyze_simulation(self, sim) -> dict:
        """The single-system path (batch_stability_analyzer.py:37-58)."""
        from .stability import StabilityAnalyzer

        analyzer = StabilityAnalyzer(sim, self.n_steps, self.dt,
                                     mode=self.mode)
        result = analyzer.run_stability_analysis() or {}
        self._postprocess(result, sim)
        return result

    @staticmethod
    def _postprocess(result: dict, sim) -> None:
        drift = result.get("energy_drift")
        bad = drift is not None and (abs(drift) > 10
                                     or not np.isfinite(drift))
        if bad:
            result["is_stable"] = 0.0
        result["pathological_energy"] = bool(bad)
        if sim._integrator_mode == "ham_soft":
            result["softening_policy"] = "adaptive-ham"
        elif sim._adaptive_softening:
            result["softening_policy"] = "adaptive-classic"
        else:
            result["softening_policy"] = "static"

    def _tangent(self, tangent, idxs, states):
        if tangent is None:
            from ..diagnostics.megno import draw_tangent

            return draw_tangent(_group_generator(self.seed, idxs[0]),
                                states)
        n_slots = states.pos.shape[1]

        def stacked(k):
            rows = []
            for i in idxs:
                a = np.asarray(tangent[i][k], np.float64)
                rows.append(np.concatenate(
                    [a, np.zeros((n_slots - len(a),) + a.shape[1:])]))
            return _on_device(np.stack(rows), states.pos.dtype,
                              states.pos.device)

        return stacked(0), stacked(1)

    def analyze_batch(self, simulations, show_progress: bool = True,
                      tangent=None):
        """One scan-engine call per (cfg, mode) group; returns the frame,
        one row per simulation in input order."""
        import pandas as pd
        from collections import defaultdict

        self.results = [None] * len(simulations)
        if show_progress:
            print(f"Analyzing {len(simulations)} simulations...")
        groups = defaultdict(list)
        for i, sim in enumerate(simulations):
            groups[(sim.cfg, self.mode)].append(i)
        megno_steps = 0
        if self.mode == "full":
            n_samp = min(50, self.n_steps // 2)
            megno_steps = min(100, n_samp) if n_samp > 0 else 0

        for (cfg, mode), idxs in groups.items():
            sims = [simulations[i] for i in idxs]
            # this dt's schedule, the simulations left as they are
            # (strang_substeps' pi-budget raise, HSI:800); the n_sub
            # columns record the demand before the cap
            raw_list = [_scheduled_dyn(s, self.dt, cap=False) for s in sims]
            n_subs_raw = np.array([int(d.n_sub) for d in raw_list])
            cap = _n_sub_cap(cfg)
            dyns_list = [d.replace(n_sub=torch.clamp_max(d.n_sub, cap))
                         for d in raw_list]
            n_sub_max = int(np.minimum(n_subs_raw, cap).max())
            states, dyns = stack_sims(sims, dyns_list)
            res, _ = analyze_batch(
                states, dyns, cfg, self.n_steps, self.dt, mode, n_sub_max,
                megno_steps, tangent=self._tangent(tangent, idxs, states)
                if megno_steps else None)
            # the JAX package's result and feature dicts come back from
            # jit with their keys sorted: so do the columns here
            res_np = {k: _as_np(res[k]) for k in sorted(res)}
            if self.mode == "full":
                feats = F.extract_all(states, dyns, cfg)
                res_np.update({f"initial_{k}": _as_np(feats[k])
                               for k in sorted(feats)})
            res_np.update(serialize_ic_columns(
                _as_np(states.mass), _as_np(states.pos), _as_np(states.vel),
                _as_np(states.mask),
                G=_as_np(dyns.G).astype(np.float64),
                softening=_as_np(dyns.s0).astype(np.float64),
                min_softening=_as_np(dyns.min_softening).astype(np.float64),
                cfg=cfg))
            res_np["n_sub"] = n_subs_raw.astype(np.int64)
            res_np["n_sub_capped"] = n_subs_raw > cap
            for j, i in enumerate(idxs):
                row = {}
                for k, v in res_np.items():
                    val = v[j]
                    if isinstance(val, str):
                        row[k] = val
                    elif isinstance(val, (np.bool_, bool)):
                        row[k] = bool(val)
                    elif isinstance(val, (np.integer, int)):
                        row[k] = int(val)
                    else:
                        row[k] = float(val)
                row["mode"] = self.mode
                self._postprocess(row, simulations[i])
                row["simulation_id"] = i
                self.results[i] = row

        if show_progress:
            print(f"Completed: {len(self.results)} simulations analyzed")
        return pd.DataFrame(self.results)

    def save_batch_results(self, filename: str) -> None:
        import pandas as pd

        if not self.results:
            print("[error] No results to save. Run analyze_batch first.")
            return
        df = pd.DataFrame(self.results)
        df.to_csv(filename, index=False)
        print(f"Saved {len(df)} results to {filename}")

    def get_feature_matrix(self) -> np.ndarray:
        import pandas as pd

        if not self.results:
            print("[error] No results available. Run analyze_batch first.")
            return np.array([])
        return pd.DataFrame(self.results).values
