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
configuration; ``early_exit_probe > 0`` raises).  The Kepler tail fast
path is a later slice: ``analysis_tail_policy`` must be ``"off"``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.device import dtype_of, resolve_device
from ..diagnostics import features as F
from ..diagnostics.megno import init_tangent, population_normals
from ..integrators import calibration as calib
from ..parallel.batch_engine import build_batch
from .fused import analyze_batch_fused, fused_config_covered


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
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def prepare_population(mass, pos, vel, mask, cfg, *, G, softening,
                       min_softening, dt, device):
    """Construction and schedule of a population, as the analysis runs
    it: ``build_batch``, the pi-budget mu raise for ``dt`` and the n_sub
    cap.  Returns (states, dyns, n_sub_raw) with the uncapped frozen
    n_sub as a host array."""
    dtype = dtype_of(cfg)
    t = lambda x, dt_=dtype: torch.as_tensor(np.array(_as_np(x)), dtype=dt_,
                                             device=device)
    states, dyns = build_batch(t(mass), t(pos), t(vel), t(mask, torch.bool),
                               cfg, np.array(_as_np(G)),
                               np.array(_as_np(softening)),
                               np.array(_as_np(min_softening)), dt)
    mu_new = calib.calibrate_mu_from_pi_budget(
        dyns.mu_soft, dyns.k_soft, abs(dt), cfg.theta_imp)
    dyns = dyns.replace(mu_soft=mu_new)
    n_sub_raw = dyns.n_sub.cpu().numpy()
    dyns = dyns.replace(n_sub=torch.clamp_max(dyns.n_sub, _n_sub_cap(cfg)))
    return states, dyns, n_sub_raw


def analyze_population(mass, pos, vel, mask, cfg, *, G=1.0, softening=0.05,
                       min_softening=0.0, dt=0.01, n_steps=1000,
                       mode="core", seed=0, show_progress=True,
                       include_ics=True, id_offset=0, timing_out=None,
                       device=None, tangent=None):
    """Batched population analysis on the fused kernels; returns a
    pandas DataFrame with the JAX package's columns.

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

    ``timing_out``: optional dict that receives the wall-clock phases
    setup_s (construction + scheduling), dispatch_s (the engine call),
    drain_s (the device -> host copy, which waits for the device),
    frame_s (DataFrame assembly), n_groups (n_sub buckets) and
    n_dispatches (always 1).
    """
    import pandas as pd

    t_setup0 = time.perf_counter()
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    if getattr(cfg, "analysis_tail_policy", "off") != "off":
        raise NotImplementedError(
            "analyze_population: the Kepler tail fast path is not ported; "
            "set analysis_tail_policy='off'")
    if float(getattr(cfg, "early_exit_probe", 0.0) or 0.0) > 0.0:
        raise NotImplementedError(
            "analyze_population: the early-exit probe is not ported")
    if not fused_config_covered(cfg, mode, dtype):
        raise NotImplementedError(
            "analyze_population: only the fused engine's configurations "
            "are ported (ham_soft, float32, exact gradient, core/full mode, "
            "use_fused_analysis; soft barrier unless use_fused_metrics=False "
            "in core mode)")
    g_np = np.asarray(_as_np(G), np.float64)
    if not (g_np.size == 1 or bool((g_np == g_np.flat[0]).all())):
        raise NotImplementedError(
            "analyze_population: non-uniform G needs the scan engine, "
            "which is not ported")

    B = pos.shape[0]
    if show_progress:
        print(f"Analyzing {B} systems (batched)...")
    states, dyns, n_sub_raw = prepare_population(
        mass, pos, vel, mask, cfg, G=g_np, softening=softening,
        min_softening=min_softening, dt=dt, device=dev)
    t = lambda x: torch.as_tensor(np.array(_as_np(x)), dtype=dtype,
                                  device=dev)

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

    # one engine call on every device (the plain version masks each
    # lane's trips beyond its own n_sub, which are exact identities)
    rows, n_sub_max, n_groups = dispatch_plan(n_sub_raw, cfg)
    t_setup = time.perf_counter() - t_setup0

    t_disp0 = time.perf_counter()
    lanes = torch.as_tensor(rows, device=dev)
    tan = None if tangent is None else (tangent[0][lanes], tangent[1][lanes])
    r, _ = analyze_batch_fused(
        states.take(lanes), dyns.take(lanes), cfg, int(n_steps), float(dt),
        mode, n_sub_max, megno_steps, tangent=tan,
        g_static=float(g_np.flat[0]))
    names = sorted(r)
    packed = torch.stack([r[k] for k in names])
    t_disp = time.perf_counter() - t_disp0

    feats = F.extract_all(states, dyns, cfg) if mode == "full" else {}
    t_drain0 = time.perf_counter()
    host = packed.cpu().numpy()
    res_rows = {}
    for i, k in enumerate(names):
        res_rows[k] = np.empty(B, host.dtype)
        res_rows[k][rows] = host[i]
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
            n_groups=n_groups, n_dispatches=1)
    if show_progress:
        print(f"Completed: {B} simulations analyzed")
    return df
