#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through their hand-written CUDA kernels:
the product end to end (a diverse population drawn on the card, analysed
by ``analyze_population``, scored by the headline classifiers without
integration), the 3-D product path (``data/stability_3d_131k.csv.gz``
through ``analyze_population`` at d = 3 and the 3-D headline
classifiers), full-mode ``analyze_population`` under the dataset pipeline's
configuration unmodified (``generators/pipeline.py::_PIPE_CFG`` of the
JAX package, Kepler tail policy on) on real systems from
``data/stability_131k.csv.gz`` (``csrc/hamsoft.cu`` for the fused lanes,
the scan engine under kepler_split for the tail), and the batched
integration of ``bench.py`` (``build_batch`` -> ``integrate_batch`` and
the fused multi-step entry points; ``csrc/composition.cu``,
``csrc/hamsoft_multistep.cu``, ``csrc/eps_grad.cu``, ``csrc/whfast.cu``),
and the large-N slice at the widths of the JAX package's
``tools/bench_largen.py`` and ``tools/bench_whfast_largen.py``
(``largen_rollout``, P3M, the classical and many-planet WHFast force
routes; ``csrc/pairwise_force.cu``), the facade (``NBodySimulation``,
its analyzers and the sim-list views), and the dataset-to-classifier
path (sharded generation over ``torch.distributed`` processes, the MLP
trained on the card, calibrated and served).  Phases (each prints its
seconds):

1. card: ``nvidia-smi`` name and power limit;
2. build: one ``nvcc`` per kernel source and body-slot count (the
   tiled force kernel: per dimension, 2 and 3; the analysis/MEGNO and
   eps kernels at d = 2 and 3, the eps kernel also at every N from 2 to
   8 at d = 2 for phase 23; the composition kernel: every N from 2
   to 16 at d = 2 and 3), all started together, beside phase 23's CPU
   references (child processes of this script on the CPU, waited for
   at the phase's end), into the git-ignored
   ``nbodysimproject_tpu_torch/_build/``; prints each build's seconds
   and ptxas' register, stack frame and spill lines, and fails unless
   the analysis and MEGNO kernels at N = 8 (d = 2 and 3), the
   multi-step kernel at every N, the eps kernel at N = 3 and 8 (d = 2
   and 3), the WHFast kernel (and its Stumpff probe), the tiled force kernel and the
   composition kernel at N in {3, 4, 8} and d in {2, 3} spill 0 bytes
   (the composition kernel also with 0 bytes of stack frame; its other
   builds reported); counts the composition kernel's SASS instructions
   a step at N = 3, d = 2 (``cuobjdump -sass``, the step loop of each
   scheme; "not measured" where it cannot, never a gate);
3. population: the first 16384 rows of the dataset (empty slots: mass
   0, mask False; these rows are the dataset's "random" cohort);
4. compare the analysis and MEGNO kernels with their plain PyTorch
   versions on the card, on 1024 real systems at N = 8, at a short
   horizon only.  The lowest n_sub bucket, 20 steps: the analysis
   columns held to the fused-vs-scan tolerances of
   ``tests/test_pallas_batch.py`` and both kernels' final pos, vel, eps
   and pi to STATE_TOL, nothing widened.  The 1024 highest-n_sub
   systems at n_sub_max = 256, 2 steps: the same tolerances (the drift
   columns' absolute one scaled by how nearly H0 or L0 cancels),
   widened on at most MAX_WIDENED rows by SENS_FACTOR times the row's
   rounding sensitivity, which the plain version gives when rerun in
   float64 and with the body slots reordered.  Each kernel's time per
   trip of its deepest lane;
5. compare the batched slice's kernels with their plain versions at
   the legs' full widths and short horizons, under the same rule
   (``row_gate``): the composition kernel (verlet at B = 2^24, yoshida4
   at B = 2^22, both at N = 8, d = 3 on a ring population at B = 2^18,
   20 steps; and every N from 2 to 16 at d = 2 and 3, both schemes,
   B = 4096, 20 steps, within STATE_TOL), the multi-step kernel under both barrier
   policies (B = 2^20, 2 steps), the eps kernel under both clamp
   settings (the bench population, and the first 1024 dataset rows with
   their masked 8-slot systems), the eps kernel's two layouts against
   each other (the dataset's 3-body rows in 3 and in 8 slots: equal
   bits, gated), the eps kernel alone at N = 3 (2^20 bench systems) and
   N = 8 (the 16384 dataset systems): 50 wrapper calls back to back
   traced by ``torch.profiler`` (one device launch a call and nothing
   else, gated; a trace that lost a record is taken again, at most
   EPS_TRACES times; the kernel's device time) and single wrapper calls
   between CUDA events, and the WHFast kernel (B = 2^22, 5 steps; and one
   step against the port's LC-8 WHFast scan), with the share of its
   Stumpff evaluations that take the closed form;
6. main path: ``analyze_population(mode="full", n_steps=1000, dt=0.01)``
   on all 16384 systems under ``_PIPE_CFG`` (tail on), one cold and
   WARM_REPS warm runs with the tail on its own stream (the run with the
   tail after the fused call is phase 22's, at its horizon); the tail's
   count and n_tail histogram, the deepest fused lane, the fused call's
   and the tail's device time; the launch counts read around the cold
   run; no lane off the tail on the scan engine (gated);
7. the tail-off run of the same population (one run): non-tail rows
   bitwise equal to the main path's (gated), labels of the tail rows
   beside it and beside the dataset, labels of the other rows beside
   the dataset (is_stable gated at LABEL_GATE) and beside a tail-off run
   on reversed body slots;
8. the same population with ``use_fused_metrics=False`` (tail off; the
   multi-step kernel in chunks, ``step_metrics`` between them): the
   run's time, its multi-step launches replayed between CUDA events
   (each launch's time and bound), held to its plain version on the
   lowest bucket (the top bucket's case was cut for phase 23) and to
   the fused way at one step (final states bitwise equal: the analysis
   kernel's trip is the multi-step kernel's), the longer horizons
   measured;
9. the main path's kernel launches replayed between CUDA events, with
   the time per trip of the deepest lane;
10. the 3-D product path (``data/stability_3d_131k.csv.gz``, its first
   16384 rows, (B, 8, 3)): the analysis and MEGNO kernels at d = 3 held
   to their plain versions as in phase 4 (1024 rows, the lowest bucket
   at 20 steps and the top bucket at 2 steps, ``row_gate``'s rule), the
   eps kernel at d = 3 on the first 1024 rows under both clamps and its
   two layouts on the 3-body rows (bitwise, gated), the ham_soft scan at
   d = 3 (``integrate_batch`` on the n_sub = 1 rows, SCAN3_STEPS steps,
   the eps kernel's launches gated > 0), the main path
   ``analyze_population`` under ``_PIPE_CFG`` one cold run (systems/s, fused_ms, tail_ms,
   n_tail, launches of both kernels gated > 0), the tail-off run (non-tail rows bitwise, gated),
   is_stable held to the JAX fused engine's on the first 256 rows with
   at most 2 substeps (``data/labels_3d_jax_fused_256.npz``, gated at
   LABEL_GATE) and beside the dataset's on the non-tail rows (printed:
   its columns are round 3's, before the vector-L fix), the main
   path's launches replayed between CUDA events with their bound at
   d = 3, and the 3-D headline MLP and GBDT
   (``data/headline3d_pre_torch.npz``) served on the card, held to the
   CPU as phase 14 holds the 2-D ones;
11. the fused engine's remaining branches: the analysis and
   MEGNO kernels under the reflection policy, the no-barrier policy and
   the "reference" eps* gradient held to their plain versions on phase
   4's lanes (on the lowest bucket only since phase 23) under
   ``row_gate``'s rule (``bucket_cases``; a row past
   the widening allowed only where ``branch_walk`` finds kernel and
   plain parting at a trip whose fold or switch the float64 plain trip
   puts within BRANCH_ULPS float32 ulps of its threshold, on at most
   MAX_WIDENED rows, is_stable still gated there), the
   "reference" gradient at d = 3 on the 3-D lowest bucket; the
   multi-step kernel under the "reference" gradient with both policies
   (B = 2^20, N = 3, 2 steps) and at d = 3, N = 8 (the 3-D lowest
   bucket, 20 steps); the eps kernel with ``use_fallback`` under both
   clamps (the bench population and the first 1024 dataset rows; the
   systems whose branch the kernel takes otherwise than the plain
   version counted and allowed only where the plain version's float64
   rerun puts gmax within BRANCH_ULPS float32 ulps of the threshold) and
   its two layouts bit for bit
   under it; the WHFast kernel at d = 3 (B = 2^22, 5 steps, inclined
   orbits); the fallback's share at t = 0 on the dataset rows and the
   bench population (gated > 0); the three branches through
   ``analyze_population`` on the 16384 dataset rows (tail off; systems/s,
   fused_ms, both kernels' launches gated > 0, non-finite rows and
   is_stable beside the soft/exact run's, printed; the launches replayed
   with their bounds; under reflection every final eps inside its walls,
   gated), the 3-D rows with ``use_fused_metrics=False`` (the multi-step
   kernel at d = 3, launches gated; its launches replayed; one step
   bitwise the fused way's, gated), the ham_soft scan and fused leg under
   the "reference" gradient and the WHFast leg at d = 3 at bench.py's
   widths (launches gated > 0); the registers and spills of every build
   of the phase, and the exact builds' registers beside PERF.md's;
12. generators: ``diverse_population`` (a ``torch.Generator`` on the card
   seeded 0, 16384 systems, 8 slots) between CUDA events, twice (the
   same bits, gated); gated on the cohort sizes and order, each cohort's
   body counts, finite float32 values on the card and each system's
   |sum m q| (and, but for the hierarchical cohort, whose generator adds
   its velocity noise after the projection as the JAX package's does,
   |sum m v|) at most COM_GATE of its scale; the per-cohort medians of
   total mass, virial ratio and mean separation beside those of the
   committed bench population;
13. bench population: ``data/bench_population_16384.npz`` (bench.py's
   own population, ``diverse_population(PRNGKey(0), 16384, n_slots=8)``
   drawn by the JAX package on the CPU, read with numpy) through
   ``analyze_population`` under ``_PIPE_CFG`` as bench.py's leg runs it
   but at BENCH_STEPS = 60 steps (bench.py's 1000 cut for the time
   limit: its eager Kepler tail runs up to 7 trips a step),
   one cold run (systems/s, ``timing_out``'s phases,
   fused_ms, tail_ms, n_tail, the launches of the analysis and MEGNO
   kernels, gated > 0), the stable and tail shares per cohort; then the
   entry point ``MLTrainingPipeline(n_systems=16384, n_steps=500,
   seed=0).generate_diverse_dataset_batched()`` once (500 steps: the
   least its clamp takes), its frame gated (16384
   rows, ``system_type`` in cohort order, both kernels launched);
14. serving: ``ic_feature_frame`` and ``StabilityPredictor.predict_frame``
   for the headline MLP and GBDT (``data/headline_pre_torch.npz``) on
   the bench population on the card, cold and the warm median of
   SERVE_REPS, in systems/s and as a multiple of phase 13's analysis
   rate; the card's scores gated against the same port on the CPU on
   the same frame (MLP within SERVE_MLP_TOL with equal verdicts outside
   that band; GBDT raw scores bit for bit, probabilities within
   SERVE_GBDT_TOL); the verdicts' agreement with phase 13's is_stable
   per cohort (not gated);
15. ``bench.py``'s legs at full width: verlet and yoshida4 scans at
   B = 16384 and 1000 steps, the fused verlet at 2^24 and yoshida4 at
   2^22 (with the SASS instructions a step and the issue floor they
   give at the card's maximum SM clock), the ham_soft scan and fused kernel at 2^20 and 100 steps
   under both barrier policies, the WHFast scan (adaptive Kepler
   solver) at B = 16384 and 100 steps (bench.py's 1000 cut for the time
   limit) and the fused WHFast kernel at
   2^22 and 100 steps (8 Laguerre-Conway updates), each with launch
   counts around its cold run, the warm median of LEG_WARM_REPS runs
   between CUDA events, the count of non-finite systems and system 0's
   relative drift of the extended Hamiltonian;
16. the tiled force kernel against its plain version: N = 4097 (not a
   tile multiple) at d = 2 and N = 1000 at d = 3 on all rows, B = 4
   systems with their own eps and G, and bench_largen's N = 10^5 cloud
   on 4096 sampled rows; each row's error from the float64 plain version
   over its magnitude sum, gated (FORCE_ERR_*), and the momentum;
17. bench_largen's single evaluations at N = 10^4, 32768, 10^5, 10^6
   (its ICs drawn again with numpy in its order, its mesh sizes): P3M
   (and its short-range pass alone), the tiled kernel and, up to 32768,
   the dense eager force; P3M's
   error median and p99 against the dense force (else the kernel),
   gated (P3M_ERR_GATE, n_dropped = 0);
18. bench_largen's rollouts, ``largen_rollout`` (dt 1e-4, eps 6 / Ng):
   p3m and direct_pallas at 10^4 and 10^5, p3m at 10^6, 50 steps
   each (10 at 10^6, cut for the time limit), cold and the warm median
   of LEG_WARM_REPS in steps/s;
   n_dropped_max = 0, finite states, the kernel's launches > 0 on the
   direct route;
19. verlet through ``build_batch`` -> ``integrate_batch`` with
   ``use_pallas_forces`` on one 4096-body cloud for 100 steps, against
   the same run on the dense force, both timed;
20. bench_whfast_largen: 4096, 16384 and 65536 planets, LC-8, the kick
   on direct_pallas and on P3M with the star split: 20 timed substeps,
   the drift over 200 (float64 energy on the card, gated), P3M's kick
   error against direct_pallas (p99 gated);
21. the tiled force kernel alone at its paths' widths (the classical
   route's N = 4096, the 65536-planet kick, 10^5 and 10^6): many
   launches back to back between CUDA events, with its bound;
22. the scan route: phase 3's rows through ``analyze_population``, one
   cold run each under ``_PIPE_CFG`` with ``use_fused_analysis=False``,
   ``fast_float32=False``, verlet, WHFast, ``use_fused_megno=False`` and
   ``early_exit_probe=0.1``, at the depths of SCAN_ROUTES (the dataset's
   1000 steps cut for the time limit, the eager scan being bound by its
   launches; systems/s, ``timing_out``'s phases and lanes per engine);
   the scan's lanes in one call against one call per ladder bucket;
   gated: row 4 launched
   on the float32 ham_soft scan and not on the float64 and classical
   runs, rows 1 and 2 not on those scan runs, row 1 on the probe and
   ``use_fused_megno=False`` runs and row 2 not on the latter, the
   probe's survivors bit for bit a fused run at the same steps without
   it and its aborted rows' drift non-finite or above 10, that run bit
   for bit the same with the tail after the fused call on the same
   stream; then the first 256 rows with n_sub <= 4 at 20 steps under
   each route, mode "minimal" and per-system G, the card against the
   same port on the CPU (float64 within F64_TOL with is_stable equal,
   a row outside it allowed only where the CPU's run on reversed body
   slots lies outside it too; float32 is_stable gated at LABEL_GATE,
   rows outside TOL allowed only where the CPU's float32 run lies
   outside TOL of its float64 run, and on at most MAX_WIDENED others).

23. the facade (``nbodysimproject_tpu_torch/facade/``, the object API),
   on the card, run right after phase 2 (its eager one-system steps
   ran ~1.8x slower at the script's end than in a fresh process):
   (a) the golden scenarios of ``tests/test_golden_regression.py`` in
   float64 (verlet 1000 steps, ham_soft 100 steps) held to their golden
   values, no eps launch (float64, the JAX dtype rule; the ham_soft
   H_ext to the bound its pi tolerance implies, as
   ``tests/test_torch_facade_golden.py`` holds it); (b) the golden
   ham_soft system (to its golden horizon: it turns non-finite near step
   110) and a 7-body ring at circular speed (1000 steps) in fast mode
   through ``run`` (FACADE_RUNS), and FACADE_STEP_CALLS ``step`` calls
   on a twin of each (ms a step each, the per-step host reads' share),
   row 4's launches gated to n_sub + 1 a step, positions and
   ``Diagnostics`` energies held entry by entry to the port's CPU
   float32 run (``row_gate``, TOL32_FACADE, widened on no entry but
   where the CPU's float32 run on reversed body slots lies outside it
   too), row 4 against its plain version at B = 1 on the held state;
   (c) ``StabilityAnalyzer(mode="full")`` over FACADE_SA_STEPS steps on
   a fast-mode hierarchical triple at d = 2 and 3, is_stable equal to
   the CPU port's; (d) ``MLTrainingPipeline.generate_diverse_dataset``
   on FACADE_BATCH systems with its ``BatchStabilityAnalyzer`` cut to
   FACADE_BATCH_STEPS steps (seconds, row 4's launches, gated > 0), row
   4 against its plain version at the view's shape and at B = 1 on the
   view's first simulations of 3 and of more bodies with a nonzero eps*
   gradient (a nonzero gradient gated), and FACADE_CPU_ROWS shallow
   rows analysed as one group on the card and on the CPU in float32 and
   float64: is_stable off the CPU's float32 verdict only on rows where
   the CPU's two precisions differ (gated); (e)
   ``NBodySimulation(config=SimConfig(force_mode="direct_pallas"))`` on
   bench_largen's 10^5 cloud, 50 steps: steps/s, row 7's launches gated
   to 51, the state bit for bit ``largen_rollout``'s; (f) a float64
   ham_soft snapshot taken on the CPU, restored on the card, run on
   beside the CPU original and a card twin (gated at F64_TOL).  The CPU
   references of (b) and (c) come from this script run as child
   processes (``--facade-cpu-references``, FACADE_REF_JOBS) during
   phase 2's builds, so that no measured phase shares the host with
   them.

24. the dataset-to-classifier path, on the card, right after phase 23:
   (a) ``parallel/distributed.py::generate_dataset_sharded`` on
   SHARD_SYSTEMS diverse systems at SHARD_STEPS steps (the pipeline's
   1000 cut for the time limit), once unsharded in this process and as
   two shards by two worker processes of this script
   (``--shard-worker``: ``torch.distributed`` over gloo, world size 2,
   both on the card); the merged shards bit for bit the unsharded
   frame in every column (NaN equal to NaN), the workers' float64
   ``reduce_statistics_global`` bit for bit ``merge_statistics`` of
   their local statistics, each worker's ``make_mesh()`` placing a host
   batch's shard and replica on its card, rows 1 and 2 launched
   (gated), their
   launches and each run's seconds printed; (b) ``MLPTrainer`` on
   ``data/stability_131k.csv.gz`` ("pre" features, the 0.7 / 0.15 /
   0.15 split of seed 42): PARITY_EPOCHS epochs of PARITY_ROWS rows at
   dropout 0 from ``make_mlp(PARITY_SEED)`` (200 optimizer steps, TF32
   off) on the card against the same on the CPU (a child process of
   this script during phase 2's builds, ``--mlp-parity-cpu``), gated at
   PARITY_TOL; then the protocol at most TRAIN_EPOCHS epochs (cut from
   200), test AUROC gated at MLP_AUROC_GATE, ms per optimizer step and
   seconds per epoch printed; (c) ``save_model``, then the port's
   ``StabilityPredictor`` on the card: its raw scores on the test split
   within PREDICT_TOL of the trainer's ``predict_proba`` (gated); (d)
   the trees ``train_gbdt`` fitted on host sklearn (fast grid, cv = 3,
   ``hold_out_val``; committed with sklearn's scores of the test split,
   since the card's machine may lack scikit-learn: ``python3
   chip_smoke.py --fit-gbdt-reference`` remakes them where it is
   installed) on the card (``ml/gbdt.py``): this run's split and scaler
   those of the fit, raw scores bit for bit sklearn's ``_raw_predict``
   and sklearn's link of them bit for bit its ``predict_proba``, test
   AUROC sklearn's and at least GBDT_AUROC_GATE (gated); (e)
   ``fit_cohort_calibration`` on the validation split by
   ``system_type``, ``choose_global_threshold``, the close encounters'
   recall floor and ``evaluate_policy``, the ``calibration`` block
   written into the metadata: the predictor's decisions on the test
   split on the card equal ``policy_decisions``', row for row (gated).

25. every slot count (rows 1-3 at N other than 3, 4 and 8; four lanes a
   body up to N = 8, two from 9 to 16), on the card, right after phase
   7, under ``_PIPE_CFG`` tail off: (a) phase 3's rows padded from 8 to
   16 slots (mass 0, mask False; the N = 8 tangents padded alike)
   through ``analyze_population`` on the N = 16 builds, and (b) the rows
   whose bodies lie in their first 5 slots cut to them (the others left
   out, counted), on the N = 5 builds: both held to phase 7's tail-off
   run, every column of TOL but is_stable within it and is_stable at
   LABEL_GATE (gated), the rows not bitwise printed, the launches of
   rows 1-2 gated > 0; (b)'s lowest bucket against the plain versions
   (``compare_case``); (c) a drawn population (``generate_population``,
   SLOT_POP_B systems of 9-16 bodies in 16 slots, seeded) at
   SLOT_POP_STEPS steps (launches gated, its finite share and the us
   per trip of its deepest lane), rows 1 and 2 on its B_CMP shallowest
   systems against their plain versions at SLOT_CMP_STEPS steps
   (``compare_case`` widened by the plain version's own rounding
   sensitivity, as phase 4's top bucket: these clusters are deep and
   chaotic) and at WITNESS_STEPS steps (``witness_case``: their final
   states bit for bit the multi-step kernel's, and their distance to
   the float64 plain run no worse than the float32 plain version's in
   three body orders, gated), and with ``use_fused_metrics=False``
   (row 3's launches gated); (d) row 3 at N = 2 (drawn pairs, one thread a system) and
   N = 16 ((c)'s shallowest) against its plain version (``row_gate``),
   its launches on a 2-body ``use_fused_metrics=False`` run gated; (e)
   rows 1-3 at N = 16, d = 3 under the reflection fold and the
   "reference" gradient on a drawn 3-D population's shallowest systems,
   as (c) at SLOT_VARIANT_STEPS and WITNESS_STEPS steps (the
   variants' launches gated on short runs).  Its builds (SLOT_JOBS) are
   made in phase 2 with the others; here each prints its registers,
   spills, shared bytes a block and resident warps an SM, and the
   builds at N <= 8 are gated at 0 bytes spilled.

It prints a ``{"kernels": [...]}`` line (the seven kernels, rows 1, 2
and 4 again at d = 3, rows 1 and 2 under each branch of phase 11, row 3
under the "reference" gradient and at d = 3, row 4's fallback, row 6
at d = 3, rows 1 and 4 on the scan route, rows 4 and 7 on the
facade's paths, and rows 1-3 at the slot counts of phase 25) and, last, the device line.  Any
failed check raises, so the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.  It writes
nothing outside the build directory (phase 23's CPU references and
their logs, and phase 24's shards, models and logs go there too).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "stability_131k.csv.gz")
B_MAIN = 16384
B_CMP = 1024
N_SLOTS = 8
N_STEPS = 1000
DT = 0.01
#: warm runs of the 2-D main path (one cold run before them); 3 until
#: the fused engine's branches came in, then 2, cut for the time limit
#: (1,214.5 s on a slow host with 2)
WARM_REPS = 1
#: warm runs of each of bench.py's legs (``run_leg``); 3 until the fused
#: engine's branches came in, then 2, cut for the time limit
LEG_WARM_REPS = 1
#: the dataset pipeline's configuration (nbodysimproject_tpu/generators/
#: pipeline.py:40-51), unmodified: the Kepler tail policy is "kepler"
PIPE = dict(slot_bucket=8, fast_float32=True, analysis_n_sub_cap=256,
            use_fused_analysis=True, analysis_group_quantum=1024)
#: the same with the tail fast path off
PIPE_OFF = dict(PIPE, analysis_tail_policy="off")
#: per-column (rtol, atol) of tests/test_pallas_batch.py:258-277
#: (fused-vs-scan agreement at float32 trajectory noise)
TOL = {
    "is_stable": (0.0, 0.0),
    "energy_drift": (0.05, 1e-5),
    "angular_momentum_drift": (0.05, 1e-5),
    "com_drift_mean": (1e-3, 1e-5),
    "com_drift_max": (1e-3, 1e-5),
    "j_eps_mean": (2e-3, 1e-6),
    "j_eps_std": (2e-3, 1e-6),
    "theta_eps_mean": (2e-3, 1e-3),
    "theta_eps_std": (2e-3, 1e-3),
    "cos_theta_mean": (1e-4, 1e-5),
    "cos_theta_min": (1e-4, 1e-5),
    "ang_mom_var_mean": (2e-3, 1e-7),
    "ang_mom_var_max": (2e-3, 1e-7),
    "tidal_trace_mean": (2e-3, 1e-3),
    "tidal_trace_max": (2e-3, 1e-3),
    "MEGNO": (1e-3, 1e-4),
    "lyapunov_time": (1e-2, 0.0),
    "megno_slope_med": (5e-3, 1e-3),
}
#: the top-bucket case also admits this many times the row's rounding
#: sensitivity, taken from the PLAIN version only: how far it moves when
#: rerun in float64, or with the body slots in two other orders (the
#: same physics, every sum in another order).  Deep n_sub systems
#: amplify rounding far more than the short benign runs the tolerances
#: above were set on: the SPH clip gate and the J-cap switch on float32
#: ulps there, and each switch moves the trajectory.  The lowest-bucket
#: case is held to the tolerances alone.
SENS_FACTOR = 10.0
#: the widening is granted on rows where the float32 plain version
#: itself lies outside the tolerances from its float64 run (any column
#: or final state value), and on at most this many other rows
MAX_WIDENED = 10
#: under a branch of the physics (the reflection fold, the "reference"
#: switch), a row past the widening is allowed only where the kernel's
#: and the plain version's trajectories first part at a trip where the
#: float64 plain trip, from the kernel's own state before it, puts the
#: branch's input within this many float32 ulps of its threshold
#: (``branch_walk``); at most MAX_WIDENED such rows
BRANCH_ULPS = 8
F32_ULP = 2.0 ** -23
#: final pos, vel, eps and pi of both kernels: (rtol, atol), as the
#: CPU tests hold the plain versions to the JAX kernels
STATE_TOL = (1e-4, 1e-5)
#: least share of the main path's fused rows whose is_stable agrees with
#: the dataset's (the one-thread kernels gave 0.9671 on the card;
#: reversed body slots alone move it by about 0.016)
LABEL_GATE = 0.95
#: the verdict's inputs and thresholds (analysis/fused.py)
VERDICT = {"energy_drift": 0.01, "angular_momentum_drift": 0.01,
           "com_drift_mean": 1.0, "MEGNO": 10.0}
MEGNO_COLS = ("MEGNO", "lyapunov_time", "megno_slope_med")
#: the dataset's own columns read for the comparison with the main path
REF_COLS = ("is_stable", "pathological_energy", "energy_drift", "n_sub",
            "system_type")
#: SimConfig's lambda_softening: the legacy gradient's strength in the
#: "reference" fallback's sign alignment
LAMBDA_SOFTENING = 0.3
#: published H100 SXM peaks (NVIDIA H100 datasheet): FP32 outside
#: the tensor cores, HBM bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

T0 = time.perf_counter()
_PHASE = [None, T0]


def phase(name):
    """Print the previous phase's seconds and start ``name``."""
    now = time.perf_counter()
    if _PHASE[0] is not None:
        print(f"  phase {_PHASE[0]!r} took {now - _PHASE[1]:.1f}s")
    _PHASE[:] = [name, now]
    print(f"[{now - T0:8.1f}s] == {name}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def load_population(n_rows, path=DATA, d=2):
    """(mass, pos, vel, mask, G, softening, min_softening) of the first
    ``n_rows`` rows of a dataset of dimension ``d``, as ml/dataset.py
    reads the file, and the dataset's own labels for them (columns of
    REF_COLS)."""
    import pandas as pd

    axes = ("x", "y", "z")[:d]
    cols = [f"{p}_{i}" for p in ("mass",) + axes
            + tuple(f"v{a}" for a in axes) for i in range(N_SLOTS)]
    df = pd.read_csv(path, comment="#", nrows=n_rows,
                     usecols=cols + ["G", "softening", "min_softening"]
                     + list(REF_COLS))
    get = lambda p: df[[f"{p}_{i}" for i in range(N_SLOTS)]].to_numpy(
        np.float64)
    mass = get("mass")
    mask = np.isfinite(mass)
    pos = np.stack([get(a) for a in axes], -1)
    vel = np.stack([get(f"v{a}") for a in axes], -1)
    clean = lambda a: np.where(np.isfinite(a), a, 0.0)
    return (clean(mass), clean(pos), clean(vel), mask,
            df["G"].to_numpy(np.float64), df["softening"].to_numpy(np.float64),
            df["min_softening"].to_numpy(np.float64)), df[list(REF_COLS)]


def label_agreement(df, ref, rows):
    """How often ``df``'s is_stable and pathological_energy agree with
    ``ref``'s on ``rows``, and how energy_drift compares where neither
    is pathological."""
    out = {"rows": int(rows.sum())}
    for col in ("is_stable", "pathological_energy"):
        a = df[col].to_numpy(bool)[rows]
        b = ref[col].to_numpy(bool)[rows]
        out[col] = {"agree": float((a == b).mean()),
                    "only_first": int((a & ~b).sum()),
                    "only_second": int((~a & b).sum()),
                    "shares": (float(a.mean()), float(b.mean()))}
    sane = rows & ~df["pathological_energy"].to_numpy(bool) \
        & ~ref["pathological_energy"].to_numpy(bool)
    a = df["energy_drift"].to_numpy(float)[sane]
    b = ref["energy_drift"].to_numpy(float)[sane]
    rtol, atol = TOL["energy_drift"]
    out["energy_drift_within_tol"] = float(
        (np.abs(a - b) <= atol + rtol * np.abs(b)).mean())
    return out


def print_agreement(what, agree):
    print(f"  {what}, on {agree['rows']} rows: " + "; ".join(
        f"{c} agrees on {v['agree']:.4f} (shares {v['shares'][0]:.4f} and "
        f"{v['shares'][1]:.4f}; {v['only_first']} rows only in the first, "
        f"{v['only_second']} only in the second)"
        for c, v in agree.items() if isinstance(v, dict))
        + f"; energy_drift within its tolerance on "
        f"{agree['energy_drift_within_tol']:.4f} of the rows sane in both")


def ptxas_counts(report):
    """(registers, stack frame bytes, spill bytes) of every function in a
    ptxas report."""
    import re

    ints = lambda pat: [int(x) for x in re.findall(pat, report)]
    return (ints(r"Used (\d+) registers"), ints(r"(\d+) bytes stack frame"),
            ints(r"(\d+) bytes spill (?:stores|loads)"))


def spill_gate(what, report, n_kernels, stack=False):
    """Registers of each kernel in a ptxas report, raising unless the
    report names ``n_kernels`` kernels and every one spills 0 bytes (and,
    with ``stack``, has 0 bytes of stack frame)."""
    regs, frames, spills = ptxas_counts(report)
    if len(regs) != n_kernels or len(spills) != 2 * n_kernels or any(spills) \
            or (stack and (len(frames) != n_kernels or any(frames))):
        raise SystemExit(f"{what}: every kernel must spill 0 bytes"
                         f"{' and keep no stack frame' if stack else ''}; "
                         f"ptxas says:\n{report}")
    return (f"{what}: registers {', '.join(map(str, regs))}, 0 bytes "
            f"spilled{', 0 bytes of stack frame' if stack else ''}")


def sass_step_counts(lib_path):
    """The SASS instructions of one step of each composition kernel
    instance in ``lib_path``: {stages: (instructions, MUFU instructions)}
    of its step loop (the one backward branch of its ``cuobjdump -sass``),
    or {stages: None} where the SASS does not show exactly one such loop;
    None where the toolkit has no cuobjdump or it fails.  A measurement,
    never a gate."""
    import re

    from nbodysimproject_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    run = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=120)
    if run.returncode != 0:
        return None
    out = {}
    for block in re.split(r"\n\s*Function : ", run.stdout)[1:]:
        name = re.search(r"composition_kernelILi\d+ELi\d+ELi(\d+)E", block)
        if name is None:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        loops = []
        for addr, text in ins:
            target = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if target and int(target.group(1), 16) < addr:
                body = [t for a, t in ins
                        if int(target.group(1), 16) <= a <= addr]
                loops.append((len(body), sum("MUFU" in t for t in body)))
        out[int(name.group(1))] = loops[0] if len(loops) == 1 else None
    return out


def issue_floor_ms(instructions):
    """Milliseconds to issue ``instructions`` thread instructions at one
    warp instruction per clock on each of the card's SM sub-partitions
    (4 per SM) at its maximum SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * instructions / (sms * 4 * 32 * mhz * 1e6)


# ---------------------------------------------------------------- work model
def trip_ops(n, d):
    """Arithmetic operations of one Strang trip, counted off the loops
    of the one-thread physics, csrc/hamsoft_physics.cuh (each add, mul,
    div, sqrt, exp or log counts one; the lane-split kernels repeat
    per-system work in every lane, which the bound does not count;
    compares and selects are not counted): pair distances, 8 forward
    SPH iterations, the softmin, the 8-step reverse sweep, two S and two
    V half-flows and the drift."""
    P, M = n * (n - 1) // 2, n * (n - 1)
    return (3 * d * P + 8 * (6 * M + 8 * n) + (6 * n + 4)
            + 8 * ((16 + 5 * d) * M + 14 * n)
            + 2 * (45 + n * (4 * d + 4) + 3 * n * d)
            + 2 * ((4 * d + 12) * P + 3 * n * d + 8) + 2 * n * d)


def entry_ops(n, d):
    """The (eps*, grad) evaluation at kernel entry."""
    P, M = n * (n - 1) // 2, n * (n - 1)
    return (3 * d * P + 8 * (6 * M + 8 * n) + (6 * n + 4)
            + 8 * ((16 + 5 * d) * M + 14 * n))


def metric_ops(n, d):
    """The step metrics; at d = 3 the vector branch (per body a cross
    product, its norm and the sums of L, |L_i| and their spread, then
    |L|, |L0| and the tilt) does 17 n + 14 more than the scalar one."""
    P = n * (n - 1) // 2
    return (2 * n * d + 2 * d + 9 * n + 4 + (3 * d + 9) * P + 17
            + (17 * n + 14 if d == 3 else 0))


def megno_ops(n, d):
    P = n * (n - 1) // 2
    return (6 * d + 14) * P + 8 * n * d + 8


def ref_ops(n, d, share):
    """The "reference" gradient's work on one eps* evaluation, counted off
    reference_switch in csrc/hamsoft_physics.cuh as trip_ops counts: the
    test on every evaluation (each valid row's norm, 2 d and a root, and
    the largest pair distance's root) and, on the ``share`` of
    evaluations that take the fallback, the Omega gradient (per body 12,
    per ordered pair 17 + 4 d: the kernel term, its two sums, the
    coefficient and its scatter), the legacy gradient (per pair 9 + 5 d,
    3 more) and the sign alignment (2 n d).  The median runs only where
    the largest distance cannot decide and is not counted; ``share``
    (the fallback's share of lanes at t = 0, ``fallback_lanes``) stands
    for the share of every trip's evaluations, which the run does not
    record."""
    P, M = n * (n - 1) // 2, n * (n - 1)
    fallback = 12 * n + M * (17 + 4 * d) + P * (9 + 5 * d) + 3 + 2 * n * d
    return n * (2 * d + 1) + 1 + share * fallback


def bound(kind, n_sub_lanes, n_sub_max, n_steps, megno_steps, n, d,
          share=None):
    """(bound_ms, bound_by) of one launch on these lanes: the larger of
    the bytes it must move over HBM bandwidth and the operations it does
    (each lane runs min(n_sub, n_sub_max) trips per step) over the FP32
    peak; with ``share`` (the "reference" gradient) ``ref_ops`` more on
    every trip and at entry."""
    ns = np.minimum(np.maximum(n_sub_lanes, 1), n_sub_max).astype(np.float64)
    B = len(ns)
    extra = 0.0 if share is None else ref_ops(n, d, share)
    trip, entry = trip_ops(n, d) + extra, entry_ops(n, d) + extra
    if kind == "analysis":
        n_samples = -(-n_steps // max(1, n_steps // 100))
        ops = (ns.sum() * n_steps * trip
               + B * (n_samples * metric_ops(n, d) + entry))
        words = B * (4 * n * d + n + 10 + 2 + 17 + 2 * n_samples)
    else:
        ops = (ns.sum() * megno_steps * trip
               + B * (megno_steps * megno_ops(n, d) + entry))
        words = B * (6 * n * d + n + 11 + 4 + megno_steps)
    t_ops, t_bytes = ops / PEAK_FP32, 4 * words / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fallback_lanes(st, dy, clamp=False, ek=False, eta=1.35):
    """Per system (taken, near): whether the "reference" fallback takes
    the gradient at ``st.pos`` in the plain physics (float32), and
    whether the float64 plain rerun puts gmax at the threshold: on the
    other branch, or within BRANCH_ULPS float32 ulps of 1e-9 r_median or
    of 1e-12 (``switch_ulps``).  ``ek``: the eps kernel's bounds (min and
    max of eps_min and eps_max) and, with ``clamp``, its value clamp;
    else the ham_soft kernels' (eps_min and eps_max as they are)."""
    from nbodysimproject_tpu_torch.ops.eps_model import degenerate_grad
    from nbodysimproject_tpu_torch.ops.hamsoft_kernels import _Physics

    res = []
    for dt_ in (torch.float32, torch.float64):
        pos = st.pos.to(dt_)
        m = torch.where(st.mask, st.mass, torch.zeros_like(st.mass)).to(dt_)
        lo, hi = dy.min_softening.to(dt_), dy.max_softening.to(dt_)
        a, b = (torch.minimum(lo, hi), torch.maximum(lo, hi)) if ek \
            else (lo, hi)
        flo = torch.clamp_min(a, 1e-12) if ek else a
        cap = torch.maximum(flo, b) if ek else b
        one = torch.ones_like(lo)
        ph = _Physics(m, st.eps.to(dt_), one, one, dy.alpha_run.to(dt_), flo,
                      cap, G=1.0, k_wall=0.0, eta=eta, jcap=0.02, bexp=5)
        es, g, _h = ph.exact_eps_grad(pos)
        if clamp:
            g = torch.where(((es >= a) & (es <= b))[:, None, None], g,
                            torch.zeros_like(g))
        res.append(degenerate_grad(g, pos, ph.valid))
    (taken, _g32, _t32), (taken64, g64, t64) = res
    near = (taken != taken64) | (switch_ulps(g64, t64) <= BRANCH_ULPS)
    return taken, near


# ------------------------------------------------------------------ compare
def conditioning(st, dy, cfg):
    """Per-row conditioning of the two drift columns: energy scale
    (|T| + |V|) over |H0| and angular-momentum scale (sum |L_i|) over
    |L0|, at least 1.  A relative drift of a nearly cancelled H0 or L0
    carries float32 noise that much larger than for a well-conditioned
    system, so the drift columns' absolute tolerance is scaled by it."""
    from nbodysimproject_tpu_torch.diagnostics import energy as E

    H0 = E.extended_hamiltonian(st, dy, cfg)
    scale_E = E.kinetic_energy(st) + torch.abs(E.potential_energy(st, dy))
    q, v = st.pos, st.vel
    if q.shape[-1] == 2:
        L_i = (st.mass * (q[..., 0] * v[..., 1] - q[..., 1] * v[..., 0]))[
            ..., None]
    else:  # d = 3: the drift of |L|, L the vector sum of m q x v
        L_i = st.mass[..., None] * torch.linalg.cross(q, v, dim=-1)
    L_i = torch.where(st.mask[..., None], L_i, torch.zeros_like(L_i))
    scale_L = L_i.norm(dim=-1).sum(-1)
    ratio = lambda s, x: torch.clamp_min(
        s / torch.clamp_min(torch.abs(x), 1e-30), 1.0).cpu().numpy()
    return {"energy_drift": ratio(scale_E, H0),
            "angular_momentum_drift": ratio(scale_L,
                                            L_i.sum(-2).norm(dim=-1))}


class Timed:
    """Calls ``fn`` between two CUDA events and keeps the last outputs
    and the elapsed device milliseconds."""

    def __init__(self, fn):
        self.fn, self.ms, self.out = fn, None, None

    def __call__(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        self.out = self.fn(*args, **kw)
        stop.record()
        stop.synchronize()
        self.ms = start.elapsed_time(stop)
        return self.out


class TimedEach:
    """Calls ``fn`` between two CUDA events on every call and keeps, per
    call, the events and the call's ``n_steps``; ``times()`` gives
    [(n_steps, ms)] once the device is done."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kw)
        stop.record()
        self.calls.append((kw.get("n_steps"), start, stop))
        return out

    def times(self):
        torch.cuda.synchronize()
        return [(n, a.elapsed_time(b)) for n, a, b in self.calls]


def _double(x):
    """A SimState or DynParams with every floating field in float64."""
    return x.replace(**{f.name: getattr(x, f.name).double()
                        for f in dataclasses.fields(x)
                        if torch.is_floating_point(getattr(x, f.name))})


def _permuted(st, tan, perm):
    if perm is None:
        return st, tan
    return (st.replace(mass=st.mass[:, perm], pos=st.pos[:, perm],
                       vel=st.vel[:, perm], mask=st.mask[:, perm]),
            (tan[0][:, perm], tan[1][:, perm]))


def _stacked(*xs):
    """The systems of each of ``xs`` (SimStates or DynParams) in turn."""
    if len(xs) == 1:
        return xs[0]
    return type(xs[0])(**{f.name: torch.cat([getattr(x, f.name) for x in xs])
                          for f in dataclasses.fields(xs[0])})


def _final_state(timed, perm, rows=slice(None)):
    """The final (pos, vel, eps, pi) of systems ``rows`` of a timed kernel
    call as float64 arrays, the body slots put back in the original
    order."""
    pos, vel, eps, pi = (x[rows].detach().cpu().numpy().astype(np.float64)
                         for x in timed.out[:4])
    if perm is not None:
        inv = np.argsort(perm.cpu().numpy())
        pos, vel = pos[:, inv], vel[:, inv]
    return {"pos": pos, "vel": vel, "eps": eps, "pi": pi}


class PlainTrace:
    """Within the context, watches the plain physics (``hk._Physics``).
    With ``count``: ``share``, the share of the eps* evaluations of
    active lanes (every lane at entry) whose gradient the "reference"
    fallback replaced; it compares the switch's output with its input,
    so that the count costs the timed plain run next to nothing (a
    fallback equal to the exact gradient in every bit is not counted).
    With ``record``: ``runs``, (pos, vel, eps, pi) after every trip, one
    list a ``hk._Physics`` made (one a kernel's plain version called),
    in the order they were made."""

    def __init__(self, hk, count=False, record=False):
        self.hk, self.count, self.record = hk, count, record
        self.taken, self.evals, self.runs = 0, 0, []

    def __enter__(self):
        if not (self.count or self.record):
            return self
        rec, base = self, self.hk._Physics

        class Watched(base):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                self._live, self._trips = None, []
                rec.runs.append(self._trips)

            def strang_trip(self, *args):
                self._live = args[-1]
                try:
                    out = super().strang_trip(*args)
                finally:
                    self._live = None
                if rec.record:
                    self._trips.append(out[:4])
                return out

            def reference_switch(self, pos, h_fin, g):
                out = super().reference_switch(pos, h_fin, g)
                if rec.count:
                    took = (out != g).flatten(1).any(1)
                    live = self._live
                    if live is not None:
                        took = took & live
                    rec.taken = rec.taken + took.sum()
                    rec.evals = rec.evals + (took.numel() if live is None
                                             else live.sum())
                return out

        self.base = base
        self.hk._Physics = Watched
        return self

    def __exit__(self, *exc):
        if self.count or self.record:
            self.hk._Physics = self.base

    @property
    def share(self):
        return float(self.taken) / max(float(self.evals), 1.0)


def fold_ulps(ph, e):
    """How near the reflection fold's input ``e`` lies to a wall or to
    the fold's period (where pi changes sign), in float32 ulps of ``e``;
    an input exactly on one (the state a fold left there, which every
    version folds alike) counts as infinitely far."""
    R = ph.cap - ph.flo
    x = e - ph.flo
    y = x - 2.0 * R * torch.floor(x / (2.0 * R))
    gap = torch.minimum(torch.minimum(y, (y - R).abs()), 2.0 * R - y)
    ulps = gap / (e.abs() * F32_ULP)
    return torch.where(gap > 0, torch.nan_to_num(ulps, nan=np.inf),
                       torch.full_like(ulps, np.inf))


def switch_ulps(gmax, thr):
    """How near gmax lies to the "reference" switch's thresholds (1e-12
    and ``thr``, 1e-9 times the median pair distance), in float32 ulps
    of the threshold."""
    a = (gmax - 1e-12).abs() / (1e-12 * F32_ULP)
    b = torch.nan_to_num((gmax - thr).abs() / (thr * F32_ULP), nan=np.inf)
    return torch.minimum(a, b)


def branch_gaps(hk, start, seed, mass, h, phys, conf):
    """One plain trip from ``start`` (pos, vel, eps, pi; every system
    active), its SPH solve seeded from ``seed``, with the entry
    gradient: per system the nearest approach, in float32 ulps, of a
    reflection fold's input to a wall or of gmax to the switch's
    threshold (``fold_ulps``, ``switch_ulps``)."""
    from nbodysimproject_tpu_torch.ops import eps_model as epsmod

    near = []

    class Gaps(hk._Physics):
        def fold(self, e, p):
            near.append(fold_ulps(self, e))
            return super().fold(e, p)

        def reference_switch(self, pos, h_fin, g):
            _deg, gmax, thr = epsmod.degenerate_grad(g, pos, self.valid)
            near.append(switch_ulps(gmax, thr))
            return super().reference_switch(pos, h_fin, g)

    pos, vel, eps, pi = start
    ph = Gaps(mass, seed, phys["k_soft"], phys["mu"], phys["alpha"],
              phys["eps_min"], phys["eps_max"], **conf)
    es, grad = ph.eps_star_and_grad(pos)
    ph.strang_trip(pos, vel, eps, pi, es, grad, h,
                   torch.ones_like(eps, dtype=torch.bool))
    gap = torch.full_like(eps, np.inf)
    for u in near:
        gap = torch.minimum(gap, u)
    return gap


def same_bits(a, b):
    """Per system, whether the states a and b (pos, vel, eps, pi) agree in
    every bit (NaN equal to NaN)."""
    out = torch.ones(a[2].shape, dtype=torch.bool, device=a[2].device)
    for x, y in zip(a, b):
        x, y = x.reshape(len(out), -1), y.reshape(len(out), -1)
        out &= ((x == y) | (torch.isnan(x) & torch.isnan(y))).all(1)
    return out


def tol_units(x, ref):
    """Per system, the largest |x - ref| / (atol + rtol |ref|) over the
    entries of the states x and ref (STATE_TOL); inf where one of them is
    finite and the other not, 0 where neither is."""
    rtol, atol = STATE_TOL
    out = torch.zeros(ref[2].shape, dtype=torch.float64,
                      device=ref[2].device)
    for a, b in zip(x, ref):
        a, b = a.double().reshape(len(out), -1), b.double().reshape(
            len(out), -1)
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        u = torch.where(fa & fb, (a - b).abs() / (atol + rtol * b.abs()),
                        torch.where(fa == fb, torch.zeros_like(a),
                                    torch.full_like(a, float("inf"))))
        out = torch.maximum(out, u.max(1).values)
    return out


def finite_rows(*states):
    """Per system, whether every entry of ``states`` is finite."""
    out = torch.ones(states[0][2].shape, dtype=torch.bool,
                     device=states[0][2].device)
    for st in states:
        for a in st:
            out &= torch.isfinite(a.reshape(len(out), -1)).all(1)
    return out


def state_parts(a, b):
    """Per system, whether the states ``a`` and ``b`` (pos, vel, eps, pi)
    lie apart by more than STATE_TOL, or are finite in other entries."""
    return tol_units(a, b) > 1


def recorded_prefixes(trips, start, per, steps):
    """The plain version's states after 0, 1, ... trips of each system,
    from the trips its run recorded (``PlainTrace``: ``steps`` macro steps
    of len(trips) // steps trips, a system active in the first ``per``
    of each): a list of (pos, vel, eps, pi)."""
    tmax = len(trips) // steps
    stacked = [torch.stack([t[q] for t in trips]) for q in range(4)]
    last = steps * per
    rows = torch.arange(len(per), device=per.device)
    out = [start]
    for m in range(1, int(last.max()) + 1):
        j = torch.clamp_max(torch.full_like(per, m), last) - 1
        idx = (j // per) * tmax + j % per
        out.append(tuple(x[idx, rows] for x in stacked))
    return out


def kernel_prefixes(multistep, start, mass, trips, h, phys, conf):
    """The kernel's states after 0, 1, ... max(trips) trips, from one
    launch of the multi-step kernel (``multistep``): each system copied
    once for every prefix m, which runs min(m, trips) trips of size h in
    one macro step (the analysis and MEGNO kernels run these trips in
    the same arithmetic).  A list as ``recorded_prefixes``'."""
    R, T = len(trips), int(trips.max())
    dev = trips.device
    m = torch.arange(1, T + 1, device=dev)
    ns = torch.minimum(m[None, :], trips[:, None]).reshape(-1).to(
        torch.int32)
    rep = lambda x: x.repeat_interleave(T, 0)
    out = multistep(*(rep(x) for x in (start[0], start[1], mass, start[2],
                                       start[3])),
                    **{k: rep(v) for k, v in phys.items()}, h=rep(h),
                    n_sub=ns, n_steps=1, n_sub_max=T, **conf)
    out = [x.reshape((R, T) + x.shape[1:]) for x in out]
    return [start] + [tuple(x[:, j] for x in out) for j in range(T)]


def branch_walk(hk, st, dy, cfg, n_steps, megno_steps, n_sub_max, kfinal,
                plain_trips, names):
    """For the systems (st, dy) of a branch case (the reflection fold,
    the "reference" switch) that lie past the widening: whether the
    kernel's and the plain version's trajectories first part at a trip
    where a branch sits at its threshold.  The kernel's states come from
    ``kernel_prefixes`` (the multi-step kernel), checked bit for bit
    against the analysis and MEGNO kernels' final states ``kfinal``
    ({kind: (pos, vel, eps, pi)}); the plain version's from the trips its
    run recorded (``plain_trips``: {kind: ``PlainTrace.runs`` list}).  At the first trip where they lie apart by more
    than STATE_TOL (``state_parts``), the float64 plain trip from the
    kernel's own state before it (``branch_gaps``) must put a fold's
    input or gmax within BRANCH_ULPS float32 ulps of its threshold.
    Returns per system whether it is allowed, and prints each walk
    (``names``: the systems' rows in the case)."""
    from nbodysimproject_tpu_torch.analysis.fused import _kernel_policy

    nsub = torch.clamp_min(dy.n_sub, 1)
    per = torch.clamp_max(nsub, n_sub_max)
    h = DT / nsub.to(torch.float32)
    phys = dict(k_soft=dy.k_soft, mu=dy.mu_soft, alpha=dy.alpha_run,
                eps_min=dy.min_softening, eps_max=dy.max_softening)
    conf = dict(G=1.0, k_wall=float(cfg.k_wall), eta=float(cfg.eta),
                jcap=float(cfg.j_max_cap), bexp=int(cfg.barrier_exponent),
                policy=_kernel_policy(cfg), grad_mode=str(cfg.eps_grad_mode),
                lam_align=float(cfg.lambda_softening))
    R = len(per)
    allowed = np.zeros(R, bool)
    walked = np.zeros(R, bool)
    k_at = (st.pos, st.vel, st.eps, st.pi)
    p_at = k_at
    for kind, steps in (("analysis", n_steps), ("megno", megno_steps)):
        trips = steps * per
        K = kernel_prefixes(hk.hamsoft_multistep, k_at, st.mass, trips, h,
                            phys, conf)
        P = recorded_prefixes(plain_trips[kind], p_at, per, steps)
        T = trips.cpu().numpy()
        end = lambda S: tuple(torch.stack([S[t][i][r] for r, t in
                                           enumerate(T)]) for i in range(4))
        k_end, p_end = end(K), end(P)
        same = same_bits(k_end, kfinal[kind])
        parts = torch.stack([state_parts(K[j], P[j])
                             for j in range(len(K))]).cpu().numpy()
        first = np.where(parts.any(0), parts.argmax(0), -1)
        rows = np.nonzero((first > 0) & ~walked)[0]
        if len(rows):
            ix = torch.as_tensor(rows, device=per.device)
            before = tuple(torch.stack([K[first[r] - 1][i][r] for r in rows])
                           for i in range(4))
            d64 = lambda x: x.double()
            gap = branch_gaps(
                hk, tuple(d64(x) for x in before), d64(k_at[2][ix]),
                d64(st.mass[ix]), d64(h[ix]),
                {k: d64(v[ix]) for k, v in phys.items()}, conf)
            gap = gap.cpu().numpy()
            for j, r in enumerate(rows):
                walked[r] = True
                allowed[r] = bool(same[r]) and gap[j] <= BRANCH_ULPS
                print(f"      walk of row {names[r]}: the {kind} kernel's replay "
                      f"{'equals' if same[r] else 'differs from'} its final "
                      f"state bit for bit; kernel and plain part at trip "
                      f"{first[r]} of {T[r]}, where the float64 plain trip "
                      f"puts a branch {gap[j]:.3g} float32 ulps from its "
                      f"threshold: {'allowed' if allowed[r] else 'not allowed'}")
        k_at, p_at = kfinal[kind], p_end
    for r in np.nonzero(~walked)[0]:
        print(f"      walk of row {names[r]}: no trip where kernel and plain "
              f"first part by more than STATE_TOL: not a branch, not "
              f"allowed")
    return allowed


def judge_case(rp, rk, others, cond, allowed):
    """The verdict of ``compare_case`` on its compared rows: ``rp``/``rk``
    the plain and kernel columns (arrays with the rows first; the final
    states as "<kernel>.pos" and so on), ``others`` the plain version's
    other runs ("plain float64", "plain reversed", "plain rolled": those
    made), ``cond`` the drift columns' conditioning, ``allowed`` the rows
    that ``branch_walk`` allows past the widening (at most MAX_WIDENED;
    is_stable stays gated on them).  Returns (report lines, failures,
    rows outside the widening before any is allowed)."""
    n_keep = len(rp["energy_drift"])
    row_any = lambda x: x.reshape(n_keep, -1).any(1)
    ones = np.ones(n_keep)

    def spread(col):
        """max |plain - plain in float64 or on reordered slots|, per row
        and element (0 where not widening)"""
        s = np.zeros_like(rp[col])
        for o in others.values():
            dlt = np.abs(o[col] - rp[col])
            s = np.maximum(s, np.where(np.isfinite(dlt), dlt, 0.0))
        return s

    tols = {c: (TOL[c] if c in TOL else STATE_TOL) for c in rp
            if c != "is_stable" and (c in TOL or "." in c)}
    lines, failures = [], []
    widened, f32_off = np.zeros(n_keep, bool), np.zeros(n_keep, bool)
    outside = np.zeros(n_keep, bool)
    for col in sorted(tols):
        a, b = rp[col], rk[col]
        rtol, atol = tols[col]
        atol = (atol * cond.get(col, ones)).reshape((-1,) + (1,) * (a.ndim - 1))
        sens = spread(col)
        both = np.isfinite(a) & np.isfinite(b)
        err = np.where(both, np.abs(b - a), 0.0)
        base = atol + rtol * np.abs(np.where(both, a, 0.0))
        out_rows = row_any((err > base + SENS_FACTOR * sens)
                           | (np.isfinite(a) != np.isfinite(b)))
        outside |= out_rows
        at_branch = out_rows & allowed
        out_rows = out_rows & ~allowed
        wide_rows = row_any(err > base) & ~out_rows & ~at_branch
        widened |= wide_rows
        rel = err[both] / np.maximum(np.abs(a[both]), 1e-30)
        line = (f"    {col:24s} max_abs {err.max(initial=0):.3e} "
                f"max_rel {rel.max(initial=0):.3e} outside "
                f"{int(out_rows.sum())} rows, widened {int(wide_rows.sum())}, "
                f"allowed at a branch {int(at_branch.sum())}")
        if "plain float64" in others:
            c = others["plain float64"][col]
            fin = both & np.isfinite(c)
            d32 = np.where(fin, np.abs(a - c), 0.0)
            dk = np.where(fin, np.abs(b - c), 0.0)
            off = row_any(d32 > base)
            f32_off |= off
            line += (f"; to float64 plain: max_abs float32 plain "
                     f"{d32.max(initial=0):.3e}, kernel "
                     f"{dk.max(initial=0):.3e}; float32 plain outside the "
                     f"tolerance on {int(off.sum())} rows")
        lines.append(line)
        for i in np.nonzero(out_rows)[0][:5]:
            j = np.unravel_index(np.argmax((err - base)[i]), err[i].shape)
            idx = [int(x) for x in j]
            lines.append(f"      row {i}{idx if idx else ''}: plain "
                         f"{a[i][j]:.6e} kernel {b[i][j]:.6e} plain reorder "
                         f"spread {sens[i][j]:.3e}")
        if out_rows.any():
            failures.append(col)
    other = widened & ~f32_off
    n_allowed = int((allowed & outside).sum())
    lines.append(f"    {int(widened.sum())} rows needed the widening, "
                 f"{int(other.sum())} of them (at most {MAX_WIDENED}) outside "
                 f"the {int(f32_off.sum())} rows where the float32 plain "
                 f"version lies outside the tolerances from its float64 run; "
                 f"{n_allowed} rows allowed at a branch (at most "
                 f"{MAX_WIDENED})")
    if other.sum() > MAX_WIDENED:
        failures.append(f"{int(widened.sum())} widened rows")
    if n_allowed > MAX_WIDENED:
        failures.append(f"{n_allowed} rows allowed at a branch")
    # labels: exact, except rows where a verdict input lies within its
    # own tolerance of the threshold (there the label may flip legitimately)
    edge = np.zeros(n_keep, bool)
    for col, thr in VERDICT.items():
        rtol, atol = TOL[col]
        atol = atol * cond.get(col, ones)
        edge |= np.abs(rp[col] - thr) <= (atol + rtol * abs(thr)
                                          + SENS_FACTOR * spread(col))
    differ = rp["is_stable"] != rk["is_stable"]
    flips = differ & ~edge
    lines.append(f"    is_stable: {int(differ.sum())} differ, "
                 f"{int(edge.sum())} rows at a threshold, {int(flips.sum())} "
                 f"flips away from one")
    if flips.any():
        failures.append("is_stable")
    return lines, failures, outside


def compare_case(label, states, dyns, cfg, lanes, n_steps, n_sub_max, hk,
                 engine, tangent_of, widen):
    """Kernel engine vs plain engine on the same lanes; the analysis
    columns and both kernels' final states are held to their
    tolerances, plus (``widen``) SENS_FACTOR times the plain version's
    own rounding sensitivity (its distance to its float64 run and to
    its runs on reordered body slots), on the rows where float32 itself
    misses the tolerances against float64 and at most MAX_WIDENED more
    (``judge_case``).  Under a branch (the reflection fold, the
    "reference" switch) a row past that is allowed only where
    ``branch_walk`` finds the two trajectories parting at a branch's
    threshold, on at most MAX_WIDENED rows.  Returns per kernel (kernel
    ms, plain ms, max abs error of the final state, n_sub, n_steps,
    megno_steps, n_sub_max, the fallback's share of the plain run's eps*
    evaluations or None)."""
    st, dy = states.take(lanes), dyns.take(lanes)
    tan = tangent_of(st)
    megno_steps = min(100, min(50, n_steps // 2))
    n = st.pos.shape[1]
    dev = st.pos.device
    # the fused way samples inside the analysis kernel; with
    # use_fused_metrics=False the multi-step kernel runs between samples
    first = "analysis" if cfg.use_fused_metrics else "multistep"
    fn = {"analysis": "hamsoft_analysis_multistep",
          "multistep": "hamsoft_multistep"}[first]
    kern = (getattr(hk, fn), hk.hamsoft_megno_multistep)
    plain = (getattr(hk, f"{fn}_plain"), hk.hamsoft_megno_multistep_plain)
    # (routes, functions, body-slot orders, float64); the first kernel
    # run warms up.  Routes of several orders run as one batch, a copy of
    # the systems an order (the plain version is bound by its launches,
    # not by its batch), and are split after
    runs = [(("warm",), kern, (None,), False),
            (("kernel",), kern, (None,), False),
            (("plain",), plain, (None,), False)]
    if widen:
        runs += [(("plain float64",), plain, (None,), True),
                 (("plain reversed", "plain rolled"), plain,
                  (torch.arange(n - 1, -1, -1, device=dev),
                   torch.roll(torch.arange(n, device=dev), 3)), False)]
    ref = cfg.eps_grad_mode == "reference"
    # the branches of the physics a float32 rounding can flip: the
    # plain run keeps its trips for ``branch_walk``
    branches = not (cfg.use_soft_barrier or cfg.disable_barrier) or ref
    walk = branches and first == "analysis"
    out = {}
    for routes, fns, perms, f64 in runs:
        route = routes[0]
        starts = [_permuted(st, tan, p) for p in perms]
        start = _stacked(*(s_ for s_, _t in starts))
        t_in = tuple(torch.cat([t[i] for _s, t in starts]) for i in range(2))
        dyn = _stacked(*([dy] * len(perms)))
        if f64:
            start, dyn = _double(start), _double(dy)
            t_in = (t_in[0].double(), t_in[1].double())
        ta, tm = (Timed(f) for f in fns)
        t0 = time.perf_counter()
        with PlainTrace(hk, count=ref and route == "plain",
                        record=walk and route == "plain") as trace:
            res, _ = engine(start, dyn, cfg, n_steps, DT, "full", n_sub_max,
                            megno_steps, tangent=t_in, g_static=1.0,
                            megno_fn=tm, **{f"{first}_fn": ta})
        torch.cuda.synchronize()
        if route == "plain":
            share = trace.share if ref else None
            plain_runs = trace.runs
        secs = time.perf_counter() - t0
        for j, (name, perm) in enumerate(zip(routes, perms)):
            rows = slice(j * len(lanes), (j + 1) * len(lanes))
            cols = {k: v[rows].cpu().numpy().astype(np.float64)
                    for k, v in res.items()}
            for kind, t in ((first, ta), ("megno", tm)):
                cols.update({f"{kind}.{k}": v for k, v in
                             _final_state(t, perm, rows).items()})
            out[name] = (cols, ta, tm, secs)
    rk, ka, km, tk = out["kernel"]
    rp, pa, pm, tp = out["plain"]
    keep = np.isfinite(rp["energy_drift"]) & (np.abs(rp["energy_drift"])
                                              <= 10.0)
    n_keep = int(keep.sum())
    print(f"  {label}: {len(lanes)} systems, n_steps={n_steps}, "
          f"megno_steps={megno_steps}, n_sub_max={n_sub_max}; kernel "
          f"engine {tk:.3f}s, plain engine {tp:.3f}s; {n_keep} rows with "
          f"non-pathological energy compared; "
          f"{'widened by the plain version sensitivity' if widen else 'tolerances alone'}"
          + (f"; the fallback replaced {share:.4f} of the plain run's eps* "
             f"evaluations" if ref else ""))
    sel = lambda cols: {k: v[keep] for k, v in cols.items()}
    others = {r: sel(out[r][0]) for r in ("plain float64", "plain reversed",
                                          "plain rolled") if r in out}
    cond = ({k: v[keep] for k, v in conditioning(st, dy, cfg).items()}
            if widen else {})
    allowed = np.zeros(n_keep, bool)
    _lines, _fail, outside = judge_case(sel(rp), sel(rk), others, cond,
                                        allowed)
    if branches and outside.any():
        rows = np.nonzero(keep)[0][outside]
        print(f"    {len(rows)} rows past the widening under a branch "
              f"(the reflection fold or the reference switch)")
        if first != "analysis" or len(rows) > MAX_WIDENED:
            print(f"    not walked: {'more than MAX_WIDENED' if len(rows) > MAX_WIDENED else 'the fused way only'}")
        else:
            ix = torch.as_tensor(rows, device=dev)
            kfinal = {kind: tuple(torch.as_tensor(
                rk[f"{kind}.{k}"][rows], dtype=torch.float32, device=dev)
                for k in ("pos", "vel", "eps", "pi"))
                for kind in ("analysis", "megno")}
            trips = {kind: [tuple(x[ix] for x in t) for t in run]
                     for kind, run in zip(("analysis", "megno"), plain_runs)}
            allowed[np.nonzero(outside)[0]] = branch_walk(
                hk, st.take(ix), dy.take(ix), cfg, n_steps, megno_steps,
                n_sub_max, kfinal, trips, rows)
    lines, failures, _ = judge_case(sel(rp), sel(rk), others, cond, allowed)
    print("\n".join(lines))
    if failures:
        raise SystemExit(f"{label}: kernel disagrees with its plain version "
                         f"on {failures}")

    def state_err(kind):
        """max |kernel - plain| over the final pos, vel, eps, pi of the
        compared rows, where both are finite"""
        err = 0.0
        for k in ("pos", "vel", "eps", "pi"):
            dlt = np.abs(rk[f"{kind}.{k}"][keep] - rp[f"{kind}.{k}"][keep])
            err = max(err, float(dlt[np.isfinite(dlt)].max(initial=0.0)))
        return err

    n_sub = dy.n_sub.cpu().numpy()
    return {first: (ka.ms, pa.ms, state_err(first), n_sub, n_steps,
                    megno_steps, n_sub_max, share),
            "megno": (km.ms, pm.ms, state_err("megno"), n_sub,
                      n_steps, megno_steps, n_sub_max, share)}


def bucket_cases(prefix, states, dyns, n_sub_raw, cfg, hk, tangent_of,
                 which=("lowest", "top")):
    """Phase 4's two comparisons on a population (``compare_case``): the
    lowest n_sub bucket (B_CMP lanes, or the B_CMP shallowest) at 20
    steps on the tolerances alone, and the B_CMP deepest lanes at 2
    steps with the widening (``which`` names the ones to run); each
    kernel's time per trip of its deepest lane.  Returns (cases, low
    lanes, top lanes, n_sub buckets)."""
    from nbodysimproject_tpu_torch.analysis.batch import _bucket_ladder_values
    from nbodysimproject_tpu_torch.analysis.fused import analyze_batch_fused

    n_sub = np.minimum(n_sub_raw, cfg.analysis_n_sub_cap)
    buckets = _bucket_ladder_values(n_sub)
    low = np.nonzero(buckets == buckets.min())[0]
    low = low[:B_CMP] if len(low) >= B_CMP else np.argsort(
        n_sub, kind="stable")[:B_CMP]
    top = np.argsort(-n_sub, kind="stable")[:B_CMP]
    dev = states.pos.device
    cases = []
    for label, lanes, steps, nsm, widen in (
            (f"{prefix}lowest bucket", low, 20, int(buckets[low].max()),
             False),
            (f"{prefix}top bucket", top, 2, int(cfg.analysis_n_sub_cap),
             True)):
        if label[len(prefix):].split()[0] not in which:
            continue
        t0 = time.perf_counter()
        cases.append(compare_case(label, states, dyns, cfg,
                                  torch.as_tensor(lanes, device=dev), steps,
                                  nsm, hk, analyze_batch_fused, tangent_of,
                                  widen))
        for kind, c in cases[-1].items():
            ms, _, _, _, n_steps_c, msteps, nsm_c, _share = c
            trips = (n_steps_c if kind == "analysis" else msteps) * nsm_c
            print(f"  {label}, {kind} kernel: {ms:.3f} ms, "
                  f"{1e3 * ms / trips:.3f} us per trip of its deepest lane "
                  f"({trips} trips)")
        print(f"  {label} done in {time.perf_counter() - t0:.1f}s")
    return cases, low, top, buckets


# ------------------------------------------------------ the batched slice
#: bench.py's configuration #1: the 3-body system (bench.py:48-54) with
#: 1% Gaussian IC perturbations, dt 0.01, float32
BENCH_M = (1.0, 0.5, 0.1)
BENCH_Q = ((0.0, 0.0), (1.0, 0.0), (0.0, 2.0))
BENCH_V = ((0.0, 0.0), (0.0, 1.0), (-0.5, 0.0))
#: the six legs' widths and horizons (bench.py:44-340)
B_SCAN, SCAN_STEPS = 16384, 1000
#: the eager WHFast scan leg's depth, cut from 1000 steps, from 200 and
#: from 100 (to pay for the scan route's phase, 22) so the script keeps
#: inside its time limit; its rate is per system-step
WH_SCAN_STEPS = 50
B_VERLET_FUSED, B_Y4_FUSED, B_HS = 1 << 24, 1 << 22, 1 << 20
HS_STEPS, HS_NSUB_CAP = 100, 50
FUSED_EPS2 = 1e-6
#: short horizons of the kernel-vs-plain comparisons at full width
CMP_COMPOSITION_STEPS, CMP_MULTISTEP_STEPS = 20, 2
#: the composition kernel's 3-D compare case (N = 8, d = 3) and its
#: sweep over every (N, d) it takes (B_SHAPES systems, SHAPES_STEPS
#: steps: the plain version's launches on small tensors set its time)
B_RING, B_SHAPES, SHAPES_STEPS = 1 << 18, 4096, 20
COMPOSITION_SHAPES = tuple((n, d) for d in (2, 3) for n in range(2, 17))
#: composition builds gated at 0 bytes spilled and 0 of stack frame
COMPOSITION_GATED = tuple((n, d) for n in (3, 4, 8) for d in (2, 3))
#: kernel-vs-plain tolerances (rtol, atol): final pos/vel of the
#: composition kernel and of the multi-step kernel as STATE_TOL; the eps
#: kernel's eps* and gradient as the CPU tests hold its plain version to
#: the JAX kernel
EPS_TOL = {"es": (1e-6, 0.0), "grad": (1e-5, 1e-5)}
#: use_fused_metrics=False is held to its plain version (the multi-step
#: kernel's) by compare_case, as the fused way is.  Against the fused way
#: it is held at one step, where both kernels seed the SPH solve from the
#: same entry eps and run the same trips (every row within TOL), and
#: measured, not gated, at the horizon of the JAX package's own parity
#: test (tests/test_pallas_batch.py, 12 steps) and at the full horizon:
#: each chunk of the multi-step kernel seeds its SPH solve from its own
#: entry eps where the analysis kernel seeds once, a difference of the
#: model (the JAX package's too) that chaotic rows amplify
CHUNK_PARITY_STEPS = (1, 12)


def bench_ics(B, seed, dev):
    """bench.py's population: (mass, pos, vel) of B perturbed copies of
    the 3-body system, drawn on the card from ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    dq = 0.01 * torch.randn((B, 3, 2), generator=gen, device=dev)
    dv = 0.01 * torch.randn((B, 3, 2), generator=gen, device=dev)
    return (f(BENCH_M).expand(B, 3).contiguous(), f(BENCH_Q)[None] + dq,
            f(BENCH_V)[None] + dv)


def composition_ops(n, d, stages):
    """Operations of one composition step, counted off the loops of
    csrc/composition.cu, an FMA as two: per stage a drift and a kick
    (N d FMAs each) and 7 d + 5 per pair, less one for each body
    coordinate, whose sum starts from its first pair term (a multiply)."""
    P = n * (n - 1) // 2
    return stages * (4 * n * d + P * (7 * d + 5) - n * d)


def ops_bound(ops, words):
    """(bound_ms, bound_by) of ``ops`` FP32 operations and ``words``
    4-byte words moved."""
    t_ops, t_bytes = ops / PEAK_FP32, 4 * words / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bound_composition(B, n, d, steps, stages):
    """The steps, the opening acceleration and the two half-kicks (one
    Verlet stage's operations), and G times the masses."""
    return ops_bound(B * (steps * composition_ops(n, d, stages)
                          + composition_ops(n, d, 1) + n),
                     B * (4 * n * d + n + 1))


def bound_multistep(n_sub, nsm, steps, n, d, share=None):
    ns = np.minimum(np.maximum(n_sub, 1), nsm).astype(np.float64)
    B = len(ns)
    extra = 0.0 if share is None else ref_ops(n, d, share)
    return ops_bound(ns.sum() * steps * (trip_ops(n, d) + extra)
                     + B * (entry_ops(n, d) + extra),
                     B * (4 * n * d + n + 13))


def bound_eps(B, n, d, share=None):
    extra = 0.0 if share is None else ref_ops(n, d, share)
    return ops_bound(B * (entry_ops(n, d) + 6 + extra),
                     B * (2 * n * d + n + 5))


def row_gate(label, outs, max_widened=MAX_WIDENED, against="float64"):
    """Hold each kernel output to its plain version: ``outs`` maps a name
    to (kernel, plain, plain float64, plain on reordered slots, (rtol,
    atol)), tensors with the system axis first.  A row fails where the
    kernel lies outside rtol/atol plus SENS_FACTOR times the plain
    version's own rounding sensitivity (its distance to its float64 run
    and to its reordered run); rows that need the widening must be rows
    where the float32 plain version itself misses the tolerance against
    float64, but for at most ``max_widened``.  ``against`` names the
    run given as "plain float64" in the report.  Returns the largest
    |kernel - plain|."""
    B = next(iter(outs.values()))[0].shape[0]
    dev = next(iter(outs.values()))[0].device
    widened = torch.zeros(B, dtype=torch.bool, device=dev)
    f32_off = torch.zeros_like(widened)
    failures, worst, differ = [], 0.0, torch.zeros_like(widened)
    for name, (k, p, p64, pr, (rtol, atol)) in outs.items():
        k, p, p64, pr = (x.double().reshape(B, -1) for x in (k, p, p64, pr))
        fin = torch.isfinite(k) & torch.isfinite(p)
        zero = torch.zeros_like(p)
        err = torch.where(fin, (k - p).abs(), zero)
        base = atol + rtol * torch.where(fin, p.abs(), zero)
        sens = torch.maximum(torch.nan_to_num((p - p64).abs()),
                             torch.nan_to_num((p - pr).abs()))
        bad = ((err > base + SENS_FACTOR * sens)
               | (torch.isfinite(k) != torch.isfinite(p))).any(1)
        wide = (err > base).any(1) & ~bad
        off = (torch.nan_to_num((p - p64).abs()) > base).any(1)
        differ |= (err > 0).any(1)
        widened |= wide
        f32_off |= off
        e = float(err.max())
        worst = max(worst, e)
        print(f"    {label} {name:5s} max_abs {e:.3e} max_rel "
              f"{float((err / p.abs().clamp_min(1e-30)).max()):.3e} outside "
              f"{int(bad.sum())} rows, widened {int(wide.sum())}; float32 "
              f"plain outside the tolerance from {against} on "
              f"{int(off.sum())} rows")
        if bad.any():
            failures.append(name)
    other = int((widened & ~f32_off).sum())
    print(f"    {label}: {B} rows, {int(differ.sum())} differ at all, "
          f"{int(widened.sum())} needed the widening, {other} of them (at "
          f"most {max_widened}) outside the float32-sensitive rows")
    if other > max_widened:
        failures.append(f"{other} widened rows")
    if failures:
        raise SystemExit(f"{label}: kernel disagrees with its plain version "
                         f"on {failures}")
    return worst


def _runs(kernel, plain, make_args, reorder, unorder):
    """(kernel out, plain out, plain float64 out, plain reordered out,
    kernel ms, plain ms): the kernel once to warm up, then once between
    CUDA events; the plain version timed the same way, then in float64
    and on reordered body slots (``reorder`` maps args, ``unorder`` the
    outputs back)."""
    kernel(*make_args(torch.float32))
    tk, tp = Timed(kernel), Timed(plain)
    k_out = tk(*make_args(torch.float32))
    p_out = tp(*make_args(torch.float32))
    p64 = plain(*make_args(torch.float64))
    pr = unorder(plain(*reorder(make_args(torch.float32))))
    torch.cuda.synchronize()
    return k_out, p_out, p64, pr, tk.ms, tp.ms


def ring_ics(B, n, d, seed, dev):
    """(mass, pos, vel) of B systems of n bodies on a ring of radius 1.5
    in the x-y plane plus 0.01 noise, masses linspace(1, 0.1), velocities
    0.3 normal (the CPU tests' ring population), drawn on the card from
    ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ang = 2.0 * np.pi * torch.arange(n, device=dev) / n
    base = torch.zeros((n, d), device=dev)
    base[:, 0], base[:, 1] = 1.5 * torch.cos(ang), 1.5 * torch.sin(ang)
    q = base[None] + 0.01 * torch.randn((B, n, d), generator=gen, device=dev)
    v = 0.3 * torch.randn((B, n, d), generator=gen, device=dev)
    m = torch.linspace(1.0, 0.1, n, device=dev).expand(B, n).contiguous()
    return m, q, v


def compare_composition(scheme, B, dev, n=3, d=2):
    """The composition kernel against its plain version: bench.py's
    3-body systems at (n, d) = (3, 2), the ring population otherwise."""
    from nbodysimproject_tpu_torch.ops import batch_kernels as bk

    m, q, v = bench_ics(B, 7, dev) if (n, d) == (3, 2) \
        else ring_ics(B, n, d, 7, dev)
    eps2 = torch.full((B,), FUSED_EPS2, device=dev)
    steps = CMP_COMPOSITION_STEPS
    kw = dict(h=DT, G=1.0, n_steps=steps, scheme=scheme)
    rev = torch.arange(n - 1, -1, -1, device=dev)

    def make(dt_):
        return tuple(x.to(dt_) for x in (q, v, m, eps2))

    k, p, p64, pr, ms, pms = _runs(
        lambda *a: bk.composition_multistep(*a, **kw),
        lambda *a: bk.composition_multistep_plain(*a, **kw), make,
        lambda a: (a[0][:, rev], a[1][:, rev], a[2][:, rev], a[3]),
        lambda o: (o[0][:, rev], o[1][:, rev]))
    label = f"composition {scheme} N={n} d={d} (B={B}, {steps} steps)"
    err = row_gate(label, {x: (k[i], p[i], p64[i], pr[i], STATE_TOL)
                           for i, x in enumerate(("pos", "vel"))})
    stages = len(bk.SCHEME_STAGES[scheme])
    b_ms, b_by = bound_composition(B, n, d, steps, stages)
    print(f"  {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by}), largest |kernel - plain| {err:.3e}",
          flush=True)
    return dict(ms=ms, plain_ms=pms, err=err, bound=(b_ms, b_by))


def composition_shapes(dev):
    """The composition kernel at every (N, d) it takes, both schemes,
    against its plain version on the ring population (B_SHAPES systems,
    SHAPES_STEPS steps): every value within STATE_TOL, nothing widened,
    the same non-finite entries.  Returns the largest |kernel - plain|."""
    from nbodysimproject_tpu_torch.ops import batch_kernels as bk

    t0 = time.perf_counter()
    worst, rtol, atol = 0.0, *STATE_TOL
    for n, d in COMPOSITION_SHAPES:
        m, q, v = ring_ics(B_SHAPES, n, d, 11, dev)
        eps2 = torch.full((B_SHAPES,), FUSED_EPS2, device=dev)
        errs = []
        for scheme in bk.SCHEME_STAGES:
            kw = dict(h=DT, G=1.0, n_steps=SHAPES_STEPS, scheme=scheme)
            got = bk.composition_multistep(q, v, m, eps2, **kw)
            ref = bk.composition_multistep_plain(q, v, m, eps2, **kw)
            for a, b in zip(got, ref):
                if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
                    raise SystemExit(f"composition N={n} d={d} {scheme}: "
                                     f"non-finite entries differ")
                e = torch.nan_to_num((a - b).abs())
                if bool((e > atol + rtol * torch.nan_to_num(b.abs())).any()):
                    raise SystemExit(f"composition N={n} d={d} {scheme}: "
                                     f"kernel outside STATE_TOL of its "
                                     f"plain version ({float(e.max()):.3e})")
                errs.append(float(e.max()))
        worst = max(worst, *errs)
        print(f"    N={n} d={d}: largest |kernel - plain| {max(errs):.3e}")
    torch.cuda.synchronize()
    print(f"    {len(COMPOSITION_SHAPES)} shapes in "
          f"{time.perf_counter() - t0:.1f}s")
    return worst


def hamsoft_bench_batch(cfg, dev):
    """bench.py's ham_soft population: built with softening 5e-2, n_sub
    capped at HS_NSUB_CAP; returns (states, dyns, kernel kwargs)."""
    from nbodysimproject_tpu_torch.parallel.batch_engine import build_batch

    m, q, v = bench_ics(B_HS, 11, dev)
    mask = torch.ones(m.shape, dtype=torch.bool, device=dev)
    st, dy = build_batch(m, q, v, mask, cfg, 1.0, 5e-2, 0.0, DT)
    dy = dy.replace(n_sub=torch.clamp_max(dy.n_sub, HS_NSUB_CAP))
    return st, dy


def multistep_kw(cfg, dy, steps, policy, grad_mode="exact"):
    n_sub = torch.clamp_min(dy.n_sub, 1)
    return dict(k_soft=dy.k_soft, mu=dy.mu_soft, alpha=dy.alpha_run,
                eps_min=dy.min_softening, eps_max=dy.max_softening,
                h=DT / n_sub.to(torch.float32), n_sub=n_sub,
                n_sub_max=int(n_sub.max()), n_steps=steps, G=1.0,
                k_wall=float(cfg.k_wall), eta=float(cfg.eta),
                jcap=float(cfg.j_max_cap), bexp=int(cfg.barrier_exponent),
                policy=policy, grad_mode=grad_mode,
                lam_align=float(cfg.lambda_softening))


def compare_multistep(cfg, st, dy, policy, hk, grad_mode="exact",
                      steps=CMP_MULTISTEP_STEPS):
    """The multi-step kernel against its plain version (``row_gate``) on
    (st, dy) under ``policy`` and ``grad_mode``; under the "reference"
    gradient the bound counts the fallback's firings in the timed plain
    run (``PlainTrace``)."""
    kw = multistep_kw(cfg, dy, steps, policy, grad_mode)
    n, d = st.pos.shape[1:]
    rev = torch.arange(n - 1, -1, -1, device=st.pos.device)
    ref = grad_mode == "reference"
    fc, counted = PlainTrace(hk, count=ref), []

    def plain(a, per):
        """the plain version; its first (timed) call counted"""
        if counted:
            return hk.hamsoft_multistep_plain(*a, **per)
        counted.append(True)
        with fc:
            return hk.hamsoft_multistep_plain(*a, **per)

    def make(dt_):
        per = {k: (v.to(dt_) if torch.is_floating_point(v) else v)
               if torch.is_tensor(v) else v for k, v in kw.items()}
        return (tuple(x.to(dt_) for x in (st.pos, st.vel, st.mass, st.eps,
                                          st.pi)), per)

    k, p, p64, pr, ms, pms = _runs(
        lambda a, per: hk.hamsoft_multistep(*a, **per),
        plain, lambda dt_: make(dt_),
        lambda ap: ((ap[0][0][:, rev], ap[0][1][:, rev], ap[0][2][:, rev],
                     ap[0][3], ap[0][4]), ap[1]),
        lambda o: (o[0][:, rev], o[1][:, rev], o[2], o[3]))
    label = f"multistep {policy}" + (
        f" {grad_mode}" if grad_mode != "exact" else "") + (
        f" N={n} d={d}" if (n, d) != (3, 2) else "")
    err = row_gate(f"{label} (B={st.pos.shape[0]}, {steps} steps)",
                   {x: (k[i], p[i], p64[i], pr[i], STATE_TOL)
                    for i, x in enumerate(("pos", "vel", "eps", "pi"))})
    share = fc.share if ref else None
    b_ms, b_by = bound_multistep(dy.n_sub.cpu().numpy(), kw["n_sub_max"],
                                 steps, n, d, share)
    print(f"  {label}: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}"
          + (f"; the fallback replaced {share:.4f} of the plain run's eps* "
             f"evaluations" if ref else "") + ")", flush=True)
    return dict(ms=ms, plain_ms=pms, err=err, bound=(b_ms, b_by),
                share=share)


def compare_eps(label, st, dy, clamp, ek, use_fallback=False,
                lam=LAMBDA_SOFTENING):
    """The eps kernel against its plain version (``row_gate``); with
    ``use_fallback`` also the systems whose branch the kernel takes
    otherwise than the plain version, allowed only where the float64
    plain run puts gmax at the threshold (``fallback_lanes``)."""
    n = st.pos.shape[1]
    rev = torch.arange(n - 1, -1, -1, device=st.pos.device)
    kw = dict(clamp=clamp, use_fallback=use_fallback, lam_align=lam)

    def make(dt_):
        return (st.pos.to(dt_), st.mass.to(dt_), st.eps.to(dt_),
                dy.alpha_run.to(dt_), dy.min_softening.to(dt_),
                dy.max_softening.to(dt_), st.mask)

    k, p, p64, pr, ms, pms = _runs(
        lambda *a: ek.eps_star_and_grad_fused(*a, **kw),
        lambda *a: ek.eps_star_and_grad_fused_plain(*a, **kw), make,
        lambda a: (a[0][:, rev], a[1][:, rev]) + a[2:6] + (a[6][:, rev],),
        lambda o: (o[0], o[1][:, rev]))
    tag = f"eps {label} clamp={clamp}" + (" fallback" if use_fallback
                                          else "")
    share = None
    if use_fallback:
        taken, near = fallback_lanes(st, dy, clamp, ek=True)
        # the branch the kernel took: the plain version's fallback output
        # against its exact one, whichever the kernel lies nearer to
        gx = ek.eps_star_and_grad_fused_plain(*make(torch.float32),
                                              clamp=clamp,
                                              use_fallback=False)[1]
        dist = lambda g: (k[1] - g).abs().amax((1, 2))
        k_taken = (dist(p[1]) <= dist(gx)) & ((p[1] - gx).abs().amax((1, 2))
                                              > 0)
        p_taken = (p[1] - gx).abs().amax((1, 2)) > 0
        other = k_taken != p_taken
        share = float(taken.float().mean())
        print(f"    {tag}: the fallback takes {int(taken.sum())} of "
              f"{len(taken)} systems ({share:.4f}; {int(p_taken.sum())} "
              f"change their gradient); {int(near.sum())} systems at the "
              f"threshold in the float64 plain run; the kernel takes the "
              f"other branch on {int(other.sum())} systems, "
              f"{int((other & ~near).sum())} of them away from the threshold")
        if (other & ~near).any():
            raise SystemExit(f"{tag}: the kernel takes the other branch "
                             f"away from the threshold")
    err = row_gate(f"{tag} (B={st.pos.shape[0]}, N={n})",
                   {"es": (k[0], p[0], p64[0], pr[0], EPS_TOL["es"]),
                    "grad": (k[1], p[1], p64[1], pr[1], EPS_TOL["grad"])})
    b_ms, b_by = bound_eps(st.pos.shape[0], n, st.pos.shape[2], share)
    nonzero = int((p[1].abs().amax((1, 2)) > 0).sum())
    print(f"  {tag}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}); nonzero gradient on {nonzero} rows",
          flush=True)
    return dict(ms=ms, plain_ms=pms, err=err, bound=(b_ms, b_by),
                share=share, nonzero=nonzero)


def eps_layouts_agree(states, dyns, ek, use_fallback=False):
    """The eps kernel's two layouts on the same systems: the dataset's
    3-body rows in 3 slots (one thread per system) and in their 8 slots
    (one lane per body; slots 3-7 masked) give eps* and gradients equal
    in every bit under both clamps (and ``use_fallback``), and a zero
    gradient in the masked slots (gated)."""
    three = (states.mask[:, :3].all(1)
             & ~states.mask[:, 3:].any(1)).nonzero()[:, 0]
    args8 = (states.pos[three], states.mass[three], states.eps[three],
             dyns.alpha_run[three], dyns.min_softening[three],
             dyns.max_softening[three], states.mask[three])
    args3 = tuple(x[:, :3].contiguous() if x.dim() >= 2 else x
                  for x in args8)
    kw = dict(use_fallback=use_fallback, lam_align=LAMBDA_SOFTENING)
    for clamp in (True, False):
        e3, g3 = ek.eps_star_and_grad_fused(*args3, clamp=clamp, **kw)
        e8, g8 = ek.eps_star_and_grad_fused(*args8, clamp=clamp, **kw)
        bits = sum(int((a.contiguous().view(torch.int32)
                        != b.contiguous().view(torch.int32)).sum())
                   for a, b in ((e3, e8), (g3, g8[:, :3])))
        pad = bool((g8[:, 3:] == 0).all())
        print(f"  eps layouts, {len(three)} 3-body rows, clamp={clamp}"
              f"{', fallback' if use_fallback else ''}: "
              f"N = 3 against N = 8: {bits} entries differ in their bits, "
              f"masked slots zero {pad}; nonzero gradient on "
              f"{int((g3.abs().amax((1, 2)) > 0).sum())} rows", flush=True)
        if bits or not pad:
            raise SystemExit("eps kernel: the N = 3 and N = 8 layouts "
                             "disagree on 3-body rows")


#: wrapper calls traced back to back, and single wrapper calls whose
#: median is taken
EPS_ALONE_REPS, EPS_CALL_REPS = 50, 20
#: traces of the EPS_ALONE_REPS calls allowed when one comes back with
#: fewer device events than calls and nothing else (the profiler lost a
#: record: 49 of 50 in one of PR 12's runs); a trace with more events or
#: another kernel fails at once, and so does a call that launches nothing
#: (every trace short)
EPS_TRACES = 3


def eps_alone(ek, cases):
    """The eps kernel alone on each case ({label: wrapper args}) under
    both clamps, on contiguous copies of the args made beforehand (the
    wrapper copies a strided q, m or mask, as the dataset population's
    body-major tensors are): EPS_ALONE_REPS wrapper calls back to back,
    traced by torch.profiler, whose device work must be exactly one
    launch of the kernel a call and nothing else (gated); the time a
    launch is the trace's mean kernel duration, the device's own however
    long the host takes between calls.  Then the median of EPS_CALL_REPS
    single wrapper calls, each between CUDA events (host work included).
    Returns {(label, clamp): (ms alone, ms a call, bound)}."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, args in cases.items():
        args = tuple(x.contiguous() for x in args)
        B, n, d = args[0].shape
        for clamp in (True, False):
            ek.eps_star_and_grad_fused(*args, clamp=clamp,
                                       use_fallback=False)
            torch.cuda.synchronize()
            for trace in range(EPS_TRACES):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(EPS_ALONE_REPS):
                        ek.eps_star_and_grad_fused(*args, clamp=clamp,
                                                   use_fallback=False)
                    torch.cuda.synchronize()
                dev_events = [e for e in prof.events()
                              if e.device_type.name == "CUDA"]
                names = {e.name[:60] for e in dev_events}
                print(f"  eps wrapper, {label}, clamp={clamp}: "
                      f"{EPS_ALONE_REPS} calls, {len(dev_events)} device "
                      f"events: {sorted(names)}", flush=True)
                if len(dev_events) > EPS_ALONE_REPS or not all(
                        "eps_grad" in e.name for e in dev_events):
                    raise SystemExit("eps wrapper: a call must launch its "
                                     "kernel and nothing else on the device")
                if len(dev_events) == EPS_ALONE_REPS:
                    break
            else:
                raise SystemExit(f"eps wrapper: fewer device events than "
                                 f"calls in {EPS_TRACES} traces")
            alone = 1e-3 * float(np.mean(
                [e.time_range.elapsed_us() for e in dev_events]))
            calls = []
            for _ in range(EPS_CALL_REPS):
                torch.cuda.synchronize()
                t = Timed(lambda: ek.eps_star_and_grad_fused(
                    *args, clamp=clamp, use_fallback=False))
                t()
                calls.append(t.ms)
            call = float(np.median(calls))
            b = bound_eps(B, n, d)
            out[(label, clamp)] = (alone, call, b)
            print(f"  eps alone, {label} (B={B}, N={n}), clamp={clamp}: "
                  f"{alone:.4f} ms a launch (device time, mean of "
                  f"{EPS_ALONE_REPS} back to back), {call:.4f} ms a wrapper "
                  f"call (median of {EPS_CALL_REPS}), bound {b[0]:.4f} ms "
                  f"({b[1]})", flush=True)
    return out


#: bench.py's WHFast legs (bench.py:342-411): a unit central mass and two
#: 1e-3 planets (Jacobi order), 1% Gaussian perturbations; the scan at
#: B = 16384 x WH_SCAN_STEPS (softening 1e-3, the adaptive Kepler solver),
#: the fused kernel at B = 2^22 x 100 steps (eps^2 = 1e-6, 8
#: Laguerre-Conway updates)
WH_M = (1.0, 1e-3, 1e-3)
WH_Q = ((0.0, 0.0), (1.0, 0.0), (0.0, 2.0))
WH_V = ((0.0, 0.0), (0.0, 1.0), (-0.5 ** 0.5, 0.0))
B_WH_FUSED, WH_FUSED_STEPS, WH_ITERS = 1 << 22, 100, 8
#: kernel-vs-plain horizon of the WHFast kernel at full width, and the
#: kernel against one substep of the port's LC-8 scan: (rtol, atol) of
#: the JAX package's own kernel-vs-scan test (tests/test_pallas_whfast.py,
#: 1e-5 / 1e-7): the kernel's reciprocal masses, exp-based cosh/sinh and
#: rsqrt round apart from the scan's divisions, cosh/sinh and sqrt
CMP_WH_STEPS = 5
WH_SCAN_TOL = (1e-5, 1e-7)


def whfast_ics(B, seed, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    dq = 0.01 * torch.randn((B, 3, 2), generator=gen, device=dev)
    dv = 0.01 * torch.randn((B, 3, 2), generator=gen, device=dev)
    return (f(WH_M).expand(B, 3).contiguous(), f(WH_Q)[None] + dq,
            f(WH_V)[None] + dv)


def whfast_ops(n, d, iters, shares=(0.0, 0.0, 0.0)):
    """(drift, kick) operations of the WHFast kernel per system, counted
    off the loops of csrc/whfast.cu: each add, multiply, divide, fabsf,
    sqrtf, rsqrtf, expf, logf, cos and sin counts one and an FMA two (the
    transcendentals cost many instructions each on the card; compares and
    selects are not counted).  The kernel branches, so the count follows
    the data: ``shares`` = (the fractions of Stumpff evaluations with
    z > 0.3 and with z < -0.3, the fraction of Kepler solves on a
    hyperbolic orbit), as kepler_shares measures them on this run's
    population.  A Stumpff evaluation is 21 in the series window (fabsf
    and 10 FMAs), 9 in the closed form for z > 0.3 (a square root, cos,
    sin, three divisions) and 13 for z < -0.3; a Kepler solve is
    3 (2 d - 1) + 14 before the updates (17 more for the hyperbolic
    seed), 35 per update and 16 + 8 d after, besides its iters + 1
    Stumpff evaluations; a drift N - 1 solves and the Jacobi,
    centre-of-mass and reconstruction sums; a kick the pair loop, the
    Jacobi back-reaction and the velocity update."""
    pos, neg, hyp = shares
    P = n * (n - 1) // 2
    stumpff = (1.0 - pos - neg) * 21 + pos * 9 + neg * 13
    solve = (3 * (2 * d - 1) + 14 + 17 * hyp + iters * (35 + stumpff)
             + 16 + 8 * d + stumpff)
    to_jacobi = d + 2 * d * (n - 1) + 2 * d * max(n - 2, 0)
    drift = (2 * to_jacobi + 2 * (2 * d * (2 * n - 1)) + 8 * d
             + 2 * (n * d + (n - 1) * (1 + 2 * d)) + 2 * n * d
             + (n - 1) * solve)
    kick = (P * (7 * d + 7) + to_jacobi + (n - 1) * (3 * d + 5)
            + n * (1 + 4 * d) + 2 * n * d)
    return drift, kick


def bound_whfast(B, n, d, steps, iters, shares):
    drift, kick = whfast_ops(n, d, iters, shares)
    return ops_bound(B * ((steps + 1) * drift + steps * kick + 3 * n - 1),
                     B * (4 * n * d + n + 1))


def kepler_shares(wk, q, v, m, eps2, kw, rows=1 << 16):
    """(z > 0.3, z < -0.3, hyperbolic) shares of the whfast_ops work model:
    the fractions of Stumpff evaluations that take each closed form and of
    Kepler solves that take the hyperbolic seed, tallied by the plain
    version's run of the first ``rows`` systems of the population (the
    kernel branches on the same quantities, rounded its own way)."""
    t = {}
    wk.whfast_multistep_plain(q[:rows], v[:rows], m[:rows], eps2[:rows],
                              tally=t, **kw)
    c = {k: float(x) for k, x in t.items()}
    shares = (c["z_pos"] / c["z"], c["z_neg"] / c["z"],
              c["hyp"] / c["solves"])
    print(f"    closed-form Stumpff evaluations (first {rows} systems): "
          f"z > 0.3 {int(c['z_pos'])}, z < -0.3 {int(c['z_neg'])} of "
          f"{int(c['z'])} = {shares[0] + shares[1]:.3e}; hyperbolic seeds "
          f"{int(c['hyp'])} of {int(c['solves'])} solves", flush=True)
    return shares


def compare_whfast(dev, wk):
    """The WHFast kernel against its plain version at B = 2^22 (row_gate;
    the sensitivity is the plain version's float64 run alone: reordering
    the bodies would change the Jacobi hierarchy, not only the rounding),
    and one kernel step against one substep of the port's LC-8 scan."""
    from nbodysimproject_tpu_torch import SimConfig
    from nbodysimproject_tpu_torch.parallel.batch_engine import (
        build_batch, integrate_batch)

    B, steps = B_WH_FUSED, CMP_WH_STEPS
    m, q, v = whfast_ics(B, 23, dev)
    eps2 = torch.full((B,), FUSED_EPS2, device=dev)
    kw = dict(h=DT, G=1.0, n_steps=steps, iters=WH_ITERS)

    def make(dt_):
        return tuple(x.to(dt_) for x in (q, v, m, eps2))

    k, p, p64, pr, ms, pms = _runs(
        lambda *a: wk.whfast_multistep(*a, **kw),
        lambda *a: wk.whfast_multistep_plain(*a, **kw), make,
        lambda a: a, lambda o: o)
    err = row_gate(f"whfast (B={B}, {steps} steps)",
                   {n: (k[i], p[i], p64[i], pr[i], STATE_TOL)
                    for i, n in enumerate(("pos", "vel"))})
    shares = kepler_shares(wk, q, v, m, eps2, kw)
    b_ms, b_by = bound_whfast(B, 3, 2, steps, WH_ITERS, shares)
    print(f"  whfast: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    # one step of the kernel against one D(h/2) K(h) D(h/2) substep of
    # the scan on the same Laguerre-Conway depth
    cfg = SimConfig(integrator_mode="whfast", fast_float32=True,
                    whfast_kepler_iters=WH_ITERS)
    mask = torch.ones(m.shape, dtype=torch.bool, device=dev)
    out, start = {}, {}
    for dt_ in (torch.float32, torch.float64):
        st, dy = build_batch(m.to(dt_), q.to(dt_), v.to(dt_), mask, cfg,
                             1.0, FUSED_EPS2 ** 0.5, 0.0, DT,
                             skip_cm_recenter=True)
        dy = dy.replace(n_sub=torch.ones_like(dy.n_sub))
        start[dt_] = st
        out[dt_] = integrate_batch(st, dy, cfg, DT, 1, 1)
    st = start[torch.float32]
    k1 = wk.whfast_multistep(st.pos, st.vel, st.mass, st.step_s2, h=DT,
                             G=1.0, n_steps=1, iters=WH_ITERS)
    s32, s64 = out[torch.float32], out[torch.float64]
    err1 = row_gate(f"whfast kernel vs LC-8 scan (B={B}, 1 step)",
                    {n: (k1[i], getattr(s32, n), getattr(s64, n),
                         getattr(s32, n), WH_SCAN_TOL)
                     for i, n in enumerate(("pos", "vel"))})
    return dict(ms=ms, plain_ms=pms, err=err, scan_err=err1,
                bound=(b_ms, b_by))


def nonfinite(pos):
    """Systems whose final positions are not all finite."""
    return int((~torch.isfinite(pos)).reshape(pos.shape[0], -1).any(1).sum())


def reset_counts(*fns):
    for fn in fns:
        fn.launches = 0


def drift_sys0(cfg, dy0, before, after):
    """bench.py's health check: system 0's relative drift of the extended
    Hamiltonian between two states of it."""
    from nbodysimproject_tpu_torch.diagnostics.energy import \
        extended_hamiltonian

    H0 = float(extended_hamiltonian(before, dy0, cfg)[0])
    H1 = float(extended_hamiltonian(after, dy0, cfg)[0])
    return abs((H1 - H0) / H0) if H0 != 0 else float("nan")


def run_leg(name, fn, B, steps, counted, reps=LEG_WARM_REPS):
    """One cold and ``reps`` warm runs of ``fn`` between CUDA events;
    the launch counts of ``counted`` are set to 0 before the cold run
    and read after it.  Returns (last output, cold ms, warm median ms,
    launches)."""
    reset_counts(*counted)
    cold = Timed(fn)
    out = cold()
    launches = {f.__name__: f.launches for f in counted}
    warm = []
    for _ in range(reps):
        t = Timed(fn)
        out = t()
        warm.append(t.ms)
    med = float(np.median(warm))
    print(f"  {name}: B={B}, {steps} steps, cold {cold.ms:.1f} ms, warm "
          f"median {med:.3f} ms ({', '.join(f'{w:.3f}' for w in warm)}): "
          f"{B * steps / (med / 1e3):.4e} system-steps/s; launches in the "
          f"cold run {launches}", flush=True)
    return out, cold.ms, med, launches


def slice_legs(dev, hk, ek, bk, wk, sass):
    """bench.py's legs at full width through the port's entry points;
    ``sass`` is ``sass_step_counts`` of the composition kernel at N = 3.
    Returns {leg: (cold ms, warm ms, launches, drift)}."""
    from nbodysimproject_tpu_torch import SimConfig
    from nbodysimproject_tpu_torch.parallel.batch_engine import (
        build_batch, integrate_batch)

    kernels = (hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep,
               hk.hamsoft_multistep, ek.eps_star_and_grad_fused,
               bk.composition_multistep, wk.whfast_multistep)
    legs = {}
    m, q, v = bench_ics(B_SCAN, 0, dev)
    mask = torch.ones(m.shape, dtype=torch.bool, device=dev)
    for mode in ("verlet", "yoshida4"):
        cfg = SimConfig(integrator_mode=mode)
        st, dy = build_batch(m, q, v, mask, cfg, 1.0, 1e-3, 0.0, DT)
        nsm = int(dy.n_sub.max())
        out, cold, med, la = run_leg(
            f"{mode} scan (integrate_batch, n_sub_max {nsm})",
            lambda: integrate_batch(st, dy, cfg, DT, SCAN_STEPS, nsm),
            B_SCAN, SCAN_STEPS, kernels)
        dr = drift_sys0(cfg, dy.take(slice(0, 1)), st.take(slice(0, 1)),
                        out.take(slice(0, 1)))
        print(f"    drift(sys0) {dr:.3e}; non-finite systems "
              f"{nonfinite(out.pos)}")
        legs[f"{mode} scan"] = (cold, med, la, dr)
        if mode == "verlet":
            st_v, dy_v, cfg_v = st, dy, cfg
    for scheme, B in (("verlet", B_VERLET_FUSED), ("yoshida4", B_Y4_FUSED)):
        mf, qf, vf = bench_ics(B, 7 if scheme == "verlet" else 17, dev)
        eps2 = torch.full((B,), FUSED_EPS2, device=dev)
        fn = bk.verlet_multistep if scheme == "verlet" \
            else bk.yoshida4_multistep
        (po, vo), cold, med, la = run_leg(
            f"{scheme} fused ({fn.__name__})",
            lambda: fn(qf, vf, mf, eps2, h=DT, G=1.0, n_steps=SCAN_STEPS),
            B, SCAN_STEPS, kernels)
        if la["composition_multistep"] == 0:
            raise SystemExit(f"{scheme} fused leg launched no kernel")
        s0 = st_v.take(slice(0, 1)).replace(
            pos=qf[:1], vel=vf[:1], eps=torch.sqrt(eps2[:1]),
            step_s2=eps2[:1])
        dr = drift_sys0(cfg_v, dy_v.take(slice(0, 1)), s0,
                        s0.replace(pos=po[:1], vel=vo[:1]))
        stages = len(bk.SCHEME_STAGES[scheme])
        b_ms, b_by = bound_composition(B, 3, 2, SCAN_STEPS, stages)
        print(f"    drift(sys0) {dr:.3e}; non-finite systems {nonfinite(po)}; "
              f"bound {b_ms:.3f} ms ({b_by}), {med / b_ms:.2f}x the bound")
        counts = None if sass is None else sass.get(stages)
        if counts is None:
            print("    SASS instructions a step: not measured ("
                  + ("cuobjdump missing or failed)" if sass is None
                     else "no single step loop in the SASS)"))
        else:
            ins, mufu = counts
            floor = issue_floor_ms(B * SCAN_STEPS * ins)
            print(f"    SASS {ins} instructions a step ({mufu} MUFU): issue "
                  f"floor {floor:.3f} ms at the card's maximum SM clock, "
                  f"{med / floor:.2f}x the floor")
        legs[f"{scheme} fused"] = (cold, med, la, dr)
        del mf, qf, vf, eps2, po, vo
        torch.cuda.empty_cache()
    cfg_hs = SimConfig(integrator_mode="ham_soft", fast_float32=True)
    st, dy = hamsoft_bench_batch(cfg_hs, dev)
    print(f"  ham_soft batch: B={B_HS}, n_sub counts "
          f"{torch.bincount(dy.n_sub).tolist()} (capped at {HS_NSUB_CAP})")
    nsm = int(dy.n_sub.max())
    one = lambda x: x.take(slice(0, 1))
    for policy in ("soft", "reflection"):
        cfg = cfg_hs.replace(use_soft_barrier=(policy == "soft"))
        out, cold, med, la = run_leg(
            f"ham_soft scan {policy} (integrate_batch, n_sub_max {nsm})",
            lambda: integrate_batch(st, dy, cfg, DT, HS_STEPS, nsm),
            B_HS, HS_STEPS, kernels)
        if la["eps_star_and_grad_fused"] == 0:
            raise SystemExit(f"ham_soft scan {policy}: the eps kernel was "
                             f"not launched")
        dr = drift_sys0(cfg, one(dy), one(st), one(out))
        print(f"    drift(sys0) {dr:.3e}; non-finite systems "
              f"{nonfinite(out.pos)}")
        legs[f"ham_soft scan {policy}"] = (cold, med, la, dr)
        kw = multistep_kw(cfg, dy, HS_STEPS, policy)
        (po, vo, eo, pio), cold, med, la = run_leg(
            f"ham_soft fused {policy} (hamsoft_multistep)",
            lambda: hk.hamsoft_multistep(st.pos, st.vel, st.mass, st.eps,
                                         st.pi, **kw),
            B_HS, HS_STEPS, kernels)
        if la["hamsoft_multistep"] == 0:
            raise SystemExit(f"ham_soft fused {policy} launched no kernel")
        after = one(st).replace(pos=po[:1], vel=vo[:1], eps=eo[:1],
                                pi=pio[:1], s=eo[:1], step_s2=eo[:1] ** 2)
        dr = drift_sys0(cfg, one(dy), one(st), after)
        b_ms, b_by = bound_multistep(dy.n_sub.cpu().numpy(), nsm, HS_STEPS,
                                     3, 2)
        print(f"    drift(sys0) {dr:.3e}; non-finite systems {nonfinite(po)}; "
              f"bound {b_ms:.3f} ms ({b_by}), {med / b_ms:.2f}x the bound")
        legs[f"ham_soft fused {policy}"] = (cold, med, la, dr)
    del st, dy, out, po, vo, eo, pio
    torch.cuda.empty_cache()
    legs.update(whfast_legs(dev, kernels, wk))
    return legs


def whfast_legs(dev, kernels, wk):
    """bench.py's two WHFast legs: the scan (integrate_batch, adaptive
    Kepler solver) at B = 16384 x WH_SCAN_STEPS and the fused kernel at
    B = 2^22 x 100 steps."""
    from nbodysimproject_tpu_torch import SimConfig
    from nbodysimproject_tpu_torch.parallel.batch_engine import (
        build_batch, integrate_batch)

    legs = {}
    one = lambda x: x.take(slice(0, 1))
    m, q, v = whfast_ics(B_SCAN, 13, dev)
    mask = torch.ones(m.shape, dtype=torch.bool, device=dev)
    cfg = SimConfig(integrator_mode="whfast", fast_float32=True)
    st, dy = build_batch(m, q, v, mask, cfg, 1.0, 1e-3, 0.0, DT)
    nsm = int(dy.n_sub.max())
    out, cold, med, la = run_leg(
        f"whfast scan (integrate_batch, adaptive Kepler solver, n_sub "
        f"counts {torch.bincount(dy.n_sub).tolist()})",
        lambda: integrate_batch(st, dy, cfg, DT, WH_SCAN_STEPS, nsm),
        B_SCAN, WH_SCAN_STEPS, kernels)
    dr = drift_sys0(cfg, one(dy), one(st), one(out))
    print(f"    drift(sys0) {dr:.3e}; non-finite systems "
          f"{nonfinite(out.pos)}")
    legs["whfast scan"] = (cold, med, la, dr)

    B = B_WH_FUSED
    mf, qf, vf = whfast_ics(B, 19, dev)
    eps2 = torch.full((B,), FUSED_EPS2, device=dev)
    (po, vo), cold, med, la = run_leg(
        f"whfast fused (whfast_multistep, {WH_ITERS} Laguerre-Conway "
        f"updates)",
        lambda: wk.whfast_multistep(qf, vf, mf, eps2, h=DT, G=1.0,
                                    n_steps=WH_FUSED_STEPS, iters=WH_ITERS),
        B, WH_FUSED_STEPS, kernels)
    if la["whfast_multistep"] == 0:
        raise SystemExit("whfast fused leg launched no kernel")
    s0 = one(st).replace(pos=qf[:1], vel=vf[:1])
    dr = drift_sys0(cfg, one(dy), s0, s0.replace(pos=po[:1], vel=vo[:1]))
    shares = kepler_shares(wk, qf, vf, mf, eps2, dict(
        h=DT, G=1.0, n_steps=WH_FUSED_STEPS, iters=WH_ITERS))
    b_ms, b_by = bound_whfast(B, 3, 2, WH_FUSED_STEPS, WH_ITERS, shares)
    print(f"    drift(sys0) {dr:.3e}; non-finite systems {nonfinite(po)}; "
          f"bound {b_ms:.3f} ms ({b_by}), {med / b_ms:.2f}x the bound")
    legs["whfast fused"] = (cold, med, la, dr)
    return legs


#: the large-N slice at the widths of the JAX package's tools:
#: tools/bench_largen.py's single force evaluations and 50-step rollouts
#: (its ICs drawn again from numpy.random.default_rng(0) in its order,
#: its mesh sizes, r_cut of 6 cells) and tools/bench_whfast_largen.py's
#: many-planet WHFast (planetary_system(N, seed=1), LC-8, 20 timed
#: substeps, 100 for the energy drift: 200 until a slow host ran the
#: script for 1,185.2 s, cut for the time limit)
LN_NS = (10_000, 32_768, 100_000, 1_000_000)
LN_NG = {10_000: 256, 32_768: 384, 100_000: 640, 1_000_000: 3072}
LN_R_CUT = 6.0
LN_DENSE_MAX = 32_768
LN_ROLL_DT = 1e-4
LN_ROLL_NS, LN_ROLL_STEPS = (10_000, 100_000, 1_000_000), 50
#: rollouts cut in depth (PR 12) to keep the script inside its time limit
LN_ROLL_STEPS_AT = {1_000_000: 10}
#: P3M's relative force error against the direct force, (median, p99)
#: gates at about twice the JAX package's record (data/bench_largen.json:
#: at most 1.02e-3 and 8.6e-3)
P3M_ERR_GATE = (2e-3, 2e-2)
#: the tiled kernel against its plain version: each row's largest error
#: from the float64 plain version over the row's magnitude sum S_i (the
#: two float32 versions sum in different orders, so they are not held to
#: each other); the kernel's worst at most FORCE_ERR_FACTOR times the
#: float32 plain version's worst on the same rows, and at most
#: FORCE_ERR_MAX
FORCE_ERR_FACTOR, FORCE_ERR_MAX = 4.0, 1e-4
FORCE_SAMPLE_ROWS = 4096
CLASSICAL_N, CLASSICAL_STEPS = 4096, 100
WL_NS, WL_TIMED, WL_STEPS, WL_ITERS = (4096, 16384, 65536), 20, 100, 8
#: above this many bodies the tool builds the WHFast state directly
#: (build_batch's calibration is O(N^2) dense)
WL_BUILD_MAX = 16384
WL_DRIFT_MAX, WL_KICK_P99_MAX = 1e-5, 0.06


def pairwise_ops(d):
    """Operations of one valid pair in csrc/pairwise_force.cu's inner loop,
    an FMA counted as two: d subtractions, d FMAs for r^2 from eps^2,
    rsqrtf, three multiplies for m_j / r^3, d FMAs into the partial
    sums."""
    return 5 * d + 4


def bound_pairwise(B, n, d, tj=512):
    """The tiled kernel's bound for B unpadded systems of n bodies: every
    ordered pair i != j is valid, plus d subtractions per tile and 2 d
    multiplies per body; positions and masses read once, forces written
    once."""
    tiles = -(-n // tj)
    ops = B * (n * (n - 1) * pairwise_ops(d) + n * d * (tiles + 2))
    return ops_bound(ops, B * (2 * n * d + n + 2))


def largen_ics():
    """tools/bench_largen.py's initial conditions, drawn in its order from
    numpy.random.default_rng(0): {N: (q, m)} of the single evaluations
    and {N: (q, m, v)} of the rollouts, float32."""
    rng = np.random.default_rng(0)
    f32 = lambda a: np.asarray(a, np.float32)
    evals, rolls = {}, {}
    for N in LN_NS:
        q = f32(rng.normal(0, 1.0, (N, 2)))
        evals[N] = (q, f32(np.abs(rng.normal(1, 0.3, N))))
    for N in LN_ROLL_NS:
        q = f32(rng.normal(0, 1.0, (N, 2)))
        m = f32(np.abs(rng.normal(1, 0.3, N)) / N)
        rolls[N] = (q, m, f32(rng.normal(0, 0.3, (N, 2))))
    return evals, rolls


def span_eps(q, Ng):
    """The tool's softening: the float32 span of the positions over Ng."""
    return float(np.float32(float(q.max() - q.min()) / Ng))


def force_case(fk, label, q, m, eps, G, rows=None):
    """The tiled kernel against its plain version on (B, N, d) float32
    tensors: both in float32 on all rows, each row of ``rows`` (default:
    all) held to the float64 plain version under the FORCE_ERR gate, and
    the momentum |sum_i F_i| / sum_i |F_i| printed.  Returns the kernel's
    and the plain version's ms, the largest |kernel - plain| and the
    bound."""
    B, n, d = q.shape
    fk.pairwise_force(q, m, eps, G)
    tk, tp = Timed(fk.pairwise_force), Timed(fk.pairwise_force_plain)
    F = tk(q, m, eps, G)
    P = tp(q, m, eps, G)
    idx = torch.arange(n, device=q.device) if rows is None else rows
    args64 = [x.double() for x in (q, m, eps, G)]
    P64 = fk.pairwise_force_plain(*args64, rows=idx)
    S = fk.magnitude_sum(*args64, rows=idx)
    rel = lambda X: ((X[:, idx].double() - P64).abs().amax(-1) / S).max()
    ek, ep = float(rel(F)), float(rel(P))
    F64 = F.double()
    mom = float((F64.sum(1).norm(dim=-1) / F64.norm(dim=-1).sum(1)).max())
    err = float((F - P).abs().max())
    b_ms, b_by = bound_pairwise(B, n, d)
    print(f"  pairwise_force {label}: kernel {tk.ms:.3f} ms, plain "
          f"{tp.ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); rows held to "
          f"float64: {idx.numel()} of {n} x {B}, worst error / S_i kernel "
          f"{ek:.3e}, float32 plain {ep:.3e}; max |kernel - plain| "
          f"{err:.3e}; momentum |sum F| / sum |F| {mom:.3e}", flush=True)
    if not (ek <= FORCE_ERR_FACTOR * ep and ek <= FORCE_ERR_MAX):
        raise SystemExit(f"pairwise_force {label}: kernel error {ek:.3e} "
                         f"against float32 plain {ep:.3e}")
    return dict(ms=tk.ms, plain_ms=tp.ms, err=err, bound=(b_ms, b_by))


def compare_pairwise(fk, dev, evals):
    """The tiled kernel against its plain version: N = 4097 (not a tile
    multiple) and N = 1000 at d = 3, all rows; B = 4 systems with their
    own eps and G; bench_largen's N = 10^5 cloud on 4096 sampled rows."""
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    cases = {}
    for label, B, n, d in (("N=4097 d=2", 1, 4097, 2),
                           ("N=1000 d=3", 1, 1000, 3),
                           ("B=4 N=2048 d=2", 4, 2048, 2)):
        q = t(rng.normal(size=(B, n, d)) * 3)
        m = t(rng.uniform(0.1, 2.0, (B, n)))
        eps = t(rng.uniform(0.01, 0.1, B))
        G = t(rng.uniform(0.5, 2.0, B)) if B > 1 else t([1.0])
        cases[label] = force_case(fk, label, q, m, eps, G)
    N = 100_000
    q, m = evals[N]
    rows = torch.as_tensor(np.sort(np.random.default_rng(6).choice(
        N, FORCE_SAMPLE_ROWS, replace=False)), device=dev)
    cases["N=1e5"] = force_case(
        fk, f"N={N} d=2 (bench_largen's cloud)", t(q)[None], t(m)[None],
        t([span_eps(q, LN_NG[N])]), t([1.0]), rows=rows)
    return cases


#: back-to-back launches per kernel-alone timing of the tiled kernel
FORCE_ALONE_REPS = {4096: 500, 65537: 20, 100_000: 10, 1_000_000: 2}


def force_alone(fk, dev, evals):
    """The tiled kernel alone at the widths of its paths: the classical
    route's cloud (N = 4096, B = 1, eps 0.05), the 65536-planet system
    of the many-planet WHFast kick (N = 65537, eps 0) and bench_largen's
    10^5 and 10^6 clouds.  FORCE_ALONE_REPS launches of the library entry
    back to back between CUDA events, on buffers made beforehand and
    with the slices the wrapper takes, so the time is the device's and
    not the wrapper's host overhead (these launches do not count).
    Returns {N: (ms, slices, bound)}."""
    from nbodysimproject_tpu_torch.ops import cuda_build

    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    N = CLASSICAL_N
    cases = {N: (t(rng.normal(0, 1.0, (1, N, 2))),
                 t(np.abs(rng.normal(1, 0.3, (1, N))) / N), 0.05)}
    m, q, _v = planetary_system(WL_NS[-1], 1)
    cases[len(m)] = (t(q)[None], t(m)[None], 0.0)
    for N in (100_000, 1_000_000):
        q, m = evals[N]
        cases[N] = (t(q)[None], t(m)[None], span_eps(q, LN_NG[N]))
    out = {}
    for N, (q, m, e) in cases.items():
        B, n, d = q.shape
        eb, Gb = torch.full((B,), e, device=dev), torch.ones(B, device=dev)
        S = fk.source_slices(n, B, *fk._card_slots(q.device.index, d))
        F = torch.empty_like(q)
        part = F if S == 1 else torch.empty((S, B, n, d), device=dev)
        lib = fk._library(d)
        ptrs = cuda_build.pointers(q, m, eb, Gb, F, part)
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch = lambda: lib.hs_pairwise_force(*ptrs, B, n, S, stream)
        if launch() != 0:
            raise SystemExit(f"pairwise_force N={n}: launch failed")
        reps = FORCE_ALONE_REPS[n]
        tm = Timed(lambda: [launch() for _ in range(reps)])
        tm()
        ms = tm.ms / reps
        if not torch.equal(F, fk.pairwise_force(q, m, eb, Gb)):
            raise SystemExit(f"pairwise_force N={n}: the entry and the "
                             f"wrapper disagree")
        b = bound_pairwise(B, n, d)
        out[n] = (ms, S, b)
        print(f"  N={n}: {ms:.4f} ms a launch ({reps} launches, {S} source "
              f"slice(s)), bound {b[0]:.4f} ms ({b[1]}), {ms / b[0]:.2f}x",
              flush=True)
        del q, m, F, part
        torch.cuda.empty_cache()
    return out


def rel_err(F, ref):
    """Per-body |F - ref| / |ref| (the tool's P3M error)."""
    return ((F - ref).norm(dim=1)
            / ref.norm(dim=1).clamp_min(1e-30)).double().cpu().numpy()


def largen_evals(fk, pm, dev, evals):
    """bench_largen's single evaluations: P3M, the tiled kernel and, up to
    N = 32768, the dense eager force; P3M's error against the dense force
    (else the kernel), gated.  Returns {N: row}."""
    from nbodysimproject_tpu_torch.ops.forces import gravitational_force

    out = {}
    for N in LN_NS:
        q_np, m_np = evals[N]
        q, m = (torch.as_tensor(a, device=dev) for a in (q_np, m_np))
        Ng = LN_NG[N]
        eps = span_eps(q_np, Ng)
        p3m = lambda: pm.p3m_force(q, m, eps, 1.0, Ng=Ng,
                                   r_cut_cells=LN_R_CUT)
        p3m()
        tp = Timed(p3m)
        F_p3m, dropped = tp()
        # the short-range pass alone, on the mesh frame p3m_force takes
        lo, cell = pm._mesh_frame(q, Ng, None)
        n_rows = pm.pp_rows(Ng, LN_R_CUT)
        ts = Timed(pm._pp_short_range_banded)
        ts(q, m, torch.as_tensor(eps, device=dev),
           torch.ones((), device=dev), LN_R_CUT * cell, lo, n_rows, 256,
           pm.default_pp_window(N, n_rows))
        tk = Timed(fk.pairwise_force)
        F_k = tk(q, m, eps, 1.0)
        row = dict(p3m_ms=tp.ms, short_ms=ts.ms, kernel_ms=tk.ms,
                   n_dropped=int(dropped), bound=bound_pairwise(1, N, 2))
        ref = F_k
        if N <= LN_DENSE_MAX:
            torch.cuda.empty_cache()
            e1 = torch.ones(1, device=dev)
            dense = lambda: gravitational_force(q[None], m[None], eps * e1,
                                                e1)[0]
            td = Timed(dense)
            ref = td()
            row["dense_ms"] = td.ms
            kd = rel_err(F_k, ref)
            print(f"    kernel against the dense force: median "
                  f"{np.median(kd):.3e}, max {kd.max():.3e}")
            torch.cuda.empty_cache()
        rel = rel_err(F_p3m, ref)
        row["p3m_med"], row["p3m_p99"] = (float(np.median(rel)),
                                          float(np.percentile(rel, 99)))
        print(f"  N={N}: P3M {tp.ms:.3f} ms (Ng {Ng}, n_dropped "
              f"{row['n_dropped']}; its short-range pass alone "
              f"{ts.ms:.3f} ms, {ts.ms / tp.ms:.2f} of it), tiled kernel {tk.ms:.3f} ms (bound "
              f"{row['bound'][0]:.3f} ms, {row['bound'][1]}), dense "
              f"{row.get('dense_ms', float('nan')):.3f} ms; P3M error "
              f"against the {'dense force' if N <= LN_DENSE_MAX else 'kernel'}"
              f": median {row['p3m_med']:.3e}, p99 {row['p3m_p99']:.3e}",
              flush=True)
        if not (row["p3m_med"] <= P3M_ERR_GATE[0]
                and row["p3m_p99"] <= P3M_ERR_GATE[1]
                and row["n_dropped"] == 0):
            raise SystemExit(f"P3M at N={N} outside its gate: {row}")
        out[N] = row
        del q, m, F_p3m, F_k, ref
        torch.cuda.empty_cache()
    return out


def largen_rollouts(fk, dev, rolls):
    """bench_largen's rollouts through largen_rollout: p3m and
    direct_pallas at 10^4 and 10^5, p3m at 10^6; one cold and
    LEG_WARM_REPS warm runs between CUDA events, the kernel's launches
    counted around the cold run.  Returns {(mode, N): row}."""
    from nbodysimproject_tpu_torch import SimConfig, largen_rollout

    out = {}
    for N in LN_ROLL_NS:
        steps = LN_ROLL_STEPS_AT.get(N, LN_ROLL_STEPS)
        q, m, v = (torch.as_tensor(a, device=dev) for a in rolls[N])
        Ng = LN_NG[N]
        for mode in ("p3m", "direct_pallas"):
            if mode == "direct_pallas" and N >= 1_000_000:
                continue
            cfg = SimConfig(integrator_mode="verlet", force_mode=mode,
                            pm_grid=Ng, pm_r_cut_cells=LN_R_CUT)
            run = lambda: largen_rollout(q, v, m, 6.0 / Ng, 1.0, LN_ROLL_DT,
                                         steps, cfg)
            (qo, vo, info), cold, med, la = run_leg(
                f"largen_rollout {mode} N={N}", run, 1, steps,
                (fk.pairwise_force,))
            fin = bool(torch.isfinite(qo).all() and torch.isfinite(vo).all())
            dropped = int(info.n_dropped_max)
            launches = la["pairwise_force"]
            print(f"    {steps / (med / 1e3):.3f} steps/s; n_dropped_max "
                  f"{dropped}, finite {fin}, kinetic {float(info.kinetic):.6e}")
            if not fin or dropped != 0:
                raise SystemExit(f"rollout {mode} N={N}: finite {fin}, "
                                 f"n_dropped_max {dropped}")
            if mode == "direct_pallas" and launches == 0:
                raise SystemExit(f"rollout {mode} N={N} launched no kernel")
            out[(mode, N)] = dict(steps=steps, cold=cold, med=med,
                                  launches=launches)
        del q, m, v
        torch.cuda.empty_cache()
    return out


def classical_route(fk, dev):
    """verlet through build_batch -> integrate_batch with
    use_pallas_forces on one cloud of CLASSICAL_N bodies, against the same
    run on the dense force."""
    from nbodysimproject_tpu_torch import SimConfig
    from nbodysimproject_tpu_torch.parallel.batch_engine import (
        build_batch, integrate_batch)

    rng = np.random.default_rng(3)
    N = CLASSICAL_N
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    q = t(rng.normal(0, 1.0, (1, N, 2)))
    m = t(np.abs(rng.normal(1, 0.3, (1, N))) / N)
    v = t(rng.normal(0, 0.3, (1, N, 2)))
    mask = torch.ones((1, N), dtype=torch.bool, device=dev)
    runs = {}
    for pallas in (True, False):
        cfg = SimConfig(integrator_mode="verlet", use_pallas_forces=pallas)
        st, dy = build_batch(m, q, v, mask, cfg, 1.0, 0.05, 0.0, DT)
        nsm = int(dy.n_sub.max())
        reset_counts(fk.pairwise_force)
        tr = Timed(lambda: integrate_batch(st, dy, cfg, DT, CLASSICAL_STEPS,
                                           nsm))
        out = tr()
        runs[pallas] = (out, tr.ms, fk.pairwise_force.launches, nsm)
    (ok, k_ms, k_la, nsm), (od, d_ms, d_la, _) = runs[True], runs[False]
    scale = float((q - q.mean(1, keepdim=True)).norm(dim=-1).max())
    diff = float((ok.pos - od.pos).norm(dim=-1).max()) / scale
    print(f"  verlet N={N}, {CLASSICAL_STEPS} steps of {DT} (n_sub {nsm}): "
          f"tiled kernel {k_ms:.1f} ms ({k_la} launches), dense {d_ms:.1f} "
          f"ms ({d_la} launches); max position difference / cloud radius "
          f"{diff:.3e}", flush=True)
    if k_la == 0 or d_la != 0:
        raise SystemExit("classical route: use_pallas_forces did not (alone) "
                         "launch the kernel")
    if not bool(torch.isfinite(ok.pos).all()):
        raise SystemExit("classical route: non-finite state")
    return dict(kernel_ms=k_ms, dense_ms=d_ms, launches=k_la, diff=diff,
                n_sub=nsm)


def planetary_system(n_planets, seed):
    """tools/bench_whfast.py's generator: a unit central mass and
    n_planets 1e-4 planets on near-circular orbits ordered by radius."""
    rng = np.random.default_rng(seed)
    n = n_planets + 1
    m = np.full((n,), 1e-4)
    m[0] = 1.0
    a = np.linspace(1.0, 1.0 + 0.5 * n_planets, n - 1)
    th = rng.uniform(0, 2 * np.pi, n - 1)
    q = np.zeros((n, 2))
    v = np.zeros((n, 2))
    q[1:, 0] = a * np.cos(th)
    q[1:, 1] = a * np.sin(th)
    vc = 1.0 / np.sqrt(a)
    v[1:, 0] = -vc * np.sin(th)
    v[1:, 1] = vc * np.cos(th)
    return m, q, v


def energy64(st, chunk=1024):
    """The exact unsoftened energy of system 0 in float64 on the card, in
    row chunks (the tool's two_body_energy)."""
    m, q, v = (x[0].double() for x in (st.mass, st.pos, st.vel))
    ke = 0.5 * (m * (v * v).sum(-1)).sum()
    n = q.shape[0]
    jj = torch.arange(n, device=q.device)
    pe = torch.zeros((), dtype=torch.float64, device=q.device)
    for s0 in range(0, n, chunk):
        ii = jj[s0:s0 + chunk]
        diff = q[ii, None, :] - q[None, :, :]
        r = torch.sqrt((diff * diff).sum(-1))
        pe -= torch.where(jj[None, :] > ii[:, None],
                          m[ii, None] * m[None, :] / r,
                          torch.zeros_like(r)).sum()
    return float(ke + pe)


def whfast_state(m, q, v, cfg, dev):
    """The tool's WHFast state: build_batch up to WL_BUILD_MAX bodies,
    else the fixed-schedule state built directly."""
    from nbodysimproject_tpu_torch.core.state import DynParams, SimState
    from nbodysimproject_tpu_torch.parallel.batch_engine import build_batch

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)[None],
                                  device=dev)
    mask = torch.ones((1, len(m)), dtype=torch.bool, device=dev)
    if len(m) <= WL_BUILD_MAX:
        return build_batch(t(m), t(q), t(v), mask, cfg, 1.0, 0.0, 0.0, DT)
    z = torch.zeros(1, device=dev)
    st = SimState(mass=t(m), pos=t(q), vel=t(v), mask=mask, eps=z, pi=z,
                  s=z, step_s2=z, softening_energy_delta=z, hist_count=z,
                  hist_sum=z, hist_sumsq=z)
    dy = DynParams(G=z + 1.0, s0=z, min_softening=z, max_softening=z,
                   softening_scale=z, k_soft=z, mu_soft=z, chi_eps=z,
                   k_wall=z, alpha_run=z, omega_spr0=z, h_sub_ref=z + DT,
                   n_sub=torch.ones(1, dtype=torch.int32, device=dev),
                   frozen_dt=z + DT)
    return st, dy


def whfast_many_planets(fk, dev):
    """bench_whfast_largen: the interaction kick on direct_pallas and on
    P3M with the star split, WL_TIMED substeps timed after as many cold,
    the energy drift over WL_STEPS substeps (float64 energy on the card),
    P3M's kick error against direct_pallas at the ICs.  Returns
    {N: row}."""
    from nbodysimproject_tpu_torch import SimConfig
    from nbodysimproject_tpu_torch.integrators.whfast import (
        wh_interaction_accel, whfast_substep)

    out = {}
    for N in WL_NS:
        m, q, v = planetary_system(N, 1)
        row, accs = {}, {}
        for name, kw in (("direct_pallas", dict(force_mode="direct_pallas",
                                                use_pallas_forces=True)),
                         ("p3m", dict(force_mode="p3m"))):
            cfg = SimConfig(integrator_mode="whfast", fast_float32=True,
                            whfast_kepler_iters=WL_ITERS, **kw)
            st, dy = whfast_state(m, q, v, cfg, dev)
            h = torch.full((1,), DT, device=dev)
            reset_counts(fk.pairwise_force)
            accs[name] = wh_interaction_accel(st, dy, cfg)[0].double()

            def run(s, k):
                for _ in range(k):
                    s = whfast_substep(s, dy, cfg, h)
                return s

            run(st, WL_TIMED)
            tr = Timed(run)
            s20 = tr(st, WL_TIMED)
            launches = fk.pairwise_force.launches
            E0 = energy64(st)
            s_end = run(st, WL_STEPS)
            drift = abs((energy64(s_end) - E0) / E0)
            fin = bool(torch.isfinite(s_end.pos).all()
                       and torch.isfinite(s20.pos).all())
            row[name] = dict(ms=tr.ms, steps_s=WL_TIMED / (tr.ms / 1e3),
                             drift=drift, launches=launches)
            print(f"  N={N} planets, {name}: {row[name]['steps_s']:.2f} "
                  f"steps/s ({tr.ms:.1f} ms per {WL_TIMED} substeps), "
                  f"drift over {WL_STEPS} substeps {drift:.3e}, finite "
                  f"{fin}, kernel launches {launches}", flush=True)
            if not fin or not drift < WL_DRIFT_MAX:
                raise SystemExit(f"WHFast N={N} {name}: finite {fin}, drift "
                                 f"{drift:.3e}")
            if name == "direct_pallas" and launches == 0:
                raise SystemExit(f"WHFast N={N}: the kick launched no kernel")
            del st, dy, s20, s_end
        ref, app = accs["direct_pallas"], accs["p3m"]
        scale = ref.norm(dim=1)
        scale = torch.maximum(scale, torch.quantile(scale, 0.01))
        rel = ((app - ref).norm(dim=1) / scale).cpu().numpy()
        row["kick"] = (float(np.percentile(rel, 50)),
                       float(np.percentile(rel, 99)), float(rel.max()))
        print(f"  N={N}: P3M kick error against direct_pallas p50 "
              f"{row['kick'][0]:.3e}, p99 {row['kick'][1]:.3e}, max "
              f"{row['kick'][2]:.3e}", flush=True)
        if not row["kick"][1] <= WL_KICK_P99_MAX:
            raise SystemExit(f"WHFast N={N}: P3M kick error p99 "
                             f"{row['kick'][1]:.3e}")
        out[N] = row
        torch.cuda.empty_cache()
    return out


def pd_isnan(x):
    """NaN test for a frame column of any dtype (False where not float)."""
    x = np.asarray(x)
    return np.isnan(x) if x.dtype.kind == "f" else np.zeros(x.shape, bool)


def _outside(a, x, rtol, atol):
    """Rows of ``x`` outside (rtol, atol) of ``a``, or finite where ``a``
    is not (and the reverse)."""
    both = np.isfinite(a) & np.isfinite(x)
    with np.errstate(invalid="ignore"):
        err = np.where(both, np.abs(x - a), 0.0)
    return (err > atol + rtol * np.abs(np.where(both, a, 0.0))) \
        | (np.isfinite(a) != np.isfinite(x))


def cols_outside(ref, got, rows):
    """Rows outside TOL in any column of TOL, over ``rows`` entries."""
    out = np.zeros(rows, bool)
    for col, (rtol, atol) in TOL.items():
        out |= _outside(ref[col], got[col], rtol, atol)
    return out


def chunked_parity_horizon(states, dyns, cfg, n_sub_max, engine,
                           horizons=CHUNK_PARITY_STEPS):
    """use_fused_metrics=False against True on every lane (core mode) at
    each horizon of ``horizons``: rows that differ at all and rows
    outside TOL, by n_sub.  At one step every row must lie within TOL and
    the final states must be bitwise equal."""
    B = states.pos.shape[0]
    ns = np.minimum(dyns.n_sub.cpu().numpy(), n_sub_max)
    groups = ((ns <= 2), (ns > 2) & (ns < 64), (ns >= 64))
    for steps in horizons:
        res, fin = {}, {}
        for flag in (True, False):
            r, st1 = engine(states, dyns,
                            cfg.replace(use_fused_metrics=flag), steps, DT,
                            "core", n_sub_max, 0)
            res[flag] = {k: v.cpu().numpy().astype(np.float64)
                         for k, v in r.items()}
            fin[flag] = torch.cat([x.reshape(B, -1) for x in (
                st1.pos, st1.vel, st1.eps, st1.pi)], 1)
        same = (fin[True] == fin[False]) | (torch.isnan(fin[True])
                                            & torch.isnan(fin[False]))
        differ = np.zeros(B, bool)
        for col in TOL:
            a, b = res[True][col], res[False][col]
            differ |= ~((a == b) | (np.isnan(a) & np.isnan(b)))
        outside = cols_outside(res[True], res[False], B)
        n_differ = int((~same.all(1)).sum())
        print(f"  {steps} step(s) on {B} lanes: final pos/vel/eps/pi differ "
              f"on {n_differ} rows; columns differ at all on "
              f"{int(differ.sum())} rows, {int(outside.sum())} outside TOL; "
              f"outside "
              f"TOL by n_sub <= 2 / 3-63 / >= 64: " + ", ".join(
                  f"{int((outside & g).sum())} of {int(g.sum())}"
                  for g in groups))
        if steps == 1 and outside.any():
            raise SystemExit("use_fused_metrics=False: one step disagrees "
                             "with the fused way")
        if steps == 1 and n_differ:
            raise SystemExit("use_fused_metrics=False: one step's final "
                             "states differ from the fused way's")


def chunked_full_horizon(df, df_c, df_rev, sane):
    """The full-horizon use_fused_metrics=False run (``df_c``) beside the
    main path's (``df``) and the reversed-slot run (``df_rev``, the
    population's rounding floor), on the rows whose energy is sane in
    the main run: printed, not gated."""
    differ = np.zeros(len(df), bool)
    outside = np.zeros(len(df), bool)
    floor = np.zeros(len(df), bool)
    for col, (rtol, atol) in TOL.items():
        a = df[col].to_numpy(float)
        b = df_c[col].to_numpy(float)
        o = _outside(a, b, rtol, atol) & sane
        f = _outside(a, df_rev[col].to_numpy(float), rtol, atol) & sane
        differ |= sane & ~((a == b) | (np.isnan(a) & np.isnan(b)))
        outside |= o
        floor |= f
    print(f"    {int(sane.sum())} sane rows: {int(differ.sum())} differ at "
          f"all, {int(outside.sum())} outside TOL, {int(floor.sum())} where "
          f"the reversed-slot run is outside TOL, "
          f"{int((outside & ~floor).sum())} outside TOL where the "
          f"reversed-slot run is not")
    print_agreement("the fused way (first) against use_fused_metrics=False "
                    "(second), all rows",
                    label_agreement(df, df_c, np.ones(len(df), bool)))

def tail_stats(states, dyns, cfg, n_sub_raw):
    """The tail's selection on the population: (sel, n_tail) and a
    printed summary (count, n_tail histogram, deepest fused lane)."""
    from nbodysimproject_tpu_torch.analysis.batch import (_n_sub_cap,
                                                          _tail_selection)

    sel, n_tail = _tail_selection(states, dyns, cfg, n_sub_raw, DT)
    capped = np.minimum(n_sub_raw, _n_sub_cap(cfg))
    fused_max = int(capped[~sel].max()) if (~sel).any() else 0
    hist = {int(k): int(c) for k, c in zip(*np.unique(n_tail[sel],
                                                       return_counts=True))}
    bodies = states.mask.sum(1).cpu().numpy()[sel]
    print(f"  tail: {int(sel.sum())} systems, n_tail histogram {hist}, "
          f"by body count {np.bincount(bodies, minlength=N_SLOTS + 1)}; "
          f"{int((capped[~sel] >= 256).sum())} fused lanes at the n_sub cap, "
          f"the deepest fused lane n_sub {fused_max}")
    return sel, n_tail


def check_output(df, what):
    """Shape, columns and finiteness of a frame of the main path."""
    assert len(df) == B_MAIN, len(df)
    missing = [c for c in list(TOL) + [f"initial_{k}" for k in (
        "total_energy", "virial_ratio", "softening_std")] if c not in df]
    if missing:
        raise SystemExit(f"{what}: missing columns {missing}")
    if not np.isfinite(df["is_stable"]).all():
        raise SystemExit(f"{what}: non-finite is_stable")
    sane = ~df["pathological_energy"].to_numpy(bool)
    cols = [c for c in TOL if c not in MEGNO_COLS] + [
        c for c in df.columns if c.startswith("initial_")]
    bad = {c: int((~np.isfinite(df.loc[sane, c].to_numpy(float))).sum())
           for c in cols}
    bad = {c: v for c, v in bad.items() if v}
    if bad:
        raise SystemExit(f"{what}: non-finite values on non-pathological "
                         f"rows: {bad}")
    megno_nf = ~np.isfinite(df[list(MEGNO_COLS)].to_numpy(float)).all(1)
    if (df.loc[megno_nf, "is_stable"] != 0.0).any():
        raise SystemExit(f"{what}: a row with non-finite MEGNO is labelled "
                         f"stable")
    print(f"  {what}: stable share {df['is_stable'].mean():.4f}; "
          f"pathological energy {int((~sane).sum())}; non-finite MEGNO on "
          f"{int((megno_nf & sane).sum())} non-pathological rows "
          f"(labelled unstable)")


# ------------------------------------ the generators and the serving path
BENCH_POP = os.path.join(HERE, "data", "bench_population_16384.npz")
MODEL_PREFIX = os.path.join(HERE, "data", "headline_pre_")
#: the bench population's horizon and the pipeline entry point's
#: n_steps (its clamp's least value), cut from bench.py's 1000 steps for
#: the time limit: their Kepler tail runs up to 7 trips a step, eagerly,
#: which took 99-187 s a 1000-step run on the card; the bench
#: population's cut from 250 to 125 steps with the fused engine's
#: branches, to 60 steps after a slow host's 1,214.5 s, and to 30 steps
#: to pay for the scan route's phase (22)
BENCH_STEPS = 30
ENTRY_STEPS = 500
#: the card's scores against the same port on the CPU, on the same frame
SERVE_MLP_TOL = 1e-5
SERVE_GBDT_TOL = 1e-15
#: |sum m q| and |sum m v| of each drawn system over sum m |q| / m |v|
COM_GATE = 1e-5
#: cohorts whose generator adds velocity noise after its COM projection
#: (the JAX package's hierarchical cohort): their momentum is reported
NOISY_COHORTS = ("hierarchical",)
SERVE_REPS = 3


def bench_population():
    """bench.py's population as the JAX package draws it
    (``diverse_population(PRNGKey(0), 16384, n_slots=8)``, float32, drawn
    on the CPU and committed): (mass, pos, vel, mask, softening) numpy
    arrays and the cohort tag of each row."""
    with np.load(BENCH_POP, allow_pickle=False) as z:
        arrays = [z[k] for k in ("mass", "pos", "vel", "mask", "softening")]
        types = z["cohorts"][z["types"]]
    return arrays, types


def per_cohort(types, reduce=np.median, **cols):
    """{cohort: {name: reduce(values)}} in cohort order of first
    appearance."""
    types = np.asarray(types)
    order = list(dict.fromkeys(types.tolist()))
    return {c: {k: float(reduce(np.asarray(v)[types == c]))
                for k, v in cols.items()} for c in order}


def check_drawn(pop, sizes, counts, dev):
    """The generators phase's gates on a drawn population."""
    mass, pos, vel, mask, soft, types = pop
    B = mass.shape[0]
    want = sum(([k] * v for k, v in sizes.items()), [])
    if list(types) != want:
        raise SystemExit("generators: the cohorts are not cohort_sizes' "
                         "sizes in cohort order")
    for x in (mass, pos, vel, soft):
        if x.device.type != dev.type or x.dtype != torch.float32:
            raise SystemExit(f"generators: a {x.dtype} tensor on {x.device}")
        if not bool(torch.isfinite(x).all()):
            raise SystemExit("generators: non-finite values")
    if mass.shape != (B, N_SLOTS) or pos.shape != (B, N_SLOTS, 2):
        raise SystemExit(f"generators: shapes {mass.shape} {pos.shape}")
    t = np.asarray(types)
    n = mask.sum(1).cpu().numpy()
    m = torch.where(mask, mass, torch.zeros_like(mass)).double()
    rel = {}
    for name, x in (("pos", pos), ("vel", vel)):
        x = x.double()
        num = (m[..., None] * x).sum(1).norm(dim=-1)
        den = (m * x.norm(dim=-1)).sum(1)
        rel[name] = (num / torch.clamp_min(den, 1e-300)).cpu().numpy()
    for c, (lo, hi) in counts.items():
        sel = t == c
        if n[sel].min() < lo or n[sel].max() > hi:
            raise SystemExit(f"generators: {c} body counts {n[sel].min()}-"
                             f"{n[sel].max()} outside [{lo}, {hi}]")
        worst_q = float(rel["pos"][sel].max())
        worst_v = float(rel["vel"][sel].max())
        print(f"  {c}: {int(sel.sum())} systems, bodies {n[sel].min()}-"
              f"{n[sel].max()}, max |sum m q| / sum m|q| {worst_q:.3e}, "
              f"max |sum m v| / sum m|v| {worst_v:.3e}"
              + (" (noise after the projection, as in the JAX package; "
                 "not gated)" if c in NOISY_COHORTS else ""))
        if worst_q > COM_GATE or (c not in NOISY_COHORTS
                                  and worst_v > COM_GATE):
            raise SystemExit(f"generators: {c} COM or momentum above "
                             f"{COM_GATE} of its scale")


def generators_phase(dev):
    """diverse_population(torch.Generator seeded 0, 16384, n_slots=8)
    drawn on the card between CUDA events, twice (the same bits), gated,
    and its per-cohort statistics beside the committed bench
    population's."""
    from nbodysimproject_tpu_torch.generators import pipeline as gp

    times, pops = [], []
    for _ in range(2):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        pops.append(gp.diverse_population(gen, B_MAIN, n_slots=N_SLOTS,
                                          device=dev))
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    same = all(torch.equal(a, b) for a, b in zip(pops[0][:5], pops[1][:5]))
    print(f"  diverse_population({B_MAIN}, n_slots={N_SLOTS}) on the card: "
          f"cold {times[0]:.3f} ms, again {times[1]:.3f} ms "
          f"({B_MAIN / times[1] * 1e3:.1f} systems/s); the same seed "
          f"redrawn gives the same bits: {same}")
    if not same:
        raise SystemExit("generators: one seed drew two populations")
    pop = pops[0]
    check_drawn(pop, gp.cohort_sizes(B_MAIN), gp.COHORT_BODY_COUNTS, dev)
    st = gp.population_statistics(*pop[:5])
    (bm, bq, bv, bmask, bsoft), btypes = bench_population()
    f = lambda a: torch.as_tensor(a)
    bst = gp.population_statistics(f(bm), f(bq), f(bv), f(bmask), f(bsoft))
    card = per_cohort(pop[5], **{k: v.cpu().numpy() for k, v in st.items()})
    ref = per_cohort(btypes, **{k: v.numpy() for k, v in bst.items()})
    print("  per-cohort medians, the card's draw | the committed bench "
          "population (JAX, CPU):")
    for c in card:
        print(f"    {c}: " + ", ".join(
            f"{k} {card[c][k]:.4f} | {ref[c][k]:.4f}" for k in card[c]))
    return dict(ms=times[1], cold_ms=times[0])


def bench_population_phase(cfg, hk, kw, dev):
    """bench.py's leg on its own population: analyze_population under
    _PIPE_CFG at BENCH_STEPS steps, one cold run (its warm runs went to
    pay for phase 25: one took 8.8 s on an NVIDIA H100 80GB HBM3 at 700 W);
    then the entry point MLTrainingPipeline(16384, ENTRY_STEPS, seed=0)
    .generate_diverse_dataset_batched() on a population drawn on the
    card."""
    from nbodysimproject_tpu_torch import MLTrainingPipeline, analyze_population
    from nbodysimproject_tpu_torch.generators.pipeline import cohort_sizes

    (mass, pos, vel, mask, soft), types = bench_population()
    kinds = (hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep)
    run_kw = dict(kw, softening=soft, G=1.0, min_softening=0.0, device=dev)
    reset_counts(*kinds)
    tm = {}
    t0 = time.perf_counter()
    df = analyze_population(mass, pos, vel, mask, cfg, timing_out=tm,
                            **run_kw)
    cold = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in kinds}
    print(f"  cold {cold:.3f}s: {B_MAIN / cold:.1f} systems/s (bench.py's "
          f"population, B={B_MAIN}, n_steps={kw['n_steps']}, N={N_SLOTS}, "
          f"tail on), launches {launches}, phases {tm}")
    if not all(launches.values()):
        raise SystemExit(f"bench population: a kernel was not launched: "
                         f"{launches}")
    check_output(df, "bench population")
    share = per_cohort(types, np.mean, stable=df["is_stable"].to_numpy(float),
                       tail=df["tail_fast_path"].to_numpy(float))
    print("  per cohort, stable share / tail share: " + "; ".join(
        f"{c} {v['stable']:.4f} / {v['tail']:.4f}" for c, v in share.items()))

    reset_counts(*kinds)
    tm = {}
    t0 = time.perf_counter()
    df_e = MLTrainingPipeline(n_systems=B_MAIN, n_steps=ENTRY_STEPS, seed=0,
                              device=dev) \
        .generate_diverse_dataset_batched(timing_out=tm)
    t_e = time.perf_counter() - t0
    launches_e = {f.__name__: f.launches for f in kinds}
    want = sum(([k] * v for k, v in cohort_sizes(B_MAIN).items()), [])
    print(f"  MLTrainingPipeline(n_systems={B_MAIN}, n_steps={ENTRY_STEPS}, "
          f"seed=0).generate_diverse_dataset_batched(): {t_e:.3f}s "
          f"({B_MAIN / t_e:.1f} systems/s, drawn on the card, cold), "
          f"launches {launches_e}, fused_ms {tm['fused_ms']:.1f}, tail_ms "
          f"{tm['tail_ms']:.1f}, n_tail {tm['n_tail']}")
    if len(df_e) != B_MAIN or "system_type" not in df_e \
            or df_e["system_type"].tolist() != want:
        raise SystemExit("the pipeline's frame: wrong rows or system_type")
    if not all(launches_e.values()):
        raise SystemExit(f"the pipeline did not launch both kernels: "
                         f"{launches_e}")
    check_output(df_e, "pipeline entry point")
    e_share = per_cohort(df_e["system_type"], np.mean,
                         stable=df_e["is_stable"].to_numpy(float),
                         tail=df_e["tail_fast_path"].to_numpy(float))
    print("  its stable share / tail share per cohort: " + "; ".join(
        f"{c} {v['stable']:.4f} / {v['tail']:.4f}"
        for c, v in e_share.items()))
    return dict(df=df, types=types, pop=(mass, pos, vel, mask, soft),
                cold=cold, launches=launches, entry_s=t_e,
                launches_entry=launches_e)


def timed_host(fn, reps=SERVE_REPS):
    """(cold s, warm median s of ``reps``, last output) of ``fn``; each
    call ends in host copies, so the host clock covers the device
    work."""
    out, ts = None, []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return ts[0], float(np.median(ts[1:])), out


def card_scores(prefix, kind, frame, types, dev, what):
    """One model's ``predict_frame`` on the card (timed_host) held to the
    same predictor on the CPU on the same frame: the MLP within
    SERVE_MLP_TOL with equal verdicts on the rows farther than that from
    their operating point, the GBDT's raw scores bit for bit and its
    probabilities within SERVE_GBDT_TOL (gated).  Returns the card's
    (cold s, warm s, prob, stable) and the largest differences."""
    from nbodysimproject_tpu_torch import StabilityPredictor

    card = StabilityPredictor(prefix=prefix, model=kind, device=dev)
    cpu = StabilityPredictor(prefix=prefix, model=kind, device="cpu")
    c_p, t_p, (prob, stable, raw) = timed_host(
        lambda: card.predict_frame(frame, cohorts=types, return_raw=True))
    prob_c, stable_c, raw_c = cpu.predict_frame(frame, cohorts=types,
                                                return_raw=True)
    # each row's operating point: the calibration's (schema v2) or the
    # legacy per-cohort threshold
    calib = card.calibration
    points = ((calib.get("cohort_operating_points") or {}) if calib
              else card.cohort_thresholds)
    default = calib["global_threshold"] if calib else card.threshold
    thr = np.asarray([points.get(c, default) for c in types])
    d_prob = float(np.abs(prob - prob_c).max())
    d_raw = float(np.abs(raw.astype(float) - raw_c.astype(float)).max())
    note = ""
    if kind == "mlp":
        clear = np.abs(prob_c - thr) > SERVE_MLP_TOL
        if not (d_prob <= SERVE_MLP_TOL and d_raw <= SERVE_MLP_TOL
                and np.array_equal(stable[clear], stable_c[clear])):
            raise SystemExit(f"{what}: the card's MLP scores differ from "
                             f"the CPU's")
        note = (f"verdicts equal on the {int(clear.sum())} rows more than "
                f"{SERVE_MLP_TOL} from their operating point; "
                f"{int((stable != stable_c).sum())} differ in all")
    else:
        same_raw = np.array_equal(card.raw_score(frame), cpu.raw_score(frame))
        if not (same_raw and d_prob <= SERVE_GBDT_TOL
                and d_raw <= SERVE_GBDT_TOL
                and np.array_equal(stable, stable_c)):
            raise SystemExit(f"{what}: the card's GBDT differs from the "
                             f"CPU's (raw scores equal: {same_raw})")
        note = f"raw scores equal bit for bit: {same_raw}"
    return dict(cold=c_p, s=t_p, prob=prob, stable=stable, d_prob=d_prob,
                d_raw=d_raw, note=note)


def serving_phase(cfg, bench, dev, main_rate):
    """ic_feature_frame and both headline predictors on the bench
    population on the card, timed (beside the bench population's
    analysis rate and the main path's 1000-step rate ``main_rate``), the
    card's scores gated against the same port on the CPU, the verdicts
    beside the bench population's is_stable."""
    from nbodysimproject_tpu_torch import ic_feature_frame

    mass, pos, vel, mask, soft = bench["pop"]
    types = bench["types"]
    print(f"  torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.get_float32_matmul_precision() = "
          f"{torch.get_float32_matmul_precision()!r} (the predictor runs "
          f"the MLP with TF32 off and 'highest' whatever these are)")
    kw = dict(G=1.0, softening=soft, min_softening=0.0, dt=DT)
    c_ic, t_ic, frame = timed_host(lambda: ic_feature_frame(
        mass, pos, vel, mask, cfg, device=dev, **kw))
    frame_cpu = ic_feature_frame(mass, pos, vel, mask, cfg, device="cpu",
                                 **kw)
    feats = [c for c in frame.columns if c.startswith("initial_")]
    # each column's largest difference over its largest magnitude
    d_feat = max(float(np.nanmax(np.abs(
        frame[c].to_numpy(float) - frame_cpu[c].to_numpy(float)))
        / max(float(np.nanmax(np.abs(frame_cpu[c].to_numpy(float)))), 1e-30))
        for c in feats)
    an_rate = B_MAIN / bench["cold"]
    print(f"  ic_feature_frame: cold {c_ic:.3f}s, warm median {t_ic:.4f}s = "
          f"{B_MAIN / t_ic:.1f} systems/s; its initial_* columns against "
          f"the CPU's: largest difference over the column's largest magnitude "
          f"{d_feat:.3e} (not gated)")
    out = {"ic_s": t_ic}
    for kind in ("mlp", "gbdt"):
        sc = card_scores(MODEL_PREFIX, kind, frame, types, dev, "serving")
        c_p, t_p, stable = sc["cold"], sc["s"], sc["stable"]
        d_prob = sc["d_prob"]
        rate = B_MAIN / t_p
        both = B_MAIN / (t_p + t_ic)
        print(f"  {kind}: predict_frame cold {c_p:.3f}s, warm median "
              f"{t_p:.4f}s = {rate:.1f} systems/s; with ic_feature_frame "
              f"{both:.1f} systems/s = {both / an_rate:.1f}x the bench "
              f"population's analysis at {BENCH_STEPS} steps "
              f"({an_rate:.1f} systems/s), {both / main_rate:.1f}x the main "
              f"path's at {N_STEPS} ({main_rate:.1f}); card against CPU: "
              f"max |dprob| {d_prob:.3e}, max |draw| {sc['d_raw']:.3e}")
        print(f"    {sc['note']}")
        truth = bench["df"]["is_stable"].to_numpy(bool)
        agree = per_cohort(types, np.mean,
                           agree=(stable == truth).astype(float),
                           predicted=stable.astype(float))
        print(f"    verdicts against the bench population's is_stable "
              f"(agreement / predicted stable share, not gated): " + "; ".join(
                  f"{c} {v['agree']:.4f} / {v['predicted']:.4f}"
                  for c, v in agree.items())
              + f"; all {float((stable == truth).mean()):.4f}")
        out[kind] = dict(s=t_p, rate=rate, both=both, ratio=both / an_rate,
                         ratio_main=both / main_rate, d_prob=d_prob)
    return out


# --------------------------------------------------- the 3-D product path
DATA3 = os.path.join(HERE, "data", "stability_3d_131k.csv.gz")
#: the JAX fused engine's labels (its Pallas kernels in interpret mode,
#: full mode at the dataset's horizon) of the 3-D dataset's first 256
#: rows with at most 2 substeps (``tests/torch_label_parity.py
#: --d3-fused 256``); the JAX scan engine zeroes the eps* gradient on
#: these rows (ROADMAP.md Queue 3), so its labels are not the reference
LABELS3 = os.path.join(HERE, "data", "labels_3d_jax_fused_256.npz")
MODEL3_PREFIX = os.path.join(HERE, "data", "headline3d_pre_")
#: the 3-D dataset's columns are round 3's: its cos_theta_mean lies
#: outside [-1, 1] where a cosine cannot (the z-only L0 in the vector
#: branch) and its angular_momentum_drift is the z component's
#: (``tests/torch_label_parity.py --d3-fused``), so its labels are not
#: shown to be the JAX package's and the card's agreement with them is
#: printed, not gated
DATASET3_LABELS_GATED = False
#: the ham_soft scan at d = 3 (the eps kernel's path): its steps on the
#: population's n_sub = 1 rows
SCAN3_STEPS = 100


def hamsoft_scan_3d(states, dyns, ek, dev):
    """The ham_soft scan (``integrate_batch``, the eps kernel on every
    (eps*, grad) evaluation) at d = 3 on the 3-D population's n_sub = 1
    rows, SCAN3_STEPS steps: one cold and LEG_WARM_REPS warm runs between
    CUDA events, the eps kernel's launches in the cold run (gated > 0), the
    systems whose positions end non-finite (the random cohort's
    blow-ups, counted as bench.py's legs count them)."""
    from nbodysimproject_tpu_torch import SimConfig
    from nbodysimproject_tpu_torch.parallel.batch_engine import \
        integrate_batch

    cfg = SimConfig(integrator_mode="ham_soft", fast_float32=True)
    rows = torch.nonzero(dyns.n_sub == 1)[:, 0]
    st, dy = states.take(rows), dyns.take(rows)
    out, cold, med, la = run_leg(
        f"ham_soft scan d=3 ({len(rows)} rows at n_sub 1)",
        lambda: integrate_batch(st, dy, cfg, DT, SCAN3_STEPS, 1),
        len(rows), SCAN3_STEPS, (ek.eps_star_and_grad_fused,))
    bad = nonfinite(out.pos)
    print(f"  ham_soft scan d=3: {bad} of {len(rows)} systems end with "
          f"non-finite positions")
    if not la["eps_star_and_grad_fused"]:
        raise SystemExit(f"the 3-D ham_soft scan launched no eps kernel: "
                         f"{la}")
    return dict(cold=cold, med=med, launches=la["eps_star_and_grad_fused"],
                B=len(rows), nonfinite=bad)


def serve_3d(cfg, pop, soft, G, min_soft, dev):
    """ic_feature_frame and both 3-D headline predictors on the 3-D
    population on the card (warm median of SERVE_REPS), the card's
    scores held to the CPU's as the 2-D serving phase holds them."""
    from nbodysimproject_tpu_torch import ic_feature_frame

    types = ["random"] * B_MAIN
    _c, t_ic, frame = timed_host(lambda: ic_feature_frame(
        *pop, cfg, device=dev, G=G, softening=soft, min_softening=min_soft,
        dt=DT))
    print(f"  3-D ic_feature_frame: {len(frame.columns)} columns, warm median "
          f"{t_ic:.4f}s = {B_MAIN / t_ic:.1f} systems/s")
    out = {"ic_s": t_ic}
    for kind in ("mlp", "gbdt"):
        sc = card_scores(MODEL3_PREFIX, kind, frame, types, dev,
                         "3-D serving")
        both = B_MAIN / (sc["s"] + t_ic)
        print(f"  3-D {kind}: predict_frame warm median {sc['s']:.4f}s, with "
              f"ic_feature_frame {both:.1f} systems/s; card against CPU max "
              f"|dprob| {sc['d_prob']:.3e}, max |draw| {sc['d_raw']:.3e}; "
              f"predicted stable share {sc['stable'].mean():.4f}; "
              f"{sc['note']}")
        out[kind] = dict(s=sc["s"], both=both, d_prob=sc["d_prob"],
                         stable=float(sc["stable"].mean()))
    return out


def phase_3d(cfg, cfg_off, hk, ek, dev, tangent_of):
    """The 3-D product path on the card: kernels held to their plain
    versions at d = 3, the ham_soft scan, the main path (one cold run: its
    warm runs went to pay for phase 25, one took 29.9 s on an NVIDIA H100
    80GB HBM3 at 700 W),
    the tail-off run, the labels, the main path's launches replayed, and
    the 3-D headline models served."""
    from nbodysimproject_tpu_torch import analyze_population
    from nbodysimproject_tpu_torch.analysis.batch import (dispatch_plan,
                                                          prepare_population)
    from nbodysimproject_tpu_torch.analysis.fused import analyze_batch_fused
    from nbodysimproject_tpu_torch.diagnostics.megno import (
        init_tangent, population_normals)

    (mass, pos, vel, mask, G, soft, min_soft), ref = load_population(
        B_MAIN, DATA3, 3)
    assert pos.shape == (B_MAIN, N_SLOTS, 3) and np.all(G == G[0])
    print(f"  3-D population: {B_MAIN} systems, {int(mask.sum())} bodies, "
          f"{np.bincount(mask.sum(1))} by body count, cohorts "
          f"{ref['system_type'].value_counts().to_dict()}", flush=True)
    states, dyns, n_sub_raw = prepare_population(
        mass, pos, vel, mask, cfg, G=G, softening=soft,
        min_softening=min_soft, dt=DT, device=dev)
    cases, low3, _top3, _b3 = bucket_cases("3-D ", states, dyns, n_sub_raw,
                                           cfg, hk, tangent_of)
    out = {"cases": cases, "low": low3}
    first = torch.arange(B_CMP, device=dev)
    out["eps"] = {clamp: compare_eps("3-D dataset", states.take(first),
                                     dyns.take(first), clamp, ek)
                  for clamp in (True, False)}
    eps_layouts_agree(states, dyns, ek)
    out["scan"] = hamsoft_scan_3d(states, dyns, ek, dev)

    kw = dict(G=G, softening=soft, min_softening=min_soft, dt=DT,
              n_steps=N_STEPS, mode="full", show_progress=False)
    sel, _n_tail = tail_stats(states, dyns, cfg, n_sub_raw)
    kinds = (hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep)
    reset_counts(*kinds)
    tm = {}
    t0 = time.perf_counter()
    df = analyze_population(mass, pos, vel, mask, cfg, timing_out=tm, **kw)
    cold = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in kinds}
    print(f"  3-D main path cold {cold:.3f}s = {B_MAIN / cold:.1f} "
          f"systems/s (B={B_MAIN}, n_steps={N_STEPS}, N={N_SLOTS}, d=3, "
          f"tail on its own stream), launches {launches}, phases {tm}",
          flush=True)
    if not all(launches.values()):
        raise SystemExit(f"the 3-D main path did not launch both kernels: "
                         f"{launches}")
    if tm["n_tail"] != int(sel.sum()) or not np.array_equal(
            df["tail_fast_path"].to_numpy(bool), sel):
        raise SystemExit("the 3-D main path's tail differs from its "
                         "selection")
    check_output(df, "3-D tail on")
    if not {"z_0", "vz_7"} <= set(df.columns):
        raise SystemExit("the 3-D frame lacks its z columns")

    t0 = time.perf_counter()
    df_off = analyze_population(mass, pos, vel, mask, cfg_off, **kw)
    t_off = time.perf_counter() - t0
    check_output(df_off, "3-D tail off")
    keep = ~sel
    differ = {c: int((~((df[c].to_numpy()[keep] == df_off[c].to_numpy()[keep])
                        | (pd_isnan(df[c].to_numpy()[keep])
                           & pd_isnan(df_off[c].to_numpy()[keep])))).sum())
              for c in df_off.columns}
    differ = {c: v for c, v in differ.items() if v}
    print(f"  3-D tail-off run {t_off:.3f}s ({B_MAIN / t_off:.1f} "
          f"systems/s); non-tail rows ({int(keep.sum())}) bitwise equal to "
          f"the tail-on run in every column: {not differ}")
    if differ:
        raise SystemExit(f"3-D non-tail rows differ from the tail-off run: "
                         f"{differ}")

    with np.load(LABELS3) as z:
        rows, jax_stable = z["rows"], z["is_stable"].astype(bool)
    if sel[rows].any():
        raise SystemExit("3-D labels: a row of the JAX fused engine's went "
                         "to the tail")
    card = df["is_stable"].to_numpy(bool)[rows]
    agree_jax = float((card == jax_stable).mean())
    print(f"  3-D is_stable on the {len(rows)} rows of "
          f"{os.path.basename(LABELS3)}: agrees with the JAX fused engine's "
          f"on {agree_jax:.4f} (gated >= {LABEL_GATE}); stable shares card "
          f"{card.mean():.4f}, JAX {jax_stable.mean():.4f}, the dataset "
          f"{ref['is_stable'].to_numpy(bool)[rows].mean():.4f}")
    if agree_jax < LABEL_GATE:
        raise SystemExit(f"3-D is_stable agrees with the JAX package on "
                         f"{agree_jax:.4f} of its rows (< {LABEL_GATE})")
    agree_ds = label_agreement(df, ref, keep)
    print_agreement("3-D non-tail rows: this run (first) against the "
                    "dataset (second)", agree_ds)
    a = agree_ds["is_stable"]["agree"]
    why = "gated" if DATASET3_LABELS_GATED else \
        "not gated: the 3-D dataset predates the vector-L fix"
    print(f"  3-D is_stable against the dataset on the non-tail rows: "
          f"{a:.4f} ({why})")
    if DATASET3_LABELS_GATED and a < LABEL_GATE:
        raise SystemExit(f"3-D is_stable agrees with the dataset on {a:.4f}")

    # the main path's launches replayed on the same inputs
    z1, z2 = population_normals(0, B_MAIN, (N_SLOTS, 3), torch.float32)
    dr0, dv0 = init_tangent(z1.to(dev), z2.to(dev), states)
    fused_rows = np.nonzero(~sel)[0]
    order, n_sub_max, _ = dispatch_plan(n_sub_raw[fused_rows], cfg)
    lanes = torch.as_tensor(fused_rows[order], device=dev)
    ta, tmg = Timed(hk.hamsoft_analysis_multistep), Timed(
        hk.hamsoft_megno_multistep)
    megno_steps = min(100, min(50, N_STEPS // 2))
    analyze_batch_fused(states.take(lanes), dyns.take(lanes), cfg, N_STEPS,
                        DT, "full", n_sub_max, megno_steps,
                        tangent=(dr0[lanes], dv0[lanes]), analysis_fn=ta,
                        megno_fn=tmg)
    ns_lanes = dyns.n_sub[lanes].cpu().numpy()
    main_ms = {}
    for kind, t, steps in (("analysis", ta, N_STEPS),
                           ("megno", tmg, megno_steps)):
        b = bound(kind, ns_lanes, n_sub_max, N_STEPS, megno_steps, N_SLOTS, 3)
        per_trip = 1e3 * t.ms / (steps * n_sub_max)
        main_ms[kind] = (t.ms, per_trip, b)
        print(f"  3-D {kind}: {len(ns_lanes)} fused lanes, one launch "
              f"{t.ms:.1f} ms = {per_trip:.3f} us per trip of the deepest "
              f"lane, bound {b[0]:.3f} ms ({b[1]}), {t.ms / b[0]:.0f}x the "
              f"bound", flush=True)

    out.update(cold=cold, off=t_off, launches=launches,
               n_tail=int(sel.sum()), fused_ms=float(tm["fused_ms"]),
               tail_ms=float(tm["tail_ms"]), main_ms=main_ms,
               agree_jax=agree_jax, agree_ds=a,
               serve=serve_3d(cfg, (mass, pos, vel, mask), soft, G, min_soft,
                              dev),
               pop=dict(raw=(mass, pos, vel, mask), G=G, soft=soft,
                        min_soft=min_soft, states=states, dyns=dyns,
                        n_sub_raw=n_sub_raw, low=out["low"], df_off=df_off))
    return out


# ------------------------------------- the fused engine's other branches
#: the analysis and MEGNO kernels' branches of this phase: label, the
#: SimConfig fields that select it
BRANCHES = (("reflection", dict(use_soft_barrier=False)),
            ("none", dict(disable_barrier=True)),
            ("reference", dict(eps_grad_mode="reference")))
#: the build variants of this phase, started with every other build in
#: phase 2: the analysis and MEGNO kernels' reflection fold and
#: "reference" gradient at N = 8 (d = 2; the "reference" gradient at
#: d = 3 too), the multi-step kernel's at N = 3 (the bench's systems)
#: and at N = 8 (``branch_walk`` replays the analysis and MEGNO kernels'
#: trips with it), the eps kernel's at N = 3 and 8
BRANCH_JOBS = (("hamsoft.cu", 8, 2, "refl"), ("hamsoft.cu", 8, 2, "ref"),
               ("hamsoft.cu", 8, 3, "ref"),
               ("hamsoft_multistep.cu", 3, 2, "ref"),
               ("hamsoft_multistep.cu", 8, 2, "ref"),
               ("hamsoft_multistep.cu", 8, 3, "ref"),
               ("eps_grad.cu", 3, 2, "ref"), ("eps_grad.cu", 8, 2, "ref"))
#: the default builds this phase adds (d = 3 of rows 3 and 6)
BRANCH_DEFAULT_JOBS = tuple(("hamsoft_multistep.cu", n, 3) for n in (3, 4, 8)) \
    + (("whfast.cu", 3, 3),)
#: registers of the exact builds as PERF.md section 6 records them:
#: (source, N, d) -> {kernel: registers of its instances}
EXACT_REGISTERS = {
    ("hamsoft.cu", 8, 2): {"analysis_kernel": [149], "megno_kernel": [143]},
    ("hamsoft.cu", 8, 3): {"analysis_kernel": [144], "megno_kernel": [144]},
    ("hamsoft_multistep.cu", 3, 2): {"multistep_thread": [190, 192]},
    ("eps_grad.cu", 3, 2): {"eps_grad_thread": [156]},
    ("eps_grad.cu", 8, 2): {"eps_grad_lane": [167]},
    ("eps_grad.cu", 3, 3): {"eps_grad_thread": [167]},
    ("eps_grad.cu", 8, 3): {"eps_grad_lane": [186]},
    ("whfast.cu", 3, 2): {"whfast_kernel": [62]},
}


def ptxas_entries(report):
    """[(kernel name, REFL/REF template arguments if any, registers,
    spill bytes)] of a ptxas report, in its order."""
    import re

    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            name = next((k for k in ("analysis_kernel", "megno_kernel",
                                     "multistep_thread", "multistep_warp",
                                     "eps_grad_thread", "eps_grad_lane",
                                     "whfast_kernel", "stumpff_probe")
                         if k in mangled), mangled[:40])
            # bool template arguments print as Lb0E / Lb1E
            flags = "".join(re.findall(r"Lb(\d)E", mangled))
            out.append([name, flags, None, 0])
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1][2] = int(m.group(1))
        for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", line):
            if out:
                out[-1][3] += int(x)
    return out


def whfast_ics_3d(B, seed, dev):
    """bench.py's WHFast systems with each planet's orbit tilted about the
    x axis by up to 0.1 rad and 1% Gaussian perturbations in all three
    coordinates, drawn on the card from ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    q2, v2 = f(WH_Q), f(WH_V)
    inc = 0.1 * torch.rand((B, 3), generator=gen, device=dev)
    c, s = torch.cos(inc), torch.sin(inc)
    q = torch.stack([q2[:, 0].expand(B, 3), q2[:, 1] * c, q2[:, 1] * s], -1)
    v = torch.stack([v2[:, 0].expand(B, 3), v2[:, 1] * c, v2[:, 1] * s], -1)
    q = q + 0.01 * torch.randn((B, 3, 3), generator=gen, device=dev)
    v = v + 0.01 * torch.randn((B, 3, 3), generator=gen, device=dev)
    return f(WH_M).expand(B, 3).contiguous(), q, v


def compare_whfast_3d(dev, wk):
    """The WHFast kernel at d = 3 against its plain version (``row_gate``,
    the plain version's float64 run as the sensitivity, as at d = 2) at
    B = 2^22, CMP_WH_STEPS steps, on inclined planetary systems."""
    B, steps = B_WH_FUSED, CMP_WH_STEPS
    m, q, v = whfast_ics_3d(B, 29, dev)
    eps2 = torch.full((B,), FUSED_EPS2, device=dev)
    kw = dict(h=DT, G=1.0, n_steps=steps, iters=WH_ITERS)

    def make(dt_):
        return tuple(x.to(dt_) for x in (q, v, m, eps2))

    k, p, p64, pr, ms, pms = _runs(
        lambda *a: wk.whfast_multistep(*a, **kw),
        lambda *a: wk.whfast_multistep_plain(*a, **kw), make,
        lambda a: a, lambda o: o)
    err = row_gate(f"whfast d=3 (B={B}, {steps} steps)",
                   {n: (k[i], p[i], p64[i], pr[i], STATE_TOL)
                    for i, n in enumerate(("pos", "vel"))})
    shares = kepler_shares(wk, q, v, m, eps2, kw)
    b_ms, b_by = bound_whfast(B, 3, 3, steps, WH_ITERS, shares)
    print(f"  whfast d=3: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), largest |kernel - plain| {err:.3e}",
          flush=True)
    return dict(ms=ms, plain_ms=pms, err=err, bound=(b_ms, b_by),
                ics=(m, q, v, eps2))


def nonfinite_rows(df):
    """Rows with a non-finite value in any compared column, and the
    count in each column that has one (NaN MEGNO columns on blown-up
    systems, an infinite lyapunov_time where MEGNO is 0)."""
    bad = ~np.isfinite(df[list(TOL)].to_numpy(float))
    cols = {c: int(n) for c, n in zip(TOL, bad.sum(0)) if n}
    return f"{int(bad.any(1).sum())} {cols}"


def branch_run(label, cfg_b, pop, states, dyns, n_sub_raw, ref_df, hk,
               share, d, dev):
    """One full-width ``analyze_population`` run of a branch (tail off):
    systems/s, fused_ms, the launches of both kernels (gated > 0), its
    non-finite rows beside the soft/exact run's (``ref_df``), is_stable
    beside it (printed: the physics differs); then its kernel launches
    replayed on the same lanes between CUDA events, with their bounds,
    and under the reflection policy every final eps within [eps_min,
    eps_max] (gated)."""
    from nbodysimproject_tpu_torch import analyze_population
    from nbodysimproject_tpu_torch.analysis.batch import dispatch_plan
    from nbodysimproject_tpu_torch.analysis.fused import analyze_batch_fused
    from nbodysimproject_tpu_torch.diagnostics.megno import (
        init_tangent, population_normals)

    (mass, pos, vel, mask), G, soft, min_soft = pop
    kinds = (hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep)
    reset_counts(*kinds)
    tm = {}
    t0 = time.perf_counter()
    df = analyze_population(mass, pos, vel, mask, cfg_b, G=G, softening=soft,
                            min_softening=min_soft, dt=DT, n_steps=N_STEPS,
                            mode="full", show_progress=False, timing_out=tm)
    t_run = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in kinds}
    agree = float((df["is_stable"].to_numpy(bool)
                   == ref_df["is_stable"].to_numpy(bool)).mean())
    print(f"  {label}: {t_run:.3f}s = {len(df) / t_run:.1f} systems/s "
          f"(d={d}, tail off, cold), fused call {tm['fused_ms']:.1f} ms, "
          f"launches {launches}; non-finite rows {nonfinite_rows(df)} "
          f"(soft/exact run {nonfinite_rows(ref_df)}); is_stable agrees with "
          f"the soft/exact run on {agree:.4f} (stable share "
          f"{df['is_stable'].mean():.4f} against "
          f"{ref_df['is_stable'].mean():.4f}; not gated)", flush=True)
    if not all(launches.values()):
        raise SystemExit(f"{label}: the run did not launch both kernels: "
                         f"{launches}")
    z1, z2 = population_normals(0, len(df), tuple(states.pos.shape[1:]),
                                torch.float32)
    dr0, dv0 = init_tangent(z1.to(dev), z2.to(dev), states)
    order, nsm, _ = dispatch_plan(n_sub_raw, cfg_b)
    lanes = torch.as_tensor(order, device=dev)
    ta, tmg = Timed(hk.hamsoft_analysis_multistep), Timed(
        hk.hamsoft_megno_multistep)
    megno_steps = min(100, min(50, N_STEPS // 2))
    _r, st1 = analyze_batch_fused(
        states.take(lanes), dyns.take(lanes), cfg_b, N_STEPS, DT, "full", nsm,
        megno_steps, tangent=(dr0[lanes], dv0[lanes]), analysis_fn=ta,
        megno_fn=tmg)
    ns_lanes = dyns.n_sub[lanes].cpu().numpy()
    if share is not None:
        # the bound takes the fallback's share at t = 0 for every trip:
        # the kernels do not count their firings; the share at the end
        # shows how far it moved
        end = float(fallback_lanes(st1, dyns.take(lanes))[0].float().mean())
        print(f"    the fallback's share at t = 0 {share:.4f} (the bounds "
              f"below), at the end of the run {end:.4f}", flush=True)
    times = {}
    for kind, t, steps in (("analysis", ta, N_STEPS),
                           ("megno", tmg, megno_steps)):
        b = bound(kind, ns_lanes, nsm, N_STEPS, megno_steps, N_SLOTS, d, share)
        times[kind] = (t.ms, b)
        print(f"    {kind} replayed: one launch {t.ms:.1f} ms = "
              f"{1e3 * t.ms / (steps * nsm):.3f} us per trip of the deepest "
              f"lane, bound {b[0]:.3f} ms ({b[1]}), {t.ms / b[0]:.0f}x the "
              f"bound", flush=True)
    if cfg_b.use_soft_barrier is False and not cfg_b.disable_barrier:
        dl = dyns.take(lanes)
        inside = (st1.eps >= dl.min_softening) & (st1.eps <= dl.max_softening)
        print(f"    reflection: final eps inside [eps_min, eps_max] on "
              f"{int(inside.sum())} of {len(inside)} systems (gated: all)")
        if not bool(inside.all()):
            raise SystemExit(f"{label}: a final eps lies outside its walls")
    return dict(s=t_run, fused_ms=tm["fused_ms"], launches=launches,
                agree=agree, times=times, df=df)


def phase_branches(cfg, cfg_off, hk, ek, wk, dev, tangent_of, pop, states,
                   dyns, n_sub_raw, df_off, p3, built):
    """The fused engine's remaining branches on the card: the builds'
    registers and spills, the fallback's share at t = 0, the kernels
    held to their plain versions in each branch, and the branches' runs
    at full width.  Returns the numbers of the report."""
    from nbodysimproject_tpu_torch import SimConfig, analyze_population
    from nbodysimproject_tpu_torch.analysis.batch import dispatch_plan
    from nbodysimproject_tpu_torch.analysis.fused import analyze_batch_fused
    from nbodysimproject_tpu_torch.diagnostics.megno import (
        init_tangent, population_normals)
    from nbodysimproject_tpu_torch.ops import cuda_build
    from nbodysimproject_tpu_torch.parallel.batch_engine import \
        integrate_batch

    t_phase = time.perf_counter()
    out = {"cases": {}}
    # the builds: this phase's started with every other in phase 2
    secs = [built[j][1] for j in BRANCH_JOBS + BRANCH_DEFAULT_JOBS]
    print(f"  builds of this phase: {len(secs)}, the longest "
          f"{max(secs):.1f}s, in phase 2's parallel build")
    for job in BRANCH_JOBS + BRANCH_DEFAULT_JOBS:
        print(f"    {cuda_build.job_name(job)}: " + "; ".join(
            f"{n}{'<' + f + '>' if f else ''} {r} registers, {sp} bytes "
            f"spilled" for n, f, r, sp in ptxas_entries(built[job][2])))
    for job, want in EXACT_REGISTERS.items():
        got = {n: sorted(r for k, _f, r, _sp in ptxas_entries(built[job][2])
                         if k == n) for n in want}
        print(f"    exact build {cuda_build.job_name(job)}: registers {got}, "
              f"PERF.md {want}; unchanged {got == want}")

    # the fallback's share of lanes at t = 0
    cfg_hs = SimConfig(integrator_mode="ham_soft", fast_float32=True)
    st_h, dy_h = hamsoft_bench_batch(cfg_hs, dev)
    shares = {}
    for what, st, dy, ek_sem in (("dataset rows", states, dyns, False),
                                 ("bench population", st_h, dy_h, True)):
        taken, near = fallback_lanes(st, dy, clamp=ek_sem, ek=ek_sem)
        shares[what] = float(taken.float().mean())
        print(f"  the fallback's share at t = 0 on the {what} "
              f"({len(taken)} systems{', the eps kernel' if ek_sem else ''}"
              f"): {shares[what]:.4f} ({int(taken.sum())} systems; gated "
              f"> 0); {int(near.sum())} at the threshold in float64",
              flush=True)
        if shares[what] <= 0.0:
            raise SystemExit(f"the fallback takes no system of the {what}")
    out["shares"] = shares
    share_ds = shares["dataset rows"]

    # rows 1-2 in each branch against their plain versions, on the lowest
    # bucket: each branch is a template argument of the kernel whose top
    # bucket phase 4 holds (the branches' top-bucket cases, 35.2-62.0 s
    # each on an NVIDIA H100 80GB HBM3 at 700 W, were cut for phase 23)
    pop3 = p3["pop"]
    for label, over in BRANCHES:
        t0 = time.perf_counter()
        out["cases"][label] = bucket_cases(
            f"{label} ", states, dyns, n_sub_raw, cfg.replace(**over), hk,
            tangent_of, which=("lowest",))[0]
        print(f"  {label} cases done in {time.perf_counter() - t0:.1f}s",
              flush=True)
    cfg_r = cfg.replace(eps_grad_mode="reference")
    st3, dy3 = pop3["states"], pop3["dyns"]
    low3 = torch.as_tensor(pop3["low"], device=dev)
    taken3, near3 = fallback_lanes(st3.take(low3), dy3.take(low3))
    print(f"  reference 3-D lowest bucket: the fallback takes "
          f"{int(taken3.sum())} of {len(taken3)} systems at t = 0, "
          f"{int(near3.sum())} at the threshold in float64")
    out["cases"]["reference d=3"] = bucket_cases(
        "reference 3-D ", st3, dy3, pop3["n_sub_raw"], cfg_r, hk, tangent_of,
        which=("lowest",))[0]

    # row 3: the "reference" gradient under both policies on the bench's
    # systems; d = 3 at N = 8 on the 3-D lowest bucket
    taken_b, near_b = fallback_lanes(st_h, dy_h)
    print(f"  multi-step reference: the fallback takes {int(taken_b.sum())} "
          f"of {len(taken_b)} bench systems at t = 0, {int(near_b.sum())} at "
          f"the threshold in float64")
    for policy in ("soft", "reflection"):
        out[f"multistep reference {policy}"] = compare_multistep(
            cfg_hs.replace(use_soft_barrier=(policy == "soft")), st_h, dy_h,
            policy, hk, "reference")
    out["multistep d=3"] = compare_multistep(
        cfg, st3.take(low3), dy3.take(low3), "soft", hk, steps=20)

    # row 4: the fallback under both clamps, and its two layouts
    first = torch.arange(B_CMP, device=dev)
    for clamp in (True, False):
        out[f"eps bench clamp={clamp}"] = compare_eps(
            "bench", st_h, dy_h, clamp, ek, use_fallback=True)
        out[f"eps dataset clamp={clamp}"] = compare_eps(
            "dataset", states.take(first), dyns.take(first), clamp, ek,
            use_fallback=True)
    eps_layouts_agree(states, dyns, ek, use_fallback=True)

    # row 6 at d = 3
    out["whfast d=3"] = compare_whfast_3d(dev, wk)
    torch.cuda.empty_cache()

    # the runs at full width: the three branches on the dataset rows
    for label, over in BRANCHES:
        out[f"run {label}"] = branch_run(
            label, cfg_off.replace(**over), pop, states, dyns, n_sub_raw,
            df_off, hk, share_ds if label == "reference" else None, 2, dev)
        del out[f"run {label}"]["df"]
    # the 3-D rows with use_fused_metrics=False (row 3 at d = 3)
    cfg_c = cfg_off.replace(use_fused_metrics=False)
    kinds = (hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep,
             hk.hamsoft_multistep)
    reset_counts(*kinds)
    (m3, q3, v3, k3) = pop3["raw"]
    t0 = time.perf_counter()
    df_c = analyze_population(m3, q3, v3, k3, cfg_c, G=pop3["G"],
                              softening=pop3["soft"],
                              min_softening=pop3["min_soft"], dt=DT,
                              n_steps=N_STEPS, mode="full",
                              show_progress=False)
    t_c = time.perf_counter() - t0
    la = {f.__name__: f.launches for f in kinds}
    ref3 = pop3["df_off"]
    agree = float((df_c["is_stable"].to_numpy(bool)
                   == ref3["is_stable"].to_numpy(bool)).mean())
    print(f"  3-D use_fused_metrics=False: {t_c:.3f}s = {B_MAIN / t_c:.1f} "
          f"systems/s (tail off), launches {la}; non-finite rows "
          f"{nonfinite_rows(df_c)} (the fused way {nonfinite_rows(ref3)}); "
          f"is_stable agrees with the fused way on {agree:.4f}", flush=True)
    if la["hamsoft_multistep"] == 0 or la["hamsoft_analysis_multistep"]:
        raise SystemExit("3-D use_fused_metrics=False did not run the "
                         "multi-step kernel alone")
    rows_c, nsm_c, _ = dispatch_plan(pop3["n_sub_raw"], cfg_off)
    lanes_c = torch.as_tensor(rows_c, device=dev)
    z1, z2 = population_normals(0, B_MAIN, (N_SLOTS, 3), torch.float32)
    dr0, dv0 = init_tangent(z1.to(dev), z2.to(dev), st3)
    tms = TimedEach(hk.hamsoft_multistep)
    analyze_batch_fused(st3.take(lanes_c), dy3.take(lanes_c), cfg_c,
                        N_STEPS, DT, "full", nsm_c, min(50, N_STEPS // 2),
                        tangent=(dr0[lanes_c], dv0[lanes_c]),
                        multistep_fn=tms)
    calls = tms.times()
    ns_c = dy3.n_sub[lanes_c].cpu().numpy()
    full = [ms for n, ms in calls if n == calls[-2][0]]
    full_b = bound_multistep(ns_c, nsm_c, calls[-2][0], N_SLOTS, 3)
    out["chunked d=3"] = dict(run_s=t_c, launches=la["hamsoft_multistep"],
                              kernel_ms=sum(ms for _, ms in calls),
                              launch_ms=float(np.median(full)),
                              launch_steps=calls[-2][0], launch_bound=full_b)
    print(f"    the multi-step kernel at d = 3 (replayed): {len(calls)} "
          f"launches, {out['chunked d=3']['kernel_ms']:.1f} ms in all; a "
          f"{calls[-2][0]}-step launch {float(np.median(full)):.3f} ms "
          f"(bound {full_b[0]:.4f} ms, {full_b[1]})", flush=True)
    print("  3-D one step, use_fused_metrics=False against the fused way:")
    chunked_parity_horizon(st3.take(lanes_c), dy3.take(lanes_c), cfg_off,
                           nsm_c, analyze_batch_fused, horizons=(1,))

    # row 4's fallback through the ham_soft scan and row 3's through the
    # fused leg, at the width of bench.py's ham_soft leg; row 6 at d = 3
    # at the width of its fused leg
    counted = (ek.eps_star_and_grad_fused, hk.hamsoft_multistep,
               wk.whfast_multistep)
    cfg_hr = cfg_hs.replace(eps_grad_mode="reference")
    nsm = int(dy_h.n_sub.max())
    o, cold, med, la = run_leg(
        f"ham_soft scan reference (integrate_batch, n_sub_max {nsm})",
        lambda: integrate_batch(st_h, dy_h, cfg_hr, DT, HS_STEPS, nsm),
        B_HS, HS_STEPS, counted, reps=1)
    print(f"    non-finite systems {nonfinite(o.pos)}")
    out["scan reference"] = (cold, med, la["eps_star_and_grad_fused"])
    kwr = multistep_kw(cfg_hr, dy_h, HS_STEPS, "soft", "reference")
    o, cold, med, la = run_leg(
        "ham_soft fused reference (hamsoft_multistep)",
        lambda: hk.hamsoft_multistep(st_h.pos, st_h.vel, st_h.mass, st_h.eps,
                                     st_h.pi, **kwr),
        B_HS, HS_STEPS, counted, reps=1)
    # the fallback's share counted over the compare case's 2 steps on
    # the same systems
    share_c = out["multistep reference soft"]["share"]
    print(f"    non-finite systems {nonfinite(o[0])}; bound "
          f"{bound_multistep(dy_h.n_sub.cpu().numpy(), nsm, HS_STEPS, 3, 2, share_c)[0]:.3f} ms "
          f"(the fallback's share {share_c:.4f}, counted in the compare case)")
    out["fused reference"] = (cold, med, la["hamsoft_multistep"])
    del st_h, dy_h, o
    torch.cuda.empty_cache()
    m, q, v, eps2 = out["whfast d=3"].pop("ics")
    o, cold, med, la = run_leg(
        "whfast fused d=3 (whfast_multistep)",
        lambda: wk.whfast_multistep(q, v, m, eps2, h=DT, G=1.0,
                                    n_steps=WH_FUSED_STEPS, iters=WH_ITERS),
        B_WH_FUSED, WH_FUSED_STEPS, counted, reps=1)
    print(f"    non-finite systems {nonfinite(o[0])}")
    out["whfast leg d=3"] = (cold, med, la["whfast_multistep"])
    for key, launches in (("scan reference", out["scan reference"][2]),
                          ("fused reference", out["fused reference"][2]),
                          ("whfast leg d=3", out["whfast leg d=3"][2])):
        if not launches:
            raise SystemExit(f"{key}: its kernel was not launched")
    del m, q, v, eps2, o
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    print(f"  the branches' phase {out['s']:.1f}s, its builds in phase 2")
    return out


# ------------------------------------------------- every slot count 2-16
#: phase 25's builds, made in phase 2 with the others: both
#: sources at N = 2, 5 and 16 (d = 2) and at N = 16, d = 3, and the
#: analysis and MEGNO kernels' reflection fold and the "reference"
#: gradient of all three at N = 16, d = 3 (the largest table and
#: register count); any other N is built on first use
SLOT_JOBS = tuple((src, n, 2) for n in (2, 5, 16)
                  for src in ("hamsoft.cu", "hamsoft_multistep.cu")) \
    + (("hamsoft.cu", 16, 3), ("hamsoft_multistep.cu", 16, 3),
       ("hamsoft.cu", 16, 3, "refl"), ("hamsoft.cu", 16, 3, "ref"),
       ("hamsoft_multistep.cu", 16, 3, "ref"))
#: the slot counts of phase 25's (a) and (b)
SLOTS_PAD, SLOTS_CUT = 16, 5
#: (c): a population of 9 to 16 bodies in 16 slots drawn on the card
#: (seeded), analysed at SLOT_POP_STEPS steps (the dataset's 1000 cut
#: for the time limit)
SLOT_POP_B, SLOT_POP_COUNTS, SLOT_POP_SEED = 4096, (9, 16), 25
SLOT_POP_STEPS = 100
#: the 2-body population of (d) and the 3-D one of (e) (seeded), and
#: the horizon of the runs of (c)-(e) that count a kernel's launches
SLOT_PAIRS_B, SLOT_POP3_B = 4096, 4096
SLOT_SHORT_STEPS = 20
#: (c) and (e) hold rows 1-2 to their plain versions on the B_CMP
#: shallowest systems twice.  At WITNESS_STEPS steps (and half as many
#: MEGNO steps), ``witness_case``: the kernels' final states bit for bit
#: the multi-step kernel's, and their distance to the float64 plain run
#: no worse than the float32 plain version's in three body orders.  And
#: at SLOT_CMP_STEPS and SLOT_VARIANT_STEPS steps, the analysis columns
#: too, under ``compare_case``'s widened rule (phase 4's top bucket's):
#: the drawn 9-16-body clusters are deep (at d = 2 14 of 4096 have
#: n_sub <= 4 and the 1024 shallowest reach 38) and chaotic, so that
#: the tolerances alone cannot hold a float32 run to another at 20
#: steps.  On an NVIDIA H100 80GB HBM3 at 700 W, at 20 + 10 steps
#: (``tools/hamsoft_slot_probe.py``): the float32 plain version in each
#: of three body orders lay outside STATE_TOL of its float64 run on
#: 824-829 of (c)'s 1024 rows (the kernel 843), on 339-356 under the
#: "reference" fallback (the kernel 351); the kernel's state bit for bit
#: its one-thread layout's on every row; and every row where the kernel
#: went NaN went non-finite in float64 too
SLOT_CMP_STEPS, SLOT_VARIANT_STEPS = 2, 4
WITNESS_STEPS = 20
#: ``witness_case``'s gate: at each of these quantiles of the rows (the
#: float64 run finite), the kernel's distance to the float64 run in
#: STATE_TOL units within STATE_TOL (1) or at most WITNESS_FACTOR times
#: the largest of the float32 plain version's three body orders'
WITNESS_QUANTILES = (0.5, 0.9, 0.99)
WITNESS_FACTOR = 2.0
#: the branch variants of (e): label, SimConfig fields, the multi-step
#: kernel's policy and gradient mode
SLOT_VARIANTS = (("refl", dict(use_soft_barrier=False), "reflection",
                  "exact"),
                 ("ref", dict(eps_grad_mode="reference"), "soft",
                  "reference"))


def slot_rows(label, ref, df, rows):
    """Phase 25 (a) and (b): ``df``'s rows held to ``ref``'s on the same
    systems (``rows`` of ``ref``): every column of TOL but is_stable
    within its tolerance, is_stable agreeing on at least LABEL_GATE of
    the rows (both gated); the rows that differ at all in any column the
    two frames share, printed.  Returns (rows not bitwise, is_stable
    agreement)."""
    n = len(df)
    ref = ref.iloc[rows].reset_index(drop=True)
    df = df.reset_index(drop=True)
    differ, by_col = np.zeros(n, bool), {}
    for col in ref.columns.intersection(df.columns):
        a, b = ref[col].to_numpy(), df[col].to_numpy()
        d = ~((a == b) | (pd_isnan(a) & pd_isnan(b)))
        differ |= d
        if d.any():
            by_col[col] = int(d.sum())
    outside = {}
    for col, (rtol, atol) in TOL.items():
        if col != "is_stable":
            o = _outside(ref[col].to_numpy(float), df[col].to_numpy(float),
                         rtol, atol)
            if o.any():
                outside[col] = int(o.sum())
    agree = float((ref["is_stable"].to_numpy(bool)
                   == df["is_stable"].to_numpy(bool)).mean())
    print(f"  {label}: {n} rows; {int(differ.sum())} not bitwise the N = "
          f"{N_SLOTS} tail-off run's in some column (rows by column: "
          f"{by_col or 'none'}); columns outside TOL {outside or 'none'}; "
          f"is_stable agrees on {agree:.4f} (gated >= {LABEL_GATE})",
          flush=True)
    if outside:
        raise SystemExit(f"{label}: columns outside TOL of the N = "
                         f"{N_SLOTS} run: {outside}")
    if agree < LABEL_GATE:
        raise SystemExit(f"{label}: is_stable agrees on {agree:.4f}")
    return int(differ.sum()), agree


def slot_run(label, fns, *args, **kw):
    """``analyze_population(*args, **kw)`` with the launch counts of
    ``fns`` set to 0 just before and read just after (each gated > 0),
    on the fused engine alone (gated): (frame, seconds, launches,
    timing_out)."""
    from nbodysimproject_tpu_torch import analyze_population

    reset_counts(*fns)
    tm = {}
    t0 = time.perf_counter()
    df = analyze_population(*args, timing_out=tm, show_progress=False, **kw)
    secs = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in fns}
    print(f"  {label}: {secs:.3f}s ({len(df) / secs:.1f} systems/s), "
          f"launches {launches}, fused call {tm['fused_ms']:.1f} ms",
          flush=True)
    if not all(launches.values()) or tm["engine"] != "fused" \
            or tm["scan_lanes"]:
        raise SystemExit(f"{label}: not every kernel launched on the fused "
                         f"engine: {launches}, {tm}")
    return df, secs, launches, tm


def slot_entries(tag, n, d, cases, launches, share=None):
    """The report's entries of rows 1 and 2 at (n, d) from a compare
    case (``compare_case``) and a run's launches."""
    out = []
    for kind, line in (("analysis", 565), ("megno", 770)):
        ms, plain_ms, err, ns, steps, msteps, nsm, sh = cases[kind]
        b_ms, b_by = bound(kind, ns, nsm, steps, msteps, n, d,
                           sh if share is None else share)
        out.append({
            "name": f"hamsoft_{kind}_multistep {tag}", "route": "cuda",
            "source": "nbodysimproject_tpu_torch/csrc/hamsoft.cu",
            "replaces": f"nbodysimproject_tpu/ops/pallas_hamsoft.py:{line}",
            "launches": launches[f"hamsoft_{kind}_multistep"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return out


def multistep_entry(tag, c, launches):
    return {"name": f"hamsoft_multistep {tag}", "route": "cuda",
            "source": "nbodysimproject_tpu_torch/csrc/hamsoft_multistep.cu",
            "replaces": "nbodysimproject_tpu/ops/pallas_hamsoft.py:508",
            "launches": launches, "max_abs_err": c["err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
            "bound_by": c["bound"][1], "library_ms": None}


def shallow_case(label, st, dy, n_sub_raw, cfg, hk, tangent_of, steps):
    """Rows 1-2 against their plain versions (``compare_case``, widened
    by the plain version's own rounding sensitivity) on the B_CMP
    shallowest systems at ``steps`` steps; returns (case, lanes)."""
    from nbodysimproject_tpu_torch.analysis.fused import analyze_batch_fused

    n_sub = np.minimum(n_sub_raw, cfg.analysis_n_sub_cap)
    lanes = np.argsort(n_sub, kind="stable")[:B_CMP]
    t0 = time.perf_counter()
    case = compare_case(label, st, dy, cfg,
                        torch.as_tensor(lanes, device=st.pos.device),
                        steps, max(1, int(n_sub[lanes].max())), hk,
                        analyze_batch_fused, tangent_of, True)
    print(f"  {label} done in {time.perf_counter() - t0:.1f}s", flush=True)
    return case, lanes


def witness_case(label, st, dy, n_sub_raw, cfg, hk, tangent_of, steps,
                 one_thread=False, gate=True):
    """Rows 1-2 on the B_CMP shallowest systems at ``steps`` steps and
    steps // 2 MEGNO steps, held two ways.  Exactly: each kernel's final
    (pos, vel, eps, pi) bit for bit the multi-step kernel's over the same
    trips (the kernels share one trip), and with ``one_thread`` that
    bit for bit the multi-step kernel's one-thread layout.  Against the
    float64 plain multi-step run from the same start: the kernel's
    distance in STATE_TOL units (``tol_units``, the larger of the two
    stages) at WITNESS_QUANTILES within STATE_TOL or no worse than
    WITNESS_FACTOR times the float32 plain version's in three body orders (as given, reversed,
    rolled by 3), and the kernel non-finite only on rows where the
    float64 run or a float32 plain order is too.  Prints what it finds,
    and the tolerances' own verdict on the plain version against itself
    reordered; with ``gate``, fails on any of these.  Returns the
    figures."""
    from nbodysimproject_tpu_torch.analysis.fused import (
        _kernel_policy, analyze_batch_fused)

    dev = st.pos.device
    n_sub = np.minimum(n_sub_raw, cfg.analysis_n_sub_cap)
    lanes = np.argsort(n_sub, kind="stable")[:B_CMP]
    nsm = max(1, int(n_sub[lanes].max()))
    ix = torch.as_tensor(lanes, device=dev)
    st, dy = st.take(ix), dy.take(ix)
    msteps = min(100, min(50, steps // 2))
    t0 = time.perf_counter()
    ta, tm = Timed(hk.hamsoft_analysis_multistep), Timed(
        hk.hamsoft_megno_multistep)
    analyze_batch_fused(st, dy, cfg, steps, DT, "full", nsm, msteps,
                        tangent=tangent_of(st), g_static=1.0, analysis_fn=ta,
                        megno_fn=tm)
    conf = dict(G=1.0, k_wall=float(cfg.k_wall), eta=float(cfg.eta),
                jcap=float(cfg.j_max_cap), bexp=int(cfg.barrier_exponent),
                policy=_kernel_policy(cfg), grad_mode=str(cfg.eps_grad_mode),
                lam_align=float(cfg.lambda_softening))

    def run(fn, s, y, **extra):
        """(the state after the analysis steps, after the MEGNO steps)"""
        nsub = torch.clamp_min(y.n_sub, 1)
        kw = dict(k_soft=y.k_soft, mu=y.mu_soft, alpha=y.alpha_run,
                  eps_min=y.min_softening, eps_max=y.max_softening,
                  h=DT / nsub.to(s.pos.dtype), n_sub=nsub, n_sub_max=nsm,
                  **conf, **extra)
        a = fn(s.pos, s.vel, s.mass, s.eps, s.pi, n_steps=steps, **kw)
        b = fn(*a[:2], s.mass, *a[2:4], n_steps=msteps, **kw)
        return tuple(a[:4]), tuple(b[:4])

    warp = run(hk.hamsoft_multistep, st, dy)
    exact = {"analysis kernel = multi-step kernel":
             same_bits(ta.out[:4], warp[0]),
             "MEGNO kernel = multi-step kernel": same_bits(tm.out[:4],
                                                           warp[1])}
    if one_thread:
        thread = run(hk.hamsoft_multistep, st, dy, one_thread=True)
        exact["warp layout = one-thread layout"] = (
            same_bits(warp[0], thread[0]) & same_bits(warp[1], thread[1]))
    R, n = len(lanes), st.pos.shape[1]
    perms = (None, torch.arange(n - 1, -1, -1, device=dev),
             torch.roll(torch.arange(n, device=dev), 3))
    tan = tangent_of(st)
    plain = run(hk.hamsoft_multistep_plain,
                _stacked(*(_permuted(st, tan, p)[0] for p in perms)),
                _stacked(*([dy] * len(perms))))
    orders = []
    for j, p in enumerate(perms):
        runs = []
        for stage in plain:
            x = tuple(t[j * R:(j + 1) * R] for t in stage)
            if p is not None:
                inv = torch.argsort(p)
                x = (x[0][:, inv], x[1][:, inv], x[2], x[3])
            runs.append(x)
        orders.append(runs)
    f64 = run(hk.hamsoft_multistep_plain, _double(st), _double(dy))
    units = lambda r, ref: torch.maximum(tol_units(r[0], ref[0]),
                                         tol_units(r[1], ref[1]))
    uk = units(warp, f64)
    up = [units(r, f64) for r in orders]
    fin64 = finite_rows(*f64)
    finp = [finite_rows(*r) for r in orders]
    fink = finite_rows(*warp)
    qs = torch.tensor(WITNESS_QUANTILES, dtype=torch.float64, device=dev)
    quant = lambda u: torch.quantile(torch.nan_to_num(u[fin64],
                                                      posinf=1e30), qs)
    qk, qp = quant(uk), torch.stack([quant(u) for u in up]).max(0).values
    unexplained = ~fink & fin64 & torch.stack(finp).all(0)
    self_parts = int((units(orders[1], orders[0]) > 1).sum())
    kern_parts = int((units(warp, orders[0]) > 1).sum())
    names = ("plain", "plain reversed", "plain rolled")
    out = {
        "steps": steps, "megno_steps": msteps, "n_sub_max": nsm,
        "exact": {k: int(v.sum()) for k, v in exact.items()},
        "outside": {"kernel": int((uk > 1).sum()),
                    **{nm: int((u > 1).sum()) for nm, u in zip(names, up)}},
        "quantiles": {"kernel": qk.tolist(), "plain orders": qp.tolist()},
        "non-finite": {"kernel": int((~fink).sum()),
                       "float64": int((~fin64).sum()),
                       **{nm: int((~f).sum()) for nm, f in zip(names, finp)}},
        "unexplained": int(unexplained.sum()), "self_parts": self_parts,
        "kernel_parts": kern_parts, "s": time.perf_counter() - t0}
    print(f"  {label}: {R} systems, {steps} + {msteps} MEGNO steps, "
          f"n_sub_max {nsm}; rows bit for bit (of {R}): {out['exact']}; "
          f"rows outside STATE_TOL of the float64 plain run "
          f"{out['outside']}; STATE_TOL units to it at quantiles "
          f"{WITNESS_QUANTILES}: kernel {[round(x, 3) for x in qk.tolist()]}"
          f", the plain orders' largest {[round(x, 3) for x in qp.tolist()]}"
          f" (gated <= 1 or {WITNESS_FACTOR}x); non-finite rows "
          f"{out['non-finite']}, the kernel's with float64 and every plain "
          f"order finite {out['unexplained']} (gated 0); the tolerances "
          f"alone part the plain version from itself reversed on "
          f"{self_parts} rows, from the kernel on {kern_parts}; "
          f"{out['s']:.1f}s", flush=True)
    failures = [k for k, v in exact.items() if int(v.sum()) != R]
    if bool(((qk > 1.0) & (qk > WITNESS_FACTOR * qp)).any()):
        failures.append("the distance to float64")
    if out["unexplained"]:
        failures.append("non-finite rows")
    if gate and failures:
        raise SystemExit(f"{label}: {failures}")
    return out


def drawn_population(B, counts, n_slots, d, seed, dev):
    """(mass, pos, vel, mask) of ``generate_population`` on the card: B
    systems of counts[0] to counts[1] bodies in ``n_slots`` slots, seeded."""
    from nbodysimproject_tpu_torch.generators.ic_generator import (
        generate_population, sample_body_counts)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = sample_body_counts(gen, B, counts, device=dev)
    return generate_population(gen, n, n_slots=n_slots, dim=d, device=dev)


def phase_slots(cfg_off, hk, dev, pop, df_off, tangent8, tangent_of, built):
    """Phase 25: the analysis, MEGNO and multi-step kernels at slot counts
    other than 3, 4 and 8 on the card.  Returns (report entries, the
    phase's figures)."""
    from nbodysimproject_tpu_torch import SimConfig
    from nbodysimproject_tpu_torch.analysis.batch import prepare_population
    from nbodysimproject_tpu_torch.ops import cuda_build
    from nbodysimproject_tpu_torch.parallel.batch_engine import build_batch

    t_phase = time.perf_counter()
    rows12 = (hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep)
    row3 = (hk.hamsoft_multistep,)
    entries, out = [], {}
    secs = [built[j][1] for j in SLOT_JOBS]
    print(f"  builds of this phase: {len(secs)}, made in phase 2, the "
          f"longest {max(secs):.1f}s")
    for job in SLOT_JOBS:
        src, n, d, *var = job
        occ = hk.occupancy(src, n, d, var[0] if var else "")
        print(f"    {cuda_build.job_name(job)}: " + "; ".join(
            f"{k}{'<' + f + '>' if f else ''} {r} registers, {sp} bytes "
            f"spilled" for k, f, r, sp in ptxas_entries(built[job][2]))
            + f"; shared bytes a block and resident warps an SM {occ}")
        if n <= 8:
            spill_gate(cuda_build.job_name(job), built[job][2], 2)

    (mass, pos, vel, mask), G, soft, min_soft = pop
    dr8, dv8 = tangent8
    kw = dict(G=G, softening=soft, min_softening=min_soft, dt=DT,
              n_steps=N_STEPS, mode="full")

    # (a) the dataset rows in 16 slots (mass 0, mask False), their N = 8
    # tangents padded alike
    k = SLOTS_PAD - N_SLOTS
    padn = lambda a: np.concatenate(
        [a, np.zeros(a.shape[:1] + (k,) + a.shape[2:], a.dtype)], 1)
    padt = lambda t: torch.cat([t, t.new_zeros(t.shape[:1] + (k,)
                                               + t.shape[2:])], 1)
    df16, s16, l16, tm16 = slot_run(
        f"(a) the {len(mass)} dataset rows in {SLOTS_PAD} slots", rows12,
        padn(mass), padn(pos), padn(vel), padn(mask), cfg_off,
        tangent=(padt(dr8), padt(dv8)), **kw)
    out["a"] = dict(s=s16, fused_ms=tm16["fused_ms"], launches=l16)
    out["a"]["differ"], out["a"]["agree"] = slot_rows(
        f"(a) {SLOTS_PAD} slots", df_off, df16, np.arange(len(mass)))
    del df16

    # (b) the rows whose bodies lie in their first 5 slots, cut to them
    ok = ~mask[:, SLOTS_CUT:].any(1)
    rows = np.nonzero(ok)[0]
    idx = torch.as_tensor(rows, device=dev)
    cut = lambda a: a[rows, :SLOTS_CUT]
    per = lambda a: a[rows] if np.ndim(a) else a
    print(f"  (b): {int((~ok).sum())} rows hold a body past slot "
          f"{SLOTS_CUT} and are left out", flush=True)
    df5, s5, l5, tm5 = slot_run(
        f"(b) {len(rows)} dataset rows in {SLOTS_CUT} slots", rows12,
        cut(mass), cut(pos), cut(vel), cut(mask), cfg_off,
        tangent=(dr8[idx, :SLOTS_CUT], dv8[idx, :SLOTS_CUT]),
        **dict(kw, G=per(G), softening=per(soft),
               min_softening=per(min_soft)))
    out["b"] = dict(s=s5, fused_ms=tm5["fused_ms"], launches=l5,
                    left_out=int((~ok).sum()))
    out["b"]["differ"], out["b"]["agree"] = slot_rows(
        f"(b) {SLOTS_CUT} slots", df_off, df5, rows)
    del df5
    st5, dy5, nsr5 = prepare_population(
        cut(mass), cut(pos), cut(vel), cut(mask), cfg_off, G=per(G),
        softening=per(soft), min_softening=per(min_soft), dt=DT, device=dev)
    case5 = bucket_cases(f"(b) N={SLOTS_CUT} ", st5, dy5, nsr5, cfg_off, hk,
                         tangent_of, which=("lowest",))[0][0]
    entries += slot_entries(f"N={SLOTS_CUT}", SLOTS_CUT, 2, case5, l5)
    del st5, dy5

    # (c) a drawn population of 9-16 bodies in 16 slots, every slot real
    # in its largest systems
    m, q, v, msk = drawn_population(SLOT_POP_B, SLOT_POP_COUNTS, SLOTS_PAD,
                                    2, SLOT_POP_SEED, dev)
    kc = dict(G=1.0, softening=0.05, dt=DT, mode="full")
    dfc, sc, lc, tmc = slot_run(
        f"(c) {SLOT_POP_B} drawn systems of {SLOT_POP_COUNTS[0]}-"
        f"{SLOT_POP_COUNTS[1]} bodies in {SLOTS_PAD} slots, "
        f"{SLOT_POP_STEPS} steps", rows12, m, q, v, msk, cfg_off,
        n_steps=SLOT_POP_STEPS, **kc)
    stc, dyc, nsrc = prepare_population(m, q, v, msk, cfg_off, G=1.0,
                                        softening=0.05, min_softening=0.0,
                                        dt=DT, device=dev)
    nsm = int(np.minimum(nsrc, cfg_off.analysis_n_sub_cap).max())
    msteps = min(100, min(50, SLOT_POP_STEPS // 2))
    finite = float(np.isfinite(dfc[list(TOL)].to_numpy(float)).all(1).mean())
    us = 1e3 * tmc["fused_ms"] / ((SLOT_POP_STEPS + msteps) * nsm)
    print(f"  (c): finite share {finite:.4f} (every column of TOL); the "
          f"deepest lane n_sub {nsm}: the fused call {tmc['fused_ms']:.1f} "
          f"ms = {us:.3f} us per trip of the deepest lane "
          f"({SLOT_POP_STEPS} + {msteps} MEGNO steps)", flush=True)
    out["c"] = dict(s=sc, fused_ms=tmc["fused_ms"], launches=lc,
                    finite=finite, us=us, nsm=nsm)
    del dfc
    case_c, low = shallow_case(f"(c) N={SLOTS_PAD}, the {B_CMP} shallowest",
                               stc, dyc, nsrc, cfg_off, hk, tangent_of,
                               SLOT_CMP_STEPS)
    entries += slot_entries(f"N={SLOTS_PAD}", SLOTS_PAD, 2, case_c, l16)
    out["c"]["witness"] = witness_case(
        f"(c) N={SLOTS_PAD}, the {B_CMP} shallowest, witness", stc, dyc,
        nsrc, cfg_off, hk, tangent_of, WITNESS_STEPS)
    _dfc3, _s, l3c, _tm = slot_run(
        f"(c) use_fused_metrics=False, {SLOT_SHORT_STEPS} steps", row3, m, q,
        v, msk, cfg_off.replace(use_fused_metrics=False),
        n_steps=SLOT_SHORT_STEPS, **kc)

    # (d) row 3 at N = 2 (one thread a system) and N = 16 (two lanes a
    # body), d = 2, against its plain version
    cfg_hs = SimConfig(integrator_mode="ham_soft", fast_float32=True)
    m2, q2, v2, msk2 = drawn_population(SLOT_PAIRS_B, (2, 2), 2, 2,
                                        SLOT_POP_SEED + 1, dev)
    f32 = lambda x: x.to(torch.float32)
    st2, dy2 = build_batch(f32(m2), f32(q2), f32(v2), msk2, cfg_hs, 1.0,
                           0.05, 0.0, DT)
    dy2 = dy2.replace(n_sub=torch.clamp_max(dy2.n_sub, HS_NSUB_CAP))
    c2 = compare_multistep(cfg_hs, st2, dy2, "soft", hk)
    _df2, _s, l2, _tm = slot_run(
        f"(d) {SLOT_PAIRS_B} drawn pairs, use_fused_metrics=False, "
        f"{SLOT_SHORT_STEPS} steps", row3, m2, q2, v2, msk2,
        cfg_off.replace(use_fused_metrics=False), n_steps=SLOT_SHORT_STEPS,
        **kc)
    lowt = torch.as_tensor(low, device=dev)
    c16 = compare_multistep(cfg_hs, stc.take(lowt), dyc.take(lowt), "soft",
                            hk)
    entries += [multistep_entry("N=2", c2, l2["hamsoft_multistep"]),
                multistep_entry(f"N={SLOTS_PAD}", c16,
                                l3c["hamsoft_multistep"])]
    del stc, dyc, st2, dy2

    # (e) rows 1-3 at N = 16, d = 3, under the reflection fold and the
    # "reference" gradient, on a drawn population's lowest bucket
    m3, q3, v3, msk3 = drawn_population(SLOT_POP3_B, SLOT_POP_COUNTS,
                                        SLOTS_PAD, 3, SLOT_POP_SEED + 2, dev)
    st3, dy3, nsr3 = prepare_population(m3, q3, v3, msk3, cfg_off, G=1.0,
                                        softening=0.05, min_softening=0.0,
                                        dt=DT, device=dev)
    out["e"] = {}
    for label, over, policy, grad in SLOT_VARIANTS:
        cfg_v = cfg_off.replace(**over)
        case_v, low3 = shallow_case(
            f"(e) N={SLOTS_PAD} d=3 {label}, the {B_CMP} shallowest", st3,
            dy3, nsr3, cfg_v, hk, tangent_of, SLOT_VARIANT_STEPS)
        wit = witness_case(
            f"(e) N={SLOTS_PAD} d=3 {label}, the {B_CMP} shallowest, "
            f"witness", st3, dy3, nsr3, cfg_v, hk, tangent_of, WITNESS_STEPS)
        low3 = torch.as_tensor(low3, device=dev)
        cv = compare_multistep(cfg_hs.replace(**over), st3.take(low3),
                               dy3.take(low3), policy, hk, grad)
        _d, _s, lv, _tm = slot_run(
            f"(e) {label}: {SLOT_POP3_B} drawn 3-D systems, "
            f"{SLOT_SHORT_STEPS} steps", rows12, m3, q3, v3, msk3, cfg_v,
            n_steps=SLOT_SHORT_STEPS, **kc)
        _d, _s, lv3, _tm = slot_run(
            f"(e) {label}, use_fused_metrics=False", row3, m3, q3, v3, msk3,
            cfg_v.replace(use_fused_metrics=False),
            n_steps=SLOT_SHORT_STEPS, **kc)
        tag = f"N={SLOTS_PAD} d=3 {label}"
        entries += slot_entries(tag, SLOTS_PAD, 3, case_v, lv)
        entries.append(multistep_entry(tag, cv, lv3["hamsoft_multistep"]))
        out["e"][label] = (case_v, cv, wit)
    out["s"] = time.perf_counter() - t_phase
    print(f"  the slot counts' phase {out['s']:.1f}s")
    return entries, out


# ------------------------------------------------------- the scan route
#: the runs of the scan route on the dataset rows: label, the changes to
#: _PIPE_CFG, n_steps; each is one cold run.  The dataset's 1000 steps
#: are cut for the time limit, by route: the eager scan is bound by its
#: launches, and each macro step runs the deepest lane's 256 trips (on
#: an H100, ~2.4 s a macro step for the float32 ham_soft scan, ~6.7 s
#: for the float64 one, whose eps* solve is autograd's, ~8.2 s for
#: WHFast's adaptive Kepler solver at up to 33 trips); 2 steps is the
#: least that runs the MEGNO continuation (one step), 20 the least the
#: probe runs at
SCAN_ROUTES = (
    ("use_fused_analysis=False", dict(use_fused_analysis=False), 2),
    ("float64", dict(fast_float32=False), 2),
    ("verlet", dict(integrator_mode="verlet"), 100),
    ("whfast", dict(integrator_mode="whfast"), 2),
    ("use_fused_megno=False", dict(use_fused_megno=False), 2),
    ("early-exit probe", dict(early_exit_probe=0.1), 100),
)
#: the card against the same port on the CPU: the first SCAN_CPU_ROWS
#: rows of the population whose frozen n_sub is at most SCAN_CPU_NSUB (on
#: the CPU the scan is bound by its operations' dispatch too, and the
#: first 256 rows hold lanes at n_sub 256, whose trips would set every
#: route's time), at SCAN_CPU_STEPS steps, under each route above (the probe
#: with early_exit_min_n_sub lowered to SCAN_CPU_PROBE_NSUB, so that
#: these rows are probed), mode "minimal" and per-system G
SCAN_CPU_ROWS = 256
SCAN_CPU_NSUB = 4
SCAN_CPU_STEPS = 20
SCAN_CPU_PROBE_NSUB = 2
#: steps of the grouping measurement: the float32 ham_soft scan's lanes
#: in one call against one call per n_sub bucket of the ladder
SCAN_GROUP_STEPS = 1
#: per-system G of that comparison: a seeded numpy draw in this range
SCAN_G_RANGE = (0.9, 1.1)
#: float64 rows, card against CPU: relative 1e-9 and, for the drift
#: columns (differences of O(1) quantities, O(1e-16) absolute error on
#: values that may be near 0), absolute 1e-12; a row outside it is
#: allowed only where the CPU's own run on reversed body slots (every
#: sum in another order) lies outside it too: a chaotic row amplifies
#: the card's FMA roundings to ~1e-8 in 30 steps (one of the 256 rows
#: on an H100), as it does the reordered sums
F64_TOL = (1e-9, 1e-12)


def scan_route_run(label, cfg_r, pop, kw, hk, ek):
    """One cold run of ``analyze_population`` under ``cfg_r`` on the
    phase's population: systems/s, ``timing_out``'s phases and lanes
    per engine, the launches of rows 1, 2 and 4 read around it."""
    from nbodysimproject_tpu_torch import analyze_population

    counted = (hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep,
               ek.eps_star_and_grad_fused)
    reset_counts(*counted)
    tm = {}
    t0 = time.perf_counter()
    df = analyze_population(*pop, cfg_r, timing_out=tm, **kw)
    s = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counted}
    B = len(df)
    print(f"  {label}: {s:.3f}s = {B / s:.1f} systems/s; lanes fused "
          f"{tm['fused_lanes']}, scan {tm['scan_lanes']}, tail "
          f"{tm['n_tail']}, probed {tm['probe_lanes']}, aborted "
          f"{tm['n_early_exit']}; device ms fused {tm['fused_ms']:.1f}, "
          f"scan {tm['scan_ms']:.1f}, tail {tm['tail_ms']:.1f}, probe "
          f"{tm['probe_ms']:.1f}; launches {launches}; phases "
          f"{ {k: v for k, v in tm.items() if k.endswith('_s')} }",
          flush=True)
    if tm["fused_lanes"] + tm["scan_lanes"] + tm["n_tail"] \
            + tm["n_early_exit"] != B:
        raise SystemExit(f"{label}: the lanes do not add up: {tm}")
    check_output(df, label)
    return df, dict(s=s, tm=tm, launches=launches)


def scan_route_cpu(label, cfg_r, pop, G, soft, min_soft, mode, n_sub_raw):
    """The first SCAN_CPU_ROWS rows with n_sub <= SCAN_CPU_NSUB at
    SCAN_CPU_STEPS steps on the card and on the CPU (the kernels' plain
    versions), the same tangents: float64 within F64_TOL with is_stable
    equal, a row outside it allowed only where the CPU's run on reversed
    body slots lies outside it too; float32 is_stable
    agreement gated at LABEL_GATE and the rows outside TOL counted,
    allowed only where the CPU's own float32 run lies outside TOL of its
    float64 run (the row's rounding sensitivity), and on at most
    MAX_WIDENED others."""
    from nbodysimproject_tpu_torch import analyze_population
    from nbodysimproject_tpu_torch.analysis.batch import prepare_population
    from nbodysimproject_tpu_torch.diagnostics.megno import (
        init_tangent, population_normals)

    rows = np.nonzero(n_sub_raw <= SCAN_CPU_NSUB)[0][:SCAN_CPU_ROWS]
    sub = tuple(a[rows] for a in pop)
    g = G[rows] if np.ndim(G) else G
    kw = dict(G=g, softening=soft[rows], min_softening=min_soft[rows],
              dt=DT, n_steps=SCAN_CPU_STEPS, mode=mode, show_progress=False)
    f64 = not cfg_r.fast_float32
    dtype = torch.float64 if f64 else torch.float32

    def tangent(dt_):
        st, _dy, _ns = prepare_population(
            *sub, cfg_r.replace(fast_float32=dt_ == torch.float32), G=g,
            softening=soft[rows], min_softening=min_soft[rows], dt=DT,
            device=torch.device("cpu"))
        z1, z2 = population_normals(5, len(rows), tuple(sub[1].shape[1:]),
                                    dt_)
        return init_tangent(z1, z2, st)

    tan = tangent(dtype)
    t0 = time.perf_counter()
    card = analyze_population(*sub, cfg_r, tangent=tan, **kw)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = analyze_population(*sub, cfg_r, tangent=tan, device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    cols = [c for c in TOL if c in cpu.columns]
    a_st = card["is_stable"].to_numpy()
    b_st = cpu["is_stable"].to_numpy()
    agree = float((a_st == b_st).mean())
    worst = 0.0
    if f64:
        rtol, atol = F64_TOL
        bad = np.zeros(len(rows), bool)
        why = {}
        for c in cols:
            a, b = cpu[c].to_numpy(float), card[c].to_numpy(float)
            o = _outside(a, b, rtol, atol)
            bad |= o
            if o.any():
                why[c] = int(o.sum())
            fin = np.isfinite(a) & np.isfinite(b)
            worst = max(worst, float(np.abs(a[fin] - b[fin]).max(
                initial=0.0)))
        sens = np.zeros(len(rows), bool)
        if bad.any():
            # the CPU's own float64 rounding sensitivity: its run on the
            # body slots reversed (every sum in another order)
            rev = slice(None, None, -1)
            cpu_rev = analyze_population(
                *(a[:, rev] for a in sub), cfg_r, device="cpu",
                tangent=(tan[0].flip(1), tan[1].flip(1)), **kw)
            for c in cols:
                sens |= _outside(cpu[c].to_numpy(float),
                                 cpu_rev[c].to_numpy(float), rtol, atol)
        other = int((bad & ~sens).sum())
        print(f"  card against CPU, {label} (float64, {len(rows)} rows, "
              f"{SCAN_CPU_STEPS} steps): card {t_card:.2f}s, CPU "
              f"{t_cpu:.2f}s; rows outside F64_TOL {int(bad.sum())} "
              f"(by column {why}; n_sub "
              f"{n_sub_raw[rows][bad].tolist()}), {other} of them where "
              f"the CPU's run on reversed body slots lies within F64_TOL "
              f"of it; is_stable agrees on {agree:.4f}, largest "
              f"|card - CPU| {worst:.3e}", flush=True)
        if other or agree < 1.0:
            raise SystemExit(f"scan route {label}: float64 card and CPU "
                             f"differ on {other} rounding-stable rows, "
                             f"is_stable {agree:.4f}")
        return dict(card_s=t_card, cpu_s=t_cpu, outside=int(bad.sum()),
                    other=other, agree=agree)
    out = np.zeros(len(rows), bool)
    for c in cols:
        rtol, atol = TOL[c]
        a, b = cpu[c].to_numpy(float), card[c].to_numpy(float)
        out |= _outside(a, b, rtol, atol)
        fin = np.isfinite(a) & np.isfinite(b)
        worst = max(worst, float(np.abs(a[fin] - b[fin]).max(initial=0.0)))
    sens = np.zeros(len(rows), bool)
    if out.any():
        # the CPU's own float32 rounding sensitivity: its float64 run of
        # the same route and tangents
        cpu64 = analyze_population(
            *sub, cfg_r.replace(fast_float32=False), device="cpu",
            tangent=tangent(torch.float64), **kw)
        for c in cols:
            rtol, atol = TOL[c]
            sens |= _outside(cpu64[c].to_numpy(float), cpu[c].to_numpy(float),
                             rtol, atol)
    other = int((out & ~sens).sum())
    print(f"  card against CPU, {label} (float32, {len(rows)} rows, "
          f"{SCAN_CPU_STEPS} steps): card {t_card:.2f}s, CPU {t_cpu:.2f}s; "
          f"rows outside TOL {int(out.sum())}, {other} of them (at most "
          f"{MAX_WIDENED}) where the CPU's float32 run lies within TOL of "
          f"its float64 run; is_stable agrees on {agree:.4f} (gated >= "
          f"{LABEL_GATE}), largest |card - CPU| {worst:.3e}", flush=True)
    if agree < LABEL_GATE or other > MAX_WIDENED:
        raise SystemExit(f"scan route {label}: card and CPU disagree "
                         f"(is_stable {agree:.4f}, {other} rows outside TOL)")
    return dict(card_s=t_card, cpu_s=t_cpu, outside=int(out.sum()),
                other=other, agree=agree)


def scan_grouping(cfg, states, dyns, n_sub_raw, sel):
    """The float32 ham_soft scan's lanes (all but the tail's) in one call
    against one call per n_sub bucket of the ladder (the JAX package's
    grouping), core mode, SCAN_GROUP_STEPS steps: seconds of each, the
    host clock around them after a sync."""
    from nbodysimproject_tpu_torch.analysis.batch import (
        _bucket_ladder_values, _n_sub_cap)
    from nbodysimproject_tpu_torch.analysis.stability import analyze_batch

    cfg_u = cfg.replace(use_fused_analysis=False)
    idx = np.nonzero(~sel)[0]
    ns = np.minimum(n_sub_raw, _n_sub_cap(cfg))
    b = _bucket_ladder_values(ns[idx])

    def run(groups):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in groups:
            lanes = torch.as_tensor(g, device=states.pos.device)
            nsm = int(ns[g].max())
            analyze_batch(states.take(lanes), dyns.take(lanes), cfg_u,
                          SCAN_GROUP_STEPS, DT, "core", nsm, 0, trips=nsm)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    one = run([idx])
    ladder = run([idx[b == v] for v in np.unique(b)])
    print(f"  grouping of the scan's {len(idx)} lanes ({SCAN_GROUP_STEPS} "
          f"step, core): one call {one:.3f}s, one call per ladder bucket "
          f"({len(np.unique(b))} calls) {ladder:.3f}s", flush=True)
    return one, ladder


def phase_scan_route(cfg, hk, ek, pop, G, soft, min_soft, prepared, sel):
    """Phase 22: analyze_population's scan route on the dataset rows."""
    from nbodysimproject_tpu_torch import analyze_population

    t_phase = time.perf_counter()
    states, dyns, n_sub_raw = prepared
    kw = dict(G=G, softening=soft, min_softening=min_soft, dt=DT,
              mode="full", show_progress=False)
    out = {"runs": {}}
    df_p = None
    for label, change, steps in SCAN_ROUTES:
        df, out["runs"][label] = scan_route_run(
            label, cfg.replace(**change), pop, dict(kw, n_steps=steps), hk,
            ek)
        out["runs"][label]["steps"] = steps
        if label == "early-exit probe":
            df_p, probe_steps = df, steps
        del df
        torch.cuda.empty_cache()
    runs = out["runs"]
    la = {k: v["launches"] for k, v in runs.items()}
    row_1, row_2, row_4 = ("hamsoft_analysis_multistep",
                           "hamsoft_megno_multistep",
                           "eps_star_and_grad_fused")
    scans = ("use_fused_analysis=False", "float64", "verlet", "whfast")
    gates = {
        "row 4 on the float32 ham_soft scan":
            la["use_fused_analysis=False"][row_4] > 0,
        "row 4 off the float64 and classical runs":
            all(la[k][row_4] == 0 for k in ("float64", "verlet", "whfast")),
        "rows 1 and 2 off the scan runs":
            all(la[k][row_1] == 0 and la[k][row_2] == 0 for k in scans),
        "the scan runs' lanes on the scan engine":
            all(runs[k]["tm"]["engine"] == "scan"
                and runs[k]["tm"]["fused_lanes"] == 0 for k in scans),
        "row 1 on the probe and use_fused_megno=False runs":
            la["early-exit probe"][row_1] > 0
            and la["use_fused_megno=False"][row_1] > 0,
        "row 2 off the use_fused_megno=False run":
            la["use_fused_megno=False"][row_2] == 0,
        "the probe probed": runs["early-exit probe"]["tm"]["probe_lanes"] > 0,
    }
    print(f"  gates: {gates}")
    failed = [k for k, v in gates.items() if not v]
    if failed:
        raise SystemExit(f"scan route: {failed}")
    # the probe's survivors against a fused run at the same steps without
    # the probe, and that run against the same with the tail after the
    # fused call on the same stream (the side stream changes no row)
    kw_p = dict(kw, n_steps=probe_steps)
    t0 = time.perf_counter()
    df_f = analyze_population(*pop, cfg, **kw_p)
    t_fused = time.perf_counter() - t0
    t0 = time.perf_counter()
    df_s = analyze_population(*pop, cfg, tail_stream=False, **kw_p)
    t_serial = time.perf_counter() - t0
    early = df_p["early_exit"].to_numpy(bool)
    keep = ~early
    differ = [c for c in df_f.columns if not np.array_equal(
        df_f[c].to_numpy()[keep], df_p[c].to_numpy()[keep],
        equal_nan=df_f[c].dtype.kind == "f")]
    drift = df_p["energy_drift"].to_numpy(float)[early]
    with np.errstate(invalid="ignore"):
        bad_abort = int((np.isfinite(drift) & (np.abs(drift) <= 10.0)).sum())
    chaos_nan = bool(np.isnan(df_p.loc[early, list(MEGNO_COLS)].to_numpy(
        float)).all())
    side = [c for c in df_f.columns if not np.array_equal(
        df_f[c].to_numpy(), df_s[c].to_numpy(),
        equal_nan=df_f[c].dtype.kind == "f")]
    print(f"  the fused run without the probe ({probe_steps} steps) "
          f"{t_fused:.3f}s ({len(df_f) / t_fused:.1f} systems/s), the tail "
          f"after it on the same stream {t_serial:.3f}s "
          f"({len(df_f) / t_serial:.1f} systems/s); {int(keep.sum())} "
          f"survivors bitwise equal to it: {not differ}; {int(early.sum())} "
          f"aborted rows, {bad_abort} of them with a finite drift <= 10, "
          f"their chaos columns NaN: {chaos_nan}; side stream and same "
          f"stream equal: {not side}", flush=True)
    if differ or bad_abort or not chaos_nan or side:
        raise SystemExit(f"scan route: probe survivors differ in {differ}, "
                         f"{bad_abort} aborted rows below the threshold, "
                         f"chaos NaN {chaos_nan}, side stream {side}")
    out.update(fused_s=t_fused, serial_s=t_serial, aborted=int(early.sum()),
               probe_steps=probe_steps)
    del df_p, df_f, df_s
    torch.cuda.empty_cache()
    out["grouping"] = scan_grouping(cfg, states, dyns, n_sub_raw, sel)
    # the card against the port on the CPU
    g_rows = np.random.default_rng(22).uniform(*SCAN_G_RANGE, len(G))
    cpu_cases = [(label, cfg.replace(**change), G, "full")
                 for label, change, _steps in SCAN_ROUTES]
    cpu_cases = [(label, c.replace(early_exit_min_n_sub=SCAN_CPU_PROBE_NSUB)
                  if c.early_exit_probe else c, g, mode)
                 for label, c, g, mode in cpu_cases]
    cpu_cases += [("minimal", cfg, G, "minimal"),
                  ("per-system G", cfg, g_rows, "full")]
    out["cpu"] = {label: scan_route_cpu(label, c, pop, g, soft, min_soft,
                                        mode, n_sub_raw)
                  for label, c, g, mode in cpu_cases}
    out["s"] = time.perf_counter() - t_phase
    print(f"  the scan route's phase {out['s']:.1f}s")
    return out


# ------------------------------------------------------------- the facade
#: the golden scenarios of tests/test_golden_regression.py (phase 23 (a)):
#: inputs, horizon, and the end state pinned there with its tolerances
GOLDEN_VERLET = dict(
    sim=dict(integrator_mode="verlet", softening=1e-3, masses=[1.0, 0.5, 0.1],
             positions=[[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]],
             velocities=[[0.0, 0.0], [0.0, 1.0], [-0.5, 0.0]]),
    steps=1000, pos=[[-0.35175328, -0.29241702], [0.51360617, -0.34556418],
                     [5.94950188, 6.65199117]], pos_tol=(1e-6, 1e-8))
GOLDEN_HAMSOFT = dict(
    sim=dict(integrator_mode="ham_soft", softening=0.05,
             masses=[1.0, 1.0, 0.5],
             positions=[[-0.6, 0.05], [0.55, -0.02], [9.2, 0.3]],
             velocities=[[0.0, -0.7], [0.0, 0.72], [0.02, 0.5]]),
    steps=100, pos=[[-0.29568652, -0.65048405], [0.24357825, 0.48475306],
                    [9.20421653, 0.69146197]], pos_tol=(1e-5, 1e-7),
    eps=(0.18630140060382266, 1e-6), pi=(124.92173161726738, 1e-3),
    H=(652.3749602929558, 1e-4))
#: (b): the macro steps of each fast-mode run through ``run`` (one host
#: read at the end), where it is held to the CPU's float32 run: the
#: golden ham_soft system to its golden horizon (it turns non-finite
#: near step 110, after the barrier bounce at step 96, in float32 and
#: float64 alike), the ring to 1000
FACADE_RUNS = {"golden ham_soft": 100, "ring7": 1000}
#: (b): ``step`` calls timed on a twin of each run (the JAX facade's
#: per-step host reads: the softening ledger, the schedule check)
FACADE_STEP_CALLS = 50
FACADE_DT = 0.01
#: the ring's body count (the eps kernel's build at this N is one of
#: ``facade_eps_jobs``)
FACADE_RING_N = 7
#: (c): the hierarchical triple's scale (positions times it, velocities
#: over its square root: one substep a step, against two unscaled, so a
#: step costs 12-13 ms on the card instead of 18-30) and the
#: StabilityAnalyzer's horizon (full mode, 50 MEGNO steps)
FACADE_TRIPLE_SCALE = 1.5
FACADE_SA_STEPS = 500
#: (d): the sim-list view's simulations (a facade construction takes
#: ~23 ms on the card, a B = 1 ``build_batch`` of ~500 launches), the
#: batch analyzer's depth (the view's 500 steps cut: the eager scan
#: runs the deepest lane's n_sub trips, up to 256, each macro step; 2
#: is the least with a MEGNO step), and the rows held to the CPU (the
#: first FACADE_CPU_ROWS with a frozen n_sub of at most FACADE_CPU_NSUB,
#: as phase 22 picks its CPU rows)
FACADE_BATCH = 256
FACADE_BATCH_STEPS = 2
FACADE_CPU_ROWS = 64
FACADE_CPU_NSUB = 4
#: (f): float64 ham_soft steps on the CPU before the snapshot, then on
#: the card after it
FACADE_SNAP_STEPS = 20
#: (b): the card against the CPU's float32 run, positions and energies
#: each an entry of ``row_gate`` (the CPU tests' float32 position
#: tolerance, (rtol, atol)), widened only on entries where the CPU's
#: float32 run on reversed body slots lies outside it too; the float64
#: run is no measure here: it parts from float32 by 23-127 in the golden
#: system's H_ext (pi's evolution under the pi budget), where two
#: float32 runs agree to 6e-8
TOL32_FACADE = (2e-5, 2e-6)
#: the CPU references of (b) and (c), computed by this script run as
#: child processes on the CPU during phase 2's builds (one a job), so
#: that no measured phase shares the host with them
FACADE_REF_JOBS = (("ring7",), ("ring7 reversed", "golden ham_soft",
                                "golden ham_soft reversed"),
                   ("triple d=2", "triple d=3"))
FACADE_REF = os.path.join(HERE, "nbodysimproject_tpu_torch", "_build",
                          "facade_cpu_ref{}.json")
#: energies of ``Diagnostics`` held in (b)
FACADE_ENERGIES = ("H_ext", "energy", "kinetic", "potential")


def facade_systems():
    """(masses, positions, velocities, keywords, d) of phase 23's
    systems, from numpy: the golden ham_soft system, a 7-body ring of
    radius 1.5 at its circular speed (``generate_equal_mass_polygon``; one
    substep a step; at half the speed the ring collapses and is chaotic
    within the 1000 steps: card and CPU part by O(1) there, as float32
    and float64 do), and a hierarchical triple (separation ratio 20,
    scaled by FACADE_TRIPLE_SCALE) at d = 2 and, tilted by a numpy draw
    (seed 3), at d = 3."""
    from nbodysimproject_tpu_torch import SpecializedGenerators as SG

    g = GOLDEN_HAMSOFT["sim"]
    out = {"golden ham_soft": (np.array(g["masses"]),
                               np.array(g["positions"]),
                               np.array(g["velocities"]),
                               dict(integrator_mode="ham_soft",
                                    softening=0.05), 2)}
    m, q, v = SG.generate_equal_mass_polygon(FACADE_RING_N, radius=1.5,
                                             rotation_fraction=1.0,
                                             device="cpu")
    out["ring7"] = (m, q, v, dict(integrator_mode="ham_soft",
                                  softening=0.05), 2)
    m, q, v = SG.generate_hierarchical_triple(separation_ratio=20.0,
                                              device="cpu")
    q, v = q * FACADE_TRIPLE_SCALE, v / np.sqrt(FACADE_TRIPLE_SCALE)
    kw = dict(integrator_mode="ham_soft", softening=0.05)
    out["triple d=2"] = (m, q, v, kw, 2)
    rng = np.random.default_rng(3)
    out["triple d=3"] = (m, np.concatenate([q, 0.05 * rng.normal(
        size=(3, 1))], 1), np.concatenate([v, 0.02 * rng.normal(
            size=(3, 1))], 1), kw, 3)
    return out


def facade_sim(label, fast, device, reverse=False):
    """A facade simulation of ``label`` (its bodies in reversed slots
    where ``reverse``)."""
    from nbodysimproject_tpu_torch import NBodySimulation, SimConfig

    m, q, v, kw, d = facade_systems()[label]
    if reverse:
        m, q, v = (np.ascontiguousarray(a[::-1]) for a in (m, q, v))
    return NBodySimulation(config=SimConfig(fast_float32=fast, dim=d),
                           masses=m, positions=q, velocities=v,
                           device=device, **kw)


def facade_eps_jobs(ek):
    """The eps kernel's builds phase 23 takes beyond ``ek.build_jobs()``:
    N = 2 to 8 at d = 2 (the ring's 7; the sim-list view's simulations
    at their own body counts, and its shallow rows' group)."""
    return [j for j in ((ek.SOURCE, n, 2) for n in range(2, 9))
            if j not in ek.build_jobs()]


def facade_energies(sim):
    from nbodysimproject_tpu_torch import Diagnostics

    dg = Diagnostics(sim)
    return {"kinetic": dg.kinetic_energy(), "potential": dg.potential_energy(),
            "energy": dg.energy(), "H_ext": dg.compute_extended_hamiltonian()}


def facade_held(sim, reverse=False):
    """(b)'s held entries of a simulation: its positions (in the original
    body order) and FACADE_ENERGIES."""
    pos = sim.pos[::-1] if reverse else sim.pos
    e = facade_energies(sim)
    return np.concatenate([np.ravel(pos), [e[k] for k in FACADE_ENERGIES]])


def facade_cpu_references(path, keys):
    """The CPU side of phase 23 (b) and (c) for ``keys``, written to
    ``path`` as JSON: a fast-mode run's held entries in float32 (" reversed":
    its bodies in reversed slots), or the StabilityAnalyzer's full-mode
    columns on a triple in float32."""
    from nbodysimproject_tpu_torch import StabilityAnalyzer

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = {}
    for key in keys:
        label = key.replace(" reversed", "")
        sim = facade_sim(label, True, "cpu", reverse=key != label)
        if label in FACADE_RUNS:
            sim.run(FACADE_DT, FACADE_RUNS[label])
            out[key] = facade_held(sim, reverse=key != label).tolist()
        else:
            out[key] = StabilityAnalyzer(
                sim, FACADE_SA_STEPS, FACADE_DT,
                mode="full").run_stability_analysis()
    out["s"] = time.perf_counter() - t0
    tmp = path + ".part"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, path)
    return 0


def start_facade_cpu_references():
    """This script in one child process on the CPU for each of
    FACADE_REF_JOBS; each stopped at exit if still running.  Returns
    [(process, output path)]."""
    import atexit

    procs = []
    os.makedirs(os.path.dirname(FACADE_REF), exist_ok=True)
    for i, keys in enumerate(FACADE_REF_JOBS):
        path = FACADE_REF.format(i)
        if os.path.exists(path):
            os.remove(path)
        log = open(path + ".log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--facade-cpu-references", path, *keys],
            stdout=log, stderr=subprocess.STDOUT, cwd=HERE), path))
        log.close()

    def stop():
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return procs


def wait_facade_cpu_references(procs):
    """The merged references of FACADE_REF_JOBS once every child is done
    (each job's seconds under "s <i>"), and the seconds waited."""
    t0 = time.perf_counter()
    ref = {}
    for i, (proc, path) in enumerate(procs):
        rc = proc.wait(timeout=600)
        if rc != 0 or not os.path.exists(path):
            raise SystemExit(f"the facade's CPU references failed (rc {rc}; "
                             f"{path}.log)")
        with open(path) as f:
            part = json.load(f)
        ref[f"s {i}"] = part.pop("s")
        ref.update(part)
    return ref, time.perf_counter() - t0


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_facade(ek, fk, dev, ref):
    """Phase 23: the object API on the card (``facade/``), (a)-(f) of the
    script's docstring, ``ref`` the CPU references of (b) and (c).
    Returns the phase's figures for the report."""
    from nbodysimproject_tpu_torch import (BatchStabilityAnalyzer, Diagnostics,
                                           MLTrainingPipeline, NBodySimulation,
                                           SimConfig, StabilityAnalyzer,
                                           largen_rollout)
    from nbodysimproject_tpu_torch.analysis.batch import (_group_generator,
                                                          stack_sims)
    from nbodysimproject_tpu_torch.diagnostics.megno import draw_tangent

    t_phase = time.perf_counter()
    out = {"eps_launches": 0, "eps_cases": []}
    count = lambda: int(ek.eps_star_and_grad_fused.launches)

    # (a) the two golden scenarios in float64: no kernel (the JAX dtype
    # rule), the golden end states
    for name, g in (("verlet", GOLDEN_VERLET), ("ham_soft", GOLDEN_HAMSOFT)):
        reset_counts(ek.eps_star_and_grad_fused)
        t0 = time.perf_counter()
        sim = NBodySimulation(device=dev, **g["sim"])
        sim.run(0.01, g["steps"])
        pos = sim.pos
        s = time.perf_counter() - t0
        d_pos = float(np.abs(pos - np.array(g["pos"])).max())
        ok = np.allclose(pos, g["pos"], rtol=g["pos_tol"][0],
                         atol=g["pos_tol"][1])
        line = f"  (a) golden {name} float64, {g['steps']} steps {s:.2f}s: " \
               f"|pos - golden| {d_pos:.3e}"
        if name == "ham_soft":
            # H_ext is 641 of 652 K_eps = pi^2 / (2 mu): the golden's pi
            # tolerance admits |dH| up to |pi| 1e-3 / mu, and round-off
            # grown through the barrier bounce at step 96 moves pi within
            # it (tests/test_torch_facade_golden.py)
            H = Diagnostics(sim).compute_extended_hamiltonian()
            mu = float(sim._dyn.mu_soft)
            d_e, d_pi, d_H = (abs(sim._epsilon - g["eps"][0]),
                              abs(sim._pi - g["pi"][0]), abs(H - g["H"][0]))
            H_tol = g["H"][1] + abs(sim._pi) * g["pi"][1] / mu
            ok = ok and d_e < g["eps"][1] and d_pi < g["pi"][1] \
                and d_H < H_tol
            line += (f", |eps - golden| {d_e:.3e}, |pi - golden| {d_pi:.3e},"
                     f" |H_ext - golden| {d_H:.3e} (held to {H_tol:.3e}; the "
                     f"golden's own 1e-4 met: {d_H < g['H'][1]})")
        print(line + f"; eps kernel launches {count()}", flush=True)
        if not ok or count() != 0:
            raise SystemExit(f"(a) golden {name}: outside its golden "
                             f"tolerances, or a float64 run launched the eps "
                             f"kernel ({count()})")

    # (b) fast mode: the eps kernel on every substep of run() and step()
    for label, steps in FACADE_RUNS.items():
        reset_counts(ek.eps_star_and_grad_fused)
        sim = facade_sim(label, True, dev)
        sync(dev)
        t0 = time.perf_counter()
        sim.run(FACADE_DT, steps)
        sync(dev)
        t_run = (time.perf_counter() - t0) / steps
        launches = count()
        n_sub = sim._frozen_n_sub
        twin = facade_sim(label, True, dev)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(FACADE_STEP_CALLS):
            twin.step(FACADE_DT)
        sync(dev)
        t_step = (time.perf_counter() - t0) / FACADE_STEP_CALLS
        out["eps_launches"] += count()
        want = steps * (n_sub + 1)
        print(f"  (b) {label} fast mode (N={sim.n_bodies}, n_sub {n_sub}): "
              f"run({steps}) {1e3 * t_run:.3f} ms a step, "
              f"{FACADE_STEP_CALLS} step() calls {1e3 * t_step:.3f} ms a step "
              f"(the per-step host reads {1.0 - t_run / t_step:.3f} of a "
              f"step() call); eps kernel launches in run() {launches} "
              f"(want {want})", flush=True)
        if launches != want:
            raise SystemExit(f"(b) {label}: eps launches {launches}, want "
                             f"{want}")
        # positions and energies against the CPU's float32 run, entries as
        # rows, its run on reversed body slots as the sensitivity
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))[:, None]
        card, cpu = f64(facade_held(sim)), f64(ref[label])
        rev = f64(ref[f"{label} reversed"])
        row_gate(f"(b) {label}: card against the CPU's float32 run at step "
                 f"{steps}, positions and {', '.join(FACADE_ENERGIES)}",
                 {"q, E": (card, cpu, rev, rev, TOL32_FACADE)},
                 max_widened=0, against="its run on reversed body slots")
        out[label] = dict(run_ms=1e3 * t_run, step_ms=1e3 * t_step,
                          sync_share=1.0 - t_run / t_step, launches=launches,
                          n_sub=n_sub)
        # the eps kernel against its plain version at this B = 1 shape, on
        # the held (finite) state, with the facade's clamp (the soft
        # policy's): these systems' bodies lie outside each other's SPH
        # support, so their eps* gradient is 0 (B = 1 rows with a nonzero
        # gradient are held in (d))
        case = compare_eps(f"facade {label} B=1", sim._state, sim._dyn, True,
                           ek)
        out["eps_cases"].append(case)
        if label == "ring7":
            out["eps_case"] = case

    # (c) StabilityAnalyzer in full mode, fast mode, d = 2 and 3
    for label in ("triple d=2", "triple d=3"):
        reset_counts(ek.eps_star_and_grad_fused)
        sim = facade_sim(label, True, dev)
        t0 = time.perf_counter()
        got = StabilityAnalyzer(sim, FACADE_SA_STEPS, FACADE_DT,
                                mode="full").run_stability_analysis()
        s = time.perf_counter() - t0
        out["eps_launches"] += count()
        cpu = ref[label]
        diff = {k: abs(got[k] - cpu[k]) for k in VERDICT}
        print(f"  (c) StabilityAnalyzer {label}, full, {FACADE_SA_STEPS} "
              f"steps at n_sub {sim._frozen_n_sub}: {s:.2f}s, is_stable "
              f"{got['is_stable']} (CPU {cpu['is_stable']}), |card - CPU| "
              f"{ {k: f'{v:.3e}' for k, v in diff.items()} } (thresholds "
              f"{VERDICT}, the card's {({k: round(got[k], 6) for k in VERDICT})}"
              f"), eps kernel launches {count()}", flush=True)
        if got["is_stable"] != cpu["is_stable"] or count() == 0:
            raise SystemExit(f"(c) {label}: is_stable {got['is_stable']} on "
                             f"the card, {cpu['is_stable']} on the CPU, or no "
                             f"eps launch ({count()})")
        out[label] = dict(s=s)

    # (d) BatchStabilityAnalyzer on the sim-list view's simulations
    class Capture(BatchStabilityAnalyzer):
        def analyze_batch(self, simulations, show_progress=True,
                          tangent=None):
            self.sims = list(simulations)
            return super().analyze_batch(simulations, show_progress,
                                         tangent)

    reset_counts(ek.eps_star_and_grad_fused)
    pipe = MLTrainingPipeline(n_systems=FACADE_BATCH, seed=0, device=dev)
    pipe.batch_analyzer = Capture(FACADE_BATCH_STEPS, FACADE_DT, mode="full")
    t0 = time.perf_counter()
    df = pipe.generate_diverse_dataset()
    sync(dev)
    s_view = time.perf_counter() - t0
    view_launches = count()
    out["eps_launches"] += view_launches
    sims = pipe.batch_analyzer.sims
    missing = [c for c in list(TOL) + ["system_type", "n_sub"]
               if c not in df]
    if len(df) != FACADE_BATCH or missing \
            or not np.isfinite(df["is_stable"]).all():
        raise SystemExit(f"(d): {len(df)} rows, missing columns {missing}, "
                         f"or a non-finite is_stable")
    states, dyns = stack_sims(sims)
    n_slots = states.pos.shape[1]
    dr, dv = (t.cpu().numpy() for t in draw_tangent(_group_generator(0, 0),
                                                    states))
    # the eps kernel against its plain version at the view's shape, with
    # the soft policy's clamp (the view's) and without it (where the
    # gradient is not clamped to 0)
    for clamp in (True, False):
        out["eps_cases"].append(compare_eps(
            f"facade view B={FACADE_BATCH}", states, dyns, clamp, ek))
    # and at B = 1 on the view's own simulations whose eps* gradient is
    # nonzero (the view's simulations hold 8 slots, ``_PIPE_CFG``'s
    # bucket): the first of 3 bodies in its own 3 slots (the one-thread
    # layout, as a facade simulation of 3 bodies holds them) and the
    # first of more in its 8 (one lane a body)
    from types import SimpleNamespace

    g = ek.eps_star_and_grad_fused_plain(
        states.pos, states.mass, states.eps, dyns.alpha_run,
        dyns.min_softening, dyns.max_softening, states.mask, clamp=False,
        use_fallback=False, lam_align=LAMBDA_SOFTENING)[1]
    live = (g.abs().amax((1, 2)) > 0).cpu().numpy()
    picks = [next((i for i in range(len(sims)) if live[i]
                   and (sims[i].n_bodies <= 3) == small), None)
             for small in (True, False)]
    nonzero = 0
    for i in (p for p in picks if p is not None):
        st = sims[i]._state
        n = 3 if sims[i].n_bodies <= 3 else st.pos.shape[1]
        st = SimpleNamespace(pos=st.pos[:, :n], mass=st.mass[:, :n],
                             mask=st.mask[:, :n], eps=st.eps)
        for clamp in (True, False):
            c = compare_eps(f"facade view simulation {i} B=1", st,
                            sims[i]._dyn, clamp, ek)
            out["eps_cases"].append(c)
            nonzero += c["nonzero"]
    print(f"  (d) B = 1 eps cases with a nonzero gradient: simulations "
          f"{picks} (3 bodies in 3 slots, more in 8), nonzero gradient in "
          f"{nonzero} of their cases; {int(live.sum())} of {len(sims)} view "
          f"rows have one", flush=True)
    if nonzero == 0:
        raise SystemExit("(d): no B = 1 eps case with a nonzero gradient")

    # is_stable on shallow rows against the CPU: the same rows analysed
    # as one group on the card and, restored, on the CPU in float32 and
    # float64 (the same padding, trips and tangents on both); a row may
    # differ from the card only where the CPU's two precisions differ
    n_sub_all = df["n_sub"].to_numpy()
    rows = np.nonzero(n_sub_all <= FACADE_CPU_NSUB)[0][:FACADE_CPU_ROWS]
    k = max(sims[i].n_bodies for i in rows)
    tangent = [(dr[i][:k], dv[i][:k]) for i in rows]
    analyze = lambda group: BatchStabilityAnalyzer(
        FACADE_BATCH_STEPS, FACADE_DT, mode="full").analyze_batch(
        group, show_progress=False, tangent=tangent)
    before = count()
    on_card = analyze([sims[i] for i in rows])
    out["eps_launches"] += count() - before
    t0 = time.perf_counter()
    verdicts = {}
    for name, fast in (("float32", True), ("float64", False)):
        group = []
        for i in rows:
            snap = sims[i].snapshot()
            snap["cfg"] = snap["cfg"].replace(fast_float32=fast)
            group.append(NBodySimulation.restore(snap, device="cpu"))
        verdicts[name] = analyze(group)
    s_cpu = time.perf_counter() - t0
    card_v = on_card["is_stable"].to_numpy()
    c32, c64 = (verdicts[x]["is_stable"].to_numpy()
                for x in ("float32", "float64"))
    differ = np.nonzero(card_v != c32)[0]
    sensitive = c32 != c64
    away = int((~sensitive[differ]).sum())
    agree = float((card_v == c32).mean())
    for j in differ:
        print(f"    row {rows[j]}: is_stable card {card_v[j]}, CPU float32 "
              f"{c32[j]}, float64 {c64[j]}; " + ", ".join(
                  f"{c} {on_card[c].to_numpy()[j]:.6g} / "
                  f"{verdicts['float32'][c].to_numpy()[j]:.6g} / "
                  f"{verdicts['float64'][c].to_numpy()[j]:.6g} (threshold "
                  f"{t})" for c, t in VERDICT.items()))
    in_view = float((df["is_stable"].to_numpy()[rows] == card_v).mean())
    out["batch"] = dict(s=s_view, launches=view_launches, agree=agree,
                        n_sub_max=int(min(n_sub_all.max(), 256)))
    print(f"  (d) generate_diverse_dataset({FACADE_BATCH}) -> "
          f"BatchStabilityAnalyzer (full, {FACADE_BATCH_STEPS} steps): "
          f"{s_view:.2f}s, eps kernel launches {view_launches}, deepest "
          f"capped n_sub {out['batch']['n_sub_max']}; is_stable of "
          f"{len(rows)} rows (n_sub <= {FACADE_CPU_NSUB}, {k} slots) "
          f"analysed on the card against the CPU's float32 run {agree:.4f}, "
          f"{int(sensitive.sum())} rows whose CPU float32 and float64 "
          f"verdicts differ, {away} rows off the CPU away from them (gated "
          f"0; the CPU runs {s_cpu:.2f}s); the same rows' verdicts in the "
          f"view's {n_slots}-slot group the same in {in_view:.4f}",
          flush=True)
    if view_launches == 0 or away:
        raise SystemExit(f"(d): eps launches {view_launches}, is_stable off "
                         f"the CPU's on {away} rows where its precisions "
                         f"agree")

    # (e) the large-N branch on direct_pallas: bench_largen's 10^5 cloud
    N = 100_000
    q, m, v = largen_ics()[1][N]
    eps, steps = 6.0 / LN_NG[N], LN_ROLL_STEPS
    reset_counts(fk.pairwise_force)
    sim = NBodySimulation(config=SimConfig(force_mode="direct_pallas"),
                          masses=m, positions=q, velocities=v,
                          integrator_mode="verlet", softening=eps,
                          device=dev)
    sync(dev)
    t0 = time.perf_counter()
    sim.run(LN_ROLL_DT, steps)
    sync(dev)
    s = time.perf_counter() - t0
    launches = int(fk.pairwise_force.launches)
    m64, v64 = np.asarray(m, np.float64), np.asarray(v, np.float64)
    v0 = v64 - (m64[:, None] * v64).sum(0) / m64.sum()  # the facade's
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    qr, vr, _ = largen_rollout(f64(q), f64(v0), f64(m), eps, 1.0, LN_ROLL_DT,
                               steps, SimConfig(force_mode="direct_pallas"))
    same = bool(torch.equal(sim._state.pos[0], qr)
                and torch.equal(sim._state.vel[0], vr))
    out["largen"] = dict(s=s, launches=launches, steps_s=steps / s)
    print(f"  (e) the large-N branch, direct_pallas, N={N}: run({steps}) "
          f"{s:.3f}s = {steps / s:.2f} steps/s, tiled force launches "
          f"{launches} (want {steps + 1}), positions and velocities bit for "
          f"bit largen_rollout's: {same}", flush=True)
    if launches != steps + 1 or not same:
        raise SystemExit("(e): the large-N branch is not largen_rollout")
    del sim, qr, vr

    # (f) a snapshot taken on the CPU, restored on the card, run on as the
    # original on the CPU and its twin built on the card
    orig = facade_sim("golden ham_soft", False, "cpu")
    twin = facade_sim("golden ham_soft", False, dev)
    for s_ in (orig, twin):
        s_.run(FACADE_DT, FACADE_SNAP_STEPS)
    moved = NBodySimulation.restore(orig.snapshot(), device=dev)
    for s_ in (orig, twin, moved):
        s_.run(FACADE_DT, FACADE_SNAP_STEPS)
    dif = lambda a, b: float(np.abs(a.pos - b.pos).max()
                             / np.abs(b.pos).max())
    d_orig, d_twin = dif(moved, orig), dif(moved, twin)
    print(f"  (f) a CPU snapshot restored on the card ({moved.device}), "
          f"{FACADE_SNAP_STEPS} steps on: relative position difference from "
          f"the CPU original {d_orig:.3e}, from the card twin {d_twin:.3e} "
          f"(gated <= {F64_TOL[0]})", flush=True)
    if moved.device.type != dev.type or max(d_orig, d_twin) > F64_TOL[0]:
        raise SystemExit("(f): the restored simulation parts from the "
                         "original")
    out["s"] = time.perf_counter() - t_phase
    print(f"  the facade's phase {out['s']:.1f}s")
    return out


#: phase 24 (a): the sharded generation's population and depth (the
#: dataset pipeline runs 1000 steps; cut for the time limit to 100: at
#: 250 the eager tail's deepest lanes took 244 ms a step, 64 s a run, on
#: an H100 80GB HBM3 at 700 W)
SHARD_SYSTEMS = 4096
SHARD_STEPS = 100
SHARD_SEED = 24
#: (b): the card-against-CPU training parity, PARITY_EPOCHS epochs of
#: the first PARITY_ROWS training rows at batch 32 (200 optimizer steps)
#: from make_mlp(PARITY_SEED), dropout 0, validated on the same rows
PARITY_ROWS = 640
PARITY_EPOCHS = 10
PARITY_SEED = 7
PARITY_TOL = 1e-4
#: (b): the protocol's epochs, cut from 200 for the time limit (an
#: epoch 6.5-11.3 s on an H100 80GB HBM3 at 700 W, the eager step
#: host-bound at 2.3-3.9 ms; 15 epochs reached AUROC 0.9766, 3 0.9745)
TRAIN_EPOCHS = 3
MLP_AUROC_GATE = 0.95
GBDT_AUROC_GATE = 0.97
#: (d): the GBDT that train_gbdt fitted on DATA where scikit-learn runs
#: (``python3 chip_smoke.py --fit-gbdt-reference``), committed: the
#: trees as the port writes them, and sklearn's scores of the test split
GBDT_PREFIX = os.path.join(HERE, "data", "port_gbdt_pre_")
GBDT_REFERENCE = GBDT_PREFIX + "reference.npz"
#: (c): the predictor's raw scores against the trainer's predict_proba
PREDICT_TOL = 1e-6
#: (e): the close encounters' recall floor on the calibrated probability
#: (tools/calibrate_operating_points.py of the JAX package)
CE_FLOOR = {("close_encounter", "close_encounter_boundary"): 0.93}
TRAIN_DIR = os.path.join(HERE, "nbodysimproject_tpu_torch", "_build",
                         "phase24")
MLP_PARITY_CPU = os.path.join(TRAIN_DIR, "mlp_parity_cpu.npz")


def quiet(fn, *args, **kw):
    """``fn``'s result with its stdout dropped (the trainers print their
    progress)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def mlp_parity_run(device, data=None):
    """(b)'s parity run on ``device``: a trainer on PARITY_ROWS training
    rows (``data``: load_and_prepare_data's arrays, else loaded here),
    returning (the kept state dict, on the CPU; its epoch; seconds)."""
    from nbodysimproject_tpu_torch.ml import MLPTrainer, make_mlp

    trainer = MLPTrainer(DATA, device=device, features="pre")
    if data is None:
        data = quiet(trainer.load_and_prepare_data)
    X, y = data[0][:PARITY_ROWS], data[1][:PARITY_ROWS]
    trainer.dropout_rate = 0.0
    init = make_mlp(X.shape[1], PARITY_SEED, device="cpu").state_dict()
    t0 = time.perf_counter()
    quiet(trainer.train, X, y, X, y, epochs=PARITY_EPOCHS,
          patience=PARITY_EPOCHS, init_state=init)
    secs = time.perf_counter() - t0
    return ({k: v.cpu() for k, v in trainer.params.items()},
            trainer.best_epoch, secs)


def mlp_parity_cpu(path):
    """The CPU side of (b)'s parity, written to ``path`` (a child process
    during phase 2's builds)."""
    torch.set_num_threads(2)
    state, best, secs = mlp_parity_run("cpu")
    tmp = path + ".part.npz"
    np.savez(tmp, best=best, s=secs, **{k: v.numpy()
                                         for k, v in state.items()})
    os.replace(tmp, path)
    return 0


def start_mlp_parity_cpu():
    import atexit

    os.makedirs(TRAIN_DIR, exist_ok=True)
    if os.path.exists(MLP_PARITY_CPU):
        os.remove(MLP_PARITY_CPU)
    log = open(MLP_PARITY_CPU + ".log", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mlp-parity-cpu",
         MLP_PARITY_CPU], stdout=log, stderr=subprocess.STDOUT, cwd=HERE)
    log.close()
    atexit.register(lambda: proc.poll() is None and (proc.kill(),
                                                     proc.wait()))
    return proc


def free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def shard_worker(port, rank, out_dir, device, seed, n_systems, n_steps):
    """One of (a)'s two processes: joins the gloo group, generates and
    analyses its shard on ``device`` (the card), places a batch on the
    default mesh, and writes its local and all-reduced statistics, the
    mesh check, launches and seconds to ``out_dir/worker_<rank>.npz``."""
    import torch.distributed as dist

    from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
    from nbodysimproject_tpu_torch.parallel import (make_mesh, replicate,
                                                    shard_batch)
    from nbodysimproject_tpu_torch.parallel.distributed import (
        feature_statistics, generate_dataset_sharded, initialize_distributed)

    rank = int(rank)
    if not initialize_distributed(f"localhost:{port}", 2, rank):
        raise SystemExit("the worker joined no process group")
    reset_counts(hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep)
    tm = {}
    t0 = time.perf_counter()
    df, reduced = generate_dataset_sharded(
        int(seed), int(n_systems), out_dir=out_dir, n_steps=int(n_steps),
        show_progress=False, timing_out=tm, device=device)
    secs = time.perf_counter() - t0
    local = feature_statistics(df)
    # the default mesh under this gloo group: a host batch's shard and
    # replica land on this process's card
    mesh = make_mesh()
    batch = torch.arange(2 * SHARD_SYSTEMS, dtype=torch.float64).reshape(
        SHARD_SYSTEMS, 2)
    shard = shard_batch(batch, mesh).to_local()
    rep = replicate(batch, mesh).to_local()
    mesh_ok = (shard.device.type == rep.device.type == "cuda"
               and torch.equal(shard.cpu(), batch.chunk(2)[rank])
               and torch.equal(rep.cpu(), batch))
    np.savez(os.path.join(out_dir, f"worker_{rank}.npz"), s=secs,
             mesh_ok=mesh_ok,
             n_tail=tm["n_tail"], rows=len(df),
             analysis=hk.hamsoft_analysis_multistep.launches,
             megno=hk.hamsoft_megno_multistep.launches,
             **{f"local_{k}": local[k] for k in ("count", "sum", "sumsq")},
             **{f"reduced_{k}": reduced[k] for k in ("count", "sum", "sumsq")})
    dist.destroy_process_group()
    return 0


def frames_differ(a, b):
    """{column: rows that differ} between two frames of the same columns
    (NaN equal to NaN)."""
    out = {}
    for c in a.columns:
        x, y = a[c].to_numpy(), b[c].to_numpy()
        same = x == y
        if x.dtype.kind == "f":
            same |= np.isnan(x) & np.isnan(y)
        if not same.all():
            out[c] = np.nonzero(~same)[0]
    return out


def start_shard_workers(out_dir, dev):
    """(a)'s two worker processes, started; returns [(process, log)]."""
    port = free_port()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for r in range(2):
        log = os.path.join(out_dir, f"worker_{r}.log")
        with open(log, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--shard-worker",
                 str(port), str(r), out_dir, str(dev), str(SHARD_SEED),
                 str(SHARD_SYSTEMS), str(SHARD_STEPS)],
                stdout=f, stderr=subprocess.STDOUT, cwd=HERE, env=env), log))
    return procs


def wait_shard_workers(procs):
    try:
        rcs = [p.wait(timeout=600) for p, _ in procs]
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        for r, (_p, log) in enumerate(procs):
            with open(log) as f:
                print(f"  worker {r} log:\n" + f.read()[-4000:])
        raise SystemExit(f"the shard workers failed: rc {rcs}")


def sharded_generation(hk, dev):
    """Phase 24 (a): the two workers and the unsharded run side by side
    (each host-bound on its own core); returns its figures."""
    import shutil

    from nbodysimproject_tpu_torch.parallel.distributed import (
        generate_dataset_sharded, merge_shards, merge_statistics)

    one, two = (os.path.join(TRAIN_DIR, d) for d in ("one", "two"))
    for d in (one, two):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    procs = start_shard_workers(two, dev)
    reset_counts(hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep)
    tm = {}
    t1 = time.perf_counter()
    generate_dataset_sharded(
        SHARD_SEED, SHARD_SYSTEMS, out_dir=one, n_steps=SHARD_STEPS,
        process_index=0, process_count=1, reduce_stats=False,
        show_progress=False, timing_out=tm, device=dev)
    sync(dev)
    t_one = time.perf_counter() - t1
    launches = {"analysis": hk.hamsoft_analysis_multistep.launches,
                "megno": hk.hamsoft_megno_multistep.launches}
    print(f"  unsharded: {SHARD_SYSTEMS} systems x {SHARD_STEPS} steps in "
          f"{t_one:.3f}s ({SHARD_SYSTEMS / t_one:.1f} systems/s, beside the "
          f"two workers), launches {launches}, lanes fused "
          f"{tm['fused_lanes']} / tail {tm['n_tail']}, fused call "
          f"{tm['fused_ms']:.1f} ms, tail {tm['tail_ms']:.1f} ms (the tail "
          f"issued on its own stream inside the fused call)", flush=True)
    if not (launches["analysis"] > 0 and launches["megno"] > 0):
        raise SystemExit(f"the sharded path did not launch rows 1 and 2: "
                         f"{launches}")
    if tm["n_tail"] == 0:
        raise SystemExit("the sharded population sends nothing to the tail")
    wait_shard_workers(procs)
    t_all = time.perf_counter() - t0
    workers = [dict(np.load(os.path.join(two, f"worker_{r}.npz")))
               for r in range(2)]
    for r, w in enumerate(workers):
        print(f"  worker {r}: {int(w['rows'])} rows in {float(w['s']):.3f}s "
              f"of generation and analysis, tail {int(w['n_tail'])}, "
              f"launches analysis {int(w['analysis'])} / megno "
              f"{int(w['megno'])}")
    print(f"  the three runs (gloo, world size 2, and the unsharded one, one "
          f"card) {t_all:.3f}s wall, the workers' start-up included")

    merged, ref = merge_shards(two), merge_shards(one)
    if list(merged.columns) != list(ref.columns) or len(merged) != len(ref):
        raise SystemExit("the merged shards' columns or rows differ from "
                         "the unsharded frame's")
    differ = frames_differ(merged, ref)
    if differ:
        tail = ref["tail_fast_path"].to_numpy(bool)
        for c, rows in differ.items():
            print(f"  column {c}: {len(rows)} rows differ, "
                  f"{int(tail[rows].sum())} of them on the tail; first "
                  f"{rows[:8].tolist()}")
        raise SystemExit(f"the merged shards differ from the unsharded run "
                         f"in {len(differ)} columns")
    print(f"  merged shards bit for bit the unsharded frame: {len(ref)} rows "
          f"x {len(ref.columns)} columns ({int(ref['tail_fast_path'].sum())} "
          f"on the tail)")
    local = [{"feature_cols": None, **{k: w[f"local_{k}"] for k in
                                       ("count", "sum", "sumsq")}}
             for w in workers]
    m = merge_statistics(local)
    same = all(np.array_equal(w[f"reduced_{k}"], m[k])
               and w[f"reduced_{k}"].dtype == np.float64
               for w in workers for k in ("count", "sum", "sumsq"))
    print(f"  the workers' float64 all-reduce bit for bit merge_statistics "
          f"of their local statistics: {same}")
    if not same:
        raise SystemExit("reduce_statistics_global differs from "
                         "merge_statistics")
    if not all(int(w["analysis"]) > 0 and int(w["megno"]) > 0
               for w in workers):
        raise SystemExit("a shard worker did not launch rows 1 and 2")
    mesh_ok = all(bool(w["mesh_ok"]) for w in workers)
    print(f"  the workers' make_mesh() / shard_batch / replicate: a host "
          f"batch's shard and replica on each worker's card, its rows: "
          f"{mesh_ok}")
    if not mesh_ok:
        raise SystemExit("the default mesh did not place the batch on the "
                         "card")
    return dict(t_one=t_one, t_all=t_all, launches=launches,
                workers=[{k: float(w[k]) for k in ("s", "analysis", "megno",
                                                   "n_tail")}
                         for w in workers],
                n_tail=tm["n_tail"], rows=len(ref))


def fit_gbdt_reference():
    """(d)'s committed GBDT (``--fit-gbdt-reference``, on a host with
    scikit-learn): ``train_gbdt`` on DATA (fast grid, cv 3,
    ``hold_out_val``, one process, four threads), its trees into
    ``GBDT_PREFIX + "torch.npz"``; sklearn's raw scores and
    probabilities on the test split, the labels, the feature names and
    the test metrics into GBDT_REFERENCE."""
    import joblib
    import sklearn
    from threadpoolctl import threadpool_limits

    from nbodysimproject_tpu_torch.ml import DataUtils, train_gbdt
    from nbodysimproject_tpu_torch.ml.dataset import StabilityDataset

    os.environ["NB_GBDT_GRID"] = "fast"
    t0 = time.perf_counter()
    with joblib.parallel_config(backend="sequential"), threadpool_limits(4):
        metrics, extras = train_gbdt(DATA, cv=3, prefix=GBDT_PREFIX,
                                     features="pre", hold_out_val=True,
                                     return_probs=True)
    secs = time.perf_counter() - t0
    X, y, names = StabilityDataset.load(DATA, features="pre")
    X_test, y_test = DataUtils.split_and_scale(X, y, test_size=0.15,
                                               val_size=0.15, seed=42)[2::3]
    raw = extras["model"]._raw_predict(X_test)[:, 0]
    if not (np.array_equal(y_test, extras["y_test"])
            and np.array_equal(extras["model"].predict_proba(X_test)[:, 1],
                               extras["prob_test"])):
        raise SystemExit("the re-made test split is not train_gbdt's")
    np.savez(GBDT_REFERENCE, raw_test=raw, prob_test=extras["prob_test"],
             y_test=y_test, feature_names=np.asarray(names),
             auroc=metrics["auroc"],
             balanced_accuracy=metrics["balanced_accuracy"],
             sklearn=sklearn.__version__, fit_s=secs)
    print(f"{extras['model'].n_iter_} trees, test AUROC {metrics['auroc']}, "
          f"fit {secs:.1f}s: {GBDT_PREFIX}torch.npz, {GBDT_REFERENCE}")
    return 0


def gbdt_on_card(trainer, pred, frame, y_test, dev):
    """Phase 24 (d): the committed ``train_gbdt`` trees on the card held
    to sklearn's scores of them; returns the test metrics."""
    from scipy.special import expit

    from nbodysimproject_tpu_torch.ml.artifacts import load_artifacts
    from nbodysimproject_tpu_torch.ml.calibrate import roc_auc
    from nbodysimproject_tpu_torch.ml.gbdt import TreeEnsemble
    from nbodysimproject_tpu_torch.ml.predict import feature_matrix

    ref = dict(np.load(GBDT_REFERENCE))
    arrays = load_artifacts(GBDT_PREFIX + "torch.npz")
    # the split and the scaler made here (numpy replicas of sklearn's)
    # are the ones the trees were fitted on where sklearn ran
    same_split = (list(ref["feature_names"]) == list(pred.feature_names)
                  and np.array_equal(ref["y_test"], y_test)
                  and np.array_equal(arrays["gbdt_scaler_mean"],
                                     trainer.scaler.mean_)
                  and np.array_equal(arrays["gbdt_scaler_scale"],
                                     trainer.scaler.scale_))
    Xs = trainer.scaler.transform(feature_matrix(frame, pred.feature_names))
    ens = TreeEnsemble(arrays, dev)
    raw_card = ens.raw_predict(torch.as_tensor(Xs, device=dev))
    raw_g = raw_card.cpu().numpy()
    same_raw = np.array_equal(raw_g, ref["raw_test"])
    prob = expit(raw_g)
    same_prob = np.array_equal(prob, ref["prob_test"])
    d_sig = float(np.abs(torch.sigmoid(raw_card).cpu().numpy()
                         - ref["prob_test"]).max())
    auroc = roc_auc(ref["y_test"], prob)
    print(f"  GBDT (train_gbdt's committed trees, fast grid, cv 3, sklearn "
          f"{ref['sklearn']}): {ens.n_trees} trees of depth <= "
          f"{ens.max_depth} on the card; split, labels and scaler those of "
          f"the fit {same_split}; raw scores bit for bit sklearn's "
          f"{same_raw}, sklearn's link of them bit for bit predict_proba "
          f"{same_prob} (torch.sigmoid on the card within {d_sig:.3e}); "
          f"test AUROC {auroc:.4f} (gate {GBDT_AUROC_GATE}; sklearn's "
          f"{float(ref['auroc']):.4f})", flush=True)
    if not (same_split and same_raw and same_prob
            and auroc == float(ref["auroc"]) and auroc >= GBDT_AUROC_GATE):
        raise SystemExit("the GBDT on the card differs from sklearn's or "
                         "scores below its gate")
    return {"auroc": auroc,
            "balanced_accuracy": float(ref["balanced_accuracy"])}


def phase_training(hk, dev, parity_proc):
    """Phase 24: (a)-(e) of the script's docstring.  Returns its
    figures for the report."""
    import pandas as pd

    from nbodysimproject_tpu_torch.ml import (DataUtils, MLPTrainer,
                                              StabilityPredictor)
    from nbodysimproject_tpu_torch.ml.calibrate import (
        calibrated_probability, choose_global_threshold,
        choose_recall_floor_thresholds, evaluate_policy,
        fit_cohort_calibration, policy_decisions)

    t_phase = time.perf_counter()
    out = {"sharded": sharded_generation(hk, dev)}

    # (b) the MLP on the card
    rc = parity_proc.wait(timeout=600)
    if rc != 0 or not os.path.exists(MLP_PARITY_CPU):
        raise SystemExit(f"the CPU training parity failed (rc {rc}; "
                         f"{MLP_PARITY_CPU}.log)")
    ref = dict(np.load(MLP_PARITY_CPU))
    trainer = MLPTrainer(DATA, device=dev, features="pre")
    t0 = time.perf_counter()
    data = quiet(trainer.load_and_prepare_data)
    t_load = time.perf_counter() - t0
    X_train, y_train, X_val, y_val, X_test, y_test = data
    state, best, t_par = mlp_parity_run(dev, data)
    d_par = max(float(np.abs(v.numpy() - ref[k]).max())
                for k, v in state.items())
    print(f"  training parity: {PARITY_EPOCHS * (PARITY_ROWS // 32)} optimizer"
          f" steps at dropout 0, card against CPU: largest parameter "
          f"difference {d_par:.3e} (gate {PARITY_TOL}), best epochs "
          f"{best} / {int(ref['best'])}; card {t_par:.3f}s, CPU "
          f"{float(ref['s']):.3f}s", flush=True)
    if not (d_par <= PARITY_TOL and best == int(ref["best"])):
        raise SystemExit("the card's training parts from the CPU's")

    t0 = time.perf_counter()
    quiet(trainer.train, X_train, y_train, X_val, y_val, epochs=TRAIN_EPOCHS)
    sync(dev)
    t_train = time.perf_counter() - t0
    n_ep = len(trainer.history)
    steps = n_ep * (len(X_train) // 32)
    quiet(trainer.compute_optimal_threshold, X_val, y_val)
    metrics = quiet(trainer.evaluate, X_test, y_test)
    print(f"  MLP: {len(X_train)} training rows, {n_ep} epochs (best "
          f"{trainer.best_epoch}), {t_train:.3f}s = {t_train / n_ep:.3f} s an "
          f"epoch, {1e3 * t_train / steps:.4f} ms an optimizer step (the "
          f"validation pass included); data load {t_load:.2f}s; test AUROC "
          f"{metrics['auroc']:.4f} (gate {MLP_AUROC_GATE}), balanced "
          f"accuracy {metrics['balanced_accuracy']:.4f}, Youden threshold "
          f"{trainer.optimal_threshold:.4f}", flush=True)
    if not metrics["auroc"] >= MLP_AUROC_GATE:
        raise SystemExit("the MLP trained on the card scores below its gate")

    # (c) served from its artifacts
    prefix = os.path.join(TRAIN_DIR, "port_pre_")
    quiet(trainer.save_model, prefix)
    df_all = pd.read_csv(DATA, comment="#", usecols=list(
        trainer.feature_names) + ["is_stable", "system_type"])
    if len(df_all) != len(X_train) + len(X_val) + len(X_test):
        raise SystemExit("the dataset's rows are not the trainer's")
    _tr, va, te = DataUtils.split_indices(df_all["is_stable"].to_numpy(),
                                          0.15, 0.15, 42)
    frame = df_all.iloc[te].reset_index(drop=True)
    pred = StabilityPredictor(prefix, model="mlp", device=dev)
    prob_test = trainer.predict_proba(X_test).astype(np.float64)
    raw = pred.predict_frame(frame, return_raw=True)[2]
    d_pred = float(np.abs(raw - prob_test).max())
    print(f"  served: the predictor's raw scores on the {len(te)} test rows "
          f"within {d_pred:.3e} of the trainer's (gate {PREDICT_TOL}; "
          f"bit for bit: {np.array_equal(raw, prob_test)})")
    if not d_pred <= PREDICT_TOL:
        raise SystemExit("the predictor's scores part from the trainer's")

    # (d) the GBDT: its committed trees on the card
    g_metrics = gbdt_on_card(trainer, pred, frame, y_test, dev)

    # (e) calibration on the validation split, served on the card
    types = df_all["system_type"].to_numpy().astype(str)
    c_val, c_te = types[va], types[te]
    prob_val = trainer.predict_proba(X_val).astype(np.float64)
    y_v, y_t = y_val.astype(np.float64), y_test.astype(np.float64)
    calib = fit_cohort_calibration(prob_val, y_v, c_val)
    pc_val = calibrated_probability(prob_val, c_val, calib)
    thr = choose_global_threshold(pc_val, y_v)
    calib["global_threshold"] = thr
    calib["cohort_operating_points"] = quiet(
        choose_recall_floor_thresholds, pc_val, y_v, c_val, CE_FLOOR)
    report = evaluate_policy(prob_test, y_t, c_te, calib, thr)
    with open(prefix + "model_metadata.json") as f:
        meta = json.load(f)
    meta["calibration"] = calib
    with open(prefix + "model_metadata.json", "w") as f:
        json.dump(meta, f)
    served = StabilityPredictor(prefix, model="mlp", device=dev)
    _p, stable = served.predict_frame(frame, cohorts=c_te)
    _pc, stable_ref = policy_decisions(prob_test, c_te, calib, thr)
    ov = report["__overall__"]
    tpr = float(stable[y_t == 1].mean())
    print(f"  calibration: {len(calib['cohorts'])} cohort curves, global "
          f"threshold {thr:.4f}, operating points "
          f"{calib['cohort_operating_points']}; test balanced accuracy "
          f"{ov['balanced_accuracy']:.4f} (AUROC {ov.get('auroc', 0):.4f}); "
          f"the card's decisions equal the policy's on "
          f"{int((stable == stable_ref).sum())} of {len(stable)} rows")
    if not (np.array_equal(stable, stable_ref) and tpr == ov["tpr"]):
        raise SystemExit("the calibrated predictor's decisions differ from "
                         "evaluate_policy's")
    out.update(parity=d_par, t_par=t_par, t_par_cpu=float(ref["s"]),
               t_train=t_train, epochs=n_ep, steps=steps, mlp=metrics,
               youden=trainer.optimal_threshold, d_pred=d_pred,
               gbdt=g_metrics, calib_ba=ov["balanced_accuracy"],
               s=time.perf_counter() - t_phase)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from nbodysimproject_tpu_torch import SimConfig, analyze_population
    from nbodysimproject_tpu_torch.analysis.batch import (dispatch_plan,
                                                          prepare_population)
    from nbodysimproject_tpu_torch.analysis.fused import analyze_batch_fused
    from nbodysimproject_tpu_torch.diagnostics.megno import (
        init_tangent, population_normals)
    from nbodysimproject_tpu_torch.ops import batch_kernels as bk
    from nbodysimproject_tpu_torch.ops import cuda_build
    from nbodysimproject_tpu_torch.ops import eps_kernels as ek
    from nbodysimproject_tpu_torch.ops import force_kernels as fk
    from nbodysimproject_tpu_torch.ops import hamsoft_kernels as hk
    from nbodysimproject_tpu_torch.ops import pm_force as pm
    from nbodysimproject_tpu_torch.ops import whfast_kernels as wk

    phase("card")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # phase 23's and phase 24's CPU references, in child processes beside
    # the builds
    facade_ref = start_facade_cpu_references()
    parity_proc = start_mlp_parity_cpu()

    phase("build")
    t0 = time.perf_counter()
    # the composition kernel at every (N, d) it takes, bk.build_jobs()'s
    # shapes among them
    built = cuda_build.build(hk.build_jobs() + ek.build_jobs()
                             + facade_eps_jobs(ek)
                             + bk.build_jobs(COMPOSITION_SHAPES)
                             + wk.build_jobs() + fk.build_jobs()
                             + list(BRANCH_JOBS) + list(SLOT_JOBS))
    for job, (path, secs, report) in sorted(built.items()):
        print(f"  {cuda_build.job_name(job)}: {os.path.basename(path)} in "
              f"{secs:.1f}s")
        for line in report.splitlines():
            print(f"    {line.strip()}")
    print(f"  build wall {time.perf_counter() - t0:.1f}s")
    # the analysis and MEGNO kernels at N = 8 (d = 2 and 3), the
    # multi-step kernel's two policies' instances at every N (d = 2 and
    # 3), the eps kernel at N = 3 and 8 (d = 2 and 3), the WHFast kernel
    # and its Stumpff probe (d = 2 and 3), the force kernel and its slice
    # sum; the branch variants' builds are reported by their phase
    for job, n_kernels in ([(("hamsoft.cu", N_SLOTS, 2), 2),
                            (("hamsoft.cu", N_SLOTS, 3), 2)]
                           + [(j, 2) for j in hk.build_jobs()
                              if j[0] == "hamsoft_multistep.cu"]
                           + [(j, 1) for j in ek.build_jobs()]
                           + [(j, 2) for j in wk.build_jobs()]
                           + [(j, 2) for j in fk.build_jobs()]):
        print("  " + spill_gate(f"{job[0]} N={job[1]} d={job[2]}",
                                built[job][2], n_kernels))
    # the composition kernel's Verlet and Yoshida4 instances: 0 spilled
    # and 0 bytes of stack frame where gated, the rest reported
    for job in bk.build_jobs(COMPOSITION_SHAPES):
        if job[1:] in COMPOSITION_GATED:
            print("  " + spill_gate(f"{job[0]} N={job[1]} d={job[2]}",
                                    built[job][2], 2, stack=True))
        else:
            regs, frames, spills = ptxas_counts(built[job][2])
            print(f"  {job[0]} N={job[1]} d={job[2]} (not gated): "
                  f"registers {regs}, stack frame {frames} bytes, spilled "
                  f"{spills} bytes")
    sass = sass_step_counts(built[(bk.SOURCE, 3, 2)][0])
    print(f"  composition.cu N=3 d=2 SASS, (instructions, MUFU) a step by "
          f"stage count: {sass}")

    facade_ref, waited = wait_facade_cpu_references(facade_ref)
    secs = ", ".join(f"{facade_ref[f's {i}']:.1f}"
                     for i in range(len(FACADE_REF_JOBS)))
    print(f"  phase 23's CPU references: {len(FACADE_REF_JOBS)} child "
          f"processes on the CPU, {secs} s, waited {waited:.2f}s after the "
          f"builds", flush=True)

    # phase 23 runs here, in a fresh process: its eager B = 1 steps ran
    # ~1.8x slower at the script's end than alone (9.05 against 4.8-5.1
    # ms a step)
    phase("the facade: NBodySimulation, its analyzers and the sim-list views "
          "on the card")
    facade = phase_facade(ek, fk, dev, facade_ref)
    torch.cuda.empty_cache()

    phase("the dataset-to-classifier path: sharded generation, the MLP and "
          "GBDT trained, calibrated and served")
    training = phase_training(hk, dev, parity_proc)
    torch.cuda.empty_cache()

    phase("population")
    (mass, pos, vel, mask, G, soft, min_soft), ref = load_population(B_MAIN)
    assert mass.shape == (B_MAIN, N_SLOTS) and np.all(G == G[0])
    print(f"  {B_MAIN} systems, {int(mask.sum())} bodies, "
          f"{np.bincount(mask.sum(1))} systems by body count, cohorts "
          f"{ref['system_type'].value_counts().to_dict()}")

    phase("compare kernels with their plain versions")
    cfg = SimConfig(**PIPE)
    cfg_off = SimConfig(**PIPE_OFF)
    states, dyns, n_sub_raw = prepare_population(
        mass, pos, vel, mask, cfg, G=G, softening=soft,
        min_softening=min_soft, dt=DT, device=dev)
    def tangent_of(st):
        z1, z2 = population_normals(7, st.pos.shape[0],
                                    tuple(st.pos.shape[1:]), torch.float32)
        return init_tangent(z1.to(dev), z2.to(dev), st)

    cases, low, top, buckets = bucket_cases("", states, dyns, n_sub_raw, cfg,
                                            hk, tangent_of)

    phase("compare the batched slice's kernels with their plain versions")
    new_cmp = {}
    for scheme, B in (("verlet", B_VERLET_FUSED), ("yoshida4", B_Y4_FUSED)):
        new_cmp[f"composition {scheme}"] = compare_composition(scheme, B, dev)
        torch.cuda.empty_cache()
    for scheme in bk.SCHEME_STAGES:
        new_cmp[f"composition {scheme} N=8 d=3"] = compare_composition(
            scheme, B_RING, dev, 8, 3)
    print("  composition kernel at every (N, d), both schemes:")
    new_cmp["composition shapes"] = dict(err=composition_shapes(dev))
    torch.cuda.empty_cache()
    cfg_hs = SimConfig(integrator_mode="ham_soft", fast_float32=True)
    st_h, dy_h = hamsoft_bench_batch(cfg_hs, dev)
    for policy in ("soft", "reflection"):
        new_cmp[f"multistep {policy}"] = compare_multistep(
            cfg_hs.replace(use_soft_barrier=(policy == "soft")), st_h, dy_h,
            policy, hk)
    first = torch.arange(B_CMP, device=dev)
    for clamp in (True, False):
        new_cmp[f"eps bench clamp={clamp}"] = compare_eps(
            "bench", st_h, dy_h, clamp, ek)
        new_cmp[f"eps dataset clamp={clamp}"] = compare_eps(
            "dataset", states.take(first), dyns.take(first), clamp, ek)
    eps_layouts_agree(states, dyns, ek)
    eps_alone(ek, {
        "bench": (st_h.pos, st_h.mass, st_h.eps, dy_h.alpha_run,
                  dy_h.min_softening, dy_h.max_softening, st_h.mask),
        "dataset": (states.pos, states.mass, states.eps, dyns.alpha_run,
                    dyns.min_softening, dyns.max_softening, states.mask)})
    del st_h, dy_h
    torch.cuda.empty_cache()
    new_cmp["whfast"] = compare_whfast(dev, wk)
    torch.cuda.empty_cache()

    phase("main path: analyze_population under _PIPE_CFG, tail on")
    kw = dict(G=G, softening=soft, min_softening=min_soft, dt=DT,
              n_steps=N_STEPS, mode="full", show_progress=False)
    sel, n_tail = tail_stats(states, dyns, cfg, n_sub_raw)
    reset_counts(hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep)
    tm = {}
    t0 = time.perf_counter()
    df = analyze_population(mass, pos, vel, mask, cfg, timing_out=tm, **kw)
    t_cold = time.perf_counter() - t0
    launches = {"analysis": hk.hamsoft_analysis_multistep.launches,
                "megno": hk.hamsoft_megno_multistep.launches}
    print(f"  cold {t_cold:.3f}s ({B_MAIN / t_cold:.1f} systems/s), "
          f"launches {launches}, phases {tm}")
    if not (launches["analysis"] > 0 and launches["megno"] > 0):
        raise SystemExit(f"the main path did not launch both kernels: "
                         f"{launches}")
    if tm["n_tail"] != int(sel.sum()) or not np.array_equal(
            df["tail_fast_path"].to_numpy(bool), sel):
        raise SystemExit("the main path's tail differs from its selection")
    if tm["engine"] != "fused" or tm["scan_lanes"] != 0 \
            or tm["fused_lanes"] != B_MAIN - tm["n_tail"]:
        raise SystemExit(f"the main path sent lanes off the tail to the "
                         f"scan engine: {tm}")
    warm, fused_ms, tail_ms = [], [], []
    for _ in range(WARM_REPS):
        tm = {}
        t0 = time.perf_counter()
        df = analyze_population(mass, pos, vel, mask, cfg, timing_out=tm,
                                **kw)
        warm.append(time.perf_counter() - t0)
        fused_ms.append(tm["fused_ms"])
        tail_ms.append(tm["tail_ms"])
        print(f"  warm {warm[-1]:.3f}s phases {tm}")
    t_med = float(np.median(warm))
    print(f"  warm median {t_med:.3f}s over {WARM_REPS}: "
          f"{B_MAIN / t_med:.1f} systems/s (B={B_MAIN}, n_steps={N_STEPS}, "
          f"N={N_SLOTS}, d=2, tail on its own stream) on {card}; fused call "
          f"{np.median(fused_ms):.1f} ms, tail {np.median(tail_ms):.1f} ms "
          f"(medians, device time)")
    check_output(df, "tail on")

    phase("tail off: bitwise non-tail rows, labels")
    t0 = time.perf_counter()
    df_off = analyze_population(mass, pos, vel, mask, cfg_off, **kw)
    t_off = time.perf_counter() - t0
    print(f"  tail-off run {t_off:.3f}s ({B_MAIN / t_off:.1f} systems/s)")
    check_output(df_off, "tail off")
    keep = ~sel
    differ = {c: int((~((df[c].to_numpy()[keep] == df_off[c].to_numpy()[keep])
                        | (pd_isnan(df[c].to_numpy()[keep])
                           & pd_isnan(df_off[c].to_numpy()[keep])))).sum())
              for c in df_off.columns}
    differ = {c: v for c, v in differ.items() if v}
    print(f"  non-tail rows ({int(keep.sum())}) bitwise equal to the tail-off "
          f"run in every column: {not differ}")
    if differ:
        raise SystemExit(f"non-tail rows differ from the tail-off run: "
                         f"{differ}")
    print(f"  n_sub equal to the dataset's on "
          f"{float((df['n_sub'] == ref['n_sub']).mean()):.4f} of the rows")
    print_agreement("tail rows: this run (first) against the dataset "
                    "(second)", label_agreement(df, ref, sel))
    print_agreement("tail rows: this run (first) against the tail-off run "
                    "(second)", label_agreement(df, df_off, sel))
    print_agreement("tail rows: the tail-off run (first) against the "
                    "dataset (second)", label_agreement(df_off, ref, sel))
    print_agreement("other rows: this run (first) against the dataset "
                    "(second)", label_agreement(df, ref, keep))
    # the rounding floor: the same systems with their body slots (and
    # MEGNO tangents) reversed, the same physics with every sum in
    # another order (tail off)
    rev = slice(None, None, -1)
    z1, z2 = population_normals(0, B_MAIN, (N_SLOTS, 2), torch.float32)
    dr0, dv0 = init_tangent(z1.to(dev), z2.to(dev), states)
    t0 = time.perf_counter()
    df_rev = analyze_population(
        mass[:, rev], pos[:, rev], vel[:, rev], mask[:, rev], cfg_off,
        tangent=(dr0.flip(1), dv0.flip(1)), **kw)
    print(f"  reversed-slot run (tail off) {time.perf_counter() - t0:.3f}s")
    agree_rev = label_agreement(df_off, df_rev, keep)
    print_agreement("other rows: the tail-off run (first) against the "
                    "reversed-slot run (second)", agree_rev)
    agree_ds = label_agreement(df, ref, keep)["is_stable"]["agree"]
    print(f"  is_stable on the {int(keep.sum())} fused rows: agrees with the "
          f"dataset on {agree_ds:.4f} (gated >= {LABEL_GATE}); the tail-off "
          f"run with its reversed-slot run on "
          f"{agree_rev['is_stable']['agree']:.4f} (the rounding floor)")
    if agree_ds < LABEL_GATE:
        raise SystemExit(f"is_stable agrees with the dataset on {agree_ds:.4f}"
                         f" of the fused rows (< {LABEL_GATE})")

    phase("every slot count: the dataset rows in 16 and in 5 slots, a drawn "
          "population of 9-16 bodies, rows 1-3 at N = 2, 5 and 16")
    slot_report, slots = phase_slots(
        cfg_off, hk, dev, ((mass, pos, vel, mask), G, soft, min_soft),
        df_off, (dr0, dv0), tangent_of, built)
    torch.cuda.empty_cache()

    phase("use_fused_metrics=False on the main path's population (tail off)")
    cfg_c = cfg_off.replace(use_fused_metrics=False)
    chunked_cases = []
    reset_counts(hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep,
                 hk.hamsoft_multistep)
    t0 = time.perf_counter()
    df_c = analyze_population(mass, pos, vel, mask, cfg_c, **kw)
    t_c = time.perf_counter() - t0
    launches_c = {f.__name__: f.launches for f in (
        hk.hamsoft_analysis_multistep, hk.hamsoft_megno_multistep,
        hk.hamsoft_multistep)}
    print(f"  {t_c:.3f}s ({B_MAIN / t_c:.1f} systems/s), launches "
          f"{launches_c}")
    if launches_c["hamsoft_multistep"] == 0 \
            or launches_c["hamsoft_analysis_multistep"] != 0:
        raise SystemExit("use_fused_metrics=False did not run the "
                         "multi-step kernel alone")
    if len(df_c) != B_MAIN or not np.isfinite(df_c["is_stable"]).all():
        raise SystemExit("use_fused_metrics=False: missing or non-finite "
                         "is_stable")
    chunked_full_horizon(df_off, df_c, df_rev,
                         ~df_off["pathological_energy"].to_numpy(bool))
    del df_c, df_rev
    rows_c, nsm_c, _ = dispatch_plan(n_sub_raw, cfg_off)
    lanes_c = torch.as_tensor(rows_c, device=dev)
    # the run's multi-step launches replayed on the same lanes (dispatch
    # order, seed-0 tangents) with CUDA events around each launch
    tms = TimedEach(hk.hamsoft_multistep)
    analyze_batch_fused(states.take(lanes_c), dyns.take(lanes_c), cfg_c,
                        N_STEPS, DT, "full", nsm_c, min(50, N_STEPS // 2),
                        tangent=(dr0[lanes_c], dv0[lanes_c]),
                        multistep_fn=tms)
    calls = tms.times()
    ns_c = dyns.n_sub[lanes_c].cpu().numpy()
    chunk_b = [bound_multistep(ns_c, nsm_c, n, N_SLOTS, 2) for n, _ in calls]
    full = [ms for n, ms in calls if n == calls[-2][0]]
    full_b = bound_multistep(ns_c, nsm_c, calls[-2][0], N_SLOTS, 2)
    trips = calls[-2][0] * nsm_c
    chunked = dict(run_s=t_c, launches=len(calls),
                   kernel_ms=sum(ms for _, ms in calls),
                   bound_ms=sum(b for b, _ in chunk_b),
                   launch_ms=float(np.median(full)), launch_steps=calls[-2][0],
                   launch_bound=full_b)
    print(f"  the multi-step kernel on this run (replayed): "
          f"{chunked['launches']} launches, {chunked['kernel_ms']:.1f} ms in "
          f"all (bound {chunked['bound_ms']:.3f} ms, {full_b[1]}); a "
          f"{chunked['launch_steps']}-step launch {chunked['launch_ms']:.3f} "
          f"ms (median of {len(full)}; bound {full_b[0]:.4f} ms, "
          f"{chunked['launch_ms'] / full_b[0]:.1f}x), "
          f"{1e3 * chunked['launch_ms'] / trips:.3f} us per trip of the "
          f"deepest lane; the run {t_c:.3f}s", flush=True)
    chunked_parity_horizon(states.take(lanes_c), dyns.take(lanes_c), cfg_off,
                           nsm_c, analyze_batch_fused)
    # the lowest bucket only: the top bucket's case (41.3 s on an NVIDIA
    # H100 80GB HBM3 at 700 W) was cut to pay for phase 23; the multi-step
    # kernel's trip is the analysis kernel's, bit for bit (gated above),
    # and the analysis kernel's top bucket is held in phase 4
    for label, lanes, steps, nsm, widen in (
            ("lowest bucket, use_fused_metrics=False", low, 20,
             int(buckets[low].max()), False),):
        t0 = time.perf_counter()
        chunked_cases.append(compare_case(
            label, states, dyns, cfg_c, torch.as_tensor(lanes, device=dev),
            steps, nsm, hk, analyze_batch_fused, tangent_of, widen))
        print(f"  {label} done in {time.perf_counter() - t0:.1f}s")

    phase("main-path kernel times")
    # the main path's one launch of each kernel, replayed on the same
    # inputs (the fused lanes in analyze_population's dispatch order and
    # its seed-0 tangents) with CUDA events around each launch
    fused_rows = np.nonzero(~sel)[0]
    order, n_sub_max, _ = dispatch_plan(n_sub_raw[fused_rows], cfg)
    lanes = torch.as_tensor(fused_rows[order], device=dev)
    ta, tm_ = Timed(hk.hamsoft_analysis_multistep), Timed(
        hk.hamsoft_megno_multistep)
    megno_steps = min(100, min(50, N_STEPS // 2))
    analyze_batch_fused(states.take(lanes), dyns.take(lanes), cfg, N_STEPS,
                        DT, "full", n_sub_max, megno_steps,
                        tangent=(dr0[lanes], dv0[lanes]), analysis_fn=ta,
                        megno_fn=tm_)
    ns_lanes = dyns.n_sub[lanes].cpu().numpy()
    main_ms = {}
    for kind, t, steps in (("analysis", ta, N_STEPS),
                           ("megno", tm_, megno_steps)):
        b_ms, b_by = bound(kind, ns_lanes, n_sub_max, N_STEPS,
                           megno_steps, N_SLOTS, 2)
        per_trip = 1e3 * t.ms / (steps * n_sub_max)
        main_ms[kind] = (t.ms, per_trip)
        print(f"  {kind}: {len(ns_lanes)} fused lanes (tail on), one launch "
              f"{t.ms:.1f} ms = {per_trip:.3f} us per trip of the deepest "
              f"lane ({steps} x {n_sub_max} trips), bound {b_ms:.3f} ms "
              f"({b_by}), {t.ms / b_ms:.0f}x the bound", flush=True)

    phase("the 3-D product path: analyze_population at d = 3 on the 3-D "
          "dataset, its kernels, labels and the 3-D headline models")
    p3 = phase_3d(cfg, cfg_off, hk, ek, dev, tangent_of)
    torch.cuda.empty_cache()

    phase("the fused engine's remaining branches: the reflection and "
          "no-barrier policies, the reference gradient, rows 3 and 6 at "
          "d = 3")
    branches = phase_branches(
        cfg, cfg_off, hk, ek, wk, dev, tangent_of,
        ((mass, pos, vel, mask), G, soft, min_soft), states, dyns, n_sub_raw,
        df_off, p3, built)
    torch.cuda.empty_cache()

    phase("generators: diverse_population on the card")
    gen_out = generators_phase(dev)
    phase("bench population: analyze_population on bench.py's population, "
          "then MLTrainingPipeline")
    bench = bench_population_phase(cfg, hk, dict(dt=DT, n_steps=BENCH_STEPS,
                                                 mode="full",
                                                 show_progress=False), dev)
    phase("serving: ic_feature_frame and StabilityPredictor")
    serving = serving_phase(cfg, bench, dev, B_MAIN / t_med)
    del bench["df"]
    torch.cuda.empty_cache()

    phase("the batched slice: bench.py's legs at full width")
    legs = slice_legs(dev, hk, ek, bk, wk, sass)

    torch.cuda.empty_cache()
    evals, rolls = largen_ics()
    phase("the large-N slice: the tiled force kernel against its plain "
          "version")
    force_cmp = compare_pairwise(fk, dev, evals)
    torch.cuda.empty_cache()
    phase("the large-N slice: bench_largen's single force evaluations")
    ln_evals = largen_evals(fk, pm, dev, evals)
    phase("the large-N slice: bench_largen's rollouts (largen_rollout)")
    ln_rolls = largen_rollouts(fk, dev, rolls)
    phase("the large-N slice: verlet through integrate_batch with "
          "use_pallas_forces")
    classical = classical_route(fk, dev)
    phase("the large-N slice: bench_whfast_largen's many-planet WHFast")
    wl = whfast_many_planets(fk, dev)
    phase("the large-N slice: the tiled force kernel alone at its paths' "
          "widths")
    alone = force_alone(fk, dev, evals)
    del evals, rolls
    torch.cuda.empty_cache()

    phase("the scan route: analyze_population for every configuration the "
          "fused engine does not take, on the dataset rows")
    scan = phase_scan_route(cfg, hk, ek, (mass, pos, vel, mask), G, soft,
                            min_soft, (states, dyns, n_sub_raw), sel)
    torch.cuda.empty_cache()

    phase("report")
    entries = []
    for kind, replaces in (
            ("analysis", "nbodysimproject_tpu/ops/pallas_hamsoft.py:565"),
            ("megno", "nbodysimproject_tpu/ops/pallas_hamsoft.py:770")):
        ms, plain_ms, err, ns, steps, msteps, nsm, _sh = cases[1][kind]
        b_ms, b_by = bound(kind, ns, nsm, steps, msteps, N_SLOTS, 2)
        entries.append({
            "name": f"hamsoft_{kind}_multistep",
            "route": "cuda",
            "source": "nbodysimproject_tpu_torch/csrc/hamsoft.cu",
            "replaces": replaces,
            "launches": launches[kind],
            "max_abs_err": max(err, cases[0][kind][2]),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        low_ms, low_plain = cases[0][kind][:2]
        print(f"  {kind}: top-bucket case kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"lowest-bucket case kernel {low_ms:.3f} ms, plain "
              f"{low_plain:.3f} ms")
    for name, src, replaces, leg, case, err_of in (
            ("hamsoft_multistep", "hamsoft_multistep.cu",
             "nbodysimproject_tpu/ops/pallas_hamsoft.py:508",
             "ham_soft fused soft", "multistep soft", ("multistep",)),
            ("eps_star_and_grad_fused", "eps_grad.cu",
             "nbodysimproject_tpu/ops/pallas_eps.py:50",
             "ham_soft scan soft", "eps bench clamp=True", ("eps",)),
            ("composition_multistep", "composition.cu",
             "nbodysimproject_tpu/ops/pallas_batch.py:49", "verlet fused",
             "composition verlet", ("composition",)),
            ("whfast_multistep", "whfast.cu",
             "nbodysimproject_tpu/ops/pallas_whfast.py:162", "whfast fused",
             "whfast", ("whfast",))):
        c = new_cmp[case]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"nbodysimproject_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": legs[leg][2][name],
            "max_abs_err": max([v["err"] for k, v in new_cmp.items()
                                if k.startswith(err_of)]
                               + [c[name[8:]][2] for c in chunked_cases
                                  if name == "hamsoft_multistep"]),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
            "library_ms": None})
        print(f"  {name}: {case} case kernel {c['ms']:.3f} ms, plain "
              f"{c['plain_ms']:.3f} ms, bound {c['bound'][0]:.4f} ms "
              f"({c['bound'][1]}); launches in the {leg} leg "
              f"{legs[leg][2][name]}")
    for kind, replaces in (
            ("analysis", "nbodysimproject_tpu/ops/pallas_hamsoft.py:565"),
            ("megno", "nbodysimproject_tpu/ops/pallas_hamsoft.py:770")):
        ms, plain_ms, err, ns, steps, msteps, nsm, _sh = \
            p3["cases"][1][kind]
        b_ms, b_by = bound(kind, ns, nsm, steps, msteps, N_SLOTS, 3)
        entries.append({
            "name": f"hamsoft_{kind}_multistep d=3",
            "route": "cuda",
            "source": "nbodysimproject_tpu_torch/csrc/hamsoft.cu",
            "replaces": replaces,
            "launches": p3["launches"][f"hamsoft_{kind}_multistep"],
            "max_abs_err": max(err, p3["cases"][0][kind][2]),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        m_ms, per_trip, (mb, mby) = p3["main_ms"][kind]
        print(f"  {kind} d=3: top-bucket case kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); 3-D main-"
              f"path launch {m_ms:.1f} ms ({per_trip:.3f} us per trip), "
              f"bound {mb:.3f} ms ({mby})")
    e3 = p3["eps"][True]
    entries.append({
        "name": "eps_star_and_grad_fused d=3", "route": "cuda",
        "source": "nbodysimproject_tpu_torch/csrc/eps_grad.cu",
        "replaces": "nbodysimproject_tpu/ops/pallas_eps.py:50",
        "launches": p3["scan"]["launches"],
        "max_abs_err": max(v["err"] for v in p3["eps"].values()),
        "ms": e3["ms"], "plain_ms": e3["plain_ms"], "bound_ms": e3["bound"][0],
        "bound_by": e3["bound"][1], "library_ms": None})
    print(f"  eps d=3: 3-D dataset case (B={B_CMP}, N={N_SLOTS}, clamp) kernel "
          f"{e3['ms']:.3f} ms, plain {e3['plain_ms']:.3f} ms, bound "
          f"{e3['bound'][0]:.4f} ms ({e3['bound'][1]}); launches in the 3-D "
          f"ham_soft scan ({p3['scan']['B']} systems, {SCAN3_STEPS} steps) "
          f"{p3['scan']['launches']}, its warm median {p3['scan']['med']:.1f} "
          f"ms")
    print(f"  3-D main path (tail on): cold run {p3['cold']:.3f}s = "
          f"{B_MAIN / p3['cold']:.1f} systems/s, "
          f"fused call {p3['fused_ms']:.1f} ms, tail {p3['tail_ms']:.1f} ms, "
          f"n_tail {p3['n_tail']}; tail off {p3['off']:.3f}s; is_stable "
          f"against the JAX package {p3['agree_jax']:.4f}, against the "
          f"dataset (non-tail) {p3['agree_ds']:.4f}")
    for kind in ("mlp", "gbdt"):
        v = p3["serve"][kind]
        print(f"  3-D serving {kind}: with ic_feature_frame {v['both']:.1f} "
              f"systems/s, card against CPU max |dprob| {v['d_prob']:.3e}")
    for label, _over in BRANCHES:
        run = branches[f"run {label}"]
        cases_b = branches["cases"][label]
        for kind, replaces in (
                ("analysis", "nbodysimproject_tpu/ops/pallas_hamsoft.py:565"),
                ("megno", "nbodysimproject_tpu/ops/pallas_hamsoft.py:770")):
            # a case's bound counts the fallback's firings in its plain
            # run; the full-width run's, the share at t = 0
            ms, plain_ms, err, ns, steps, msteps, nsm, sh = cases_b[0][kind]
            b_ms, b_by = bound(kind, ns, nsm, steps, msteps, N_SLOTS, 2, sh)
            entries.append({
                "name": f"hamsoft_{kind}_multistep {label}", "route": "cuda",
                "source": "nbodysimproject_tpu_torch/csrc/hamsoft.cu",
                "replaces": replaces,
                "launches": run["launches"][f"hamsoft_{kind}_multistep"],
                "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None})
            r_ms, (rb, rby) = run["times"][kind]
            print(f"  {kind} {label}: lowest-bucket case kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}"
                  + (f"; the fallback's counted share {sh:.4f}" if sh
                     is not None else "") + "); its full-width run's "
                  f"launch {r_ms:.1f} ms, bound {rb:.3f} ms ({rby})")
        print(f"  {label} run (tail off): {run['s']:.3f}s = "
              f"{B_MAIN / run['s']:.1f} systems/s, fused call "
              f"{run['fused_ms']:.1f} ms, is_stable against soft/exact "
              f"{run['agree']:.4f}")
    for kind in ("analysis", "megno"):
        ms, plain_ms, err, ns, steps, msteps, nsm, sh = \
            branches["cases"]["reference d=3"][0][kind]
        b_ms, b_by = bound(kind, ns, nsm, steps, msteps, N_SLOTS, 3, sh)
        print(f"  {kind} reference d=3: lowest-bucket case kernel {ms:.3f} "
              f"ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"the fallback's counted share {sh:.4f}), largest |kernel - "
              f"plain| {err:.3e}")
    for name, src, replaces, case, launches, errs in (
            ("hamsoft_multistep reference", "hamsoft_multistep.cu",
             "nbodysimproject_tpu/ops/pallas_hamsoft.py:508",
             "multistep reference soft", branches["fused reference"][2],
             ("multistep reference soft", "multistep reference reflection")),
            ("hamsoft_multistep d=3", "hamsoft_multistep.cu",
             "nbodysimproject_tpu/ops/pallas_hamsoft.py:508",
             "multistep d=3", branches["chunked d=3"]["launches"],
             ("multistep d=3",)),
            ("eps_star_and_grad_fused fallback", "eps_grad.cu",
             "nbodysimproject_tpu/ops/pallas_eps.py:50",
             "eps bench clamp=True", branches["scan reference"][2],
             tuple(f"eps {w} clamp={c}" for w in ("bench", "dataset")
                   for c in (True, False))),
            ("whfast_multistep d=3", "whfast.cu",
             "nbodysimproject_tpu/ops/pallas_whfast.py:162", "whfast d=3",
             branches["whfast leg d=3"][2], ("whfast d=3",))):
        c = branches[case]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"nbodysimproject_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(branches[k]["err"] for k in errs),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
            "library_ms": None})
        print(f"  {name}: {case} case kernel {c['ms']:.3f} ms, plain "
              f"{c['plain_ms']:.3f} ms, bound {c['bound'][0]:.4f} ms "
              f"({c['bound'][1]}); launches on its path {launches}")
    for key in ("scan reference", "fused reference", "whfast leg d=3"):
        cold, med, launches = branches[key]
        print(f"  leg {key}: cold {cold:.1f} ms, warm {med:.3f} ms, "
              f"launches {launches}")
    cd3 = branches["chunked d=3"]
    print(f"  hamsoft_multistep N=8 d=3 (the 3-D use_fused_metrics=False "
          f"analysis): run {cd3['run_s']:.3f}s, {cd3['launches']} launches, "
          f"{cd3['kernel_ms']:.1f} ms in all, {cd3['launch_ms']:.3f} ms a "
          f"{cd3['launch_steps']}-step launch (bound "
          f"{cd3['launch_bound'][0]:.4f} ms)")
    print(f"  the branches' phase {branches['s']:.1f}s; the fallback's share "
          f"at t = 0 {branches['shares']}")
    # rows 1 and 4 on the scan route: their launches in phase 22's runs,
    # their compare cases at the same shapes (N = 8 dataset rows)
    ms, plain_ms, err, ns, steps, msteps, nsm, _sh = cases[1]["analysis"]
    b_ms, b_by = bound("analysis", ns, nsm, steps, msteps, N_SLOTS, 2)
    c = new_cmp["eps dataset clamp=True"]
    for name, src, replaces, launches, row in (
            ("hamsoft_analysis_multistep scan route", "hamsoft.cu",
             "nbodysimproject_tpu/ops/pallas_hamsoft.py:565",
             sum(r["launches"]["hamsoft_analysis_multistep"]
                 for r in scan["runs"].values()),
             dict(max_abs_err=max(err, cases[0]["analysis"][2]), ms=ms,
                  plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)),
            ("eps_star_and_grad_fused scan route", "eps_grad.cu",
             "nbodysimproject_tpu/ops/pallas_eps.py:50",
             sum(r["launches"]["eps_star_and_grad_fused"]
                 for r in scan["runs"].values()),
             dict(max_abs_err=max(v["err"] for k, v in new_cmp.items()
                                  if k.startswith("eps dataset")),
                  ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound"][0],
                  bound_by=c["bound"][1]))):
        entries.append({"name": name, "route": "cuda",
                        "source": f"nbodysimproject_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": launches, **row,
                        "library_ms": None})
        print(f"  {name}: launches in phase 22's runs {launches}; compare "
              f"case kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} "
              f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    c = force_cmp["N=1e5"]
    main_roll = ln_rolls[("direct_pallas", 100_000)]
    entries.append({
        "name": "pairwise_force", "route": "cuda",
        "source": "nbodysimproject_tpu_torch/csrc/pairwise_force.cu",
        "replaces": "nbodysimproject_tpu/ops/pallas_kernels.py:28",
        "launches": main_roll["launches"],
        "max_abs_err": max(v["err"] for v in force_cmp.values()),
        "ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
        "library_ms": None})
    print(f"  pairwise_force: N=1e5 case kernel {c['ms']:.3f} ms, plain "
          f"{c['plain_ms']:.3f} ms, bound {c['bound'][0]:.4f} ms "
          f"({c['bound'][1]}); launches in the direct_pallas rollout at "
          f"N=1e5 {main_roll['launches']}")
    # rows 4 and 7 on the facade's paths: their launches in phase 23's
    # runs; row 4's case the facade's own B = 1 shape (the ring, N = 7),
    # its error the largest of phase 23's eps cases; row 7's the N = 1e5
    # case above (the same shape)
    c = facade["eps_case"]
    entries.append({
        "name": "eps_star_and_grad_fused facade", "route": "cuda",
        "source": "nbodysimproject_tpu_torch/csrc/eps_grad.cu",
        "replaces": "nbodysimproject_tpu/ops/pallas_eps.py:50",
        "launches": facade["eps_launches"],
        "max_abs_err": max(x["err"] for x in facade["eps_cases"]),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
        "bound_by": c["bound"][1], "library_ms": None})
    c = force_cmp["N=1e5"]
    entries.append({
        "name": "pairwise_force facade", "route": "cuda",
        "source": "nbodysimproject_tpu_torch/csrc/pairwise_force.cu",
        "replaces": "nbodysimproject_tpu/ops/pallas_kernels.py:28",
        "launches": facade["largen"]["launches"],
        "max_abs_err": max(v["err"] for v in force_cmp.values()),
        "ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
        "library_ms": None})
    for label in FACADE_RUNS:
        f = facade[label]
        print(f"  facade {label} fast mode: {f['run_ms']:.3f} ms a step in "
              f"run(), {f['step_ms']:.3f} ms in step() (the host reads "
              f"{f['sync_share']:.3f} of it), eps launches {f['launches']} "
              f"at n_sub {f['n_sub']}")
    b = facade["batch"]
    print(f"  facade: StabilityAnalyzer full {FACADE_SA_STEPS} steps "
          f"{facade['triple d=2']['s']:.2f}s (d=2), "
          f"{facade['triple d=3']['s']:.2f}s (d=3); the sim-list view "
          f"{FACADE_BATCH} x {FACADE_BATCH_STEPS} steps {b['s']:.2f}s (eps "
          f"launches {b['launches']}, is_stable against the CPU "
          f"{b['agree']:.4f}); the large-N branch "
          f"{facade['largen']['steps_s']:.2f} steps/s at N=1e5 (tiled "
          f"launches {facade['largen']['launches']}); row 4 launches in the "
          f"phase {facade['eps_launches']}; eps facade ring B=1 case "
          f"kernel "
          f"{facade['eps_case']['ms']:.3f} ms, plain "
          f"{facade['eps_case']['plain_ms']:.3f} ms; the phase "
          f"{facade['s']:.1f}s")
    launches_at = {CLASSICAL_N: classical["launches"],
                   WL_NS[-1] + 1: wl[WL_NS[-1]]["direct_pallas"]["launches"],
                   100_000: main_roll["launches"], 1_000_000: 1}
    for n, (ms, S, (b_ms, b_by)) in alone.items():
        print(f"  pairwise_force alone N={n}: {ms:.4f} ms ({S} slice(s)), "
              f"bound {b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x; launches on "
              f"its path {launches_at[n]}")
    c8 = chunked_cases[0]["multistep"]
    print(f"  hamsoft_multistep N=8 (the use_fused_metrics=False analysis): "
          f"run {chunked['run_s']:.3f}s, {chunked['launches']} launches, "
          f"{chunked['kernel_ms']:.1f} ms in all (bound "
          f"{chunked['bound_ms']:.3f} ms), {chunked['launch_ms']:.3f} ms a "
          f"{chunked['launch_steps']}-step launch (bound "
          f"{chunked['launch_bound'][0]:.4f} ms); lowest-bucket case kernel "
          f"{c8[0]:.3f} ms, plain {c8[1]:.3f} ms")
    for policy in ("soft", "reflection"):
        med = legs[f"ham_soft fused {policy}"][1]
        c3 = new_cmp[f"multistep {policy}"]
        print(f"  hamsoft_multistep N=3 {policy}: bench leg {med:.3f} ms; "
              f"compare case kernel {c3['ms']:.3f} ms, plain "
              f"{c3['plain_ms']:.3f} ms, bound {c3['bound'][0]:.4f} ms")
    for N, row in ln_evals.items():
        print(f"  bench_largen N={N}: P3M {row['p3m_ms']:.3f} ms (short "
              f"range {row['short_ms']:.3f} ms; error "
              f"median {row['p3m_med']:.3e}, p99 {row['p3m_p99']:.3e}), "
              f"kernel {row['kernel_ms']:.3f} ms (bound "
              f"{row['bound'][0]:.3f} ms), dense "
              f"{row.get('dense_ms', float('nan')):.3f} ms")
    for (mode, N), row in ln_rolls.items():
        print(f"  rollout {mode} N={N}: {row['steps']} steps, warm median "
              f"{row['med']:.3f} ms = {row['steps'] / (row['med'] / 1e3):.3f}"
              f" steps/s (cold {row['cold']:.1f} ms)")
    print(f"  classical verlet N={CLASSICAL_N}: tiled {classical['kernel_ms']:.1f}"
          f" ms, dense {classical['dense_ms']:.1f} ms, position difference "
          f"{classical['diff']:.3e}")
    for N, row in wl.items():
        print(f"  WHFast N={N}: direct_pallas "
              f"{row['direct_pallas']['steps_s']:.2f} steps/s (drift "
              f"{row['direct_pallas']['drift']:.3e}), p3m "
              f"{row['p3m']['steps_s']:.2f} steps/s (drift "
              f"{row['p3m']['drift']:.3e}); kick error p50/p99/max "
              f"{row['kick'][0]:.3e}/{row['kick'][1]:.3e}/{row['kick'][2]:.3e}")
    for leg, (cold, med, la, dr) in legs.items():
        print(f"  leg {leg}: cold {cold:.1f} ms, warm median {med:.3f} ms, "
              f"drift(sys0) {dr:.3e}")
    print(f"  main path (tail on): warm median {t_med:.3f}s = "
          f"{B_MAIN / t_med:.1f} systems/s; tail off "
          f"{t_off:.3f}s ({B_MAIN / t_off:.1f} systems/s); at "
          f"{scan['probe_steps']} steps (phase 22) {scan['fused_s']:.3f}s, "
          f"the tail after the fused call {scan['serial_s']:.3f}s "
          f"({B_MAIN / scan['serial_s']:.1f} systems/s)")
    print(f"  the scan's lanes in one call {scan['grouping'][0]:.3f}s, one "
          f"call per ladder bucket {scan['grouping'][1]:.3f}s "
          f"({SCAN_GROUP_STEPS} step, core)")
    for label, run in scan["runs"].items():
        tm = run["tm"]
        print(f"  scan route {label} ({run['steps']} steps): "
              f"{run['s']:.3f}s = {B_MAIN / run['s']:.1f} systems/s; engine "
              f"{tm['engine']}, lanes fused {tm['fused_lanes']} / scan "
              f"{tm['scan_lanes']} / tail {tm['n_tail']} / aborted "
              f"{tm['n_early_exit']}; launches {run['launches']}")
    for label, c in scan["cpu"].items():
        print(f"  scan route card against CPU, {label}: is_stable "
              f"{c['agree']:.4f}, rows outside the tolerance {c['outside']}"
              f"; card {c['card_s']:.2f}s, CPU {c['cpu_s']:.2f}s")
    print(f"  the scan route's phase {scan['s']:.1f}s")
    for kind, (ms, per_trip) in main_ms.items():
        print(f"  {kind} kernel on the main path: {ms:.1f} ms, {per_trip:.3f}"
              f" us per trip of the deepest lane; top-bucket case "
              f"{cases[1][kind][0]:.3f} ms")
    print(f"  generators: diverse_population({B_MAIN}) {gen_out['ms']:.3f} ms"
          f" on the card (cold {gen_out['cold_ms']:.3f} ms)")
    print(f"  bench population ({BENCH_STEPS} steps, tail on): cold run "
          f"{bench['cold']:.3f}s = {B_MAIN / bench['cold']:.1f} systems/s,"
          f" launches {bench['launches']}; the pipeline entry point "
          f"{bench['entry_s']:.3f}s, launches {bench['launches_entry']}")
    for kind in ("mlp", "gbdt"):
        v = serving[kind]
        print(f"  serving {kind}: predict_frame {v['rate']:.1f} systems/s, "
              f"with ic_feature_frame {v['both']:.1f} systems/s = "
              f"{v['ratio']:.1f}x the bench population's analysis at "
              f"{BENCH_STEPS} steps, {v['ratio_main']:.1f}x the main path's "
              f"at {N_STEPS}; card against CPU max |dprob| "
              f"{v['d_prob']:.3e}")
    sh = training["sharded"]
    w_s = ", ".join(f"{w['s']:.3f}" for w in sh["workers"])
    w_l = [(int(w["analysis"]), int(w["megno"])) for w in sh["workers"]]
    entries += slot_report
    for e in slot_report:
        print(f"  {e['name']}: compare case kernel {e['ms']:.3f} ms, plain "
              f"{e['plain_ms']:.3f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}), largest |kernel - plain| "
              f"{e['max_abs_err']:.3e}; launches on its path {e['launches']}")
    a, b, c = slots["a"], slots["b"], slots["c"]
    print(f"  every slot count (phase 25, {slots['s']:.1f}s): (a) {SLOTS_PAD} "
          f"slots {a['s']:.3f}s, fused call {a['fused_ms']:.1f} ms, "
          f"{a['differ']} rows not bitwise, is_stable {a['agree']:.4f}; (b) "
          f"{SLOTS_CUT} slots {b['s']:.3f}s, fused call {b['fused_ms']:.1f} "
          f"ms, {b['differ']} rows not bitwise, {b['left_out']} left out, "
          f"is_stable {b['agree']:.4f}; (c) {SLOT_POP_B} x {SLOT_POP_STEPS} "
          f"steps {c['s']:.3f}s, fused call {c['fused_ms']:.1f} ms, "
          f"{c['us']:.3f} us per deepest trip (n_sub {c['nsm']}), finite "
          f"share {c['finite']:.4f}")
    for what, w in [("(c)", c["witness"])] + [
            (f"(e) {k}", v[2]) for k, v in slots["e"].items()]:
        print(f"  {what} at {w['steps']} + {w['megno_steps']} steps: rows "
              f"bit for bit {w['exact']}; outside STATE_TOL of float64 "
              f"{w['outside']}; the plain version against itself reversed "
              f"parts on {w['self_parts']} rows")
    print(f"  dataset-to-classifier (phase 24, {training['s']:.1f}s): sharded "
          f"generation {SHARD_SYSTEMS} x {SHARD_STEPS} steps unsharded "
          f"{sh['t_one']:.3f}s (launches {sh['launches']}) beside two "
          f"workers ({w_s}s, launches {w_l}), {sh['t_all']:.3f}s wall"
          f"; MLP {training['epochs']} epochs in {training['t_train']:.3f}s "
          f"({1e3 * training['t_train'] / training['steps']:.4f} ms a step), "
          f"AUROC {training['mlp']['auroc']:.4f}, parity "
          f"{training['parity']:.3e}; GBDT AUROC "
          f"{training['gbdt']['auroc']:.4f}; calibrated BA "
          f"{training['calib_ba']:.4f}")
    phase("done")
    print(f"  total {time.perf_counter() - T0:.1f}s")
    print(card)
    print(json.dumps({"kernels": entries, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--facade-cpu-references"]:
        sys.exit(facade_cpu_references(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--mlp-parity-cpu"]:
        sys.exit(mlp_parity_cpu(sys.argv[2]))
    if sys.argv[1:2] == ["--fit-gbdt-reference"]:
        sys.exit(fit_gbdt_reference())
    if sys.argv[1:2] == ["--shard-worker"]:
        sys.exit(shard_worker(*sys.argv[2:9]))
    sys.exit(main())
