#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``redcliff_tpu_torch``).

Drives the port's main paths on one CUDA card — serving a fitted model,
fitting one, fitting a coefficient grid, fitting it durably on the bucket
ladder, running one array task from cached-args files, scoring the
fitted models through the evaluation layer, fitting the paper's
baseline families as array tasks, DCSFA-NMF and DYNOTEARS among them,
generating synthetic data on the card, running the paper's two
accuracy flows from curation to scores, the Table-2 discovery flow and
the analysis layer on the host, and the time-series transformer on the
card — and holds every kernel on them against its plain PyTorch version.
Phases, one JSON line each:

1. build: the factor-mix and GL-prox CUDA kernels from
   ``redcliff_tpu_torch/ops/csrc`` (into ``build/torch_kernels/``), built
   at once, each timed; the card's name and power limit.
2. kernel: each kernel against its plain version on the card — factor mix
   at the serve shapes, the eval readout's (S = 240) and the training
   shapes (forward and autograd
   backward, full and remainder batch, M = 100, 10 and 7, a p offset by
   one float), GL prox functional and in place (the output aliasing the
   input) at the training block and the cMLP-FM GISTA block (10, 50, 10,
   2), the off-tile shapes, slabs walked in
   chunks, blocks offset by one float, and on an all-zero and an
   at-threshold group; the lane forms of both at the grid's shapes (27
   lanes): the mix at the training batch and the remainder batch, on a p
   offset by one float, the gradients of its vmap rule and of its autograd
   Function; the prox in
   place with mixed gates (lanes off, a lane with a zero group), on a
   block offset by one float and on slabs walked in chunks, one launch
   per call for all lanes — max abs error beside the tolerance and the
   launch plan each case took; CUDA-event times of the kernel, one library
   call where one exists and the plain version, in turns, beside the bound
   and the launch floor (one ``x.zero_()``), and at the synSys flow's two
   shapes (B=128 K=2 M=6, S=85 K=2 M=36) each one's device time alone
   (``torch.profiler``); the host cost of each piece of the factor mix's
   launch path.
3. serve: a REDCLIFF-S model at the D4IC headline widths (10 channels,
   gen_lag 4, embed_lag 16, 5 factors, DGCNN embedder with 3 graph-conv
   layers of 100 hidden nodes, 2 sims) from random weights (seed 0), saved
   as an artifact and served through ``ServeService.from_artifact`` with 64
   slots to 48 streams, one of which turns NaN after warm-up.
4. check: the card's serve outputs against the port's CPU path.
5. train: the published D4IC REDCLIFF-S configuration at full width
   (gen_hidden 25, batch 128, the paper's coefficients rescaled as the
   driver does, GL prox on) fitted through ``RedcliffTrainer.fit`` on
   numpy-made D4IC-shaped data from a seed, depth cut to 1 pretrain + 1
   acclimation + 2 combined epochs. Checks finite losses, no skipped step,
   no zeroed group, kernel launch counts against the steps and forwards
   the fit ran, the best epoch, and that the artifact loads.
6. train_check: the same 8 guarded combined steps from the same weights
   and batches on the card and on the CPU, losses and params compared.
7. grid: the published D4IC coefficient grid (gen_lr x ADJ_L1 x COS_SIM,
   3 x 3 x 3 = 27 points, rescaled as train/driver.py does) of the train
   phase's model, data and depth, fitted through ``run_coefficient_grid``
   from one point's weights replicated over the lanes, in the default
   stream mode, which is the epoch engine on the card (each epoch one
   CUDA-graph replay of its full batches and one of the remainder, the
   same for validation). Checks the mode and the dispatches against
   ``dispatch_budget``, finite results, no skipped step or quarantined
   lane, both kernels' executions against the steps and forwards the grid
   ran (plus each capture's warm-up step), and one lane against the port's
   per-point ``RedcliffTrainer`` fit of the same point from the same
   weights on the card.
8. grid_check: the same 8 grid steps (27 lanes) from the same weights and
   batches on the card and on the CPU, losses and per-lane updates
   compared.
9. grid_stream: the grid phase's points, model, data and weights at 12
   epochs (1 pretrain, 1 acclimation, 10 combined; lookback 50 keeps the
   published 50-epoch stop-after span, so no lane stops), fitted three
   times: ``per_batch`` (eager steps), ``auto`` (the epoch engine) and
   ``kscan`` (``scan_batches`` 4). For each: the mode, train and
   validation dispatches against ``dispatch_budget``, graphs captured and
   capture ms, epoch ms by phase, fit wall, peak device memory, kernel
   executions; the captured fits' max abs differences from the per_batch
   fit (val history, best criteria, best params; within the ROADMAP grid
   bars) and equal best epochs, active lanes and failures.
10. grid_durable: the published grid through ``RedcliffGridRunner.fit`` on
   the bucket ladder (27 points at width 32) in the epoch engine, a
   checkpoint every epoch, and wall-clock budgets that evict points 15-26
   at the first epoch boundary: checks the eviction (cause ``deadline``,
   original ids, each retired lane through ``on_lane_retire``), the
   compaction to width 16 and the recapture of the programs there, that
   the lane prox is handed aligned contiguous blocks (its TMA path),
   launch counts by width, then a fit stopped after 2 epochs and resumed
   to 4 (its programs captured anew) against the uninterrupted one (same
   decisions, params within 1e-6 relative; bitwise equality printed); the
   eager step's host ms and device us at widths 32 and 16, and the
   checkpoint's bytes, write and load ms.
11. array_task: one array task of the published D4IC REDCLIFF-S
   cached-args (depth cut as in train) through
   ``train/driver.py:set_up_and_run_experiments`` on a fold of the train
   phase's data written by the port's ``save_cv_split``; checks the
   artifact, its reload through ``eval/model_io.py``, its GC readout and
   the factor-mix launches against the fit's forwards (the array task sets
   no prox, here as in the JAX package, so it launches no GL prox).
12. eval: the evaluation layer (``redcliff_tpu_torch/eval``) on the
   grid's and the array task's models. Each of the 27 points' best params
   is written as ``grid_point<i>/final_best_model.bin`` (as
   ``experiments/d4ic_grid_search.py:231-258`` does) and scored by
   ``evaluate_algorithm_on_fold`` against the sVAR's 5 true graphs: each
   point's off-diagonal optimal F1, the criteria winner (argmin of the
   grid's best criteria) and the oracle best. ``select_best_models`` over
   the array task's run root. The array task's model read out by
   ``evaluate_dynamic_readouts_on_fold`` over 16 switching recordings of
   256 steps from the same state VARs (240 windows each: one embed and
   one ``graph_mix`` per recording), ``average_factor_scoring_by_state``,
   ``get_model_gc_score_estimates`` on one window (one forward) and
   ``evaluate_fold_system_level``. The same artifacts through the port's
   CPU path: optimal-F1 stats within 1e-6, everything downstream of the
   DGCNN embed within 1e-4, the same winners; factor-mix launches = 16
   ``graph_mix`` + 1 forward, GL prox 0; eval wall per grid point and
   readout windows per second.
13. baselines: the paper's baseline families, each as array task 1
   through ``set_up_and_run_experiments`` from its published D4IC
   cached-args (cMLP, cLSTM, DGCNN, NAVAR_CMLP, NAVAR_CLSTM, and
   REDCLIFF_S_CLSTM: REDCLIFF-S with cLSTM factors), depth cut only, on
   2,000 / 500 recordings of 48 steps from the train phase's 5-state VAR;
   then a cMLP-FM GISTA fit through ``Trainer`` with the GL prox. One line
   per family: fit wall, steps/s, epochs, best epoch; checks finite
   losses, no skipped step, the artifact's reload through
   ``eval/model_io.py`` and finite (C, C) GC estimates, the factor-mix
   executions of REDCLIFF_S_CLSTM against its forwards, and the GISTA
   fit's GL-prox executions against its applied steps with no zeroed
   group.
14. baselines_check: 8 guarded steps of each family from the same weights
   and batches on the card and on the CPU, losses and params compared at
   the train_check bars.
15. dcsfa: DCSFA-NMF from the published d4IC cached-args (10 nodes, 500
   ``vanilla`` directed-spectrum features, 5 components, h 256, batch
   128, AdamW; depth cut to 2 encoder-pretrain and 4 joint epochs) as
   array task 1 through ``set_up_and_run_experiments`` on the baselines
   phase's recordings: the features are host work inside the task, the
   NMF pretrain and every step run on the card. Checks the fit log's
   steps, finite histories, the artifact's reload (``(model, params,
   state)``), the 5 component graphs from ``get_model_gc_estimates``,
   scored against the 5 true graphs by ``evaluate_algorithm_on_fold``;
   neither kernel launches. Prints the NMF pretrain ms, encoder-pretrain
   and joint steps/s and epoch ms.
16. dcsfa_check: on the features of 512 training recordings, the NMF
   pretrain's component order from the card and the CPU (equal), then 8
   joint steps from the same post-NMF params and batches on both: losses
   and params at the train_check bars, the BatchNorm-cancelled encoder
   bias (whose gradient is rounding noise that AdamW turns into steps of
   about lr) within its random-walk bound.
17. dynotears: DYNOTEARS_Vanilla from its published cached-args as array
   task 1 on the same recordings, on the host (the family does no device
   work in either package): wall per recording, the averaged graph read
   out and scored; neither kernel launches.
18. data_gen: the device half of ``data/synthetic.py``
   (``generate_synthetic_dataset``, one batched program over all
   recordings and states) at the synSys accuracy study's size (1,040 +
   240 recordings, T 100, burn-in 50, 2 states of 6 nodes, gaussian,
   OneHot) and at one D4IC network's (150 recordings, T 48, burn-in 50, 1
   state of 10 nodes, Oracle): wall ms (first call and the mean of 5),
   recordings/s, the device's busy and idle share; shapes, finite values
   and labels checked; neither kernel launches.
19. data_gen_check: at both sizes, the unit draws made on the card and
   copied to the CPU, the generator's body run on each: per recording
   max |dX| within 1e-5 of the largest amplitude, Oracle labels within
   1e-6, OneHot labels equal off the (counted) ties.
20. accuracy_synsys: the synSys twin
   (``redcliff_tpu_torch/experiments/accuracy_parity_synsys.py``) with
   the JAX script's ``--smoke``, one fold, ``--dynamic --algs ref``:
   curation, the array tasks of REDCLIFF-S, cMLP, cLSTM, DGCNN and
   DCSFA-NMF, the cross-algorithm battery, the dynamic readouts. Checks
   every artifact's reload and finite params, finite F1s, factor-mix
   executions = the REDCLIFF task's forwards (from its meta data) + one
   ``graph_mix`` per dynamic-readout recording (16), and no GL prox (no
   family of the flow sets one, in either package). One fold keeps the
   phase inside its time: the JAX smoke runs three.
21. accuracy_d4ic: the D4IC twin with ``--smoke --folds 1 --algs core``:
   five networks' recordings from the device generator, the D4IC
   mixture, the array tasks of both REDCLIFF-S variants, cMLP, cLSTM,
   DGCNN and DCSFA-NMF, the battery; the same checks (factor-mix
   executions = both REDCLIFF tasks' forwards).
22. discovery: the Table-2 flow on the host
   (``eval/supervised_discovery.py``): one synSys 6-2-2 fold curated at the
   study's size by the port's data layer, its held-out split (240
   recordings of (100, 6), two states, OneHot) through
   ``run_supervised_discovery_evaluation`` over SLARAC, QRBS, SELVAR (its
   native C++ core, built with g++ into ``build/host_native/``; a failed
   build fails the phase) and PCMCI against the fold's true factor
   graphs; LASAR is left out (it needs scikit-learn, which the card's
   machine lacks). The native SELVAR core held to the numpy core on the
   same input; ``run_d4ic_regime_pcmci_experiment`` on one D4IC network's
   recordings from the device generator (150 of (48, 10)). Wall per
   algorithm, optimal F1 and ROC-AUC per regime factor; neither kernel
   launches.
23. analysis: the analysis layer on the host over the accuracy_synsys
   phase's ``evals/`` tree (``run_cross_experiment_analysis`` without
   figures, ``summarize_off_diag_f1``, ``write_cross_experiment_report``,
   ``factor_selection_table`` over its REDCLIFF-S runs): the condensed
   off-diagonal F1 means equal the twin's JSON, no figure is written;
   neither kernel launches.
24. ts_transformer: the time-series transformer at mvts_transformer's
   published defaults (d_model 64, 8 heads, 3 layers, feed-forward 256,
   fixed positions, gelu, BatchNorm) on 128 synSys windows (T 100, 6
   features): the encoder and the 2-class classiregressor, forwards card
   vs CPU at the f32 bars (BatchNorm and LayerNorm, with and without a
   padding mask), 20 Adam steps of the classifier loss on each (loss
   histories at the trainer bars); ms per forward and per step, peak
   device memory; neither kernel launches.
25. telemetry: the telemetry spine through the normal entry points, on
   the train phase's model, data, knobs and weights. (1) A per-point fit
   through ``RedcliffTrainer.fit`` with a ``save_dir``,
   ``profile_window="epoch:2"``, ``REDCLIFF_QUALITY=1`` and the truth
   graphs: every ``metrics.jsonl`` record validates against the port's
   registry, the event sequence is the expected one, and the Chrome trace
   of the window names both kernels, each as many times as its wrapper
   counted over the window; the predicted bytes beside the measured peak.
   (2) The same fit with telemetry off equals it bitwise; both walls.
   (3) The published grid (27 lanes, ladder 32, epoch engine) with a
   ``log_dir``, the truth and a window over a capture epoch (1), then over
   a replayed epoch (3): records valid, ``quality`` keyed by the 27 point
   ids, ``compile`` events counting the captures, both kernels in each
   trace at the counters' counts. (4) Two fits armed with ``nan_batch:40``
   and ``skip_update:40`` end bitwise equal. The earlier phases run with
   ``REDCLIFF_QUALITY=0`` (their counts are their fits' forwards; the
   quality readout adds one per check window).
26. runtime: the production runtime, on the train phase's model, data and
   weights, under a fresh autotune store and cost-model store
   (``REDCLIFF_AUTOTUNE_DIR``, ``REDCLIFF_COST_MODEL_DIR``). (1) The
   launch-plan autotuner (``ops/autotune.py``): each kernel's threads-per-
   block ladder searched at the train shapes (B=128 K=5 M=10; the block
   (5, 10, 25, 10, 4)) and at the grid's lane shapes at width 32, each
   candidate's median us (CUDA events) and max abs error against the
   plain version beside the bar, its threads read back from the cached
   plan; the factor mix bitwise equal across tiles; a second
   ``RedcliffTrainer`` construction reuses both winners with 0 search
   steps; a per-point fit with the winners launches both kernels as the
   train phase counts them. (3) The training split written as a shard
   file (the validation split as four), fitted through
   ``ShardedBatchDataset`` with ``REDCLIFF_WATCHDOG`` armed: every core
   heartbeat stamps, the params within the trainer bars of the
   ArrayDataset fit (the same batch order), both kernels launched eagerly;
   a child armed with ``hang_in:prefetch:60`` exits with the taxonomy's
   hang code (19), leaving a ``hang`` event and a ``flight_record.json``.
   (2) The grid_durable configuration with ``async_checkpointing`` on and
   off: results bitwise equal, checkpoints equal after ``read_checkpoint``,
   a resume from the async checkpoint against the uninterrupted fit; the
   main thread's stall per save (``ckpt_barrier_stall_ms``,
   ``ckpt.submit_barrier``) beside the synchronous write ms. (4) Those
   fits wrote the cost-model store (rows under platform ``cuda`` at widths
   32 and 16); a fit with ``REDCLIFF_PREDICTIVE=1`` logs ``policy`` and
   ``cost_model`` events: each decision and the MAPE.

Launch counts are reset just before each main path (serve, train, grid,
each grid_stream fit, grid_durable, array_task, eval, each baseline task
and the GISTA fit, dcsfa, dynotears, data_gen, accuracy_synsys,
accuracy_d4ic, discovery, analysis, ts_transformer, each telemetry fit,
each runtime fit) and read just after;
the kernel-phase launches do not count. A count is executions on the
device: a launch captured into a CUDA graph counts at each replay of the
graph (and the warm-up step before each capture ran and counts). Then a
``kernels`` line, the ``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script
exits non-zero and prints no ``ok`` line. It also refuses to run without
CUDA or outside a checkout of the repository.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one NVIDIA card. ``--profile`` adds ``profile`` phases after the
checks: each kernel's, each library call's and the floor's device time
alone, a ``torch.profiler`` window of serve ticks, one of training steps
and one of grid steps (device busy time, idle share, top device ops) with
one combined epoch replayed by the epoch engine beside them, the
ops of one prox step as the trainer runs it (one kernel, no allocation or
copy), each lane kernel's device time alone beside its library call
and plain version, a window of each baseline family's steps and one of
DCSFA joint steps.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# non-tensor-core float32 rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# kernel vs plain version: f32 both, a different summation order
RTOL, ATOL = 1e-5, 1e-6
# card vs CPU through the DGCNN embed and sigmoid(10 x)
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-5
# card vs CPU over 8 training steps: f32 both, another summation order in
# every reduction (the DGCNN normalization, the GEMMs, the group norms of
# the prox), drifting through two Adams and the prox step after step — the
# multi-step bar of the CPU tests against JAX (tests/test_torch_train.py)
TRAIN_LOSS_RTOL, TRAIN_LOSS_ATOL = 1e-4, 1e-5
TRAIN_PARAM_ATOL = 1e-4

CONFIG = dict(
    num_chans=10, gen_lag=4, gen_hidden=(32,), embed_lag=16,
    embed_hidden_sizes=(0,), num_factors=5, num_supervised_factors=5,
    factor_score_coeff=2.0, factor_cos_sim_coeff=0.05,
    factor_weight_l1_coeff=0.01, adj_l1_reg_coeff=0.001,
    factor_score_embedder_type="DGCNN", dgcnn_num_graph_conv_layers=3,
    dgcnn_num_hidden_nodes=100,
    primary_gc_est_mode="conditional_factor_fixed_embedder",
    num_sims=2, training_mode="combined")
CAPACITY = 64
STREAMS = 48
ANSWERED = 32

# the published D4IC REDCLIFF-S model (experiments/accuracy_parity_d4ic.py
# REDCLIFF_ARGS, from the reference's
# train/REDCLIFF_S_CMLP_d4IC_BSCgs1_cached_args.txt) at full width; loss
# coefficients rescaled as train/driver.py:62-83 does (cos-sim / sum(1..K-1),
# adj-L1 / (K sqrt(C^2 - 1)))
K_TRAIN, C_TRAIN = 5, 10
TRAIN_CONFIG = dict(
    num_chans=C_TRAIN, gen_lag=4, gen_hidden=(25,), embed_lag=16,
    embed_hidden_sizes=(0,), num_factors=K_TRAIN,
    num_supervised_factors=K_TRAIN, forecast_coeff=10.0,
    factor_score_coeff=100.0,
    factor_cos_sim_coeff=1.0 / sum(range(1, K_TRAIN)),
    factor_weight_l1_coeff=1e-3,
    adj_l1_reg_coeff=1.0 / K_TRAIN / (C_TRAIN ** 2 - 1.0) ** 0.5,
    use_sigmoid_restriction=False, sigmoid_eccentricity_coeff=10.0,
    factor_score_embedder_type="DGCNN", dgcnn_num_graph_conv_layers=3,
    dgcnn_num_hidden_nodes=100,
    primary_gc_est_mode="conditional_factor_fixed_embedder",
    forward_pass_mode="apply_factor_weights_after_sim_completion",
    num_sims=1,
    training_mode="pretrain_embedder_then_acclimate_factors_then_combined",
    # depth cut: 50 -> 1 pretrain, 15 -> 1 acclimation epochs
    num_pretrain_epochs=1, num_acclimation_epochs=1)
# a GL threshold lr * lam = 2e-3 per factor step: it shrinks every group
# but zeroes none within the run (a zeroed group stalls the fit in both
# packages: ROADMAP queue 3)
PROX_LAM = 4.0
TRAIN_KNOBS = dict(
    batch_size=128, gen_lr=5e-4, gen_eps=1e-4, gen_weight_decay=1e-4,
    embed_lr=2e-4, embed_eps=1e-4, embed_weight_decay=1e-4,
    # depth cut: max_iter 1000 -> 4, check_every 10 -> 1
    max_iter=4, check_every=1, lookback=1,
    stopping_criteria_forecast_coeff=10.0,
    stopping_criteria_factor_coeff=100.0,
    stopping_criteria_cosSim_coeff=1.0,
    prox_penalty="GL", prox_lam=PROX_LAM, seed=0)
# D4IC-shaped windows of (embed_lag + 1, 10); neither count divides by the
# batch, so both streams end in a short remainder batch (80 and 116)
N_TRAIN, N_VAL = 2000, 500
TRAIN_CHECK_STEPS = 8

# the published D4IC coefficient grid (experiments/d4ic_grid_search.py:70-72)
# over the train phase's model: raw axes, each point rescaled by the
# helper of train/driver.py with the stopping cos-sim coefficient
# mirroring the loss coefficient (the reference's experiment scripts' rule)
GRID_GEN_LR = (0.0002, 0.0005, 0.002)
GRID_ADJ_L1 = (1.0, 0.1, 0.01)
GRID_COS_SIM = (10.0, 1.0, 0.1)
GRID_LANES = len(GRID_GEN_LR) * len(GRID_ADJ_L1) * len(GRID_COS_SIM)
# lane 10 = (5e-4, 1.0, 1.0): the published BSCgs1 point itself
GRID_OWN_LANE = 10
GRID_CHECK_STEPS = 8
GRID_CHECK_REL = 1e-3
# a grid lane against the per-point fit of its point on the card: the same
# arithmetic in another program (vmapped GEMMs and reductions reorder
# sums), over the whole 64-step fit; the val losses within the multi-step
# bar of train_check, the params within 64 steps' drift of it; the best
# criteria within the JAX package's own grid-vs-trainer bar
# (tests/test_parallel_grid.py:281): the trainer's GC tracker forms the
# cosine stopping term on the host in float64
GRID_LANE_LOSS_RTOL, GRID_LANE_LOSS_ATOL = 1e-4, 1e-5
GRID_LANE_CRIT_RTOL = 2e-3
GRID_LANE_PARAM_ATOL = 5e-4


# grid_stream: the grid phase's 27 points, model, data and seed-0 weights
# at a depth of STREAM_MAX_ITER epochs (1 pretrain, 1 acclimation, the rest
# combined) fitted in the three stream modes: per_batch (eager steps), the
# default "auto" (the epoch engine on the card) and kscan with
# STREAM_SCAN_BATCHES. lookback 50 at check_every 1 keeps the published
# stop-after span (lookback 5 x check_every 10 = 50 epochs), so no lane
# stops within the depth and the grid stays at width 32. The captured fits
# must make the per_batch fit's decisions, their values within the grid
# bars of ROADMAP "Tolerances" (0 difference is predicted: the same
# kernels in the same order)
STREAM_MAX_ITER = 12
STREAM_LOOKBACK = 50
STREAM_SCAN_BATCHES = 4
# the points the guard quarantines (nonfinite_grad, epochs 4-9): the nine
# gen_lr 2e-3 lanes. The JAX grid quarantines the same points at the same
# epochs with the same cause from the same weights and data
# (tests/test_torch_grid_stream.py::
# test_published_grid_quarantine_matches_jax); every other lane stays finite
STREAM_QUARANTINED = tuple(range(18, 27))
STREAM_HIST = dict(rtol=1e-4, atol=1e-5)
STREAM_PARAMS = dict(rtol=1e-4, atol=1e-4)

# grid_durable: the published grid on the bucket ladder (27 points at
# width 32), a checkpoint every epoch, and wall-clock budgets that evict
# points 15-26 at the first epoch boundary, so the 15 survivors compact to
# width 16; then a fit stopped after DURABLE_RESUME_AT epochs and resumed
# to the horizon, held to the uninterrupted one: the same decisions,
# params within DURABLE_PARAM_REL relative (max abs error over the leaf's
# max abs value; the same programs on the same inputs)
DURABLE_LIVE = 15
DURABLE_DEADLINES = (1e6,) * DURABLE_LIVE + (1e-3,) * (27 - DURABLE_LIVE)
DURABLE_RESUME_AT = 2
DURABLE_PARAM_REL = 1e-6
DURABLE_PROFILE_STEPS = 8

# array_task: the published D4IC REDCLIFF-S cached-args
# (experiments/accuracy_parity_d4ic.py:70-97, from the reference's
# train/REDCLIFF_S_CMLP_d4IC_BSCgs1_cached_args.txt) with the train
# phase's depth cut, run as array task 1 through
# train/driver.py:set_up_and_run_experiments on a fold of the train
# phase's data written by the port's save_cv_split
ARRAY_TASK_MODEL = "REDCLIFF_S_CMLP"
ARRAY_TASK_DATA = "d4IC_sVAR_fold0"
ARRAY_TASK_ARGS = {
    "output_length": "1", "batch_size": "128", "max_iter": "1000",
    "lookback": "1", "check_every": "10", "verbose": "0", "num_sims": "1",
    "num_factors": "5", "num_supervised_factors": "5",
    "wavelet_level": "None", "gen_hidden": "[25]", "gen_lr": "0.0005",
    "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "gen_lag_and_input_len": "4", "FORECAST_COEFF": "10.0",
    "FACTOR_SCORE_COEFF": "100.0", "FACTOR_COS_SIM_COEFF": "1.0",
    "FACTOR_WEIGHT_L1_COEFF": "0.001", "ADJ_L1_REG_COEFF": "1.0",
    "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
    "DAGNESS_NODE_COEFF": "0.0",
    "primary_gc_est_mode": "conditional_factor_fixed_embedder",
    "forward_pass_mode": "apply_factor_weights_after_sim_completion",
    "training_mode": "pretrain_embedder_then_acclimate_factors_then_combined",
    "num_pretrain_epochs": "50", "num_acclimation_epochs": "15",
    "factor_score_embedder_type": "DGCNN", "embed_hidden_sizes": "[0]",
    "embed_num_hidden_nodes": "100", "embed_num_graph_conv_layers": "3",
    "embed_lr": "0.0002", "embed_eps": "0.0001",
    "embed_weight_decay": "0.0001", "embed_lag": "16",
    "use_sigmoid_restriction": "0", "sigmoid_eccentricity_coeff": "10.0",
    "prior_factors_path": "None", "cost_criteria": "CosineSimilarity",
    "unsupervised_start_index": "0", "max_factor_prior_batches": "10",
    "stopping_criteria_forecast_coeff": "10.",
    "stopping_criteria_factor_coeff": "100.",
    "stopping_criteria_cosSim_coeff": "1.", "deltaConEps": "0.1",
    "in_degree_coeff": "1.", "out_degree_coeff": "1.",
}
ARRAY_TASK_CUTS = {"num_pretrain_epochs": "1", "num_acclimation_epochs": "1",
                   "max_iter": "4", "check_every": "1"}

# baselines: the paper's baseline families as array tasks through
# train/driver.py:set_up_and_run_experiments from their published D4IC
# cached-args (experiments/accuracy_parity_d4ic.py: CMLP_ARGS :98-108,
# CLSTM_ARGS :110-120, DGCNN_ARGS :122-131, NAVAR_ARGS :152-153 with the
# synSys transcription's widths, accuracy_parity_synsys.py:93-99) and
# REDCLIFF-S with cLSTM factors (the REDCLIFF args :70-96 in the cLSTM
# schema: LSTM width 25, context 4 = gen_lag), on 10-channel recordings of
# BASELINE_T steps (:66-67) from the train phase's 5-state sparse VAR, with
# one-hot state labels for DGCNN; depth cut only (BASELINE_CUTS)
BASELINE_T = 48
BASELINE_DATA = "d4IC_sVAR48_fold0"
BASELINE_ARGS = {
    "cMLP": {
        "output_length": "1", "num_sims": "1", "embed_hidden_sizes": "[60]",
        "batch_size": "128", "gen_eps": "0.0001",
        "gen_weight_decay": "0.0001", "max_iter": "1000", "lookback": "1",
        "check_every": "10", "verbose": "0", "num_factors": "1",
        "num_supervised_factors": "0", "wavelet_level": "None",
        "gen_hidden": "[50]", "gen_lr": "0.0005",
        "gen_lag_and_input_len": "2", "FORECAST_COEFF": "1.0",
        "FACTOR_SCORE_COEFF": "0.0", "ADJ_L1_REG_COEFF": "1.0",
        "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
        "DAGNESS_NODE_COEFF": "0.0"},
    "cLSTM": {
        "output_length": "1", "num_sims": "1", "embed_hidden_sizes": "[10]",
        "batch_size": "128", "gen_eps": "0.0001",
        "gen_weight_decay": "0.0001", "max_iter": "1000", "lookback": "3",
        "check_every": "5", "verbose": "0", "num_factors": "1",
        "num_supervised_factors": "0", "wavelet_level": "None",
        "gen_hidden": "25", "gen_lr": "0.0005", "context": "2",
        "max_input_length": "4", "FORECAST_COEFF": "1.0",
        "FACTOR_SCORE_COEFF": "0.0", "ADJ_L1_REG_COEFF": "10.0",
        "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
        "DAGNESS_NODE_COEFF": "0.0"},
    "DGCNN": {
        "batch_size": "128", "gen_eps": "0.0001",
        "gen_weight_decay": "0.0001", "max_iter": "1000", "lookback": "1",
        "check_every": "10", "verbose": "0", "num_channels": "10",
        "wavelet_level": "None", "num_wavelets_per_chan": "1",
        "num_features_per_node": "2", "num_graph_conv_layers": "1",
        "num_hidden_nodes": "100", "num_classes": "5",
        "signal_format": "original flattened", "gen_lr": "0.0001"},
    "NAVAR_CMLP": {
        "num_nodes": "10", "num_hidden": "256", "maxlags": "20",
        "hidden_layers": "2", "dropout": "0", "val_proportion": "0.0",
        "epochs": "250", "batch_size": "128", "check_every": "50",
        "learning_rate": "0.0001", "weight_decay": "0",
        "split_timeseries": "0", "signal_format": "original",
        "lambda1": "0.0"},
    "REDCLIFF_S_CLSTM": dict(ARRAY_TASK_ARGS, gen_hidden="25", context="4",
                             max_input_length="4"),
}
BASELINE_ARGS["NAVAR_CLSTM"] = BASELINE_ARGS["NAVAR_CMLP"]
BASELINE_CUTS = {
    "cMLP": {"max_iter": "4", "check_every": "1"},
    "cLSTM": {"max_iter": "4", "check_every": "1"},
    "DGCNN": {"max_iter": "4", "check_every": "1"},
    "NAVAR_CMLP": {"epochs": "4", "check_every": "1"},
    "NAVAR_CLSTM": {"epochs": "4", "check_every": "1"},
    "REDCLIFF_S_CLSTM": ARRAY_TASK_CUTS,
}
# each family's name in the eval layer's GC dispatch
BASELINE_ALG = {"cMLP": "CMLP", "cLSTM": "CLSTM", "DGCNN": "DGCNN",
                "NAVAR_CMLP": "NAVAR_CMLP", "NAVAR_CLSTM": "NAVAR_CLSTM",
                "REDCLIFF_S_CLSTM": "REDCLIFF_S_CLSTM"}
# the cMLP-FM GISTA fit: the cMLP widths through Trainer with the GL prox
# at the train phase's threshold (lr 5e-4 x lam 4 = 2e-3 per step), which
# zeroes no group within the run (a zeroed group stalls the fit: ROADMAP
# queue 3 item 2); its first-layer block (C_out, H, C_in, L) = (10, 50,
# 10, 2) is the GL prox kernel's new shape
GISTA_BLOCK = (C_TRAIN, 50, C_TRAIN, 2)
BASELINE_CHECK_STEPS = 8

# DCSFA-NMF and DYNOTEARS: the published d4IC DCSFA cached-args
# (experiments/accuracy_parity_d4ic.py:132-141: 10 nodes, windows cut to
# num_node_features = 20 steps, nperseg 20 -> F = 5 frequencies below 250
# Hz, the "vanilla" layout of 10 x 10 x 5 = 500 features, 5 components all
# supervised, h 256, batch 128, AdamW lr 1e-3, 20 NMF iterations) and the
# published DYNOTEARS_Vanilla args (experiments/accuracy_parity_synsys.py:
# 101-106), as array tasks on the baselines phase's 2,000 / 500 recordings
# of 48 steps with one-hot state labels; depth cut only
DCSFA_MODEL = "DCSFANMF"
DCSFA_ARGS = {
    "batch_size": "128", "num_high_level_node_features": "5",
    "best_model_name": "dCSFA-NMF-best-model.pt", "num_node_features": "20",
    "n_components": "5", "n_sup_networks": "5",
    "signal_format": "original flattened directed_spectrum vanilla",
    "h": "256", "momentum": "0.5", "lr": "0.001", "recon_weight": "1.0",
    "sup_weight": "2.0", "sup_recon_weight": "1.0",
    "sup_smoothness_weight": "2.0", "n_epochs": "1000",
    "n_pre_epochs": "50", "nmf_max_iter": "20",
}
DCSFA_CUTS = {"n_epochs": "4", "n_pre_epochs": "2"}
DCSFA_FEATURES = 5 * C_TRAIN * C_TRAIN
DCSFA_CHECK_STEPS = 8
# AdamW turns the rounding noise of a gradient that is zero in exact
# arithmetic (the encoder bias in front of the BatchNorm, which the batch
# mean cancels) into steps of up to about lr each: card and CPU walk that
# bias apart by at most about 2 lr per step (tests/test_torch_dcsfa.py)
DCSFA_BIAS_WALK = 2 * 1e-3 * DCSFA_CHECK_STEPS
DYNOTEARS_MODEL = "DYNOTEARS_Vanilla"
DYNOTEARS_ARGS = {
    "lambda_w": "0.9", "lambda_a": "0.1", "max_iter": "100",
    "h_tol": "0.00000001", "w_threshold": "0.0", "tabu_edges": "None",
    "tabu_parent_nodes": "None", "tabu_child_nodes": "None",
    "lag_size": "1", "signal_format": "original",
}

# eval: the grid's 27 best-params artifacts scored against the sVAR's 5
# true graphs (experiments/d4ic_grid_search.py:231-258), the array task's
# run root selected (eval_gs), and the array task's model read out over
# EVAL_RECORDINGS validation recordings of EVAL_T steps from the same 5
# state VARs, the state switching every EVAL_SWITCH steps in an order
# drawn from numpy's default_rng(EVAL_ORDER_SEED); windows of embed_lag
# (T - history = 240 per recording). Card vs CPU: the per-point
# optimal-F1 stats within EVAL_F1_ATOL (a readout of the params, no
# embed); anything downstream of the DGCNN embed within EVAL_DYN_ATOL
EVAL_RECORDINGS = 16
EVAL_T = 256
EVAL_SWITCH = 32
EVAL_ORDER_SEED = 2
EVAL_F1_ATOL = 1e-6
EVAL_DYN_ATOL = 1e-4


# data_gen: the device generator (data/synthetic.py) at the synSys size of
# the accuracy study (experiments/accuracy_parity_synsys.py:195-196,
# 239-247: 1,040 + 240 recordings, T 100, burn-in 50, 2 states of 6 nodes
# with 2 edges, gaussian, OneHot, noise 1.0; fold 0's graphs) and at one
# D4IC network's (experiments/accuracy_parity_d4ic.py:193-210,233: 150
# recordings, T 48, burn-in 50, 1 state of 10 nodes with 13 edges,
# gaussian, Oracle; network 0's graph)
GEN_SIZES = {
    "synsys": dict(nodes=6, factors=2, edges=2, orthogonal=True, seed=0,
                   n=1040 + 240, T=100, burnin=50, label="OneHot",
                   noise="gaussian", noise_amp=1.0),
    "d4ic_network": dict(nodes=10, factors=1, edges=13, orthogonal=False,
                         seed=1, n=150, T=48, burnin=50, label="Oracle",
                         noise="gaussian", noise_amp=0.1),
}
GEN_TIMED_RUNS = 5
# card vs CPU body: per recording, relative to its largest amplitude (the
# recurrence runs burnin + T steps in float32, another summation order on
# each device); labels absolute
GEN_BODY_REL = 1e-5
GEN_LABEL_ATOL = 1e-6
# the accuracy flows' smokes through the twins' main (the JAX scripts'
# own --smoke): synSys one fold with --dynamic and the reference's
# algorithm set; D4IC one fold without NAVAR / DYNOTEARS
ACC_SYNSYS_ARGV = ["--smoke", "--folds", "1", "--dynamic", "--algs", "ref"]
ACC_D4IC_ARGV = ["--smoke", "--folds", "1", "--algs", "core"]
# run_dynamic_readout_evaluation's default: recordings read out per fold,
# one graph_mix each for a REDCLIFF run
ACC_DYNAMIC_RECORDINGS = 16
# the factor mix's shapes on those flows (batch 128): synSys K = 2, M = 6
# at 1,040 / 240 (remainders 16, 112) and the smoke's 240 / 96 (112, 96);
# D4IC K = 5, M = 10 at 600 / 150 (88, 22) and the smoke's 120 / 40; the
# synSys readout's windows: T 100 - embed_lag 16 + 1
SYNSYS_BATCHES = (128, 16, 112, 96)
D4IC_BATCHES = (120, 40, 88, 22)
# the grid's quality readout: the graph summary vmapped over the lanes on
# the first validation batch cut to RedcliffTrainConfig's
# max_samples_for_gc_tracking windows, one lane-form mix at each ladder width
QUALITY_READOUT_B = 40
SYNSYS_READOUT_S = 100 - 16 + 1
# discovery: the Table-2 flow (eval/supervised_discovery.py) on the held-out
# split of one synSys 6-2-2 fold at the study's size
# (experiments/accuracy_parity_synsys.py:195-196,239-247: 240 recordings of
# (100, 6), two states, OneHot), lasar left out (it needs scikit-learn);
# SELVAR on its native core, held to the numpy core at
# tests/test_selvar_golden.py's bars; then the D4IC regime-PCMCI
# experiment on one network's recordings from the device generator (the
# data_gen phase's size)
DISCOVERY_ALGS = ("slarac", "qrbs", "selvar", "PCMCI")
DISCOVERY_FOLD = 0
SELVAR_RTOL, SELVAR_ATOL = 1e-8, 1e-10
# ts_transformer: mvts_transformer's published defaults (src/options.py of
# Zerveas et al., KDD 2021, the model the reference vendors) on the synSys
# windows: B 128, T 100, 6 features, 2 classes
TST_CONFIG = dict(feat_dim=6, max_len=100, d_model=64, n_heads=8,
                  num_layers=3, dim_feedforward=256, pos_encoding="fixed",
                  activation="gelu", norm="BatchNorm")
TST_BATCH = 128
TST_CLASSES = 2
TST_STEPS = 20
TST_LR = 1e-3
TST_TIMED = 50
# the trainer bars for multi-step histories (ROADMAP "Tolerances")
TST_HIST = dict(rtol=1e-4, atol=1e-5)


class SmokeFailure(RuntimeError):
    pass


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _require(ok, what):
    if not ok:
        raise SmokeFailure(what)


def _nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound_ms(B, K, M, b_prime):
    """Least time for the mix on the card: each input read once, the output
    written once, over HBM bandwidth; 2*B*K*M flops over the f32 rate."""
    return _bound(4 * (B * K + K * b_prime * M + B * M), 2.0 * B * K * M)


def _prox_bound_ms(numel):
    """Least time for the GL prox: the block read once and written once;
    per element a square-accumulate, a divide and a multiply (4 flops)."""
    return _bound(8 * numel, 4.0 * numel)


def _time_ms(torch, fn, iters=1000, warmup=100):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_turns(torch, fns):
    """CUDA-event ms per call of each of ``fns`` (name -> fn), timed in
    turns — the given order, then reversed (kernel, library, plain, plain,
    library, kernel) — and the mean of each name's two readings."""
    names = list(fns)
    got = {n: [] for n in names}
    for n in names + names[::-1]:
        got[n].append(_time_ms(torch, fns[n]))
    return {n: sum(v) / len(v) for n, v in got.items()}


def _host_us(torch, fn, iters=10000):
    """Host wall us per call of ``fn`` (perf_counter over ``iters`` calls
    that start on an idle card, then a sync): what the calling thread pays,
    which is the cost at shapes whose device work is shorter."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _max_err(got, want):
    return float((got.detach() - want.detach()).abs().max())


def _check_close(torch, name, got, want, errs, rtol=RTOL, atol=ATOL):
    err = _max_err(got, want)
    errs[name] = err
    _require(bool(torch.allclose(got, want, rtol=rtol, atol=atol)),
             f"{name}: kernel disagrees with plain version (max abs err "
             f"{err}, rtol {rtol}, atol {atol})")


def phase_build(torch, kernels):
    """Build every kernel at once, one nvcc per source, each timed."""
    from redcliff_tpu_torch.ops.cuda_build import BUILD_DIR

    build_s, errors = {}, {}

    def build(name, mod):
        t0 = time.perf_counter()
        try:
            mod.load_kernel()
        except Exception as e:  # noqa: BLE001 — reported below, then raised
            errors[name] = repr(e)
        build_s[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(n, m))
               for n, m in kernels.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    _require(not errors, f"kernel build failed: {errors}")
    smi = _nvidia_smi()
    _emit({"phase": "build",
           "kernels": {n: os.path.relpath(m.KERNEL_SOURCE, HERE)
                       for n, m in kernels.items()},
           "build_dir": os.path.relpath(BUILD_DIR, HERE),
           "build_s": build_s, "build_wall_s": wall_s,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def _mix_grads(torch, mix, w0, p0):
    w = w0.clone().requires_grad_(True)
    p = p0.clone().requires_grad_(True)
    out = mix(w, p)
    torch.sin(out).sum().backward()
    return out.detach(), w.grad, p.grad


def _offset_view(torch, t):
    """A copy of ``t`` whose storage starts one float past a 16-byte
    boundary: the same values, a misaligned base pointer."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def _mix_checks(torch, FM, gen, dev, errs):
    """The factor mix against its plain version, and the launch plan each
    case took (float4, float2 or scalar)."""
    plans = {}

    def plan(w, p, B, M, sk, sb):
        vec = FM.mix_plan(B, M, sk if w.shape[1] > 1 else 0,
                          sb if B > 1 else 0, p.data_ptr() % 16)[0]
        return {1: "scalar", 2: "float2", 4: "float4"}[vec]

    # M = 10 (the training and load shapes: float2), 20 and 100 (float4),
    # 7 (scalar), K = 20 with M = 12 (the K loop that is not unrolled); the
    # last two on a p offset by one float (scalar)
    cases = [((64, 5, 1, 10), False), ((64, 5, 2, 10), False),
             ((17, 5, 1, 10), False), ((1, 5, 1, 10), False),
             ((128, 5, 1, 10), False), ((64, 5, 10, 10), False),
             ((32, 5, 1, 7), False), ((8, 20, 1, 12), False),
             ((64, 5, 10, 10), True), ((128, 5, 1, 10), True)]
    # the accuracy flows' batches: synSys (K = 2, M = 6) full, the
    # published remainder and the smoke's remainder and validation batch;
    # D4IC (K = 5, M = 10) the smoke's one batch and validation batch, the
    # published remainders
    cases += [((B, 2, 1, 6), False) for B in SYNSYS_BATCHES]
    cases += [((B, K_TRAIN, 1, C_TRAIN), False) for B in D4IC_BATCHES]
    for (B, K, T, C), offset in cases:
        w = torch.rand((B, K), generator=gen).to(dev)
        p = torch.randn((K, B, T, C), generator=gen).to(dev)
        if offset:
            p = _offset_view(torch, p)
        name = f"factor_mix{(B, K, T, C)}" + (" p+1 float" if offset else "")
        _check_close(torch, name, FM.factor_mix(w, p),
                     FM.factor_mix_reference(w, p), errs)
        plans[name] = plan(w, p, B, T * C, p.stride(0), p.stride(1))
    gc = torch.randn((5, 10, 10), generator=gen).to(dev)
    for S, offset in ((64, False), (3, False), (64, True),
                      (EVAL_T - TRAIN_CONFIG["embed_lag"], False)):
        w = torch.rand((S, 5), generator=gen).to(dev)
        g = _offset_view(torch, gc) if offset else gc
        name = f"graph_mix(S={S})" + (" gc+1 float" if offset else "")
        _check_close(torch, name, FM.graph_mix(w, g),
                     FM.graph_mix_reference(w, g), errs)
        plans[name] = plan(w, g, S, 100, g.stride(0), 0)
    # the synSys dynamic readout: 85 windows of a 100-step recording, the
    # 2 factor graphs of 6 x 6
    g2 = torch.randn((2, 6, 6), generator=gen).to(dev)
    w2 = torch.rand((SYNSYS_READOUT_S, 2), generator=gen).to(dev)
    name = f"graph_mix(S={SYNSYS_READOUT_S} K=2 M=36)"
    _check_close(torch, name, FM.graph_mix(w2, g2),
                 FM.graph_mix_reference(w2, g2), errs)
    plans[name] = plan(w2, g2, SYNSYS_READOUT_S, 36, g2.stride(0), 0)
    _require(plans["graph_mix(S=64)"] == "float4"
             and plans["graph_mix(S=240)"] == "float4"
             and plans["factor_mix(128, 5, 1, 10)"] == "float2"
             and plans["graph_mix(S=64) gc+1 float"] == "scalar"
             and plans["factor_mix(64, 5, 10, 10) p+1 float"] == "scalar",
             f"factor_mix launch plans {plans}")
    # autograd, kernel forward + einsum backward vs the plain version: the
    # serve-test shape, the training batch and an odd remainder batch; and
    # the same forward with no gradient wanted (the direct launch)
    for B, K, C in ((64, K_TRAIN, C_TRAIN), (128, K_TRAIN, C_TRAIN),
                    (117, K_TRAIN, C_TRAIN), (120, K_TRAIN, C_TRAIN),
                    (128, 2, 6), (112, 2, 6), (16, 2, 6)):
        w0 = torch.rand((B, K), generator=gen).to(dev)
        p0 = torch.randn((K, B, 1, C), generator=gen).to(dev)
        got = _mix_grads(torch, FM.factor_mix, w0, p0)
        want = _mix_grads(torch, FM.factor_mix_reference, w0, p0)
        tag = (f"B={B}" if (K, C) == (K_TRAIN, C_TRAIN)
               else f"B={B} K={K} M={C}")
        for what, a, b in zip(("forward", "dw", "dp"), got, want):
            _check_close(torch, f"factor_mix_{what}({tag})", a, b, errs)
        with torch.no_grad():
            direct = FM.factor_mix(w0.requires_grad_(True), p0)
        _require(bool(torch.equal(direct, got[0])),
                 f"factor_mix(B={B}): no-grad and autograd forwards differ")
    return plans


def _prox_checks(torch, PX, gen, dev, errs):
    """The GL prox, functional and in place, against its plain version;
    the plan (chunk, TMA bulk copy or not) each case took."""
    plans = {}
    train_block = (K_TRAIN, C_TRAIN, TRAIN_CONFIG["gen_hidden"][0], C_TRAIN,
                   TRAIN_CONFIG["gen_lag"])
    # the training block, the cMLP-FM GISTA block, the off-tile shapes of
    # tests/test_precision_kernels.py:117-121, a slab walked in chunks with
    # and without the bulk copy (16,000 and 15,005 floats); three
    # thresholds each, on an aligned and on a misaligned block, functional
    # and in place (the output aliasing the input)
    for shape in (train_block, GISTA_BLOCK, (3, 7, 5, 7, 3), (1, 1, 3, 1, 1),
                  (5, 12, 32, 12, 4), (2, 3, 200, 10, 8),
                  (2, 1, 3001, 1, 5)):
        for offset in (False, True):
            W = (0.05 * torch.randn(shape, generator=gen)).to(dev)
            if offset:
                W = _offset_view(torch, W)
            *_, H, C, L = shape
            chunk, bulk, threads = PX.prox_plan(H, C, L,
                                                W.data_ptr() % 16)
            tag = f"gl_prox{shape}" + (" +1 float" if offset else "")
            plans[tag] = {"chunk": chunk, "slab": H * C * L,
                          "bulk": bool(bulk), "threads": threads}
            for lam, lr in ((PROX_LAM, TRAIN_KNOBS["gen_lr"]),
                            (0.013, 0.002), (50.0, 0.05)):
                want = PX.gl_prox_reference(W, lam, lr)
                _check_close(torch, f"{tag}(lam={lam},lr={lr})",
                             PX.gl_prox(W, lam, lr), want, errs)
                Wi = W.clone() if not offset else _offset_view(torch, W)
                ptr = Wi.data_ptr()
                got = PX.gl_prox_(Wi, lam, lr)
                _require(got is Wi and Wi.data_ptr() == ptr,
                         f"{tag}: gl_prox_ did not update in place")
                _check_close(torch, f"{tag}(lam={lam},lr={lr}) in place",
                             Wi, want, errs)
    _require(plans[f"gl_prox{train_block}"]["bulk"]
             and plans[f"gl_prox{train_block}"]["chunk"] == 1000
             and plans[f"gl_prox{GISTA_BLOCK}"]["bulk"]
             and plans[f"gl_prox{GISTA_BLOCK}"]["chunk"] == 1000
             and not plans[f"gl_prox{train_block} +1 float"]["bulk"]
             and plans["gl_prox(2, 3, 200, 10, 8)"]["chunk"] < 16000,
             f"gl_prox launch plans {plans}")
    # an all-zero group and a group exactly at the threshold
    W = torch.randn(train_block, generator=gen).to(dev)
    W[0, 0, :, 1, :] = 0.0
    thresh = PX.threshold(1.0, 0.25)
    W[1, 2, :, 0, :] *= thresh / torch.sqrt(torch.sum(W[1, 2, :, 0, :] ** 2))
    got = PX.gl_prox(W, 1.0, 0.25)
    _check_close(torch, "gl_prox(zero and at-threshold groups)", got,
                 PX.gl_prox_reference(W, 1.0, 0.25), errs)
    _require(float(got[0, 0, :, 1, :].abs().max()) == 0.0,
             "gl_prox: the all-zero group did not stay zero")
    _require(float(got[1, 2, :, 0, :].abs().max()) <= ATOL,
             "gl_prox: the at-threshold group did not go to zero")
    return plans


_VEC = {1: "scalar", 2: "float2", 4: "float4"}


def _grid_lr(torch, dev):
    """The grid's per-lane gen_lr, lane order of ``_grid_points``."""
    return torch.tensor([lr for lr in GRID_GEN_LR
                         for _ in range(GRID_LANES // len(GRID_GEN_LR))],
                        dtype=torch.float32, device=dev)


def _ladder_inputs(torch, PX, gen, dev, width, live):
    """Lane-kernel inputs of a grid era on the bucket ladder: ``width``
    lanes of which the first ``live`` hold grid points 0..live-1 and the
    rest are filler lanes (point 0's threshold, gated off), as the engine
    lays them out — the mix's (w, p) at the training batch, the prox's
    first-layer block, thresholds and gate."""
    B = TRAIN_KNOBS["batch_size"]
    w = torch.rand((width, B, K_TRAIN), generator=gen).to(dev)
    p = torch.randn((width, K_TRAIN, B, 1, C_TRAIN), generator=gen).to(dev)
    W = (0.05 * torch.randn((width, K_TRAIN, C_TRAIN,
                             TRAIN_CONFIG["gen_hidden"][0], C_TRAIN,
                             TRAIN_CONFIG["gen_lag"]), generator=gen)).to(dev)
    lr = _grid_lr(torch, dev)[:live]
    lr = torch.cat([lr, lr[:1].expand(width - live)])
    gate = torch.arange(width, device=dev) < live
    return w, p, W, PX.lane_thresholds(lr, PROX_LAM), gate


def _mix_lane_checks(torch, FM, gen, dev, errs):
    """The factor mix's lane form against its plain lane version at the
    grid's shapes (27 lanes, the training batch and the remainder batch),
    on a p offset by one float, one launch per call; and the gradients of
    ``FactorMixFn``'s vmap rule (``torch.func.vmap`` of ``torch.func.grad``,
    as the grid step takes them) against the plain einsum's."""
    plans = {}
    G, K, C = GRID_LANES, K_TRAIN, C_TRAIN
    for B in (TRAIN_KNOBS["batch_size"], N_TRAIN % TRAIN_KNOBS["batch_size"]):
        w = torch.rand((G, B, K), generator=gen).to(dev)
        p = torch.randn((G, K, B, 1, C), generator=gen).to(dev)
        for offset in (False, True):
            pp = _offset_view(torch, p) if offset else p
            name = f"factor_mix_lanes(G={G}, B={B})" + (
                " p+1 float" if offset else "")
            before = FM.factor_mix.launches
            got = FM.factor_mix_lanes(w, pp)
            _require(FM.factor_mix.launches == before + 1,
                     f"{name}: not one launch for all lanes")
            _check_close(torch, name, got,
                         FM.factor_mix_lanes_reference(w, pp), errs)
            plans[name] = _VEC[FM.mix_plan(B, C, pp.stride(1), pp.stride(2),
                                           pp.data_ptr() % 16,
                                           pp.stride(0))[0]]
        r = torch.randn((G, B, 1, C), generator=gen).to(dev)

        def grads(mix):
            return torch.func.vmap(torch.func.grad(
                lambda a, b, c: (c * mix(a, b)).sum(), argnums=(0, 1)))(
                    w, p, r)
        for what, a, b in zip(("dw", "dp"), grads(FM.FactorMixFn.apply),
                              grads(FM.factor_mix_reference)):
            _check_close(torch, f"factor_mix vmap rule {what} (G={G}, "
                                f"B={B})", a, b, errs)
        # ordinary autograd through the lane form (FactorMixLanesFn), with
        # the fixed cotangent r
        def lane_grads(mix):
            wg = w.clone().requires_grad_(True)
            pg = p.clone().requires_grad_(True)
            (r * mix(wg, pg)).sum().backward()
            return wg.grad, pg.grad
        for what, a, b in zip(("dw", "dp"),
                              lane_grads(FM.factor_mix_lanes),
                              lane_grads(FM.factor_mix_lanes_reference)):
            _check_close(torch, f"factor_mix_lanes autograd {what} (G={G}, "
                                f"B={B})", a, b, errs)
    _require(plans[f"factor_mix_lanes(G={G}, B=128)"] == "float2"
             and plans[f"factor_mix_lanes(G={G}, B=128) p+1 float"]
             == "scalar", f"factor_mix lane plans {plans}")
    return plans


def _prox_lane_checks(torch, PX, gen, dev, errs):
    """The GL prox's lane form in place against its plain lane version at
    27 lanes with the grid's per-lane thresholds and mixed gates (every
    fourth lane off, a lane with a zero group gated on, one gated off), on
    the training block, a block offset by one float and slabs walked in
    chunks; one launch per call; zero groups stay zero and gated-off lanes
    exactly as they were."""
    plans = {}
    G = GRID_LANES
    lr = _grid_lr(torch, dev)
    gate = torch.ones(G, dtype=torch.bool)
    gate[::4] = False
    gate = gate.to(dev)
    train_block = (K_TRAIN, C_TRAIN, TRAIN_CONFIG["gen_hidden"][0], C_TRAIN,
                   TRAIN_CONFIG["gen_lag"])
    for shape in (train_block, (2, 3, 200, 10, 8)):
        for offset in (False, True):
            W = (0.05 * torch.randn((G,) + shape, generator=gen)).to(dev)
            W[5, 0, 0, :, 1, :] = 0.0   # gated on
            W[8, 1, 2, :, 0, :] = 0.0   # gated off
            if offset:
                W = _offset_view(torch, W)
            *_, H, C, L = shape
            chunk, bulk, _ = PX.prox_plan(H, C, L, W.data_ptr() % 16)
            tag = f"gl_prox_lanes{(G,) + shape}" + (
                " +1 float" if offset else "")
            plans[tag] = {"chunk": chunk, "bulk": bool(bulk),
                          "slabs_per_lane": W.numel() // G // (H * C * L)}
            for lam in (PROX_LAM, 50.0):
                t = PX.lane_thresholds(lr, lam)
                want = PX.gl_prox_lanes_reference(W, t, gate)
                Wi = W.clone() if not offset else _offset_view(torch, W)
                ptr = Wi.data_ptr()
                before = PX.gl_prox.launches
                got = PX.gl_prox_lanes_(Wi, t, gate)
                _require(got is Wi and Wi.data_ptr() == ptr
                         and PX.gl_prox.launches == before + 1,
                         f"{tag}: not one in-place launch for all lanes")
                _check_close(torch, f"{tag}(lam={lam})", Wi, want, errs)
                _require(bool(torch.isfinite(Wi).all())
                         and float(Wi[5, 0, 0, :, 1, :].abs().max()) == 0.0,
                         f"{tag}: a zero group did not stay zero")
                _require(bool(torch.equal(Wi[~gate], W[~gate])),
                         f"{tag}: a gated-off lane changed")
    _require(plans[f"gl_prox_lanes{(G,) + train_block}"]["bulk"]
             and not plans[f"gl_prox_lanes{(G,) + train_block} +1 float"][
                 "bulk"]
             and plans[f"gl_prox_lanes{(G, 2, 3, 200, 10, 8)}"]["chunk"]
             < 16000, f"gl_prox lane plans {plans}")
    return plans


def _mix_lanes_library(torch, w, p):
    """``torch.matmul`` on the permuted operands: the library call that
    computes the lane mix, ``(G, B, 1, K) @ (G, B, K, M)``."""
    G, K, B, T, C = p.shape
    return torch.matmul(w[:, :, None, :],
                        p.reshape(G, K, B, T * C).permute(0, 2, 1, 3))


def _mix_host_breakdown(torch, FM, w, p, gc=None):
    """Host us per call of each piece of the factor mix's launch path at
    ``w``, ``p`` (perf_counter over 10,000 calls): the pieces this launch
    path keeps and those it dropped, beside the whole call, one library
    call and the floor. With ``gc`` (the serve tick, ``p`` its broadcast)
    the whole ``graph_mix`` call and the view it no longer builds too."""
    K, B, T, C = p.shape
    dev = w.device
    idx = w.get_device()
    out = w.new_empty((B, T, C))
    plan = FM._mix_args(B, K, T * C, p.stride(0), p.stride(1),
                        p.data_ptr() % 16, idx)
    args = (w.data_ptr(), p.data_ptr(), out.data_ptr(), plan[1])
    raw = torch._C._cuda_getCurrentRawStream
    one = torch.zeros(1, device=dev)

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    pieces = {
        # kept
        "factor_mix (whole call, no grad)": lambda: FM.factor_mix(w, p),
        "_launch (checks + launch)": lambda: FM._launch(w, p),
        "_mix_args (cached plan)": lambda: FM._mix_args(
            B, K, T * C, p.stride(0), p.stride(1), p.data_ptr() % 16, idx),
        "new_empty": lambda: w.new_empty((B, T, C)),
        "raw stream handle": lambda: raw(idx),
        "ctypes call + launch + raw stream handle":
            lambda: FM._fn(*args, raw(idx)),
        "data_ptr x3": lambda: (w.data_ptr(), p.data_ptr(), out.data_ptr()),
        # dropped
        "FactorMixFn.apply (whole call)": lambda: FM.FactorMixFn.apply(w, p),
        "with torch.cuda.device": device_ctx,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.empty(dtype, device)": lambda: torch.empty(
            (B, T, C), dtype=torch.float32, device=dev),
        # yardsticks
        "torch.bmm (whole call)": lambda: torch.bmm(
            w[:, None, :], p.reshape(K, B, T * C).transpose(0, 1)),
        "floor: x.zero_()": one.zero_,
    }
    if gc is not None:
        pieces["graph_mix (whole call)"] = lambda: FM.graph_mix(w, gc)
        pieces["graph_mix expand view (dropped)"] = lambda: gc.contiguous()[
            :, None].expand((K, B) + tuple(gc.shape[1:]))
        pieces["torch.mm (whole call)"] = lambda: torch.mm(w, gc.view(K, -1))
    return {k: _host_us(torch, f) for k, f in pieces.items()}


def _prox_host_breakdown(torch, PX, W, lam, lr):
    """Host us per call of each piece of the GL prox's launch path at the
    block ``W`` (perf_counter over 10,000 calls), beside the floor."""
    Wi = W.clone()
    *_, H, C, L = W.shape
    idx = W.get_device()
    lead = W.numel() // (H * C * L)
    plan = PX._prox_args(lead, H, C, L, Wi.data_ptr() % 16, idx)
    args = (Wi.data_ptr(), Wi.data_ptr(), plan[1], PX.threshold(lam, lr))
    raw = torch._C._cuda_getCurrentRawStream
    one = torch.zeros(1, device=W.device)
    pieces = {
        "gl_prox_ (in place, whole call)": lambda: PX.gl_prox_(Wi, lam, lr),
        "_launch into W (checks + launch)": lambda: PX._launch(
            Wi, lam, lr, out=Wi),
        "_prox_args (cached plan)": lambda: PX._prox_args(
            lead, H, C, L, Wi.data_ptr() % 16, idx),
        "threshold(lam, lr)": lambda: PX.threshold(lam, lr),
        "ctypes call + launch + raw stream handle":
            lambda: PX._fn(*args, raw(idx)),
        "increment_version": lambda: torch.autograd.graph.increment_version(
            Wi),
        "gl_prox (functional, whole call)": lambda: PX.gl_prox(W, lam, lr),
        "empty_like (functional only)": lambda: torch.empty_like(W),
        "floor: x.zero_()": one.zero_,
    }
    return {k: _host_us(torch, f) for k, f in pieces.items()}


def phase_kernel(torch, FM, PX):
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    errs = {"factor_mix": {}, "gl_prox": {}}
    mix_plans = _mix_checks(torch, FM, gen, dev, errs["factor_mix"])
    prox_plans = _prox_checks(torch, PX, gen, dev, errs["gl_prox"])
    lane_plans = {"factor_mix": _mix_lane_checks(torch, FM, gen, dev,
                                                 errs["factor_mix"]),
                  "gl_prox": _prox_lane_checks(torch, PX, gen, dev,
                                               errs["gl_prox"])}
    torch.cuda.synchronize()

    # times at the main paths' shapes: the per-tick graph blend (S=64, K=5,
    # M=100, broadcast graphs), the load-time mix (B=1), the training mix
    # (B=128, K=5, M=10) and the training block's prox (in place, as the
    # trainer runs it); each kernel, its library call and its plain version
    # in turns; beside them the launch floor, one x.zero_() on a
    # one-element tensor
    one = torch.zeros(1, device=dev)
    floor_ms = _time_ms(torch, one.zero_)
    timing = {"factor_mix": {}, "gl_prox": {}}
    gc = torch.randn((5, 10, 10), generator=gen).to(dev)
    w = torch.rand((CAPACITY, 5), generator=gen).to(dev)
    w1 = torch.rand((1, 5), generator=gen).to(dev)
    p1 = torch.randn((5, 1, 1, 10), generator=gen).to(dev)
    B = TRAIN_KNOBS["batch_size"]
    wt = torch.rand((B, K_TRAIN), generator=gen).to(dev)
    pt = torch.randn((K_TRAIN, B, 1, C_TRAIN), generator=gen).to(dev)
    S_r = EVAL_T - TRAIN_CONFIG["embed_lag"]
    wr = torch.rand((S_r, 5), generator=gen).to(dev)
    ws = torch.rand((B, 2), generator=gen).to(dev)
    ps = torch.randn((2, B, 1, 6), generator=gen).to(dev)
    S_s = SYNSYS_READOUT_S
    wsr = torch.rand((S_s, 2), generator=gen).to(dev)
    gs = torch.randn((2, 6, 6), generator=gen).to(dev)
    for key, shape, fns, bound in (
            ("tick", "S=64 K=5 M=100 (graph_mix, p broadcast over S)",
             {"kernel_ms": lambda: FM.graph_mix(w, gc),
              "library_ms": lambda: torch.mm(w, gc.view(5, -1)),
              "plain_ms": lambda: FM.graph_mix_reference(w, gc)},
             _bound_ms(CAPACITY, 5, 100, 1)),
            ("readout", f"S={S_r} K=5 M=100 (graph_mix, the dynamic "
                        f"readout's factor sum, graphs broadcast over S)",
             {"kernel_ms": lambda: FM.graph_mix(wr, gc),
              "library_ms": lambda: torch.mm(wr, gc.view(5, -1)),
              "plain_ms": lambda: FM.graph_mix_reference(wr, gc)},
             _bound_ms(S_r, 5, 100, 1)),
            ("load", "B=1 K=5 M=10 (factor_mix, one sim step)",
             {"kernel_ms": lambda: FM.factor_mix(w1, p1),
              "library_ms": lambda: torch.bmm(
                  w1[:, None, :], p1.reshape(5, 1, 10).transpose(0, 1)),
              "plain_ms": lambda: FM.factor_mix_reference(w1, p1)},
             _bound_ms(1, 5, 10, 1)),
            ("train", "B=128 K=5 M=10 (factor_mix forward, training batch)",
             {"kernel_ms": lambda: FM.factor_mix(wt, pt),
              "library_ms": lambda: torch.bmm(
                  wt[:, None, :], pt.reshape(K_TRAIN, B, C_TRAIN).transpose(
                      0, 1)),
              "plain_ms": lambda: FM.factor_mix_reference(wt, pt)},
             _bound_ms(B, K_TRAIN, C_TRAIN, B)),
            ("synsys_train", "B=128 K=2 M=6 (factor_mix forward, the synSys "
                             "accuracy flow's training batch)",
             {"kernel_ms": lambda: FM.factor_mix(ws, ps),
              "library_ms": lambda: torch.bmm(
                  ws[:, None, :], ps.reshape(2, B, 6).transpose(0, 1)),
              "plain_ms": lambda: FM.factor_mix_reference(ws, ps)},
             _bound_ms(B, 2, 6, B)),
            ("synsys_readout", f"S={S_s} K=2 M=36 (graph_mix, the synSys "
                               f"dynamic readout's factor sum)",
             {"kernel_ms": lambda: FM.graph_mix(wsr, gs),
              "library_ms": lambda: torch.mm(wsr, gs.view(2, -1)),
              "plain_ms": lambda: FM.graph_mix_reference(wsr, gs)},
             _bound_ms(S_s, 2, 36, 1))):
        t = timing["factor_mix"][key] = {"shape": shape,
                                         **_time_turns(torch, fns)}
        t["bound_ms"], t["bound_by"] = bound
        t["floor_ms"] = floor_ms
        if key.startswith("synsys"):
            # device time alone (torch.profiler, 200 calls), as the
            # --profile phase measures the other shapes
            t["device_us_alone"] = _alone_us(torch, {
                "kernel": fns["kernel_ms"], "library": fns["library_ms"],
                "plain": fns["plain_ms"], "floor": one.zero_})
    # the grid's lane form: 27 lanes at the training batch and at the
    # remainder batch, one launch each; the library call is torch.matmul on
    # the permuted operands
    G = GRID_LANES
    for key, Bg in (("grid", B), ("grid_rem", N_TRAIN % B)):
        wg = torch.rand((G, Bg, K_TRAIN), generator=gen).to(dev)
        pg = torch.randn((G, K_TRAIN, Bg, 1, C_TRAIN), generator=gen).to(dev)
        t = timing["factor_mix"][key] = {
            "shape": f"G={G} B={Bg} K={K_TRAIN} M={C_TRAIN} "
                     f"(factor_mix_lanes, one launch for all lanes); "
                     f"library_ms: torch.matmul on permuted operands",
            **_time_turns(torch, {
                "kernel_ms": lambda: FM.factor_mix_lanes(wg, pg),
                "library_ms": lambda: _mix_lanes_library(torch, wg, pg),
                "plain_ms": lambda: FM.factor_mix_lanes_reference(wg, pg)})}
        t["bound_ms"], t["bound_by"] = _bound_ms(G * Bg, K_TRAIN, C_TRAIN,
                                                 G * Bg)
        t["floor_ms"] = floor_ms
    train_block = (K_TRAIN, C_TRAIN, 25, C_TRAIN, 4)
    Wt = (0.05 * torch.randn(train_block, generator=gen)).to(dev)
    Wi = Wt.clone()
    lam, lr = PROX_LAM, TRAIN_KNOBS["gen_lr"]
    prox = timing["gl_prox"]["train"] = {
        "shape": "(K, C_out, H, C_in, L) = (5, 10, 25, 10, 4): 500 groups "
                 "of 100; kernel_ms in place (gl_prox_), as the trainer "
                 "runs it",
        **_time_turns(torch, {
            "kernel_ms": lambda: PX.gl_prox_(Wi, lam, lr),
            "functional_ms": lambda: PX.gl_prox(Wt, lam, lr),
            "plain_ms": lambda: PX.gl_prox_reference(Wt, lam, lr)}),
        # no single PyTorch call computes the GL prox
        "library_ms": None,
    }
    prox["bound_ms"], prox["bound_by"] = _prox_bound_ms(Wt.numel())
    prox["floor_ms"] = floor_ms
    # the cMLP-FM GISTA block (the generic trainer's prox), in place
    Wc = (0.05 * torch.randn(GISTA_BLOCK, generator=gen)).to(dev)
    Wci = Wc.clone()
    cmlp = timing["gl_prox"]["cmlp_fm"] = {
        "shape": "(C_out, H, C_in, L) = (10, 50, 10, 2): 100 groups of "
                 "100, 10 slabs of 1,000; kernel_ms in place (gl_prox_), "
                 "as the generic trainer runs it",
        **_time_turns(torch, {
            "kernel_ms": lambda: PX.gl_prox_(Wci, lam, lr),
            "functional_ms": lambda: PX.gl_prox(Wc, lam, lr),
            "plain_ms": lambda: PX.gl_prox_reference(Wc, lam, lr)}),
        "library_ms": None,
    }
    cmlp["bound_ms"], cmlp["bound_by"] = _prox_bound_ms(Wc.numel())
    cmlp["floor_ms"] = floor_ms
    # the grid's lane form in place, every lane gated on (the most work)
    Wg = (0.05 * torch.randn((G,) + train_block, generator=gen)).to(dev)
    Wgi = Wg.clone()
    tg = PX.lane_thresholds(_grid_lr(torch, dev), lam)
    on = torch.ones(G, dtype=torch.bool, device=dev)
    grid = timing["gl_prox"]["grid"] = {
        "shape": f"({G}, 5, 10, 25, 10, 4): {G} lanes, {G * 50:,} slabs of "
                 f"1,000; kernel_ms in place (gl_prox_lanes_), as the grid "
                 f"runs it",
        **_time_turns(torch, {
            "kernel_ms": lambda: PX.gl_prox_lanes_(Wgi, tg, on),
            "plain_ms": lambda: PX.gl_prox_lanes_reference(Wg, tg, on)}),
        "library_ms": None,
    }
    grid["bound_ms"], grid["bound_by"] = _prox_bound_ms(Wg.numel())
    grid["floor_ms"] = floor_ms
    # the ladder's widths: the 27 points at width 32 (5 filler lanes) and
    # the 15 survivors of grid_durable at width 16 (1 filler lane); the
    # prox's bound counts the gated-on lanes only (a gated-off slab is not
    # read)
    for width, live in ((32, GRID_LANES), (16, 15)):
        wl, pl, Wl, tl, gl = _ladder_inputs(torch, PX, gen, dev, width, live)
        Wli = Wl.clone()
        _check_close(torch, f"factor_mix_lanes(G={width})",
                     FM.factor_mix_lanes(wl, pl),
                     FM.factor_mix_lanes_reference(wl, pl),
                     errs["factor_mix"])
        # the quality readout's lane form at this width (telemetry path)
        wq = torch.rand((width, QUALITY_READOUT_B, K_TRAIN),
                        generator=gen).to(dev)
        pq = torch.randn((width, K_TRAIN, QUALITY_READOUT_B, 1, C_TRAIN),
                         generator=gen).to(dev)
        for pp, tag in ((pq, ""), (_offset_view(torch, pq), " p+1 float")):
            name = (f"factor_mix_lanes(G={width}, B={QUALITY_READOUT_B}) "
                    f"quality readout{tag}")
            before = FM.factor_mix.launches
            got = FM.factor_mix_lanes(wq, pp)
            _require(FM.factor_mix.launches == before + 1,
                     f"{name}: not one launch for all lanes")
            _check_close(torch, name, got,
                         FM.factor_mix_lanes_reference(wq, pp),
                         errs["factor_mix"])
        want = PX.gl_prox_lanes_reference(Wl, tl, gl)
        _check_close(torch, f"gl_prox_lanes(G={width}, {live} on)",
                     PX.gl_prox_lanes_(Wl.clone(), tl, gl), want,
                     errs["gl_prox"])
        t = timing["factor_mix"][f"grid{width}"] = {
            "shape": f"G={width} ({live} points, {width - live} filler) "
                     f"B={B} K={K_TRAIN} M={C_TRAIN} (factor_mix_lanes); "
                     f"library_ms: torch.matmul on permuted operands",
            **_time_turns(torch, {
                "kernel_ms": lambda: FM.factor_mix_lanes(wl, pl),
                "library_ms": lambda: _mix_lanes_library(torch, wl, pl),
                "plain_ms": lambda: FM.factor_mix_lanes_reference(wl,
                                                                  pl)})}
        t["bound_ms"], t["bound_by"] = _bound_ms(width * B, K_TRAIN,
                                                 C_TRAIN, width * B)
        t["floor_ms"] = floor_ms
        t = timing["gl_prox"][f"grid{width}"] = {
            "shape": f"({width}, 5, 10, 25, 10, 4): {live} lanes gated on, "
                     f"{width - live} filler lanes off; in place",
            **_time_turns(torch, {
                "kernel_ms": lambda: PX.gl_prox_lanes_(Wli, tl, gl),
                "plain_ms": lambda: PX.gl_prox_lanes_reference(Wl, tl,
                                                               gl)}),
            "library_ms": None}
        t["bound_ms"], t["bound_by"] = _prox_bound_ms(Wl[:live].numel())
        t["floor_ms"] = floor_ms
    host_us = {"factor_mix_tick": _mix_host_breakdown(
        torch, FM, w, gc[:, None].expand(5, CAPACITY, 10, 10), gc),
        "factor_mix_train": _mix_host_breakdown(torch, FM, wt, pt),
        "gl_prox_train": _prox_host_breakdown(torch, PX, Wt, lam, lr)}
    max_err = {k: max(v.values()) for k, v in errs.items()}
    _emit({"phase": "kernel", "rtol": RTOL, "atol": ATOL,
           "max_abs_err": max_err, "errors": errs,
           "plans": {"factor_mix": mix_plans, "gl_prox": prox_plans,
                     "lanes": lane_plans},
           "timing": timing, "host_us_per_call": host_us})
    return max_err, timing


def _streams(np, n, chans):
    rng = np.random.default_rng(0)
    streams = {f"s{i:02d}": rng.normal(size=(n, chans)).astype(np.float32)
               for i in range(STREAMS)}
    # the last stream turns toxic after its ring has warmed up
    streams[f"s{STREAMS - 1:02d}"][CONFIG["embed_lag"] + 4, 3] = np.nan
    return streams


def phase_serve(torch, FM, PX):
    import numpy as np

    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)
    from redcliff_tpu_torch.serve.service import ServeService
    from redcliff_tpu_torch.train.trainer import save_model

    root = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    model = RedcliffSCMLP(RedcliffSCMLPConfig(**CONFIG))
    params = model.init(torch.Generator().manual_seed(0))
    artifact = os.path.join(root, "artifact")
    save_model(artifact, model, params)

    L = CONFIG["embed_lag"]
    n = L + ANSWERED
    streams = _streams(np, n, CONFIG["num_chans"])
    poisoner = f"s{STREAMS - 1:02d}"

    # ---- the main path: counts at 0 just before, read just after
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    svc = ServeService.from_artifact(artifact, root=os.path.join(root,
                                                                 "serve"),
                                     capacity=CAPACITY, resume=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_launches = FM.factor_mix.launches
    for sid in streams:
        svc.connect(sid=sid)
    tick_ms = []
    records = {sid: [] for sid in streams}
    for t in range(n):
        for sid, xs in streams.items():
            svc.ingest(sid, xs[t])
        t1 = time.perf_counter()
        svc.pump()
        tick_ms.append((time.perf_counter() - t1) * 1e3)
        for sid in streams:
            records[sid].extend(svc.poll(sid))
    state_path = svc.drain()
    launches = FM.factor_mix.launches
    prox_launches = PX.gl_prox.launches
    dispatches = svc.dispatches

    _require(load_launches == 2,
             f"load ran {load_launches} factor-mix launches, want 2 "
             f"(one per sim step)")
    _require(launches == dispatches + 2,
             f"{launches} factor-mix launches for {dispatches} dispatched "
             f"ticks + 2 at load")
    _require(dispatches == n, f"{dispatches} dispatches for {n} ticks")
    _require(prox_launches == 0, "serving launched the prox kernel")
    K, C = CONFIG["num_factors"], CONFIG["num_chans"]
    for sid, recs in records.items():
        if sid == poisoner:
            continue
        ans = [r for r in recs if "scores" in r]
        _require(len(ans) == ANSWERED + 1,
                 f"{sid} answered {len(ans)}, want {ANSWERED + 1}")
        for r in ans:
            _require(r["scores"].shape == (K,) and r["graph"].shape == (C, C),
                     f"{sid}: record shapes {r['scores'].shape}, "
                     f"{r['graph'].shape}")
            _require(bool(np.isfinite(r["scores"]).all()
                          and np.isfinite(r["graph"]).all()),
                     f"{sid}: non-finite output")
    _require(svc.registry.get(poisoner).state == "quarantined",
             "poisoner not quarantined")
    _require(any("error" in r for r in records[poisoner]),
             "poisoner got no error record")
    _require(state_path is not None and os.path.exists(state_path),
             f"drain wrote no serve_state.bin ({state_path!r})")

    ticks = np.asarray(tick_ms)
    _emit({"phase": "serve", "device": torch.cuda.get_device_name(0),
           "capacity": CAPACITY, "streams": STREAMS, "ticks": n,
           "dispatches": dispatches, "factor_mix_launches": launches,
           "load_launches": load_launches, "load_s": load_s,
           "ticks_per_s": float(n / (ticks.sum() / 1e3)),
           "tick_p50_ms": float(np.percentile(ticks, 50)),
           "tick_p99_ms": float(np.percentile(ticks, 99)),
           "tick_first_ms": float(ticks[0]),
           "answered_per_stream": ANSWERED + 1,
           "poisoner_quarantined": True, "drain_state": os.path.relpath(
               state_path, HERE)})
    return launches, model, params


def phase_check(torch, model, params):
    """Card against the port's CPU path: the same weights, the same samples
    through two full-width slot tables."""
    import numpy as np

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.serve.engine import StreamEngine

    host = interop.params_to_jax(params)
    card = StreamEngine(model, interop.params_from_jax(host, "cuda"),
                        CAPACITY)
    cpu = StreamEngine(model, interop.params_from_jax(host, "cpu"), CAPACITY,
                       device="cpu")
    rng = np.random.default_rng(1)
    L, C = CONFIG["embed_lag"], CONFIG["num_chans"]
    worst = {"scores": 0.0, "graph": 0.0}
    for t in range(L + 4):
        samples = rng.normal(size=(CAPACITY, C)).astype(np.float32)
        arrive = rng.random(CAPACITY) < 0.9
        got, want = card.step(samples, arrive), cpu.step(samples, arrive)
        for k in ("ready", "poison_hit", "poisoned"):
            _require(bool((got[k] == want[k]).all()), f"{k} differs at {t}")
        for k in worst:
            _require(got[k].shape == want[k].shape, f"{k} shape")
            _require(bool(np.isfinite(got[k]).all()), f"{k} non-finite")
            _require(bool(np.allclose(got[k], want[k], rtol=SERVE_RTOL,
                                      atol=SERVE_ATOL)),
                     f"{k} card vs CPU differ at tick {t}: max abs "
                     f"{np.abs(got[k] - want[k]).max()}")
            worst[k] = max(worst[k], float(np.abs(got[k] - want[k]).max()))
    torch.cuda.synchronize()
    _emit({"phase": "check", "against": "port CPU path, same weights",
           "ticks": L + 4, "rtol": SERVE_RTOL, "atol": SERVE_ATOL,
           "max_abs_err": worst})


def _device_us(torch, prof, n):
    """Per-call device time (us) of each CUDA op in a profile of ``n``
    calls, and the total. User annotations on the device timeline (e.g.
    ``Optimizer.step#Adam.step``) span the kernels inside them and are left
    out, so no time is counted twice."""
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        if getattr(e, "is_user_annotation", False) \
                or e.key.startswith("Optimizer."):
            continue
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.key[:60]] = per.get(e.key[:60], 0.0) + t / n
    return per, sum(per.values())


def _kernel_us(torch, prof):
    """Each hand-written kernel's device us per launch in a profile, and
    its launches there: ``{name: {"us_per_launch", "launches"}}``."""
    out = {}
    for name in ("factor_mix_kernel", "gl_prox_kernel"):
        total, count = 0.0, 0
        for e in prof.key_averages():
            if (name in e.key
                    and e.device_type == torch.autograd.DeviceType.CUDA):
                total += getattr(e, "self_device_time_total", 0.0) or 0.0
                count += e.count
        out[name] = {"us_per_launch": total / count if count else None,
                     "launches": count}
    return out


def _alone_us(torch, fns, n=200):
    """Device us per call of each of ``fns`` (name -> fn) run alone:
    ``torch.profiler`` device time of ``n`` back-to-back calls."""
    from torch.profiler import ProfilerActivity, profile

    alone = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        alone[name] = _device_us(torch, prof, n)[1]
    return alone


def phase_profile(torch, FM):
    """Where a serve tick's time goes (``--profile`` only): device time of
    the kernel and the library call alone, then a profiled window of ticks
    of the full-width service — host wall per tick, device busy per tick,
    the device's idle share, and the top device ops."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from redcliff_tpu_torch.serve.service import ServeService

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    gc = torch.randn((5, 10, 10), generator=gen).to(dev)
    w = torch.rand((CAPACITY, 5), generator=gen).to(dev)
    w1 = torch.rand((1, 5), generator=gen).to(dev)
    p1 = torch.randn((5, 1, 1, 10), generator=gen).to(dev)
    wr = torch.rand((EVAL_T - TRAIN_CONFIG["embed_lag"], 5),
                    generator=gen).to(dev)
    one = torch.zeros(1, device=dev)
    alone = _alone_us(torch, {
        "floor: x.zero_()": one.zero_,
        "factor_mix_kernel (tick)": lambda: FM.graph_mix(w, gc),
        "torch.mm (tick)": lambda: torch.mm(w, gc.view(5, -1)),
        "factor_mix_kernel (readout)": lambda: FM.graph_mix(wr, gc),
        "torch.mm (readout)": lambda: torch.mm(wr, gc.view(5, -1)),
        "plain (readout)": lambda: FM.graph_mix_reference(wr, gc),
        "factor_mix_kernel (load)": lambda: FM.factor_mix(w1, p1),
        "torch.bmm (load)": lambda: torch.bmm(
            w1[:, None, :], p1.reshape(5, 1, 10).transpose(0, 1))})

    artifact = os.path.join(HERE, "build", "chip_smoke", "artifact")
    svc = ServeService.from_artifact(artifact, capacity=CAPACITY,
                                     resume=False)
    streams = _streams(np, CONFIG["embed_lag"] + 40, CONFIG["num_chans"])
    for sid in streams:
        svc.connect(sid=sid)
    n_warm, n_prof = CONFIG["embed_lag"] + 8, 30

    def tick(t):
        for sid, xs in streams.items():
            svc.ingest(sid, xs[t])
        svc.pump()
        for sid in streams:
            svc.poll(sid)

    for t in range(n_warm):
        tick(t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(n_warm, n_warm + n_prof):
            tick(t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    per, busy_us = _device_us(torch, prof, n_prof)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    _emit({"phase": "profile", "device": torch.cuda.get_device_name(0),
           "device_us_per_call_alone": alone,
           "ticks": n_prof, "tick_wall_ms_profiled": wall_ms,
           "device_busy_us_per_tick": busy_us,
           "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms
                                 if busy_us else None),
           "device_ops_per_tick": len(per),
           "top_device_us_per_tick": dict(top)})


def _state_vars(np, rng):
    """The 5 states' sparse VAR(4) coefficients (K, L, C, C), each scaled
    to a companion spectral radius of at most 0.9."""
    K, C, L = K_TRAIN, C_TRAIN, TRAIN_CONFIG["gen_lag"]
    A = np.zeros((K, L, C, C))
    for k in range(K):
        A[k] = (rng.random((L, C, C)) < 0.15) * rng.normal(0.0, 0.4,
                                                            (L, C, C))
        A[k, 0] += 0.4 * np.eye(C)
        comp = np.zeros((L * C, L * C))
        comp[:C] = np.concatenate(list(A[k]), axis=1)
        comp[C:, :-C] = np.eye((L - 1) * C)
        rho = float(np.max(np.abs(np.linalg.eigvals(comp))))
        if rho > 0.9:  # spectral radius of the companion matrix to 0.9
            A[k] *= ((0.9 / rho) ** np.arange(1, L + 1))[:, None, None]
    return A


def _d4ic_like_data(np, n, seed, T=None):
    """``n`` windows of (T, 10) (default embed_lag + 1 steps) from a
    5-state sparse VAR(4) (one random stable coefficient set per state, a
    burn-in per window), with one-hot state labels (n, 5, 1), and each
    state's true lagged graph (5, C, C, L): the support of its
    coefficients."""
    rng = np.random.default_rng(seed)
    K, C, L = K_TRAIN, C_TRAIN, TRAIN_CONFIG["gen_lag"]
    if T is None:
        T = TRAIN_CONFIG["embed_lag"] + TRAIN_CONFIG["num_sims"]
    burn = 32
    A = _state_vars(np, rng)
    states = rng.integers(0, K, n)
    Ak = A[states]
    x = np.zeros((n, burn + T, C))
    noise = rng.normal(size=(n, burn + T, C))
    for t in range(L, burn + T):
        x[:, t] = noise[:, t] + sum(
            np.einsum("nij,nj->ni", Ak[:, l], x[:, t - 1 - l])
            for l in range(L))
    Y = np.eye(K, dtype=np.float32)[states][:, :, None]
    graphs = (np.transpose(A, (0, 2, 3, 1)) != 0).astype(np.float64)
    return x[:, burn:].astype(np.float32), Y, graphs


def _train_data(np):
    from redcliff_tpu_torch.data.datasets import train_val_split

    X, Y, _ = _d4ic_like_data(np, N_TRAIN + N_VAL, seed=0)
    return train_val_split(X, Y, val_fraction=N_VAL / (N_TRAIN + N_VAL),
                           rng=np.random.default_rng(1))


def _group_norms(np, w):
    """(K, C_out, C_in) norms of the first-layer (H, L) groups."""
    return np.sqrt((np.asarray(w, np.float64) ** 2).sum(axis=(-3, -1)))


def phase_train(torch, FM, PX):
    """The full-width fit through ``RedcliffTrainer.fit``: counts at 0 just
    before, read just after."""
    import math

    import numpy as np

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)
    from redcliff_tpu_torch.train.redcliff_trainer import (
        RedcliffTrainConfig, RedcliffTrainer)
    from redcliff_tpu_torch.train.trainer import load_model

    root = os.path.join(HERE, "build", "chip_smoke", "train")
    shutil.rmtree(root, ignore_errors=True)
    train_ds, val_ds = _train_data(np)
    model = RedcliffSCMLP(RedcliffSCMLPConfig(**TRAIN_CONFIG))
    params = model.init(torch.Generator().manual_seed(0))
    trainer = RedcliffTrainer(model, RedcliffTrainConfig(**TRAIN_KNOBS))
    _require(trainer.device.type == "cuda", "the trainer is not on the card")

    # ---- the main path: counts at 0 just before, read just after
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    res = trainer.fit(params, train_ds, val_ds, save_dir=root)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    mix_launches = FM.factor_mix.launches
    prox_launches = PX.gl_prox.launches

    B = TRAIN_KNOBS["batch_size"]
    n_tr = -(-len(train_ds) // B)
    n_val = -(-len(val_ds) // B)
    phases = [tuple(e["phases"]) for e in res.epochs]
    _require(phases[:3] == [("embedder_pretrain",), ("factor_pretrain",),
                            ("combined",)],
             f"phase schedule {phases}")
    for k in ("avg_combo_loss", "avg_forecasting_loss", "avg_factor_loss",
              "avg_adj_penalty", "avg_factor_cos_sim_penalty"):
        _require(all(math.isfinite(v) for v in res.histories[k]),
                 f"non-finite {k}: {res.histories[k]}")
    _require(math.isfinite(res.final_val_loss)
             and math.isfinite(res.best_loss), "non-finite final losses")
    _require(res.aborted is None, f"fit aborted: {res.aborted}")
    _require(res.numerics["skipped"] == 0,
             f"the guard skipped {res.numerics['skipped']} steps")
    last = load_model(os.path.join(root, "trainer_checkpoint.pkl"))
    norms = np.concatenate([
        _group_norms(np, last["params"]["factors"][0]["w"]).ravel(),
        _group_norms(np, interop.params_to_jax(res.params)["factors"][0][
            "w"]).ravel()])
    _require(bool((norms > 0).all()), "the prox zeroed a group")
    first_norms = _group_norms(np, interop.params_to_jax(params)[
        "factors"][0]["w"])
    factor_steps = sum(e["steps"].get(ph, 0) for e in res.epochs
                       for ph in ("factor_pretrain", "combined",
                                  "post_train"))
    want_factor_steps = sum(n_tr for ph in phases for p in ph
                            if p != "embedder_pretrain")
    _require(prox_launches == factor_steps == want_factor_steps > 0,
             f"{prox_launches} gl_prox launches for {factor_steps} applied "
             f"factor steps ({want_factor_steps} expected)")
    # forwards the fit ran: one per step (the loss), one per step of the
    # phases that track the label confusion, two per validation batch (loss
    # and confusion) each epoch, one per batch of the final validation
    forwards = sum(n_tr * (1 + (p in ("embedder_pretrain", "combined")))
                   for ph in phases for p in ph)
    forwards += 2 * n_val * len(phases) + n_val
    _require(mix_launches == forwards,
             f"{mix_launches} factor_mix launches for {forwards} forwards")
    past = TRAIN_CONFIG["num_pretrain_epochs"] \
        + TRAIN_CONFIG["num_acclimation_epochs"]
    _require(res.best_it >= past and math.isfinite(res.best_loss),
             f"best_it {res.best_it} was not set past pretraining")
    art = load_model(root)
    _require(art["model_class"] == "RedcliffSCMLP", "artifact class")
    for a, b in zip(_leaves_np(art["params"]),
                    _leaves_np(interop.params_to_jax(res.params))):
        _require(a.shape == b.shape and bool((a == b).all()),
                 "final_best_model.bin does not hold the best params")

    by_phase = {}
    for e in res.epochs:
        by_phase.setdefault("+".join(e["phases"]), []).append(e["ms"])
    steps = sum(n_tr * len(ph) for ph in phases)
    _emit({"phase": "train", "device": torch.cuda.get_device_name(0),
           "config": "D4IC REDCLIFF-S, full width (C=10, gen_lag 4, "
                     "gen_hidden 25, embed_lag 16, K=5, DGCNN 3x100)",
           "reduced": {"num_pretrain_epochs": "50 -> 1",
                       "num_acclimation_epochs": "15 -> 1",
                       "max_iter": "1000 -> 4", "check_every": "10 -> 1"},
           "train_windows": len(train_ds), "val_windows": len(val_ds),
           "batch_size": B, "batches_per_epoch": n_tr,
           "val_batches": n_val, "prox_lam": PROX_LAM,
           "epochs": len(res.epochs), "steps": steps,
           "fit_wall_s": fit_s, "steps_per_s": steps / fit_s,
           "epoch_ms": [e["ms"] for e in res.epochs],
           "epoch_ms_p50_by_phase": {k: float(np.percentile(v, 50))
                                     for k, v in by_phase.items()},
           "factor_mix_launches": mix_launches,
           "gl_prox_launches": prox_launches, "skipped": 0,
           "best_it": res.best_it, "best_loss": res.best_loss,
           "val_combo_loss": res.histories["avg_combo_loss"],
           "final_val_loss": res.final_val_loss,
           "group_norm_sum_first_last": [float(first_norms.sum()),
                                         float(_group_norms(
                                             np, last["params"]["factors"][
                                                 0]["w"]).sum())],
           "min_group_norm": float(norms.min())})
    return mix_launches, prox_launches, model, params, train_ds


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_np(v)]
    return [tree]


def _train_steps(torch, np, model, host_params, batches, device,
                 prox=True):
    """Guarded combined steps on ``device``, one per batch (with the
    train phase's prox unless ``prox`` is False); returns the losses and
    the params after them."""
    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.runtime import numerics
    from redcliff_tpu_torch.train.redcliff_trainer import (
        RedcliffTrainConfig, RedcliffTrainer)

    knobs = TRAIN_KNOBS if prox else dict(TRAIN_KNOBS, prox_penalty=None)
    trainer = RedcliffTrainer(model, RedcliffTrainConfig(**knobs),
                              device=device)
    live = trainer.live_params(host_params)
    optA, optB = trainer.make_optimizers(live)
    nstate = numerics.init_numerics_state()
    losses = []
    for X, Y in batches:
        combo, _, nstate, ok = trainer.train_step(
            live, optA, optB, torch.from_numpy(X).to(trainer.device),
            torch.from_numpy(Y).to(trainer.device), "combined", nstate)
        _require(ok, f"train_check: a step on {device} was skipped")
        losses.append(float(combo.detach()))
    return np.asarray(losses), interop.params_to_jax(live)


def phase_train_check(torch, model, params, train_ds):
    """Card against the port's CPU path: the same weights, the same
    batches, TRAIN_CHECK_STEPS guarded combined steps with the prox."""
    import numpy as np

    from redcliff_tpu_torch import interop

    host = interop.params_to_jax(params)
    batches = [b for _, b in zip(range(TRAIN_CHECK_STEPS), train_ds.batches(
        TRAIN_KNOBS["batch_size"], rng=np.random.default_rng(2)))]
    card_l, card_p = _train_steps(torch, np, model, host, batches, "cuda")
    cpu_l, cpu_p = _train_steps(torch, np, model, host, batches, "cpu")
    torch.cuda.synchronize()
    _require(bool(np.isfinite(card_l).all()), "train_check: non-finite loss")
    _require(bool(np.allclose(card_l, cpu_l, rtol=TRAIN_LOSS_RTOL,
                              atol=TRAIN_LOSS_ATOL)),
             f"train_check: losses card {card_l.tolist()} vs CPU "
             f"{cpu_l.tolist()}")
    diffs = [float(np.abs(a - b).max())
             for a, b in zip(_leaves_np(card_p), _leaves_np(cpu_p))]
    _require(max(diffs) <= TRAIN_PARAM_ATOL,
             f"train_check: params differ by {max(diffs)} > "
             f"{TRAIN_PARAM_ATOL}")
    _emit({"phase": "train_check", "against": "port CPU path, same weights "
           "and batches", "steps": len(batches),
           "loss_rtol": TRAIN_LOSS_RTOL, "loss_atol": TRAIN_LOSS_ATOL,
           "param_atol": TRAIN_PARAM_ATOL,
           "max_loss_rel_err": float(np.max(np.abs(card_l - cpu_l)
                                            / np.abs(cpu_l))),
           "max_param_abs_err": max(diffs), "card_losses": card_l.tolist()})


def phase_profile_train(torch, FM, PX, model, params, train_ds):
    """Where a training step's time goes (``--profile`` only): each
    kernel's device time alone at the training shapes, then a profiled
    window of full-width combined steps — host wall per step, device busy
    per step, the device's idle share, and the top device ops."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.runtime import numerics
    from redcliff_tpu_torch.train.redcliff_trainer import (
        RedcliffTrainConfig, RedcliffTrainer)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    B = TRAIN_KNOBS["batch_size"]
    wt = torch.rand((B, K_TRAIN), generator=gen).to(dev)
    pt = torch.randn((K_TRAIN, B, 1, C_TRAIN), generator=gen).to(dev)
    Wt = (0.05 * torch.randn((K_TRAIN, C_TRAIN, 25, C_TRAIN, 4),
                             generator=gen)).to(dev)
    lam, lr = PROX_LAM, TRAIN_KNOBS["gen_lr"]
    Wi = Wt.clone()
    Wo = _offset_view(torch, Wt)
    Wc = (0.05 * torch.randn(GISTA_BLOCK, generator=gen)).to(dev)
    one = torch.zeros(1, device=dev)
    alone = _alone_us(torch, {
        "floor: x.zero_()": one.zero_,
        "factor_mix_kernel": lambda: FM.factor_mix(wt, pt),
        "torch.bmm": lambda: torch.bmm(
            wt[:, None, :],
            pt.reshape(K_TRAIN, B, C_TRAIN).transpose(0, 1)),
        "gl_prox_kernel (in place)": lambda: PX.gl_prox_(Wi, lam, lr),
        "gl_prox_kernel (functional)": lambda: PX.gl_prox(Wt, lam, lr),
        # the same block offset by one float: scalar loads, not the TMA
        "gl_prox_kernel (in place, +1 float)": lambda: PX.gl_prox_(
            Wo, lam, lr),
        "gl_prox_plain": lambda: PX.gl_prox_reference(Wt, lam, lr),
        "gl_prox_kernel (cMLP-FM block, in place)": lambda: PX.gl_prox_(
            Wc, lam, lr),
        "gl_prox_plain (cMLP-FM block)": lambda: PX.gl_prox_reference(
            Wc, lam, lr)})

    trainer = RedcliffTrainer(model, RedcliffTrainConfig(**TRAIN_KNOBS))
    live = trainer.live_params(interop.params_to_jax(params))
    optA, optB = trainer.make_optimizers(live)
    nstate = numerics.init_numerics_state()
    batches = list(train_ds.batches(B, rng=np.random.default_rng(4),
                                    device=dev))
    n_warm, n_prof = 4, len(batches) - 4
    for X, Y in batches[:n_warm]:
        _, _, nstate, _ = trainer.train_step(live, optA, optB, X, Y,
                                             "combined", nstate)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for X, Y in batches[n_warm:]:
            _, _, nstate, _ = trainer.train_step(live, optA, optB, X, Y,
                                                 "combined", nstate)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    per, busy_us = _device_us(torch, prof, n_prof)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:12]

    # the prox step as the trainer runs it (in place) beside the functional
    # update written back (allocation, kernel, copy): the device ops and
    # the aten ops of one call
    w_live = live["factors"][0]["w"]
    prox_step = {}
    for name, fn in (
            ("apply_prox_ (in place, the trainer)",
             lambda: model.apply_prox_(live, lam, lr)),
            ("apply_prox + copy_", lambda: w_live.copy_(
                model.apply_prox(live, lam, lr)["factors"][0]["w"]))):
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p2:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
        prox_step[name] = {
            "device_us_per_call": _device_us(torch, p2, 20)[0],
            "aten_ops_per_call": {
                e.key: e.count / 20 for e in p2.key_averages()
                if e.key.startswith("aten::")}}
    inplace = prox_step["apply_prox_ (in place, the trainer)"]
    _require(len(inplace["device_us_per_call"]) == 1
             and "gl_prox_kernel" in next(iter(inplace["device_us_per_call"]))
             and not inplace["aten_ops_per_call"],
             f"the trainer's prox step is not one kernel launch: {inplace}")
    _emit({"phase": "profile_train", "device": torch.cuda.get_device_name(0),
           "device_us_per_call_alone": alone, "steps": n_prof,
           "step_wall_ms_profiled": wall_ms,
           "device_busy_us_per_step": busy_us,
           "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms
                                 if busy_us else None),
           "device_ops_per_step": len(per),
           "top_device_us_per_step": dict(top),
           "prox_step": prox_step})


def phase_profile_baselines(torch, models, train_ds):
    """Where a baseline step's time goes (``--profile`` only): for each
    family, a profiled window of guarded steps at the published widths on
    the card — host wall per step, device busy per step, the device's idle
    share and the top device ops."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.models.redcliff import RedcliffSCMLP
    from redcliff_tpu_torch.runtime import numerics
    from redcliff_tpu_torch.train.redcliff_trainer import (
        RedcliffTrainConfig, RedcliffTrainer)
    from redcliff_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda")
    B = 128
    X = torch.from_numpy(train_ds.X[:8 * B]).to(dev)
    Y = torch.from_numpy(train_ds.Y[:8 * B]).to(dev)
    batches = [(X[i * B:(i + 1) * B], Y[i * B:(i + 1) * B]) for i in range(8)]
    n_warm = 2
    out = {}
    for family, (model, lr, prox) in models.items():
        host = interop.params_to_jax(model.init(
            torch.Generator().manual_seed(0)))
        nstate = numerics.init_numerics_state()
        if isinstance(model, RedcliffSCMLP):
            trainer = RedcliffTrainer(model, RedcliffTrainConfig(
                **dict(TRAIN_KNOBS, prox_penalty=None)))
            live = trainer.live_params(host)
            opts = trainer.make_optimizers(live)

            def step(Xb, Yb, nstate):
                return trainer.train_step(live, *opts, Xb, Yb, "combined",
                                          nstate)[2]
        else:
            trainer = Trainer(model, TrainConfig(
                learning_rate=lr, prox_penalty="GL" if prox else None,
                prox_lam=PROX_LAM),
                has_labels=type(model).__name__ == "DGCNNModel")
            live = trainer.live_params(host)
            opt = trainer.make_optimizer(live)

            def step(Xb, Yb, nstate):
                return trainer.train_step(live, opt, Xb, Yb, None,
                                          nstate)[2]
        for Xb, Yb in batches[:n_warm]:
            nstate = step(Xb, Yb, nstate)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for Xb, Yb in batches[n_warm:]:
                nstate = step(Xb, Yb, nstate)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / (8 - n_warm)
        per, busy_us = _device_us(torch, prof, 8 - n_warm)
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        out[family] = {"step_wall_ms_profiled": wall_ms,
                       "device_busy_us_per_step": busy_us,
                       "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms
                                             if busy_us else None),
                       "device_ops_per_step": len(per),
                       "top_device_us_per_step": dict(top)}
    _emit({"phase": "profile_baselines",
           "device": torch.cuda.get_device_name(0),
           "steps": 8 - n_warm, "batch_size": B, "families": out})


def _grid_points():
    """The 27 engine points of the published grid, lane order gen_lr x
    ADJ_L1 x COS_SIM, and their raw axis values."""
    from redcliff_tpu_torch.train.driver import (
        rescale_dataset_dependent_coefficients)

    def rescaled(key, raw):
        d = {"coeff_dict": {key: raw}, "num_factors": K_TRAIN,
             "num_channels": C_TRAIN}
        rescale_dataset_dependent_coefficients(d)
        return d["coeff_dict"][key]

    points, raw = [], []
    for lr in GRID_GEN_LR:
        for adj in GRID_ADJ_L1:
            for cs in GRID_COS_SIM:
                c = rescaled("FACTOR_COS_SIM_COEFF", cs)
                points.append({"gen_lr": lr,
                               "adj_l1_reg_coeff": rescaled(
                                   "ADJ_L1_REG_COEFF", adj),
                               "factor_cos_sim_coeff": c,
                               "stopping_criteria_cosSim_coeff": c})
                raw.append({"gen_lr": lr, "ADJ_L1_REG_COEFF": adj,
                            "FACTOR_COS_SIM_COEFF": cs})
    return points, raw


def _warmup_launches(stats):
    """Kernel launches of the warm-up steps of the fit's captured programs
    (one step each, run on the device and counted): per program, its
    launches per replay over its steps."""
    out = {"factor_mix": 0, "gl_prox": 0}
    for p in stats["programs"]:
        for k, n in p["launches_per_replay"].items():
            out[k] += n // p["steps"]
    return out


def _stream_budget(stats, res, n_train, n_val, scan_batches=0):
    """The train and validation dispatches the fit's epochs may make
    (``data/pipeline.py dispatch_budget``; multi-phase epochs step per
    batch and phase), against the counted ones."""
    from redcliff_tpu_torch.data.pipeline import dispatch_budget

    B = TRAIN_KNOBS["batch_size"]
    tr, vl = (n_train // B, int(n_train % B > 0)), (n_val // B,
                                                     int(n_val % B > 0))
    train = sum(dispatch_budget(*tr, scan_batches, e["mode"])
                * len(e["phases"]) for e in res.epochs)
    val_mode = "epoch" if stats["mode"] == "epoch" else "per_batch"
    val = len(res.epochs) * dispatch_budget(*vl, mode=val_mode)
    return {"train": stats["train_dispatches"], "train_budget": train,
            "val": stats["val_dispatches"], "val_budget": val}


def _own_lane_fit(model, params, point, train_ds, val_ds):
    """The port's per-point fit of one grid point on the card, from the
    grid's weights: the point's coefficients in the model config, its
    optimizer and stopping values in the train config."""
    import dataclasses

    from redcliff_tpu_torch.models.redcliff import RedcliffSCMLP
    from redcliff_tpu_torch.train.redcliff_trainer import (
        RedcliffTrainConfig, RedcliffTrainer)

    cfg = dataclasses.replace(model.config, **{
        k: v for k, v in point.items() if hasattr(model.config, k)})
    tc = RedcliffTrainConfig(**{**TRAIN_KNOBS, **{
        k: v for k, v in point.items() if not hasattr(model.config, k)}})
    return RedcliffTrainer(RedcliffSCMLP(cfg), tc).fit(params, train_ds,
                                                       val_ds)


def phase_grid(torch, FM, PX):
    """The published D4IC grid through ``run_coefficient_grid``: counts
    at 0 just before, read just after; then one lane against the port's
    per-point fit of its point on the card."""
    import math

    import numpy as np

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)
    from redcliff_tpu_torch.train.driver import run_coefficient_grid
    from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig

    points, raw = _grid_points()
    train_ds, val_ds = _train_data(np)
    model = RedcliffSCMLP(RedcliffSCMLPConfig(**TRAIN_CONFIG))
    params = model.init(torch.Generator().manual_seed(0))
    tc = RedcliffTrainConfig(**TRAIN_KNOBS)
    run_dir = os.path.join(HERE, "build", "chip_smoke", "grid")
    shutil.rmtree(run_dir, ignore_errors=True)

    # ---- the main path: counts at 0 just before, read just after
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    res = run_coefficient_grid(model, tc, points, train_ds, val_ds,
                               init_point_params=params, run_dir=run_dir)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    mix_launches = FM.factor_mix.launches
    prox_launches = PX.gl_prox.launches

    G = GRID_LANES
    B = TRAIN_KNOBS["batch_size"]
    n_tr = -(-len(train_ds) // B)
    n_val = -(-len(val_ds) // B)
    phases = [tuple(e["phases"]) for e in res.epochs]
    _require(phases[:3] == [("embedder_pretrain",), ("factor_pretrain",),
                            ("combined",)], f"grid phase schedule {phases}")
    _require(res.val_history.shape == (len(phases), G)
             and bool(np.isfinite(res.val_history).all()),
             f"grid val history {res.val_history}")
    _require(bool(np.isfinite(res.best_criteria).all()),
             f"grid best criteria {res.best_criteria}")
    skipped = int(sum(res.numerics["skipped"]))
    _require(skipped == 0, f"the grid's guard skipped {skipped} steps")
    _require(res.failures == [], f"quarantined lanes: {res.failures}")
    _require(not os.path.exists(os.path.join(run_dir, "failures.json")),
             "failures.json written for a grid without failures")
    for leaf in interop.tree_leaves(res.best_params):
        _require(leaf.shape[0] == G and bool(np.isfinite(leaf).all()),
                 "grid best params: shape or non-finite")
    # the default stream mode resolves to the epoch engine on the card:
    # one replay per epoch's full batches and one for the remainder, the
    # same for validation
    stats = res.dispatch_stats
    budget = _stream_budget(stats, res, len(train_ds), len(val_ds))
    _require(stats["mode"] == "epoch"
             and all(e["mode"] == "epoch" for e in res.epochs)
             and budget["train"] == budget["train_budget"]
             and budget["val"] == budget["val_budget"]
             and stats["graph_captures"] == len(stats["programs"]) > 0,
             f"grid: stream {stats['mode']}, dispatches {budget}")
    # executions: one forward per step (all lanes at once) and one per
    # validation batch, one prox per factor step (all lanes at once), each
    # counted at its replay, plus the warm-up step before each capture
    warm = _warmup_launches(stats)
    forwards = sum(n_tr * len(ph) + n_val for ph in phases)
    _require(mix_launches == forwards + warm["factor_mix"],
             f"{mix_launches} factor_mix launches for {forwards} grid "
             f"forwards and {warm['factor_mix']} warm-up steps")
    factor_steps = sum(n_tr for ph in phases for p in ph
                       if p != "embedder_pretrain")
    _require(prox_launches == factor_steps + warm["gl_prox"]
             and factor_steps > 0,
             f"{prox_launches} gl_prox launches for {factor_steps} grid "
             f"factor steps and {warm['gl_prox']} warm-up steps")
    past = TRAIN_CONFIG["num_pretrain_epochs"] \
        + TRAIN_CONFIG["num_acclimation_epochs"]
    _require(bool((res.best_epoch >= past).all()),
             f"grid best epochs {res.best_epoch.tolist()} not past "
             f"pretraining")

    # one lane against the per-point fit of its point, on the card
    g = GRID_OWN_LANE
    own = _own_lane_fit(model, params, points[g], train_ds, val_ds)
    # the per-point fit stops at its early stop; the lane freezes there
    own_hist = np.asarray(own.histories["avg_combo_loss"])
    lane_hist = res.val_history[:len(own_hist), g]
    lane = {"best_epoch": int(res.best_epoch[g]), "best_it": own.best_it,
            "loss_rtol": GRID_LANE_LOSS_RTOL,
            "loss_atol": GRID_LANE_LOSS_ATOL,
            "criteria_rtol": GRID_LANE_CRIT_RTOL,
            "param_atol": GRID_LANE_PARAM_ATOL,
            "criteria_rel_err": float(abs(res.best_criteria[g]
                                          - own.best_loss)
                                      / abs(own.best_loss)),
            "max_val_loss_rel_err": float(np.max(
                np.abs(lane_hist - own_hist) / np.abs(own_hist))),
            "max_param_abs_err": max(
                float(np.abs(a[g] - b).max()) for a, b in zip(
                    _leaves_np(res.best_params),
                    _leaves_np(interop.params_to_jax(own.params))))}
    _require(lane["best_epoch"] == own.best_it
             and math.isclose(res.best_criteria[g], own.best_loss,
                              rel_tol=GRID_LANE_CRIT_RTOL)
             and bool(np.allclose(lane_hist, own_hist,
                                  rtol=GRID_LANE_LOSS_RTOL,
                                  atol=GRID_LANE_LOSS_ATOL))
             and lane["max_param_abs_err"] <= GRID_LANE_PARAM_ATOL,
             f"grid lane {g} vs its per-point fit: {lane}")

    by_phase = {}
    for e in res.epochs:
        by_phase.setdefault("+".join(e["phases"]), []).append(e["ms"])
    steps = sum(n_tr * len(ph) for ph in phases)
    _emit({"phase": "grid", "device": torch.cuda.get_device_name(0),
           "config": "the D4IC REDCLIFF-S of the train phase; the published "
                     "D4IC grid (experiments/d4ic_grid_search.py:70-72)",
           "axes": {"gen_lr": list(GRID_GEN_LR),
                    "ADJ_L1_REG_COEFF": list(GRID_ADJ_L1),
                    "FACTOR_COS_SIM_COEFF": list(GRID_COS_SIM)},
           "lanes": G,
           "reduced": {"num_pretrain_epochs": "50 -> 1",
                       "num_acclimation_epochs": "15 -> 1",
                       "max_iter": "1000 -> 4", "check_every": "10 -> 1",
                       "lookback": "5 -> 1"},
           "stream_mode": stats["mode"], "epochs": len(phases),
           "dispatches": budget,
           "graph_captures": stats["graph_captures"],
           "capture_ms": stats["capture_ms"],
           "warmup_launches": warm,
           "steps": steps, "fit_wall_s": fit_s,
           "steps_per_s": steps / fit_s,
           "lane_steps_per_s": G * steps / fit_s,
           "epoch_ms": [e["ms"] for e in res.epochs],
           "epoch_ms_p50_by_phase": {k: float(np.percentile(v, 50))
                                     for k, v in by_phase.items()},
           "factor_mix_launches": mix_launches,
           "gl_prox_launches": prox_launches, "skipped": skipped,
           "quarantined": len(res.failures),
           "active_lanes": int(res.active.sum()),
           "best_epoch": res.best_epoch.tolist(),
           "val_combo_loss_last": res.val_history[-1].tolist(),
           "own_lane": g, "own_lane_point": raw[g],
           "own_lane_vs_per_point": lane})
    return mix_launches, prox_launches, model, params, train_ds, res


def _without_res(run):
    return {k: v for k, v in run.items() if k != "res"}


def phase_grid_stream(torch, FM, PX, params):
    """The grid in its three stream modes through ``run_coefficient_grid``
    from the same seed-0 weights: per_batch, auto (the epoch engine) and
    kscan. Each fit's counts at 0 just before it, read just after; the
    captured fits against the per_batch one."""
    import numpy as np

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)
    from redcliff_tpu_torch.train.driver import run_coefficient_grid
    from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig

    points, _ = _grid_points()
    train_ds, val_ds = _train_data(np)
    model = RedcliffSCMLP(RedcliffSCMLPConfig(**TRAIN_CONFIG))
    B = TRAIN_KNOBS["batch_size"]
    n_tr = -(-len(train_ds) // B)
    n_val = -(-len(val_ds) // B)
    knobs = {**TRAIN_KNOBS, "max_iter": STREAM_MAX_ITER,
             "lookback": STREAM_LOOKBACK}
    runs, launches = {}, {}
    for name, over in (("per_batch", {"stream_mode": "per_batch"}),
                       ("auto", {}),
                       ("kscan", {"stream_mode": "kscan",
                                  "scan_batches": STREAM_SCAN_BATCHES})):
        tc = RedcliffTrainConfig(**knobs, **over)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # ---- a main path: counts at 0 just before, read just after
        FM.factor_mix.launches = 0
        PX.gl_prox.launches = 0
        t0 = time.perf_counter()
        res = run_coefficient_grid(model, tc, points, train_ds, val_ds,
                                   init_point_params=params)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches[name] = {"factor_mix": FM.factor_mix.launches,
                          "gl_prox": PX.gl_prox.launches}
        st = res.dispatch_stats
        phases = [tuple(e["phases"]) for e in res.epochs]
        warm = _warmup_launches(st)
        forwards = sum(n_tr * len(ph) + n_val for ph in phases)
        factor_steps = sum(n_tr for ph in phases for p in ph
                           if p != "embedder_pretrain")
        budget = _stream_budget(st, res, len(train_ds), len(val_ds),
                                tc.scan_batches)
        by_phase = {}
        for e in res.epochs:
            by_phase.setdefault("+".join(e["phases"]), []).append(e["ms"])
        runs[name] = {
            "res": res, "mode": st["mode"], "fit_wall_s": fit_s,
            "epochs": len(res.epochs), "dispatches": budget,
            "graph_captures": st["graph_captures"],
            "capture_ms": st["capture_ms"],
            "programs": [{k: p[k] for k in ("kind", "phase", "steps",
                                             "rows", "capture_ms")}
                         for p in st["programs"]],
            "epoch_ms_by_phase": by_phase,
            "epoch_ms_p50_by_phase": {k: float(np.percentile(v, 50))
                                      for k, v in by_phase.items()},
            "train_time_ms": st["train_time_ms"],
            "val_time_ms": st["val_time_ms"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": launches[name], "warmup_launches": warm,
            "executions_expected": {
                "factor_mix": forwards + warm["factor_mix"],
                "gl_prox": factor_steps + warm["gl_prox"]}}
    want = {"per_batch": "per_batch", "auto": "epoch", "kscan": "kscan"}
    ref = runs["per_batch"]["res"]
    for name, r in runs.items():
        d = r["dispatches"]
        _require(r["mode"] == want[name]
                 and r["epochs"] == STREAM_MAX_ITER
                 and d["train"] == d["train_budget"]
                 and d["val"] == d["val_budget"]
                 and r["launches"] == r["executions_expected"]
                 and (r["graph_captures"] > 0) == (name != "per_batch"),
                 f"grid_stream {name}: {_without_res(r)}")
        res = r["res"]
        r["max_abs_diff_vs_per_batch"] = {
            "val_history": float(np.nanmax(np.abs(res.val_history
                                                  - ref.val_history))),
            "best_criteria": float(np.nanmax(np.abs(res.best_criteria
                                                    - ref.best_criteria))),
            "best_params": max(float(np.abs(a - b).max()) for a, b in zip(
                _leaves_np(res.best_params), _leaves_np(ref.best_params)))}
        r["bitwise_equal_to_per_batch"] = bool(
            np.array_equal(res.val_history, ref.val_history)
            and np.array_equal(res.best_criteria, ref.best_criteria)
            and all(np.array_equal(a, b) for a, b in zip(
                _leaves_np(res.best_params), _leaves_np(ref.best_params))))
        same = {"best_epoch": bool(np.array_equal(res.best_epoch,
                                                  ref.best_epoch)),
                "active": bool(np.array_equal(res.active, ref.active)),
                "failures": res.failures == ref.failures}
        r["decisions_equal_to_per_batch"] = same
        _require(all(same.values())
                 and np.allclose(res.val_history, ref.val_history,
                                 equal_nan=True, **STREAM_HIST)
                 and np.allclose(res.best_criteria, ref.best_criteria,
                                 equal_nan=True, **STREAM_HIST)
                 and all(np.allclose(a, b, **STREAM_PARAMS) for a, b in zip(
                     _leaves_np(res.best_params),
                     _leaves_np(ref.best_params))),
                 f"grid_stream {name} vs per_batch: decisions {same}, "
                 f"max abs diffs {r['max_abs_diff_vs_per_batch']}")
    # the guard quarantines the points the JAX grid quarantines, and only
    # those; their lanes may hold NaN, every other lane is finite
    failed = sorted(f["point"] for f in ref.failures)
    _require(failed == list(STREAM_QUARANTINED)
             and {f["cause"] for f in ref.failures} == {"nonfinite_grad"},
             f"grid_stream: quarantined {ref.failures}, want the points "
             f"{list(STREAM_QUARANTINED)} (nonfinite_grad)")
    healthy = [g for g in range(GRID_LANES) if g not in failed]
    _require(bool(np.isfinite(ref.val_history[:, healthy]).all()),
             f"grid_stream: non-finite validation losses outside the "
             f"quarantined lanes {failed}")
    _emit({"phase": "grid_stream", "device": torch.cuda.get_device_name(0),
           "config": "the grid phase's 27 points, model, data and seed-0 "
                     "weights; three stream modes",
           "lanes": GRID_LANES, "width": 32,
           "reduced": {"num_pretrain_epochs": "50 -> 1",
                       "num_acclimation_epochs": "15 -> 1",
                       "max_iter": f"1000 -> {STREAM_MAX_ITER}",
                       "check_every": "10 -> 1",
                       "lookback": f"5 -> {STREAM_LOOKBACK} (the same "
                                   f"50-epoch stop-after span)"},
           "scan_batches": STREAM_SCAN_BATCHES,
           "bars": {"history": STREAM_HIST, "params": STREAM_PARAMS},
           "per_batch_failures": ref.failures,
           "per_batch_skipped": int(sum(ref.numerics["skipped"])),
           "per_batch_best_epoch": ref.best_epoch.tolist(),
           "runs": {n: _without_res(r) for n, r in runs.items()}})
    return {n: r["launches"] for n, r in runs.items()}


def _grid_steps(torch, np, model, host_params, batches, device):
    """GRID_CHECK_STEPS combined steps of the 27-lane grid (exact width) on
    ``device`` from ``host_params`` replicated over the lanes; returns the
    per-lane losses and the stacked params after them."""
    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.parallel.grid import GridSpec, RedcliffGridRunner
    from redcliff_tpu_torch.runtime import numerics
    from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig

    runner = RedcliffGridRunner(
        model, RedcliffTrainConfig(**TRAIN_KNOBS, g_bucket=False),
        GridSpec(_grid_points()[0]), device=device)
    params, optA, optB = runner.init_grid_from(host_params)
    nstate = numerics.init_numerics_state(lanes=GRID_LANES,
                                          device=runner.device)
    active = torch.ones(GRID_LANES, dtype=torch.bool, device=runner.device)
    losses = []
    for X, Y in batches:
        nstate, combo = runner._step(
            "combined", params, optA, optB, nstate, active,
            torch.from_numpy(X).to(runner.device),
            torch.from_numpy(Y).to(runner.device))
        losses.append(combo.cpu().numpy())
    _require(int(nstate["skipped"].sum()) == 0,
             f"grid_check: a step on {device} was skipped")
    return np.stack(losses), interop.params_to_jax(params)


def phase_grid_check(torch, model, params, train_ds):
    """Card against the port's CPU path: the same weights, the same
    batches, GRID_CHECK_STEPS combined grid steps of all 27 lanes."""
    import numpy as np

    from redcliff_tpu_torch import interop

    host = interop.params_to_jax(params)
    batches = [b for _, b in zip(range(GRID_CHECK_STEPS), train_ds.batches(
        TRAIN_KNOBS["batch_size"], rng=np.random.default_rng(5)))]
    card_l, card_p = _grid_steps(torch, np, model, host, batches, "cuda")
    cpu_l, cpu_p = _grid_steps(torch, np, model, host, batches, "cpu")
    torch.cuda.synchronize()
    _require(bool(np.isfinite(card_l).all()), "grid_check: non-finite loss")
    _require(bool(np.allclose(card_l, cpu_l, rtol=TRAIN_LOSS_RTOL,
                              atol=TRAIN_LOSS_ATOL)),
             f"grid_check: losses card vs CPU differ by "
             f"{float(np.abs(card_l - cpu_l).max())}")
    # per lane: the 8 steps' update (params after - before) agrees to a
    # relative L2 error of GRID_CHECK_REL, and no element differs by more
    # than the two Adam steps' worth it can reach where a subgradient
    # switches between the runs (the adjacency-L1 |x| at a GC entry near
    # zero): 2 * lr * steps, the lane's larger lr
    G = GRID_LANES
    lanes_lr = np.asarray([max(p["gen_lr"], TRAIN_KNOBS["embed_lr"])
                           for p in _grid_points()[0]])
    flat = lambda tree: np.concatenate([  # noqa: E731
        np.asarray(x, np.float64).reshape(G, -1) for x in _leaves_np(tree)],
        axis=1)
    card_f, cpu_f = flat(card_p), flat(cpu_p)
    init_f = np.concatenate([np.broadcast_to(
        np.asarray(x, np.float64).reshape(1, -1), (G, np.size(x)))
        for x in _leaves_np(host)], axis=1)
    rel = (np.linalg.norm(card_f - cpu_f, axis=1)
           / np.linalg.norm(cpu_f - init_f, axis=1))
    worst = np.abs(card_f - cpu_f).max(axis=1)
    bound = 2.0 * lanes_lr * len(batches)
    _require(bool((rel <= GRID_CHECK_REL).all()
                  and (worst <= bound).all()),
             f"grid_check: per-lane update rel. err {rel.tolist()} (bar "
             f"{GRID_CHECK_REL}), max abs err {worst.tolist()} (bars "
             f"{bound.tolist()})")
    _emit({"phase": "grid_check", "against": "port CPU path, same weights "
           "and batches", "lanes": G, "steps": len(batches),
           "loss_rtol": TRAIN_LOSS_RTOL, "loss_atol": TRAIN_LOSS_ATOL,
           "update_rel_l2": GRID_CHECK_REL,
           "param_abs_bar": "2 * lr * steps per lane",
           "max_loss_rel_err": float(np.max(np.abs(card_l - cpu_l)
                                            / np.abs(cpu_l))),
           "max_update_rel_err": float(rel.max()),
           "max_param_abs_err": float(worst.max()),
           "lanes_above_1e-4": [int(g) for g in np.flatnonzero(worst > 1e-4)],
           "max_param_abs_err_by_lane": worst.tolist()})


def phase_profile_grid(torch, FM, PX, model, params, train_ds):
    """Where a grid step's time goes (``--profile`` only): each lane
    kernel's device time alone beside its library call and plain version,
    then a profiled window of 27-lane combined steps — host wall per step,
    device busy per step, the device's idle share, and the top device
    ops."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.parallel.epoch_engine import EpochEngine
    from redcliff_tpu_torch.parallel.grid import GridSpec, RedcliffGridRunner
    from redcliff_tpu_torch.runtime import numerics
    from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    G, B = GRID_LANES, TRAIN_KNOBS["batch_size"]
    wg = torch.rand((G, B, K_TRAIN), generator=gen).to(dev)
    pg = torch.randn((G, K_TRAIN, B, 1, C_TRAIN), generator=gen).to(dev)
    Wg = (0.05 * torch.randn((G, K_TRAIN, C_TRAIN, 25, C_TRAIN, 4),
                             generator=gen)).to(dev)
    Wgi, Wgo = Wg.clone(), _offset_view(torch, Wg)
    tg = PX.lane_thresholds(_grid_lr(torch, dev), PROX_LAM)
    on = torch.ones(G, dtype=torch.bool, device=dev)
    one = torch.zeros(1, device=dev)
    B_rem = N_TRAIN % B
    wr = torch.rand((G, B_rem, K_TRAIN), generator=gen).to(dev)
    pr = torch.randn((G, K_TRAIN, B_rem, 1, C_TRAIN), generator=gen).to(dev)
    ladder = {}
    for width, live in ((32, GRID_LANES), (16, 15)):
        wl, pl, Wl, tl, gl = _ladder_inputs(torch, PX, gen, dev, width, live)
        Wli = Wl.clone()
        ladder.update({
            f"factor_mix_kernel (lanes, G={width})":
                lambda wl=wl, pl=pl: FM.factor_mix_lanes(wl, pl),
            f"torch.matmul (lanes, G={width})":
                lambda wl=wl, pl=pl: _mix_lanes_library(torch, wl, pl),
            f"gl_prox_kernel (lanes, G={width}, {live} on, in place)":
                lambda Wli=Wli, tl=tl, gl=gl: PX.gl_prox_lanes_(Wli, tl, gl),
            f"gl_prox_lanes_plain (G={width}, {live} on)":
                lambda Wl=Wl, tl=tl, gl=gl: PX.gl_prox_lanes_reference(
                    Wl, tl, gl)})
    alone = _alone_us(torch, {
        **ladder,
        f"factor_mix_kernel (lanes, B={B_rem})":
            lambda: FM.factor_mix_lanes(wr, pr),
        f"torch.matmul (lanes, B={B_rem})":
            lambda: _mix_lanes_library(torch, wr, pr),
        "floor: x.zero_()": one.zero_,
        "factor_mix_kernel (lanes)": lambda: FM.factor_mix_lanes(wg, pg),
        "torch.matmul (lanes, permuted operands)":
            lambda: _mix_lanes_library(torch, wg, pg),
        "factor_mix_lanes_plain": lambda: FM.factor_mix_lanes_reference(
            wg, pg),
        "gl_prox_kernel (lanes, in place)":
            lambda: PX.gl_prox_lanes_(Wgi, tg, on),
        "gl_prox_kernel (lanes, in place, +1 float)":
            lambda: PX.gl_prox_lanes_(Wgo, tg, on),
        "gl_prox_lanes_plain": lambda: PX.gl_prox_lanes_reference(
            Wg, tg, on)})

    runner = RedcliffGridRunner(
        model, RedcliffTrainConfig(**TRAIN_KNOBS, g_bucket=False),
        GridSpec(_grid_points()[0]))
    gparams, optA, optB = runner.init_grid_from(
        interop.params_to_jax(params))
    nstate = numerics.init_numerics_state(lanes=G, device=dev)
    active = torch.ones(G, dtype=torch.bool, device=dev)
    batches = list(train_ds.batches(B, rng=np.random.default_rng(7),
                                    device=dev))
    n_warm, n_prof = 3, 8

    def step(X, Y):
        return runner._step("combined", gparams, optA, optB, nstate, active,
                            X, Y)[0]

    for X, Y in batches[:n_warm]:
        nstate = step(X, Y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for X, Y in batches[n_warm:n_warm + n_prof]:
            nstate = step(X, Y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    per, busy_us = _device_us(torch, prof, n_prof)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:12]

    # one combined epoch replayed by the epoch engine (its programs
    # captured by a first epoch), on the same runner and state
    engine = EpochEngine(runner, "epoch", train_ds, train_ds, {
        "train_dispatches": 0, "val_dispatches": 0, "graph_captures": 0,
        "capture_ms": 0.0, "programs": []})
    engine.new_era(G)
    state = (gparams, optA, optB, nstate)
    rng = np.random.default_rng(8)
    t0 = time.perf_counter()
    engine.train_epoch("epoch", "combined", state, active, train_ds, rng)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as eprof:
        t0 = time.perf_counter()
        start.record()
        engine.train_epoch("epoch", "combined", state, active, train_ds, rng)
        end.record()
        torch.cuda.synchronize()
        epoch_wall_ms = (time.perf_counter() - t0) * 1e3
    eper, ebusy_us = _device_us(torch, eprof, 1)
    etop = sorted(eper.items(), key=lambda kv: -kv[1])[:12]
    n_steps = -(-len(train_ds) // B)
    _emit({"phase": "profile_grid", "device": torch.cuda.get_device_name(0),
           "device_us_per_call_alone": alone, "lanes": G, "steps": n_prof,
           "step_wall_ms_profiled": wall_ms,
           "device_busy_us_per_step": busy_us,
           "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms
                                 if busy_us else None),
           "device_ops_per_step": len(per),
           "top_device_us_per_step": dict(top),
           "kernels_in_eager_steps": _kernel_us(torch, prof),
           "replayed_epoch": {
               "steps": n_steps, "replays": 2,
               "first_epoch_ms_with_capture": first_ms,
               "capture_ms": engine.stats["capture_ms"],
               "wall_ms_profiled": epoch_wall_ms,
               "event_ms": start.elapsed_time(end),
               "device_busy_us": ebusy_us,
               "device_busy_us_per_step": ebusy_us / n_steps,
               "device_idle_share": (1.0 - ebusy_us / 1e3 / epoch_wall_ms
                                     if ebusy_us else None),
               "device_ops": len(eper),
               "top_device_us": dict(etop),
               "kernels_in_replay": _kernel_us(torch, eprof),
               "eager_step_wall_ms_x_steps": wall_ms * n_steps}})


def _width_profile(torch, np, FM, PX, model, params, train_ds, points,
                   live):
    """Host wall ms, device busy us and kernel launches per combined step
    of the grid engine at the bucket-ladder width of ``live`` of the
    points (filler lanes gated off), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from redcliff_tpu_torch.parallel.grid import GridSpec, RedcliffGridRunner
    from redcliff_tpu_torch.runtime import numerics
    from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig

    runner = RedcliffGridRunner(model, RedcliffTrainConfig(**TRAIN_KNOBS),
                                GridSpec(points[:live]))
    width = runner._g_exec0
    gp, optA, optB = runner.pad_to_width(runner.init_grid_from(params))
    dev = runner.device
    nstate = numerics.init_numerics_state(lanes=width, device=dev)
    active = torch.arange(width, device=dev) < live
    batches = list(train_ds.batches(TRAIN_KNOBS["batch_size"],
                                    rng=np.random.default_rng(9),
                                    device=dev))
    n = DURABLE_PROFILE_STEPS

    def step(X, Y):
        return runner._step("combined", gp, optA, optB, nstate, active, X,
                            Y)[0]

    for X, Y in batches[:2]:
        nstate = step(X, Y)
    torch.cuda.synchronize()
    mix0, prox0 = FM.factor_mix.launches, PX.gl_prox.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for X, Y in batches[2:2 + n]:
            nstate = step(X, Y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    per, busy_us = _device_us(torch, prof, n)
    return {"width": width, "live": live, "steps": n,
            "step_host_ms": wall_ms, "step_device_us": busy_us,
            "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms
                                  if busy_us else None),
            "factor_mix_launches_per_step": (FM.factor_mix.launches
                                             - mix0) / n,
            "gl_prox_launches_per_step": (PX.gl_prox.launches - prox0) / n}


def phase_grid_durable(torch, FM, PX, params):
    """The published grid on the bucket ladder with a checkpoint every
    epoch and lane deadlines that force one compaction, through
    ``RedcliffGridRunner.fit``: counts at 0 just before, read just after.
    Then a stopped-and-resumed fit against the uninterrupted one, and each
    ladder width's step cost."""
    import numpy as np

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)
    from redcliff_tpu_torch.parallel.grid import GridSpec, RedcliffGridRunner
    from redcliff_tpu_torch.runtime import numerics
    from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig

    points, _ = _grid_points()
    train_ds, val_ds = _train_data(np)
    model = RedcliffSCMLP(RedcliffSCMLPConfig(**TRAIN_CONFIG))
    spec = GridSpec(points, fit_deadline_s=list(DURABLE_DEADLINES))
    tc = RedcliffTrainConfig(**TRAIN_KNOBS)
    root = os.path.join(HERE, "build", "chip_smoke", "grid_durable")
    shutil.rmtree(root, ignore_errors=True)

    # what the lane prox is handed on every call: the block's width,
    # alignment and layout, and the gate's and thresholds' widths
    blocks = []
    prox_lanes = model.apply_prox_lanes_

    def watched_prox(p, t, gate, penalty="GL"):
        W = p["factors"][0]["w"]
        blocks.append((W.shape[0], W.data_ptr() % 16, W.is_contiguous(),
                       t.shape[0], gate.shape[0]))
        return prox_lanes(p, t, gate, penalty)
    model.apply_prox_lanes_ = watched_prox

    retired, at_retire = [], {}

    def on_retire(pid, rec, epoch):
        retired.append((pid, epoch, rec["failed_cause"]))
        at_retire.setdefault(epoch, (FM.factor_mix.launches,
                                     PX.gl_prox.launches))

    def fit(ck, max_iter=None, hook=None):
        runner = RedcliffGridRunner(model, tc, spec)
        res = runner.fit(None, train_ds, val_ds, max_iter=max_iter,
                         init_params=runner.init_grid_from(params),
                         copy_init=False, checkpoint_dir=ck,
                         checkpoint_every=1, on_lane_retire=hook)
        return runner, res

    # ---- the main path: counts at 0 just before, read just after
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    runner, res = fit(os.path.join(root, "full"), hook=on_retire)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    mix_launches = FM.factor_mix.launches
    prox_launches = PX.gl_prox.launches

    stats = runner.dispatch_stats
    B = TRAIN_KNOBS["batch_size"]
    n_tr = -(-len(train_ds) // B)
    n_val = -(-len(val_ds) // B)
    evicted = list(range(DURABLE_LIVE, GRID_LANES))
    widths = [e["width"] for e in res.epochs]
    phases = [tuple(e["phases"]) for e in res.epochs]
    _require([(f["point"], f["epoch"], f["cause"]) for f in res.failures]
             == [(g, 0, "deadline") for g in evicted],
             f"grid_durable: failures {res.failures}")
    # the deadline evictions retire at epoch 0; lanes that stop early may
    # retire at later check windows and compact the grid further
    _require(sorted(r for r in retired if r[1] == 0)
             == [(g, 0, numerics.CAUSE_DEADLINE) for g in evicted]
             and all(r[2] != numerics.CAUSE_DEADLINE for r in retired
                     if r[1] > 0),
             f"grid_durable: retired lanes {retired}")
    _require(widths[:2] == [32, 16] and max(widths[1:]) == 16
             and len(widths) == TRAIN_KNOBS["max_iter"]
             and stats["compactions"] == len(at_retire),
             f"grid_durable: widths {widths}, stats {stats}")
    _require(not res.active[DURABLE_LIVE:].any()
             and res.val_history.shape == (len(widths), GRID_LANES)
             and bool(np.isfinite(res.val_history).all())
             and bool(np.isfinite(res.best_criteria[:DURABLE_LIVE]).all())
             and bool(np.isinf(res.best_criteria[DURABLE_LIVE:]).all()),
             "grid_durable: results not at the original ids (the evicted "
             "lanes stopped before any stopping criteria)")
    _require(sum(res.numerics["skipped"]) == 0,
             "grid_durable: the guard skipped steps")
    # the epoch engine: every epoch replayed, and each era (width 32, then
    # 16 after the compaction) captured its own programs
    budget = _stream_budget(stats, res, len(train_ds), len(val_ds))
    cap_widths = sorted({p["width"] for p in stats["programs"]})
    _require(stats["mode"] == "epoch"
             and all(e["mode"] == "epoch" for e in res.epochs)
             and budget["train"] == budget["train_budget"]
             and budget["val"] == budget["val_budget"]
             and cap_widths == sorted(set(widths)),
             f"grid_durable: stream {stats['mode']}, dispatches {budget}, "
             f"programs captured at widths {cap_widths}")
    # launches by width, measured: the retire hook read the counts at each
    # compaction, i.e. at the end of each width's era; each capture's
    # warm-up step ran on the device and counts
    warm = _warmup_launches(stats)
    warm_by_width = {str(w): {"factor_mix": 0, "gl_prox": 0}
                     for w in widths}
    for p in stats["programs"]:
        for k, n in p["launches_per_replay"].items():
            warm_by_width[str(p["width"])][k] += n // p["steps"]
    forwards = sum(n_tr * len(ph) + n_val for ph in phases) \
        + warm["factor_mix"]
    factor_steps = sum(n_tr for ph in phases for p in ph
                       if p != "embedder_pretrain") + warm["gl_prox"]
    by_width, prev = {}, (0, 0)
    for epoch, counts in sorted(at_retire.items()) + [
            (len(widths) - 1, (mix_launches, prox_launches))]:
        w = by_width.setdefault(str(widths[epoch]),
                                {"factor_mix": 0, "gl_prox": 0})
        w["factor_mix"] += counts[0] - prev[0]
        w["gl_prox"] += counts[1] - prev[1]
        prev = counts
    mix32 = n_tr * len(phases[0]) + n_val \
        + warm_by_width["32"]["factor_mix"]
    prox32 = sum(n_tr for p in phases[0] if p != "embedder_pretrain") \
        + warm_by_width["32"]["gl_prox"]
    _require(by_width["32"] == {"factor_mix": mix32, "gl_prox": prox32}
             and mix_launches == forwards
             and prox_launches == factor_steps > 0,
             f"grid_durable: launches {mix_launches}/{prox_launches} for "
             f"{forwards} forwards and {factor_steps} factor steps (warm-up "
             f"steps included); by width {by_width}")
    # the lane prox's Python wrapper runs at each warm-up and capture (a
    # replay runs the captured launches): every block it was handed is
    # the era's aligned, contiguous slab with a gate and thresholds of its
    # width
    prox_widths = {w for w, ph in zip(widths, phases) for p in ph
                   if p != "embedder_pretrain"}
    _require({b[0] for b in blocks} == prox_widths
             and all(b[1:] == (0, True, b[0], b[0]) for b in blocks)
             and PX.prox_plan(TRAIN_CONFIG["gen_hidden"][0], C_TRAIN,
                              TRAIN_CONFIG["gen_lag"], 0)[1],
             f"grid_durable: the lane prox was handed {set(blocks)}")
    model.apply_prox_lanes_ = prox_lanes

    # ---- stopped after DURABLE_RESUME_AT epochs, resumed to the horizon
    ck = os.path.join(root, "resumed")
    fit(ck, max_iter=DURABLE_RESUME_AT)
    resumed_runner, resumed = fit(ck)
    # the resume loads new leaves: its programs are captured anew
    _require(resumed_runner.dispatch_stats["resumed_from_epoch"]
             == DURABLE_RESUME_AT - 1
             and resumed_runner.dispatch_stats["graph_captures"] > 0
             and [e["epoch"] for e in resumed.epochs]
             == list(range(DURABLE_RESUME_AT, TRAIN_KNOBS["max_iter"])),
             f"grid_durable: the resume ran {resumed.epochs}")
    same = (np.array_equal(resumed.best_epoch, res.best_epoch)
            and np.array_equal(resumed.active, res.active)
            and resumed.failures == res.failures)
    rel = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
              for a, b in zip(_leaves_np(resumed.best_params),
                              _leaves_np(res.best_params)))
    bitwise = all(np.array_equal(a, b) for a, b in zip(
        _leaves_np(resumed.best_params), _leaves_np(res.best_params))) \
        and np.array_equal(resumed.val_history, res.val_history) \
        and np.array_equal(resumed.best_criteria, res.best_criteria)
    _require(same and rel <= DURABLE_PARAM_REL,
             f"grid_durable: resumed vs uninterrupted: decisions "
             f"{'same' if same else 'differ'}, params rel. err {rel}")

    step_by_width = {str(w): _width_profile(
        torch, np, FM, PX, model, interop.params_to_jax(params), train_ds,
        points, live) for w, live in ((32, GRID_LANES), (16, DURABLE_LIVE))}
    epoch_ms = {}
    for e in res.epochs:
        steps = n_tr * len(e["phases"])
        epoch_ms.setdefault(str(e["width"]), []).append(
            {"epoch": e["epoch"], "phases": e["phases"], "ms": e["ms"],
             "ms_per_step": e["ms"] / steps})
    _emit({"phase": "grid_durable", "device": torch.cuda.get_device_name(0),
           "config": "the grid phase's 27 points, model, data and depth; "
                     "checkpoint_every=1; fit_deadline_s 1e6 for points "
                     "0-14, 1e-3 for 15-26",
           "fit_wall_s": fit_s, "widths_by_epoch": widths,
           "stream_mode": stats["mode"], "dispatches": budget,
           "graph_captures": stats["graph_captures"],
           "capture_ms": stats["capture_ms"],
           "captures_by_width": {str(w): sum(
               1 for p in stats["programs"] if p["width"] == w)
               for w in cap_widths},
           "warmup_launches_by_width": warm_by_width,
           "resumed_graph_captures": resumed_runner.dispatch_stats[
               "graph_captures"],
           "compactions": stats["compactions"],
           "lane_epochs": stats["lane_epochs"],
           "lane_epochs_nominal": stats["lane_epochs_nominal"],
           "evicted": evicted, "retired_at_epoch": 0,
           "retired": retired,
           "prox_blocks": {"widths": sorted({b[0] for b in blocks}),
                           "aligned_16B": True, "contiguous": True,
                           "tma_path": True},
           "launches": {"factor_mix": mix_launches,
                        "gl_prox": prox_launches},
           "launches_by_width": by_width,
           "epoch_host_ms_by_width": epoch_ms,
           "step_by_width": step_by_width,
           "checkpoint": {"bytes": stats["ckpt_bytes"],
                          "saves": stats["ckpt_saves"],
                          "write_ms_mean": stats["ckpt_stall_ms"]
                          / stats["ckpt_saves"],
                          "load_ms": resumed_runner.dispatch_stats[
                              "ckpt_load_ms"]},
           "resume": {"stopped_after_epochs": DURABLE_RESUME_AT,
                      "decisions_identical": same,
                      "max_param_rel_err": rel,
                      "param_rel_bar": DURABLE_PARAM_REL,
                      "bitwise_equal": bool(bitwise)},
           "best_epoch": res.best_epoch.tolist(),
           "active_lanes": int(res.active.sum())})
    return mix_launches, prox_launches


def phase_array_task(torch, FM, PX):
    """One array task of the published D4IC REDCLIFF-S configuration
    through ``set_up_and_run_experiments`` on the card: counts at 0 just
    before, read just after; then the artifact reloads through the port's
    ``eval/model_io.py``."""
    import math

    import numpy as np

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.data.shards import save_cv_split
    from redcliff_tpu_torch.eval.model_io import load_model_for_eval
    from redcliff_tpu_torch.models.redcliff import phase_schedule
    from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint
    from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
    from redcliff_tpu_torch.utils.config import serialize_tensor_to_string

    root = os.path.join(HERE, "build", "chip_smoke", "array_task")
    shutil.rmtree(root, ignore_errors=True)
    X, Y, graphs = _d4ic_like_data(np, N_TRAIN + N_VAL, seed=0)
    pairs = [[x, y] for x, y in zip(X, Y)]
    save_cv_split(pairs[:N_TRAIN], pairs[N_TRAIN:], 0,
                  os.path.join(root, "data"))
    data_args = os.path.join(root, f"{ARRAY_TASK_DATA}_cached_args.txt")
    with open(data_args, "w") as f:
        json.dump({"data_root_path": os.path.join(root, "data", "fold_0"),
                   "num_channels": str(C_TRAIN),
                   **{f"net{k + 1}_adjacency_tensor":
                      serialize_tensor_to_string(g)
                      for k, g in enumerate(graphs)}}, f)
    model_args = os.path.join(root, f"{ARRAY_TASK_MODEL}_d4IC_BSCgs1_"
                                    f"cached_args.txt")
    with open(model_args, "w") as f:
        json.dump({**ARRAY_TASK_ARGS, **ARRAY_TASK_CUTS}, f)
    runs = os.path.join(root, "runs")
    os.makedirs(runs)
    args = {"save_root_path": runs}

    # ---- the main path: counts at 0 just before, read just after
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    task = set_up_and_run_experiments(args, [model_args], [data_args],
                                      [ARRAY_TASK_MODEL], [ARRAY_TASK_DATA],
                                      task_id=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    mix_launches = FM.factor_mix.launches
    prox_launches = PX.gl_prox.launches

    _require(task == 1 and len(os.listdir(runs)) == 1,
             f"array_task: runs {os.listdir(runs)}")
    run_dir = os.path.join(runs, os.listdir(runs)[0])
    model, params = load_model_for_eval(run_dir)
    cfg = model.config
    _require((cfg.num_chans, cfg.gen_hidden, cfg.num_factors,
              cfg.dgcnn_num_graph_conv_layers, cfg.dgcnn_num_hidden_nodes)
             == (C_TRAIN, (25,), K_TRAIN, 3, 100)
             and math.isclose(cfg.adj_l1_reg_coeff,
                              TRAIN_CONFIG["adj_l1_reg_coeff"])
             and math.isclose(cfg.factor_cos_sim_coeff,
                              TRAIN_CONFIG["factor_cos_sim_coeff"]),
             f"array_task: artifact config {cfg}")
    leaves = _leaves_np(interop.params_to_jax(params))
    _require(all(bool(np.isfinite(x).all()) for x in leaves),
             "array_task: non-finite artifact params")
    with torch.no_grad():
        Xw = torch.from_numpy(X[:8, :cfg.embed_lag]).to(params[
            "factors"][0]["w"].device)
        gc = model.gc(params, X=Xw, ignore_lag=False)
    _require(bool(torch.isfinite(gc).all())
             and tuple(gc.shape) == (8, K_TRAIN, C_TRAIN, C_TRAIN,
                                     TRAIN_CONFIG["gen_lag"]),
             f"array_task: GC readout {tuple(gc.shape)}")
    meta = read_checkpoint(os.path.join(
        run_dir, "training_meta_data_and_hyper_parameters.pkl"))
    B = TRAIN_KNOBS["batch_size"]
    n_tr, n_val = -(-N_TRAIN // B), -(-N_VAL // B)
    phases = [phase_schedule(cfg, it) for it in range(meta["epoch"] + 1)]
    forwards = sum(n_tr * (1 + (p in ("embedder_pretrain", "combined")))
                   for ph in phases for p in ph)
    forwards += 2 * n_val * len(phases) + n_val
    _require(mix_launches == forwards and prox_launches == 0,
             f"array_task: {mix_launches} factor_mix launches for "
             f"{forwards} forwards, {prox_launches} gl_prox launches (the "
             f"array task sets no prox)")
    _require(all(math.isfinite(v) for v in meta["avg_combo_loss"]),
             f"array_task: val losses {meta['avg_combo_loss']}")
    _emit({"phase": "array_task", "device": torch.cuda.get_device_name(0),
           "config": "published D4IC REDCLIFF-S cached-args "
                     "(experiments/accuracy_parity_d4ic.py:70-97), no prox",
           "reduced": ARRAY_TASK_CUTS,
           "run_dir": os.path.relpath(run_dir, HERE), "task_id": task,
           "train_windows": N_TRAIN, "val_windows": N_VAL,
           "epochs": len(phases), "fit_wall_s": fit_s,
           "factor_mix_launches": mix_launches,
           "gl_prox_launches": prox_launches, "best_it": meta["best_it"],
           "val_combo_loss": meta["avg_combo_loss"],
           "gc_shape": list(gc.shape)})
    return mix_launches, prox_launches, runs


def _write_fold(np, root, name, T):
    """The train phase's windows at T steps as a fold written by the port's
    ``save_cv_split``, and its data cached-args file (the 5 true graphs).
    Returns the cached-args path and the numpy windows."""
    from redcliff_tpu_torch.data.shards import save_cv_split
    from redcliff_tpu_torch.utils.config import serialize_tensor_to_string

    X, Y, graphs = _d4ic_like_data(np, N_TRAIN + N_VAL, seed=0, T=T)
    pairs = [[x, y] for x, y in zip(X, Y)]
    save_cv_split(pairs[:N_TRAIN], pairs[N_TRAIN:], 0,
                  os.path.join(root, "data"))
    data_args = os.path.join(root, f"{name}_cached_args.txt")
    with open(data_args, "w") as f:
        json.dump({"data_root_path": os.path.join(root, "data", "fold_0"),
                   "num_channels": str(C_TRAIN),
                   **{f"net{k + 1}_adjacency_tensor":
                      serialize_tensor_to_string(g)
                      for k, g in enumerate(graphs)}}, f)
    return data_args, X


def _redcliff_forwards(cfg, epochs, n_tr, n_val):
    """The REDCLIFF-S forwards (factor-mix launches) of a per-point fit of
    ``epochs`` epochs: one per step (the loss), one per step of the phases
    that track the label confusion, two per validation batch (loss and
    confusion) each epoch, one per batch of the final validation."""
    from redcliff_tpu_torch.models.redcliff import phase_schedule

    phases = [phase_schedule(cfg, it) for it in range(epochs)]
    forwards = sum(n_tr * (1 + (p in ("embedder_pretrain", "combined")))
                   for ph in phases for p in ph)
    return forwards + 2 * n_val * len(phases) + n_val


def phase_baselines(torch, FM, PX):
    """The baseline families on the card: each family's published D4IC
    array task through ``set_up_and_run_experiments`` (counts at 0 just
    before each, read just after), then the cMLP-FM GISTA fit through
    ``Trainer`` with the GL prox. One line per family. Returns the
    factor-mix and GL-prox executions of the path, and for baselines_check
    each family's (model, learning rate, prox on) and the training
    windows."""
    import math

    import numpy as np

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.data.shards import load_normalized_split_datasets
    from redcliff_tpu_torch.eval.gc_estimates import get_model_gc_estimates
    from redcliff_tpu_torch.eval.model_io import load_model_for_eval
    from redcliff_tpu_torch.models.cmlp_fm import CMLPFM, CMLPFMConfig
    from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint
    from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
    from redcliff_tpu_torch.train.trainer import TrainConfig, Trainer

    root = os.path.join(HERE, "build", "chip_smoke", "baselines")
    shutil.rmtree(root, ignore_errors=True)
    data_args, X = _write_fold(np, root, BASELINE_DATA, BASELINE_T)
    B = 128
    n_tr, n_val = -(-N_TRAIN // B), -(-N_VAL // B)
    mix_total = prox_total = 0
    models = {}
    for family, args in BASELINE_ARGS.items():
        margs = os.path.join(root, f"{family}_d4IC_cached_args.txt")
        with open(margs, "w") as f:
            json.dump({**args, **BASELINE_CUTS[family]}, f)
        runs = os.path.join(root, "runs", family)
        os.makedirs(runs)
        # ---- the main path: counts at 0 just before, read just after
        FM.factor_mix.launches = 0
        PX.gl_prox.launches = 0
        t0 = time.perf_counter()
        task = set_up_and_run_experiments(
            {"save_root_path": runs}, [margs], [data_args], [family],
            [BASELINE_DATA], task_id=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        mix, prox = FM.factor_mix.launches, PX.gl_prox.launches

        _require(task == 1 and len(os.listdir(runs)) == 1,
                 f"baselines {family}: runs {os.listdir(runs)}")
        run_dir = os.path.join(runs, os.listdir(runs)[0])
        model, params = load_model_for_eval(run_dir)
        models[family] = (model, float(args.get(
            "gen_lr", args.get("learning_rate"))), False)
        meta = read_checkpoint(os.path.join(
            run_dir, "training_meta_data_and_hyper_parameters.pkl"))
        epochs = meta["epoch"] + 1
        losses = meta["avg_combo_loss"]
        # the task's per-epoch log of steps and skips, in its checkpoint
        log = read_checkpoint(os.path.join(
            run_dir, "trainer_checkpoint.pkl"))["epoch_log"]
        skipped = sum(e["skipped"] for e in log)
        actions = [e["action"] for e in log]
        _require(len(losses) == epochs
                 and all(math.isfinite(v) for v in losses),
                 f"baselines {family}: val losses {losses}")
        _require(log and log[-1]["epoch"] == meta["epoch"],
                 f"baselines {family}: epoch log {log}")
        _require("abort" not in actions and skipped == 0,
                 f"baselines {family}: monitor actions {actions}, "
                 f"{skipped} skipped steps")
        leaves = _leaves_np(interop.params_to_jax(params))
        _require(all(bool(np.isfinite(x).all()) for x in leaves),
                 f"baselines {family}: non-finite artifact params")
        Xe = X[N_TRAIN:N_TRAIN + 32]
        if "REDCLIFF" in family:
            Xe = Xe[:, :model.config.max_lag]
        ests = get_model_gc_estimates(model, params, BASELINE_ALG[family],
                                      K_TRAIN, X=Xe)
        _require(len(ests) == K_TRAIN
                 and all(e.shape[:2] == (C_TRAIN, C_TRAIN)
                         and bool(np.isfinite(e).all()) for e in ests),
                 f"baselines {family}: GC estimates "
                 f"{[e.shape for e in ests]}")
        if "REDCLIFF" in family:
            want_mix = _redcliff_forwards(model.config, epochs, n_tr,
                                          n_val)
        else:
            want_mix = 0
        # the array tasks set no prox, in either package
        _require(mix == want_mix and prox == 0,
                 f"baselines {family}: {mix} factor_mix launches "
                 f"({want_mix} expected), {prox} gl_prox launches (0)")
        mix_total += mix
        steps = sum(e["steps"] + e["skipped"] for e in log) \
            if "REDCLIFF" not in family else sum(
                sum(e["steps"].values()) + e["skipped"] for e in log)
        _emit({"phase": "baselines", "family": family,
               "device": torch.cuda.get_device_name(0),
               "model": type(model).__name__,
               "config": "published D4IC cached-args "
                         "(experiments/accuracy_parity_d4ic.py)",
               "reduced": BASELINE_CUTS[family],
               "run_dir": os.path.relpath(run_dir, HERE),
               "recording_steps": BASELINE_T,
               "train_recordings": N_TRAIN, "val_recordings": N_VAL,
               "epochs": epochs, "best_epoch": meta["best_it"],
               "steps": steps, "fit_wall_s": fit_s,
               "steps_per_s": steps / fit_s,
               "epoch_ms": [e["ms"] for e in log],
               "skipped": skipped, "val_combo_loss": losses,
               "gc_estimate_shape": list(ests[0].shape),
               "factor_mix_launches": mix, "gl_prox_launches": prox})

    # ---- the cMLP-FM GISTA fit at the cMLP widths
    args = BASELINE_ARGS["cMLP"]
    model = CMLPFM(CMLPFMConfig(
        num_chans=C_TRAIN, gen_lag=int(args["gen_lag_and_input_len"]),
        gen_hidden=(50,), input_length=int(args["gen_lag_and_input_len"]),
        adj_l1_coeff=float(args["ADJ_L1_REG_COEFF"])))
    train_ds, val_ds = load_normalized_split_datasets(
        os.path.join(root, "data", "fold_0"), grid_search=False,
        device="cuda")
    trainer = Trainer(model, TrainConfig(
        learning_rate=float(args["gen_lr"]), max_iter=4, lookback=1,
        check_every=1, batch_size=B, seed=0, prox_penalty="GL",
        prox_lam=PROX_LAM))
    params = model.init(torch.Generator().manual_seed(0), trainer.device)
    _require(tuple(params["factor"][0]["w"].shape) == GISTA_BLOCK,
             f"GISTA block {tuple(params['factor'][0]['w'].shape)}")
    gdir = os.path.join(root, "gista")
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    res = trainer.fit(params, train_ds, val_ds, save_dir=gdir)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    mix, prox = FM.factor_mix.launches, PX.gl_prox.launches
    applied = sum(e["steps"] for e in res.epochs)
    _require(res.aborted is None and res.numerics["skipped"] == 0
             and all(math.isfinite(v)
                     for v in res.histories["avg_combo_loss"]),
             f"GISTA fit: aborted {res.aborted}, skipped "
             f"{res.numerics['skipped']}, {res.histories['avg_combo_loss']}")
    _require(prox == applied == n_tr * len(res.epochs) > 0 and mix == 0,
             f"GISTA fit: {prox} gl_prox launches for {applied} applied "
             f"steps, {mix} factor_mix launches")
    last = read_checkpoint(os.path.join(gdir, "trainer_checkpoint.pkl"))
    norms = np.concatenate([
        _group_norms(np, last["params"]["factor"][0]["w"]).ravel(),
        _group_norms(np, interop.params_to_jax(res.params)["factor"][0][
            "w"]).ravel()])
    _require(bool((norms > 0).all()), "GISTA fit: the prox zeroed a group")
    gm, gp = load_model_for_eval(gdir)
    _require(type(gm) is CMLPFM, "GISTA fit: artifact class")
    first = _group_norms(np, interop.params_to_jax(params)["factor"][0]["w"])
    _emit({"phase": "baselines", "family": "cMLP GISTA",
           "device": torch.cuda.get_device_name(0), "model": "CMLPFM",
           "config": "the cMLP widths (gen_hidden [50], lag 2, batch 128) "
                     "through Trainer, prox_penalty GL",
           "reduced": {"max_iter": "1000 -> 4", "check_every": "10 -> 1"},
           "prox_lam": PROX_LAM, "learning_rate": float(args["gen_lr"]),
           "block": list(GISTA_BLOCK), "epochs": len(res.epochs),
           "best_epoch": res.best_it, "steps": applied,
           "fit_wall_s": fit_s, "steps_per_s": applied / fit_s,
           "epoch_ms": [e["ms"] for e in res.epochs], "skipped": 0,
           "val_combo_loss": res.histories["avg_combo_loss"],
           "group_norm_sum_first_last": [
               float(first.sum()), float(_group_norms(
                   np, last["params"]["factor"][0]["w"]).sum())],
           "min_group_norm": float(norms.min()),
           "factor_mix_launches": mix, "gl_prox_launches": prox})
    models["cMLP GISTA"] = (model, float(args["gen_lr"]), True)
    return mix_total, prox, models, train_ds


def _baseline_steps(torch, np, model, lr, prox, host_params, batches,
                    device):
    """Guarded steps of one family on ``device``, one per batch (the
    generic trainer's step at learning rate ``lr``, with the GL prox when
    ``prox``; or REDCLIFF-S's combined step): the losses and the params
    after them."""
    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.models.redcliff import RedcliffSCMLP
    from redcliff_tpu_torch.runtime import numerics
    from redcliff_tpu_torch.train.trainer import TrainConfig, Trainer

    if isinstance(model, RedcliffSCMLP):
        return _train_steps(torch, np, model, host_params, batches, device,
                            prox=False)
    trainer = Trainer(model, TrainConfig(
        learning_rate=lr, prox_penalty="GL" if prox else None,
        prox_lam=PROX_LAM), has_labels=type(model).__name__ == "DGCNNModel",
        device=device)
    live = trainer.live_params(host_params)
    opt = trainer.make_optimizer(live)
    nstate = numerics.init_numerics_state()
    losses = []
    for X, Y in batches:
        combo, _, nstate, ok = trainer.train_step(
            live, opt, torch.from_numpy(X).to(trainer.device),
            torch.from_numpy(Y).to(trainer.device), None, nstate)
        _require(ok, f"baselines_check: a step on {device} was skipped")
        losses.append(float(combo.detach()))
    return np.asarray(losses), interop.params_to_jax(live)


def phase_baselines_check(torch, PX, models, train_ds):
    """Card against the port's CPU path for each family: the same weights
    (the port's init, seed 0), the same batches, BASELINE_CHECK_STEPS
    guarded steps; the GISTA fit's steps run the GL prox (the kernel on
    the card)."""
    import numpy as np

    from redcliff_tpu_torch import interop

    X = train_ds.X
    Y = train_ds.Y
    rng = np.random.default_rng(2)
    order = rng.permutation(len(X))
    B = 128
    batches = [(X[order[i * B:(i + 1) * B]], Y[order[i * B:(i + 1) * B]])
               for i in range(BASELINE_CHECK_STEPS)]
    out = {}
    for family, (model, lr, prox) in models.items():
        host = interop.params_to_jax(model.init(
            torch.Generator().manual_seed(0)))
        prox0 = PX.gl_prox.launches
        card_l, card_p = _baseline_steps(torch, np, model, lr, prox, host,
                                         batches, "cuda")
        prox_card = PX.gl_prox.launches - prox0
        cpu_l, cpu_p = _baseline_steps(torch, np, model, lr, prox, host,
                                       batches, "cpu")
        torch.cuda.synchronize()
        diffs = [float(np.abs(a - b).max())
                 for a, b in zip(_leaves_np(card_p), _leaves_np(cpu_p))]
        rel = float(np.max(np.abs(card_l - cpu_l) / np.abs(cpu_l)))
        _require(bool(np.isfinite(card_l).all())
                 and bool(np.allclose(card_l, cpu_l, rtol=TRAIN_LOSS_RTOL,
                                      atol=TRAIN_LOSS_ATOL))
                 and max(diffs) <= TRAIN_PARAM_ATOL,
                 f"baselines_check {family}: losses card {card_l.tolist()} "
                 f"vs CPU {cpu_l.tolist()}, params differ by {max(diffs)}")
        _require(prox_card == (BASELINE_CHECK_STEPS if prox else 0),
                 f"baselines_check {family}: {prox_card} gl_prox launches")
        out[family] = {"max_loss_rel_err": rel, "max_param_abs_err":
                       max(diffs), "card_losses": card_l.tolist(),
                       "gl_prox_launches": prox_card}
    _emit({"phase": "baselines_check", "against": "port CPU path, same "
           "weights and batches", "steps": BASELINE_CHECK_STEPS,
           "loss_rtol": TRAIN_LOSS_RTOL, "loss_atol": TRAIN_LOSS_ATOL,
           "param_atol": TRAIN_PARAM_ATOL, "families": out})


def phase_dcsfa(torch, FM, PX):
    """DCSFA-NMF on the card: the published d4IC cached-args, depth cut,
    as array task 1 through ``set_up_and_run_experiments`` (counts at 0
    just before, read just after: the path launches neither kernel). The
    directed-spectrum features are host work inside the task; the fit log
    gives the NMF pretrain, the encoder pretrain's and the joint fit's
    steps and walls, and each epoch. The run's 5 component graphs are read
    out with ``get_model_gc_estimates`` and scored against the 5 true
    graphs with ``evaluate_algorithm_on_fold``. Returns the executions and
    what dcsfa_check needs."""
    import math

    import numpy as np

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.data.shards import load_normalized_split_datasets
    from redcliff_tpu_torch.eval.cross_alg import evaluate_algorithm_on_fold
    from redcliff_tpu_torch.eval.gc_estimates import get_model_gc_estimates
    from redcliff_tpu_torch.eval.model_io import load_model_for_eval
    from redcliff_tpu_torch.models.dcsfa_nmf import FIT_LOG_NAME
    from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint
    from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
    from redcliff_tpu_torch.utils.config import load_true_gc_factors

    root = os.path.join(HERE, "build", "chip_smoke", "dcsfa")
    shutil.rmtree(root, ignore_errors=True)
    data_args, _ = _write_fold(np, root, BASELINE_DATA, BASELINE_T)
    margs = os.path.join(root, f"{DCSFA_MODEL}_d4IC_OBPgs1_cached_args.txt")
    with open(margs, "w") as f:
        json.dump({**DCSFA_ARGS, **DCSFA_CUTS}, f)
    runs = os.path.join(root, "runs")
    os.makedirs(runs)
    t0 = time.perf_counter()
    load_normalized_split_datasets(os.path.join(root, "data", "fold_0"),
                                   grid_search=False)
    load_s = time.perf_counter() - t0

    # ---- the main path: counts at 0 just before, read just after
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    task = set_up_and_run_experiments(
        {"save_root_path": runs}, [margs], [data_args], [DCSFA_MODEL],
        [BASELINE_DATA], task_id=1)
    torch.cuda.synchronize()
    task_s = time.perf_counter() - t0
    mix, prox = FM.factor_mix.launches, PX.gl_prox.launches

    _require(task == 1 and len(os.listdir(runs)) == 1,
             f"dcsfa: runs {os.listdir(runs)}")
    run_dir = os.path.join(runs, os.listdir(runs)[0])
    _require(mix == 0 and prox == 0,
             f"dcsfa: {mix} factor_mix / {prox} gl_prox launches (0, 0)")
    log = read_checkpoint(os.path.join(run_dir, FIT_LOG_NAME))
    hist = log["histories"]
    B = int(DCSFA_ARGS["batch_size"])
    n_tr = -(-N_TRAIN // B)
    _require(log["device"].startswith("cuda"), f"dcsfa: fit on {log['device']}")
    _require(log["dim_in"] == DCSFA_FEATURES and log["n"] == N_TRAIN,
             f"dcsfa: {log['n']} x {log['dim_in']} features")
    _require(log["pre_steps"] == int(DCSFA_CUTS["n_pre_epochs"]) * n_tr
             and log["joint_steps"] == int(DCSFA_CUTS["n_epochs"]) * n_tr,
             f"dcsfa: {log['pre_steps']} pretrain / {log['joint_steps']} "
             f"joint steps")
    _require(all(math.isfinite(v) for k in ("training", "recon",
                                            "val_recon") for v in hist[k])
             and hist["best_epoch"] >= 0,
             f"dcsfa: histories {hist}")
    model, params, state = load_model_for_eval(run_dir)
    _require(type(model).__name__ == "FullDCSFAModel"
             and model.gc_feature_layout == "vanilla"
             and tuple(params["W_nmf"].shape) == (K_TRAIN, DCSFA_FEATURES)
             and params["W_nmf"].is_cuda,
             f"dcsfa: artifact {type(model).__name__}")
    leaves = _leaves_np(interop.params_to_jax(params))
    _require(all(bool(np.isfinite(x).all()) for x in leaves),
             "dcsfa: non-finite artifact params")
    ests = get_model_gc_estimates(model, params, "DCSFA", K_TRAIN)
    _require(len(ests) == K_TRAIN
             and all(e.shape == (C_TRAIN, C_TRAIN)
                     and bool(np.isfinite(e).all()) for e in ests),
             f"dcsfa: GC estimates {[e.shape for e in ests]}")
    true_gcs = load_true_gc_factors(data_args)
    stats = evaluate_algorithm_on_fold(run_dir, "DCSFA", true_gcs)
    f1 = {k: v for k, v in stats.items() if not k.startswith("factor_")}
    pre_s, joint_s = log["pre_s"], log["joint_s"]
    fit_s = (log["nmf_ms"] / 1e3 + pre_s
             + sum(e["ms"] for e in log["epochs"]) / 1e3)
    _emit({"phase": "dcsfa", "device": torch.cuda.get_device_name(0),
           "model": type(model).__name__,
           "config": "published d4IC DCSFA cached-args "
                     "(experiments/accuracy_parity_d4ic.py:132-141)",
           "reduced": DCSFA_CUTS, "run_dir": os.path.relpath(run_dir, HERE),
           "train_recordings": N_TRAIN, "val_recordings": N_VAL,
           "features": log["dim_in"], "task_wall_s": task_s,
           # the task's wall outside the fit and the fold's load: the host
           # features, most of it (dcsfa_check times them alone)
           "features_and_setup_s_host": task_s - fit_s - load_s,
           "fold_load_s": load_s, "nmf_pretrain_ms": log["nmf_ms"],
           "component_order": log["component_order"],
           "encoder_pretrain_steps": log["pre_steps"],
           "encoder_pretrain_steps_per_s": log["pre_steps"] / pre_s,
           "joint_steps": log["joint_steps"],
           "joint_steps_per_s": log["joint_steps"] / joint_s,
           "epoch_ms": [e["ms"] for e in log["epochs"]],
           "epoch_steps_ms": [e["steps_ms"] for e in log["epochs"]],
           "training_loss": hist["training"], "val_recon": hist["val_recon"],
           "val_auc": hist["val_pred"], "best_epoch": hist["best_epoch"],
           "gc_estimate_shape": list(ests[0].shape),
           "f1_across_factors": {
               p: {k: v for k, v in s.items() if k.endswith("mean_across_"
                                                             "factors")}
               for p, s in f1.items()},
           "factor_mix_launches": mix, "gl_prox_launches": prox})
    return mix, prox, model, root, margs


def _dcsfa_steps(torch, np, model, host_params, host_state, batches,
                 device):
    """Joint DCSFA steps on ``device`` from host params and state, one per
    batch: the losses and the params and state after them."""
    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.models.dcsfa_nmf import _live
    from redcliff_tpu_torch.utils.precision import resolve_device

    dev = resolve_device(device)  # full float32 on the card
    live = _live(interop.params_from_jax(host_params, dev))
    state = interop.params_from_jax(host_state, dev)
    phase = model.make_phase(live, pretrain=False)
    losses = []
    for b in batches:
        batch = tuple(torch.from_numpy(a).to(dev) for a in b)
        state, lv = model.train_step(live, state, phase, batch, False)
        losses.append(lv)
    losses = torch.stack(losses).cpu().numpy()
    return (losses, interop.params_to_jax(live),
            interop.params_to_jax(state))


def phase_dcsfa_check(torch, model, root, margs):
    """Card against the port's CPU path: the NMF pretrain's component order
    from both (on the features of the first 512 training recordings), then
    DCSFA_CHECK_STEPS joint steps from the same post-NMF params and the
    same batches (weighted draws with replacement, as the fit draws them):
    losses within TRAIN_LOSS_RTOL, params within TRAIN_PARAM_ATOL, but the
    BatchNorm-cancelled encoder bias and the running mean that tracks it
    within DCSFA_BIAS_WALK. Returns the host features, labels and params
    (for the profile)."""
    import numpy as np

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.data.shards import (apply_signal_format,
                                                load_normalized_split_datasets)
    from redcliff_tpu_torch.models.dcsfa_nmf import nmf_fit, order_components
    from redcliff_tpu_torch.utils.config import read_in_model_args

    args = read_in_model_args({"model_type": DCSFA_MODEL,
                               "model_cached_args_file": margs})
    train_ds, _ = load_normalized_split_datasets(
        os.path.join(root, "data", "fold_0"), grid_search=False)
    n = min(512, len(train_ds))
    t0 = time.perf_counter()
    X = apply_signal_format(train_ds.X[:n], args["signal_format"],
                            args["max_num_features_per_series"],
                            args["dirspec_params"])
    feat_s = time.perf_counter() - t0
    y = train_ds.Y[:n].reshape(n, -1)[:, :K_TRAIN]
    cfg = model.config
    orders, nmf_ms = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        s_nmf, _ = nmf_fit(X, cfg.n_components, max_iter=int(
            DCSFA_ARGS["nmf_max_iter"]), loss=cfg.recon_loss, device=dev)
        nmf_ms[dev] = (time.perf_counter() - t0) * 1e3
        orders[dev] = order_components(s_nmf, y, cfg.n_components,
                                       cfg.fixed_corr)[0]
    _require(orders["cuda"] == orders["cpu"],
             f"dcsfa_check: component order card {orders['cuda']} vs CPU "
             f"{orders['cpu']}")
    params, state = model.init(torch.Generator().manual_seed(0),
                               X.shape[1])
    params, _ = model.pretrain_nmf(params, X, y,
                                   int(DCSFA_ARGS["nmf_max_iter"]))
    host_p = interop.params_to_jax(params)
    host_s = interop.params_to_jax(state)
    rng = np.random.default_rng(2)
    B = int(DCSFA_ARGS["batch_size"])
    ones = np.ones((B, 1), np.float32)
    batches = []
    for _ in range(DCSFA_CHECK_STEPS):
        idx = rng.choice(n, size=B, replace=True)
        batches.append((X[idx], y[idx], np.ones_like(y[idx]), ones, ones))
    card_l, card_p, card_s = _dcsfa_steps(torch, np, model, host_p, host_s,
                                          batches, "cuda")
    cpu_l, cpu_p, cpu_s = _dcsfa_steps(torch, np, model, host_p, host_s,
                                       batches, "cpu")
    walked = ("enc1/b", "bn_mean")

    def diffs(a, b, prefix=""):
        out = {}
        for k, v in a.items():
            if isinstance(v, dict):
                out.update(diffs(v, b[k], f"{prefix}{k}/"))
            else:
                out[prefix + k] = float(np.abs(v - b[k]).max())
        return out
    d = {**diffs(card_p, cpu_p), **diffs(card_s, cpu_s)}
    held = max(v for k, v in d.items() if k not in walked)
    walk = max(d[k] for k in walked)
    rel = float(np.max(np.abs(card_l - cpu_l) / np.abs(cpu_l)))
    _require(bool(np.isfinite(card_l).all())
             and bool(np.allclose(card_l, cpu_l, rtol=TRAIN_LOSS_RTOL,
                                  atol=TRAIN_LOSS_ATOL))
             and held <= TRAIN_PARAM_ATOL and walk <= DCSFA_BIAS_WALK,
             f"dcsfa_check: losses card {card_l.tolist()} vs CPU "
             f"{cpu_l.tolist()}, params differ by {d}")
    _emit({"phase": "dcsfa_check", "against": "port CPU path, same "
           "post-NMF params and batches", "steps": DCSFA_CHECK_STEPS,
           "recordings": n, "features_s_host": feat_s,
           "features_ms_per_recording": feat_s * 1e3 / n,
           "component_order": orders, "nmf_ms": nmf_ms,
           "loss_rtol": TRAIN_LOSS_RTOL, "param_atol": TRAIN_PARAM_ATOL,
           "max_loss_rel_err": rel, "max_param_abs_err": held,
           "bias_walk_abs": walk, "bias_walk_bound": DCSFA_BIAS_WALK,
           "card_losses": card_l[:, 0].tolist()})
    return X, y, host_p, host_s


def phase_dynotears(torch, FM, PX):
    """DYNOTEARS_Vanilla with the published args as array task 1 through
    ``set_up_and_run_experiments`` on the baselines phase's fold: host
    work only (counts at 0 just before, read just after: 0 and 0); the
    averaged lagged graph read out and scored against the 5 true graphs."""
    import numpy as np

    from redcliff_tpu_torch.eval.cross_alg import evaluate_algorithm_on_fold
    from redcliff_tpu_torch.eval.gc_estimates import get_model_gc_estimates
    from redcliff_tpu_torch.eval.model_io import load_model_for_eval
    from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
    from redcliff_tpu_torch.utils.config import load_true_gc_factors

    root = os.path.join(HERE, "build", "chip_smoke", "dynotears")
    shutil.rmtree(root, ignore_errors=True)
    data_args, _ = _write_fold(np, root, BASELINE_DATA, BASELINE_T)
    margs = os.path.join(root, f"{DYNOTEARS_MODEL}_d4IC_BCNIBCHVgs1Parsim_"
                               f"cached_args.txt")
    with open(margs, "w") as f:
        json.dump(DYNOTEARS_ARGS, f)
    runs = os.path.join(root, "runs")
    os.makedirs(runs)
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    task = set_up_and_run_experiments(
        {"save_root_path": runs}, [margs], [data_args], [DYNOTEARS_MODEL],
        [BASELINE_DATA], task_id=1)
    wall_s = time.perf_counter() - t0
    mix, prox = FM.factor_mix.launches, PX.gl_prox.launches
    _require(task == 1 and len(os.listdir(runs)) == 1,
             f"dynotears: runs {os.listdir(runs)}")
    _require(mix == 0 and prox == 0,
             f"dynotears: {mix} factor_mix / {prox} gl_prox launches")
    run_dir = os.path.join(runs, os.listdir(runs)[0])
    model, params = load_model_for_eval(run_dir)
    ests = get_model_gc_estimates(model, params, DYNOTEARS_MODEL, K_TRAIN)
    _require(params is None and len(ests) == K_TRAIN
             and all(e.shape == (C_TRAIN, C_TRAIN)
                     and bool(np.isfinite(e).all()) for e in ests),
             f"dynotears: GC estimates {[e.shape for e in ests]}")
    stats = evaluate_algorithm_on_fold(run_dir, DYNOTEARS_MODEL,
                                       load_true_gc_factors(data_args))
    _emit({"phase": "dynotears", "model": type(model).__name__,
           "config": "published DYNOTEARS_Vanilla cached-args "
                     "(experiments/accuracy_parity_synsys.py:101-106)",
           "reduced": {}, "run_dir": os.path.relpath(run_dir, HERE),
           "recordings": N_TRAIN, "recording_steps": BASELINE_T,
           "wall_s_host": wall_s, "ms_per_recording": wall_s * 1e3 / N_TRAIN,
           "gc_abs_sum": float(np.abs(ests[0]).sum()),
           "f1_across_factors": {
               p: {k: v for k, v in s.items() if k.endswith("mean_across_"
                                                             "factors")}
               for p, s in stats.items() if not p.startswith("factor_")},
           "factor_mix_launches": mix, "gl_prox_launches": prox})
    return mix, prox


def _gen_system(size):
    """A size's graphs from the host factory with the curation's
    coefficients, and its base parameters."""
    from redcliff_tpu_torch.data import synthetic as S

    c = GEN_SIZES[size]
    p = S.reference_curation_params(c["nodes"])
    graphs, acts, _ = S.generate_lagged_adjacency_graphs_for_factor_model(
        num_nodes=c["nodes"], num_lags=2, num_factors=c["factors"],
        make_factors_orthogonal=c["orthogonal"],
        make_factors_singular_components=False, rand_seed=c["seed"],
        off_diag_edge_strengths=p["off_diag_edge_strengths"],
        diag_receiving_node_forgetting_coeffs=
            p["diag_receiving_node_forgetting_coeffs"],
        diag_sending_node_forgetting_coeffs=
            p["diag_sending_node_forgetting_coeffs"],
        num_edges_per_graph=c["edges"])
    return c, p, graphs, acts


def phase_data_gen(torch, FM, PX):
    """The device generator (``generate_synthetic_dataset``) on the card at
    both sizes: wall ms of the first call and the mean of
    ``GEN_TIMED_RUNS`` more (host clock around a synchronized call, the
    numpy copy included), recordings/s, and the device's busy and idle
    share (``torch.profiler`` device time of one call over the unprofiled
    mean wall). Checks shapes, dtypes, finite values and labels. Launches
    neither kernel (counts at 0 before the timed calls, read after)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from redcliff_tpu_torch.data import synthetic as S

    out = {}
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    for size in GEN_SIZES:
        c, p, graphs, acts = _gen_system(size)

        def gen(seed):
            return S.generate_synthetic_dataset(
                torch.Generator(device="cuda").manual_seed(seed), graphs,
                acts, p["base_freqs"], p["noise_mu"], p["noise_var"],
                p["innovation_amp"], num_samples=c["n"],
                recording_length=c["T"], burnin_period=c["burnin"],
                num_labeled_sys_states=c["factors"], label_type=c["label"],
                noise_type=c["noise"], noise_amp=c["noise_amp"])

        t0 = time.perf_counter()
        X, Y = gen(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        walls = []
        for seed in range(1, GEN_TIMED_RUNS + 1):
            t0 = time.perf_counter()
            gen(seed)
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = sum(walls) / len(walls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            gen(0)
            torch.cuda.synchronize()
        device_us = _device_us(torch, prof, 1)[1]
        _require(X.shape == (c["n"], c["T"], c["nodes"])
                 and Y.shape == (c["n"], c["factors"], c["T"])
                 and X.dtype == np.float32 and Y.dtype == np.float32
                 and bool(np.isfinite(X).all()),
                 f"data_gen {size}: X {X.shape} {X.dtype}, Y {Y.shape}")
        if c["label"] == "OneHot":
            _require(bool(np.all(Y.sum(axis=1) == 1.0)),
                     f"data_gen {size}: labels not one-hot")
        else:
            _require(float(Y.min()) >= 0.0 and float(Y.max()) <= 1.0 + 1e-6,
                     f"data_gen {size}: Oracle labels outside [0, 1]")
        out[size] = {"recordings": c["n"], "T": c["T"],
                     "burnin": c["burnin"], "states": c["factors"],
                     "nodes": c["nodes"], "label": c["label"],
                     "noise": c["noise"], "first_call_ms": first_ms,
                     "wall_ms": wall_ms, "wall_ms_runs": walls,
                     "recordings_per_s": c["n"] / wall_ms * 1e3,
                     "device_busy_us": device_us,
                     "device_busy_share": device_us / (wall_ms * 1e3),
                     "device_idle_share": 1.0 - device_us / (wall_ms * 1e3),
                     "abs_max": float(np.abs(X).max())}
    mix, prox = FM.factor_mix.launches, PX.gl_prox.launches
    _require(mix == 0 and prox == 0,
             f"data_gen: {mix} factor_mix / {prox} gl_prox launches")
    _emit({"phase": "data_gen", "device": torch.cuda.get_device_name(0),
           "config": "synSys 6-2-2 curation size "
                     "(experiments/accuracy_parity_synsys.py:195-196,"
                     "239-247) and one D4IC network "
                     "(experiments/accuracy_parity_d4ic.py:193-210,233)",
           "reduced": {}, "sizes": out,
           "factor_mix_launches": mix, "gl_prox_launches": prox})
    return mix, prox


def phase_data_gen_check(torch):
    """The generator's body card vs CPU at both sizes: the unit draws made
    on the card (``draw_synthetic_noise``) and copied to the CPU, then
    ``synthetic_batch_body`` on each. Per recording max |dX| within
    ``GEN_BODY_REL`` of the CPU's largest amplitude; Oracle labels within
    ``GEN_LABEL_ATOL``; OneHot labels equal but where the two largest
    ramps lie within ``GEN_LABEL_ATOL`` (counted). The body sums and
    divides in the same order on both devices, so bitwise equality is
    expected; ``bitwise`` says whether it held."""
    import numpy as np

    from redcliff_tpu_torch.data import synthetic as S

    out = {}
    for size in GEN_SIZES:
        c, p, graphs, acts = _gen_system(size)
        gen = torch.Generator(device="cuda").manual_seed(7)
        draws = S.draw_synthetic_noise(gen, c["n"], c["factors"], c["T"],
                                       c["burnin"], c["nodes"],
                                       noise_type=c["noise"], device="cuda")
        res = {}
        for dev, label in (("cuda", c["label"]), ("cpu", c["label"]),
                           ("cpu_oracle", "Oracle")):
            d = dev.split("_")[0]
            M1, M2, codes, base = S.stack_systems(
                graphs, acts, p["base_freqs"], p["noise_mu"],
                p["noise_var"], p["innovation_amp"], device=d)
            with torch.no_grad():
                X, Y = S.synthetic_batch_body(
                    M1, M2, codes, base,
                    {k: v.to(d) for k, v in draws.items()}, c["T"],
                    c["burnin"], c["factors"], label_type=label,
                    noise_type=c["noise"], noise_amp=c["noise_amp"])
            res[dev] = (X.cpu().numpy(), Y.cpu().numpy())
        (gX, gY), (cX, cY) = res["cuda"], res["cpu"]
        rel = np.abs(gX - cX).max(axis=(1, 2)) / np.abs(cX).max(axis=(1, 2))
        oracle = np.sort(res["cpu_oracle"][1], axis=1)
        ties = (np.zeros(oracle[:, 0].shape, bool) if oracle.shape[1] == 1
                else oracle[:, -1] - oracle[:, -2] <= GEN_LABEL_ATOL)
        label_err = float(np.abs(gY - cY).max())
        flips = (int(np.any(gY != cY, axis=1)[~ties].sum())
                 if c["label"] == "OneHot" else None)
        _require(float(rel.max()) <= GEN_BODY_REL,
                 f"data_gen_check {size}: body card vs CPU rel err "
                 f"{float(rel.max())} > {GEN_BODY_REL}")
        if c["label"] == "Oracle":
            _require(label_err <= GEN_LABEL_ATOL,
                     f"data_gen_check {size}: labels {label_err}")
        else:
            _require(flips == 0, f"data_gen_check {size}: {flips} one-hot "
                                 f"labels differ off the ties")
        out[size] = {"bitwise": bool(np.array_equal(gX, cX)
                                     and np.array_equal(gY, cY)),
                     "max_rel_err": float(rel.max()),
                     "max_abs_err": float(np.abs(gX - cX).max()),
                     "label_max_abs_err": label_err,
                     "onehot_ties_excluded": int(ties.sum()),
                     "label_flips": flips}
    _emit({"phase": "data_gen_check",
           "against": "port CPU body, the card's draws",
           "rel_tol": GEN_BODY_REL, "label_atol": GEN_LABEL_ATOL,
           "sizes": out})


def _flow_runs(roots_dir):
    """Each algorithm's run dirs under a twin's runs root:
    {alias: [run_dir, ...]}."""
    out = {}
    for d in sorted(os.listdir(roots_dir)):
        alias = d[:-len("_models")]
        root = os.path.join(roots_dir, d)
        out[alias] = [os.path.join(root, r) for r in sorted(os.listdir(root))]
    return out


def _flow_checks(name, out, runs, n_train, n_val, batch, dynamic_folds):
    """The checks both flows share: every algorithm's runs load back
    through ``load_artifact`` with finite params, every F1 is finite; the
    factor-mix executions each REDCLIFF run's fit makes (its forwards, from
    its meta data) plus one ``graph_mix`` per dynamic-readout recording.
    Returns the expected factor-mix executions."""
    import math

    import numpy as np

    from redcliff_tpu_torch.eval.model_io import load_artifact
    from redcliff_tpu_torch.interop import tree_leaves
    from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint

    _require(set(out["algorithms"]) == set(runs),
             f"{name}: algorithms {sorted(out['algorithms'])} vs runs "
             f"{sorted(runs)}")
    forwards = 0
    for alias, run_dirs in runs.items():
        stats = out["algorithms"][alias]
        _require(math.isfinite(stats["offdiag_optimal_f1_mean"]),
                 f"{name}: {alias} F1 {stats}")
        for run_dir in run_dirs:
            payload = load_artifact(run_dir)
            leaves = ([] if payload.get("params") is None
                      else tree_leaves(payload["params"]))
            _require(all(bool(np.isfinite(np.asarray(x)).all())
                         for x in leaves),
                     f"{name}: non-finite params in {run_dir}")
            if payload["model_class"] == "RedcliffSCMLP":
                meta = read_checkpoint(os.path.join(
                    run_dir, "training_meta_data_and_hyper_parameters.pkl"))
                forwards += _redcliff_forwards(
                    payload["config"], meta["epoch"] + 1,
                    -(-n_train // batch), -(-n_val // batch))
                forwards += ACC_DYNAMIC_RECORDINGS * dynamic_folds
    return forwards


def phase_accuracy_synsys(torch, FM, PX):
    """The synSys twin's ``main`` with the JAX script's ``--smoke`` on the
    card (``ACC_SYNSYS_ARGV``): curation, the five array tasks, the
    cross-algorithm battery and the dynamic readouts. Counts at 0 just
    before, read just after. Returns them, the work dir, the twin's JSON
    and its run dirs (the analysis phase reads them)."""
    from redcliff_tpu_torch.experiments import accuracy_parity_synsys as A

    wd = os.path.join(HERE, "build", "chip_smoke", "accuracy_synsys")
    shutil.rmtree(wd, ignore_errors=True)
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    out = A.main([wd] + ACC_SYNSYS_ARGV)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    mix, prox = FM.factor_mix.launches, PX.gl_prox.launches
    n_train, n_val = A.SAMPLES[True]
    runs = _flow_runs(os.path.join(wd, "runs"))
    expected = _flow_checks("accuracy_synsys", out, runs, n_train,
                            n_val, int(A.REDCLIFF_ARGS["batch_size"]),
                            dynamic_folds=out["folds"])
    _require(mix == expected and prox == 0,
             f"accuracy_synsys: {mix} factor_mix executions for {expected} "
             f"REDCLIFF forwards + graph_mix readouts, {prox} gl_prox")
    _require(os.path.isfile(os.path.join(wd, "ACCURACY_SYNSYS_smoke.json")),
             "accuracy_synsys: no JSON in the work dir")
    _emit({"phase": "accuracy_synsys",
           "device": torch.cuda.get_device_name(0),
           "config": "experiments/accuracy_parity_synsys.py --smoke "
                     "(its own smoke cuts), through the port twin",
           "argv": ACC_SYNSYS_ARGV, "reduced": {"folds": "3 -> 1"},
           "train_recordings": n_train, "val_recordings": n_val,
           "wall_s": wall_s, "walls": out["wall_s"],
           "algorithms": out["algorithms"],
           "dynamic_redcliff": out["dynamic_readouts"]["REDCLIFF_S_CMLP"],
           "factor_mix_launches": mix, "expected_factor_mix": expected,
           "gl_prox_launches": prox})
    return mix, prox, wd, out, runs


def phase_accuracy_d4ic(torch, FM, PX):
    """The D4IC twin's ``main`` with the JAX script's ``--smoke`` on the
    card (``ACC_D4IC_ARGV``): five networks' recordings from the device
    generator, the D4IC mixture, the six array tasks and the battery.
    Counts at 0 just before, read just after."""
    from redcliff_tpu_torch.experiments import accuracy_parity_d4ic as A

    wd = os.path.join(HERE, "build", "chip_smoke", "accuracy_d4ic")
    shutil.rmtree(wd + "_smoke", ignore_errors=True)
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    out = A.main([wd] + ACC_D4IC_ARGV)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    mix, prox = FM.factor_mix.launches, PX.gl_prox.launches
    n_train, n_val = (k * A.NUM_NETWORKS for k in A.SAMPLES[True])
    runs = _flow_runs(os.path.join(wd + "_smoke", "runs_HSNR"))
    expected = _flow_checks("accuracy_d4ic", out, runs, n_train,
                            n_val, int(A.REDCLIFF_ARGS["batch_size"]),
                            dynamic_folds=0)
    _require(mix == expected and prox == 0,
             f"accuracy_d4ic: {mix} factor_mix executions for {expected} "
             f"REDCLIFF forwards, {prox} gl_prox")
    _require(os.path.isfile(os.path.join(
        wd + "_smoke", "ACCURACY_D4IC_HSNR_smoke.json")),
        "accuracy_d4ic: no JSON in the work dir")
    _emit({"phase": "accuracy_d4ic", "device": torch.cuda.get_device_name(0),
           "config": "experiments/accuracy_parity_d4ic.py --smoke --algs "
                     "core (its own smoke cuts), through the port twin",
           "argv": ACC_D4IC_ARGV, "reduced": {"folds": "3 -> 1"},
           "train_recordings": n_train, "val_recordings": n_val,
           "wall_s": wall_s, "walls": out["wall_s"],
           "algorithms": out["algorithms"],
           "factor_mix_launches": mix, "expected_factor_mix": expected,
           "gl_prox_launches": prox})
    return mix, prox


def phase_discovery(torch, FM, PX):
    """The Table-2 discovery flow on the host. One synSys 6-2-2 fold is
    curated at the study's size with the port's data layer, and its
    held-out split (240 recordings of (100, 6), two states, OneHot) goes
    through ``run_supervised_discovery_evaluation`` over
    ``DISCOVERY_ALGS`` against the fold's true factor graphs. Before the
    flow, SELVAR's native core is called with ``backend="native"`` (a
    failed build raises) and held to the numpy core on the first regime's
    masked series, so the flow's ``"auto"`` runs the native core. Then
    ``run_d4ic_regime_pcmci_experiment`` on one D4IC network's recordings
    from the device generator. Prints the wall per algorithm and, per
    regime factor, the optimal F1 and ROC-AUC. Launches neither kernel.
    Returns the launch counts and the fold's training windows and labels
    (the ts_transformer phase's data)."""
    import importlib
    import importlib.util

    import numpy as np

    from redcliff_tpu_torch.data import synthetic as S
    from redcliff_tpu_torch.data.curation import curate_synthetic_fold
    from redcliff_tpu_torch.data.shards import load_normalized_samples
    from redcliff_tpu_torch.eval import supervised_discovery as SD
    from redcliff_tpu_torch.utils.config import load_true_gc_factors

    sel = importlib.import_module("redcliff_tpu_torch.tidybench.selvar")
    wd = os.path.join(HERE, "build", "chip_smoke", "discovery")
    shutil.rmtree(wd, ignore_errors=True)
    t0 = time.perf_counter()
    fold_dir, _ = curate_synthetic_fold(
        os.path.join(wd, "data"), fold_id=DISCOVERY_FOLD, num_nodes=6,
        num_lags=2, num_factors=2, num_supervised_factors=2,
        num_edges_per_graph=2, num_samples_in_train_set=1040,
        num_samples_in_val_set=240, sample_recording_len=100,
        burnin_period=50, label_type_setting="OneHot",
        noise_type="gaussian", noise_level=1.0, folder_name="synSys6_2_2")
    curate_s = time.perf_counter() - t0
    truth = load_true_gc_factors(os.path.join(
        fold_dir, f"data_fold{DISCOVERY_FOLD}_cached_args.txt"))
    held_out = load_normalized_samples(os.path.join(fold_dir, "validation"))
    samples = list(zip(held_out.X, held_out.Y))
    _require(len(samples) == 240 and held_out.X.shape[1:] == (100, 6),
             f"discovery: held-out split {held_out.X.shape}")

    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    # the native SELVAR core against the numpy core on the same input,
    # first: backend="native" raises when the C++ core cannot be built, so a
    # failed build fails the phase before the flow (whose "auto" would fall
    # back to numpy) runs
    data, _, masks = SD.prepare_data_for_modeling(samples)[:3]
    x0 = data * masks[0]
    t0 = time.perf_counter()
    Bn, An, _ = sel.slvar(x0, maxlags=1, backend="native")
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Bp, Ap, _ = sel.slvar(x0, maxlags=1, backend="numpy")
    numpy_s = time.perf_counter() - t0
    selvar_err = float(np.abs(Bn - Bp).max())
    _require(np.array_equal(An, Ap) and np.allclose(
        Bn, Bp, rtol=SELVAR_RTOL, atol=SELVAR_ATOL),
        f"discovery: native SELVAR vs numpy: lags equal "
        f"{np.array_equal(An, Ap)}, max abs diff {selvar_err}")
    results, walls = {}, {}
    for alg in DISCOVERY_ALGS:
        t0 = time.perf_counter()
        results[alg] = SD.run_supervised_discovery_evaluation(
            samples, truth, algorithms=(alg,))[alg]
        walls[alg] = time.perf_counter() - t0
    scores = {}
    for alg, res in results.items():
        _require(len(res["preds"]) == 2 and all(
            p.shape == (6, 6) and bool(np.isfinite(p).all())
            for p in res["preds"]), f"discovery: {alg} predictions")
        scores[alg] = {rf: {"optF1": st["optF1_score"],
                            "roc_auc": st["roc_auc"]}
                       for rf, st in res["stats"].items()}
        _require(all(0.0 <= v["optF1"] <= 1.0 for v in scores[alg].values()),
                 f"discovery: {alg} F1s {scores[alg]}")

    # one D4IC network's recordings from the device generator
    c, p, graphs, acts = _gen_system("d4ic_network")
    X, Y = S.generate_synthetic_dataset(
        torch.Generator(device="cuda").manual_seed(0), graphs, acts,
        p["base_freqs"], p["noise_mu"], p["noise_var"], p["innovation_amp"],
        num_samples=c["n"], recording_length=c["T"],
        burnin_period=c["burnin"], num_labeled_sys_states=c["factors"],
        label_type=c["label"], noise_type=c["noise"],
        noise_amp=c["noise_amp"])
    t0 = time.perf_counter()
    out = SD.run_d4ic_regime_pcmci_experiment(
        list(zip(X, Y)), graphs, regime_source="oracle", pred_source="graph")
    d4ic = {"wall_s_host": time.perf_counter() - t0,
            "recordings": int(X.shape[0]), "T": int(X.shape[1]),
            "optF1_by_regime": out["optF1Scores_by_regime"],
            "mean": out["cross_regime_mean"]}
    _require(0.0 <= out["cross_regime_mean"] <= 1.0,
             f"discovery: D4IC regime PCMCI {d4ic}")
    mix, prox = FM.factor_mix.launches, PX.gl_prox.launches
    _require(mix == 0 and prox == 0,
             f"discovery: {mix} factor_mix / {prox} gl_prox launches")
    lasar = ("left out: scikit-learn is not installed on this machine"
             if importlib.util.find_spec("sklearn") is None else
             "left out (scikit-learn is installed here; the smoke keeps "
             "the card machine's algorithm set)")
    _emit({"phase": "discovery", "device": torch.cuda.get_device_name(0),
           "config": "synSys 6-2-2 fold 0, held-out split "
                     "(experiments/accuracy_parity_synsys.py:195-196,"
                     "239-247); one D4IC network "
                     "(experiments/accuracy_parity_d4ic.py:193-210,233)",
           "reduced": {"folds": "3 -> 1", "split": "held-out only"},
           "recordings": len(samples), "curate_s_host": curate_s,
           "algorithms": list(DISCOVERY_ALGS), "lasar": lasar,
           "selvar_core": "native (built and held to numpy "
                          "before the flow)", "wall_s_host": walls,
           "scores_by_regime_factor": scores,
           "selvar_native_vs_numpy": {
               "max_abs_diff": selvar_err, "rtol": SELVAR_RTOL,
               "atol": SELVAR_ATOL, "native_s": native_s,
               "numpy_s": numpy_s},
           "d4ic_network_regime_pcmci": d4ic,
           "factor_mix_launches": mix, "gl_prox_launches": prox})
    n = TST_BATCH
    train = load_normalized_samples(os.path.join(fold_dir, "train"))
    labels = train.Y[:n].mean(axis=2).argmax(axis=1)
    return mix, prox, train.X[:n], labels


def phase_analysis(torch, FM, PX, synsys_wd, synsys_out, synsys_runs):
    """The analysis layer on the host over the ``evals/`` tree that the
    accuracy_synsys phase wrote: ``run_cross_experiment_analysis`` (no
    figures: ``plot=False``), ``summarize_off_diag_f1``,
    ``write_cross_experiment_report`` and ``factor_selection_table`` over
    that phase's REDCLIFF-S run directories. Checks that the condensed
    off-diagonal F1 means equal the twin's own JSON, and that no figure
    is written (matplotlib is absent on the card's machine, and the
    analysis draws nothing without it). Launches neither kernel."""
    import importlib.util

    from redcliff_tpu_torch.eval import analysis as AN
    from redcliff_tpu_torch.eval import summaries as SM

    evals = os.path.join(synsys_wd, "evals")
    save = os.path.join(HERE, "build", "chip_smoke", "analysis")
    shutil.rmtree(save, ignore_errors=True)
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    cross = AN.run_cross_experiment_analysis(evals, save, plot=False)
    merged = {k: e["cv_stats"] for k, e in cross["condensed"].items()}
    table = SM.summarize_off_diag_f1(merged)
    SM.write_cross_experiment_report(merged, save, plot=False)
    selection = AN.factor_selection_table(
        {2: synsys_runs["REDCLIFF_S_CMLP"]})
    wall_s = time.perf_counter() - t0
    mix, prox = FM.factor_mix.launches, PX.gl_prox.launches
    (sys_key,) = cross["condensed"]
    condensed = cross["condensed"][sys_key]["alg_stats"]
    for alg, stats in synsys_out["algorithms"].items():
        want = stats["offdiag_optimal_f1_mean"]
        _require(condensed[alg]["mean"] == want
                 and table["mean"][sys_key][alg] == want,
                 f"analysis: {alg} condensed F1 {condensed[alg]['mean']} / "
                 f"table {table['mean'][sys_key][alg]} vs the twin's {want}")
    figures = [f for _, _, files in os.walk(save) for f in files
               if f.endswith(".png")]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    _require(not figures, f"analysis: figures written {figures}")
    _require(bool(selection[2]), "analysis: empty factor-selection table")
    _require(mix == 0 and prox == 0,
             f"analysis: {mix} factor_mix / {prox} gl_prox launches")
    _emit({"phase": "analysis", "device": torch.cuda.get_device_name(0),
           "config": "the accuracy_synsys phase's evals/ tree "
                     f"({sys_key})", "reduced": {},
           "wall_s_host": wall_s, "system_details": cross["system_details"],
           "off_diag_f1_mean": table["mean"][sys_key],
           "matches_twin_json": True,
           "factor_selection": selection, "matplotlib": has_mpl,
           "figures": len(figures),
           "factor_mix_launches": mix, "gl_prox_launches": prox})
    return mix, prox


def _tst_steps(torch, model, params, X, y, steps):
    """``steps`` Adam steps of the classifier loss on one batch from
    ``params`` (copied); the loss history."""
    from redcliff_tpu_torch.interop import tree_leaves, tree_map

    live = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                    params)
    opt = torch.optim.Adam(tree_leaves(live), lr=TST_LR)
    hist = []
    for _ in range(steps):
        loss, _ = model.loss(live, X, y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        hist.append(loss.item())
    return hist


def phase_ts_transformer(torch, FM, PX, X_np, y_np, smi):
    """The time-series transformer at mvts_transformer's published
    defaults (``TST_CONFIG``) on 128 synSys windows (T 100, 6 features):
    the encoder and the 2-class classiregressor, params from a seeded
    generator on the CPU and copied to the card (TF32 off through
    ``utils/precision.py``). Forwards card vs CPU at the f32 bars with
    BatchNorm and LayerNorm, with and without a padding mask; 20 Adam
    steps of the classifier loss on each, the loss histories at the
    trainer bars. Prints ms per forward and per step (CUDA events), the
    peak device memory, and the card's name and power limit. Launches
    neither kernel."""
    import numpy as np

    from redcliff_tpu_torch.interop import tree_map
    from redcliff_tpu_torch.models import ts_transformer as TT
    from redcliff_tpu_torch.utils.precision import resolve_device

    dev = resolve_device("cuda")
    _require(not torch.backends.cuda.matmul.allow_tf32
             and not torch.backends.cudnn.allow_tf32,
             "ts_transformer: TF32 is on")
    Xc = torch.from_numpy(np.ascontiguousarray(X_np, dtype=np.float32))
    yc = torch.from_numpy(np.asarray(y_np, dtype=np.int64))
    mask_c = torch.ones(Xc.shape[:2], dtype=torch.bool)
    mask_c[::2, -20:] = False
    Xd, yd, mask_d = Xc.to(dev), yc.to(dev), mask_c.to(dev)
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    errs, times = {}, {}
    for norm in ("BatchNorm", "LayerNorm"):
        models = {
            "encoder": TT.TSTransformerEncoder(TT.TSTransformerConfig(
                **dict(TST_CONFIG, norm=norm))),
            "classifier": TT.TSTransformerEncoderClassiregressor(
                TT.TSTransformerConfig(**dict(TST_CONFIG, norm=norm,
                                              num_classes=TST_CLASSES)))}
        gen = torch.Generator().manual_seed(0)
        params = {}
        for name, model in models.items():
            host = model.init(gen, device="cpu")
            card = params[name] = tree_map(lambda t: t.to(dev), host)
            if name == "classifier":
                clf_host = host
            for masked in (False, True):
                with torch.no_grad():
                    got = model.forward(card, Xd, mask_d if masked else None)
                    want = model.forward(host, Xc,
                                         mask_c if masked else None)
                _check_close(torch, f"{name}/{norm}/"
                             f"{'mask' if masked else 'no mask'}",
                             got.cpu(), want, errs)
        if norm != TST_CONFIG["norm"]:
            continue
        # the published model on the card: ms per forward and per step
        enc, clf = models["encoder"], models["classifier"]
        with torch.no_grad():
            times["encoder_forward_ms"] = _time_ms(
                torch, lambda: enc.forward(params["encoder"], Xd), TST_TIMED,
                5)
            times["classifier_forward_ms"] = _time_ms(
                torch, lambda: clf.forward(params["classifier"], Xd),
                TST_TIMED, 5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        card_hist = _tst_steps(torch, clf, params["classifier"], Xd, yd,
                               TST_STEPS)
        end.record()
        torch.cuda.synchronize()
        times["step_ms"] = start.elapsed_time(end) / TST_STEPS
        times["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        cpu_hist = _tst_steps(torch, clf, clf_host, Xc, yc, TST_STEPS)
        hist_err = float(np.max(np.abs(np.subtract(card_hist, cpu_hist))))
        _require(np.allclose(card_hist, cpu_hist, **TST_HIST)
                 and bool(np.isfinite(card_hist).all()),
                 f"ts_transformer: {TST_STEPS} steps card vs CPU, max "
                 f"|dloss| {hist_err}: {card_hist} vs {cpu_hist}")
    mix, prox = FM.factor_mix.launches, PX.gl_prox.launches
    _require(mix == 0 and prox == 0,
             f"ts_transformer: {mix} factor_mix / {prox} gl_prox launches")
    _emit({"phase": "ts_transformer", "device": torch.cuda.get_device_name(0),
           "card": smi,
           "config": "mvts_transformer defaults (src/options.py, Zerveas "
                     "et al. KDD 2021): " + json.dumps(TST_CONFIG),
           "reduced": {}, "batch": TST_BATCH, "classes": TST_CLASSES,
           "data": "synSys 6-2-2 fold 0 training windows (the discovery "
                   "phase's fold)",
           "rtol": RTOL, "atol": ATOL, "max_abs_err": errs,
           "steps": TST_STEPS, "lr": TST_LR, "loss_card": card_hist,
           "loss_cpu": cpu_hist, "loss_max_abs_diff": hist_err,
           "hist_bars": TST_HIST, **times,
           "factor_mix_launches": mix, "gl_prox_launches": prox})
    return mix, prox


def phase_profile_dcsfa(torch, model, X, y, host_p, host_s):
    """Where a DCSFA joint step's time goes (``--profile`` only): a
    profiled window of joint steps at the published widths on the card —
    host wall per step, device busy per step, the device's idle share and
    the top device ops."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.models.dcsfa_nmf import _live
    from redcliff_tpu_torch.utils.precision import resolve_device

    dev = resolve_device("cuda")
    live = _live(interop.params_from_jax(host_p, dev))
    state = interop.params_from_jax(host_s, dev)
    phase = model.make_phase(live, pretrain=False)
    B, n_warm, n = int(DCSFA_ARGS["batch_size"]), 2, 10
    rng = np.random.default_rng(3)
    ones = torch.ones((B, 1), device=dev)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    batches = []
    for _ in range(n):
        idx = torch.from_numpy(rng.choice(len(X), B)).to(dev)
        batches.append((Xd[idx], yd[idx], torch.ones_like(yd[idx]), ones,
                        ones))
    for b in batches[:n_warm]:
        state, _ = model.train_step(live, state, phase, b, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[n_warm:]:
            state, _ = model.train_step(live, state, phase, b, False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (n - n_warm)
    per, busy_us = _device_us(torch, prof, n - n_warm)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    _emit({"phase": "profile_dcsfa", "device": torch.cuda.get_device_name(0),
           "steps": n - n_warm, "batch_size": B, "features": X.shape[1],
           "step_wall_ms_profiled": wall_ms,
           "device_busy_us_per_step": busy_us,
           "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms
                                 if busy_us else None),
           "device_ops_per_step": len(per),
           "top_device_us_per_step": dict(top)})


def _switching_recordings(np, A, n, T, seed):
    """``n`` recordings (x (T, C), y (K, T)) of the state VARs ``A``
    (K, L, C, C), the state switching every EVAL_SWITCH steps in an order
    drawn from ``default_rng(seed)``, a burn-in in the first state, one-hot
    labels per step."""
    rng = np.random.default_rng(seed)
    K, L, C = A.shape[0], A.shape[1], A.shape[2]
    burn = 32
    out = []
    for _ in range(n):
        order = rng.integers(0, K, -(-T // EVAL_SWITCH))
        states = np.repeat(order, EVAL_SWITCH)[:T]
        steps = np.concatenate([np.full(burn, states[0]), states])
        x = rng.normal(size=(burn + T, C))
        for t in range(L, burn + T):
            x[t] += sum(A[steps[t], l] @ x[t - 1 - l] for l in range(L))
        out.append((x[burn:].astype(np.float32),
                    np.eye(K, dtype=np.float32)[states].T))
    return out


def _max_abs_diff(np, a, b):
    """Max abs difference of two trees of numbers and arrays (None where
    the other has None); inf where their structures differ."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return float("inf")
        return max([_max_abs_diff(np, a[k], b[k]) for k in a] or [0.0])
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return float("inf")
        return max([_max_abs_diff(np, x, y) for x, y in zip(a, b)] or [0.0])
    if a is None or b is None:
        return 0.0 if a is b else float("inf")
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.max(d)) if d.size else 0.0


def phase_eval(torch, FM, PX, model, grid_res, task_runs, readout_timing):
    """The evaluation layer on the card: score the grid's 27 points and
    pick the criteria winner and the oracle best, select over the array
    task's run root, read out the array task's model over switching
    recordings (state tracking and the conditional graphs through
    ``graph_mix``), one factor-score estimate and the system-level
    battery; counts at 0 just before, read just after. Then the same
    artifacts through the port's CPU path."""
    import pickle
    import types

    import numpy as np

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.eval import (average_factor_scoring_by_state,
                                         evaluate_algorithm_on_fold,
                                         evaluate_dynamic_readouts_on_fold,
                                         evaluate_fold_system_level,
                                         get_model_gc_estimates,
                                         get_model_gc_score_estimates,
                                         load_model_for_eval,
                                         select_best_models)
    from redcliff_tpu_torch.eval.summaries import OFFDIAG_PARADIGM

    _, raw = _grid_points()
    _, _, graphs = _d4ic_like_data(np, 1, seed=0)
    A = _state_vars(np, np.random.default_rng(0))
    true_gcs = list(graphs)
    root = os.path.join(HERE, "build", "chip_smoke", "eval")
    shutil.rmtree(root, ignore_errors=True)
    # each point's best params as experiments/d4ic_grid_search.py:233-240
    # writes them: a headerless pickle per grid_point<i>/
    point_dirs = []
    for i in range(GRID_LANES):
        d = os.path.join(root, f"grid_point{i}")
        os.makedirs(d)
        with open(os.path.join(d, "final_best_model.bin"), "wb") as f:
            pickle.dump({"model_class": "RedcliffSCMLP",
                         "config": model.config,
                         "params": interop.tree_map(
                             lambda x, i=i: np.asarray(x[i]),
                             grid_res.best_params)}, f)
        point_dirs.append(d)
    task_run = os.path.join(task_runs, os.listdir(task_runs)[0])
    samples = _switching_recordings(np, A, EVAL_RECORDINGS, EVAL_T,
                                    EVAL_ORDER_SEED)
    history = TRAIN_CONFIG["embed_lag"]
    windows = EVAL_T - history
    K = K_TRAIN
    label_ds = types.SimpleNamespace(X=[x for x, _ in samples],
                                     Y=[y for _, y in samples])

    def run(device):
        out, wall = {}, {}
        t0 = time.perf_counter()
        out["points"] = [evaluate_algorithm_on_fold(
            d, ARRAY_TASK_MODEL, true_gcs, device=device)
            for d in point_dirs]
        wall["points_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["dynamic"] = evaluate_dynamic_readouts_on_fold(
            task_run, ARRAY_TASK_MODEL, true_gcs, samples, K,
            max_recordings=EVAL_RECORDINGS, history=history, device=device)
        wall["dynamic_s"] = time.perf_counter() - t0
        tmodel, tparams = load_model_for_eval(task_run, device=device)
        t0 = time.perf_counter()
        out["factor_scores"] = average_factor_scoring_by_state(
            tmodel, tparams, label_ds, K, windows, history)
        wall["factor_scores_s"] = time.perf_counter() - t0
        out["score_estimate"] = get_model_gc_score_estimates(
            tmodel, tparams, ARRAY_TASK_MODEL, K,
            X=samples[0][0][None, :history])
        out["system_level"] = evaluate_fold_system_level(
            get_model_gc_estimates(tmodel, tparams, ARRAY_TASK_MODEL, K),
            true_gcs)
        return out, wall

    # ---- the main path: counts at 0 just before, read just after
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    t0 = time.perf_counter()
    card, card_wall = run(None)
    selection = select_best_models(task_runs)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    mix_launches = FM.factor_mix.launches
    prox_launches = PX.gl_prox.launches

    cpu, cpu_wall = run("cpu")
    # one graph_mix per recording, one forward for the score estimate
    want_mix = EVAL_RECORDINGS + 1
    _require(mix_launches == want_mix and prox_launches == 0,
             f"eval: {mix_launches} factor_mix launches for {want_mix} "
             f"(16 graph_mix + 1 forward), {prox_launches} gl_prox")

    def f1(stats):
        return stats[OFFDIAG_PARADIGM]["f1_mean_across_factors"]

    crit = np.asarray(grid_res.best_criteria, dtype=np.float64)
    card_f1 = [f1(s) for s in card["points"]]
    cpu_f1 = [f1(s) for s in cpu["points"]]
    pick = {"criteria_winner": int(np.argmin(crit)),
            "oracle_best_card": int(np.argmax(card_f1)),
            "oracle_best_cpu": int(np.argmax(cpu_f1))}
    errs = {"points_f1_stats": _max_abs_diff(np, card["points"],
                                             cpu["points"]),
            "points_offdiag_f1": _max_abs_diff(np, card_f1, cpu_f1),
            "dynamic": _max_abs_diff(np, card["dynamic"], cpu["dynamic"]),
            "factor_scores": _max_abs_diff(np, card["factor_scores"],
                                           cpu["factor_scores"]),
            "score_estimate": _max_abs_diff(np, card["score_estimate"],
                                            cpu["score_estimate"]),
            "system_level": _max_abs_diff(np, card["system_level"],
                                          cpu["system_level"])}
    _require(max(errs["points_f1_stats"], errs["points_offdiag_f1"])
             <= EVAL_F1_ATOL,
             f"eval: grid-point optimal-F1 stats card vs CPU {errs}")
    _require(all(errs[k] <= EVAL_DYN_ATOL for k in (
        "dynamic", "factor_scores", "score_estimate", "system_level")),
             f"eval: readouts card vs CPU {errs}")
    _require(pick["oracle_best_card"] == pick["oracle_best_cpu"],
             f"eval: oracle best card vs CPU {pick}")
    _require(all(np.isfinite(card_f1))
             and all(len(v) == EVAL_RECORDINGS
                     for v in card["dynamic"].values()),
             f"eval: F1s {card_f1}, dynamic {card['dynamic']}")
    _require(all(r["ranking"] and r["best_run"] == os.path.basename(task_run)
                 for r in selection.values()),
             f"eval: selection over the array task's runs {selection}")
    n_win = EVAL_RECORDINGS * windows
    f1_top2 = sorted(card_f1, reverse=True)[:2]
    summary = {k: float(np.mean(v)) for k, v in card["dynamic"].items()}
    _emit({"phase": "eval", "device": torch.cuda.get_device_name(0),
           "config": "the grid's 27 best params (grid phase) and the array "
                     "task's model (array_task phase): the published D4IC "
                     "REDCLIFF-S at full width",
           "grid_points": GRID_LANES, "eval_wall_s": eval_s,
           "eval_wall_s_per_grid_point": card_wall["points_s"] / GRID_LANES,
           "cpu_eval_wall_s_per_grid_point": cpu_wall["points_s"]
           / GRID_LANES,
           "optf1_offdiag_by_point": card_f1,
           "criteria_winner": {"point": pick["criteria_winner"],
                               "raw": raw[pick["criteria_winner"]],
                               "optf1": card_f1[pick["criteria_winner"]]},
           "oracle_best": {"point": pick["oracle_best_card"],
                           "raw": raw[pick["oracle_best_card"]],
                           "optf1": card_f1[pick["oracle_best_card"]],
                           # the pick's lead over the runner-up: a near-tie
                           # says the pick carries little
                           "margin_to_second": f1_top2[0] - f1_top2[1]},
           "selection": {c: {"best_run": r["best_run"],
                             "best_epoch": r["best_epoch"]}
                         for c, r in selection.items()},
           "recordings": EVAL_RECORDINGS, "recording_len": EVAL_T,
           "windows_per_recording": windows,
           "dynamic_readout_wall_s": card_wall["dynamic_s"],
           "readout_windows_per_s": n_win / card_wall["dynamic_s"],
           "cpu_readout_windows_per_s": n_win / cpu_wall["dynamic_s"],
           "factor_scoring_wall_s": card_wall["factor_scores_s"],
           "dynamic_means": summary,
           "score_estimate": card["score_estimate"].tolist(),
           "system_level_normal_means": {
               k: float(np.mean(v))
               for k, v in card["system_level"]["normal"].items()},
           "card_vs_cpu_max_abs": errs, "f1_atol": EVAL_F1_ATOL,
           "readout_atol": EVAL_DYN_ATOL,
           "factor_mix_launches": mix_launches,
           "gl_prox_launches": prox_launches,
           "graph_mix_readout_timing": readout_timing})
    return mix_launches, prox_launches


# telemetry: the train phase's model, data, knobs and seed-0 weights through
# the normal entry points with the telemetry spine on. The per-point fit
# profiles its first combined epoch; the grid fits profile a capture epoch
# at width 32 (the factor_pretrain programs are captured in epoch 1), a
# replayed combined epoch (3) at width 32, and one at width 16 (points
# 15-26 evicted by their deadline at epoch 0, as in grid_durable); the
# fault fits poison / skip the middle step of the first combined epoch (40
# at the full size)
TELEMETRY_WINDOW = 2
TELEMETRY_GRID_FITS = (("capture32", 1, None), ("replay32", 3, None),
                       ("replay16", 3, DURABLE_DEADLINES))
# the kernels' names in a torch.profiler trace (the __global__ functions of
# ops/csrc/factor_mix.cu and ops/csrc/gl_prox.cu)
KERNEL_NAMES = {"factor_mix": "factor_mix_kernel",
                "gl_prox": "gl_prox_kernel"}
# the small width of the gpu-marked test's run of the same checks
TELEMETRY_SMALL = dict(gen_hidden=(8,), dgcnn_num_hidden_nodes=16)
TELEMETRY_SMALL_N = (384, 128)


def _trace_kernels(path):
    """Each kernel's executions in a ``torch.profiler`` Chrome trace, and
    its device time by launch configuration ("grid x,y,z block x"): count
    and mean µs."""
    with open(path) as f:
        trace = json.load(f)
    counts = {k: 0 for k in KERNEL_NAMES}
    by_launch = {k: {} for k in KERNEL_NAMES}
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") != "kernel":
            continue
        for k, name in KERNEL_NAMES.items():
            if name in ev.get("name", ""):
                counts[k] += 1
                args = ev.get("args", {})
                key = (f"grid {','.join(map(str, args.get('grid', [])))} "
                       f"block {','.join(map(str, args.get('block', [])))}")
                n, tot = by_launch[k].get(key, (0, 0.0))
                by_launch[k][key] = (n + 1, tot + float(ev.get("dur", 0)))
    return counts, {k: {key: {"n": n, "mean_us": tot / n}
                        for key, (n, tot) in v.items()}
                    for k, v in by_launch.items()}


class _WindowCounters:
    """Wraps ``obs.profiling.window_for`` while a fit runs, so the kernel
    counters are read when its capture starts and when it stops: the
    window's launches on the wrappers' own count."""

    def __init__(self, FM, PX):
        self.FM, self.PX = FM, PX
        self.at = {}

    def _read(self):
        return {"factor_mix": self.FM.factor_mix.launches,
                "gl_prox": self.PX.gl_prox.launches}

    def __enter__(self):
        from redcliff_tpu_torch.obs import profiling

        self._mod, self._real = profiling, profiling.window_for

        def window_for(*a, **kw):
            win = self._real(*a, **kw)
            if not win.enabled:
                return win
            start, end = win.on_epoch_start, win.on_epoch_end

            def on_start(epoch):
                was = win._prof
                start(epoch)
                if was is None and win._prof is not None:
                    self.at["start"] = self._read()

            def on_end(epoch, logger=None):
                was = win._prof
                end(epoch, logger=logger)
                if was is not None and win._prof is None:
                    self.at["stop"] = self._read()
            win.on_epoch_start, win.on_epoch_end = on_start, on_end
            return win
        profiling.window_for = window_for
        return self

    def __exit__(self, *exc):
        self._mod.window_for = self._real
        return False

    def window_launches(self):
        return {k: self.at["stop"][k] - self.at["start"][k]
                for k in KERNEL_NAMES}


class _Env:
    """Set environment variables for a block and restore them after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def _records(run_dir):
    from redcliff_tpu_torch.obs.logging import read_jsonl
    from redcliff_tpu_torch.obs.schema import validate_records

    recs = read_jsonl(run_dir)
    bad = validate_records(recs)
    _require(not bad, f"{run_dir}: records outside the registry: {bad[:3]}")
    return recs


def _profiled(recs, trace_counts, window_counts, what):
    """The fit's one ``profile`` record; its trace's kernel counts must be
    the wrappers' counts over the window. Returns the record and the
    kernels' device time by launch configuration."""
    prof = [r for r in recs if r["event"] == "profile"]
    _require(len(prof) == 1 and os.path.isfile(prof[0]["path"])
             and not prof[0]["truncated"],
             f"{what}: profile events {prof}")
    counts, by_launch = _trace_kernels(prof[0]["path"])
    _require(counts == window_counts,
             f"{what}: trace kernel counts {counts} against the wrappers' "
             f"{window_counts} over the window")
    trace_counts[what] = counts
    return prof[0], by_launch


def telemetry_checks(root, small=False, grid=True):
    """The telemetry phase's fits and checks (``small``: the gpu test's
    width; ``grid=False`` leaves out check 3); returns the phase's
    readings. Raises on a failed check."""
    import numpy as np
    import torch

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.data.datasets import train_val_split
    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)
    from redcliff_tpu_torch.ops import factor_mix as FM
    from redcliff_tpu_torch.ops import pallas_prox as PX
    from redcliff_tpu_torch.parallel.grid import GridSpec, RedcliffGridRunner
    from redcliff_tpu_torch.train.redcliff_trainer import (
        RedcliffTrainConfig, RedcliffTrainer)

    root = str(root)
    shutil.rmtree(root, ignore_errors=True)
    cfg = dict(TRAIN_CONFIG, **(TELEMETRY_SMALL if small else {}))
    n_tr, n_val = TELEMETRY_SMALL_N if small else (N_TRAIN, N_VAL)
    X, Y, graphs = _d4ic_like_data(np, n_tr + n_val, seed=0)
    train_ds, val_ds = train_val_split(X, Y, val_fraction=n_val
                                       / (n_tr + n_val),
                                       rng=np.random.default_rng(1))
    truth = list(graphs)
    model = RedcliffSCMLP(RedcliffSCMLPConfig(**cfg))
    params = model.init(torch.Generator().manual_seed(0))
    out = {"trace_counts": {}, "counter_counts": {}, "launches": {
        "factor_mix": 0, "gl_prox": 0}}
    # the kernel phase held the grid readout's lane form at this batch
    _require(RedcliffTrainConfig(**TRAIN_KNOBS).max_samples_for_gc_tracking
             == QUALITY_READOUT_B, "the quality readout's batch moved")

    def fit(save_dir, **knobs):
        trainer = RedcliffTrainer(model, RedcliffTrainConfig(
            **{**TRAIN_KNOBS, **knobs}))
        t0 = time.perf_counter()
        res = trainer.fit(params, train_ds, val_ds, true_GC=truth,
                          save_dir=save_dir)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # ---- 1. the traced per-point fit: counts at 0 just before, read
    # just after
    run1 = os.path.join(root, "fit")
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    FM.factor_mix.launches = 0
    PX.gl_prox.launches = 0
    with _Env(REDCLIFF_QUALITY="1", REDCLIFF_PROFILE=None), \
            _WindowCounters(FM, PX) as wc:
        on, on_s = fit(run1, profile_window=f"epoch:{TELEMETRY_WINDOW}")
    torch.cuda.synchronize()
    out["launches"]["factor_mix"] += FM.factor_mix.launches
    out["launches"]["gl_prox"] += PX.gl_prox.launches
    out["counter_counts"]["fit"] = wc.window_launches()
    recs = _records(run1)
    epochs = TRAIN_KNOBS["max_iter"]
    want = (["fit_start", "memory"]
            + [e for it in range(epochs) for e in
               (["epoch", "quality"]
                + (["profile"] if it == TELEMETRY_WINDOW else []))]
            + ["memory", "fit_end"])
    # the launch-plan records of the trainer's construction come from the
    # environment's autotune store (none in this script's own run)
    got = [r["event"] for r in recs if r["event"] != "autotune"]
    _require(got == want, f"fit events {got}, expected {want}")
    prof, fit_kernels = _profiled(recs, out["trace_counts"],
                                  out["counter_counts"]["fit"], "fit")
    _require(all(v > 0 for v in out["counter_counts"]["fit"].values()),
             f"the window missed a kernel: {out['counter_counts']}")
    qual = [r for r in recs if r["event"] == "quality"]
    _require(all(q["lanes"] == [0] and q["auroc"][0] is not None
                 for q in qual), "quality records without AUROC")
    pred, meas = [r for r in recs if r["event"] == "memory"]
    _require(pred["kind"] == "predicted" and meas["kind"] == "measured"
             and pred["backend"] == "cuda" and pred["fits"] is True,
             f"memory records {pred} {meas}")
    out["fit"] = {
        "fit_wall_s_on": on_s, "profile_path": os.path.relpath(
            prof["path"], HERE), "profile_dur_ms": prof["dur_ms"],
        "quality_last": {k: qual[-1][k] for k in (
            "edge_energy", "sparsity", "entropy", "auroc", "aupr",
            "jaccard", "topk_hash")},
        "predicted_bytes": pred["predicted_bytes"],
        "measured_peak_bytes": meas["peak_bytes"],
        "phase_start_allocated_bytes": base_alloc,
        "kernels_us_by_launch": fit_kernels,
        "peak_above_start_bytes": meas["peak_bytes"] - base_alloc,
        "bytes_limit": meas["bytes_limit"],
        "device_kind": meas["device_kind"]}

    # ---- 2. the same fit with telemetry off: the same params, bitwise
    with _Env(REDCLIFF_QUALITY="0", REDCLIFF_PROFILE=None):
        off, off_s = fit(None)
    same = all(torch.equal(a, b) for a, b in zip(
        interop.tree_leaves(on.params), interop.tree_leaves(off.params)))
    _require(same and on.best_it == off.best_it,
             "the fit with telemetry off differs from the traced fit")
    out["bitwise_on_off"] = same
    out["fit"]["fit_wall_s_off"] = off_s

    # ---- 3. the published grid (27 lanes, ladder 32, the epoch engine)
    # with a metrics log, the truth and a window over a capture epoch, then
    # over a replayed epoch at width 32 and at width 16
    points, _ = _grid_points()
    grids = {}
    for name, w, deadlines in TELEMETRY_GRID_FITS if grid else ():
        run = os.path.join(root, f"grid_{name}")
        runner = RedcliffGridRunner(model, RedcliffTrainConfig(
            **TRAIN_KNOBS, profile_window=f"epoch:{w}"),
            GridSpec(points=points, fit_deadline_s=deadlines))
        FM.factor_mix.launches = 0
        PX.gl_prox.launches = 0
        t0 = time.perf_counter()
        with _Env(REDCLIFF_QUALITY="1", REDCLIFF_PROFILE=None), \
                _WindowCounters(FM, PX) as gwc:
            res = runner.fit(None, train_ds, val_ds, log_dir=run,
                             init_params=runner.init_grid_from(params),
                             true_gc=truth)
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        out["launches"]["factor_mix"] += FM.factor_mix.launches
        out["launches"]["gl_prox"] += PX.gl_prox.launches
        stats = res.dispatch_stats
        grecs = _records(run)
        start = grecs[0]
        _require(stats["mode"] == "epoch" and start["event"] == "fit_start"
                 and start["grid_width"] == 32,
                 f"grid mode {stats['mode']}, first record {start}")
        counts = gwc.window_launches()
        out["counter_counts"][f"grid_{name}"] = counts
        gprof, by_launch = _profiled(grecs, out["trace_counts"], counts,
                                     f"grid_{name}")
        _require(all(v > 0 for v in counts.values()),
                 f"grid window {name} missed a kernel: {counts}")
        widths = [r["grid_width"] for r in grecs if r["event"] == "epoch"]
        _require(widths[w] == int(name[-2:]),
                 f"grid {name}: widths by epoch {widths}")
        # quality keyed by original point id: all 27 at the first window,
        # then the lanes that still run (filler lanes never appear)
        quals = [r for r in grecs if r["event"] == "quality"]
        live = list(range(GRID_LANES if deadlines is None
                          else DURABLE_LIVE))
        _require(quals and quals[0]["lanes"] == list(range(GRID_LANES))
                 and all(q["lanes"] == live and len(q["auroc"]) == len(live)
                         for q in quals[1:]),
                 f"grid {name}: quality lanes "
                 f"{[q['lanes'] for q in quals]}")
        comp = [r for r in grecs if r["event"] == "compile"]
        _require(sum(c["programs"] for c in comp) == stats["graph_captures"]
                 > 0 and all(c["compile_ms"] > 0 for c in comp),
                 f"compile events {comp} against "
                 f"{stats['graph_captures']} captures")
        cap_epochs = sorted(c["epoch"] for c in comp)
        kind = "capture" if w in cap_epochs else "replay"
        _require(name.startswith(kind),
                 f"grid window {name} is a {kind} epoch (captures at "
                 f"{cap_epochs})")
        gpred = next(r for r in grecs if r["event"] == "memory")
        gmeas = [r for r in grecs if r["event"] == "memory"
                 and r["kind"] == "measured"]
        grids[name] = {
            "window_epoch": w, "fit_wall_s": g_s,
            "widths_by_epoch": widths,
            "compile_events": [(c["epoch"], c["programs"],
                                round(c["compile_ms"], 3)) for c in comp],
            "profile_dur_ms": gprof["dur_ms"],
            "kernels_us_by_launch": by_launch,
            "predicted_bytes": gpred["predicted_bytes"],
            "measured_peak_bytes": max(r["peak_bytes"] for r in gmeas),
            "mean_auroc_last": quals[-1]["mean_auroc"],
            "quality_windows": len(quals)}
    out["grid"] = grids or None

    # ---- 4. nan_batch:K and skip_update:K end bitwise equal
    n_b = -(-len(train_ds) // TRAIN_KNOBS["batch_size"])
    out["fault_step"] = step = 2 * n_b + n_b // 2
    fault = {}
    for spec in ("nan_batch", "skip_update"):
        FM.factor_mix.launches = 0
        PX.gl_prox.launches = 0
        with _Env(REDCLIFF_QUALITY="0", REDCLIFF_PROFILE=None,
                  REDCLIFF_FAULT_INJECT=f"{spec}:{step}"):
            fault[spec], _ = fit(None)
        out["launches"]["factor_mix"] += FM.factor_mix.launches
        out["launches"]["gl_prox"] += PX.gl_prox.launches
    nan_res, skip_res = fault["nan_batch"], fault["skip_update"]
    same = all(torch.equal(a, b) for a, b in zip(
        interop.tree_leaves(nan_res.params),
        interop.tree_leaves(skip_res.params)))
    _require(same and nan_res.numerics["skipped"] == 1
             and skip_res.numerics["skipped"] == 0,
             f"nan_batch vs skip_update: bitwise {same}, skipped "
             f"{nan_res.numerics['skipped']} / "
             f"{skip_res.numerics['skipped']}")
    out["nan_equals_skip"] = same
    return out


def phase_telemetry(torch, smi):
    """The telemetry spine through the normal entry points (see
    :func:`telemetry_checks`); every fit's launches are its path's."""
    root = os.path.join(HERE, "build", "chip_smoke", "telemetry")
    t0 = time.perf_counter()
    out = telemetry_checks(root)
    fit = out["fit"]
    _emit({"phase": "telemetry", "device": torch.cuda.get_device_name(0),
           "card": smi,
           "config": "the train phase's (D4IC REDCLIFF-S, full width) and "
                     "the published D4IC grid (27 lanes, ladder 32)",
           "wall_s": time.perf_counter() - t0,
           "fit_wall_s_telemetry_on": fit["fit_wall_s_on"],
           "fit_wall_s_telemetry_off": fit["fit_wall_s_off"],
           "bitwise_on_off": out["bitwise_on_off"],
           "nan_batch_equals_skip_update": out["nan_equals_skip"],
           "fault_step": out["fault_step"],
           "predicted_bytes": fit["predicted_bytes"],
           "measured_peak_bytes": fit["measured_peak_bytes"],
           "peak_above_phase_start_bytes": fit["peak_above_start_bytes"],
           "phase_start_allocated_bytes": fit["phase_start_allocated_bytes"],
           "bytes_limit": fit["bytes_limit"],
           "profile": fit["profile_path"],
           "profile_dur_ms": fit["profile_dur_ms"],
           "trace_kernel_counts": out["trace_counts"],
           "counter_kernel_counts": out["counter_counts"],
           "quality_last": fit["quality_last"], "grid": out["grid"],
           "factor_mix_launches": out["launches"]["factor_mix"],
           "gl_prox_launches": out["launches"]["gl_prox"]})
    return out["launches"]["factor_mix"], out["launches"]["gl_prox"]


# ---------------------------------------------------------------------------
# runtime: the production runtime (launch-plan autotuner, async checkpoint
# writer, streaming shards and the watchdog, cost model and the predictive
# policy)
# ---------------------------------------------------------------------------
# the launch-plan search: the median of this many CUDA-event-timed launches
# per candidate, after one warm-up launch
RUNTIME_TUNE_REPS = 200
# the grid's lane shapes are tuned at the published grid's ladder width
RUNTIME_LANES = 32
# the in-process watchdog of the shard fit: armed, with budgets no healthy
# component of that fit comes near
RUNTIME_WATCHDOG = "poll_s=0.5,grace_s=30,budget_s=120"
# the hang subprocess: the JAX tests' fault and watchdog policy
RUNTIME_HANG_FAULT = "hang_in:prefetch:60"
RUNTIME_HANG_WATCHDOG = "poll_s=0.5,grace_s=2,budget.prefetch=3"
RUNTIME_HANG_TIMEOUT_S = 180
# the shard fit's validation split streams from this many shard files; its
# training split is one shard, so its batch order equals the ArrayDataset
# fit's (a shuffle permutes the shard order and then each shard)
RUNTIME_VAL_SHARDS = 4


def _train_raw(np):
    """The train phase's raw windows, split as ``_train_data`` splits them
    (``train_val_split``): ``(X_train, Y_train, X_val, Y_val)``."""
    X, Y, _ = _d4ic_like_data(np, N_TRAIN + N_VAL, seed=0)
    idx = np.arange(len(X))
    np.random.default_rng(1).shuffle(idx)
    n_val = int(round(len(X) * N_VAL / (N_TRAIN + N_VAL)))
    return X[idx[n_val:]], Y[idx[n_val:]], X[idx[:n_val]], Y[idx[:n_val]]


def _tune_checks(torch, np, FM, PX, at):
    """Each kernel's ladder searched at the train shapes and the grid's lane
    shapes at width 32 (a fresh store): each candidate's median us, its
    error against the plain version beside the bar, its threads as
    launched (read back from the cached plan); the factor mix bitwise equal
    across tiles; the winner's plan read back after the search."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, K = TRAIN_KNOBS["batch_size"], K_TRAIN
    M = TRAIN_CONFIG["num_sims"] * C_TRAIN
    G = RUNTIME_LANES
    block = (K_TRAIN, C_TRAIN, TRAIN_CONFIG["gen_hidden"][0], C_TRAIN,
             TRAIN_CONFIG["gen_lag"])
    lam, lr = PROX_LAM, TRAIN_KNOBS["gen_lr"]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    w1, p1 = torch.rand((B, K), generator=gen, device="cuda"), rnd(K, B, 1, M)
    wG = torch.rand((G, B, K), generator=gen, device="cuda")
    pG = rnd(G, K, B, 1, M)
    W1, WG = rnd(*block), rnd(G, *block)
    tG = PX.lane_thresholds(torch.full((G,), lr, device="cuda"), lam)
    gate = torch.arange(G, device="cuda") < GRID_LANES  # 27 on, 5 filler

    def prox1():
        W = W1.clone()
        PX.gl_prox_(W, lam, lr)
        return W, PX.launch_plan(W)[2]

    def proxG():
        W = WG.clone()
        PX.gl_prox_lanes_(W, tG, gate)
        return W, PX.launch_plan(W, lanes=True)[2]

    cases = {
        "factor_mix": (
            lambda: at.tune_factor_mix(B, K, M, reps=RUNTIME_TUNE_REPS),
            lambda: (FM.factor_mix(w1, p1), FM.launch_plan(w1, p1)[1]),
            FM.factor_mix_reference(w1, p1)),
        "factor_mix_lanes": (
            lambda: at.tune_factor_mix(B, K, M, lanes=G,
                                       reps=RUNTIME_TUNE_REPS),
            lambda: (FM.factor_mix_lanes(wG, pG),
                     FM.launch_plan(wG, pG)[1]),
            FM.factor_mix_lanes_reference(wG, pG)),
        "gl_prox": (
            lambda: at.tune_gl_prox(block, reps=RUNTIME_TUNE_REPS),
            prox1, PX.gl_prox_reference(W1, lam, lr)),
        "gl_prox_lanes": (
            lambda: at.tune_gl_prox(block, lanes=G, reps=RUNTIME_TUNE_REPS),
            proxG, PX.gl_prox_lanes_reference(WG, tG, gate)),
    }
    out = {}
    for kernel, (tune, run, want) in cases.items():
        winner, rec = tune()
        _require(rec["searched"] and rec["search_steps"] == 3,
                 f"runtime: {kernel} did not search its ladder: {rec}")
        ladder = (at.FACTOR_MIX_THREADS if kernel.startswith("factor_mix")
                  else at.GL_PROX_THREADS)
        errs, outs, launched = {}, {}, {}
        for t in ladder:
            with at.trial(kernel, {"threads": t}):
                got, launched[t] = run()
            _check_close(torch, f"runtime {kernel} threads={t}", got, want,
                         errs)
            outs[t] = got
        _require(all(launched[t] == t for t in ladder),
                 f"runtime: {kernel} launched {launched} threads")
        bitwise = all(torch.equal(outs[ladder[0]], outs[t]) for t in ladder)
        if kernel.startswith("factor_mix"):
            # K is summed in one thread whatever the block size
            _require(bitwise, f"runtime: {kernel} differs across tiles")
        _, winner_plan = run()
        _require(winner_plan == winner,
                 f"runtime: {kernel} launches {winner_plan} threads, the "
                 f"stored winner is {winner}")
        out[kernel] = {
            "candidate_us": {str(t): rec["candidate_us"][t] for t in ladder},
            "winner_threads": winner, "default_threads": rec[
                "default_threads"],
            "speedup_vs_default": rec.get("speedup_vs_default"),
            "search_ms": rec.get("search_ms"),
            "max_abs_err": {str(t): errs[f"runtime {kernel} threads={t}"]
                            for t in ladder},
            "rtol": RTOL, "atol": ATOL,
            "threads_launched": {str(t): launched[t] for t in ladder},
            "winner_threads_launched": winner_plan,
            "bitwise_equal_across_tiles": bool(bitwise)}
    return out


def _grid_equal(np, a, b):
    """Bitwise equality of two GridResults (NaN equal to NaN)."""
    return (all(np.array_equal(x, y, equal_nan=True) for x, y in zip(
        _leaves_np(a.best_params), _leaves_np(b.best_params)))
        and np.array_equal(a.val_history, b.val_history, equal_nan=True)
        and np.array_equal(a.best_criteria, b.best_criteria, equal_nan=True)
        and np.array_equal(a.best_epoch, b.best_epoch)
        and np.array_equal(a.active, b.active) and a.failures == b.failures)


def _ckpt_equal(np, a, b):
    """Equality of two read-back checkpoints: arrays bitwise (NaN equal),
    everything else by ``==``."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_ckpt_equal(np, a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_ckpt_equal(np, x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    return a == b


def runtime_checks(root):
    """The runtime phase's fits and checks; returns its readings (each main
    path's launches under ``"launches"``). Raises on a failed check."""
    import numpy as np
    import torch

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.data.datasets import ArrayDataset
    from redcliff_tpu_torch.data.shards import ShardedBatchDataset
    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)
    from redcliff_tpu_torch.obs import costmodel, flight
    from redcliff_tpu_torch.obs.logging import read_jsonl
    from redcliff_tpu_torch.ops import autotune as at
    from redcliff_tpu_torch.ops import factor_mix as FM
    from redcliff_tpu_torch.ops import pallas_prox as PX
    from redcliff_tpu_torch.parallel.grid import GridSpec, RedcliffGridRunner
    from redcliff_tpu_torch.runtime import checkpoint as ckpt
    from redcliff_tpu_torch.runtime import watchdog
    from redcliff_tpu_torch.train.redcliff_trainer import (
        RedcliffTrainConfig, RedcliffTrainer)

    root = str(root)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {"launches": {"factor_mix": 0, "gl_prox": 0}}

    def count(name, fn):
        """One main path: counts at 0 just before, read just after."""
        FM.factor_mix.launches = 0
        PX.gl_prox.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"factor_mix": FM.factor_mix.launches,
               "gl_prox": PX.gl_prox.launches}
        for k, v in got.items():
            out["launches"][k] += v
        out.setdefault("launches_by_path", {})[name] = got
        return res, got, wall

    model = RedcliffSCMLP(RedcliffSCMLPConfig(**TRAIN_CONFIG))
    params = model.init(torch.Generator().manual_seed(0))
    Xtr, Ytr, Xva, Yva = _train_raw(np)
    B = TRAIN_KNOBS["batch_size"]
    n_tr, n_val = -(-len(Xtr) // B), -(-len(Xva) // B)

    # ---- 1. autotune: the ladders searched into a fresh store, then a
    # trainer constructed on it reuses both winners with 0 search steps
    at.clear_memo()
    at.drain_records()
    out["autotune"] = _tune_checks(torch, np, FM, PX, at)
    at.drain_records()
    tc = RedcliffTrainConfig(**TRAIN_KNOBS)
    trainer = RedcliffTrainer(model, tc)
    recs = at.drain_records()
    _require(sorted(r["kernel"] for r in recs) == ["factor_mix", "gl_prox"]
             and all(r["kind"] == "reuse" and r["search_steps"] == 0
                     for r in recs),
             f"runtime: the second construction searched: {recs}")
    out["second_construction_records"] = recs

    def expected(res):
        ph = [tuple(e["phases"]) for e in res.epochs]
        mix = sum(n_tr * (1 + (p in ("embedder_pretrain", "combined")))
                  for e in ph for p in e) + 2 * n_val * len(ph) + n_val
        prox = sum(n_tr for e in ph for p in e if p != "embedder_pretrain")
        return ph, {"factor_mix": mix, "gl_prox": prox}

    # ---- 3 (its reference first). The per-point fit with the winners on
    # the ArrayDataset of the shard fit's statistics
    split = os.path.join(root, "shards")
    os.makedirs(os.path.join(split, "train"))
    os.makedirs(os.path.join(split, "val"))
    with open(os.path.join(split, "train", "subset_0.pkl"), "wb") as f:
        pickle.dump([[x, y] for x, y in zip(Xtr, Ytr)], f)
    for i, rows in enumerate(np.array_split(np.arange(len(Xva)),
                                            RUNTIME_VAL_SHARDS)):
        with open(os.path.join(split, "val", f"subset_{i}.pkl"), "wb") as f:
            pickle.dump([[Xva[j], Yva[j]] for j in rows], f)
    with _Env(REDCLIFF_WATCHDOG=RUNTIME_WATCHDOG):
        watchdog.REGISTRY.clear()
        sh_train = ShardedBatchDataset(os.path.join(split, "train"))
        sh_val = ShardedBatchDataset(os.path.join(split, "val"))
        arr_train = ArrayDataset(Xtr, Ytr, stats=sh_train.stats)
        arr_val = ArrayDataset(Xva, Yva, stats=sh_val.stats)
        ref, ref_launch, ref_s = count("tuned_fit", lambda: trainer.fit(
            params, arr_train, arr_val, save_dir=os.path.join(root, "arr")))
        _, want = expected(ref)
        _require(all(np.isfinite(v) for v in ref.histories["avg_combo_loss"])
                 and ref.numerics["skipped"] == 0 and ref_launch == want,
                 f"runtime: the tuned fit launched {ref_launch} ({want} "
                 f"expected) or is not finite")
        watchdog.REGISTRY.clear()
        sh, sh_launch, sh_s = count("shard_fit", lambda: RedcliffTrainer(
            model, tc).fit(params, sh_train, sh_val,
                           save_dir=os.path.join(root, "sharded")))
        beats = watchdog.REGISTRY.counts()
    core = {c: sum(n for k, n in beats.items()
                   if k == c or k.endswith(":" + c))
            for c in watchdog.CORE_COMPONENTS}
    _require(all(core.values()), f"runtime: heartbeats {beats}")
    diffs = [float(np.abs(a - b).max()) for a, b in zip(
        _leaves_np(interop.params_to_jax(sh.params)),
        _leaves_np(interop.params_to_jax(ref.params)))]
    loss_diff = float(np.max(np.abs(
        np.asarray(sh.histories["avg_combo_loss"])
        - np.asarray(ref.histories["avg_combo_loss"]))))
    _require(max(diffs) <= TRAIN_PARAM_ATOL and loss_diff <= TRAIN_LOSS_ATOL
             + TRAIN_LOSS_RTOL * max(abs(v) for v in ref.histories[
                 "avg_combo_loss"]) and sh_launch == ref_launch,
             f"runtime: the shard fit is {max(diffs)} / {loss_diff} from the "
             f"ArrayDataset fit, launches {sh_launch} / {ref_launch}")
    out["shards"] = {
        "train_shards": 1, "val_shards": RUNTIME_VAL_SHARDS,
        "fit_wall_s": {"array": ref_s, "sharded": sh_s},
        "heartbeats": core, "max_param_abs_diff": max(diffs),
        "max_val_loss_abs_diff": loss_diff,
        "param_atol": TRAIN_PARAM_ATOL,
        "bitwise_equal": all(d == 0.0 for d in diffs),
        "launches_sharded": sh_launch, "launches_array": ref_launch,
        "eager": True}

    # the armed hang child: exits with the taxonomy's hang code, leaving a
    # hang event and a flight record
    hang_dir = os.path.join(root, "hang")
    os.makedirs(hang_dir)
    env = dict(os.environ, REDCLIFF_FAULT_INJECT=RUNTIME_HANG_FAULT,
               REDCLIFF_WATCHDOG=RUNTIME_HANG_WATCHDOG, PYTHONPATH=HERE)
    # the child's own shapes are neither tuned nor priced here
    for k in ("REDCLIFF_FAULT_MARKER", "REDCLIFF_AUTOTUNE_DIR",
              "REDCLIFF_COST_MODEL_DIR", "REDCLIFF_COMPILE_CACHE"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "redcliff_tpu_torch.runtime.faultinject",
         "--checkpoint-dir", hang_dir, "--sharded", "--device", "cuda"],
        env=env, cwd=HERE, capture_output=True, text=True,
        timeout=RUNTIME_HANG_TIMEOUT_S)
    hang_s = time.perf_counter() - t0
    hang_events = [r for r in read_jsonl(hang_dir)
                   if r["event"] in ("hang", "hang_exit")]
    flight_path = os.path.join(hang_dir, flight.FLIGHT_RECORD_NAME)
    _require(proc.returncode == watchdog.EXIT_HANG
             and watchdog.classify_exit(proc.returncode) == "hang"
             and any(r["event"] == "hang" and "prefetch" in r["components"]
                     for r in hang_events)
             and os.path.exists(flight_path),
             f"runtime: the hang child exited {proc.returncode}, events "
             f"{[r['event'] for r in hang_events]}, flight record "
             f"{os.path.exists(flight_path)}: {proc.stderr[-2000:]}")
    out["hang"] = {"exit_code": proc.returncode,
                   "taxonomy": watchdog.classify_exit(proc.returncode),
                   "wall_s": hang_s, "events": [r["event"]
                                                for r in hang_events],
                   "flight_record": os.path.relpath(flight_path, HERE)}

    # ---- 2. async checkpoints: the durable grid with the writer on and
    # off; the store of step 4 is written by these fits
    points, _ = _grid_points()
    train_ds = ArrayDataset(Xtr, Ytr)
    val_ds = ArrayDataset(Xva, Yva, stats=train_ds.stats)
    spec = GridSpec(points, fit_deadline_s=list(DURABLE_DEADLINES))
    store = costmodel.store_path()

    def grid(ck, max_iter=None, log_dir=None, **knobs):
        runner = RedcliffGridRunner(model, RedcliffTrainConfig(
            **{**TRAIN_KNOBS, **knobs}), spec)
        res = runner.fit(None, train_ds, val_ds, max_iter=max_iter,
                         init_params=runner.init_grid_from(params),
                         copy_init=False, checkpoint_dir=ck,
                         checkpoint_every=1, log_dir=log_dir)
        return runner, res

    # the grid's constructor tunes its lane forms at every ladder width
    # (32 was searched above): the first one searches the rest, before any
    # count is read
    at.drain_records()
    RedcliffGridRunner(model, RedcliffTrainConfig(**TRAIN_KNOBS), spec)
    out["grid_construction_records"] = at.drain_records()
    flight.clear()
    (arun, ares), a_launch, a_s = count("grid_async", lambda: grid(
        os.path.join(root, "async")))
    barrier_spans = [r["dur_ms"] for r in flight.snapshot().get("ckpt", [])
                     if r["name"] == "ckpt.submit_barrier"]
    buckets = (costmodel.load().buckets if store else {})
    widths_in_store = sorted(b["g_bucket"] for b in buckets.values()
                             if b["platform"] == "cuda")
    _require(widths_in_store == [16, 32],
             f"runtime: the store holds widths {widths_in_store}")
    (srun, sres), s_launch, s_s = count("grid_sync", lambda: grid(
        os.path.join(root, "sync"), async_checkpointing=False))
    a_ck = ckpt.read_checkpoint(os.path.join(root, "async",
                                             RedcliffGridRunner.CHECKPOINT_NAME))
    s_ck = ckpt.read_checkpoint(os.path.join(root, "sync",
                                             RedcliffGridRunner.CHECKPOINT_NAME))
    res_eq, ck_eq = _grid_equal(np, ares, sres), _ckpt_equal(np, a_ck, s_ck)
    _require(res_eq and ck_eq and a_launch == s_launch,
             f"runtime: async against sync: results equal {res_eq} (max "
             f"abs diff {_max_abs_diff(np, ares.best_params, sres.best_params)}"
             f"), checkpoints equal {ck_eq}, launches {a_launch} / "
             f"{s_launch}")
    ck = os.path.join(root, "resumed")
    _, _, r1 = count("grid_async_stopped", lambda: grid(
        ck, max_iter=DURABLE_RESUME_AT))
    (rrun, rres), _, r2 = count("grid_async_resumed", lambda: grid(ck))
    same = (np.array_equal(rres.best_epoch, ares.best_epoch)
            and np.array_equal(rres.active, ares.active)
            and rres.failures == ares.failures)
    rel = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
              for a, b in zip(_leaves_np(rres.best_params),
                              _leaves_np(ares.best_params)))
    _require(rrun.dispatch_stats["resumed_from_epoch"]
             == DURABLE_RESUME_AT - 1 and same and rel <= DURABLE_PARAM_REL,
             f"runtime: the resume from the async checkpoint: decisions "
             f"{'same' if same else 'differ'}, params rel. err {rel}")
    ast, sst = arun.dispatch_stats, srun.dispatch_stats
    out["async_checkpoint"] = {
        "saves": ast["ckpt_saves"], "bytes": ast["ckpt_bytes"],
        "main_thread_ms_per_save_async": ast["ckpt_stall_ms"]
        / ast["ckpt_saves"],
        "ckpt_barrier_stall_ms": ast["ckpt_barrier_stall_ms"],
        "ckpt_submit_barrier_spans_ms": barrier_spans,
        "sync_write_ms_per_save": sst["ckpt_stall_ms"] / sst["ckpt_saves"],
        "fit_wall_s": {"async": a_s, "sync": s_s},
        "bitwise_equal_results": True, "checkpoint_equal_after_read": True,
        "resume": {"stopped_after_epochs": DURABLE_RESUME_AT,
                   "decisions_identical": same, "max_param_rel_err": rel,
                   "param_rel_bar": DURABLE_PARAM_REL,
                   "bitwise_equal": _grid_equal(np, rres, ares),
                   "wall_s": r1 + r2}}

    # ---- 4. the cost model and the predictive policy: a fit armed with
    # REDCLIFF_PREDICTIVE prices its widths from the store the fits above
    # wrote, and scores the store against its epochs
    out["store"] = {"path": os.path.relpath(store, HERE) if store else None,
                    "buckets": costmodel.load().accuracy_rows()}
    run_dir = os.path.join(root, "predictive")
    with _Env(REDCLIFF_PREDICTIVE="1"):
        (prun, pres), p_launch, p_s = count("grid_predictive", lambda: grid(
            os.path.join(run_dir, "ck"), log_dir=run_dir))
    recs = read_jsonl(run_dir)
    pol = [r for r in recs if r["event"] == "policy"]
    cms = [r for r in recs if r["event"] == "cost_model"]
    _require(type(prun.policy).__name__ == "PredictiveSchedulingPolicy"
             and pol and cms and np.isfinite(pres.val_history[
                 :, :DURABLE_LIVE]).all(),
             f"runtime: the predictive fit logged {len(pol)} policy and "
             f"{len(cms)} cost_model events")
    out["predictive"] = {
        "fit_wall_s": p_s,
        "decisions": [{k: r.get(k) for k in (
            "kind", "epoch", "action", "fallback", "chosen_width",
            "heuristic_width", "from_width", "to_width", "saving_ms",
            "compile_ms", "gather_ms", "total_ms", "heuristic_ms")}
            for r in pol],
        "widths_by_epoch": [e["width"] for e in pres.epochs],
        "cost_model_events": [{k: r.get(k) for k in (
            "epoch", "grid_width", "predicted_epoch_ms", "actual_epoch_ms",
            "residual_pct", "source", "eta_s")} for r in cms],
        "mape_pct": prun.dispatch_stats["cost_model"]["mape_pct"],
        "eta": prun.dispatch_stats["eta"]}
    # each folded epoch's ms beside its host wall: the device span covers
    # the replayed epoch's work
    out["epoch_ms"] = {
        "folded_by_width": {w: ast["epoch_ms_by_width"][w]
                            / ast["epochs_by_width"][w]
                            for w in ast["epochs_by_width"]},
        "host_by_epoch": [(e["epoch"], e["width"], e["ms"])
                          for e in ares.epochs]}
    return out


def phase_runtime(torch, smi):
    """The production runtime through the normal entry points (see
    :func:`runtime_checks`), under a fresh autotune and cost-model store;
    every fit's launches are its path's."""
    from redcliff_tpu_torch.ops import autotune as at

    root = os.path.join(HERE, "build", "chip_smoke", "runtime")
    t0 = time.perf_counter()
    with _Env(REDCLIFF_AUTOTUNE_DIR=os.path.join(root + "_store", "tune"),
              REDCLIFF_COST_MODEL_DIR=os.path.join(root + "_store", "cost"),
              REDCLIFF_QUALITY="0", REDCLIFF_PREDICTIVE=None,
              REDCLIFF_AUTOTUNE=None):
        shutil.rmtree(root + "_store", ignore_errors=True)
        try:
            out = runtime_checks(root)
        finally:
            # the plans go back to the defaults the earlier phases ran
            at.clear_memo()
            at._clear_plans("factor_mix")
            at._clear_plans("gl_prox")
    _emit({"phase": "runtime", "device": torch.cuda.get_device_name(0),
           "card": smi,
           "config": "the train phase's (D4IC REDCLIFF-S, full width, GL "
                     "prox lam 4) and the grid_durable configuration (27 "
                     "points, width 32 -> 16)",
           "wall_s": time.perf_counter() - t0, **out})
    return out["launches"]["factor_mix"], out["launches"]["gl_prox"]


def _kernel_entry(name, mod, replaces, launches, by_path, max_err, t):
    return {"name": name, "route": "cuda",
            "source": os.path.relpath(mod.KERNEL_SOURCE, HERE),
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path, "max_abs_err": max_err,
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "floor_ms": t["floor_ms"],
            "shape": t["shape"]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from redcliff_tpu_torch.ops import factor_mix as FM
        from redcliff_tpu_torch.ops import pallas_prox as PX
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2

    # the quality readout adds a forward (a factor-mix launch) per check
    # window; the phases before telemetry count their fits' forwards
    # without it, and the telemetry phase turns it on for its own fits
    os.environ["REDCLIFF_QUALITY"] = "0"
    smi = phase_build(torch, {"factor_mix": FM, "gl_prox": PX})
    max_err, timing = phase_kernel(torch, FM, PX)
    serve_launches, smodel, sparams = phase_serve(torch, FM, PX)
    phase_check(torch, smodel, sparams)
    mix_launches, prox_launches, tmodel, tparams, train_ds = phase_train(
        torch, FM, PX)
    phase_train_check(torch, tmodel, tparams, train_ds)
    grid_mix, grid_prox, gmodel, gparams, gtrain, gres = phase_grid(
        torch, FM, PX)
    phase_grid_check(torch, gmodel, gparams, gtrain)
    stream = phase_grid_stream(torch, FM, PX, gparams)
    dur_mix, dur_prox = phase_grid_durable(torch, FM, PX, gparams)
    task_mix, task_prox, task_runs = phase_array_task(torch, FM, PX)
    eval_mix, eval_prox = phase_eval(torch, FM, PX, gmodel, gres, task_runs,
                                     timing["factor_mix"]["readout"])
    base_mix, base_prox, base_models, base_train = phase_baselines(
        torch, FM, PX)
    phase_baselines_check(torch, PX, base_models, base_train)
    dc_mix, dc_prox, dc_model, dc_root, dc_margs = phase_dcsfa(torch, FM, PX)
    dc_check = phase_dcsfa_check(torch, dc_model, dc_root, dc_margs)
    dy_mix, dy_prox = phase_dynotears(torch, FM, PX)
    gen_mix, gen_prox = phase_data_gen(torch, FM, PX)
    phase_data_gen_check(torch)
    syn_mix, syn_prox, syn_wd, syn_out, syn_runs = phase_accuracy_synsys(
        torch, FM, PX)
    d4_mix, d4_prox = phase_accuracy_d4ic(torch, FM, PX)
    disc_mix, disc_prox, tst_X, tst_y = phase_discovery(torch, FM, PX)
    an_mix, an_prox = phase_analysis(torch, FM, PX, syn_wd, syn_out,
                                     syn_runs)
    tst_mix, tst_prox = phase_ts_transformer(torch, FM, PX, tst_X, tst_y,
                                             smi)
    tel_mix, tel_prox = phase_telemetry(torch, smi)
    rt_mix, rt_prox = phase_runtime(torch, smi)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, FM)
        phase_profile_train(torch, FM, PX, tmodel, tparams, train_ds)
        phase_profile_grid(torch, FM, PX, gmodel, gparams, gtrain)
        phase_profile_baselines(torch, base_models, base_train)
        phase_profile_dcsfa(torch, dc_model, *dc_check)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "redcliff_tpu" or m.startswith("redcliff_tpu."))
    _require(not leaked, f"the port imported {leaked}")

    mix_paths = {"serve": serve_launches, "train": mix_launches,
                 "grid": grid_mix,
                 "grid_stream": sum(v["factor_mix"] for v in stream.values()),
                 "grid_durable": dur_mix,
                 "array_task": task_mix, "eval": eval_mix,
                 "baselines": base_mix, "dcsfa": dc_mix,
                 "dynotears": dy_mix, "data_gen": gen_mix,
                 "accuracy_synsys": syn_mix, "accuracy_d4ic": d4_mix,
                 "discovery": disc_mix, "analysis": an_mix,
                 "ts_transformer": tst_mix, "telemetry": tel_mix,
                 "runtime": rt_mix}
    fm = _kernel_entry(
        "factor_mix", FM, "redcliff_tpu/ops/factor_mix.py:58",
        sum(mix_paths.values()), mix_paths, max_err["factor_mix"],
        timing["factor_mix"]["train"])
    fm["by_shape"] = {k: v for k, v in timing["factor_mix"].items()
                      if k != "train"}
    prox_paths = {"serve": 0, "train": prox_launches, "grid": grid_prox,
                  "grid_stream": sum(v["gl_prox"] for v in stream.values()),
                  "grid_durable": dur_prox, "array_task": task_prox,
                  "eval": eval_prox, "baselines": base_prox,
                  "dcsfa": dc_prox, "dynotears": dy_prox,
                  "data_gen": gen_prox, "accuracy_synsys": syn_prox,
                  "accuracy_d4ic": d4_prox, "discovery": disc_prox,
                  "analysis": an_prox, "ts_transformer": tst_prox,
                  "telemetry": tel_prox, "runtime": rt_prox}
    px = _kernel_entry(
        "gl_prox", PX, "redcliff_tpu/ops/pallas_prox.py:47",
        sum(prox_paths.values()), prox_paths, max_err["gl_prox"],
        timing["gl_prox"]["train"])
    px["by_shape"] = {k: v for k, v in timing["gl_prox"].items()
                      if k != "train"}
    _emit({"kernels": [fm, px]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
