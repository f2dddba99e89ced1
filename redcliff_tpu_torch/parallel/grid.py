"""Coefficient-grid engine: G REDCLIFF-S points trained as one batched
program (port of ``parallel/grid.py``).

The reference fits a coefficient grid as one process per point (SLURM
arrays). The JAX package vmaps the per-point training step over a stacked
parameter/coefficient axis instead; the port does the same with
``torch.func``: each step is ``vmap(grad_and_value(loss_for_phase))`` over
the lanes with the batch shared, followed by two stacked Adams with
``torch.optim.Adam`` semantics per lane (per-lane learning rate, coupled
weight decay, eps and bias correction with per-lane step counts) and the
GL prox for every lane at once (``models/redcliff.py apply_prox_lanes_``).
On the card the factor mix and the prox are hand-written CUDA kernels,
each launched once per call for all lanes.

Per lane, as the JAX grid: a lane gate ``active & isfinite(loss) &
isfinite(grad norm)`` applied with ``torch.where`` (a gated lane keeps its
params and its Adam state; nothing is read on the host per step), device
counters of the numerics guard, validation as ordered per-batch sums from
zero, the supervised cosine stopping term, per-lane stopping criteria,
``select_best``, the lookback early stop, the non-finite quarantine
(causes ``nonfinite_grad`` / ``nonfinite_val``), Freeze accept/revert over
lanes, and the Hungarian factor alignment after pretraining.

Durability and elasticity, as the JAX grid:

* the bucket ladder and compaction (``parallel/policy.py``,
  ``parallel/compaction.py``): a grid runs at a power-of-two width with
  masked filler lanes, and at check windows the surviving lanes are
  gathered down the ladder into fresh, contiguous leaves (the lane prox's
  fast path needs an aligned slab). Results, histories and failures are
  reported under original point ids; ``on_lane_retire`` sees each lane a
  compaction retires;
* checkpoint and resume: a durable write (atomic, CRC, ``.prev``
  generation, quarantine of a corrupt head) of the whole fit state with
  the shuffle rng and the compaction era, behind the JAX grid's
  compatibility fingerprint; a resume lands at the checkpoint's own era
  and width and continues bit for bit. With ``async_checkpointing`` (the
  default) the write runs on a background thread
  (``runtime/checkpoint.AsyncCheckpointWriter``) from a host snapshot the
  loop takes (pinned copies on the current stream and an event, which
  the next replay is ordered after), the same bytes as a synchronous
  write; a preemption's and a grid deadline's final checkpoint are joined
  before the fit raises;
* per-lane deadlines (eviction with cause ``"deadline"`` and a forced
  checkpoint; siblings' math untouched) and a whole-grid deadline
  (``DeadlineExceeded`` after a final checkpoint);
* SIGTERM/SIGINT while checkpointing: one final checkpoint at the epoch
  boundary, then ``Preempted``.

Execution engine (``data/pipeline.py`` stream modes,
``parallel/epoch_engine.py``), as the JAX grid's: with the default
``stream_mode="auto"`` an eligible fit runs the EPOCH engine — the dataset
stays device-resident, each single-phase epoch's shuffled batch order is
copied into a device index buffer, and one replay of a CUDA graph runs the
whole epoch's steps (one more for the short remainder); validation is one
replay too. ``"kscan"`` replays a graph of ``scan_batches`` steps per full
group of batches; ``"per_batch"``, multi-phase epochs and FreezeByBatch
step eagerly per batch. Every mode runs the same steps on the same batches
in the same order, so the modes agree bit for bit on the CPU, where a
program's body runs eagerly. ``dispatch_stats`` records what ran (the JAX
keys ``mode``, ``epochs``, ``train_dispatches``, ``val_dispatches``,
``train_time_ms``, ``val_time_ms``, ``epoch_ms_by_width``, and the port's
``graph_captures``, ``capture_ms`` and ``programs``).

Telemetry, as the JAX grid emits it (``redcliff_tpu/parallel/grid.py:
1588-1650,1772,2021-2080,2134-2173,2289-2414,2535``): with a ``log_dir``
the fit writes ``metrics.jsonl`` — ``fit_start``, the predicted
``memory`` of its ladder width, at each check window an ``epoch`` record,
``quality`` (per-lane graph summaries of ``obs/quality.py`` keyed by
original point id, filler lanes skipped; AUROC/AUPR with ``true_gc``) and
the measured ``memory`` on a card, then ``deadline_evicted``,
``compaction``, ``early_exit_all_inactive``, ``compile`` (the CUDA graphs
an epoch captured, ``runtime/compileobs.py``),
``preempted_final_checkpoint``, ``grid_deadline_final_checkpoint``,
``profile`` and ``fit_end`` — and the spans ``grid.dispatch`` (every
step, program replay and validation pass: ring-only, enqueue time),
``grid.check_window`` and ``grid.compaction`` (emitted) and
``grid.ckpt_save``. ``profile_window`` / ``profile_dir`` open a bounded
``torch.profiler`` window. The quality readout reads params only, so fits
are bit-identical with telemetry on or off. The step fault points
(``runtime/faultinject.py``) apply on the per-batch path only, as in
JAX: ``nan_batch`` and ``grad_blowup`` as there, and ``skip_update``
too, which the JAX grid never applies (ROADMAP queue 3 item 16); the
scanned modes apply none. The crash points ``checkpoint_saved`` and
``epoch_end`` are the JAX grid's.

The production runtime, as the JAX grid runs it
(``redcliff_tpu/parallel/grid.py:290-315,381-383,741,1150-1166,
1502-1508,1599-1602,1668,1749-1783,1831-1833,2081-2130,2416-2485``):

* the liveness watchdog (``REDCLIFF_WATCHDOG``, ``runtime/watchdog.py``)
  around the fit, bound to the preemption guard and the fit's log; the
  loop stamps ``epoch_engine`` per epoch and ``batch_loop`` per eager
  batch, and each CUDA-graph capture runs under the op-scoped
  ``compile`` heartbeat;
* the learned cost model (``obs/costmodel.py``): ``dispatch_stats`` keeps
  ``epoch_ms_by_width``, ``epochs_by_width`` and
  ``first_epoch_ms_by_width``; each check window scores the store's
  prediction (else the fit's own steady mean at the width) against the
  epochs it resolved, logs a ``cost_model`` event and sets
  ``dispatch_stats["eta"]``; the fit's end folds the per-width epochs and
  captures into the store under platform ``"cuda"``. On the card an
  epoch's ms is resolved at the next check window from a CUDA event pair
  around it: the larger of its host wall and its device span, so a
  replayed epoch whose host call returns early still counts its device
  work;
* the predictive scheduling policy (``REDCLIFF_PREDICTIVE``,
  ``parallel/policy.py``), swapped in before the initial width when a
  store resolves, its decisions logged as ``policy`` events; a width is
  "warm" when the epoch engine needs no capture there;
* the launch-plan autotuner (``ops/autotune.py``) at construction, for
  both kernels' lane forms at every ladder width the grid can run at,
  before any capture, its records logged as ``autotune`` events.

Mixed precision, as the JAX grid runs it (``redcliff_tpu/parallel/
grid.py:362-401,1308-1313,1566-1611,1834-1909,2097,2314,2441-2482``):
``GridSpec.precision_mode`` (else the train config's) ``"mixed"`` runs
each step's loss and gradients, the validation pass and the Freeze step
inside a ``"bfloat16"`` matmul context (``utils/precision.py``; the factor
mix's bf16 lane form on the card, in the eager steps and in the captured
programs alike). The precision-cliff watch reads one flag a epoch, in
mixed fits only: a lane stuck on ``max_consecutive_skips`` non-finite
gradient steps in an epoch that skipped demotes the whole grid to f32 (a
``precision`` event, ``cause="precision_cliff"``, with the lanes) and gets
one f32 epoch instead of quarantine; the epoch engine drops every captured
program, so the f32 programs are captured afresh and no replay runs a
bf16 graph again (``dispatch_stats["precision_eras"]`` counts the bf16
launches of each era). The demotion is checkpointed
(``precision_demoted``) and a resume honours it; the fingerprint rejects a
different ``precision_mode``. The cost rows carry the mode's label
(``utils/precision.py precision_label``), and the store folds the mixed
and the f32 era apart.

The cost model learns steady-state epochs only: an epoch in which the
epoch engine captured a CUDA graph is left out of ``epoch_ms_by_width`` /
``epochs_by_width``, of the ``cost_model`` scoring and of the store fold
(its capture cost is in the compile accumulators);
``first_epoch_ms_by_width`` keeps each width's first epoch as JAX keeps
it. The CPU captures nothing, so its events are JAX's.

The device mesh, as the JAX grid shards it (``redcliff_tpu/parallel/
grid.py:273-335,674-690,885-914,1186-1272,1511-1515,1547-1550,1614-1659``):
``mesh`` (``parallel/mesh.py``) is the full device capacity and splits the
lane axis into contiguous shards, shard ``i`` on ``mesh.devices[i]``; a
width below the device count runs on the first ``width`` devices (the
sub-mesh rule), and the bucket ladder rounds widths to fit the mesh
(``compaction.bucket_width(n, n_devices)``). Every shard holds its lanes'
params, Adam states, numerics counters and best params on its device,
and runs the step, the epoch engine's programs, validation, the cosine
term, the Freeze round and the quality readout itself: both kernels'
lane forms launch per shard, on the shard's device and stream, each
shard launched in mesh order before anything is read back. The per-lane
decision vectors (active, best criteria, failures) live on the first
device and are formed once from the gathered per-lane values, so the
host loop makes one set of decisions. A compaction gathers the survivors,
takes their rows and re-splits them over the new width's mesh. The
checkpoint holds gathered host state plus the mesh's shape (``mesh``,
audit only: the resume fingerprint stays mesh-agnostic), and a resume on
a different device count re-shards the checkpointed lanes onto the
survivors (``parallel/remesh.py``: a ``grid.remesh`` span, a ``remesh``
event, ``dispatch_stats["remeshes"/"remesh"]``). A dispatch dying with a
device-loss, collective-timeout or coordinator-loss signature surfaces as
``remesh.HostLostError`` (drivers exit 21). In a process group
(``parallel/distributed.py``) each process holds its own shards, every
host read is an all-gather, compaction is off and process 0 writes the
checkpoint, as in JAX.

Entry points run on ``cuda`` unless the caller passes ``device=``; with a
mesh the fit's first device is the mesh's first local entry.
"""
from __future__ import annotations

import contextlib
import copy
import os
import time
import warnings
from dataclasses import asdict, dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from redcliff_tpu_torch.data import pipeline
from redcliff_tpu_torch.interop import params_to_jax, tree_leaves, tree_map
from redcliff_tpu_torch.models.redcliff import phase_schedule
from redcliff_tpu_torch.obs import costmodel as _costmodel
from redcliff_tpu_torch.obs import memory as _obsmem
from redcliff_tpu_torch.obs import profiling as _profiling
from redcliff_tpu_torch.obs import quality as _quality
from redcliff_tpu_torch.obs import schema as _schema
from redcliff_tpu_torch.obs import spans as _spans
from redcliff_tpu_torch.obs.logging import MetricLogger
from redcliff_tpu_torch.ops import autotune as _autotune
from redcliff_tpu_torch.ops import factor_mix as _factor_mix
from redcliff_tpu_torch.ops.pallas_prox import lane_thresholds
from redcliff_tpu_torch.parallel import compaction, distributed, remesh
from redcliff_tpu_torch.parallel import policy as gridpolicy
from redcliff_tpu_torch.parallel import epoch_engine as _engines
from redcliff_tpu_torch.parallel.epoch_engine import EpochEngine
from redcliff_tpu_torch.parallel.mesh import (DeviceMesh, canonical,
                                              lane_bounds)
from redcliff_tpu_torch.parallel.policy import GridSchedulingPolicy
from redcliff_tpu_torch.runtime import checkpoint as durable_ckpt
from redcliff_tpu_torch.runtime import compileobs, faultinject, numerics
from redcliff_tpu_torch.runtime import watchdog as _watchdog
from redcliff_tpu_torch.runtime.preempt import (DeadlineExceeded, Preempted,
                                                PreemptionGuard)
from redcliff_tpu_torch.train.freeze import apply_freeze_lanes
from redcliff_tpu_torch.utils.misc import factor_alignment_order
from redcliff_tpu_torch.utils.precision import (check_precision_mode,
                                                matmul_precision_ctx,
                                                precision_label,
                                                resolve_device,
                                                resolve_matmul_precision)

__all__ = ["GridSpec", "GridResult", "RedcliffGridRunner",
           "group_configs_by_shape", "COEFF_AXES", "OPT_AXES", "STOP_AXES"]

COEFF_AXES = (
    "forecast_coeff", "factor_score_coeff", "factor_cos_sim_coeff",
    "factor_weight_l1_coeff", "adj_l1_reg_coeff",
    "factor_weight_smoothing_penalty_coeff",
)
OPT_AXES = ("embed_lr", "gen_lr", "embed_weight_decay", "gen_weight_decay")
# per-point stopping-criteria coefficients; fall back to the train config
STOP_AXES = ("stopping_criteria_forecast_coeff",
             "stopping_criteria_factor_coeff",
             "stopping_criteria_cosSim_coeff")

_BETA1, _BETA2 = 0.9, 0.999


@dataclass
class GridSpec:
    """G hyperparameter points sharing one model shape. Each entry of
    ``points`` maps coefficient/optimizer/stopping axis names (COEFF_AXES +
    OPT_AXES + STOP_AXES) to floats; unspecified axes fall back to the
    model config / train config values.

    ``lane_seeds`` (one int per point) makes per-lane initialization
    composition-independent: lane i's init depends on ``(seed,
    lane_seeds[i])`` only, never on its position in the grid.
    ``fit_deadline_s`` (a scalar or one per point) is each lane's
    wall-clock budget and ``grid_deadline_s`` the whole fit's, both
    counted from the start of this process's ``fit`` call."""

    points: Sequence[dict]
    fit_deadline_s: Any = None   # scalar | per-point sequence | None
    grid_deadline_s: float | None = None
    lane_seeds: Sequence[int] | None = None
    # None inherits RedcliffTrainConfig.precision_mode; "mixed" runs bf16
    # contractions under the precision-cliff watch (a skip storm demotes
    # the whole grid to f32). Part of the resume fingerprint
    precision_mode: str | None = None

    def __post_init__(self):
        if self.precision_mode is not None:
            check_precision_mode(self.precision_mode)
        valid = set(COEFF_AXES) | set(OPT_AXES) | set(STOP_AXES)
        for i, p in enumerate(self.points):
            unknown = set(p) - valid
            if unknown:
                raise ValueError(
                    f"grid point {i} has unknown hyperparameter axes "
                    f"{sorted(unknown)}; valid axes: {sorted(valid)}")
        if self.lane_seeds is not None \
                and len(self.lane_seeds) != len(self.points):
            raise ValueError(
                f"lane_seeds has {len(self.lane_seeds)} entries for "
                f"{len(self.points)} grid points")
        if self.grid_deadline_s is not None and self.grid_deadline_s <= 0:
            raise ValueError("grid_deadline_s must be positive")
        if self.fit_deadline_s is not None:
            lanes = self.lane_deadlines()
            if len(lanes) != len(self.points):
                raise ValueError(
                    f"fit_deadline_s has {len(lanes)} entries for "
                    f"{len(self.points)} grid points")
            if (lanes <= 0).any():
                raise ValueError("fit_deadline_s entries must be positive")

    def lane_deadlines(self):
        """Per-lane wall-clock budgets as a float array ((G,), inf = no
        budget), or None when no per-fit deadline is configured."""
        if self.fit_deadline_s is None:
            return None
        if np.ndim(self.fit_deadline_s) == 0:
            return np.full((len(self.points),), float(self.fit_deadline_s))
        return np.asarray([float(d) for d in self.fit_deadline_s])

    def stacked(self, base_cfg, train_cfg):
        """Every axis as a ``(G,)`` float32 numpy array."""
        out = {}
        for name in COEFF_AXES:
            out[name] = np.asarray(
                [p.get(name, getattr(base_cfg, name)) for p in self.points],
                dtype=np.float32)
        for name in OPT_AXES + STOP_AXES:
            out[name] = np.asarray(
                [p.get(name, getattr(train_cfg, name)) for p in self.points],
                dtype=np.float32)
        return out

    def needs_gc(self, base_cfg):
        return any(p.get("factor_cos_sim_coeff",
                         base_cfg.factor_cos_sim_coeff) > 0
                   for p in self.points)

    def needs_gc_lagged(self, base_cfg):
        return any(p.get("adj_l1_reg_coeff", base_cfg.adj_l1_reg_coeff) > 0
                   for p in self.points)


@dataclass
class GridResult:
    best_params: Any          # numpy tree with leading G axis
    best_criteria: np.ndarray  # (G,)
    best_epoch: np.ndarray     # (G,)
    val_history: np.ndarray    # (epochs, G) validation combo loss
    coeffs: dict
    active: np.ndarray = None  # (G,) bool; False = point early-stopped
    # quarantined grid points, one {"point", "epoch", "cause", "hparams"}
    # record each, cause in {"nonfinite_grad", "nonfinite_val",
    # "deadline"}: ``nonfinite_grad`` — the lane's numerics guard skipped
    # steps in the failing epoch (max_consecutive_skips in a row, or a
    # non-finite validation loss after skipped steps); ``nonfinite_val`` —
    # validation loss went non-finite with finite steps; ``deadline`` —
    # the lane's wall-clock budget ran out. Each freezes the lane while
    # the rest of the grid keeps training
    failures: list = field(default_factory=list)
    # the port's additions, as RedcliffFitResult carries them: per epoch
    # run by this call {"epoch", "phases", "width", "ms", "mode",
    # "launches_by_shard"} (host wall ms, read after the epoch's check
    # window; the stream mode its steps ran in; each lane shard's kernel
    # executions), the numerics guard's per-point counters at the end of
    # the fit ({"skipped": [...], ...}), and the runner's dispatch_stats
    # (what ran: stream mode, dispatches, CUDA graphs) for callers that
    # never see the runner
    epochs: list = field(default_factory=list)
    numerics: dict | None = None
    dispatch_stats: dict | None = None


def group_configs_by_shape(config_dicts, shape_keys):
    """Partition config dicts into shape-compatible groups (one grid each).
    Returns {shape_tuple: [indices]}: groups in first-appearance order of
    their shape, ascending indices within a group, a missing key grouped
    under None."""
    groups = {}
    for i, cd in enumerate(config_dicts):
        key = tuple(cd.get(k) for k in shape_keys)
        groups.setdefault(key, []).append(i)
    return groups


def _lane_seed(seed, lane_seed):
    """A generator seed from the grid's seed and one lane's own seed."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, int(lane_seed) % 2 ** 64])
    return int(ss.generate_state(1, np.uint64)[0] % 2 ** 63)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _lanes(x, like):
    """A ``(G,)`` per-lane tensor shaped to broadcast against ``like``."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def _where(mask, new, old):
    """Per-lane select over two trees: ``new`` where ``mask``."""
    return tree_map(lambda a, b: torch.where(_lanes(mask, a), a, b), new, old)


def _clone(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def _take(tree, rows):
    """Rows ``rows`` of every leaf as fresh contiguous tensors (never views
    of the old leaves: the lane prox works in place on an aligned slab)."""
    return tree_map(lambda x: x.index_select(0, rows), tree)


class _Shard:
    """One lane shard of the current era: lanes ``[lo, hi)`` on
    ``device``. The runner's step, batch and validation helpers run on it
    through this view, with the era's coefficients, learning rates and
    prox thresholds sliced to its lanes; everything else is the
    runner's."""

    def __init__(self, runner, index, lo, hi, device):
        self._runner = runner
        self.index, self.lo, self.hi = index, lo, hi
        self.device = device

        def part(v):
            return v[lo:hi].to(device)
        self._ex_coeffs = {k: part(v) for k, v in runner._ex_coeffs.items()}
        self._ex_loss_coeffs = {k: self._ex_coeffs[k] for k in COEFF_AXES}
        self._ex_lr64 = {k: part(v) for k, v in runner._ex_lr64.items()}
        self._ex_prox_t = (part(runner._ex_prox_t)
                           if runner._ex_prox_t is not None else None)

    @property
    def width(self):
        return self.hi - self.lo

    def __getattr__(self, name):
        return getattr(self._runner, name)

    # the runner's per-lane helpers, run on this shard's lanes and device
    # (looked up on the runner's class at each call)
    def _step(self, *args):
        return type(self._runner)._step(self, *args)

    def _adam_(self, *args):
        return type(self._runner)._adam_(self, *args)

    def _batches(self, *args, **kw):
        return type(self._runner)._batches(self, *args, **kw)


class RedcliffGridRunner:
    """Trains G REDCLIFF-S configurations at once (see the module
    docstring)."""

    CHECKPOINT_NAME = "grid_checkpoint.pkl"
    # per-fit accounting, (re)set by fit: the stream mode, dispatches and
    # CUDA graphs, the width, compactions, lane-epochs computed against an
    # uncompacted run's, the synchronous checkpoint writes and load, the
    # epoch resumed from
    dispatch_stats = None

    def __init__(self, model, train_config, spec: GridSpec, mesh=None,
                 policy=None, device=None):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a parallel.mesh.DeviceMesh, got "
                            f"{type(mesh).__name__}")
        if spec.precision_mode is not None:
            check_precision_mode(spec.precision_mode)
        if len(spec.points) == 0:
            raise ValueError("a grid needs at least one point")
        self.model = model
        self.tc = train_config
        self.spec = spec
        # elastic scheduling, as the JAX grid: ``mesh`` is the FULL device
        # capacity, ``self.mesh`` the active mesh (a sub-mesh once the
        # execution width drops below the device count)
        self._mesh_full = self.mesh = mesh
        if mesh is not None:
            local = mesh.local_indices()
            if not local:
                raise ValueError("this process owns no entry of the mesh")
            first = mesh.devices[local[0]]
            if device is not None and canonical(device) != first:
                raise ValueError(
                    f"device={device!r} disagrees with the mesh's first "
                    f"local device {first}")
            device = first
        self._n_proc = distributed.process_count() if mesh is not None else 1
        self.device = resolve_device(device)
        self.policy = (policy if policy is not None
                       else GridSchedulingPolicy.from_train_config(
                           train_config))
        # the precision mode (the spec's, else the train config's) and the
        # effective matmul precision; "mixed" fits are demotable: a
        # sentinel skip storm runs every later step at f32
        self._precision_mode = (spec.precision_mode
                                or getattr(train_config, "precision_mode",
                                           "f32"))
        self._precision = resolve_matmul_precision(
            self._precision_mode,
            getattr(train_config, "matmul_precision", None))
        self._demoted = False
        # the epoch engines of the running fit, one per local lane shard
        # (the predictive policy asks them which widths need no capture),
        # and the current era's shards
        self._engines = []
        self._shards = []
        # predictive scheduling (REDCLIFF_PREDICTIVE, parallel/policy.py):
        # with a readable cost-model store, the predictive policy replaces
        # the heuristic before the initial-width decision; with no usable
        # prior every decision is the heuristic's. A caller's policy wins
        if policy is None and gridpolicy.predictive_enabled():
            cm = _costmodel.load(self._cost_model_base())
            if cm is not None:
                max_w = os.environ.get(gridpolicy.ENV_POLICY_MAX_WIDTH)
                self.policy = gridpolicy.PredictiveSchedulingPolicy(
                    g_bucket=self.policy.g_bucket,
                    compaction=self.policy.compaction, cost_model=cm,
                    shape_key=self._shape_key(),
                    platform=_costmodel.platform_label(self.device),
                    precision=self._precision_label0(),
                    epochs=getattr(train_config, "max_iter", None),
                    max_width=(int(max_w) if max_w and max_w.isdigit()
                               else None),
                    warm=self._width_warm)
        self._g_real = G = len(spec.points)
        n_dev = mesh.size if mesh is not None else 1
        self._g_exec0 = self.policy.initial_width(G, n_dev)
        if mesh is not None:
            self.mesh = self._mesh_for(self._g_exec0)
        # the initial-width decision record (predictive policy only),
        # logged as a `policy` event once a fit has its log
        self._policy_init_decision = (
            self.policy.take_decision()
            if hasattr(self.policy, "take_decision") else None)
        # original point id per execution lane; -1 marks bucket filler
        # lanes (masked from birth, never surfaced in GridResult)
        self._orig_ids0 = np.concatenate(
            [np.arange(G, dtype=np.int32),
             np.full((self._g_exec0 - G,), -1, np.int32)])
        tc, cfg = train_config, model.config
        # result-facing per-point coefficients (real width); the execution
        # lanes' come from _set_era
        self.result_coeffs = spec.stacked(cfg, tc)
        self.coeffs = {k: torch.from_numpy(v).to(self.device)
                       for k, v in self.result_coeffs.items()}
        # Adam's learning rates as torch.optim.Adam holds them (Python
        # floats): the step size lr / (1 - beta1**step) is rounded once
        self._lr64 = {name: torch.tensor(
            [float(p.get(name, getattr(tc, name))) for p in spec.points],
            dtype=torch.float64, device=self.device)
            for name in ("embed_lr", "gen_lr")}
        self._need_gc = spec.needs_gc(cfg)
        self._need_gc_lagged = spec.needs_gc_lagged(cfg)
        self._guard = tc.numerics is not None and tc.numerics.enabled
        self._numerics_k = (tc.numerics.max_consecutive_skips
                            if self._guard else 0)
        self._demotable = (self._precision_mode == "mixed" and self._guard
                           and self._precision is not None)
        self._prox_pen = tc.prox_penalty
        # the per-lane GL thresholds, a float32 product on the device as
        # the JAX grid forms lr * lam under vmap
        self._prox_t = (lane_thresholds(self.coeffs["gen_lr"], tc.prox_lam)
                        if self._prox_pen is not None else None)
        mode = cfg.training_mode
        self._freeze = "Freeze" in mode
        self._freeze_by_batch = "FreezeByBatch" in mode
        # reported in fit_start; the port caches no compiled program
        self._compile_cache_dir = compileobs.enable_cache(
            getattr(train_config, "compile_cache_dir", None))
        self._build()
        self._set_era(self._orig_ids0)
        self._maybe_tune_kernels()

    def _maybe_tune_kernels(self):
        """Tune (or reuse) both kernels' launch plans at this grid's shapes
        — their lane forms at every ladder width the grid can run at —
        before any launch or capture
        (``ops/autotune.py tune_for_model``; a no-op without a card or a
        store)."""
        cfg, tc = self.model.config, self.tc
        widths = [self._g_exec0]
        n_dev = self._mesh_full.size if self._mesh_full is not None else 1
        if self.policy.g_bucket and self.policy.compaction:
            while widths[-1] > 2:
                w = compaction.bucket_width(widths[-1] // 2, n_dev)
                if w >= widths[-1]:
                    break
                widths.append(w)
        for width in widths:
            n = (self._mesh_for(width).size
                 if self._mesh_full is not None else 1)
            _autotune.tune_for_model(cfg, tc.batch_size,
                                     prox_penalty=tc.prox_penalty,
                                     device=self.device, lanes=width // n)

    def _precision_label0(self):
        """The cost-model label of this fit's mode before any demotion."""
        return precision_label(self._precision_mode,
                               getattr(self.tc, "matmul_precision", None))

    def _demote_to_f32(self):
        """The sentinel-triggered precision demotion: every later step,
        validation pass and capture runs at f32. The caller logs the
        ``precision`` event and resets the consecutive-skip counters."""
        self._precision = None
        self._demoted = True
        # the predictive policy prices the f32 programs from f32 evidence
        if hasattr(self.policy, "precision"):
            self.policy.precision = "f32"
        # a graph captured under the bf16 context has its casts baked in:
        # no replay may run one again
        for engine in self._engines:
            engine.drop_programs()

    def _ctx(self):
        """The fit's matmul-precision context (none at f32)."""
        return matmul_precision_ctx(self._precision)

    def _cost_model_base(self):
        """The cost-model store's base directory, resolved as
        ``costmodel.store_path`` resolves it: ``REDCLIFF_COST_MODEL_DIR``,
        the ``compile_cache_dir`` knob, ``REDCLIFF_COMPILE_CACHE``."""
        return (os.environ.get(_costmodel.ENV_STORE_DIR)
                or getattr(self.tc, "compile_cache_dir", None)
                or os.environ.get(compileobs.ENV_CACHE_DIR) or None)

    def _shape_key(self):
        return _schema.shape_key(_schema.shape_desc(self.model.config))

    def _width_warm(self, width):
        """Whether moving to ``width`` needs no CUDA-graph capture: the
        running fit's epoch engine holds that width's programs or captures
        nothing (the predictive policy's "warm")."""
        if not self._engines:
            return False
        n = self._mesh_for(width).size if self._mesh_full is not None else 1
        return all(e.holds(width // n) for e in self._engines)

    # ------------------------------------------------------------------ init
    def _adam_state(self, tree):
        return {"step": torch.zeros((tree_leaves(tree)[0].shape[0],),
                                    dtype=torch.int64, device=self.device),
                "exp_avg": tree_map(torch.zeros_like, tree),
                "exp_avg_sq": tree_map(torch.zeros_like, tree)}

    def _opt_states(self, params):
        """Per-lane Adam state over a stacked params tree: ``(embedder
        Adam, factor Adam)``, each ``{"step": (G,), "exp_avg": tree,
        "exp_avg_sq": tree}``."""
        return (self._adam_state(params["embedder"]),
                self._adam_state(params["factors"]))

    def init_grid(self, seed=0):
        """G independently drawn parameter sets stacked on axis 0, with
        fresh Adam states. With ``spec.lane_seeds`` lane i draws from a
        generator seeded by ``(seed, lane_seeds[i])`` only, so a point
        inits identically whatever grid it is in; without them, from the
        i-th child of ``seed`` (position-dependent, as JAX's
        ``split(key, G)``)."""
        G = self._g_real
        if self.spec.lane_seeds is not None:
            seeds = [_lane_seed(seed, s) for s in self.spec.lane_seeds]
        else:
            seeds = [int(c.generate_state(1, np.uint64)[0] % 2 ** 63)
                     for c in np.random.SeedSequence(int(seed)).spawn(G)]
        params = _stack([self.model.init(torch.Generator().manual_seed(s),
                                         self.device) for s in seeds])
        return (params,) + self._opt_states(params)

    def init_grid_from(self, point_params):
        """Replicate ONE parameter set (numpy or torch tree) across the
        grid axis — the SLURM-array pattern's initialization, where every
        per-point process seeds identically."""
        G = self._g_real

        def rep(x):
            t = x.detach() if isinstance(x, torch.Tensor) \
                else torch.from_numpy(np.array(x))
            t = t.to(self.device)
            return torch.stack([t] * G)
        params = tree_map(rep, point_params)
        return (params,) + self._opt_states(params)

    def pad_to_width(self, state):
        """A real-width stacked state (any tree of ``(G, ...)`` leaves)
        padded to the initial execution width: filler lanes replicate lane
        0 — finite, valid math whose results the active mask discards."""
        pad = self._g_exec0 - self._g_real
        if not pad:
            return state
        return tree_map(lambda x: torch.cat(
            [x, x[:1].expand((pad,) + tuple(x.shape[1:]))]), state)

    # ----------------------------------------------------------------- build
    def _build(self):
        model = self.model
        cfg = model.config
        need_gc, need_gc_lagged = self._need_gc, self._need_gc_lagged

        def make_grad(phase):
            def loss_fn(params, coeffs, X, Y):
                return model.loss_for_phase(
                    params, X, Y, phase, coeffs=coeffs, need_gc=need_gc,
                    need_gc_lagged=need_gc_lagged)
            return torch.func.vmap(
                torch.func.grad_and_value(loss_fn, has_aux=True),
                in_dims=(0, 0, None, None))

        self._grads = {phase: make_grad(phase) for phase in (
            "embedder_pretrain", "factor_pretrain", "combined",
            "post_train")}

        def point_val(params, coeffs, X, Y):
            combo, parts = model.loss_for_phase(
                params, X, Y, "combined", coeffs=coeffs, need_gc=need_gc,
                need_gc_lagged=need_gc_lagged)
            # coefficient-normalized stopping-criteria terms (the
            # reference divides each val part by its loss coefficient)
            fc, fsc = coeffs["forecast_coeff"], coeffs["factor_score_coeff"]
            fo = parts["forecasting_loss"] / torch.where(
                fc > 0, fc, torch.ones_like(fc))
            fa = parts["factor_loss"] / torch.where(
                fsc > 0, fsc, torch.ones_like(fsc))
            return combo, fo, fa

        vval = torch.func.vmap(point_val, in_dims=(0, 0, None, None))

        def val(params, coeffs, X, Y):
            with self._ctx():
                return vval(params, coeffs, X, Y)

        self._val = val

        # supervised pairwise-cosine stopping term: mean cosine between
        # max-normalized lag-summed supervised GC estimates on the first
        # validation batch
        S = cfg.num_supervised_factors

        def point_cos(params, X):
            est = model.gc(params, cfg.primary_gc_est_mode, X=X,
                           threshold=False, ignore_lag=True)[..., 0]
            s_eff = min(S, est.shape[1])
            if s_eff < 2:
                return torch.zeros((), dtype=est.dtype, device=est.device)
            sup = est[:, :s_eff]
            m = torch.amax(sup, dim=(-2, -1), keepdim=True)
            # positive-max guard: all-non-positive estimates pass through
            sup = sup / torch.where(m > 0, m, torch.ones_like(m))
            flat = sup.reshape(sup.shape[0], s_eff, -1)
            norms = torch.clamp_min(torch.linalg.norm(flat, dim=-1), 1e-8)
            sims = (torch.einsum("nik,njk->nij", flat, flat)
                    / (norms[:, :, None] * norms[:, None, :]))
            iu = torch.triu_indices(s_eff, s_eff, offset=1)
            return torch.mean(sims[:, iu[0], iu[1]])

        self._cos = (torch.func.vmap(point_cos, in_dims=(0, None))
                     if S > 1 else None)

    def _set_era(self, orig_ids):
        """The execution lanes' coefficients, learning rates and prox
        thresholds for one compaction era: real lanes take their point's,
        filler lanes replicate the first real lane's (their math must stay
        finite; the active mask discards their results)."""
        ids = np.asarray(orig_ids)
        real = ids >= 0
        fill = int(ids[real][0]) if real.any() else 0
        ix = torch.as_tensor(np.where(real, ids, fill), dtype=torch.long,
                             device=self.device)
        self._ex_coeffs = {k: v.index_select(0, ix)
                           for k, v in self.coeffs.items()}
        self._ex_loss_coeffs = {k: self._ex_coeffs[k] for k in COEFF_AXES}
        self._ex_lr64 = {k: v.index_select(0, ix)
                         for k, v in self._lr64.items()}
        self._ex_prox_t = (self._prox_t.index_select(0, ix)
                           if self._prox_t is not None else None)
        self._shards = self._layout(ids.size)

    # ------------------------------------------------------------------ mesh
    def _mesh_for(self, width):
        """The mesh an execution grid of ``width`` lanes shards over: the
        full mesh when the width is a multiple of its device count, a
        SUB-mesh over the first ``width`` devices when the width divides
        it. Bucket-ladder widths always satisfy one of the two."""
        mesh = self._mesh_full
        if mesh is None:
            return None
        n_dev = mesh.size
        if width % n_dev == 0:
            return mesh
        if n_dev % width == 0:
            return mesh.sub(width)
        raise ValueError(
            f"grid width {width} cannot shard over the {n_dev}-device mesh "
            f"(neither a multiple nor a divisor of the device count)")

    def _layout(self, width):
        """This process's lane shards of a ``width``-lane era: one shard on
        the runner's device without a mesh, else one per local entry of
        the width's (sub-)mesh."""
        if self._mesh_full is None:
            return [_Shard(self, 0, 0, width, self.device)]
        self.mesh = mesh = self._mesh_for(width)
        bounds = lane_bounds(width, mesh.size)
        return [_Shard(self, i, *bounds[i], mesh.devices[i])
                for i in mesh.local_indices()]

    def _split(self, tree):
        """A full-width tree on the runner's device -> this process's shard
        trees, each a fresh contiguous copy on its shard's device (the one
        shard of an unmeshed fit is the tree itself)."""
        if self._mesh_full is None:
            return [tree]
        return [tree_map(lambda x, _s=sh: x[_s.lo:_s.hi].to(
            _s.device, copy=True), tree) for sh in self._shards]

    def _split_vec(self, v):
        """A ``(width,)`` per-lane tensor -> each shard's lanes on its
        device (views where the device is the runner's)."""
        if self._mesh_full is None:
            return [v]
        return [v[sh.lo:sh.hi].to(sh.device) for sh in self._shards]

    def _gather(self, parts):
        """Shard trees (this process's, mesh order) -> the full-width tree
        on the runner's device: concatenated in one process, all-gathered
        across a process group (a collective: every process calls it)."""
        if self._mesh_full is None:
            return parts[0]
        if self._n_proc > 1:
            arrays = tree_map(lambda *xs: distributed.ShardedArray(
                (), {sh.index: x for sh, x in zip(self._shards, xs)},
                self.mesh), *parts)
            host = distributed.gather_to_host(arrays)
            return tree_map(lambda a: torch.from_numpy(a).to(self.device),
                            host)
        if len(parts) == 1 and self._shards[0].device == self.device:
            return parts[0]
        return tree_map(lambda *xs: torch.cat(
            [x.to(self.device) for x in xs]), *parts)

    def _new_engines(self, mode, train_ds, val_ds, stats, old=()):
        """One epoch engine per shard of the current era, reusing the
        engine of ``old`` that already runs on the shard's mesh entry;
        each starts a fresh era at its shard's width."""
        out = []
        for j, sh in enumerate(self._shards):
            if j < len(old) and old[j].device == sh.device:
                eng = old[j]
                eng.runner = sh
            else:
                eng = EpochEngine(sh, mode, train_ds, val_ds, stats)
            eng.new_era(sh.width)
            out.append(eng)
        return out

    def _exec_deadlines(self, orig_ids):
        """Per-execution-lane wall-clock budgets for the current era
        (filler lanes: +inf), or None when no per-fit deadline is set."""
        lane_deadline = self.spec.lane_deadlines()
        if lane_deadline is None:
            return None
        ids = np.asarray(orig_ids)
        out = np.full(ids.shape, np.inf)
        m = ids >= 0
        out[m] = lane_deadline[ids[m]]
        return out

    # ------------------------------------------------------------------ step
    def _adam_(self, params, grads, state, lr64, wd, eps, gate):
        """One gated Adam step over the stacked leaves of ``params``, in
        place, with torch.optim.Adam's arithmetic per lane. Lanes outside
        ``gate`` keep their params, moments and step count."""
        step = state["step"] + 1
        bc1 = 1.0 - torch.pow(_BETA1, step.double())
        bc2 = 1.0 - torch.pow(_BETA2, step.double())
        step_size = (lr64 / bc1).float()
        bc2_sqrt = torch.sqrt(bc2).float()

        def update(p, g, m, v):
            g = g + _lanes(wd, p) * p
            m_new = torch.lerp(m, g, 1 - _BETA1)
            v_new = (v * _BETA2).addcmul_(g, g, value=1 - _BETA2)
            denom = torch.sqrt(v_new) / _lanes(bc2_sqrt, p) + eps
            p_new = p - (_lanes(step_size, p) * m_new) / denom
            keep = _lanes(gate, p)
            p.copy_(torch.where(keep, p_new, p))
            m.copy_(torch.where(keep, m_new, m))
            v.copy_(torch.where(keep, v_new, v))

        tree_map(update, params, grads, state["exp_avg"],
                 state["exp_avg_sq"])
        state["step"].copy_(torch.where(gate, step, state["step"]))

    def _step(self, phase, params, optA, optB, nstate, active, X, Y):
        """One guarded, lane-gated step of ``phase`` for every execution
        lane of the current era, in place on ``params``, the Adam states
        and the numerics counters ``nstate`` (a captured program replays
        on fixed storage; JAX rebinds donated buffers instead). Returns
        ``(nstate, per-lane loss)``."""
        c = self._ex_coeffs
        with self._ctx():
            grads, (combo, _) = self._grads[phase](
                params, self._ex_loss_coeffs, X, Y)
        combo = combo.detach()
        if self._guard:
            gnorm = numerics.lane_global_norm(grads)
            ok = torch.isfinite(combo) & torch.isfinite(gnorm)
            new = numerics.update_numerics_state(nstate, ok, gnorm,
                                                 count=active)
            for k, v in new.items():
                nstate[k].copy_(v)
            gate = active & ok
        else:
            gate = active
        tc = self.tc
        with torch.no_grad():
            if phase in ("embedder_pretrain", "combined"):
                self._adam_(params["embedder"], grads["embedder"], optA,
                            self._ex_lr64["embed_lr"],
                            c["embed_weight_decay"], tc.embed_eps, gate)
            if phase in ("factor_pretrain", "post_train", "combined"):
                self._adam_(params["factors"], grads["factors"], optB,
                            self._ex_lr64["gen_lr"], c["gen_weight_decay"],
                            tc.gen_eps, gate)
                if self._prox_pen is not None:
                    # GISTA prox after the factor step; the gate leaves
                    # frozen/guarded/filler lanes untouched (a prox of an
                    # unchanged iterate would still shrink it)
                    self.model.apply_prox_lanes_(params, self._ex_prox_t,
                                                 gate, self._prox_pen)
        return nstate, combo

    @staticmethod
    def _select_best(best_crit, best_epoch, crit, better, epoch):
        """The per-lane best criteria and epochs after an epoch whose
        criteria ``crit`` improved the lanes of ``better``; each shard
        selects its best params with its lanes of ``better``."""
        return (torch.where(better, crit, best_crit),
                torch.where(better, torch.full_like(best_epoch, epoch),
                            best_epoch))

    def phase_for_epoch(self, epoch):
        return phase_schedule(self.model.config, epoch)

    def _batches(self, ds, rng=None):
        """(X, Y) tensors on the runner's device: gathered from the
        dataset's device-resident copy when it has one, else prefetched."""
        bs = self.tc.batch_size
        if getattr(ds, "supports_device_batches", False):
            return ds.batches(bs, rng=rng, device=self.device)

        def put(x):
            return torch.as_tensor(x).to(self.device)
        return pipeline.prefetch_batches(ds.batches(bs, rng=rng),
                                         depth=self.tc.prefetch_batches,
                                         put=put)

    def _align_all_points(self, P, train_ds):
        """Per-lane Hungarian alignment of factors to supervised labels at
        the pretrain->train transition: one vmapped forward per shard gives
        every lane's first factor weightings, each lane's permutation is
        solved on the host and applied as a per-lane gather along the
        factor axis (in place, on every shard)."""
        cfg = self.model.config
        tc = self.tc
        fw = torch.func.vmap(lambda p, X: self.model.forward(p, X)[2][0],
                             in_dims=(0, None))
        preds, labels = [], []
        with torch.no_grad():
            for b, (X, Y) in enumerate(self._batches(train_ds)):
                if b >= tc.max_factor_prior_batches:
                    break
                Xw = X[:, : cfg.max_lag, :]
                preds.append(numerics.to_host(self._gather(
                    [fw(p, Xw.to(sh.device))
                     for sh, p in zip(self._shards, P)])))
                Y = Y.cpu().numpy()
                if Y.ndim == 3:
                    col = cfg.max_lag if Y.shape[2] > cfg.max_lag else 0
                    labels.append(Y[:, :, col])
                else:
                    labels.append(Y)
        preds = np.concatenate(preds, axis=1)  # (G, N, K)
        lab = np.vstack(labels)
        K = cfg.num_factors
        orders = np.stack([np.asarray(factor_alignment_order(
            preds[g], lab, K,
            unsupervised_start_index=tc.unsupervised_start_index))
            for g in range(preds.shape[0])])
        with torch.no_grad():
            for sh, params in zip(self._shards, P):
                idx = torch.as_tensor(orders[sh.lo:sh.hi], dtype=torch.long,
                                      device=sh.device)
                for leaf in tree_leaves(params["factors"]):
                    ix = idx.reshape(idx.shape + (1,) * (leaf.dim() - 2))
                    leaf.copy_(torch.gather(leaf, 1, ix.expand(leaf.shape)))
        return P

    # ------------------------------------------------------------ checkpoint
    def _checkpoint_meta(self, train_ds, val_ds):
        """The resume-compatibility fingerprint of the JAX grid: every knob
        whose change would make "resume" silently mean "train something
        else". Deliberately absent, as there: the per-call ``max_iter``
        override, the deadlines and the elastic-scheduling knobs
        (``compaction``, ``g_bucket``) — the checkpoint state carries its
        own compaction era."""
        tc = self.tc
        return {
            "points": list(self.spec.points),
            "lane_seeds": (list(int(s) for s in self.spec.lane_seeds)
                           if self.spec.lane_seeds is not None else None),
            "seed": tc.seed,
            "training_mode": self.model.config.training_mode,
            "batch_size": tc.batch_size,
            "check_every": tc.check_every,
            "lookback": tc.lookback,
            "scan_batches": tc.scan_batches,
            "stream_mode": tc.stream_mode,
            "prefetch_batches": tc.prefetch_batches,
            "max_iter": tc.max_iter,
            "matmul_precision": tc.matmul_precision,
            "precision_mode": self._precision_mode,
            "prox": {"penalty": tc.prox_penalty, "lam": tc.prox_lam},
            "numerics": (None if tc.numerics is None
                         else asdict(tc.numerics)),
            "train_data": durable_ckpt.dataset_fingerprint(train_ds),
            "val_data": durable_ckpt.dataset_fingerprint(val_ds),
        }

    def _hostify(self, state, meta):
        """The checkpoint payload: tensors as numpy copies, the per-epoch
        loss rows expanded to the original point width (a resumed fit may
        land in another era than the one that wrote a row)."""
        host = {k: numerics.to_host(v) for k, v in state.items()
                if k not in ("val_history", "val_eras", "eras",
                             "dispatch_stats")}
        # the telemetry snapshot the obs report reads (obs/report.py)
        host["dispatch_stats"] = state.get("dispatch_stats")
        rows = [numerics.to_host(v) for v in state["val_history"]]
        host["val_history"] = list(compaction.expand_history(
            rows, state["val_eras"], state["eras"], self._g_real))
        host["orig_ids"] = np.asarray(state["orig_ids"], np.int32)
        host["meta"] = meta
        return host

    def _save_checkpoint(self, checkpoint_dir, state, meta, writer=None):
        """Write the fit state durably: synchronously, or with a ``writer``
        from a host snapshot the loop's thread takes
        (``runtime/checkpoint.host_snapshot``: the tensors, which the next
        step or replay updates in place, as pinned copies behind an event;
        copies of the lists and the retired store the loop keeps growing)
        while the writer thread waits on the event, pickles and writes."""
        t0 = time.perf_counter()
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, self.CHECKPOINT_NAME)
        stats = self.dispatch_stats
        stats["ckpt_saves"] += 1
        if writer is None:
            # in a process group the state is already gathered on every
            # process; process 0 writes
            if distributed.process_index() != 0:
                return
            durable_ckpt.write_checkpoint(path, self._hostify(state, meta))
            stats["ckpt_bytes"] = os.path.getsize(path)
        else:
            snap = dict(state, val_history=list(state["val_history"]),
                        val_eras=list(state["val_eras"]),
                        eras=list(state["eras"]),
                        retired=dict(state["retired"]))
            snap, ready = durable_ckpt.host_snapshot(snap)
            meta = copy.deepcopy(meta)

            def write():
                ready()
                durable_ckpt.write_checkpoint(path,
                                              self._hostify(snap, meta))
                stats["ckpt_bytes"] = os.path.getsize(path)
            writer.submit(write)
        stats["ckpt_stall_ms"] += (time.perf_counter() - t0) * 1e3

    def _load_checkpoint(self, checkpoint_dir, want_meta):
        """``(checkpoint, source path)`` of the newest usable generation,
        or ``(None, None)`` for a fresh start. A corrupt head is
        quarantined to ``*.bad`` and ``.prev`` is tried next; a readable
        checkpoint of a different fit, or one the JAX grid wrote (its
        optimizer state is optax's), is refused with a ``ValueError``."""
        path = os.path.join(checkpoint_dir, self.CHECKPOINT_NAME)
        try:
            ckpt, src = durable_ckpt.load_checkpoint(path)
        except durable_ckpt.ForbiddenClassError as e:
            raise ValueError(
                f"{path} is not a grid checkpoint of the port (a JAX-written "
                f"one holds optax state and does not resume here); point "
                f"checkpoint_dir elsewhere") from e
        if ckpt is None:
            return None, None
        meta = ckpt.get("meta", {})
        diff = ([k for k in want_meta if meta.get(k) != want_meta[k]]
                + [k for k in meta if k not in want_meta])
        if diff:
            detail = ", ".join(
                f"{k}: saved={meta.get(k)!r} current={want_meta.get(k)!r}"
                for k in diff)
            raise ValueError(
                f"checkpoint in {checkpoint_dir!r} was written by a "
                f"different fit — resuming it would silently train something "
                f"else. Mismatched fields: {detail}. Point checkpoint_dir "
                f"elsewhere, delete the stale checkpoint, or rerun with the "
                f"original configuration.")
        return ckpt, src

    # ------------------------------------------------------------------- fit
    def fit(self, key=None, train_ds=None, val_ds=None, max_iter=None,
            log_dir=None, init_params=None, copy_init=True,
            checkpoint_dir=None, checkpoint_every=None, true_gc=None,
            on_lane_retire=None) -> GridResult:
        """Fit every lane; returns a :class:`GridResult` indexed by point.

        ``key``: the int seed of :meth:`init_grid` (the JAX package takes
        a PRNG key; ``None`` means ``train_config.seed``), unused when
        ``init_params`` (a stacked real-width ``(params, embedder Adam,
        factor Adam)`` tuple from :meth:`init_grid`, :meth:`init_grid_from`
        or ``interop.grid_state_from_jax``) is given; that state is copied
        unless ``copy_init=False`` hands it over.

        ``checkpoint_dir`` + ``checkpoint_every``: the whole fit state every
        ``checkpoint_every`` epochs (and at a deadline eviction); a fit
        pointed at a directory holding a checkpoint resumes from it
        instead of starting over, and a SIGTERM/SIGINT then writes one
        final checkpoint at the epoch boundary and raises ``Preempted``.

        ``on_lane_retire(point_id, record, epoch)``: called at a check
        window for each lane a compaction retires (early-stopped,
        quarantined or evicted: its state never changes again), with its
        ``best_params``/``best_crit``/``best_epoch``/``failed_epoch``/
        ``failed_cause``/``numerics`` record, under its original id. An
        exception in the hook is reported as a warning: results do not
        depend on it.

        ``log_dir``: the fit's ``metrics.jsonl`` (and a profiler window's
        trace, under ``profile/``) go there. ``true_gc``: the dataset's
        ground-truth graphs (a list of ``(C, C[, L])`` arrays), which add
        per-lane AUROC/AUPR to the ``quality`` events. Telemetry only:
        results are bit-identical with or without either."""
        if train_ds is None or val_ds is None:
            raise TypeError("fit needs train_ds and val_ds")
        pw = _profiling.window_for(
            self.tc, run_dir=log_dir,
            max_iter=max_iter if max_iter is not None else self.tc.max_iter,
            device=self.device)
        logger = MetricLogger(log_dir)
        # the background checkpoint writer, scoped here so every exit path
        # joins the in-flight write (a background failure re-raises on a
        # clean exit and is warned while another exception propagates)
        writer = (durable_ckpt.AsyncCheckpointWriter()
                  if checkpoint_dir is not None and self.tc.async_checkpointing
                  and self._n_proc == 1 else None)
        try:
            # the guard wraps the whole fit, so a signal during set-up is
            # latched too; the epoch loop polls it. The env-armed watchdog
            # escalates a stale heartbeat: log -> a final checkpoint
            # through the guard -> hard exit with the hang code
            with PreemptionGuard(enabled=checkpoint_dir is not None) \
                    as guard, (writer or contextlib.nullcontext()), \
                    _watchdog.maybe_start(
                        guard=guard if guard.enabled else None) as wd:
                if wd is not None:
                    wd.bind(logger=logger)
                try:
                    return self._fit(key, train_ds, val_ds, max_iter,
                                     init_params, copy_init, checkpoint_dir,
                                     checkpoint_every, on_lane_retire, guard,
                                     logger, pw, true_gc, writer)
                except (Preempted, DeadlineExceeded, remesh.HostLostError):
                    raise
                except Exception as e:
                    # a dispatch dying with a device-loss, collective-timeout
                    # or coordinator-loss signature means the mesh lost
                    # capacity, not that the fit is wrong: the typed failure
                    # makes drivers exit host_lost (21) and the supervisor
                    # re-mesh instead of restarting at the same shape
                    tag = remesh.classify_device_error(e)
                    if tag is not None:
                        raise remesh.HostLostError(tag, detail=str(e)) from e
                    raise
        finally:
            self._engines = []
            _watchdog.retire("epoch_engine")
            _watchdog.retire("batch_loop")
            # a window the epochs never closed (an early exit inside it, a
            # preemption, a deadline) announces its truncated capture
            pw.finish(logger=logger)
            logger.close()

    def _dispatch_span(self, kind, cold=False):
        """The ring-only ``grid.dispatch`` span around one step, program
        run or validation pass (host enqueue time; no sync)."""
        return _spans.span("grid.dispatch", component="dispatch", kind=kind,
                           cold=cold)

    def _fit(self, key, train_ds, val_ds, max_iter, init_params, copy_init,
             checkpoint_dir, checkpoint_every, on_lane_retire, guard, logger,
             pw, true_gc, writer=None):
        tc = self.tc
        cfg = self.model.config
        dev = self.device
        G_real = self._g_real
        max_iter = tc.max_iter if max_iter is None else max_iter
        rng = np.random.default_rng(tc.seed)
        # deadlines bound this process's spend: a resumed fit gets a fresh
        # budget
        fit_t0 = time.monotonic()
        stop_after = tc.lookback * tc.check_every
        past_at = cfg.num_pretrain_epochs + cfg.num_acclimation_epochs
        # the batch stream, resolved once per fit; multi-phase epochs step
        # per batch below (their phases interleave within each batch)
        base_stream = pipeline.choose_stream_mode(
            tc.stream_mode, train_ds, scan_batches=tc.scan_batches,
            batch_size=tc.batch_size, freeze_by_batch=self._freeze_by_batch)
        # host wall ms of the train and validation sections (enqueue time:
        # no sync is added to measure them); the epochs, their ms and each
        # width's first epoch by execution width (on the card each epoch's
        # ms covers its device work, resolved at the next check window);
        # and the CUDA graphs captured (each program's key, capture ms and
        # kernel launches per replay)
        self.dispatch_stats = stats = {
            "mode": base_stream, "epochs": 0, "train_dispatches": 0,
            "val_dispatches": 0, "train_time_ms": 0.0, "val_time_ms": 0.0,
            "epoch_ms_by_width": {}, "epochs_by_width": {},
            "first_epoch_ms_by_width": {}, "graph_captures": 0,
            "capture_ms": 0.0, "programs": [],
            "grid_width": self._g_exec0, "compactions": 0,
            "lane_epochs": 0, "lane_epochs_nominal": 0,
            "ckpt_saves": 0, "ckpt_bytes": None, "ckpt_stall_ms": 0.0,
            "ckpt_load_ms": None, "resumed_from_epoch": None,
            # telemetry, as the JAX grid's: live lanes at the last check
            # window, the prefetch counters of obs.counters, the predicted
            # footprint and measured peak (obs/memory.py), the quality
            # monitor's rolling snapshot (obs/quality.py)
            "lanes_live": None, "prefetch_stall_ms": 0.0,
            "prefetch_items": 0, "ckpt_barrier_stall_ms": 0.0,
            "memory": None, "quality": None,
            # the cost model's scoring (obs/costmodel.py): the remaining
            # fit's ETA and the running residual summary, refreshed at each
            # check window that resolves an epoch
            "eta": None, "cost_model": None,
            # per precision era, from its first epoch: the bf16 factor-mix
            # kernel's executions (ops/factor_mix.py graph_mix_bf16), so a
            # demoted fit shows none after the demotion
            "precision_eras": [],
            # the port's: each lane shard's kernel executions (its steps,
            # replays, capture warm-ups and validation passes), by mesh
            # index; an unmeshed fit is shard "0"
            "launches_by_shard": {}}
        ckpt = ck_meta = ck_src = None
        if checkpoint_dir is not None:
            t0 = time.perf_counter()
            ck_meta = self._checkpoint_meta(train_ds, val_ds)
            ckpt, ck_src = self._load_checkpoint(checkpoint_dir, ck_meta)
            if ckpt is not None:
                stats["ckpt_load_ms"] = (time.perf_counter() - t0) * 1e3
        remesh_info = None
        if ckpt is not None:
            # resume at the checkpoint's own era and width
            orig_ids = np.asarray(ckpt["orig_ids"], np.int32)
            retired = dict(ckpt["retired"])
            # elastic re-meshing (parallel/remesh.py): a checkpoint written
            # on another device count, or whose width cannot shard over the
            # mesh visible now, re-shards its lanes onto this mesh on the
            # host before any tensor exists: survivors ride the bucket
            # ladder at the new device count, frozen lanes retire to the
            # host store, results keep their original point ids
            n_dev = self._mesh_full.size if self._mesh_full is not None \
                else 1
            ck_mesh = ckpt.get("mesh") or {}
            mesh_changed = (ck_mesh.get("n_devices") is not None
                            and int(ck_mesh["n_devices"]) != n_dev)
            incompatible = (self._mesh_full is not None
                            and not remesh.width_fits(orig_ids.size, n_dev))
            if mesh_changed or incompatible:
                t_plan = time.perf_counter()
                with _spans.span("grid.remesh", component="remesh",
                                 from_width=int(orig_ids.size),
                                 to_devices=n_dev):
                    plan = remesh.plan_resharding(
                        np.asarray(ckpt["active"], bool), orig_ids,
                        retired.keys(), n_dev,
                        compact=self.policy.compaction)
                    if plan is not None:
                        migrated = remesh.apply_reshard(ckpt, retired, plan)
                        remesh_info = {
                            "from_width": int(orig_ids.size),
                            "to_width": int(plan.new_width),
                            "from_devices": ck_mesh.get("n_devices"),
                            "to_devices": n_dev, "lanes_migrated": migrated,
                            "lanes_retired": [int(p)
                                              for p in plan.retire_ids],
                            "plan_ms": round(
                                (time.perf_counter() - t_plan) * 1e3, 3)}
                        orig_ids = np.asarray(plan.orig_ids, np.int32)
            to_dev = lambda t: numerics.to_torch(t, dev)  # noqa: E731
            params, optA, optB = (to_dev(ckpt[k]) for k in (
                "params", "optA_state", "optB_state"))
            best_params = to_dev(ckpt["best_params"])
            accepted = (to_dev(ckpt["accepted"])
                        if ckpt["accepted"] is not None else None)
            best_crit, best_epoch, active, failed_epoch, failed_cause = (
                to_dev(ckpt[k]) for k in ("best_crit", "best_epoch",
                                          "active", "failed_epoch",
                                          "failed_cause"))
            nstate = to_dev(ckpt["nstate"])
            # checkpointed rows are already expanded to the original width
            val_history = list(ckpt["val_history"])
            val_eras = [-1] * len(val_history)
            aligned = ckpt["aligned"]
            rng.bit_generator.state = ckpt["rng_state"]
            start_it = ckpt["epoch"] + 1
            stats["resumed_from_epoch"] = ckpt["epoch"]
            if ckpt.get("precision_demoted") and self._demotable \
                    and not self._demoted:
                # the checkpointed fit demoted mixed -> f32: the resume
                # runs at f32 from its first step (never re-promotes)
                self._demote_to_f32()
        else:
            if init_params is not None:
                def own(x):
                    x = torch.as_tensor(x).to(dev)
                    return x.detach().clone() if copy_init else x
                state = tree_map(own, tuple(init_params))
            else:
                state = self.init_grid(tc.seed if key is None else key)
            params, optA, optB = self.pad_to_width(state)
            orig_ids = self._orig_ids0.copy()
            retired = {}
            Gx = orig_ids.size
            best_crit = torch.full((Gx,), float("inf"), device=dev)
            best_epoch = torch.zeros((Gx,), dtype=torch.int32, device=dev)
            best_params = _clone(params)
            accepted = _clone(params) if self._freeze else None
            # filler lanes are born inactive
            active = torch.from_numpy(orig_ids >= 0).to(dev)
            failed_epoch = torch.full((Gx,), -1, dtype=torch.int32,
                                      device=dev)
            failed_cause = torch.zeros((Gx,), dtype=torch.int32, device=dev)
            nstate = numerics.init_numerics_state(lanes=Gx, device=dev)
            val_history, val_eras = [], []
            aligned = False
            start_it = 0
        Gx = int(orig_ids.size)
        width_nominal = Gx
        eras, era_cur = [orig_ids], 0
        stats["remeshes"] = 1 if remesh_info else 0
        stats["remesh"] = remesh_info
        # the era's lanes, split over the mesh: each shard holds its lanes'
        # params, both Adam states, numerics counters, best and accepted
        # params on its device; the per-lane decision vectors stay whole
        # on the first device
        self._set_era(orig_ids)
        P, A, B, N, BP = (self._split(t) for t in (
            params, optA, optB, nstate, best_params))
        ACC = self._split(accepted) if accepted is not None else None
        del params, optA, optB, nstate, best_params, accepted
        self._engines = engines = self._new_engines(base_stream, train_ds,
                                                    val_ds, stats)
        # the full-capacity mesh's shape, in every checkpoint and in
        # fit_start (audit metadata, not the resume fingerprint)
        mesh_desc = remesh.mesh_shape(self._mesh_full)
        stats["grid_width"] = Gx
        # per-execution-lane deadlines, remapped per era; dl_done keeps the
        # per-epoch check a host compare
        lane_deadline = self._exec_deadlines(orig_ids)
        dl_done = np.zeros((Gx,), dtype=bool)
        # the cosine window: the first validation batch's slice, once
        cos_Xw = None
        if self._cos is not None:
            first = next(iter(self._batches(val_ds)), None)
            if first is not None:
                cos_Xw = first[0][: tc.max_samples_for_gc_tracking,
                                  : cfg.max_lag, :]
        # the quality observatory (obs/quality.py): per-lane graph
        # summaries at check windows, one vmapped readout of the params
        # (nothing else is read or written); none with REDCLIFF_QUALITY=0
        qmon = qual_fn = qual_Xw = None
        if _quality.enabled():
            qual_Xw = cos_Xw
            if qual_Xw is None:
                qfirst = next(iter(self._batches(val_ds)), None)
                if qfirst is not None:
                    qual_Xw = qfirst[0][: tc.max_samples_for_gc_tracking,
                                        : cfg.max_lag, :]
            if qual_Xw is not None:
                qual_fn = torch.func.vmap(
                    _quality.make_summary_fn(self.model), in_dims=(0, None))
                qmon = _quality.QualityMonitor(
                    true_gc=true_gc, mode=_quality.readout_mode(cfg))
        counters_t0 = _spans.COUNTERS.snapshot()
        compile_t0 = compileobs.snapshot()
        # the learned cost model (obs/costmodel.py), loaded once per fit:
        # its predictions are scored against the resolved epochs at each
        # check window, and this fit's epochs fold into it at the end
        cm_base = self._cost_model_base()
        cm_platform = _costmodel.platform_label(dev)
        cost_model = _costmodel.load(cm_base) if cm_base else None
        cm_shape_key = self._shape_key()
        # the precision half of the cost bucket: bf16 and f32 epochs are
        # different costs; a demoted fit folds and predicts under "f32"
        cm_precision0 = self._precision_label0()
        cm_n = 0          # residual samples scored this fit
        cm_abs_pct = 0.0  # running sum of |residual_pct|
        # epochs whose ms is not resolved yet: on the card a CUDA event
        # pair around each epoch, read at the next check window (the host
        # syncs there anyway) so the folded ms covers the device work
        ev_timing = dev.type == "cuda"
        pending = []
        # each width's first FOLDED epoch when it is also the width's first
        # epoch (the compile/cache skew JAX leaves out; on the card the
        # first epoch captures and is not folded at all), and the same per
        # precision era for the store fold: the first epoch after a
        # demotion carries the f32 rebuild, as JAX's demote_first_f32
        fold_first = {}
        eras_acc = {}
        # the compile accumulators at a mid-fit demotion (split as JAX
        # splits them: the f32 recaptures belong to the f32 era)
        demote_compile = None

        def fold(acc, key, ms):
            acc["epoch_ms_by_width"][key] = (
                acc["epoch_ms_by_width"].get(key, 0.0) + ms)
            acc["epochs_by_width"][key] = (
                acc["epochs_by_width"].get(key, 0) + 1)

        def resolve(wait=False):
            """Fold the pending epochs whose end event has run into the
            per-width accumulators, leaving out the epochs that captured a
            CUDA graph; returns the last one folded."""
            last = None
            while pending:
                p_it, p_w, p_ms, ev0, ev1, p_caps, p_prec = pending[0]
                if ev1 is not None:
                    if wait:
                        ev1.synchronize()
                    elif not ev1.query():
                        break
                    p_ms = max(p_ms, ev0.elapsed_time(ev1))
                pending.pop(0)
                key = str(p_w)
                first = key not in stats["first_epoch_ms_by_width"]
                stats["first_epoch_ms_by_width"].setdefault(key, p_ms)
                era = eras_acc.setdefault(p_prec, {
                    "epochs_by_width": {}, "epoch_ms_by_width": {},
                    "first_epoch_ms_by_width": {}, "seen": set()})
                era_first = key not in era["seen"]
                era["seen"].add(key)
                if p_caps:
                    # a capture epoch: its cost is the capture's, which the
                    # compile accumulators carry; not a steady-state epoch
                    continue
                if first:
                    fold_first[key] = p_ms
                if era_first:
                    era["first_epoch_ms_by_width"][key] = p_ms
                fold(stats, key, p_ms)
                fold(era, key, p_ms)
                last = (p_it, p_w, p_ms)
            return last

        logger.log("fit_start", model="RedcliffGridRunner", grid_size=G_real,
                   grid_width=Gx, lanes_padded=int((orig_ids < 0).sum()),
                   training_mode=cfg.training_mode,
                   shape=_schema.shape_desc(cfg), max_iter=max_iter,
                   stream_mode=base_stream, mesh=mesh_desc,
                   compile_cache_dir=self._compile_cache_dir,
                   resumed_from_epoch=start_it - 1 if ckpt else None,
                   resumed_from=ck_src,
                   precision_mode=(self.spec.precision_mode
                                   or tc.precision_mode),
                   points=list(self.spec.points))
        # the launch-plan searches/lookups of the constructor
        for atrec in _autotune.drain_records():
            logger.log("autotune", **atrec)
        # the predictive policy's initial-width decision
        if self._policy_init_decision:
            logger.log("policy", epoch=start_it - 1, grid_width=Gx,
                       **self._policy_init_decision)
            self._policy_init_decision = None
        if self._demoted and start_it > 0:
            logger.log("precision", kind="resume_demoted",
                       epoch=start_it - 1, mode_from="mixed",
                       mode_to="f32", grid_width=Gx)
        if remesh_info is not None:
            # which mesh the checkpoint came from, which it landed on, how
            # many lanes migrated, the plan's latency
            logger.log("remesh", epoch=start_it - 1, **remesh_info)
        bf16_t0 = _factor_mix.graph_mix_bf16.launches
        stats["precision_eras"].append({
            "precision": "f32" if self._demoted else cm_precision0,
            "from_epoch": start_it, "bf16_launches": 0})
        # the predicted footprint of this fit's width, from shapes only,
        # and the headroom verdict on its device
        mem_poll = _obsmem.polling_enabled()
        mem_pred = _obsmem.grid_footprint(
            self.model, tc, Gx, train_ds=train_ds, val_ds=val_ds,
            stream_mode=base_stream, freeze=self._freeze)
        # the headroom over every distinct device of the mesh (entries that
        # name one card share its memory)
        mem_devices = list(dict.fromkeys(
            self._mesh_full.devices if self._mesh_full is not None
            else [dev]))
        headroom = _obsmem.check_headroom(mem_pred["total_bytes"],
                                          devices=mem_devices,
                                          n_devices=len(mem_devices))
        stats["memory"] = {
            "predicted_bytes": mem_pred["total_bytes"],
            "per_lane_bytes": mem_pred["per_lane_bytes"],
            "g_bucket": Gx, "peak_bytes": None,
            "bytes_limit": headroom["bytes_limit"],
            "fits": headroom["fits"], "polls": 0}
        logger.log(
            "memory", kind="predicted", epoch=start_it - 1,
            g_bucket=Gx, grid_width=Gx,
            predicted_bytes=mem_pred["total_bytes"],
            params_bytes=mem_pred["params_bytes"],
            opt_bytes=mem_pred["opt_bytes"],
            best_bytes=mem_pred["best_bytes"],
            per_lane_bytes=mem_pred["per_lane_bytes"],
            dataset_bytes=mem_pred["dataset_bytes"],
            epoch_gather_bytes=mem_pred["epoch_gather_bytes"],
            fits=headroom["fits"], bytes_limit=headroom["bytes_limit"],
            budget_bytes=headroom["budget_bytes"],
            headroom_bytes=headroom["headroom_bytes"],
            backend=headroom["backend"], n_devices=len(mem_devices))
        # the fault points' step index on the per-batch path, as JAX's
        fi_step = 0
        epochs = []
        for it in range(start_it, max_iter):
            # the epoch loop's heartbeat, one stamp per epoch (a capture
            # inside the epoch runs under the op-scoped `compile` beat)
            _watchdog.stamp("epoch_engine")
            pw.on_epoch_start(it)
            epoch_compile_t0 = compileobs.snapshot()
            epoch_caps0 = stats["graph_captures"]
            launches0 = copy.deepcopy(stats["launches_by_shard"])
            epoch_prec = "f32" if self._demoted else cm_precision0
            t_epoch0 = time.perf_counter()
            ev0 = None
            if ev_timing:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            epoch_width = Gx
            if (not aligned and "pretrain_factor" in cfg.training_mode
                    and it == cfg.num_pretrain_epochs
                    and cfg.num_supervised_factors > 0):
                P = self._align_all_points(P, train_ds)
                aligned = True
            phases = self.phase_for_epoch(it)
            # per-epoch skip baseline for quarantine-cause attribution
            epoch_skip_base = self._gather(
                [n["skipped"] for n in N]).clone()
            mode = base_stream if len(phases) == 1 else "per_batch"
            # each shard's lanes of the gate, read by its steps
            acts = self._split_vec(active)
            if mode == "per_batch":
                for X, Y in self._batches(train_ds, rng=rng):
                    _watchdog.stamp("batch_loop")
                    # the step fault points ride the per-batch path only
                    # (the scanned modes take device-resident batches)
                    X = faultinject.poison_batch(X, fi_step)
                    skip = faultinject.skip_update(fi_step)
                    fi_step += 1
                    if skip:
                        continue
                    for phase in phases:
                        # every shard's step, in mesh order, before any
                        # read back
                        for j, sh in enumerate(self._shards):
                            with self._dispatch_span("step"):
                                _engines.counted(
                                    stats, sh.index,
                                    lambda: sh._step(
                                        phase, P[j], A[j], B[j], N[j],
                                        acts[j],
                                        *_engines._on(sh.device, X, Y)))
                            stats["train_dispatches"] += 1
                    if self._freeze_by_batch:
                        for j in range(len(P)):
                            P[j], ACC[j] = self._freeze_step(P[j], ACC[j])
                _watchdog.retire("batch_loop")
            else:
                # the first shard's engine drives the others (``peers``,
                # given only when there are others) on its batch plan
                peers = [(engines[j], (P[j], A[j], B[j], N[j]), acts[j])
                         for j in range(1, len(P))]
                engines[0].train_epoch(
                    mode, phases[0], (P[0], A[0], B[0], N[0]), acts[0],
                    train_ds, rng, **({"peers": peers} if peers else {}))
            t_val0 = time.perf_counter()
            stats["train_time_ms"] += (t_val0 - t_epoch0) * 1e3
            # validation: ordered per-batch sums from zero, per shard, then
            # gathered into whole per-lane vectors
            sums, n = _engines.validate(engines, P, val_ds)
            combo_sum, forecast_sum, factor_sum = (
                self._gather([t[i] for t in sums]) for i in range(3))
            stats["val_time_ms"] += (time.perf_counter() - t_val0) * 1e3
            if n == 0:
                raise ValueError(
                    "validation dataset yielded no batches — increase "
                    "val_fraction or dataset size")
            val_now = combo_sum / n
            val_history.append(val_now)
            val_eras.append(era_cur)
            # quarantine: a non-finite validation loss, or a guard streak of
            # max_consecutive_skips; the cause is nonfinite_grad when this
            # epoch skipped steps, else nonfinite_val
            bad = ~torch.isfinite(val_now)
            if self._guard:
                consecutive = self._gather([n["consecutive"] for n in N])
                bad = bad | (consecutive >= self._numerics_k)
                grad_implicated = (self._gather([n["skipped"] for n in N])
                                   - epoch_skip_base) > 0
            else:
                grad_implicated = torch.zeros_like(active)
            if self._demotable and not self._demoted:
                # the precision-cliff watch (mixed fits only; one host read
                # an epoch): a lane stuck on a skip storm in an epoch that
                # skipped blames bf16 before the lane. The whole grid
                # demotes to f32 and the stuck lanes get one f32 epoch
                # before quarantine can judge them again; a lane that
                # storms on at f32 quarantines within max_consecutive_skips
                # further epochs. A validation blow-up with finite steps
                # quarantines as usual: it carries no bf16 evidence
                hit = (active & grad_implicated
                       & (consecutive >= self._numerics_k)
                       ).cpu().numpy()
                if hit.any():
                    nhost = numerics.numerics_summary(
                        numerics.to_host(self._gather(N)))
                    self._demote_to_f32()
                    for nst in N:
                        nst["consecutive"].zero_()
                    demote_compile = compileobs.delta(compile_t0)
                    era = stats["precision_eras"][-1]
                    era["bf16_launches"] = (
                        _factor_mix.graph_mix_bf16.launches - bf16_t0)
                    bf16_t0 = _factor_mix.graph_mix_bf16.launches
                    stats["precision_eras"].append({
                        "precision": "f32", "from_epoch": it + 1,
                        "bf16_launches": 0})
                    logger.log(
                        "precision", kind="demote", epoch=it,
                        cause="precision_cliff", mode_from="mixed",
                        mode_to="f32", grid_width=Gx,
                        lanes=[int(orig_ids[g])
                               for g in np.flatnonzero(hit)],
                        skipped=nhost["skipped"],
                        consecutive=nhost["consecutive"])
                    bad = torch.zeros_like(bad)
                    grad_implicated = torch.zeros_like(active)
            newly_failed = active & bad
            failed_epoch = torch.where(newly_failed,
                                       torch.full_like(failed_epoch, it),
                                       failed_epoch)
            failed_cause = torch.where(
                newly_failed,
                torch.where(grad_implicated,
                            torch.full_like(failed_cause,
                                            numerics.CAUSE_NONFINITE_GRAD),
                            torch.full_like(failed_cause,
                                            numerics.CAUSE_NONFINITE_VAL)),
                failed_cause)
            active = active & ~bad
            c = self._ex_coeffs
            if it >= past_at:
                # per-point stopping criteria: stopping coefficients x
                # coefficient-normalized val means, plus the supervised
                # pairwise-cosine term
                crit = c["stopping_criteria_forecast_coeff"] \
                    * (forecast_sum / n)
                if cfg.num_supervised_factors >= 1:
                    crit = crit + c["stopping_criteria_factor_coeff"] \
                        * (factor_sum / n)
                if self._cos is not None:
                    with torch.no_grad():
                        cos = self._gather([
                            self._cos(p, cos_Xw.to(sh.device))
                            for sh, p in zip(self._shards, P)])
                        crit = crit + c["stopping_criteria_cosSim_coeff"] \
                            * cos
                better = crit < best_crit
                if self._freeze:
                    if not self._freeze_by_batch:
                        for j in range(len(P)):
                            P[j], ACC[j] = self._freeze_step(P[j], ACC[j])
                    best_crit, best_epoch = self._select_best(
                        best_crit, best_epoch, crit, better, it)
                    BP = [_clone(acc) for acc in ACC]
                else:
                    best_crit, best_epoch = self._select_best(
                        best_crit, best_epoch, crit, better, it)
                    BP = [_where(b, p, bp) for b, p, bp in zip(
                        self._split_vec(better), P, BP)]
                # lookback early stop: no improvement for
                # lookback*check_every epochs freezes the lane
                active = active & ((it - best_epoch) < stop_after)
            else:
                # pretrain/acclimation epochs track the live params as best
                # for healthy lanes; a quarantined lane keeps its last
                # finite snapshot
                BP = [_where(a, p, bp) for a, p, bp in zip(
                    self._split_vec(active), P, BP)]
                best_epoch = torch.where(active,
                                         torch.full_like(best_epoch, it),
                                         best_epoch)

            # wall-clock deadlines, after this epoch's bookkeeping: an
            # evicted lane keeps what it earned through this epoch and
            # freezes from the next one, siblings untouched
            force_ckpt = False
            elapsed = None
            if lane_deadline is not None or self.spec.grid_deadline_s:
                elapsed = time.monotonic() - fit_t0
            over = self.policy.lane_evictions(lane_deadline, dl_done,
                                              elapsed)
            if over is not None and over.any():
                dl_done |= over
                dl_bad = torch.from_numpy(over).to(dev)
                newly_dl = active & dl_bad
                n_evict = int(newly_dl.sum())
                if n_evict:
                    failed_epoch = torch.where(
                        newly_dl, torch.full_like(failed_epoch, it),
                        failed_epoch)
                    failed_cause = torch.where(
                        newly_dl, torch.full_like(failed_cause,
                                                  numerics.CAUSE_DEADLINE),
                        failed_cause)
                    active = active & ~dl_bad
                    # the evicted lanes' state must land durably
                    force_ckpt = True
                    # original point ids, not execution rows
                    logger.log("deadline_evicted", epoch=it,
                               elapsed_s=round(elapsed, 3),
                               lanes=[int(orig_ids[g])
                                      for g in np.flatnonzero(over)],
                               num_evicted=n_evict)
            grid_dl_hit = self.policy.grid_deadline_hit(
                self.spec.grid_deadline_s, elapsed)

            stop = False
            plan = None
            if it % tc.check_every == 0:
                # the one host read of the loop, on the check cadence: the
                # epoch record, the quality readout, the early exit once
                # every lane has stopped, and the compaction decision
                with _spans.span("grid.check_window",
                                 component="check_window", logger=logger,
                                 emit=True, epoch=it, width=Gx):
                    act_host = active.cpu().numpy()
                    stats["lanes_live"] = int(act_host.sum())
                    if logger.active:
                        host = numerics.to_host({
                            "val": val_now, "best": best_crit,
                            "failed": failed_epoch,
                            "skipped": self._gather(
                                [n["skipped"] for n in N])})
                        logger.log(
                            "epoch", epoch=it, phases=list(phases),
                            val_combo_loss=host["val"],
                            best_criteria=host["best"],
                            num_active=int(act_host.sum()),
                            lanes_live=stats["lanes_live"], grid_width=Gx,
                            lanes_padded=int((orig_ids < 0).sum()),
                            num_quarantined=int((host["failed"] >= 0).sum()),
                            guarded_steps_skipped=int(host["skipped"].sum()),
                            epoch_ms=round(
                                (time.perf_counter() - t_epoch0) * 1e3, 3))
                    if qmon is not None:
                        with torch.no_grad(), self._dispatch_span("quality"):
                            qdev = self._gather([
                                qual_fn(p, qual_Xw.to(sh.device))
                                for sh, p in zip(self._shards, P)])
                        # the (G, K, C, C) graphs are read only to score
                        # them against the truth
                        qhost = {k: v.cpu().numpy() for k, v in qdev.items()
                                 if qmon.true_gc is not None or k != "gc"}
                        qrec = qmon.update(it, qhost, orig_ids)
                        stats["quality"] = qmon.snapshot()
                        if logger.active:
                            logger.log("quality", grid_width=Gx, **qrec)
                # the measured watermark (allocator counters; none on the
                # CPU)
                if mem_poll:
                    wm = _obsmem.poll_watermark(mem_devices)
                    if wm is not None:
                        sm = stats["memory"]
                        sm["polls"] += 1
                        sm["peak_bytes"] = max(sm["peak_bytes"] or 0,
                                               wm["peak_bytes"])
                        logger.log("memory", kind="measured", epoch=it,
                                   grid_width=Gx,
                                   bytes_in_use=wm["bytes_in_use"],
                                   peak_bytes=wm["peak_bytes"],
                                   bytes_limit=wm["bytes_limit"],
                                   n_devices=wm["n_devices"],
                                   device_kind=wm["device_kind"])
                # the cost model's scoring (obs/costmodel.py): the last
                # epoch resolved in this window against the prediction that
                # existed before it ran — the store's at its width, else
                # the fit's own mean there. A width's first epoch is never
                # scored (it carries the captures the model learns apart)
                scored = resolve()
                if scored is not None:
                    s_it, s_w, s_ms = scored
                    skey = str(s_w)
                    pred_ms = cm_src = None
                    n_w = stats["epochs_by_width"].get(skey, 0)
                    # a width's first epoch is never scored: folded, it is
                    # the cache-priming one; on the card it captured and
                    # is not folded
                    steady = n_w > (1 if skey in fold_first else 0)
                    if steady and cost_model is not None:
                        pred_ms = cost_model.predict_epoch_ms(
                            cm_shape_key, s_w, platform=cm_platform,
                            precision=("f32" if self._demoted
                                       else cm_precision0))
                        if pred_ms is not None:
                            cm_src = "store"
                    if pred_ms is None:
                        tot_prior = stats["epoch_ms_by_width"][skey] - s_ms
                        n_prior = n_w - 1
                        first = fold_first.get(skey)
                        if first is not None and n_prior >= 1:
                            tot_prior -= first
                            n_prior -= 1
                        if n_prior > 0 and tot_prior > 0:
                            pred_ms = tot_prior / n_prior
                            cm_src = "observed"
                    if pred_ms is not None and pred_ms > 0:
                        residual_pct = 100.0 * (s_ms - pred_ms) / pred_ms
                        cm_n += 1
                        cm_abs_pct += abs(residual_pct)
                        epochs_remaining = max(max_iter - it - 1, 0)
                        eta_s = epochs_remaining * pred_ms / 1e3
                        stats["eta"] = {
                            "epoch": s_it,
                            "predicted_epoch_ms": round(pred_ms, 3),
                            "epochs_remaining": epochs_remaining,
                            "eta_s": round(eta_s, 3), "source": cm_src}
                        stats["cost_model"] = {
                            "samples": cm_n,
                            "mape_pct": round(cm_abs_pct / cm_n, 2),
                            "source": cm_src}
                        logger.log(
                            "cost_model", epoch=s_it, grid_width=s_w,
                            predicted_epoch_ms=round(pred_ms, 3),
                            actual_epoch_ms=round(s_ms, 3),
                            residual_pct=round(residual_pct, 2),
                            source=cm_src, eta_s=round(eta_s, 3),
                            epochs_remaining=epochs_remaining,
                            samples=cm_n,
                            mape_pct=stats["cost_model"]["mape_pct"])
                stop = it >= past_at and not act_host.any()
                if stop:
                    logger.log("early_exit_all_inactive", epoch=it)
                else:
                    plan = self.policy.compaction_plan(
                        act_host, orig_ids, retired.keys(),
                        self._mesh_full.size
                        if self._mesh_full is not None else 1,
                        n_processes=self._n_proc,
                        epochs_remaining=max(max_iter - it - 1, 0))
                    # the predictive policy's pricing of this window's
                    # ladder move (compact / hold / fallback)
                    pol_dec = (self.policy.take_decision()
                               if hasattr(self.policy, "take_decision")
                               else None)
                    if pol_dec is not None:
                        logger.log("policy", epoch=it, grid_width=Gx,
                                   **pol_dec)
            epoch_ms = (time.perf_counter() - t_epoch0) * 1e3
            ev1 = None
            if ev_timing:
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record()
            pending.append((it, epoch_width, epoch_ms, ev0, ev1,
                            stats["graph_captures"] - epoch_caps0,
                            epoch_prec))
            epochs.append({
                "epoch": it, "phases": list(phases), "width": epoch_width,
                "ms": epoch_ms, "mode": mode,
                # each shard's kernel executions in this epoch
                "launches_by_shard": {
                    sh: {k: n - launches0.get(sh, {}).get(k, 0)
                         for k, n in by.items()}
                    for sh, by in stats["launches_by_shard"].items()}})
            stats["epochs"] += 1
            stats["lane_epochs"] += epoch_width
            stats["lane_epochs_nominal"] += width_nominal
            if stop:
                break
            if plan is not None:
                t_comp = time.perf_counter()
                # retire the frozen lanes' results to the host before
                # their rows are dropped
                # the survivors are gathered whole, their rows taken and
                # re-split over the new width's mesh below
                best_params, nstate = self._gather(BP), self._gather(N)
                if plan.retire_rows.size:
                    rows = torch.as_tensor(plan.retire_rows,
                                           dtype=torch.long, device=dev)
                    frozen = numerics.to_host({
                        "best_params": _take(best_params, rows),
                        "best_crit": best_crit[rows],
                        "best_epoch": best_epoch[rows],
                        "failed_epoch": failed_epoch[rows],
                        "failed_cause": failed_cause[rows],
                        "numerics": _take(nstate, rows)})
                    for i, pid in enumerate(plan.retire_ids):
                        retired[int(pid)] = {
                            "best_params": tree_map(
                                lambda leaf, _i=i: leaf[_i].copy(),
                                frozen["best_params"]),
                            "best_crit": float(frozen["best_crit"][i]),
                            "best_epoch": int(frozen["best_epoch"][i]),
                            "failed_epoch": int(frozen["failed_epoch"][i]),
                            "failed_cause": int(frozen["failed_cause"][i]),
                            "numerics": {k: v[i].item() for k, v
                                         in frozen["numerics"].items()}}
                    if on_lane_retire is not None:
                        for pid in plan.retire_ids:
                            # the hook is advisory: a failing one is
                            # reported and the fit goes on unchanged
                            try:
                                on_lane_retire(int(pid), retired[int(pid)],
                                               it)
                            except Exception as e:  # noqa: BLE001
                                warnings.warn(
                                    f"on_lane_retire failed for point "
                                    f"{int(pid)} at epoch {it}: {e!r}",
                                    RuntimeWarning)
                old_width = Gx
                sel = torch.as_tensor(plan.sel, dtype=torch.long, device=dev)
                params, optA, optB, nstate, best_params = (
                    _take(t, sel) for t in (self._gather(P), self._gather(A),
                                            self._gather(B), nstate,
                                            best_params))
                accepted = (_take(self._gather(ACC), sel)
                            if ACC is not None else None)
                best_crit, best_epoch, failed_epoch, failed_cause = (
                    t.index_select(0, sel) for t in (
                        best_crit, best_epoch, failed_epoch, failed_cause))
                active = torch.from_numpy(plan.active).to(dev)
                orig_ids = plan.orig_ids
                Gx = plan.new_width
                self._set_era(orig_ids)
                P, A, B, N, BP = (self._split(t) for t in (
                    params, optA, optB, nstate, best_params))
                ACC = (self._split(accepted) if accepted is not None
                       else None)
                del params, optA, optB, nstate, best_params, accepted
                self._engines = engines = self._new_engines(
                    base_stream, train_ds, val_ds, stats, old=engines)
                lane_deadline = self._exec_deadlines(orig_ids)
                dl_done = dl_done[plan.sel]
                eras.append(orig_ids)
                era_cur += 1
                stats["compactions"] += 1
                stats["grid_width"] = Gx
                logger.log("compaction", epoch=it, from_width=old_width,
                           to_width=Gx, lanes_live=stats["lanes_live"],
                           retired=[int(p) for p in plan.retire_ids],
                           mesh_devices=(self.mesh.size
                                         if self.mesh is not None else None))
                _spans.record_span(
                    "grid.compaction", (time.perf_counter() - t_comp) * 1e3,
                    component="compaction", logger=logger, emit=True,
                    epoch=it, from_width=old_width, to_width=Gx)

            if checkpoint_dir is not None:
                due = ((checkpoint_every and (it + 1) % checkpoint_every == 0)
                       or force_ckpt or grid_dl_hit or guard.preempted)
                if due:
                    t_save = time.perf_counter()
                    self._save_checkpoint(checkpoint_dir, {
                        "params": self._gather(P),
                        "optA_state": self._gather(A),
                        "optB_state": self._gather(B),
                        "best_params": self._gather(BP),
                        "best_crit": best_crit, "best_epoch": best_epoch,
                        "active": active,
                        "accepted": (self._gather(ACC) if ACC is not None
                                     else None),
                        "failed_epoch": failed_epoch,
                        "failed_cause": failed_cause,
                        "nstate": self._gather(N),
                        # the mesh shape this attempt ran on: audit only,
                        # not part of the resume fingerprint
                        "mesh": mesh_desc,
                        "val_history": val_history, "val_eras": val_eras,
                        "eras": eras, "orig_ids": orig_ids,
                        "retired": retired, "aligned": aligned,
                        "rng_state": rng.bit_generator.state, "epoch": it,
                        "precision_demoted": self._demoted,
                        # a copy: the live dict keeps changing under an
                        # asynchronous writer
                        "dispatch_stats": copy.deepcopy(stats),
                    }, ck_meta, writer=writer)
                    # the loop thread's stall: the whole write, or the
                    # snapshot hand-off to the writer (ring-only)
                    _spans.record_span(
                        "grid.ckpt_save",
                        (time.perf_counter() - t_save) * 1e3,
                        component="ckpt", epoch=it,
                        background=writer is not None)
                    if writer is not None and faultinject.armed():
                        # "checkpoint_saved" means durably on disk before
                        # the crash point fires
                        writer.wait()
                    faultinject.crash_point("checkpoint_saved", epoch=it)
                if guard.preempted:
                    if writer is not None:
                        # the final checkpoint is durable before Preempted
                        writer.wait()
                    logger.log("preempted_final_checkpoint", epoch=it,
                               signum=guard.signum)
                    raise Preempted(guard.signum, epoch=it)
            if grid_dl_hit:
                if writer is not None:
                    writer.wait()
                logger.log("grid_deadline_final_checkpoint", epoch=it,
                           elapsed_s=round(elapsed, 3),
                           deadline_s=float(self.spec.grid_deadline_s),
                           checkpointed=checkpoint_dir is not None)
                raise DeadlineExceeded(
                    "grid", epoch=it, elapsed_s=elapsed,
                    deadline_s=float(self.spec.grid_deadline_s))
            # the CUDA graphs this epoch captured (runtime/compileobs.py)
            dc = compileobs.delta(epoch_compile_t0)
            if dc["compiles"]:
                logger.log("compile", epoch=it, programs=dc["compiles"],
                           compile_ms=dc["compile_ms"], grid_width=Gx)
            pw.on_epoch_end(it, logger=logger)
            faultinject.crash_point("epoch_end", epoch=it)

        _watchdog.retire("epoch_engine")
        if writer is not None:
            # completion barrier: a background failure surfaces here and
            # the last generation is durable before results return
            writer.wait()
        resolve(wait=True)
        stats["precision_eras"][-1]["bf16_launches"] = (
            _factor_mix.graph_mix_bf16.launches - bf16_t0)
        # the folded epochs per precision era, for the obs report's cost
        # rows (labelled when an era is not f32)
        stats["cost_eras"] = {
            label: {k: dict(era[k]) for k in ("epochs_by_width",
                                              "epoch_ms_by_width")}
            for label, era in eras_acc.items()}
        # a last watermark sample, so fits shorter than a check window
        # still record a measured peak on a card
        if mem_poll:
            wm = _obsmem.poll_watermark(mem_devices)
            if wm is not None:
                stats["memory"]["polls"] += 1
                stats["memory"]["peak_bytes"] = max(
                    stats["memory"]["peak_bytes"] or 0, wm["peak_bytes"])
        stats.update(compileobs.delta(compile_t0))
        cdelta = _spans.COUNTERS.delta(counters_t0)
        stats["prefetch_stall_ms"] = cdelta.get("prefetch_stall_ms", 0.0)
        stats["prefetch_items"] = int(cdelta.get("prefetch_items", 0))
        stats["ckpt_barrier_stall_ms"] = cdelta.get("ckpt_barrier_stall_ms",
                                                    0.0)
        # fold this fit's per-width epochs and captures into the persistent
        # store (advisory: a store failure never fails the fit)
        if cm_base:
            try:
                # one fold per precision era, the compile accumulators
                # split at a mid-fit demotion
                compile_keys = ("compiles", "compile_ms", "cache_hits",
                                "cache_misses")
                rows = []
                for label, era in eras_acc.items():
                    part = {k: stats.get(k, 0) for k in compile_keys}
                    if demote_compile is not None:
                        part = ({k: demote_compile.get(k, 0)
                                 for k in compile_keys}
                                if label != "f32" else
                                {k: stats.get(k, 0) - demote_compile.get(k, 0)
                                 for k in compile_keys})
                    rows += _costmodel.rows_from_dispatch_stats(
                        cm_shape_key, {**part, **era}, precision=label)
                _costmodel.update_store(cm_base, rows, platform=cm_platform)
            except Exception as e:  # noqa: BLE001 — best-effort fold
                warnings.warn(f"cost-model store fold failed: {e!r}",
                              RuntimeWarning)

        # ---- result assembly under original point ids: live lanes
        # scatter through orig_ids, retired lanes come from the host store,
        # filler lanes are dropped
        real = orig_ids >= 0
        ids = orig_ids[real]

        def full_of(exec_arr, fill):
            exec_arr = np.asarray(exec_arr)
            out = np.full((G_real,) + exec_arr.shape[1:], fill,
                          exec_arr.dtype)
            out[ids] = exec_arr[real]
            return out

        host = numerics.to_host({
            "best_crit": best_crit, "best_epoch": best_epoch,
            "active": active, "failed_epoch": failed_epoch,
            "failed_cause": failed_cause, "nstate": self._gather(N)})
        final_crit = full_of(host["best_crit"], np.inf)
        final_epoch = full_of(host["best_epoch"], 0)
        final_active = full_of(host["active"], False)
        final_failed = full_of(host["failed_epoch"], -1)
        final_cause = full_of(host["failed_cause"], 0)
        final_numerics = {k: full_of(v, 0) for k, v in host["nstate"].items()}
        best_full = tree_map(lambda leaf: full_of(leaf, 0),
                             params_to_jax(self._gather(BP)))
        for pid, rec in retired.items():
            final_crit[pid] = rec["best_crit"]
            final_epoch[pid] = rec["best_epoch"]
            final_failed[pid] = rec["failed_epoch"]
            final_cause[pid] = rec["failed_cause"]
            for k, v in rec["numerics"].items():
                final_numerics[k][pid] = v
            for dst, src in zip(tree_leaves(best_full),
                                tree_leaves(rec["best_params"])):
                dst[pid] = src
        failures = [{"point": int(g), "epoch": int(e),
                     "cause": numerics.QUARANTINE_CAUSES.get(
                         int(cc), "nonfinite_val"),
                     "hparams": dict(self.spec.points[g])}
                    for g, (e, cc) in enumerate(zip(final_failed,
                                                    final_cause))
                    if e >= 0]
        logger.log("fit_end", best_epoch=final_epoch,
                   best_criteria=final_crit,
                   num_active=int(final_active.sum()),
                   compactions=stats["compactions"],
                   compile_ms=stats["capture_ms"], failures=failures,
                   dispatch_stats=stats)
        rows = [numerics.to_host(v) for v in val_history]
        return GridResult(
            best_params=best_full,
            best_criteria=final_crit,
            best_epoch=final_epoch,
            val_history=compaction.expand_history(rows, val_eras, eras,
                                                  G_real),
            coeffs=dict(self.result_coeffs),
            active=final_active,
            failures=failures, epochs=epochs,
            numerics={k: v.tolist() for k, v in final_numerics.items()},
            dispatch_stats=stats)

    def _freeze_step(self, params, accepted):
        """One Freeze accept/revert round over every lane: the merged
        candidates go back into the live params (in place); returns
        ``(params, new accepted)``."""
        with torch.no_grad(), self._ctx():
            candidate, accepted = apply_freeze_lanes(
                self.model, self.model.config.training_mode, params,
                accepted)
            tree_map(lambda dst, src: dst.copy_(src), params, candidate)
        return params, accepted

