"""REDCLIFF-S training choreography (port of ``train/redcliff_trainer.py``).

* epoch-scheduled phases (pretrain embedder / pretrain+acclimate factors /
  combined / post-train); two ``torch.optim.Adam`` with coupled weight
  decay (optax's ``add_decayed_weights`` + ``adam``), one over the
  embedder leaves and one over the factor leaves. Every step takes
  gradients of the whole tree (the guard's global norm covers every leaf)
  and steps the phase's optimizer(s);
* the GISTA proximal update after the factor step in every phase but
  ``embedder_pretrain``, at ``gen_lr`` (never the backed-off rate), in
  place on the live first-layer block through the GL prox kernel on the
  card (one launch, no allocation or copy);
* the numerics guard (runtime/numerics.py): a non-finite step skips both
  optimizers and the prox; one host read of the verdict per step;
* the Freeze-by-epoch/batch accept/revert choreography (train/freeze.py);
* Hungarian factor alignment at the pretrain->train transition;
* validation, confusion histories, GC tracking on the first validation
  batch, the weighted (factor, forecast, cosSim) stopping criteria with
  the lookback rule, the divergence monitor's rollback/abort;
* checkpoints through the durable format (runtime/checkpoint.py):
  ``final_best_model.bin`` in the shared ``{model_class, config, params}``
  numpy layout both packages read, the meta histories, and
  ``trainer_checkpoint.pkl`` in the port's own layout (optimizer
  ``state_dict`` s as numpy, the batch-shuffle rng state, the per-epoch
  log of steps by phase, skips and wall ms). A resumed fit
  continues the shuffle stream, so it equals the uninterrupted fit; the
  JAX trainer restarts the stream from the seed on resume. With
  ``async_checkpointing`` (the default, as in JAX) the periodic saves go
  to a background writer (``AsyncCheckpointWriter``): the loop's thread
  takes a host snapshot (pinned copies on the current stream and an
  event) and the pickle, CRC and fsync run behind the next epoch; the
  files are byte for byte the synchronous ones.

The optimizers and the prox update the live parameter tensors in place,
so every tree kept beside them (best, accepted, snapshots, checkpoints) is
a copy (``train/live.py``). Fits run on ``cuda`` unless ``device=`` says
otherwise.

Telemetry, as the JAX trainer emits it (``redcliff_tpu/train/
redcliff_trainer.py:355-368,477-493,509-540,577-578,628-680,721-760``): a
fit with a ``save_dir`` writes ``<save_dir>/metrics.jsonl``
(``obs/logging.py``) with ``fit_start``, the predicted ``memory``, one
``epoch`` per epoch, ``anomaly`` and ``numerics`` (rollback; abort with
the flight recorder's dump), ``quality`` on the check cadence (the graph
summary of ``obs/quality.py``, one readout of params; AUROC/AUPR when
``true_GC`` is given; off with ``REDCLIFF_QUALITY=0``; unlike JAX, a fit
with no ``save_dir`` builds no readout, as it has no log to write to), the
measured
``memory`` on a card, ``profile`` and ``fit_end``. ``profile_window`` /
``profile_dir`` / ``REDCLIFF_PROFILE`` open a bounded ``torch.profiler``
window (``obs/profiling.py``). The step fault points
(``runtime/faultinject.py``: ``nan_batch``, ``grad_blowup``,
``skip_update``) apply per batch with the JAX trainer's global step
counter. Telemetry reads the device only at epoch boundaries and never
changes a number: a fit is bit-identical with it on or off.

The production runtime, as the JAX trainer runs it
(``redcliff_tpu/train/redcliff_trainer.py:215-217,352-355,506-521,548,
576,766-767``): with ``REDCLIFF_WATCHDOG`` set a liveness watchdog
(``runtime/watchdog.py``) watches the ``epoch_engine`` and ``batch_loop``
heartbeats the loop stamps (and the prefetcher's, the shard loader's and
the checkpoint writer's); the constructor tunes both kernels' launch plans
at the fit's shapes (``ops/autotune.py tune_for_model``; a no-op without a
card or a store) and the fit logs the drained ``autotune`` events.

Not ported (ROADMAP): ``factor_mesh``, ``matmul_precision`` and mixed
precision, which raise ``NotImplementedError``. The factors are cMLPs or
cLSTMs (a cLSTM fit takes no prox, as in the JAX package).
"""
from __future__ import annotations

import copy
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from redcliff_tpu_torch.interop import params_to_jax, tree_leaves, tree_map
from redcliff_tpu_torch.models.redcliff import RedcliffSCMLP, phase_schedule
from redcliff_tpu_torch.obs import flight as _flight
from redcliff_tpu_torch.obs import memory as _obsmem
from redcliff_tpu_torch.obs import profiling as _profiling
from redcliff_tpu_torch.obs import quality as _obsquality
from redcliff_tpu_torch.obs import schema as _schema
from redcliff_tpu_torch.obs.logging import MetricLogger
from redcliff_tpu_torch.ops import autotune as _autotune
from redcliff_tpu_torch.runtime import checkpoint as durable_ckpt
from redcliff_tpu_torch.runtime import faultinject, numerics
from redcliff_tpu_torch.runtime import watchdog as _watchdog
from redcliff_tpu_torch.runtime.numerics import NumericsPolicy
from redcliff_tpu_torch.train.freeze import apply_freeze
from redcliff_tpu_torch.train.live import (LiveTreeMixin, assign_tree,
                                           copy_tree)
from redcliff_tpu_torch.train.tracking import GCProgressTracker
from redcliff_tpu_torch.utils.misc import factor_alignment_order
from redcliff_tpu_torch.utils.precision import (check_precision_mode,
                                                resolve_device)

__all__ = ["RedcliffTrainConfig", "RedcliffTrainer", "RedcliffFitResult"]

@dataclass
class RedcliffTrainConfig:
    """The JAX package's per-point knobs, field for field where the port
    honours them."""

    embed_lr: float = 1e-3
    embed_eps: float = 1e-8
    embed_weight_decay: float = 0.0
    gen_lr: float = 1e-3
    gen_eps: float = 1e-8
    gen_weight_decay: float = 0.0
    max_iter: int = 100
    lookback: int = 5
    check_every: int = 50
    batch_size: int = 32
    seed: int = 0
    verbose: int = 0
    stopping_criteria_forecast_coeff: float = 1.0
    stopping_criteria_factor_coeff: float = 1.0
    stopping_criteria_cosSim_coeff: float = 1.0
    max_factor_prior_batches: int = 10
    unsupervised_start_index: int = 0
    max_samples_for_gc_tracking: int = 40
    # bounded torch.profiler window (obs/profiling.py): "epoch:N" /
    # "epoch:N-M" brackets exactly those epochs, the Chrome trace under the
    # run dir's profile/ (or profile_dir) announced by a `profile` event.
    # None = follow REDCLIFF_PROFILE; profile_dir alone means ONE bounded
    # window (epoch 1)
    profile_dir: str | None = None
    profile_window: str | None = None
    # not ported: must stay None
    matmul_precision: str | None = None
    # "f32" only ("mixed" raises)
    precision_mode: str = "f32"
    # GISTA prox after each factor step: "GL" | "GSGL" | "H" | None
    prox_penalty: str | None = None
    prox_lam: float = 0.0
    # grid engine only: replay a CUDA graph of this many steps per group of
    # batches staged on the device; <= 1 keeps the one-step-per-batch
    # path. Ignored in FreezeByBatch modes (accept/revert runs between
    # batches)
    scan_batches: int = 0
    # batch-stream execution mode of the grid (data/pipeline.py): "auto"
    # resolves to the EPOCH engine — one CUDA-graph replay runs the whole
    # epoch's steps against the device-resident dataset — when eligible,
    # degrading to the k-batch replay (scan_batches) and then per-batch
    # steps. All modes run the same steps in the same order;
    # "per_batch"/"kscan"/"epoch" force a mode (still degrading when
    # ineligible, e.g. multi-process or freeze-by-batch). An unknown mode
    # raises ValueError when a grid fit resolves it
    stream_mode: str = "auto"
    # prefetch depth for batch sources that are not device-resident
    prefetch_batches: int = 2
    # grid engine only (parallel/policy.py): gather the surviving lanes
    # down the power-of-two bucket ladder at check windows, and pad a
    # fresh grid's width up to the ladder with masked filler lanes
    compaction: bool = True
    g_bucket: bool = True
    # hand periodic checkpoint saves to a background writer thread (the
    # host snapshot stays on the loop's thread; pickle, CRC and fsync move
    # off it); completion barrier at the next save and at the fit's end
    async_checkpointing: bool = True
    # the compile-cache directory of the JAX knob (runtime/compileobs.py):
    # the port caches no compiled program, so it is only reported (in
    # fit_start); None = follow REDCLIFF_COMPILE_CACHE
    compile_cache_dir: str | None = None
    # None disables the guard and the divergence monitor
    numerics: NumericsPolicy | None = field(default_factory=NumericsPolicy)

    def __post_init__(self):
        check_precision_mode(self.precision_mode)
        if self.matmul_precision is not None:
            raise NotImplementedError(
                "matmul_precision is not ported yet (ROADMAP queue 1, item "
                "18, mixed precision of the training path)")
        if self.prox_penalty not in (None, "GL", "GSGL", "H"):
            raise ValueError(
                f"prox_penalty must be one of None/'GL'/'GSGL'/'H', got "
                f"{self.prox_penalty!r}")


@dataclass
class RedcliffFitResult:
    params: dict
    best_it: int
    best_loss: float
    histories: dict
    tracker: GCProgressTracker
    final_val_loss: float
    # non-None when the numerics sentinel aborted the fit
    aborted: str | None = None
    # per epoch run by this call: {"epoch", "phases", "ms", "steps",
    # "skipped", "action"}: wall ms, the applied (guard-passed) steps per
    # phase, the guard's skipped steps, and the divergence monitor's verdict
    epochs: list = field(default_factory=list)
    # runtime/numerics.py numerics_summary at the end of the fit
    numerics: dict | None = None


class RedcliffTrainer(LiveTreeMixin):
    def __init__(self, model: RedcliffSCMLP, config: RedcliffTrainConfig,
                 device=None):
        self.model = model
        self.config = config
        self.device = resolve_device(device)
        self._guard = config.numerics is not None and config.numerics.enabled
        # both kernels' launch plans tuned at this fit's shapes, before any
        # launch (a no-op without a card, a store or with
        # REDCLIFF_AUTOTUNE=0); the records land as `autotune` events
        _autotune.tune_for_model(model.config, config.batch_size,
                                 prox_penalty=config.prox_penalty,
                                 device=self.device)

    # ------------------------------------------------------------------ phases
    def phase_for_epoch(self, epoch):
        return phase_schedule(self.model.config, epoch)

    def make_optimizers(self, live):
        """(embedder Adam, factor Adam) over the live leaves."""
        tc = self.config

        def adam(leaves, lr, eps, wd):
            # torch.optim.Adam with weight_decay adds wd * p to the gradient
            # before the moments: optax add_decayed_weights -> adam
            return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999),
                                    eps=eps, weight_decay=wd)
        return (adam(tree_leaves(live["embedder"]), tc.embed_lr, tc.embed_eps,
                     tc.embed_weight_decay),
                adam(tree_leaves(live["factors"]), tc.gen_lr, tc.gen_eps,
                     tc.gen_weight_decay))

    # -------------------------------------------------------------------- step
    def train_step(self, live, optA, optB, X, Y, phase, nstate):
        """One guarded training step on the live params. Returns
        ``(combo, parts, nstate, applied)``."""
        tc = self.config
        leaves = tree_leaves(live)
        combo, parts = self.model.loss_for_phase(live, X, Y, phase)
        grads = torch.autograd.grad(combo, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]

        def apply():
            if phase == "embedder_pretrain":
                opts = (optA,)
            elif phase in ("factor_pretrain", "post_train"):
                opts = (optB,)
            else:
                opts = (optA, optB)
            for p, g in zip(leaves, grads):
                p.grad = g
            for opt in opts:
                opt.step()
            for p in leaves:
                p.grad = None
            if tc.prox_penalty is not None and phase != "embedder_pretrain":
                # GISTA prox after the factor step, at the configured lr,
                # in place on the live first-layer block
                with torch.no_grad():
                    self.model.apply_prox_(live, tc.prox_lam, tc.gen_lr,
                                           tc.prox_penalty)

        if self._guard:
            nstate, ok = numerics.guarded_update(grads, combo, apply, nstate)
        else:
            apply()
            ok = True
        return combo, parts, nstate, ok

    # --------------------------------------------------------------- alignment
    def align_factors_with_labels(self, params, train_ds):
        """Hungarian-align factor indices to supervised labels using the
        first predicted factor weighting on up to
        ``max_factor_prior_batches`` batches."""
        cfg = self.model.config
        tc = self.config
        preds, labels = [], []
        with torch.no_grad():
            for b, (X, Y) in enumerate(self._batches(train_ds)):
                if b >= tc.max_factor_prior_batches:
                    break
                _, _, fw, _ = self.model.forward(params, X[:, : cfg.max_lag])
                preds.append(fw[0].cpu().numpy())
                Y = Y.cpu().numpy()
                if Y.ndim == 3:
                    col = cfg.max_lag if Y.shape[2] > cfg.max_lag else 0
                    labels.append(Y[:, :, col])
                else:
                    labels.append(Y)
        order = factor_alignment_order(
            np.vstack(preds), np.vstack(labels), cfg.num_factors,
            unsupervised_start_index=tc.unsupervised_start_index)
        return self.model.permute_factors(params, order)

    # --------------------------------------------------------------------- fit
    def fit(self, params, train_ds, val_ds, true_GC=None, save_dir=None,
            resume=True, factor_mesh=None) -> RedcliffFitResult:
        """Fit from ``params`` (a numpy or torch tree in the JAX layout).
        Returns the best params as tensors on the trainer's device. With a
        ``save_dir`` the fit writes its checkpoints and ``metrics.jsonl``
        there."""
        if factor_mesh is not None:
            raise NotImplementedError(
                "factor_mesh is not ported yet (ROADMAP queue 1, multi-GPU)")
        pw = _profiling.window_for(self.config, run_dir=save_dir,
                                   max_iter=self.config.max_iter,
                                   device=self.device)
        # the env-armed liveness watchdog (REDCLIFF_WATCHDOG); no
        # preemption guard here, so a confirmed hang goes straight to the
        # hard-exit rung
        with _watchdog.maybe_start() as wd:
            return self._fit(params, train_ds, val_ds, true_GC, save_dir,
                             resume, pw, wd)

    def _fit(self, params, train_ds, val_ds, true_GC, save_dir, resume, pw,
             wd=None):
        cfg = self.model.config
        tc = self.config
        self._true_GC = true_GC
        rng = np.random.default_rng(tc.seed)
        live = self.live_params(params)
        optA, optB = self.make_optimizers(live)
        mode = cfg.training_mode
        freeze_by_batch = "FreezeByBatch" in mode
        freeze = "Freeze" in mode

        tracker = GCProgressTracker(
            num_supervised_factors=cfg.num_supervised_factors,
            num_chans=cfg.num_chans, num_factors=cfg.num_factors)
        histories = {
            "avg_forecasting_loss": [], "avg_factor_loss": [],
            "avg_factor_cos_sim_penalty": [], "avg_fw_l1_penalty": [],
            "avg_adj_penalty": [], "avg_fw_smoothing_penalty": [],
            "avg_combo_loss": [],
            "factor_score_train_acc_history": [],
            "factor_score_train_tpr_history": [],
            "factor_score_train_tnr_history": [],
            "factor_score_train_fpr_history": [],
            "factor_score_train_fnr_history": [],
            "factor_score_val_acc_history": [],
            "factor_score_val_tpr_history": [],
            "factor_score_val_tnr_history": [],
            "factor_score_val_fpr_history": [],
            "factor_score_val_fnr_history": [],
        }
        best_it = None
        best_loss = np.inf
        best_params = copy_tree(live)
        accepted = copy_tree(live)  # Freeze-mode accepted tree
        iter_start = 0
        aligned = False
        # the epochs of earlier calls on this save_dir (the checkpoint's log)
        prior_log = []

        ckpt_path = (os.path.join(save_dir, "trainer_checkpoint.pkl")
                     if save_dir else None)
        ck = None
        if resume and ckpt_path:
            try:
                ck, _src = durable_ckpt.load_checkpoint(ckpt_path)
            except durable_ckpt.ForbiddenClassError as e:
                raise ValueError(
                    f"{ckpt_path} is not a trainer checkpoint of the port "
                    f"(a JAX-written one holds optax state and does not "
                    f"resume here); pass resume=False or another save_dir"
                ) from e
        if ck is not None:
            to_dev = lambda t: numerics.to_torch(t, self.device)  # noqa: E731
            assign_tree(live, to_dev(ck["params"]))
            best_params = to_dev(ck["best_params"])
            accepted = to_dev(ck["accepted"])
            optA.load_state_dict(numerics.to_torch(ck["optA_state"]))
            optB.load_state_dict(numerics.to_torch(ck["optB_state"]))
            histories = ck["histories"]
            best_it, best_loss = ck["best_it"], ck["best_loss"]
            iter_start = ck["epoch"] + 1
            aligned = ck.get("aligned", False)
            if ck.get("tracker_state") is not None:
                tracker.__dict__.update(ck["tracker_state"])
            if ck.get("rng_state") is not None:
                rng.bit_generator.state = ck["rng_state"]
            prior_log = list(ck.get("epoch_log", []))

        # the quality observatory (obs/quality.py): one graph-summary
        # readout of the live params on the check cadence, on the first
        # validation batch's window; nothing is built with
        # REDCLIFF_QUALITY=0, nor without a save_dir (the readout lands
        # only in metrics.jsonl, so a fit with no log pays nothing for it)
        qmon = qual_fn = qual_Xw = None
        if save_dir and _obsquality.enabled():
            qfirst = next(iter(self._batches(val_ds)), None)
            if qfirst is not None:
                qual_Xw = qfirst[0][: tc.max_samples_for_gc_tracking,
                                    : cfg.max_lag, :]
                qual_fn = _obsquality.make_summary_fn(self.model)
                qmon = _obsquality.QualityMonitor(
                    true_gc=true_GC, mode=_obsquality.readout_mode(cfg))

        last_it = iter_start - 1
        policy = tc.numerics if self._guard else None
        monitor = (numerics.DivergenceMonitor(policy)
                   if policy is not None else None)
        nstate = numerics.init_numerics_state()
        prev_skipped = 0
        # the fault points' global step index, per fit call as in JAX
        step_counter = 0
        aborted = None
        epochs = []
        # the background checkpoint writer: periodic saves hand their
        # pickle + fsync to a thread (completion barrier at the next save
        # and at the fit's end)
        writer = (durable_ckpt.AsyncCheckpointWriter()
                  if save_dir and tc.async_checkpointing else None)
        logger = MetricLogger(save_dir)
        if wd is not None:
            wd.bind(logger=logger)  # hang incidents land in metrics.jsonl
        try:
            logger.log("fit_start", model="RedcliffSCMLP", training_mode=mode,
                       shape=_schema.shape_desc(cfg), train_config=tc,
                       resume_epoch=iter_start)
            # the launch-plan searches/lookups of the constructor
            for atrec in _autotune.drain_records():
                logger.log("autotune", **atrec)
            # the predicted footprint from shapes: live params + best and
            # accepted copies + both Adams' two moments + the datasets
            mp = _obsmem.trainer_footprint(live, (live, live),
                                           extra_copies=2, train_ds=train_ds,
                                           val_ds=val_ds)
            hr = _obsmem.check_headroom(mp["total_bytes"],
                                        devices=[self.device])
            logger.log("memory", kind="predicted", epoch=iter_start - 1,
                       predicted_bytes=mp["total_bytes"],
                       params_bytes=mp["params_bytes"],
                       opt_bytes=mp["opt_bytes"],
                       dataset_bytes=mp["dataset_bytes"],
                       fits=hr["fits"], bytes_limit=hr["bytes_limit"],
                       budget_bytes=hr["budget_bytes"],
                       headroom_bytes=hr["headroom_bytes"],
                       backend=hr["backend"])
            for it in range(iter_start, tc.max_iter):
                _watchdog.stamp("epoch_engine")
                pw.on_epoch_start(it)
                t_epoch0 = time.perf_counter()
                last_it = it
                if (not aligned and "pretrain_factor" in mode
                        and it == cfg.num_pretrain_epochs
                        and cfg.num_supervised_factors > 0):
                    assign_tree(live, self.align_factors_with_labels(
                        live, train_ds))
                    aligned = True

                phases = self.phase_for_epoch(it)
                conf_mat = (np.zeros((cfg.num_supervised_factors,) * 2)
                            if cfg.num_supervised_factors > 0 else None)
                applied = {p: 0 for p in phases}
                skipped = 0
                for X, Y in self._batches(train_ds, rng=rng):
                    _watchdog.stamp("batch_loop")
                    X = faultinject.poison_batch(X, step_counter)
                    skip = faultinject.skip_update(step_counter)
                    step_counter += 1
                    if skip:
                        continue
                    for phase in phases:
                        _, _, nstate, ok = self.train_step(
                            live, optA, optB, X, Y, phase, nstate)
                        applied[phase] += int(ok)
                        skipped += int(not ok)
                        if conf_mat is not None and phase in (
                                "embedder_pretrain", "combined"):
                            conf_mat += self._confusion(live, X, Y)
                    if freeze_by_batch:
                        accepted = self._apply_freeze(live, accepted)

                if conf_mat is not None and conf_mat.sum() > 0:
                    self._append_conf_stats(conf_mat, histories, "train")

                self._epoch_gc_tracking(live, val_ds, tracker)

                val = self.validate(live, val_ds, histories)
                histories["avg_forecasting_loss"].append(
                    val["forecasting_loss"])
                histories["avg_factor_loss"].append(val["factor_loss"])
                histories["avg_factor_cos_sim_penalty"].append(
                    val["factor_cos_sim_penalty"])
                histories["avg_fw_l1_penalty"].append(val["fw_l1_penalty"])
                histories["avg_adj_penalty"].append(val["adj_l1_penalty"])
                histories["avg_fw_smoothing_penalty"].append(
                    val.get("fw_smoothing_penalty", 0.0))
                histories["avg_combo_loss"].append(val["combo_loss"])

                criteria = None
                stop_early = False
                past_pretrain = (it >= cfg.num_pretrain_epochs
                                 + cfg.num_acclimation_epochs)
                if past_pretrain:
                    cos_mean = tracker.latest_mean_supervised_cosine()
                    if cfg.num_supervised_factors > 1:
                        criteria = (tc.stopping_criteria_factor_coeff
                                    * val["factor_loss"]
                                    + tc.stopping_criteria_forecast_coeff
                                    * val["forecasting_loss"]
                                    + tc.stopping_criteria_cosSim_coeff
                                    * cos_mean)
                    elif cfg.num_supervised_factors == 1:
                        criteria = (tc.stopping_criteria_factor_coeff
                                    * val["factor_loss"]
                                    + tc.stopping_criteria_forecast_coeff
                                    * val["forecasting_loss"])
                    else:
                        criteria = (tc.stopping_criteria_forecast_coeff
                                    * val["forecasting_loss"])

                rolled_back = False
                action = None
                if monitor is not None:
                    nhost = numerics.numerics_summary(nstate)
                    if nhost["skipped"] > prev_skipped:
                        logger.log("anomaly", epoch=it,
                                   cause="nonfinite_grad",
                                   epoch_skipped_steps=nhost["skipped"]
                                   - prev_skipped, **nhost)
                    prev_skipped = nhost["skipped"]
                    action = monitor.check(it, nhost, criteria)
                    if action.kind == "rollback":
                        snap = monitor.rollback()
                        assign_tree(live, snap["params"])
                        accepted = tree_map(lambda x: x.to(self.device),
                                            snap["accepted"])
                        optA.load_state_dict(snap["optA_state"])
                        optB.load_state_dict(snap["optB_state"])
                        nstate = numerics.reset_consecutive(nstate)
                        logger.log(
                            "numerics", kind="rollback", epoch=it,
                            cause=action.cause,
                            restored_epoch=monitor.snapshot_epoch,
                            lr_scale=monitor.lr_scale,
                            learning_rates=numerics.current_learning_rates(
                                (optA.state_dict(), optB.state_dict())),
                            rollbacks=monitor.rollbacks)
                        rolled_back = True
                    elif action.kind == "abort":
                        aborted = action.cause
                        # the abort dumps the flight recorder next to
                        # metrics.jsonl
                        fr = _flight.dump_for_logger(
                            logger, reason="numerics_abort",
                            extra={"epoch": it, "cause": action.cause})
                        logger.log("numerics", kind="abort", epoch=it,
                                   cause=action.cause, flight_record=fr,
                                   **nhost)
                    elif criteria is None or np.isfinite(criteria):
                        monitor.note_good(
                            it, {"params": live, "accepted": accepted,
                                 "optA_state": optA.state_dict(),
                                 "optB_state": optB.state_dict()})

                if not rolled_back and aborted is None:
                    if past_pretrain:
                        if freeze:
                            accepted = self._apply_freeze(live, accepted)
                            if criteria < best_loss:
                                best_loss = criteria
                                best_it = it
                            elif best_it is not None and (it - best_it) == \
                                    tc.lookback * tc.check_every:
                                # the lookback rule in every mode, Freeze too
                                stop_early = True
                            best_params = accepted
                        else:
                            if criteria < best_loss:
                                best_loss = criteria
                                best_it = it
                                best_params = copy_tree(live)
                            elif best_it is not None and (it - best_it) == \
                                    tc.lookback * tc.check_every:
                                stop_early = True
                    else:
                        best_it = it
                        best_params = copy_tree(live)

                epoch_ms = (time.perf_counter() - t_epoch0) * 1e3
                epochs.append({"epoch": it, "phases": list(phases),
                               "ms": epoch_ms, "steps": applied,
                               "skipped": skipped,
                               "action": None if action is None
                               else action.kind})
                # logged before the early stop is honoured, so the stopping
                # epoch's record lands
                logger.log("epoch", epoch=it, phases=list(phases),
                           criteria=criteria, epoch_ms=round(epoch_ms, 3),
                           **val, **tracker.latest_as_dict())
                if qmon is not None and it % tc.check_every == 0:
                    with torch.no_grad():
                        qdev = qual_fn(live, qual_Xw)
                    qhost = {k: v.cpu().numpy()[None]
                             for k, v in qdev.items()}
                    logger.log("quality", **qmon.update(
                        it, qhost, np.zeros(1, np.int32)))
                pw.on_epoch_end(it, logger=logger)
                if stop_early and tc.verbose:
                    print("Stopping early")
                if stop_early or aborted is not None:
                    break
                if rolled_back:
                    continue

                if it % tc.check_every == 0 and save_dir:
                    self._save_checkpoint(save_dir, it, best_params,
                                          accepted, live, optA, optB,
                                          histories, best_it, best_loss,
                                          tracker, aligned, rng,
                                          prior_log + epochs, writer=writer)
                if tc.verbose and it % max(1, tc.check_every) == 0:
                    print(f"epoch {it} phases={phases}: "
                          f"val_combo={val['combo_loss']:.5f}")

            final_val = self.validate(best_params, val_ds, None)
            # the measured watermark, on a card (nothing on the CPU)
            if _obsmem.polling_enabled():
                wm = _obsmem.poll_watermark([self.device])
                if wm is not None:
                    logger.log("memory", kind="measured", epoch=last_it,
                               bytes_in_use=wm["bytes_in_use"],
                               peak_bytes=wm["peak_bytes"],
                               bytes_limit=wm["bytes_limit"],
                               n_devices=wm["n_devices"],
                               device_kind=wm["device_kind"])
            logger.log("fit_end",
                       best_it=best_it if best_it is not None else 0,
                       best_loss=float(best_loss),
                       final_val_loss=final_val["combo_loss"],
                       aborted=aborted,
                       quality=(qmon.snapshot()
                                if qmon is not None and qmon.windows
                                else None))
        finally:
            _watchdog.retire("epoch_engine")
            _watchdog.retire("batch_loop")
            # an exit inside the profiler window (an early stop, an abort,
            # an exception) still closes the capture and announces it
            pw.finish(logger=logger)
            logger.close()
            if writer is not None:
                # join the in-flight write on every exit path: a background
                # failure re-raises on a clean exit and is warned (not
                # masked) while another exception propagates
                writer.__exit__(*sys.exc_info())
        if save_dir:
            self._save_checkpoint(save_dir, last_it, best_params, accepted,
                                  live, optA, optB, histories, best_it,
                                  best_loss, tracker, aligned, rng,
                                  prior_log + epochs, writer=writer)
            if writer is not None:
                writer.wait()  # the final state is durable on return
        return RedcliffFitResult(
            params=best_params,
            best_it=best_it if best_it is not None else 0,
            best_loss=float(best_loss), histories=histories, tracker=tracker,
            final_val_loss=final_val["combo_loss"], aborted=aborted,
            epochs=epochs, numerics=numerics.numerics_summary(nstate))

    # ----------------------------------------------------------------- helpers
    def _apply_freeze(self, live, accepted):
        """Accept/revert per-factor updates: the merged candidate goes back
        into the live leaves; returns the new accepted tree."""
        with torch.no_grad():
            candidate, accepted = apply_freeze(
                self.model, self.model.config.training_mode, live, accepted)
        assign_tree(live, candidate)
        return accepted

    def _confusion(self, params, X, Y):
        cfg = self.model.config
        S = cfg.num_supervised_factors
        W = cfg.max_lag
        with torch.no_grad():
            preds = self.model.forward(params, X[:, :W, :])[3][0]
        preds = preds.cpu().numpy()
        Y = Y.cpu().numpy()
        if Y.ndim == 3:
            col = cfg.max_lag if Y.shape[2] > cfg.max_lag else 0
            y = Y[:, :S, col]
        else:
            y = Y[:, :S]
        cm = np.zeros((S, S))
        for t, p in zip(y.argmax(axis=1), preds[:, :S].argmax(axis=1)):
            cm[t, p] += 1
        return cm

    @staticmethod
    def _append_conf_stats(cm, histories, split):
        """Multi-class TPR/TNR/FPR/FNR/ACC from a confusion matrix."""
        TP = np.diag(cm)
        FP = cm.sum(axis=0) - TP
        FN = cm.sum(axis=1) - TP
        TN = cm.sum() - (FP + FN + TP)
        with np.errstate(divide="ignore", invalid="ignore"):
            histories[f"factor_score_{split}_acc_history"].append(
                (TP + TN) / (TP + FP + FN + TN))
            histories[f"factor_score_{split}_tpr_history"].append(
                TP / (TP + FN))
            histories[f"factor_score_{split}_tnr_history"].append(
                TN / (TN + FP))
            histories[f"factor_score_{split}_fpr_history"].append(
                FP / (FP + TN))
            histories[f"factor_score_{split}_fnr_history"].append(
                FN / (TP + FN))

    def _epoch_gc_tracking(self, params, val_ds, tracker):
        """GC metrics on the first validation batch."""
        cfg = self.model.config
        tc = self.config
        for X, _ in self._batches(val_ds):
            Xw = X[: tc.max_samples_for_gc_tracking, : cfg.max_lag, :]
            with torch.no_grad():
                lagged = self.model.gc(
                    params, cfg.primary_gc_est_mode, X=Xw, threshold=False,
                    ignore_lag=False, combine_wavelet_representations=True)
                nolag = self.model.gc(
                    params, cfg.primary_gc_est_mode, X=Xw, threshold=False,
                    ignore_lag=True, combine_wavelet_representations=True)
            lagged = lagged.cpu().numpy()
            nolag = nolag.cpu().numpy()[..., 0]
            est_lagged = [[lagged[s, k] for k in range(lagged.shape[1])]
                          for s in range(lagged.shape[0])]
            est_nolag = [[nolag[s, k] for k in range(nolag.shape[1])]
                         for s in range(nolag.shape[0])]
            tracker.update(true_GC=self._true_GC, est_by_sample=est_lagged,
                           est_by_sample_lagsummed=est_nolag)
            break

    def validate(self, params, val_ds, histories):
        """Mean loss parts over the (unshuffled) validation batches, each
        part divided by its loss coefficient; ``histories`` also gets the
        validation confusion statistics."""
        cfg = self.model.config
        coeffs = self.model.normalization_coeffs()
        sums = {}
        combo_sum = 0.0
        n = 0
        conf_mat = (np.zeros((cfg.num_supervised_factors,) * 2)
                    if cfg.num_supervised_factors > 0
                    and histories is not None else None)
        for X, Y in self._batches(val_ds):
            with torch.no_grad():
                combo, parts = self.model.loss_for_phase(params, X, Y,
                                                         "combined")
            names = list(parts)
            host = torch.stack([combo] + [parts[k] for k in names]).tolist()
            combo_sum += host[0]
            for k, v in zip(names, host[1:]):
                c = coeffs.get(k, 1.0)
                sums[k] = sums.get(k, 0.0) + v / (c if c > 0 else 1.0)
            if conf_mat is not None:
                conf_mat += self._confusion(params, X, Y)
            n += 1
        if n == 0:
            raise ValueError("validation dataset yielded no batches")
        out = {k: v / n for k, v in sums.items()}
        out["combo_loss"] = combo_sum / n
        if conf_mat is not None and conf_mat.sum() > 0:
            self._append_conf_stats(conf_mat, histories, "val")
        return out

    _true_GC = None

    def _save_checkpoint(self, save_dir, it, best_params, accepted, live,
                         optA, optB, histories, best_it, best_loss, tracker,
                         aligned, rng, epoch_log, writer=None):
        """The three durable files. The trainer checkpoint carries
        ``epoch_log``: the per-epoch records (``RedcliffFitResult.epochs``)
        of every call on this save_dir. With a ``writer`` the loop's thread
        only snapshots (``runtime/checkpoint.host_snapshot``: the tensor
        trees, which the next step updates in place, and deep copies of the
        host state the loop keeps appending to) and the writer thread
        writes the same files from the snapshot."""
        if writer is None:
            self._write_checkpoint_files(
                save_dir, it, best_params, accepted, live,
                optA.state_dict(), optB.state_dict(), histories, best_it,
                best_loss, tracker.as_dict(), dict(tracker.__dict__),
                aligned, rng.bit_generator.state, epoch_log)
            return
        trees, ready = durable_ckpt.host_snapshot(
            (best_params, accepted, live, optA.state_dict(),
             optB.state_dict()))
        host = copy.deepcopy((histories, tracker.as_dict(),
                              dict(tracker.__dict__),
                              rng.bit_generator.state, epoch_log))

        def write():
            ready()
            self._write_checkpoint_files(
                save_dir, it, *trees, host[0], best_it,
                best_loss, host[1], host[2], aligned, host[3], host[4])
        writer.submit(write)

    def _write_checkpoint_files(self, save_dir, it, best_params, accepted,
                                live, optA_state, optB_state, histories,
                                best_it, best_loss, tracker_meta,
                                tracker_state, aligned, rng_state,
                                epoch_log):
        os.makedirs(save_dir, exist_ok=True)
        durable_ckpt.write_checkpoint(
            os.path.join(save_dir, "final_best_model.bin"),
            {"model_class": "RedcliffSCMLP", "config": self.model.config,
             "params": params_to_jax(best_params)})
        meta = {"epoch": it, "best_loss": float(best_loss),
                "best_it": best_it, **histories, **tracker_meta}
        durable_ckpt.write_checkpoint(
            os.path.join(save_dir,
                         "training_meta_data_and_hyper_parameters.pkl"), meta)
        durable_ckpt.write_checkpoint(
            os.path.join(save_dir, "trainer_checkpoint.pkl"),
            {
                "epoch": it,
                "params": params_to_jax(live),
                "best_params": params_to_jax(best_params),
                "accepted": params_to_jax(accepted),
                "optA_state": numerics.to_host(optA_state),
                "optB_state": numerics.to_host(optB_state),
                "histories": histories,
                "best_it": best_it,
                "best_loss": float(best_loss),
                "aligned": aligned,
                "tracker_state": tracker_state,
                "rng_state": rng_state,
                "epoch_log": epoch_log,
            })
