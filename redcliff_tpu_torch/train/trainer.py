"""The generic trainer of the baseline model families, and model artifacts
(port of ``train/trainer.py``).

A model exposes ``init(generator, device)``, ``loss(params, X[, Y][,
rng]) -> (combo, parts)`` and ``gc``, and optionally ``apply_prox_`` (the
in-place GISTA prox), ``validation_criteria``, ``normalization_coeffs``,
``gc_requires_data`` and ``wants_rng``: cMLP-FM, cLSTM-FM, NAVAR,
NAVAR-LSTM and DGCNN (``models/``). The REDCLIFF-S trainer is
``train/redcliff_trainer.py``; this one follows its conventions:

* one ``torch.optim.Adam`` over every leaf (optax's
  ``inject_hyperparams(adam)``: no weight decay, eps 1e-8, the learning
  rate in ``param_groups`` so the divergence monitor can back it off);
* the prox after the Adam step, in place, at ``learning_rate`` (never the
  backed-off rate): for cMLP-FM one GL prox kernel launch on the card;
* the numerics guard (runtime/numerics.py) with one host read per step,
  and the divergence monitor's rollback/abort;
* labels reach the loss only for ``has_labels`` (DGCNN); a model that
  ``wants_rng`` (NAVAR with dropout) gets a ``torch.Generator`` on the
  device, seeded with ``seed``, drawn from step after step (JAX folds a
  key per step, which torch cannot reproduce);
* validation, GC tracking on the first validation batch, early stopping
  after ``lookback * check_every`` epochs without a better criteria;
* checkpoints through the durable format: ``final_best_model.bin`` in the
  ``{model_class, config, params}`` numpy layout both packages read, the
  meta histories, and ``trainer_checkpoint.pkl`` in the port's own layout
  (Adam's ``state_dict`` as numpy, the batch-shuffle rng state, the
  dropout generator's state, and the per-epoch log of steps, skips and
  wall ms). A resumed fit equals the uninterrupted one;
  the JAX trainer restarts both streams on resume, and its checkpoint
  (optax state) is refused with ``ValueError``.

Adam and the prox update the live parameter tensors in place, so every
tree kept beside them (best, snapshots, checkpoints) is a copy
(``train/live.py``, shared with the REDCLIFF-S trainer). Fits run
on ``cuda`` unless ``device=`` says otherwise.

Telemetry, as the JAX trainer emits it (``redcliff_tpu/train/
trainer.py:368-523``): with a ``save_dir`` the fit writes
``metrics.jsonl`` with ``fit_start``, the predicted ``memory``, one
``epoch`` per epoch, ``quality`` on the check cadence (the host twin
``obs/quality.py:summarize_host`` of the family's GC readout; off with
``REDCLIFF_QUALITY=0``), ``anomaly`` / ``numerics`` (rollback; abort with
the flight recorder's dump), the measured ``memory`` on a card,
``profile`` and ``fit_end``; ``profile_window`` / ``profile_dir`` /
``REDCLIFF_PROFILE`` open a bounded ``torch.profiler`` window, and the
step fault points of ``runtime/faultinject.py`` apply per batch with the
JAX trainer's global step counter. A fit is bit-identical with telemetry
on or off.

The production runtime, as the JAX trainer runs it
(``redcliff_tpu/train/trainer.py:79,359-364,397-402,531-532``): with
``async_checkpointing`` (the default) the periodic saves go to a
background writer (``runtime/checkpoint.AsyncCheckpointWriter``, the
loop's thread taking a host snapshot, the files byte for byte the
synchronous ones), and with ``REDCLIFF_WATCHDOG`` set a liveness watchdog
(``runtime/watchdog.py``) watches the ``epoch_engine`` and ``batch_loop``
heartbeats the loop stamps.

Mixed precision, as the JAX trainer runs it (``redcliff_tpu/train/
trainer.py:86-95,151-163,305-309,469-478,621-622``): under
``precision_mode="mixed"`` each step's loss and gradients and the
validation loss run inside a ``"bfloat16"`` matmul context
(``utils/precision.py``: bf16-rounded operands, float32 sums, JAX's
transpose rule for the gradients); a sentinel rollback demotes the fit to
f32 (a ``precision`` event, ``kind="demote"``), ``precision_demoted`` is
written into ``trainer_checkpoint.pkl`` and a resume runs at f32 from its
first step. Params, Adam state and the prox stay float32.
"""
from __future__ import annotations

import copy
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from redcliff_tpu_torch.interop import params_to_jax, tree_leaves
from redcliff_tpu_torch.obs import flight as _flight
from redcliff_tpu_torch.obs import memory as _obsmem
from redcliff_tpu_torch.obs import profiling as _profiling
from redcliff_tpu_torch.obs import quality as _obsquality
from redcliff_tpu_torch.obs import schema as _schema
from redcliff_tpu_torch.obs.logging import MetricLogger
from redcliff_tpu_torch.runtime import checkpoint as durable_ckpt
from redcliff_tpu_torch.runtime import faultinject, numerics
from redcliff_tpu_torch.runtime import watchdog as _watchdog
from redcliff_tpu_torch.runtime.numerics import NumericsPolicy
from redcliff_tpu_torch.train.live import (LiveTreeMixin, assign_tree,
                                           copy_tree)
from redcliff_tpu_torch.train.tracking import GCProgressTracker
from redcliff_tpu_torch.utils.precision import (check_precision_mode,
                                                matmul_precision_ctx,
                                                resolve_matmul_precision,
                                                resolve_device)

__all__ = ["TrainConfig", "Trainer", "FitResult", "save_model", "load_model",
           "ARTIFACT_NAME"]

ARTIFACT_NAME = "final_best_model.bin"


@dataclass
class TrainConfig:
    """The JAX package's knobs, field for field."""

    learning_rate: float = 1e-3
    max_iter: int = 100
    lookback: int = 5
    check_every: int = 50
    batch_size: int = 32
    seed: int = 0
    prox_penalty: str | None = None  # "GL" | "GSGL" | "H"
    prox_lam: float = 0.0
    verbose: int = 0
    # bounded torch.profiler window ("epoch:N" / "epoch:N-M",
    # obs/profiling.py); None = follow REDCLIFF_PROFILE. profile_dir alone
    # means ONE bounded window (epoch 1)
    profile_dir: str | None = None
    profile_window: str | None = None
    # prefetch depth for batch sources that are not device-resident
    prefetch_batches: int = 2
    # hand periodic checkpoint saves to a background writer thread (the
    # host snapshot stays on the loop's thread; pickle, CRC and fsync move
    # off it); completion barrier at the next save and at the fit's end
    async_checkpointing: bool = True
    # the compile-cache directory of the JAX knob (runtime/compileobs.py):
    # the port caches no compiled program, so it is only reported (in
    # fit_start's train_config)
    compile_cache_dir: str | None = None
    # None disables the guard and the divergence monitor
    numerics: NumericsPolicy | None = field(default_factory=NumericsPolicy)
    # "f32" (default: no precision context) or "mixed" (bf16
    # contractions; a sentinel rollback demotes the fit to f32 and the
    # demotion persists in the checkpoint)
    precision_mode: str = "f32"

    def __post_init__(self):
        check_precision_mode(self.precision_mode)
        if self.prox_penalty not in (None, "GL", "GSGL", "H"):
            raise ValueError(
                f"prox_penalty must be one of None/'GL'/'GSGL'/'H', got "
                f"{self.prox_penalty!r}")


@dataclass
class FitResult:
    params: Any
    best_it: int
    best_loss: float
    histories: dict
    tracker: GCProgressTracker | None
    final_val_loss: float
    # non-None when the numerics sentinel aborted the fit
    aborted: str | None = None
    # per epoch run by this call: {"epoch", "ms", "steps", "skipped",
    # "action"}: wall ms, the applied (guard-passed) steps, the guard's
    # skipped steps and the divergence monitor's verdict
    epochs: list = field(default_factory=list)
    # runtime/numerics.py numerics_summary at the end of the fit
    numerics: dict | None = None


def save_model(save_dir, model, params, extra=None):
    """Persist {config, params} under the reference's artifact name."""
    os.makedirs(save_dir, exist_ok=True)
    payload = {
        "model_class": type(model).__name__,
        "config": model.config,
        "params": params_to_jax(params),
    }
    if extra:
        payload.update(extra)
    durable_ckpt.write_checkpoint(os.path.join(save_dir, ARTIFACT_NAME),
                                  payload)


def load_model(save_dir_or_file):
    """Read a model artifact payload (durable format or legacy pickle)."""
    path = save_dir_or_file
    if os.path.isdir(path):
        path = os.path.join(path, ARTIFACT_NAME)
    return durable_ckpt.read_checkpoint(path)


class Trainer(LiveTreeMixin):
    def __init__(self, model, config: TrainConfig, has_labels=False,
                 device=None):
        self.model = model
        self.config = config
        self.has_labels = has_labels
        self.device = resolve_device(device)
        self.wants_rng = bool(getattr(model, "wants_rng", False))
        self._guard = config.numerics is not None and config.numerics.enabled
        # the effective matmul precision; "mixed" fits are demotable: a
        # sentinel rollback runs every later step at f32
        self._precision = resolve_matmul_precision(config.precision_mode)
        self._demotable = (config.precision_mode == "mixed" and self._guard
                           and self._precision is not None)
        self._demoted = False

    def _demote_to_f32(self):
        """Run every later step at f32 (the sentinel-triggered demotion)."""
        self._precision = None
        self._demoted = True

    def make_optimizer(self, live):
        """Adam over every live leaf, as optax's adam."""
        return torch.optim.Adam(tree_leaves(live), lr=self.config.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)

    def make_step_rng(self):
        """The dropout generator on the trainer's device, or None."""
        if not self.wants_rng:
            return None
        return torch.Generator(device=self.device).manual_seed(
            self.config.seed)

    def loss(self, params, X, Y, rng=None):
        """The model's loss with the labels or the dropout generator the
        family takes."""
        if self.has_labels:
            return self.model.loss(params, X, Y)
        if self.wants_rng:
            return self.model.loss(params, X, rng=rng)
        return self.model.loss(params, X)

    # -------------------------------------------------------------------- step
    def train_step(self, live, opt, X, Y, rng, nstate):
        """One guarded step on the live params. Returns ``(combo, parts,
        nstate, applied)``."""
        cfg = self.config
        leaves = tree_leaves(live)
        with matmul_precision_ctx(self._precision):
            combo, parts = self.loss(live, X, Y, rng)
            grads = torch.autograd.grad(combo, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]

        def apply():
            for p, g in zip(leaves, grads):
                p.grad = g
            opt.step()
            for p in leaves:
                p.grad = None
            if cfg.prox_penalty is not None:
                with torch.no_grad():
                    self.model.apply_prox_(live, cfg.prox_lam,
                                           cfg.learning_rate,
                                           cfg.prox_penalty)

        if self._guard:
            nstate, ok = numerics.guarded_update(grads, combo, apply, nstate)
        else:
            apply()
            ok = True
        return combo, parts, nstate, ok

    # ---------------------------------------------------------------- validate
    def validate(self, params, val_ds):
        """Mean loss parts over the (unshuffled) validation batches, each
        part divided by its loss coefficient."""
        coeffs = getattr(self.model, "normalization_coeffs", lambda: {})()
        sums = {}
        combo_sum = 0.0
        n = 0
        for X, Y in self._batches(val_ds):
            with torch.no_grad(), matmul_precision_ctx(self._precision):
                combo, parts = self.loss(params, X, Y)
            names = list(parts)
            host = torch.stack([combo] + [parts[k] for k in names]).tolist()
            combo_sum += host[0]
            for k, v in zip(names, host[1:]):
                c = coeffs.get(k, 1.0)
                sums[k] = sums.get(k, 0.0) + v / (c if c > 0 else 1.0)
            n += 1
        if n == 0:
            raise ValueError(
                "validation dataset yielded no batches — increase "
                "val_fraction or dataset size (empty validation would make "
                "early stopping undefined)")
        out = {k: v / n for k, v in sums.items()}
        out["combo_loss"] = combo_sum / n
        return out

    def criteria(self, params, val):
        """The model's early-stopping criteria, else the combo loss."""
        if hasattr(self.model, "validation_criteria"):
            with torch.no_grad():
                return float(self.model.validation_criteria(params, val))
        return val["combo_loss"]

    def gc_kwargs(self, track_X):
        """``model.gc`` keywords of the tracker: the tracking window for
        data-dependent estimates, and wavelet bands condensed to (C, C)."""
        kw = {}
        if getattr(self.model, "gc_requires_data", False):
            kw["X"] = track_X
        mcfg = self.model.config
        if (getattr(mcfg, "wavelet_level", None) is not None
                or getattr(mcfg, "num_wavelets_per_chan", 1) > 1):
            kw["combine_wavelet_representations"] = True
        return kw

    def _epoch_gc_tracking(self, params, tracker, true_GC, track_X):
        kw = self.gc_kwargs(track_X)
        with torch.no_grad():
            ests = [g.cpu().numpy() for g in
                    self.model.gc(params, ignore_lag=False, **kw)]
            nolag = [g.cpu().numpy() for g in
                     self.model.gc(params, ignore_lag=True, **kw)]
        tracker.update(true_GC, [ests], est_by_sample_lagsummed=[nolag])

    # --------------------------------------------------------------------- fit
    def fit(self, params, train_ds, val_ds, true_GC=None, save_dir=None,
            resume=True) -> FitResult:
        """Fit from ``params`` (a numpy or torch tree in the JAX layout).
        Returns the best params as tensors on the trainer's device. With a
        ``save_dir`` the fit writes its checkpoints and ``metrics.jsonl``
        there."""
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)
        live = self.live_params(params)
        opt = self.make_optimizer(live)
        step_rng = self.make_step_rng()
        tracker = None
        if true_GC is not None:
            tracker = GCProgressTracker(
                num_supervised_factors=len(true_GC),
                num_chans=true_GC[0].shape[0],
                num_factors=getattr(self.model.config, "num_factors",
                                    len(true_GC)))
        histories = {"avg_forecasting_loss": [], "avg_adj_penalty": [],
                     "avg_combo_loss": []}
        best_it = None
        best_loss = np.inf
        best_params = copy_tree(live)
        iter_start = 0
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
            assign_tree(live, numerics.to_torch(ck["params"], self.device))
            best_params = numerics.to_torch(ck["best_params"], self.device)
            opt.load_state_dict(numerics.to_torch(ck["opt_state"]))
            histories = ck["histories"]
            best_it, best_loss = ck["best_it"], ck["best_loss"]
            iter_start = ck["epoch"] + 1
            if tracker is not None and ck.get("tracker_state") is not None:
                tracker.__dict__.update(ck["tracker_state"])
            rng.bit_generator.state = ck["rng_state"]
            if step_rng is not None:
                step_rng.set_state(torch.from_numpy(ck["step_rng_state"]))
            prior_log = list(ck.get("epoch_log", []))
            if ck.get("precision_demoted") and self._demotable \
                    and not self._demoted:
                # the checkpointed fit demoted mixed -> f32: a resume stays
                # f32 (never silently re-promotes)
                self._demote_to_f32()

        # the quality observatory rides the host twin of the family's GC
        # readout (entropy None: no factor scores on this path); built
        # only when there is a metrics log (a save_dir) to write it to
        qmon = (_obsquality.QualityMonitor(true_gc=true_GC,
                                           mode="host_readout")
                if save_dir and _obsquality.enabled() else None)
        track_X = None
        if ((tracker is not None or qmon is not None)
                and getattr(self.model, "gc_requires_data", False)):
            # data-dependent estimates (NAVAR's contribution stds) are
            # tracked on the first validation batch
            for X, _ in self._batches(val_ds):
                track_X = X
                break

        last_it = iter_start - 1
        policy = cfg.numerics if self._guard else None
        monitor = (numerics.DivergenceMonitor(policy)
                   if policy is not None else None)
        nstate = numerics.init_numerics_state()
        prev_skipped = 0
        # the fault points' global step index, per fit call as in JAX
        step_counter = 0
        aborted = None
        epochs = []
        # the background checkpoint writer (completion barrier at the next
        # save and at the fit's end)
        writer = (durable_ckpt.AsyncCheckpointWriter()
                  if save_dir and cfg.async_checkpointing else None)
        logger = MetricLogger(save_dir)
        # the env-armed liveness watchdog (REDCLIFF_WATCHDOG), its hang
        # incidents in this fit's metrics.jsonl
        wd = _watchdog.maybe_start(logger=logger)
        pw = _profiling.window_for(cfg, run_dir=save_dir,
                                   max_iter=cfg.max_iter, device=self.device)
        try:
            logger.log("fit_start", model=type(self.model).__name__,
                       shape=_schema.shape_desc(self.model.config),
                       train_config=cfg, resume_epoch=iter_start)
            # the predicted footprint from shapes: live params + the best
            # copy + Adam's two moments + the datasets
            mp = _obsmem.trainer_footprint(live, (live, live),
                                           extra_copies=1, train_ds=train_ds,
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
            # scoped around the loop: a window the epochs never closed
            # announces its truncated capture on the way out
            with pw, wd:
                for it in range(iter_start, cfg.max_iter):
                    _watchdog.stamp("epoch_engine")
                    pw.on_epoch_start(it)
                    t_epoch0 = time.perf_counter()
                    last_it = it
                    applied = skipped = 0
                    for X, Y in self._batches(train_ds, rng=rng):
                        _watchdog.stamp("batch_loop")
                        X = faultinject.poison_batch(X, step_counter)
                        skip = faultinject.skip_update(step_counter)
                        step_counter += 1
                        if skip:
                            continue
                        _, _, nstate, ok = self.train_step(
                            live, opt, X, Y, step_rng, nstate)
                        applied += int(ok)
                        skipped += int(not ok)

                    if tracker is not None:
                        self._epoch_gc_tracking(live, tracker, true_GC,
                                                track_X)
                    val = self.validate(live, val_ds)
                    histories["avg_forecasting_loss"].append(
                        val.get("forecasting_loss", 0.0))
                    histories["avg_adj_penalty"].append(
                        val.get("adj_l1_penalty", 0.0))
                    histories["avg_combo_loss"].append(val["combo_loss"])
                    criteria = self.criteria(live, val)
                    epoch_ms = (time.perf_counter() - t_epoch0) * 1e3

                    logger.log("epoch", epoch=it, criteria=criteria,
                               epoch_ms=round(epoch_ms, 3), **val,
                               **(tracker.latest_as_dict() if tracker
                                  else {}))
                    if qmon is not None and it % cfg.check_every == 0:
                        with torch.no_grad():
                            mats = [g.cpu().numpy() for g in self.model.gc(
                                live, ignore_lag=False,
                                **self.gc_kwargs(track_X))]
                        logger.log("quality", **qmon.update(
                            it, _obsquality.summarize_host(mats),
                            np.zeros(1, np.int32)))
                    pw.on_epoch_end(it, logger=logger)

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
                        if action.kind == "abort":
                            aborted = action.cause
                            # the abort dumps the flight recorder next to
                            # metrics.jsonl
                            fr = _flight.dump_for_logger(
                                logger, reason="numerics_abort",
                                extra={"epoch": it, "cause": action.cause})
                            logger.log("numerics", kind="abort", epoch=it,
                                       cause=action.cause, flight_record=fr,
                                       **nhost)
                        elif action.kind == "ok" and math.isfinite(criteria):
                            monitor.note_good(it, {
                                "params": live,
                                "opt_state": opt.state_dict()})
                    epochs.append({"epoch": it, "ms": epoch_ms,
                                   "steps": applied, "skipped": skipped,
                                   "action": None if action is None
                                   else action.kind})
                    if aborted is not None:
                        break
                    if action is not None and action.kind == "rollback":
                        # re-run from the snapshot, its learning rate
                        # backed off; no best or checkpoint update
                        snap = monitor.rollback()
                        assign_tree(live, snap["params"])
                        opt.load_state_dict(snap["opt_state"])
                        nstate = numerics.reset_consecutive(nstate)
                        logger.log(
                            "numerics", kind="rollback", epoch=it,
                            cause=action.cause,
                            restored_epoch=monitor.snapshot_epoch,
                            lr_scale=monitor.lr_scale,
                            learning_rates=numerics.current_learning_rates(
                                opt.state_dict()),
                            rollbacks=monitor.rollbacks)
                        if self._demotable and not self._demoted:
                            # the precision cliff: a mixed rollback demotes
                            # the fit to f32
                            self._demote_to_f32()
                            logger.log("precision", kind="demote",
                                       epoch=it, cause=action.cause,
                                       mode_from="mixed", mode_to="f32",
                                       rollbacks=monitor.rollbacks,
                                       **nhost)
                        continue

                    if criteria < best_loss:
                        best_loss = criteria
                        best_it = it
                        best_params = copy_tree(live)
                    elif best_it is not None and (it - best_it) == \
                            cfg.lookback * cfg.check_every:
                        if cfg.verbose:
                            print("Stopping early")
                        break

                    if it % cfg.check_every == 0 and save_dir:
                        self._save_checkpoint(save_dir, it, best_params, opt,
                                              live, histories, best_it,
                                              best_loss, tracker, rng,
                                              step_rng, prior_log + epochs,
                                              writer=writer)
                    if cfg.verbose and it % max(1, cfg.check_every) == 0:
                        print(f"epoch {it}: val_combo={val['combo_loss']:.5f} "
                              f"criteria={criteria:.5f}")

            final_val = self.validate(best_params, val_ds)
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
            logger.close()
            if writer is not None:
                # join the in-flight write on every exit path: a background
                # failure re-raises on a clean exit and is warned (not
                # masked) while another exception propagates
                writer.__exit__(*sys.exc_info())
        if save_dir:
            # the last trained epoch, so a resume with a larger max_iter
            # continues from where training stopped
            self._save_checkpoint(save_dir, last_it, best_params, opt, live,
                                  histories, best_it, best_loss, tracker,
                                  rng, step_rng, prior_log + epochs,
                                  writer=writer)
            if writer is not None:
                writer.wait()  # the final state is durable on return
        return FitResult(
            params=best_params,
            best_it=best_it if best_it is not None else 0,
            best_loss=float(best_loss), histories=histories, tracker=tracker,
            final_val_loss=final_val["combo_loss"], aborted=aborted,
            epochs=epochs, numerics=numerics.numerics_summary(nstate))

    def _save_checkpoint(self, save_dir, it, best_params, opt, live,
                         histories, best_it, best_loss, tracker, rng,
                         step_rng, epoch_log, writer=None):
        """The three durable files. The trainer checkpoint carries
        ``epoch_log``: the per-epoch records (``FitResult.epochs``) of every
        call on this save_dir. With a ``writer`` the loop's thread only
        snapshots (``runtime/checkpoint.host_snapshot`` of the tensor trees,
        deep copies of the host state) and the writer thread writes the
        same files from the snapshot."""
        tracker_meta = tracker.as_dict() if tracker is not None else None
        tracker_state = (None if tracker is None
                         else dict(tracker.__dict__))
        step_state = (None if step_rng is None
                      else step_rng.get_state().numpy())
        demoted = self._demoted
        if writer is None:
            self._write_checkpoint_files(
                save_dir, it, best_params, opt.state_dict(), live,
                histories, best_it, best_loss, tracker_meta, tracker_state,
                rng.bit_generator.state, step_state, epoch_log, demoted)
            return
        trees, ready = durable_ckpt.host_snapshot(
            (best_params, opt.state_dict(), live))
        host = copy.deepcopy((histories, tracker_meta, tracker_state,
                              rng.bit_generator.state, step_state,
                              epoch_log))

        def write():
            ready()
            self._write_checkpoint_files(
                save_dir, it, *trees, host[0], best_it, best_loss, *host[1:],
                demoted)
        writer.submit(write)

    def _write_checkpoint_files(self, save_dir, it, best_params, opt_state,
                                live, histories, best_it, best_loss,
                                tracker_meta, tracker_state, rng_state,
                                step_state, epoch_log, demoted=False):
        save_model(save_dir, self.model, best_params)
        meta = {"epoch": it, "best_loss": float(best_loss),
                "best_it": best_it, **histories}
        if tracker_meta is not None:
            meta.update(tracker_meta)
        durable_ckpt.write_checkpoint(
            os.path.join(save_dir,
                         "training_meta_data_and_hyper_parameters.pkl"), meta)
        durable_ckpt.write_checkpoint(
            os.path.join(save_dir, "trainer_checkpoint.pkl"),
            {
                "epoch": it,
                "params": params_to_jax(live),
                "best_params": params_to_jax(best_params),
                "opt_state": numerics.to_host(opt_state),
                "histories": histories,
                "best_it": best_it,
                "best_loss": float(best_loss),
                "tracker_state": tracker_state,
                "rng_state": rng_state,
                "step_rng_state": step_state,
                "epoch_log": epoch_log,
                # the sentinel's precision demotion (mixed -> f32)
                "precision_demoted": demoted,
            })
