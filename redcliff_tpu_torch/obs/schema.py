"""Versioned event-schema registry of the telemetry spine (port of
``redcliff_tpu/obs/schema.py``; stdlib only).

Every line the port writes to ``metrics.jsonl`` is one of the event types
registered here. The JAX package's registry is closed and the port cannot
extend it, so the port keeps its own, with the same contract: an unknown
event name, a missing required field, or a field that is neither
registered nor matched by one of the event's ``patterns`` is an error.
Records from older writers may lack the ``seq``/``pid``/``host`` identity
fields, so those are optional everywhere.

``EVENTS``, ``LEDGER_EVENTS``, ``SPAN_NAMES``, :func:`validate_record(s)
<validate_record>`, :func:`shape_desc` and :func:`shape_key` are the JAX
package's, field for field, so one record contract holds for both packages
and later slices find their events here. The differences:

* emitter descriptions (prose, never validated) say ``torch.profiler``
  for ``jax.profiler`` (``profile``) and ``torch.cuda.memory_stats`` for
  ``device.memory_stats()`` (``memory``), and drop the JAX package's
  ticket references (``precision``, ``policy``, ``preempt``, ``packing``,
  ``partial_result``, ``fleet_lifecycle``, ``serve_ladder``);
* the error messages name this module;
* :func:`check_sources` scans ``redcliff_tpu_torch/``, and the JAX
  package's two import lists (``NO_JAX_MODULES``, ``LAZY_JAX_MODULES``)
  become one, :data:`NO_CUDA_AT_IMPORT_MODULES`: the observability and
  fault modules, which must import with no CUDA work (no kernel module or
  Triton at module scope) and never synchronize the device; and the fleet's
  control modules, :data:`NO_BACKEND_MODULES`, import no torch at all
  (the JAX list's fleet half).

Run the source tripwires as a lint step with ``python -m
redcliff_tpu_torch.obs.schema --check``.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

__all__ = ["SCHEMA_VERSION", "EventSchema", "EVENTS", "LEDGER_EVENTS",
           "validate_record", "validate_records", "SHAPE_KEYS", "shape_desc",
           "shape_key", "SPAN_NAMES", "check_sources", "main"]

SCHEMA_VERSION = 1

# model-config fields that key a compiled program family: with the grid
# width they form the (shape, G-bucket) axis of the obs report's cost table
# (the input ROADMAP item 4's learned cost model trains on). Emitters stamp
# the subset their model config defines into fit_start's "shape" field.
SHAPE_KEYS = ("num_chans", "gen_lag", "embed_lag", "max_lag", "num_factors",
              "num_supervised_factors", "gen_hidden", "embed_hidden_sizes",
              "input_length", "num_sims")


def shape_desc(config):
    """The ``fit_start.shape`` dict for a model config: every
    :data:`SHAPE_KEYS` field the config defines (non-None)."""
    return {k: getattr(config, k) for k in SHAPE_KEYS
            if getattr(config, k, None) is not None}


def _shape_val(v):
    # normalize through the same tuple->list coercion the jsonl round trip
    # applies, so a key computed live (config tuples) and one computed from
    # re-read metrics (JSON lists) are IDENTICAL — the cost-model store
    # merges on this string
    if isinstance(v, tuple):
        v = list(v)
    if isinstance(v, list):
        return "[" + ", ".join(str(_shape_val(x)) for x in v) + "]"
    return v


def shape_key(shape):
    """Canonical string key for a ``fit_start.shape`` dict — the shape half
    of the (shape, G-bucket) cost axis shared by the obs report's cost
    table and the learned cost model's store (obs/costmodel.py). Stable
    across the metrics round trip (tuples serialize as JSON lists)."""
    if not isinstance(shape, dict) or not shape:
        return "unknown"
    return ",".join(f"{k}={_shape_val(shape[k])}" for k in sorted(shape))


# the CLOSED span-name registry: every `obs.span(...)` / `record_span(...)`
# name literal in redcliff_tpu_torch/ must appear here — enforced by the
# AST source tripwire below, the span analog of the event registry
SPAN_NAMES = frozenset({
    "grid.dispatch", "grid.check_window", "grid.compaction", "grid.remesh",
    "grid.ckpt_save",
    "ckpt.write", "ckpt.async_write", "ckpt.submit_barrier",
    "prefetch.fill", "prefetch.stall", "shard.load",
    "fleet.plan", "fleet.batch",
    "serve.dispatch",
})

# identity fields the MetricLogger stamps on every record (schema v1);
# optional on read: pre-v1 files and third-party writers lack them.
# ``trace`` is the cross-process half: the trace context ({"batch_id",
# "trace_ids": {request_id: trace_id}}) stamped on every record — and every
# emitted span — a process writes while it serves a batch
# (spans.set_trace_ctx / REDCLIFF_TRACE_CTX)
_IDENTITY = ("seq", "pid", "host", "trace")

# numerics-sentinel summary fields (runtime/numerics.py numerics_summary),
# splatted into anomaly/numerics events by the trainers
_NUMERICS_SUMMARY = ("skipped", "consecutive", "checked", "grad_norm_last",
                     "grad_norm_mean", "grad_norm_std", "grad_norm_max")

# hang/host-loss incident body (runtime/watchdog.py _record)
_INCIDENT = ("components", "ages_s", "grace_s", "stacks", "host")


@dataclass(frozen=True)
class EventSchema:
    """One registered event type. ``required``/``optional`` are field names
    beyond the registry-wide core fields; ``patterns`` are regexes that
    admit dynamic field families."""

    emitter: str
    required: frozenset = frozenset()
    optional: frozenset = frozenset()
    patterns: tuple = ()
    version: int = SCHEMA_VERSION
    _compiled: tuple = field(default=None, compare=False, repr=False)

    def allows(self, name):
        if name in self.required or name in self.optional:
            return True
        compiled = self._compiled
        if compiled is None:
            compiled = tuple(re.compile(p) for p in self.patterns)
            object.__setattr__(self, "_compiled", compiled)
        return any(p.match(name) for p in compiled)


def _ev(emitter, required=(), optional=(), patterns=()):
    return EventSchema(emitter=emitter, required=frozenset(required),
                       optional=frozenset(optional), patterns=tuple(patterns))


# ---------------------------------------------------------------------------
# metrics.jsonl events. Core fields: event + wall_time required (the
# MetricLogger stamps both), seq/pid/host optional-on-read.
# ---------------------------------------------------------------------------
EVENTS = {
    "fit_start": _ev(
        "trainers + grid engine",
        required=("model",),
        optional=("train_config", "resume_epoch", "training_mode", "shape",
                  "grid_size", "grid_width", "lanes_padded", "stream_mode",
                  "mesh", "compile_cache_dir", "resumed_from_epoch",
                  "resumed_from", "points", "max_iter", "precision_mode")),
    "epoch": _ev(
        "trainers + grid engine",
        required=("epoch",),
        optional=("phases", "criteria", "epoch_ms",
                  # grid per-check-window fields
                  "val_combo_loss", "best_criteria", "num_active",
                  "lanes_live", "grid_width", "lanes_padded",
                  "num_quarantined", "guarded_steps_skipped"),
        patterns=(
            # the trainers splat validate() loss parts and the GC tracker's
            # per-threshold/per-factor oracle metrics into the record
            r".*_loss$", r".*_penalty$", r".*_sim$",
            r"^(f1|roc_auc|accuracy|precision|recall|deltacon0|"
            r"deltaffinity|gc_l1|cosine_sim|confusion)_[A-Za-z0-9._\-]+$")),
    "anomaly": _ev(
        "numerics sentinel (trainers)",
        required=("epoch", "cause"),
        optional=("epoch_skipped_steps",) + _NUMERICS_SUMMARY),
    "numerics": _ev(
        "DivergenceMonitor (trainers)",
        required=("epoch", "kind", "cause"),
        optional=("restored_epoch", "lr_scale", "learning_rates",
                  "rollbacks", "flight_record") + _NUMERICS_SUMMARY),
    "fit_end": _ev(
        "trainers + grid engine",
        optional=("best_it", "best_loss", "final_val_loss", "aborted",
                  "best_epoch", "best_criteria", "num_active", "compactions",
                  "compile_ms", "failures", "dispatch_stats",
                  # model-quality snapshot (obs/quality.py): the trainers
                  # stamp it directly; the grid engine carries it inside
                  # dispatch_stats["quality"]
                  "quality")),
    "precision": _ev(
        "trainers + grid engine + serve (mixed-precision production path: "
        "kind=demote — the numerics sentinel caught a "
        "skip/rollback storm under precision_mode='mixed' and the fit "
        "rebuilt every step at f32; kind=resume_demoted — a resumed fit "
        "honored the checkpointed demotion instead of re-promoting. The "
        "same pair is scoped to the serve table — scope='serve', "
        "tick-indexed instead of epoch-indexed: a poisoned-lane storm "
        "inside the sentinel window demotes the whole slot table to f32)",
        required=("kind",),
        optional=("epoch", "cause", "mode_from", "mode_to", "lanes",
                  "grid_width", "rollbacks", "scope", "ticks",
                  "lanes_poisoned", "window_ticks") + _NUMERICS_SUMMARY),
    "autotune": _ev(
        "trainers + grid engine (ops/autotune.py kernel-tiling search/"
        "lookup records: kind=search — a measured candidate-ladder search "
        "ran and persisted a winner beside the compile cache; kind=reuse "
        "— a persisted winner was loaded with zero search steps)",
        required=("kernel",),
        optional=("kind", "platform", "shape", "g_bucket", "tile",
                  "candidates", "search_ms", "search_steps",
                  "speedup_vs_default")),
    "compile": _ev(
        "grid engine (runtime/compileobs.py counters)",
        required=("epoch", "programs", "compile_ms"),
        optional=("cache_hits", "cache_misses", "grid_width")),
    "compaction": _ev(
        "grid engine (parallel/compaction.py)",
        required=("epoch", "from_width", "to_width"),
        optional=("lanes_live", "retired", "mesh_devices")),
    "remesh": _ev(
        "grid engine (parallel/remesh.py)",
        required=("epoch",),
        optional=("from_width", "to_width", "from_devices", "to_devices",
                  "lanes_migrated", "lanes_retired", "plan_ms")),
    "deadline_evicted": _ev(
        "grid engine (GridSpec.fit_deadline_s)",
        required=("epoch", "lanes"),
        optional=("elapsed_s", "num_evicted")),
    "early_exit_all_inactive": _ev("grid engine", required=("epoch",)),
    "preempted_final_checkpoint": _ev(
        "grid engine (PreemptionGuard)",
        required=("epoch",), optional=("signum",)),
    "grid_deadline_final_checkpoint": _ev(
        "grid engine (GridSpec.grid_deadline_s)",
        required=("epoch",),
        optional=("elapsed_s", "deadline_s", "checkpointed")),
    "hang": _ev("watchdog", required=("components",), optional=_INCIDENT),
    "hang_exit": _ev(
        "watchdog", required=("exit_code",), optional=_INCIDENT),
    "host_lost": _ev(
        "watchdog", required=("components",), optional=_INCIDENT),
    "host_lost_exit": _ev(
        "watchdog", required=("exit_code",), optional=_INCIDENT),
    "span": _ev(
        "obs.spans (emit=True call sites)",
        required=("name", "dur_ms"),
        optional=("span_id", "parent_id", "t_wall", "t_mono", "component",
                  "attrs", "error")),
    "flight_record": _ev(
        "obs.flight (artifact file, not a jsonl line)",
        required=("reason", "components"),
        optional=("schema_version", "extra")),
    "cost_model": _ev(
        "grid engine (obs/costmodel.py prediction-vs-actual scoring, one "
        "per check window once a prediction exists)",
        required=("epoch", "predicted_epoch_ms", "actual_epoch_ms"),
        optional=("residual_pct", "grid_width", "source", "eta_s",
                  "epochs_remaining", "samples", "mape_pct",
                  "predicted_compile_ms")),
    "policy": _ev(
        "predictive scheduling policy (parallel/policy.py "
        "decisions consulted from the learned cost model, logged by the "
        "grid engine and the fleet worker; kind=initial_width — the priced "
        "starting-rung choice at fit start; kind=compaction — the "
        "compact/hold/fallback pricing of one check window's ladder move; "
        "kind=compile_order — the worker's cold-compile claim ordering "
        "over one admission plan; kind=preempt_price — the worker's "
        "deadline-aware hold/preempt pricing of a queued tenant against "
        "the running batch)",
        required=("kind",),
        optional=("epoch", "grid_width", "action", "fallback",
                  "from_width", "to_width", "chosen_width",
                  "heuristic_width", "saving_ms", "compile_ms", "gather_ms",
                  "total_ms", "heuristic_ms", "epochs", "epochs_remaining",
                  "order", "batch_id", "request_id", "beneficiary",
                  "deadline_at", "eta_s", "queued_eta_s", "running_rem_s",
                  "grace_s", "slack_s", "priority", "worker", "reason")),
    "preempt": _ev(
        "fleet worker deadline-aware preemption ("
        "kind=signal — the worker decided a queued higher-priority "
        "tenant's deadline would be missed and SIGTERMed the supervised "
        "batch child after its checkpoint landed; kind=preempted — the "
        "batch settled as a zero-charge reclaim: leases released, "
        "composition pinned to resume bit-identically after the "
        "beneficiary runs)",
        required=("kind",),
        optional=("batch_id", "requests", "tenants", "beneficiary",
                  "tenant", "priority", "deadline_at", "eta_s",
                  "queued_eta_s", "running_rem_s", "slack_s", "grace_s",
                  "worker", "run_dir", "reason", "epoch")),
    "memory": _ev(
        "grid engine + trainers (obs/memory.py: kind=predicted — the "
        "analytical device-memory footprint at fit start; kind=measured — a "
        "torch.cuda.memory_stats watermark poll, check-window cadence, only "
        "on backends that report)",
        required=("kind",),
        optional=("epoch", "g_bucket", "grid_width", "predicted_bytes",
                  "params_bytes", "opt_bytes", "best_bytes",
                  "per_lane_bytes", "dataset_bytes", "epoch_gather_bytes",
                  "bytes_in_use", "peak_bytes", "bytes_limit",
                  "budget_bytes", "headroom_bytes", "fits", "backend",
                  "device_kind", "n_devices", "note")),
    "quality": _ev(
        "grid engine + trainers (obs/quality.py: one per check window when "
        "REDCLIFF_QUALITY=1 — per-lane Granger-graph summaries keyed by "
        "original point id, convergence diagnostics, and live AUROC/AUPR "
        "when the dataset carries ground-truth graphs)",
        required=("epoch", "lanes"),
        optional=("grid_width", "mode", "topk_k", "edge_energy", "sparsity",
                  "entropy", "topk_hash", "jaccard", "plateaued", "auroc",
                  "aupr", "mean_jaccard", "mean_auroc", "mean_aupr",
                  "plateaued_count")),
    "profile": _ev(
        "obs/profiling.py capture windows (announces the torch.profiler "
        "Chrome trace a bounded window wrote under the run dir)",
        required=("path",),
        optional=("spec", "first_epoch", "last_epoch", "dur_ms",
                  "truncated")),
    "watch": _ev(
        "obs.watch (snapshot artifact / --once --json output, not a jsonl "
        "line; the serve block carries the elastic-data-plane posture — "
        "watch.serve.rung is the resident rung width vs capacity, "
        "watch.serve.fused_samples the cumulative fusion credit)",
        required=("run_dir", "fits"),
        optional=("schema_version", "ok", "grid_eta_s", "stalls", "numerics",
                  "heartbeats", "attempts", "incidents", "read_audit",
                  "memory", "fleet", "quality", "policy", "preempt",
                  "serve", "packing")),
    "fleet": _ev(
        "fleet sweep service (redcliff_tpu/fleet: submit CLI, planner, "
        "worker loop, run_batch driver, containment layer; kind=submit | "
        "plan | claim | reclaim | batch_start | batch_end | complete | "
        "lease_lost | renew_error | deadletter | bisect | cancel | requeue "
        "| manifest | worker_start | worker_stop | worker_crash)",
        required=("kind",),
        optional=("batch_id", "requests", "tenants", "n_points", "g_bucket",
                  "queue_depth", "batches", "unschedulable", "plan_ms",
                  "utilization_pct", "decisions", "eta_s",
                  "predicted_bytes", "run_dir", "worker", "classification",
                  "rc", "attempts", "wall_s", "done", "failed", "released",
                  "priority", "n_devices", "budget_bytes", "lease_s",
                  # containment fields: retry budgets, bisection,
                  # dead-letter routing, heartbeat renewal escalation,
                  # suspect-solo planning
                  "reason", "halves", "error", "consecutive", "suspects",
                  "deadlettered", "bisected", "max_attempts", "preempted",
                  # worker_crash: the uncaught-exception record
                  # + the flight-record artifact dumped before exit
                  "flight_record",
                  # spatial packing fields: the sub-mesh slot a
                  # batch ran on, the plan's priced packed-vs-serial
                  # verdict, and the fair-share deferrals the planner made
                  "slot", "packing", "quota_deferred")),
    "packing": _ev(
        "fleet spatial mesh packing (fleet/worker.py gang loop "
        "over parallel/packing.py's slot table; kind=plan — the priced "
        "packed-vs-serial verdict for the current queue; kind=slot_claim "
        "| slot_free — a sub-mesh slot occupied/returned at a "
        "check-window boundary; kind=slot_wait — a reclaim whose recorded "
        "slot is still busy; kind=cancel_stop — the cancel watch SIGTERMed "
        "a batch whose every member went terminal; kind=slot_canceled — "
        "that batch settled with its slot freed and no requeue)",
        required=("kind",),
        optional=("batch_id", "slot", "requests", "tenants",
                  "predicted_bytes", "worker", "decision", "reason",
                  "makespan_s", "serial_s", "makespan_ratio", "n_devices",
                  "pool", "headroom_violations")),
    "partial_result": _ev(
        "fleet per-point result streaming (fleet/run_batch.py — "
        "one line per grid point appended to results/<id>.partial.jsonl "
        "as lanes retire at check windows; final=True rows are the "
        "settle-time completion sweep, at-least-once so consumers keep "
        "the last row per point)",
        required=("request_id", "batch_id", "point", "final"),
        optional=("tenant", "merged_point", "epoch", "best_criterion",
                  "best_epoch", "failed")),
    "fleet_lifecycle": _ev(
        "fleet history ledger (fleet/history.py — the durable per-request "
        "lifecycle transitions obs/slo.py and the fleet trace export join; "
        "kind=submitted | planned | claimed | attempt | released | "
        "bisected | settled | requeued | preempted — the zero-charge "
        "checkpoint-and-yield transition the deadline-aware "
        "preemption records — | autoscale | qos — the durable "
        "pool-scaling and QoS-rung transitions, what `obs trace --fleet` "
        "joins scaling decisions from)",
        required=("kind",),
        optional=("request_id", "trace_id", "batch_id", "tenant", "worker",
                  "state", "classification", "attempt", "attempts",
                  "started_at", "requests", "trace_ids", "halves", "reason",
                  "priority", "deadline_s", "n_points", "submitted_at",
                  "g_bucket", "reclaim", "run_dir", "parent_batch_id",
                  "beneficiary", "workers", "target", "rung")),
    "autoscale": _ev(
        "fleet autoscaler (fleet/autoscale.py — the SLO-driven control "
        "loop's decision stream in the fleet root's metrics chain; "
        "kind=start | scale_up | respawn | scale_down | hold | stop)",
        required=("kind",),
        optional=("workers", "target", "max_workers", "min_workers",
                  "reason", "queue_depth", "drain_eta_s", "target_drain_s",
                  "window_s", "breaches", "spawned", "retired", "worker",
                  "classification", "restarts", "pending", "ticks")),
    "qos": _ev(
        "fleet autoscaler degraded-QoS ladder (fleet/autoscale.py — a "
        "breaching tenant demoted to cheaper settings instead of "
        "dead-lining; kind=demote | restore)",
        required=("kind", "tenant"),
        optional=("rung", "from_rung", "reason", "precision_mode",
                  "check_every_factor", "window_s", "worker")),
    "backpressure": _ev(
        "fleet queue admission gate (fleet/queue.py submit — the "
        "structured reject-with-ETA when predicted queue wait would "
        "breach the tenant's armed queue-wait SLO; kind=reject)",
        required=("kind", "tenant"),
        optional=("eta_s", "threshold_s", "queue_depth", "workers",
                  "n_points", "priority", "reason")),
    "serve": _ev(
        "streaming inference service (redcliff_tpu/serve/service.py — the "
        "slot-table serving loop's operational stream; kind=start | resume "
        "| tick | qos | reject | overflow | drain | stop. qos is the "
        "per-STREAM degraded graph-readout cadence ladder — the serve twin "
        "of the fleet's per-tenant qos event; reject is the SlotsExhausted "
        "admission refusal with lease-expiry ETA)",
        required=("kind",),
        optional=("capacity", "streams", "free_slots", "ticks",
                  "samples_in", "samples_out", "rejects", "dropped",
                  "p50_ms", "p99_ms", "n", "eta_s", "reason", "sid",
                  "trace_id", "rung", "from_rung", "cadence", "backlog",
                  "checkpoint", "resumed", "undelivered", "model_class",
                  # elastic data plane: resident rung width,
                  # live high-water mark, fusion + precision posture
                  "width", "live", "fused_samples", "mode", "fuse",
                  "precision_mode")),
    "serve_ladder": _ev(
        "serve occupancy ladder (redcliff_tpu/serve/service.py ServeLadder "
        "— the slot table's pow2 rung decisions at tick boundaries; "
        "kind=grow | shrink | hold | fallback | repack. grow is mandatory "
        "(a leased slot beyond the rung would never dispatch), shrink is "
        "priced through the cost store (predicted dead-lane saving "
        "over the horizon vs cold-compile cost), hold/fallback record a "
        "declined or unpriceable shrink once per hysteresis episode, and "
        "repack is the cross-geometry resume that re-packs lanes instead "
        "of failing the shape check)",
        required=("kind",),
        optional=("from_width", "to_width", "live", "capacity", "mode",
                  "cold", "saving_ms", "compile_ms", "horizon_ticks",
                  "reason", "ticks", "streams", "from_capacity")),
    "serve_fuse": _ev(
        "serve micro-batched tick fusion (redcliff_tpu/serve/service.py — "
        "periodic fusion stats at the tick-event cadence when "
        "REDCLIFF_SERVE_FUSE > 1; kind=stats. hist maps per-stream fused "
        "take -> dispatch count — the fuse depth distribution obs report "
        "renders)",
        required=("kind",),
        optional=("depth", "fused_samples", "hist", "ticks", "width")),
    "session": _ev(
        "serve session lifecycle (redcliff_tpu/serve/service.py over "
        "serve/session.py's lease/heartbeat registry; kind=connect | "
        "disconnect | expire | quarantine | recycle | resume — expire is "
        "the lease reaper, quarantine the per-stream input-contract "
        "verdict, recycle the lane reset that returns a slot to the pool)",
        required=("kind", "sid"),
        optional=("slot", "trace_id", "reason", "samples_in", "samples_out",
                  "lease_s", "state", "undelivered")),
    "regression": _ev(
        "obs.regress (bench-artifact sentinel block, not a jsonl line)",
        required=("regressions",),
        optional=("schema_version", "current_round", "rounds_compared",
                  "families_checked", "improvements", "skipped", "notes",
                  "tpu_cache")),
}

# ---------------------------------------------------------------------------
# run_ledger.jsonl events (runtime/supervisor.py): stdlib writer, no
# wall_time core field (attempts carry started_at instead)
# ---------------------------------------------------------------------------
LEDGER_EVENTS = {
    "attempt": _ev(
        "supervisor",
        required=("attempt", "cmd", "rc", "classification", "action"),
        optional=("backoff_s", "started_at", "duration_s", "mesh", "eta")),
    "remesh": _ev(
        "supervisor",
        required=("from_devices", "to_devices"),
        optional=("from_hosts", "to_hosts")),
    "final": _ev(
        "supervisor",
        required=("classification",), optional=("rc", "attempts")),
    "fleet": _ev(
        "fleet worker (tenant manifest: request id -> merged point range, "
        "the per-tenant attribution map obs report joins on)",
        required=("kind",),
        optional=("batch_id", "requests", "worker", "tenants")),
}


def _registry_for(kind):
    if kind == "metrics":
        return EVENTS, ("event", "wall_time")
    if kind == "ledger":
        return LEDGER_EVENTS, ("event",)
    raise ValueError(f"unknown registry kind {kind!r}")


def validate_record(rec, kind="metrics"):
    """Validate one record against the registry; returns a list of error
    strings (empty = valid)."""
    registry, core_required = _registry_for(kind)
    if not isinstance(rec, dict):
        return [f"record is not an object: {type(rec).__name__}"]
    errors = []
    name = rec.get("event")
    if name is None:
        return ["missing 'event' field"]
    schema = registry.get(name)
    if schema is None:
        return [f"unknown event type {name!r} (register it in "
                f"redcliff_tpu_torch/obs/schema.py)"]
    for f_ in core_required:
        if f_ not in rec:
            errors.append(f"{name}: missing core field {f_!r}")
    for f_ in sorted(schema.required):
        if f_ not in rec:
            errors.append(f"{name}: missing required field {f_!r}")
    known_core = set(core_required) | set(_IDENTITY)
    for f_ in rec:
        if f_ in known_core:
            continue
        if not schema.allows(f_):
            errors.append(
                f"{name}: unregistered field {f_!r} (add it to the event's "
                f"schema in redcliff_tpu_torch/obs/schema.py)")
    return errors


def validate_records(records, kind="metrics"):
    """Validate a sequence of records; returns ``[(index, [errors...])]``
    for every invalid record (empty list = all valid)."""
    out = []
    for i, rec in enumerate(records):
        errs = validate_record(rec, kind=kind)
        if errs:
            out.append((i, errs))
    return out


# ---------------------------------------------------------------------------
# standalone source tripwires: ``python -m redcliff_tpu_torch.obs.schema
# --check`` runs the AST-level registry and import scans as a lint entry
# point (tests/test_torch_obs.py drives them too). stdlib only.
# ---------------------------------------------------------------------------

# the observability and fault modules: importing one must do no CUDA work
# (no kernel module, no Triton at module scope; kernels are built at first
# launch), and none may synchronize the device — a sync inside the
# observability layer would serialize what it observes
NO_CUDA_AT_IMPORT_MODULES = (
    "obs/__init__.py", "obs/spans.py", "obs/flight.py", "obs/schema.py",
    "obs/logging.py", "obs/memory.py", "obs/profiling.py", "obs/quality.py",
    "obs/costmodel.py", "obs/slo.py", "runtime/admission.py",
    "runtime/compileobs.py", "runtime/faultinject.py", "runtime/watchdog.py",
    "runtime/retry.py", "serve/chaos.py", "utils/observability.py")
# the fleet's control processes (the CLI, queue scans, admission planning,
# the worker loop, the autoscaler, the chaos harness, the crash-loop
# supervisor and the slot table): they may not import torch at all, at any
# scope — a control process never initializes a backend; only the
# supervised ``fleet/run_batch.py`` child does
NO_BACKEND_MODULES = (
    "fleet/__init__.py", "fleet/__main__.py", "fleet/autoscale.py",
    "fleet/chaos.py", "fleet/history.py", "fleet/planner.py",
    "fleet/queue.py", "fleet/worker.py", "parallel/packing.py",
    "runtime/supervisor.py", "supervise.py", "utils/precision_modes.py")
# module-scope imports these modules may not make
_CUDA_AT_IMPORT = ("triton", "redcliff_tpu_torch.ops")
_BACKENDS = ("torch", "triton")
_DEVICE_SYNCS = ("synchronize", "block_until_ready")


def _pkg_root():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _iter_sources(pkg_root):
    for dirpath, _dirs, files in os.walk(pkg_root):
        if "__pycache__" in dirpath:
            continue
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _check_name_literals(tree, path, events, errors):
    """Every event/span name LITERAL must be registered: ``log("<event>")``
    -> EVENTS u LEDGER_EVENTS, ``span``/``record_span`` -> SPAN_NAMES, and
    dict literals carrying ``"event": "<name>"`` (the stdlib writers)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            fname = (fn.id if isinstance(fn, ast.Name)
                     else fn.attr if isinstance(fn, ast.Attribute)
                     else None)
            if not (fname in ("span", "record_span", "log") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            if fname == "log":
                if name not in events:
                    errors.append(f"{path}:{node.lineno}: unregistered "
                                  f"event literal {name!r}")
            elif name not in SPAN_NAMES:
                errors.append(f"{path}:{node.lineno}: unregistered span "
                              f"literal {name!r}")
        elif isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (isinstance(k, ast.Constant) and k.value == "event"
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)
                        and v.value not in events):
                    errors.append(f"{path}:{node.lineno}: unregistered "
                                  f"event literal {v.value!r}")


def _check_host_sync(tree, path, rel, errors):
    """The import and no-sync discipline: no module of the port imports
    ``jax`` or ``redcliff_tpu``; the :data:`NO_BACKEND_MODULES` import no
    torch at any scope; the :data:`NO_CUDA_AT_IMPORT_MODULES` import no
    kernel module or Triton at module scope and never call
    ``synchronize``."""
    scoped = rel.endswith(NO_CUDA_AT_IMPORT_MODULES)
    no_backend = rel in NO_BACKEND_MODULES
    in_func = set()
    if scoped:
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(fn):
                    in_func.add(id(sub))
    for node in ast.walk(tree):
        if scoped and isinstance(node, ast.Attribute) \
                and node.attr in _DEVICE_SYNCS:
            errors.append(f"{path}:{node.lineno}: {node.attr} in an "
                          f"observability module (device sync)")
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            if n.split(".")[0] in ("jax", "redcliff_tpu"):
                errors.append(f"{path}:{node.lineno}: imports {n}")
            elif no_backend and n.split(".")[0] in _BACKENDS:
                errors.append(f"{path}:{node.lineno}: imports {n} in a "
                              f"fleet control module (a backend)")
            elif scoped and id(node) not in in_func and any(
                    n == m or n.startswith(m + ".")
                    for m in _CUDA_AT_IMPORT):
                errors.append(f"{path}:{node.lineno}: imports {n} at "
                              f"module scope (CUDA work at import)")


def check_sources(pkg_root=None):
    """Run every source tripwire over ``redcliff_tpu_torch/``; returns a
    list of ``"path:line: message"`` violations (empty = clean)."""
    pkg_root = pkg_root or _pkg_root()
    events = set(EVENTS) | set(LEDGER_EVENTS)
    errors = []
    for path in sorted(_iter_sources(pkg_root)):
        with open(path) as f:
            try:
                tree = ast.parse(f.read(), filename=path)
            except SyntaxError as e:
                errors.append(f"{path}: syntax error: {e}")
                continue
        rel = os.path.relpath(path, pkg_root).replace(os.sep, "/")
        _check_name_literals(tree, path, events, errors)
        _check_host_sync(tree, path, rel, errors)
    return errors


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m redcliff_tpu_torch.obs.schema",
        description="Event-schema registry tools: --check runs the AST "
                    "source tripwires (event/span literal registration, "
                    "the import and no-sync discipline) as a lint step; "
                    "exits 1 on any violation.")
    ap.add_argument("--check", action="store_true",
                    help="scan redcliff_tpu_torch/ sources for "
                         "unregistered event/span literals and import or "
                         "sync violations")
    args = ap.parse_args(argv)
    if not args.check:
        ap.print_help()
        return 2
    errors = check_sources()
    for e in errors:
        print(e)
    print(f"schema --check: {len(errors)} violation(s); "
          f"{len(EVENTS)} metric + {len(LEDGER_EVENTS)} ledger event "
          f"type(s), {len(SPAN_NAMES)} span name(s) registered "
          f"(schema v{SCHEMA_VERSION})")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
