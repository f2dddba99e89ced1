"""Live run watch: what is this run doing RIGHT NOW, and when will it end?
(port of ``obs/watch.py``, a copy on the port's modules).

``python -m redcliff_tpu_torch.obs watch <run_dir>`` tails a run directory's
telemetry — ``metrics.jsonl`` (rotation chain, torn mid-append tails
tolerated) + ``run_ledger.jsonl`` + the ``dispatch_stats`` snapshot inside
``grid_checkpoint.pkl`` — and renders the operator view the report CLI's
post-mortem join cannot give: lanes live, the current G-bucket, epoch rate,
the stall breakdown (ckpt / barrier / prefetch / compile), numerics skip
counters, heartbeat ages, and the learned cost model's ETA per fit and for
the whole run (``cost_model`` events, obs/costmodel.py).

Follow mode re-snapshots the whole rotation chain every ``--interval``
seconds rather than holding a file offset: a chain re-read is O(run dir)
and therefore cheap at metrics scale, and it is the only approach that is
automatically correct across rotation boundaries (``metrics.jsonl`` ->
``.1``), truncation, a writer SIGKILLed mid-append, and a supervisor
restart swapping the writing pid — every case a byte-offset tail gets
wrong. The snapshot also carries the device-memory view (obs/memory.py):
the newest measured HBM watermark + the analytical prediction, rendered
as a live ``hbm:`` line (``n/a (backend)`` where ``memory_stats()`` is
unsupported).

``--once`` prints a single snapshot and exits; ``--once --json`` prints the
snapshot as one strict-JSON object that validates against the registered
``watch`` event schema (:mod:`redcliff_tpu_torch.obs.schema`) — the scriptable /
testable contract. A missing or telemetry-less run dir exits with code 2
and a one-line diagnosis (never a traceback).

"Heartbeat ages" here are the OUTSIDE view: seconds since each telemetry
source (metrics file mtime, newest record, newest ``epoch`` event, newest
emitted span per component, ledger) last moved. The in-process watchdog
(runtime/watchdog.py) owns the authoritative in-memory heartbeat registry;
a watcher on another host only sees what reached disk.

The port's differences from the JAX module: the ``hbm:`` line reads the
``memory`` events the port's ``obs/memory.py`` writes (the allocator's
watermark on a card, none on the CPU). A fleet sweep-service root (the
port's ``fleet/``) gets the JAX module's fleet and packing sections.
"""
from __future__ import annotations

import json
import os
import sys
import time

from redcliff_tpu_torch.obs import schema as _schema
from redcliff_tpu_torch.obs.logging import jsonl_files, read_jsonl

__all__ = ["build_snapshot", "render_text", "diagnose_run_dir", "run_watch",
           "is_fleet_root"]


def is_fleet_root(path):
    """Whether ``path`` is a fleet sweep-service root (fleet/queue.py
    layout) rather than a single-run directory — flips the watch into
    FLEET mode (queue depth, per-tenant in-flight, planner decisions)."""
    return (os.path.exists(os.path.join(path, "requests.jsonl"))
            or os.path.isdir(os.path.join(path, "leases")))


def diagnose_run_dir(run_dir):
    """One-line diagnosis for an unwatchable run dir, or None when it holds
    telemetry (shared by the report CLI's exit-2 contract)."""
    if not os.path.exists(run_dir):
        return f"run dir does not exist: {run_dir}"
    if not os.path.isdir(run_dir):
        return f"not a directory: {run_dir}"
    if (not jsonl_files(os.path.join(run_dir, "metrics.jsonl"))
            and not os.path.exists(os.path.join(run_dir,
                                                "run_ledger.jsonl"))
            and not is_fleet_root(run_dir)):
        return (f"no telemetry in {run_dir}: neither metrics.jsonl (or its "
                f"rotation chain) nor run_ledger.jsonl nor a fleet queue "
                f"(requests.jsonl) — is this a run directory?")
    return None


def _fit_view(rec):
    shape = rec.get("shape")
    return {
        "model": rec.get("model"),
        "shape": _schema.shape_key(shape),
        "grid_size": rec.get("grid_size"),
        "grid_width": rec.get("grid_width"),   # updated by compaction/remesh
        "stream_mode": rec.get("stream_mode"),
        "max_iter": rec.get("max_iter"),
        "started_wall": rec.get("wall_time"),
        "resumed_from_epoch": rec.get("resumed_from_epoch"),
        "last_epoch": None, "lanes_live": None, "num_quarantined": 0,
        "guarded_steps_skipped": 0, "epoch_ms_last": None,
        "epochs_seen": 0, "first_epoch": None, "first_epoch_wall": None,
        "last_epoch_wall": None, "epoch_rate_per_min": None,
        "eta": None, "done": False,
        # a later fit_start in the same metrics chain (a supervisor
        # re-attempt / resume) supersedes this one: it is no longer live
        # even though it never wrote a fit_end (it crashed/was killed)
        "superseded": False,
    }


def _fit_eta(fit, now):
    """Remaining-work estimate for one fit: the newest ``cost_model``
    event's ETA discounted by the time since it was computed; fallback —
    extrapolate the observed check-window epoch rate to ``max_iter``."""
    cm = fit.pop("_cost_model_last", None)
    if cm is not None and isinstance(cm.get("eta_s"), (int, float)):
        age = max(now - (cm.get("wall_time") or now), 0.0)
        return {"eta_s": round(max(cm["eta_s"] - age, 0.0), 3),
                "source": f"cost_model:{cm.get('source') or '?'}",
                "predicted_epoch_ms": cm.get("predicted_epoch_ms"),
                "epochs_remaining": cm.get("epochs_remaining"),
                "as_of_epoch": cm.get("epoch")}
    rate = fit.get("epoch_rate_per_min")
    if (rate and fit.get("max_iter") is not None
            and fit.get("last_epoch") is not None):
        remaining = max(fit["max_iter"] - fit["last_epoch"] - 1, 0)
        # discount by time already elapsed since the last observed epoch —
        # symmetrical with the cost_model branch; a wedged run's eta decays
        # to 0 instead of promising the same remaining work forever
        age = max(now - (fit.get("last_epoch_wall") or now), 0.0)
        return {"eta_s": round(max(remaining / rate * 60.0 - age, 0.0), 3),
                "source": "epoch_rate",
                "predicted_epoch_ms": round(60e3 / rate, 3),
                "epochs_remaining": remaining,
                "as_of_epoch": fit["last_epoch"]}
    return None


# follow-mode cache for the checkpointed stall breakdown: the grid
# checkpoint pickles EVERY lane's params (hundreds of MB on real sweeps),
# so unpickling it each refresh tick would burn the fit host's disk/CPU to
# extract a handful of scalars — re-read only when the file changes
_ckpt_stall_cache = {}


def _checkpoint_stalls(run_dir):
    """Stall/compile breakdown from the newest checkpointed dispatch_stats
    (the only mid-run source: fit_end has not happened yet). Cached on the
    checkpoint file's (mtime, size) signature."""
    from redcliff_tpu_torch.obs import report as _report

    path = os.path.join(run_dir, "grid_checkpoint.pkl")
    try:
        st = os.stat(path)
        sig = (st.st_mtime_ns, st.st_size)
    except OSError:
        sig = None
    cached = _ckpt_stall_cache.get(run_dir)
    if cached is not None and cached[0] == sig:
        return cached[1]
    ck = _report._checkpoint_stats(run_dir)
    if not isinstance(ck, dict):
        _ckpt_stall_cache[run_dir] = (sig, None)
        return None
    out = {k: (round(v, 3) if isinstance(v, float) else v)
           for k in ("ckpt_stall_ms", "ckpt_barrier_stall_ms",
                     "prefetch_stall_ms", "compile_ms", "train_time_ms",
                     "val_time_ms", "epochs", "lanes_live", "grid_width")
           for v in (ck.get(k),)}
    out["source"] = "grid_checkpoint.pkl"
    _ckpt_stall_cache[run_dir] = (sig, out)
    return out


# follow-mode cache for the fleet-SLO view: slo_for_root re-reads and
# re-aggregates the WHOLE lifecycle ledger, which only grows — so a busy
# root would pay an ever-larger parse on every refresh tick even when no
# request moved. Cached on the ledger head file's (mtime, size) signature
# (appends grow it, rotation replaces it — either invalidates).
_fleet_slo_cache = {}


def _fleet_slo(root):
    from redcliff_tpu_torch.fleet import history as _history
    from redcliff_tpu_torch.obs import slo as _slo

    try:
        st = os.stat(_history.history_path(root))
        sig = (st.st_mtime_ns, st.st_size)
    except OSError:
        sig = None
    cached = _fleet_slo_cache.get(str(root))
    if cached is not None and cached[0] == sig:
        return cached[1]
    out = _slo.slo_for_root(root)
    _fleet_slo_cache[str(root)] = (sig, out)
    return out


def build_snapshot(run_dir, now=None):
    """One watch snapshot as a plain dict (``event="watch"`` — validates
    against the registered schema; importable for services and tests)."""
    now = time.time() if now is None else now
    mstats = {}
    try:
        records = read_jsonl(run_dir, stats=mstats)
    except FileNotFoundError:
        records, mstats = [], {"files": [], "records": 0, "torn_lines": 0}
    lstats = {}
    ledger_path = os.path.join(run_dir, "run_ledger.jsonl")
    ledger = (read_jsonl(ledger_path, stats=lstats)
              if os.path.exists(ledger_path) else [])

    fits, incidents = [], []
    cur = None
    fleet_last_plan = None   # newest planner packing decision (fleet event)
    fleet_workers = {}       # worker id -> last fleet-event wall time
    last_autoscale = None    # newest autoscaler decision
    last_qos = {}            # tenant -> newest qos demote/restore event
    last_backpressure = None  # newest admission-gate reject
    backpressure_rejects = 0
    mem_pred = mem_meas = None  # newest memory events (obs/memory.py)
    last_quality = None      # newest quality event (obs/quality.py)
    last_policy = None       # newest predictive-policy decision
    last_preempt = None      # newest deadline-aware preemption event
    last_serve = None        # newest serve-plane event
    serve_counts = {}        # newest non-None value per serve counter
    serve_quarantines = 0    # session quarantine verdicts seen
    last_pack_plan = None    # newest packing kind=plan verdict
    last_pack_event = None   # newest packing event of any kind
    pack_claims = pack_frees = 0  # slot lifecycle counters
    partial_points = 0       # partial_result rows streamed so far
    last_partial = None      # newest partial_result row
    anomalies = rollbacks = aborts = 0
    last_span_by_component = {}
    last_wall = last_epoch_wall = None
    for rec in records:
        wt = rec.get("wall_time")
        if isinstance(wt, (int, float)):
            last_wall = wt if last_wall is None else max(last_wall, wt)
        ev = rec.get("event")
        if ev == "fit_start":
            # a run dir's fits are sequential (attempts/resumes append to
            # one chain): any earlier fit still "live" at this point died
            # without a fit_end — mark it superseded, not LIVE
            for f in fits:
                if not f["done"]:
                    f["superseded"] = True
            cur = _fit_view(rec)
            fits.append(cur)
        elif ev == "epoch" and cur is not None:
            e = rec.get("epoch")
            cur["last_epoch"] = e
            cur["epochs_seen"] += 1
            if cur["first_epoch"] is None:
                cur["first_epoch"], cur["first_epoch_wall"] = e, wt
            cur["last_epoch_wall"] = wt
            last_epoch_wall = wt
            for k_rec, k_fit in (("lanes_live", "lanes_live"),
                                 ("num_quarantined", "num_quarantined"),
                                 ("guarded_steps_skipped",
                                  "guarded_steps_skipped"),
                                 ("epoch_ms", "epoch_ms_last"),
                                 ("grid_width", "grid_width")):
                if rec.get(k_rec) is not None:
                    cur[k_fit] = rec[k_rec]
        elif ev == "cost_model" and cur is not None:
            cur["_cost_model_last"] = rec
        elif ev == "memory":
            if rec.get("kind") == "measured":
                mem_meas = rec
            elif rec.get("kind") == "predicted":
                mem_pred = rec
        elif ev == "quality":
            # model-quality observatory (obs/quality.py): the newest
            # check-window summary becomes the `quality:` headline; absent
            # on pre-quality runs (section simply omitted)
            last_quality = rec
        elif ev == "policy":
            # predictive scheduling (parallel/policy.py): the
            # newest decision — chosen rung / compact-vs-hold pricing in a
            # run dir, compile ordering / preemption pricing in a fleet
            # root — becomes the `policy:` headline
            last_policy = rec
        elif ev == "preempt":
            last_preempt = rec
        elif ev == "serve":
            # serving-plane headline: counters are cumulative
            # but scattered across kinds (drain has no capacity, stop no
            # streams) — fold the newest non-None value per field
            last_serve = rec
            for k in ("capacity", "streams", "free_slots", "ticks",
                      "samples_in", "samples_out", "rejects", "dropped",
                      "p50_ms", "p99_ms", "n", "width", "live",
                      "fused_samples", "mode", "fuse", "precision_mode"):
                if rec.get(k) is not None:
                    serve_counts[k] = rec[k]
        elif ev == "session":
            serve_quarantines += rec.get("kind") == "quarantine"
        elif ev in ("compaction", "remesh") and cur is not None:
            if rec.get("to_width") is not None:
                cur["grid_width"] = rec["to_width"]
        elif ev == "fleet":
            if rec.get("kind") == "plan":
                fleet_last_plan = rec
            w = rec.get("worker")
            if w and isinstance(wt, (int, float)):
                fleet_workers[str(w)] = wt
        elif ev == "packing":
            # spatial mesh packing: the newest priced
            # packed-vs-serial verdict + slot lifecycle counters become
            # the `packing:` headline
            last_pack_event = rec
            kind = rec.get("kind")
            if kind == "plan":
                last_pack_plan = rec
            pack_claims += kind == "slot_claim"
            pack_frees += kind == "slot_free"
        elif ev == "partial_result":
            partial_points += 1
            last_partial = rec
        elif ev == "autoscale":
            # the SLO-driven control loop's decision stream:
            # the newest decision becomes the fleet section's headline
            last_autoscale = rec
        elif ev == "qos":
            if rec.get("tenant") is not None:
                last_qos[str(rec["tenant"])] = rec
        elif ev == "backpressure":
            last_backpressure = rec
            backpressure_rejects += rec.get("kind") == "reject"
        elif ev == "anomaly":
            anomalies += 1
        elif ev == "numerics":
            kind = rec.get("kind")
            rollbacks += kind == "rollback"
            aborts += kind == "abort"
        elif ev == "fit_end" and cur is not None:
            cur["done"] = True
        elif ev in ("hang", "host_lost", "hang_exit", "host_lost_exit"):
            incidents.append({"event": ev, "wall_time": wt,
                              "components": sorted(
                                  rec.get("components") or {})})
        elif ev == "span":
            comp = (rec.get("component")
                    or str(rec.get("name", "")).partition(".")[0])
            if comp and isinstance(wt, (int, float)):
                last_span_by_component[comp] = wt

    for fit in fits:
        if fit["superseded"]:
            # dead attempt: no rate extrapolation, no eta contribution
            fit.pop("_cost_model_last", None)
            continue
        n_e, t0, t1 = (fit["epochs_seen"], fit["first_epoch_wall"],
                       fit["last_epoch_wall"])
        if (n_e > 1 and isinstance(t0, (int, float))
                and isinstance(t1, (int, float)) and t1 > t0
                and fit["last_epoch"] is not None
                and fit["first_epoch"] is not None
                and fit["last_epoch"] > fit["first_epoch"]):
            # epochs advanced per wall minute, from the check-window cadence
            # (exact even when check_every > 1: the epoch NUMBERS advance)
            fit["epoch_rate_per_min"] = round(
                (fit["last_epoch"] - fit["first_epoch"]) / (t1 - t0) * 60.0,
                3)
        fit["eta"] = None if fit["done"] else _fit_eta(fit, now)
        fit.pop("_cost_model_last", None)

    live = [f for f in fits if not f["done"] and not f["superseded"]]
    etas = [f["eta"]["eta_s"] for f in live
            if f.get("eta") and isinstance(f["eta"].get("eta_s"),
                                           (int, float))]
    attempts = [r for r in ledger if r.get("event") == "attempt"]
    final = next((r for r in reversed(ledger) if r.get("event") == "final"),
                 None)

    files = mstats.get("files") or []
    try:
        newest_mtime = max(os.path.getmtime(p) for p in files) \
            if files else None
    except OSError:
        newest_mtime = None
    heartbeats = {
        "metrics_file_age_s": (round(now - newest_mtime, 3)
                               if newest_mtime is not None else None),
        "last_record_age_s": (round(now - last_wall, 3)
                              if last_wall is not None else None),
        "last_epoch_age_s": (round(now - last_epoch_wall, 3)
                             if last_epoch_wall is not None else None),
        "span_age_s": {c: round(now - t, 3)
                       for c, t in sorted(last_span_by_component.items())},
    }
    # the numerics skip counter of the run as it stands NOW: live (or
    # completed) fits only — a crashed superseded attempt's stale counter
    # must not shadow the restarted attempt's
    current_fits = [f for f in fits if not f["superseded"]] or fits
    last_skipped = max((f["guarded_steps_skipped"] or 0
                        for f in current_fits), default=0)
    # live HBM view (obs/memory.py): the newest measured watermark poll +
    # the newest analytical prediction; measured stays None on backends
    # without memory_stats (render shows an explicit "n/a (backend)")
    memory = None
    if mem_pred is not None or mem_meas is not None:
        memory = {
            "predicted_bytes": (mem_pred or {}).get("predicted_bytes"),
            "g_bucket": (mem_pred or {}).get("g_bucket"),
            "backend": (mem_pred or {}).get("backend"),
            "bytes_in_use": (mem_meas or {}).get("bytes_in_use"),
            "peak_bytes": (mem_meas or {}).get("peak_bytes"),
            "bytes_limit": ((mem_meas or {}).get("bytes_limit")
                            or (mem_pred or {}).get("bytes_limit")),
            "measured_age_s": (
                round(now - mem_meas["wall_time"], 3)
                if mem_meas and isinstance(mem_meas.get("wall_time"),
                                           (int, float)) else None),
        }
    # model-quality headline (obs/quality.py): the newest check-window
    # graph summary — lanes covered, plateau count, edge-set stability,
    # live AUROC when ground truth is in hand. None (section omitted) on
    # runs that never emitted a quality event, pre-quality runs included
    quality = None
    if last_quality is not None:
        qwt = last_quality.get("wall_time")
        quality = {
            "epoch": last_quality.get("epoch"),
            "lanes": len(last_quality.get("lanes") or []),
            "plateaued_count": last_quality.get("plateaued_count"),
            "stability": last_quality.get("mean_jaccard"),
            "auroc": last_quality.get("mean_auroc"),
            "aupr": last_quality.get("mean_aupr"),
            "age_s": (round(now - qwt, 3)
                      if isinstance(qwt, (int, float)) else None),
        }
    # predictive-scheduling headlines: the newest policy
    # decision and preemption event, age-stamped — None (sections omitted)
    # on runs/roots that never decided predictively
    policy = None
    if last_policy is not None:
        pwt = last_policy.get("wall_time")
        policy = {k: last_policy.get(k) for k in
                  ("kind", "action", "fallback", "epoch", "from_width",
                   "to_width", "chosen_width", "heuristic_width",
                   "saving_ms", "compile_ms", "heuristic_ms", "total_ms",
                   "epochs_remaining", "beneficiary", "request_id",
                   "batch_id", "reason")}
        policy["age_s"] = (round(now - pwt, 3)
                          if isinstance(pwt, (int, float)) else None)
    preempt = None
    if last_preempt is not None:
        pwt = last_preempt.get("wall_time")
        preempt = {k: last_preempt.get(k) for k in
                   ("kind", "batch_id", "requests", "beneficiary", "tenant",
                    "queued_eta_s", "running_rem_s", "deadline_at",
                    "grace_s")}
        preempt["age_s"] = (round(now - pwt, 3)
                            if isinstance(pwt, (int, float)) else None)
    # streaming-inference section: the serve plane's live
    # counters + the newest latency view — None (section omitted) on run
    # dirs that never served
    serve = None
    if last_serve is not None:
        swt = last_serve.get("wall_time")
        serve = dict(serve_counts)
        # elastic data plane: the engine's current pow2 rung —
        # the dispatched slot-table width, <= capacity under the occupancy
        # ladder — surfaces as `rung` (watch.serve.rung)
        serve["rung"] = serve.pop("width", None)
        serve["last_kind"] = last_serve.get("kind")
        serve["quarantines"] = serve_quarantines
        serve["age_s"] = (round(now - swt, 3)
                          if isinstance(swt, (int, float)) else None)
    # fleet mode (fleet/queue.py roots): queue depth + per-tenant counts
    # from the authoritative file queue, live in-flight claims from the
    # lease files, and the planner's newest packing decision from the
    # rotation-chain-tailed `fleet` events above
    # spatial-packing section: the worker-published occupancy
    # state file is authoritative (it outlives the metrics tail); the
    # tailed packing/partial_result events supply the newest verdict and
    # streaming progress. None (section omitted) on roots that never packed
    packing_sec = None
    pack_state = None
    if is_fleet_root(run_dir):
        from redcliff_tpu_torch.parallel import packing as _fpacking
        pack_state = _fpacking.load_state(run_dir, now=now)
        # partial_result rows stream into the per-batch run-dir chains,
        # not the root chain — count the durable partial files instead
        # (bounded: tiny one-line-per-point files, capped at 256)
        import glob as _glob
        for path in _glob.glob(os.path.join(
                run_dir, "work", "*", "results",
                "*.partial.jsonl"))[:256]:
            try:
                with open(path, encoding="utf-8") as fh:
                    partial_points += sum(1 for _ in fh)
            except OSError:
                continue
    if (pack_state is not None or last_pack_event is not None
            or partial_points):
        packing_sec = {
            "state": pack_state,
            "slot_claims": pack_claims,
            "slot_frees": pack_frees,
            "partial_points": partial_points,
            "last_partial": ({k: last_partial.get(k) for k in
                              ("request_id", "batch_id", "point", "epoch",
                               "final")}
                             if last_partial else None),
            "last_plan": ({k: last_pack_plan.get(k) for k in
                           ("decision", "reason", "makespan_ratio",
                            "makespan_s", "serial_s", "n_devices", "pool",
                            "headroom_violations")}
                          if last_pack_plan else None),
            "last_event": ({k: last_pack_event.get(k) for k in
                            ("kind", "batch_id", "slot", "worker")}
                           if last_pack_event else None),
        }
        pwt = (last_pack_event or {}).get("wall_time")
        packing_sec["age_s"] = (round(now - pwt, 3)
                                if isinstance(pwt, (int, float)) else None)
    fleet = None
    if is_fleet_root(run_dir):
        fleet = _fleet_section(
            run_dir, fleet_last_plan, fleet_workers, now,
            last_autoscale=last_autoscale, last_qos=last_qos,
            last_backpressure=last_backpressure,
            backpressure_rejects=backpressure_rejects)
    return {
        "event": "watch",
        "wall_time": now,
        "schema_version": _schema.SCHEMA_VERSION,
        "run_dir": os.path.abspath(run_dir),
        "ok": bool(records or ledger or fleet is not None),
        "fleet": fleet,
        "fits": fits,
        "grid_eta_s": round(sum(etas), 3) if etas else None,
        "stalls": _checkpoint_stalls(run_dir),
        "numerics": {"anomaly_events": anomalies, "rollbacks": rollbacks,
                     "aborts": aborts,
                     "guarded_steps_skipped": int(last_skipped)},
        "memory": memory,
        "quality": quality,
        "policy": policy,
        "preempt": preempt,
        "serve": serve,
        "packing": packing_sec,
        "heartbeats": heartbeats,
        "incidents": incidents,
        "attempts": {"n": len(attempts),
                     "last_classification": (attempts[-1].get(
                         "classification") if attempts else None),
                     "last_eta": (attempts[-1].get("eta")
                                  if attempts else None),
                     "final": (final or {}).get("classification")},
        "read_audit": {"records": mstats.get("records", 0),
                       "torn_lines": (mstats.get("torn_lines", 0)
                                      + lstats.get("torn_lines", 0)),
                       "files": [os.path.basename(p) for p in files]},
    }


def _fleet_section(root, last_plan, workers, now, last_autoscale=None,
                   last_qos=None, last_backpressure=None,
                   backpressure_rejects=0):
    """The fleet-mode snapshot body: queue/tenant counts (file queue =
    authoritative), live in-flight claims (lease files), the planner's
    newest packing decision, worker liveness ages, and the autoscaler's
    control state (published ``autoscale.json`` = authoritative pool view;
    the tailed ``autoscale``/``qos``/``backpressure`` events supply the
    newest decisions)."""
    from redcliff_tpu_torch.fleet import autoscale as _as
    from redcliff_tpu_torch.fleet.queue import FleetQueue

    # create=False: a watcher is a pure reader — it must neither mkdir
    # under the service root nor crash on a read-only/archived one
    q = FleetQueue(root, create=False)
    st = q.status(now=now)
    in_flight = [{
        "request_id": l.get("request_id"),
        "tenant": l.get("tenant"),
        "worker": l.get("worker"),
        "batch_id": l.get("batch_id"),
        "expires_in_s": round(float(l.get("expires_at") or 0.0) - now, 3),
    } for l in q.live_leases(now=now)]
    plan = None
    if last_plan is not None:
        plan = {k: last_plan.get(k) for k in
                ("queue_depth", "batches", "unschedulable", "plan_ms",
                 "utilization_pct", "decisions", "worker")}
        wt = last_plan.get("wall_time")
        plan["age_s"] = (round(now - wt, 3)
                         if isinstance(wt, (int, float)) else None)
    # containment view: dead-letter depth + dossier headlines,
    # and every request's durable attempt/reclaim counts (the retry-budget
    # state a release/reclaim updates). One terminal_ids() batch view for
    # the whole tick — a follow-mode watcher re-renders this every tick,
    # so no per-request stat probes and only the rendered dossiers read
    term = q.terminal_ids()
    terminal_rids = set().union(*term.values())
    deadletters = []
    for rid in sorted(term["deadletter"])[:16]:
        rec = q.deadletter_record(rid)
        if rec is None:
            continue  # raced a requeue; depth still counts the listing
        deadletters.append({
            "request_id": rec.get("request_id"),
            "tenant": (rec.get("dossier") or {}).get("tenant"),
            "reason": (rec.get("dossier") or {}).get("reason"),
            "attempts": (rec.get("dossier") or {}).get("attempts"),
            "last_classification": (rec.get("dossier") or {}).get(
                "last_classification"),
        })
    # live requests only (a terminal request's budget lives in its
    # dossier), bounded like the dead-letter list so snapshot size never
    # grows with root history
    attempts = {}
    for rec in q.attempt_records():
        rid = rec.get("request_id")
        if not rid or rid in terminal_rids:
            continue
        if not (rec.get("attempts") or rec.get("reclaims")
                or rec.get("suspect")):
            continue
        attempts[rid] = {
            "attempts": int(rec.get("attempts") or 0),
            "reclaims": int(rec.get("reclaims") or 0),
            "last": (rec.get("last") or {}).get("classification"),
        }
        if len(attempts) >= 64:
            break
    # fleet-SLO headline (obs/slo.py): per-tenant queue-wait
    # percentiles / deadline hit-rate / dead-letter rate from the durable
    # lifecycle ledger, with REDCLIFF_SLO_* threshold breach flags — the
    # service-level numbers a follow-mode operator steers by
    slo = _fleet_slo(root)
    # autoscale view: durable state file + qos rung files are
    # authoritative (they outlive the metrics tail); the tailed events
    # carry the newest decision/reject headline
    auto_state = _as.load_state(root)
    qos_rungs = _as.active_qos(root)
    autoscale = None
    if auto_state is not None or qos_rungs or last_autoscale is not None \
            or last_backpressure is not None or last_qos:
        last_dec = (auto_state or {}).get("last_decision") or last_autoscale
        awt = (auto_state or {}).get("wall_time")
        autoscale = {
            "workers": (auto_state or {}).get("workers"),
            "target": (auto_state or {}).get("target"),
            "max_workers": (auto_state or {}).get("max_workers"),
            "pending": (auto_state or {}).get("pending"),
            "drain_eta_s": (auto_state or {}).get("drain_eta_s"),
            "state_age_s": (round(now - awt, 3)
                            if isinstance(awt, (int, float)) else None),
            "last_decision": ({k: last_dec.get(k) for k in
                               ("kind", "reason", "workers", "target",
                                "queue_depth", "drain_eta_s", "breaches")}
                              if last_dec else None),
            "qos": {t: {"rung": r.get("rung"), "reason": r.get("reason")}
                    for t, r in sorted(qos_rungs.items())},
            "last_qos_events": {t: {k: e.get(k) for k in
                                    ("kind", "rung", "from_rung", "reason")}
                                for t, e in sorted((last_qos or {}).items())},
            "backpressure": {
                "rejects": int(backpressure_rejects),
                "last": ({k: last_backpressure.get(k) for k in
                          ("tenant", "eta_s", "threshold_s", "queue_depth",
                           "workers")}
                         if last_backpressure else None),
            },
        }
    return {
        "counts": st["counts"],
        "by_tenant": st["by_tenant"],
        "torn_spool_lines": st["torn_spool_lines"],
        "in_flight": in_flight,
        "last_plan": plan,
        "deadletter": {"depth": len(term["deadletter"]),
                       "requests": deadletters},
        "attempts": attempts,
        "slo": slo,
        "autoscale": autoscale,
        "worker_age_s": {w: round(now - t, 3)
                         for w, t in sorted(workers.items())},
    }


def _fmt_age(s):
    if s is None:
        return "-"
    if s >= 3600:
        return f"{s / 3600:.1f}h"
    if s >= 60:
        return f"{s / 60:.1f}m"
    return f"{s:.1f}s"


def _fmt_eta(eta):
    if not eta or eta.get("eta_s") is None:
        return "-"
    return f"{_fmt_age(eta['eta_s'])} ({eta['source']})"


def render_text(snap):
    """Terminal rendering of one :func:`build_snapshot` dict."""
    out = [f"watch: {snap['run_dir']}  "
           f"(records {snap['read_audit']['records']}, torn "
           f"{snap['read_audit']['torn_lines']})"]
    fl = snap.get("fleet")
    if fl:
        c = fl["counts"]
        out.append(f"  fleet queue: {c['queued']} queued | {c['running']} "
                   f"running | {c['done']} done | {c['failed']} failed | "
                   f"{c.get('deadletter', 0)} dead-lettered | "
                   f"{c.get('canceled', 0)} canceled "
                   f"(of {c['submitted']} submitted"
                   + (f"; {c['expired_claims']} expired claim(s)"
                      if c["expired_claims"] else "") + ")")
        for tenant, t in sorted(fl["by_tenant"].items()):
            out.append(f"    tenant {tenant}: {t['queued']}q "
                       f"{t['running']}r {t['done']}d {t['failed']}f"
                       + (f" {t['deadletter']}dl"
                          if t.get("deadletter") else "")
                       + (f" {t['canceled']}c" if t.get("canceled") else ""))
        dl = fl.get("deadletter") or {}
        if dl.get("depth"):
            out.append(f"    dead-letter depth: {dl['depth']}")
            for d in dl.get("requests") or []:
                out.append(f"      {d['request_id']} [{d['tenant']}] "
                           f"{d['reason']} after {d['attempts']} attempt(s)"
                           + (f" (last {d['last_classification']})"
                              if d.get("last_classification") else ""))
        att = fl.get("attempts") or {}
        if att:
            out.append("    attempt budgets: " + "  ".join(
                f"{rid}={a['attempts']}f/{a['reclaims']}r"
                for rid, a in sorted(att.items())))
        slo = fl.get("slo")
        if slo:
            ov = slo["overall"]

            def _slo_s(v):
                return f"{v:.2f}s" if isinstance(v, (int, float)) else "-"

            qw, tt = ov.get("queue_wait_s") or {}, ov.get("ttfa_s") or {}
            dl = ov.get("deadline") or {}
            dlp = ov.get("deadletter_pct")
            att_pr = ov.get("attempts_per_request")
            out.append(
                f"    slo: qwait p50/p99 {_slo_s(qw.get('p50'))}/"
                f"{_slo_s(qw.get('p99'))} | ttfa p99 "
                f"{_slo_s(tt.get('p99'))} | deadline "
                + (f"{dl['hit_pct']:.0f}%" if dl.get("hit_pct") is not None
                   else "-")
                + f" | attempts/req "
                + (f"{att_pr:.2f}" if att_pr is not None else "-")
                + f" | dead-letter "
                + (f"{dlp:.1f}%" if dlp is not None else "-")
                + f" ({ov['settled']}/{ov['requests']} settled)")
            for br in slo.get("breaches") or []:
                out.append(f"    SLO BREACH [{br['scope']}] {br['slo']}: "
                           f"{br['value']:.3f} vs {br['threshold']:.3f}")
        for inf in fl["in_flight"]:
            out.append(f"    in-flight {inf['request_id']} "
                       f"[{inf['tenant']}] on {inf['worker']} "
                       f"batch={inf['batch_id']} lease "
                       f"{_fmt_age(max(inf['expires_in_s'], 0.0))} left")
        lp = fl.get("last_plan")
        if lp:
            out.append(f"    last plan ({_fmt_age(lp['age_s'])} ago): "
                       f"depth={lp['queue_depth']} -> "
                       f"{lp['batches']} batch(es), "
                       f"{lp['unschedulable']} unschedulable, "
                       f"util={lp['utilization_pct']}%, "
                       f"plan={lp['plan_ms']}ms")
            for d in (lp.get("decisions") or [])[:4]:
                out.append(f"      {d.get('batch_id')}: "
                           f"{d.get('n_points')} pt -> "
                           f"bucket {d.get('g_bucket')}, tenants "
                           f"{','.join(d.get('tenants') or [])}"
                           + (f", eta {_fmt_age(d['eta_s'])}"
                              if d.get("eta_s") is not None else ""))
        if fl["worker_age_s"]:
            out.append("    workers: " + "  ".join(
                f"{w}={_fmt_age(a)}"
                for w, a in fl["worker_age_s"].items()))
        auto = fl.get("autoscale")
        if auto:
            out.append(
                f"    autoscale: {auto.get('workers')}/"
                f"{auto.get('max_workers')} worker(s), target "
                f"{auto.get('target')}, pending {auto.get('pending')}, "
                f"drain eta {_fmt_age(auto.get('drain_eta_s'))}"
                + (f" (state {_fmt_age(auto['state_age_s'])} old)"
                   if auto.get("state_age_s") is not None else ""))
            ld = auto.get("last_decision")
            if ld:
                out.append(f"      last decision: {ld.get('kind')} "
                           f"({ld.get('reason')})")
            for tenant, r in sorted((auto.get("qos") or {}).items()):
                out.append(f"      qos tenant {tenant}: rung "
                           f"{r.get('rung')} ({r.get('reason')})")
            bp = auto.get("backpressure") or {}
            if bp.get("rejects"):
                last = bp.get("last") or {}
                out.append(
                    f"      backpressure: {bp['rejects']} reject(s)"
                    + (f", last [{last.get('tenant')}] eta "
                       f"{_fmt_age(last.get('eta_s'))} vs slo "
                       f"{_fmt_age(last.get('threshold_s'))}"
                       if last else ""))
    pk = snap.get("packing")
    if pk:
        st_p = pk.get("state") or {}
        lp_p = pk.get("last_plan") or {}
        out.append(
            "  packing: "
            + (f"{st_p.get('busy_devices', 0)}/{st_p.get('pool', '?')} "
               f"device(s) busy, {st_p.get('concurrent_batches', 0)} "
               f"co-resident, util {st_p.get('utilization_pct', 0)}%"
               if st_p else "no live occupancy state")
            + f" | {pk.get('slot_claims', 0)} claim(s) / "
              f"{pk.get('slot_frees', 0)} free(s)"
            + (f" ({_fmt_age(pk['age_s'])} old)"
               if pk.get("age_s") is not None else ""))
        if lp_p:
            ratio = lp_p.get("makespan_ratio")
            out.append(
                f"    last packing plan: {lp_p.get('decision')} "
                f"({lp_p.get('reason')})"
                + (f", makespan ratio {ratio:.3f}"
                   if isinstance(ratio, (int, float)) else "")
                + f", headroom violations "
                  f"{lp_p.get('headroom_violations', 0)}")
        if pk.get("partial_points"):
            last_pr = pk.get("last_partial") or {}
            out.append(
                f"    partial results: {pk['partial_points']} point(s) "
                f"streamed"
                + (f", last {last_pr.get('request_id')}#"
                   f"{last_pr.get('point')} epoch {last_pr.get('epoch')}"
                   + (" (final)" if last_pr.get("final") else "")
                   if last_pr else ""))
    sv = snap.get("serve")
    if sv:
        def _ms(v):
            return f"{v:.2f}ms" if isinstance(v, (int, float)) else "-"

        out.append(
            f"  serve [{sv.get('last_kind')}]: "
            f"{sv.get('streams', 0)} stream(s) / "
            f"{sv.get('capacity', '?')} slot(s), "
            f"{sv.get('samples_out', 0)}/{sv.get('samples_in', 0)} "
            f"answered, lat p50/p99 {_ms(sv.get('p50_ms'))}/"
            f"{_ms(sv.get('p99_ms'))}"
            + (f", rung:{sv['rung']}/{sv.get('capacity', '?')}"
               + (f" [{sv['mode']}]" if sv.get("mode") else "")
               if sv.get("rung") is not None else "")
            + (f", fused:{sv['fused_samples']}"
               + (f" (depth<={sv['fuse']})" if sv.get("fuse") else "")
               if sv.get("fused_samples") else "")
            + (f", precision:{sv['precision_mode']}"
               if sv.get("precision_mode")
               and sv.get("precision_mode") != "f32" else "")
            + (f", {sv['rejects']} reject(s)" if sv.get("rejects") else "")
            + (f", {sv['dropped']} dropped" if sv.get("dropped") else "")
            + (f", {sv['quarantines']} quarantine(s)"
               if sv.get("quarantines") else "")
            + (f" ({_fmt_age(sv['age_s'])} old)"
               if sv.get("age_s") is not None else ""))
    hb = snap["heartbeats"]
    out.append(f"  ages: metrics file {_fmt_age(hb['metrics_file_age_s'])} |"
               f" last record {_fmt_age(hb['last_record_age_s'])} | last "
               f"epoch {_fmt_age(hb['last_epoch_age_s'])}")
    if hb["span_age_s"]:
        out.append("  span ages: " + "  ".join(
            f"{c}={_fmt_age(a)}" for c, a in hb["span_age_s"].items()))
    at = snap["attempts"]
    if at["n"]:
        out.append(f"  supervisor: {at['n']} attempt(s), last "
                   f"{at['last_classification']}"
                   + (f", final {at['final']}" if at["final"] else "")
                   + (f", eta-at-exit {_fmt_age(at['last_eta']['eta_s'])}"
                      if at.get("last_eta")
                      and at["last_eta"].get("eta_s") is not None else ""))
    for i, f in enumerate(snap["fits"]):
        state = ("done" if f["done"]
                 else "dead" if f.get("superseded") else "LIVE")
        width = f.get("grid_width")
        out.append(
            f"  fit {i} [{state}] {f['model']} G={f['grid_size']} "
            f"bucket={width} mode={f['stream_mode'] or '?'} epoch "
            f"{f['last_epoch']}"
            + (f"/{f['max_iter']}" if f.get("max_iter") is not None else "")
            + f" lanes_live={f['lanes_live']} "
            f"quarantined={f['num_quarantined']} "
            f"skipped={f['guarded_steps_skipped']}")
        out.append(
            f"         rate={f['epoch_rate_per_min'] or '-'} epoch/min  "
            f"last_epoch_ms={f['epoch_ms_last'] or '-'}  "
            f"eta={_fmt_eta(f['eta'])}")
    if not snap["fits"]:
        out.append("  (no fit_start recorded yet)")
    if snap["grid_eta_s"] is not None:
        out.append(f"  whole-run ETA: {_fmt_age(snap['grid_eta_s'])}")
    st = snap["stalls"]
    if st:
        out.append(
            f"  stalls (from {st['source']}, epoch {st.get('epochs')}): "
            f"ckpt={st.get('ckpt_stall_ms')}ms "
            f"barrier={st.get('ckpt_barrier_stall_ms')}ms "
            f"prefetch={st.get('prefetch_stall_ms')}ms "
            f"compile={st.get('compile_ms')}ms")
    n = snap["numerics"]
    out.append(f"  numerics: {n['anomaly_events']} anomaly, "
               f"{n['rollbacks']} rollback, {n['aborts']} abort, "
               f"{n['guarded_steps_skipped']} guarded step(s) skipped")
    q = snap.get("quality")
    if q:
        fs = lambda v: (f"{v:.3f}" if isinstance(v, (int, float)) else "-")
        out.append(
            f"  quality: epoch {q.get('epoch')} lanes={q.get('lanes')} "
            f"plateaued={q.get('plateaued_count')} "
            f"stability={fs(q.get('stability'))} "
            f"auroc={fs(q.get('auroc'))} "
            f"(age {_fmt_age(q.get('age_s'))})")
    pol = snap.get("policy")
    if pol:
        fms = lambda v: (f"{v:.0f}ms" if isinstance(v, (int, float))
                         else "-")
        kind = pol.get("kind")
        if kind == "compaction":
            body = (f"{pol.get('action')} {pol.get('from_width')}->"
                    f"{pol.get('to_width')} saving {fms(pol.get('saving_ms'))}"
                    f" vs compile {fms(pol.get('compile_ms'))} "
                    f"({pol.get('epochs_remaining')} epochs left)")
        elif kind == "initial_width":
            body = (f"{pol.get('action')} rung {pol.get('chosen_width')} "
                    f"(heuristic {pol.get('heuristic_width')}, "
                    f"saving {fms(pol.get('saving_ms'))})")
        elif kind == "preempt_price":
            body = (f"{pol.get('action')} "
                    f"{pol.get('request_id') or pol.get('beneficiary') or ''}"
                    + (f" ({pol['reason']})" if pol.get("reason") else ""))
        else:
            body = f"{kind} {pol.get('action') or ''}".strip()
        out.append(f"  policy: {body}"
                   + (" [fallback]" if pol.get("fallback") else "")
                   + f" (age {_fmt_age(pol.get('age_s'))})")
    pre = snap.get("preempt")
    if pre:
        out.append(
            f"  preempt: {pre.get('kind')} batch {pre.get('batch_id')} -> "
            f"{pre.get('beneficiary')}"
            + (f" [{pre['tenant']}]" if pre.get("tenant") else "")
            + (f" queued eta {_fmt_age(pre['queued_eta_s'])}"
               if pre.get("queued_eta_s") is not None else "")
            + (f", running rem {_fmt_age(pre['running_rem_s'])}"
               if pre.get("running_rem_s") is not None else "")
            + f" (age {_fmt_age(pre.get('age_s'))})")
    mem = snap.get("memory")
    if mem:
        fb = lambda b: (f"{b / (1 << 20):.1f}MB"
                        if isinstance(b, (int, float)) else "-")
        if mem.get("bytes_in_use") is not None \
                or mem.get("peak_bytes") is not None:
            out.append(
                f"  hbm: in_use {fb(mem['bytes_in_use'])} | peak "
                f"{fb(mem['peak_bytes'])} | limit {fb(mem['bytes_limit'])} "
                f"(age {_fmt_age(mem['measured_age_s'])}; predicted "
                f"{fb(mem['predicted_bytes'])})")
        else:
            out.append(
                f"  hbm: n/a ({mem.get('backend') or 'backend'}) — "
                f"predicted {fb(mem['predicted_bytes'])} at bucket "
                f"{mem.get('g_bucket')}")
    if snap["incidents"]:
        out.append(f"  incidents: " + "; ".join(
            f"{i['event']}({','.join(i['components'])})"
            for i in snap["incidents"]))
    return "\n".join(out)


def run_watch(run_dir, once=False, as_json=False, interval=2.0,
              max_ticks=None, out=None):
    """CLI body. ``max_ticks`` bounds the follow loop (tests); returns the
    exit code."""
    out = out if out is not None else sys.stdout
    diag = diagnose_run_dir(run_dir)
    if diag is not None:
        print(f"obs watch: {diag}", file=sys.stderr)
        return 2
    ticks = 0
    while True:
        snap = build_snapshot(run_dir)
        if as_json:
            json.dump(snap, out, indent=2, allow_nan=False)
            out.write("\n")
        else:
            if not once and out.isatty():
                out.write("\x1b[H\x1b[2J")  # home + clear: live refresh
            out.write(render_text(snap) + "\n")
        out.flush()
        ticks += 1
        if once or (max_ticks is not None and ticks >= max_ticks):
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0
