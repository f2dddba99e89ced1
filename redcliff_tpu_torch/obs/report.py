"""Run-analytics CLI: join a run directory's telemetry into one summary
(port of ``obs/report.py``, a copy on the port's modules).

``python -m redcliff_tpu_torch.obs report <run_dir>`` reads everything the spine
wrote — ``metrics.jsonl`` (rotation chain, torn lines tolerated),
``run_ledger.jsonl`` (supervisor attempts), the checkpointed
``dispatch_stats`` inside ``grid_checkpoint.pkl``, and any
``flight_record.json`` — and produces:

* a per-run summary: wall time in compile / train dispatch / val dispatch /
  checkpoint stall / prefetch stall, lane-epochs by G-bucket, the
  compaction/remesh history, quarantine + numerics skip/rollback counts,
  supervisor attempt classifications;
* a machine-readable per-(shape, G-bucket) **cost table** — observed epoch
  step cost and compile cost per compiled program family. This table is the
  training input for ROADMAP item 4's learned cost model (choose bucket
  ladders/compaction points by predicted wall-clock) and item 1's admission
  planner (pack requests into G-buckets the mesh can absorb);
* a schema audit: every record validated against the versioned registry
  (:mod:`redcliff_tpu_torch.obs.schema`), torn-line counts per file;
* the learned-cost-model view (obs/costmodel.py): per-(shape, G-bucket)
  prediction accuracy from the run's ``cost_model`` residual events (MAPE,
  sample counts, last ETA) joined with the persistent store's state
  (bucket sample counts, staleness);
* ``tpu_bench_cache``: the JAX report's provenance of its cached TPU
  evidence, kept as a key whose value is None: the port shows no TPU
  evidence as its own.

The port's differences from the JAX module: the checkpointed
``dispatch_stats`` are read through the port's checkpoint reader
(``runtime/checkpoint.py``, on the host, no card; a JAX-written grid
checkpoint's optimizer state is read as opaque objects, never run). A
fleet sweep-service root (the port's ``fleet/``) gets the JAX module's
sections: per-tenant, containment, fleet SLO, autoscale and packing.

``--json`` prints the full report as one JSON object; ``-o PATH`` writes it.
The report is importable (:func:`build_report`) for tests and services.
A missing or telemetry-less run dir exits with code 2 and a one-line
diagnosis. This module also hosts the ``obs`` CLI dispatcher: ``report``,
``watch`` (:mod:`redcliff_tpu_torch.obs.watch`), ``trace``
(:mod:`redcliff_tpu_torch.obs.trace_export`) and ``regress``
(:mod:`redcliff_tpu_torch.obs.regress`). It imports no torch.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from redcliff_tpu_torch.obs import costmodel as _costmodel
from redcliff_tpu_torch.obs import schema as _schema
from redcliff_tpu_torch.obs.logging import read_jsonl

__all__ = ["build_report", "render_text", "main", "LEDGER_NAME"]

LEDGER_NAME = "run_ledger.jsonl"

# dispatch_stats keys summed across attempts for the time breakdown
_SUM_STATS = ("train_dispatches", "val_dispatches", "epochs", "compactions",
              "remeshes", "lane_epochs", "lane_epochs_nominal",
              "compile_ms", "compiles", "cache_hits", "cache_misses",
              "ckpt_stall_ms", "ckpt_barrier_stall_ms", "prefetch_stall_ms",
              "prefetch_items", "train_time_ms", "val_time_ms")


# canonical (shape, G-bucket) key shared with the cost-model store
_shape_key = _schema.shape_key


def _cost_model_store_info(run_cache_dir=None):
    """State of the persistent cost-model store (obs/costmodel.py): where
    it is, how much evidence it holds, how stale it is.

    ``run_cache_dir`` is the compile-cache dir the run's fit_start
    recorded; when the env-resolved store is absent (the report
    is read on a host without the writer's env), the store that fit
    actually wrote — ``<dirname(run_cache_dir)>/cost_model_v*.json`` — is
    tried next."""
    path = _costmodel.store_path()
    if (path is None or not os.path.exists(path)) and run_cache_dir:
        alt = _costmodel.store_path(os.path.dirname(str(run_cache_dir)))
        if alt and os.path.exists(alt):
            path = alt
    if path is None:
        return {"configured": False, "path": None}
    # load(path) handles both base forms store_path supports — a directory
    # and a direct *.json file (REDCLIFF_COST_MODEL_DIR may be either)
    model = _costmodel.load(path)
    if model is None:
        return {"configured": True, "path": path, "present": False}
    stale = model.staleness_s()
    return {"configured": True, "path": path, "present": True,
            "version": _costmodel.STORE_VERSION, "runs": model.runs,
            "buckets": len(model.buckets),
            "updated_at": model.updated_at,
            "staleness_s": round(stale, 1) if stale is not None else None}


def _read_ledger(run_dir, stats):
    path = os.path.join(run_dir, LEDGER_NAME)
    if not os.path.exists(path):
        return []
    return read_jsonl(path, stats=stats)


def _checkpoint_stats(run_dir):
    """dispatch_stats snapshot stored in the newest grid checkpoint
    generation, or None (older checkpoints / no checkpoint / no numpy).
    A pure reader: a corrupt generation is skipped, never quarantined, and
    a class the port does not unpickle (a JAX checkpoint's optimizer
    state) is read as an opaque object."""
    path = os.path.join(run_dir, "grid_checkpoint.pkl")
    if not os.path.exists(path):
        return None
    try:
        from redcliff_tpu_torch.runtime import checkpoint as durable_ckpt

        ckpt, _src = durable_ckpt.load_checkpoint(path,
                                                  allow_quarantine=False,
                                                  opaque=True)
        if isinstance(ckpt, dict):
            return ckpt.get("dispatch_stats")
    except Exception:  # noqa: BLE001 — a torn checkpoint must not kill
        return None    # the report; the metrics chain still has the story
    return None


def build_report(run_dir):
    """Aggregate one run directory's telemetry into a plain-dict report
    (strict-JSON-able; see module docstring for the sections)."""
    mstats, lstats = {}, {}
    try:
        records = read_jsonl(run_dir, stats=mstats)
    except FileNotFoundError:
        records = []
        mstats = {"files": [], "records": 0, "torn_lines": 0}
    ledger = _read_ledger(run_dir, lstats)

    fits = []
    cur = None            # current fit context: {"shape_key", "shape", ...}
    manifest = {}         # request_id -> {tenant, start, stop} (fleet runs)
    fleet_kind_counts = {}  # fleet-event lifecycle counts (fleet roots)
    packing_counts = {}     # packing-event kind tallies
    packing_last_plan = None  # newest priced packed-vs-serial verdict
    partial_streamed = partial_final = 0  # partial_result rows seen
    autoscale_counts = {}   # autoscale decision-kind counts
    last_autoscale = None
    qos_last = {}           # tenant -> newest qos demote/restore event
    qos_demotes = 0
    bp_rejects = 0
    bp_last = None
    cost = {}             # (shape_key, g_bucket) -> accumulators
    cm_acc = {}           # (shape_key, g_bucket) -> residual-event accuracy
    run_cache_dir = None  # the versioned compile-cache dir fit_start logs
    profiles = []         # capture-window artifacts (`profile` events)
    compactions, remeshes, failures, hangs = [], [], [], []
    anomalies = rollbacks = aborts = skipped_steps = 0
    precision_events = []  # mixed-precision demotions
    autotune_events = []   # kernel-tiling searches/lookups (ops/autotune.py)
    policy_events = []     # predictive-policy decisions
    preempt_events = []    # deadline-aware preemption events
    quarantined = 0
    stats_sum = {k: 0 for k in _SUM_STATS}
    t_first = t_last = None

    # two epoch-count sources per (shape, width): EXACT per-width
    # accumulators from fit_end's dispatch_stats (the grid counts every
    # epoch), and SAMPLED counts from `epoch` events (the grid only emits
    # those on the check_every cadence — up to check_every x fewer than ran;
    # the trainers emit every epoch, so sampling is exact there). Exact wins
    # whenever present
    # a mixed-precision grid's fit_end carries its epochs per precision
    # era (dispatch_stats "cost_eras"): their rows are labelled with the
    # era's precision ("mixed", "f32"), as the store keeps them apart; an
    # f32-only fit's rows stay unlabelled, as the JAX report's
    def _cost(shape_key, width, precision=""):
        key = (shape_key, int(width), precision)
        if key not in cost:
            cost[key] = {"epochs_sampled": 0, "epoch_ms_sampled": 0.0,
                         "epochs_exact": 0, "epoch_ms_exact": 0.0,
                         "compiles": 0, "compile_ms": 0.0, "cache_hits": 0,
                         "cache_misses": 0}
        return cost[key]

    for rec in records:
        ev = rec.get("event")
        wt = rec.get("wall_time")
        if isinstance(wt, (int, float)):
            t_first = wt if t_first is None else min(t_first, wt)
            t_last = wt if t_last is None else max(t_last, wt)
        if ev == "fit_start":
            cur = {"model": rec.get("model"),
                   "shape": rec.get("shape"),
                   "shape_key": _shape_key(rec.get("shape")),
                   "grid_size": rec.get("grid_size"),
                   "grid_width": rec.get("grid_width"),
                   "stream_mode": rec.get("stream_mode"),
                   "resumed_from_epoch": rec.get("resumed_from_epoch"),
                   "mesh": rec.get("mesh")}
            fits.append(cur)
            if rec.get("compile_cache_dir"):
                run_cache_dir = rec["compile_cache_dir"]
        elif ev == "epoch":
            width = rec.get("grid_width") or 1
            if isinstance(rec.get("epoch_ms"), (int, float)):
                c = _cost(cur["shape_key"] if cur else "unknown", width)
                c["epochs_sampled"] += 1
                c["epoch_ms_sampled"] += rec["epoch_ms"]
            skipped_steps = max(skipped_steps,
                                rec.get("guarded_steps_skipped") or 0)
        elif ev == "compile":
            width = rec.get("grid_width") or (cur or {}).get("grid_width") \
                or 1
            c = _cost(cur["shape_key"] if cur else "unknown", width)
            c["compiles"] += rec.get("programs") or 0
            c["compile_ms"] += rec.get("compile_ms") or 0.0
            c["cache_hits"] += rec.get("cache_hits") or 0
            c["cache_misses"] += rec.get("cache_misses") or 0
        elif ev == "cost_model":
            # learned-cost-model residual events (one per check window):
            # the prediction-accuracy evidence the accuracy table reports
            width = rec.get("grid_width") or (cur or {}).get("grid_width") \
                or 1
            key = (cur["shape_key"] if cur else "unknown", int(width))
            a = cm_acc.setdefault(key, {
                "samples": 0, "abs_pct_sum": 0.0, "sources": set(),
                "last": None})
            a["samples"] += 1
            if isinstance(rec.get("residual_pct"), (int, float)):
                a["abs_pct_sum"] += abs(rec["residual_pct"])
            if rec.get("source"):
                a["sources"].add(rec["source"])
            a["last"] = rec
        elif ev == "memory":
            # device-memory observatory (obs/memory.py): the analytical
            # prediction at fit start + the max measured watermark across
            # this fit's polls — the predicted-vs-measured view per fit
            if cur is not None:
                m = cur.setdefault("_memory", {
                    "predicted_bytes": None, "g_bucket": None,
                    "measured_peak_bytes": None, "polls": 0,
                    "bytes_limit": None, "fits_device": None,
                    "backend": None})
                if rec.get("kind") == "predicted":
                    m["predicted_bytes"] = rec.get("predicted_bytes")
                    m["g_bucket"] = rec.get("g_bucket")
                    m["fits_device"] = rec.get("fits")
                    m["backend"] = rec.get("backend")
                    if rec.get("bytes_limit") is not None:
                        m["bytes_limit"] = rec["bytes_limit"]
                elif rec.get("kind") == "measured":
                    m["polls"] += 1
                    peak = rec.get("peak_bytes")
                    if peak is None:
                        peak = rec.get("bytes_in_use")
                    if isinstance(peak, (int, float)):
                        m["measured_peak_bytes"] = max(
                            m["measured_peak_bytes"] or 0, peak)
                    if rec.get("bytes_limit") is not None:
                        m["bytes_limit"] = rec["bytes_limit"]
        elif ev == "quality":
            # model-quality observatory (obs/quality.py): per-check-window
            # graph summaries; the last event + the fit_end snapshot below
            # become the report's model-quality section
            if cur is not None:
                qv = cur.setdefault("_quality", {"windows": 0, "last": None,
                                                 "snapshot": None})
                qv["windows"] += 1
                qv["last"] = rec
        elif ev == "packing":
            # spatial mesh packing: slot-lifecycle tallies +
            # the newest priced packed-vs-serial verdict
            kind = str(rec.get("kind"))
            packing_counts[kind] = packing_counts.get(kind, 0) + 1
            if kind == "plan":
                packing_last_plan = rec
        elif ev == "partial_result":
            # per-point result streaming: at-least-once rows,
            # so tally final vs streaming separately (a resumed batch may
            # re-stream a point; consumers keep the last row per point)
            partial_streamed += 1
            partial_final += bool(rec.get("final"))
        elif ev == "fleet":
            # tenant manifest (fleet/run_batch.py): request id -> merged
            # point range; restart attempts re-log it, latest wins
            kind = rec.get("kind")
            fleet_kind_counts[str(kind)] = \
                fleet_kind_counts.get(str(kind), 0) + 1
            if kind == "manifest":
                for row in rec.get("requests") or []:
                    if isinstance(row, dict) and row.get("request_id"):
                        manifest[row["request_id"]] = row
        elif ev == "autoscale":
            # the SLO-driven control loop's decision stream
            kind = str(rec.get("kind"))
            autoscale_counts[kind] = autoscale_counts.get(kind, 0) + 1
            # headline = the newest POOL decision; start/stop are loop
            # lifecycle markers, holds are steady-state noise
            if kind not in ("hold", "start", "stop"):
                last_autoscale = rec
        elif ev == "qos":
            if rec.get("tenant") is not None:
                qos_last[str(rec["tenant"])] = rec
            qos_demotes += rec.get("kind") == "demote"
        elif ev == "backpressure":
            bp_rejects += rec.get("kind") == "reject"
            bp_last = rec
        elif ev == "profile":
            profiles.append({k: rec.get(k) for k in
                             ("path", "spec", "first_epoch", "last_epoch",
                              "dur_ms", "truncated")})
        elif ev == "compaction":
            compactions.append({k: rec.get(k) for k in
                                ("epoch", "from_width", "to_width",
                                 "lanes_live", "retired")})
            if cur is not None:
                cur["grid_width"] = rec.get("to_width")
        elif ev == "remesh":
            remeshes.append({k: rec.get(k) for k in
                             ("epoch", "from_width", "to_width",
                              "from_devices", "to_devices",
                              "lanes_migrated", "plan_ms")})
        elif ev == "anomaly":
            anomalies += 1
        elif ev == "numerics":
            if rec.get("kind") == "rollback":
                rollbacks += 1
            elif rec.get("kind") == "abort":
                aborts += 1
        elif ev == "precision":
            precision_events.append({k: rec.get(k) for k in
                                     ("kind", "epoch", "cause", "mode_from",
                                      "mode_to", "lanes")})
        elif ev == "autotune":
            autotune_events.append({k: rec.get(k) for k in
                                    ("kernel", "kind", "shape", "g_bucket",
                                     "tile", "search_ms",
                                     "speedup_vs_default")})
        elif ev == "policy":
            # predictive scheduling decisions (parallel/policy.py
            # via the grid engine / fleet worker): kept with the emitting
            # fit's shape key so compaction decisions can be joined against
            # the observed per-width epoch costs (predicted vs REALIZED)
            policy_events.append(dict(
                rec, _shape_key=(cur or {}).get("shape_key", "unknown")))
        elif ev == "preempt":
            preempt_events.append(rec)
        elif ev == "fit_end":
            ds = rec.get("dispatch_stats")
            # quality snapshot: inside dispatch_stats for the grid engine,
            # a top-level field for the trainers; missing on pre-quality
            # runs (.get everywhere — never a KeyError)
            q_snap = (ds.get("quality") if isinstance(ds, dict) else None) \
                or rec.get("quality")
            if isinstance(q_snap, dict) and cur is not None:
                cur.setdefault("_quality", {"windows": 0, "last": None,
                                            "snapshot": None})["snapshot"] \
                    = q_snap
            if isinstance(ds, dict):
                for k in _SUM_STATS:
                    v = ds.get(k)
                    if isinstance(v, (int, float)):
                        stats_sum[k] += v
                # exact per-width epoch/step-cost accumulators (every epoch
                # counted, not just the check-window-sampled ones)
                sk = cur["shape_key"] if cur else "unknown"
                eras = ds.get("cost_eras")
                if not (isinstance(eras, dict) and set(eras) - {"f32"}):
                    eras = {"": ds}
                for label, era in eras.items():
                    em = era.get("epoch_ms_by_width") or {}
                    for w, n in (era.get("epochs_by_width") or {}).items():
                        c = _cost(sk, int(w), label)
                        c["epochs_exact"] += int(n)
                        c["epoch_ms_exact"] += float(em.get(w, 0.0))
            for f in rec.get("failures") or []:
                failures.append(f)
            quarantined += len(rec.get("failures") or [])
        elif ev in ("hang", "host_lost", "hang_exit", "host_lost_exit"):
            hangs.append({"event": ev,
                          "components": sorted(rec.get("components") or {}),
                          "exit_code": rec.get("exit_code")})

    ck_stats = _checkpoint_stats(run_dir)

    # the worker stamps the same tenant manifest into the supervisor ledger
    # (fleet/worker.py) — it covers attempts that died before the metrics
    # chain got the run_batch manifest event
    for rec in ledger:
        if rec.get("event") == "fleet" and rec.get("kind") == "manifest":
            for row in rec.get("requests") or []:
                if isinstance(row, dict) and row.get("request_id"):
                    manifest.setdefault(row["request_id"], row)

    attempts = [r for r in ledger if r.get("event") == "attempt"]
    classes = {}
    for a in attempts:
        c = a.get("classification") or "?"
        classes[c] = classes.get(c, 0) + 1
    final = next((r for r in reversed(ledger)
                  if r.get("event") == "final"), None)

    cost_table = []
    by_bucket = {}
    # a labelled (sk, width) keeps only its labelled rows: the unlabelled
    # entry there holds the sampled `epoch` events (the exact counts win)
    # and the `compile` events, whose counters join its first labelled row
    for (sk, width, label), acc in sorted(cost.items()):
        if not label:
            continue
        blank = cost.get((sk, width, ""))
        if blank is not None:
            for k in ("compiles", "compile_ms", "cache_hits",
                      "cache_misses"):
                acc[k] += blank[k]
            del cost[(sk, width, "")]
    for (sk, width, label), acc in sorted(cost.items()):
        exact = acc["epochs_exact"] > 0
        n = acc["epochs_exact"] if exact else acc["epochs_sampled"]
        ms = acc["epoch_ms_exact"] if exact else acc["epoch_ms_sampled"]
        cost_table.append(
            {"shape": sk, "g_bucket": width, "epochs": n,
             **({"precision": label} if label else {}),
             "mean_epoch_ms": round(ms / n, 3) if n else None,
             "total_epoch_ms": round(ms, 3),
             # sampled=True: epoch counts/times come from check-window
             # `epoch` events only (the emitting fit never wrote its
             # dispatch_stats — e.g. it crashed before fit_end), so they
             # undercount by up to check_every
             "sampled": not exact,
             "compiles": acc["compiles"],
             "compile_ms": round(acc["compile_ms"], 3),
             "cache_hits": acc["cache_hits"],
             "cache_misses": acc["cache_misses"]})
        if n:
            by_bucket[str(width)] = by_bucket.get(str(width), 0) + n

    # cost-model accuracy table: the run's prediction-vs-actual residuals
    # per (shape, G-bucket) — the "is the learned model any good yet" view
    cm_rows = []
    for (sk, width), a in sorted(cm_acc.items()):
        last = a["last"] or {}
        cm_rows.append({
            "shape": sk, "g_bucket": width, "samples": a["samples"],
            "mape_pct": (round(a["abs_pct_sum"] / a["samples"], 2)
                         if a["samples"] else None),
            "sources": sorted(a["sources"]),
            "last_predicted_epoch_ms": last.get("predicted_epoch_ms"),
            "last_actual_epoch_ms": last.get("actual_epoch_ms"),
            "last_eta_s": last.get("eta_s"),
            "last_epoch": last.get("epoch"),
        })

    # predictive policy decision table: what the policy decided
    # (compact / hold / widen / fallback), the saving it PREDICTED, and —
    # for executed compactions, joined against the observed per-width epoch
    # means above — the saving it REALIZED. The fallback count is the
    # "how often did the store have no usable prior" health signal
    def _observed_mean_ms(sk, width):
        n = ms = 0
        for (ksk, kw, _), acc in cost.items():
            if ksk != sk or kw != int(width or 0):
                continue
            exact = acc["epochs_exact"] > 0
            n += acc["epochs_exact"] if exact else acc["epochs_sampled"]
            ms += (acc["epoch_ms_exact"] if exact
                   else acc["epoch_ms_sampled"])
        return ms / n if n else None

    policy_decisions = None
    if policy_events or preempt_events:
        by_action = {}
        fallbacks = 0
        pred_sum = real_sum = 0.0
        joined = 0
        rows = []
        for p in policy_events:
            key = f"{p.get('kind')}:{p.get('action') or '?'}"
            by_action[key] = by_action.get(key, 0) + 1
            if p.get("fallback"):
                fallbacks += 1
            realized = None
            if p.get("kind") == "compaction" and p.get("action") == "compact" \
                    and isinstance(p.get("saving_ms"), (int, float)) \
                    and isinstance(p.get("epochs_remaining"), (int, float)):
                mf = _observed_mean_ms(p.get("_shape_key"),
                                       p.get("from_width"))
                mt = _observed_mean_ms(p.get("_shape_key"),
                                       p.get("to_width"))
                if mf is not None and mt is not None:
                    realized = (mf - mt) * p["epochs_remaining"]
                    pred_sum += p["saving_ms"]
                    real_sum += realized
                    joined += 1
            rows.append({
                "kind": p.get("kind"), "action": p.get("action"),
                "epoch": p.get("epoch"),
                "fallback": bool(p.get("fallback")),
                "from_width": p.get("from_width"),
                "to_width": p.get("to_width"),
                "chosen_width": p.get("chosen_width"),
                "heuristic_width": p.get("heuristic_width"),
                "predicted_saving_ms": p.get("saving_ms"),
                "realized_saving_ms": (round(realized, 3)
                                       if realized is not None else None),
                "compile_ms": p.get("compile_ms"),
                "epochs_remaining": p.get("epochs_remaining"),
                "beneficiary": p.get("beneficiary"),
                "reason": p.get("reason")})
        policy_decisions = {
            "decisions": len(policy_events),
            "by_action": dict(sorted(by_action.items())),
            "fallbacks": fallbacks,
            "predicted_saving_ms": (round(pred_sum, 3) if joined else None),
            "realized_saving_ms": (round(real_sum, 3) if joined else None),
            "preempts": sum(1 for p in preempt_events
                            if p.get("kind") == "preempted"),
            "preempt_signals": sum(1 for p in preempt_events
                                   if p.get("kind") == "signal"),
            "rows": rows[-16:],
        }

    # model-quality section (obs/quality.py): per-fit convergence readouts
    # from the quality events + the fit_end snapshot, and — on fleet batch
    # run dirs — the per-request quality blocks run_batch stamped into
    # results/<id>.json (requests with no quality events render n/a)
    quality_fits = []
    for i, f in enumerate(fits):
        qv = f.pop("_quality", None)
        if qv is None:
            continue
        snap = qv.get("snapshot") or {}
        last = qv.get("last") or {}
        quality_fits.append({
            "fit": i, "model": f.get("model"),
            "windows": snap.get("windows") or qv["windows"],
            "lanes": snap.get("lanes"),
            "plateaued_count": (snap.get("plateaued_count")
                                if snap else last.get("plateaued_count")),
            "converged_at_epoch": snap.get("converged_at_epoch"),
            "final_stability": (snap.get("mean_edge_stability")
                                if snap else last.get("mean_jaccard")),
            "final_auroc": (snap.get("mean_auroc")
                            if snap else last.get("mean_auroc")),
            "final_aupr": (snap.get("mean_aupr")
                           if snap else last.get("mean_aupr")),
        })
    request_quality = {}
    results_dir = os.path.join(run_dir, "results")
    if manifest and os.path.isdir(results_dir):
        for rid in manifest:
            try:
                with open(os.path.join(results_dir, f"{rid}.json")) as fh:
                    rec_ = json.load(fh)
                request_quality[rid] = (rec_ or {}).get("quality")
            except (OSError, ValueError):
                request_quality[rid] = None
    quality_section = {"fits": quality_fits, "requests": request_quality}

    # device-memory section: predicted vs measured peak per fit + the
    # profile-artifact inventory (capture windows announce their artifacts
    # via `profile` events; stray artifact dirs under the run dir are
    # globbed too so un-announced traces still surface)
    mem_fits = []
    for i, f in enumerate(fits):
        m = f.pop("_memory", None)
        if m is None:
            continue
        pred, meas = m["predicted_bytes"], m["measured_peak_bytes"]
        err = (round(100.0 * (pred - meas) / meas, 1)
               if isinstance(pred, (int, float))
               and isinstance(meas, (int, float)) and meas else None)
        mem_fits.append({"fit": i, "model": f.get("model"), **m,
                         "err_pct": err})
    artifact_dirs = sorted(
        os.path.relpath(p, run_dir)
        for p in glob.glob(os.path.join(run_dir, "profile*"))
        if os.path.isdir(p))
    memory_section = {
        "fits": mem_fits,
        "measured_available": any(
            m["measured_peak_bytes"] is not None for m in mem_fits),
        "profiles": profiles,
        "profile_artifacts": artifact_dirs,
    }

    # per-tenant section (fleet runs, docs/ARCHITECTURE.md "Fleet sweep
    # service"): fits/points/lane-epochs/wall attributed through the tenant
    # manifest's merged point ranges; quarantine causes keyed by which
    # range the failing ORIGINAL point id falls in
    tenants = {}
    if manifest:
        # lane-epochs attributed by point share of the engine's EXACT
        # total (dispatch_stats lane_epochs counts what actually computed,
        # early-stop/compaction included) — per-tenant numbers always sum
        # to the run's own lane-epoch accounting above, never beyond it
        total_pts = sum(
            max(int(r.get("stop") or 0) - int(r.get("start") or 0), 0)
            for r in manifest.values()) or 1
        exact_lane_epochs = int(stats_sum["lane_epochs"])
        for row in manifest.values():
            t = tenants.setdefault(str(row.get("tenant")), {
                "requests": 0, "points": 0, "lane_epochs": 0,
                "quarantined": {}, "wall_s": (round(t_last - t_first, 3)
                                              if t_first is not None
                                              else None)})
            n = int(row.get("stop") or 0) - int(row.get("start") or 0)
            t["requests"] += 1
            t["points"] += n
        # largest-remainder apportionment of the exact total by point
        # share (independent rounding could sum past the engine's number)
        shares = sorted(
            ((exact_lane_epochs * t["points"]) % total_pts, name)
            for name, t in tenants.items())
        leftover = exact_lane_epochs - sum(
            exact_lane_epochs * t["points"] // total_pts
            for t in tenants.values())
        for frac, name in reversed(shares):
            t = tenants[name]
            t["lane_epochs"] = exact_lane_epochs * t["points"] // total_pts
            if leftover > 0 and frac:
                t["lane_epochs"] += 1
                leftover -= 1
        for f in failures:
            p = f.get("point")
            if not isinstance(p, int):
                continue
            for row in manifest.values():
                if int(row.get("start") or 0) <= p < int(row.get("stop")
                                                         or 0):
                    q = tenants[str(row.get("tenant"))]["quarantined"]
                    cause = f.get("cause") or "?"
                    q[cause] = q.get(cause, 0) + 1
                    break

    # fleet containment section (fleet ROOTS only, docs/ARCHITECTURE.md
    # "Fleet failure containment"): dead-letter dossiers, per-request
    # attempt budgets, and the containment-lifecycle event counts (bisect /
    # deadletter / cancel / requeue / renew_error)
    containment = None
    fleet_slo = None
    fleet_autoscale = None
    if os.path.exists(os.path.join(run_dir, "requests.jsonl")) \
            or os.path.isdir(os.path.join(run_dir, "leases")):
        from redcliff_tpu_torch.fleet import autoscale as _as
        from redcliff_tpu_torch.fleet.queue import FleetQueue
        from redcliff_tpu_torch.obs import slo as _slo

        # fleet-SLO section: per-tenant queue-wait percentiles,
        # time-to-first-attempt, deadline hit-rate, attempts-per-request,
        # dead-letter rate from the durable lifecycle ledger, with
        # REDCLIFF_SLO_* breach flags
        fleet_slo = _slo.slo_for_root(run_dir)
        q = FleetQueue(run_dir, create=False)  # pure reader
        st = q.status()
        containment = {
            "counts": st["counts"],
            "deadletters": [{
                "request_id": rec.get("request_id"),
                "deadlettered_at": rec.get("deadlettered_at"),
                "dossier": rec.get("dossier"),
            } for rec in q.deadletters()],
            "attempt_records": q.attempt_records(),
            "events": {k: fleet_kind_counts[k] for k in sorted(
                fleet_kind_counts)
                if k in ("deadletter", "bisect", "cancel", "requeue",
                         "renew_error", "lease_lost", "reclaim")},
        }
        # autoscale section: decision-kind tallies from the
        # metrics chain, the last non-hold decision, the durable published
        # control state, active QoS rungs, and admission-gate rejects
        auto_state = _as.load_state(run_dir)
        qos_rungs = _as.active_qos(run_dir)
        if autoscale_counts or auto_state is not None or qos_rungs \
                or bp_rejects or qos_last:
            fleet_autoscale = {
                "decisions": {k: autoscale_counts[k]
                              for k in sorted(autoscale_counts)},
                "last_decision": ({k: last_autoscale.get(k) for k in
                                   ("kind", "reason", "workers", "target",
                                    "queue_depth", "drain_eta_s",
                                    "breaches", "wall_time")}
                                  if last_autoscale else None),
                "state": auto_state,
                "qos": {t: {"rung": r.get("rung"), "reason": r.get("reason")}
                        for t, r in sorted(qos_rungs.items())},
                "qos_demotes": int(qos_demotes),
                "qos_last_events": {t: {k: e.get(k) for k in
                                        ("kind", "rung", "from_rung",
                                         "reason")}
                                    for t, e in sorted(qos_last.items())},
                "backpressure": {
                    "rejects": int(bp_rejects),
                    "last": ({k: bp_last.get(k) for k in
                              ("tenant", "eta_s", "threshold_s",
                               "queue_depth", "workers")}
                             if bp_last else None),
                },
            }

    # spatial-packing section: slot-lifecycle tallies, the
    # newest priced verdict, and the partial-result streaming progress.
    # None on run dirs/roots that never packed or streamed.
    fleet_packing = None
    if not partial_streamed:
        # fleet ROOT: partial_result events live in each batch's RUN-DIR
        # chain, not here — count the durable stream files instead (the
        # same at-least-once contract `fleet status` / `obs watch` read)
        for pf in sorted(glob.glob(os.path.join(
                run_dir, "work", "*", "results", "*.partial.jsonl")))[:256]:
            try:
                with open(pf, "r", encoding="utf-8") as fh:
                    for line in fh:
                        if not line.strip():
                            continue
                        partial_streamed += 1
                        try:
                            partial_final += bool(
                                json.loads(line).get("final"))
                        except ValueError:
                            pass
            except OSError:
                continue
    if packing_counts or partial_streamed:
        fleet_packing = {
            "events": {k: packing_counts[k] for k in sorted(packing_counts)},
            "last_plan": ({k: packing_last_plan.get(k) for k in
                           ("decision", "reason", "makespan_s", "serial_s",
                            "makespan_ratio", "n_devices", "pool",
                            "headroom_violations")}
                          if packing_last_plan else None),
            "partial_results": {"streamed": int(partial_streamed),
                                "final": int(partial_final)},
        }

    # streaming-inference section: the serve plane's cumulative
    # counters + latency SLO view (obs/slo.py compute_serve_slo over the
    # run's `serve` events, REDCLIFF_SLO_SERVE_* breach flags) and the
    # session-lifecycle tallies. None on run dirs that never served.
    serve_section = None
    serve_events = [r for r in records if r.get("event") == "serve"]
    if serve_events:
        from redcliff_tpu_torch.obs import slo as _slo_mod

        session_kinds = {}
        qos_demotes_serve = 0
        for r in records:
            if r.get("event") == "session":
                k = str(r.get("kind"))
                session_kinds[k] = session_kinds.get(k, 0) + 1
            elif r.get("event") == "serve" and r.get("kind") == "qos" \
                    and (r.get("rung") or 0) > (r.get("from_rung") or 0):
                qos_demotes_serve += 1
        serve_section = {
            "slo": _slo_mod.compute_serve_slo(records),
            "sessions": {k: session_kinds[k]
                         for k in sorted(session_kinds)},
            "qos_demotes": qos_demotes_serve,
        }
        # elastic-data-plane occupancy table: rung ride history
        # from the `serve_ladder` decisions, dead-lane % from the tick-level
        # width-vs-capacity ratio (the fraction of slot-table FLOPs the
        # ladder did NOT dispatch), fuse-depth distribution from the newest
        # cumulative `serve_fuse` histogram, and serve-scoped precision
        # demotions (the poisoned-lane-storm sentinel)
        ladder_counts = {}
        rung_history = []
        ladder_mode = None
        width_sum = width_n = live_sum = 0
        capacity = None
        fuse_hist = None
        fused_samples = 0
        serve_demotions = []
        for r in records:
            ev = r.get("event")
            if ev == "serve":
                if r.get("capacity") is not None:
                    capacity = r["capacity"]
                if r.get("mode") is not None:
                    ladder_mode = r["mode"]
                if r.get("kind") == "tick" and r.get("width") is not None:
                    width_sum += r["width"]
                    width_n += 1
                    live_sum += r.get("live") or 0
                if r.get("fused_samples") is not None:
                    fused_samples = r["fused_samples"]
            elif ev == "serve_ladder":
                k = str(r.get("kind"))
                ladder_counts[k] = ladder_counts.get(k, 0) + 1
                if k in ("grow", "shrink") and len(rung_history) < 64:
                    rung_history.append(
                        {"kind": k, "from": r.get("from_width"),
                         "to": r.get("to_width"), "live": r.get("live"),
                         "tick": r.get("ticks")})
            elif ev == "serve_fuse" and r.get("kind") == "stats":
                fuse_hist = r.get("hist") or fuse_hist
                if r.get("fused_samples") is not None:
                    fused_samples = r["fused_samples"]
            elif ev == "precision" and r.get("scope") == "serve":
                serve_demotions.append(
                    {"kind": r.get("kind"), "cause": r.get("cause"),
                     "lanes_poisoned": r.get("lanes_poisoned"),
                     "tick": r.get("ticks")})
        if width_n or ladder_counts or fuse_hist or serve_demotions:
            mean_width = (width_sum / width_n) if width_n else None
            dead_pct = None
            if mean_width is not None and capacity:
                dead_pct = round(100.0 * (1.0 - mean_width / capacity), 1)
            serve_section["occupancy"] = {
                "ladder_mode": ladder_mode,
                "capacity": capacity,
                "mean_rung": (round(mean_width, 2)
                              if mean_width is not None else None),
                "mean_live": (round(live_sum / width_n, 2)
                              if width_n else None),
                "dead_lane_flops_saved_pct": dead_pct,
                "decisions": {k: ladder_counts[k]
                              for k in sorted(ladder_counts)},
                "rung_history": rung_history,
                "fuse_depth_hist": fuse_hist,
                "fused_samples": int(fused_samples),
                "demotions": serve_demotions,
            }

    schema_errors = _schema.validate_records(records)
    ledger_errors = _schema.validate_records(ledger, kind="ledger")

    saved = None
    if stats_sum["lane_epochs_nominal"]:
        saved = round(100.0 * (1 - stats_sum["lane_epochs"]
                               / stats_sum["lane_epochs_nominal"]), 1)
    return {
        "run_dir": os.path.abspath(run_dir),
        "schema_version": _schema.SCHEMA_VERSION,
        "wall_span_s": (round(t_last - t_first, 3)
                        if t_first is not None else None),
        "fits": fits,
        "attempts": {"n": len(attempts), "classifications": classes,
                     "final": (final or {}).get("classification"),
                     "meshes": [a.get("mesh") for a in attempts
                                if a.get("mesh")]},
        "time_breakdown_ms": {
            "compile": round(stats_sum["compile_ms"], 3),
            "train_dispatch": round(stats_sum["train_time_ms"], 3),
            "val_dispatch": round(stats_sum["val_time_ms"], 3),
            "ckpt_stall": round(stats_sum["ckpt_stall_ms"], 3),
            "ckpt_barrier_stall": round(stats_sum["ckpt_barrier_stall_ms"],
                                        3),
            "prefetch_stall": round(stats_sum["prefetch_stall_ms"], 3),
            # the rows are NESTED measurements, not a partition:
            # ckpt_barrier_stall is contained in ckpt_stall (the async
            # submit barrier runs inside the save hand-off), and cold
            # compiles + prefetch stalls happen inside the train_dispatch
            # wall time — summing the rows double-counts
            "overlap_note": "nested, not disjoint: ckpt_barrier_stall "
                            "within ckpt_stall; compile and prefetch_stall "
                            "within train_dispatch",
        },
        "dispatches": {"train": int(stats_sum["train_dispatches"]),
                       "val": int(stats_sum["val_dispatches"]),
                       "epochs": int(stats_sum["epochs"])},
        "lane_epochs": {"total": int(stats_sum["lane_epochs"]),
                        "nominal": int(stats_sum["lane_epochs_nominal"]),
                        "saved_pct": saved,
                        "by_bucket": by_bucket},
        "compactions": compactions,
        "remeshes": remeshes,
        "policy_decisions": policy_decisions,
        "tenants": tenants,
        "fleet_containment": containment,
        "fleet_slo": fleet_slo,
        "fleet_autoscale": fleet_autoscale,
        "fleet_packing": fleet_packing,
        "serve": serve_section,
        "quality": quality_section,
        "memory": memory_section,
        "numerics": {"anomaly_events": anomalies,
                     "guarded_steps_skipped": int(skipped_steps),
                     "rollbacks": rollbacks, "aborts": aborts,
                     "quarantined_lanes": quarantined,
                     "failures": failures},
        "precision": precision_events,
        "autotune": autotune_events,
        "hang_incidents": hangs,
        "flight_records": sorted(
            os.path.basename(p) for p in
            glob.glob(os.path.join(run_dir, "flight_record*.json"))),
        "checkpoint_dispatch_stats": ck_stats,
        "cost_table": cost_table,
        "cost_model": {"accuracy": cm_rows,
                       "store": _cost_model_store_info(run_cache_dir)},
        # the port shows no TPU evidence as its own
        "tpu_bench_cache": None,
        "read_audit": {
            "metrics": mstats, "ledger": lstats,
            "schema_errors": [
                {"index": i, "errors": errs} for i, errs in schema_errors],
            "ledger_schema_errors": [
                {"index": i, "errors": errs} for i, errs in ledger_errors],
        },
    }


def _fmt_ms(ms):
    if ms is None:
        return "-"
    if ms >= 60_000:
        return f"{ms / 60_000:.1f}min"
    if ms >= 1_000:
        return f"{ms / 1_000:.2f}s"
    return f"{ms:.1f}ms"


def _fmt_bytes(b):
    if not isinstance(b, (int, float)):
        return "-"
    for unit, div in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10)):
        if b >= div:
            return f"{b / div:.2f}{unit}"
    return f"{int(b)}B"


def _fmt_score(v):
    return f"{v:.3f}" if isinstance(v, (int, float)) else "n/a"


def _fmt_quality(q):
    """One-line per-request quality rendering (fleet results blocks):
    requests with no quality events show an explicit n/a."""
    if not isinstance(q, dict) or not q.get("windows"):
        return "quality n/a"
    conv = q.get("converged_at_epoch")
    stab = q.get("edge_stability") or []
    stab = [s for s in stab if isinstance(s, (int, float))]
    auc = q.get("auroc") or []
    auc = [a for a in auc if isinstance(a, (int, float))]
    mean = lambda xs: sum(xs) / len(xs) if xs else None
    return ("quality "
            + (f"converged@{conv}" if conv is not None else "not converged")
            + f", stability {_fmt_score(mean(stab))}"
            + f", auroc {_fmt_score(mean(auc))}"
            + f" ({q.get('windows')} window(s))")


def render_text(report):
    """Human-readable rendering of :func:`build_report` output."""
    r = report
    out = [f"run report: {r['run_dir']}",
           f"  schema v{r['schema_version']}; wall span "
           f"{_fmt_ms((r['wall_span_s'] or 0) * 1e3)}; "
           f"{len(r['fits'])} fit attempt(s)"]
    at = r["attempts"]
    if at["n"]:
        cls = ", ".join(f"{k}x{v}" for k, v in
                        sorted(at["classifications"].items()))
        out.append(f"  supervisor: {at['n']} attempt(s) [{cls}] -> "
                   f"{at['final'] or '?'}")
    tb = r["time_breakdown_ms"]
    out.append("time breakdown (nested measurements — do not sum: barrier "
               "within ckpt_stall; compile/prefetch within train_dispatch):")
    for k in ("compile", "train_dispatch", "val_dispatch", "ckpt_stall",
              "ckpt_barrier_stall", "prefetch_stall"):
        out.append(f"  {k:<20} {_fmt_ms(tb[k])}")
    d = r["dispatches"]
    le = r["lane_epochs"]
    out.append(f"dispatches: {d['train']} train / {d['val']} val over "
               f"{d['epochs']} epoch(s)")
    out.append(f"lane-epochs: {le['total']} of {le['nominal']} nominal"
               + (f" ({le['saved_pct']}% saved by compaction)"
                  if le["saved_pct"] is not None else "")
               + f"; by bucket {le['by_bucket']}")
    if r["compactions"]:
        out.append(f"compactions: " + "; ".join(
            f"epoch {c['epoch']}: {c['from_width']}->{c['to_width']}"
            for c in r["compactions"]))
    if r["remeshes"]:
        out.append(f"remeshes: " + "; ".join(
            f"epoch {c['epoch']}: {c['from_devices']}->{c['to_devices']} "
            f"devices" for c in r["remeshes"]))
    tn = r.get("tenants") or {}
    if tn:
        out.append("per-tenant (fleet manifest, redcliff_tpu/fleet):")
        for tenant, t in sorted(tn.items()):
            quar = (", ".join(f"{k}x{v}"
                              for k, v in sorted(t["quarantined"].items()))
                    or "none")
            out.append(f"  {tenant}: {t['requests']} request(s), "
                       f"{t['points']} point(s), {t['lane_epochs']} "
                       f"lane-epoch(s), wall {_fmt_ms((t['wall_s'] or 0) * 1e3)}, "
                       f"quarantined: {quar}")
        rq = (r.get("quality") or {}).get("requests") or {}
        if rq:
            for rid in sorted(rq):
                out.append(f"  request {rid}: {_fmt_quality(rq[rid])}")
    fc = r.get("fleet_containment")
    if fc:
        c = fc["counts"]
        out.append("fleet containment (docs/ARCHITECTURE.md 'Fleet failure "
                   "containment'):")
        out.append(f"  terminal states: {c['done']} done | {c['failed']} "
                   f"failed | {c['deadletter']} dead-lettered | "
                   f"{c['canceled']} canceled "
                   f"(of {c['submitted']} submitted)")
        if fc["events"]:
            out.append("  lifecycle events: " + "  ".join(
                f"{k}x{v}" for k, v in sorted(fc["events"].items())))
        for d in fc["deadletters"]:
            doss = d.get("dossier") or {}
            causes = doss.get("quarantine_causes")
            out.append(f"  dead-letter {d['request_id']} "
                       f"[{doss.get('tenant')}]: {doss.get('reason')} after "
                       f"{doss.get('attempts')} attempt(s), classifications "
                       f"{doss.get('classifications')}"
                       + (f", quarantine causes {causes}" if causes else ""))
            for fr in doss.get("flight_records") or []:
                out.append(f"    flight record: {fr}")
        budgets = [a for a in fc["attempt_records"]
                   if a.get("attempts") or a.get("reclaims")]
        if budgets:
            out.append("  attempt budgets: " + "  ".join(
                f"{a['request_id']}={a.get('attempts', 0)}f/"
                f"{a.get('reclaims', 0)}r" for a in budgets))
    slo = r.get("fleet_slo")
    if slo:
        out.append("fleet SLOs (lifecycle ledger history.jsonl, "
                   "obs/slo.py; docs/ARCHITECTURE.md 'Request lifecycle "
                   "tracing & SLOs'):")
        out.append(f"  {'scope':<14} {'req':>4} {'setl':>5} "
                   f"{'qwait p50/p99':>16} {'ttfa p50/p99':>15} "
                   f"{'deadline':>9} {'att/req':>8} {'dl%':>6}")

        def _s(v):
            return f"{v:.2f}s" if isinstance(v, (int, float)) else "-"

        def _pair(dist):
            d = dist or {}
            return f"{_s(d.get('p50'))}/{_s(d.get('p99'))}"

        for name, b in ([("overall", slo["overall"])]
                        + sorted(slo["tenants"].items())):
            dl = b.get("deadline") or {}
            hit = (f"{dl['hit_pct']:.0f}%" if dl.get("hit_pct") is not None
                   else "-")
            att = b.get("attempts_per_request")
            dlp = b.get("deadletter_pct")
            out.append(
                f"  {name:<14} {b['requests']:>4} {b['settled']:>5} "
                f"{_pair(b.get('queue_wait_s')):>16} "
                f"{_pair(b.get('ttfa_s')):>15} {hit:>9} "
                f"{(f'{att:.2f}' if att is not None else '-'):>8} "
                f"{(f'{dlp:.1f}' if dlp is not None else '-'):>6}")
        for br in slo.get("breaches") or []:
            out.append(f"  SLO BREACH [{br['scope']}] {br['slo']}: "
                       f"{br['value']:.3f} vs threshold "
                       f"{br['threshold']:.3f}")
    fa = r.get("fleet_autoscale")
    if fa:
        out.append("fleet autoscale (SLO-driven control loop, "
                   "fleet/autoscale.py; docs/ARCHITECTURE.md 'SLO-driven "
                   "autoscaling & degraded QoS'):")
        if fa.get("decisions"):
            out.append("  decisions: " + "  ".join(
                f"{k}={v}" for k, v in sorted(fa["decisions"].items())))
        ld = fa.get("last_decision")
        if ld:
            out.append(f"  last decision: {ld.get('kind')} "
                       f"({ld.get('reason')}), workers={ld.get('workers')} "
                       f"target={ld.get('target')}")
        st_ = fa.get("state") or {}
        if st_:
            out.append(f"  published state: {st_.get('workers')}/"
                       f"{st_.get('max_workers')} worker(s), pending "
                       f"{st_.get('pending')}, drain eta "
                       f"{st_.get('drain_eta_s')}s")
        for tenant, q_ in sorted((fa.get("qos") or {}).items()):
            out.append(f"  qos tenant {tenant}: rung {q_.get('rung')} "
                       f"({q_.get('reason')})")
        bp = fa.get("backpressure") or {}
        if bp.get("rejects"):
            last = bp.get("last") or {}
            out.append(f"  backpressure: {bp['rejects']} reject(s)"
                       + (f", last [{last.get('tenant')}] eta "
                          f"{last.get('eta_s')}s vs slo "
                          f"{last.get('threshold_s')}s" if last else ""))
    fp = r.get("fleet_packing")
    if fp:
        out.append("fleet packing (spatial multi-tenant mesh packing, "
                   "parallel/packing.py; docs/ARCHITECTURE.md 'Spatial "
                   "mesh packing & gang scheduling'):")
        if fp.get("events"):
            out.append("  events: " + "  ".join(
                f"{k}={v}" for k, v in sorted(fp["events"].items())))
        lp_ = fp.get("last_plan")
        if lp_:
            ratio = lp_.get("makespan_ratio")
            out.append(
                f"  last plan: {lp_.get('decision')} ({lp_.get('reason')})"
                + (f", makespan ratio {ratio:.3f}"
                   if isinstance(ratio, (int, float)) else "")
                + f", pool {lp_.get('pool')}/{lp_.get('n_devices')} "
                  f"device(s), headroom violations "
                  f"{lp_.get('headroom_violations', 0)}")
        pr = fp.get("partial_results") or {}
        if pr.get("streamed"):
            out.append(f"  partial results: {pr['streamed']} row(s) "
                       f"streamed, {pr['final']} final")
    sv = r.get("serve")
    if sv:
        out.append("serve (streaming inference service, "
                   "redcliff_tpu/serve; docs/ARCHITECTURE.md 'Streaming "
                   "inference service'):")
        ss = sv.get("slo") or {}
        lat = ss.get("latency") or {}

        def _ms(v):
            return f"{v:.2f}ms" if isinstance(v, (int, float)) else "-"

        out.append(
            f"  {ss.get('samples_out') or 0}/{ss.get('samples_in') or 0} "
            f"samples answered over {ss.get('streams') or 0} stream(s); "
            f"lat p50/p99 {_ms(lat.get('p50_ms'))}/{_ms(lat.get('p99_ms'))}"
            f" (n={lat.get('n') or 0})"
            + (f"; {ss['rejects']} admission reject(s)"
               if ss.get("rejects") else "")
            + (f"; {ss['dropped']} slow-consumer drop(s)"
               if ss.get("dropped") else ""))
        if sv.get("sessions"):
            out.append("  sessions: " + "  ".join(
                f"{k}={v}" for k, v in sorted(sv["sessions"].items())))
        if sv.get("qos_demotes"):
            out.append(f"  qos: {sv['qos_demotes']} cadence demotion(s)")
        occ = sv.get("occupancy")
        if occ:
            out.append(
                f"  occupancy [ladder={occ.get('ladder_mode') or '?'}]: "
                f"mean rung {occ.get('mean_rung')}/"
                f"{occ.get('capacity')} slot(s) "
                f"(mean live {occ.get('mean_live')}), dead-lane FLOPs "
                f"saved {occ.get('dead_lane_flops_saved_pct')}%"
                + (", decisions " + " ".join(
                    f"{k}={v}"
                    for k, v in sorted(occ["decisions"].items()))
                   if occ.get("decisions") else ""))
            hist = occ.get("rung_history") or []
            if hist:
                ride = " -> ".join(str(h["to"]) for h in hist)
                out.append(f"    rung ride: {hist[0].get('from')} -> {ride}"
                           f" ({len(hist)} transition(s))")
            if occ.get("fuse_depth_hist"):
                out.append(
                    f"    fuse depths: " + "  ".join(
                        f"{k}x{v}" for k, v in sorted(
                            occ["fuse_depth_hist"].items(),
                            key=lambda kv: int(kv[0])))
                    + f" ({occ.get('fused_samples', 0)} fused sample(s))")
            for d in occ.get("demotions") or []:
                out.append(
                    f"    PRECISION DEMOTION [{d.get('kind')}] "
                    f"{d.get('cause')}"
                    + (f" ({d['lanes_poisoned']} lane(s) poisoned)"
                       if d.get("lanes_poisoned") is not None else ""))
        for br in ss.get("breaches") or []:
            out.append(f"  SLO BREACH [{br['scope']}] {br['slo']}: "
                       f"{br['value']:.3f} vs threshold "
                       f"{br['threshold']:.3f}")
    qf = (r.get("quality") or {}).get("fits") or []
    if qf:
        out.append("model quality (live Granger-graph readouts, "
                   "obs/quality.py):")
        for q in qf:
            conv = (f"converged@{q['converged_at_epoch']}"
                    if q.get("converged_at_epoch") is not None
                    else f"{q.get('plateaued_count') or 0} plateaued")
            out.append(
                f"  fit {q['fit']} {q.get('model')}: "
                f"{q.get('windows') or 0} window(s), "
                f"lanes={q.get('lanes') if q.get('lanes') is not None else '-'}, "
                f"{conv}, stability {_fmt_score(q.get('final_stability'))}, "
                f"auroc {_fmt_score(q.get('final_auroc'))}, "
                f"aupr {_fmt_score(q.get('final_aupr'))}")
    mem = r.get("memory") or {}
    out.append("device memory (predicted vs measured peak, obs/memory.py):")
    for m in mem.get("fits") or []:
        meas = (_fmt_bytes(m["measured_peak_bytes"])
                if m.get("measured_peak_bytes") is not None
                else f"n/a ({m.get('backend') or 'backend'})")
        err = (f", err {m['err_pct']:+.1f}%"
               if m.get("err_pct") is not None else "")
        out.append(f"  fit {m['fit']} {m.get('model')} "
                   f"bucket={m.get('g_bucket')}: predicted "
                   f"{_fmt_bytes(m.get('predicted_bytes'))}, measured peak "
                   f"{meas}{err} ({m.get('polls', 0)} poll(s))")
    if not mem.get("fits"):
        out.append("  (no memory events recorded)")
    profs = mem.get("profiles") or []
    arts = mem.get("profile_artifacts") or []
    if profs or arts:
        for p in profs:
            out.append(f"  profile [{p.get('spec')}] epochs "
                       f"{p.get('first_epoch')}-{p.get('last_epoch')}"
                       + (" (truncated)" if p.get("truncated") else "")
                       + f" -> {p.get('path')}")
        # compare by leaf name, not absolute path: the `profile` event
        # holds the WRITER's absolute path, which no longer matches after
        # the run dir is copied off-host for post-mortem analysis
        announced = {os.path.basename(os.path.normpath(p["path"]))
                     for p in profs if p.get("path")}
        for a in arts:
            if os.path.basename(os.path.normpath(a)) not in announced:
                out.append(f"  profile artifact (unannounced): {a}")
    else:
        out.append("  profiles: none (REDCLIFF_PROFILE=epoch:N / "
                   "profile_window to capture a bounded window)")
    n = r["numerics"]
    out.append(f"numerics: {n['anomaly_events']} anomaly event(s), "
               f"{n['guarded_steps_skipped']} guarded step(s) skipped, "
               f"{n['rollbacks']} rollback(s), {n['aborts']} abort(s), "
               f"{n['quarantined_lanes']} quarantined lane(s)")
    for p in r.get("precision") or []:
        out.append(f"  precision {p.get('kind')}: "
                   f"{p.get('mode_from')}->{p.get('mode_to')} at epoch "
                   f"{p.get('epoch')} ({p.get('cause') or 'resume'})")
    for a in r.get("autotune") or []:
        tile = a.get("tile") or {}
        out.append(f"  autotune {a.get('kind') or 'search'} "
                   f"{a.get('kernel')}[{a.get('shape')} g{a.get('g_bucket')}]"
                   f": tile={tile}"
                   + (f" search {a['search_ms']:.0f}ms"
                      if a.get("search_ms") else ""))
    if r["hang_incidents"]:
        out.append(f"hang/host-loss incidents: {len(r['hang_incidents'])} "
                   f"(flight records: {r['flight_records'] or 'none'})")
    out.append("cost table (per shape x G-bucket):")
    out.append(f"  {'g_bucket':>8} {'epochs':>7} {'mean_epoch':>11} "
               f"{'compile':>9} {'hits/miss':>10}  shape")
    for row in r["cost_table"]:
        # "~" marks sampled rows (check-window epoch events only — the fit
        # never wrote its dispatch_stats, so counts undercount)
        n = f"{row['epochs']}~" if row.get("sampled") else f"{row['epochs']}"
        out.append(
            f"  {row['g_bucket']:>8} {n:>7} "
            f"{_fmt_ms(row['mean_epoch_ms']):>11} "
            f"{_fmt_ms(row['compile_ms']):>9} "
            f"{row['cache_hits']:>4}/{row['cache_misses']:<5}  "
            f"{row['shape']}")
    if not r["cost_table"]:
        out.append("  (no timed epochs recorded)")
    cm = r.get("cost_model") or {}
    rows = cm.get("accuracy") or []
    out.append("cost model accuracy (prediction vs actual per shape x "
               "G-bucket, obs/costmodel.py):")
    if rows:
        out.append(f"  {'g_bucket':>8} {'samples':>8} {'mape_pct':>9} "
                   f"{'last_pred':>10} {'last_act':>9} {'eta':>8}  shape")
        for row in rows:
            out.append(
                f"  {row['g_bucket']:>8} {row['samples']:>8} "
                f"{row['mape_pct'] if row['mape_pct'] is not None else '-':>9} "
                f"{_fmt_ms(row['last_predicted_epoch_ms']):>10} "
                f"{_fmt_ms(row['last_actual_epoch_ms']):>9} "
                f"{_fmt_ms((row['last_eta_s'] or 0) * 1e3) if row['last_eta_s'] is not None else '-':>8}  "
                f"{row['shape']}")
    else:
        out.append("  (no cost_model residual events in this run)")
    st = cm.get("store") or {}
    if st.get("present"):
        stale = st.get("staleness_s")
        out.append(f"  store: {st['buckets']} bucket(s) over {st['runs']} "
                   f"fold(s), updated {_fmt_ms((stale or 0) * 1e3)} ago "
                   f"({st['path']})")
    elif st.get("configured"):
        out.append(f"  store: not written yet ({st['path']})")
    else:
        out.append("  store: no compile-cache dir configured "
                   "(REDCLIFF_COMPILE_CACHE / compile_cache_dir)")
    pd = r.get("policy_decisions")
    if pd:
        out.append(
            f"predictive policy decisions (parallel/policy.py, "
            f"REDCLIFF_PREDICTIVE): {pd['decisions']} decision(s), "
            f"{pd['fallbacks']} heuristic fallback(s), "
            f"{pd['preempt_signals']} preempt signal(s), "
            f"{pd['preempts']} preemption(s)")
        if pd.get("by_action"):
            out.append("  by action: " + "  ".join(
                f"{k}={v}" for k, v in pd["by_action"].items()))
        if pd.get("predicted_saving_ms") is not None:
            out.append(
                f"  executed compactions: predicted saving "
                f"{_fmt_ms(pd['predicted_saving_ms'])} vs realized "
                f"{_fmt_ms(pd['realized_saving_ms'])}")
        for row in pd.get("rows") or []:
            if row["kind"] == "compaction":
                body = (f"{row['from_width']}->{row['to_width']} "
                        f"pred {_fmt_ms(row['predicted_saving_ms'])}"
                        f" real {_fmt_ms(row['realized_saving_ms'])}"
                        f" ({row['epochs_remaining']} epochs left)")
            elif row["kind"] == "initial_width":
                body = (f"rung {row['chosen_width']} "
                        f"(heuristic {row['heuristic_width']})")
            else:
                body = row.get("beneficiary") or row.get("reason") or ""
            out.append(f"  {row['kind']}:{row['action']}"
                       + (" [fallback]" if row["fallback"] else "")
                       + (f" @e{row['epoch']}"
                          if row.get("epoch") is not None else "")
                       + f" {body}")
    tc = r.get("tpu_bench_cache")
    if tc:
        out.append(f"cached real-TPU evidence: {tc.get('value')} w/s on "
                   f"{tc.get('device')}, measured {tc.get('measured_at')} "
                   f"({tc.get('file')}; pallas prox max err "
                   f"{tc.get('pallas_prox_max_abs_err')})")
    audit = r["read_audit"]
    torn = (audit["metrics"].get("torn_lines", 0)
            + audit["ledger"].get("torn_lines", 0))
    nerr = len(audit["schema_errors"]) + len(audit["ledger_schema_errors"])
    out.append(f"read audit: {audit['metrics'].get('records', 0)} metric "
               f"record(s), {torn} torn line(s) skipped, "
               f"{nerr} schema violation(s)")
    for e in (audit["schema_errors"] + audit["ledger_schema_errors"])[:5]:
        out.append(f"  record {e['index']}: {'; '.join(e['errors'])}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m redcliff_tpu_torch.obs",
        description="Performance-observatory tooling (docs/ARCHITECTURE.md "
                    "'Telemetry spine' / 'Performance observatory').")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser(
        "report", help="join metrics.jsonl + run_ledger.jsonl + checkpointed "
                       "dispatch_stats into a per-run summary, the "
                       "per-(shape, G-bucket) cost table, and the "
                       "cost-model accuracy view")
    rp.add_argument("run_dir", help="run directory (holds metrics.jsonl)")
    rp.add_argument("--json", action="store_true",
                    help="print the full report as one JSON object")
    rp.add_argument("-o", "--output", default=None,
                    help="also write the JSON report to this path")
    wp = sub.add_parser(
        "watch", help="live, rotation-chain-aware tail of a run dir: lanes, "
                      "G-bucket, epoch rate, stalls, numerics, heartbeat "
                      "ages, cost-model ETA (obs/watch.py)")
    wp.add_argument("run_dir", help="run directory (holds metrics.jsonl)")
    wp.add_argument("--once", action="store_true",
                    help="print one snapshot and exit")
    wp.add_argument("--json", action="store_true",
                    help="with --once: print the snapshot as one "
                         "schema-valid JSON object")
    wp.add_argument("--interval", type=float, default=2.0,
                    help="follow-mode refresh seconds (default 2)")
    tp = sub.add_parser(
        "trace", help="export the run's spans + engine events + ledger "
                      "attempts as Chrome trace-event JSON for Perfetto "
                      "(obs/trace_export.py)")
    tp.add_argument("run_dir", help="run directory (holds metrics.jsonl), "
                                    "or a fleet root with --fleet")
    tp.add_argument("-o", "--output", default=None,
                    help="write the trace JSON here (default: stdout)")
    tp.add_argument("--fleet", action="store_true",
                    help="treat run_dir as a fleet root: join the "
                         "lifecycle ledger, worker metrics, and every "
                         "batch run dir into one timeline (per-request "
                         "tracks + queue counter tracks)")
    gp = sub.add_parser(
        "regress", help="compare the newest BENCH_r*.json of --bench-dir "
                        "against the prior trajectory per metric family "
                        "with noise bands (obs/regress.py; exit 3 when a "
                        "family regressed; the port has no default "
                        "trajectory)")
    gp.add_argument("--bench-dir", default=None)
    gp.add_argument("--current", default=None)
    gp.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "report":
        from redcliff_tpu_torch.obs.watch import diagnose_run_dir

        diag = diagnose_run_dir(args.run_dir)
        if diag is not None:
            print(f"obs report: {diag}", file=sys.stderr)
            return 2
        report = build_report(args.run_dir)
        if args.output:
            with open(args.output, "w") as f:
                json.dump(report, f, indent=2, allow_nan=False)
                f.write("\n")
        if args.json:
            json.dump(report, sys.stdout, indent=2, allow_nan=False)
            sys.stdout.write("\n")
        else:
            print(render_text(report))
        return 0
    if args.cmd == "watch":
        from redcliff_tpu_torch.obs.watch import run_watch

        return run_watch(args.run_dir, once=args.once, as_json=args.json,
                         interval=args.interval)
    if args.cmd == "trace":
        from redcliff_tpu_torch.obs.trace_export import main as trace_main

        targv = [args.run_dir]
        if args.output:
            targv += ["-o", args.output]
        if args.fleet:
            targv.append("--fleet")
        return trace_main(targv)
    if args.cmd == "regress":
        from redcliff_tpu_torch.obs.regress import main as regress_main

        rargv = []
        if args.bench_dir:
            rargv += ["--bench-dir", args.bench_dir]
        if args.current:
            rargv += ["--current", args.current]
        if args.json:
            rargv.append("--json")
        return regress_main(rargv)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
