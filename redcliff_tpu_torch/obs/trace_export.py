"""Perfetto / Chrome trace-event export of a run directory's telemetry
(port of ``obs/trace_export.py``, a copy on the port's modules).

``python -m redcliff_tpu_torch.obs trace <run_dir> [-o trace.json]`` joins the
span records, the structured engine events (``cost_model`` / ``memory`` /
``compile`` / ``compaction`` / ``remesh`` / numerics / deadline / hang),
and the supervisor's ledger attempts from ``metrics.jsonl`` +
``run_ledger.jsonl`` — rotation-chain- and torn-tail-aware via the spine's
:func:`~redcliff_tpu_torch.obs.logging.read_jsonl` — into one Chrome
trace-event-format JSON object loadable in Perfetto (ui.perfetto.dev) or
``chrome://tracing``.

Mapping (the trace-event format's vocabulary):

* each writing ``(host, pid)`` becomes a trace *process* (``M`` metadata
  names it), each span component a *thread* within it — so a supervisor
  restart or a multi-host run renders as parallel process lanes;
* ``span`` records become complete (``ph="X"``) events with their measured
  ``dur_ms``, placed at the span's true START — ``Span`` stamps ``t_wall``
  at entry; ``record_span`` entries stamp it at record time (the end) and
  are backed off by their duration;
* supervisor ledger ``attempt`` records become ``X`` events on a synthetic
  ``supervisor`` process (``started_at`` + ``duration_s``);
* ``epoch`` events feed a ``lanes_live`` counter track and ``memory``
  events an ``hbm_bytes`` counter track (``ph="C"``) — the live-width and
  HBM-watermark curves next to the timeline;
* every other registered event lands as an instant (``ph="i"``) carrying
  its fields in ``args``.

**Fleet mode** (``obs trace --fleet <root>``): pointed at a
fleet sweep-service root (fleet/queue.py layout), :func:`build_fleet_trace`
joins the root's own metrics chain, the request-lifecycle ledger
(``history.jsonl``, fleet/history.py), and every ``work/<batch_id>`` run
dir + supervisor ledger into ONE timeline: per-worker / per-child
(host, pid) process lanes, a ``fleet-requests`` process with one track
per request spanning submit -> settle across every process that touched
it (under its submit-minted ``trace_id``), and queue-depth / in-flight /
dead-letter-depth counter tracks replayed from the ledger.

stdlib + the spine's jsonl reader only — no torch, never a device; the
export runs post-mortem on any machine holding the run dir.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from redcliff_tpu_torch.obs.logging import read_jsonl

__all__ = ["build_trace", "build_fleet_trace", "validate_trace",
           "write_trace", "main"]

# events never rendered as instants: spans get their own "X" events, and a
# record that already fed a counter sample this pass is not duplicated as
# an instant (epoch / measured-memory records would otherwise appear twice
# — once on the counter track, once on the timeline)
_INSTANT_SKIP = ("span",)

_COUNTER_NUMERIC = (int, float)


class _Ids:
    """Stable small-int ids for (host, pid) processes and their threads."""

    def __init__(self):
        self.pids = {}
        self.tids = {}
        self.meta = []

    def pid(self, host, pid):
        key = (host if host is not None else "?",
               pid if pid is not None else 0)
        if key not in self.pids:
            self.pids[key] = len(self.pids) + 1
            self.meta.append({"ph": "M", "name": "process_name",
                              "pid": self.pids[key], "tid": 0,
                              "args": {"name": f"{key[0]}:{key[1]}"}})
        return self.pids[key]

    def tid(self, pid, component):
        key = (pid, component or "events")
        if key not in self.tids:
            self.tids[key] = len([k for k in self.tids if k[0] == pid]) + 1
            self.meta.append({"ph": "M", "name": "thread_name",
                              "pid": pid, "tid": self.tids[key],
                              "args": {"name": key[1]}})
        return self.tids[key]


def _num(v):
    return v if isinstance(v, _COUNTER_NUMERIC) \
        and not isinstance(v, bool) else None


def _args_of(rec):
    """Event fields minus the identity/core plumbing, JSON-safe as-is
    (records come from strict-JSON metrics.jsonl)."""
    return {k: v for k, v in rec.items()
            if k not in ("event", "wall_time", "seq", "pid", "host")}


def _span_start(rec):
    """A span record's wall-clock START. ``Span`` stamps ``t_wall`` at
    __enter__ (wall_time - t_wall ≈ dur); ``record_span`` stamps it at
    record time, i.e. the END (wall_time - t_wall ≈ 0) — distinguish by
    which gap the duration better explains and back the end-stamped case
    off by its duration."""
    wall = _num(rec.get("wall_time"))
    t_wall = _num(rec.get("t_wall"))
    dur_s = (_num(rec.get("dur_ms")) or 0.0) / 1e3
    if t_wall is None:
        return (wall - dur_s) if wall is not None else None
    if wall is not None and (wall - t_wall) < 0.5 * dur_s:
        return t_wall - dur_s
    return t_wall


def _read_run_dir(run_dir):
    """(records, ledger, mstats, lstats) for one run dir — missing files
    degrade to empty, torn lines counted by the spine's reader."""
    mstats, lstats = {}, {}
    try:
        records = read_jsonl(run_dir, stats=mstats)
    except FileNotFoundError:
        records, mstats = [], {"files": [], "records": 0, "torn_lines": 0}
    ledger_path = os.path.join(run_dir, "run_ledger.jsonl")
    ledger = (read_jsonl(ledger_path, stats=lstats)
              if os.path.exists(ledger_path) else [])
    return records, ledger, mstats, lstats


def _walls_of(records, ledger):
    """Every wall-clock timestamp that must bound the trace's time base."""
    walls = [r["wall_time"] for r in records
             if _num(r.get("wall_time")) is not None]
    # span STARTS bound the time base too (a long first span would
    # otherwise begin before t0 and get a negative timestamp)
    walls += [s for r in records if r.get("event") == "span"
              for s in (_span_start(r),) if s is not None]
    walls += [r["started_at"] for r in ledger
              if _num(r.get("started_at")) is not None]
    return walls


def _metric_events(records, ids, ts, events):
    """Map one metrics-chain record list into trace events: spans ->
    ``X``, epoch/memory -> counter samples, everything else -> instants —
    each on its writing (host, pid)'s process lane."""
    for rec in records:
        ev = rec.get("event")
        wall = _num(rec.get("wall_time"))
        if ev is None or wall is None:
            continue
        pid = ids.pid(rec.get("host"), rec.get("pid"))
        if ev == "span":
            name = rec.get("name") or "span"
            comp = str(name).partition(".")[0]
            dur = _num(rec.get("dur_ms")) or 0.0
            start = _span_start(rec)
            e = {"ph": "X", "name": name, "cat": "span",
                 "ts": ts(start if start is not None else wall),
                 "dur": round(dur * 1e3, 1),
                 "pid": pid, "tid": ids.tid(pid, comp)}
            args = {k: rec[k] for k in ("span_id", "parent_id", "trace")
                    if rec.get(k) is not None}
            args.update(rec.get("attrs") or {})
            if args:
                e["args"] = args
            events.append(e)
            continue
        tid = ids.tid(pid, ev.partition("_")[0] if ev.startswith("fit")
                      else "events")
        counted = False
        if ev == "epoch":
            lanes = _num(rec.get("lanes_live"))
            if lanes is None:
                lanes = _num(rec.get("num_active"))
            if lanes is not None:
                c = {"lanes_live": lanes}
                width = _num(rec.get("grid_width"))
                if width is not None:
                    c["grid_width"] = width
                events.append({"ph": "C", "name": "lanes_live",
                               "ts": ts(wall), "pid": pid,
                               "tid": ids.tid(pid, "counters"), "args": c})
                counted = True
        if ev == "memory":
            hbm = {k: v for k in ("bytes_in_use", "peak_bytes")
                   for v in (_num(rec.get(k)),) if v is not None}
            if hbm:
                events.append({"ph": "C", "name": "hbm_bytes",
                               "ts": ts(wall), "pid": pid,
                               "tid": ids.tid(pid, "counters"),
                               "args": hbm})
                counted = True
        if ev in _INSTANT_SKIP or counted:
            continue
        events.append({"ph": "i", "name": ev, "cat": ev, "s": "t",
                       "ts": ts(wall), "pid": pid, "tid": tid,
                       "args": _args_of(rec)})


def _ledger_events(ledger, ids, ts, events, proc_name="supervisor"):
    """Supervisor ledger attempts as ``X`` events on a synthetic
    process."""
    sup_pid = None
    for rec in ledger:
        if rec.get("event") != "attempt":
            continue
        start = _num(rec.get("started_at"))
        if start is None:
            continue
        if sup_pid is None:
            sup_pid = ids.pid(proc_name, 0)
        dur_s = _num(rec.get("duration_s")) or 0.0
        events.append({
            "ph": "X",
            "name": f"attempt {rec.get('attempt')} "
                    f"[{rec.get('classification') or '?'}]",
            "cat": "attempt", "ts": ts(start),
            "dur": round(dur_s * 1e6, 1),
            "pid": sup_pid, "tid": ids.tid(sup_pid, "attempts"),
            "args": _args_of(rec)})


def build_trace(run_dir):
    """Export one run directory as a Chrome trace-event JSON dict:
    ``{"traceEvents": [...], "displayTimeUnit": "ms", "otherData": {...}}``.
    Timestamps are microseconds relative to the run's earliest record."""
    records, ledger, mstats, lstats = _read_run_dir(run_dir)
    walls = _walls_of(records, ledger)
    t0 = min(walls) if walls else 0.0
    ts = lambda wall: round((wall - t0) * 1e6, 1)

    ids = _Ids()
    events = []
    _metric_events(records, ids, ts, events)
    _ledger_events(ledger, ids, ts, events)

    events.sort(key=lambda e: e.get("ts", 0.0))
    return {
        "traceEvents": ids.meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "run_dir": os.path.abspath(run_dir),
            "t0_wall": t0,
            "records": mstats.get("records", 0),
            "torn_lines": (mstats.get("torn_lines", 0)
                           + lstats.get("torn_lines", 0)),
            "ledger_records": len(ledger),
        },
    }


def _request_track_events(history, ids, ts, events):
    """Per-request tracks from the lifecycle ledger: one thread per
    request on a synthetic ``fleet-requests`` process, holding one ``X``
    event spanning submit -> settle (the whole cross-process lifetime
    under one trace_id) plus an instant per transition (claimed / attempt
    / settled ...). Batch-scoped transitions (planned / bisected) land on
    a ``fleet-batches`` thread."""
    per_req = {}
    batch_events = []
    for rec in history:
        if rec.get("request_id") is not None:
            per_req.setdefault(rec["request_id"], []).append(rec)
        elif rec.get("kind") in ("planned", "bisected"):
            batch_events.append(rec)
    if not per_req and not batch_events:
        return
    pid = ids.pid("fleet-requests", 0)
    for rid in sorted(per_req):
        recs = sorted(per_req[rid],
                      key=lambda r: (_num(r.get("wall_time")) or 0.0,
                                     r.get("seq") or 0))
        tenant = next((r.get("tenant") for r in recs
                       if r.get("tenant") is not None), "?")
        trace_id = next((r.get("trace_id") for r in recs
                         if r.get("trace_id") is not None), None)
        walls = [w for r in recs for w in (_num(r.get("wall_time")),)
                 if w is not None]
        if not walls:
            continue
        sub = next((_num(r.get("submitted_at")) or _num(r.get("wall_time"))
                    for r in recs if r.get("kind") == "submitted"),
                   min(walls))
        settled = next((r for r in recs if r.get("kind") == "settled"),
                       None)
        end = (_num(settled.get("wall_time")) if settled is not None
               else None)
        tid = ids.tid(pid, rid)
        args = {"request_id": rid, "tenant": tenant}
        if trace_id is not None:
            args["trace_id"] = trace_id
        args["state"] = (settled.get("state") if settled is not None
                         else "live")
        events.append({"ph": "X", "name": f"{tenant}/{rid}",
                       "cat": "request", "ts": ts(min(sub, min(walls))),
                       "dur": round(max((end if end is not None
                                         else max(walls)) - sub, 0.0) * 1e6,
                                    1),
                       "pid": pid, "tid": tid, "args": args})
        for r in recs:
            wall = _num(r.get("wall_time"))
            if wall is None:
                continue
            events.append({"ph": "i", "name": str(r.get("kind")),
                           "cat": "fleet_lifecycle", "s": "t",
                           "ts": ts(wall), "pid": pid, "tid": tid,
                           "args": _args_of(r)})
    if batch_events:
        tid = ids.tid(pid, "fleet-batches")
        for r in batch_events:
            wall = _num(r.get("wall_time"))
            if wall is None:
                continue
            events.append({"ph": "i", "name": str(r.get("kind")),
                           "cat": "fleet_lifecycle", "s": "t",
                           "ts": ts(wall), "pid": pid, "tid": tid,
                           "args": _args_of(r)})


def _queue_counter_events(history, ids, ts, events):
    """Replay the lifecycle ledger into queue-depth / in-flight /
    dead-letter-depth counter tracks (one sample per transition)."""
    ordered = sorted((r for r in history if r.get("request_id") is not None),
                     key=lambda r: (_num(r.get("wall_time")) or 0.0,
                                    r.get("seq") or 0))
    if not ordered:
        return
    pid = ids.pid("fleet-queue", 0)
    tid = ids.tid(pid, "counters")
    state = {}  # request_id -> "queued" | "running" | terminal state
    queued = in_flight = deadletter = 0
    for rec in ordered:
        kind, rid = rec.get("kind"), rec["request_id"]
        wall = _num(rec.get("wall_time"))
        if wall is None:
            continue
        prev = state.get(rid)
        if kind == "submitted" and prev is None:
            state[rid] = "queued"
            queued += 1
        elif kind == "claimed" and prev == "queued":
            state[rid] = "running"
            queued -= 1
            in_flight += 1
        elif kind == "released" and prev == "running":
            # a lease release (budget-route, bisection, all-or-nothing
            # claim rollback) returns the request to the queue — without
            # this the in-flight curve would stay high through exactly the
            # crash-loop incidents the counters exist to diagnose
            state[rid] = "queued"
            in_flight -= 1
            queued += 1
        elif kind == "settled" and prev in ("queued", "running"):
            if prev == "queued":
                queued -= 1
            else:
                in_flight -= 1
            state[rid] = str(rec.get("state") or "settled")
            if state[rid] == "deadletter":
                deadletter += 1
        elif kind == "requeued" and prev not in ("queued", "running"):
            if prev == "deadletter":
                deadletter -= 1
            state[rid] = "queued"
            queued += 1
        else:
            continue
        events.append({"ph": "C", "name": "queue_depth", "ts": ts(wall),
                       "pid": pid, "tid": tid, "args": {"queued": queued}})
        events.append({"ph": "C", "name": "in_flight", "ts": ts(wall),
                       "pid": pid, "tid": tid,
                       "args": {"in_flight": in_flight}})
        events.append({"ph": "C", "name": "deadletter_depth",
                       "ts": ts(wall), "pid": pid, "tid": tid,
                       "args": {"deadletter": deadletter}})


def build_fleet_trace(root):
    """Export a FLEET ROOT (fleet/queue.py layout) as one joined Chrome
    trace: the root's own metrics chain (worker fleet events + spans), the
    lifecycle ledger's per-request tracks and queue/in-flight/dead-letter
    counter curves, and every ``work/<batch_id>`` run dir's records +
    supervisor ledger — each writing (host, pid) its own process lane, so
    one request's track visibly spans submit CLI -> worker -> supervised
    torch child (and any reclaiming worker after a SIGKILL) under one
    trace_id."""
    from redcliff_tpu_torch.fleet.history import read_history

    hstats = {}
    root_records, _ledger, rstats, _ = _read_run_dir(root)
    # the root chain never has a run_ledger; fleet_lifecycle records ride
    # history.jsonl, not metrics.jsonl
    history = read_history(root, stats=hstats)
    work_dir = os.path.join(root, "work")
    try:
        batch_dirs = sorted(
            os.path.join(work_dir, d) for d in os.listdir(work_dir)
            if os.path.isdir(os.path.join(work_dir, d)))
    except OSError:
        batch_dirs = []
    runs = []
    torn = rstats.get("torn_lines", 0) + hstats.get("torn_lines", 0)
    n_records = rstats.get("records", 0) + hstats.get("records", 0)
    for d in batch_dirs:
        records, ledger, mstats, lstats = _read_run_dir(d)
        runs.append((d, records, ledger))
        torn += mstats.get("torn_lines", 0) + lstats.get("torn_lines", 0)
        n_records += mstats.get("records", 0)

    walls = _walls_of(root_records, [])
    walls += [w for r in history
              for w in (_num(r.get("wall_time")),
                        _num(r.get("submitted_at")),
                        _num(r.get("started_at"))) if w is not None]
    for _d, records, ledger in runs:
        walls += _walls_of(records, ledger)
    t0 = min(walls) if walls else 0.0
    ts = lambda wall: round((wall - t0) * 1e6, 1)

    ids = _Ids()
    events = []
    _metric_events(root_records, ids, ts, events)
    for d, records, ledger in runs:
        _metric_events(records, ids, ts, events)
        _ledger_events(ledger, ids, ts, events,
                       proc_name=f"supervisor:{os.path.basename(d)}")
    _request_track_events(history, ids, ts, events)
    _queue_counter_events(history, ids, ts, events)

    events.sort(key=lambda e: e.get("ts", 0.0))
    return {
        "traceEvents": ids.meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "fleet_root": os.path.abspath(root),
            "t0_wall": t0,
            "records": n_records,
            "history_records": hstats.get("records", 0),
            "batch_run_dirs": len(runs),
            "torn_lines": torn,
        },
    }


_VALID_PH = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n", "s", "t",
             "f"}


def validate_trace(trace):
    """Structural validation against the Chrome trace-event schema subset
    this exporter emits. Returns a list of error strings (empty = valid);
    shared by the tier-1 round-trip test and the bench probe."""
    errors = []
    if not isinstance(trace, dict):
        return ["trace is not an object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(e.get("pid"), int) \
                or not isinstance(e.get("tid"), int):
            errors.append(f"{where}: pid/tid must be ints")
        if ph == "M":
            if not isinstance((e.get("args") or {}).get("name"), str):
                errors.append(f"{where}: metadata without args.name")
            continue
        if _num(e.get("ts")) is None or e["ts"] < 0:
            errors.append(f"{where}: missing/negative ts")
        if not isinstance(e.get("name"), str):
            errors.append(f"{where}: missing name")
        if ph == "X" and (_num(e.get("dur")) is None or e["dur"] < 0):
            errors.append(f"{where}: X event without non-negative dur")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or not all(
                    _num(v) is not None for v in args.values()):
                errors.append(f"{where}: C event args must be numeric")
    return errors


def write_trace(run_dir, output, fleet=False):
    """Build and write the trace; returns the trace dict. ``fleet=True``
    treats ``run_dir`` as a fleet root (:func:`build_fleet_trace`)."""
    trace = build_fleet_trace(run_dir) if fleet else build_trace(run_dir)
    with open(output, "w") as f:
        json.dump(trace, f, allow_nan=False)
        f.write("\n")
    return trace


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m redcliff_tpu_torch.obs trace",
        description="Export a run directory's telemetry as Chrome "
                    "trace-event JSON (open in ui.perfetto.dev).")
    ap.add_argument("run_dir", help="run directory (holds metrics.jsonl), "
                                    "or a fleet root with --fleet")
    ap.add_argument("-o", "--output", default=None,
                    help="write the trace JSON here (default: stdout)")
    ap.add_argument("--fleet", action="store_true",
                    help="treat run_dir as a fleet sweep-service root: "
                         "join the lifecycle ledger, worker metrics, and "
                         "every batch run dir into one timeline "
                         "(per-request tracks + queue counter tracks)")
    args = ap.parse_args(argv)
    from redcliff_tpu_torch.obs.watch import diagnose_run_dir, is_fleet_root

    diag = diagnose_run_dir(args.run_dir)
    if diag is None and args.fleet and not is_fleet_root(args.run_dir):
        diag = (f"not a fleet root (no requests.jsonl / leases/): "
                f"{args.run_dir}")
    if diag is not None:
        print(f"obs trace: {diag}", file=sys.stderr)
        return 2
    if args.output:
        trace = write_trace(args.run_dir, args.output, fleet=args.fleet)
        od = trace["otherData"]
        print(f"obs trace: {len(trace['traceEvents'])} event(s) from "
              f"{od['records']} record(s) ({od['torn_lines']} torn line(s) "
              f"skipped) -> {args.output}")
    else:
        trace = (build_fleet_trace(args.run_dir) if args.fleet
                 else build_trace(args.run_dir))
        json.dump(trace, sys.stdout, allow_nan=False)
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
