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

Fleet mode (``--fleet``, :func:`build_fleet_trace`) reads a fleet
sweep-service root, which the port does not have yet (ROADMAP queue 1,
item 12): it raises, and the CLI exits 2.

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


FLEET_NOT_PORTED = ("fleet trace export reads a fleet sweep-service root, "
                    "which is not ported yet (ROADMAP queue 1, item 12)")


def build_fleet_trace(root):
    """The JAX module's fleet-root export: raises until the fleet is
    ported."""
    raise NotImplementedError(FLEET_NOT_PORTED)


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
    from redcliff_tpu_torch.obs.watch import diagnose_run_dir

    diag = diagnose_run_dir(args.run_dir)
    if diag is None and args.fleet:
        diag = FLEET_NOT_PORTED
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
