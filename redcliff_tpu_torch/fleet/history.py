"""Durable request-lifecycle ledger: ``<root>/history.jsonl``.

The fleet's SERVICE-LEVEL memory. The queue's terminal records say *where*
a request ended; the metrics chain says what each process did while it had
the request — but neither survives as one joinable per-request timeline:
the spool never learns a request was claimed, and a worker's metrics die
with its run dir's retention. This ledger records every lifecycle
TRANSITION — append-only, one strict-JSON line per event, multi-process
safe — so queue-wait percentiles, deadline hit-rates, and attempt counts
(obs/slo.py) and the fleet-wide Perfetto export (obs/trace_export.py
``--fleet``) can be computed long after the workers that produced them are
gone, across any number of worker restarts and SIGKILL storms.

Event taxonomy (``fleet_lifecycle`` in the closed obs/schema.py registry;
docs/ARCHITECTURE.md "Request lifecycle tracing & SLOs")::

    submitted   queue.submit — mints the request's durable trace_id
    planned     worker — the admission/merge decision that claimed a batch
    claimed     queue.claim — fresh claim or lease-expiry reclaim
    attempt     worker — one supervised run of a batch holding the request
                (classification + supervisor attempt count + started_at)
    released    queue Lease.release — a claim handed back without a verdict
                (budget-route, bisection, all-or-nothing claim rollback):
                the request is queued again and its queue wait continues
    bisected    worker — a blind-failed merged batch split into pinned
                halves (the halves stay linked to the members' traces)
    settled     queue._settle — the terminal transition
                (state=done|failed|deadletter|canceled)
    requeued    queue.requeue — a dead-letter resurrected (fresh budget)

Every event carries ``wall_time`` + the seq/pid/host identity triple (the
spine's ordering contract) and, where the writer knows them, the request's
``trace_id``/``batch_id``/``tenant`` — the join keys one trace identity
rides from submit to settle across the submit CLI, the worker, and the
supervised run_batch child.

Write discipline: one ``O_APPEND`` write + fsync per event with the same
torn-tail newline-healing guard as the request spool (fleet/queue.py) —
concurrent submitters/workers interleave whole lines, a writer SIGKILLed
mid-append leaves one torn line the tolerant reader skips and counts.
Writes are BEST-EFFORT (an unwritable history must never fail the queue
protocol itself); reads ride the spine's rotation-chain- and
torn-tail-aware :func:`redcliff_tpu_torch.obs.logging.read_jsonl`.

Rotation: ``REDCLIFF_HISTORY_MAX_BYTES`` (0/unset = never rotate, the
default) caps the head file like the metrics spine —
``history.jsonl`` -> ``history.jsonl.1``, shifting backups up and
dropping the oldest past :data:`MAX_BACKUPS`. Unlike the spine's
single-writer logger this ledger has many writer PROCESSES, so exactly
one racer rotates (non-blocking flock on a ``.lock`` sidecar; losers
skip — the next append retries) and a writer mid-append keeps its fd
through the rename, so records land in the rotated segment, never lost.
Under a cap the SLO window is the retained chain: week-long fleets trade
unbounded ledger growth (and the O(ledger) re-parse every ``obs watch``
tick pays on an active root) for windowed service metrics.

stdlib only at module scope, and never torch or jax (obs/schema.py ``--check``
enforces it): the submit CLI and worker control processes write here.

Port of ``redcliff_tpu/fleet/history.py``, a copy: it computes and writes
what the JAX module does.
"""
from __future__ import annotations

import fcntl
import itertools
import json
import os
import time

from redcliff_tpu_torch.obs import spans as _spans

__all__ = ["HISTORY_NAME", "LIFECYCLE_EVENT", "ENV_MAX_BYTES",
           "MAX_BACKUPS", "history_path", "append_line", "append_event",
           "read_history"]

HISTORY_NAME = "history.jsonl"
LIFECYCLE_EVENT = "fleet_lifecycle"
ENV_MAX_BYTES = "REDCLIFF_HISTORY_MAX_BYTES"
MAX_BACKUPS = 8

# process-local sequence for history records (the spine's per-process total
# order; independent of obs.logging's counter — (pid, seq) only needs to
# order ONE file's records from one process)
_seq = itertools.count(1)


def history_path(root):
    return os.path.join(str(root), HISTORY_NAME)


def append_line(path, line):
    """One guarded ``O_APPEND`` write + fsync of ``line`` (bytes, newline-
    terminated): concurrent writers interleave whole lines, and a writer
    SIGKILLed mid-append leaves one torn tail the NEXT writer heals by
    leading with a newline — its record never fuses into the garbage (two
    healers racing just produce a blank line the tolerant reader skips).
    The one copy of the crash-safety invariant this ledger and the request
    spool (fleet/queue.py submit) both ride; raises ``OSError`` — each
    caller picks its own durability contract."""
    fd = os.open(str(path), os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        size = os.fstat(fd).st_size
        if size and os.pread(fd, 1, size - 1) != b"\n":
            line = b"\n" + line
        os.write(fd, line)
        os.fsync(fd)
    finally:
        os.close(fd)


def append_event(root, kind, request_id=None, trace_id=None, batch_id=None,
                 tenant=None, now=None, **fields):
    """Append one lifecycle transition to ``<root>/history.jsonl``;
    returns the record (written or not — best-effort durability: an
    unwritable ledger is counted against observability, never against the
    queue protocol the caller is in the middle of)."""
    now = time.time() if now is None else now
    rec = {"event": LIFECYCLE_EVENT, "wall_time": now, "seq": next(_seq),
           "pid": os.getpid(), "host": _spans.HOST, "kind": str(kind)}
    for key, val in (("request_id", request_id), ("trace_id", trace_id),
                     ("batch_id", batch_id),
                     ("tenant", str(tenant) if tenant is not None else None)):
        if val is not None:
            rec[key] = val
    for key, val in fields.items():
        if val is not None:
            rec[key] = val
    try:
        path = history_path(root)
        append_line(path,
                    json.dumps(rec, allow_nan=False).encode("utf-8") + b"\n")
        _maybe_rotate(path)
    except OSError:
        pass
    return rec


def _maybe_rotate(path):
    """Rotate ``path`` past the ``REDCLIFF_HISTORY_MAX_BYTES`` cap (0/unset
    = never). Multi-process safe: exactly one racer wins a non-blocking
    flock on the ``.lock`` sidecar and shifts the chain; losers skip — the
    cap is advisory, the NEXT append retries. A concurrent appender's
    O_APPEND fd follows its inode through the rename, so its record lands
    in the rotated segment and the chain reader still sees it. Rotation is
    best-effort like the spine's: a failed rename grows the file past the
    cap but never destroys recorded transitions."""
    try:
        cap = int(os.environ.get(ENV_MAX_BYTES, "0") or 0)
    except ValueError:
        cap = 0
    if cap <= 0:
        return
    try:
        if os.path.getsize(path) <= cap:
            return
    except OSError:
        return
    try:
        lfd = os.open(f"{path}.lock", os.O_CREAT | os.O_RDWR, 0o644)
    except OSError:
        return
    try:
        try:
            fcntl.flock(lfd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            return  # another process is rotating right now
        try:
            if os.path.getsize(path) <= cap:
                return  # it already rotated while we waited on the lock
            oldest = f"{path}.{MAX_BACKUPS}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(MAX_BACKUPS - 1, 0, -1):
                src = f"{path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{path}.{i + 1}")
            os.replace(path, f"{path}.1")
        except OSError:
            pass
    finally:
        os.close(lfd)


def read_history(root, stats=None):
    """Every parseable lifecycle record, oldest first (rotation-chain- and
    torn-tail-aware via the spine's reader). ``stats`` (optional dict
    out-param) gets ``{"files", "records", "torn_lines"}``. Returns ``[]``
    — never raises — on a root with no history yet (pure readers point
    this at arbitrary directories)."""
    # lazy import: obs.logging pulls numpy, which control-plane writers
    # (queue/worker) never need on the append path
    from redcliff_tpu_torch.obs.logging import read_jsonl

    try:
        records = read_jsonl(history_path(root), stats=stats)
    except FileNotFoundError:
        if stats is not None:
            stats.update(files=[], records=0, torn_lines=0)
        return []
    return [r for r in records if r.get("event") == LIFECYCLE_EVENT]
