"""Crash flight recorder: bounded in-memory rings of recent telemetry (port
of ``redcliff_tpu/obs/flight.py``, copied; stdlib only).

The hot path deliberately emits no per-dispatch events, so the most
relevant evidence of a crash (what each component was doing in its last
seconds) would never reach disk. This module keeps that evidence in
memory: every finished span and any explicitly recorded event lands in a
per-component ring of the last ``capacity`` records (``REDCLIFF_FLIGHT_N``,
default 64). On escalation (the trainers' numerics abort) :func:`dump`
writes the rings as one structured ``flight_record.json`` artifact next to
the run's ``metrics.jsonl`` — strict JSON, atomically written, latest
incident wins.

Ring appends are a dict build and a ``deque.append`` under a lock — cheap
enough for per-dispatch recording.
"""
from __future__ import annotations

import collections
import json
import math
import os
import threading
import time

__all__ = ["FlightRecorder", "RECORDER", "record", "snapshot", "clear",
           "dump", "dump_for_logger", "FLIGHT_RECORD_NAME", "ENV_CAPACITY",
           "DEFAULT_CAPACITY"]

FLIGHT_RECORD_NAME = "flight_record.json"
ENV_CAPACITY = "REDCLIFF_FLIGHT_N"
DEFAULT_CAPACITY = 64


def _capacity_from_env():
    try:
        return max(int(os.environ.get(ENV_CAPACITY, DEFAULT_CAPACITY)), 1)
    except ValueError:
        return DEFAULT_CAPACITY


class FlightRecorder:
    """Per-component bounded rings of the most recent telemetry records."""

    def __init__(self, capacity=None):
        self.capacity = capacity or _capacity_from_env()
        self._lock = threading.Lock()
        self._rings = {}

    def record(self, component, rec):
        with self._lock:
            ring = self._rings.get(component)
            if ring is None:
                ring = self._rings[component] = collections.deque(
                    maxlen=self.capacity)
            ring.append(rec)

    def snapshot(self):
        """{component: [oldest .. newest]} — copies, safe to mutate."""
        with self._lock:
            return {c: list(r) for c, r in self._rings.items()}

    def clear(self):
        with self._lock:
            self._rings.clear()


# process-global recorder: spans and engines record without plumbing a
# handle; escalation paths dump it
RECORDER = FlightRecorder()


def record(component, rec):
    """Record ``rec`` (a dict) into ``component``'s global ring."""
    RECORDER.record(component, rec)


def snapshot():
    return RECORDER.snapshot()


def clear():
    RECORDER.clear()


def _plain(v):
    """Best-effort strict-JSON coercion without numpy: non-finite floats
    become null, unknown objects become their ``str``."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return str(v)


def dump(target_dir, reason, extra=None, recorder=None,
         filename=FLIGHT_RECORD_NAME):
    """Write the flight record as ``<target_dir>/flight_record.json``
    (atomic tmp+replace; the latest incident wins) and return its path.

    The artifact is one strict-JSON object::

        {"event": "flight_record", "schema_version": ..., "reason": ...,
         "wall_time": ..., "pid": ..., "host": ...,
         "extra": <caller context, e.g. the abort's epoch and cause>,
         "components": {component: [last-N span/event records]}}
    """
    from redcliff_tpu_torch.obs import schema as _schema
    from redcliff_tpu_torch.obs import spans as _spans

    recorder = recorder if recorder is not None else RECORDER
    os.makedirs(target_dir, exist_ok=True)
    path = os.path.join(target_dir, filename)
    rec = {
        "event": "flight_record",
        "schema_version": _schema.SCHEMA_VERSION,
        "reason": reason,
        "wall_time": time.time(),
        "pid": os.getpid(),
        "host": _spans.HOST,
        "extra": _plain(extra),
        "components": _plain(recorder.snapshot()),
    }
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(rec, f, allow_nan=False)
        f.write("\n")
    os.replace(tmp, path)
    return path


def dump_for_logger(logger, reason, extra=None):
    """Dump next to a bound :class:`MetricLogger`'s jsonl file (the run
    directory); no-op returning None when the logger is inactive/unbound —
    escalation paths call this unconditionally."""
    path = getattr(logger, "path", None) if logger is not None else None
    if not path:
        return None
    return dump(os.path.dirname(path) or ".", reason, extra=extra)
