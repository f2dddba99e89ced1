"""Structured jsonl metric logging and the opt-in whole-block profiler
trace (port of ``redcliff_tpu/obs/logging.py``).

The write half of the telemetry spine: every engine appends strict-JSON
event records to ``<save_dir>/metrics.jsonl`` through
:class:`MetricLogger`, and every record carries the identity triple — a
process-wide monotonic ``seq``, ``pid`` and ``host`` — so interleaved
multi-attempt logs have a total order per process. Files rotate at a byte
cap (``REDCLIFF_METRICS_MAX_BYTES`` / the ``max_bytes`` knob) to
``metrics.jsonl.1`` ..., so long sweeps cannot grow one file unbounded.

The read half is crash-tolerant: :func:`read_jsonl` walks the rotation
chain oldest-first and SKIPS unparseable lines instead of raising (a
SIGKILL mid-append leaves a torn final line), counting them in its
``stats`` out-param. Event schemas are registered in
:mod:`redcliff_tpu_torch.obs.schema`.

:func:`jsonable` also takes torch tensors (as the JAX module takes jax
arrays): a tensor is copied to the host once, where it is coerced. The
emitters hand it host values read once an epoch, so it never makes a
device read on the step path. numpy at module scope; torch only inside
:func:`profiler_trace`.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import threading
import time
from dataclasses import asdict, is_dataclass

import numpy as np

from redcliff_tpu_torch.obs import spans as _spans

__all__ = ["MetricLogger", "profiler_trace", "jsonable", "read_jsonl",
           "jsonl_files", "ENV_MAX_BYTES", "DEFAULT_MAX_BACKUPS"]

ENV_MAX_BYTES = "REDCLIFF_METRICS_MAX_BYTES"
DEFAULT_MAX_BACKUPS = 8

# process-wide event sequence: one counter shared by every logger in the
# process, so (pid, seq) totally orders a process's records even when two
# loggers (e.g. two fits') interleave on different files
_seq = itertools.count(1)


def jsonable(v):
    """Recursively coerce numpy scalars and arrays and torch tensors into
    STRICT JSON-encodable Python values. Arrays become (nested) lists;
    non-finite floats (NaN/inf, scalar or array element) become ``None`` —
    the emitted lines never contain the JSON-standard-breaking
    ``NaN``/``Infinity`` tokens."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if is_dataclass(v) and not isinstance(v, type):
        return {k: jsonable(x) for k, x in asdict(v).items()}
    if isinstance(v, dict):
        return {str(k): jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        f = float(v)
        return f if math.isfinite(f) else None
    if hasattr(v, "detach") and hasattr(v, "cpu"):
        # a torch tensor (without importing torch here): one host copy;
        # bfloat16 and other dtypes numpy lacks go through float32
        v = v.detach().cpu()
        if not v.dtype.is_complex and v.dtype.is_floating_point \
                and v.dtype.itemsize < 4:
            v = v.float()
        return jsonable(v.numpy())
    if hasattr(v, "ndim"):  # numpy arrays and other array-likes
        arr = np.asarray(v)
        if arr.ndim == 0:
            return jsonable(arr.item())
        return [jsonable(x) for x in arr.tolist()]
    return str(v)


class MetricLogger:
    """Append-only jsonl metric writer.

    ``MetricLogger(save_dir)`` writes to ``<save_dir>/metrics.jsonl``;
    ``MetricLogger(None)`` is a no-op sink so call sites never branch.
    Resumed runs keep appending to the same file — the ``epoch`` field makes
    replays self-describing, and the ``seq``/``pid``/``host`` identity
    triple stamped on every record totally orders interleaved attempts.

    Rotation: when ``max_bytes`` (default: the ``REDCLIFF_METRICS_MAX_BYTES``
    env var; 0/unset = never rotate) is exceeded after a write, the file
    rotates — ``metrics.jsonl`` -> ``metrics.jsonl.1``, shifting existing
    backups up and dropping the oldest past ``max_backups``. Records are
    never split across the rotation boundary (whole lines only), and
    :func:`read_jsonl` reads the chain back oldest-first.
    """

    def __init__(self, target, filename="metrics.jsonl", resume=True,
                 max_bytes=None, max_backups=DEFAULT_MAX_BACKUPS):
        self._fh = None
        # another thread may log while the fit loop logs epochs;
        # serialized writes keep every jsonl line intact (a torn line
        # would break strict-JSON readers)
        self._lock = threading.Lock()
        if max_bytes is None:
            try:
                max_bytes = int(os.environ.get(ENV_MAX_BYTES, "0")) or None
            except ValueError:
                max_bytes = None
        self.max_bytes = max_bytes
        self.max_backups = max(int(max_backups), 1)
        self._pid = os.getpid()
        self._host = _spans.HOST
        if target is None:
            return
        path = target
        if not str(target).endswith(".jsonl"):
            os.makedirs(target, exist_ok=True)
            path = os.path.join(target, filename)
        else:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self.path = path
        self._fh = open(path, "a" if resume else "w")
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0

    @property
    def active(self):
        return self._fh is not None

    def log(self, event, **fields):
        if self._fh is None:
            return
        rec = {"event": event, "wall_time": time.time(),
               "seq": next(_seq), "pid": self._pid, "host": self._host}
        # trace identity (spans.set_trace_ctx / REDCLIFF_TRACE_CTX): while
        # a request-scoped context is live and tracing is on, every record
        # this process writes carries the batch/request join keys — the
        # cross-process half of the identity triple. One None check when
        # no context is set; REDCLIFF_TRACE=0 drops the stamping entirely
        ctx = _spans.trace_ctx()
        if ctx is not None and _spans.enabled() and "trace" not in fields:
            rec["trace"] = ctx
        rec.update({k: jsonable(v) for k, v in fields.items()})
        # allow_nan=False is the strictness backstop: jsonable already maps
        # non-finite floats to null, so a violation here is a bug, not data
        line = json.dumps(rec, allow_nan=False) + "\n"
        with self._lock:
            if self._fh is not None:
                self._fh.write(line)
                self._fh.flush()
                self._bytes += len(line)
                if self.max_bytes and self._bytes > self.max_bytes:
                    self._rotate_locked()

    def _rotate_locked(self):
        """Rotate under the held lock: close, shift the backup chain up
        (dropping the oldest), reopen fresh. Rotation is best-effort: if the
        head rename fails (e.g. the directory lost write permission — rename
        needs it, appending to the existing file does not), the file is
        reopened for APPEND, never truncated — a failed rotation may grow
        the file past the cap but can never destroy recorded telemetry."""
        self._fh.close()
        rotated = False
        try:
            oldest = f"{self.path}.{self.max_backups}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self.max_backups - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
            rotated = True
        except OSError:
            pass  # appending must keep working
        self._fh = open(self.path, "w" if rotated else "a")
        if rotated:
            self._bytes = 0

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def jsonl_files(path):
    """The rotation chain for a jsonl path (or a run dir), oldest first:
    ``[path.N, ..., path.1, path]`` — only files that exist. The base path
    is always last so readers see records in write order."""
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    rotated = []
    parent = os.path.dirname(path) or "."
    base = os.path.basename(path)
    pat = re.compile(re.escape(base) + r"\.(\d+)$")
    try:
        for name in os.listdir(parent):
            m = pat.match(name)
            if m:
                rotated.append((int(m.group(1)), os.path.join(parent, name)))
    except OSError:
        pass
    out = [p for _, p in sorted(rotated, reverse=True)]
    if os.path.exists(path):
        out.append(path)
    return out


def read_jsonl(path, event=None, stats=None, strict=False):
    """Load a metrics.jsonl file (optionally filtered by event type),
    following the rotation chain oldest-first.

    Crash-tolerant by default: a line that fails to parse — the torn final
    line a SIGKILL mid-append leaves behind, or a line truncated by disk
    full — is SKIPPED and counted instead of poisoning the whole file.
    Pass a dict as ``stats`` to receive ``{"files", "records",
    "torn_lines"}``; ``strict=True`` restores raise-on-bad-line.
    """
    files = jsonl_files(path)
    if not files:
        # preserve the pre-rotation contract: a missing file raises
        raise FileNotFoundError(
            path if str(path).endswith(".jsonl")
            else os.path.join(path, "metrics.jsonl"))
    out = []
    torn = 0
    for fpath in files:
        with open(fpath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    if strict:
                        raise
                    torn += 1
                    continue
                if event is None or rec.get("event") == event:
                    out.append(rec)
    if stats is not None:
        stats.update(files=files, records=len(out), torn_lines=torn)
    return out


@contextlib.contextmanager
def profiler_trace(log_dir):
    """Opt-in whole-block ``torch.profiler`` context (``log_dir=None`` is a
    no-op) that writes one Chrome trace, ``<log_dir>/trace.json``. For ad
    hoc scripts that want an entire region traced; the fit loops capture
    bounded windows through :mod:`redcliff_tpu_torch.obs.profiling`
    instead. CPU activity always, CUDA activity when CUDA is available."""
    if not log_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))
