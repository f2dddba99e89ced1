"""Lifecycle trace spans: the timing half of the telemetry spine (port of
``redcliff_tpu/obs/spans.py``, copied; stdlib only).

A *span* wraps one operation — a dispatch, a checkpoint write, a batch
fill, a compaction — and records how long it took, against both clocks
(monotonic for durations, wall for cross-process alignment), with process
and host identity and a propagated parent id so nested spans reconstruct
the call tree in a post-mortem. Every finished span lands in the in-memory
flight-recorder ring (:mod:`redcliff_tpu_torch.obs.flight`); spans opened
with ``emit=True`` and a live :class:`~redcliff_tpu_torch.obs.logging
.MetricLogger` also write one ``span`` event to ``metrics.jsonl`` (schema:
:mod:`redcliff_tpu_torch.obs.schema`).

Cost discipline:

* **zero-cost when disabled** — :func:`span` returns one shared no-op
  context after a single module-global flag check (``REDCLIFF_TRACE=0``);
* **never a device sync** — a span measures host wall time around the
  operation it wraps. Around an asynchronously launched CUDA kernel or
  graph replay that is *enqueue* time, by design: no
  ``torch.cuda.synchronize()``, no ``.item()``, no transfer ever happens
  inside span bookkeeping (device time stays attributable through the
  kernels' launch counters and the profiler windows);
* hot-path spans (per dispatch) are ring-only: a dict build and a deque
  append, no I/O.

Side-band counters (:class:`Counters`) accumulate cross-thread totals that
have no natural span emission point — prefetch stall milliseconds — which
the grid engine folds into its per-fit ``dispatch_stats``.

**Trace context**: a caller may run work under a context ``{"batch_id":
..., "trace_ids": {request_id: trace_id}}``, set in-process with
:func:`set_trace_ctx` or handed to a child process through the
``REDCLIFF_TRACE_CTX`` environment variable (parsed once at import). While
a context is live (and tracing is on), every finished span — and, through
the ``MetricLogger``, every metrics record — carries it as a ``trace``
field.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

from redcliff_tpu_torch.obs import flight as _flight

__all__ = ["span", "record_span", "enabled", "set_enabled", "Span", "NOOP",
           "Counters", "COUNTERS", "ENV_TRACE", "ENV_TRACE_CTX",
           "trace_ctx", "set_trace_ctx", "PID", "HOST"]

ENV_TRACE = "REDCLIFF_TRACE"
ENV_TRACE_CTX = "REDCLIFF_TRACE_CTX"

# tracing defaults ON: the spine's steady-state cost is ring appends and a
# handful of jsonl lines per check window; REDCLIFF_TRACE=0 drops it to one
# flag check per span() call
_enabled = os.environ.get(ENV_TRACE, "1").strip().lower() not in (
    "0", "off", "false")

PID = os.getpid()
try:
    HOST = os.uname().nodename
except (AttributeError, OSError):  # non-posix
    import socket

    HOST = socket.gethostname()

# process-wide span ids: unique within a process; (pid, span_id) is unique
# across the run's processes (both ride every span record)
_ids = itertools.count(1)
_tls = threading.local()  # per-thread open-span stack (parent propagation)


# cross-process trace context: a parent exports REDCLIFF_TRACE_CTX (JSON
# {"batch_id", "trace_ids": {request_id: trace_id}}) into its child; a
# non-dict / unparseable value is ignored — identity stamping must never
# crash the process it identifies
def _ctx_from_env():
    raw = os.environ.get(ENV_TRACE_CTX)
    if not raw:
        return None
    try:
        ctx = json.loads(raw)
    except ValueError:
        return None
    return ctx if isinstance(ctx, dict) and ctx else None


_trace_ctx = _ctx_from_env()


def trace_ctx():
    """The live trace context dict, or None: a thread-scoped context wins
    over the process-wide one."""
    return getattr(_tls, "trace_ctx", None) or _trace_ctx


def set_trace_ctx(ctx):
    """Set (or clear, with None) the trace context; returns the PREVIOUS
    context so callers can scope it. From the main thread this is the
    process-wide context; from any other thread it is a THREAD-scoped
    override, so concurrent batches never stamp each other's spans."""
    global _trace_ctx
    ctx = ctx if isinstance(ctx, dict) and ctx else None
    if threading.current_thread() is threading.main_thread():
        prev = _trace_ctx
        _trace_ctx = ctx
        return prev
    prev = getattr(_tls, "trace_ctx", None)
    _tls.trace_ctx = ctx
    return prev


def enabled():
    """Whether tracing is live (module-global flag; one attribute read)."""
    return _enabled


def set_enabled(flag):
    """Flip tracing at runtime (on/off overhead probes; tests). Returns the
    new state."""
    global _enabled
    _enabled = bool(flag)
    return _enabled


class _NoopSpan:
    """The shared disabled-tracing span: enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP = _NoopSpan()


class Span:
    """One traced operation. Use via :func:`span` as a context manager."""

    __slots__ = ("name", "component", "logger", "emit", "attrs",
                 "span_id", "parent_id", "t_wall", "t_mono", "dur_ms")

    def __init__(self, name, component, logger, emit, attrs):
        self.name = name
        self.component = component or name.partition(".")[0]
        self.logger = logger
        self.emit = emit
        self.attrs = attrs
        self.span_id = None
        self.parent_id = None
        self.t_wall = None
        self.t_mono = None
        self.dur_ms = None

    def set(self, **attrs):
        """Attach/overwrite attributes mid-span (recorded at exit)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.parent_id = stack[-1].span_id if stack else None
        self.span_id = next(_ids)
        stack.append(self)
        self.t_wall = time.time()
        self.t_mono = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur_ms = (time.perf_counter() - self.t_mono) * 1e3
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        rec = {
            "event": "span", "name": self.name,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "t_wall": self.t_wall, "t_mono": self.t_mono,
            "dur_ms": round(self.dur_ms, 3), "pid": PID, "host": HOST,
        }
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = dict(self.attrs)
        if _trace_ctx is not None:
            rec["trace"] = _trace_ctx
        _flight.record(self.component, rec)
        if self.emit and self.logger is not None \
                and getattr(self.logger, "active", False):
            emit_rec = {k: v for k, v in rec.items()
                        if k not in ("event", "pid", "host")}
            self.logger.log("span", **emit_rec)
        return False


def span(name, *, component=None, logger=None, emit=False, **attrs):
    """Open a trace span named ``name`` (convention:
    ``"<component>.<operation>"``, e.g. ``"grid.dispatch"``,
    ``"ckpt.write"``; the registry is ``obs/schema.py:SPAN_NAMES``).

    ``component`` keys the flight-recorder ring the finished span lands in
    (defaults to the name's dotted head). ``emit=True`` + a live ``logger``
    additionally writes a ``span`` event to metrics.jsonl — reserve it for
    low-frequency lifecycle spans (check windows, compactions, remeshes);
    hot-path spans stay ring-only. ``**attrs`` must be plain JSON-able
    scalars/short lists. Returns the shared no-op when tracing is disabled.
    """
    if not _enabled:
        return NOOP
    return Span(name, component, logger, emit, attrs)


def record_span(name, dur_ms, *, component=None, logger=None, emit=False,
                t_wall=None, **attrs):
    """Record an already-measured operation as a finished span — for call
    sites where wrapping the block in a context manager would be awkward
    (e.g. long engine sections timed with ``perf_counter``). Same record
    shape and destinations as :class:`Span`; returns the record, or None
    when tracing is disabled."""
    if not _enabled:
        return None
    stack = getattr(_tls, "stack", None)
    rec = {
        "event": "span", "name": name,
        "span_id": next(_ids),
        "parent_id": stack[-1].span_id if stack else None,
        "t_wall": t_wall if t_wall is not None else time.time(),
        "dur_ms": round(dur_ms, 3), "pid": PID, "host": HOST,
    }
    if attrs:
        rec["attrs"] = dict(attrs)
    if _trace_ctx is not None:
        rec["trace"] = _trace_ctx
    _flight.record(component or name.partition(".")[0], rec)
    if emit and logger is not None and getattr(logger, "active", False):
        logger.log("span", **{k: v for k, v in rec.items()
                              if k not in ("event", "pid", "host")})
    return rec


class Counters:
    """Thread-safe additive counters for cross-thread time accounting that
    has no single span emission point (prefetch stall).
    Engines snapshot at fit start and fold the delta into their stats."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {}

    def add(self, key, value=1.0):
        with self._lock:
            self._c[key] = self._c.get(key, 0.0) + value

    def snapshot(self):
        with self._lock:
            return dict(self._c)

    def delta(self, before):
        """``now - before`` for every key present now (missing = 0)."""
        now = self.snapshot()
        return {k: round(v - before.get(k, 0.0), 3) for k, v in now.items()}


COUNTERS = Counters()
