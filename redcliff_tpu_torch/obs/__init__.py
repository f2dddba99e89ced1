"""redcliff_tpu_torch.obs — the telemetry spine (port of
``redcliff_tpu/obs/__init__.py``).

* :mod:`.spans` — lifecycle trace spans and cross-thread counters;
  zero-cost when disabled (``REDCLIFF_TRACE=0``), never a device sync;
* :mod:`.flight` — the crash flight recorder: bounded in-memory rings of
  each component's last spans, dumped as ``flight_record.json`` on a
  numerics abort;
* :mod:`.logging` — strict-JSON ``metrics.jsonl`` writing (seq/pid/host
  identity on every record, size-capped rotation) and crash-tolerant
  reading;
* :mod:`.schema` — the port's closed event-schema registry, its validator
  and the source tripwires;
* :mod:`.memory` — the analytical device-memory footprint and live
  watermarks from the caching allocator;
* :mod:`.profiling` — bounded ``torch.profiler`` capture windows
  (``REDCLIFF_PROFILE=epoch:3`` / ``profile_window``);
* :mod:`.quality` — the model-quality observatory: per-lane graph
  summaries, convergence diagnostics and live AUROC/AUPR
  (``REDCLIFF_QUALITY``);
* :mod:`.costmodel` — the learned per-(shape, width) epoch and capture
  cost store the grid scores and folds, and the predictive scheduling
  policy prices from.

Not ported yet (ROADMAP queue 1, item 11): the JAX package's ``report``,
``watch``, ``trace_export``, ``regress`` and ``slo`` modules and their
names (``build_report``, ``render_text``, ``build_snapshot``,
``run_sentinel``, ``build_trace``, ``build_fleet_trace``,
``validate_trace``, ``compute_slo``, ``slo_for_root``). Asking for one
raises ``NotImplementedError``; none is silently absent.

Import discipline: importing this package does no CUDA work; numpy and
torch load with :mod:`.logging` and :mod:`.quality`, lazily, on first
attribute access.
"""
from __future__ import annotations

from redcliff_tpu_torch.obs import costmodel, flight, schema, spans  # noqa: F401,E501
from redcliff_tpu_torch.obs import memory, profiling  # noqa: F401
from redcliff_tpu_torch.obs.spans import COUNTERS as counters  # noqa: F401
from redcliff_tpu_torch.obs.spans import (NOOP, Span, enabled,  # noqa: F401
                                          record_span, set_enabled, span)

__all__ = [
    "span", "record_span", "Span", "NOOP", "enabled", "set_enabled",
    "counters", "costmodel", "flight", "schema", "spans", "memory",
    "profiling",
    "quality", "MetricLogger", "jsonable", "read_jsonl", "jsonl_files",
    "profiler_trace",
]

_LAZY = {
    "MetricLogger": "redcliff_tpu_torch.obs.logging",
    "jsonable": "redcliff_tpu_torch.obs.logging",
    "read_jsonl": "redcliff_tpu_torch.obs.logging",
    "jsonl_files": "redcliff_tpu_torch.obs.logging",
    "profiler_trace": "redcliff_tpu_torch.obs.logging",
}
_LAZY_MODULES = {"quality": "redcliff_tpu_torch.obs.quality"}
# the JAX package's names whose modules are not ported yet
_UNPORTED = {
    "report": "report", "build_report": "report", "render_text": "report",
    "watch": "watch", "build_snapshot": "watch",
    "regress": "regress", "run_sentinel": "regress",
    "trace_export": "trace_export", "build_trace": "trace_export",
    "build_fleet_trace": "trace_export", "validate_trace": "trace_export",
    "slo": "slo", "compute_slo": "slo", "slo_for_root": "slo",
}


def __getattr__(name):
    import importlib

    mod = _LAZY_MODULES.get(name)
    if mod is not None:
        return importlib.import_module(mod)
    mod = _LAZY.get(name)
    if mod is not None:
        return getattr(importlib.import_module(mod), name)
    if name in _UNPORTED:
        raise NotImplementedError(
            f"redcliff_tpu_torch.obs.{name} (obs/{_UNPORTED[name]}.py) is "
            f"not ported yet (ROADMAP queue 1, item 11)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
