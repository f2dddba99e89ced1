"""Compile observability (port of ``redcliff_tpu/runtime/compileobs.py``).

The JAX module counts XLA compiles and persistent-cache hits through
``jax.monitoring`` listeners and points ``jax_compilation_cache_dir`` at a
versioned cache. The port compiles no XLA program. Its one-time program
cost is the epoch engine's CUDA-graph captures
(``parallel/epoch_engine.py``: one warm-up step, then the capture, per
program and compaction era), so that is what it counts:
:func:`note_capture` adds one capture and its milliseconds,
:func:`snapshot` / :func:`delta` give before/after accounting, and the
grid logs a ``compile`` event for every epoch that captured a program,
with ``programs`` = graphs captured and ``compile_ms`` = their capture
milliseconds.

``cache_hits`` and ``cache_misses`` are left out: PyTorch keeps no
persistent cache of captured graphs, so a graph is captured afresh in
every process and there is nothing to hit. (The hand-written kernels'
builds do persist, under ``build/torch_kernels/``, outside this module.)

:func:`enable_cache` is accepted, as the trainers and the grid call it in
JAX: it resolves the configured directory (the ``compile_cache_dir`` knob,
else ``REDCLIFF_COMPILE_CACHE``) so ``fit_start`` can stamp it, and caches
nothing there. JAX's ``install`` (its ``jax.monitoring`` listeners) has no
counterpart: the epoch engine reports each capture itself. stdlib only.
"""
from __future__ import annotations

import os
import threading

__all__ = ["enable_cache", "note_capture", "snapshot", "delta",
           "ENV_CACHE_DIR"]

ENV_CACHE_DIR = "REDCLIFF_COMPILE_CACHE"

_lock = threading.Lock()
_counters = {
    "compiles": 0,      # CUDA graphs captured
    "compile_ms": 0.0,  # host wall ms of those captures (warm-up included)
}


def note_capture(ms):
    """Count one CUDA-graph capture that took ``ms`` host milliseconds."""
    with _lock:
        _counters["compiles"] += 1
        _counters["compile_ms"] += float(ms)


def snapshot():
    """Current cumulative counters (a copy)."""
    with _lock:
        return dict(_counters)


def delta(before, after=None):
    """Counter difference ``after - before`` (``after`` defaults to now)."""
    after = snapshot() if after is None else after
    return {k: (round(after[k] - before[k], 3)
                if isinstance(after[k], float) else after[k] - before[k])
            for k in _counters}


def enable_cache(base_dir=None):
    """The configured compile-cache directory (``base_dir``, else the
    ``REDCLIFF_COMPILE_CACHE`` environment variable), or None when neither
    is set. Nothing is cached there (see the module docstring); the
    directory is reported in ``fit_start``."""
    base_dir = base_dir if base_dir is not None else os.environ.get(
        ENV_CACHE_DIR) or None
    return base_dir or None
