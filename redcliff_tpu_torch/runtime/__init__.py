"""redcliff_tpu_torch.runtime — the fault-tolerance runtime (port of
``redcliff_tpu/runtime/__init__.py``): the layer between "the math is
right" and "the fit survives the machine".

* :mod:`.admission` — the structured admission-reject taxonomy;
* :mod:`.checkpoint` — durable checkpoint files (atomic writes, a ``.prev``
  generation, CRC header, quarantine, dataset fingerprints), the
  background :class:`AsyncCheckpointWriter` and its ``host_snapshot``;
* :mod:`.retry` — one retry/backoff/deadline policy with a fixed-schema
  outcome log;
* :mod:`.preempt` — SIGTERM/SIGINT capture that turns a preemption notice
  into a final checkpoint;
* :mod:`.numerics` — the numerics sentinel (guarded updates, skip
  counters, the divergence monitor);
* :mod:`.watchdog` — heartbeats, hang detection and the exit-code
  taxonomy;
* :mod:`.faultinject` — the fault-injection hooks and the child fit;
* :mod:`.compileobs` — compile observability (CUDA-graph captures).

The exports are the JAX package's names, plus ``AsyncCheckpointWriter``;
``BackpressureReject`` (the serve plane's admission error, ROADMAP queue
1, item 1) raises ``NotImplementedError``. Names resolve lazily (the
stdlib retry names at import), so importing this package imports neither
torch nor anything CUDA-specific.
"""
from __future__ import annotations

# stdlib; imported here so that ``runtime.retry`` is the function, as in
# the JAX package, not its module
from redcliff_tpu_torch.runtime.retry import (  # noqa: F401
    PROBE_RETRY_POLICY,
    GiveUp,
    RetryOutcome,
    RetryPolicy,
    retry,
)

__all__ = [
    "AdmissionReject", "SlotsExhausted",
    "CheckpointCorruptError", "CheckpointWriteError", "AsyncCheckpointWriter",
    "dataset_fingerprint", "load_checkpoint", "quarantine", "read_checkpoint",
    "write_checkpoint",
    "DivergenceMonitor", "NumericsAction", "NumericsPolicy", "global_norm",
    "guarded_update", "init_numerics_state", "numerics_summary",
    "scale_learning_rate",
    "Preempted", "PreemptionGuard",
    "PROBE_RETRY_POLICY", "GiveUp", "RetryOutcome", "RetryPolicy", "retry",
]

_MODULE_OF = {
    "AdmissionReject": "admission", "SlotsExhausted": "admission",
    "CheckpointCorruptError": "checkpoint",
    "CheckpointWriteError": "checkpoint",
    "AsyncCheckpointWriter": "checkpoint",
    "dataset_fingerprint": "checkpoint", "load_checkpoint": "checkpoint",
    "quarantine": "checkpoint", "read_checkpoint": "checkpoint",
    "write_checkpoint": "checkpoint",
    "DivergenceMonitor": "numerics", "NumericsAction": "numerics",
    "NumericsPolicy": "numerics", "global_norm": "numerics",
    "guarded_update": "numerics", "init_numerics_state": "numerics",
    "numerics_summary": "numerics", "scale_learning_rate": "numerics",
    "Preempted": "preempt", "PreemptionGuard": "preempt",
}
# the JAX package's names whose counterparts are not ported yet
_UNPORTED = {"BackpressureReject": "item 1, the serve data plane"}


def __getattr__(name):
    import importlib

    mod = _MODULE_OF.get(name)
    if mod is not None:
        return getattr(importlib.import_module(
            f"redcliff_tpu_torch.runtime.{mod}"), name)
    if name in _UNPORTED:
        raise NotImplementedError(
            f"redcliff_tpu_torch.runtime.{name} is not ported yet (ROADMAP "
            f"queue 1, {_UNPORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
