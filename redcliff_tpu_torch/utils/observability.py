"""Back-compat shim (port of ``redcliff_tpu/utils/observability.py``): the
original observability surface, re-exported from
:mod:`redcliff_tpu_torch.obs`; new code imports from there."""
from __future__ import annotations

from redcliff_tpu_torch.obs.logging import (MetricLogger, jsonable,
                                            profiler_trace, read_jsonl)

__all__ = ["MetricLogger", "profiler_trace", "jsonable", "read_jsonl"]
