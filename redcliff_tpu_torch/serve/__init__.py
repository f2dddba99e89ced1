"""Streaming inference service (port of ``redcliff_tpu/serve``).

- :mod:`~redcliff_tpu_torch.serve.engine` — the elastic slot table: each
  stream owns one lane of cached embedder state (a device ring buffer of
  its last ``embed_lag`` samples); a tick advances every resident lane in
  one dispatch at the current occupancy rung, fused over backlog when
  asked, in f32 or mixed precision (bf16 contractions and the bf16 form of
  the factor-mix kernel over f32 state);
- :mod:`~redcliff_tpu_torch.serve.session` — the lease/heartbeat session
  registry;
- :mod:`~redcliff_tpu_torch.serve.service` — the serving loop: input
  contracts, the per-stream QoS ladder, the occupancy ladder, tick fusion,
  the poisoned-lane-storm demotion sentinel, the prefetching run loop,
  drain/resume across rung geometries and the serve telemetry;
- :mod:`~redcliff_tpu_torch.serve.chaos` — the seeded chaos harness.

``python -m redcliff_tpu_torch.serve smoke`` and ``ladder-smoke`` are the
self-contained checks; both take ``--device``.
"""
from redcliff_tpu_torch.serve.session import (  # noqa: F401
    Session,
    SessionRegistry,
)

__all__ = ["Session", "SessionRegistry"]
