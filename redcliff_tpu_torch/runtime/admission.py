"""Structured admission rejects: the port's copy of
``redcliff_tpu/runtime/admission.py``, class for class.

* :class:`AdmissionReject` — the base: every structured refusal carries
  ``eta_s`` (predicted seconds until admission would likely succeed;
  best-effort, never a promise) and ``reason``;
* :class:`BackpressureReject` — the fleet queue's reject-with-ETA
  (predicted queue wait would breach the tenant's queue-wait SLO);
* :class:`SlotsExhausted` — every stream slot is leased; ``eta_s`` is the
  soonest lease expiry;
* :class:`TenantQuotaExceeded` — the fleet admission planner's fair-share
  refusal (the batch is deferred, not dropped).

The fleet (``fleet/queue.py``, ``fleet/planner.py``) raises the two fleet
rejects; the serve chaos harness shares the one taxonomy with the JAX
package. stdlib only.
"""
from __future__ import annotations

__all__ = ["AdmissionReject", "BackpressureReject", "SlotsExhausted",
           "TenantQuotaExceeded"]


class AdmissionReject(RuntimeError):
    """Base of every structured admission refusal. ``eta_s`` may be None
    when no prediction exists."""

    def __init__(self, message, eta_s=None, reason=None):
        self.eta_s = float(eta_s) if eta_s is not None else None
        self.reason = reason
        super().__init__(message)


class BackpressureReject(AdmissionReject):
    """``fleet submit`` refused admission: the predicted queue wait would
    breach the tenant's queue-wait SLO (``REDCLIFF_SLO_QUEUE_P99_S``). The
    structured reject-with-ETA: ``eta_s`` is the predicted wait, so the
    caller can resubmit after roughly that long (or with
    ``REDCLIFF_BACKPRESSURE=0``). Rejection beats silent lateness."""

    def __init__(self, tenant, eta_s, threshold_s, queue_depth, workers):
        self.tenant = str(tenant)
        self.threshold_s = float(threshold_s)
        self.queue_depth = int(queue_depth)
        self.workers = int(workers)
        super().__init__(
            f"backpressure: predicted queue wait {float(eta_s):.1f}s exceeds "
            f"SLO {self.threshold_s:g}s for tenant {self.tenant!r} "
            f"(queue depth {self.queue_depth}, {self.workers} worker(s)); "
            f"retry in ~{float(eta_s):.0f}s or set "
            f"REDCLIFF_BACKPRESSURE=0",
            eta_s=eta_s, reason="predicted queue wait")


class SlotsExhausted(AdmissionReject):
    """``connect`` refused admission: every slot in the fixed-capacity
    stream table is leased to a live session. ``eta_s`` is the soonest
    lease expiry among live sessions, or None."""

    def __init__(self, capacity, eta_s=None):
        self.capacity = int(capacity)
        eta = (f"soonest lease expiry in ~{float(eta_s):.1f}s"
               if eta_s is not None else "no lease near expiry")
        super().__init__(
            f"serve admission: all {self.capacity} stream slot(s) leased; "
            f"{eta} — retry then, or raise REDCLIFF_SERVE_SLOTS",
            eta_s=eta_s, reason="slots exhausted")


class TenantQuotaExceeded(AdmissionReject):
    """Fleet admission planner fair-share refusal: the tenant already holds
    ``max_inflight_slots`` sub-mesh slots (in flight plus admitted earlier
    in this plan cycle), so this batch is DEFERRED — it stays queued with
    this structured reason (surfaced by ``fleet status``) and re-plans once
    a slot frees. ``eta_s`` is the tenant's soonest predicted batch
    completion when the cost model can price one, else None."""

    def __init__(self, tenant, max_inflight_slots, inflight, eta_s=None):
        self.tenant = str(tenant)
        self.max_inflight_slots = int(max_inflight_slots)
        self.inflight = int(inflight)
        super().__init__(
            f"tenant quota: {self.tenant!r} holds {self.inflight} of "
            f"{self.max_inflight_slots} fair-share slot(s); batch deferred "
            f"until one frees (REDCLIFF_FLEET_TENANT_SLOTS raises the "
            f"quota)",
            eta_s=eta_s, reason="tenant quota")
