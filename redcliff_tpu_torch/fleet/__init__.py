"""redcliff_tpu_torch.fleet — the grid-fleet sweep service (port of
``redcliff_tpu/fleet``: host copies, and a ``run_batch`` child that fits on
the card).

REDCLIFF-S model selection is a grid sweep by construction (per-factor cMLP
forecasters swept over regularization/shape coefficients), but a grid fit
used to be one process launched by a driver. This package turns sweep
fitting into a long-lived, multi-tenant SERVICE — the "heavy traffic from
millions of users" shape of large-scale ML systems (arXiv:1605.08695)
applied to sweep serving:

* :mod:`.queue` — a durable, crash-safe request queue: an append-only JSONL
  spool plus atomic claim/lease files with lease expiry, so a SIGKILLed
  worker's claim is reclaimed by the next worker and the fit resumes from
  its durable checkpoint — a request is never lost and never run twice;
* :mod:`.planner` — the cost/memory-aware admission planner: packs
  heterogeneous requests (shapes, priorities, deadlines) into the elastic
  scheduler's G-buckets by predicted wall-clock
  (obs/costmodel.py ``predict_fit_eta``) under an HBM budget
  (obs/memory.py ``per_lane_bytes``/``check_headroom``), batching
  same-shape requests into ONE grid fit so the mesh stays full and the
  persistent compile cache amortizes across tenants;
* :mod:`.worker` — the worker loop: claims a planned batch, runs it under
  the crash-loop supervisor (runtime/supervisor.py ``supervise``), renews
  leases while the fit runs, stamps tenant ids into ``run_ledger.jsonl``
  and metrics events, and marks requests complete from the batch's
  per-request results;
* :mod:`.run_batch` — the torch-side batch driver the worker supervises: one
  merged grid fit per batch (checkpointed + resumable, content-derived
  per-lane seeds so a request fits identically whatever batch it lands
  in), split back into per-request result records plus the merged-grid
  ``failures.json`` attribution artifact;
* :mod:`.chaos` — the fleet chaos harness: poison request
  specs, worker SIGKILL storms, lease-expiry races, torn/corrupt durable
  state — seeded schedules for the containment soak;
* CLI — ``python -m redcliff_tpu_torch.fleet
  submit|work|autoscale|status|cancel|requeue``.

Blast-radius containment (docs/ARCHITECTURE.md "Fleet failure
containment"): per-request retry budgets persisted in ``attempts/``,
poison attribution from the grid engine's per-lane quarantine causes,
blind-failure batch bisection over pinned compositions, suspect-solo
admission planning, and a durable ``deadletter/`` with failure dossiers —
so one poison tenant can never fail a healthy co-tenant's request or
crash-loop a worker fleet forever.

Import discipline: ``queue``/``planner``/``worker`` are under the
observability no-host-sync discipline (obs/schema.py ``--check``): no
torch and no jax import at all — a fleet control process must never
initialize a backend (that is ``run_batch``'s job, in the supervised
child).
"""
from __future__ import annotations

__all__ = ["queue", "planner", "worker"]
