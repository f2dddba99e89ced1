"""Cost/memory-aware admission planner: pack fit requests into G-buckets.

The decision layer between the durable queue (fleet/queue.py) and the grid
engine (parallel/grid.py). Given the pending heterogeneous request mix —
shapes, priorities, deadlines, point counts — :func:`plan` produces an
ordered list of BATCHES, each one grid fit:

* **same-shape requests merge into one fit** — their points concatenate
  along the grid axis, so the mesh runs one compiled program family at a
  bucket-ladder width instead of one padded micro-fit per tenant, and the
  persistent compile cache + cost-model store amortize across tenants.
  Requests batch together only when their full non-point spec matches
  (:func:`batch_key`): same model/train config, same data — one merged
  ``GridSpec`` must mean the same math for every tenant in it;
* **widths come from the elastic scheduler's ladder**
  (parallel/compaction.py ``bucket_width`` — the same rungs
  ``footprint_by_bucket`` enumerates), so the planner's packing unit IS the
  engine's execution unit;
* **admission is memory-gated**: with per-request HBM hints
  (``per_lane_bytes``/``fixed_bytes``, from obs/memory.py
  ``grid_footprint``) and a device budget (``budget_bytes``, from
  ``check_headroom``'s ``budget_bytes``), a batch is CLOSED before its
  predicted footprint at the next bucket would exceed the budget, and a
  single request that cannot fit at any width is returned as
  ``unschedulable`` — the planner never admits a batch whose footprint
  estimate exceeds headroom (pinned by tests/test_fleet.py);
* **ordering is cost-aware**: batches sort by priority (desc), then
  earliest tenant deadline, then predicted wall-clock
  (obs/costmodel.py ``predict_fit_eta`` — shortest first; unknown-ETA
  batches after, in submission order rather than hash order so planners
  with different cost-model stores agree), then
  deterministic tie-breaks, so urgent and cheap work drains ahead of long
  sweeps. Batch views also carry ``cold_compile_ms`` (the predicted
  first-touch compile when the program family is cold, 0 when the shared
  persistent cache holds it) — the fleet worker's cold-compile claim
  ordering input (parallel/policy.py ``compile_order``).

:func:`fifo_plan` is the naive one-request-per-fit baseline bench.py's
``fleet`` probe compares against (mesh-slot utilization,
:func:`utilization`).

stdlib + numpy only, no torch and no jax (obs/schema.py ``--check``
enforces it): planning runs in control processes that must never initialize
a backend. All predictions are consumed from persistent stores/hints, never
computed on device.

Port of ``redcliff_tpu/fleet/planner.py``, a copy: it computes what the
JAX module does. It reads ``precision_label`` from
``utils/precision_modes.py``, which imports no torch.
"""
from __future__ import annotations

import hashlib
import json
import os
import time

from redcliff_tpu_torch.parallel import compaction, packing as _packing
from redcliff_tpu_torch.runtime.admission import TenantQuotaExceeded

__all__ = ["batch_key", "batch_id_for", "plan", "fifo_plan", "utilization",
           "predicted_batch_bytes", "tenant_slot_quota",
           "DEFAULT_MAX_BUCKET", "ENV_TENANT_SLOTS"]

# widest bucket a single batch may occupy without an explicit override: a
# merged sweep past this rides multiple batches (bounded checkpoint size,
# bounded blast radius of one bad batch)
DEFAULT_MAX_BUCKET = 256

# per-tenant fair-share quota: max sub-mesh slots one
# tenant may hold in flight at once. "2" = every tenant, "a=1,b=4" =
# per-tenant overrides, "2,a=1" = default plus override. Unset = unlimited.
ENV_TENANT_SLOTS = "REDCLIFF_FLEET_TENANT_SLOTS"


def tenant_slot_quota(env=None):
    """Parse the ``REDCLIFF_FLEET_TENANT_SLOTS`` fair-share spec into
    ``{tenant_or_"*": max_inflight_slots}`` (None when unset/invalid —
    quotas are an operator knob, never a crash)."""
    raw = (os.environ.get(ENV_TENANT_SLOTS, "") if env is None else env)
    raw = str(raw).strip()
    if not raw:
        return None
    quota = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            tenant, _, n = part.partition("=")
            tenant = tenant.strip()
        else:
            tenant, n = "*", part
        try:
            n = int(n)
        except ValueError:
            return None
        if n < 1 or not tenant:
            return None
        quota[tenant] = n
    return quota or None


def batch_key(request):
    """The mergeability key: requests batch into one grid fit only when
    everything except their points/tenant/priority/deadline is identical
    (same model config, train config, data spec, and horizon). Returns
    ``(shape_json, spec_hash)`` — both deterministic strings."""
    shape = request.get("shape") or {}
    spec = dict(request.get("spec") or {})
    spec.pop("points", None)
    blob = json.dumps({"spec": spec, "epochs": request.get("epochs")},
                      sort_keys=True)
    return (json.dumps(shape, sort_keys=True),
            hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12])


def batch_id_for(request_ids):
    """Deterministic batch id from the ORDERED member request ids — the
    same composition always lands in the same ``work/<batch_id>`` run dir,
    which is what lets a reclaiming worker resume the dead worker's grid
    checkpoint instead of starting a different fit."""
    h = hashlib.sha1("\n".join(request_ids).encode("utf-8")).hexdigest()
    return f"batch-{h[:12]}"


def predicted_batch_bytes(requests, g_bucket):
    """Predicted HBM footprint of a merged batch at execution width
    ``g_bucket``: ``per_lane_bytes * g_bucket + max(fixed_bytes)`` from the
    members' hints (the obs/memory.py ``grid_footprint`` decomposition —
    fixed covers the device-resident dataset + epoch gather, shared across
    lanes). None when no member carries a per-lane hint (no memory
    evidence: admission degrades to ungated, mirroring
    ``check_headroom``'s explicit None on backends without memory stats)."""
    per_lane = [r.get("per_lane_bytes") for r in requests
                if isinstance(r.get("per_lane_bytes"), (int, float))]
    if not per_lane:
        return None
    fixed = max((r.get("fixed_bytes") or 0) for r in requests)
    return int(max(per_lane) * int(g_bucket) + fixed)


def _order_key(request):
    """Deterministic urgency ordering: priority desc, earliest deadline,
    submission order, id."""
    dl = request.get("deadline_s")
    return (-int(request.get("priority") or 0),
            float(dl) if dl is not None else float("inf"),
            float(request.get("submitted_at") or 0.0),
            str(request.get("request_id")))


def _batch_view(members, n_devices, cost_model=None, platform=None,
                suspect=False):
    n_points = sum(len(r.get("points") or ()) for r in members)
    width = compaction.bucket_width(n_points, n_devices)
    ids = [r["request_id"] for r in members]
    shape = members[0].get("shape") or {}
    epochs = max((r.get("epochs") or 0) for r in members)
    # precision half of the cost bucket: a mixed-precision batch must be
    # priced from mixed-epoch evidence, not f32's (the merge key guarantees
    # every member shares one train_config). utils.precision_modes imports no
    # torch — the planner's no-backend control-plane discipline holds.
    # Defensive: pricing is ADVISORY, so a malformed tenant-supplied spec
    # (non-dict train_config) degrades to the default label instead of
    # crashing the whole worker's plan cycle
    try:
        from redcliff_tpu_torch.utils.precision_modes import precision_label

        tcd = (members[0].get("spec") or {}).get("train_config") or {}
        precision = precision_label(tcd.get("precision_mode") or "f32",
                                    tcd.get("matmul_precision"))
    except Exception:  # noqa: BLE001 — tenant input, advisory output
        precision = "f32"
    eta_s = cold_compile_ms = None
    if cost_model is not None:
        try:
            from redcliff_tpu_torch.obs.schema import shape_key as _sk

            sk = _sk(shape)
            eta_s = cost_model.predict_fit_eta(
                sk, width, epochs, platform=platform,
                cold_programs=1, precision=precision)
            # cold-compile ordering input: the predicted cost of
            # this batch's FIRST-TOUCH compile — 0 when the program family
            # has compile evidence (the shared persistent compile cache holds
            # it), the predicted cold compile otherwise, None unpriceable
            if cost_model.compile_warm(sk, width, platform=platform,
                                       precision=precision):
                cold_compile_ms = 0.0
            else:
                cm = cost_model.predict_compile_ms(sk, width,
                                                   platform=platform,
                                                   precision=precision)
                cold_compile_ms = (round(float(cm), 3)
                                   if cm is not None else None)
        except Exception:  # noqa: BLE001 — predictions are advisory
            eta_s = cold_compile_ms = None
    n_dev = int(n_devices or 1)
    return {
        "batch_id": batch_id_for(ids),
        "requests": ids,
        # the members' durable trace identities (queue.submit) ride every
        # planning decision, so the worker's trace context — and the
        # `planned` lifecycle event — link the merge decision back to each
        # request's submit-to-settle timeline
        "trace_ids": {r["request_id"]: r["trace_id"]
                      for r in members if r.get("trace_id")},
        "tenants": sorted({str(r.get("tenant")) for r in members}),
        "shape": shape,
        "n_points": n_points,
        "g_bucket": width,
        # lane capacity the mesh is tied up for while this fit runs: a
        # sub-bucket fit (G' < n_devices) still occupies the whole mesh
        # serially, so slots round up to the device count — the honest
        # denominator for mesh-slot utilization
        "mesh_slots": max(width, n_dev) if width <= n_dev
        else -(-width // n_dev) * n_dev,
        "epochs": epochs,
        "priority": max((int(r.get("priority") or 0) for r in members),
                        default=0),
        "deadline_s": min((float(r["deadline_s"]) for r in members
                           if r.get("deadline_s") is not None),
                          default=None),
        "predicted_bytes": predicted_batch_bytes(members, width),
        "eta_s": (round(eta_s, 3) if isinstance(eta_s, (int, float))
                  else None),
        # earliest member submission: the deterministic tie-break for
        # unknown-ETA ordering (see _batch_order_key)
        "submitted_at": min((float(r.get("submitted_at") or 0.0)
                             for r in members), default=0.0),
        "precision": precision,
        "cold_compile_ms": cold_compile_ms,
        # containment circuit breaker: this batch was planned SOLO because
        # its request has prior failed attempts (never merged with healthy
        # tenants until it proves clean)
        "suspect": bool(suspect),
    }


def _batch_order_key(batch):
    """Priority desc, earliest deadline, then predicted wall-clock
    shortest-first for KNOWN ETAs — with unknown-ETA batches after them,
    ordered among themselves by earliest member SUBMISSION time (then id).

    The unknown group's internal order deliberately rides submission time,
    not the content-hash batch id (the older "unknown last" key):
    on a mixed-store fleet — some hosts' cost models price a shape others
    have never seen — the hash order made two planners disagree about
    which unpriced tenant drains first, i.e. queue position depended on
    which worker happened to scan. Submission order is store-independent
    FIFO fairness for every pair of batches unknown to both planners
    (pinned by the two-store planner test)."""
    dl = batch.get("deadline_s")
    eta = batch.get("eta_s")
    return (-batch["priority"],
            dl if dl is not None else float("inf"),
            ((0, float(eta)) if eta is not None
             else (1, float(batch.get("submitted_at") or 0.0))),
            batch["batch_id"])


def plan(requests, n_devices=1, budget_bytes=None, cost_model=None,
         platform=None, max_bucket=DEFAULT_MAX_BUCKET, suspects=None,
         tenant_slots=None, inflight_slots=None):
    """Pack ``requests`` (queue records) into admitted batches.

    Returns ``{"batches": [...], "unschedulable": [...], "quota_deferred":
    [...], "queue_depth", "plan_ms", "utilization", "packing"}``. Every
    admitted batch satisfies ``predicted_bytes is None or predicted_bytes
    <= budget_bytes`` (when a budget is known); requests that cannot fit
    even alone at their smallest bucket are listed under ``unschedulable``
    with a reason instead of being silently admitted.

    ``suspects`` (request-id set): containment circuit breaker — a request
    with prior failed attempts is planned into a SOLO batch, never merged
    with healthy tenants, until it proves clean. One poison tenant can then
    cost at most its own solo fits, not a merged batch's blast radius (the
    ~3x-utilization merge path stays open to everyone else).

    ``tenant_slots`` (None = the ``REDCLIFF_FLEET_TENANT_SLOTS`` env spec,
    see :func:`tenant_slot_quota`): per-tenant fair-share — a batch whose
    tenant already holds its ``max_inflight_slots`` sub-mesh slots
    (``inflight_slots``: {tenant: live slots}, from the packed worker's
    slot table, plus whatever this plan admitted earlier) is DEFERRED to
    ``quota_deferred`` with the structured
    :class:`~redcliff_tpu_torch.runtime.admission.TenantQuotaExceeded` reason —
    still queued, surfaced by ``fleet status``, re-planned next cycle.

    ``packing`` is the spatial packing decision record
    (parallel/packing.py :func:`~redcliff_tpu_torch.parallel.packing
    .price_packing` over the admitted batches): ``decision`` is
    ``"packed"`` only when every batch is cost-model priced AND the
    simulated slot-table makespan beats serial — an empty cost store keeps
    the worker bit-identical to the serial heuristic."""
    t0 = time.perf_counter()
    suspects = frozenset(suspects or ())
    ordered = sorted(requests, key=_order_key)
    groups = {}
    for r in ordered:
        groups.setdefault(batch_key(r), []).append(r)

    batches, unschedulable = [], []
    for key in sorted(groups):
        members = []
        n_points = 0
        for r in groups[key]:
            r_points = len(r.get("points") or ())
            if r_points == 0:
                unschedulable.append({"request_id": r["request_id"],
                                      "reason": "no_points"})
                continue
            if r["request_id"] in suspects:
                solo_width = compaction.bucket_width(r_points, n_devices)
                solo_bytes = predicted_batch_bytes([r], solo_width)
                if (budget_bytes is not None and solo_bytes is not None
                        and solo_bytes > budget_bytes) \
                        or solo_width > int(max_bucket):
                    unschedulable.append({
                        "request_id": r["request_id"],
                        "reason": ("exceeds_headroom"
                                   if solo_width <= int(max_bucket)
                                   else "exceeds_max_bucket"),
                        "predicted_bytes": solo_bytes,
                        "budget_bytes": budget_bytes,
                        "g_bucket": solo_width})
                    continue
                batches.append(_batch_view([r], n_devices, cost_model,
                                           platform, suspect=True))
                continue
            cand_points = n_points + r_points
            cand_width = compaction.bucket_width(cand_points, n_devices)
            cand_bytes = predicted_batch_bytes(members + [r], cand_width)
            over_budget = (budget_bytes is not None
                           and cand_bytes is not None
                           and cand_bytes > budget_bytes)
            over_width = cand_width > int(max_bucket)
            if members and (over_budget or over_width):
                batches.append(_batch_view(members, n_devices,
                                           cost_model, platform))
                members, n_points = [], 0
                cand_width = compaction.bucket_width(r_points, n_devices)
                cand_bytes = predicted_batch_bytes([r], cand_width)
                over_budget = (budget_bytes is not None
                               and cand_bytes is not None
                               and cand_bytes > budget_bytes)
                over_width = cand_width > int(max_bucket)
            if not members and (over_budget or over_width):
                unschedulable.append({
                    "request_id": r["request_id"],
                    "reason": ("exceeds_headroom" if over_budget
                               else "exceeds_max_bucket"),
                    "predicted_bytes": cand_bytes,
                    "budget_bytes": budget_bytes,
                    "g_bucket": cand_width})
                continue
            members.append(r)
            n_points += r_points
        if members:
            batches.append(_batch_view(members, n_devices, cost_model,
                                       platform))
    batches.sort(key=_batch_order_key)
    if tenant_slots is None:
        tenant_slots = tenant_slot_quota()
    batches, quota_deferred = _apply_tenant_quota(batches, tenant_slots,
                                                 inflight_slots)
    return {
        "batches": batches,
        "unschedulable": unschedulable,
        "quota_deferred": quota_deferred,
        "queue_depth": len(ordered),
        "plan_ms": round((time.perf_counter() - t0) * 1e3, 3),
        "utilization": utilization(batches),
        "packing": _packing.price_packing(batches, n_devices, budget_bytes),
    }


def _apply_tenant_quota(batches, tenant_slots, inflight_slots):
    """Fair-share filter over the ordered admitted batches: each batch
    charges one sub-mesh slot to every tenant riding it; a batch that would
    push any of its tenants past quota (live slots + slots admitted earlier
    this cycle) is deferred — stays queued, re-plans next cycle. Deferral
    never reorders the survivors (priority order is the planner's, quota
    only thins it)."""
    if not tenant_slots:
        return batches, []
    held = {str(t): int(n) for t, n in (inflight_slots or {}).items()}
    default = tenant_slots.get("*")
    admitted, deferred = [], []
    for b in batches:
        over = None
        for tenant in b.get("tenants") or ():
            cap = tenant_slots.get(tenant, default)
            if cap is not None and held.get(tenant, 0) >= cap:
                over = (tenant, cap)
                break
        if over is None:
            for tenant in b.get("tenants") or ():
                held[tenant] = held.get(tenant, 0) + 1
            admitted.append(b)
            continue
        tenant, cap = over
        exc = TenantQuotaExceeded(tenant, cap, held.get(tenant, 0),
                                  eta_s=b.get("eta_s"))
        deferred.append({"batch_id": b["batch_id"],
                         "requests": b["requests"],
                         "tenant": exc.tenant,
                         "reason": exc.reason,
                         "max_inflight_slots": exc.max_inflight_slots,
                         "inflight": exc.inflight,
                         "eta_s": exc.eta_s,
                         "detail": str(exc)})
    return admitted, deferred


def fifo_plan(requests, n_devices=1, budget_bytes=None, cost_model=None,
              platform=None):
    """The naive baseline: one request per fit, strict submission order, no
    merging — what the repo did before the fleet service (one driver
    process per sweep). Same admission gate, so the bench comparison
    isolates PACKING, not safety."""
    t0 = time.perf_counter()
    ordered = sorted(requests,
                     key=lambda r: (float(r.get("submitted_at") or 0.0),
                                    str(r.get("request_id"))))
    batches, unschedulable = [], []
    for r in ordered:
        if not r.get("points"):
            unschedulable.append({"request_id": r["request_id"],
                                  "reason": "no_points"})
            continue
        b = _batch_view([r], n_devices, cost_model, platform)
        if budget_bytes is not None and b["predicted_bytes"] is not None \
                and b["predicted_bytes"] > budget_bytes:
            unschedulable.append({
                "request_id": r["request_id"],
                "reason": "exceeds_headroom",
                "predicted_bytes": b["predicted_bytes"],
                "budget_bytes": budget_bytes,
                "g_bucket": b["g_bucket"]})
            continue
        batches.append(b)
    return {
        "batches": batches,
        "unschedulable": unschedulable,
        "queue_depth": len(ordered),
        "plan_ms": round((time.perf_counter() - t0) * 1e3, 3),
        "utilization": utilization(batches),
    }


def utilization(batches):
    """Mesh-slot utilization of a plan: real grid points over the lane
    capacity the mesh is serially tied up for (``mesh_slots`` — bucket
    padding plus per-fit mesh rounding are the waste; a 2-point fit on an
    8-device mesh burns 8 slots). ``{"points", "slots",
    "utilization_pct"}``."""
    points = sum(b["n_points"] for b in batches)
    slots = sum(b.get("mesh_slots", b["g_bucket"]) for b in batches)
    return {"points": points, "slots": slots,
            "utilization_pct": (round(100.0 * points / slots, 1)
                                if slots else None)}
