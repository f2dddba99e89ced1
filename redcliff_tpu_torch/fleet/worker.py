"""Fleet worker loop: claim planned batches, supervise fits, mark results.

One worker = one long-lived control process on a host with accelerators::

    python -m redcliff_tpu_torch.fleet work --root /fleet

Each cycle it (1) prefers RECLAIM work — expired leases whose recorded
batch composition it re-claims so the dead worker's grid fit resumes from
its durable checkpoint in the same ``work/<batch_id>`` run dir; then (2)
plans fresh admission over the pending queue (fleet/planner.py) and claims
the first admitted batch; then (3) runs the batch as a supervised child —
:func:`redcliff_tpu_torch.runtime.supervisor.supervise` around ``python -m
redcliff_tpu_torch.fleet.run_batch <batch.json>`` — so crashes, hangs, and
preemptions restart from checkpoint under the existing exit-code taxonomy,
while a background thread renews the members' leases on a cadence well
inside ``lease_s``.

Tenant stamping: before supervising, the worker appends a ``fleet``
manifest record (batch id + per-request tenant and merged point range) to
the batch's ``run_ledger.jsonl``; ``run_batch`` logs the same manifest as a
metrics event. ``obs report`` joins both into its per-tenant section, and
every planner/claim/batch transition lands as a schema-registered ``fleet``
event in the FLEET ROOT's ``metrics.jsonl`` (what ``obs watch <root>``
tails in fleet mode).

Settle discipline (blast-radius containment, docs/ARCHITECTURE.md "Fleet
failure containment"): a ``clean`` supervised outcome marks requests done
(first ``done/<id>.json`` writer wins — never run twice) — except a member
whose per-request artifact is missing (routed through the retry budget) or
whose EVERY point the grid engine quarantined for a deterministic-numerics
cause (the attribution path: the poison tenant is dead-lettered with its
quarantine causes while healthy co-tenants still complete; wall-clock
``deadline`` evictions never attribute). A terminal failure of a MERGED
batch is never blamed on its members: with 2+ live leases the batch is
split in half and the halves requeued as pinned compositions, so repeated
halving deterministically corners a poison request while its siblings
finish; with <=1 live lease (the rest lost or terminal) the survivor —
possibly a healthy co-tenant — is budget-routed, never verdicted. Only a
terminal failure of a genuinely SOLO composition is charged as that
request's own: deterministic classes fail it outright, a crash/hang loop
(``giving_up``) releases it against its durable retry budget (queue
``attempts/``) until the budget is spent, then routes it to ``deadletter/``
with a failure dossier. Anything non-terminal releases the leases so
another worker retries.

Predictive scheduling (``REDCLIFF_PREDICTIVE``,
docs/ARCHITECTURE.md "Predictive scheduling & preemption"): the worker
closes the learning loop on two decisions — fresh admission plans are
claimed COLD-COMPILE-FIRST within an urgency class (parallel/policy.py
``compile_order``: the longest predicted missing executable starts
compiling earliest, so the shared persistent cache warms on the critical
path), and a running batch is CHECKPOINT-AND-PREEMPTED when
``predict_fit_eta`` shows a queued higher-priority tenant's deadline would
otherwise be missed (:class:`_PreemptMonitor`). A preemption is a reclaim,
never a charged failure attempt: leases release cleanly, the composition is
pinned with its beneficiary (``after_request``) and resumes bit-identically
from its checkpoint after the deadline tenant is served.

No torch and no jax anywhere in this module's import chain (obs/schema.py
``--check`` enforces it): the worker is a control process — the device
backend initializes only inside the supervised ``run_batch`` child, on
``cuda`` unless the worker was given ``device``.

Port of ``redcliff_tpu/fleet/worker.py``: the same loop, settle discipline
and records. The one addition is ``device`` (``work(..., device=None)``,
``fleet work --device``): when given, the supervised child is
``python -m redcliff_tpu_torch.fleet.run_batch <batch.json> --device D``;
when not, the child runs on ``cuda`` and fails without it. As in JAX, a
packed gang needs ``n_devices >= 2``, so on one card the serial loop
runs.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import socket
import sys
import threading
import time
import uuid

from redcliff_tpu_torch.obs import record_span
from redcliff_tpu_torch.obs import costmodel as _costmodel
from redcliff_tpu_torch.obs import flight as _flight
from redcliff_tpu_torch.obs import spans as _spans
from redcliff_tpu_torch.runtime.supervisor import (SupervisorPolicy,
                                             latest_cost_model_eta,
                                             supervise)
from redcliff_tpu_torch.fleet import autoscale as _autoscale
from redcliff_tpu_torch.fleet import history as _history
from redcliff_tpu_torch.fleet import planner as _planner
from redcliff_tpu_torch.fleet.queue import FleetQueue, LeaseLost
from redcliff_tpu_torch.parallel import packing as _packing
# parallel/policy.py is torch- and jax-free by contract (schema --check pins
# it via this import chain): the predictive-scheduling gate + the
# cold-compile claim-ordering decision live there, beside the
# width/compaction pricing
from redcliff_tpu_torch.parallel.policy import (PredictiveSchedulingPolicy,
                                          predictive_enabled)

__all__ = ["work", "run_one_batch", "default_worker_id",
           "TERMINAL_FAIL_CLASSES", "DETERMINISTIC_FAIL_CLASSES",
           "DEFAULT_MAX_ATTEMPTS", "DEFAULT_PREEMPT_GRACE_S"]

# supervised outcomes a restart cannot fix: the batch will not be re-run
# as-is (solo requests are failed or budget-routed; merged batches bisect)
TERMINAL_FAIL_CLASSES = ("numerics_abort", "deadline", "giving_up",
                         "mesh_exhausted")

# the subset that is a deterministic VERDICT on a solo request (a replay
# provably repeats it): recorded in failed/, not dead-lettered. giving_up
# is deliberately absent — a crash loop is *suspicious*, not proven
# deterministic (the host may be at fault), so it burns retry budget and
# dead-letters only when the budget is spent
DETERMINISTIC_FAIL_CLASSES = ("numerics_abort", "deadline", "mesh_exhausted")

# default per-request retry budget: failure attempts (giving_up /
# missing_result) a request may accumulate before it is dead-lettered.
# Lease-expiry reclaims deliberately do NOT count — a worker SIGKILL storm
# is an infrastructure fault, and letting it spend tenants' budgets would
# dead-letter healthy requests (the exact blast radius this layer exists
# to contain)
DEFAULT_MAX_ATTEMPTS = 3

# deadline-aware preemption knobs (armed by REDCLIFF_PREDICTIVE,
# parallel/policy.py): the grace term is the charged checkpoint-and-yield
# overhead — the in-flight epoch the child drains plus its final checkpoint
# and the beneficiary's supervised-child spawn — and the poll is how often
# the monitor re-prices the queue against the running batch
ENV_PREEMPT_GRACE = "REDCLIFF_PREEMPT_GRACE_S"
ENV_PREEMPT_POLL = "REDCLIFF_PREEMPT_POLL_S"
DEFAULT_PREEMPT_GRACE_S = 5.0
DEFAULT_PREEMPT_POLL_S = 0.5


def default_worker_id():
    return f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"


def _logger(root):
    """The fleet root's MetricLogger (lazy import: obs.logging pulls numpy,
    which is fine for a control process — only torch and jax are banned
    here)."""
    from redcliff_tpu_torch.obs.logging import MetricLogger

    return MetricLogger(root)


def _manifest_rows(requests):
    """Per-request merged-point ranges: [{request_id, tenant, trace_id,
    start, stop}] — the tenant-attribution map every report join keys on
    (``trace_id`` links each range back to the request's lifecycle
    trace)."""
    rows, start = [], 0
    for r in requests:
        n = len(r.get("points") or ())
        rows.append({"request_id": r["request_id"],
                     "tenant": str(r.get("tenant")),
                     "trace_id": r.get("trace_id"),
                     "start": start, "stop": start + n})
        start += n
    return rows


def _trace_context(batch_id, members):
    """The cross-process trace context for one batch: batch id + every
    member's durable trace identity (minted at submit). Set in-process for
    the worker's own spans/events and exported to the supervised run_batch
    child via ``REDCLIFF_TRACE_CTX`` (obs/spans.py)."""
    tids = {m["request_id"]: m["trace_id"]
            for m in members if m.get("trace_id")}
    ctx = {"batch_id": batch_id}
    if tids:
        ctx["trace_ids"] = tids
    return ctx


def _claim_batch(q, worker_id, lease_s, batch_id, request_ids, by_id,
                 logger, reclaim=False, all_ids=None):
    """Claim every member of one batch (all-or-nothing); returns
    {request_id: Lease} or None. ``all_ids`` records the FULL batch
    composition on each lease (it may exceed ``request_ids`` on a reclaim
    whose other members already completed)."""
    leases = {}
    for rid in request_ids:
        rec = by_id.get(rid)
        lease = q.claim(rid, worker_id, lease_s, batch_id=batch_id,
                        batch_request_ids=list(all_ids or request_ids),
                        tenant=(rec or {}).get("tenant"),
                        trace_id=(rec or {}).get("trace_id"))
        if lease is None:
            if q.is_terminal(rid):
                continue  # already finished by someone: not a conflict
            for l in leases.values():
                l.release()
            return None
        leases[rid] = lease
    if leases:
        logger.log("fleet", kind="reclaim" if reclaim else "claim",
                   batch_id=batch_id, requests=list(leases),
                   tenants=sorted({str(by_id[r].get("tenant"))
                                   for r in leases if r in by_id}),
                   worker=worker_id)
    return leases or None


def _next_batch(q, worker_id, lease_s, n_devices, budget_bytes, max_bucket,
                logger, predictive=False, tenant_slots=None,
                inflight_slots=None, plan_out=None):
    """Reclaim-first, then pinned compositions, then plan-and-claim.
    Returns (batch_view, leases, member_requests) or None when nothing is
    claimable right now. ``predictive`` arms the cold-compile claim
    ordering over fresh admission plans.

    Packing hooks: ``tenant_slots``/``inflight_slots`` ride into
    the planner's fair-share quota, and ``plan_out`` (a mutable dict) is
    filled with the fresh plan's ``packing`` decision + ``quota_deferred``
    list so the packed worker loop can gang-schedule without re-planning."""
    now = time.time()
    by_id = {r["request_id"]: r for r in q.requests()}

    # 1) reclaim: an expired lease records the batch it was claimed under —
    # resume THAT composition so the grid checkpoint fingerprint matches.
    # The FULL recorded member list stays the batch (manifest offsets must
    # match the merged grid the checkpoint was written under); only the
    # not-yet-terminal members need fresh claims
    for batch_id, stale in sorted(q.expired_claims().items(),
                                  key=lambda kv: str(kv[0])):
        if batch_id is None:
            continue  # no recorded composition: replanned below
        rids_all = (stale[0].get("batch_request_ids")
                    or [l["request_id"] for l in stale])
        rids_all = [r for r in rids_all if r in by_id]
        claimable = [r for r in rids_all if not q.is_terminal(r)]
        if not claimable:
            continue
        leases = _claim_batch(q, worker_id, lease_s, batch_id, claimable,
                              by_id, logger, reclaim=True,
                              all_ids=rids_all)
        if leases:
            # the reclaim is recorded on each member's durable attempt
            # ledger (kind="reclaim": dossier evidence, NOT budget — worker
            # deaths are infra faults, see DEFAULT_MAX_ATTEMPTS)
            for rid in leases:
                q.record_attempt(rid, "lease_expired", batch_id=batch_id,
                                 run_dir=q.batch_dir(batch_id),
                                 kind="reclaim")
            members = [by_id[r] for r in rids_all]
            batch = _planner._batch_view(members, n_devices)
            batch["batch_id"] = batch_id  # preserve the recorded run dir
            return batch, leases, members

    # 1b) pinned compositions (bisection halves): claimed EXACTLY as
    # pinned, bypassing the planner — a just-bisected suspect must never be
    # re-merged with healthy tenants. The pin is consumed at claim time;
    # from then on the lease records carry the composition (so a worker
    # dying mid-half lands back in the reclaim path above)
    pinned = q.pinned_batches()
    pinned_ids = {rid for p in pinned for rid in (p.get("requests") or ())}
    for pin in pinned:
        batch_id = pin["batch_id"]
        # deadline-aware preemption: a preempted composition is
        # pinned WITH the beneficiary it yielded the mesh to — defer
        # claiming it while that request is still waiting (no terminal
        # record, no live lease), so this cycle falls through to fresh
        # planning and serves the beneficiary first. Once it is being
        # served (live lease elsewhere) or settled, the pin resumes the
        # preempted fit from its checkpoint in the same run dir
        after = pin.get("after_request")
        if after and after in by_id and not q.is_terminal(after):
            lease = q.lease_of(after)
            if lease is None \
                    or float(lease.get("expires_at") or 0.0) <= now:
                continue
        rids_all = [r for r in pin["requests"] if r in by_id]
        claimable = [r for r in rids_all if not q.is_terminal(r)]
        if not claimable:
            q.unpin_batch(batch_id)  # everyone settled elsewhere
            continue
        if claimable != rids_all:
            # a member settled elsewhere (canceled/dead-lettered) between
            # pin and claim: its points must NOT ride back into the fit —
            # unlike a RECLAIM there is no checkpoint fingerprint to
            # preserve here, so re-key the half to the surviving
            # composition (same content-derived lane seeds, so any prior
            # run of this exact composition still resumes cleanly)
            new_id = _planner.batch_id_for(claimable)
            # a re-keyed pin keeps its preemption-beneficiary deferral:
            # dropping after_request here would let the preempted batch
            # jump ahead of the tenant it yielded the mesh to
            q.pin_batch(new_id, claimable,
                        parent_batch_id=pin.get("parent_batch_id"),
                        after_request=pin.get("after_request"))
            q.unpin_batch(batch_id)
            batch_id, rids_all = new_id, claimable
        leases = _claim_batch(q, worker_id, lease_s, batch_id, claimable,
                              by_id, logger, all_ids=rids_all)
        if leases:
            q.unpin_batch(batch_id)
            members = [by_id[r] for r in rids_all]
            batch = _planner._batch_view(members, n_devices)
            batch["batch_id"] = batch_id
            return batch, leases, members

    # 2) fresh admission plan over the pending queue (derived from the one
    # spool scan above: non-terminal, no live lease, not pinned, submission
    # order), with prior-failure suspects quarantined into solo batches
    now = time.time()
    pending, suspects = [], set()
    for rid, rec in by_id.items():
        if rid in pinned_ids or q.is_terminal(rid):
            continue
        lease = q.lease_of(rid)
        if lease is not None and float(lease.get("expires_at") or 0.0) > now:
            continue
        pending.append(rec)
        att = q.attempt_record(rid)
        if att and (int(att.get("attempts") or 0) > 0
                    or att.get("suspect")):
            # prior failed attempts, or a requeued dead-letter (fresh
            # budget but still a suspect until it proves clean)
            suspects.add(rid)
    if not pending:
        return None
    # degraded-QoS ladder: apply any durable per-tenant demotion
    # rung (fleet/autoscale.py, <root>/qos/<tenant>.json) to the FRESH
    # admission population only. A demoted spec no longer shares a
    # planner.batch_key with undemoted work, so un-breached co-tenants'
    # batches are bit-identical with the ladder active or not. The reclaim
    # and pinned paths above deliberately bypass this: their compositions
    # must resume the exact spec their grid checkpoint was fitted under
    qos_rungs = _autoscale.active_qos(q.root)
    if qos_rungs:
        pending = [_autoscale.apply_qos(rec, qos_rungs) for rec in pending]
    pend_map = {r["request_id"]: r for r in pending}
    t0 = time.perf_counter()
    cost_model = _costmodel.load()
    pl = _planner.plan(pending, n_devices=n_devices,
                       budget_bytes=budget_bytes,
                       cost_model=cost_model, max_bucket=max_bucket,
                       suspects=suspects, tenant_slots=tenant_slots,
                       inflight_slots=inflight_slots)
    if plan_out is not None:
        plan_out["packing"] = pl.get("packing")
        plan_out["quota_deferred"] = pl.get("quota_deferred") or []
    record_span("fleet.plan", (time.perf_counter() - t0) * 1e3,
                component="fleet", logger=logger, emit=True,
                queue_depth=pl["queue_depth"], batches=len(pl["batches"]))
    logger.log("fleet", kind="plan", queue_depth=pl["queue_depth"],
               batches=len(pl["batches"]),
               unschedulable=len(pl["unschedulable"]),
               quota_deferred=(pl.get("quota_deferred") or None),
               plan_ms=pl["plan_ms"],
               suspects=sorted(suspects),
               utilization_pct=pl["utilization"]["utilization_pct"],
               decisions=[{k: b.get(k) for k in
                           ("batch_id", "requests", "tenants", "n_points",
                            "g_bucket", "predicted_bytes", "eta_s",
                            "priority", "suspect")}
                          for b in pl["batches"][:8]],
               worker=worker_id)
    batches = pl["batches"]
    if predictive and cost_model is not None and len(batches) > 1:
        batches = _cold_compile_order(batches, logger, worker_id)
    for b in batches:
        rids = [r for r in b["requests"]
                if r in by_id and not q.is_terminal(r)]
        if not rids:
            continue
        if rids != b["requests"]:
            # a member settled (e.g. canceled) between planning and this
            # claim: its points must not ride into the fit — rebuild the
            # batch from the survivors (fresh id, fresh run dir; same
            # content-derived lane seeds, so results are unchanged)
            b = _planner._batch_view([pend_map[r] for r in rids
                                      if r in pend_map], n_devices)
        leases = _claim_batch(q, worker_id, lease_s, b["batch_id"],
                              b["requests"], by_id, logger)
        if leases:
            # the merge decision that actually claimed work becomes a
            # durable `planned` lifecycle event (the decisions that were
            # merely proposed this cycle re-plan next cycle — recording
            # them all every poll would spam the ledger)
            _history.append_event(
                q.root, "planned", batch_id=b["batch_id"],
                requests=b["requests"], trace_ids=b.get("trace_ids"),
                n_points=b["n_points"], g_bucket=b["g_bucket"],
                worker=worker_id)
            # members come from the QoS-transformed map: the demoted spec
            # (and its "qos" stamp) is what rides into batch.json and the
            # supervised fit
            members = [pend_map.get(r) or by_id[r]
                       for r in b["requests"] if r in by_id]
            return b, leases, members
    return None


def _cold_compile_order(batches, logger, worker_id):
    """Cold-compile claim ordering (the worker's half of
    warming the compile cache on the critical path): within the plan's
    LEADING urgency class — the prefix of batches sharing the head's
    (priority, deadline) — claim the batch whose first-touch program is the
    LONGEST predicted cold compile first. Whoever claims it starts compiling on
    the fleet's most expensive missing executable immediately (overlapped
    with that fit's own prefetch/warmup, under the engine's op-scoped
    ``compile`` heartbeat excuse), so sibling workers and every later batch
    of the same family hit the shared persistent cache warm. Warm and
    unpriceable batches keep their urgency order after the cold group —
    ordering is pure decision math in parallel/policy.py ``compile_order``
    over the batch views' ``cold_compile_ms`` (priced ONCE at plan time,
    the single source of truth); urgency classes are never crossed."""
    head = batches[0]
    hkey = (head.get("priority"), head.get("deadline_s"))
    n = 0
    for b in batches:
        if (b.get("priority"), b.get("deadline_s")) != hkey:
            break
        n += 1
    if n <= 1:
        return batches
    order = PredictiveSchedulingPolicy.compile_order(batches[:n])
    if order == list(range(n)):
        return batches
    logger.log("policy", kind="compile_order",
               order=[batches[i]["batch_id"] for i in order],
               worker=worker_id)
    return [batches[i] for i in order] + batches[n:]


class _PreemptMonitor:
    """Deadline-aware preemption: while a supervised
    batch runs, periodically price every queued HIGHER-priority tenant
    with a deadline against the running batch — would its deadline be
    missed if we wait, and met if we checkpoint-and-yield now? Preempt only
    when BOTH predictions exist and both answers are yes: a preemption is
    never triggered on a guess (no usable cost-model prior on either side
    means hold, mirroring the policy's bit-identical fallback contract).

    Mechanics ride machinery that already exists end to end: the SIGTERM
    lands on the supervised ``run_batch`` child, whose PreemptionGuard
    drains the in-flight epoch, writes a final checkpoint, and exits
    ``EXIT_PREEMPTED``; ``supervise``'s ``should_stop`` hook turns that
    into a stop instead of a restart; the settle path releases the leases
    as ZERO-CHARGE reclaims (attempt budgets untouched — a preemption
    is a reclaim, never a failure) and pins the exact composition with
    ``after_request`` so the beneficiary claims the mesh first and the
    preempted fit then resumes bit-identically from its checkpoint in the
    same run dir (the lease/pin paths). The signal is gated on the
    batch's first durable grid checkpoint: before it exists the child's
    guard may not be installed and there is nothing to resume from.

    Remaining-work estimate for the running batch: the fit's own newest
    ``cost_model`` ETA (metrics tail beside the batch ledger — the
    scoring events), else the store-level ``predict_fit_eta`` minus elapsed
    wall; the queued tenant's cost is the planner's own batch-view pricing,
    cold compile included. Every pricing lands as a ``policy`` event
    (kind=preempt_price, action=hold|preempt) and the signal as a
    ``preempt`` event — the ``obs watch`` fleet headline's source."""

    def __init__(self, q, batch, members, run_dir, logger, worker_id,
                 n_devices=1, grace_s=None, poll_s=None, now=None):
        self._q = q
        self._batch = batch
        self._members = members
        self._member_ids = {m["request_id"] for m in members}
        self._run_dir = run_dir
        self._logger = logger
        self._worker = worker_id
        self._n_devices = int(n_devices or 1)
        self._grace = float(grace_s if grace_s is not None else
                            os.environ.get(ENV_PREEMPT_GRACE,
                                           DEFAULT_PREEMPT_GRACE_S))
        self._poll = float(poll_s if poll_s is not None else
                           os.environ.get(ENV_PREEMPT_POLL,
                                          DEFAULT_PREEMPT_POLL_S))
        self._started = time.time() if now is None else now
        self._proc = None
        self._held = set()    # candidates already priced+logged as hold
        # poll-tick caches (the monitor runs for the whole batch lifetime):
        # the cost model re-parses only when the store file changes (the
        # watch.py (mtime, size)-signature pattern), and the queue rescan
        # is skipped while the spool is unchanged AND the last scan found
        # no candidate — the steady no-urgent-work state costs two stats.
        # The skip is bounded by _RESCAN_S: a candidate can also become
        # pending WITHOUT a spool write (another worker's lease on it
        # expires/releases), so a periodic full rescan backstops the
        # signature gate
        self._cm_sig = None
        self._cm = None
        self._spool_sig = ()
        self._had_candidates = False
        self._last_scan = 0.0
        self._errored = False
        self.requested = False
        self.decision = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-preempt-monitor")

    # full-queue rescan backstop cadence (see __init__): pending-set changes
    # that bypass the spool signature are picked up within this bound
    _RESCAN_S = 2.0

    # supervise() hooks -------------------------------------------------
    def on_spawn(self, proc):
        self._proc = proc

    def should_stop(self):
        return self.requested

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)

    # -------------------------------------------------------------------
    def _log(self, event, **kw):
        try:
            self._logger.log(event, **kw)
        except Exception:  # noqa: BLE001 — telemetry trouble must never
            pass           # take down the batch loop

    def _run(self):
        while not self._stop.wait(self._poll):
            if self.requested:
                return
            try:
                self._check(time.time())
            except Exception as e:  # noqa: BLE001 — pricing is advisory;
                if not self._errored:  # a bug here must not kill the batch
                    self._errored = True
                    self._log("policy", kind="preempt_price",
                              action="error", worker=self._worker,
                              reason=f"{type(e).__name__}: {e}")

    def _running_remaining_s(self, now, cost_model):
        """Predicted seconds until the RUNNING batch finishes: the fit's
        own newest cost_model ETA when THIS batch's telemetry has one
        (since_wall pins it to this batch — a stale dir never leaks an
        old attempt's eta), discounted by the event's age so a sparse
        check-window cadence cannot overstate remaining work by a whole
        window; else the store-level whole-fit prediction minus elapsed
        wall; None = no usable prior (never preempt on a guess)."""
        eta = latest_cost_model_eta(
            os.path.join(self._run_dir, "run_ledger.jsonl"),
            since_wall=self._started)
        if eta is not None and isinstance(eta.get("eta_s"), (int, float)):
            age = (max(now - eta["wall_time"], 0.0)
                   if isinstance(eta.get("wall_time"), (int, float))
                   else 0.0)
            return max(float(eta["eta_s"]) - age, 0.0)
        view = _planner._batch_view(self._members, self._n_devices,
                                    cost_model=cost_model)
        if view.get("eta_s") is None:
            return None
        return max(float(view["eta_s"]) - (now - self._started), 0.0)

    def _load_cost_model(self):
        path = _costmodel.store_path()
        if path is None:
            return None
        try:
            st = os.stat(path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            sig = None
        if sig != self._cm_sig:
            self._cm_sig = sig
            self._cm = _costmodel.load() if sig is not None else None
        return self._cm

    def _check(self, now):
        spool_sig = None
        try:
            st = os.stat(self._q.spool_path)
            spool_sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            pass
        if spool_sig == self._spool_sig and not self._had_candidates \
                and now - self._last_scan < self._RESCAN_S:
            return  # nothing new submitted, nobody was waiting last scan
        cost_model = self._load_cost_model()
        if cost_model is None:
            return
        self._spool_sig = spool_sig
        self._last_scan = now
        batch_pri = int(self._batch.get("priority") or 0)
        cands = [r for r in self._q.pending(now=now)
                 if r["request_id"] not in self._member_ids
                 and r.get("deadline_s") is not None
                 and int(r.get("priority") or 0) > batch_pri]
        self._had_candidates = bool(cands)
        if not cands:
            return
        run_rem = self._running_remaining_s(now, cost_model)
        if run_rem is None:
            return
        for r in sorted(cands, key=_planner._order_key):
            rid = r["request_id"]
            view = _planner._batch_view([r], self._n_devices,
                                        cost_model=cost_model)
            eta_r = view.get("eta_s")
            if eta_r is None:
                continue  # no prior for the tenant's shape: hold
            deadline_at = (float(r.get("submitted_at") or 0.0)
                           + float(r["deadline_s"]))
            miss_if_wait = now + run_rem + eta_r > deadline_at
            meets_if_preempt = now + self._grace + eta_r <= deadline_at
            fields = {
                "batch_id": self._batch["batch_id"],
                "queued_eta_s": round(float(eta_r), 3),
                "running_rem_s": round(run_rem, 3),
                "deadline_at": round(deadline_at, 3),
                "slack_s": round(deadline_at - now - eta_r, 3),
                "grace_s": self._grace,
                "priority": int(r.get("priority") or 0),
                "worker": self._worker,
            }
            if miss_if_wait and meets_if_preempt:
                # durable-state gate: without a checkpoint there is nothing
                # to resume and the child's guard may not be up yet — hold
                # this poll, the decision re-prices next tick
                if not os.path.exists(os.path.join(self._run_dir,
                                                   "grid_checkpoint.pkl")):
                    return
                proc = self._proc
                if proc is None or proc.poll() is not None:
                    return  # no live child to yield (racing an exit)
                self.decision = dict(fields, beneficiary=rid,
                                     tenant=str(r.get("tenant")))
                self.requested = True
                self._log("policy", kind="preempt_price", action="preempt",
                          request_id=rid, **fields)
                self._log("preempt", kind="signal", beneficiary=rid,
                          tenant=str(r.get("tenant")),
                          requests=sorted(self._member_ids),
                          run_dir=self._run_dir, **fields)
                try:
                    proc.terminate()
                except OSError:
                    pass
                return
            if rid not in self._held:
                # first hold pricing per candidate (not every poll): the
                # audit trail that the monitor SAW the tenant and why it
                # stayed its hand
                self._held.add(rid)
                self._log("policy", kind="preempt_price", action="hold",
                          request_id=rid,
                          reason=("meets_deadline" if not miss_if_wait
                                  else "missed_even_preempting"), **fields)


class _CancelWatch:
    """Sub-mesh slot cancellation (extending the cancel/requeue
    tombstones to packed batches): while a gang-scheduled
    batch runs, poll the queue for member cancellation; once EVERY member
    is terminal (canceled/requeued elsewhere — first-writer-wins terminal
    records), SIGTERM the supervised child so its PreemptionGuard drains
    the in-flight epoch, checkpoints, and exits at the next check-window
    boundary. The settle path then just releases the (already-terminal)
    leases and the gang loop re-offers the freed slot to the queue — the
    surviving co-tenant's fit is a separate process on a disjoint sub-mesh
    and is never touched (bit-identity pinned by tests/test_packing.py)."""

    def __init__(self, q, members, logger, worker_id, poll_s=None):
        self._q = q
        self._member_ids = sorted(m["request_id"] for m in members)
        self._logger = logger
        self._worker = worker_id
        self._poll = float(poll_s if poll_s is not None else
                           os.environ.get(ENV_PREEMPT_POLL,
                                          DEFAULT_PREEMPT_POLL_S))
        self._proc = None
        self.requested = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-cancel-watch")

    # supervise() hooks -------------------------------------------------
    def on_spawn(self, proc):
        self._proc = proc

    def should_stop(self):
        return self.requested

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _run(self):
        while not self._stop.wait(self._poll):
            if self.requested:
                return
            try:
                if not all(self._q.is_terminal(rid)
                           for rid in self._member_ids):
                    continue
            except Exception:  # noqa: BLE001 — the watch is advisory;
                continue       # queue I/O trouble must not kill the batch
            self.requested = True
            try:
                self._logger.log("packing", kind="cancel_stop",
                                 requests=self._member_ids,
                                 worker=self._worker)
            except Exception:  # noqa: BLE001 — telemetry best-effort
                pass
            proc = self._proc
            if proc is not None and proc.poll() is None:
                try:
                    proc.terminate()
                except OSError:
                    pass
            return


class _LeaseHeartbeat:
    """Renews a batch's leases every ``lease_s / 3`` seconds while the
    supervised fit runs; a lost lease (reclaimed by another worker after an
    expiry we slept through) stops renewals and is surfaced to the caller
    so it will not publish results it no longer owns.

    Renewal ERRORS are not silent: each miss logs a structured ``fleet``
    event with the error kind, and ``max_renew_misses`` CONSECUTIVE misses
    on one lease escalate to lease-lost handling — after that many failed
    renewals we can no longer prove the on-disk lease is ours (it may have
    expired and been reclaimed behind the unreadable filesystem), so
    publishing results would race the new owner."""

    def __init__(self, leases, lease_s, logger, max_renew_misses=3):
        self._leases = leases
        self._lease_s = float(lease_s)
        self._logger = logger
        self._max_misses = max(int(max_renew_misses), 1)
        self._misses = {}
        self._stop = threading.Event()
        self.lost = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-lease-heartbeat")

    def _log(self, **kw):
        try:
            self._logger.log("fleet", **kw)
        except Exception:  # noqa: BLE001 — the same fs trouble that broke
            pass           # the renewal must not kill the heartbeat thread

    def _run(self):
        period = max(self._lease_s / 3.0, 0.05)
        while not self._stop.wait(period):
            for rid, lease in list(self._leases.items()):
                try:
                    lease.renew(self._lease_s)
                except LeaseLost:
                    self.lost.append(rid)
                    self._leases.pop(rid, None)
                    self._misses.pop(rid, None)
                    self._log(kind="lease_lost", requests=[rid])
                except OSError as e:
                    n = self._misses.get(rid, 0) + 1
                    self._misses[rid] = n
                    self._log(kind="renew_error", requests=[rid],
                              consecutive=n,
                              error=f"{type(e).__name__}: {e}")
                    if n >= self._max_misses:
                        self.lost.append(rid)
                        self._leases.pop(rid, None)
                        self._misses.pop(rid, None)
                        self._log(kind="lease_lost", requests=[rid],
                                  consecutive=n,
                                  error="renewal misses exhausted")
                else:
                    self._misses.pop(rid, None)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=self._lease_s)


def run_one_batch(q, batch, leases, members, logger, worker_id,
                  lease_s=60.0, checkpoint_every=1, supervisor_policy=None,
                  env=None, python=None,
                  max_attempts=DEFAULT_MAX_ATTEMPTS, n_devices=1,
                  predictive=None, preempt_monitor=None, slot=None,
                  cancel_watch=None, device=None):
    """Run one claimed batch under the crash-loop supervisor and settle its
    requests (containment discipline — see the module docstring); returns
    the :class:`~redcliff_tpu_torch.runtime.supervisor.SuperviseOutcome`.

    ``predictive`` (None = the ``REDCLIFF_PREDICTIVE`` env gate) arms the
    deadline-aware preemption monitor; ``preempt_monitor`` injects a
    pre-built monitor (tests).

    ``slot`` (``{"lo", "width"}``): the sub-mesh device interval
    a PACKED worker assigned this batch — recorded in batch.json so the
    supervised child meshes over exactly those devices and a reclaim
    resumes in the SAME slot; ``cancel_watch`` arms the gang-scheduling
    cancel hook (:class:`_CancelWatch`).

    The batch runs under its TRACE CONTEXT (batch id + each member's
    submit-minted trace id): set process-wide (thread-scoped inside a
    packed worker's gang threads) for the worker's own spans and fleet
    events, exported into the supervised run_batch child via
    ``REDCLIFF_TRACE_CTX`` (so every record the torch child writes carries
    the same join keys), and scoped — restored on every exit path.

    ``device`` (port only): the torch device the supervised child fits on
    (``--device``); None leaves the child's default, ``cuda``."""
    ctx = _trace_context(batch["batch_id"], members)
    prev_ctx = _spans.set_trace_ctx(ctx)
    try:
        return _run_one_batch(q, batch, leases, members, logger, worker_id,
                              ctx, lease_s=lease_s,
                              checkpoint_every=checkpoint_every,
                              supervisor_policy=supervisor_policy, env=env,
                              python=python, max_attempts=max_attempts,
                              n_devices=n_devices, predictive=predictive,
                              preempt_monitor=preempt_monitor, slot=slot,
                              cancel_watch=cancel_watch, device=device)
    finally:
        _spans.set_trace_ctx(prev_ctx)


def _run_one_batch(q, batch, leases, members, logger, worker_id, trace_ctx,
                   lease_s=60.0, checkpoint_every=1, supervisor_policy=None,
                   env=None, python=None,
                   max_attempts=DEFAULT_MAX_ATTEMPTS, n_devices=1,
                   predictive=None, preempt_monitor=None, slot=None,
                   cancel_watch=None, device=None):
    batch_id = batch["batch_id"]
    run_dir = q.batch_dir(batch_id)
    os.makedirs(run_dir, exist_ok=True)
    batch_file = os.path.join(run_dir, "batch.json")
    if not os.path.exists(batch_file):
        # deterministic from the claimed composition: a reclaiming worker
        # that finds the file missing (claimant died pre-write) rebuilds
        # the identical content from the lease-recorded member order
        tmp = f"{batch_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            # g_bucket: the planner-ADMITTED width (deterministic from the
            # composition, so a reclaiming worker rebuilds it identically);
            # run_batch exports it as the predictive policy's widening
            # ceiling — the HBM admission gate priced THIS width. slot:
            # the packed worker's sub-mesh assignment — durable here (not
            # in the lease) so a SIGKILLed packing resumes every batch in
            # its ORIGINAL slot
            json.dump({"batch_id": batch_id, "run_dir": run_dir,
                       "checkpoint_every": int(checkpoint_every),
                       "g_bucket": batch.get("g_bucket"),
                       "slot": slot,
                       "requests": members}, f, allow_nan=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, batch_file)
    # tenant stamping into the supervisor ledger: the manifest row set the
    # per-tenant report section joins on (run_batch logs the same manifest
    # as a metrics event inside the run dir)
    ledger_path = os.path.join(run_dir, "run_ledger.jsonl")
    with open(ledger_path, "a") as f:
        f.write(json.dumps({"event": "fleet", "kind": "manifest",
                            "batch_id": batch_id, "worker": worker_id,
                            "requests": _manifest_rows(members)}) + "\n")
    logger.log("fleet", kind="batch_start", batch_id=batch_id,
               run_dir=run_dir, requests=batch["requests"],
               tenants=batch["tenants"], n_points=batch["n_points"],
               g_bucket=batch["g_bucket"], eta_s=batch.get("eta_s"),
               predicted_bytes=batch.get("predicted_bytes"),
               slot=slot, worker=worker_id)
    cmd = [python or sys.executable, "-m",
           "redcliff_tpu_torch.fleet.run_batch", batch_file]
    if device is not None:
        cmd += ["--device", str(device)]
    # the trace context crosses the process boundary as env: the torch child
    # (and any grand-children the supervisor restarts) stamps every span
    # and metrics record with the same batch/request join keys
    child_env = dict(env if env is not None else os.environ)
    child_env[_spans.ENV_TRACE_CTX] = json.dumps(trace_ctx)
    started_at = time.time()
    t0 = time.perf_counter()
    # deadline-aware preemption monitor: armed by the
    # REDCLIFF_PREDICTIVE gate (or injected by tests); inert when off —
    # supervise runs exactly as before
    monitor = preempt_monitor
    if monitor is None and (predictive if predictive is not None
                            else predictive_enabled()):
        monitor = _PreemptMonitor(q, batch, members, run_dir, logger,
                                  worker_id, n_devices=n_devices,
                                  now=started_at)
    # supervise() hook composition: the preempt monitor and the packed
    # cancel watch each SIGTERM the child themselves; either one asking is
    # a stop, not a restart
    hooks = [h for h in (monitor, cancel_watch) if h is not None]
    on_spawn = ((lambda proc: [h.on_spawn(proc) for h in hooks])
                if hooks else None)
    should_stop = ((lambda: any(h.should_stop() for h in hooks))
                   if hooks else None)
    with _LeaseHeartbeat(leases, lease_s, logger) as hb, \
            (monitor if monitor is not None else contextlib.nullcontext()), \
            (cancel_watch if cancel_watch is not None
             else contextlib.nullcontext()):
        outcome = supervise(
            cmd, ledger_path=ledger_path,
            policy=supervisor_policy or SupervisorPolicy(max_restarts=2),
            env=child_env,
            on_spawn=on_spawn,
            should_stop=should_stop)
    dur_ms = (time.perf_counter() - t0) * 1e3
    record_span("fleet.batch", dur_ms, component="fleet", logger=logger,
                emit=True, batch_id=batch_id,
                classification=outcome.classification)

    lost = set(hb.lost)
    settled = {"done": [], "failed": [], "released": [], "deadletter": [],
               "bisected": [], "preempted": [], "lost": sorted(lost)}
    cls = outcome.classification
    live = [(rid, leases[rid]) for rid in leases if rid not in lost]

    def member_of(rid):
        return next((m for m in members if m["request_id"] == rid), {})

    def trace_of(rid):
        return member_of(rid).get("trace_id")

    # one durable `attempt` lifecycle transition per still-owned member:
    # when the supervised run STARTED (the SLO layer's time-to-first-
    # attempt endpoint), how it classified, and how many supervisor
    # attempts it burned. Lost leases are the new owner's story to record.
    for rid, _lease in live:
        _history.append_event(
            q.root, "attempt", request_id=rid, trace_id=trace_of(rid),
            batch_id=batch_id, tenant=member_of(rid).get("tenant"),
            worker=worker_id, classification=cls,
            attempts=len(outcome.attempts), started_at=started_at,
            run_dir=run_dir)

    def send_to_deadletter(rid, att, reason, causes=None):
        rec = member_of(rid)
        q.deadletter(rid, dossier=_dossier(rec, att, reason, run_dir,
                                           causes=causes),
                     trace_id=trace_of(rid))
        settled["deadletter"].append(rid)
        logger.log("fleet", kind="deadletter", batch_id=batch_id,
                   requests=[rid], tenants=[str(rec.get("tenant"))],
                   reason=reason, attempts=(att or {}).get("attempts"),
                   run_dir=run_dir, worker=worker_id)

    if cls == "clean":
        for rid, lease in live:
            rec = member_of(rid)
            result = _read_result(run_dir, rid)
            if result is None:
                # clean exit, no per-request artifact (should not happen):
                # a durability bug, not a verdict — retry on the budget,
                # dead-letter when it is spent (never a stub "done")
                att = q.record_attempt(rid, "missing_result",
                                       batch_id=batch_id, run_dir=run_dir)
                if att["attempts"] >= max_attempts:
                    send_to_deadletter(rid, att, "missing_result")
                else:
                    lease.release()
                    settled["released"].append(rid)
                continue
            causes = _poison_causes(result)
            if causes is not None:
                # attribution: the grid engine quarantined EVERY point of
                # this request (deterministic per-lane causes) — the poison
                # tenant is contained without touching its siblings
                att = q.record_attempt(rid, "poison_quarantine",
                                       batch_id=batch_id, run_dir=run_dir)
                send_to_deadletter(rid, att, "poison_quarantine",
                                   causes=causes)
                continue
            q.complete(rid, result=result, trace_id=trace_of(rid))
            settled["done"].append(rid)
            logger.log("fleet", kind="complete", batch_id=batch_id,
                       requests=[rid], tenants=[str(rec.get("tenant"))],
                       worker=worker_id)
    elif cancel_watch is not None and cancel_watch.requested:
        # packed-slot cancellation settle: the child
        # was stopped because EVERY member is already terminal (canceled /
        # settled elsewhere — their tombstones are the verdict). Nothing to
        # charge, nothing to pin: release whatever leases are still ours
        # and let the gang loop re-offer the freed slot to the queue
        for rid, lease in live:
            lease.release()
            settled["released"].append(rid)
        logger.log("packing", kind="slot_canceled", batch_id=batch_id,
                   requests=[rid for rid, _ in live], slot=slot,
                   worker=worker_id)
    elif monitor is not None and monitor.requested:
        # deadline-aware preemption settle: the batch stopped
        # because THIS worker asked it to yield — whatever the exact exit
        # class (normally `preempted`; `signal` if the SIGTERM landed in a
        # pre-guard window), it is a RECLAIM, never a charged failure:
        # attempts record kind="reclaim" (dossier evidence, budget
        # untouched), the leases release cleanly, and the exact
        # composition is pinned with the beneficiary so the mesh serves the
        # deadline tenant first and this fit then resumes bit-identically
        # from its checkpoint in the same run dir
        rids_all = [m["request_id"] for m in members]
        beneficiary = (monitor.decision or {}).get("beneficiary")
        for rid, lease in live:
            q.record_attempt(rid, "preempted", batch_id=batch_id,
                             run_dir=run_dir, kind="reclaim")
            lease.release()
            settled["preempted"].append(rid)
        q.pin_batch(batch_id, rids_all, after_request=beneficiary)
        logger.log("preempt", kind="preempted", batch_id=batch_id,
                   requests=rids_all, tenants=batch.get("tenants"),
                   beneficiary=beneficiary, run_dir=run_dir,
                   worker=worker_id)
        _history.append_event(
            q.root, "preempted", batch_id=batch_id, requests=rids_all,
            trace_ids={rid: trace_of(rid) for rid in rids_all
                       if trace_of(rid)},
            beneficiary=beneficiary, worker=worker_id)
    elif cls in TERMINAL_FAIL_CLASSES and len(live) > 1:
        # terminal failure of a MERGED batch with no per-lane attribution:
        # never blame every member — bisect, so halving corners the poison
        # while healthy siblings still finish (as pinned compositions the
        # planner cannot re-merge)
        _bisect(q, batch_id, run_dir, cls, live, member_of, settled,
                logger, worker_id)
    elif cls in TERMINAL_FAIL_CLASSES and len(members) == 1:
        # genuinely SOLO composition: the verdict is attributable to this
        # request alone
        for rid, lease in live:
            att = q.record_attempt(rid, cls, batch_id=batch_id,
                                   run_dir=run_dir)
            if cls in DETERMINISTIC_FAIL_CLASSES:
                q.fail(rid, cls, trace_id=trace_of(rid))
                settled["failed"].append(rid)
            elif att["attempts"] >= max_attempts:
                # a solo crash/hang loop (giving_up) past its budget
                send_to_deadletter(rid, att, "crash_loop")
            else:
                lease.release()
                settled["released"].append(rid)
    elif cls in TERMINAL_FAIL_CLASSES:
        # MERGED composition but at most one lease is still ours (the rest
        # were lost or already terminal): the batch the child ran still
        # carried co-tenants' lanes, so the terminal class cannot be
        # pinned on the lone survivor — it may be a healthy co-tenant of
        # the real poison. Budget-route instead of issuing a verdict; the
        # dossier reason keeps the recorded class (`merged_<class>`) so an
        # operator never misreads a deterministic deadline/numerics death
        # as an infra crash loop
        for rid, lease in live:
            att = q.record_attempt(rid, cls, batch_id=batch_id,
                                   run_dir=run_dir)
            if att["attempts"] >= max_attempts:
                send_to_deadletter(rid, att,
                                   "crash_loop" if cls == "giving_up"
                                   else f"merged_{cls}")
            else:
                lease.release()
                settled["released"].append(rid)
    else:
        for rid, lease in live:
            lease.release()
            settled["released"].append(rid)
    logger.log("fleet", kind="batch_end", batch_id=batch_id,
               classification=outcome.classification, rc=outcome.returncode,
               attempts=len(outcome.attempts),
               wall_s=round(dur_ms / 1e3, 3),
               done=len(settled["done"]), failed=len(settled["failed"]),
               released=len(settled["released"]),
               deadlettered=len(settled["deadletter"]),
               bisected=len(settled["bisected"]),
               preempted=len(settled["preempted"]), worker=worker_id)
    return outcome


def _bisect(q, batch_id, run_dir, classification, live, member_of, settled,
            logger, worker_id):
    """Split a blind-failed merged batch into two pinned halves (claim
    order) and release the leases: the next claim cycles — this worker's or
    any other's — run the halves as exact compositions. Each member's
    durable attempt ledger is charged one failure (the classification the
    batch died with), so the eventual solo culprit carries its history."""
    rids = [rid for rid, _ in live]
    mid = (len(rids) + 1) // 2
    halves = []
    for ids in (rids[:mid], rids[mid:]):
        half_id = _planner.batch_id_for(ids)
        q.pin_batch(half_id, ids, parent_batch_id=batch_id)
        halves.append({"batch_id": half_id, "requests": ids})
    for rid, lease in live:
        q.record_attempt(rid, classification, batch_id=batch_id,
                         run_dir=run_dir)
        lease.release()
        settled["bisected"].append(rid)
    logger.log("fleet", kind="bisect", batch_id=batch_id, requests=rids,
               classification=classification, halves=halves,
               worker=worker_id)
    # the bisection round stays on each member's lifecycle timeline: the
    # halves' batch ids link the pinned re-runs back to the same traces
    _history.append_event(
        q.root, "bisected", batch_id=batch_id, requests=rids,
        trace_ids={rid: member_of(rid).get("trace_id") for rid in rids
                   if member_of(rid).get("trace_id")},
        halves=[h["batch_id"] for h in halves],
        classification=classification, worker=worker_id)


# quarantine causes that are a DETERMINISTIC verdict on the point itself
# (a replay provably diverges again). deadline is deliberately absent:
# eviction at a wall-clock budget depends on how loaded the host was, so a
# fully-deadline-evicted request completes done-with-failures, not poison
_POISON_CAUSES = ("nonfinite_grad", "nonfinite_val")


def _poison_causes(result):
    """The per-cause quarantine counts when EVERY point of this request was
    quarantined by the grid engine for a deterministic-numerics cause (the
    poison-attribution signal), else None. A partial quarantine — or any
    wall-clock-dependent cause like ``deadline`` — is normal sweep behavior
    and completes as done with the failures recorded."""
    n = result.get("n_points") or 0
    fails = result.get("failures") or []
    points = {f.get("point") for f in fails
              if isinstance(f.get("point"), int)}
    if not n or len(points) < n:
        return None
    causes = {}
    for f in fails:
        cause = str(f.get("cause") or "?")
        causes[cause] = causes.get(cause, 0) + 1
    if any(c not in _POISON_CAUSES for c in causes):
        return None
    return causes


def _dossier(rec, att, reason, run_dir, causes=None):
    """The dead-letter failure dossier: everything an operator needs to
    judge the request without spelunking run dirs — attempt/classification
    history, the run dirs it burned, and any crash flight records they
    hold."""
    att = att or {}
    history = att.get("history") or []
    run_dirs = sorted({h.get("run_dir") for h in history
                       if h.get("run_dir")} | {run_dir})
    flights = []
    for d in run_dirs:
        flights.extend(sorted(
            glob.glob(os.path.join(d, "flight_record*.json"))))
    return {
        "request_id": rec.get("request_id"),
        "tenant": str(rec.get("tenant")),
        "reason": reason,
        "attempts": int(att.get("attempts") or 0),
        "reclaims": int(att.get("reclaims") or 0),
        "classifications": [h.get("classification") for h in history],
        "last_classification": (att.get("last") or {}).get("classification"),
        "run_dirs": run_dirs,
        "flight_records": flights,
        "quarantine_causes": causes,
    }


def _read_result(run_dir, request_id):
    """The per-request result record, or None when the clean-exited child
    left no artifact — the caller routes that through the retry budget
    instead of recording a stub done."""
    path = os.path.join(run_dir, "results", f"{request_id}.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def work(root, worker_id=None, lease_s=60.0, poll_s=2.0, max_batches=None,
         drain=False, once=False, n_devices=1, budget_bytes=None,
         max_bucket=_planner.DEFAULT_MAX_BUCKET, checkpoint_every=1,
         supervisor_policy=None, env=None, python=None,
         max_attempts=DEFAULT_MAX_ATTEMPTS, predictive=None, packing=None,
         device=None):
    """The worker loop; returns the number of batches run.

    ``drain``: exit once the queue holds no claimable or running work.
    ``once``: run at most one claim cycle. ``max_batches`` bounds the run.
    ``budget_bytes``: the admission HBM budget (``check_headroom``'s
    ``budget_bytes`` on the serving mesh; None = ungated, e.g. this CPU
    container). ``max_attempts``: the per-request retry budget (failure
    attempts before a request is dead-lettered). ``predictive`` (None =
    the ``REDCLIFF_PREDICTIVE`` env gate) arms the cold-compile claim
    ordering and the deadline-aware preemption monitor.

    ``packing`` (None = the ``REDCLIFF_FLEET_PACKING`` env gate;
    True = ``"force"``, or a mode string): spatial multi-tenant mesh
    packing — with 2+ devices the worker gang-schedules CONCURRENT batches
    on disjoint sub-mesh slots (:func:`_work_packed`). ``"auto"`` packs
    only when the planner's priced makespan beats serial (empty cost store
    = the serial loop, bit-identical); ``"force"`` always packs.

    ``device`` (port only): the torch device every supervised
    ``run_batch`` child fits on; None = ``cuda``, and without CUDA the
    child fails (the supervisor classifies its exit as JAX would)."""
    q = FleetQueue(root)
    worker_id = worker_id or default_worker_id()
    predictive = (predictive_enabled() if predictive is None
                  else bool(predictive))
    if packing is None:
        pack_mode = _packing.packing_mode()
    elif isinstance(packing, str):
        pack_mode = _packing.packing_mode(env=packing)
    else:
        pack_mode = "force" if packing else "off"
    if pack_mode != "off" and int(n_devices or 1) >= 2:
        return _work_packed(q, worker_id=worker_id, lease_s=lease_s,
                            poll_s=poll_s, max_batches=max_batches,
                            drain=drain, once=once, n_devices=n_devices,
                            budget_bytes=budget_bytes,
                            max_bucket=max_bucket,
                            checkpoint_every=checkpoint_every,
                            supervisor_policy=supervisor_policy, env=env,
                            python=python, max_attempts=max_attempts,
                            predictive=predictive, mode=pack_mode,
                            device=device)
    batches_run = 0
    with _logger(root) as logger:
        logger.log("fleet", kind="worker_start", worker=worker_id,
                   n_devices=n_devices, budget_bytes=budget_bytes,
                   lease_s=lease_s)
        try:
            while True:
                got = _next_batch(q, worker_id, lease_s, n_devices,
                                  budget_bytes, max_bucket, logger,
                                  predictive=predictive)
                if got is not None:
                    batch, leases, members = got
                    run_one_batch(q, batch, leases, members, logger,
                                  worker_id, lease_s=lease_s,
                                  checkpoint_every=checkpoint_every,
                                  supervisor_policy=supervisor_policy,
                                  env=env, python=python,
                                  max_attempts=max_attempts,
                                  n_devices=n_devices,
                                  predictive=predictive, device=device)
                    batches_run += 1
                    if max_batches is not None \
                            and batches_run >= max_batches:
                        break
                    if once:
                        break
                    continue
                if once:
                    break
                # drain: nothing is claimable right now (_next_batch came
                # back empty — the queue is empty OR holds only
                # unschedulable requests the planner can never admit) and
                # nothing is in flight anywhere whose completion/expiry
                # could change that
                if drain and not q.live_leases():
                    break
                time.sleep(poll_s)
        except Exception as e:
            # an uncaught worker-loop exception used to die without a
            # record: mirror the watchdog's escalation path — dump the
            # flight recorder (the worker's last spans/events) next to the
            # fleet root's metrics and emit a structured worker_crash
            # event, THEN re-raise so the exit code still says crash
            path = None
            try:
                path = _flight.dump(str(root), "worker_crash", extra={
                    "worker": worker_id,
                    "error": f"{type(e).__name__}: {e}"})
            except Exception:  # noqa: BLE001 — the dump must not mask
                pass           # the original crash
            try:
                logger.log("fleet", kind="worker_crash", worker=worker_id,
                           error=f"{type(e).__name__}: {e}",
                           flight_record=path, batches=batches_run)
            except Exception:  # noqa: BLE001 — same: the crash record is
                pass           # best-effort, the original exception wins
            raise
        logger.log("fleet", kind="worker_stop", worker=worker_id,
                   batches=batches_run)
    return batches_run


def _recorded_slot(q, batch_id):
    """The sub-mesh slot a batch's durable batch.json recorded, or None —
    the reclaim path's slot pin: a resumed packing lands every batch back
    in its original slot."""
    try:
        with open(os.path.join(q.batch_dir(batch_id), "batch.json")) as f:
            slot = (json.load(f) or {}).get("slot")
    except (OSError, ValueError):
        return None
    if isinstance(slot, dict) and isinstance(slot.get("lo"), int) \
            and isinstance(slot.get("width"), int):
        return {"lo": slot["lo"], "width": slot["width"]}
    return None


def _work_packed(q, worker_id, lease_s, poll_s, max_batches, drain, once,
                 n_devices, budget_bytes, max_bucket, checkpoint_every,
                 supervisor_policy, env, python, max_attempts, predictive,
                 mode, device=None):
    """The spatial-packing worker loop: gang-schedule
    concurrent batches on disjoint sub-mesh slots of one device pool.

    Claims happen only in THIS thread (the planner/queue protocol is
    untouched); each claimed batch then runs :func:`run_one_batch` in its
    own gang thread — a separate supervised torch child on its own slot's
    devices, with its own lease heartbeat, preempt monitor, and cancel
    watch. Slot claims/frees happen only between supervised runs — i.e. at
    batch boundaries, which are check-window boundaries for the fits
    (checkpoint cadence) — so preemption and compaction compose
    without new synchronization. A freed slot is re-offered to the queue on
    the next claim poll.

    Co-residency discipline: the planner is consulted with the FREE slot
    width as its pool and the REMAINING HBM budget (pool budget minus live
    co-tenants' ``predicted_bytes``) as its gate, so an admitted batch
    satisfies the headroom model by construction — zero headroom
    violations. A running batch with no memory evidence blocks
    co-scheduling entirely while a budget is set (conservative, mirroring
    ``check_headroom``'s explicit-None degradation). In ``auto`` mode
    co-scheduling additionally requires the plan's priced packing verdict
    (``decision == "packed"``); an empty cost store prices nothing, so the
    loop degrades to one-batch-at-a-time — bit-identical to the serial
    worker's claims."""
    batches_run = 0
    slots = _packing.SlotTable(n_devices)
    tenant_slots = _planner.tenant_slot_quota()
    running = {}  # batch_id -> {"thread", "slot", "batch", "leases"}
    co_ok = (mode == "force")
    wave_started = False
    last_pub = None
    last_decision = None

    with _logger(q.root) as logger:
        logger.log("fleet", kind="worker_start", worker=worker_id,
                   n_devices=n_devices, budget_bytes=budget_bytes,
                   lease_s=lease_s, packing=mode)

        def publish():
            nonlocal last_pub
            occ = slots.occupancy()
            sig = (tuple((s["lo"], s["width"]) for s in occ["slots"]),
                   len(running))
            if sig == last_pub:
                return
            last_pub = sig
            try:
                _packing.publish_state(q.root, occ,
                                       concurrent_batches=len(running))
            except OSError:
                pass

        def reap():
            nonlocal batches_run
            for bid in list(running):
                st = running[bid]
                if st["thread"].is_alive():
                    continue
                st["thread"].join()
                slots.free(st["slot"])
                logger.log("packing", kind="slot_free", batch_id=bid,
                           slot=st["slot"], worker=worker_id)
                del running[bid]
                batches_run += 1

        def inflight_tenants():
            out = {}
            for st in running.values():
                for t in st["batch"].get("tenants") or ():
                    out[t] = out.get(t, 0) + 1
            return out

        def launch(batch, leases, members, slot):
            cw = _CancelWatch(q, members, logger, worker_id)

            def _target():
                try:
                    run_one_batch(
                        q, batch, leases, members, logger, worker_id,
                        lease_s=lease_s, checkpoint_every=checkpoint_every,
                        supervisor_policy=supervisor_policy, env=env,
                        python=python, max_attempts=max_attempts,
                        n_devices=slot["width"], predictive=predictive,
                        slot=slot, cancel_watch=cw, device=device)
                except Exception as e:  # noqa: BLE001 — a gang thread must
                    # never die silently: record the crash and release the
                    # leases so the composition is reclaimable (same story
                    # as a worker process death, minus the wait for expiry)
                    try:
                        logger.log("fleet", kind="worker_crash",
                                   worker=worker_id,
                                   error=f"{type(e).__name__}: {e}",
                                   batches=batches_run)
                    except Exception:  # noqa: BLE001
                        pass
                    for lease in leases.values():
                        try:
                            lease.release()
                        except Exception:  # noqa: BLE001 — lost/settled
                            pass

            t = threading.Thread(target=_target, daemon=True,
                                 name=f"fleet-gang-{batch['batch_id']}")
            running[batch["batch_id"]] = {"thread": t, "slot": slot,
                                          "batch": batch, "leases": leases}
            logger.log("packing", kind="slot_claim",
                       batch_id=batch["batch_id"], slot=slot,
                       requests=batch["requests"],
                       tenants=batch.get("tenants"),
                       predicted_bytes=batch.get("predicted_bytes"),
                       worker=worker_id)
            t.start()

        try:
            while True:
                reap()
                publish()
                free = slots.free_widths()
                cap_left = (max_batches is None
                            or batches_run + len(running) < max_batches)
                may_claim = (cap_left and bool(free)
                             and (not running or co_ok)
                             and not (once and wave_started
                                      and not running))
                claimed = False
                if may_claim:
                    eff_dev = free[0]
                    used = [st["batch"].get("predicted_bytes")
                            for st in running.values()]
                    if budget_bytes is None:
                        eff_budget = None
                    elif any(u is None for u in used):
                        eff_budget = 0  # no evidence: never co-resident
                    else:
                        eff_budget = budget_bytes - sum(used)
                    if eff_budget is None or eff_budget > 0:
                        plan_out = {}
                        got = _next_batch(
                            q, worker_id, lease_s, eff_dev, eff_budget,
                            max_bucket, logger, predictive=predictive,
                            tenant_slots=tenant_slots,
                            inflight_slots=inflight_tenants(),
                            plan_out=plan_out)
                        pk = plan_out.get("packing")
                        if pk is not None:
                            if mode == "auto":
                                co_ok = (pk.get("decision") == "packed")
                            dec = {k: pk.get(k) for k in
                                   ("decision", "reason", "makespan_s",
                                    "serial_s", "makespan_ratio",
                                    "n_devices", "pool",
                                    "headroom_violations")}
                            if dec != last_decision:
                                last_decision = dec
                                logger.log("packing", kind="plan",
                                           worker=worker_id, **dec)
                        if got is not None:
                            batch, leases, members = got
                            slot = None
                            recorded = _recorded_slot(q, batch["batch_id"])
                            if recorded is not None:
                                if slots.reserve(recorded):
                                    slot = recorded
                                else:
                                    # reclaim whose ORIGINAL slot is still
                                    # occupied: wait for it (release the
                                    # claims — zero-charge, the reclaim
                                    # attempt is already on the ledger)
                                    logger.log(
                                        "packing", kind="slot_wait",
                                        batch_id=batch["batch_id"],
                                        slot=recorded, worker=worker_id)
                            else:
                                slot = slots.alloc(_packing.devices_for(
                                    batch.get("g_bucket"), eff_dev))
                            if slot is None:
                                for lease in leases.values():
                                    try:
                                        lease.release()
                                    except Exception:  # noqa: BLE001
                                        pass
                            else:
                                wave_started = True
                                claimed = True
                                launch(batch, leases, members, slot)
                if claimed:
                    continue  # greedily fill remaining slots this poll
                if running:
                    time.sleep(min(poll_s, 0.2))
                    continue
                if once and wave_started:
                    break
                if max_batches is not None and batches_run >= max_batches:
                    break
                if once:
                    break
                if drain and not q.live_leases():
                    break
                time.sleep(poll_s)
        except Exception as e:
            path = None
            try:
                path = _flight.dump(str(q.root), "worker_crash", extra={
                    "worker": worker_id,
                    "error": f"{type(e).__name__}: {e}"})
            except Exception:  # noqa: BLE001 — the dump must not mask
                pass           # the original crash
            try:
                logger.log("fleet", kind="worker_crash", worker=worker_id,
                           error=f"{type(e).__name__}: {e}",
                           flight_record=path, batches=batches_run)
            except Exception:  # noqa: BLE001
                pass
            raise
        finally:
            publish()
        logger.log("fleet", kind="worker_stop", worker=worker_id,
                   batches=batches_run)
    return batches_run
