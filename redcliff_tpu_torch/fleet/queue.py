"""Durable multi-tenant request queue: JSONL spool + atomic claim leases.

The fleet's persistence layer. Everything is plain files under one root so
the queue survives any process death and needs no daemon, no database, and
no locks held across crashes::

    <root>/requests.jsonl        append-only submission spool (one JSON line
                                 per request; O_APPEND + fsync — a torn tail
                                 from a killed submitter is skipped+counted)
    <root>/leases/<id>.json      live claim: created O_CREAT|O_EXCL (the
                                 atomic claim), renewed by tmp+rename,
                                 carries an absolute ``expires_at``
    <root>/done/<id>.json        terminal result record (atomic tmp+rename;
                                 first writer wins — the never-run-twice
                                 half of the contract)
    <root>/failed/<id>.json      terminal failure record (same discipline)
    <root>/deadletter/<id>.json  terminal containment record: the request
                                 exhausted its retry budget or was attributed
                                 as the poison member of a merged batch; the
                                 record carries a failure DOSSIER (attempts,
                                 classifications, run dirs, flight-record
                                 paths) so an operator can judge it without
                                 spelunking run dirs. ``requeue`` resurrects
                                 it with a fresh budget (dossier archived)
    <root>/canceled/<id>.json    terminal cancellation record (first writer
                                 wins; a canceled leased request is never
                                 re-planned and never orphans its lease)
    <root>/attempts/<id>.json    durable per-request attempt ledger: failure
                                 attempt count + reclaim count + a bounded
                                 classification history — the retry-budget
                                 state every release/reclaim updates
    <root>/pinned/<batch_id>.json  pinned batch composition (ordered request
                                 ids): work a bisecting worker requeued as
                                 exact halves — claimed AS THAT COMPOSITION,
                                 bypassing the admission planner
    <root>/work/<batch_id>/      batch run directories (worker-owned:
                                 grid checkpoints, metrics, ledger, results)

**Crash safety.** A worker that dies holding a lease simply stops renewing
it; once ``expires_at`` passes, any worker may RECLAIM the request:
``os.rename`` the expired lease to a unique tombstone (exactly one racer's
rename succeeds — rename of a vanished source fails), then re-claim through
the same ``O_EXCL`` create every fresh claim uses. The lease records the
batch it was claimed under (``batch_id`` + the batch's ordered request ids),
so the reclaiming worker re-runs the SAME batch composition in the same
run directory — the grid fit resumes from its durable checkpoint
(runtime/checkpoint.py) and the final results are bit-identical to an
uninterrupted run (pinned by tests/test_fleet.py).

**Exactly-once results.** ``complete()`` writes ``done/<id>.json``
atomically and refuses to overwrite an existing record; a request with a
done (or failed) record is never pending and never claimable again. The
lease protocol guarantees single-claimant only while claimants are LIVE —
a worker that outlives its own lease (e.g. a multi-minute GC pause) could
race a reclaimer, which is why ``lease_s`` must comfortably exceed the
renewal cadence; the first ``complete()`` still wins either way.

**Trace identity & lifecycle ledger.** ``submit`` mints a
durable ``trace_id`` on every spool record — the one identity a request
keeps across the submit CLI, the planner, every worker that claims it, and
every supervised run_batch child that fits it. Each lifecycle transition
the queue itself performs (submitted / claimed / settled / requeued) is
additionally appended to the ``<root>/history.jsonl`` ledger
(fleet/history.py) — best-effort, multi-process-safe — which is what the
SLO layer (obs/slo.py) and the fleet trace export (``obs trace --fleet``)
join after the workers are gone.

stdlib only, no torch and no jax (obs/schema.py ``--check`` enforces it):
queue scans run in control processes that must never initialize a backend.

Port of ``redcliff_tpu/fleet/queue.py``, a copy: it computes and writes
what the JAX module does.
"""
from __future__ import annotations

import json
import os
import socket
import time
import uuid

from redcliff_tpu_torch.fleet import history as _history
# shared admission taxonomy: BackpressureReject moved to
# runtime/admission.py so the serve plane raises the same family; this
# re-export keeps every existing `from fleet.queue import BackpressureReject`
# call site and except-clause working unchanged
from redcliff_tpu_torch.runtime.admission import BackpressureReject

__all__ = ["FleetQueue", "Lease", "LeaseLost", "BackpressureReject",
           "SPOOL_NAME", "TERMINAL_STATES"]

SPOOL_NAME = "requests.jsonl"
_LEASES = "leases"
_DONE = "done"
_FAILED = "failed"
_DEADLETTER = "deadletter"
_CANCELED = "canceled"
_ATTEMPTS = "attempts"
_PINNED = "pinned"
_WORK = "work"

# every request ends in EXACTLY one of these (the containment invariant
# tests/test_fleet_containment.py pins under the chaos soak)
TERMINAL_STATES = ("done", "failed", "deadletter", "canceled")

# bounded attempt history: enough to read a crash-loop's shape from the
# dossier without letting a pathological requeue loop grow the file forever
_MAX_HISTORY = 20


class LeaseLost(RuntimeError):
    """The lease file no longer belongs to this claimant (it expired and
    another worker reclaimed the request)."""


def _read_json(path):
    """Parse one JSON file; None on missing/torn (a reader must never crash
    on a half-written artifact)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _write_json_atomic(path, payload, overwrite=True):
    """tmp + fsync + rename. With ``overwrite=False`` an existing file wins
    (os.link is atomic-fail-if-exists on POSIX); returns False then."""
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        json.dump(payload, f, allow_nan=False)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    try:
        if overwrite:
            os.replace(tmp, path)
            return True
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


class Lease:
    """One live claim on one request. ``renew`` extends ``expires_at``
    (tmp+rename keeps the file continuously present); ``release`` deletes
    the lease so the request becomes claimable again. Both verify the
    on-disk lease still carries this claimant's token — a reclaimed lease
    raises :class:`LeaseLost` instead of clobbering the new owner."""

    def __init__(self, queue, request_id, data):
        self._q = queue
        self.request_id = request_id
        self.data = data

    @property
    def path(self):
        return self._q._lease_path(self.request_id)

    def _check_owner(self):
        cur = _read_json(self.path)
        if cur is None or cur.get("token") != self.data["token"]:
            raise LeaseLost(
                f"lease on {self.request_id} now belongs to "
                f"{(cur or {}).get('worker')!r} (expired and reclaimed?)")

    def renew(self, lease_s, now=None):
        now = time.time() if now is None else now
        self._check_owner()
        self.data = dict(self.data, renewed_at=now,
                         expires_at=now + float(lease_s),
                         renewals=int(self.data.get("renewals") or 0) + 1)
        _write_json_atomic(self.path, self.data)

    def release(self, now=None):
        try:
            self._check_owner()
        except LeaseLost:
            return  # not ours anymore: nothing to release
        try:
            os.unlink(self.path)
        except OSError:
            return  # lease file stuck: the claim is still visibly live
        # the request is back in the queue: without this transition the
        # SLO layer would end its queue wait at the aborted claim and the
        # trace export's in-flight counter would stay high through exactly
        # the crash-loop incidents the timeline exists to diagnose
        _history.append_event(
            self._q.root, "released", request_id=self.request_id,
            trace_id=self.data.get("trace_id"),
            batch_id=self.data.get("batch_id"),
            tenant=self.data.get("tenant"),
            worker=self.data.get("worker"), now=now)


class FleetQueue:
    """File-backed fleet queue rooted at ``root`` (created on first use).

    ``create=False`` opens the root READ-ONLY for observers (the watch
    CLI): nothing is mkdir'd, and the scan methods tolerate missing
    subdirectories — a pure reader must never mutate the service root (or
    crash on an archived/read-only mount)."""

    def __init__(self, root, create=True):
        self.root = str(root)
        if create:
            os.makedirs(self.root, exist_ok=True)
            for d in (_LEASES, _DONE, _FAILED, _DEADLETTER, _CANCELED,
                      _ATTEMPTS, _PINNED, _WORK):
                os.makedirs(os.path.join(self.root, d), exist_ok=True)
        self.spool_path = os.path.join(self.root, SPOOL_NAME)

    # ------------------------------------------------------------------
    # paths
    # ------------------------------------------------------------------
    def _lease_path(self, request_id):
        return os.path.join(self.root, _LEASES, f"{request_id}.json")

    def _done_path(self, request_id):
        return os.path.join(self.root, _DONE, f"{request_id}.json")

    def _failed_path(self, request_id):
        return os.path.join(self.root, _FAILED, f"{request_id}.json")

    def _deadletter_path(self, request_id):
        return os.path.join(self.root, _DEADLETTER, f"{request_id}.json")

    def _canceled_path(self, request_id):
        return os.path.join(self.root, _CANCELED, f"{request_id}.json")

    def _attempts_path(self, request_id):
        return os.path.join(self.root, _ATTEMPTS, f"{request_id}.json")

    def _pin_path(self, batch_id):
        return os.path.join(self.root, _PINNED, f"{batch_id}.json")

    def batch_dir(self, batch_id):
        return os.path.join(self.root, _WORK, str(batch_id))

    # ------------------------------------------------------------------
    # submit / read the spool
    # ------------------------------------------------------------------
    def _backpressure_gate(self, tenant, now):
        """Raise :class:`BackpressureReject` when the predicted queue wait
        for a request submitted now would breach the armed queue-wait SLO.
        Inert unless ``REDCLIFF_SLO_QUEUE_P99_S`` is set (and not opted
        out via ``REDCLIFF_BACKPRESSURE=0``) — prediction costs a planner
        pass, so the gate only runs when a tenant actually bought an SLO."""
        from redcliff_tpu_torch.fleet import autoscale as _autoscale
        from redcliff_tpu_torch.obs import slo as _slo

        if not _autoscale.backpressure_enabled():
            return
        threshold = _slo.thresholds_from_env().get("queue_p99_s")
        if threshold is None:
            return
        pred = _autoscale.predict_queue_wait_s(self.root, q=self, now=now)
        if pred["eta_s"] <= threshold:
            return
        from redcliff_tpu_torch.obs.logging import MetricLogger

        with MetricLogger(self.root) as log:
            log.log("backpressure", kind="reject", tenant=str(tenant),
                    eta_s=pred["eta_s"], threshold_s=float(threshold),
                    queue_depth=pred["queue_depth"],
                    workers=pred["workers"], reason="predicted queue wait")
        raise BackpressureReject(tenant, pred["eta_s"], threshold,
                                 pred["queue_depth"], pred["workers"])

    def submit(self, tenant, points, spec=None, shape=None, priority=0,
               deadline_s=None, epochs=None, per_lane_bytes=None,
               fixed_bytes=None, request_id=None, now=None):
        """Append one fit request to the spool; returns its ``request_id``.

        ``points``: the grid points this tenant wants fitted (list of hparam
        dicts — the unit the planner merges across same-shape requests).
        ``spec``: what to fit — ``{"model_config", "train_config", "data",
        "epochs"}`` consumed by :mod:`redcliff_tpu_torch.fleet.run_batch`;
        requests batch together only when their non-point spec is identical.
        ``shape``: the (shape-key) dict for the cost/memory models (derived
        from ``spec["model_config"]`` when omitted). ``per_lane_bytes`` /
        ``fixed_bytes``: HBM hints for the admission planner (from
        obs/memory.py ``grid_footprint``/``per_lane_bytes``).

        Mints the request's durable ``trace_id`` — the identity every
        lifecycle event, span, and metrics record downstream joins on —
        and appends the ``submitted`` lifecycle transition to the history
        ledger.

        **Admission backpressure.** When the tenant queue-wait
        SLO is armed (``REDCLIFF_SLO_QUEUE_P99_S`` set) and
        ``REDCLIFF_BACKPRESSURE`` is not ``0``, submission first consults
        the autoscaler's queue-wait prediction
        (fleet/autoscale.py:predict_queue_wait_s — cost-model-priced drain
        estimate over the live worker count) and raises
        :class:`BackpressureReject` — structured, with the predicted ETA —
        instead of spooling work that is predicted to breach. With no SLO
        armed the gate is inert and submit behaves exactly as before."""
        now = time.time() if now is None else now
        self._backpressure_gate(tenant, now)
        spec = dict(spec or {})
        if epochs is None:
            epochs = spec.get("epochs")
        if shape is None:
            shape = _shape_from_model_config(spec.get("model_config") or {})
        rid = request_id or (
            f"req-{int(now * 1000):013d}-{os.getpid()}-"
            f"{uuid.uuid4().hex[:8]}")
        trace_id = f"tr-{uuid.uuid4().hex[:16]}"
        rec = {
            "request_id": rid,
            "trace_id": trace_id,
            "tenant": str(tenant),
            "submitted_at": now,
            "priority": int(priority),
            "deadline_s": (float(deadline_s) if deadline_s is not None
                           else None),
            "shape": shape,
            "points": list(points),
            "epochs": (int(epochs) if epochs is not None else None),
            "per_lane_bytes": per_lane_bytes,
            "fixed_bytes": fixed_bytes,
            "spec": spec,
        }
        # one guarded O_APPEND write + fsync (fleet/history.py append_line,
        # the shared torn-tail-healing invariant): concurrent submitters
        # interleave whole lines; a submitter killed mid-write leaves one
        # torn tail line the tolerant reader skips and counts. Raises on
        # failure — the spool IS the durability contract
        _history.append_line(
            self.spool_path,
            json.dumps(rec, allow_nan=False).encode("utf-8") + b"\n")
        _history.append_event(self.root, "submitted", request_id=rid,
                              trace_id=trace_id, tenant=tenant, now=now,
                              priority=int(priority),
                              deadline_s=rec["deadline_s"],
                              n_points=len(rec["points"]),
                              submitted_at=now)
        return rid

    def requests(self, stats=None):
        """Every spooled request in submission order (first record wins on a
        duplicated id). ``stats`` (optional dict out-param) gets
        ``{"records", "torn_lines"}``."""
        out, seen = [], set()
        torn = 0
        try:
            with open(self.spool_path, "rb") as f:
                raw = f.read()
        except OSError:
            raw = b""
        for line in raw.splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                torn += 1
                continue
            rid = rec.get("request_id")
            if not rid or rid in seen:
                continue
            seen.add(rid)
            out.append(rec)
        if stats is not None:
            stats["records"] = len(out)
            stats["torn_lines"] = torn
        return out

    # ------------------------------------------------------------------
    # claim protocol
    # ------------------------------------------------------------------
    def lease_of(self, request_id):
        """The current lease record (live or expired), or None."""
        return _read_json(self._lease_path(request_id))

    def terminal_state(self, request_id):
        """Which terminal record exists — one of :data:`TERMINAL_STATES` —
        or None while the request is still live. Checked in a fixed order so
        racing writers (e.g. cancel vs complete) always read ONE winner."""
        for state, path_of in (("done", self._done_path),
                               ("failed", self._failed_path),
                               ("deadletter", self._deadletter_path),
                               ("canceled", self._canceled_path)):
            if os.path.exists(path_of(request_id)):
                return state
        return None

    def terminal_ids(self):
        """``{state: set(request_ids)}`` in ONE listdir per state — the
        batch view the whole-queue scans (status/pending) use instead of
        4 stat calls per request (the watch CLI re-runs status every
        tick)."""
        dirs = {"done": _DONE, "failed": _FAILED,
                "deadletter": _DEADLETTER, "canceled": _CANCELED}
        out = {}
        for state in TERMINAL_STATES:
            try:
                names = os.listdir(os.path.join(self.root, dirs[state]))
            except OSError:
                names = []
            out[state] = {n[:-len(".json")] for n in names
                          if n.endswith(".json")}
        return out

    def is_terminal(self, request_id):
        return self.terminal_state(request_id) is not None

    def claim(self, request_id, worker, lease_s, batch_id=None,
              batch_request_ids=None, tenant=None, trace_id=None, now=None):
        """Atomically claim ``request_id``; returns a :class:`Lease` or
        None (already done/failed, or live-leased by someone else, or lost
        the reclaim race).

        ``batch_id``/``batch_request_ids`` record the batch this claim
        belongs to, so a worker reclaiming an expired lease re-runs the
        SAME batch composition (and therefore resumes the same grid
        checkpoint) instead of re-planning a different one. ``trace_id``
        (from the spool record) rides the ``claimed`` lifecycle event —
        the queue-wait endpoint the SLO layer measures."""
        now = time.time() if now is None else now
        if self.is_terminal(request_id):
            return None
        path = self._lease_path(request_id)
        data = {
            "request_id": request_id,
            "worker": str(worker),
            "token": uuid.uuid4().hex,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "tenant": tenant,
            "trace_id": trace_id,
            "claimed_at": now,
            "expires_at": now + float(lease_s),
            "renewals": 0,
            "batch_id": batch_id,
            "batch_request_ids": (list(batch_request_ids)
                                  if batch_request_ids else None),
            "reclaimed_from": None,
        }
        existing = _read_json(path)
        if existing is None and os.path.exists(path):
            # torn lease (claimant died mid-create): treat as expired
            existing = {"expires_at": 0.0}
        if existing is not None:
            if float(existing.get("expires_at") or 0.0) > now:
                return None  # live claim
            # expired: exactly one racer wins the tombstone rename
            tomb = (f"{path}.expired.{os.getpid()}."
                    f"{uuid.uuid4().hex[:8]}")
            try:
                os.rename(path, tomb)
            except OSError:
                return None  # someone else reclaimed first
            data["reclaimed_from"] = {
                "worker": existing.get("worker"),
                "expires_at": existing.get("expires_at"),
                "batch_id": existing.get("batch_id"),
            }
            # a reclaim inherits the dead worker's batch composition unless
            # the caller pinned its own
            if batch_id is None:
                data["batch_id"] = existing.get("batch_id")
                data["batch_request_ids"] = existing.get("batch_request_ids")
        if not _write_json_atomic(path, data, overwrite=False):
            return None  # another claimant slipped in after the tombstone
        _history.append_event(
            self.root, "claimed", request_id=request_id, trace_id=trace_id,
            batch_id=data["batch_id"], tenant=tenant, now=now,
            worker=str(worker),
            reclaim=(True if data["reclaimed_from"] is not None else None))
        return Lease(self, request_id, data)

    # ------------------------------------------------------------------
    # terminal records
    # ------------------------------------------------------------------
    def _settle(self, request_id, state, rec, trace_id=None, now=None):
        """Write one terminal record (first writer wins within a state) and
        drop any lease file so a settled request never orphans its claim.

        Cross-STATE exclusivity (a request terminal in exactly ONE of
        done/failed/deadletter/canceled) cannot ride the pre-write
        ``is_terminal`` check alone: two racers aiming at DIFFERENT states
        (cancel vs complete) can both pass it. So after a successful write
        each writer re-scans in the fixed :data:`TERMINAL_STATES` priority
        order and CONVERGES: it deletes any lower-priority record its own
        outranks, and deletes its own (returning False) when a
        higher-priority record exists. Whichever write lands last sees the
        other's record, so every interleaving ends with exactly the
        highest-priority state on disk (done > failed > deadletter >
        canceled: finished work outranks a racing cancel)."""
        paths = {"done": self._done_path, "failed": self._failed_path,
                 "deadletter": self._deadletter_path,
                 "canceled": self._canceled_path}
        path = paths[state](request_id)
        wrote = (not self.is_terminal(request_id)
                 and _write_json_atomic(path, rec, overwrite=False))
        if wrote:
            idx = TERMINAL_STATES.index(state)
            if any(os.path.exists(paths[s](request_id))
                   for s in TERMINAL_STATES[:idx]):
                # a higher-priority racer landed between our check and our
                # write: defer to it
                try:
                    os.unlink(path)
                except OSError:
                    pass
                wrote = False
            else:
                for s in TERMINAL_STATES[idx + 1:]:
                    try:
                        os.unlink(paths[s](request_id))
                    except OSError:
                        pass
        try:
            os.unlink(self._lease_path(request_id))
        except OSError:
            pass
        if wrote:
            # the terminal lifecycle transition the SLO layer keys on
            # (settled-at minus submitted-at = end-to-end latency; state
            # splits the deadline-hit / dead-letter-rate numerators). `now`
            # is the caller's clock — the SAME timestamp the terminal
            # record carries, so an injected-time settle (tests, replays)
            # stays synthetic-timing-exact in the ledger too
            _history.append_event(self.root, "settled",
                                  request_id=request_id, trace_id=trace_id,
                                  state=state, now=now,
                                  reason=rec.get("reason"))
        return wrote

    def complete(self, request_id, result=None, trace_id=None, now=None):
        """Record the request as done (atomic; FIRST writer wins — the
        never-run-twice half of the durability contract) and drop any lease
        file. Returns True when this call wrote the record."""
        now = time.time() if now is None else now
        return self._settle(request_id, "done",
                            {"request_id": request_id, "completed_at": now,
                             "result": result}, trace_id=trace_id, now=now)

    def fail(self, request_id, reason, trace_id=None, now=None):
        """Record a terminal failure (deterministic classifications the
        supervisor will not restart: numerics_abort, deadline,
        mesh_exhausted)."""
        now = time.time() if now is None else now
        return self._settle(request_id, "failed",
                            {"request_id": request_id, "failed_at": now,
                             "reason": str(reason)}, trace_id=trace_id,
                            now=now)

    def deadletter(self, request_id, dossier=None, trace_id=None, now=None):
        """Route the request to the durable dead-letter directory instead of
        re-planning it (retry budget exhausted, or attributed as the poison
        member of a merged batch). ``dossier`` is the failure dossier the
        worker assembled: attempts, classifications, run dirs, flight-record
        paths, quarantine causes."""
        now = time.time() if now is None else now
        return self._settle(request_id, "deadletter",
                            {"request_id": request_id,
                             "deadlettered_at": now,
                             "dossier": dossier}, trace_id=trace_id,
                            now=now)

    def cancel(self, request_id, reason=None, now=None):
        """Cancel a request: first-writer-wins ``canceled`` terminal record
        riding the same settle discipline as complete/fail. A canceled
        request is never claimable or re-plannable again; if a worker is
        mid-batch on it, the worker's own settle finds the terminal record
        and skips publishing (its lease is unlinked here and by the settle).
        Returns True when this call canceled it (False: already terminal)."""
        now = time.time() if now is None else now
        known = {r["request_id"]: r for r in self.requests()}
        if request_id not in known:
            return False
        return self._settle(request_id, "canceled",
                            {"request_id": request_id, "canceled_at": now,
                             "reason": (str(reason) if reason is not None
                                        else None)},
                            trace_id=known[request_id].get("trace_id"),
                            now=now)

    def requeue(self, request_id, now=None):
        """Resurrect a dead-letter request with a FRESH retry budget: the
        dead-letter record is archived beside itself (audit trail, no longer
        terminal) and the attempt ledger reset, so the request is pending
        again and plannable — but SOLO: the fresh ledger carries a
        ``suspect`` marker so the planner keeps quarantining it away from
        healthy tenants until it proves clean (a zeroed budget alone would
        let a known-poison request re-merge). Returns True when resurrected
        (False: no dead-letter record to resurrect)."""
        now = time.time() if now is None else now
        path = self._deadletter_path(request_id)
        # archive name does not end in .json, so terminal scans skip it
        archive = f"{path}.requeued.{int(now)}.{uuid.uuid4().hex[:6]}"
        try:
            os.rename(path, archive)
        except OSError:
            return False  # no dossier (or a racing requeue won)
        _write_json_atomic(self._attempts_path(request_id), {
            "request_id": request_id, "attempts": 0, "reclaims": 0,
            "last": None, "history": [], "suspect": True,
            "requeued_at": now})
        # the resurrected request keeps its submit-minted identity: look the
        # spool record back up so the `requeued` transition carries the same
        # join keys every other queue-written transition does
        spool = next((r for r in self.requests()
                      if r["request_id"] == request_id), {})
        _history.append_event(self.root, "requeued", request_id=request_id,
                              trace_id=spool.get("trace_id"),
                              tenant=spool.get("tenant"), now=now)
        return True

    def result(self, request_id):
        """The done record, or None."""
        return _read_json(self._done_path(request_id))

    def deadletter_record(self, request_id):
        """The dead-letter record (with its dossier), or None."""
        return _read_json(self._deadletter_path(request_id))

    def deadletters(self):
        """Every dead-letter record, sorted by request id — the containment
        view obs watch/report render."""
        d = os.path.join(self.root, _DEADLETTER)
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return []
        out = []
        for name in names:
            if not name.endswith(".json"):
                continue  # .requeued archives, .tmp droppings
            rec = _read_json(os.path.join(d, name))
            if rec is not None:
                out.append(rec)
        return out

    # ------------------------------------------------------------------
    # per-request attempt ledger (the retry-budget state)
    # ------------------------------------------------------------------
    def attempt_record(self, request_id):
        """The durable attempt ledger for one request, or None (never
        failed/reclaimed). ``{"attempts", "reclaims", "last", "history"}``:
        ``attempts`` counts FAILURE attempts (what the retry budget bounds),
        ``reclaims`` counts lease-expiry reclaims (recorded for the dossier;
        infra faults like a worker SIGKILL storm must not eat a healthy
        tenant's budget)."""
        return _read_json(self._attempts_path(request_id))

    def record_attempt(self, request_id, classification, batch_id=None,
                       run_dir=None, kind="failure", now=None):
        """Append one attempt to the request's durable ledger and return the
        updated record. ``kind="failure"`` increments the budgeted attempt
        count; ``kind="reclaim"`` increments the reclaim count only. Last
        writer wins on a racing update (atomic tmp+rename): attempt counts
        are containment accounting, not the exactly-once surface — that is
        the terminal records'."""
        now = time.time() if now is None else now
        rec = self.attempt_record(request_id) or {
            "request_id": request_id, "attempts": 0, "reclaims": 0,
            "last": None, "history": []}
        entry = {"at": now, "kind": kind,
                 "classification": str(classification),
                 "batch_id": batch_id, "run_dir": run_dir}
        if kind == "failure":
            rec["attempts"] = int(rec.get("attempts") or 0) + 1
        else:
            rec["reclaims"] = int(rec.get("reclaims") or 0) + 1
        rec["last"] = entry
        rec["history"] = (list(rec.get("history") or [])
                          + [entry])[-_MAX_HISTORY:]
        _write_json_atomic(self._attempts_path(request_id), rec)
        return rec

    def attempt_records(self):
        """Every request's attempt ledger, sorted by request id — the
        per-request attempt-count view obs watch/report render."""
        d = os.path.join(self.root, _ATTEMPTS)
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return []
        out = []
        for name in names:
            if not name.endswith(".json") or ".tmp." in name:
                continue
            rec = _read_json(os.path.join(d, name))
            if rec is not None:
                out.append(rec)
        return out

    def reset_attempts(self, request_id):
        try:
            os.unlink(self._attempts_path(request_id))
        except OSError:
            pass

    # ------------------------------------------------------------------
    # pinned batches (bisection halves: exact compositions, planner-bypass)
    # ------------------------------------------------------------------
    def pin_batch(self, batch_id, request_ids, parent_batch_id=None,
                  after_request=None, now=None):
        """Durably pin an exact batch composition for the next claiming
        worker (the bisection requeue path: halves must run AS HALVES, not
        be re-merged by the admission planner).

        ``after_request`` (deadline-aware preemption): the
        beneficiary request this composition yielded the mesh to — workers
        defer claiming the pin while that request is still pending (no
        terminal record, no live lease), so the preempted batch resumes
        only once the tenant it was preempted FOR has been served (or has
        settled some other way)."""
        now = time.time() if now is None else now
        _write_json_atomic(self._pin_path(batch_id), {
            "batch_id": batch_id, "requests": list(request_ids),
            "parent_batch_id": parent_batch_id,
            "after_request": after_request, "pinned_at": now})

    def unpin_batch(self, batch_id):
        try:
            os.unlink(self._pin_path(batch_id))
        except OSError:
            pass

    def pinned_batches(self):
        """Every pinned composition, sorted by batch id (deterministic claim
        order across workers)."""
        d = os.path.join(self.root, _PINNED)
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return []
        out = []
        for name in names:
            if not name.endswith(".json") or ".tmp." in name:
                continue
            rec = _read_json(os.path.join(d, name))
            if rec is not None and rec.get("batch_id") \
                    and rec.get("requests"):
                out.append(rec)
        return out

    # ------------------------------------------------------------------
    # queue views
    # ------------------------------------------------------------------
    def pending(self, now=None, include_leased=False):
        """Requests with no terminal record (and, by default, no LIVE
        lease), in submission order — the planner's input."""
        now = time.time() if now is None else now
        out = []
        terminal = set().union(*self.terminal_ids().values())
        for rec in self.requests():
            rid = rec["request_id"]
            if rid in terminal:
                continue
            if not include_leased:
                lease = self.lease_of(rid)
                if lease is not None \
                        and float(lease.get("expires_at") or 0.0) > now:
                    continue
            out.append(rec)
        return out

    def live_leases(self, now=None):
        """Current LIVE claims (unexpired, non-terminal) — the watch CLI's
        per-tenant in-flight view. Sorted by request id."""
        now = time.time() if now is None else now
        out = []
        for lease in self._scan_leases():
            rid = lease.get("request_id")
            if not rid or self.is_terminal(rid):
                continue
            if float(lease.get("expires_at") or 0.0) > now:
                out.append(lease)
        return out

    def _scan_leases(self):
        lease_dir = os.path.join(self.root, _LEASES)
        try:
            names = sorted(os.listdir(lease_dir))
        except OSError:
            return  # read-only observer of a root with no leases dir yet
        for name in names:
            if not name.endswith(".json") or ".tmp." in name \
                    or ".expired." in name:
                continue
            lease = _read_json(os.path.join(lease_dir, name))
            if lease is not None:
                yield lease

    def expired_claims(self, now=None):
        """Expired (unrenewed) leases of non-terminal requests, grouped by
        recorded batch id: ``{batch_id_or_None: [lease_record, ...]}`` — the
        reclaim-first work a scanning worker prefers over fresh planning."""
        now = time.time() if now is None else now
        groups = {}
        for lease in self._scan_leases():
            rid = lease.get("request_id")
            if not rid:
                continue
            expired = float(lease.get("expires_at") or 0.0) <= now
            if self.is_terminal(rid):
                if expired:
                    # GC: the claimant died AFTER the request went terminal
                    # (e.g. canceled out from under a dead worker) — the
                    # stale lease would otherwise sit forever ("never
                    # orphans a lease")
                    try:
                        os.unlink(self._lease_path(rid))
                    except OSError:
                        pass
                continue
            if not expired:
                continue
            groups.setdefault(lease.get("batch_id"), []).append(lease)
        return groups

    # terminal-record timestamp field per state (the terminal-state age the
    # status CLI renders)
    _TERMINAL_AT = {"done": "completed_at", "failed": "failed_at",
                    "deadletter": "deadlettered_at",
                    "canceled": "canceled_at"}

    def status(self, now=None, include_requests=False):
        """Queue-wide counts: total/queued/running/done/failed plus the
        per-tenant breakdown — the ``fleet status`` CLI body and the watch
        CLI's fleet section.

        ``include_requests=True`` adds a per-request ``requests`` list with
        lifecycle ages: ``queue_age_s`` (now − ``submitted_at``) for live
        requests — how long each tenant has been waiting — and
        ``terminal_age_s`` (now − the terminal record's own timestamp) for
        settled ones. Off by default: it reads one terminal record per
        settled request, which a follow-mode watcher re-running status
        every tick must not pay."""
        now = time.time() if now is None else now
        stats = {}
        reqs = self.requests(stats=stats)
        terminal = self.terminal_ids()
        by_tenant = {}
        rows = []
        counts = {"submitted": len(reqs), "queued": 0, "running": 0,
                  "done": 0, "failed": 0, "deadletter": 0, "canceled": 0,
                  "expired_claims": 0}

        def tbucket(tenant):
            return by_tenant.setdefault(str(tenant), {
                "submitted": 0, "queued": 0, "running": 0, "done": 0,
                "failed": 0, "deadletter": 0, "canceled": 0})

        def row(rec, state, terminal_state=None):
            if not include_requests:
                return
            sub = rec.get("submitted_at")
            r = {"request_id": rec["request_id"],
                 "tenant": str(rec.get("tenant")),
                 "trace_id": rec.get("trace_id"),
                 "state": state,
                 "queue_age_s": None, "terminal_age_s": None}
            if terminal_state is None:
                if isinstance(sub, (int, float)):
                    r["queue_age_s"] = round(now - sub, 3)
            else:
                trec = _read_json(
                    {"done": self._done_path,
                     "failed": self._failed_path,
                     "deadletter": self._deadletter_path,
                     "canceled": self._canceled_path}[terminal_state](
                         rec["request_id"])) or {}
                at = trec.get(self._TERMINAL_AT[terminal_state])
                if isinstance(at, (int, float)):
                    r["terminal_age_s"] = round(now - at, 3)
            rows.append(r)

        for rec in reqs:
            rid = rec["request_id"]
            t = tbucket(rec.get("tenant"))
            t["submitted"] += 1
            state = next((s for s in TERMINAL_STATES
                          if rid in terminal[s]), None)
            if state is not None:
                counts[state] += 1
                t[state] += 1
                row(rec, state, terminal_state=state)
                continue
            lease = self.lease_of(rid)
            if lease is not None \
                    and float(lease.get("expires_at") or 0.0) > now:
                counts["running"] += 1
                t["running"] += 1
                row(rec, "running")
            else:
                if lease is not None:
                    counts["expired_claims"] += 1
                counts["queued"] += 1
                t["queued"] += 1
                row(rec, "queued")
        out = {"root": os.path.abspath(self.root), "counts": counts,
               "by_tenant": by_tenant,
               "torn_spool_lines": stats.get("torn_lines", 0)}
        if include_requests:
            out["requests"] = rows
        return out


# shape-key fields mirrored from obs/schema.py SHAPE_KEYS; kept as a literal
# so this module stays importable with zero package dependencies (the
# supervisor-style control processes must stay torch- and jax-free)
_SHAPE_KEYS = ("num_chans", "gen_lag", "embed_lag", "max_lag", "num_factors",
               "num_supervised_factors", "gen_hidden", "embed_hidden_sizes",
               "input_length", "num_sims")


def _shape_from_model_config(model_config):
    return {k: model_config[k] for k in _SHAPE_KEYS
            if model_config.get(k) is not None}
