"""SLO-driven fleet autoscaler: scale, backpressure, and a degraded-QoS
ladder (ROADMAP item 4 — the service-level control loop).

The predictive scheduler closed the *per-fit* loop (cost-model predictions
steer scheduling); this module closes the *service-level* one.
``obs/slo.py`` computes per-tenant queue-wait/TTFA percentiles and breach
flags from the durable lifecycle ledger, and until now nothing acted on
them — a submit storm just made every tenant silently late. The autoscaler
consumes the WINDOWED SLO view (``compute_slo(..., window_s=...)`` — recent
breaches, not all-time percentiles) plus the learned cost model's fit ETAs
(``obs/costmodel.py:predict_fit_eta`` via the admission planner's batch
views) and reacts three ways, cheapest reaction first:

* **scale** — spawn supervised worker processes (``python -m
  redcliff_tpu_torch.fleet work --drain``, own process groups, exactly the chaos
  harness's :class:`~redcliff_tpu_torch.fleet.chaos.WorkerFleet` mechanics)
  against the queue's predicted drain time, with hysteresis (a cooldown
  between pool changes) and a hard max-worker cap. Scale-DOWN is passive
  by design: workers run ``--drain`` and retire themselves on an empty
  queue — the autoscaler reaps the exit and logs it, so a scale-down can
  never SIGKILL a supervised batch mid-fit. Crashed workers are respawned
  on the supervisor taxonomy (``runtime/supervisor.py
  worker_exit_action``) within a restart budget;
* **backpressure** — :meth:`~redcliff_tpu_torch.fleet.queue.FleetQueue.submit`
  consults :func:`predict_queue_wait_s` and rejects with a structured
  reject-with-ETA error when the predicted wait would breach the tenant's
  queue-wait SLO (``REDCLIFF_SLO_QUEUE_P99_S``). Rejection beats silent
  lateness; ``REDCLIFF_BACKPRESSURE=0`` opts out;
* **degrade** — a priced QoS ladder applied to a BREACHING tenant's queued
  work instead of dead-lining it, pulling the same demotion lever the
  numerics sentinel pulls mid-fit: rung 1 demotes the tenant's
  queued requests to ``precision_mode="mixed"`` (cheaper MXU
  contractions), rung 2 additionally coarsens ``check_every`` by
  :data:`QOS_CHECK_EVERY_FACTOR` — fewer eval/quality readouts, which IS
  the lowered quality top-k cadence (obs/quality.py reads at check
  windows). Rungs are durable per-tenant files (``<root>/qos/<tenant>
  .json``) the worker's fresh-admission path applies via
  :func:`apply_qos`; a demoted spec no longer shares a
  ``planner.batch_key`` with undemoted work, so un-breached co-tenants'
  batches — and their decision streams — are bit-identical with the
  autoscaler on or off. Demotion is recorded on the request (``"qos"``)
  and lands in its results manifest (fleet/run_batch.py).

Every decision is logged as a schema-registered ``autoscale``/``qos``
event in the fleet root's metrics chain AND (pool/rung changes) as a
durable ``fleet_lifecycle`` transition in ``history.jsonl`` — traceable in
``obs trace --fleet``, ``obs watch``, ``obs report``, and ``fleet
status``. The control state lives in ``<root>/autoscale.json`` (atomic
tmp+rename) so observers and the submit-side backpressure gate read one
file, never the autoscaler's memory.

Knobs (see docs/ARCHITECTURE.md "SLO-driven autoscaling & degraded QoS")::

    REDCLIFF_AUTOSCALE_MAX_WORKERS     pool cap               (default 4)
    REDCLIFF_AUTOSCALE_MIN_WORKERS     pool floor             (default 0)
    REDCLIFF_AUTOSCALE_TARGET_DRAIN_S  drain-time target      (default 60)
    REDCLIFF_AUTOSCALE_HYSTERESIS_S    pool-change cooldown   (default 10)
    REDCLIFF_AUTOSCALE_WINDOW_S        rolling SLO window     (default 300)
    REDCLIFF_AUTOSCALE_DEFAULT_ETA_S   unpriced-batch ETA     (default 30)
    REDCLIFF_AUTOSCALE_QOS             QoS ladder gate        (default 1)
    REDCLIFF_BACKPRESSURE              submit-gate opt-out    (default 1)

stdlib only, no torch and no jax (obs/schema.py ``--check`` enforces it): the
autoscaler is fleet CONTROL plane — it spawns workers, it never initializes
a backend.

Port of ``redcliff_tpu/fleet/autoscale.py``, a copy: the same decisions
on the same ledgers; it spawns ``python -m redcliff_tpu_torch.fleet work
--drain`` (``worker_args`` such as ``["--device", "cpu"]`` ride along).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import uuid
from dataclasses import dataclass

__all__ = ["AutoscalePolicy", "Autoscaler", "QOS_MAX_RUNG",
           "QOS_CHECK_EVERY_FACTOR", "qos_knobs", "apply_qos", "set_qos",
           "active_qos", "load_state", "predict_queue_wait_s",
           "predicted_drain", "STATE_NAME", "QOS_DIR",
           "ENV_MAX_WORKERS", "ENV_MIN_WORKERS", "ENV_TARGET_DRAIN_S",
           "ENV_HYSTERESIS_S", "ENV_WINDOW_S", "ENV_DEFAULT_ETA_S",
           "ENV_QOS", "ENV_BACKPRESSURE", "backpressure_enabled"]

ENV_MAX_WORKERS = "REDCLIFF_AUTOSCALE_MAX_WORKERS"
ENV_MIN_WORKERS = "REDCLIFF_AUTOSCALE_MIN_WORKERS"
ENV_TARGET_DRAIN_S = "REDCLIFF_AUTOSCALE_TARGET_DRAIN_S"
ENV_HYSTERESIS_S = "REDCLIFF_AUTOSCALE_HYSTERESIS_S"
ENV_WINDOW_S = "REDCLIFF_AUTOSCALE_WINDOW_S"
ENV_DEFAULT_ETA_S = "REDCLIFF_AUTOSCALE_DEFAULT_ETA_S"
ENV_QOS = "REDCLIFF_AUTOSCALE_QOS"
ENV_BACKPRESSURE = "REDCLIFF_BACKPRESSURE"

STATE_NAME = "autoscale.json"
QOS_DIR = "qos"

# how stale the autoscale.json worker count may be before the submit-side
# backpressure gate falls back to counting live-lease workers
STATE_FRESH_S = 60.0

QOS_MAX_RUNG = 2
QOS_CHECK_EVERY_FACTOR = 4

# the breached SLOs the ladder reacts to: waiting-time SLOs a cheaper/
# coarser fit can actually fix (a dead-letter-rate breach is a containment
# story, not a capacity one)
_QOS_SLOS = ("queue_p99_s", "ttfa_p99_s")


def _env_float(name, default):
    raw = os.environ.get(name)
    if raw is None or not str(raw).strip():
        return float(default)
    try:
        return float(raw)
    except ValueError:
        return float(default)


def backpressure_enabled():
    """The submit-side admission gate's opt-out knob: on unless
    ``REDCLIFF_BACKPRESSURE=0`` (rejection beats silent lateness)."""
    return os.environ.get(ENV_BACKPRESSURE, "1").strip().lower() \
        not in ("0", "false", "off", "no")


@dataclass
class AutoscalePolicy:
    """The control loop's knobs (env-overridable, see module docstring)."""

    max_workers: int = 4
    min_workers: int = 0
    target_drain_s: float = 60.0
    hysteresis_s: float = 10.0
    window_s: float = 300.0
    default_eta_s: float = 30.0
    qos: bool = True

    @classmethod
    def from_env(cls):
        return cls(
            max_workers=int(_env_float(ENV_MAX_WORKERS, 4)),
            min_workers=int(_env_float(ENV_MIN_WORKERS, 0)),
            target_drain_s=_env_float(ENV_TARGET_DRAIN_S, 60.0),
            hysteresis_s=_env_float(ENV_HYSTERESIS_S, 10.0),
            window_s=_env_float(ENV_WINDOW_S, 300.0),
            default_eta_s=_env_float(ENV_DEFAULT_ETA_S, 30.0),
            qos=os.environ.get(ENV_QOS, "1").strip().lower()
            not in ("0", "false", "off", "no"),
        )


# ---------------------------------------------------------------------------
# durable control state: <root>/autoscale.json + <root>/qos/<tenant>.json
# ---------------------------------------------------------------------------
def _write_json_atomic(path, obj):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, allow_nan=False)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_state(root):
    """The autoscaler's last published control state
    (``<root>/autoscale.json``), or None when no autoscaler ever ran."""
    return _read_json(os.path.join(str(root), STATE_NAME))


def _qos_path(root, tenant):
    return os.path.join(str(root), QOS_DIR, f"{tenant}.json")


def set_qos(root, tenant, rung, reason=None, now=None):
    """Set (or clear, ``rung<=0``) a tenant's durable QoS demotion rung.
    Returns the written record (None on clear)."""
    now = time.time() if now is None else now
    path = _qos_path(root, str(tenant))
    if int(rung) <= 0:
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rec = dict(qos_knobs(int(rung)), tenant=str(tenant), set_at=now,
               reason=reason)
    _write_json_atomic(path, rec)
    return rec


def active_qos(root):
    """``{tenant: rung_record}`` for every tenant currently demoted
    (``<root>/qos/*.json``); empty dict when the ladder is idle."""
    d = os.path.join(str(root), QOS_DIR)
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return {}
    out = {}
    for name in names:
        if not name.endswith(".json") or ".tmp." in name:
            continue
        rec = _read_json(os.path.join(d, name))
        if isinstance(rec, dict) and rec.get("rung"):
            out[rec.get("tenant") or name[:-len(".json")]] = rec
    return out


# ---------------------------------------------------------------------------
# the QoS ladder
# ---------------------------------------------------------------------------
def qos_knobs(rung):
    """The knob set one ladder rung applies. Only train_config keys the
    batch driver's ``RedcliffTrainConfig`` actually accepts may appear
    here — an invented key would crash every demoted fit."""
    rung = max(0, min(int(rung), QOS_MAX_RUNG))
    knobs = {"rung": rung}
    if rung >= 1:
        knobs["precision_mode"] = "mixed"
    if rung >= 2:
        knobs["check_every_factor"] = QOS_CHECK_EVERY_FACTOR
    return knobs


def apply_qos(request, rungs):
    """Apply a tenant's active demotion rung to one queued request record.

    ``rungs`` is :func:`active_qos` output. Returns the request UNCHANGED
    (same object — the bit-identity guarantee for un-breached co-tenants)
    when its tenant holds no rung; otherwise a deep copy whose
    ``spec.train_config`` carries the rung's knobs and whose top-level
    ``"qos"`` field records the demotion for the results manifest. The
    mutated spec changes ``planner.batch_key``, so demoted work never
    merges with an undemoted sibling's batch."""
    rec = (rungs or {}).get(str(request.get("tenant")))
    rung = int((rec or {}).get("rung") or 0)
    if rung <= 0:
        return request
    out = json.loads(json.dumps(request))  # deep copy, JSON-clean
    tc = out.setdefault("spec", {}).setdefault("train_config", {})
    applied = {"rung": rung, "reason": rec.get("reason"),
               "set_at": rec.get("set_at")}
    if rec.get("precision_mode"):
        tc["precision_mode"] = rec["precision_mode"]
        applied["precision_mode"] = rec["precision_mode"]
    factor = rec.get("check_every_factor")
    if factor:
        base = int(tc.get("check_every") or 1)
        tc["check_every"] = max(base, 1) * int(factor)
        applied["check_every"] = tc["check_every"]
    out["qos"] = applied
    return out


# ---------------------------------------------------------------------------
# drain / queue-wait prediction (the backpressure gate's math)
# ---------------------------------------------------------------------------
def predicted_drain(q, cost_model=None, n_devices=1, default_eta_s=30.0,
                    now=None, root=None):
    """Predicted per-worker drain time of the PENDING queue: one admission
    plan's batch ETAs (cost-model priced where a matching shape rung
    exists, ``default_eta_s`` per unpriced batch). In-flight work is
    deliberately excluded — its lease already ended the wait obs/slo.py
    measures, and undercounting keeps the backpressure gate honest
    (rejecting on work we cannot price would reject on guesses).

    Slot-awareness: a PACKED worker drains several
    batches concurrently on disjoint sub-mesh slots, so pricing the queue
    serially over-predicts drain — and over-spawns workers. When the
    worker publishes live slot occupancy (``<root>/packing.json``,
    parallel/packing.py ``publish_state``; ``root`` defaults to
    ``q.root``), the serial total divides by the published packing width
    (live concurrent batches, floored at 1). A stale/missing publication
    keeps the serial estimate — the conservative pre-packing behavior.

    Returns ``{"pending", "batches", "priced", "unpriced",
    "total_eta_s", "packing_width"}``."""
    from redcliff_tpu_torch.fleet import planner as _planner
    from redcliff_tpu_torch.parallel import packing as _packing

    pending = q.pending(now=now)
    if not pending:
        return {"pending": 0, "batches": 0, "priced": 0, "unpriced": 0,
                "total_eta_s": 0.0, "packing_width": 1}
    pl = _planner.plan(pending, n_devices=n_devices, cost_model=cost_model)
    total, priced, unpriced = 0.0, 0, 0
    for b in pl["batches"]:
        eta = b.get("eta_s")
        if isinstance(eta, (int, float)):
            total += float(eta)
            priced += 1
        else:
            total += float(default_eta_s)
            unpriced += 1
    # requests the planner cannot admit still occupy the queue: price them
    # like unpriced batches so a wedged-unschedulable backlog reads as load
    total += float(default_eta_s) * len(pl["unschedulable"])
    unpriced += len(pl["unschedulable"])
    width = 1
    pack_state = _packing.load_state(root if root is not None else q.root,
                                     now=now)
    if pack_state is not None:
        width = max(int(pack_state.get("concurrent_batches") or 0), 1)
    return {"pending": len(pending), "batches": len(pl["batches"]),
            "priced": priced, "unpriced": unpriced,
            "total_eta_s": round(total / width, 3),
            "packing_width": width}


def _worker_count(root, q, now):
    """Best available live-worker estimate for the submit-side gate: the
    autoscaler's published state when fresh, else distinct live-lease
    workers, else 1 (a lone default worker — the conservative floor)."""
    state = load_state(root)
    wt = (state or {}).get("wall_time")
    if state is not None and isinstance(wt, (int, float)) \
            and (now - wt) <= STATE_FRESH_S:
        return max(int(state.get("workers") or 0), 1), "autoscaler"
    workers = {l.get("worker") for l in q.live_leases(now=now)
               if l.get("worker")}
    if workers:
        return len(workers), "leases"
    return 1, "default"


def predict_queue_wait_s(root, q=None, cost_model=None, now=None,
                         default_eta_s=None):
    """Predicted queue wait for a request submitted NOW: the pending
    queue's serial drain estimate divided by the live worker count.
    Returns ``{"eta_s", "workers", "workers_source", "queue_depth",
    "priced", "unpriced"}`` (``eta_s`` 0.0 on an empty queue)."""
    from redcliff_tpu_torch.fleet.queue import FleetQueue
    from redcliff_tpu_torch.obs import costmodel as _costmodel

    now = time.time() if now is None else now
    q = FleetQueue(root, create=False) if q is None else q
    if cost_model is None:
        cost_model = _costmodel.load()
    state = load_state(root)
    if default_eta_s is None:
        default_eta_s = _env_float(ENV_DEFAULT_ETA_S, 30.0)
    drain = predicted_drain(
        q, cost_model=cost_model,
        n_devices=int((state or {}).get("n_devices") or 1),
        default_eta_s=default_eta_s, now=now)
    workers, source = _worker_count(root, q, now)
    return {
        "eta_s": round(drain["total_eta_s"] / max(workers, 1), 3),
        "workers": workers,
        "workers_source": source,
        "queue_depth": drain["pending"],
        "priced": drain["priced"],
        "unpriced": drain["unpriced"],
    }


# ---------------------------------------------------------------------------
# the control loop
# ---------------------------------------------------------------------------
class Autoscaler:
    """The SLO-driven fleet control loop (see the module docstring).

    ``spawn`` is injectable for tests (called with the worker argv, must
    return a Popen-like object with ``poll()``); ``thresholds`` overrides
    the ``REDCLIFF_SLO_*`` env thresholds the windowed breach check uses.
    ``worker_args`` are appended to every spawned worker's argv."""

    def __init__(self, root, policy=None, n_devices=1, lease_s=60.0,
                 poll_s=0.5, max_attempts=3, max_restarts=2,
                 worker_args=(), env=None, python=None, spawn=None,
                 thresholds=None, supervisor_policy=None, logger=None,
                 scaler_id=None):
        from redcliff_tpu_torch.fleet.queue import FleetQueue

        self.root = str(root)
        self.q = FleetQueue(self.root)
        self.policy = policy or AutoscalePolicy.from_env()
        self.n_devices = int(n_devices)
        self.lease_s = float(lease_s)
        self.poll_s = float(poll_s)
        self.max_attempts = int(max_attempts)
        self.max_restarts = int(max_restarts)
        self.worker_args = list(worker_args)
        self.env = dict(env) if env is not None else None
        self.python = python or sys.executable
        self._spawn = spawn
        self.thresholds = thresholds
        self.supervisor_policy = supervisor_policy
        self.scaler_id = scaler_id or f"autoscaler-{uuid.uuid4().hex[:6]}"
        self._logger = logger
        self._owns_logger = False
        # live pool: worker_id -> {"proc", "spawned_at", "restarts"}
        self.workers = {}
        self._spawn_seq = 0
        self.last_scale_wall = None
        self.last_decision = None
        self.first_breach_wall = None
        self.ticks = 0
        self._qos_wall = {}  # tenant -> last rung-change wall (hysteresis)

    # -- worker lifecycle --------------------------------------------------
    def _worker_cmd(self, worker_id):
        return [self.python, "-m", "redcliff_tpu_torch.fleet", "work",
                "--root", self.root, "--drain",
                "--worker-id", worker_id,
                "--lease-s", str(self.lease_s),
                "--poll-s", str(self.poll_s),
                "--max-attempts", str(self.max_attempts),
                "--n-devices", str(self.n_devices),
                ] + self.worker_args

    def _spawn_worker(self, restarts=0):
        self._spawn_seq += 1
        worker_id = f"{self.scaler_id}-w{self._spawn_seq}"
        cmd = self._worker_cmd(worker_id)
        if self._spawn is not None:
            proc = self._spawn(cmd)
        else:
            # own process group, exactly like the chaos harness's fleet:
            # a supervised batch child dies with its worker, never orphans
            proc = subprocess.Popen(cmd, env=self.env,
                                    start_new_session=True,
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
        self.workers[worker_id] = {"proc": proc, "spawned_at": time.time(),
                                   "restarts": int(restarts)}
        return worker_id

    def _reap(self, logger, now, pending):
        """Collect exited workers: clean drains RETIRE (the passive
        scale-down), restartable crashes respawn within the budget."""
        from redcliff_tpu_torch.runtime.supervisor import worker_exit_action

        for worker_id, w in list(self.workers.items()):
            rc = w["proc"].poll()
            if rc is None:
                continue
            del self.workers[worker_id]
            classification, action = worker_exit_action(
                rc, w["restarts"], max_restarts=self.max_restarts)
            if action == "respawn" and pending:
                replacement = self._spawn_worker(restarts=w["restarts"] + 1)
                logger.log("autoscale", kind="respawn", worker=replacement,
                           classification=classification,
                           restarts=w["restarts"] + 1,
                           workers=len(self.workers),
                           reason=f"worker {worker_id} exited "
                                  f"{classification}")
                self._ledger("autoscale", worker=replacement,
                             reason=f"respawn after {classification}",
                             workers=len(self.workers), now=now)
            else:
                reason = ("drained" if classification == "drained"
                          else f"exited {classification}")
                logger.log("autoscale", kind="scale_down", worker=worker_id,
                           classification=classification,
                           workers=len(self.workers), reason=reason)
                self._ledger("autoscale", worker=worker_id,
                             reason=f"scale_down: {reason}",
                             workers=len(self.workers), now=now)

    def _ledger(self, kind, now=None, **fields):
        from redcliff_tpu_torch.fleet import history as _history

        _history.append_event(self.root, kind, now=now, **fields)

    # -- the decision ------------------------------------------------------
    def _windowed_slo(self, now):
        from redcliff_tpu_torch.obs import slo as _slo

        return _slo.slo_for_root(self.root, thresholds=self.thresholds,
                                 window_s=self.policy.window_s)

    def _target_workers(self, drain, breached, live):
        """Pool size that drains the predicted backlog inside the target:
        ``ceil(total_eta / target_drain_s)``, nudged one ABOVE the live
        pool while a recent waiting-time SLO breach stands (observed
        lateness outranks a prediction that says we are fine)."""
        p = self.policy
        target = 0
        if drain["pending"]:
            target = max(int(math.ceil(
                drain["total_eta_s"] / max(p.target_drain_s, 1e-9))), 1)
        if breached and drain["pending"]:
            target = max(target, live + 1)
        return max(min(target, p.max_workers), p.min_workers)

    def tick(self, now=None):
        """One control decision; returns the decision record (also logged
        as an ``autoscale`` event and published to ``autoscale.json``)."""
        now = time.time() if now is None else now
        self.ticks += 1
        logger = self._ensure_logger()
        from redcliff_tpu_torch.obs import costmodel as _costmodel

        drain = predicted_drain(self.q, cost_model=_costmodel.load(),
                                n_devices=self.n_devices,
                                default_eta_s=self.policy.default_eta_s,
                                now=now)
        self._reap(logger, now, pending=bool(drain["pending"]))
        slo = self._windowed_slo(now)
        breaches = [b for b in ((slo or {}).get("breaches") or [])
                    if b.get("slo") in _QOS_SLOS]
        if breaches and self.first_breach_wall is None:
            self.first_breach_wall = now
        live = len(self.workers)
        target = self._target_workers(drain, bool(breaches), live)
        cooled = (self.last_scale_wall is None
                  or (now - self.last_scale_wall)
                  >= self.policy.hysteresis_s)
        decision = {"kind": "hold", "workers": live, "target": target,
                    "reason": "steady"}
        if target > live and cooled:
            spawned = [self._spawn_worker() for _ in range(target - live)]
            self.last_scale_wall = now
            decision = {
                "kind": "scale_up", "workers": len(self.workers),
                "target": target,
                "reason": (f"predicted drain {drain['total_eta_s']:.1f}s > "
                           f"target {self.policy.target_drain_s:.0f}s"
                           + (f"; {len(breaches)} windowed SLO breach(es)"
                              if breaches else "")),
                "spawned": spawned,
            }
            self._ledger("autoscale", reason=decision["reason"],
                         workers=len(self.workers), target=target, now=now)
        elif target > live:
            decision = {"kind": "hold", "workers": live, "target": target,
                        "reason": "hysteresis cooldown"}
        elif target < live:
            # passive scale-down: --drain workers retire themselves; the
            # hold here just names why the pool is (temporarily) oversized
            decision = {"kind": "hold", "workers": live, "target": target,
                        "reason": "awaiting worker self-drain"}
        qos_changes = self._qos_tick(logger, slo, breaches, live, now)
        rec = dict(decision, queue_depth=drain["pending"],
                   drain_eta_s=drain["total_eta_s"],
                   target_drain_s=self.policy.target_drain_s,
                   window_s=self.policy.window_s,
                   breaches=len(breaches), max_workers=self.policy.max_workers)
        # log every pool change; holds only when something else moved
        # (a multi-hour steady loop must not write a record per tick)
        if rec["kind"] != "hold" or qos_changes \
                or self.last_decision is None \
                or rec["reason"] != self.last_decision.get("reason"):
            logger.log("autoscale", **rec)
        self.last_decision = dict(rec, wall_time=now)
        self._publish(now, drain)
        return self.last_decision

    def _qos_tick(self, logger, slo, breaches, live, now):
        """The degraded-QoS ladder: demote a breaching tenant one rung when
        scaling is exhausted (pool at cap), restore when its window is
        clean. Rate-limited per tenant by the same hysteresis."""
        if not self.policy.qos:
            return 0
        rungs = active_qos(self.root)
        breached_tenants = {b["scope"] for b in breaches
                            if b.get("scope") not in (None, "overall")}
        changes = 0

        def cooled(tenant):
            last = self._qos_wall.get(tenant)
            return last is None or (now - last) >= self.policy.hysteresis_s

        if live >= self.policy.max_workers:
            for tenant in sorted(breached_tenants):
                cur = int((rungs.get(tenant) or {}).get("rung") or 0)
                if cur >= QOS_MAX_RUNG or not cooled(tenant):
                    continue
                rung = cur + 1
                reason = (f"windowed SLO breach at max workers "
                          f"({live}/{self.policy.max_workers})")
                rec = set_qos(self.root, tenant, rung, reason=reason,
                              now=now)
                self._qos_wall[tenant] = now
                changes += 1
                logger.log("qos", kind="demote", tenant=tenant, rung=rung,
                           from_rung=cur, reason=reason,
                           precision_mode=rec.get("precision_mode"),
                           check_every_factor=rec.get("check_every_factor"),
                           window_s=self.policy.window_s,
                           worker=self.scaler_id)
                self._ledger("qos", tenant=tenant, rung=rung,
                             reason=reason, now=now)
        for tenant in sorted(set(rungs) - breached_tenants):
            if not cooled(tenant):
                continue
            cur = int((rungs.get(tenant) or {}).get("rung") or 0)
            set_qos(self.root, tenant, 0, now=now)
            self._qos_wall[tenant] = now
            changes += 1
            logger.log("qos", kind="restore", tenant=tenant, rung=0,
                       from_rung=cur, reason="window clean",
                       window_s=self.policy.window_s, worker=self.scaler_id)
            self._ledger("qos", tenant=tenant, rung=0,
                         reason="restore: window clean", now=now)
        return changes

    def _publish(self, now, drain):
        state = {
            "wall_time": now,
            "scaler": self.scaler_id,
            "workers": len(self.workers),
            "worker_ids": sorted(self.workers),
            "target": (self.last_decision or {}).get("target"),
            "max_workers": self.policy.max_workers,
            "min_workers": self.policy.min_workers,
            "n_devices": self.n_devices,
            "pending": drain["pending"],
            "drain_eta_s": drain["total_eta_s"],
            "last_decision": self.last_decision,
            "qos": {t: r.get("rung")
                    for t, r in sorted(active_qos(self.root).items())},
            "ticks": self.ticks,
        }
        _write_json_atomic(os.path.join(self.root, STATE_NAME), state)

    # -- loop --------------------------------------------------------------
    def _ensure_logger(self):
        if self._logger is None:
            from redcliff_tpu_torch.obs.logging import MetricLogger

            self._logger = MetricLogger(self.root).__enter__()
            self._owns_logger = True
        return self._logger

    def close(self):
        # live --drain workers are left to finish and retire themselves:
        # stopping the control loop must never SIGKILL a supervised batch
        logger = self._ensure_logger()
        logger.log("autoscale", kind="stop", workers=len(self.workers),
                   ticks=self.ticks)
        if self._owns_logger:
            self._logger.__exit__(None, None, None)
            self._logger, self._owns_logger = None, False

    def settled(self, now=None):
        """True when the queue holds no pending work and no live lease —
        the drain-mode exit condition."""
        now = time.time() if now is None else now
        return not self.q.pending(now=now) and not self.q.live_leases(now=now)

    def run(self, interval_s=2.0, max_ticks=None, drain=False,
            sleep=time.sleep):
        """Run the control loop. ``drain``: exit once the queue is fully
        settled AND every spawned worker has retired. ``max_ticks`` bounds
        the loop (tests / smoke). Returns a summary dict."""
        logger = self._ensure_logger()
        logger.log("autoscale", kind="start", worker=self.scaler_id,
                   max_workers=self.policy.max_workers,
                   min_workers=self.policy.min_workers,
                   target_drain_s=self.policy.target_drain_s,
                   window_s=self.policy.window_s)
        t0 = time.time()
        try:
            while True:
                now = time.time()
                self.tick(now=now)
                if max_ticks is not None and self.ticks >= int(max_ticks):
                    break
                if drain and self.settled(now=now) and not any(
                        w["proc"].poll() is None
                        for w in self.workers.values()):
                    # one final reap so the retire events land, and a final
                    # publish so observers see the emptied pool
                    self._reap(logger, now, pending=False)
                    self._publish(now, {"pending": 0, "total_eta_s": 0.0})
                    break
                sleep(interval_s)
        finally:
            self.close()
        return {
            "ticks": self.ticks,
            "wall_s": round(time.time() - t0, 3),
            "workers": len(self.workers),
            "first_breach_wall": self.first_breach_wall,
            "last_decision": self.last_decision,
        }
