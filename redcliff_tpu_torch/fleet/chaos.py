"""Fleet chaos harness: seeded fleet-level faults for the containment soak.

The fault grammar (runtime/faultinject.py) breaks ONE supervised
fit — kills, NaN batches, hangs, torn checkpoint writes. This module extends
the same philosophy one level up, to the fleet SERVICE: the faults a
multi-tenant sweep queue meets in production, composed into seeded schedules
so the chaos soak (tests/test_fleet_containment.py) is deterministic and
replayable. The invariant every schedule must leave intact: every submitted
request ends in exactly ONE of ``done/``, ``failed/``, ``deadletter/``,
``canceled/`` — never lost, never duplicated — and healthy requests always
complete, bit-identical to a fault-free run.

Fault classes:

- **poison request specs** (:func:`poison_point`): grid points that
  deterministically ruin the batch they are merged into. ``"nan"`` is an
  ATTRIBUTABLE poison — an absurd learning rate drives the lane non-finite
  and the grid engine's per-lane quarantine names the culprit. The
  ``__chaos__`` sentinel modes (``"sigkill"`` / ``"exit:N"`` /
  ``"hang:S"``) are BLIND poisons — the batch driver dies before any
  attribution exists, so the worker must corner the culprit by bisection.
  Sentinels are inert unless the fault grammar arms ``fleet_poison``
  (:func:`redcliff_tpu_torch.runtime.faultinject.fleet_poison_armed`), and the
  driver strips them from points before the fit either way;
- **worker SIGKILL storms** (:class:`WorkerFleet`): real worker processes
  (own process groups, so the supervised child dies with them) killed on a
  seeded schedule and respawned — the lease-expiry/reclaim/resume path
  under sustained infrastructure failure;
- **lease-expiry races** (:func:`expire_random_lease`): a live lease's
  ``expires_at`` is forced into the past, so another worker reclaims a
  batch whose original owner may still be running — the claim token
  protocol must keep exactly one publisher;
- **torn/corrupt durable state** (:func:`tear_spool_tail`,
  :func:`corrupt_random_lease`): a submitter killed mid-append, a lease
  file half-written by a dying claimant — every reader must skip-and-count,
  never crash, never lose a healthy request.

stdlib only, no torch and no jax (obs/schema.py ``--check`` enforces it):
chaos drives CONTROL processes; only the supervised batch driver it
torments initializes a backend.

Port of ``redcliff_tpu/fleet/chaos.py``, a copy: the same schedules from
a seed; :class:`WorkerFleet` launches ``python -m redcliff_tpu_torch.fleet
work`` (pass ``extra_args=["--device", "cpu"]`` to fit on the CPU).
"""
from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import time

__all__ = ["CHAOS_KEY", "poison_point", "strip_chaos", "detonate",
           "tear_spool_tail", "corrupt_random_lease", "expire_random_lease",
           "WorkerFleet", "FLEET_FAULT_KINDS", "random_fleet_fault_schedule",
           "apply_fault", "submit_storm"]

# the sentinel key a poison request spec rides in on; the batch driver
# strips it from every point before the fit and acts on it only when the
# fault grammar arms `fleet_poison`
CHAOS_KEY = "__chaos__"

# a learning rate past sqrt(f32 max): Adam-normalized updates bound steps to
# ~lr, so the poisoned lane's squared forecast error overflows to inf within
# an epoch and the numerics guard quarantines it (same constant the
# bad-point harness uses — the attributable poison)
_NAN_LR = 1e20


def poison_point(mode, base=None):
    """One poison grid point. ``mode``:

    - ``"nan"`` — attributable: quarantined in-engine, named in
      ``failures.json``;
    - ``"sigkill"`` — blind: the batch driver SIGKILLs itself pre-fit;
    - ``"exit:N"`` — blind: the driver exits with code N (e.g. ``exit:19``
      simulates a watchdog-hard-exited hang without the wait);
    - ``"hang:S"`` — blind: the driver sleeps S seconds, then exits 19
      (a hang long enough to look wedged, short enough to soak-test).
    """
    if mode == "nan":
        return {"gen_lr": _NAN_LR, "embed_lr": _NAN_LR}
    return dict(base or {"gen_lr": 1e-3}, **{CHAOS_KEY: str(mode)})


def strip_chaos(point, sink=None):
    """A copy of ``point`` without the chaos sentinel; when the point
    carried one, its spec is appended to ``sink``. The batch driver runs
    every point through this so an UNARMED replay of a chaos spool fits the
    underlying healthy point instead of crash-looping."""
    if CHAOS_KEY not in point:
        return dict(point)
    out = {k: v for k, v in point.items() if k != CHAOS_KEY}
    if sink is not None:
        sink.append(str(point[CHAOS_KEY]))
    return out


def detonate(spec):
    """Die the way a poison sentinel says (called by the batch driver,
    pre-fit, only when ``fleet_poison`` is armed)."""
    if spec == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    name, _, arg = spec.partition(":")
    if name == "exit":
        raise SystemExit(int(arg or 1))
    if name == "hang":
        time.sleep(float(arg or 1.0))
        raise SystemExit(19)  # watchdog EXIT_HANG: a wedged child hard-exit
    raise SystemExit(f"unknown fleet poison spec {spec!r}")


# ---------------------------------------------------------------------------
# durable-state faults
# ---------------------------------------------------------------------------
def tear_spool_tail(root, garbage=b'{"request_id": "req-chaos-torn", "ten'):
    """Append a torn (newline-less, truncated-JSON) tail to the spool — a
    submitter SIGKILLed mid-append. Readers must skip-and-count it; the next
    real submit must heal the line boundary."""
    path = os.path.join(str(root), "requests.jsonl")
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, garbage)
        os.fsync(fd)
    finally:
        os.close(fd)


def _lease_files(root):
    d = os.path.join(str(root), "leases")
    try:
        return sorted(n for n in os.listdir(d)
                      if n.endswith(".json") and ".tmp." not in n
                      and ".expired." not in n)
    except OSError:
        return []


def corrupt_random_lease(root, rng):
    """Overwrite one lease file with garbage bytes (a claimant that died
    mid-create / media corruption). The claim protocol treats a torn lease
    as expired, so the request is reclaimable — never wedged, never lost.
    Returns the corrupted file name, or None when no lease exists."""
    names = _lease_files(root)
    if not names:
        return None
    name = names[rng.randrange(len(names))]
    with open(os.path.join(str(root), "leases", name), "wb") as f:
        f.write(b"\x00{torn-lease-garbage")
    return name


def expire_random_lease(root, rng, now=None):
    """Force one live lease's ``expires_at`` into the past — the
    lease-expiry RACE: a reclaimer takes the batch while the recorded owner
    may still be running; the owner's next renew must see LeaseLost and
    stand down. Returns the expired request id, or None."""
    names = _lease_files(root)
    if not names:
        return None
    name = names[rng.randrange(len(names))]
    path = os.path.join(str(root), "leases", name)
    try:
        with open(path) as f:
            lease = json.load(f)
    except (OSError, ValueError):
        return None
    lease["expires_at"] = 0.0
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(lease, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return lease.get("request_id")


# ---------------------------------------------------------------------------
# load faults
# ---------------------------------------------------------------------------
def submit_storm(root, n_requests, tenant="storm", seed=0, spec=None,
                 points_per_request=1, epochs=None, priority=0,
                 deadline_s=None, distinct=True, now=None):
    """A seeded burst of N requests against a fleet root — the LOAD fault:
    more work than the current pool can drain inside its SLO. Used by the
    autoscale acceptance soak and bench probe: at fixed worker
    count the storm breaches queue-wait p99; with the autoscaler +
    backpressure armed it must settle with SLOs restored and zero
    dead-letters.

    ``spec`` is the per-request fit spec (defaults to the CLI's tiny
    synthetic spec). ``distinct=True`` (the default) varies each request's
    data seed deterministically in ``seed`` — CRITICAL for a storm: N
    byte-identical specs share one ``planner.batch_key`` and merge into a
    single batch, which is a merge benchmark, not a load storm.

    Submissions ride the normal admission gate: a
    :class:`~redcliff_tpu_torch.fleet.queue.BackpressureReject` is counted, not
    raised. Returns ``{"submitted": [rids...], "rejected": [
    {"eta_s", "threshold_s"}...], "tenant", "seed"}``."""
    from redcliff_tpu_torch.fleet.queue import BackpressureReject, FleetQueue

    rng = random.Random(seed)
    q = FleetQueue(str(root))
    if spec is None:
        from redcliff_tpu_torch.fleet.__main__ import TINY_SPEC

        spec = TINY_SPEC
    submitted, rejected = [], []
    for i in range(int(n_requests)):
        s = json.loads(json.dumps(spec))
        if distinct:
            data = s.setdefault("data", {})
            data["seed"] = int(data.get("seed") or 0) + 1 + rng.randrange(
                1 << 20)
        points = [{"gen_lr": round(1e-3 * (1 + rng.random()), 8)}
                  for _ in range(int(points_per_request))]
        try:
            rid = q.submit(tenant, points, spec=s, epochs=epochs,
                           priority=priority, deadline_s=deadline_s,
                           now=now)
        except BackpressureReject as rej:
            rejected.append({"eta_s": rej.eta_s,
                             "threshold_s": rej.threshold_s,
                             "queue_depth": rej.queue_depth,
                             "workers": rej.workers})
            continue
        submitted.append(rid)
    return {"submitted": submitted, "rejected": rejected,
            "tenant": str(tenant), "seed": int(seed)}


# ---------------------------------------------------------------------------
# worker fleet + SIGKILL storms
# ---------------------------------------------------------------------------
class WorkerFleet:
    """N real fleet workers as subprocesses in their own process groups (a
    SIGKILL to the group takes the supervised batch child down too — the
    whole-host-death the reclaim path exists for).

    ``env`` should carry the chaos arming (``REDCLIFF_FAULT_INJECT=
    fleet_poison``) and any runtime pinning the soak's bit-identity legs
    need. Workers run ``--drain``: a worker exits on an empty queue, and
    :meth:`respawn` keeps the fleet at strength until the queue settles.
    """

    def __init__(self, root, n_workers=2, lease_s=4.0, poll_s=0.2,
                 max_attempts=2, max_restarts=0, env=None, python=None,
                 extra_args=()):
        self.root = str(root)
        self.n_workers = int(n_workers)
        self.lease_s = float(lease_s)
        self.poll_s = float(poll_s)
        self.max_attempts = int(max_attempts)
        self.max_restarts = int(max_restarts)
        self.env = dict(env) if env is not None else None
        self.python = python or sys.executable
        self.extra_args = list(extra_args)
        self.procs = []
        self.kills = 0
        self.spawned = 0

    def _cmd(self):
        return [self.python, "-m", "redcliff_tpu_torch.fleet", "work",
                "--root", self.root, "--drain",
                "--lease-s", str(self.lease_s),
                "--poll-s", str(self.poll_s),
                "--max-attempts", str(self.max_attempts),
                "--max-restarts", str(self.max_restarts),
                "--base-delay-s", "0.05", "--max-delay-s", "0.05",
                ] + self.extra_args

    def spawn_one(self):
        proc = subprocess.Popen(self._cmd(), env=self.env,
                                start_new_session=True,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        self.procs.append(proc)
        self.spawned += 1
        return proc

    def __enter__(self):
        for _ in range(self.n_workers):
            self.spawn_one()
        return self

    def live(self):
        return [p for p in self.procs if p.poll() is None]

    def kill_one(self, rng):
        """SIGKILL a random live worker's whole process group (worker +
        supervised child). Returns the killed pid, or None."""
        live = self.live()
        if not live:
            return None
        proc = live[rng.randrange(len(live))]
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            return None
        proc.wait()
        self.kills += 1
        return proc.pid

    def respawn(self):
        """Top the fleet back up to ``n_workers`` live processes."""
        for _ in range(self.n_workers - len(self.live())):
            self.spawn_one()

    def __exit__(self, *exc):
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except OSError:
                    pass
            proc.wait()


# the fleet-level chaos grammar the seeded schedule fuzzer draws from;
# every op must leave the containment invariant reachable (kills respawn,
# torn state is skip-and-count, races resolve through the claim token)
FLEET_FAULT_KINDS = ("kill_worker", "expire_lease", "corrupt_lease",
                     "tear_spool")


def random_fleet_fault_schedule(seed, n_ops=6):
    """A seeded list of fleet-fault ops for the chaos soak — applied between
    polls while the worker fleet drains. Deterministic in ``seed``; kills
    lead the distribution (the dominant production fault)."""
    r = random.Random(seed)
    weighted = ("kill_worker", "kill_worker", "expire_lease",
                "corrupt_lease", "tear_spool")
    return [weighted[r.randrange(len(weighted))] for _ in range(int(n_ops))]


def apply_fault(op, root, rng, fleet=None):
    """Apply one schedule op; returns a short description for the soak log.
    ``kill_worker`` needs ``fleet`` (it also respawns to strength)."""
    if op == "kill_worker":
        if fleet is None:
            return "kill_worker: no fleet"
        pid = fleet.kill_one(rng)
        fleet.respawn()
        return f"kill_worker: pid={pid}"
    if op == "expire_lease":
        return f"expire_lease: {expire_random_lease(root, rng)}"
    if op == "corrupt_lease":
        return f"corrupt_lease: {corrupt_random_lease(root, rng)}"
    if op == "tear_spool":
        tear_spool_tail(root)
        return "tear_spool"
    raise ValueError(f"unknown fleet fault op {op!r}")
