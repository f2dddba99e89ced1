"""Crash-loop supervisor: restart a driver process until it finishes or the
failure is one a restart cannot fix.

``python -m redcliff_tpu_torch.supervise -- <driver cmd ...>`` runs the
driver as a child, classifies every exit through the watchdog taxonomy
(:func:`~redcliff_tpu_torch.runtime.watchdog.classify_exit`), and restarts
on the transient classes — preemption, watchdog hang, plain crashes/signals — with
the shared :mod:`~redcliff_tpu_torch.runtime.retry` backoff between attempts.
Deterministic failures (``numerics_abort``: a restart replays the same
divergence) and spent budgets (``deadline``) stop immediately; a crash loop
gives up after ``max_restarts``. Resume correctness is the checkpoint
layer's guarantee (durable CRC+``.prev`` generations plus the grid
fingerprint), so a supervised run's final artifacts are bit-identical to an
uninterrupted one — pinned by tests/test_supervisor.py.

Host-fault tolerance (elastic re-meshing, docs/ARCHITECTURE.md "Elastic
re-meshing & host-fault tolerance"): a child exiting ``host_lost`` (taxonomy
code 21 — stale per-host heartbeats, a collective timeout mapped to
:class:`~redcliff_tpu_torch.parallel.remesh.HostLostError`, or an explicit
device-loss signal) is NOT restarted at the same shape. When the policy
declares the mesh (``mesh_devices``/``n_hosts``), the supervisor degrades
the device budget by one host's worth, exports it to the next attempt via
``REDCLIFF_MESH_DEVICES`` (which
:func:`~redcliff_tpu_torch.parallel.remesh.visible_mesh` honors), and
restarts —
the grid engine re-shards the checkpointed lanes onto the smaller mesh and
the sweep continues with results still reported under original point ids.
A mesh degraded below ``min_devices`` stops with ``mesh_exhausted``. Without
a declared mesh, ``host_lost`` degrades to a plain same-shape restart.

Every attempt is a line in ``run_ledger.jsonl`` (strict JSON): command, rc,
classification, action, backoff, wall times, and the commanded mesh shape
({n_hosts, n_devices, device_kind}) — the audit trail an operator reads
after a 12-hour grid search died at 3am, including which attempts ran
degraded.

Per-attempt ETA: when the driver writes its telemetry next to the ledger
(the usual layout — ``metrics.jsonl`` in the same run directory), each
attempt record also carries the learned cost model's remaining-work
estimate as of the attempt's last check window (the newest ``cost_model``
event: predicted epoch cost, epochs remaining, ``eta_s``) — so the ledger
answers not just "why did attempt 3 stop" but "how much work was left when
it did", the admission-planner input ROADMAP item 1 needs per request.
Read via a bounded tail of the metrics file (crash-tolerant: torn lines
skipped), absent when no telemetry or no prediction exists.

stdlib only (the supervisor parent must never initialize a device
backend: no torch, no jax).

Port of ``redcliff_tpu/runtime/supervisor.py``, a copy: it computes and
writes what the JAX module does. A ``host_lost`` exit (code 21) comes
from the grid's mesh (``parallel/remesh.HostLostError``): with a declared
mesh budget the next attempt's ``REDCLIFF_MESH_DEVICES`` shrinks and its
grid re-shards the checkpoint onto the survivors.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field

from redcliff_tpu_torch.runtime.retry import RetryPolicy
from redcliff_tpu_torch.runtime.watchdog import classify_exit

__all__ = ["SupervisorPolicy", "SuperviseOutcome", "supervise", "main",
           "LEDGER_NAME", "latest_cost_model_eta", "worker_exit_action"]

LEDGER_NAME = "run_ledger.jsonl"

# restart vs stop per classification; "signal:*" prefixes match "signal".
# host_lost restarts too — via the re-mesh path when the policy declares a
# mesh, degrading to a same-shape restart when it does not
RESTART_CLASSES = ("preempted", "hang", "crash", "signal", "host_lost")
TERMINAL_CLASSES = ("clean", "numerics_abort", "deadline")

DEFAULT_BACKOFF = RetryPolicy(max_attempts=1_000_000, base_delay_s=1.0,
                              multiplier=2.0, max_delay_s=60.0)

# the env knob the next attempt's visible_mesh() honors; kept as a literal
# (not imported from parallel.remesh) so this module stays stdlib-only
MESH_DEVICES_ENV = "REDCLIFF_MESH_DEVICES"
SIM_HOSTS_ENV = "REDCLIFF_SIM_HOSTS"


@dataclass
class SupervisorPolicy:
    """``max_restarts`` bounds the crash loop (restarts, not attempts: 3
    means up to 4 child runs); ``backoff`` spaces them.

    Mesh declaration (enables re-mesh-then-restart on ``host_lost`` exits):
    ``mesh_devices`` is the full-strength device count, ``n_hosts`` how many
    hosts it spans; ``devices_per_host`` defaults to the even split. On each
    ``host_lost`` the budget drops by one host's devices and the new budget
    is exported to the child via ``REDCLIFF_MESH_DEVICES``; once it would
    fall below ``min_devices`` (or the last host is gone) the run stops with
    ``mesh_exhausted``. With ``mesh_devices`` alone (host width unknown) the
    budget degrades conservatively by ONE device per loss — under-shooting
    just costs extra restart rounds until the budget fits the survivors,
    while over-shooting would discard healthy devices for the rest of the
    sweep. ``device_kind`` is audit metadata for the ledger."""

    max_restarts: int = 5
    backoff: RetryPolicy = field(default_factory=lambda: DEFAULT_BACKOFF)
    mesh_devices: int | None = None
    n_hosts: int | None = None
    devices_per_host: int | None = None
    min_devices: int = 1
    device_kind: str | None = None

    def host_width(self):
        """Devices one lost host takes with it (1 when unknown — degrade
        conservatively rather than throw away healthy capacity)."""
        if self.devices_per_host:
            return int(self.devices_per_host)
        if self.mesh_devices and self.n_hosts:
            return max(int(self.mesh_devices) // int(self.n_hosts), 1)
        return 1


@dataclass
class SuperviseOutcome:
    classification: str   # final classification ("giving_up" on a crash loop)
    returncode: int       # last child's rc (the supervisor's own exit code)
    attempts: list        # one record per child run (the ledger lines)


def _restartable(classification):
    return any(classification == c or classification.startswith(c + ":")
               for c in RESTART_CLASSES)


def worker_exit_action(returncode, restarts_used, max_restarts=None,
                       policy=None):
    """Judge one WORKER-process exit under the supervised-exit taxonomy:
    returns ``(classification, action)`` where action is ``"retire"`` (a
    clean drain — the fleet autoscaler's passive scale-down), ``"respawn"``
    (a restartable infra class with restart budget left), or ``"stop"``
    (terminal, or budget exhausted). The fleet autoscaler
    (fleet/autoscale.py) applies the same exit-code taxonomy to its worker
    POOL that :func:`supervise` applies to one child — one classification
    vocabulary across both supervision layers."""
    if max_restarts is None:
        max_restarts = (policy or SupervisorPolicy()).max_restarts
    if returncode == 0:
        return "drained", "retire"
    classification = classify_exit(returncode)
    if _restartable(classification) and int(restarts_used) < int(
            max_restarts):
        return classification, "respawn"
    return classification, "stop"


# how much of the metrics file tail to scan for the newest cost_model
# event: check windows emit one small line each, so 128 KiB covers
# thousands of windows while keeping the read O(1) in run length
_ETA_TAIL_BYTES = 128 * 1024


def latest_cost_model_eta(ledger_path, since_wall=None,
                          tail_bytes=_ETA_TAIL_BYTES):
    """The newest ``cost_model`` event's ETA fields from the metrics.jsonl
    sitting next to ``ledger_path``, or None (no metrics file, no event in
    the tail, torn/unparseable lines — all degrade silently: the ETA is
    audit garnish, never a supervision input).

    ``since_wall`` restricts to events stamped at/after that wall time —
    the supervisor passes each attempt's start so an attempt that died
    before its first check window reports NO eta instead of inheriting the
    previous attempt's."""
    run_dir = os.path.dirname(ledger_path) or "."
    path = os.path.join(run_dir, "metrics.jsonl")
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if size > tail_bytes:
                f.seek(size - tail_bytes)
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(tail.splitlines()):
        if '"cost_model"' not in line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn first line of the tail window / mid-append
        if rec.get("event") != "cost_model":
            continue
        if since_wall is not None and not (
                isinstance(rec.get("wall_time"), (int, float))
                and rec["wall_time"] >= since_wall):
            return None  # newest event predates this attempt: no eta
        # wall_time: when the ETA was computed — consumers that treat
        # eta_s as "remaining from NOW" (the fleet preemption monitor)
        # must discount by its age or a sparse check-window cadence
        # overstates remaining work by up to one window
        return {k: rec.get(k) for k in
                ("eta_s", "predicted_epoch_ms", "epochs_remaining",
                 "epoch", "source", "wall_time")}
    return None


class _Ledger:
    def __init__(self, path):
        self.path = path
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)

    def append(self, rec):
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


def supervise(cmd, ledger_path=None, policy=None, env=None,
              sleep=time.sleep, popen=subprocess.Popen, on_spawn=None,
              should_stop=None):
    """Run ``cmd`` under crash-loop supervision; returns
    :class:`SuperviseOutcome` (its ``returncode`` is what the supervisor
    process should exit with).

    ``sleep``/``popen``/``on_spawn``/``should_stop`` are injectable for
    tests and for the CLI's SIGTERM relay: ``on_spawn(proc)`` exposes the
    live child, ``should_stop()`` (checked after each attempt) turns an
    externally-preempted supervisor into a stop instead of a restart.
    """
    policy = policy or SupervisorPolicy()
    ledger = _Ledger(ledger_path)
    attempts = []
    attempt = 0
    # commanded mesh shape: what the NEXT child may use. Degrades by one
    # host's devices on every host_lost exit; exported via
    # REDCLIFF_MESH_DEVICES so the child's visible_mesh() honors it
    cur_devices = policy.mesh_devices
    cur_hosts = policy.n_hosts

    def child_env():
        if cur_devices is None:
            return env  # no mesh tracking: pass the caller's env untouched
        e = dict(env if env is not None else os.environ)
        e[MESH_DEVICES_ENV] = str(cur_devices)
        if cur_hosts is not None:
            e[SIM_HOSTS_ENV] = str(cur_hosts)
        return e

    while True:
        started = time.time()
        t0 = time.monotonic()
        proc = popen(list(cmd), env=child_env())
        if on_spawn is not None:
            on_spawn(proc)
        rc = proc.wait()
        classification = classify_exit(rc)
        stopping = bool(should_stop()) if should_stop is not None else False
        mesh_exhausted = False
        remesh_to = None
        if classification in TERMINAL_CLASSES or stopping:
            action = "stop"
        elif not _restartable(classification):
            action = "stop"
        elif attempt >= policy.max_restarts:
            action = "give_up"
        elif classification == "host_lost" and cur_devices is not None:
            # re-mesh-then-restart: shrink the commanded mesh by one host's
            # devices; the resumed child re-shards its checkpointed lanes
            # onto the survivors. Exhausting the mesh is terminal — there
            # is nothing left to run on
            remesh_to = cur_devices - policy.host_width()
            if remesh_to < max(policy.min_devices, 1) \
                    or (cur_hosts is not None and cur_hosts <= 1):
                action = "stop"
                mesh_exhausted = True
            else:
                action = "remesh_restart"
        else:
            action = "restart"
        restarting = action in ("restart", "remesh_restart")
        backoff = (policy.backoff.backoff_s(attempt + 1)
                   if restarting else 0.0)
        rec = {
            "event": "attempt", "attempt": attempt, "cmd": list(cmd),
            "rc": rc, "classification": classification, "action": action,
            "backoff_s": round(backoff, 3), "started_at": started,
            "duration_s": round(time.monotonic() - t0, 3),
        }
        if cur_devices is not None:
            # the mesh shape THIS attempt ran under — the degraded-resume
            # audit trail (which attempts ran at which width)
            rec["mesh"] = {"n_hosts": cur_hosts, "n_devices": cur_devices,
                           "device_kind": policy.device_kind}
        if ledger.path:
            # remaining-work estimate at THIS attempt's last check window
            # (obs/costmodel.py scoring events written by the driver next
            # to this ledger); absent when this attempt left no telemetry —
            # since_wall keeps a compile-crash attempt from inheriting the
            # previous attempt's eta
            eta = latest_cost_model_eta(ledger.path, since_wall=started)
            if eta is not None:
                rec["eta"] = eta
        ledger.append(rec)
        attempts.append(rec)
        if action == "remesh_restart":
            ledger.append({
                "event": "remesh", "from_devices": cur_devices,
                "to_devices": remesh_to, "from_hosts": cur_hosts,
                "to_hosts": (cur_hosts - 1 if cur_hosts else None)})
            cur_devices = remesh_to
            if cur_hosts:
                cur_hosts -= 1
        if not restarting:
            final = ("giving_up" if action == "give_up"
                     else "mesh_exhausted" if mesh_exhausted
                     else classification)
            ledger.append({"event": "final", "classification": final,
                           "rc": rc, "attempts": len(attempts)})
            return SuperviseOutcome(classification=final, returncode=rc,
                                    attempts=attempts)
        # backoff in short slices, re-checking the stop flag before the
        # respawn: a SIGTERM landing BETWEEN attempts (no live child to
        # relay it to) must stop the loop, not spawn a fresh child that
        # never saw the preemption notice
        remaining = backoff
        while remaining > 0 and not (should_stop is not None
                                     and should_stop()):
            step = min(remaining, 0.5)
            sleep(step)
            remaining -= step
        if should_stop is not None and should_stop():
            ledger.append({"event": "final", "classification": "stopped",
                           "rc": rc, "attempts": len(attempts)})
            return SuperviseOutcome(classification="stopped", returncode=rc,
                                    attempts=attempts)
        attempt += 1


def main(argv=None):
    """CLI: ``python -m redcliff_tpu_torch.supervise [opts] -- <driver cmd ...>``.

    SIGTERM/SIGINT to the supervisor are relayed to the child (so preempting
    the supervisor preempts the run: the child latches, checkpoints, exits
    ``EXIT_PREEMPTED``) and the loop stops instead of restarting. The
    supervisor exits with the last child's returncode (0 on clean)."""
    ap = argparse.ArgumentParser(
        prog="redcliff_tpu_torch.supervise",
        description="Crash-loop supervisor with exit-code taxonomy and a "
                    "run_ledger.jsonl audit trail.")
    ap.add_argument("--ledger", default=LEDGER_NAME,
                    help=f"ledger path (default ./{LEDGER_NAME})")
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--base-delay-s", type=float, default=1.0)
    ap.add_argument("--max-delay-s", type=float, default=60.0)
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="full-strength device count: enables re-mesh-then-"
                         "restart on host_lost exits (exported to the child "
                         f"via {MESH_DEVICES_ENV})")
    ap.add_argument("--n-hosts", type=int, default=None,
                    help="hosts the mesh spans (devices-per-host defaults "
                         "to the even split)")
    ap.add_argument("--devices-per-host", type=int, default=None,
                    help="devices one lost host takes with it")
    ap.add_argument("--min-devices", type=int, default=1,
                    help="stop with mesh_exhausted below this budget")
    ap.add_argument("--device-kind", default=None,
                    help="audit metadata for the ledger's mesh records")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- followed by the driver command")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no driver command given (use: supervise -- <cmd ...>)")

    state = {"child": None, "stop": False}

    def relay(signum, frame):
        state["stop"] = True
        child = state["child"]
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signum)
            except OSError:
                pass

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, relay)

    policy = SupervisorPolicy(
        max_restarts=args.max_restarts,
        backoff=RetryPolicy(max_attempts=1_000_000,
                            base_delay_s=args.base_delay_s, multiplier=2.0,
                            max_delay_s=args.max_delay_s),
        mesh_devices=args.mesh_devices, n_hosts=args.n_hosts,
        devices_per_host=args.devices_per_host,
        min_devices=args.min_devices, device_kind=args.device_kind)
    outcome = supervise(
        cmd, ledger_path=args.ledger, policy=policy,
        on_spawn=lambda p: state.__setitem__("child", p),
        should_stop=lambda: state["stop"])
    print(f"supervise: {outcome.classification} after "
          f"{len(outcome.attempts)} attempt(s), rc={outcome.returncode}",
          file=sys.stderr)
    return outcome.returncode


if __name__ == "__main__":
    raise SystemExit(main())
