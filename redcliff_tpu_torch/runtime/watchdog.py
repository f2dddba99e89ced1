"""Liveness watchdog: heartbeat registry, hang detection, exit-code taxonomy
(the port's copy of ``redcliff_tpu/runtime/watchdog.py``).

A fit that silently hangs — a wedged shard read, a prefetch thread
deadlocked against the async checkpoint writer, a stuck launch — would
otherwise burn its whole allocation with no signal. This module is the
liveness layer:

- :class:`HeartbeatRegistry` — named monotonic-clock heartbeats. The epoch
  loop, the per-batch loop, the prefetcher, the shard loader and the async
  checkpoint writer each ``stamp()`` theirs; components that finish a scope
  ``retire()`` so idle phases cannot read as hangs. Every stamp also counts
  into a persistent tally, so a registered-but-never-stamped component is
  visible.
- :class:`Watchdog` — a daemon thread that polls the registry; a stamp older
  than its budget raises a ``hang`` incident (per-component ages + all-thread
  stacks, and a flight-recorder dump through ``obs/flight.py``), then
  escalates **log -> checkpoint -> exit**: the checkpoint rung latches the
  preemption guard, so a merely slow loop writes a final checkpoint and
  exits ``EXIT_PREEMPTED``; a wedged process is hard-exited with
  ``EXIT_HANG`` after ``grace_s``.
- the **exit-code taxonomy**: a supervised child says why it died through
  its exit code.

``COMPILE_COMPONENT`` scopes the port's one-time program cost, a CUDA-graph
capture (``parallel/epoch_engine.py``; ``runtime/compileobs.py`` counts
captures as compiles): while a capture is live and within its budget, the
watchdog excuses the other overdue components.

The code is the JAX module's, bit for bit, but for the flight recorder's
import (the port's ``obs/flight.py``). stdlib only.
"""
from __future__ import annotations

import contextlib
import faulthandler
import os
import signal
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field

__all__ = [
    "EXIT_CLEAN", "EXIT_PREEMPTED", "EXIT_NUMERICS_ABORT", "EXIT_HANG",
    "EXIT_DEADLINE", "EXIT_HOST_LOST", "classify_exit", "CORE_COMPONENTS",
    "HeartbeatRegistry", "REGISTRY", "stamp", "retire", "op_scope",
    "host_component", "host_of",
    "COMPILE_COMPONENT", "COMPILE_BUDGET_S",
    "WatchdogPolicy", "Watchdog", "maybe_start", "dump_stacks",
]

# ---------------------------------------------------------------------------
# exit-code taxonomy: how a supervised child says WHY it died. 0 and the
# 17-20 band are the contract with runtime/supervisor.py (and with outer
# schedulers); negative returncodes are signals (subprocess convention).
# 17 predates this module (faultinject.PREEMPTED_EXIT_CODE re-exports it).
# ---------------------------------------------------------------------------
EXIT_CLEAN = 0            # fit finished; artifacts complete
EXIT_PREEMPTED = 17       # SIGTERM/SIGINT latched; final checkpoint written
EXIT_NUMERICS_ABORT = 18  # numerics sentinel aborted (deterministic: a
#                           restart replays the same divergence)
EXIT_HANG = 19            # watchdog hard-exited a wedged process
EXIT_DEADLINE = 20        # wall-clock deadline; checkpointed + resumable
EXIT_HOST_LOST = 21       # part of the mesh is gone (host heartbeats stale /
#                           collective timeout / device-loss signal): the
#                           supervisor re-meshes (smaller device budget) and
#                           restarts from the durable checkpoint

_EXIT_NAMES = {
    EXIT_CLEAN: "clean",
    EXIT_PREEMPTED: "preempted",
    EXIT_NUMERICS_ABORT: "numerics_abort",
    EXIT_HANG: "hang",
    EXIT_DEADLINE: "deadline",
    EXIT_HOST_LOST: "host_lost",
}


def classify_exit(returncode):
    """Map a child returncode onto the taxonomy: ``clean`` / ``preempted`` /
    ``numerics_abort`` / ``hang`` / ``deadline`` / ``host_lost`` /
    ``signal:NAME`` (killed by an un-latched signal, SIGKILL included) /
    ``crash`` (anything else)."""
    if returncode in _EXIT_NAMES:
        return _EXIT_NAMES[returncode]
    if returncode is not None and returncode < 0:
        try:
            return f"signal:{signal.Signals(-returncode).name}"
        except ValueError:
            return f"signal:{-returncode}"
    return "crash"


# the heartbeat map a fully-equipped supervised fit stamps (host-stream data,
# prefetch on, async checkpointing): the tier-1 tripwire test runs such a fit
# and asserts every one of these actually beat
CORE_COMPONENTS = ("epoch_engine", "batch_loop", "prefetch", "shard_loader",
                   "ckpt_writer")

DEFAULT_BUDGET_S = 600.0
ENV_WATCHDOG = "REDCLIFF_WATCHDOG"


class HeartbeatRegistry:
    """Named monotonic-clock heartbeats with per-component age budgets.

    ``stamp(name)`` auto-registers unknown names (budget =
    ``default_budget_s``, overridable per component via ``budgets``) so deep
    components need no plumbing; ``retire(name)`` removes a component from
    liveness monitoring when its scope ends (a prefetcher between epochs is
    idle, not hung) while keeping its cumulative stamp count for the
    dead-heartbeat tripwire. All methods are thread-safe and O(components).
    """

    def __init__(self, clock=time.monotonic, default_budget_s=DEFAULT_BUDGET_S):
        self.clock = clock
        self.default_budget_s = default_budget_s
        self.budgets = {}  # per-component overrides, consulted on register
        self._lock = threading.Lock()
        self._beats = {}   # name -> [last_stamp, budget_s]
        self._counts = {}  # name -> cumulative stamps (survives retire)

    def _budget_for(self, name):
        """Configured budget for ``name``; host-scoped beats
        (``host<h>:component``) fall back to the base component's override
        (an operator tuning ``budget.shard_loader`` expects it to govern
        every host's shard loader) before the default."""
        if name in self.budgets:
            return self.budgets[name]
        if host_of(name) is not None:
            base = name.partition(":")[2]
            if base in self.budgets:
                return self.budgets[base]
        return self.default_budget_s

    def register(self, name, budget_s=None):
        if budget_s is None:
            budget_s = self._budget_for(name)
        with self._lock:
            self._beats[name] = [self.clock(), float(budget_s)]
            self._counts.setdefault(name, 0)

    def stamp(self, name):
        with self._lock:
            beat = self._beats.get(name)
            if beat is None:
                self._beats[name] = [self.clock(),
                                     float(self._budget_for(name))]
            else:
                beat[0] = self.clock()
            self._counts[name] = self._counts.get(name, 0) + 1

    def retire(self, name):
        with self._lock:
            self._beats.pop(name, None)

    def refresh(self):
        """Re-stamp every live component (no count bump): a watchdog starting
        mid-process must grant stale entries a fresh budget, not fire on a
        previous fit's leftovers."""
        with self._lock:
            now = self.clock()
            for beat in self._beats.values():
                beat[0] = now

    def ages(self):
        with self._lock:
            now = self.clock()
            return {n: now - b[0] for n, b in self._beats.items()}

    def overdue(self):
        """[(name, age_s, budget_s)] for every live heartbeat past budget."""
        with self._lock:
            now = self.clock()
            return [(n, now - b[0], b[1]) for n, b in self._beats.items()
                    if now - b[0] > b[1]]

    def counts(self):
        with self._lock:
            return dict(self._counts)

    def clear(self):
        with self._lock:
            self._beats.clear()
            self._counts.clear()


# process-global registry: components stamp without plumbing a handle through
# the data layer. Fits that start a Watchdog refresh() it so stale entries
# from a previous fit in the same process never read as hangs.
REGISTRY = HeartbeatRegistry()

# the op-scoped cold-compile heartbeat: the grid stamps it around each
# CUDA-graph capture of the epoch engine (the port's one-time program cost,
# parallel/grid.py). While it is live and within budget, the watchdog
# EXCUSES other overdue components: a long capture window blocks the main
# thread legitimately. A capture older than its own (generous) budget still
# escalates — a truly wedged capture is a hang. Overridable like any budget via REDCLIFF_WATCHDOG=budget.compile=S.
COMPILE_COMPONENT = "compile"
COMPILE_BUDGET_S = 1800.0
REGISTRY.budgets.setdefault(COMPILE_COMPONENT, COMPILE_BUDGET_S)


def stamp(name):
    """Stamp ``name`` on the global registry (auto-registering)."""
    REGISTRY.stamp(name)


def retire(name):
    """Retire ``name`` from global liveness monitoring (counts persist)."""
    REGISTRY.retire(name)


@contextlib.contextmanager
def op_scope(name):
    """Stamp ``name`` for the duration of one operation, retiring on exit —
    the op-scoped heartbeat shape (stamp at entry, retire when the scope
    ends) used for cold compiles: ``with op_scope(COMPILE_COMPONENT): ...``.

    A closing COMPILE scope additionally ``refresh()``es the registry:
    every live component's age includes the whole compile window it was
    legitimately blocked behind, so without a fresh budget the first poll
    after a long (but in-budget) compile would fire a false hang incident
    on the still-stale siblings the excuse just stopped covering.
    """
    stamp(name)
    try:
        yield
    finally:
        retire(name)
        if name == COMPILE_COMPONENT:
            REGISTRY.refresh()


def host_component(host_id, component):
    """The host-scoped heartbeat name for ``component`` on host ``host_id``
    (``"host2:shard_loader"``). Host-scoped beats let one process observe
    per-host liveness — a real multi-controller run's cross-host heartbeat
    relay, or the single-process simulation's host partitions — and give the
    watchdog the signal for :data:`EXIT_HOST_LOST` classification: ONE
    host's components going stale while the rest of the process stays live
    is a lost host, not a wedged process."""
    return f"host{int(host_id)}:{component}"


def host_of(name):
    """The host index a heartbeat name is scoped to, or None for ordinary
    process-wide components."""
    if name.startswith("host"):
        head, sep, _ = name.partition(":")
        if sep and head[4:].isdigit():
            return int(head[4:])
    return None


def dump_stacks():
    """Every thread's current stack as one string (named per thread) — the
    forensic core of a ``hang`` event: *where* each thread is wedged."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out)


@dataclass
class WatchdogPolicy:
    """Escalation knobs. ``grace_s`` is the window between latching the
    preemption guard (rung 2: a slow-but-alive loop checkpoints and exits
    ``EXIT_PREEMPTED`` on its own) and the hard exit (rung 3:
    ``os._exit(EXIT_HANG)`` — a wedged process cannot run cleanup, and the
    durable ``.prev`` checkpoint generation makes that safe)."""

    poll_s: float = 5.0
    grace_s: float = 30.0
    default_budget_s: float = DEFAULT_BUDGET_S
    budgets: dict = field(default_factory=dict)  # per-component overrides
    hard_exit: bool = True
    latch_preempt: bool = True
    # classify "exactly one host's heartbeats stale, everything else live"
    # as a lost host (exit EXIT_HOST_LOST: the supervisor re-meshes) instead
    # of a process hang. Disable with REDCLIFF_WATCHDOG=...,host_loss=0
    host_loss: bool = True

    @classmethod
    def from_env(cls, env=ENV_WATCHDOG):
        """Policy from ``REDCLIFF_WATCHDOG``; None when unset/empty/"0".

        ``"1"`` enables defaults; otherwise a comma-separated ``k=v`` list:
        ``poll_s``, ``grace_s``, ``budget_s`` (default budget), and
        ``budget.<component>=S`` per-component overrides — e.g.
        ``REDCLIFF_WATCHDOG="poll_s=0.5,grace_s=2,budget.prefetch=3"``.
        """
        spec = os.environ.get(env, "").strip()
        if not spec or spec == "0":
            return None
        policy = cls()
        if spec == "1":
            return policy
        for part in spec.split(","):
            k, _, v = part.strip().partition("=")
            if not v:
                continue
            if k == "poll_s":
                policy.poll_s = float(v)
            elif k == "grace_s":
                policy.grace_s = float(v)
            elif k == "budget_s":
                policy.default_budget_s = float(v)
            elif k == "host_loss":
                policy.host_loss = v not in ("0", "false", "off")
            elif k.startswith("budget."):
                policy.budgets[k[len("budget."):]] = float(v)
        return policy


class Watchdog:
    """Daemon thread that turns stale heartbeats into the escalation ladder.

    On the first poll that finds overdue heartbeats it emits ONE structured
    ``hang`` incident (per-component ages/budgets/stamp counts + all-thread
    stacks) to the bound MetricLogger and stderr, and latches the preemption
    guard (when bound) so an alive-but-slow loop can still save and exit
    cleanly. If any heartbeat is still overdue ``grace_s`` later the process
    is hard-exited with ``EXIT_HANG`` (``on_hang``-only mode sets
    ``hard_exit=False`` and just keeps logging). A recovery
    (nothing overdue) rearms the ladder.

    The thread is a daemon and ``stop()`` joins it, so pytest teardown can
    never hang on a leftover watchdog.
    """

    def __init__(self, policy=None, registry=None, guard=None, logger=None,
                 on_hang=None, exit_fn=os._exit, clock=time.monotonic):
        self.policy = policy or WatchdogPolicy()
        self.registry = registry if registry is not None else REGISTRY
        self.guard = guard
        self.logger = logger
        self.on_hang = on_hang
        self.exit_fn = exit_fn
        self.clock = clock
        self.incidents = 0
        self._stop = threading.Event()
        self._thread = None

    def bind(self, guard=None, logger=None):
        """Late-bind the escalation targets (the guard exists before the fit
        loop, the MetricLogger only inside it)."""
        if guard is not None:
            self.guard = guard
        if logger is not None:
            self.logger = logger
        return self

    def start(self):
        if self._thread is not None:
            return self
        self.registry.default_budget_s = self.policy.default_budget_s
        self.registry.budgets.update(self.policy.budgets)
        # stale stamps from earlier fits in this process get a fresh budget
        self.registry.refresh()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="runtime-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------------
    def _lost_host(self, overdue):
        """The host index when EVERY overdue heartbeat is scoped to one host
        AND at least one other component (another host's, or any plain
        process-wide beat) is still being monitored — the signature of a
        peer that stopped participating while this process stays healthy.
        None otherwise (a process-wide stall is a hang, not a host loss)."""
        hosts = {host_of(n) for n, _, _ in overdue}
        if len(hosts) != 1 or None in hosts:
            return None
        lost = next(iter(hosts))
        others = [n for n in self.registry.ages() if host_of(n) != lost]
        return lost if others else None

    def _other_counts(self, lost):
        """Stamp counts of every component NOT scoped to the lost host —
        the proof-of-life baseline for the host-loss grace window."""
        return {n: c for n, c in self.registry.counts().items()
                if host_of(n) != lost}

    def _run(self):
        latched_at = None
        host_latched_at = None
        host_alive0 = None
        host_demoted = False  # a host-loss incident failed proof-of-life:
        #                       stay on the hang ladder until recovery
        while not self._stop.wait(self.policy.poll_s):
            overdue = self.registry.overdue()
            if overdue and not any(n == COMPILE_COMPONENT
                                   for n, _, _ in overdue) \
                    and COMPILE_COMPONENT in self.registry.ages():
                # a live, in-budget cold-compile scope legitimately blocks
                # the main thread (epoch_engine/batch_loop cannot stamp
                # while a graph is captured) — excuse everything until it
                # finishes or itself exceeds its own budget
                overdue = []
            if not overdue:
                latched_at = host_latched_at = None  # recovered: rearm
                host_demoted = False
                continue
            now = self.clock()
            lost = (self._lost_host(overdue)
                    if self.policy.host_loss and not host_demoted else None)
            if lost is not None:
                # host-loss ladder: one structured incident, then exit with
                # the re-mesh taxonomy code after grace. Deliberately NO
                # preempt latch — the in-process loop is healthy (nothing
                # here needs saving beyond the last periodic checkpoint),
                # and on a real multi-host mesh a final save would wedge on
                # collectives the dead host can no longer join; exiting
                # fast hands the supervisor the re-mesh decision
                latched_at = None
                if host_latched_at is None:
                    host_latched_at = now
                    host_alive0 = self._other_counts(lost)
                    self.incidents += 1
                    self._emit(overdue, event="host_lost", host=lost)
                    continue
                if now - host_latched_at >= self.policy.grace_s:
                    # proof of life: "others are merely in-budget" is not
                    # evidence this process is healthy (a whole-process
                    # wedge freezes short-budget host beats first); only a
                    # component that actually STAMPED during the grace
                    # window proves liveness. Without one, demote to the
                    # ordinary hang ladder — exit 19 and a same-shape
                    # restart, never a misclassified mesh shrink. (A main
                    # thread blocked on a dead collective takes the typed
                    # collective-timeout route in the grid engine, not
                    # this heartbeat route.)
                    counts = self._other_counts(lost)
                    alive = any(counts.get(n, 0) > c0
                                for n, c0 in host_alive0.items()) \
                        or any(n not in host_alive0 for n in counts)
                    if alive:
                        if self.policy.hard_exit:
                            self._hard_exit(
                                overdue, exit_code=EXIT_HOST_LOST,
                                event="host_lost", host=lost)
                        host_latched_at = None
                        continue
                    host_latched_at = None
                    host_demoted = True  # until recovery rearms
                    lost = None  # fall through to the hang ladder below
                else:
                    continue
            if lost is None and host_latched_at is not None:
                host_latched_at = None
            if latched_at is None:
                latched_at = now
                self.incidents += 1
                self._emit(overdue)
                if self.guard is not None and self.policy.latch_preempt:
                    # rung 2: a slow-but-alive loop sees the latch at its
                    # next epoch boundary, writes the final checkpoint, and
                    # exits EXIT_PREEMPTED on its own
                    self.guard.signum = None
                    self.guard.preempted = True
                continue
            if now - latched_at >= self.policy.grace_s:
                if self.policy.hard_exit:
                    self._hard_exit(overdue)
                # on_hang-only mode: keep logging one incident per ladder
                # cycle instead of spamming every poll
                latched_at = None

    def _record(self, overdue):
        counts = self.registry.counts()
        return {
            "components": {
                name: {"age_s": round(age, 3), "budget_s": budget,
                       "stamps": counts.get(name, 0)}
                for name, age, budget in overdue},
            "ages_s": {n: round(a, 3)
                       for n, a in self.registry.ages().items()},
            "grace_s": self.policy.grace_s,
        }

    def _dump_flight(self, reason, rec, timeout_s=5.0):
        """Dump the crash flight recorder (obs/flight.py) next
        to the bound logger's metrics.jsonl: the stalled component's last
        spans — per-dispatch, checkpoint writes, prefetch fills, shard
        loads — are in-memory evidence that was deliberately never flushed
        to disk; an escalation is exactly when it must be. Best-effort AND
        time-bounded: the dump writes to the same filesystem whose wedge may
        be the very hang being escalated, and blocking I/O is uninterruptible
        by try/except — so it runs in a daemon thread joined for at most
        ``timeout_s``, like the hard-exit's log flush. Forensics can never
        block the ladder (or the guaranteed exit)."""
        result = [None]

        def dump():
            with contextlib.suppress(Exception):
                from redcliff_tpu_torch.obs import flight as _flight

                result[0] = _flight.dump_for_logger(self.logger,
                                                    reason=reason, extra=rec)

        t = threading.Thread(target=dump, name="watchdog-flight",
                             daemon=True)
        t.start()
        t.join(timeout=timeout_s)
        return result[0]

    def _emit(self, overdue, event="hang", **extra):
        rec = self._record(overdue)
        rec.update(extra)
        stacks = dump_stacks()
        flight_path = self._dump_flight(event, rec)
        print(f"[watchdog] {event.upper()} detected: {rec['components']}"
              + (f"\nflight record: {flight_path}" if flight_path else "")
              + f"\n{stacks}", file=sys.stderr, flush=True)
        if self.logger is not None and getattr(self.logger, "active", False):
            self.logger.log(event, **rec, stacks=stacks)
        if self.on_hang is not None:
            try:
                self.on_hang(rec)
            except Exception:  # noqa: BLE001 — a bad callback must not
                pass           # silence the ladder

    def _hard_exit(self, overdue, exit_code=EXIT_HANG, event="hang", **extra):
        rec = self._record(overdue)
        rec.update(extra)
        # stderr forensics FIRST — guaranteed even if the jsonl logger is
        # unusable (e.g. the main thread wedged while holding its lock)
        print(f"[watchdog] {event} persists after {self.policy.grace_s:.1f}s "
              f"grace; hard exit {exit_code}: {rec['components']}",
              file=sys.stderr, flush=True)
        # refresh the flight record with the state at exit time (the _emit
        # dump is grace_s old by now); time-bounded like the log flush below
        # — a wedged filesystem must not block the exit
        self._dump_flight(event, dict(rec, exit_code=exit_code))
        with contextlib.suppress(Exception):
            faulthandler.dump_traceback(file=sys.stderr)
        sys.stderr.flush()
        if self.logger is not None and getattr(self.logger, "active", False):
            # best-effort, time-bounded: the *_exit record is nice to
            # have, but the exit must happen even if logging would block
            def flush_log():
                with contextlib.suppress(Exception):
                    self.logger.log(f"{event}_exit", exit_code=exit_code,
                                    **rec)
                    self.logger.close()

            t = threading.Thread(target=flush_log, name="watchdog-flush",
                                 daemon=True)
            t.start()
            t.join(timeout=5.0)
        # os._exit, not sys.exit: the main thread is wedged and cannot unwind;
        # durability is the checkpoint layer's job (.prev generation)
        self.exit_fn(exit_code)


def maybe_start(guard=None, logger=None, registry=None):
    """Watchdog context from the environment: a live :class:`Watchdog` when
    ``REDCLIFF_WATCHDOG`` is set (the supervised-run switch), else an inert
    nullcontext — call sites never branch."""
    policy = WatchdogPolicy.from_env()
    if policy is None:
        return contextlib.nullcontext(None)
    return Watchdog(policy=policy, guard=guard, logger=logger,
                    registry=registry)
