"""Streaming inference service: supervision + dispatch over the slot table
(port of ``serve/service.py``).

Ties the :class:`~redcliff_tpu_torch.serve.engine.StreamEngine` slot table
(device math) to the :class:`~redcliff_tpu_torch.serve.session.
SessionRegistry` (lease/heartbeat supervision), the shared admission
taxonomy (``SlotsExhausted`` reject-with-ETA) and the telemetry spine
(schema-registered ``serve`` / ``session`` / ``serve_ladder`` /
``serve_fuse`` / ``precision`` events through ``obs/logging.py``'s
``MetricLogger``, ``serve.dispatch`` spans, per-stream ``trace_id``).

**Tick discipline.** ``pump()`` is one tick: reap lapsed leases (recycled
lanes reset one by one), assemble pending samples per ACTIVE stream into
the arrival batch, run the occupancy-ladder policy, ONE engine dispatch at
the current rung, distribute outputs. A tick with no arrivals dispatches
nothing. ``run_loop`` rides the same tick through
:func:`data.pipeline.prefetch_batches` (depth 2): a prefetch thread reaps
and assembles tick t+1 on the host while this thread dispatches tick t.
The assembly thread never touches a CUDA tensor: while the loop runs, a
lane reset asked for on another thread waits in a queue that the dispatch
thread applies at the start of its next tick.

**Occupancy ladder.** ``REDCLIFF_SERVE_LADDER`` selects the policy:
``off`` always dispatches the full ``capacity`` table; ``force`` always
rides the smallest pow2 rung >= the live high-water mark; ``auto``
(default) grows on demand (every leased slot must ride the dispatch) and
prices shrinks through the cost model (``obs/costmodel.py``): predicted
dead-lane saving over ``REDCLIFF_SERVE_LADDER_HORIZON`` ticks against the
first-dispatch cost of a cold rung, with ``REDCLIFF_SERVE_LADDER_HOLD``
ticks of hysteresis. With no evidence — an empty store and no local tick
observations — auto holds the current (maximum) rung, the same bytes as
ladder off. Rung moves happen at tick boundaries only.

**Tick fusion.** When a stream has backlog and ``REDCLIFF_SERVE_FUSE`` >
1, one dispatch advances up to that many samples per lane
(:meth:`StreamEngine.step_fused`) instead of N ticks; the per-stream
``answered`` counter drives graph cadence as if the samples had arrived
over N ticks, so the record stream equals the unfused run's.

**Mixed precision.** ``precision_mode="mixed"`` (or
``REDCLIFF_SERVE_PRECISION=mixed``) serves bf16 contractions over f32 ring
state, the graph blend through the bf16 form of the factor-mix kernel. The
per-lane NaN latch doubles as the demotion sentinel:
``REDCLIFF_SERVE_DEMOTE_STORM`` poisoned lanes inside
``REDCLIFF_SERVE_DEMOTE_WINDOW`` ticks demote the whole table to f32, log a
``precision`` event, and the drain checkpoint records the demotion so a
resume never silently re-promotes.

**Input contracts (per stream).** A shape-violating sample quarantines its
stream host-side; a non-finite sample is detected on the device and
quarantines the stream with its ring untouched. Either way the stream
degrades to a structured error record its subscriber polls.

**Overload.** Admission past capacity raises ``SlotsExhausted``; a stream
whose backlog climbs sheds graph-readout cadence through
:data:`QOS_CADENCE` (scores keep flowing every sample); ingest past the
backlog cap is refused; a slow consumer's out-queue drops ITS oldest
records past the out-queue cap.

**Drain.** ``drain()`` (or SIGTERM via :meth:`install_signal_handlers`)
answers every in-flight sample and checkpoints sessions, rings, the active
rung, the precision state and undelivered records to ``serve_state.bin``
(runtime/checkpoint.py); a restarted server resumes every session with a
fresh lease, re-packing lanes into a different capacity (dense from slot
0, order kept); only a table too small for the live streams refuses,
naming both geometries.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from collections import deque

import numpy as np

from redcliff_tpu_torch import obs as _obs
from redcliff_tpu_torch.obs import slo as _slo
from redcliff_tpu_torch.obs.logging import MetricLogger
from redcliff_tpu_torch.parallel import compaction as _compaction
from redcliff_tpu_torch.runtime.admission import SlotsExhausted
from redcliff_tpu_torch.runtime.checkpoint import (load_checkpoint,
                                                   write_checkpoint)
from redcliff_tpu_torch.serve import session as _session
from redcliff_tpu_torch.utils.precision import (check_precision_mode,
                                                precision_label)

__all__ = ["ServeService", "ServeLadder", "SlotsExhausted",
           "ENV_SLOTS", "DEFAULT_SLOTS", "ENV_INGEST_CAP", "ENV_OUT_CAP",
           "ENV_LADDER", "ENV_FUSE", "ENV_PRECISION", "LADDER_MODES",
           "MIN_RUNG", "QOS_CADENCE", "STATE_BASENAME"]

ENV_SLOTS = "REDCLIFF_SERVE_SLOTS"
DEFAULT_SLOTS = 8
ENV_INGEST_CAP = "REDCLIFF_SERVE_INGEST_CAP"
DEFAULT_INGEST_CAP = 64
ENV_OUT_CAP = "REDCLIFF_SERVE_OUT_CAP"
DEFAULT_OUT_CAP = 256

# ---- occupancy ladder ----
ENV_LADDER = "REDCLIFF_SERVE_LADDER"
DEFAULT_LADDER = "auto"
LADDER_MODES = ("off", "auto", "force")
# churn floor: below this rung another saved lane cannot pay for a cold
# program, and sub-4 tables thrash on any connect
MIN_RUNG = 4
ENV_LADDER_HOLD = "REDCLIFF_SERVE_LADDER_HOLD"
DEFAULT_LADDER_HOLD = 8
ENV_LADDER_HORIZON = "REDCLIFF_SERVE_LADDER_HORIZON"
DEFAULT_LADDER_HORIZON = 500

# ---- micro-batched tick fusion ----
ENV_FUSE = "REDCLIFF_SERVE_FUSE"
DEFAULT_FUSE = 1

# ---- mixed-precision serve path ----
ENV_PRECISION = "REDCLIFF_SERVE_PRECISION"
ENV_DEMOTE_STORM = "REDCLIFF_SERVE_DEMOTE_STORM"
DEFAULT_DEMOTE_STORM = 3
ENV_DEMOTE_WINDOW = "REDCLIFF_SERVE_DEMOTE_WINDOW"
DEFAULT_DEMOTE_WINDOW = 200

# degraded-QoS ladder: graph-readout cadence per rung (emit the (C, C)
# graph on every Nth answered sample); scores always flow every sample
QOS_CADENCE = (1, 4, 16)
# backlog hysteresis (fractions of the ingest cap): demote above, restore
# below — the gap prevents rung flapping at a steady backlog
_QOS_DEMOTE_FRAC = 0.5
_QOS_RESTORE_FRAC = 0.25

STATE_BASENAME = "serve_state.bin"

# cumulative latency reservoir cap: p50/p99 over the run, bounded memory
_MAX_LAT_SAMPLES = 100_000
# tick-event cadence (every Nth pump emits the counters/latency record)
_TICK_EVERY = 25


def _int_env(name, default):
    try:
        v = int(os.environ.get(name, default))
        return v if v > 0 else default
    except ValueError:
        return default


class ServeLadder:
    """Host-side occupancy-ladder policy: which rung should this tick
    dispatch, and is a shrink worth a cold program?

    The serve twin of the predictive scheduling policy. Growth is
    mandatory (every leased slot must ride the dispatch); shrink below the
    current rung is approved only after ``hold`` consecutive ticks of the
    live high-water mark sitting under the smaller rung AND (in ``auto``)
    a positive pricing verdict: predicted dead-lane saving over ``horizon``
    ticks vs the compile cost of the target rung if it is cold. Evidence
    comes first from this process's own per-width dispatch timings, then
    from the persistent cost store (keyed under the serve shape so
    tick costs never merge with training epochs); with NO evidence the
    policy holds the current (maximum) rung — the bit-identical
    empty-store fallback.
    """

    def __init__(self, capacity, mode=None, min_rung=MIN_RUNG, hold=None,
                 horizon=None, shape_key="serve", precision="f32"):
        mode = (mode if mode is not None
                else os.environ.get(ENV_LADDER, DEFAULT_LADDER))
        mode = str(mode).lower()
        if mode not in LADDER_MODES:
            raise ValueError(
                f"{ENV_LADDER} must be one of {LADDER_MODES}, got {mode!r}")
        self.mode = mode
        self.capacity = int(capacity)
        self.min_rung = max(1, min(int(min_rung), self.capacity))
        self.hold = int(hold if hold is not None
                        else _int_env(ENV_LADDER_HOLD, DEFAULT_LADDER_HOLD))
        self.horizon = int(horizon if horizon is not None
                           else _int_env(ENV_LADDER_HORIZON,
                                         DEFAULT_LADDER_HORIZON))
        self.shape_key = shape_key
        self.precision = precision
        self._obs = {}          # width -> [steady ticks, total ms]
        self._compile_obs = {}  # width -> measured first-dispatch skew ms
        self._below = 0         # consecutive ticks want < current
        self._store = None
        self._store_loaded = False

    def target(self, live_hi):
        """The rung ``live_hi`` leased lanes want under this mode."""
        if self.mode == "off":
            return self.capacity
        return _compaction.serve_rung(live_hi, self.capacity, self.min_rung)

    # ------------------------------------------------------------ evidence
    def observe(self, width, ms, cold):
        """Fold one dispatch's wall ms into the per-width accumulators.
        A cold dispatch carries the compile skew (measured far above steady
        state): it is recorded as compile evidence, never averaged into the
        steady tick cost (the rows_from_dispatch_stats discipline)."""
        if cold:
            base = self._steady_ms(width)
            self._compile_obs[width] = max(
                0.0, float(ms) - (base if base is not None else 0.0))
        else:
            o = self._obs.setdefault(int(width), [0, 0.0])
            o[0] += 1
            o[1] += float(ms)

    def _steady_ms(self, width):
        o = self._obs.get(int(width))
        if o and o[0]:
            return o[1] / o[0]
        return None

    def _cost_model(self):
        if not self._store_loaded:
            self._store_loaded = True
            try:
                from redcliff_tpu_torch.obs import costmodel as _costmodel
                self._store = _costmodel.load(None)
            except Exception:
                self._store = None
        return self._store

    def tick_ms(self, width, platform=None):
        """Best per-tick wall estimate at a width: exact local mean, else
        the nearest locally measured width scaled per-lane, else the
        persistent store, else None (no evidence)."""
        exact = self._steady_ms(width)
        if exact is not None:
            return exact
        near = [(abs(w - width), w) for w, o in self._obs.items() if o[0]]
        if near:
            _, w = min(near)
            return self._steady_ms(w) * (float(width) / w)
        cm = self._cost_model()
        if cm is not None:
            return cm.predict_epoch_ms(self.shape_key, width,
                                       platform=platform,
                                       precision=self.precision)
        return None

    def compile_ms(self, width, platform=None):
        """Predicted cost of compiling the rung cold: exact local
        measurement, else the store, else the nearest locally measured
        compile (compile cost tracks the program, not the lane count),
        else None."""
        if int(width) in self._compile_obs:
            return self._compile_obs[int(width)]
        cm = self._cost_model()
        if cm is not None:
            est = cm.predict_compile_ms(self.shape_key, width,
                                        platform=platform,
                                        precision=self.precision)
            if est is not None:
                return est
        if self._compile_obs:
            _, w = min((abs(w - width), w) for w in self._compile_obs)
            return self._compile_obs[w]
        return None

    # ------------------------------------------------------------ the verdict
    def decide(self, live_hi, current, cold_fn, platform=None):
        """One tick's rung decision at the tick boundary.

        Returns ``(new_width, event)`` where event is a dict for the
        ``serve_ladder`` record (None when nothing noteworthy happened —
        steady-state holds are silent; priced holds/fallbacks emit once per
        hysteresis episode, not per tick).
        """
        if self.mode == "off":
            return self.capacity, None
        want = self.target(live_hi)
        if want > current:
            # growth is correctness, not economics: a leased slot beyond
            # the rung would never be dispatched
            self._below = 0
            return want, {"kind": "grow", "from_width": current,
                          "to_width": want, "live": int(live_hi),
                          "cold": bool(cold_fn(want))}
        if want == current:
            self._below = 0
            return current, None
        self._below += 1
        if self._below < self.hold:
            return current, None
        first = self._below == self.hold
        if self.mode == "force":
            self._below = 0
            return want, {"kind": "shrink", "from_width": current,
                          "to_width": want, "live": int(live_hi),
                          "cold": bool(cold_fn(want)), "reason": "forced"}
        cur_ms = self.tick_ms(current, platform)
        if cur_ms is None:
            # empty store + no local evidence: hold the current (maximum)
            # rung — the bit-identical always-max fallback
            ev = {"kind": "fallback", "from_width": current,
                  "to_width": current, "live": int(live_hi),
                  "reason": "no_evidence"} if first else None
            return current, ev
        want_ms = self.tick_ms(want, platform)
        if want_ms is None:
            # per-lane-proportional prior off the measured rung
            want_ms = cur_ms * (float(want) / current)
        saving = max(0.0, cur_ms - want_ms) * self.horizon
        cold = bool(cold_fn(want))
        comp = 0.0 if not cold else self.compile_ms(want, platform)
        if comp is None:
            ev = {"kind": "fallback", "from_width": current,
                  "to_width": current, "live": int(live_hi),
                  "reason": "compile_unpriceable"} if first else None
            return current, ev
        if saving > comp:
            self._below = 0
            return want, {"kind": "shrink", "from_width": current,
                          "to_width": want, "live": int(live_hi),
                          "cold": cold, "saving_ms": round(saving, 3),
                          "compile_ms": round(comp, 3),
                          "horizon_ticks": self.horizon}
        ev = {"kind": "hold", "from_width": current, "to_width": want,
              "live": int(live_hi), "saving_ms": round(saving, 3),
              "compile_ms": round(comp, 3), "horizon_ticks": self.horizon,
              "reason": "not_worth_compile"} if first else None
        return current, ev

    def rows(self):
        """This process's per-width observations as cost-store rows
        (folded into the persistent store at stop — the next server's
        shrink pricing starts warm)."""
        rows = []
        for w in sorted(set(self._obs) | set(self._compile_obs)):
            n, tot = self._obs.get(w, (0, 0.0))
            comp = self._compile_obs.get(w)
            if not n and comp is None:
                continue
            rows.append({"shape": self.shape_key, "g_bucket": int(w),
                         "precision": self.precision,
                         "epochs": int(n), "epoch_ms": float(tot),
                         "compiles": 1 if comp is not None else 0,
                         "compile_ms": float(comp or 0.0)})
        return rows


class ServeService:
    """One serving process: slot table + sessions + queues + telemetry.

    All public methods accept an explicit ``now`` (tests and the chaos
    harness drive virtual clocks); wall time is only the default. Public
    methods are serialized on an internal lock; ``pump``/``run_loop`` must
    be driven from one thread (the engine owns device state).
    """

    def __init__(self, model, params, root=None, capacity=None,
                 lease_s=None, resume=True, precision_mode=None,
                 ladder=None, fuse=None, device=None):
        from redcliff_tpu_torch.serve.engine import StreamEngine

        self.capacity = int(capacity if capacity is not None
                            else _int_env(ENV_SLOTS, DEFAULT_SLOTS))
        self.ingest_cap = _int_env(ENV_INGEST_CAP, DEFAULT_INGEST_CAP)
        self.out_cap = _int_env(ENV_OUT_CAP, DEFAULT_OUT_CAP)
        self.root = root
        self._mu = threading.RLock()
        self.precision_mode = check_precision_mode(
            precision_mode if precision_mode is not None
            else os.environ.get(ENV_PRECISION, "f32"))
        self.engine = StreamEngine(model, params, self.capacity,
                                   precision_mode=self.precision_mode,
                                   device=device)
        self.fuse = max(1, int(fuse if fuse is not None
                               else _int_env(ENV_FUSE, DEFAULT_FUSE)))
        # serve-prefixed shape key: tick costs bucket separately from any
        # training epochs of the same model geometry
        shape_key = (f"serve|c{self.engine.num_chans}"
                     f"l{self.engine.window_len}k{self.engine.num_factors}")
        self.ladder = ServeLadder(
            self.capacity, mode=ladder, shape_key=shape_key,
            precision=precision_label(self.precision_mode))
        self._demote_storm = _int_env(ENV_DEMOTE_STORM, DEFAULT_DEMOTE_STORM)
        self._demote_window = _int_env(ENV_DEMOTE_WINDOW,
                                       DEFAULT_DEMOTE_WINDOW)
        self._poison_ticks = deque()
        self.registry = _session.SessionRegistry(self.capacity,
                                                 lease_s=lease_s)
        self.pending = {}    # sid -> deque[(sample (C,), t_enq)]
        self.out = {}        # sid -> deque[record]
        self.drops = {}      # sid -> slow-consumer drops
        self._answered = {}  # sid -> answered-sample count (cadence basis)
        self._lat_ms = []
        self._fused_samples = 0
        self._fuse_hist = {}  # per-stream fused take -> dispatch count
        # while run_loop runs, the thread that owns the engine's device
        # state; lane resets asked for on other threads wait in _resets
        self._owner = None
        self._resets = []
        self.ticks = 0
        self.dispatches = 0
        self.samples_in = 0
        self.samples_out = 0
        self.rejects = 0
        self._draining = False
        self._stopped = False
        self._log = MetricLogger(root)
        resumed = 0
        if resume and root is not None:
            resumed = self._try_resume()
        self._log.log("serve", kind="start", capacity=self.capacity,
                      streams=len(self.registry.sessions), resumed=resumed,
                      width=self.engine.width, mode=self.ladder.mode,
                      fuse=self.fuse,
                      precision_mode=self.engine.precision_mode,
                      model_class=type(model).__name__)

    # ------------------------------------------------------------ loading
    @classmethod
    def from_artifact(cls, path, device=None, **kw):
        """Serve a fitted artifact: ``path`` is a run dir or artifact file
        (eval/model_io.py)."""
        from redcliff_tpu_torch.eval.model_io import load_model_for_eval

        model, params = load_model_for_eval(path, device=device)
        return cls(model, params, device=device, **kw)

    # ------------------------------------------------------------ admission
    def connect(self, sid=None, now=None):
        """Admit a new subscriber stream: lease a slot, reset its lane,
        mint its trace_id. Raises :class:`SlotsExhausted` (with the
        soonest-lease-expiry ETA) when the table is full."""
        now = time.time() if now is None else float(now)
        with self._mu:
            try:
                sess = self.registry.connect(sid=sid, now=now)
            except SlotsExhausted as e:
                self.rejects += 1
                self._log.log("serve", kind="reject", eta_s=e.eta_s,
                              capacity=self.capacity, reason=e.reason)
                raise
            self._reset_lane(sess.slot)
            self.pending[sess.sid] = deque()
            self.out[sess.sid] = deque()
            self.drops[sess.sid] = 0
            self._answered[sess.sid] = 0
            self._log.log("session", kind="connect", sid=sess.sid,
                          slot=sess.slot, trace_id=sess.trace_id,
                          lease_s=self.registry.lease_s)
            return {"sid": sess.sid, "slot": sess.slot,
                    "trace_id": sess.trace_id}

    def disconnect(self, sid):
        """Close a stream and recycle its slot. Unknown sid is a no-op
        (double-disconnect races are normal under churn)."""
        with self._mu:
            sess = self.registry.disconnect(sid)
            if sess is None:
                return None
            self._recycle(sess, kind="disconnect")
            return sess.state

    def _reset_lane(self, slot):
        """Zero one lane now, or — while ``run_loop`` runs and this is not
        its dispatch thread — at the start of the next dispatch."""
        if self._owner is None or self._owner == threading.get_ident():
            self.engine.reset_slot(slot)
        else:
            self._resets.append(slot)

    def _apply_resets(self):
        """The lane resets queued by other threads, on the owning
        thread."""
        while self._resets:
            self.engine.reset_slot(self._resets.pop(0))

    def _recycle(self, sess, kind):
        """Free one lane after a terminal transition: reset exactly that
        lane, drop its queues, emit the lifecycle + recycle pair."""
        self._reset_lane(sess.slot)
        self.pending.pop(sess.sid, None)
        undelivered = len(self.out.pop(sess.sid, ()) or ())
        self.drops.pop(sess.sid, None)
        self._answered.pop(sess.sid, None)
        self._log.log("session", kind=kind, sid=sess.sid, slot=sess.slot,
                      trace_id=sess.trace_id, samples_in=sess.samples_in,
                      samples_out=sess.samples_out, state=sess.state,
                      undelivered=undelivered)
        self._log.log("session", kind="recycle", sid=sess.sid,
                      slot=sess.slot, trace_id=sess.trace_id)

    # ------------------------------------------------------------ ingest/poll
    def ingest(self, sid, sample, now=None):
        """Offer one sample to a stream. Returns a structured verdict dict
        (``accepted`` plus reason/backlog on refusal) — never raises for
        data problems; a contract violation quarantines that stream only."""
        now = time.time() if now is None else float(now)
        with self._mu:
            sess = self.registry.get(sid)
            if sess is None:
                return {"accepted": False, "reason": "unknown session"}
            self.registry.heartbeat(sid, now=now)
            if sess.state == _session.QUARANTINED:
                return {"accepted": False, "trace_id": sess.trace_id,
                        "reason": f"quarantined: {sess.quarantine_reason}"}
            arr = np.asarray(sample, dtype=np.float32)
            if arr.shape != (self.engine.num_chans,):
                self._quarantine(sess, f"shape violation: got "
                                 f"{tuple(arr.shape)}, want "
                                 f"({self.engine.num_chans},)", now)
                return {"accepted": False, "trace_id": sess.trace_id,
                        "reason": f"quarantined: "
                                  f"{sess.quarantine_reason}"}
            q = self.pending[sid]
            if len(q) >= self.ingest_cap:
                self._log.log("serve", kind="overflow", sid=sid,
                              trace_id=sess.trace_id, backlog=len(q))
                return {"accepted": False, "trace_id": sess.trace_id,
                        "reason": "backlog full", "backlog": len(q)}
            sess.samples_in += 1
            self.samples_in += 1
            q.append((arr, now))
            return {"accepted": True, "trace_id": sess.trace_id}

    def poll(self, sid, max_items=None, now=None):
        """Drain a stream's answered records (oldest first). Counts as a
        heartbeat. A quarantined stream's poll returns its structured error
        state as the final record."""
        now = time.time() if now is None else float(now)
        with self._mu:
            sess = self.registry.get(sid)
            if sess is None:
                return []
            self.registry.heartbeat(sid, now=now)
            q = self.out.get(sid)
            if q is None:
                return []
            n = len(q) if max_items is None else min(len(q), int(max_items))
            return [q.popleft() for _ in range(n)]

    # ------------------------------------------------------------ quarantine
    def _quarantine(self, sess, reason, now, extra=0):
        """ACTIVE -> QUARANTINED: pending samples are answered as error
        records (a drain must not strand them); ``extra`` covers samples
        already in the in-flight fused batch behind the poison — the lane's
        latch discarded them on the device, accounting answers them here.
        The lane's device state is never consulted again."""
        self.registry.quarantine(sess.sid, reason)
        q = self.pending.get(sess.sid)
        err = {"sid": sess.sid, "trace_id": sess.trace_id,
               "error": sess.quarantine_reason}
        outq = self.out.get(sess.sid)
        for _ in range(int(extra)):
            self._push_out(sess, outq, dict(err))
        while q:
            q.popleft()
            self._push_out(sess, outq, dict(err))
        self._push_out(sess, outq, dict(err))
        self._log.log("session", kind="quarantine", sid=sess.sid,
                      slot=sess.slot, trace_id=sess.trace_id, reason=reason)

    def _push_out(self, sess, outq, record):
        """Append to a stream's out-queue under the slow-consumer cap:
        past it, ITS oldest record drops (counted)."""
        if outq is None:
            return
        if len(outq) >= self.out_cap:
            outq.popleft()
            self.drops[sess.sid] = self.drops.get(sess.sid, 0) + 1
        outq.append(record)

    # ------------------------------------------------------------ the tick
    def _assemble(self, now):
        """Pop pending samples per ACTIVE stream into the tick batch at
        full capacity (the dispatcher slices to the rung); host numpy
        only. Fusion engages only when some stream has real backlog —
        otherwise depth is 1 and the single-tick advance runs. Returns
        ``(samples (S, F, C), arrive (S, F), meta, depth)``; meta maps
        slot -> (sid, [t_enq, ...])."""
        S, C = self.capacity, self.engine.num_chans
        depth = 1
        if self.fuse > 1:
            for sess in self.registry.live():
                if sess.state == _session.ACTIVE and \
                        len(self.pending.get(sess.sid) or ()) > 1:
                    depth = self.fuse
                    break
        samples = np.zeros((S, depth, C), dtype=np.float32)
        arrive = np.zeros((S, depth), dtype=bool)
        meta = {}
        for sess in self.registry.live():
            if sess.state != _session.ACTIVE:
                continue
            q = self.pending.get(sess.sid)
            if not q:
                continue
            ts = []
            for f in range(min(len(q), depth)):
                sample, t_enq = q.popleft()
                samples[sess.slot, f] = sample
                arrive[sess.slot, f] = True
                ts.append(t_enq)
            meta[sess.slot] = (sess.sid, ts)
        return samples, arrive, meta, depth

    def _live_hi(self):
        """Live high-water mark: 1 + the highest leased slot (ACTIVE and
        QUARANTINED both hold lanes). The rung must cover every leased
        slot."""
        return 1 + max((s.slot for s in self.registry.sessions.values()),
                       default=-1)

    def _ladder_tick(self, now, floor=0):
        """Run the rung policy at the tick boundary; resize + emit on a
        decision. ``floor`` covers slots already assembled into the
        in-flight batch (a disconnect between assemble and dispatch must
        not shrink them out from under the distribute)."""
        hi = max(self._live_hi(), int(floor))
        cur = self.engine.width
        new, ev = self.ladder.decide(hi, cur, self.engine.is_cold,
                                     self.engine.platform)
        if new != cur:
            self.engine.resize(new)
        if ev is not None:
            self._log.log("serve_ladder", capacity=self.capacity,
                          mode=self.ladder.mode, ticks=self.ticks, **ev)

    def _distribute(self, out, meta, depth, now):
        """Turn one dispatch's lane outputs into per-stream records. A
        fused dispatch carries a leading F axis; element f of lane s equals
        the f-th sequential single-tick dispatch, so the record stream is
        independent of fuse depth. Graph cadence keys off the per-stream
        answered counter, so the QoS ladder composes with fusion
        unchanged."""
        fused = depth > 1
        for slot, (sid, t_enqs) in meta.items():
            sess = self.registry.get(sid)
            if sess is None:      # reaped between assemble and distribute
                continue
            for f, t_enq in enumerate(t_enqs):
                if fused:
                    poison_hit = out["poison_hit"][f, slot]
                    ready = out["ready"][f, slot]
                else:
                    poison_hit = out["poison_hit"][slot]
                    ready = out["ready"][slot]
                if poison_hit:
                    self._poison_ticks.append(self.ticks)
                    self._quarantine(sess, "non-finite sample", now,
                                     extra=len(t_enqs) - f - 1)
                    break
                if not ready:
                    # warmup: the ring is not full yet
                    continue
                self._answered[sid] = self._answered.get(sid, 0) + 1
                cadence = QOS_CADENCE[min(sess.qos_rung,
                                          len(QOS_CADENCE) - 1)]
                lat_ms = max(0.0, (now - t_enq) * 1e3)
                scores = out["scores"][f, slot] if fused \
                    else out["scores"][slot]
                rec = {"sid": sid, "trace_id": sess.trace_id,
                       "seq": self._answered[sid],
                       "scores": np.array(scores, copy=True),
                       "latency_ms": lat_ms}
                if (self._answered[sid] - 1) % cadence == 0:
                    graph = out["graph"][f, slot] if fused \
                        else out["graph"][slot]
                    rec["graph"] = np.array(graph, copy=True)
                self._push_out(sess, self.out.get(sid), rec)
                sess.samples_out += 1
                self.samples_out += 1
                if len(self._lat_ms) < _MAX_LAT_SAMPLES:
                    self._lat_ms.append(lat_ms)

    def _maybe_demote(self, now):
        """The poisoned-lane-storm sentinel: ``storm`` quarantines by NaN
        inside ``window`` ticks demote the whole table from mixed to f32.
        Recorded in the drain checkpoint and honoured at resume — never
        silently re-promoted."""
        if self.engine.precision_mode != "mixed" or self.engine.demoted:
            return
        w = self._demote_window
        while self._poison_ticks and self._poison_ticks[0] <= self.ticks - w:
            self._poison_ticks.popleft()
        if len(self._poison_ticks) < self._demote_storm:
            return
        self.engine.demote()
        self._log.log("precision", kind="demote", scope="serve",
                      lanes_poisoned=len(self._poison_ticks),
                      window_ticks=w, ticks=self.ticks,
                      cause="poisoned-lane storm", mode_from="mixed",
                      mode_to="f32")

    def _update_qos(self, now):
        """Per-stream backlog ladder with hysteresis; emits only rung
        changes. One greedy subscriber demotes alone."""
        demote_at = self.ingest_cap * _QOS_DEMOTE_FRAC
        restore_at = self.ingest_cap * _QOS_RESTORE_FRAC
        top = len(QOS_CADENCE) - 1
        for sess in self.registry.live():
            if sess.state != _session.ACTIVE:
                continue
            backlog = len(self.pending.get(sess.sid, ()))
            if backlog >= demote_at and sess.qos_rung < top:
                frm = sess.qos_rung
                sess.qos_rung += 1
                self._log.log("serve", kind="qos", sid=sess.sid,
                              trace_id=sess.trace_id, rung=sess.qos_rung,
                              from_rung=frm, backlog=backlog,
                              cadence=QOS_CADENCE[sess.qos_rung],
                              reason="backlog")
            elif backlog <= restore_at and sess.qos_rung > 0:
                frm = sess.qos_rung
                sess.qos_rung = 0
                self._log.log("serve", kind="qos", sid=sess.sid,
                              trace_id=sess.trace_id, rung=0, from_rung=frm,
                              backlog=backlog, cadence=QOS_CADENCE[0],
                              reason="recovered")

    def _reap(self, now):
        for sess in self.registry.reap(now=now):
            self._recycle(sess, kind="expire")

    def _dispatch_tick(self, samples, arrive, meta, depth, now, wall):
        """The shared back half of a tick: queued lane resets, ladder
        decision, ONE dispatch at the rung, distribute, sentinels,
        counters. ``samples``/``arrive`` are full-capacity; the rung slice
        is a view."""
        with self._mu:
            self._apply_resets()
            floor = 1 + max(meta, default=-1)
            self._ladder_tick(now, floor=floor)
            W = self.engine.width
        answered = 0
        out = None
        if meta:
            cold = self.engine.is_cold(W, depth)
            t0 = time.perf_counter()
            with _obs.span("serve.dispatch", component="serve"):
                if depth > 1:
                    out = self.engine.step_fused(samples[:W], arrive[:W])
                else:
                    out = self.engine.step(samples[:W, 0], arrive[:W, 0])
            ms = (time.perf_counter() - t0) * 1e3
        with self._mu:
            if out is not None:
                self.dispatches += 1
                self.ladder.observe(W, ms, cold)
                if depth > 1:
                    self._fused_samples += int(arrive[:W].sum())
                for _slot, (_sid, ts) in meta.items():
                    self._fuse_hist[len(ts)] = \
                        self._fuse_hist.get(len(ts), 0) + 1
                before = self.samples_out
                # on the real clock, latency charges the dispatch that just
                # ran; a virtual clock stays as given (deterministic replay)
                self._distribute(out, meta, depth,
                                 time.time() if wall else now)
                answered = self.samples_out - before
                self._maybe_demote(now)
            self._update_qos(now)
            self.ticks += 1
            if self.ticks % _TICK_EVERY == 0:
                self._emit_tick()
        return answered

    def pump(self, now=None):
        """One synchronous tick. Returns the number of samples answered."""
        wall = now is None
        now = time.time() if wall else float(now)
        with self._mu:
            self._reap(now)
            samples, arrive, meta, depth = self._assemble(now)
        return self._dispatch_tick(samples, arrive, meta, depth, now, wall)

    def _emit_tick(self):
        dist = {}
        if self._lat_ms:
            # one sort of the reservoir for both ranks (the JAX service
            # sorts it once per percentile)
            p50, p99 = _slo.percentiles(self._lat_ms, (50.0, 99.0))
            dist = {"p50_ms": p50, "p99_ms": p99}
        self._log.log("serve", kind="tick", ticks=self.ticks,
                      streams=len(self.registry.sessions),
                      free_slots=self.registry.free_slots(),
                      width=self.engine.width,
                      live=self._live_hi(),
                      samples_in=self.samples_in,
                      samples_out=self.samples_out,
                      fused_samples=self._fused_samples,
                      rejects=self.rejects,
                      dropped=sum(self.drops.values()),
                      n=len(self._lat_ms), **dist)
        if self.fuse > 1:
            self._log.log("serve_fuse", kind="stats", depth=self.fuse,
                          fused_samples=self._fused_samples,
                          hist={str(k): v for k, v
                                in sorted(self._fuse_hist.items())},
                          ticks=self.ticks)

    # ------------------------------------------------------------ the loop
    def run_loop(self, max_ticks=None, interval_s=0.0, depth=2):
        """Drive ticks through the double-buffered prefetch pipeline:
        reaping and assembly of tick t+1 (prefetch thread, host numpy only)
        overlap the engine dispatch of tick t (this thread, which owns the
        device state: lane resets asked for elsewhere meanwhile wait for
        it). Runs until ``max_ticks`` or a drain request; batches already
        assembled are dispatched, never dropped, then :meth:`drain`
        finishes the remaining backlog synchronously."""
        from redcliff_tpu_torch.data.pipeline import prefetch_batches

        def assembly():
            n = 0
            while not self._draining:
                if max_ticks is not None and n >= max_ticks:
                    return
                now = time.time()
                with self._mu:
                    self._reap(now)
                    batch = self._assemble(now)
                yield batch + (now,)
                n += 1
                if interval_s:
                    time.sleep(interval_s)

        self._owner = threading.get_ident()
        try:
            src = prefetch_batches(assembly(), depth=depth)
            # exhaust the stream: on drain the generator stops producing
            # and this loop dispatches every batch already buffered
            # (samples popped from pending must be answered, not lost)
            for samples, arrive, meta, fdepth, _t_asm in src:
                self._dispatch_tick(samples, arrive, meta, fdepth,
                                    time.time(), True)
            src.close()
        finally:
            with self._mu:
                self._owner = None
                self._apply_resets()
        if self._draining:
            self.drain()

    # ------------------------------------------------------------ drain/stop
    def drain(self, now=None):
        """Answer every in-flight sample, checkpoint every session, stop.
        Zero loss: live streams' pending queues pump to empty; undelivered
        out-queues persist into the drain checkpoint. Returns the
        checkpoint path (None without a root)."""
        now = time.time() if now is None else float(now)
        self._draining = True
        # bounded by total backlog: each pump answers >= 1 sample while any
        # ACTIVE stream has pending work (warmup samples count as progress
        # via their state advance)
        guard = self.capacity * self.ingest_cap + len(self.registry.sessions)
        while guard >= 0 and any(
                self.pending.get(s.sid)
                for s in self.registry.live()
                if s.state == _session.ACTIVE):
            self.pump(now=now)
            guard -= 1
        path = self._checkpoint()
        dist = {}
        if self._lat_ms:
            dist = {"p50_ms": _slo.percentile(self._lat_ms, 50.0),
                    "p99_ms": _slo.percentile(self._lat_ms, 99.0),
                    "n": len(self._lat_ms)}
        self._log.log("serve", kind="drain", ticks=self.ticks,
                      streams=len(self.registry.sessions),
                      width=self.engine.width,
                      samples_in=self.samples_in,
                      samples_out=self.samples_out,
                      fused_samples=self._fused_samples,
                      rejects=self.rejects,
                      dropped=sum(self.drops.values()),
                      undelivered=sum(len(q) for q in self.out.values()),
                      checkpoint=path, **dist)
        self.stop()
        return path

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        self._fold_cost_store()
        self._log.log("serve", kind="stop", ticks=self.ticks,
                      samples_out=self.samples_out)
        self._log.close()

    def _fold_cost_store(self):
        """Fold this process's per-rung tick and first-dispatch
        observations into the persistent cost store (when one is
        configured): the next server's first shrink decision prices
        against real evidence instead of holding the maximum rung."""
        try:
            from redcliff_tpu_torch.obs import costmodel as _costmodel
            if _costmodel.store_path(None) is None:
                return
            rows = self.ladder.rows()
            if rows:
                _costmodel.update_store(None, rows, self.engine.platform)
        except Exception:  # noqa: BLE001 — telemetry never fails a drain
            pass

    def request_drain(self):
        """Async-signal-safe drain request: the running loop (or the next
        explicit ``drain()`` caller) completes it."""
        self._draining = True

    def install_signal_handlers(self):
        """SIGTERM/SIGINT -> graceful drain request."""
        def _h(signum, frame):
            self.request_drain()
        signal.signal(signal.SIGTERM, _h)
        signal.signal(signal.SIGINT, _h)

    # ------------------------------------------------------------ durability
    def _state_path(self):
        return os.path.join(self.root, STATE_BASENAME) \
            if self.root is not None else None

    def _checkpoint(self):
        path = self._state_path()
        if path is None:
            return None
        with self._mu:
            self._apply_resets()
            payload = {
                "registry": self.registry.snapshot(),
                "engine": self.engine.export_state(),
                "ladder": {"width": self.engine.width,
                           "capacity": self.capacity,
                           "mode": self.ladder.mode},
                "precision": {"mode": self.engine.precision_mode,
                              "demoted": self.engine.demoted},
                "out": {sid: list(q) for sid, q in self.out.items()},
                "answered": dict(self._answered),
                "drops": dict(self.drops),
                "counters": {"ticks": self.ticks,
                             "dispatches": self.dispatches,
                             "samples_in": self.samples_in,
                             "samples_out": self.samples_out,
                             "fused_samples": self._fused_samples,
                             "rejects": self.rejects},
            }
        os.makedirs(self.root, exist_ok=True)
        write_checkpoint(path, payload)
        return path

    def _try_resume(self):
        path = self._state_path()
        payload, _src = load_checkpoint(path)
        if payload is None:
            return 0
        now = time.time()
        prec = payload.get("precision") or {}
        if prec.get("demoted") and self.engine.precision_mode == "mixed" \
                and not self.engine.demoted:
            # a storm-demoted table never silently re-promotes on restart
            self.engine.demote()
            self._log.log("precision", kind="resume_demoted", scope="serve",
                          cause="checkpoint recorded demotion",
                          mode_from="mixed", mode_to="f32")
        eng_snap = payload["engine"]
        ck_width = int(np.asarray(eng_snap["window"]).shape[0])
        snap_reg = payload["registry"]
        if int(snap_reg["capacity"]) == self.capacity:
            self.registry = _session.SessionRegistry.from_snapshot(
                snap_reg, now=now)
            # restore straight into the recorded rung; the ladder takes
            # over from there at the first pump
            self.engine.resize(min(max(ck_width, 1), self.capacity))
            self.engine.import_state(eng_snap)
        else:
            self._resume_repack(snap_reg, eng_snap, ck_width, now)
        self.out = {sid: deque(v) for sid, v in payload["out"].items()}
        self._answered = dict(payload.get("answered", {}))
        self.drops = dict(payload.get("drops", {}))
        c = payload.get("counters", {})
        self.ticks = int(c.get("ticks", 0))
        self.dispatches = int(c.get("dispatches", 0))
        self.samples_in = int(c.get("samples_in", 0))
        self.samples_out = int(c.get("samples_out", 0))
        self._fused_samples = int(c.get("fused_samples", 0))
        self.rejects = int(c.get("rejects", 0))
        for sess in self.registry.live():
            self.pending.setdefault(sess.sid, deque())
            self.out.setdefault(sess.sid, deque())
            self.drops.setdefault(sess.sid, 0)
            self._answered.setdefault(sess.sid, 0)
            self._log.log("session", kind="resume", sid=sess.sid,
                          slot=sess.slot, trace_id=sess.trace_id,
                          state=sess.state,
                          samples_out=sess.samples_out)
        self._log.log("serve", kind="resume",
                      streams=len(self.registry.sessions),
                      width=self.engine.width,
                      ticks=self.ticks, checkpoint=path)
        return len(self.registry.sessions)

    def _resume_repack(self, snap_reg, eng_snap, ck_width, now):
        """Cross-geometry resume: re-pack live lanes into THIS table
        instead of failing the shape check. Lanes pack dense from slot 0 in
        checkpoint-slot order (relative order kept), the registry's free
        pool is re-seeded above them, and the engine restores row by row
        through ``import_state(slot_map=...)``. Only a table too small for
        the live streams refuses, naming both geometries."""
        sess_dicts = sorted(snap_reg["sessions"], key=lambda d: d["slot"])
        n = len(sess_dicts)
        if n > self.capacity:
            raise ValueError(
                f"serve resume geometry mismatch: checkpoint capacity "
                f"{int(snap_reg['capacity'])} (rung {ck_width}, {n} live "
                f"streams) vs engine capacity {self.capacity} — {n} live "
                f"streams do not fit the new table; grow capacity or drain "
                f"sessions before resizing")
        reg = _session.SessionRegistry(self.capacity,
                                       lease_s=snap_reg.get("lease_s"))
        slot_map = {}
        for new, d in enumerate(sess_dicts):
            sess = _session.Session.from_dict(d)
            slot_map[int(d["slot"])] = new
            sess.slot = new
            sess.lease_expires_at = now + reg.lease_s
            reg.sessions[sess.sid] = sess
        reg._free = list(range(self.capacity - 1, n - 1, -1))
        self.registry = reg
        width = self.ladder.target(n)
        self.engine.resize(width)
        self.engine.import_state(eng_snap, slot_map=slot_map)
        self._log.log("serve_ladder", kind="repack", from_width=ck_width,
                      to_width=width, live=n, capacity=self.capacity,
                      from_capacity=int(snap_reg["capacity"]),
                      mode=self.ladder.mode, streams=n)
