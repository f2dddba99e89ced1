"""Seeded chaos harness for the serve plane: churn, poison, slow consumers
(the port's copy of ``redcliff_tpu/serve/chaos.py``, on the port's
admission module, plus :func:`max_abs_difference`).

The serving twin of fleet/chaos.py: every storm is a deterministic function
of its seed, so a failure reproduces exactly. Three adversaries, composable
in one storm:

- **connect/disconnect churn** — short-lived sessions lease, stream, and
  vanish every few ticks (some by disconnect, some by silent lease expiry),
  exercising slot recycling under load;
- **NaN streams** — a fraction of chaos sessions stream non-finite samples,
  exercising per-stream quarantine;
- **slow consumers** — chaos sessions never poll, so their out-queues hit
  the cap and shed THEIR oldest records, exercising bounded-memory
  containment.

The headline check is :func:`churn_isolation_report`: run the same victim
streams twice — once interference-free, once inside a storm — and compare
every victim's answered records BYTE for byte. The slot-table engine's
row-independence makes this an equality, not a tolerance (the churn
isolation pin, tests/test_serve.py + the bench ``serve`` probe).

stdlib + numpy only, no torch (obs/schema.py ``--check`` lists it among
the modules that import nothing CUDA-specific): the harness drives a
service object; the service owns the device.
"""
from __future__ import annotations

import numpy as np

from redcliff_tpu_torch.runtime.admission import SlotsExhausted

__all__ = ["stream_samples", "drive", "make_churn_storm",
           "make_sawtooth_storm", "outputs_identical", "max_abs_difference",
           "churn_isolation_report"]


def stream_samples(seed, n, chans):
    """Deterministic victim signal: ``(n, chans)`` float32."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, chans)).astype(np.float32)


def drive(svc, victim_samples, ticks, chaos_fn=None, now0=0.0, dt=0.01):
    """Drive a service on a virtual clock: each tick ingests one pending
    sample per victim (while any remain), runs the chaos actor, pumps once,
    and polls every victim. Victims must already be connected (so their
    slot assignment precedes any churn). Returns ``{sid: [records...]}``.
    """
    fed = {sid: 0 for sid in victim_samples}
    results = {sid: [] for sid in victim_samples}
    now = float(now0)
    for t in range(int(ticks)):
        now += dt
        for sid, arr in victim_samples.items():
            i = fed[sid]
            if i < len(arr):
                verdict = svc.ingest(sid, arr[i], now=now)
                if verdict.get("accepted"):
                    fed[sid] = i + 1
        if chaos_fn is not None:
            chaos_fn(svc, t, now)
        svc.pump(now=now)
        for sid in victim_samples:
            results[sid].extend(svc.poll(sid, now=now))
    return results


def make_churn_storm(seed, chans, connect_p=0.6, nan_p=0.4,
                     lifetime=(1, 5), expire_p=0.25):
    """Build a seeded per-tick chaos actor for :func:`drive`.

    Each tick it retires due chaos sessions (mostly by disconnect; with
    probability ``expire_p`` by going silent and letting the lease reaper
    recycle the slot), connects a new one with probability ``connect_p``
    (poisoned — streaming NaNs — with probability ``nan_p``), and feeds
    every live chaos session one sample. Chaos sessions never poll: they
    are the slow consumers. ``SlotsExhausted`` rejections are expected
    under storm pressure and counted on ``storm.rejects``.
    """
    rng = np.random.default_rng(seed)
    live = {}   # sid -> [retire_tick, poisoned, abandon]

    def storm(svc, t, now):
        for sid in [s for s, v in live.items() if v[0] <= t]:
            if not live[sid][2]:
                svc.disconnect(sid)
            # abandoned sessions just stop heartbeating; the reaper takes
            # the slot back at lease expiry
            del live[sid]
        if rng.random() < connect_p:
            sid = f"chaos-{t}-{rng.integers(1 << 20)}"
            poisoned = bool(rng.random() < nan_p)
            abandon = bool(rng.random() < expire_p)
            span = int(rng.integers(lifetime[0], lifetime[1] + 1))
            try:
                svc.connect(sid=sid, now=now)
            except SlotsExhausted:
                storm.rejects += 1
            else:
                live[sid] = [t + span, poisoned, abandon]
        for sid, (_r, poisoned, abandon) in live.items():
            x = rng.normal(size=chans).astype(np.float32)
            if poisoned:
                x[int(rng.integers(chans))] = np.nan
            # abandoned sessions are silent from birth: no ingest means no
            # heartbeat, so only the lease reaper can recycle their slots
            if not abandon:
                svc.ingest(sid, x, now=now)

    storm.rejects = 0
    return storm


def make_sawtooth_storm(seed, chans, lo=0, hi=6, period=12, nan_p=0.0):
    """Seeded sawtooth-occupancy actor: chaos-session count rides a
    deterministic triangle wave between ``lo`` and ``hi`` with the given
    ``period`` (ticks per half-cycle), connecting on the upstroke and
    disconnecting newest-first on the downstroke. The occupancy-ladder
    adversary: every sweep drags the live high-water mark through multiple
    rungs, forcing grow -> shrink -> grow cycles while victims stream
    (tests/test_serve_elastic.py pins their bytes across the whole ride).
    Sample payloads (and optional NaN poisoning at ``nan_p``) come from the
    seeded rng, so a failure reproduces exactly."""
    rng = np.random.default_rng(seed)
    live = []   # connected chaos sids, connect order

    def target(t):
        phase = t % (2 * period)
        up = phase if phase < period else 2 * period - phase
        return lo + round((hi - lo) * up / period)

    def storm(svc, t, now):
        want = target(t)
        while len(live) > want:
            svc.disconnect(live.pop())
        while len(live) < want:
            sid = f"saw-{t}-{len(live)}"
            try:
                svc.connect(sid=sid, now=now)
            except SlotsExhausted:
                storm.rejects += 1
                break
            else:
                live.append(sid)
        for sid in live:
            x = rng.normal(size=chans).astype(np.float32)
            if nan_p and rng.random() < nan_p:
                x[int(rng.integers(chans))] = np.nan
            svc.ingest(sid, x, now=now)

    storm.rejects = 0
    storm.target = target
    return storm


def outputs_identical(a, b):
    """Byte-for-byte comparison of two :func:`drive` result maps (scores,
    graphs, seq; latency excluded — it is clock, not math). Returns
    ``(identical, n_compared, detail)``."""
    n = 0
    for sid in a:
        ra, rb = a[sid], b.get(sid)
        if rb is None or len(ra) != len(rb):
            return False, n, f"{sid}: record count {len(ra)} vs " \
                             f"{len(rb) if rb is not None else 'missing'}"
        for x, y in zip(ra, rb):
            n += 1
            if x.get("seq") != y.get("seq"):
                return False, n, f"{sid}: seq {x.get('seq')} vs " \
                                 f"{y.get('seq')}"
            xs = np.asarray(x["scores"])
            ys = np.asarray(y["scores"])
            if xs.tobytes() != ys.tobytes():
                return False, n, f"{sid}: scores diverge at seq " \
                                 f"{x.get('seq')}"
            if ("graph" in x) != ("graph" in y):
                return False, n, f"{sid}: graph cadence diverges at seq " \
                                 f"{x.get('seq')}"
            if "graph" in x and (np.asarray(x["graph"]).tobytes()
                                 != np.asarray(y["graph"]).tobytes()):
                return False, n, f"{sid}: graph diverges at seq " \
                                 f"{x.get('seq')}"
    return True, n, ""


def max_abs_difference(a, b):
    """The largest absolute difference between two :func:`drive` result
    maps over every record both hold scores (and graphs) for, in record
    order; ``inf`` when a count, a seq or the graph cadence differs. The
    tolerance twin of :func:`outputs_identical`, for comparisons where a
    matrix product's rounding may depend on the table's width (the port's
    ladder on torch's GEMMs)."""
    worst = 0.0
    for sid in a:
        ra, rb = a[sid], b.get(sid)
        if rb is None or len(ra) != len(rb):
            return float("inf")
        for x, y in zip(ra, rb):
            if x.get("seq") != y.get("seq") or ("graph" in x) != ("graph"
                                                               in y):
                return float("inf")
            if ("error" in x) != ("error" in y):
                return float("inf")
            for k in ("scores", "graph"):
                if k in x:
                    d = np.abs(np.asarray(x[k], dtype=np.float64)
                               - np.asarray(y[k], dtype=np.float64))
                    worst = max(worst, float(np.max(d)) if d.size else 0.0)
    return worst


def churn_isolation_report(make_service, chans, n_victims=2, n_samples=24,
                           seed=0, extra_ticks=8):
    """THE isolation check: same victims, with and without a storm;
    verdict is byte equality of every victim output.

    ``make_service`` constructs a fresh service (fresh slot table) per run
    — the two runs must not share device state. Returns a dict with
    ``identical`` (the pin), ``compared`` (records checked), ``rejects``
    (storm admission pressure), and ``detail`` on mismatch.
    """
    victims = {f"victim-{i}": stream_samples(seed + i, n_samples, chans)
               for i in range(n_victims)}
    ticks = n_samples + int(extra_ticks)

    def run(with_storm):
        svc = make_service()
        for sid in victims:
            svc.connect(sid=sid, now=0.0)
        storm = make_churn_storm(seed + 1000, chans) if with_storm else None
        res = drive(svc, victims, ticks, chaos_fn=storm)
        svc.stop()
        return res, (storm.rejects if storm else 0)

    clean, _ = run(False)
    stormy, rejects = run(True)
    identical, compared, detail = outputs_identical(clean, stormy)
    return {"identical": identical, "compared": compared,
            "rejects": rejects, "victims": n_victims, "detail": detail}
