"""Fleet service-level objectives from the request-lifecycle ledger
(the port's copy of ``redcliff_tpu/obs/slo.py``, function for function; the
one addition is :func:`percentiles`, several nearest ranks from one sort,
which the serve tick event uses).

A multi-tenant queue lives or dies by numbers no single run dir holds:
how long tenants WAIT (queue-wait percentiles), how fast submitted work
first touches a device (time-to-first-attempt), whether deadlines are met
(hit-rate), how much retry churn each request costs (attempts-per-request),
and how often requests die in containment (dead-letter rate). This module
computes all of them from the durable lifecycle ledger
(``<root>/history.jsonl``, fleet/history.py) — which survives worker
restarts and SIGKILL storms — per tenant and fleet-wide, and flags
threshold breaches via the ``REDCLIFF_SLO_*`` knobs.

Definitions (docs/ARCHITECTURE.md "Request lifecycle tracing & SLOs"):

* **queue_wait_s** — first EFFECTIVE ``claimed`` wall time −
  ``submitted_at``: how long the request sat before a worker picked it up
  and actually did something with the claim. A claim rolled back by a
  lease ``released`` transition before any attempt (an all-or-nothing
  batch-claim rollback, a budget-route back to the queue) does not end
  the wait — the request is back in line and the tenant is still waiting;
  a claim that reaches an attempt or a settle locks the wait in, and
  reclaims after that do not reset it;
* **ttfa_s** — earliest ``attempt.started_at`` − ``submitted_at``: time to
  the first supervised run actually starting (claim + plan + spawn);
* **deadline hit-rate** — among SETTLED requests submitted with a
  ``deadline_s``: settled ``done`` with (settle wall − ``submitted_at``)
  <= deadline. A request that finished late, failed, or was dead-lettered
  counts as a miss; an unsettled request is not yet judged, and a
  ``canceled`` request is excluded from the denominator entirely — a
  voluntary tenant cancel is not a service miss;
* **attempts_per_request** — mean total supervisor attempts per request
  over requests with at least one recorded ``attempt`` transition;
* **deadletter rate** — settled ``deadletter`` over all settled, percent.

The default view is ALL-TIME (every request the ledger ever saw — what
``obs report`` archives). ``compute_slo(records, window_s=...)`` instead
restricts the population to requests with lifecycle activity inside the
trailing window (last event wall time within ``window_s`` of the ledger's
newest wall) — the view the fleet autoscaler (fleet/autoscale.py) reacts
to, so a breach absorbed an hour ago cannot keep the pool inflated. The
windowed output carries ``window.window_s``/``window.cutoff_wall``; the
all-time output is bit-identical to what it was before windowing existed.

Percentiles are **nearest-rank** (p-th percentile of n sorted values =
value at rank ``ceil(p/100 * n)``): exact on small populations — a ledger
with known synthetic timings yields exactly predictable p50/p99 (pinned by
tests/test_fleet_obs.py), no interpolation surprises.

Requeued dead-letters re-enter the live population: a ``requeued``
transition clears the settled state, and the request's eventual re-settle
is judged afresh. Racing settle writers (the queue's converging-settle
discipline) may leave two ``settled`` transitions for one request — the
winner is the queue's fixed priority order (done > failed > deadletter >
canceled), mirroring what actually survives on disk.

Thresholds (each unset by default = no breach checking for that SLO)::

    REDCLIFF_SLO_QUEUE_P99_S      max acceptable queue-wait p99, seconds
    REDCLIFF_SLO_TTFA_P99_S       max acceptable time-to-first-attempt p99
    REDCLIFF_SLO_DEADLINE_PCT     min acceptable deadline hit-rate, percent
    REDCLIFF_SLO_DEADLETTER_PCT   max acceptable dead-letter rate, percent

**Serve SLOs.** The streaming inference service has its own
latency objective: per-sample ingest->answer latency, judged on the same
nearest-rank percentiles from the cumulative reservoir the service's
``serve`` kind=tick/drain events carry (``p50_ms``/``p99_ms``/``n``).
:func:`compute_serve_slo` folds a run dir's serve events into one block and
flags breaches of::

    REDCLIFF_SLO_SERVE_P50_MS     max acceptable per-sample p50, milliseconds
    REDCLIFF_SLO_SERVE_P99_MS     max acceptable per-sample p99, milliseconds

stdlib only, no jax (obs/schema.py ``--check`` enforces it): SLO math runs
in observer processes that must never initialize a backend.
"""
from __future__ import annotations

import math
import os

__all__ = ["percentile", "percentiles", "compute_slo", "slo_for_root",
           "thresholds_from_env", "ENV_QUEUE_P99_S", "ENV_TTFA_P99_S",
           "ENV_DEADLINE_PCT", "ENV_DEADLETTER_PCT",
           "compute_serve_slo", "serve_thresholds_from_env",
           "ENV_SERVE_P50_MS", "ENV_SERVE_P99_MS"]

ENV_QUEUE_P99_S = "REDCLIFF_SLO_QUEUE_P99_S"
ENV_TTFA_P99_S = "REDCLIFF_SLO_TTFA_P99_S"
ENV_DEADLINE_PCT = "REDCLIFF_SLO_DEADLINE_PCT"
ENV_DEADLETTER_PCT = "REDCLIFF_SLO_DEADLETTER_PCT"
ENV_SERVE_P50_MS = "REDCLIFF_SLO_SERVE_P50_MS"
ENV_SERVE_P99_MS = "REDCLIFF_SLO_SERVE_P99_MS"

# the queue's converging-settle priority (fleet/queue.py TERMINAL_STATES):
# when racing writers recorded two settles, this is the one that survived
_STATE_PRIORITY = ("done", "failed", "deadletter", "canceled")


def percentile(values, p):
    """Nearest-rank percentile: the value at rank ``ceil(p/100 * n)`` of
    the sorted population (p in (0, 100]). Exact — never interpolates —
    so known synthetic timings yield exactly predictable results. None on
    an empty population."""
    if not values:
        return None
    ordered = sorted(values)
    rank = min(max(int(math.ceil(p / 100.0 * len(ordered))), 1),
               len(ordered))
    return ordered[rank - 1]


def percentiles(values, ps):
    """:func:`percentile` at each of ``ps``, from one sort of ``values``
    (a list, one entry per p; None each on an empty population)."""
    if not values:
        return [None] * len(ps)
    ordered = sorted(values)
    n = len(ordered)
    return [ordered[min(max(int(math.ceil(p / 100.0 * n)), 1), n) - 1]
            for p in ps]


def _env_float(name):
    raw = os.environ.get(name)
    if raw is None or not str(raw).strip():
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def thresholds_from_env():
    """The breach thresholds from the ``REDCLIFF_SLO_*`` env knobs (None =
    that SLO is not checked)."""
    return {
        "queue_p99_s": _env_float(ENV_QUEUE_P99_S),
        "ttfa_p99_s": _env_float(ENV_TTFA_P99_S),
        "deadline_hit_pct": _env_float(ENV_DEADLINE_PCT),
        "deadletter_pct": _env_float(ENV_DEADLETTER_PCT),
    }


def _wall(rec):
    wt = rec.get("wall_time")
    return wt if isinstance(wt, (int, float)) else None


def _requests_from_history(records):
    """Fold the lifecycle ledger into per-request summaries:
    ``{request_id: {tenant, submitted_at, deadline_s, first_claimed,
    first_attempt_start, attempts, settled_state, settled_at}}``."""
    reqs = {}
    ordered = sorted((r for r in records if r.get("kind")),
                     key=lambda r: (_wall(r) or 0.0, r.get("seq") or 0))
    for rec in ordered:
        kind = rec.get("kind")
        rid = rec.get("request_id")
        if rid is None:
            continue  # batch-scoped transitions (planned/bisected)
        r = reqs.setdefault(rid, {
            "request_id": rid, "tenant": None, "trace_id": None,
            "submitted_at": None, "deadline_s": None,
            "first_claimed": None, "first_attempt_start": None,
            "attempts": 0, "settled_state": None, "settled_at": None,
            "last_wall": None, "_pending_claim": None})
        wt_any = _wall(rec)
        if wt_any is not None and (r["last_wall"] is None
                                   or wt_any > r["last_wall"]):
            r["last_wall"] = wt_any
        if rec.get("tenant") is not None:
            r["tenant"] = str(rec["tenant"])
        if rec.get("trace_id") is not None and r["trace_id"] is None:
            r["trace_id"] = rec["trace_id"]
        if kind == "submitted":
            sub = rec.get("submitted_at")
            r["submitted_at"] = sub if isinstance(sub, (int, float)) \
                else _wall(rec)
            if rec.get("deadline_s") is not None:
                r["deadline_s"] = float(rec["deadline_s"])
        elif kind == "claimed":
            # provisional until the claim leads to an attempt or a settle:
            # a claim rolled back by a lease release never did any work,
            # so it must not end the tenant's queue wait
            wt = _wall(rec)
            if wt is not None and r["first_claimed"] is None \
                    and r["_pending_claim"] is None:
                r["_pending_claim"] = wt
        elif kind == "released":
            if r["first_claimed"] is None:
                r["_pending_claim"] = None
        elif kind == "attempt":
            if r["first_claimed"] is None \
                    and r["_pending_claim"] is not None:
                r["first_claimed"] = r["_pending_claim"]
            start = rec.get("started_at")
            start = start if isinstance(start, (int, float)) else _wall(rec)
            if start is not None and (r["first_attempt_start"] is None
                                      or start < r["first_attempt_start"]):
                r["first_attempt_start"] = start
            n = rec.get("attempts")
            r["attempts"] += int(n) if isinstance(n, int) and n > 0 else 1
        elif kind == "settled":
            if r["first_claimed"] is None \
                    and r["_pending_claim"] is not None:
                r["first_claimed"] = r["_pending_claim"]
            state = str(rec.get("state") or "?")
            prev = r["settled_state"]
            if prev is None or (state in _STATE_PRIORITY
                                and (prev not in _STATE_PRIORITY
                                     or _STATE_PRIORITY.index(state)
                                     < _STATE_PRIORITY.index(prev))):
                r["settled_state"] = state
                r["settled_at"] = _wall(rec)
        elif kind == "requeued":
            # back into the live population: the re-settle is judged fresh
            r["settled_state"] = None
            r["settled_at"] = None
    for r in reqs.values():
        # a claim still pending at ledger end is live right now (the
        # worker holds the lease mid-batch): it did end the queue wait
        if r["first_claimed"] is None and r["_pending_claim"] is not None:
            r["first_claimed"] = r["_pending_claim"]
        del r["_pending_claim"]
    return reqs


def _dist(values):
    if not values:
        return None
    return {"n": len(values),
            "p50": percentile(values, 50.0),
            "p99": percentile(values, 99.0),
            "mean": sum(values) / len(values),
            "max": max(values)}


def _block(reqs):
    """One SLO block (per tenant, or fleet-wide) from request summaries."""
    queue_waits, ttfas, attempt_counts = [], [], []
    states = {s: 0 for s in _STATE_PRIORITY}
    with_deadline = hits = 0
    for r in reqs:
        sub = r["submitted_at"]
        if sub is not None and r["first_claimed"] is not None:
            queue_waits.append(r["first_claimed"] - sub)
        if sub is not None and r["first_attempt_start"] is not None:
            ttfas.append(r["first_attempt_start"] - sub)
        if r["attempts"]:
            attempt_counts.append(r["attempts"])
        state = r["settled_state"]
        if state in states:
            states[state] += 1
            if r["deadline_s"] is not None and sub is not None \
                    and r["settled_at"] is not None \
                    and state != "canceled":
                with_deadline += 1
                if state == "done" \
                        and (r["settled_at"] - sub) <= r["deadline_s"]:
                    hits += 1
    settled = sum(states.values())
    return {
        "requests": len(reqs),
        "settled": settled,
        "states": states,
        "queue_wait_s": _dist(queue_waits),
        "ttfa_s": _dist(ttfas),
        "deadline": ({"with_deadline": with_deadline, "hits": hits,
                      "hit_pct": 100.0 * hits / with_deadline}
                     if with_deadline else None),
        "attempts_per_request": (sum(attempt_counts) / len(attempt_counts)
                                 if attempt_counts else None),
        "deadletter_pct": (100.0 * states["deadletter"] / settled
                           if settled else None),
    }


def _breaches_of(scope, block, thr):
    out = []

    def breach(slo, value, threshold, worse_above=True):
        if value is None or threshold is None:
            return
        if (value > threshold) if worse_above else (value < threshold):
            out.append({"scope": scope, "slo": slo, "value": value,
                        "threshold": threshold})

    qw, tt = block.get("queue_wait_s"), block.get("ttfa_s")
    breach("queue_p99_s", (qw or {}).get("p99"), thr.get("queue_p99_s"))
    breach("ttfa_p99_s", (tt or {}).get("p99"), thr.get("ttfa_p99_s"))
    breach("deadline_hit_pct", (block.get("deadline") or {}).get("hit_pct"),
           thr.get("deadline_hit_pct"), worse_above=False)
    breach("deadletter_pct", block.get("deadletter_pct"),
           thr.get("deadletter_pct"))
    return out


def compute_slo(records, thresholds=None, window_s=None):
    """Compute the fleet SLO view from lifecycle-ledger records
    (fleet/history.py). Returns ``{"requests", "settled", "overall",
    "tenants": {tenant: block}, "thresholds", "breaches", "window"}`` —
    strict-JSON-able; ``None`` sub-blocks mean no evidence yet, never
    zero. ``thresholds`` defaults to :func:`thresholds_from_env`.

    ``window_s`` restricts the population to requests with lifecycle
    activity in the trailing window (see module docstring); ``None`` — the
    default — is the all-time view, whose output is bit-identical to the
    pre-windowing era."""
    thr = dict(thresholds_from_env(), **(thresholds or {}))
    reqs = list(_requests_from_history(records).values())
    walls = [w for rec in records for w in (_wall(rec),) if w is not None]
    cutoff_wall = None
    if window_s is not None and walls:
        cutoff_wall = max(walls) - float(window_s)
        reqs = [r for r in reqs if r["last_wall"] is not None
                and r["last_wall"] >= cutoff_wall]
    by_tenant = {}
    for r in reqs:
        by_tenant.setdefault(r["tenant"] or "?", []).append(r)
    overall = _block(reqs)
    tenants = {t: _block(rs) for t, rs in sorted(by_tenant.items())}
    breaches = _breaches_of("overall", overall, thr)
    for t, block in tenants.items():
        breaches.extend(_breaches_of(t, block, thr))
    window = {"first_wall": min(walls) if walls else None,
              "last_wall": max(walls) if walls else None}
    if window_s is not None:
        window["window_s"] = float(window_s)
        window["cutoff_wall"] = cutoff_wall
    return {
        "requests": overall["requests"],
        "settled": overall["settled"],
        "overall": overall,
        "tenants": tenants,
        "thresholds": thr,
        "breaches": breaches,
        "window": window,
    }


def serve_thresholds_from_env():
    """Serve latency thresholds from ``REDCLIFF_SLO_SERVE_*`` (None = that
    SLO is not checked)."""
    return {
        "serve_p50_ms": _env_float(ENV_SERVE_P50_MS),
        "serve_p99_ms": _env_float(ENV_SERVE_P99_MS),
    }


def compute_serve_slo(records, thresholds=None):
    """Fold a metrics chain's ``serve`` events into the serve SLO block.

    The service emits CUMULATIVE latency percentiles (nearest-rank over its
    bounded reservoir) on every kind=tick/drain record, so the newest such
    record IS the run's current view — no re-derivation, byte-agreement
    with what the service itself computed. Returns ``{"latency":
    {"p50_ms", "p99_ms", "n"}, "streams", "rejects", "dropped",
    "samples_in", "samples_out", "width", "fused_samples", "mode",
    "thresholds", "breaches"}`` (the last three from the elastic data
    plane: newest dispatched rung width, cumulative fused-sample
    count, ladder mode), or None when the records carry no serve events
    at all.
    """
    thr = dict(serve_thresholds_from_env(), **(thresholds or {}))
    last_lat = None
    # counters are cumulative but scattered across kinds (drain carries no
    # rejects, stop no streams): keep the newest non-None value per field
    counts = {k: None for k in ("streams", "rejects", "dropped",
                                "samples_in", "samples_out", "width",
                                "fused_samples", "mode")}
    seen = False
    for rec in records:
        if rec.get("event") != "serve":
            continue
        seen = True
        for k in counts:
            if rec.get(k) is not None:
                counts[k] = rec[k]
        if rec.get("n") and rec.get("p99_ms") is not None:
            last_lat = rec
    if not seen:
        return None
    latency = None
    if last_lat is not None:
        latency = {"p50_ms": last_lat.get("p50_ms"),
                   "p99_ms": last_lat.get("p99_ms"),
                   "n": last_lat.get("n")}
    breaches = []
    if latency is not None:
        for slo, key in (("serve_p50_ms", "p50_ms"),
                         ("serve_p99_ms", "p99_ms")):
            value, limit = latency.get(key), thr.get(slo)
            if value is not None and limit is not None and value > limit:
                breaches.append({"scope": "serve", "slo": slo,
                                 "value": value, "threshold": limit})
    return dict(counts, latency=latency, thresholds=thr, breaches=breaches)


def slo_for_root(root, thresholds=None, stats=None, window_s=None):
    """The SLO view for a fleet root (reads ``<root>/history.jsonl``), or
    None when the root holds no lifecycle ledger yet."""
    from redcliff_tpu_torch.fleet.history import read_history

    records = read_history(root, stats=stats)
    if not records:
        return None
    return compute_slo(records, thresholds=thresholds, window_s=window_s)
