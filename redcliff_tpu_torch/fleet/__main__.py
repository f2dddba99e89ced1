"""``python -m redcliff_tpu_torch.fleet {submit,work,autoscale,status,cancel,
requeue}``.

submit — append fit requests to a fleet root's durable queue
    (fleet/queue.py). ``--tiny`` uses the built-in canonical tiny spec
    (the fault-injection harness's small deterministic fit) — the smoke /
    CI path; real sweeps pass ``--spec-file`` + ``--points``. Rides the
    admission backpressure gate: with ``REDCLIFF_SLO_QUEUE_P99_S`` armed,
    a submit whose predicted queue wait would breach it is REJECTED with
    the ETA (exit 3; ``REDCLIFF_BACKPRESSURE=0`` opts out).
work — run the worker loop (fleet/worker.py): reclaim expired claims,
    run pinned bisection halves, plan admission (fleet/planner.py),
    supervise batches, settle results under the containment discipline
    (``--max-attempts`` is the per-request retry budget).
autoscale — run the SLO-driven fleet control loop (fleet/autoscale.py):
    spawn/retire ``work --drain`` workers against the queue's predicted
    drain time (``REDCLIFF_AUTOSCALE_*`` knobs), demote breaching tenants
    down the degraded-QoS ladder at the pool cap, publish
    ``<root>/autoscale.json``.
status — queue-wide and per-tenant counts plus a per-request age table:
    queue age (now − ``submitted_at``) for live requests, terminal-state
    age for settled ones (``--json`` for scripts); plus the autoscaler's
    last published decision and per-tenant QoS/backpressure state when an
    autoscaler has run against the root.
cancel — first-writer-wins ``canceled`` terminal record: the request is
    never re-planned, a running worker's settle stands down, and no lease
    is orphaned (tombstone-reclaim path, docs/ARCHITECTURE.md "Fleet
    failure containment").
requeue — resurrect a dead-lettered request with a fresh retry budget
    (its dossier is archived; the planner treats it as a solo suspect
    until it proves clean).

The CLI (like the queue/planner/worker) never initializes a backend (no
torch, no jax); only the supervised ``run_batch`` child does.

Port of ``redcliff_tpu/fleet/__main__.py``: the same verbs, options and
exit codes, plus ``work --device``: the device the ``run_batch``
children fit on (``cuda`` when not given; without CUDA the child fails,
it never fits on the CPU unasked).
"""
from __future__ import annotations

import argparse
import json
import sys

# the canonical tiny spec: mirrors runtime/faultinject.py's _tiny_runner
# model/train shape so fleet smoke fits warm-start from the same persistent
# compile cache the fault-injection suite already primes
TINY_SPEC = {
    "model": "RedcliffSCMLP",
    "model_config": {
        "num_chans": 4, "gen_lag": 2, "gen_hidden": [8], "embed_lag": 4,
        "embed_hidden_sizes": [8], "num_factors": 2,
        "num_supervised_factors": 2, "factor_weight_l1_coeff": 0.01,
        "adj_l1_reg_coeff": 0.001, "factor_cos_sim_coeff": 0.01,
        "factor_score_embedder_type": "Vanilla_Embedder",
        "primary_gc_est_mode": "fixed_factor_exclusive", "num_sims": 1,
        "training_mode": "combined"},
    "train_config": {"batch_size": 16, "check_every": 1, "seed": 0},
    "data": {"kind": "synthetic", "seed": 0, "n": 48},
    "epochs": 2,
}
TINY_POINTS = [{"gen_lr": 1e-3}, {"gen_lr": 3e-3}]


def _cmd_submit(args):
    from redcliff_tpu_torch.fleet.queue import FleetQueue
    from redcliff_tpu_torch.obs.logging import MetricLogger

    if args.tiny:
        spec = json.loads(json.dumps(TINY_SPEC))  # deep copy
        if args.epochs is not None:
            spec["epochs"] = args.epochs
        points = (json.loads(args.points) if args.points
                  else list(TINY_POINTS))
    else:
        if not args.spec_file:
            print("fleet submit: --spec-file (or --tiny) is required",
                  file=sys.stderr)
            return 2
        with open(args.spec_file) as f:
            spec = json.load(f)
        if args.epochs is not None:
            spec["epochs"] = args.epochs
        if args.points:
            points = json.loads(args.points)
        elif args.points_file:
            with open(args.points_file) as f:
                points = json.load(f)
        else:
            points = spec.pop("points", None)
        if not points:
            print("fleet submit: no grid points (--points / --points-file "
                  "/ spec['points'])", file=sys.stderr)
            return 2
    if getattr(args, "precision_mode", None):
        # tenant-facing mixed-precision knob: rides the spec's
        # train_config, so it joins the planner's merge key (requests that
        # disagree on numerics never share a batch) and the batch driver's
        # RedcliffTrainConfig verbatim
        spec.setdefault("train_config", {})["precision_mode"] = \
            args.precision_mode
    from redcliff_tpu_torch.fleet.queue import BackpressureReject

    q = FleetQueue(args.root)
    rids = []
    rc = 0
    with MetricLogger(args.root) as log:
        for _ in range(args.n):
            try:
                rid = q.submit(args.tenant, points, spec=spec,
                               priority=args.priority,
                               deadline_s=args.deadline_s,
                               per_lane_bytes=args.per_lane_bytes,
                               fixed_bytes=args.fixed_bytes)
            except BackpressureReject as rej:
                # the structured reject-with-ETA, not a crash: nothing was
                # spooled; retry after ~eta_s or opt out
                print(f"fleet submit: {rej}", file=sys.stderr)
                rc = 3
                break
            log.log("fleet", kind="submit", requests=[rid],
                    tenants=[args.tenant], n_points=len(points),
                    priority=args.priority)
            rids.append(rid)
    for rid in rids:
        print(rid)
    return rc


def _cmd_work(args):
    from redcliff_tpu_torch.fleet.worker import work
    from redcliff_tpu_torch.runtime.retry import RetryPolicy
    from redcliff_tpu_torch.runtime.supervisor import SupervisorPolicy

    policy = SupervisorPolicy(
        max_restarts=args.max_restarts,
        backoff=RetryPolicy(max_attempts=1_000_000,
                            base_delay_s=args.base_delay_s, multiplier=2.0,
                            max_delay_s=args.max_delay_s))
    n = work(args.root, worker_id=args.worker_id, lease_s=args.lease_s,
             poll_s=args.poll_s, max_batches=args.max_batches,
             drain=args.drain, once=args.once, n_devices=args.n_devices,
             budget_bytes=args.budget_bytes, max_bucket=args.max_bucket,
             checkpoint_every=args.checkpoint_every,
             supervisor_policy=policy, max_attempts=args.max_attempts,
             packing=args.packing, device=args.device)
    print(f"fleet work: ran {n} batch(es)", file=sys.stderr)
    return 0


def _cmd_autoscale(args):
    from redcliff_tpu_torch.fleet import autoscale as _autoscale

    policy = _autoscale.AutoscalePolicy.from_env()
    for name in ("max_workers", "min_workers", "target_drain_s",
                 "hysteresis_s", "window_s"):
        val = getattr(args, name)
        if val is not None:
            setattr(policy, name, val)
    scaler = _autoscale.Autoscaler(
        args.root, policy=policy, n_devices=args.n_devices,
        lease_s=args.lease_s, poll_s=args.poll_s,
        max_attempts=args.max_attempts, max_restarts=args.max_restarts)
    summary = scaler.run(interval_s=args.interval_s,
                         max_ticks=args.max_ticks, drain=args.drain)
    last = summary.get("last_decision") or {}
    print(f"fleet autoscale: {summary['ticks']} tick(s) over "
          f"{summary['wall_s']:.1f}s, {summary['workers']} worker(s) "
          f"live, last decision {last.get('kind')} "
          f"({last.get('reason')})", file=sys.stderr)
    return 0


def _cmd_cancel(args):
    from redcliff_tpu_torch.fleet.queue import FleetQueue
    from redcliff_tpu_torch.obs.logging import MetricLogger

    q = FleetQueue(args.root)
    if q.cancel(args.request_id, reason=args.reason):
        with MetricLogger(args.root) as log:
            log.log("fleet", kind="cancel", requests=[args.request_id],
                    reason=args.reason)
        print(f"canceled {args.request_id}")
        return 0
    state = q.terminal_state(args.request_id)
    print(f"fleet cancel: {args.request_id} not canceled "
          + (f"(already terminal: {state})" if state
             else "(unknown request id)"), file=sys.stderr)
    return 1


def _cmd_requeue(args):
    from redcliff_tpu_torch.fleet.queue import FleetQueue
    from redcliff_tpu_torch.obs.logging import MetricLogger

    q = FleetQueue(args.root)
    if q.requeue(args.request_id):
        with MetricLogger(args.root) as log:
            log.log("fleet", kind="requeue", requests=[args.request_id])
        print(f"requeued {args.request_id} (fresh retry budget)")
        return 0
    print(f"fleet requeue: {args.request_id} has no dead-letter record "
          f"to resurrect", file=sys.stderr)
    return 1


def _cmd_status(args):
    import os

    from redcliff_tpu_torch.fleet.queue import FleetQueue

    if not os.path.exists(args.root):
        print(f"fleet status: no such fleet root: {args.root}",
              file=sys.stderr)
        return 2
    # create=False: status is a pure reader — no mkdir side effects, and
    # archived/read-only roots still report. include_requests: the
    # per-request age view (queue age = now - submitted_at for live
    # requests, terminal-state age for settled ones)
    from redcliff_tpu_torch.fleet import autoscale as _autoscale

    st = FleetQueue(args.root, create=False).status(include_requests=True)
    auto = _autoscale.load_state(args.root)
    qos = _autoscale.active_qos(args.root)
    if auto is not None or qos:
        st["autoscale"] = {
            "state": auto,
            "qos": {t: {"rung": r.get("rung"), "reason": r.get("reason")}
                    for t, r in sorted(qos.items())},
        }
    # spatial-packing view: worker-published occupancy state,
    # the newest plan's fair-share quota deferrals (structured reasons from
    # the metrics chain), and per-request partial-result stream progress
    # (results/<id>.partial.jsonl row counts under the batch work dirs)
    import glob as _glob

    from redcliff_tpu_torch.parallel import packing as _packing

    pack_state = _packing.load_state(args.root)
    quota_deferred = None
    try:
        from redcliff_tpu_torch.obs.logging import read_jsonl
        for rec in reversed(read_jsonl(args.root)):
            if rec.get("event") == "fleet" and rec.get("kind") == "plan":
                quota_deferred = rec.get("quota_deferred") or []
                break
    except (OSError, ValueError):
        pass
    partials = {}
    for path in sorted(_glob.glob(os.path.join(
            args.root, "work", "*", "results", "*.partial.jsonl"))):
        rid = os.path.basename(path)[:-len(".partial.jsonl")]
        rows = finals = 0
        try:
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    try:
                        row = json.loads(line)
                    except ValueError:
                        continue
                    rows += 1
                    finals += bool(row.get("final"))
        except OSError:
            continue
        acc = partials.setdefault(rid, {"rows": 0, "final": 0})
        acc["rows"] += rows
        acc["final"] += finals
    if pack_state is not None or quota_deferred or partials:
        st["packing"] = {
            "state": pack_state,
            "quota_deferred": quota_deferred or [],
            "partial_results": partials,
        }
    if args.json:
        json.dump(st, sys.stdout, indent=2, allow_nan=False)
        sys.stdout.write("\n")
        return 0
    c = st["counts"]
    print(f"fleet: {st['root']}")
    print(f"  {c['submitted']} submitted | {c['queued']} queued | "
          f"{c['running']} running | {c['done']} done | "
          f"{c['failed']} failed | {c['deadletter']} dead-lettered | "
          f"{c['canceled']} canceled"
          + (f" | {c['expired_claims']} expired claim(s)"
             if c["expired_claims"] else "")
          + (f" | {st['torn_spool_lines']} torn spool line(s)"
             if st["torn_spool_lines"] else ""))
    for tenant, t in sorted(st["by_tenant"].items()):
        print(f"  tenant {tenant}: {t['submitted']} submitted, "
              f"{t['queued']} queued, {t['running']} running, "
              f"{t['done']} done, {t['failed']} failed, "
              f"{t['deadletter']} dead-lettered, {t['canceled']} canceled")
    auto_st = (st.get("autoscale") or {}).get("state")
    if auto_st:
        last = auto_st.get("last_decision") or {}
        print(f"  autoscale: {auto_st.get('workers')}/"
              f"{auto_st.get('max_workers')} worker(s), target "
              f"{auto_st.get('target')}, {auto_st.get('pending')} pending, "
              f"drain eta {auto_st.get('drain_eta_s')}s")
        if last:
            print(f"    last decision: {last.get('kind')} "
                  f"({last.get('reason')})")
    for tenant, rec in sorted(((st.get("autoscale") or {}).get("qos")
                               or {}).items()):
        print(f"    qos tenant {tenant}: rung {rec.get('rung')} "
              f"({rec.get('reason')})")
    pk = st.get("packing")
    if pk:
        ps = pk.get("state") or {}
        if ps:
            print(f"  packing: {ps.get('busy_devices', 0)}/"
                  f"{ps.get('pool', '?')} device(s) busy, "
                  f"{ps.get('concurrent_batches', 0)} co-resident "
                  f"batch(es), util {ps.get('utilization_pct', 0)}%")
        for d in pk.get("quota_deferred") or []:
            print(f"    quota-deferred {d.get('batch_id')} "
                  f"[{d.get('tenant')}]: {d.get('reason')} — "
                  f"{d.get('inflight')}/{d.get('max_inflight_slots')} "
                  f"slot(s) held"
                  + (f", eta {d.get('eta_s')}s"
                     if d.get("eta_s") is not None else ""))
        for rid, acc in sorted((pk.get("partial_results") or {}).items()):
            print(f"    partial {rid}: {acc['rows']} row(s) streamed, "
                  f"{acc['final']} final")

    def _age(s):
        if s is None:
            return "-"
        if s >= 3600:
            return f"{s / 3600:.1f}h"
        if s >= 60:
            return f"{s / 60:.1f}m"
        return f"{s:.1f}s"

    rows = st.get("requests") or []
    if rows:
        print(f"  {'request':<40} {'tenant':<12} {'state':<10} "
              f"{'queue age':>10} {'settled for':>12}")
        for r in rows:
            print(f"  {r['request_id']:<40} {r['tenant']:<12} "
                  f"{r['state']:<10} {_age(r['queue_age_s']):>10} "
                  f"{_age(r['terminal_age_s']):>12}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m redcliff_tpu_torch.fleet",
        description="Grid-fleet sweep service: durable multi-tenant queue "
                    "+ cost/memory-aware admission planner "
                    "(docs/ARCHITECTURE.md 'Fleet sweep service').")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("submit", help="append fit request(s) to the queue")
    sp.add_argument("--root", required=True, help="fleet root directory")
    sp.add_argument("--tenant", default="default")
    sp.add_argument("--priority", type=int, default=0)
    sp.add_argument("--deadline-s", type=float, default=None)
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--tiny", action="store_true",
                    help="use the built-in canonical tiny spec (smoke/CI)")
    sp.add_argument("--spec-file", default=None,
                    help="JSON spec: {model, model_config, train_config, "
                         "data, epochs[, points]}")
    sp.add_argument("--points", default=None,
                    help="grid points as a JSON list of hparam dicts")
    sp.add_argument("--points-file", default=None)
    sp.add_argument("--precision-mode", default=None,
                    choices=("f32", "mixed"),
                    help="production precision mode for the fit "
                         "(train_config.precision_mode; 'mixed' = bf16 "
                         "MXU contractions under the numerics sentinel's "
                         "auto-demotion watch)")
    sp.add_argument("--per-lane-bytes", type=int, default=None,
                    help="HBM per-lane hint for the admission planner "
                         "(obs/memory.py per_lane_bytes)")
    sp.add_argument("--fixed-bytes", type=int, default=None)
    sp.add_argument("-n", type=int, default=1, dest="n",
                    help="submit N identical requests")
    sp.set_defaults(fn=_cmd_submit)

    wp = sub.add_parser("work", help="run the worker loop")
    wp.add_argument("--root", required=True)
    wp.add_argument("--worker-id", default=None)
    wp.add_argument("--lease-s", type=float, default=60.0)
    wp.add_argument("--poll-s", type=float, default=2.0)
    wp.add_argument("--max-batches", type=int, default=None)
    wp.add_argument("--drain", action="store_true",
                    help="exit once the queue holds no claimable or "
                         "running work")
    wp.add_argument("--once", action="store_true")
    wp.add_argument("--n-devices", type=int, default=1,
                    help="mesh device count the planner packs buckets for")
    wp.add_argument("--budget-bytes", type=int, default=None,
                    help="admission HBM budget (check_headroom's "
                         "budget_bytes; omit = ungated)")
    wp.add_argument("--max-bucket", type=int, default=256)
    wp.add_argument("--checkpoint-every", type=int, default=1)
    wp.add_argument("--max-restarts", type=int, default=2)
    wp.add_argument("--base-delay-s", type=float, default=0.5)
    wp.add_argument("--max-delay-s", type=float, default=30.0)
    wp.add_argument("--packing", default=None,
                    choices=["off", "auto", "force"],
                    help="spatial mesh packing mode: off = "
                         "serial claims (default), auto = co-schedule "
                         "disjoint sub-mesh slots when the priced plan "
                         "says packed beats serial, force = always pack; "
                         "unset defers to REDCLIFF_FLEET_PACKING")
    wp.add_argument("--max-attempts", type=int, default=3,
                    help="per-request retry budget: failure attempts before "
                         "a request is dead-lettered (fleet/worker.py)")
    wp.add_argument("--device", default=None,
                    help="torch device the supervised run_batch children "
                         "fit on (default cuda; without CUDA the child "
                         "fails)")
    wp.set_defaults(fn=_cmd_work)

    asp = sub.add_parser(
        "autoscale",
        help="run the SLO-driven fleet control loop (fleet/autoscale.py): "
             "scale drain-workers against predicted drain time, demote "
             "breaching tenants down the degraded-QoS ladder")
    asp.add_argument("--root", required=True)
    asp.add_argument("--interval-s", type=float, default=2.0,
                     help="control-loop tick interval")
    asp.add_argument("--max-ticks", type=int, default=None,
                     help="stop after N ticks (smoke/CI)")
    asp.add_argument("--drain", action="store_true",
                     help="exit once the queue settles and every spawned "
                          "worker has retired")
    asp.add_argument("--max-workers", type=int, default=None,
                     help="pool cap (default REDCLIFF_AUTOSCALE_MAX_WORKERS "
                          "or 4)")
    asp.add_argument("--min-workers", type=int, default=None)
    asp.add_argument("--target-drain-s", type=float, default=None,
                     help="queue drain-time target the pool is sized for")
    asp.add_argument("--hysteresis-s", type=float, default=None,
                     help="cooldown between pool/QoS changes")
    asp.add_argument("--window-s", type=float, default=None,
                     help="rolling SLO window the loop reacts to")
    asp.add_argument("--n-devices", type=int, default=1)
    asp.add_argument("--lease-s", type=float, default=60.0)
    asp.add_argument("--poll-s", type=float, default=2.0)
    asp.add_argument("--max-attempts", type=int, default=3)
    asp.add_argument("--max-restarts", type=int, default=2,
                     help="respawn budget per worker slot (crashed workers "
                          "respawn under the supervised-exit taxonomy)")
    asp.set_defaults(fn=_cmd_autoscale)

    st = sub.add_parser("status", help="queue + per-tenant counts")
    st.add_argument("--root", required=True)
    st.add_argument("--json", action="store_true")
    st.set_defaults(fn=_cmd_status)

    cp = sub.add_parser("cancel",
                        help="terminal 'canceled' record (first writer "
                             "wins; never re-planned, no orphaned lease)")
    cp.add_argument("request_id")
    cp.add_argument("--root", required=True)
    cp.add_argument("--reason", default=None)
    cp.set_defaults(fn=_cmd_cancel)

    rq = sub.add_parser("requeue",
                        help="resurrect a dead-lettered request with a "
                             "fresh retry budget (dossier archived)")
    rq.add_argument("request_id")
    rq.add_argument("--root", required=True)
    rq.set_defaults(fn=_cmd_requeue)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
