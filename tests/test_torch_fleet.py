"""The port's fleet control plane (redcliff_tpu_torch/{fleet,runtime/
supervisor,supervise,parallel/packing}.py) against the JAX package's.

The control modules are host copies: on the same inputs they must compute
and write what the JAX modules do, bit for bit. Each scenario here runs
once per package on its own root, under one deterministic clock, seeded
``uuid4`` and reset sequence counters, and the two results are compared
with only the root path (and a wall-clock duration, ``*_ms``) masked:
planner plans, the slot table and the packing pricer, the supervisor's
classification and ledger, the queue and lifecycle ledger after a scripted
submit/claim/renew/expire/reclaim/cancel/requeue/dead-letter sequence,
autoscale ticks against a fake worker pool, and chaos schedules. The
control modules import neither torch nor jax (a subprocess pins it).
"""
import importlib
import itertools
import json
import os
import random
import subprocess
import sys
import time
import uuid

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("redcliff_tpu", "redcliff_tpu_torch")
T0 = 1.9e9

# the fleet's control modules: no backend at import (the JAX list's
# fleet half, obs/schema.py NO_BACKEND_MODULES in the port)
CONTROL_MODULES = ("fleet", "fleet.__main__", "fleet.autoscale",
                   "fleet.chaos", "fleet.history", "fleet.planner",
                   "fleet.queue", "fleet.worker", "parallel.packing",
                   "runtime.supervisor", "supervise",
                   "utils.precision_modes")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture
def det(monkeypatch):
    """Deterministic clock, ids and counters; ``det(pkg)`` resets them
    before a package's leg."""
    state = {}

    def fake_time():
        state["n"] += 1
        return T0 + 0.001 * state["n"]

    def fake_uuid4():
        return uuid.UUID(int=state["rng"].getrandbits(128), version=4)

    monkeypatch.setattr(time, "time", fake_time)
    monkeypatch.setattr(uuid, "uuid4", fake_uuid4)
    for name in ("REDCLIFF_FAULT_INJECT", "REDCLIFF_SLO_QUEUE_P99_S",
                 "REDCLIFF_SLO_TTFA_P99_S", "REDCLIFF_SLO_DEADLINE_PCT",
                 "REDCLIFF_SLO_DEADLETTER_PCT", "REDCLIFF_BACKPRESSURE",
                 "REDCLIFF_FLEET_PACKING", "REDCLIFF_FLEET_TENANT_SLOTS",
                 "REDCLIFF_PREDICTIVE", "REDCLIFF_COST_MODEL_DIR",
                 "REDCLIFF_COMPILE_CACHE", "REDCLIFF_TRACE_CTX"):
        monkeypatch.delenv(name, raising=False)

    def reset(pkg):
        state["n"] = 0
        state["rng"] = random.Random(7)
        monkeypatch.setattr(_mod(pkg, "fleet.history"), "_seq",
                            itertools.count(1))
        monkeypatch.setattr(_mod(pkg, "obs.logging"), "_seq",
                            itertools.count(1))
        monkeypatch.setattr(_mod(pkg, "obs.spans"), "_ids",
                            itertools.count(1))

    return reset


def _norm(obj, roots=()):
    """Mask the package root paths and the wall-clock ``*_ms`` fields."""
    if isinstance(obj, dict):
        return {k: ("<ms>" if str(k).endswith("_ms") and isinstance(
            v, (int, float)) else _norm(v, roots)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_norm(v, roots) for v in obj]
    if isinstance(obj, str):
        for r in roots:
            obj = obj.replace(r, "<root>")
        return obj.replace("redcliff_tpu_torch", "redcliff_tpu")
    return obj


def _both(tmp_path, det, scenario):
    """Run ``scenario(pkg, root)`` for each package; returns both results,
    normalized."""
    out = []
    for pkg in PKGS:
        root = str(tmp_path / pkg)
        os.makedirs(root, exist_ok=True)
        det(pkg)
        out.append(_norm(scenario(pkg, root), (root,)))
    return out


# --------------------------------------------------------------- imports
def test_control_modules_import_with_torch_and_jax_blocked(tmp_path):
    """Every fleet control module imports in a process where torch and jax
    (and the JAX package) cannot be imported; the CLI's help runs there;
    ``utils.precision`` still re-exports ``precision_label``."""
    code = f"""
import importlib, sys
for m in ("torch", "jax", "redcliff_tpu", "triton"):
    sys.modules[m] = None
for name in {CONTROL_MODULES!r}:
    importlib.import_module("redcliff_tpu_torch." + name)
from redcliff_tpu_torch.utils.precision_modes import precision_label
assert precision_label("mixed") == "mixed" and precision_label() == "f32"
from redcliff_tpu_torch.fleet.__main__ import main
try:
    main(["work", "--help"])
except SystemExit as e:
    assert e.code == 0
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("torch", "jax", "redcliff_tpu",
                                     "triton"))
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-2000:]
    from redcliff_tpu_torch.obs import schema
    from redcliff_tpu_torch.utils import precision, precision_modes

    assert precision.precision_label is precision_modes.precision_label
    assert schema.check_sources() == []
    for name in CONTROL_MODULES:
        rel = name.replace(".", "/")
        rel = rel + ("/__init__.py" if name == "fleet" else ".py")
        assert rel in schema.NO_BACKEND_MODULES, rel


def test_schema_check_flags_torch_in_a_control_module(tmp_path):
    """The source tripwire: a fleet control module that imports torch, at
    any scope, is a violation."""
    from redcliff_tpu_torch.obs import schema

    pkg = tmp_path / "pkg"
    (pkg / "fleet").mkdir(parents=True)
    (pkg / "fleet" / "planner.py").write_text(
        "def f():\n    import torch\n    return torch\n")
    (pkg / "fleet" / "run_batch.py").write_text("import torch\n")
    errs = schema.check_sources(str(pkg))
    assert len(errs) == 1 and "planner.py:2" in errs[0] \
        and "fleet control module" in errs[0]


# --------------------------------------------------------------- planner
SHAPE_A = {"num_chans": 4, "num_factors": 2}
SHAPE_B = {"num_chans": 8, "num_factors": 4}


def _req(i, shape, n_points, tenant="t", priority=0, deadline_s=None,
         per_lane=None, fixed=0, epochs=10, train_config=None):
    spec = {"model_config": shape, "epochs": epochs}
    if train_config is not None:
        spec["train_config"] = train_config
    return {
        "request_id": f"req-{i:03d}", "tenant": tenant,
        "trace_id": f"tr-{i:03d}",
        "submitted_at": float(i), "priority": priority,
        "deadline_s": deadline_s, "shape": shape,
        "points": [{"gen_lr": 1e-3 * (j + 1)} for j in range(n_points)],
        "epochs": epochs, "per_lane_bytes": per_lane, "fixed_bytes": fixed,
        "spec": spec,
    }


class _FakeCostModel:
    """Deterministic pricing for both planners (package-independent)."""

    def predict_fit_eta(self, sk, width, epochs, platform=None,
                        cold_programs=1, precision="f32"):
        return 0.5 * width * epochs * (0.6 if precision == "mixed" else 1)

    def compile_warm(self, sk, width, platform=None, precision="f32"):
        return width <= 8

    def predict_compile_ms(self, sk, width, platform=None, precision="f32"):
        return 100.0 * width


PLAN_CASES = {
    "merge": (lambda: [_req(0, SHAPE_A, 2), _req(1, SHAPE_A, 3),
                       _req(2, SHAPE_B, 2)], dict(n_devices=1)),
    "horizons": (lambda: [_req(0, SHAPE_A, 2, epochs=10),
                          _req(1, SHAPE_A, 2, epochs=50)],
                 dict(n_devices=1)),
    "headroom": (lambda: [_req(i, SHAPE_A, 3, per_lane=1 << 30)
                          for i in range(6)] + [
                     _req(9, SHAPE_A, 4, per_lane=4 << 30, epochs=3)],
                 dict(n_devices=1, budget_bytes=9 << 30)),
    "priority_deadline": (lambda: [
        _req(0, SHAPE_A, 2), _req(1, SHAPE_B, 2, priority=5),
        _req(2, {"num_chans": 16}, 2, deadline_s=60.0),
        _req(3, SHAPE_A, 0)], dict(n_devices=1)),
    "mesh8": (lambda: [_req(i, (SHAPE_A, SHAPE_B)[i % 2], 1 + (i * 3) % 5,
                            per_lane=64 << 20) for i in range(12)],
              dict(n_devices=8, budget_bytes=8 << 30)),
    "suspects_quota": (lambda: [
        _req(i, SHAPE_A if i < 4 else SHAPE_B, 2,
             tenant=("greedy", "modest")[i % 2], epochs=5 + i)
        for i in range(8)],
        dict(n_devices=4, suspects={"req-002", "req-005"},
             tenant_slots={"*": 2, "greedy": 1},
             inflight_slots={"modest": 1}, max_bucket=16)),
    "priced_mixed": (lambda: [
        _req(i, SHAPE_A, 1 + i, train_config={
            "precision_mode": ("f32", "mixed")[i % 2]})
        for i in range(6)] + [
        _req(7, SHAPE_B, 9, train_config="not-a-dict")],
        dict(n_devices=4, budget_bytes=None, cost=True)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("fn", ["plan", "fifo_plan"])
def test_planner_matches_jax(tmp_path, det, case, fn):
    make, kw = PLAN_CASES[case]

    def scenario(pkg, root):
        planner = _mod(pkg, "fleet.planner")
        args = dict(kw)
        if args.pop("cost", False):
            args["cost_model"] = _FakeCostModel()
        if fn == "fifo_plan":
            for k in ("suspects", "tenant_slots", "inflight_slots",
                      "max_bucket"):
                args.pop(k, None)
        out = getattr(planner, fn)(make(), **args)
        out["ids"] = [planner.batch_id_for(b["requests"])
                      for b in out["batches"]]
        return out

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out
    assert port_out["batches"] or port_out["unschedulable"]


def test_planner_helpers_match_jax(tmp_path, det):
    def scenario(pkg, root):
        planner = _mod(pkg, "fleet.planner")
        reqs = PLAN_CASES["merge"][0]()
        return {
            "quota": [planner.tenant_slot_quota(env=e) for e in
                      (None, "", "2", "a=1,b=4", "2,a=1", "garbage=")],
            "keys": [planner.batch_key(r) for r in reqs],
            "bytes": [planner.predicted_batch_bytes(reqs, w)
                      for w in (1, 8, 32)],
            "util": planner.utilization(planner.plan(reqs)["batches"]),
        }

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out


# --------------------------------------------------------------- packing
def test_slot_table_sequences_match_jax(tmp_path, det):
    """One seeded sequence of allocs, reserves and frees over several pool
    sizes: every return value and occupancy snapshot equal."""
    def scenario(pkg, root):
        packing = _mod(pkg, "parallel.packing")
        rng = random.Random(3)
        trace = []
        for n in (1, 4, 6, 8, 16):
            st = packing.SlotTable(n)
            live = []
            for _ in range(40):
                op = rng.random()
                if op < 0.5:
                    s = st.alloc(rng.choice((1, 2, 4, 8)))
                    trace.append(("alloc", s))
                    if s:
                        live.append(s)
                elif op < 0.7:
                    s = {"lo": rng.randrange(16), "width": rng.choice((1, 2,
                                                                       4))}
                    ok = st.reserve(s)
                    trace.append(("reserve", s, ok))
                    if ok:
                        live.append(s)
                elif live:
                    s = live.pop(rng.randrange(len(live)))
                    st.free(s)
                    trace.append(("free", s))
                trace.append(st.free_widths())
            trace.append(st.occupancy())
        trace.append([packing.devices_for(g, n) for g in (1, 3, 8, 32)
                      for n in (1, 2, 4, 8)])
        trace.append([packing.largest_pow2(n) for n in (1, 3, 6, 8, 17)])
        trace.append([packing.packing_mode(env=e) for e in
                      ("", "0", "1", "auto", "force", "off", "junk")])
        packing.publish_state(root, packing.SlotTable(4).occupancy(),
                              concurrent_batches=2)
        trace.append(packing.load_state(root))
        return trace

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out


@pytest.mark.parametrize("budget", [None, 1000, 5000])
def test_price_packing_matches_jax(tmp_path, det, budget):
    batches = [{"batch_id": f"b{i}", "g_bucket": g, "eta_s": e,
                "predicted_bytes": p}
               for i, (g, e, p) in enumerate([(1, 10.0, 600), (2, 4.0, 900),
                                              (4, 12.5, 1200), (1, 3.0, 100),
                                              (8, 20.0, 2000)])]

    def scenario(pkg, root):
        packing = _mod(pkg, "parallel.packing")
        return [packing.price_packing([dict(b) for b in batches], n, budget)
                for n in (1, 4, 8)] + [packing.price_packing(
                    [dict(b, eta_s=None) for b in batches], 4, budget)]

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out


# ------------------------------------------------------------ supervisor
EXIT_CODES = (0, 1, 2, 17, 18, 19, 20, 21, 137, -9, -15, -6)


@pytest.mark.parametrize("rc", EXIT_CODES)
def test_worker_exit_action_matches_jax(tmp_path, det, rc):
    def scenario(pkg, root):
        sup = _mod(pkg, "runtime.supervisor")
        return [sup.worker_exit_action(rc, used, max_restarts=m)
                for used in (0, 1, 2, 5) for m in (None, 0, 2)]

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out


def _script(tmp_path, codes):
    """A child exiting ``codes[n]`` on its n-th run (last code repeats)."""
    counter = str(tmp_path / "count.txt")
    src = ("import os,sys\n"
           f"p={counter!r}\n"
           "n=int(open(p).read()) if os.path.exists(p) else 0\n"
           "open(p,'w').write(str(n+1))\n"
           f"c={list(codes)!r}\n"
           "sys.exit(c[min(n, len(c)-1)])\n")
    return [sys.executable, "-c", src]


SUPERVISE_CASES = {
    "crash_then_clean": (1, 1, 0),
    "crash_loop": (1,),
    "numerics_abort": (18,),
    "deadline": (20,),
    "preempted_then_clean": (17, 0),
    "hang_then_clean": (19, 0),
    "host_lost_unmeshed": (21, 0),
}


@pytest.mark.parametrize("case", sorted(SUPERVISE_CASES))
def test_supervise_classification_matches_jax(tmp_path, det, case):
    """The same scripted child under both supervisors: the outcome, every
    attempt's classification, action and backoff, and the ledger lines
    (command, times and the mesh shape masked to the fields both write)."""
    def scenario(pkg, root):
        sup = _mod(pkg, "runtime.supervisor")
        retry = importlib.import_module(f"{pkg}.runtime.retry")
        policy = sup.SupervisorPolicy(
            max_restarts=2,
            backoff=retry.RetryPolicy(max_attempts=10 ** 6,
                                      base_delay_s=0.5, multiplier=2.0,
                                      max_delay_s=4.0))
        slept = []
        ledger = os.path.join(root, "run_ledger.jsonl")
        out = sup.supervise(_script(tmp_path / pkg,
                                    SUPERVISE_CASES[case]),
                            ledger_path=ledger, policy=policy,
                            sleep=slept.append)
        with open(ledger) as f:
            recs = [json.loads(line) for line in f]
        for r in recs:
            r.pop("cmd", None)
            for k in ("started_at", "duration_s", "wall_time"):
                if k in r:
                    r[k] = "<t>"
        return {"cls": out.classification, "rc": out.returncode,
                "attempts": [(a["classification"], a["action"],
                              a["backoff_s"]) for a in out.attempts],
                "slept": round(sum(slept), 6), "ledger": recs}

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out


def test_latest_cost_model_eta_matches_jax(tmp_path, det):
    def scenario(pkg, root):
        sup = _mod(pkg, "runtime.supervisor")
        with open(os.path.join(root, "metrics.jsonl"), "w") as f:
            for i in range(3):
                f.write(json.dumps({"event": "cost_model", "epoch": i,
                                    "eta_s": 30.0 - i, "wall_time": T0 + i,
                                    "epochs_remaining": 10 - i}) + "\n")
            f.write('{"event": "cost_mo')
        ledger = os.path.join(root, "run_ledger.jsonl")
        return [sup.latest_cost_model_eta(ledger),
                sup.latest_cost_model_eta(ledger, since_wall=T0 + 1.5),
                sup.latest_cost_model_eta(ledger, since_wall=T0 + 9)]

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out and port_out[0] is not None


# -------------------------------------------------------- queue + history
def _tiny_spec(pkg, epochs=1):
    spec = json.loads(json.dumps(_mod(pkg, "fleet.__main__").TINY_SPEC))
    spec["epochs"] = epochs
    return spec


def test_queue_and_history_sequence_match_jax(tmp_path, det):
    """One scripted sequence — submit, claim, renew, expire, reclaim,
    attempts, complete, fail, cancel, dead-letter, requeue, pin — leaves
    the same queue records, leases, attempt ledger, dossiers, lifecycle
    ledger and files in both packages."""
    def scenario(pkg, root):
        qm = _mod(pkg, "fleet.queue")
        history = _mod(pkg, "fleet.history")
        q = qm.FleetQueue(root)
        spec = _tiny_spec(pkg)
        pts = [{"gen_lr": 1e-3}, {"gen_lr": 2e-3}]
        a = q.submit("alice", pts, spec=spec, priority=2)
        b = q.submit("bob", pts, spec=spec, deadline_s=60.0)
        c = q.submit("carol", pts[:1], spec=spec)
        d = q.submit("dave", pts, spec=spec, per_lane_bytes=1 << 20,
                     fixed_bytes=1 << 10)
        e = q.submit("erin", pts, spec=spec, epochs=3)
        with open(q.spool_path, "a") as f:
            f.write('{"request_id": "req-torn", "tenant"')
        f_ = q.submit("frank", pts, spec=spec)
        la = q.claim(a, "w1", lease_s=30.0, batch_id="batch-x",
                     batch_request_ids=[a, b], tenant="alice")
        lb = q.claim(b, "w1", lease_s=30.0, batch_id="batch-x",
                     batch_request_ids=[a, b], tenant="bob")
        lost_claim = q.claim(a, "w2", lease_s=30.0)
        la.renew(30.0)
        lb.renew(0.0)
        expired = q.expired_claims()
        lb2 = q.claim(b, "w2", lease_s=30.0)
        try:
            lb.renew(30.0)
            stale = "renewed"
        except qm.LeaseLost:
            stale = "lost"
        lb.release()
        q.record_attempt(a, "giving_up", batch_id="batch-x",
                         run_dir=q.batch_dir("batch-x"))
        q.record_attempt(b, "reclaim", batch_id="batch-x", kind="reclaim")
        done = [q.complete(a, result={"ok": 1}),
                q.complete(a, result={"ok": 2})]
        lb2.release()
        fail = q.fail(e, "numerics_abort")
        cancel = [q.cancel(c, reason="user"), q.cancel(c)]
        dl = q.deadletter(d, dossier={"reason": "giving_up",
                                      "attempts": 3})
        dl_rec = q.deadletter_record(d)
        rq = q.requeue(d)
        q.pin_batch("batch-y", [d, f_], parent_batch_id="batch-x")
        pinned = q.pinned_batches()
        q.unpin_batch("batch-y")
        files = sorted(os.path.relpath(os.path.join(dp, n), root)
                       for dp, _, ns in os.walk(root) for n in ns)
        return {
            "ids": [a, b, c, d, e, f_], "lost_claim": lost_claim,
            "expired": expired, "stale": stale, "done": done, "fail": fail,
            "cancel": cancel, "dl": dl, "dl_rec": dl_rec, "requeue": rq,
            "pinned": pinned, "requests": q.requests(),
            "pending": q.pending(), "live": q.live_leases(),
            "terminal": {k: sorted(v) for k, v in q.terminal_ids().items()},
            "status": q.status(include_requests=True),
            "attempts": q.attempt_records(),
            "deadletters": q.deadletters(), "result": q.result(a),
            "history": history.read_history(root), "files": files,
        }

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out
    assert port_out["stale"] == "lost" and port_out["done"] == [True, False]
    assert port_out["status"]["torn_spool_lines"] == 1


def test_history_rotation_and_torn_tail_match_jax(tmp_path, det,
                                                  monkeypatch):
    def scenario(pkg, root):
        history = _mod(pkg, "fleet.history")
        monkeypatch.setattr(history, "ROTATE_BYTES", 600, raising=False)
        for i in range(12):
            history.append_event(root, "submitted", request_id=f"r{i}",
                                 tenant="t", trace_id=f"tr{i}",
                                 submitted_at=T0 + i)
        with open(history.history_path(root), "ab") as f:
            f.write(b'{"event": "fleet_lifecyc')
        history.append_event(root, "claimed", request_id="r0")
        stats = {}
        recs = history.read_history(root, stats=stats)
        return {"recs": recs, "stats": stats,
                "files": sorted(os.listdir(root))}

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out


# ------------------------------------------------------------- autoscale
class _FakeProc:
    def __init__(self, cmd):
        self.cmd = cmd
        self.rc = None

    def poll(self):
        return self.rc

    def terminate(self):
        self.rc = -15

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


_NO_SLOS = {"queue_p99_s": None, "ttfa_p99_s": None,
            "deadline_hit_pct": None, "deadletter_pct": None}


@pytest.mark.parametrize("case", ["scale_and_reap", "breach_qos"])
def test_autoscale_ticks_match_jax(tmp_path, det, case):
    """The control loop against a fake worker pool on a seeded storm:
    every tick's decision, the published state, the QoS rungs, the spawned
    argv and the autoscale events equal JAX's."""
    def scenario(pkg, root):
        autoscale = _mod(pkg, "fleet.autoscale")
        chaos = _mod(pkg, "fleet.chaos")
        history = _mod(pkg, "fleet.history")
        logging = _mod(pkg, "obs.logging")
        storm = chaos.submit_storm(root, 5, tenant="hot", seed=1,
                                   spec=_tiny_spec(pkg))
        chaos.submit_storm(root, 2, tenant="cold", seed=2,
                           spec=_tiny_spec(pkg))
        procs = []

        def spawn(cmd):
            procs.append(_FakeProc(cmd))
            return procs[-1]

        thresholds = dict(_NO_SLOS)
        kw = dict(max_workers=3, min_workers=0, target_drain_s=1.0,
                  hysteresis_s=10.0, window_s=600.0, default_eta_s=30.0)
        if case == "breach_qos":
            thresholds["queue_p99_s"] = 0.05
            kw.update(max_workers=1, target_drain_s=1000.0, qos=True)
            history.append_event(root, "claimed",
                                 request_id=storm["submitted"][0],
                                 tenant="hot", now=T0 + 50.0)
        scaler = autoscale.Autoscaler(
            root, autoscale.AutoscalePolicy(**kw), spawn=spawn,
            thresholds=thresholds, worker_args=["--device", "cpu"],
            scaler_id="scaler-x")
        decisions = []
        t = T0 + 60.0
        for i in range(6):
            decisions.append(scaler.tick(now=t))
            if i == 2 and procs:
                procs[0].rc = 137
            if i == 3 and len(procs) > 1:
                procs[1].rc = 0
            t += 6.0
        out = {"decisions": decisions,
               "state": autoscale.load_state(root),
               "qos": autoscale.active_qos(root),
               "argv": [p.cmd[1:] for p in procs],
               "events": [r for r in logging.read_jsonl(root)
                          if r.get("event") in ("autoscale", "qos")],
               "drain": autoscale.predicted_drain(
                   _mod(pkg, "fleet.queue").FleetQueue(root),
                   default_eta_s=30.0),
               "wait": autoscale.predict_queue_wait_s(root, now=t)}
        scaler.close()
        return out

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out
    kinds = [d["kind"] for d in port_out["decisions"]]
    assert "scale_up" in kinds
    assert all(a[-2:] == ["--device", "cpu"] for a in port_out["argv"])


def test_qos_ladder_matches_jax(tmp_path, det):
    def scenario(pkg, root):
        autoscale = _mod(pkg, "fleet.autoscale")
        planner = _mod(pkg, "fleet.planner")
        req = {"request_id": "r", "tenant": "a", "points": [{"gen_lr": 1e-3}],
               "spec": _tiny_spec(pkg, epochs=8), "epochs": 8}
        autoscale.set_qos(root, "a", 2, reason="breach")
        autoscale.set_qos(root, "b", 1, reason="breach")
        rungs = autoscale.active_qos(root)
        demoted = autoscale.apply_qos(req, rungs)
        clean = autoscale.apply_qos(dict(req, tenant="c"), rungs)
        return {"knobs": [autoscale.qos_knobs(r) for r in range(-1, 4)],
                "rungs": rungs, "demoted": demoted, "clean": clean,
                "keys": [planner.batch_key(demoted), planner.batch_key(req)]}

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out
    assert port_out["keys"][0] != port_out["keys"][1]


# ----------------------------------------------------------------- chaos
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_schedules_match_jax(tmp_path, det, seed):
    """The seeded fault schedules, poison specs, sentinel stripping, a
    seeded storm and the durable-state faults equal JAX's."""
    def scenario(pkg, root):
        chaos = _mod(pkg, "fleet.chaos")
        qm = _mod(pkg, "fleet.queue")
        sink = []
        pts = [chaos.poison_point(m) for m in
               ("nan", "sigkill", "exit:7", "hang:0.1")]
        storm = chaos.submit_storm(root, 4, tenant="s", seed=seed,
                                   spec=_tiny_spec(pkg),
                                   points_per_request=2)
        q = qm.FleetQueue(root)
        for rid in storm["submitted"][:3]:
            q.claim(rid, "w", lease_s=30.0)
        rng = random.Random(seed)
        faults = [chaos.apply_fault(op, root, rng) for op in
                  ("expire_lease", "corrupt_lease", "tear_spool",
                   "kill_worker")]
        return {"schedule": chaos.random_fleet_fault_schedule(seed, 10),
                "points": pts,
                "stripped": [chaos.strip_chaos(p, sink) for p in pts],
                "sink": sink, "storm": storm, "faults": faults,
                "status": q.status(), "expired": q.expired_claims(),
                "cmd": chaos.WorkerFleet(root, extra_args=[
                    "--device", "cpu"])._cmd()[1:]}

    jax_out, port_out = _both(tmp_path, det, scenario)
    assert port_out == jax_out


def test_cli_parsers_match_jax_plus_device():
    """Every verb and option of the JAX CLI exists in the port's with the
    same defaults; ``work`` adds ``--device``."""
    import argparse

    def options(pkg):
        m = _mod(pkg, "fleet.__main__")
        captured = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, args=None, namespace=None):
            captured["parser"] = self
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                m.main(["status", "--root", "x"])
        finally:
            argparse.ArgumentParser.parse_args = real
        sub = next(a for a in captured["parser"]._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {verb: {a.dest: a.default for a in p._actions}
                for verb, p in sub.choices.items()}

    jax_opts, port_opts = options(PKGS[0]), options(PKGS[1])
    assert sorted(port_opts) == sorted(jax_opts)
    for verb, opts in jax_opts.items():
        extra = {k: v for k, v in port_opts[verb].items() if k not in opts}
        assert {k: port_opts[verb][k] for k in opts} == opts, verb
        assert extra == ({"device": None} if verb == "work" else {}), verb
    assert _mod(PKGS[1], "fleet.__main__").TINY_SPEC \
        == _mod(PKGS[0], "fleet.__main__").TINY_SPEC
