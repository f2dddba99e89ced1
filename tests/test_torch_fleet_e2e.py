"""The port's fleet sweep service end to end on the CPU
(``python -m redcliff_tpu_torch.fleet ... work --drain --device cpu``).

A two-tenant tiny queue goes from ``submit`` through ONE merged batch to
``status``; the watch and report CLIs read the drained root, and the
port's report of it equals the JAX package's report of the same root (but
for the JAX report's cached TPU evidence). A SIGKILLed worker's batch is
reclaimed by a second worker and resumes from its checkpoint, bit for bit
equal to an uninterrupted run. An armed poison co-tenant (a blind
``exit:7`` sentinel) crashes its merged batch: the worker bisects it, the
healthy tenant completes with the same bits as in an unpoisoned batch,
and the poison request is dead-lettered with its dossier.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from redcliff_tpu_torch.fleet import chaos  # noqa: E402
from redcliff_tpu_torch.fleet.__main__ import TINY_POINTS  # noqa: E402
from redcliff_tpu_torch.fleet.queue import FleetQueue  # noqa: E402
from redcliff_tpu_torch.obs import schema  # noqa: E402
from redcliff_tpu_torch.obs.logging import read_jsonl  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "redcliff_tpu_torch.fleet"]
RESULT_KEYS = ("best_criteria", "best_epoch", "val_history", "active",
               "failures")


def _env(tmp, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("REDCLIFF_FAULT", "REDCLIFF_SLO",
                                "REDCLIFF_PREDICTIVE",
                                "REDCLIFF_FLEET_PACKING"))}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               REDCLIFF_COST_MODEL_DIR=str(tmp / "cost"), **extra)
    return env


def _run(argv, env, timeout=300):
    r = subprocess.run(CLI + argv, env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, (argv, r.stderr[-3000:])
    return r


def _submit(root, tenant, env, points=None, epochs=None):
    argv = ["submit", "--root", str(root), "--tiny", "--tenant", tenant]
    if points is not None:
        argv += ["--points", json.dumps(points)]
    if epochs is not None:
        argv += ["--epochs", str(epochs)]
    return _run(argv, env).stdout.split()[-1]


def _drain(root, env, *extra):
    r = _run(["work", "--root", str(root), "--drain", "--device", "cpu",
              "--lease-s", "30", "--poll-s", "0.2", "--base-delay-s",
              "0.05", "--max-delay-s", "0.05", *extra], env)
    return int(r.stderr.split("ran ")[1].split()[0])


def _result(root, rid):
    return FleetQueue(str(root), create=False).result(rid)["result"]


@pytest.fixture(scope="module")
def drained(tmp_path_factory):
    """Two tiny tenants submitted and drained through the CLI."""
    tmp = tmp_path_factory.mktemp("e2e")
    env = _env(tmp)
    root = tmp / "fleet"
    rids = {t: _submit(root, t, env) for t in ("alice", "bob")}
    n = _drain(root, env)
    status = json.loads(_run(["status", "--root", str(root), "--json"],
                             env).stdout)
    return root, rids, n, status, env


def test_two_tenants_submit_drain_status(drained):
    root, rids, n, status, env = drained
    assert n == 1, "same-spec requests must merge into ONE batch"
    assert status["counts"]["done"] == 2 and status["counts"]["failed"] == 0
    for rid in rids.values():
        res = _result(root, rid)
        assert res["n_points"] == len(TINY_POINTS)
        assert all(np.isfinite(v) for v in res["best_criteria"])
    recs = read_jsonl(str(root))
    assert schema.validate_records(recs) == []
    kinds = {r.get("kind") for r in recs if r.get("event") == "fleet"}
    assert {"plan", "claim", "batch_start", "batch_end", "complete"} <= kinds
    # the child ran the batch on the CPU it was asked for
    batch_id = next(r["batch_id"] for r in recs if r.get("event") == "fleet"
                    and r.get("kind") == "batch_end")
    run_dir = FleetQueue(str(root), create=False).batch_dir(batch_id)
    ledger = [json.loads(line) for line in
              open(os.path.join(run_dir, "run_ledger.jsonl"))]
    cmds = [r["cmd"] for r in ledger if r.get("event") == "attempt"]
    assert cmds and all(c[-2:] == ["--device", "cpu"] and
                        "redcliff_tpu_torch.fleet.run_batch" in c
                        for c in cmds)
    # the watch CLI reads the fleet root; its snapshot validates
    snap = json.loads(_run_obs(["watch", str(root), "--once", "--json"],
                               env))
    assert schema.validate_record(snap) == []
    assert snap["fleet"]["counts"]["done"] == 2
    assert snap["fleet"]["by_tenant"]["alice"]["done"] == 1
    # the per-tenant section of the batch run dir's report
    rep = json.loads(_run_obs(["report", run_dir, "--json"], env))
    assert set(rep["tenants"]) == {"alice", "bob"}
    assert rep["read_audit"]["schema_errors"] == []


def _run_obs(argv, env, pkg="redcliff_tpu_torch"):
    r = subprocess.run([sys.executable, "-m", f"{pkg}.obs", *argv], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (argv, r.stderr[-3000:])
    return r.stdout


def test_report_of_drained_root_equals_jax_report(drained, tmp_path):
    """``obs report`` of the fleet root and of its batch run dir: the
    port's equals the JAX package's on the same directories (but for the
    JAX report's cached TPU evidence); the fleet trace exports."""
    root, rids, n, status, env = drained
    from redcliff_tpu.obs import report as jreport
    from redcliff_tpu_torch.obs import report as treport
    from redcliff_tpu_torch.obs import trace_export as ttrace

    run_dir = next(iter(
        os.path.join(str(root), "work", d)
        for d in os.listdir(os.path.join(str(root), "work"))))
    for target in (str(root), run_dir):
        j = jreport.build_report(target)
        t = treport.build_report(target)
        j.pop("tpu_bench_cache")
        assert t.pop("tpu_bench_cache") is None
        assert t == j, target
    rep = treport.build_report(str(root))
    assert rep["fleet_containment"]["counts"]["done"] == 2
    assert sorted(rep["fleet_slo"]["tenants"]) == ["alice", "bob"]
    assert treport.render_text(rep) == jreport.render_text(
        dict(rep, tpu_bench_cache=None))
    out = str(tmp_path / "fleet_trace.json")
    _run_obs(["trace", "--fleet", str(root), "-o", out], env)
    with open(out) as f:
        trace = json.load(f)
    assert not ttrace.validate_trace(trace)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(nm).startswith("alice/") for nm in names)


def test_sigkill_worker_lease_reclaim_resume_bit_identical(drained,
                                                           tmp_path):
    """SIGKILL the worker (and its supervised child) once the batch's
    epoch-1 checkpoint is durable; after the 2 s lease expires a second
    worker reclaims the recorded batch and resumes: the results equal an
    uninterrupted run's bit for bit, and the request ran once."""
    env = _env(tmp_path)
    root = tmp_path / "fleet_kill"
    rid = _submit(root, "crash", env, epochs=4)
    marker = str(tmp_path / "epoch1.marker")
    env1 = dict(env, REDCLIFF_FAULT_INJECT="marker_after_epoch:1",
                REDCLIFF_FAULT_MARKER=marker)
    w1 = subprocess.Popen(CLI + ["work", "--root", str(root), "--device",
                                 "cpu", "--max-batches", "1", "--lease-s",
                                 "2", "--poll-s", "0.2"],
                          env=env1, start_new_session=True, cwd=REPO,
                          stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 240
        while not os.path.exists(marker):
            assert time.time() < deadline, "fit never reached epoch 1"
            assert w1.poll() is None, "worker 1 exited before the marker"
            time.sleep(0.05)
        os.killpg(w1.pid, signal.SIGKILL)
    finally:
        if w1.poll() is None:
            os.killpg(w1.pid, signal.SIGKILL)
        w1.wait()
    q = FleetQueue(str(root))
    lease = q.lease_of(rid)
    assert lease is not None and lease["batch_id"]
    while time.time() < float(lease["expires_at"]):
        time.sleep(0.05)
    assert q.status()["counts"]["queued"] == 1
    assert _drain(root, env) == 1
    assert q.status()["counts"]["done"] == 1
    # the uninterrupted reference: the same spec and points
    ref_root = tmp_path / "fleet_ref"
    ref = _submit(ref_root, "crash", env, epochs=4)
    assert _drain(ref_root, env) == 1
    res, res_ref = _result(root, rid), _result(ref_root, ref)
    for key in RESULT_KEYS:
        assert res[key] == res_ref[key], f"{key} diverged after resume"
    recs = read_jsonl(q.batch_dir(lease["batch_id"]))
    starts = [r for r in recs if r.get("event") == "fit_start"]
    assert len([r for r in starts
                if r.get("resumed_from_epoch") is None]) == 1
    assert any(r.get("resumed_from_epoch") is not None for r in starts)
    assert os.listdir(os.path.join(str(root), "done")) == [f"{rid}.json"]
    assert any(r.get("event") == "fleet" and r.get("kind") == "reclaim"
               for r in read_jsonl(str(root)))


def test_poison_cotenant_bisected_and_deadlettered(drained, tmp_path):
    """A blind poison co-tenant (``exit:7``, armed) crashes the merged
    batch: the worker bisects it into pinned halves, the healthy tenant
    completes bit for bit as in the unpoisoned two-tenant batch, and the
    poison request is dead-lettered with its dossier."""
    ref_root, ref_rids = drained[0], drained[1]
    env = _env(tmp_path, REDCLIFF_FAULT_INJECT="fleet_poison")
    root = tmp_path / "fleet_poison"
    good = _submit(root, "alice", env)
    bad = _submit(root, "mallory", env,
                  points=[chaos.poison_point("exit:7")])
    _drain(root, env, "--max-restarts", "0", "--max-attempts", "1")
    q = FleetQueue(str(root))
    counts = q.status()["counts"]
    assert counts["done"] == 1 and counts["deadletter"] == 1 \
        and counts["failed"] == 0
    assert q.terminal_state(good) == "done"
    assert q.terminal_state(bad) == "deadletter"
    dossier = q.deadletter_record(bad)["dossier"]
    assert dossier["reason"] == "crash_loop"
    assert "giving_up" in dossier["classifications"]
    recs = read_jsonl(str(root))
    assert schema.validate_records(recs) == []
    assert any(r.get("event") == "fleet" and r.get("kind") == "bisect"
               for r in recs)
    res, res_ref = _result(root, good), _result(ref_root, ref_rids["alice"])
    for key in RESULT_KEYS:
        assert res[key] == res_ref[key], f"{key} differs across batches"
