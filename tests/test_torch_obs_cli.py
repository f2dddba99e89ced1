"""The port's observability CLIs (redcliff_tpu_torch/obs/{report,watch,
trace_export,regress,__main__}.py) against the JAX package's.

One JAX-written faulted grid run dir (tests/test_obs_report.py's
``faulted_run``: nan batches from step 2 quarantine every lane) goes
through both packages' ``build_report``, ``build_snapshot``,
``build_trace`` and ``render_text``: equal but for the JAX report's cached
TPU evidence, which the port never shows as its own. A port grid fit from
the same weights reports the JAX run's decisions. The regression sentinel
and the cost model's report-fed entry points are held to JAX's on the same
inputs, and the module entry runs with jax and the JAX package blocked.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from redcliff_tpu.models.redcliff import (RedcliffSCMLP,  # noqa: E402
                                          RedcliffSCMLPConfig)
from redcliff_tpu.obs import costmodel as jcm  # noqa: E402
from redcliff_tpu.obs import regress as jregress  # noqa: E402
from redcliff_tpu.obs import report as jreport  # noqa: E402
from redcliff_tpu.obs import trace_export as jtrace  # noqa: E402
from redcliff_tpu.obs import watch as jwatch  # noqa: E402
from redcliff_tpu.parallel.grid import GridSpec, RedcliffGridRunner  # noqa: E402,E501
from redcliff_tpu.train import redcliff_trainer as jtr  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset as TDataset  # noqa: E402,E501
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.obs import costmodel as tcm  # noqa: E402
from redcliff_tpu_torch.obs import regress as tregress  # noqa: E402
from redcliff_tpu_torch.obs import report as treport  # noqa: E402
from redcliff_tpu_torch.obs import schema  # noqa: E402
from redcliff_tpu_torch.obs import trace_export as ttrace  # noqa: E402
from redcliff_tpu_torch.obs import watch as twatch  # noqa: E402
from redcliff_tpu_torch.parallel import grid as tgrid  # noqa: E402
from redcliff_tpu_torch.train import redcliff_trainer as ttr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1.9e9
POINTS = [{"gen_lr": 1e-3}, {"gen_lr": 5e-3}, {"gen_lr": 2e-3}]
MODEL_KW = dict(num_chans=4, gen_lag=2, gen_hidden=(8,), embed_lag=4,
                embed_hidden_sizes=(8,), num_factors=2,
                num_supervised_factors=0, factor_weight_l1_coeff=0.01,
                adj_l1_reg_coeff=0.001, factor_cos_sim_coeff=0.0,
                factor_score_embedder_type="Vanilla_Embedder",
                primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
                training_mode="combined")


def _data(n=64):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 6, 4)).astype(np.float32)
    Y = rng.uniform(size=(n, 2, 1)).astype(np.float32)
    return X, Y


def _tc(mod):
    return mod.RedcliffTrainConfig(max_iter=4, batch_size=32, check_every=1,
                                   stream_mode="per_batch")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX-written faulted grid run (checkpointed into the run dir,
    with the supervisor's ledger lines) and the port's fit of the same
    grid from the same stacked weights, under the same faults."""
    root = tmp_path_factory.mktemp("obs_cli")
    jrun, trun = str(root / "jax"), str(root / "port")
    model = RedcliffSCMLP(RedcliffSCMLPConfig(**MODEL_KW))
    X, Y = _data()
    runner = RedcliffGridRunner(model, _tc(jtr), GridSpec(points=POINTS))
    old = os.environ.get("REDCLIFF_FAULT_INJECT")
    os.environ["REDCLIFF_FAULT_INJECT"] = "nan_batch:2-50"
    try:
        runner.fit(jax.random.PRNGKey(0), JDataset(X, Y), JDataset(X, Y),
                   log_dir=jrun, checkpoint_dir=jrun, checkpoint_every=1)
        tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**MODEL_KW))
        state = interop.grid_state_from_jax(
            *runner.init_grid(jax.random.PRNGKey(0)))
        tgrid.RedcliffGridRunner(tm, _tc(ttr), tgrid.GridSpec(POINTS),
                                 device="cpu").fit(
            0, TDataset(X, Y), TDataset(X, Y), log_dir=trun,
            checkpoint_dir=trun, checkpoint_every=1, init_params=state)
    finally:
        if old is None:
            os.environ.pop("REDCLIFF_FAULT_INJECT", None)
        else:
            os.environ["REDCLIFF_FAULT_INJECT"] = old
    for run in (jrun, trun):
        with open(os.path.join(run, "run_ledger.jsonl"), "a") as f:
            f.write(json.dumps({
                "event": "attempt", "attempt": 0, "cmd": ["fit"], "rc": 0,
                "classification": "clean", "action": "stop",
                "backoff_s": 0.0, "started_at": 1.0,
                "duration_s": 2.0}) + "\n")
            f.write(json.dumps({"event": "final", "classification": "clean",
                                "rc": 0, "attempts": 1}) + "\n")
    return jrun, trun


# ------------------------------------------------- parity on one run dir
def test_report_watch_trace_equal_jax_on_a_jax_run(runs):
    """The four functions on the JAX-written run dir: equal to JAX's but
    for ``tpu_bench_cache`` (None in the port) and its rendered line; the
    checkpointed dispatch_stats read from the JAX checkpoint too."""
    jrun, _ = runs
    jr, tr = jreport.build_report(jrun), treport.build_report(jrun)
    assert tr.pop("tpu_bench_cache") is None
    jr.pop("tpu_bench_cache")
    assert tr == jr
    assert isinstance(tr["checkpoint_dispatch_stats"], dict)
    assert tr["numerics"]["quarantined_lanes"] == 3
    assert treport.render_text(tr) == jreport.render_text(jr)
    js = jwatch.build_snapshot(jrun, now=NOW)
    ts = twatch.build_snapshot(jrun, now=NOW)
    assert ts == js and not schema.validate_record(ts)
    assert twatch.render_text(ts) == jwatch.render_text(js)
    jt, tt = jtrace.build_trace(jrun), ttrace.build_trace(jrun)
    assert tt == jt and not ttrace.validate_trace(tt)


def test_port_run_reports_the_jax_runs_decisions(runs):
    """A port grid fit from the same weights under the same faults: its
    report's numerics (quarantines, causes, skipped steps), failures and
    schema audit equal the JAX run's; every record validates."""
    jrun, trun = runs
    jr, tr = jreport.build_report(jrun), treport.build_report(trun)
    for k in ("quarantined_lanes", "failures", "guarded_steps_skipped",
              "rollbacks", "aborts", "anomaly_events"):
        assert tr["numerics"][k] == jr["numerics"][k], k
    assert tr["read_audit"]["schema_errors"] == \
        jr["read_audit"]["schema_errors"] == []
    assert tr["read_audit"]["ledger_schema_errors"] == []
    assert [f["model"] for f in tr["fits"]] == \
        [f["model"] for f in jr["fits"]]
    # the port's checkpoint carries its dispatch_stats for the report
    assert tr["checkpoint_dispatch_stats"]["ckpt_saves"] >= 1
    snap = twatch.build_snapshot(trun, now=NOW)
    assert not schema.validate_record(snap) and snap["ok"]
    assert snap["stalls"]["source"] == "grid_checkpoint.pkl"
    assert not ttrace.validate_trace(ttrace.build_trace(trun))


# ---------------------------------------------------- regression sentinel
def _payload(value, **over):
    p = {"metric": "m", "value": value, "unit": "w/s", "platform": "cpu",
         "grid_points": 16, "vs_baseline": 0.8}
    p.update(over)
    return p


def _traj(*payloads):
    return [{"round": i + 1, "path": f"r{i + 1}", "payload": p}
            for i, p in enumerate(payloads)]


SENTINEL_CASES = {
    "slowdown": (_payload(50.0), (_payload(100.0), _payload(104.0),
                                  _payload(98.0))),
    "improvement": (_payload(300.0), (_payload(100.0), _payload(104.0))),
    "too_few_priors": (_payload(100.0), (_payload(300.0),)),
    "other_platform": (_payload(100.0), (_payload(300.0, platform="tpu"),
                                         _payload(300.0, platform="tpu"))),
    "live_fallback": (_payload(1.0, live_fallback=_payload(40.0)),
                      (_payload(100.0), _payload(101.0))),
}


@pytest.mark.parametrize("case", sorted(SENTINEL_CASES))
def test_regress_sentinel_equals_jax(case, tmp_path):
    cur, prior = SENTINEL_CASES[case]
    traj = _traj(*prior)
    jb = jregress.run_sentinel(cur, trajectory=traj, bench_dir=str(tmp_path),
                               now=NOW)
    tb = tregress.run_sentinel(cur, trajectory=traj, now=NOW)
    assert tb == jb and not schema.validate_record(tb)
    assert tregress.render_text(tb) == jregress.render_text(jb)
    # a trajectory directory of BENCH rounds reads the same in both
    for i, p in enumerate(prior + (cur,)):
        with open(tmp_path / f"BENCH_r{i + 1:02d}.json", "w") as f:
            json.dump({"parsed": p}, f)
    assert [r["payload"] for r in tregress.load_trajectory(str(tmp_path))] \
        == [r["payload"] for r in jregress.load_trajectory(str(tmp_path))]
    with pytest.raises(ValueError, match="no port benchmark trajectory"):
        tregress.load_trajectory(None)


# -------------------------------------------------------------- cost model
def test_cost_model_from_report_equals_jax(runs, tmp_path):
    """``fit_from_report`` and ``update_store_from_report`` on the JAX
    run's report: the same buckets as JAX's under the same label."""
    jrun, _ = runs
    rep = treport.build_report(jrun)
    rep["cost_table"].append(dict(rep["cost_table"][0], g_bucket=2,
                                  precision="mixed"))
    for prec in ("f32", "mixed"):
        tmodel = tcm.fit_from_report(rep, platform="cuda", precision=prec)
        jmodel = jcm.fit_from_report(rep, platform="cuda", precision=prec)
        strip = lambda m: {k: {f: v for f, v in b.items()  # noqa: E731
                               if f != "updated_at"}
                           for k, b in m.buckets.items()}
        assert strip(tmodel) == strip(jmodel) and strip(tmodel)
    tcm.update_store_from_report(str(tmp_path / "t"), rep, "cuda",
                                 now=NOW)
    jcm.update_store_from_report(str(tmp_path / "j"), rep, "cuda", now=NOW)
    with open(tcm.store_path(str(tmp_path / "t"))) as f:
        tstore = json.load(f)
    with open(jcm.store_path(str(tmp_path / "j"))) as f:
        jstore = json.load(f)
    assert tstore == jstore and tstore["buckets"]


# ------------------------------------------------------------ the CLI entry
def test_module_entry_exit_codes_with_jax_blocked(runs, tmp_path):
    """``python -m redcliff_tpu_torch.obs`` with jax and the JAX package
    blocked: report/watch/trace/regress on the run dirs and report and
    ``trace --fleet`` on a fleet root exit 0 with valid output; a missing
    dir and ``regress`` without ``--bench-dir`` exit 2 with one line and
    no traceback; the schema lint passes."""
    jrun, trun = runs
    fleet = tmp_path / "fleet"
    fleet.mkdir()
    (fleet / "requests.jsonl").write_text("")
    trace_out = str(tmp_path / "trace.json")
    cases = [
        (["report", trun, "--json"], 0),
        (["report", jrun], 0),
        (["watch", trun, "--once", "--json"], 0),
        (["trace", trun, "-o", trace_out], 0),
        (["report", str(tmp_path / "missing")], 2),
        (["watch", str(tmp_path / "missing"), "--once"], 2),
        (["trace", str(tmp_path / "missing")], 2),
        (["report", str(fleet)], 0),
        (["trace", str(fleet), "--fleet"], 0),
        (["regress"], 2),
    ]
    code = f"""
import io, json, runpy, sys, contextlib
sys.modules["jax"] = None
sys.modules["redcliff_tpu"] = None
out = []
for argv, _ in {cases!r}:
    sys.argv = ["obs"] + argv
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        try:
            runpy.run_module("redcliff_tpu_torch.obs", run_name="__main__",
                             alter_sys=True)
            rc = 0
        except SystemExit as e:
            rc = e.code
    out.append([rc, so.getvalue(), se.getvalue()])
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("jax", "redcliff_tpu"))
print(json.dumps({{"out": out, "bad": bad}}))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for (argv, want), (rc, out, err) in zip(cases, res["out"]):
        assert rc == want, (argv, rc, err[-2000:])
        if want == 2:
            assert "Traceback" not in err and len(err.strip().splitlines()) \
                == 1, (argv, err)
    assert "fleet containment" in res["out"][7][1]
    assert not ttrace.validate_trace(json.loads(res["out"][8][1]))
    assert "no port benchmark trajectory" in res["out"][9][2]
    rep = json.loads(res["out"][0][1])
    assert rep["tpu_bench_cache"] is None
    assert not rep["read_audit"]["schema_errors"]
    snap = json.loads(res["out"][2][1])
    assert not schema.validate_record(snap)
    with open(trace_out) as f:
        assert not ttrace.validate_trace(json.load(f))
    r = subprocess.run([sys.executable, "-m", "redcliff_tpu_torch.obs.schema",
                        "--check"], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "0 violation" in r.stdout, r.stderr[-2000:]
