"""The port's fleet batch driver (redcliff_tpu_torch/fleet/run_batch.py)
against the JAX package's, on the CPU.

One tiny batch file (the CLI's ``TINY_SPEC``, two requests, one of them
carrying a poison point that the numerics guard quarantines and an unarmed
chaos sentinel) goes through both packages' ``run_batch_file``, the port
on ``device="cpu"``. The grid's stacked init is drawn in JAX and carried
across (``interop.grid_state_from_jax``): both packages' ``fit`` are
wrapped to start from it. The per-request results agree at the grid bars
of tests/test_torch_grid.py (rtol 1e-4, atol 1e-5; epochs exact); the
manifest, the attributed ``failures.json`` and the final streamed rows
are equal. Within the port a request fits bit for bit the same alone and
merged (content-derived lane seeds); ``mesh: "auto"`` fits a batch on a
simulated pool of two CPU entries, whole and through a packed slot, bit
for bit as the unmeshed child; an armed ``fleet_poison`` sentinel exits with JAX's
code; without a device and without CUDA the child fails before it writes.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.fleet import run_batch as jrb  # noqa: E402
from redcliff_tpu.fleet.__main__ import TINY_SPEC  # noqa: E402
from redcliff_tpu.parallel import grid as jgrid  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.fleet import chaos as tchaos  # noqa: E402
from redcliff_tpu_torch.fleet import run_batch as trb  # noqa: E402
from redcliff_tpu_torch.obs.logging import read_jsonl  # noqa: E402
from redcliff_tpu_torch.parallel import grid as tgrid  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
EPOCHS = 3
POINTS_A = [{"gen_lr": 1e-3}, {"gen_lr": 3e-3}]
# a poison point (quarantined at epoch 0, attributable) and an unarmed
# chaos sentinel (stripped; fits as its healthy point)
POINTS_B = [{"gen_lr": 2e-3}, tchaos.poison_point("nan"),
            tchaos.poison_point("exit:23", base={"gen_lr": 5e-4})]


def _spec(**over):
    spec = json.loads(json.dumps(TINY_SPEC))
    spec["epochs"] = EPOCHS
    spec.update(over)
    return spec


def _write_batch(run_dir, requests, batch_id="batch-t", spec=None):
    os.makedirs(run_dir, exist_ok=True)
    spec = spec or _spec()
    members = [{"request_id": rid, "tenant": tenant, "trace_id": f"tr-{rid}",
                "points": pts, "spec": spec, "epochs": spec["epochs"]}
               for rid, tenant, pts in requests]
    path = os.path.join(run_dir, "batch.json")
    with open(path, "w") as f:
        json.dump({"batch_id": batch_id, "run_dir": run_dir,
                   "checkpoint_every": 1, "g_bucket": None, "slot": None,
                   "requests": members}, f)
    return path


def _results(run_dir):
    out = {}
    rdir = os.path.join(run_dir, "results")
    for name in sorted(os.listdir(rdir)):
        path = os.path.join(rdir, name)
        if name.endswith(".partial.jsonl"):
            with open(path) as f:
                out[name] = [json.loads(line) for line in f]
        elif name.endswith(".json"):
            with open(path) as f:
                out[name] = json.load(f)
    with open(os.path.join(run_dir, "failures.json")) as f:
        out["failures.json"] = json.load(f)
    out["manifest"] = [r for r in read_jsonl(run_dir)
                       if r.get("event") == "fleet"]
    return out


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Both packages' ``run_batch_file`` on the same batch, from one JAX
    init; returns (jax results, port results). The patches are undone
    before the fixture returns."""
    base = tmp_path_factory.mktemp("rb")
    carried = {}
    jfit, tfit = jgrid.RedcliffGridRunner.fit, tgrid.RedcliffGridRunner.fit

    def jax_fit(self, key, train_ds, val_ds, **kw):
        init = self.init_grid(key)
        carried["init"] = jax.tree.map(np.asarray, init)
        return jfit(self, key, train_ds, val_ds, init_params=init, **kw)

    def port_fit(self, key=None, train_ds=None, val_ds=None, **kw):
        init = interop.grid_state_from_jax(*carried["init"])
        return tfit(self, key, train_ds, val_ds, init_params=init, **kw)

    requests = [("req-a", "alice", POINTS_A), ("req-b", "bob", POINTS_B)]
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrid.RedcliffGridRunner, "fit", jax_fit)
        mp.setattr(tgrid.RedcliffGridRunner, "fit", port_fit)
        mp.delenv("REDCLIFF_FAULT_INJECT", raising=False)
        for name, rb, kw in (("jax", jrb, {}), ("port", trb,
                                                {"device": "cpu"})):
            run_dir = str(base / name)
            rb.run_batch_file(_write_batch(run_dir, requests), **kw)
            out.append((run_dir, _results(run_dir)))
    return out


def _strip_paths(obj, run_dir):
    return json.loads(json.dumps(obj).replace(run_dir, "<run>"))


def test_request_results_match_jax_at_grid_bars(parity):
    (jdir, jres), (tdir, tres) = parity
    for rid, n in (("req-a", 2), ("req-b", 3)):
        j, t = jres[f"{rid}.json"], tres[f"{rid}.json"]
        assert t["n_points"] == j["n_points"] == n
        assert t["best_epoch"] == j["best_epoch"]
        assert t["active"] == j["active"]
        for key in ("best_criteria", "val_history"):
            jv = np.asarray(j[key], dtype=np.float64)
            tv = np.asarray(t[key], dtype=np.float64)
            assert tv.shape == jv.shape
            np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{rid} {key}")
        assert (t["quality"] is None) == (j["quality"] is None)
        if t["quality"] is not None:
            assert t["quality"]["windows"] == j["quality"]["windows"]
        for k in ("request_id", "tenant", "batch_id"):
            assert t[k] == j[k]


def test_failures_manifest_and_final_rows_match_jax(parity):
    (jdir, jres), (tdir, tres) = parity
    # failures.json: the poison point quarantined in both, attributed to
    # its owner; the per-request failures slice equal
    jf, tf = jres["failures.json"], tres["failures.json"]
    assert tf == jf
    assert [(f["point"], f["request_id"], f["tenant"], f["cause"])
            for f in tf["failures"]] == [(3, "req-b", "bob",
                                          "nonfinite_grad")]
    assert tres["req-b.json"]["failures"] == jres["req-b.json"]["failures"]
    # the manifest event (request -> merged point range) equal
    strip = lambda recs, d: [  # noqa: E731
        {k: v for k, v in _strip_paths(r, d).items()
         if k not in ("wall_time", "seq", "pid", "host", "trace")}
        for r in recs]
    assert strip(tres["manifest"], tdir) == strip(jres["manifest"], jdir)
    assert tres["manifest"][0]["n_points"] == 5
    # the streamed rows: the last row per point is final unless the lane
    # retired early (the quarantined point streams at its check window),
    # with the same epochs, flags and point ids; criteria at the grid bars
    for rid in ("req-a", "req-b"):
        jrows = jres[f"{rid}.partial.jsonl"]
        trows = tres[f"{rid}.partial.jsonl"]
        last = lambda rows: {r["point"]: r for r in rows}  # noqa: E731
        jl, tl = last(jrows), last(trows)
        assert sorted(tl) == sorted(jl)
        for p in tl:
            assert tl[p]["final"] == (not tl[p]["failed"])
            for k in ("final", "epoch", "best_epoch", "failed",
                      "merged_point",
                      "request_id", "tenant", "batch_id"):
                assert tl[p][k] == jl[p][k], (rid, p, k)
            jb, tb = jl[p]["best_criterion"], tl[p]["best_criterion"]
            assert (jb is None) == (tb is None)
            if tb is not None:
                np.testing.assert_allclose(tb, jb, rtol=RTOL, atol=ATOL)
    # the events the port's child wrote validate against the registry
    from redcliff_tpu_torch.obs import schema

    assert schema.validate_records(read_jsonl(tdir)) == []


def test_lane_seed_and_merge_keys_match_jax():
    pts = POINTS_A + [tchaos.strip_chaos(p) for p in POINTS_B]
    assert [trb.lane_seed(p) for p in pts] == [jrb.lane_seed(p) for p in pts]
    assert trb._MERGE_KEYS == jrb._MERGE_KEYS
    spec = _spec()
    assert trb._canon(spec) == jrb._canon(spec)


def test_request_fits_bitwise_alone_and_merged(tmp_path):
    """Content-derived lane seeds: request A's results are bit for bit the
    same whether it runs alone or merged with B (the containment
    guarantee bisection relies on)."""
    alone = str(tmp_path / "alone")
    merged = str(tmp_path / "merged")
    trb.run_batch_file(_write_batch(alone, [("req-a", "alice", POINTS_A)],
                                    batch_id="batch-1"), device="cpu")
    trb.run_batch_file(_write_batch(merged, [
        ("req-b", "bob", POINTS_B[:1]), ("req-a", "alice", POINTS_A)],
        batch_id="batch-2"), device="cpu")
    with open(os.path.join(alone, "results", "req-a.json")) as f:
        a = json.load(f)
    with open(os.path.join(merged, "results", "req-a.json")) as f:
        m = json.load(f)
    for key in ("best_criteria", "best_epoch", "val_history", "active",
                "failures"):
        assert a[key] == m[key], key


def test_mesh_auto_fits_a_batch_on_a_simulated_pool(tmp_path):
    """``mesh: "auto"`` over a pool of two CPU entries (``sim_devices``),
    and a packed slot of that pool, each fit the batch bit for bit as the
    unmeshed child does (a sharded port grid is the unsharded one's
    arithmetic on fewer lanes)."""
    results = {}
    for name, spec, slot, sim in (
            ("plain", _spec(), None, None),
            ("auto", _spec(mesh="auto"), None, 2),
            ("slot", _spec(mesh="auto"), {"lo": 0, "width": 2}, 2)):
        run_dir = str(tmp_path / name)
        path = _write_batch(run_dir, [("req-a", "alice", POINTS_A)],
                            spec=spec)
        with open(path) as f:
            batch = json.load(f)
        batch["slot"] = slot
        with open(path, "w") as f:
            json.dump(batch, f)
        res = trb.run_batch_file(path, device="cpu", sim_devices=sim)
        results[name] = (_results(run_dir), res.dispatch_stats)
    assert [e["event"] for e in read_jsonl(
        str(tmp_path / "auto"), event="fit_start")] == ["fit_start"]
    assert read_jsonl(str(tmp_path / "auto"), event="fit_start")[0][
        "mesh"]["n_devices"] == 2
    want = results["plain"][0]["req-a.json"]
    for name in ("auto", "slot"):
        got = results[name][0]["req-a.json"]
        for key in ("best_criteria", "best_epoch", "val_history", "active",
                    "failures"):
            assert got[key] == want[key], (name, key)


def test_merge_key_mismatch_refused_as_in_jax(tmp_path):
    run_dir = str(tmp_path / "mm")
    path = _write_batch(run_dir, [("req-a", "alice", POINTS_A)])
    with open(path) as f:
        batch = json.load(f)
    other = dict(batch["requests"][0], request_id="req-z",
                 spec=_spec(epochs=EPOCHS + 1))
    batch["requests"].append(other)
    with open(path, "w") as f:
        json.dump(batch, f)
    for rb, kw in ((jrb, {}), (trb, {"device": "cpu"})):
        with pytest.raises(ValueError, match="disagree on the non-point"):
            rb.run_batch_file(path, **kw)


def _child(module, batch, env, extra=()):
    return subprocess.run([sys.executable, "-m", module, batch, *extra],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)


def test_armed_fleet_poison_detonates_with_jax_exit_code(tmp_path):
    """``REDCLIFF_FAULT_INJECT=fleet_poison`` arms the sentinels: both
    children exit with the poison's code before any fit (no results)."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               REDCLIFF_FAULT_INJECT="fleet_poison")
    rcs = []
    for name, module, extra in (
            ("jax", "redcliff_tpu.fleet.run_batch", ()),
            ("port", "redcliff_tpu_torch.fleet.run_batch",
             ("--device", "cpu"))):
        run_dir = str(tmp_path / name)
        batch = _write_batch(run_dir, [("req-b", "bob", POINTS_B)])
        r = _child(module, batch, env, extra)
        rcs.append(r.returncode)
        assert not os.path.exists(os.path.join(run_dir, "results"))
    assert rcs == [23, 23]


def test_child_without_cuda_fails_before_writing(tmp_path):
    """No ``--device`` and no CUDA: the child exits non-zero with the
    device error and writes nothing (no metrics, no results)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the child would fit there")
    run_dir = str(tmp_path / "nocuda")
    batch = _write_batch(run_dir, [("req-a", "alice", POINTS_A)])
    r = _child("redcliff_tpu_torch.fleet.run_batch", batch,
               dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 1 and "CUDA is not available" in r.stderr
    assert sorted(os.listdir(run_dir)) == ["batch.json"]
    assert trb.main(["a", "b"]) == 2 and trb.main(["--device", "cpu"]) == 2
