"""The port's telemetry spine (redcliff_tpu_torch/obs/*,
runtime/compileobs.py, utils/observability.py) against the JAX package's
(redcliff_tpu/obs/*), and the events both trainers and the grid emit.

The primitives take the same inputs in both packages: ``jsonable``, the
MetricLogger's identity triple, rotation and torn-tail reads, the spans'
parent chain and bounded ring, the counters, the flight dump, the schema
registry, the quality monitor's host half (bit for bit), the analytical
footprints (equal integers), and the capture-window specs. The event
parity tests fit the same copied weights on the same batch order through
the per-point trainer, the generic trainer (a cMLP-FM GISTA fit) and the
grid (4 points, per batch, a deadline eviction and a compaction) in both
packages, with ``REDCLIFF_QUALITY=1`` and a truth graph, and hold the two
``metrics.jsonl`` streams to each other: the same event names in order,
the same field sets (identity and timing aside), losses and criteria at
the trainer bar, quality values at rtol 1e-5 / atol 1e-5, decisions
exact, every port record valid under both registries. Two kinds of the
JAX grid's events are left out of the comparison: ``compile`` (its XLA
compiles have no CPU counterpart in the port, whose ``compile`` events
count CUDA-graph captures; the card's smoke checks them) and
``cost_model``, from both streams (each package scores epochs against a
store under the compile-cache directory tests/conftest.py sets, which
other tests keep folding into; tests/test_torch_costmodel.py holds the
two cost models to each other).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.obs import flight as jflight  # noqa: E402
from redcliff_tpu.obs import logging as jlog  # noqa: E402
from redcliff_tpu.obs import memory as jmem  # noqa: E402
from redcliff_tpu.obs import profiling as jprof  # noqa: E402
from redcliff_tpu.obs import quality as jq  # noqa: E402
from redcliff_tpu.obs import schema as jschema  # noqa: E402
from redcliff_tpu.obs import spans as jspans  # noqa: E402
from redcliff_tpu.parallel import compaction as jcompaction  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch import obs as tobs  # noqa: E402
from redcliff_tpu_torch.obs import flight as tflight  # noqa: E402
from redcliff_tpu_torch.obs import logging as tlog  # noqa: E402
from redcliff_tpu_torch.obs import memory as tmem  # noqa: E402
from redcliff_tpu_torch.obs import profiling as tprof  # noqa: E402
from redcliff_tpu_torch.obs import quality as tq  # noqa: E402
from redcliff_tpu_torch.obs import schema as tschema  # noqa: E402
from redcliff_tpu_torch.obs import spans as tspans  # noqa: E402
from redcliff_tpu_torch.parallel import compaction as tcompaction  # noqa: E402,E501
from redcliff_tpu_torch.runtime import compileobs  # noqa: E402

import test_torch_grid as G  # noqa: E402
import test_torch_train as TT  # noqa: E402
import test_torch_trainer as GT  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# identity and timing fields: per process and per clock, never compared
IDENTITY = {"wall_time", "seq", "pid", "host", "trace", "span_id",
            "parent_id"}
TIMING = {"epoch_ms", "dur_ms", "elapsed_s", "t_wall", "t_mono"}
TRAINER_BAR = dict(rtol=1e-5, atol=1e-6)
QUALITY_BAR = dict(rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- logging
def test_jsonable_matches_jax_and_takes_tensors():
    v = {"int": np.int64(3), "float": np.float32(1.5),
         "arr": np.arange(4).reshape(2, 2), "nan": float("nan"),
         "inf_arr": np.array([1.0, np.inf], np.float32),
         "cfg": GT.ttr.TrainConfig(learning_rate=0.5),
         "nested": [np.float64(2.0), ("a", np.int32(1))]}
    assert tlog.jsonable(v) == jlog.jsonable(v)
    out = tlog.jsonable({"t": torch.arange(4).reshape(2, 2),
                         "f": torch.tensor([0.5, float("nan")]),
                         "b": torch.tensor(1.5, dtype=torch.bfloat16),
                         "s": torch.tensor(2)})
    assert out == {"t": [[0, 1], [2, 3]], "f": [0.5, None], "b": 1.5,
                   "s": 2}
    json.dumps(out, allow_nan=False)


def _write_both(tmp_path, n, **kw):
    for name, mod in (("jax", jlog), ("port", tlog)):
        with mod.MetricLogger(str(tmp_path / name), **kw) as log:
            for i in range(n):
                log.log("epoch", epoch=i, loss=np.float32(0.25 * i))
            log.log("fit_end", best_it=n - 1)


def _strip(recs):
    return [{k: v for k, v in r.items() if k not in IDENTITY}
            for r in recs]


def test_metric_logger_records_and_identity_match_jax(tmp_path):
    _write_both(tmp_path, 3)
    j = jlog.read_jsonl(str(tmp_path / "jax"))
    t = tlog.read_jsonl(str(tmp_path / "port"))
    assert _strip(t) == _strip(j)
    for r in t:
        assert r["pid"] == os.getpid() and r["host"] == jspans.HOST
    assert [r["seq"] for r in t] == sorted(r["seq"] for r in t)
    # two port loggers share one process-wide sequence
    with tlog.MetricLogger(str(tmp_path / "a")) as la, \
            tlog.MetricLogger(str(tmp_path / "b")) as lb:
        la.log("epoch", epoch=0)
        lb.log("epoch", epoch=0)
    assert tlog.read_jsonl(str(tmp_path / "a"))[0]["seq"] \
        < tlog.read_jsonl(str(tmp_path / "b"))[0]["seq"]
    assert len(tlog.read_jsonl(str(tmp_path / "port"), event="epoch")) == 3
    none = tlog.MetricLogger(None)
    assert not none.active
    none.log("epoch", epoch=0)
    none.close()


@pytest.mark.parametrize("how", ["max_bytes", "env"])
def test_rotation_matches_jax(tmp_path, monkeypatch, how):
    kw = {"max_bytes": 400, "max_backups": 3}
    if how == "env":
        monkeypatch.setenv(tlog.ENV_MAX_BYTES, "400")
        kw = {"max_backups": 3}
    _write_both(tmp_path, 60, **kw)
    names = {d: sorted(os.listdir(tmp_path / d)) for d in ("jax", "port")}
    assert names["port"] == names["jax"]
    assert "metrics.jsonl.3" in names["port"]
    assert tlog.jsonl_files(str(tmp_path / "port"))[-1].endswith(
        "metrics.jsonl")
    j = jlog.read_jsonl(str(tmp_path / "jax"))
    t = tlog.read_jsonl(str(tmp_path / "port"))
    assert _strip(t) == _strip(j) and t[-1]["event"] == "fit_end"


def test_torn_and_crashed_tails_read_back_as_jax(tmp_path):
    """A torn final line (a SIGKILL mid-append) is skipped and counted in
    both packages; strict=True raises."""
    _write_both(tmp_path, 3)
    stats = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "metrics.jsonl", "a") as f:
            f.write('{"event": "epoch", "epoch": 3, "wall_ti')
        stats[name] = {}
    j = jlog.read_jsonl(str(tmp_path / "jax"), stats=stats["jax"])
    t = tlog.read_jsonl(str(tmp_path / "port"), stats=stats["port"])
    assert _strip(t) == _strip(j)
    assert stats["port"]["torn_lines"] == stats["jax"]["torn_lines"] == 1
    assert stats["port"]["records"] == stats["jax"]["records"] == 4
    with pytest.raises(json.JSONDecodeError):
        tlog.read_jsonl(str(tmp_path / "port"), strict=True)
    with pytest.raises(FileNotFoundError):
        tlog.read_jsonl(str(tmp_path / "absent"))


# ----------------------------------------------------- spans and flight
def test_span_parent_chain_ring_and_noop():
    tflight.clear()
    with tobs.span("ckpt.write", component="ckpt", file="a.pkl") as outer:
        with tobs.span("ckpt.fsync") as inner:
            pass
    ring = tflight.snapshot()["ckpt"]
    by_name = {r["name"]: r for r in ring}
    assert by_name["ckpt.fsync"]["parent_id"] == \
        by_name["ckpt.write"]["span_id"]
    assert by_name["ckpt.write"]["attrs"] == {"file": "a.pkl"}
    assert outer.dur_ms >= inner.dur_ms
    # the same record shape as JAX's
    jflight.clear()
    with jspans.span("ckpt.write", component="ckpt", file="a.pkl"):
        pass
    assert set(jflight.snapshot()["ckpt"][0]) == set(by_name["ckpt.write"])
    was = tobs.enabled()
    try:
        tobs.set_enabled(False)
        assert tobs.span("grid.dispatch") is tobs.NOOP
        assert tobs.record_span("x", 1.0) is None
    finally:
        tobs.set_enabled(was)
    rec = tflight.FlightRecorder(capacity=5)
    for i in range(20):
        rec.record("c", {"i": i})
    assert [r["i"] for r in rec.snapshot()["c"]] == list(range(15, 20))


def test_span_emit_and_counters_match_jax(tmp_path):
    for name, mod, sp in (("jax", jlog, jspans), ("port", tlog, tspans)):
        with mod.MetricLogger(str(tmp_path / name)) as log:
            with sp.span("grid.check_window", logger=log, emit=True,
                         epoch=3, width=8):
                pass
            sp.record_span("grid.compaction", 12.5, logger=log, emit=True,
                           epoch=3, from_width=8, to_width=4)
    j = jlog.read_jsonl(str(tmp_path / "jax"), event="span")
    t = tlog.read_jsonl(str(tmp_path / "port"), event="span")
    assert [set(r) - IDENTITY for r in t] == [set(r) - IDENTITY for r in j]
    assert [(r["name"], r["attrs"]) for r in t] == \
        [(r["name"], r["attrs"]) for r in j]
    assert not tschema.validate_records(t)
    assert not jschema.validate_records(t)
    deltas = []
    for sp in (jspans, tspans):
        c = sp.Counters()
        before = c.snapshot()
        c.add("prefetch_stall_ms", 2.5)
        c.add("prefetch_stall_ms", 1.5)
        c.add("prefetch_items")
        deltas.append(c.delta(before))
    assert deltas[0] == deltas[1] == {"prefetch_stall_ms": 4.0,
                                      "prefetch_items": 1.0}


def test_flight_dump_is_strict_json_as_jax(tmp_path):
    dumps = {}
    for name, fl, sp in (("jax", jflight, jspans), ("port", tflight,
                                                      tspans)):
        fl.clear()
        with sp.span("prefetch.fill", component="prefetch", batch=7):
            pass
        p = fl.dump(str(tmp_path / name), reason="numerics_abort",
                    extra={"epoch": 2, "bad": float("nan")})
        with open(p) as f:
            dumps[name] = json.load(f)
    t, j = dumps["port"], dumps["jax"]
    assert set(t) == set(j) and t["extra"] == j["extra"] == {
        "epoch": 2, "bad": None}
    assert [r["name"] for r in t["components"]["prefetch"]] == \
        ["prefetch.fill"]
    assert not tschema.validate_record(t)
    assert tflight.dump_for_logger(None, "x") is None
    assert tflight.dump_for_logger(tlog.MetricLogger(None), "x") is None


# ---------------------------------------------------------------- schema
def test_registry_equals_jax_field_for_field():
    """EVENTS, LEDGER_EVENTS and SPAN_NAMES are JAX's; only the emitter
    prose the module docstring lists differs."""
    reworded = {"profile", "memory", "precision", "policy", "preempt",
                "packing", "partial_result", "fleet_lifecycle",
                "serve_ladder"}
    assert tschema.SPAN_NAMES == jschema.SPAN_NAMES
    assert tschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert tschema.SHAPE_KEYS == jschema.SHAPE_KEYS
    for port, jax_ in ((tschema.EVENTS, jschema.EVENTS),
                       (tschema.LEDGER_EVENTS, jschema.LEDGER_EVENTS)):
        assert port.keys() == jax_.keys()
        for name in jax_:
            p, j = port[name], jax_[name]
            assert (p.required, p.optional, p.patterns, p.version) == \
                (j.required, j.optional, j.patterns, j.version), name
            if name not in reworded or port is tschema.LEDGER_EVENTS:
                assert p.emitter == j.emitter, name
    assert "torch.profiler" in tschema.EVENTS["profile"].emitter
    rec = {"event": "epoch", "wall_time": 1.0, "epoch": 0,
           "f1_t0.5_factor2": 0.3, "combo_loss": 1.0}
    assert tschema.validate_record(rec) == jschema.validate_record(rec) == []
    bad = dict(rec, bogus=1)
    assert len(tschema.validate_record(bad)) == 1
    assert tschema.validate_record({"event": "nope", "wall_time": 0})
    shape = tschema.shape_desc(G._models()[1].config)
    assert shape == jschema.shape_desc(G._models()[0].config)
    assert tschema.shape_key(shape) == jschema.shape_key(shape)


def test_source_tripwire_clean_and_catches_drift(tmp_path):
    """Every event and span name literal in redcliff_tpu_torch/ is
    registered, no module imports jax, and the observability modules do no
    CUDA work at import and never synchronize."""
    assert tschema.check_sources() == []
    pkg = tmp_path / "pkg"
    (pkg / "obs").mkdir(parents=True)
    (pkg / "obs" / "memory.py").write_text(
        "import triton\nimport redcliff_tpu_torch.ops.factor_mix\n"
        "def f(torch, log, span):\n"
        "    import triton\n    torch.cuda.synchronize()\n"
        "    log('not_an_event', x=1)\n    span('not.a.span')\n")
    (pkg / "other.py").write_text("import jax\n")
    errs = tschema.check_sources(str(pkg))
    kinds = sorted(e.split(": ", 1)[1].split(" ")[0] for e in errs)
    assert len(errs) == 6, errs
    assert sum("module scope" in e for e in errs) == 2
    assert any("synchronize" in e for e in errs)
    assert any("imports jax" in e for e in errs), kinds
    r = subprocess.run([sys.executable, "-m", "redcliff_tpu_torch.obs.schema",
                        "--check"], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "0 violation" in r.stdout, r.stdout


# ------------------------------------------------------ quality host half
def test_quality_host_units_bit_identical_to_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 5)).astype(np.float32)
    A.ravel()[3] = A.ravel()[7]  # a tie
    for k in (1, 6, 25, 40):
        np.testing.assert_array_equal(tq.topk_indices_np(A, k),
                                      jq.topk_indices_np(A, k))
    for a, b in (([1, 2, 3], [1, 2, 3]), ([1, 2], [3, 4]),
                 ([1, 2, 3], [2, 3, 4]), ([], [])):
        assert tq.jaccard(a, b) == jq.jaccard(a, b)
    assert tq.topk_hash([3, 1, 2]) == jq.topk_hash([2, 3, 1])
    for labels, scores in (([1, 1, 0, 0], [4, 3, 2, 1]), ([0, 0], [1, 2]),
                           ([1, 0, 1, 0], [4, 3, 2, 1]),
                           (rng.random(30) > 0.6, rng.normal(size=30))):
        assert tq.average_precision(labels, scores) == \
            jq.average_precision(labels, scores)
    truth = [rng.random((4, 4, 2)) * (rng.random((4, 4, 2)) > 0.5)
             for _ in range(3)]
    est = rng.normal(size=(3, 4, 4)).astype(np.float32)
    assert tq.graph_scores(truth, est) == jq.graph_scores(truth, est)
    assert tq.graph_scores([np.ones((2, 2))], est[:1, :2, :2]) == \
        jq.graph_scores([np.ones((2, 2))], est[:1, :2, :2])
    mats = [rng.normal(size=(4, 4, 3)).astype(np.float32) for _ in range(2)]
    t, j = tq.summarize_host(mats, k=5), jq.summarize_host(mats, k=5)
    assert t.keys() == j.keys()
    for key in j:
        if j[key] is None:
            assert t[key] is None
        else:
            assert t[key].dtype == j[key].dtype
            np.testing.assert_array_equal(t[key], j[key])


def _summary(energy, topk, seed=0, C=4, K=2):
    rng = np.random.default_rng(seed)
    n = len(energy)
    return {"gc": rng.random((n, K, C, C)).astype(np.float32),
            "col_norms": rng.random((n, K, C)).astype(np.float32),
            "edge_energy": np.asarray(energy, np.float32),
            "sparsity": np.full((n,), 0.5, np.float32),
            "topk_idx": np.asarray(topk, np.int32),
            "topk_val": rng.random((n, len(topk[0]))).astype(np.float32),
            "entropy": np.full((n,), 0.3, np.float32)}


def test_quality_monitor_sequences_bit_identical_to_jax():
    """Plateau confirmation and reset, Jaccard over changing top-k sets,
    original point ids with filler lanes skipped, AUROC/AUPR with truth."""
    rng = np.random.default_rng(2)
    truth = [rng.random((4, 4)) * (rng.random((4, 4)) > 0.5)
             for _ in range(2)]
    windows = [([10.0, 1.0, 3.0], [[0, 1, 2], [1, 2, 3], [4, 5, 6]]),
               ([10.0, 1.0, 3.0], [[0, 1, 2], [1, 2, 9], [4, 5, 6]]),
               ([20.0, 1.001, 3.0], [[0, 1, 2], [1, 2, 9], [4, 5, 7]]),
               ([20.0, 1.0, 3.0], [[0, 1, 3], [1, 2, 9], [4, 5, 7]]),
               ([20.0, 1.0, 3.0], [[0, 1, 3], [1, 2, 9], [4, 5, 7]])]
    for kw in (dict(window=2, tol=0.01), dict(true_gc=truth, window=1,
                                              tol=0.5, mode="m")):
        tm, jm = tq.QualityMonitor(**kw), jq.QualityMonitor(**kw)
        for epoch, (e, topk) in enumerate(windows):
            host = _summary(e, topk, seed=epoch)
            assert tm.update(epoch, host, [-1, 5, 2]) == \
                jm.update(epoch, host, [-1, 5, 2])
        assert tm.snapshot() == jm.snapshot()
        assert tm.plateaued == jm.plateaued and tm.plateaued


# ----------------------------------------------------------------- memory
def test_footprints_equal_jax_integers():
    jm, tm = G._models()
    fjm, ftm = G._models(G.FREEZE_MODE)
    X, Y = G._data()
    jds, tds = G.JDataset(X, Y), G.TDataset(X, Y)
    assert tmem.param_bytes(tm) == jmem.param_bytes(jm)
    for g in (1, 5, tcompaction.bucket_width(5), 27, 32):
        for kw in (dict(stream_mode="per_batch"), dict(stream_mode="epoch"),
                   dict(stream_mode=None)):
            assert tmem.grid_footprint(tm, None, g, **kw) == \
                jmem.grid_footprint(jm, None, g, **kw)
            assert tmem.grid_footprint(tm, None, g, train_ds=tds,
                                       val_ds=tds, **kw) == \
                jmem.grid_footprint(jm, None, g, train_ds=jds, val_ds=jds,
                                    **kw)
        assert tmem.grid_footprint(ftm, None, g) == \
            jmem.grid_footprint(fjm, None, g)
    ep = tmem.grid_footprint(tm, None, 4, train_ds=tds, val_ds=tds,
                             stream_mode="epoch")
    assert ep["dataset_bytes"] == 2 * (X.nbytes + Y.nbytes)
    assert ep["epoch_gather_bytes"] == X.nbytes + Y.nbytes
    for g_real, n_dev, mx in ((5, 1, None), (27, 1, None), (9, 4, 64)):
        assert tmem.footprint_by_bucket(tm, None, g_real, n_dev, mx) == \
            jmem.footprint_by_bucket(jm, None, g_real, n_dev, mx)
        assert tcompaction.ladder_widths(g_real, n_dev, mx) == \
            jcompaction.ladder_widths(g_real, n_dev, mx)
    params = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    for extra in (1, 2):
        assert tmem.trainer_footprint(
            interop.params_from_jax(np_params), (np_params, np_params),
            extra_copies=extra, train_ds=tds, val_ds=tds) == \
            jmem.trainer_footprint(params, (params, params),
                                   extra_copies=extra, train_ds=jds,
                                   val_ds=jds)


def test_headroom_degrades_explicitly_on_cpu(monkeypatch):
    assert tmem.device_memory_stats() is None
    assert tmem.device_memory_stats("cpu") is None
    assert tmem.poll_watermark() is None
    assert tmem.poll_watermark(["cpu"]) is None
    hr = tmem.check_headroom(1 << 30, devices=["cpu"])
    assert hr == jmem.check_headroom(1 << 30) == {
        "fits": None, "bytes_limit": None, "budget_bytes": None,
        "headroom_bytes": None, "backend": "cpu"}
    for flag, want in (("0", False), ("off", False), ("1", True)):
        monkeypatch.setenv(tmem.ENV_MEM_POLL, flag)
        assert tmem.polling_enabled() is want is jmem.polling_enabled()


# -------------------------------------------------------------- profiling
def test_parse_window_accepts_and_rejects_as_jax():
    for spec in (None, "", "off", "0", "false", "none", "epoch:3",
                 "epoch:2-4", " EPOCH:1 "):
        assert tprof.parse_window(spec) == jprof.parse_window(spec)
    for bad in ("epoch", "step:3", "epoch:x", "epoch:4-2", "epoch:-1",
                "epoch:1-"):
        with pytest.raises(ValueError):
            jprof.parse_window(bad)
        with pytest.raises(ValueError):
            tprof.parse_window(bad)


def test_window_for_alias_and_explicit_off_as_jax(tmp_path, monkeypatch):
    monkeypatch.delenv(tprof.ENV_PROFILE, raising=False)

    def resolve(pd, pwin, max_iter, run_dir=None):
        c = type("C", (), {"profile_dir": pd, "profile_window": pwin})()
        j = jprof.window_for(c, run_dir=run_dir, max_iter=max_iter)
        t = tprof.window_for(c, run_dir=run_dir, max_iter=max_iter,
                             device="cpu")
        if j is jprof.NOOP:
            assert t is tprof.NOOP
            return None
        assert (t.first_epoch, t.last_epoch, t.spec, t.out_dir) == \
            (j.first_epoch, j.last_epoch, j.spec, j.out_dir)
        return t

    prof = str(tmp_path / "prof")
    assert resolve(prof, None, 10).first_epoch == 1
    assert resolve(prof, None, 1).first_epoch == 0
    assert resolve(None, None, 10, run_dir=str(tmp_path)) is None
    assert resolve(None, "epoch:2-3", 10, run_dir=str(tmp_path)).out_dir \
        == os.path.join(str(tmp_path), "profile")
    assert resolve(None, "epoch:2", 10) is None  # nowhere to write
    assert resolve(prof, "off", 10) is None
    monkeypatch.setenv(tprof.ENV_PROFILE, "0")
    assert resolve(prof, None, 10) is None
    monkeypatch.setenv(tprof.ENV_PROFILE, "epoch:4")
    assert resolve(prof, None, 10).first_epoch == 4
    assert not tprof.window_for(
        type("C", (), {"profile_dir": prof, "profile_window": None})(),
        device="cpu").cuda


def test_truncated_window_reports_captured_range(tmp_path):
    win = tprof.CaptureWindow(str(tmp_path / "prof"), 1, 10)
    with tlog.MetricLogger(str(tmp_path)) as log, win:
        for e in range(4):  # the fit ends at epoch 3, inside the window
            win.on_epoch_start(e)
            win.on_epoch_end(e, logger=log)
    p, = tlog.read_jsonl(str(tmp_path), event="profile")
    assert p["truncated"] and (p["first_epoch"], p["last_epoch"]) == (1, 3)
    assert p["path"] == win.path and os.path.isfile(p["path"])
    assert not tschema.validate_record(p)
    assert not jschema.validate_record(p)


def _slice_fit(tmp, save_dir, **over):
    jm, tm, jp = TT._slice_models()
    X, Y = TT._slice_data()
    tc = TT.ttr.RedcliffTrainConfig(max_iter=3, batch_size=40,
                                    check_every=1, prox_penalty="GL",
                                    prox_lam=0.5, **over)
    return TT.ttr.RedcliffTrainer(tm, tc, device="cpu").fit(
        jp, TT.tds.ArrayDataset(X[:64], Y[:64]),
        TT.tds.ArrayDataset(X[64:], Y[64:]),
        true_GC=_truth(3), save_dir=None if save_dir is None
        else str(tmp / save_dir))


def _truth(k, C=4, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.random((C, C, 2)) > 0.5).astype(np.float32)
            for _ in range(k)]


def test_capture_window_and_telemetry_leave_the_fit_bit_identical(
        tmp_path, monkeypatch):
    """A CPU capture window over epoch 1 of a tiny per-point fit writes a
    Chrome trace and a ``profile`` event; the fit with the window, the
    quality readouts and the metrics log on equals the fit with all of
    them off, bit for bit."""
    monkeypatch.delenv(tprof.ENV_PROFILE, raising=False)
    monkeypatch.setenv(tq.ENV_ENABLE, "1")
    on = _slice_fit(tmp_path, "on", profile_window="epoch:1")
    monkeypatch.setenv(tq.ENV_ENABLE, "0")
    off = _slice_fit(tmp_path, None)
    for a, b in zip(interop.tree_leaves(on.params),
                    interop.tree_leaves(off.params)):
        assert torch.equal(a, b)
    np.testing.assert_equal(on.histories, off.histories)
    assert on.best_it == off.best_it
    recs = tlog.read_jsonl(str(tmp_path / "on"))
    p, = [r for r in recs if r["event"] == "profile"]
    assert (p["first_epoch"], p["last_epoch"], p["truncated"]) == \
        (1, 1, False)
    assert p["path"].startswith(str(tmp_path / "on" / "profile"))
    with open(p["path"]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    names = [r["event"] for r in recs]
    assert names.index("profile") == names.index("quality", 4) + 1


# ------------------------------------------------- event parity with JAX
def _cmp(got, want, tol, path):
    if isinstance(want, float) or isinstance(got, float):
        np.testing.assert_allclose(got, want, err_msg=path, **tol)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _cmp(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _cmp(got[k], want[k], tol, f"{path}.{k}")
    else:
        assert got == want, (path, got, want)


def _assert_streams_match(jrecs, trecs, skip=()):
    """Event names in order, field sets, and values: quality at its bar,
    every other number at the trainer bar, everything else exact; fields
    in ``skip`` (per event) and identity/timing fields aside."""
    assert [r["event"] + r.get("name", "") for r in trecs] == \
        [r["event"] + r.get("name", "") for r in jrecs]
    assert not tschema.validate_records(trecs)
    assert not jschema.validate_records(trecs)
    for j, t in zip(jrecs, trecs):
        ev = j["event"]
        assert set(t) - IDENTITY - TIMING == set(j) - IDENTITY - TIMING, ev
        for k in set(j) - IDENTITY - TIMING - set(skip.get(ev, ())):
            tol = (QUALITY_BAR if "quality" in (ev, k) else TRAINER_BAR)
            _cmp(t[k], j[k], tol, f"{ev}.{k}")


def test_redcliff_trainer_events_match_jax(tmp_path, monkeypatch):
    """The per-point fit (the slice's schedule at a tiny width, GL prox, a
    truth graph), with ``nan_batch:5`` armed so the stream holds an
    ``anomaly``: the port skips the step JAX skips."""
    monkeypatch.setenv(tq.ENV_ENABLE, "1")
    monkeypatch.setenv("REDCLIFF_FAULT_INJECT", "nan_batch:5")
    jm, tm, jp = TT._slice_models()
    X, Y = TT._slice_data()
    kw = dict(max_iter=3, batch_size=16, check_every=1, prox_penalty="GL",
              prox_lam=0.5)
    truth = _truth(3)
    TT.jtr.RedcliffTrainer(jm, TT.jtr.RedcliffTrainConfig(**kw)).fit(
        jp, TT.jds.ArrayDataset(X[:64], Y[:64]),
        TT.jds.ArrayDataset(X[64:], Y[64:]), true_GC=truth,
        save_dir=str(tmp_path / "jax"))
    TT.ttr.RedcliffTrainer(tm, TT.ttr.RedcliffTrainConfig(**kw),
                           device="cpu").fit(
        jp, TT.tds.ArrayDataset(X[:64], Y[:64]),
        TT.tds.ArrayDataset(X[64:], Y[64:]), true_GC=truth,
        save_dir=str(tmp_path / "port"))
    j = jlog.read_jsonl(str(tmp_path / "jax"))
    t = tlog.read_jsonl(str(tmp_path / "port"))
    assert [r["event"] for r in t] == [
        "fit_start", "memory", "epoch", "quality", "anomaly", "epoch",
        "quality", "epoch", "quality", "fit_end"]
    # the JAX optimizer states also count their step counts and injected
    # learning rates (scalars); the port's Adam moments alone
    _assert_streams_match(j, t, skip={
        "fit_start": ("train_config",),
        "memory": ("opt_bytes", "predicted_bytes")})
    mem = t[1]
    assert mem["opt_bytes"] == 2 * mem["params_bytes"] // 3
    assert t[4]["epoch_skipped_steps"] == 1 and t[4]["epoch"] == 1


def test_generic_trainer_events_match_jax(tmp_path, monkeypatch):
    """A cMLP-FM GISTA fit through the generic Trainer, quality on the host
    twin of the family's readout."""
    monkeypatch.setenv(tq.ENV_ENABLE, "1")
    jm, tm, jp = GT._models("cmlp_fm_gista")
    GT._fit(GT.jtr, GT.jds, jm, jp, "cmlp_fm_gista", tmp_path / "jax",
            true_gc=GT._true_gc())
    GT._fit(GT.ttr, GT.tds, tm, jp, "cmlp_fm_gista", tmp_path / "port",
            true_gc=GT._true_gc(), device="cpu")
    j = jlog.read_jsonl(str(tmp_path / "jax"))
    t = tlog.read_jsonl(str(tmp_path / "port"))
    assert [r["event"] for r in t][:4] == ["fit_start", "memory", "epoch",
                                           "quality"]
    assert t[3]["mode"] == "host_readout" and t[3]["entropy"] == [None]
    _assert_streams_match(j, t, skip={
        "fit_start": ("train_config",),
        "memory": ("opt_bytes", "predicted_bytes")})


@pytest.mark.parametrize("trainer", ["redcliff", "generic"])
def test_quality_readout_needs_a_metrics_log(tmp_path, monkeypatch,
                                             trainer):
    """With ``REDCLIFF_QUALITY=1`` but no ``save_dir`` the readout lands
    nowhere, so neither trainer builds it: no summary function, no
    monitor, no readout forward."""
    def refuse(*a, **k):
        raise AssertionError("quality readout built without a save_dir")
    monkeypatch.setenv(tq.ENV_ENABLE, "1")
    monkeypatch.setattr(tq, "make_summary_fn", refuse)
    monkeypatch.setattr(tq, "QualityMonitor", refuse)
    if trainer == "redcliff":
        res = _slice_fit(tmp_path, None)
    else:
        jm, tm, jp = GT._models("cmlp_fm_gista")
        res = GT._fit(GT.ttr, GT.tds, tm, jp, "cmlp_fm_gista",
                      true_gc=GT._true_gc(), device="cpu")
    assert res.best_it is not None
    assert not os.listdir(tmp_path)


def test_grid_events_match_jax(tmp_path, monkeypatch):
    """4 points per batch on the ladder from the JAX grid's init: two lanes
    evicted by their deadline at epoch 0, the grid compacted 4 -> 2."""
    monkeypatch.setenv(tq.ENV_ENABLE, "1")
    jm, tm = G._models()
    X, Y = G._data()
    points = [{"gen_lr": 1e-3}, {"gen_lr": 5e-3}, {"gen_lr": 2e-3},
              {"embed_lr": 2e-3}]
    deadlines = [float("inf"), 1e-9, 1e-9, float("inf")]
    knobs = dict(G.KNOBS, stream_mode="per_batch")
    truth = _truth(2)
    jrun = G.jgrid.RedcliffGridRunner(
        jm, G.jtr.RedcliffTrainConfig(**knobs),
        G.jgrid.GridSpec(points=points, fit_deadline_s=deadlines))
    init = jrun.init_grid(jax.random.PRNGKey(5))
    jrun.fit(jax.random.PRNGKey(5), G.JDataset(X, Y), G.JDataset(X, Y),
             init_params=init, log_dir=str(tmp_path / "jax"), true_gc=truth)
    trun = G.tgrid.RedcliffGridRunner(
        tm, G.ttr.RedcliffTrainConfig(**knobs),
        G.tgrid.GridSpec(points=points, fit_deadline_s=deadlines),
        device="cpu")
    tres = trun.fit(None, G.TDataset(X, Y), G.TDataset(X, Y),
                    init_params=interop.grid_state_from_jax(
                        *jax.tree.map(np.asarray, init)),
                    log_dir=str(tmp_path / "port"), true_gc=truth)
    j = [r for r in jlog.read_jsonl(str(tmp_path / "jax"))
         if r["event"] not in ("compile", "cost_model")]
    t = [r for r in tlog.read_jsonl(str(tmp_path / "port"))
         if r["event"] != "cost_model"]
    names = [r["event"] + r.get("name", "") for r in t]
    assert names[:8] == ["fit_start", "memory", "deadline_evicted", "epoch",
                         "quality", "spangrid.check_window", "compaction",
                         "spangrid.compaction"]
    assert "compile" not in names  # no CUDA graph is captured on the CPU
    qs = [r for r in t if r["event"] == "quality"]
    assert [q["lanes"] for q in qs] == [[0, 1, 2, 3], [0, 3], [0, 3]]
    _assert_streams_match(j, t, skip={
        "fit_start": ("mesh", "compile_cache_dir"),
        "fit_end": ("compile_ms", "dispatch_stats")})
    assert trun.dispatch_stats["quality"]["windows"] == 3
    assert trun.dispatch_stats["memory"]["predicted_bytes"] == \
        t[1]["predicted_bytes"]
    assert [f["cause"] for f in tres.failures] == ["deadline"] * 2


# ------------------------------------------------------ import discipline
def test_obs_imports_with_jax_blocked_and_builds_nothing(tmp_path,
                                                         monkeypatch):
    """The telemetry modules (the cost model and the watchdog among them)
    import (and the spine writes and reads) in a process where importing
    jax fails; nothing under build/torch_kernels/ is built and no kernel
    module or Triton is loaded."""
    kdir = os.path.join(REPO, "build", "torch_kernels")
    before = sorted(os.listdir(kdir)) if os.path.isdir(kdir) else None
    code = f"""
import sys
sys.modules["jax"] = None
import redcliff_tpu_torch.obs as O
from redcliff_tpu_torch.obs import (costmodel, flight, logging, memory,
                                    profiling, quality, schema, spans)
from redcliff_tpu_torch.runtime import (compileobs, faultinject, retry,
                                        watchdog)
from redcliff_tpu_torch.utils import observability
assert O.costmodel is costmodel and callable(retry)
with O.MetricLogger({str(tmp_path)!r}) as log:
    with O.span("grid.check_window", logger=log, emit=True, epoch=0):
        pass
assert not O.schema.validate_records(O.read_jsonl({str(tmp_path)!r}))
try:
    O.build_report
except NotImplementedError as e:
    assert "item 11" in str(e)
else:
    raise AssertionError("build_report resolved")
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m.split(".")[0] in ("jax", "redcliff_tpu", "triton")
                  or m.startswith("redcliff_tpu_torch.ops")))
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
    after = sorted(os.listdir(kdir)) if os.path.isdir(kdir) else None
    assert after == before
    monkeypatch.delenv(compileobs.ENV_CACHE_DIR, raising=False)
    assert compileobs.enable_cache(None) is None
    assert compileobs.enable_cache(str(tmp_path)) == str(tmp_path)


# ---------------------------------------------------------------- on card
@pytest.mark.gpu
def test_telemetry_smoke_checks_on_card(tmp_path, monkeypatch):
    """chip_smoke.py's telemetry checks 1, 2 and 4 at the slice's tiny
    width: the traced fit's records validate and its Chrome trace names
    both kernels with the wrapper counters' counts; the fit with telemetry
    off equals it bitwise; nan_batch:K equals skip_update:K bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and the CUDA profiler "
                    "run only there")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.telemetry_checks(tmp_path, small=True, grid=False)
    assert out["bitwise_on_off"] and out["nan_equals_skip"]
    assert out["trace_counts"]["fit"] == out["counter_counts"]["fit"]
    assert min(out["counter_counts"]["fit"].values()) > 0
