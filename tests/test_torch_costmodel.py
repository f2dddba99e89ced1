"""The port's learned cost model (redcliff_tpu_torch/obs/costmodel.py)
against the JAX package's (redcliff_tpu/obs/costmodel.py), and the grid's
use of it.

The store half is a copy: the same rows with ``now=`` pinned give the same
store JSON in both packages, and the same predictions (exact bucket, the
clamped nearest-width scaling, capture priors, ETAs, accuracy rows) from
either package's reader; a JAX-written store reads the same in the port.
The port's platform label is ``"cuda"`` on a card and ``"torch_<type>"``
elsewhere, never a JAX backend name. A port grid fit keeps the JAX
per-width accumulators, scores each check window against the store, logs
``cost_model`` events, sets ``dispatch_stats["eta"]`` and folds its epochs
into the store at the end.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu.obs import costmodel as jcm  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset  # noqa: E402
from redcliff_tpu_torch.obs import costmodel as tcm  # noqa: E402
from redcliff_tpu_torch.obs.logging import read_jsonl  # noqa: E402
from redcliff_tpu_torch.runtime import faultinject as fi  # noqa: E402

SHAPE = "gen_hidden=[25],num_chans=10,num_factors=5"


def _stats(widths):
    """A fit's dispatch_stats over ``widths`` = {width: [epoch ms...]}."""
    return {"epochs_by_width": {str(w): len(v) for w, v in widths.items()},
            "epoch_ms_by_width": {str(w): float(sum(v))
                                  for w, v in widths.items()},
            "first_epoch_ms_by_width": {str(w): v[0]
                                        for w, v in widths.items()},
            "compiles": 6, "compile_ms": 1234.5, "cache_hits": 0,
            "cache_misses": 0}


FITS = [
    ("cuda", _stats({32: [900.0, 80.0, 82.0], 16: [400.0, 61.0, 59.0,
                                                   60.5]})),
    ("cuda", _stats({32: [950.0, 78.5]})),
    ("cuda", _stats({8: [300.0]})),
    ("torch_cpu", _stats({4: [30.0, 12.0, 11.0]})),
]


def _write_store(mod, base):
    for i, (platform, stats) in enumerate(FITS):
        rows = mod.rows_from_dispatch_stats(SHAPE, stats)
        mod.update_store(str(base), rows, platform, now=1000.0 + i)
    return mod.store_path(str(base))


def test_rows_and_store_json_match_jax(tmp_path):
    for platform, stats in FITS:
        assert tcm.rows_from_dispatch_stats(SHAPE, stats) == \
            jcm.rows_from_dispatch_stats(SHAPE, stats)
    tp = _write_store(tcm, tmp_path / "port")
    jp = _write_store(jcm, tmp_path / "jax")
    assert os.path.basename(tp) == os.path.basename(jp) == \
        "cost_model_v1.json"
    with open(tp) as f, open(jp) as g:
        assert f.read() == g.read()


QUERIES = [(w, platform) for w in (1, 4, 8, 16, 24, 32, 64, 128)
           for platform in ("cuda", "torch_cpu", None)]


def _predictions(model):
    out = []
    for w, platform in QUERIES:
        out.append((
            model.epoch_ms_mean(SHAPE, w, platform=platform),
            model.predict_epoch_ms(SHAPE, w, platform=platform),
            model.compile_warm(SHAPE, w, platform=platform),
            model.predict_compile_ms(SHAPE, w, platform=platform),
            model.predict_fit_eta(SHAPE, w, 10, platform=platform,
                                  cold_programs=2),
            model.predict_epoch_ms(SHAPE, w, platform=platform,
                                   precision="mixed")))
    return out + [model.accuracy_rows(), model.runs, model.updated_at,
                  model.staleness_s(now=2000.0)]


def test_predictions_match_jax_and_a_jax_store_reads_the_same(tmp_path):
    _write_store(tcm, tmp_path / "port")
    _write_store(jcm, tmp_path / "jax")
    want = _predictions(jcm.load(str(tmp_path / "jax")))
    assert _predictions(tcm.load(str(tmp_path / "port"))) == want
    # the JAX-written file, read by the port
    assert _predictions(tcm.load(str(tmp_path / "jax"))) == want
    assert tcm.CostModel(None).buckets == {}


def test_bucket_cap_legacy_keys_and_corrupt_stores_match_jax(tmp_path,
                                                            monkeypatch):
    for mod in (tcm, jcm):
        monkeypatch.setattr(mod, "MAX_BUCKETS", 3)
    paths = {n: _write_store(m, tmp_path / n)
             for n, m in (("port", tcm), ("jax", jcm))}
    with open(paths["port"]) as f, open(paths["jax"]) as g:
        assert f.read() == g.read()
    assert len(json.load(open(paths["port"]))["buckets"]) == 3
    # a legacy precision-less key is backfilled on read, in both
    legacy = {"version": 1, "updated_at": 5.0, "runs": 1, "buckets": {
        f"cuda|{SHAPE}|g8": {"platform": "cuda", "shape": SHAPE,
                             "g_bucket": 8, "epochs": 2,
                             "epoch_ms_total": 20.0, "compiles": 0,
                             "compile_ms_total": 0.0}}}
    for name in ("legacy", "corrupt", "version"):
        d = tmp_path / name
        os.makedirs(d)
        with open(d / "cost_model_v1.json", "w") as f:
            if name == "legacy":
                json.dump(legacy, f)
            elif name == "version":
                json.dump(dict(legacy, version=2), f)
            else:
                f.write("{not json")
        t, j = tcm.load(str(d)), jcm.load(str(d))
        assert (t is None) == (j is None) == (name != "legacy")
        if t is not None:
            assert t.buckets == j.buckets
            assert t.predict_epoch_ms(SHAPE, 8, "cuda") == 10.0
    assert tcm.load(str(tmp_path / "absent")) is None


def test_store_path_resolution_matches_jax(tmp_path, monkeypatch):
    for env in ({}, {"REDCLIFF_COMPILE_CACHE": str(tmp_path / "c")},
                {"REDCLIFF_COMPILE_CACHE": str(tmp_path / "c"),
                 "REDCLIFF_COST_MODEL_DIR": str(tmp_path / "m")},
                {"REDCLIFF_COST_MODEL_DIR": str(tmp_path / "f.json")}):
        for k in ("REDCLIFF_COMPILE_CACHE", "REDCLIFF_COST_MODEL_DIR"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for base in (None, str(tmp_path / "b")):
            assert tcm.store_path(base) == jcm.store_path(base)
    monkeypatch.delenv("REDCLIFF_COST_MODEL_DIR", raising=False)
    monkeypatch.delenv("REDCLIFF_COMPILE_CACHE", raising=False)
    assert tcm.update_store(None, [], "cuda") is None


def test_platform_label_and_report_entry_points():
    assert tcm.platform_label(torch.device("cuda", 0)) == "cuda"
    assert tcm.platform_label("cuda:1") == "cuda"
    assert tcm.platform_label(torch.device("cpu")) == "torch_cpu"
    assert tcm.platform_label("cpu") not in ("cpu", "gpu", "tpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        tcm.fit_from_report({"cost_table": []})
    with pytest.raises(NotImplementedError, match="item 11"):
        tcm.update_store_from_report("/nowhere", {}, "cuda")


def test_grid_scores_logs_and_folds_into_the_store(tmp_path, monkeypatch):
    """A port grid fit: the JAX per-width accumulators, ``cost_model``
    events scored against the fit's own steady mean (an empty store) and
    then against the store its first fit wrote, ``dispatch_stats["eta"]``,
    and the store's rows under the port's platform label."""
    monkeypatch.setenv("REDCLIFF_COST_MODEL_DIR", str(tmp_path / "store"))
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    runs = []
    for i in range(2):
        runner, X, Y = fi._tiny_runner(6, device="cpu")
        ds = ArrayDataset(X, Y)
        runner.fit(2, ds, ds, log_dir=str(tmp_path / f"run{i}"))
        runs.append(runner)
    st = runs[0].dispatch_stats
    assert st["epochs_by_width"] == {"2": 6}
    assert st["first_epoch_ms_by_width"]["2"] > 0
    assert st["eta"]["source"] == "observed"
    assert st["eta"]["epochs_remaining"] == 0
    ev = read_jsonl(str(tmp_path / "run0"), event="cost_model")
    # a width's first epoch is never scored; the window of epoch k scores
    # epoch k - 1, so epochs 2..4 carry a prior
    assert [e["epoch"] for e in ev] == [2, 3, 4]
    assert {e["source"] for e in ev} == {"observed"}
    ev2 = read_jsonl(str(tmp_path / "run1"), event="cost_model")
    assert [e["source"] for e in ev2] == ["store"] * 4
    assert runs[1].dispatch_stats["cost_model"]["samples"] == 4
    model = tcm.load()
    key, = model.buckets
    b = model.buckets[key]
    assert key.startswith("torch_cpu|") and b["g_bucket"] == 2
    assert b["epochs"] == 2 * 5 and b["runs"] == 2
    assert b["compiles"] == 0  # no CUDA graph is captured on the CPU
    assert np.isclose(b["epoch_ms_total"], sum(
        r.dispatch_stats["epoch_ms_by_width"]["2"]
        - r.dispatch_stats["first_epoch_ms_by_width"]["2"] for r in runs),
        atol=1e-2)
