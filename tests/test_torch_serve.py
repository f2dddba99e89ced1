"""The port's serve path (redcliff_tpu_torch/serve) against the JAX
ServeService and StreamEngine on the same weights and the same streams,
plus the port's own contracts: fused == sequential ticks, drain/resume ==
an uninterrupted run, CUDA as the default device, the smoke CLI.

The JAX service runs with the occupancy ladder off: the port always
dispatches the full table, and with a DGCNN embedder the per-batch feature
normalization makes lane outputs depend on the table width.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.serve.engine import StreamEngine as JaxEngine  # noqa: E402
from redcliff_tpu.serve.service import ServeService as JaxService  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.ops import factor_mix as FM  # noqa: E402
from redcliff_tpu_torch.runtime.admission import SlotsExhausted  # noqa: E402
from redcliff_tpu_torch.serve.engine import StreamEngine  # noqa: E402
from redcliff_tpu_torch.serve.service import ServeService  # noqa: E402
from redcliff_tpu_torch.serve.session import (ACTIVE,  # noqa: E402
                                              QUARANTINED)

C, L = 4, 4
# serve scores/graphs: sigmoid eccentricity 10 magnifies input differences
# by up to 2.5x, so the absolute floor is 1e-5 (f32 both sides)
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_config(embedder):
    """The tiny Vanilla config of redcliff_tpu/serve/__main__.py, or a
    small DGCNN one."""
    kw = dict(num_chans=C, gen_lag=2, gen_hidden=(8,), embed_lag=L,
              embed_hidden_sizes=(8,), num_factors=2,
              num_supervised_factors=2, factor_weight_l1_coeff=0.01,
              adj_l1_reg_coeff=0.001, factor_cos_sim_coeff=0.01,
              factor_score_embedder_type="Vanilla_Embedder",
              primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
              training_mode="combined")
    if embedder == "DGCNN":
        kw.update(factor_score_embedder_type="DGCNN",
                  dgcnn_num_graph_conv_layers=2, dgcnn_num_hidden_nodes=8,
                  primary_gc_est_mode="conditional_factor_fixed_embedder",
                  num_sims=2)
    return jred.RedcliffSCMLPConfig(**kw)


_MODELS = {}


def _models(embedder):
    if embedder not in _MODELS:
        jcfg = _jax_config(embedder)
        jm = jred.RedcliffSCMLP(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tred.RedcliffSCMLP(
            tred.RedcliffSCMLPConfig(**dataclasses.asdict(jcfg)))
        tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[embedder] = (jm, jp, tm, tp)
    return _MODELS[embedder]


def _streams(seed, n, sids, poison=None):
    rng = np.random.default_rng(seed)
    out = {sid: rng.normal(size=(n, C)).astype(np.float32) for sid in sids}
    if poison is not None:
        out[poison][L + 2, 1] = np.nan
    return out


def _drive(svc, streams, n, t0=0.0):
    """One tick per sample for every stream; returns polled records."""
    recs = {sid: [] for sid in streams}
    now = t0
    for t in range(n):
        now += 0.01
        for sid, xs in streams.items():
            svc.ingest(sid, xs[t], now=now)
        svc.pump(now=now)
        for sid in streams:
            recs[sid].extend(svc.poll(sid, now=now))
    return recs


def _same_records(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert a["sid"] == b["sid"]
        if "error" in b:
            assert a["error"] == b["error"]
            continue
        assert a["seq"] == b["seq"]
        assert a["latency_ms"] == b["latency_ms"]
        np.testing.assert_allclose(a["scores"], b["scores"], **TOL)
        if "graph" in b:
            np.testing.assert_allclose(a["graph"], b["graph"], **TOL)


@pytest.mark.parametrize("embedder", ["Vanilla_Embedder", "DGCNN"])
def test_record_streams_match_jax_service(embedder):
    """Same streams through the JAX and the port's service: same sid/seq
    sequences, answered counts, error records and quarantine states, scores
    and graphs within tolerance, ring state exactly equal."""
    jm, jp, tm, tp = _models(embedder)
    jsvc = JaxService(jm, jp, root=None, capacity=4, resume=False,
                      ladder="off")
    tsvc = ServeService(tm, tp, root=None, capacity=4, resume=False,
                        device="cpu")
    n = L + 8
    streams = _streams(1, n, ("a", "b", "poisoner"), poison="poisoner")
    for svc in (jsvc, tsvc):
        for sid in streams:
            svc.connect(sid=sid, now=0.0)
    want = _drive(jsvc, streams, n)
    got = _drive(tsvc, streams, n)
    for sid in streams:
        _same_records(got[sid], want[sid])
        assert tsvc.registry.get(sid).state == jsvc.registry.get(sid).state
    assert tsvc.registry.get("poisoner").state == QUARANTINED
    assert sum("scores" in r for r in got["a"]) == n - L + 1
    assert any("error" in r for r in got["poisoner"])
    assert tsvc.samples_out == jsvc.samples_out
    js, ts = jsvc.engine.export_state(), tsvc.engine.export_state()
    for k in ("window", "pos", "filled", "poisoned"):
        assert ts[k].dtype == js[k].dtype
        np.testing.assert_array_equal(ts[k], js[k])
    jsvc.stop()


@pytest.mark.parametrize("embedder", ["Vanilla_Embedder", "DGCNN"])
def test_engine_steps_match_jax_engine(embedder):
    """Tick by tick, with ragged arrivals and a NaN: flags and ring state
    exact, scores and graphs within tolerance."""
    jm, jp, tm, tp = _models(embedder)
    je = JaxEngine(jm, jp, capacity=3)
    te = StreamEngine(tm, tp, capacity=3, device="cpu")
    np.testing.assert_allclose(te.static_gc.numpy(),
                               np.asarray(je.static_gc), rtol=1e-5,
                               atol=1e-6)
    rng = np.random.default_rng(2)
    for t in range(L + 6):
        samples = rng.normal(size=(3, C)).astype(np.float32)
        arrive = rng.random(3) < 0.8
        if t == L + 2:
            samples[2, 0] = np.nan
        want = je.step(samples, arrive)
        got = te.step(samples, arrive)
        for k in ("ready", "poison_hit", "poisoned"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
        np.testing.assert_allclose(got["graph"], want["graph"], **TOL)
    js, ts = je.export_state(), te.export_state()
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])


def test_step_fused_equals_sequential_steps():
    _, _, tm, tp = _models("DGCNN")
    rng = np.random.default_rng(3)
    F = L + 3
    samples = rng.normal(size=(3, F, C)).astype(np.float32)
    arrive = rng.random((3, F)) < 0.85
    samples[1, L + 1, 2] = np.inf
    seq = StreamEngine(tm, tp, capacity=3, device="cpu")
    fused = StreamEngine(tm, tp, capacity=3, device="cpu")
    steps = [seq.step(samples[:, f], arrive[:, f]) for f in range(F)]
    out = fused.step_fused(samples, arrive)
    for f, step in enumerate(steps):
        for k, v in step.items():
            np.testing.assert_array_equal(out[k][f], v)
    for k, v in seq.export_state().items():
        np.testing.assert_array_equal(fused.export_state()[k], v)


def test_resize_keeps_surviving_lanes():
    _, _, tm, tp = _models("Vanilla_Embedder")
    eng = StreamEngine(tm, tp, capacity=4, device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(L + 1):
        eng.step(rng.normal(size=(4, C)).astype(np.float32),
                 np.array([True, True, False, False]))
    before = eng.export_state()
    eng.resize(2)
    eng.resize(4)
    after = eng.export_state()
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v)
    with pytest.raises(ValueError, match="outside"):
        eng.resize(5)


def test_drain_resume_matches_uninterrupted_run(tmp_path):
    """Drain mid-stream, restart from serve_state.bin, finish: the record
    stream equals the uninterrupted run's, byte for byte."""
    _, _, tm, tp = _models("Vanilla_Embedder")
    n, cut = 12, 7
    xs = _streams(11, n, ("s",))["s"]

    ref = ServeService(tm, tp, capacity=2, resume=False, device="cpu")
    ref.connect(sid="s", now=0.0)
    want = _drive(ref, {"s": xs}, n)["s"]

    root = str(tmp_path)
    svc1 = ServeService(tm, tp, root=root, capacity=2, device="cpu")
    tr1 = svc1.connect(sid="s", now=0.0)["trace_id"]
    now = 0.0
    for t in range(cut):
        now += 0.01
        svc1.ingest("s", xs[t], now=now)
        svc1.pump(now=now)
    path = svc1.drain(now=1.0)
    assert path and path.endswith("serve_state.bin")

    svc2 = ServeService(tm, tp, root=root, capacity=2, device="cpu")
    sess = svc2.registry.get("s")
    assert sess is not None and sess.state == ACTIVE
    assert sess.trace_id == tr1
    got = list(svc2.poll("s", now=2.0))
    got += _drive(svc2, {"s": xs[cut:]}, n - cut, t0=cut * 0.01)["s"]
    assert [r["seq"] for r in got] == [r["seq"] for r in want]
    for a, b in zip(got, want):
        assert a["trace_id"] == tr1
        assert a["scores"].tobytes() == b["scores"].tobytes()
        assert ("graph" in a) == ("graph" in b)
        if "graph" in a:
            assert a["graph"].tobytes() == b["graph"].tobytes()


def test_resume_into_other_capacity_repacks_lanes(tmp_path):
    _, _, tm, tp = _models("Vanilla_Embedder")
    root = str(tmp_path)
    svc = ServeService(tm, tp, root=root, capacity=4, device="cpu")
    for sid in ("a", "b", "c"):
        svc.connect(sid=sid, now=0.0)
    svc.disconnect("a")  # leaves a hole at slot 0
    xs = _streams(5, L + 1, ("b", "c"))
    _drive(svc, xs, L + 1)
    old = svc.engine.export_state()
    slots = {sid: svc.registry.get(sid).slot for sid in ("b", "c")}
    svc.drain(now=1.0)

    small = ServeService(tm, tp, root=root, capacity=2, device="cpu")
    new = small.engine.export_state()
    for sid in ("b", "c"):
        s_new = small.registry.get(sid).slot
        np.testing.assert_array_equal(new["window"][s_new],
                                      old["window"][slots[sid]])
    with pytest.raises(ValueError, match="do not fit"):
        ServeService(tm, tp, root=root, capacity=1, device="cpu")
    with pytest.raises(ValueError, match="geometry mismatch"):
        small.engine.import_state(old)


def test_admission_lease_backlog_and_shape_contracts(monkeypatch):
    monkeypatch.setenv("REDCLIFF_SERVE_INGEST_CAP", "2")
    _, _, tm, tp = _models("Vanilla_Embedder")
    svc = ServeService(tm, tp, capacity=2, lease_s=5.0, device="cpu")
    svc.connect(sid="a", now=0.0)
    svc.connect(sid="b", now=1.0)
    with pytest.raises(SlotsExhausted) as exc:
        svc.connect(sid="c", now=2.0)
    assert exc.value.eta_s == pytest.approx(3.0)
    x = np.zeros(C, np.float32)
    assert svc.ingest("a", x, now=2.0)["accepted"]
    assert svc.ingest("a", x, now=2.0)["accepted"]
    assert svc.ingest("a", x, now=2.0)["reason"] == "backlog full"
    v = svc.ingest("b", np.zeros(C + 1, np.float32), now=2.0)
    assert not v["accepted"] and "shape violation" in v["reason"]
    assert svc.registry.get("b").state == QUARANTINED
    svc.pump(now=7.5)  # b's lease (renewed at 2.0) lapsed at 7.0
    assert svc.registry.get("b") is None
    assert svc.connect(sid="c", now=7.5)["slot"] == 1


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without device=..., the entry points ask for CUDA and raise when it
    is absent instead of running on the CPU: the engine, the service and
    its run loop, the artifact loader, the ``ladder-smoke`` CLI."""
    from redcliff_tpu_torch.eval.model_io import load_model_for_eval
    from redcliff_tpu_torch.serve.__main__ import _build_tiny_artifact, main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tm, tp = _models("Vanilla_Embedder")
    artifact = _build_tiny_artifact(str(tmp_path))
    for call in (lambda: StreamEngine(tm, tp, capacity=2),
                 lambda: ServeService(tm, tp, capacity=2),
                 lambda: ServeService(tm, tp, capacity=2,
                                      precision_mode="mixed",
                                      ladder="force").run_loop(max_ticks=1),
                 lambda: ServeService.from_artifact(artifact),
                 lambda: load_model_for_eval(artifact),
                 lambda: main(["ladder-smoke", "--root",
                               str(tmp_path / "ls")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_serve_smoke_entrypoint(tmp_path):
    from redcliff_tpu_torch.serve.__main__ import main

    before = FM.factor_mix.launches
    assert main(["smoke", "--root", str(tmp_path), "--device", "cpu"]) == 0
    assert FM.factor_mix.launches == before  # CPU: the plain version
