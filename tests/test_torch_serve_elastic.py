"""The port's elastic serve data plane against the JAX package's
(redcliff_tpu/serve, tests/test_serve_elastic.py) on the same weights, the
same seeded storms and the same knobs: the rung helper and the ladder
policy decision for decision, the engine's fused and resized ticks, ladder
and fusion identity, the mixed path and its demotion sentinel, resume
across rung geometries, the host copies (chaos, slo, admission), the bf16
factor mix's plain version and launch plan, the serve events against the
port schema, and the CLI.

Ladder identity in the port on the CPU is held at 1e-6, not bitwise:
torch's CPU matrix products block by the row count, so a lane's last bits
can move with the table's width (ROADMAP queue 3); the test prints whether
the run was bitwise. Rung-independent comparisons (fusion, demotion,
resume at equal width) stay bitwise.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.obs import read_jsonl as jread_jsonl  # noqa: E402
from redcliff_tpu.obs import slo as jslo  # noqa: E402
from redcliff_tpu.parallel.compaction import serve_rung as jserve_rung  # noqa: E402,E501
from redcliff_tpu.runtime import admission as jadm  # noqa: E402
from redcliff_tpu.serve import chaos as jchaos  # noqa: E402
from redcliff_tpu.serve.engine import StreamEngine as JaxEngine  # noqa: E402
from redcliff_tpu.serve.service import ServeLadder as JaxLadder  # noqa: E402
from redcliff_tpu.serve.service import ServeService as JaxService  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.obs import read_jsonl, schema  # noqa: E402
from redcliff_tpu_torch.obs import slo as tslo  # noqa: E402
from redcliff_tpu_torch.ops import autotune  # noqa: E402
from redcliff_tpu_torch.ops import factor_mix as FM  # noqa: E402
from redcliff_tpu_torch.parallel.compaction import serve_rung  # noqa: E402
from redcliff_tpu_torch.runtime import admission as tadm  # noqa: E402
from redcliff_tpu_torch.serve import chaos  # noqa: E402
from redcliff_tpu_torch.serve.engine import StreamEngine  # noqa: E402
from redcliff_tpu_torch.serve.service import (MIN_RUNG,  # noqa: E402
                                              STATE_BASENAME, ServeLadder,
                                              ServeService)

C, L = 4, 4
# serve bars (tests/test_torch_serve.py): f32 both sides, sigmoid(10 x)
TOL = dict(rtol=1e-5, atol=1e-5)
# mixed against f32 (tests/test_serve_elastic.py)
MIXED_TOL = dict(rtol=2e-2, atol=1e-3)
# ladder on vs off in the port on the CPU (module docstring)
LADDER_ATOL = 1e-6
# identity fields every logged record carries
_IDENTITY = ("wall_time", "seq", "pid", "host", "trace")


def _jax_config(embedder):
    """The JAX elastic test's Vanilla model, or a small DGCNN one."""
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


def _models(embedder="Vanilla_Embedder"):
    if embedder not in _MODELS:
        jcfg = _jax_config(embedder)
        jm = jred.RedcliffSCMLP(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tred.RedcliffSCMLP(
            tred.RedcliffSCMLPConfig(**dataclasses.asdict(jcfg)))
        tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[embedder] = (jm, jp, tm, tp)
    return _MODELS[embedder]


@pytest.fixture
def store(tmp_path, monkeypatch):
    """An empty cost store of the test's own (the conftest's compile
    cache holds other tests' serve rows)."""
    d = tmp_path / "cost_store"
    monkeypatch.setenv("REDCLIFF_COST_MODEL_DIR", str(d))
    return d


def _pair(embedder="Vanilla_Embedder", jroot=None, troot=None, **kw):
    jm, jp, tm, tp = _models(embedder)
    kw.setdefault("lease_s", 30.0)
    kw.setdefault("resume", False)
    js = JaxService(jm, jp, root=jroot, **kw)
    ts = ServeService(tm, tp, root=troot, device="cpu", **kw)
    return js, ts


def _port(embedder="Vanilla_Embedder", **kw):
    _, _, tm, tp = _models(embedder)
    kw.setdefault("lease_s", 30.0)
    kw.setdefault("resume", False)
    return ServeService(tm, tp, device="cpu", **kw)


def _events(root, name, reader=read_jsonl):
    return [r for r in reader(str(root)) if r.get("event") == name]


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in _IDENTITY}


def _close(got, want, **tol):
    """Two drive() result maps: same counts, seqs, cadence and errors;
    scores and graphs within ``tol``."""
    assert sorted(got) == sorted(want)
    for sid in want:
        assert len(got[sid]) == len(want[sid]), sid
        for a, b in zip(got[sid], want[sid]):
            assert set(a) == set(b), (sid, set(a), set(b))
            assert a.get("seq") == b.get("seq")
            assert a.get("error") == b.get("error")
            for k in ("scores", "graph"):
                if k in b:
                    np.testing.assert_allclose(np.asarray(a[k]),
                                               np.asarray(b[k]), **tol)


# ------------------------------------------------------------- rung helper
def test_serve_rung_matches_jax():
    rng = np.random.default_rng(0)
    cases = [(0, 8, 1), (1, 8, 1), (3, 8, 1), (5, 8, 1), (9, 8, 1),
             (17, 32, 1), (0, 8, 4), (2, 8, 4), (3, 3, 1), (1, 3, 1),
             (64, 64, 4), (33, 64, 4)]
    cases += [tuple(int(v) for v in (rng.integers(0, 80),
                                     rng.integers(1, 80),
                                     rng.integers(1, 9)))
              for _ in range(200)]
    for n, cap, lo in cases:
        assert serve_rung(n, cap, lo) == jserve_rung(n, cap, lo), \
            (n, cap, lo)


# ------------------------------------------------------------ ladder policy
def _ladder_trace(ladder, seed, platform):
    """A seeded sawtooth of live lanes with observed dispatches: every
    decision, the events, and the rows."""
    rng = np.random.default_rng(seed)
    cur, out = ladder.capacity, []
    seen = set()
    for t in range(60):
        live = int(abs((t % 24) - 12) + rng.integers(0, 3))
        new, ev = ladder.decide(live, cur, lambda w: w not in seen,
                                platform)
        out.append((new, ev))
        cur = new
        cold = cur not in seen
        seen.add(cur)
        ladder.observe(cur, float(1.0 + 0.25 * cur + rng.random()), cold)
    return out, ladder.rows()


@pytest.mark.parametrize("mode", ["off", "force", "auto"])
def test_ladder_decisions_match_jax(mode, store):
    """Growth, forced and priced shrinks, hysteresis and the evidence
    fallbacks, decision for decision and event for event, with the JAX
    policy on the same trace; ``rows()`` equal."""
    for hold, horizon in ((1, 100), (3, 500), (2, 5)):
        kw = dict(mode=mode, hold=hold, horizon=horizon,
                  shape_key="serve|x")
        got = _ladder_trace(ServeLadder(16, **kw), hold, "torch_cpu")
        want = _ladder_trace(JaxLadder(16, **kw), hold, "cpu")
        assert got == want, (mode, hold, horizon)
    kinds = {ev["kind"] for _, ev in got[0] if ev}
    if mode == "force":
        assert {"grow", "shrink"} <= kinds
    if mode == "off":
        assert not kinds and ServeLadder(16, mode="off").target(2) == 16


def test_ladder_growth_mandatory_shrink_hysteresis():
    lad = ServeLadder(16, mode="force", hold=2)
    assert lad.decide(2, 16, lambda w: True) == (16, None)
    w, ev = lad.decide(2, 16, lambda w: True)
    assert w == 4 and ev["kind"] == "shrink" and ev["reason"] == "forced"
    w, ev = lad.decide(10, 4, lambda w: True)
    assert w == 16 and ev["kind"] == "grow" and ev["live"] == 10
    with pytest.raises(ValueError, match="REDCLIFF_SERVE_LADDER"):
        ServeLadder(16, mode="sometimes")


def test_ladder_auto_no_evidence_holds_max(store):
    for lad in (ServeLadder(16, mode="auto", hold=1),
                JaxLadder(16, mode="auto", hold=1)):
        w, ev = lad.decide(2, 16, lambda w: True)
        assert w == 16 and ev == {"kind": "fallback", "from_width": 16,
                                  "to_width": 16, "live": 2,
                                  "reason": "no_evidence"}
        assert lad.decide(2, 16, lambda w: True) == (16, None)


def test_ladder_auto_prices_against_an_injected_store(tmp_path,
                                                      monkeypatch):
    """The same rows folded into each package's store (under its own
    platform label): the same priced verdicts, hold then shrink as the
    horizon grows, and the same ``rows()`` fold back."""
    from redcliff_tpu.obs import costmodel as jcm
    from redcliff_tpu_torch.obs import costmodel as tcm

    rows = [{"shape": "serve|x", "g_bucket": w, "precision": "f32",
             "epochs": 10, "epoch_ms": 10.0 * (1.0 + 0.5 * w),
             "compiles": 1, "compile_ms": 400.0}
            for w in (4, 8, 16)]
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tcm.update_store(str(tdir), rows, "torch_cpu")
    jcm.update_store(str(jdir), rows, "cpu")
    verdicts = []
    for horizon in (10, 100, 1000):
        pair = []
        for pkg, d, plat in ((ServeLadder, tdir, "torch_cpu"),
                             (JaxLadder, jdir, "cpu")):
            monkeypatch.setenv("REDCLIFF_COST_MODEL_DIR", str(d))
            lad = pkg(16, mode="auto", hold=1, horizon=horizon,
                      shape_key="serve|x")
            pair.append([lad.decide(3, 16, lambda w: True, plat),
                         lad.decide(3, 16, lambda w: False, plat)])
        assert pair[0] == pair[1], horizon
        verdicts.append(pair[0][0][1]["kind"])
    assert verdicts[0] == "hold" and verdicts[-1] == "shrink"


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("embedder", ["Vanilla_Embedder", "DGCNN"])
def test_engine_fused_and_resized_ticks(embedder):
    """step_fused equals F sequential steps bitwise; resize keeps every
    surviving lane's bytes; both against the JAX engine at the serve
    bars, tick by tick through grow -> shrink -> grow."""
    jm, jp, tm, tp = _models(embedder)
    rng = np.random.default_rng(0)
    W, F = 3, 5
    samples = rng.normal(size=(W, F, C)).astype(np.float32)
    arrive = np.ones((W, F), dtype=bool)
    arrive[2, 3] = False
    seq_e = StreamEngine(tm, tp, capacity=W, device="cpu")
    seq = [seq_e.step(samples[:, f], arrive[:, f]) for f in range(F)]
    fused = StreamEngine(tm, tp, capacity=W, device="cpu").step_fused(
        samples, arrive)
    jfused = JaxEngine(jm, jp, capacity=W).step_fused(samples, arrive)
    for f in range(F):
        for k in seq[f]:
            assert seq[f][k].tobytes() == fused[k][f].tobytes(), (k, f)
            np.testing.assert_allclose(fused[k][f], np.asarray(jfused[k][f]),
                                       **TOL)

    te, je = (StreamEngine(tm, tp, capacity=8, device="cpu"),
              JaxEngine(jm, jp, capacity=8))
    te.resize(4)
    je.resize(4)
    assert te.is_cold(4) and te.is_cold(8)
    xs = rng.normal(size=(8, 2, C)).astype(np.float32)
    for t in range(8):
        if t in (3, 5):
            w = 8 if t == 3 else 4
            before = te.export_state()
            te.resize(w)
            je.resize(w)
            after = te.export_state()
            n = min(before["window"].shape[0], w)
            for k in before:
                assert after[k][:n].tobytes() == before[k][:n].tobytes()
                assert not after[k][n:].any()
        s = np.zeros((te.width, C), np.float32)
        s[:2] = xs[t]
        a = np.zeros(te.width, bool)
        a[:2] = True
        got, want = te.step(s, a), je.step(s, a)
        for k in ("ready", "poison_hit", "poisoned"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        for k in ("scores", "graph"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), **TOL)
    assert not te.is_cold(4) and not te.is_cold(8)
    assert te.is_cold(2) == je.is_cold(2) is True
    for bad in (16, 0):
        with pytest.raises(ValueError):
            te.resize(bad)


# ------------------------------------------------- service-level identity
def test_ladder_identity_under_sawtooth_churn(tmp_path, monkeypatch, store):
    """A forced ladder riding grow -> shrink -> grow under a seeded
    sawtooth storm answers its victims as ladder off does (held at 1e-6
    in the port on the CPU, see the module docstring), at the serve bars
    against the JAX service, with the JAX service's serve_ladder event
    sequence; every record validates against the port schema."""
    monkeypatch.setenv("REDCLIFF_SERVE_LADDER_HOLD", "2")
    victims = {f"v{i}": chaos.stream_samples(50 + i, 16, C)
               for i in range(2)}

    def run(svc):
        for sid in victims:
            svc.connect(sid=sid, now=0.0)
        storm = chaos.make_sawtooth_storm(9, C, lo=0, hi=6, period=5)
        res = chaos.drive(svc, victims, ticks=24, chaos_fn=storm)
        svc.stop()
        return res

    js, ts = _pair(capacity=16, ladder="force", jroot=str(tmp_path / "j"),
                   troot=str(tmp_path / "t"))
    res_j, res_on = run(js), run(ts)
    res_off = run(_port(capacity=16, ladder="off"))
    identical, compared, detail = chaos.outputs_identical(res_on, res_off)
    worst = chaos.max_abs_difference(res_on, res_off)
    print(f"ladder on vs off: bitwise={identical} max_abs={worst}")
    assert compared > 0 and worst <= LADDER_ATOL, (worst, detail)
    _close(res_on, res_j, **TOL)

    def ladder_events(root, reader):
        return [_strip(e) for e in _events(root, "serve_ladder", reader)]

    got = ladder_events(tmp_path / "t", read_jsonl)
    want = ladder_events(tmp_path / "j", jread_jsonl)
    assert got == want
    kinds = [e["kind"] for e in got if e["kind"] in ("grow", "shrink")]
    assert "grow" in kinds and "shrink" in kinds and len(kinds) >= 3
    assert schema.validate_records(read_jsonl(str(tmp_path / "t"))) == []


def test_fusion_identity_equal_sample_counts(tmp_path, store):
    """Backlogged streams through fuse 4 answer the bytes of fuse 1, and
    the serve_fuse stats carry the JAX service's depth histogram."""
    xs = chaos.stream_samples(5, 24, C)

    def run(svc):
        svc.connect(sid="s", now=0.0)
        burst = svc.fuse
        now, recs = 0.0, []
        for i in range(24):
            now += 0.01
            svc.ingest("s", xs[i], now=now)
            if (i + 1) % burst == 0:
                svc.pump(now=now)
                recs.extend(svc.poll("s", now=now))
        for _ in range(20):
            now += 0.01
            svc.pump(now=now)
            recs.extend(svc.poll("s", now=now))
        svc.stop()
        return {"s": recs}

    plain = run(_port(capacity=4, ladder="off", fuse=1))
    js, ts = _pair(capacity=4, ladder="off", fuse=4,
                   jroot=str(tmp_path / "j"), troot=str(tmp_path / "t"))
    fused_j, fused = run(js), run(ts)
    identical, compared, detail = chaos.outputs_identical(plain, fused)
    assert identical and compared == 24 - L + 1, detail
    _close(fused, fused_j, **TOL)
    assert ts._fused_samples == js._fused_samples > 0
    assert ts._fuse_hist == js._fuse_hist and 4 in ts._fuse_hist
    st = [_strip(e) for e in _events(tmp_path / "t", "serve_fuse")]
    sj = [_strip(e) for e in _events(tmp_path / "j", "serve_fuse",
                                     jread_jsonl)]
    assert st == sj and st[-1]["fused_samples"] == ts._fused_samples


# -------------------------------------------------------- mixed precision
@pytest.mark.parametrize("embedder", ["Vanilla_Embedder", "DGCNN"])
def test_mixed_against_f32_and_jax(embedder, store):
    """The mixed path serves close to f32 (bf16 contraction bars), every
    output finite, and close to the JAX mixed service (whose CPU ignores
    the bf16 hint: its f32); the bf16 contractions did run (the outputs
    differ from f32)."""
    xs = {f"v{i}": chaos.stream_samples(70 + i, 12, C) for i in range(2)}

    def run(svc):
        for sid in xs:
            svc.connect(sid=sid, now=0.0)
        res = chaos.drive(svc, xs, ticks=16)
        svc.stop()
        return res

    f32 = run(_port(embedder, capacity=4, ladder="off"))
    js, ts = _pair(embedder, capacity=4, ladder="off",
                   precision_mode="mixed")
    assert ts.engine.precision_mode == "mixed" and not ts.engine.demoted
    jmix, mixed = run(js), run(ts)
    for res in (mixed,):
        for recs in res.values():
            for r in recs:
                assert np.isfinite(r["scores"]).all()
                assert np.isfinite(r.get("graph", 0.0)).all()
    _close(mixed, f32, **MIXED_TOL)
    _close(mixed, jmix, **MIXED_TOL)
    assert not chaos.outputs_identical(mixed, f32)[0]
    assert ts.ladder.precision == "mixed"
    with pytest.raises(ValueError):
        _port(capacity=2, precision_mode="tf32-ish")


def test_mixed_is_serve_only(monkeypatch):
    """"mixed" is no longer serve-only: the trainers and the grid take it
    (tests/test_torch_mixed.py fits them), an unknown ``matmul_precision``
    raises at config time naming it; the env knob reaches the service."""
    from redcliff_tpu_torch.parallel import grid as tgrid
    from redcliff_tpu_torch.train import redcliff_trainer as trt
    from redcliff_tpu_torch.train import trainer as ttr
    from redcliff_tpu_torch.utils import precision

    for make in (lambda: trt.RedcliffTrainConfig(precision_mode="mixed"),
                 lambda: ttr.TrainConfig(precision_mode="mixed"),
                 lambda: tgrid.GridSpec([{}], precision_mode="mixed")):
        assert make().precision_mode == "mixed"
    with pytest.raises(ValueError, match="'tf32'"):
        trt.RedcliffTrainConfig(matmul_precision="tf32")
    with pytest.raises(ValueError, match="'tf32'"):
        precision.matmul_precision_ctx("tf32")
    monkeypatch.setenv("REDCLIFF_SERVE_PRECISION", "mixed")
    assert _port(capacity=2).engine.precision_mode == "mixed"


def test_poison_storm_demotes_and_resume_honors_it(tmp_path, monkeypatch,
                                                   store):
    """A poisoned-lane storm demotes the mixed table at the JAX tick with
    the JAX precision events field for field; later records are
    byte-equal to a port f32 run; drain, then a mixed restart comes up
    demoted with resume_demoted."""
    monkeypatch.setenv("REDCLIFF_SERVE_DEMOTE_STORM", "2")
    victims = {"v0": chaos.stream_samples(80, 20, C)}

    def storm(svc, t, now):
        if t == 2:
            for i in range(3):
                svc.connect(sid=f"p{i}", now=now)
        if 2 <= t <= 6:
            for i in range(3):
                svc.ingest(f"p{i}", np.full(C, np.nan, np.float32),
                           now=now)

    def run(svc):
        svc.connect(sid="v0", now=0.0)
        return chaos.drive(svc, victims, ticks=24, chaos_fn=storm)

    troot, jroot = tmp_path / "t", tmp_path / "j"
    js, ts = _pair(capacity=8, ladder="off", precision_mode="mixed",
                   jroot=str(jroot), troot=str(troot))
    res_j, res_mixed = run(js), run(ts)
    assert ts.engine.demoted and js.engine.demoted
    ck = ts.drain(now=5.0)
    js.drain(now=5.0)
    assert ck and os.path.basename(ck) == STATE_BASENAME

    prec = [_strip(e) for e in _events(troot, "precision")]
    jprec = [_strip(e) for e in _events(jroot, "precision", jread_jsonl)]
    assert prec == jprec and prec[0]["kind"] == "demote"
    assert prec[0]["cause"] == "poisoned-lane storm"
    _close(res_mixed, res_j, **MIXED_TOL)

    svc_f = _port(capacity=8, ladder="off")
    res_f32 = run(svc_f)
    svc_f.stop()
    demote_tick = prec[0]["ticks"]
    post_m = [r for r in res_mixed["v0"] if r.get("seq", 0) >
              demote_tick + L]
    post_f = res_f32["v0"][-len(post_m):] if post_m else []
    assert post_m
    ok, n, detail = chaos.outputs_identical({"v0": post_m}, {"v0": post_f})
    assert ok and n == len(post_m), detail

    svc2 = _port(capacity=8, root=str(troot), precision_mode="mixed",
                 resume=True)
    assert svc2.engine.demoted and svc2.engine._matmul is None
    svc2.stop()
    kinds = [e["kind"] for e in _events(troot, "precision")]
    assert kinds == ["demote", "resume_demoted"]
    assert schema.validate_records(read_jsonl(str(troot))) == []


# --------------------------------------------------------- drain / resume
def test_resume_repacks_lanes_across_rung_geometries(tmp_path, monkeypatch,
                                                     store):
    monkeypatch.setenv("REDCLIFF_SERVE_LADDER_HOLD", "2")
    root = tmp_path / "rp"
    xs = {f"r{i}": chaos.stream_samples(90 + i, 14, C) for i in range(3)}

    ref = _port(capacity=4, ladder="off")
    for sid in xs:
        ref.connect(sid=sid, now=0.0)
    res_ref = chaos.drive(ref, xs, ticks=18)
    ref.stop()

    svc = _port(capacity=4, root=str(root), ladder="off")
    for sid in xs:
        svc.connect(sid=sid, now=0.0)
    res_a = chaos.drive(svc, {s: a[:7] for s, a in xs.items()}, ticks=7)
    svc.drain(now=1.0)

    svc2 = _port(capacity=16, root=str(root), ladder="auto", resume=True)
    assert sorted(svc2.registry.sessions) == sorted(xs)
    assert svc2.engine.capacity == 16
    assert svc2.engine.width == serve_rung(3, 16, MIN_RUNG)
    res_b = chaos.drive(svc2, {s: a[7:] for s, a in xs.items()}, ticks=11,
                        now0=2.0)
    svc2.stop()
    joined = {sid: res_a[sid] + res_b[sid] for sid in xs}
    identical, compared, detail = chaos.outputs_identical(joined, res_ref)
    assert identical and compared > 0, detail
    rp, = [e for e in _events(root, "serve_ladder") if e["kind"] == "repack"]
    assert (rp["from_width"], rp["to_width"], rp["from_capacity"],
            rp["capacity"]) == (4, 4, 4, 16)


def test_resume_too_small_capacity_names_both_geometries(tmp_path, store):
    root = tmp_path / "small"
    svc = _port(capacity=4, root=str(root))
    for i in range(3):
        svc.connect(sid=f"s{i}", now=0.0)
    svc.drain(now=1.0)
    with pytest.raises(ValueError) as ei:
        _port(capacity=2, root=str(root), resume=True)
    msg = str(ei.value)
    assert "geometry mismatch" in msg
    assert "capacity 4" in msg and "capacity 2" in msg


# ----------------------------------------------------------- host copies
def test_chaos_harness_equals_jax():
    """Same seeds, same actors, the same calls and bytes; the comparison
    helpers agree on the same result maps."""
    assert chaos.__all__[:5] == jchaos.__all__[:5]
    assert chaos.stream_samples(3, 7, C).tobytes() \
        == jchaos.stream_samples(3, 7, C).tobytes()

    class _Rec:
        def __init__(self):
            self.log = []

        def connect(self, sid=None, now=None):
            if len([x for x in self.log if x[0] == "c"]) > 4:
                raise tadm.SlotsExhausted(4, eta_s=1.0)
            self.log.append(("c", sid))

        def disconnect(self, sid):
            self.log.append(("d", sid))

        def ingest(self, sid, x, now=None):
            self.log.append(("i", sid, x.tobytes()))

    class _JRec(_Rec):
        def connect(self, sid=None, now=None):
            if len([x for x in self.log if x[0] == "c"]) > 4:
                raise jadm.SlotsExhausted(4, eta_s=1.0)
            self.log.append(("c", sid))

    for make in (lambda m: m.make_sawtooth_storm(3, C, lo=1, hi=5,
                                                 period=4, nan_p=0.2),
                 lambda m: m.make_churn_storm(4, C)):
        a, b = _Rec(), _JRec()
        s1, s2 = make(chaos), make(jchaos)
        for t in range(20):
            s1(a, t, 0.0)
            s2(b, t, 0.0)
        assert a.log == b.log and s1.rejects == s2.rejects
    sw = chaos.make_sawtooth_storm(3, C, lo=1, hi=5, period=4)
    assert [sw.target(t) for t in range(10)] == [1, 2, 3, 4, 5, 4, 3, 2, 1,
                                                 2]
    r = {"x": [{"seq": 1, "scores": np.ones(2, np.float32)}]}
    r2 = {"x": [{"seq": 1, "scores": np.array([1, 1 + 1e-7], np.float32)}]}
    for x, y in ((r, r), (r, r2), (r, {"x": []})):
        assert chaos.outputs_identical(x, y) == jchaos.outputs_identical(x, y)
    assert chaos.max_abs_difference(r, r) == 0.0
    assert 0 < chaos.max_abs_difference(r, r2) < 1e-6
    assert chaos.max_abs_difference(r, {"x": []}) == float("inf")


def _history(seed):
    """A seeded fleet lifecycle ledger: submits, claims (some released),
    attempts, settles (some racing, some requeued), two tenants."""
    rng = np.random.default_rng(seed)
    recs, wall = [], 1000.0
    for i in range(30):
        rid, tenant = f"r{i}", f"t{i % 2}"
        wall += float(rng.random())
        sub = {"event": "fleet_lifecycle", "kind": "submitted",
               "request_id": rid, "tenant": tenant, "wall_time": wall,
               "submitted_at": wall}
        if rng.random() < 0.5:
            sub["deadline_s"] = float(rng.integers(1, 20))
        recs.append(sub)
        t = wall
        if rng.random() < 0.2:
            t += float(rng.random())
            recs.append({"event": "fleet_lifecycle", "kind": "claimed",
                         "request_id": rid, "wall_time": t})
            t += float(rng.random())
            recs.append({"event": "fleet_lifecycle", "kind": "released",
                         "request_id": rid, "wall_time": t})
        if rng.random() < 0.9:
            t += float(rng.random() * 5)
            recs.append({"event": "fleet_lifecycle", "kind": "claimed",
                         "request_id": rid, "wall_time": t})
            for _ in range(int(rng.integers(1, 3))):
                t += float(rng.random())
                recs.append({"event": "fleet_lifecycle", "kind": "attempt",
                             "request_id": rid, "wall_time": t,
                             "started_at": t})
            if rng.random() < 0.8:
                t += float(rng.random() * 10)
                state = str(rng.choice(["done", "done", "failed",
                                        "deadletter", "canceled"]))
                recs.append({"event": "fleet_lifecycle", "kind": "settled",
                             "request_id": rid, "wall_time": t,
                             "state": state})
                if state == "deadletter" and rng.random() < 0.5:
                    recs.append({"event": "fleet_lifecycle",
                                 "kind": "requeued", "request_id": rid,
                                 "wall_time": t + 1.0})
    return recs


def test_slo_equals_jax(tmp_path, monkeypatch):
    """compute_slo (all-time, windowed, with thresholds), slo_for_root
    over a history file, compute_serve_slo over serve records and the
    nearest-rank percentile: equal to the JAX module's."""
    for k in ("QUEUE_P99_S", "TTFA_P99_S", "DEADLINE_PCT", "DEADLETTER_PCT",
              "SERVE_P50_MS", "SERVE_P99_MS"):
        monkeypatch.delenv(f"REDCLIFF_SLO_{k}", raising=False)
    recs = _history(0)
    thr = {"queue_p99_s": 2.0, "ttfa_p99_s": 3.0, "deadline_pct": 90.0,
           "deadletter_pct": 5.0}
    for kw in ({}, {"thresholds": {}}, {"thresholds": thr},
               {"window_s": 10.0}):
        assert tslo.compute_slo(recs, **kw) == jslo.compute_slo(recs, **kw)
    root = tmp_path / "fleet"
    root.mkdir()
    with open(root / "history.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    ts, js = {}, {}
    assert tslo.slo_for_root(str(root), stats=ts) \
        == jslo.slo_for_root(str(root), stats=js)
    assert ts["records"] == js["records"] == len(recs)
    assert tslo.slo_for_root(str(tmp_path / "none")) is None \
        and jslo.slo_for_root(str(tmp_path / "none")) is None
    vals = list(np.random.default_rng(1).random(101) * 10)
    for p in (0.0, 1.0, 50.0, 99.0, 100.0):
        assert tslo.percentile(vals, p) == jslo.percentile(vals, p)
    serve = [{"event": "serve", "kind": "tick", "p50_ms": 1.5,
              "p99_ms": 9.0, "n": 40, "streams": 3, "width": 4,
              "fused_samples": 2, "mode": "force", "samples_in": 50,
              "samples_out": 40, "rejects": 1, "dropped": 0},
             {"event": "serve_ladder", "kind": "grow", "to_width": 8}]
    sthr = {"serve_p50_ms": 1.0, "serve_p99_ms": 10.0}
    for kw in ({}, {"thresholds": sthr}):
        assert tslo.compute_serve_slo(serve, **kw) \
            == jslo.compute_serve_slo(serve, **kw)


def test_admission_errors_equal_jax():
    cases = [("AdmissionReject", ("m",), {"eta_s": 2, "reason": "r"}),
             ("BackpressureReject", ("t", 12.5, 5.0, 7, 2), {}),
             ("SlotsExhausted", (4,), {"eta_s": 1.25}),
             ("SlotsExhausted", (4,), {}),
             ("TenantQuotaExceeded", ("t", 2, 2), {"eta_s": 3.0})]
    for name, args, kw in cases:
        a = getattr(tadm, name)(*args, **kw)
        b = getattr(jadm, name)(*args, **kw)
        assert str(a) == str(b) and vars(a) == vars(b), name
        assert isinstance(a, tadm.AdmissionReject)
    assert tadm.__all__ == jadm.__all__
    import redcliff_tpu_torch.runtime as R

    assert R.BackpressureReject is tadm.BackpressureReject


# ------------------------------------------------- the bf16 kernel, on CPU
def test_graph_mix_bf16_plain_version_and_plan():
    """The plain bf16 blend equals a float64 numpy product of the rounded
    operands (to f32 rounding); graph_mix takes it for a bf16 operand on
    the CPU without counting a launch; the bf16 plan picks 8-byte loads
    for the serve row of 100 bf16 (200 bytes: 8-, not 16-byte aligned)
    and never an f32 autotune plan."""
    rng = np.random.default_rng(3)
    for S, K, D in ((64, 5, 10), (7, 3, 5), (1, 2, 4), (16, 5, 3)):
        w = torch.from_numpy(rng.random((S, K)).astype(np.float32))
        g = torch.from_numpy(rng.normal(size=(K, D, D)).astype(np.float32))
        wb, gb = w.to(torch.bfloat16), g.to(torch.bfloat16)
        want = np.einsum("sk,kij->sij", wb.float().numpy().astype(np.float64),
                         gb.float().numpy().astype(np.float64))
        before = FM.graph_mix_bf16.launches
        for got in (FM.graph_mix_bf16_reference(wb, gb),
                    FM.graph_mix(wb, gb), FM.graph_mix_bf16(wb, gb)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)
        assert FM.graph_mix_bf16.launches == before
        # the f32 blend of the rounded operands is the same function
        np.testing.assert_array_equal(
            FM.graph_mix_bf16_reference(wb, gb).numpy(),
            FM.graph_mix_reference(wb.float(), gb.float()).numpy())
    # (vec, threads, blocks): itemsize 2 aligns at 2 * vec bytes
    plan = FM.mix_plan
    assert plan(64, 100, 100, 0, 0, itemsize=2) == (4, 128, 13)
    assert plan(64, 100, 100, 0, 8, itemsize=2) == (4, 128, 13)
    assert plan(64, 100, 100, 0, 8) == (2, 128, 25)       # f32: float2
    assert plan(64, 100, 100, 0, 4, itemsize=2)[0] == 2
    assert plan(64, 100, 100, 0, 2, itemsize=2)[0] == 1
    assert plan(64, 100, 102, 0, 0, itemsize=2)[0] == 2   # stride % 4
    assert plan(64, 25, 25, 0, 0, itemsize=2)[0] == 1     # M odd
    assert plan(4, 100, 100, 0, 0, itemsize=2, threads=64) == (4, 64, 2)
    assert autotune.mix_key(64, 5, 100, bf16=True) \
        == ("factor_mix_bf16", "k5m100", 64)
    assert autotune.mix_key(64, 5, 100)[0] == "factor_mix"


def test_mixed_engine_blends_in_bf16(monkeypatch):
    """The mixed engine hands the blend its f32 scores, which the bf16 form
    rounds in its one launch, and the bf16 copy of the static graphs made
    at load (the f32 graphs kept for demotion), and
    its embedder contractions see bf16-rounded operands; after demote()
    the f32 path runs again."""
    from redcliff_tpu_torch.serve import engine as eng_mod
    from redcliff_tpu_torch.utils import precision

    _, _, tm, tp = _models("Vanilla_Embedder")
    eng = StreamEngine(tm, tp, capacity=3, precision_mode="mixed",
                       device="cpu")
    assert eng._static_gc_bf16.dtype == torch.bfloat16
    assert eng.static_gc.dtype == torch.float32
    assert torch.equal(eng._static_gc_bf16, eng.static_gc.bfloat16())
    seen = []
    real = eng_mod.graph_mix

    def spy(w, g):
        seen.append((w.dtype, g.dtype))
        return real(w, g)

    monkeypatch.setattr(eng_mod, "graph_mix", spy)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, C)).astype(np.float32)
    with precision.matmul_precision_ctx(precision.MIXED_MATMUL):
        a = torch.from_numpy(x)
        assert torch.equal(precision.matmul(a, a.T),
                           a.bfloat16().float() @ a.bfloat16().float().T)
    assert torch.equal(precision.matmul(a, a.T), a @ a.T)
    eng.step(x, np.ones(3, bool))
    assert eng.demote() and not eng.demote() and eng.is_cold(3)
    eng.step(x, np.ones(3, bool))
    assert seen == [(torch.float32, torch.bfloat16),
                    (torch.float32, torch.float32)]


@pytest.mark.gpu
def test_bf16_kernel_matches_plain_on_card():
    """On the card: the bf16 form against its plain version at every rung
    of the serve table and off its fast path (graphs offset by one bf16:
    the scalar plan; M = 25; K above the unrolled 16); an operand it does
    not take, or one that wants a gradient, raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev).bfloat16()

    def check(w, g):
        before = FM.graph_mix_bf16.launches
        got = FM.graph_mix(w, g)
        assert FM.graph_mix_bf16.launches == before + 1
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, FM.graph_mix_bf16_reference(w, g),
                                   rtol=1e-5, atol=1e-6)

    g = bf(rng.normal(size=(5, 10, 10)))
    for S in (4, 8, 16, 32, 64, 3):
        check(bf(rng.random((S, 5))), g)
    flat = torch.empty(g.numel() + 1, dtype=torch.bfloat16, device=dev)
    off = flat[1:].view(g.shape)
    off.copy_(g)
    assert off.data_ptr() % 4 == 2
    check(bf(rng.random((64, 5))), off)
    check(bf(rng.random((7, 5))), bf(rng.normal(size=(5, 5, 5))))
    check(bf(rng.random((9, 20))), bf(rng.normal(size=(20, 10, 10))))
    w = bf(rng.random((8, 5)))
    with pytest.raises(TypeError):
        FM.graph_mix_bf16(w, g.float())
    with pytest.raises(ValueError):
        FM.graph_mix_bf16(w.t(), g)
    # the bf16 form takes a gradient now: JAX's bf16 backward, the
    # transposed contraction on the bf16-rounded cotangent and operand
    wg = w.float().requires_grad_(True)
    out = FM.graph_mix_bf16(wg, g)
    cot = torch.randn_like(out)
    dw, = torch.autograd.grad(out, (wg,), cot)
    want = torch.einsum("sij,kij->sk", cot.bfloat16().float(), g.float())
    torch.testing.assert_close(dw, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- telemetry
def test_serve_events_validate_with_jax_field_sets(tmp_path, monkeypatch,
                                                   store):
    """One run of each service with every serve event kind this slice
    writes (start, tick, qos, overflow, reject, drain, stop, session
    lifecycle, serve_ladder, serve_fuse, precision): the port's records
    validate, and each (event, kind) carries the JAX record's fields."""
    monkeypatch.setenv("REDCLIFF_SERVE_LADDER_HOLD", "2")
    monkeypatch.setenv("REDCLIFF_SERVE_INGEST_CAP", "8")
    monkeypatch.setenv("REDCLIFF_SERVE_DEMOTE_STORM", "1")
    victims = {"v0": chaos.stream_samples(7, 40, C)}

    def run(svc):
        svc.connect(sid="v0", now=0.0)
        storm = chaos.make_sawtooth_storm(5, C, lo=0, hi=5, period=4,
                                          nan_p=0.2)

        def chaos_fn(s, t, now):
            storm(s, t, now)
            if t == 3:
                for _ in range(10):      # backlog: qos, overflow, fusion
                    s.ingest("v0", victims["v0"][0], now=now)
            if t == 5:
                try:
                    for i in range(8):
                        s.connect(sid=f"x{i}", now=now)
                except Exception:        # SlotsExhausted: a reject event
                    pass
                for i in range(8):
                    s.disconnect(f"x{i}")
        res = chaos.drive(svc, victims, ticks=30, chaos_fn=chaos_fn)
        svc.drain(now=10.0)
        return res

    js, ts = _pair(capacity=8, ladder="force", fuse=2,
                   precision_mode="mixed", jroot=str(tmp_path / "j"),
                   troot=str(tmp_path / "t"))
    run(js), run(ts)
    trecs, jrecs = read_jsonl(str(tmp_path / "t")), jread_jsonl(
        str(tmp_path / "j"))
    assert schema.validate_records(trecs) == []

    def shapes(recs):
        out = {}
        for r in recs:
            key = (r["event"], r.get("kind"))
            out.setdefault(key, set()).update(set(r) - set(_IDENTITY))
        return out

    got, want = shapes(trecs), shapes(jrecs)
    assert got == want
    for key in (("serve", "start"), ("serve", "tick"), ("serve", "qos"),
                ("serve", "overflow"), ("serve", "reject"),
                ("serve", "drain"), ("serve", "stop"),
                ("session", "connect"), ("session", "quarantine"),
                ("session", "recycle"), ("serve_ladder", "grow"),
                ("serve_ladder", "shrink"), ("serve_fuse", "stats"),
                ("precision", "demote")):
        assert key in got, key
    assert tslo.compute_serve_slo(trecs)["latency"]["n"] > 0


# ------------------------------------------------------------------ CLI
def test_ladder_smoke_cli(tmp_path, monkeypatch, store, capsys):
    """``python -m redcliff_tpu_torch.serve ladder-smoke --device cpu``:
    rungs 4 -> 32 -> 4, victims within the bar, exit 0."""
    from redcliff_tpu_torch.serve.__main__ import main

    monkeypatch.setenv("REDCLIFF_SERVE_LADDER_HOLD", "2")
    before = FM.factor_mix.launches
    assert main(["ladder-smoke", "--root", str(tmp_path / "ls"),
                 "--device", "cpu"]) == 0
    assert "rungs [4, 32, 4]" in capsys.readouterr().out
    assert FM.factor_mix.launches == before
