"""The port's launch-plan autotuner (redcliff_tpu_torch/ops/autotune.py)
against the JAX package's (redcliff_tpu/ops/autotune.py).

The store half is a copy: the same winners give the same store JSON, and
``tune`` with a fake ``measure`` picks the first minimum of a fixed-order
ladder, records the same search and reuse records, and reuses a stored
winner with zero search steps, as JAX's does. The measuring half is the
card's: the plans (``ops/factor_mix.py mix_plan`` / ``_mix_args``,
``ops/pallas_prox.py prox_plan`` / ``_prox_args``) read a stored winner's
threads per block when their per-shape cache is filled and keep today's
rule without one; ``tune_for_model`` is a no-op off the card. The ``gpu``
tests hold every point of each kernel's ladder against its plain version
on the card.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu.ops import autotune as jat  # noqa: E402
from redcliff_tpu_torch.models.redcliff import RedcliffSCMLPConfig  # noqa: E402,E501
from redcliff_tpu_torch.ops import autotune as tat  # noqa: E402
from redcliff_tpu_torch.ops import factor_mix as FM  # noqa: E402
from redcliff_tpu_torch.ops import pallas_prox as PX  # noqa: E402

WINNERS = [("factor_mix", "k5m10", 128, {"threads": 64}, 12.5, 1.1),
           ("factor_mix_lanes", "k5m10b128", 32, {"threads": 256}, 9.0,
            None),
           ("gl_prox", "h25c10l4", 64, {"threads": 128}, 30.0, 0.98),
           ("factor_mix", "k5m10", 128, {"threads": 128}, 11.0, 1.0)]


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """Both tuners with empty memos and record rings, no store in the
    environment, and the port's plan caches emptied before and after."""
    for k in ("REDCLIFF_AUTOTUNE_DIR", "REDCLIFF_COMPILE_CACHE",
              "REDCLIFF_AUTOTUNE"):
        monkeypatch.delenv(k, raising=False)
    for mod in (jat, tat):
        mod.clear_memo()
        mod.drain_records()
    FM._mix_args.cache_clear()
    PX._prox_args.cache_clear()
    yield tmp_path
    for mod in (jat, tat):
        mod.clear_memo()
        mod.drain_records()
    FM._mix_args.cache_clear()
    PX._prox_args.cache_clear()


def test_store_json_matches_jax(fresh):
    for mod, d in ((jat, fresh / "j"), (tat, fresh / "t")):
        for i, (kernel, shape, bucket, tile, ms, speed) in enumerate(
                WINNERS):
            mod.record_winner(kernel, shape, bucket, tile, platform="cuda",
                              base_dir=str(d), search_ms=ms, candidates=3,
                              speedup_vs_default=speed, now=100.0 + i)
    with open(tat.store_path(str(fresh / "t"))) as f, \
            open(jat.store_path(str(fresh / "j"))) as g:
        got, want = f.read(), g.read()
    assert got == want
    store = json.loads(got)
    assert store["winners"]["cuda|factor_mix|k5m10|g128"]["runs"] == 2
    for kernel, shape, bucket, *_ in WINNERS:
        assert tat.winner(kernel, shape, bucket, platform="cuda",
                          base_dir=str(fresh / "j")) == \
            jat.winner(kernel, shape, bucket, platform="cuda",
                       base_dir=str(fresh / "j"))


def _fake_measure(times):
    calls = []

    def measure(tile):
        calls.append(tile["threads"])
        return times[tile["threads"]]
    measure.calls = calls
    return measure


@pytest.mark.parametrize("times", [
    {64: 3.0, 128: 2.0, 256: 2.0},     # a tie: the first minimum wins
    {64: 1.0, 128: 2.0, 256: 3.0},
    {64: 5.0, 128: 5.0, 256: 4.0}])
def test_tune_picks_the_first_minimum_then_reuses(fresh, times):
    ladder = [{"threads": t} for t in (64, 128, 256)]
    out = {}
    for name, mod in (("jax", jat), ("port", tat)):
        d = str(fresh / name)
        m1 = _fake_measure(times)
        tile, rec = mod.tune("factor_mix", "k5m10", 128, ladder, m1,
                             default={"threads": 128}, platform="cuda",
                             base_dir=d, reps=3)
        m2 = _fake_measure(times)
        tile2, rec2 = mod.tune("factor_mix", "k5m10", 128, ladder, m2,
                               default={"threads": 128}, platform="cuda",
                               base_dir=d, reps=3)
        recs = mod.drain_records()
        for r in recs:
            r.pop("search_ms", None)
        out[name] = (tile, rec["searched"], rec["search_steps"], m1.calls,
                     tile2, rec2["searched"], rec2["search_steps"],
                     m2.calls, recs, rec["speedup_vs_default"])
    assert out["port"] == out["jax"]
    best = min(times.values())
    assert out["port"][0] == {"threads": next(
        t for t in (64, 128, 256) if times[t] == best)}
    assert out["port"][6] == 0 and out["port"][7] == []


def test_search_disabled_and_storeless_match_jax(fresh, monkeypatch):
    ladder = [{"threads": t} for t in (128, 256, 512)]
    for env in ({"REDCLIFF_AUTOTUNE": "0",
                 "REDCLIFF_AUTOTUNE_DIR": str(fresh / "s")}, {}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = tat.tune("gl_prox", "h25c10l4", 64, ladder,
                       _fake_measure({128: 1, 256: 1, 512: 1}),
                       default={"threads": 320}, platform="cuda")
        want = jat.tune("gl_prox", "h25c10l4", 64, ladder,
                        _fake_measure({128: 1, 256: 1, 512: 1}),
                        default={"threads": 320}, platform="cuda")
        assert got == want and got[0] == {"threads": 320}
        assert tat.search_enabled() == jat.search_enabled()
        for k in env:
            monkeypatch.delenv(k)
    assert tat.drain_records() == jat.drain_records() == []
    for n in (0, 1, 2, 3, 50, 64, 65, 1600):
        assert tat._pow2_bucket(n) == jat._pow2_bucket(n)
    assert tat.winner_key("cuda", "gl_prox", "h", 64) == \
        jat.winner_key("cuda", "gl_prox", "h", 64)


def test_keys_and_ladders():
    assert tat.mix_key(128, 5, 10) == ("factor_mix", "k5m10", 128)
    assert tat.mix_key(80, 5, 10, G=32) == ("factor_mix_lanes",
                                            "k5m10b128", 32)
    assert tat.prox_key(50, 25, 10, 4) == ("gl_prox", "h25c10l4", 50)
    assert tat.prox_key(1600, 25, 10, 4, 50) == ("gl_prox_lanes",
                                                 "h25c10l4s50", 32)
    assert [t["threads"] for t in tat.factor_mix_ladder(128)] == \
        [64, 128, 256]
    assert [t["threads"] for t in tat.gl_prox_ladder()] == [128, 256, 512]
    # every ladder point is a plan the kernels take: the factor mix's
    # __launch_bounds__(256), the GL prox's multiples of 32 up to 512
    assert max(tat.FACTOR_MIX_THREADS) <= 256
    assert all(t % 32 == 0 and t <= 512 for t in tat.GL_PROX_THREADS)


def _plans():
    """The train shapes' and the grid's lane shapes' cached plans."""
    FM._mix_args.cache_clear()
    PX._prox_args.cache_clear()
    return {"factor_mix": FM._mix_args(128, 5, 10, 1280, 10, 0, 0)[0],
            "factor_mix_lanes": FM._mix_args(128, 5, 10, 1280, 10, 0, 0,
                                             32, 640, 6400)[0],
            "gl_prox": PX._prox_args(50, 25, 10, 4, 0, 0)[0],
            "gl_prox_lanes": PX._prox_args(1600, 25, 10, 4, 0, 0, 50)[0]}


def test_plans_read_a_stored_winner_and_keep_todays_rule_without(
        fresh, monkeypatch):
    default = _plans()
    # today's plans: 128 threads for the mix, one warp per group (320 at
    # C_in = 10) for the prox
    assert [default[k].threads for k in default] == [128, 128, 320, 320]
    assert default["factor_mix"].blocks == 5  # 640 float2 outputs
    assert (PX.prox_plan(25, 10, 4, 0), FM.mix_plan(128, 10, 1280, 10, 0)) \
        == ((1000, True, 320), (2, 128, 5))
    monkeypatch.setattr(tat, "_platform", lambda: "cuda")
    monkeypatch.setenv("REDCLIFF_AUTOTUNE_DIR", str(fresh / "store"))
    assert [p.threads for p in _plans().values()] == [128, 128, 320, 320]
    for kernel, shape, bucket, threads in (
            ("factor_mix", "k5m10", 128, 64),
            ("factor_mix_lanes", "k5m10b128", 32, 256),
            ("gl_prox", "h25c10l4", 64, 128),
            ("gl_prox_lanes", "h25c10l4s50", 32, 512)):
        tat.record_winner(kernel, shape, bucket, {"threads": threads})
    tuned = _plans()
    assert [tuned[k].threads for k in tuned] == [64, 256, 128, 512]
    assert tuned["factor_mix"].blocks == 10
    assert tuned["factor_mix_lanes"].blocks == math.ceil(640 / 256)
    # everything but the threads (and the blocks that cover the work) is
    # today's plan
    for k in tuned:
        for f, _ in type(tuned[k])._fields_:
            if f not in ("threads", "blocks"):
                assert getattr(tuned[k], f) == getattr(default[k], f), f
    # a trial plan wins over the store while it lasts
    with tat.trial("gl_prox", {"threads": 256}):
        assert PX._prox_args(50, 25, 10, 4, 0, 0)[0].threads == 256
    assert PX._prox_args(50, 25, 10, 4, 0, 0)[0].threads == 128
    # the winners are not another platform's
    monkeypatch.setattr(tat, "_platform", lambda: "torch_cpu")
    tat.clear_memo()
    assert [p.threads for p in _plans().values()] == [128, 128, 320, 320]


def test_tune_for_model_is_a_noop_off_the_card(fresh, monkeypatch):
    cfg = RedcliffSCMLPConfig(num_chans=10, gen_lag=4, gen_hidden=(25,),
                              embed_lag=16, embed_hidden_sizes=(0,),
                              num_factors=5, num_supervised_factors=5,
                              training_mode="combined")
    monkeypatch.setenv("REDCLIFF_AUTOTUNE_DIR", str(fresh / "store"))
    for device in (None, "cpu", torch.device("cpu")):
        assert tat.tune_for_model(cfg, 128, prox_penalty="GL",
                                  device=device, lanes=32) is None
    assert not (fresh / "store").exists() and tat.drain_records() == []
    # the port's platform label off the card is not a JAX backend name
    if not torch.cuda.is_available():
        assert tat._platform() == "torch_cpu"


# ------------------------------------------------------------------ on card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels launch only there")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 32])
def test_every_factor_mix_tile_matches_the_plain_version_on_card(lanes):
    """Each threads-per-block of the ladder at the train shape (B=128 K=5
    M=10) and its lane form, against the plain version, and bitwise equal
    across tiles (K is summed in one thread whatever the block size)."""
    gen = _card()
    lead = () if lanes == 1 else (lanes,)
    w = torch.rand(lead + (128, 5), generator=gen, device="cuda")
    p = torch.randn(lead + (5, 128, 1, 10), generator=gen, device="cuda")
    kernel, mix, ref = (("factor_mix", FM.factor_mix,
                         FM.factor_mix_reference) if lanes == 1 else
                        ("factor_mix_lanes", FM.factor_mix_lanes,
                         FM.factor_mix_lanes_reference))
    want = ref(w, p)
    outs = []
    for t in tat.FACTOR_MIX_THREADS:
        with tat.trial(kernel, {"threads": t}):
            got = mix(w, p)
            assert FM.launch_plan(w, p)[1] == t
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        outs.append(got)
    assert all(torch.equal(outs[0], o) for o in outs)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 32])
def test_every_gl_prox_tile_matches_the_plain_version_on_card(lanes):
    """Each threads-per-block of the ladder on the train block (5, 10, 25,
    10, 4) and its lane form (per-lane thresholds, 27 lanes on), in place,
    against the plain version at atol 1e-6."""
    gen = _card()
    block = (5, 10, 25, 10, 4)
    lead = () if lanes == 1 else (lanes,)
    W0 = torch.randn(lead + block, generator=gen, device="cuda")
    lam, lr = 4.0, 5e-4
    if lanes == 1:
        kernel, want = "gl_prox", PX.gl_prox_reference(W0, lam, lr)
    else:
        t = PX.lane_thresholds(torch.full((lanes,), lr, device="cuda"), lam)
        gate = torch.arange(lanes, device="cuda") < 27
        kernel, want = "gl_prox_lanes", PX.gl_prox_lanes_reference(W0, t,
                                                                   gate)
    for threads in tat.GL_PROX_THREADS:
        W = W0.clone()
        with tat.trial(kernel, {"threads": threads}):
            if lanes == 1:
                PX.gl_prox_(W, lam, lr)
            else:
                PX.gl_prox_lanes_(W, t, gate)
            assert PX.launch_plan(W, lanes=lanes > 1)[2] == threads
        torch.testing.assert_close(W, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(W.cpu().numpy()).all()
