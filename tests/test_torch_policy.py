"""The port's predictive scheduling policy (redcliff_tpu_torch/parallel/
policy.py ``PredictiveSchedulingPolicy``) against the JAX package's
(redcliff_tpu/parallel/policy.py:181-381) on one cost-model store:
``initial_width``, ``compaction_plan``, ``take_decision`` and
``compile_order`` give the same answers and decision records, the
fallbacks included; ``predictive_enabled`` reads the switch the same way.

On the grid: the policy is swapped in before the initial width only when
``REDCLIFF_PREDICTIVE`` is set and a store resolves; a store without a
usable prior gives the heuristic's decisions (``fallback`` records) and a
fit bitwise equal to the heuristic one; a store whose prices favour
holding keeps the width and says so in a ``policy`` event. A width is
"warm" for the port's grid when its epoch engine needs no capture there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu.obs import costmodel as jcm  # noqa: E402
from redcliff_tpu.parallel import policy as jpol  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset  # noqa: E402
from redcliff_tpu_torch.interop import tree_leaves  # noqa: E402
from redcliff_tpu_torch.obs import costmodel as tcm  # noqa: E402
from redcliff_tpu_torch.obs import schema  # noqa: E402
from redcliff_tpu_torch.obs.logging import read_jsonl  # noqa: E402
from redcliff_tpu_torch.parallel import policy as tpol  # noqa: E402
from redcliff_tpu_torch.runtime import faultinject as fi  # noqa: E402

SHAPE = "s"
# (platform, shape, width, epochs, epoch ms total, compiles, compile ms)
ROWS = [("cuda", SHAPE, 32, 10, 800.0, 2, 3000.0),
        ("cuda", SHAPE, 16, 10, 600.0, 0, 0.0),
        ("cuda", SHAPE, 64, 4, 460.0, 1, 900.0),
        ("cuda", SHAPE, 8, 5, 270.0, 0, 0.0),
        ("cuda", "other", 4, 3, 30.0, 1, 10.0)]


def _store(mod, base):
    for i, (platform, shape, w, n, ms, c, cms) in enumerate(ROWS):
        mod.update_store(str(base), [{
            "shape": shape, "g_bucket": w, "epochs": n, "epoch_ms": ms,
            "compiles": c, "compile_ms": cms}], platform, now=10.0 + i)
    return mod.load(str(base))


def _policies(tmp_path, **kw):
    jm, tm = _store(jcm, tmp_path / "j"), _store(tcm, tmp_path / "t")
    base = dict(shape_key=SHAPE, platform="cuda")
    base.update(kw)
    return (jpol.PredictiveSchedulingPolicy(cost_model=jm, **base),
            tpol.PredictiveSchedulingPolicy(cost_model=tm, **base))


def _plan_tuple(plan):
    if plan is None:
        return None
    return (plan.new_width, plan.sel.tolist(), plan.orig_ids.tolist(),
            plan.active.tolist(), plan.retire_rows.tolist(),
            plan.retire_ids.tolist())


@pytest.mark.parametrize("kw", [
    dict(epochs=100), dict(epochs=3), dict(epochs=100, max_width=32),
    dict(epochs=None), dict(epochs=50, gather_ms=5000.0),
    dict(epochs=20, shape_key="unseen"), dict(epochs=20, platform="tpu"),
    dict(epochs=20, precision="mixed"), dict(epochs=20, g_bucket=False)])
def test_initial_width_matches_jax(tmp_path, kw):
    jp, tp = _policies(tmp_path, **kw)
    for g in (3, 5, 9, 15, 16, 27, 40):
        assert tp.initial_width(g) == jp.initial_width(g, 1), g
        assert tp.take_decision() == jp.take_decision()
        assert tp.take_decision() is jp.take_decision() is None


def _masks(rng, width, n_live):
    m = np.zeros(width, bool)
    m[rng.choice(width, n_live, replace=False)] = True
    return m


@pytest.mark.parametrize("kw", [dict(), dict(gather_ms=1e6),
                                dict(shape_key="unseen")])
def test_compaction_plan_matches_jax(tmp_path, kw):
    jp, tp = _policies(tmp_path, **kw)
    rng = np.random.default_rng(0)
    for width, live in ((32, 27), (32, 15), (32, 9), (16, 7), (64, 20),
                        (8, 1), (32, 0)):
        active = _masks(rng, width, live)
        orig = np.where(np.arange(width) < min(width, 27),
                        np.arange(width), -1).astype(np.int32)
        for remaining in (None, 0, 1, 3, 40):
            got = tp.compaction_plan(active, orig, [],
                                     epochs_remaining=remaining)
            want = jp.compaction_plan(active, orig, [], 1,
                                      epochs_remaining=remaining)
            assert _plan_tuple(got) == _plan_tuple(want)
            assert tp.take_decision() == jp.take_decision()
    # the heuristic base policy prices nothing
    heur = tpol.GridSchedulingPolicy()
    assert _plan_tuple(heur.compaction_plan(
        _masks(rng, 32, 9), np.arange(32, dtype=np.int32), [])) is not None


def test_compile_order_matches_jax(tmp_path):
    jm, tm = _store(jcm, tmp_path / "j"), _store(tcm, tmp_path / "t")
    programs = [
        {"shape_key": SHAPE, "g_bucket": 32}, {"shape_key": SHAPE,
                                               "g_bucket": 16},
        {"cold_compile_ms": 50.0}, {"cold_compile_ms": 0},
        {"shape_key": "other", "g_bucket": 8}, {"shape_key": None},
        {"cold_compile_ms": None}, {"shape_key": SHAPE, "g_bucket": 128,
                                    "precision": "f32"},
        {"cold_compile_ms": 5000.0}]
    for platform in ("cuda", None):
        assert tpol.PredictiveSchedulingPolicy.compile_order(
            programs, tm, platform) == \
            jpol.PredictiveSchedulingPolicy.compile_order(
                programs, jm, platform)
    assert tpol.PredictiveSchedulingPolicy.compile_order(programs) == \
        jpol.PredictiveSchedulingPolicy.compile_order(programs)


@pytest.mark.parametrize("val", [None, "", "0", "1", "true", "off", "False",
                                 " yes "])
def test_predictive_switch_matches_jax(monkeypatch, val):
    if val is None:
        monkeypatch.delenv("REDCLIFF_PREDICTIVE", raising=False)
    else:
        monkeypatch.setenv("REDCLIFF_PREDICTIVE", val)
    assert tpol.predictive_enabled() == jpol.predictive_enabled()
    assert tpol.predictive_enabled(val) == jpol.predictive_enabled(val)
    assert (tpol.ENV_PREDICTIVE, tpol.ENV_POLICY_MAX_WIDTH) == \
        (jpol.ENV_PREDICTIVE, jpol.ENV_POLICY_MAX_WIDTH)


def test_warm_callable_replaces_the_store_evidence(tmp_path):
    """Without ``warm=`` the store's capture evidence says which widths are
    warm (as in JAX); the port's grid passes ``warm=``: a warm target costs
    the gather only, a cold one the predicted capture too."""
    _, tp = _policies(tmp_path, epochs=10)
    assert tp._warm(32) and not tp._warm(16)
    assert tp._move_cost_ms(32) == 250.0
    assert tp._move_cost_ms(16) == 1500.0 + 250.0  # g32's capture mean
    warm = tpol.PredictiveSchedulingPolicy(
        cost_model=tp.cost_model, shape_key=SHAPE, platform="cuda",
        warm=lambda w: w == 16)
    assert warm._move_cost_ms(16) == 250.0
    assert warm._move_cost_ms(32) == 1500.0 + 250.0


def _tiny(tmp_path, name, max_iter=4):
    runner, X, Y = fi._tiny_runner(max_iter, device="cpu")
    ds = ArrayDataset(X, Y)
    res = runner.fit(2, ds, ds, log_dir=str(tmp_path / name))
    return runner, res


def _shape_key():
    runner, _, _ = fi._tiny_runner(1, device="cpu")
    return runner._shape_key()


def test_grid_without_a_usable_prior_equals_the_heuristic(tmp_path,
                                                          monkeypatch):
    """An armed policy over a store that prices nothing of this fit: every
    decision falls back (recorded), and the fit equals the heuristic
    one bitwise."""
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    monkeypatch.setenv("REDCLIFF_COST_MODEL_DIR", str(tmp_path / "store"))
    monkeypatch.delenv("REDCLIFF_PREDICTIVE", raising=False)
    hrun, hres = _tiny(tmp_path, "heuristic")
    assert type(hrun.policy) is tpol.GridSchedulingPolicy
    # the heuristic fit wrote rows for its own shape: aim the armed fit at
    # a store holding another shape only
    monkeypatch.setenv("REDCLIFF_COST_MODEL_DIR", str(tmp_path / "other"))
    tcm.update_store(str(tmp_path / "other"), [{
        "shape": "elsewhere", "g_bucket": 2, "epochs": 3, "epoch_ms": 9.0,
        "compiles": 1, "compile_ms": 5.0}], "torch_cpu", now=1.0)
    monkeypatch.setenv("REDCLIFF_PREDICTIVE", "1")
    prun, pres = _tiny(tmp_path, "predictive")
    assert type(prun.policy) is tpol.PredictiveSchedulingPolicy
    for a, b in zip(tree_leaves(pres.best_params),
                    tree_leaves(hres.best_params)):
        assert np.array_equal(a, b, equal_nan=True)
    assert np.array_equal(pres.val_history, hres.val_history,
                          equal_nan=True)
    pol = read_jsonl(str(tmp_path / "predictive"), event="policy")
    assert [(p["kind"], p["action"], p["fallback"]) for p in pol] == [
        ("initial_width", "fallback", True)]
    assert not schema.validate_records(pol)
    # with no store at all the heuristic stays
    monkeypatch.setenv("REDCLIFF_COST_MODEL_DIR", str(tmp_path / "none"))
    runner, _, _ = fi._tiny_runner(1, device="cpu")
    assert type(runner.policy) is tpol.GridSchedulingPolicy


def test_grid_holds_a_compaction_the_store_prices_out(tmp_path,
                                                      monkeypatch):
    """Four lanes, two evicted at epoch 0 (width 4 -> 2 by the ladder). A
    store pricing both widths alike makes the move a loss (the gather
    alone outweighs no saving): the policy holds and logs it, the grid
    stays at width 4, and the surviving lanes' results are the compacted
    fit's (lanes are independent)."""
    from redcliff_tpu_torch.parallel.grid import (GridSpec,
                                                  RedcliffGridRunner)

    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    monkeypatch.setenv("REDCLIFF_COST_MODEL_DIR", str(tmp_path / "store"))
    monkeypatch.delenv("REDCLIFF_PREDICTIVE", raising=False)

    def fit(name):
        tiny, X, Y = fi._tiny_runner(3, device="cpu")
        runner = RedcliffGridRunner(tiny.model, tiny.tc, GridSpec(
            points=[{"gen_lr": 1e-3}, {"gen_lr": 3e-3}, {"gen_lr": 2e-3},
                    {"embed_lr": 2e-3}],
            fit_deadline_s=[float("inf"), 1e-9, 1e-9, float("inf")]),
            device="cpu")
        ds = ArrayDataset(X, Y)
        return runner, runner.fit(2, ds, ds, log_dir=str(tmp_path / name))

    hrun, hres = fit("heuristic")
    assert [e["width"] for e in hres.epochs] == [4, 2, 2]
    # a store of these prices only (the heuristic fit folded its own)
    monkeypatch.setenv("REDCLIFF_COST_MODEL_DIR", str(tmp_path / "priced"))
    tcm.update_store(str(tmp_path / "priced"), [
        {"shape": _shape_key(), "g_bucket": w, "epochs": 4,
         "epoch_ms": 40.0, "compiles": 0, "compile_ms": 0.0}
        for w in (4, 2)], "torch_cpu", now=1.0)
    monkeypatch.setenv("REDCLIFF_PREDICTIVE", "1")
    prun, pres = fit("predictive")
    assert [e["width"] for e in pres.epochs] == [4, 4, 4]
    pol = read_jsonl(str(tmp_path / "predictive"), event="policy")
    assert [(p["kind"], p["action"]) for p in pol][-2:] == [
        ("compaction", "hold"), ("compaction", "hold")]
    hold = pol[-2]
    assert hold["from_width"] == 4 and hold["to_width"] == 2
    assert hold["saving_ms"] == 0.0 and hold["compile_ms"] == 0.0
    for a, b in zip(tree_leaves(pres.best_params),
                    tree_leaves(hres.best_params)):
        assert np.allclose(a[[0, 3]], b[[0, 3]], rtol=0, atol=1e-6)
