"""The port's training slice (redcliff_tpu_torch: models/redcliff.py
training half, ops/losses.py, data/, runtime/numerics.py, train/freeze.py,
train/tracking.py, utils/misc.py, train/redcliff_trainer.py) against the
JAX package.

Weights are made by the JAX package's ``init`` and carried across with
``interop.params_from_jax``; inputs are made with numpy from a seed. The
whole-slice fits run the slice's schedule (1 pretrain + 1 acclimation + 2
combined epochs, GL prox on) at a tiny width on the CPU.
"""
import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from redcliff_tpu.data import datasets as jds  # noqa: E402
from redcliff_tpu.data import pipeline as jpipe  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.obs.logging import read_jsonl  # noqa: E402
from redcliff_tpu.ops import losses as jlosses  # noqa: E402
from redcliff_tpu.runtime import numerics as jnum  # noqa: E402
from redcliff_tpu.train import freeze as jfreeze  # noqa: E402
from redcliff_tpu.train import redcliff_trainer as jtr  # noqa: E402
from redcliff_tpu.train.tracking import GCProgressTracker as JTracker  # noqa: E402,E501
from redcliff_tpu.utils import misc as jmisc  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data import datasets as tds  # noqa: E402
from redcliff_tpu_torch.data import pipeline as tpipe  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.ops import losses as tlosses  # noqa: E402
from redcliff_tpu_torch.runtime import numerics as tnum  # noqa: E402
from redcliff_tpu_torch.train import freeze as tfreeze  # noqa: E402
from redcliff_tpu_torch.train import redcliff_trainer as ttr  # noqa: E402
from redcliff_tpu_torch.train.trainer import load_model  # noqa: E402
from redcliff_tpu_torch.train.tracking import GCProgressTracker as TTracker  # noqa: E402,E501
from redcliff_tpu_torch.utils import misc as tmisc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# losses, grads, GC readouts: f32 in both frameworks, another summation
# order (tests/test_precision_kernels.py:129); downstream of a DGCNN embed
# the sigmoid/normalization magnify input differences, hence atol 1e-5
TOL = dict(rtol=1e-5, atol=1e-6)
TOL_DGCNN = dict(rtol=1e-5, atol=1e-5)
# multi-step fits: f32 drift of 8 optimizer steps through two Adams and
# the prox, compounded by the summation-order differences above
FIT_HIST_TOL = dict(rtol=1e-4, atol=1e-5)
FIT_PARAM_ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol)


# ------------------------------------------------------------------ losses
def test_loss_terms_match_jax():
    G = _x(1, 3, 4, 5, 5)
    A = _x(2, 4, 5, 5, 3)
    s = _x(3, 6, 4)
    p, t = _x(4, 6, 2, 5), _x(5, 6, 2, 5)
    _close(tlosses.pairwise_cosine_penalty(torch.from_numpy(G)),
           jlosses.pairwise_cosine_penalty(jnp.asarray(G)))
    _close(tlosses.pairwise_cosine_penalty(torch.from_numpy(G),
                                           include_diag=True),
           jlosses.pairwise_cosine_penalty(jnp.asarray(G), include_diag=True))
    _close(tlosses.pairwise_cosine_penalty(torch.from_numpy(G[:, :1])),
           jlosses.pairwise_cosine_penalty(jnp.asarray(G[:, :1])))
    _close(tlosses.lag_weighted_adjacency_l1(torch.from_numpy(A)),
           jlosses.lag_weighted_adjacency_l1(jnp.asarray(A)))
    _close(tlosses.factor_weight_l1(torch.from_numpy(s)),
           jlosses.factor_weight_l1(jnp.asarray(s)))
    _close(tlosses.channelwise_forecast_mse(torch.from_numpy(p),
                                            torch.from_numpy(t)),
           jlosses.channelwise_forecast_mse(jnp.asarray(p), jnp.asarray(t)))
    W0 = 0.3 * _x(6, 5, 5, 1)
    _close(tlosses.dagness_penalty(torch.from_numpy(W0)),
           jlosses.dagness_penalty(jnp.asarray(W0)))


# per embedder: a readout mode that reads the embedder, a label layout, and
# a sim count (num_sims 3 reaches the smoothing penalty's general branch)
LOSS_CASES = {
    "Vanilla_Embedder": dict(mode="conditional_factor_exclusive",
                             label="2d", num_sims=2),
    "cEmbedder": dict(mode="conditional_factor_conditional_embedder",
                      label="trace", num_sims=3),
    "DGCNN": dict(mode="conditional_factor_fixed_embedder", label="static",
                  num_sims=2),
}


def _loss_pair(embedder, forward_mode, seed=0, **over):
    case = LOSS_CASES[embedder]
    kw = dict(num_chans=4, gen_lag=2, gen_hidden=(6,), embed_lag=4,
              embed_hidden_sizes=(8,), num_factors=3,
              num_supervised_factors=2, forecast_coeff=2.0,
              factor_score_coeff=3.0, factor_cos_sim_coeff=0.5,
              factor_weight_l1_coeff=0.01, adj_l1_reg_coeff=0.1,
              factor_weight_smoothing_penalty_coeff=0.7,
              factor_score_embedder_type=embedder,
              dgcnn_num_graph_conv_layers=2, dgcnn_num_hidden_nodes=8,
              primary_gc_est_mode=case["mode"],
              forward_pass_mode=forward_mode, num_sims=case["num_sims"],
              training_mode="combined")
    kw.update(over)
    jcfg = jred.RedcliffSCMLPConfig(**kw)
    jm = jred.RedcliffSCMLP(jcfg)
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**kw))
    jp = _np(jm.init(jax.random.PRNGKey(seed)))
    B = 6
    T = jcfg.max_lag + jcfg.num_sims
    X = _x(10 + seed, B, T, 4)
    rng = np.random.default_rng(20 + seed)
    if case["label"] == "2d":
        Y = rng.uniform(size=(B, 2)).astype(np.float32)
    elif case["label"] == "trace":
        Y = rng.uniform(size=(B, 2, T)).astype(np.float32)
    else:
        Y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)][:, :, None]
    return jm, jp, tm, X, Y


def _grads_tree(tm, jp, X, Y, phase, coeffs=None):
    tp = interop.params_from_jax(jp, "cpu")
    leaves = []

    def req(t):
        t.requires_grad_(True)
        leaves.append(t)
        return t
    tp = jax.tree.map(req, tp)
    combo, parts = tm.loss_for_phase(tp, torch.from_numpy(X),
                                     torch.from_numpy(Y), phase,
                                     coeffs=coeffs)
    grads = torch.autograd.grad(combo, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return combo, parts, [g.numpy() for g in grads]


@pytest.mark.parametrize("phase", ["embedder_pretrain", "factor_pretrain",
                                   "combined", "post_train"])
@pytest.mark.parametrize("forward_mode", tred.FORWARD_PASS_MODES)
@pytest.mark.parametrize("embedder", list(LOSS_CASES))
def test_loss_parts_and_grads_match_jax(embedder, forward_mode, phase):
    jm, jp, tm, X, Y = _loss_pair(embedder, forward_mode)
    tol = TOL_DGCNN if embedder == "DGCNN" else TOL
    (jcombo, jparts), jgrads = jax.value_and_grad(
        lambda p: jm.loss_for_phase(p, jnp.asarray(X), jnp.asarray(Y),
                                    phase), has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    combo, parts, grads = _grads_tree(tm, jp, X, Y, phase)
    _close(combo, jcombo, tol)
    assert set(parts) == set(jparts)
    for k in parts:
        _close(parts[k], jparts[k], tol)
    assert float(parts["fw_smoothing_penalty"].detach()) != 0.0 or \
        forward_mode == "apply_factor_weights_after_sim_completion"
    jleaves = jax.tree.leaves(_np(jgrads))
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        _close(g, jg, tol)


def test_coeffs_override_with_tensor_coefficients_matches_jax():
    """Per-call coefficient overrides held as tensors (the JAX package's
    traced grid coefficients): a zero coefficient's term is still built."""
    jm, jp, tm, X, Y = _loss_pair("DGCNN", tred.FORWARD_PASS_MODES[0],
                                  seed=1)
    over = {"forecast_coeff": 1.5, "factor_cos_sim_coeff": 0.0,
            "adj_l1_reg_coeff": 0.25, "factor_score_coeff": 4.0}

    @jax.jit
    def jloss(p, c):
        return jax.value_and_grad(
            lambda q: jm.loss_for_phase(q, jnp.asarray(X), jnp.asarray(Y),
                                        "combined", coeffs=c),
            has_aux=True)(p)
    (jcombo, jparts), jgrads = jloss(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.float32(v) for k, v in over.items()})
    combo, parts, grads = _grads_tree(
        tm, jp, X, Y, "combined",
        coeffs={k: torch.tensor(v) for k, v in over.items()})
    _close(combo, jcombo, TOL_DGCNN)
    for k in parts:
        _close(parts[k], jparts[k], TOL_DGCNN)
    for g, jg in zip(grads, jax.tree.leaves(_np(jgrads))):
        _close(g, jg, TOL_DGCNN)


def test_phase_schedule_permute_and_normalization_match_jax():
    jm, jp, tm, _, _ = _loss_pair("cEmbedder", tred.FORWARD_PASS_MODES[0])
    for mode in tred.TRAINING_MODES:
        pre = 2 if "pretrain" in mode else 0
        acc = 3 if "acclimate" in mode else 0
        kw = dict(dataclasses.asdict(jm.config), training_mode=mode,
                  num_pretrain_epochs=pre, num_acclimation_epochs=acc)
        jc = jred.RedcliffSCMLPConfig(**kw)
        tc = tred.RedcliffSCMLPConfig(**kw)
        for epoch in range(8):
            assert tred.phase_schedule(tc, epoch) == \
                jred.phase_schedule(jc, epoch)
    assert tm.normalization_coeffs() == jm.normalization_coeffs()
    order = [2, 0, 1]
    got = tm.permute_factors(interop.params_from_jax(jp, "cpu"), order)
    want = jm.permute_factors(jax.tree.map(jnp.asarray, jp), order)
    for a, b in zip(jax.tree.leaves(interop.params_to_jax(got)),
                    jax.tree.leaves(_np(want))):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------------- data
def test_dataset_batch_order_matches_jax():
    """The same seed gives the same shuffled batches, remainder kept, over
    two epochs; device batches equal host batches; the epoch plan consumes
    the rng the same way."""
    X = _x(30, 37, 6, 3)
    Y = np.random.default_rng(31).uniform(size=(37, 2, 1)).astype(np.float32)
    jtrain, jval = jds.train_val_split(X, Y, 0.25,
                                       rng=np.random.default_rng(4))
    ttrain, tval = tds.train_val_split(X, Y, 0.25,
                                       rng=np.random.default_rng(4))
    for a, b in ((jtrain, ttrain), (jval, tval)):
        np.testing.assert_array_equal(a.X, b.X)
        np.testing.assert_array_equal(a.Y, b.Y)
    rj, rt, rd = (np.random.default_rng(9) for _ in range(3))
    for _ in range(2):
        jb = list(jtrain.batches(8, rng=rj))
        tb = list(ttrain.batches(8, rng=rt))
        db = list(ttrain.batches(8, rng=rd, device="cpu"))
        assert [len(x) for x, _ in tb] == [8, 8, 8, 4]
        assert len(jb) == len(tb) == len(db)
        for (jx, jy), (tx, ty), (dx, dy) in zip(jb, tb, db):
            np.testing.assert_array_equal(np.asarray(jx), tx)
            np.testing.assert_array_equal(np.asarray(jy), ty)
            np.testing.assert_array_equal(tx, dx.numpy())
            np.testing.assert_array_equal(ty, dy.numpy())
    for drop in (False, True):
        assert ttrain.num_batches(8, drop) == jtrain.num_batches(8, drop)
    jf, jr = jpipe.epoch_batch_plan(28, 8, np.random.default_rng(2))
    tf, tr = tpipe.epoch_batch_plan(28, 8, np.random.default_rng(2))
    np.testing.assert_array_equal(jf, tf)
    np.testing.assert_array_equal(jr, tr)


def test_dataset_input_contracts_match_jax():
    X = _x(32, 10, 5, 2)
    X[3, 1, 0] = np.nan
    Y = np.ones((10, 2, 1), np.float32)
    Y[7, 0, 0] = np.inf
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jd = jds.ArrayDataset(X, Y)
    with pytest.warns(RuntimeWarning, match="quarantined 2/10"):
        td = tds.ArrayDataset(X, Y)
    assert td.quarantined_samples == jd.quarantined_samples == 2
    np.testing.assert_array_equal(td.X, jd.X)
    for bad in (np.zeros((4, 5)), np.array([np.zeros((2, 2)), np.zeros(3)],
                                           dtype=object)):
        with pytest.raises(tds.InputContractError):
            tds.ArrayDataset(bad)
    with pytest.raises(tds.InputContractError, match="label length"):
        tds.ArrayDataset(np.zeros((4, 5, 2)), np.zeros((3, 2)))
    raw = tds.ArrayDataset(X, normalize=False, contract=False)
    assert np.isnan(raw.X).any() and raw.quarantined_samples == 0


def test_prefetch_iterator_order_errors_and_close():
    items = [(np.full(2, i), None) for i in range(7)]
    got = list(tpipe.prefetch_batches(iter(items), depth=2,
                                      put=lambda a: a * 10))
    assert [int(x[0]) for x, _ in got] == [0, 10, 20, 30, 40, 50, 60]
    assert all(y is None for _, y in got)
    assert len(list(tpipe.prefetch_batches(iter(items), depth=0))) == 7

    def boom():
        yield (np.zeros(1), None)
        raise KeyError("source failed")
    it = tpipe.prefetch_batches(boom(), depth=2)
    next(it)
    with pytest.raises(KeyError, match="source failed"):
        next(it)
    endless = ((np.zeros(1), None) for _ in iter(int, 1))
    with tpipe.prefetch_batches(endless, depth=2) as it:
        next(it)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


# ---------------------------------------------------------------- numerics
@pytest.mark.parametrize("loss,gradval", [
    (1.0, 1.0), (np.nan, 1.0), (1.0, np.nan), (1.0, np.inf)])
def test_guard_decisions_match_jax(loss, gradval):
    """The guard's verdict and counters on the fault cases of
    tests/test_numerics.py; a skipped step never calls the update."""
    calls = []
    tstate, ok = tnum.guarded_update(
        {"w": torch.full((3,), gradval), "b": [torch.ones(2)]},
        torch.tensor(loss, dtype=torch.float32),
        lambda: calls.append(1), tnum.init_numerics_state())
    _, jstate, jok = jnum.guarded_update(
        {"w": jnp.zeros(3)}, {"w": jnp.full(3, gradval), "b": [jnp.ones(2)]},
        jnp.float32(loss), lambda t: t, jnum.init_numerics_state())
    assert ok == bool(jok) and len(calls) == int(ok)
    ts, js = tnum.numerics_summary(tstate), jnum.numerics_summary(jstate)
    for k in ("skipped", "consecutive", "checked"):
        assert ts[k] == js[k]
    for k in ("grad_norm_mean", "grad_norm_max"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-6)


def test_guard_consecutive_counter_matches_jax():
    seq = [np.nan, np.nan, 1.0, np.inf, 2.0, np.nan, np.nan, np.nan]
    ts, js = tnum.init_numerics_state(), jnum.init_numerics_state()
    for g in seq:
        ts, _ = tnum.guarded_update([torch.full((2,), g)], torch.tensor(1.0),
                                    lambda: None, ts)
        _, js, _ = jnum.guarded_update({}, [jnp.full(2, g)],
                                       jnp.float32(1.0), lambda t: t, js)
        a, b = tnum.numerics_summary(ts), jnum.numerics_summary(js)
        assert (a["skipped"], a["consecutive"], a["checked"]) == \
            (b["skipped"], b["consecutive"], b["checked"])
        np.testing.assert_allclose(a["grad_norm_std"], b["grad_norm_std"],
                                   rtol=1e-5, atol=1e-6)
    assert tnum.reset_consecutive(ts)["consecutive"] == 0


CLEAN = {"skipped": 0, "consecutive": 0}
# (numerics summary, criteria, note_good after an ok verdict) per epoch
MONITOR_SCENARIOS = {
    "criteria_blowup": [(CLEAN, 1.0, True), (CLEAN, 0.9, True),
                        (CLEAN, 1e6, True)],
    "near_zero_best": [(CLEAN, 1e-6, True), (CLEAN, 5e-5, True),
                       (CLEAN, 1.0, True)],
    "budget_exhausted": [(CLEAN, 1.0, True), (CLEAN, 1e9, True),
                         (CLEAN, 1e9, True), (CLEAN, 1e9, True),
                         (CLEAN, 1e9, True)],
    "skips_without_snapshot": [({"skipped": 3, "consecutive": 3}, np.nan,
                                True)],
    "skips_after_snapshot": [(CLEAN, None, True),
                             ({"skipped": 3, "consecutive": 3}, None,
                              True)],
    "all_nonfinite": [(CLEAN, np.nan, True)] * 4,
    "nonfinite_after_best": [(CLEAN, 2.0, True), (CLEAN, np.inf, True)],
}


@pytest.mark.parametrize("scenario", list(MONITOR_SCENARIOS))
def test_divergence_monitor_decisions_match_jax(scenario):
    pol = dict(max_rollbacks=2, max_consecutive_skips=3,
               max_nonfinite_epochs=3)
    tm = tnum.DivergenceMonitor(tnum.NumericsPolicy(**pol))
    jm = jnum.DivergenceMonitor(jnum.NumericsPolicy(**pol))
    for epoch, (nsum, crit, note) in enumerate(MONITOR_SCENARIOS[scenario]):
        ta, ja = tm.check(epoch, nsum, crit), jm.check(epoch, nsum, crit)
        assert (ta.kind, ta.cause) == (ja.kind, ja.cause), epoch
        if ta.kind == "rollback":
            tm.rollback()
            jm.rollback()
        elif ta.kind == "ok" and note:
            tm.note_good(epoch, {"w": torch.full((2,), float(epoch))})
            jm.note_good(epoch, {"w": jnp.full(2, float(epoch))})
        assert tm.rollbacks == jm.rollbacks
        assert tm.lr_scale == jm.lr_scale


def test_rollback_lr_backoff_compounds_like_jax():
    """Repeated restores of one snapshot deepen the backoff on the torch
    optimizers' param_groups exactly as on optax's injected rate."""
    w = torch.zeros(2, requires_grad=True)
    opt = torch.optim.Adam([w], lr=1e-2)
    jopt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-2)
    jstate = jopt.init({"w": jnp.zeros(2)})
    pol = dict(max_rollbacks=5, lr_backoff=0.5)
    tm = tnum.DivergenceMonitor(tnum.NumericsPolicy(**pol))
    jm = jnum.DivergenceMonitor(jnum.NumericsPolicy(**pol))
    tm.note_good(0, {"opt": opt.state_dict()})
    jm.note_good(0, {"opt": jstate})
    for _ in range(2):
        tr, jr = tm.rollback(), jm.rollback()
        np.testing.assert_allclose(tnum.current_learning_rates(tr),
                                   jnum.current_learning_rates(jr),
                                   rtol=1e-7)
    tm.note_good(1, tr)
    jm.note_good(1, jr)
    tr, jr = tm.rollback(), jm.rollback()
    assert tnum.current_learning_rates(tr) == [pytest.approx(1.25e-3)]
    np.testing.assert_allclose(tnum.current_learning_rates(tr),
                               jnum.current_learning_rates(jr), rtol=1e-7)
    opt.load_state_dict(tr["opt"])
    assert opt.param_groups[0]["lr"] == pytest.approx(1.25e-3)


# ------------------------------------------------------------------ freeze
@pytest.mark.parametrize("mode", [
    "pretrain_embedder_then_post_train_factor_withComboCosSimL1FreezeByEpoch",
    "pretrain_embedder_then_post_train_factor_withL1FreezeByBatch"])
def test_freeze_accept_revert_matches_jax(mode):
    jm, jp, tm, _, _ = _loss_pair(
        "cEmbedder", tred.FORWARD_PASS_MODES[0], training_mode=mode,
        num_pretrain_epochs=1)
    rng = np.random.default_rng(40)
    cand = jax.tree.map(
        lambda a: (a + 0.3 * rng.normal(size=a.shape)).astype(np.float32),
        jp)
    jc, ja = jfreeze.apply_freeze(jm, mode, jax.tree.map(jnp.asarray, cand),
                                  jax.tree.map(jnp.asarray, jp))
    tc, ta = tfreeze.apply_freeze(tm, mode,
                                  interop.params_from_jax(cand, "cpu"),
                                  interop.params_from_jax(jp, "cpu"))
    for got, want in ((tc, jc), (ta, ja)):
        for a, b in zip(jax.tree.leaves(interop.params_to_jax(got)),
                        jax.tree.leaves(_np(want))):
            np.testing.assert_array_equal(a, b)
    for new, old in ((cand, jp), (jp, cand)):
        jv = jfreeze.freeze_accept_vector(
            mode, jfreeze.factor_decision_stats(jm, jax.tree.map(
                jnp.asarray, new)),
            jfreeze.factor_decision_stats(jm, jax.tree.map(jnp.asarray, old)))
        tv = tfreeze.freeze_accept_vector(
            mode, tfreeze.factor_decision_stats(
                tm, interop.params_from_jax(new, "cpu")),
            tfreeze.factor_decision_stats(
                tm, interop.params_from_jax(old, "cpu")))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# --------------------------------------------------------- tracking, misc
def test_tracker_and_factor_alignment_match_jax():
    rng = np.random.default_rng(50)
    truth = [(rng.uniform(size=(4, 4, 2)) > 0.6).astype(float)
             for _ in range(3)]
    est = [[rng.uniform(size=(4, 4, 2)) for _ in range(3)] for _ in range(2)]
    nolag = [[e.sum(-1) for e in s] for s in est]
    jt, tt = JTracker(2, 4, 3), TTracker(2, 4, 3)
    for tgc in (truth, None):
        jt.update(tgc, est, nolag)
        tt.update(tgc, est, nolag)
    assert tt.as_dict() == jt.as_dict()
    assert tt.latest_mean_supervised_cosine() == \
        jt.latest_mean_supervised_cosine()
    preds = rng.uniform(size=(30, 3))
    labels = np.eye(3)[rng.integers(0, 3, 30)]
    for usi in (0, 1):
        assert tmisc.factor_alignment_order(preds, labels, 3, usi) == \
            jmisc.factor_alignment_order(preds, labels, 3, usi)


# -------------------------------------------------------------- the slice
SLICE_CFG = dict(
    num_chans=4, gen_lag=2, gen_hidden=(6,), embed_lag=4,
    embed_hidden_sizes=(0,), num_factors=3, num_supervised_factors=3,
    forecast_coeff=10.0, factor_score_coeff=100.0,
    factor_cos_sim_coeff=1.0 / 3.0, factor_weight_l1_coeff=1e-3,
    adj_l1_reg_coeff=float(1.0 / 3.0 / np.sqrt(15.0)),
    factor_score_embedder_type="DGCNN", dgcnn_num_graph_conv_layers=2,
    dgcnn_num_hidden_nodes=8, use_sigmoid_restriction=False,
    primary_gc_est_mode="conditional_factor_fixed_embedder",
    forward_pass_mode="apply_factor_weights_after_sim_completion",
    num_sims=1,
    training_mode="pretrain_embedder_then_acclimate_factors_then_combined",
    num_pretrain_epochs=1, num_acclimation_epochs=1)


def _slice_train_config(mod, lam, **over):
    kw = dict(gen_lr=1e-2, embed_lr=1e-2, gen_eps=1e-4, embed_eps=1e-4,
              gen_weight_decay=1e-4, embed_weight_decay=1e-4, max_iter=4,
              lookback=1, check_every=1, batch_size=40, seed=3,
              stopping_criteria_forecast_coeff=10.0,
              stopping_criteria_factor_coeff=100.0,
              stopping_criteria_cosSim_coeff=1.0,
              prox_penalty="GL", prox_lam=lam)
    kw.update(over)
    return mod.RedcliffTrainConfig(**kw)


def _slice_data():
    """64 training windows (one 40 batch + a 24 remainder) and 32
    validation windows of a tiny D4IC-like layout: one-hot state labels
    (N, 3, 1)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(96, 5, 4)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 96)][:, :, None]
    return X, Y


def _slice_models(**over):
    cfg = dict(SLICE_CFG, **over)
    jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**cfg))
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**cfg))
    return jm, tm, _np(jm.init(jax.random.PRNGKey(0)))


def _fit_both(lam, tmp_path, train_over=None, **model_over):
    jm, tm, jp = _slice_models(**model_over)
    X, Y = _slice_data()
    train_over = train_over or {}
    jres = jtr.RedcliffTrainer(
        jm, _slice_train_config(jtr, lam, **train_over)).fit(
        jp, jds.ArrayDataset(X[:64], Y[:64]), jds.ArrayDataset(X[64:],
                                                               Y[64:]),
        save_dir=str(tmp_path / "jax"))
    tres = ttr.RedcliffTrainer(
        tm, _slice_train_config(ttr, lam, **train_over), device="cpu").fit(
        jp, tds.ArrayDataset(X[:64], Y[:64]), tds.ArrayDataset(X[64:],
                                                               Y[64:]),
        save_dir=str(tmp_path / "port"))
    return jres, tres


def _assert_fits_agree(jres, tres):
    assert tres.best_it == jres.best_it
    assert tres.aborted is None and jres.aborted is None
    for k, v in jres.histories.items():
        assert len(tres.histories[k]) == len(v), k
        if v:
            np.testing.assert_allclose(np.asarray(tres.histories[k], float),
                                       np.asarray(v, float),
                                       err_msg=k, **FIT_HIST_TOL)
    np.testing.assert_allclose(tres.best_loss, jres.best_loss,
                               **FIT_HIST_TOL)
    np.testing.assert_allclose(tres.final_val_loss, jres.final_val_loss,
                               **FIT_HIST_TOL)
    got = jax.tree.leaves(interop.params_to_jax(tres.params))
    for a, b in zip(got, jax.tree.leaves(_np(jres.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=FIT_PARAM_ATOL)
    return got


def _group_norms(w):
    return np.sqrt((np.asarray(w, np.float64) ** 2).sum(axis=(-3, -1)))


def test_fit_matches_jax_trainer(tmp_path):
    """The slice as a whole: the same phases, best epoch, histories and
    best params as the JAX trainer from copied weights."""
    jres, tres = _fit_both(1.0, tmp_path)
    assert [e["phases"] for e in tres.epochs] == [
        ["embedder_pretrain"], ["factor_pretrain"], ["combined"],
        ["combined"]]
    assert tres.numerics["skipped"] == 0
    got = _assert_fits_agree(jres, tres)
    # the prox ran: first-layer group norms shrank below the no-prox fit's
    _, tm, jp = _slice_models()
    X, Y = _slice_data()
    plain = ttr.RedcliffTrainer(tm, _slice_train_config(
        ttr, 1.0, prox_penalty=None), device="cpu").fit(
        jp, tds.ArrayDataset(X[:64], Y[:64]),
        tds.ArrayDataset(X[64:], Y[64:]))
    assert _group_norms(interop.params_to_jax(tres.params)["factors"][0][
        "w"]).sum() < _group_norms(interop.params_to_jax(plain.params)[
            "factors"][0]["w"]).sum()
    # a JAX-written trainer checkpoint is refused, not silently restarted
    with pytest.raises(ValueError, match="not a trainer checkpoint of the"):
        ttr.RedcliffTrainer(tm, _slice_train_config(ttr, 1.0),
                            device="cpu").fit(
            jp, tds.ArrayDataset(X[:64], Y[:64]),
            tds.ArrayDataset(X[64:], Y[64:]), save_dir=str(tmp_path / "jax"))
    # the artifact loads through the port's load_model with the best params
    art = load_model(str(tmp_path / "port"))
    assert art["model_class"] == "RedcliffSCMLP"
    for a, b in zip(jax.tree.leaves(art["params"]), got):
        np.testing.assert_array_equal(a, b)


def test_freeze_by_batch_fit_matches_jax_trainer(tmp_path):
    """A FreezeByBatch post-train fit: the per-batch and per-epoch
    accept/revert rounds pick the same factors as the JAX trainer, so the
    histories, best epoch and accepted params agree."""
    mode = "pretrain_embedder_then_post_train_factor_withL1FreezeByBatch"
    jres, tres = _fit_both(0.5, tmp_path, train_over={"max_iter": 3},
                           training_mode=mode, num_acclimation_epochs=0)
    assert [e["phases"] for e in tres.epochs] == [
        ["embedder_pretrain"], ["post_train"], ["post_train"]]
    _assert_fits_agree(jres, tres)


def test_zero_group_stall_matches_jax(tmp_path):
    """The JAX package's zero-group finding, pinned in both frameworks: a
    prox_lam that drives whole (H, L) groups to zero makes the gradient of
    factors[0]["w"] NaN (sqrt at 0 in the GC readout), and the guard then
    skips the same steps in both; the zeroed groups stay zero."""
    jres, tres = _fit_both(50.0, tmp_path)
    jskips = {e["epoch"]: e["epoch_skipped_steps"]
              for e in read_jsonl(str(tmp_path / "jax"), event="anomaly")}
    tskips = {e["epoch"]: e["skipped"] for e in tres.epochs if e["skipped"]}
    assert tskips == jskips and sum(tskips.values()) > 0
    jroll = [e["epoch"] for e in read_jsonl(str(tmp_path / "jax"),
                                            event="numerics")
             if e["kind"] == "rollback"]
    assert [e["epoch"] for e in tres.epochs
            if e["action"] == "rollback"] == jroll
    assert tres.best_it == jres.best_it
    for k in ("avg_combo_loss", "avg_forecasting_loss"):
        np.testing.assert_allclose(tres.histories[k], jres.histories[k],
                                   **FIT_HIST_TOL)
    tw = interop.params_to_jax(tres.params)["factors"][0]["w"]
    zero = _group_norms(tw) == 0
    assert zero.any()
    np.testing.assert_array_equal(
        zero, _group_norms(jres.params["factors"][0]["w"]) == 0)
    last = tnum.to_host(ttr.durable_ckpt.read_checkpoint(
        str(tmp_path / "port" / "trainer_checkpoint.pkl"))["params"])
    assert (_group_norms(last["factors"][0]["w"])[zero] == 0).all()


def test_resume_is_bit_identical_to_uninterrupted_fit(tmp_path):
    """Stop after epoch 2 (max_iter=2), resume to 4: params, best params
    and histories equal the uninterrupted 4-epoch fit bit for bit."""
    _, tm, jp = _slice_models()
    X, Y = _slice_data()

    def fit(max_iter, save_dir):
        trainer = ttr.RedcliffTrainer(
            tm, _slice_train_config(ttr, 1.0, max_iter=max_iter,
                                    lookback=5), device="cpu")
        return trainer.fit(jp, tds.ArrayDataset(X[:64], Y[:64]),
                           tds.ArrayDataset(X[64:], Y[64:]),
                           save_dir=str(save_dir))

    full = fit(4, tmp_path / "full")
    first = fit(2, tmp_path / "cut")
    assert [e["epoch"] for e in first.epochs] == [0, 1]
    resumed = fit(4, tmp_path / "cut")
    assert [e["epoch"] for e in resumed.epochs] == [2, 3]
    assert resumed.best_it == full.best_it
    assert resumed.histories["avg_combo_loss"] == \
        full.histories["avg_combo_loss"]
    for a, b in zip(jax.tree.leaves(interop.params_to_jax(resumed.params)),
                    jax.tree.leaves(interop.params_to_jax(full.params))):
        np.testing.assert_array_equal(a, b)
    ck = [ttr.durable_ckpt.read_checkpoint(
        str(d / "trainer_checkpoint.pkl")) for d in (tmp_path / "full",
                                                     tmp_path / "cut")]
    for a, b in zip(jax.tree.leaves(ck[0]["params"]),
                    jax.tree.leaves(ck[1]["params"])):
        np.testing.assert_array_equal(a, b)
    # the checkpoint's epoch log spans both calls on the cut save_dir
    for c in ck:
        assert [e["epoch"] for e in c["epoch_log"]] == [0, 1, 2, 3]
    assert [e["steps"] for e in ck[1]["epoch_log"]] == \
        [e["steps"] for e in first.epochs + resumed.epochs]
    for name in ("final_best_model.bin", "trainer_checkpoint.pkl",
                 "training_meta_data_and_hyper_parameters.pkl"):
        with open(tmp_path / "cut" / name, "rb") as f:
            assert f.read(4) == b"RTCK"


def test_unported_knobs_raise_and_default_device_is_cuda(monkeypatch,
                                                          tmp_path):
    with pytest.raises(NotImplementedError, match="matmul_precision"):
        ttr.RedcliffTrainConfig(matmul_precision="bfloat16")
    # the telemetry knobs are ported: they construct and resolve a window
    from redcliff_tpu_torch.obs import profiling

    tc = ttr.RedcliffTrainConfig(profile_window="epoch:1",
                                 profile_dir=str(tmp_path),
                                 compile_cache_dir=str(tmp_path))
    win = profiling.window_for(tc, max_iter=3, device="cpu")
    assert (win.first_epoch, win.last_epoch, win.cuda) == (1, 1, False)
    with pytest.raises(NotImplementedError, match="mixed"):
        ttr.RedcliffTrainConfig(precision_mode="mixed")
    with pytest.raises(ValueError, match="prox_penalty"):
        ttr.RedcliffTrainConfig(prox_penalty="L1")
    _, tm, jp = _slice_models()
    with pytest.raises(NotImplementedError, match="factor_mesh"):
        ttr.RedcliffTrainer(tm, ttr.RedcliffTrainConfig(),
                            device="cpu").fit(jp, None, None,
                                              factor_mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.RedcliffTrainer(tm, ttr.RedcliffTrainConfig())


def test_port_trainer_loads_no_jax(tmp_path):
    """Importing and running the port's trainer loads no jax and no module
    of the JAX package."""
    code = f"""
import sys
import numpy as np
import torch
from redcliff_tpu_torch.data.datasets import ArrayDataset
from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                RedcliffSCMLPConfig)
from redcliff_tpu_torch.train.redcliff_trainer import (RedcliffTrainConfig,
                                                       RedcliffTrainer)
model = RedcliffSCMLP(RedcliffSCMLPConfig(**{SLICE_CFG!r}))
params = model.init(torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
X = rng.normal(size=(48, 5, 4)).astype(np.float32)
Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 48)][:, :, None]
res = RedcliffTrainer(model, RedcliffTrainConfig(
    max_iter=3, batch_size=16, check_every=1, prox_penalty="GL",
    prox_lam=0.5), device="cpu").fit(
    params, ArrayDataset(X[:32], Y[:32]), ArrayDataset(X[32:], Y[32:]),
    save_dir={str(tmp_path)!r})
assert res.aborted is None and res.numerics["checked"] == 6
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "redcliff_tpu" or m.startswith("redcliff_tpu."))
print("LEAKED", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout
