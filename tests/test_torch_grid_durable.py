"""The port grid's durability and elasticity (redcliff_tpu_torch/parallel/
{grid,policy,compaction}.py, runtime/{checkpoint,preempt}.py) against the
JAX package's.

At the width of tests/test_parallel_grid.py:_model (C=4, gen_hidden 8,
K=2, Vanilla embedder) with the GL prox on. The G=16 grid follows
tests/test_compaction.py:99: 6 live lanes, 7 zero-lr lanes that stop
early, one lane evicted by its deadline at the first epoch boundary and
two poisoned lanes, so the grid compacts 16 -> 8 at epoch 1. The JAX grid
fits it once with compaction on (module fixture, streaming per batch as
the port does); the port fits it with compaction on and off from the same
stacked init, carried across by ``interop.grid_state_from_jax``.
"""
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.parallel import compaction as jcomp  # noqa: E402
from redcliff_tpu.parallel import grid as jgrid  # noqa: E402
from redcliff_tpu.parallel import policy as jpolicy  # noqa: E402
from redcliff_tpu.train import redcliff_trainer as jtr  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset as TDataset  # noqa: E402,E501
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.parallel import compaction as tcomp  # noqa: E402
from redcliff_tpu_torch.parallel import grid as tgrid  # noqa: E402
from redcliff_tpu_torch.parallel import policy as tpolicy  # noqa: E402
from redcliff_tpu_torch.runtime import checkpoint as tck  # noqa: E402
from redcliff_tpu_torch.runtime.preempt import (  # noqa: E402
    DeadlineExceeded, Preempted)
from redcliff_tpu_torch.train import driver as tdriver  # noqa: E402
from redcliff_tpu_torch.train import redcliff_trainer as ttr  # noqa: E402

# the grid bar of ROADMAP "Tolerances" (tests/test_torch_grid.py)
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)

KNOBS = dict(max_iter=5, batch_size=32, seed=7, lookback=1, check_every=1,
             prox_penalty="GL", prox_lam=0.5)
POISON = {"gen_lr": 1e20, "embed_lr": 1e20}
# 6 live + 7 zero-lr early stops + 1 deadline eviction + 2 quarantines
POINTS16 = ([{"gen_lr": 1e-3 * (1 + i)} for i in range(6)]
            + [{"gen_lr": 0.0, "embed_lr": 0.0}] * 7
            + [{"gen_lr": 2e-3}] + [POISON] * 2)
DEADLINES16 = [np.inf] * 13 + [1e-6] + [np.inf] * 2
LIVE16 = list(range(6))
EVICTED, POISONED = 13, (14, 15)


def _model_kw():
    return dict(num_chans=4, gen_lag=2, gen_hidden=(8,), embed_lag=4,
                embed_hidden_sizes=(8,), num_factors=2,
                num_supervised_factors=2, factor_weight_l1_coeff=0.01,
                adj_l1_reg_coeff=0.001, factor_cos_sim_coeff=0.01,
                factor_score_embedder_type="Vanilla_Embedder",
                primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
                training_mode="combined")


def _data(n=64):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 5, 4)).astype(np.float32)
    Y = rng.uniform(size=(n, 3, 1)).astype(np.float32)
    return X, Y


def _tmodel():
    return tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**_model_kw()))


def _spec16():
    return tgrid.GridSpec(points=POINTS16, fit_deadline_s=DEADLINES16)


def _tc(**over):
    return ttr.RedcliffTrainConfig(**{**KNOBS, **over})


def _assert_same(a, b):
    """Two port results bit for bit, decisions and values."""
    np.testing.assert_array_equal(a.val_history, b.val_history)
    np.testing.assert_array_equal(a.best_criteria, b.best_criteria)
    np.testing.assert_array_equal(a.best_epoch, b.best_epoch)
    np.testing.assert_array_equal(a.active, b.active)
    assert a.failures == b.failures
    for x, y in zip(interop.tree_leaves(a.best_params),
                    interop.tree_leaves(b.best_params)):
        np.testing.assert_array_equal(x, y)


def _assert_at_grid_bar(want, got, lanes):
    """Same decisions; values at the grid bar on ``lanes``."""
    np.testing.assert_array_equal(got.best_epoch, want.best_epoch)
    np.testing.assert_array_equal(got.active, want.active)
    assert got.failures == want.failures
    np.testing.assert_allclose(got.val_history, want.val_history, **HIST)
    np.testing.assert_allclose(got.best_criteria, want.best_criteria,
                               **HIST)
    for a, b in zip(jax.tree.leaves(want.best_params),
                    jax.tree.leaves(got.best_params)):
        np.testing.assert_allclose(np.asarray(b)[lanes],
                                   np.asarray(a)[lanes], **PARAMS)


# ------------------------------------------------- pure planning, port = JAX
_ACTIVE = np.array([False, True, False, True, False, False, True, False])


@pytest.mark.parametrize("fn,args", [
    ("bucket_width", (0,)), ("bucket_width", (3,)), ("bucket_width", (9,)),
    ("bucket_width", (27,)), ("bucket_width", (9, 8)),
    ("bucket_width", (9, 6)), ("bucket_width", (3, 8)),
    ("bucket_width", (3, 6)),
    ("ladder_widths", (27,)), ("ladder_widths", (5, 4)),
    ("ladder_widths", (3, 1, 64)),
    ("plan_compaction", (_ACTIVE, np.arange(8, dtype=np.int32), [0])),
    ("plan_compaction", (np.array([True, True, False, False]),
                         np.array([0, 1, -1, -1], np.int32), [])),
    ("plan_compaction", (np.ones(2, bool), np.arange(2, dtype=np.int32),
                         [])),
    ("plan_compaction", (np.zeros(4, bool), np.arange(4, dtype=np.int32),
                         [])),
    ("plan_compaction", (np.r_[np.ones(15, bool), np.zeros(17, bool)],
                         np.r_[np.arange(27), -np.ones(5)].astype(np.int32),
                         [])),
    ("expand_history", ([np.arange(4.), np.arange(4.) + .5, [20., 40.],
                         [21., 41.]], [0, 0, 1, 1],
                        [np.arange(4, dtype=np.int32),
                         np.array([1, 3], np.int32)], 4)),
    ("expand_history", ([np.arange(4.), [9., 9.]], [-1, 1],
                        [None, np.array([1, -1], np.int32)], 4)),
    ("expand_history", ([], [], [], 3)),
])
def test_compaction_planning_matches_jax(fn, args):
    want = getattr(jcomp, fn)(*args)
    got = getattr(tcomp, fn)(*args)
    if fn == "plan_compaction":
        assert (got is None) == (want is None)
        if want is None:
            return
        for attr in ("sel", "orig_ids", "active", "retire_rows",
                     "retire_ids"):
            np.testing.assert_array_equal(getattr(got, attr),
                                          getattr(want, attr), attr)
        assert got.new_width == want.new_width
    elif fn == "expand_history":
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("case", [
    ("initial_width", dict(g_bucket=True), (27,)),
    ("initial_width", dict(g_bucket=True), (16,)),
    ("initial_width", dict(g_bucket=False), (27,)),
    ("initial_width", dict(g_bucket=True), (1,)),
    ("initial_width", dict(g_bucket=True), (33,)),
    ("compaction_plan", dict(), (_ACTIVE, np.arange(8, dtype=np.int32),
                                 [2])),
    ("compaction_plan", dict(compaction=False),
     (_ACTIVE, np.arange(8, dtype=np.int32), [])),
    ("lane_evictions", dict(), (np.array([1.0, np.inf, 1e-3, 5.0]),
                                np.array([False, False, False, True]),
                                2.0)),
    ("lane_evictions", dict(), (None, np.zeros(2, bool), 2.0)),
    ("lane_evictions", dict(), (np.ones(2), np.zeros(2, bool), None)),
    ("grid_deadline_hit", dict(), (5.0, 6.0)),
    ("grid_deadline_hit", dict(), (5.0, 4.0)),
    ("grid_deadline_hit", dict(), (None, 6.0)),
    ("grid_deadline_hit", dict(), (5.0, None)),
])
def test_policy_matches_jax(case):
    fn, kw, args = case
    # the JAX policy's width and compaction decisions take the mesh size,
    # which is 1 for the port's single-device grid
    jargs = args + (1,) if fn in ("initial_width", "compaction_plan") \
        else args
    want = getattr(jpolicy.GridSchedulingPolicy(**kw), fn)(*jargs)
    got = getattr(tpolicy.GridSchedulingPolicy(**kw), fn)(*args)
    if fn == "compaction_plan":
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got.sel, want.sel)
            np.testing.assert_array_equal(got.retire_ids, want.retire_ids)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    cfg = ttr.RedcliffTrainConfig(compaction=False, g_bucket=False)
    p = tpolicy.GridSchedulingPolicy.from_train_config(cfg)
    assert (p.compaction, p.g_bucket) == (False, False)


# ----------------------------------------------- the G=16 grid, three ways
@pytest.fixture(scope="module")
def g16(tmp_path_factory):
    """The JAX grid (compaction on, a checkpoint every epoch), and the
    port's with compaction on (a checkpoint every epoch, retirements
    recorded) and off, all from the JAX grid's stacked init."""
    jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**_model_kw()))
    X, Y = _data()
    jspec = jgrid.GridSpec(points=POINTS16, fit_deadline_s=DEADLINES16)
    jtc = jtr.RedcliffTrainConfig(**KNOBS, stream_mode="per_batch")
    jrun = jgrid.RedcliffGridRunner(jm, jtc, jspec)
    init = jrun.init_grid(jax.random.PRNGKey(5))
    state = jax.tree.map(np.asarray, init)
    jdir = str(tmp_path_factory.mktemp("jax_ck"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REDCLIFF_QUALITY", "0")
        jres = jrun.fit(jax.random.PRNGKey(5), JDataset(X, Y),
                        JDataset(X, Y), init_params=init,
                        checkpoint_dir=jdir, checkpoint_every=1)
    tm = _tmodel()
    tinit = interop.grid_state_from_jax(*state)
    retired = []
    on_dir = str(tmp_path_factory.mktemp("port_on"))
    r_on = tgrid.RedcliffGridRunner(tm, _tc(), _spec16(), device="cpu")
    res_on = r_on.fit(None, TDataset(X, Y), TDataset(X, Y),
                      init_params=tinit, checkpoint_dir=on_dir,
                      checkpoint_every=1,
                      on_lane_retire=lambda pid, rec, ep: retired.append(
                          (pid, rec, ep)))
    r_off = tgrid.RedcliffGridRunner(tm, _tc(compaction=False), _spec16(),
                                     device="cpu")
    res_off = r_off.fit(None, TDataset(X, Y), TDataset(X, Y),
                        init_params=tinit)
    return dict(jres=jres, jrun=jrun, jdir=jdir, tinit=tinit,
                res_on=res_on, r_on=r_on, on_dir=on_dir, retired=retired,
                res_off=res_off, r_off=r_off)


def test_compaction_on_equals_off_and_jax(g16):
    """Compaction on and off give the same decisions under original ids
    (values at the grid bar), and so does the JAX grid with compaction
    on; the port really compacted, and the JAX grid did the same."""
    on, off, jres = g16["res_on"], g16["res_off"], g16["jres"]
    st = g16["r_on"].dispatch_stats
    assert st["compactions"] >= 1 and st["grid_width"] <= 8
    assert st["lane_epochs"] < st["lane_epochs_nominal"]
    assert g16["r_off"].dispatch_stats["compactions"] == 0
    assert st["grid_width"] == g16["jrun"].dispatch_stats["grid_width"]
    assert st["compactions"] == g16["jrun"].dispatch_stats["compactions"]
    assert [e["width"] for e in on.epochs][:3] == [16, 16, 8]
    _assert_at_grid_bar(off, on, LIVE16)
    _assert_at_grid_bar(jres, on, LIVE16)
    assert int((~on.active).sum()) >= 10
    assert sorted(f["point"] for f in on.failures) == [EVICTED, *POISONED]
    assert on.val_history.shape == (KNOBS["max_iter"], 16)
    assert {k: len(v) for k, v in on.numerics.items()} \
        == {k: 16 for k in on.numerics}


def test_deadline_eviction_reports_original_id(g16):
    """The evicted lane is reported under its own id with cause
    "deadline" at the first epoch boundary, by both packages."""
    for res in (g16["res_on"], g16["jres"]):
        dl = [f for f in res.failures if f["cause"] == "deadline"]
        assert [(f["point"], f["epoch"]) for f in dl] == [(EVICTED, 0)]
        assert not res.active[EVICTED]


def test_on_lane_retire_sees_original_ids(g16):
    """Every lane the compaction retired reaches the hook once, under its
    original id, with the record the result reports."""
    got = g16["retired"]
    on = g16["res_on"]
    ids = [pid for pid, _, _ in got]
    assert len(ids) == len(set(ids))
    assert set(range(6, 16)) <= set(ids)
    assert not set(ids) & {int(i) for i in np.flatnonzero(on.active)}
    for pid, rec, epoch in got:
        assert epoch >= rec["best_epoch"]
        assert rec["best_crit"] == on.best_criteria[pid] \
            or np.isnan(on.best_criteria[pid])
        assert rec["best_epoch"] == on.best_epoch[pid]
        assert rec["failed_epoch"] == next(
            (f["epoch"] for f in on.failures if f["point"] == pid), -1)


@pytest.mark.parametrize("k", [1, 3])
def test_resume_is_bit_identical_across_compaction(g16, tmp_path, k):
    """A fit stopped after epoch k-1 and resumed to the horizon equals the
    uninterrupted fit bit for bit: k=1 resumes before the compaction at
    epoch 1 (the resumed run compacts), k=3 inside the compacted era."""
    X, Y = _data()
    tm = _tmodel()
    ck = str(tmp_path / "ck")
    r1 = tgrid.RedcliffGridRunner(tm, _tc(), _spec16(), device="cpu")
    r1.fit(None, TDataset(X, Y), TDataset(X, Y), max_iter=k,
           init_params=g16["tinit"], checkpoint_dir=ck, checkpoint_every=1)
    head = tck.read_checkpoint(os.path.join(ck, "grid_checkpoint.pkl"))
    assert head["epoch"] == k - 1
    assert len(head["orig_ids"]) == (16 if k == 1 else 8)
    r2 = tgrid.RedcliffGridRunner(tm, _tc(), _spec16(), device="cpu")
    res = r2.fit(None, TDataset(X, Y), TDataset(X, Y), checkpoint_dir=ck,
                 checkpoint_every=1)
    assert r2.dispatch_stats["resumed_from_epoch"] == k - 1
    assert [e["epoch"] for e in res.epochs] == list(range(k, 5))
    _assert_same(g16["res_on"], res)


def test_resume_refuses_another_fit_and_a_jax_checkpoint(g16, tmp_path):
    """A changed batch_size is refused naming the field; a JAX-written
    grid checkpoint (optax state) is refused; a corrupt head falls back to
    .prev, is moved to .bad, and the resumed fit still equals the
    uninterrupted one."""
    X, Y = _data()
    tm = _tmodel()
    ds = TDataset(X, Y)
    runner = tgrid.RedcliffGridRunner(tm, _tc(batch_size=16), _spec16(),
                                      device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        runner.fit(None, ds, ds, checkpoint_dir=g16["on_dir"])
    runner = tgrid.RedcliffGridRunner(tm, _tc(), _spec16(), device="cpu")
    with pytest.raises(ValueError, match="JAX-written"):
        runner.fit(None, ds, ds, checkpoint_dir=g16["jdir"])
    ck = str(tmp_path / "ck")
    shutil.copytree(g16["on_dir"], ck)
    head = os.path.join(ck, "grid_checkpoint.pkl")
    # the last epoch's checkpoint torn: the epoch before it (.prev) resumes
    with open(head, "r+b") as f:
        f.seek(40)
        f.write(b"\0" * 64)
    with pytest.warns(RuntimeWarning, match="corrupt checkpoint"):
        res = runner.fit(None, ds, ds, checkpoint_dir=ck,
                         checkpoint_every=1)
    assert os.path.exists(head + ".bad")
    assert runner.dispatch_stats["resumed_from_epoch"] == 3
    _assert_same(g16["res_on"], res)


# ------------------------------------------- deadlines and preemption, G=4
POINTS4 = [{"gen_lr": 1e-3}, {"gen_lr": 5e-3},
           {"adj_l1_reg_coeff": 0.01, "embed_lr": 2e-3}, {"gen_lr": 2e-3}]


@pytest.fixture(scope="module")
def g4():
    """An uninterrupted G=4 port fit, 4 epochs, no deadline."""
    X, Y = _data()
    tm = _tmodel()
    runner = tgrid.RedcliffGridRunner(tm, _tc(max_iter=4),
                                      tgrid.GridSpec(POINTS4), device="cpu")
    init = runner.init_grid(3)
    res = runner.fit(None, TDataset(X, Y), TDataset(X, Y), init_params=init)
    return dict(res=res, init=init)


def _fit4(g4, spec, ck=None, **kw):
    X, Y = _data()
    runner = tgrid.RedcliffGridRunner(_tmodel(), _tc(max_iter=4), spec,
                                      device="cpu")
    return runner.fit(None, TDataset(X, Y), TDataset(X, Y),
                      init_params=g4["init"], checkpoint_dir=ck, **kw)


def test_lane_deadline_leaves_siblings_bit_identical(g4, tmp_path):
    """Lane 2 evicted at the first epoch boundary: reported under its id
    with cause "deadline", a checkpoint forced at that epoch, and every
    other lane bit-identical to the run without a deadline."""
    ck = str(tmp_path / "ck")
    res = _fit4(g4, tgrid.GridSpec(POINTS4, fit_deadline_s=[
        np.inf, np.inf, 1e-6, np.inf]), ck=ck)
    assert res.failures == [{"point": 2, "epoch": 0, "cause": "deadline",
                             "hparams": POINTS4[2]}]
    assert tck.read_checkpoint(os.path.join(
        ck, "grid_checkpoint.pkl"))["epoch"] == 0
    want = g4["res"]
    sib = [0, 1, 3]
    np.testing.assert_array_equal(res.val_history[:, sib],
                                  want.val_history[:, sib])
    np.testing.assert_array_equal(res.best_criteria[sib],
                                  want.best_criteria[sib])
    np.testing.assert_array_equal(res.best_epoch[sib], want.best_epoch[sib])
    for a, b in zip(interop.tree_leaves(res.best_params),
                    interop.tree_leaves(want.best_params)):
        np.testing.assert_array_equal(a[sib], b[sib])
    # the evicted lane froze after epoch 0: its history carries forward
    assert (res.val_history[1:, 2] == res.val_history[0, 2]).all()


def test_grid_deadline_checkpoints_and_resumes(g4, tmp_path):
    """grid_deadline_s ends the fit after the first epoch with a final
    checkpoint and DeadlineExceeded; resuming without the deadline equals
    the uninterrupted fit (the fingerprint leaves deadlines out)."""
    ck = str(tmp_path / "ck")
    with pytest.raises(DeadlineExceeded) as e:
        _fit4(g4, tgrid.GridSpec(POINTS4, grid_deadline_s=1e-6), ck=ck)
    assert e.value.epoch == 0
    assert tck.read_checkpoint(os.path.join(
        ck, "grid_checkpoint.pkl"))["epoch"] == 0
    _assert_same(g4["res"], _fit4(g4, tgrid.GridSpec(POINTS4), ck=ck))


def test_sigterm_writes_final_checkpoint_and_resumes(g4, tmp_path,
                                                     monkeypatch):
    """A SIGTERM latched in the middle of epoch 1 finishes the epoch,
    writes one checkpoint there and raises Preempted; the resumed fit
    equals the uninterrupted one."""
    calls = []
    step = tgrid.RedcliffGridRunner._step

    def step_then_signal(self, *args):
        calls.append(1)
        if len(calls) == 3:  # epoch 1, first batch
            os.kill(os.getpid(), signal.SIGTERM)
        return step(self, *args)

    ck = str(tmp_path / "ck")
    with monkeypatch.context() as mp:
        mp.setattr(tgrid.RedcliffGridRunner, "_step", step_then_signal)
        with pytest.raises(Preempted) as e:
            _fit4(g4, tgrid.GridSpec(POINTS4), ck=ck, checkpoint_every=3)
    assert e.value.epoch == 1 and e.value.signum == signal.SIGTERM
    assert tck.read_checkpoint(os.path.join(
        ck, "grid_checkpoint.pkl"))["epoch"] == 1
    assert signal.getsignal(signal.SIGTERM) is not None
    _assert_same(g4["res"], _fit4(g4, tgrid.GridSpec(POINTS4), ck=ck,
                                  checkpoint_every=3))


def test_filler_lanes_never_leak_and_failures_go_to_checkpoint_dir(
        tmp_path):
    """A 3-point grid runs at width 4 with one filler lane that appears in
    no result field; with no run_dir, failures.json lands in the
    checkpoint directory (tests/test_compaction.py:169)."""
    X, Y = _data()
    ck = str(tmp_path / "ck")
    points = [{"gen_lr": 1e-3}, {"gen_lr": 2e-3}, POISON]
    res = tdriver.run_coefficient_grid(
        _tmodel(), _tc(max_iter=3), points, TDataset(X, Y), TDataset(X, Y),
        key=1, checkpoint_dir=ck, checkpoint_every=1, device="cpu")
    assert res.val_history.shape == (3, 3)
    assert res.best_criteria.shape == res.active.shape == (3,)
    assert all(leaf.shape[0] == 3
               for leaf in interop.tree_leaves(res.best_params))
    assert {k: v.shape for k, v in res.coeffs.items()} \
        == {k: (3,) for k in res.coeffs}
    assert [f["point"] for f in res.failures] == [2]
    assert res.epochs[0]["width"] == 4
    assert os.path.exists(os.path.join(ck, "failures.json"))


@pytest.mark.gpu
def test_lane_prox_skips_filler_and_evicted_lanes_on_card():
    """On the card: a width-4 grid (3 points, one filler lane) with lane 2
    gated off as an evicted lane holding an all-zero group, and the same
    state compacted to fresh leaves: the kernel leaves both gated lanes
    bit for bit as they were (no NaN from 0/max(0, 0)), the others as the
    plain version, and the compacted block is aligned and contiguous."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from redcliff_tpu_torch.ops import pallas_prox as PX

    tm = _tmodel()
    runner = tgrid.RedcliffGridRunner(
        tm, _tc(), tgrid.GridSpec(POINTS4[:3]))
    assert runner._g_exec0 == 4
    params, _, _ = runner.pad_to_width(runner.init_grid(1))
    W = params["factors"][0]["w"]
    W[2, 0, 1] = 0.0
    gate = torch.tensor([True, True, False, False], device=W.device)
    for block in (W, tgrid._take(W, torch.arange(4, device=W.device))):
        assert block.data_ptr() % 16 == 0 and block.is_contiguous()
        t = runner._ex_prox_t
        want = PX.gl_prox_lanes_reference(block, t, gate)
        before = block.clone()
        PX.gl_prox_lanes_(block, t, gate)
        torch.cuda.synchronize()
        off = ~gate
        assert torch.equal(block[off], before[off])
        torch.testing.assert_close(block[gate], want[gate], rtol=1e-5,
                                   atol=1e-6)


def test_a_failing_retire_hook_warns_and_changes_nothing():
    """``on_lane_retire`` is advisory: a hook that raises is reported as a
    RuntimeWarning and the fit's results are bit-identical to a run
    without it."""
    X, Y = _data()
    points = [{"gen_lr": 1e-3}, {"gen_lr": 2e-3}, POISON]

    def fit(hook):
        runner = tgrid.RedcliffGridRunner(_tmodel(), _tc(max_iter=3),
                                          tgrid.GridSpec(points),
                                          device="cpu")
        return runner.fit(1, TDataset(X, Y), TDataset(X, Y),
                          on_lane_retire=hook)

    def hook(pid, rec, epoch):
        raise KeyError(pid)

    with pytest.warns(RuntimeWarning, match="on_lane_retire failed"):
        res = fit(hook)
    _assert_same(fit(None), res)
