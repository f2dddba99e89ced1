"""The port grid's stream modes (redcliff_tpu_torch/data/pipeline.py
``choose_stream_mode``/``dispatch_budget``/``dataset_device_bytes``,
parallel/epoch_engine.py, the epoch loop of parallel/grid.py) against the
JAX package's.

At the width of tests/test_parallel_grid.py:_model (C=4, gen_hidden 8,
K=2, Vanilla embedder) with the GL prox on. On the CPU a program's body
runs eagerly (its plain version), so the three modes must agree bit for
bit, as the JAX package's do (tests/test_data_pipeline.py:128-155). One
JAX grid fit in epoch mode (module fixture) holds the port's epoch mode
against it from the same stacked state.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from redcliff_tpu.data import pipeline as jpipe  # noqa: E402
from redcliff_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.parallel import grid as jgrid  # noqa: E402
from redcliff_tpu.train import redcliff_trainer as jtr  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data import pipeline as tpipe  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset as TDataset  # noqa: E402,E501
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.parallel import epoch_engine as tengine  # noqa: E402
from redcliff_tpu_torch.parallel import grid as tgrid  # noqa: E402
from redcliff_tpu_torch.runtime import checkpoint as tck  # noqa: E402
from redcliff_tpu_torch.runtime import numerics as tnum  # noqa: E402
from redcliff_tpu_torch.train import redcliff_trainer as ttr  # noqa: E402

# the grid bar of ROADMAP "Tolerances" (tests/test_torch_grid.py)
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)

B = 16
KNOBS = dict(max_iter=3, batch_size=B, seed=5, lookback=1, check_every=1,
             prox_penalty="GL", prox_lam=0.5)
POISON = {"gen_lr": 1e20, "factor_cos_sim_coeff": 0.1}
POINTS = [{"gen_lr": 1e-3}, {"gen_lr": 5e-3},
          {"adj_l1_reg_coeff": 0.01, "embed_lr": 2e-3}, POISON]


def _model_kw(mode="combined"):
    kw = dict(num_chans=4, gen_lag=2, gen_hidden=(8,), embed_lag=4,
              embed_hidden_sizes=(8,), num_factors=2,
              num_supervised_factors=2, factor_weight_l1_coeff=0.01,
              adj_l1_reg_coeff=0.001, factor_cos_sim_coeff=0.01,
              factor_score_embedder_type="Vanilla_Embedder",
              primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
              training_mode=mode)
    if "pretrain" in mode:
        kw["num_pretrain_epochs"] = 1
    return kw


def _tmodel(mode="combined"):
    return tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**_model_kw(mode)))


def _data(n):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 5, 4)).astype(np.float32)
    Y = rng.uniform(size=(n, 3, 1)).astype(np.float32)
    return X, Y


def _tc(**over):
    return ttr.RedcliffTrainConfig(**{**KNOBS, **over})


def _fit(n, points=POINTS, mode="combined", ds_cls=TDataset, key=3,
         **over):
    X, Y = _data(n)
    runner = tgrid.RedcliffGridRunner(_tmodel(mode), _tc(**over),
                                      tgrid.GridSpec(points), device="cpu")
    res = runner.fit(key, ds_cls(X, Y), TDataset(X, Y))
    return runner, res


def _assert_same(a, b):
    """Two port results bit for bit (NaN where the poisoned lane has it)."""
    np.testing.assert_array_equal(a.val_history, b.val_history)
    np.testing.assert_array_equal(a.best_criteria, b.best_criteria)
    np.testing.assert_array_equal(a.best_epoch, b.best_epoch)
    np.testing.assert_array_equal(a.active, b.active)
    assert a.failures == b.failures
    assert a.numerics.keys() == b.numerics.keys()
    for k in a.numerics:
        np.testing.assert_array_equal(a.numerics[k], b.numerics[k])
    for x, y in zip(interop.tree_leaves(a.best_params),
                    interop.tree_leaves(b.best_params)):
        np.testing.assert_array_equal(x, y)


class _HostOnly:
    """A dataset with no device-resident copy: ``batches`` yields numpy,
    which the grid prefetches to the device (the k-batch mode copies its
    groups into the program's buffers either way)."""

    def __init__(self, X, Y):
        self._ds = TDataset(X, Y)
        self.X, self.Y = self._ds.X, self._ds.Y

    def __len__(self):
        return len(self._ds)

    def batches(self, batch_size, rng=None):
        return self._ds.batches(batch_size, rng=rng)


# ------------------------------------- the mode choice, port = JAX, per case
def _datasets(kind):
    X = np.zeros((64, 4, 3), np.float32)
    Y = None if kind == "nolabel" else np.zeros((64, 2), np.float32)
    return JDataset(X, Y), TDataset(X, Y)


@pytest.mark.parametrize("fn,args,kwargs", [
    # tests/test_data_pipeline.py:50-85, each call against both packages
    ("choose", ("auto", "labels"), dict(scan_batches=0, batch_size=16)),
    ("choose", ("per_batch", "labels"), dict(scan_batches=0, batch_size=16)),
    ("choose", ("auto", "labels"), dict(freeze_by_batch=True,
                                        scan_batches=0, batch_size=16)),
    # too few windows for one full batch: epoch is out, kscan takes it
    ("choose", ("auto", "labels"), dict(scan_batches=4, batch_size=100)),
    ("choose", ("auto", "nolabel"), dict(scan_batches=0, batch_size=16)),
    # the device-residency ceiling set to 10 bytes in both packages
    ("choose", ("auto", "labels", 10), dict(scan_batches=4, batch_size=16)),
    ("choose", ("auto", "labels", 10), dict(scan_batches=0, batch_size=16)),
    ("choose", ("auto", "labels"), dict(scan_batches=0, batch_size=100)),
    ("choose", ("warp", "labels"), dict(scan_batches=0, batch_size=16)),
    ("choose", ("kscan", "labels"), dict(scan_batches=4, batch_size=16)),
    ("choose", ("epoch", "labels"), dict(scan_batches=4, batch_size=16)),
    ("choose", ("kscan", "labels"), dict(scan_batches=1, batch_size=16)),
    ("budget", (20,), dict(mode="per_batch")),
    ("budget", (20,), dict(scan_batches=4, mode="kscan")),
    ("budget", (21, 1), dict(scan_batches=4, mode="kscan")),
    ("budget", (20,), dict(mode="epoch")),
    ("budget", (20, 1), dict(mode="epoch")),
    ("budget", (0, 1), dict(mode="epoch")),
    ("bytes", ("labels",), {}),
    ("bytes", ("nolabel",), {}),
])
def test_stream_mode_helpers_match_jax(fn, args, kwargs, monkeypatch):
    assert tpipe.STREAM_MODES == jpipe.STREAM_MODES
    assert (tpipe.DEFAULT_MAX_DEVICE_DATASET_BYTES
            == jpipe.DEFAULT_MAX_DEVICE_DATASET_BYTES)
    if fn == "choose" and len(args) == 3:
        for pkg in (tpipe, jpipe):
            monkeypatch.setattr(pkg, "DEFAULT_MAX_DEVICE_DATASET_BYTES",
                                args[2])

    def call(pkg, which):
        if fn == "budget":
            return pkg.dispatch_budget(*args, **kwargs)
        if fn == "bytes":
            return pkg.dataset_device_bytes(_datasets(args[-1])[which])
        try:
            return pkg.choose_stream_mode(args[0],
                                          _datasets(args[1])[which],
                                          **kwargs)
        except ValueError as e:
            return ("ValueError", "stream_mode" in str(e))
    assert call(tpipe, 1) == call(jpipe, 0)


def test_config_fields_and_unknown_mode():
    """The two fields with JAX's defaults; an unknown mode raises
    ValueError when a grid fit resolves it, as in JAX; the per-point
    trainer takes the fields and ignores them."""
    for name in ("scan_batches", "stream_mode"):
        assert (getattr(ttr.RedcliffTrainConfig(), name)
                == getattr(jtr.RedcliffTrainConfig(), name))
    X, Y = _data(32)
    runner = tgrid.RedcliffGridRunner(
        _tmodel(), _tc(stream_mode="warp"), tgrid.GridSpec([{}]),
        device="cpu")
    with pytest.raises(ValueError, match="stream_mode"):
        runner.fit(0, TDataset(X, Y), TDataset(X, Y))
    model = _tmodel()
    params = model.init(torch.Generator().manual_seed(1))
    tc = _tc(max_iter=1, stream_mode="warp", scan_batches=4)
    out = ttr.RedcliffTrainer(model, tc, device="cpu").fit(
        params, TDataset(X, Y), TDataset(X, Y))
    assert np.isfinite(out.best_loss)


# --------------------------------------------- the three modes, bit for bit
@pytest.mark.parametrize("n", [80, 56])
def test_stream_modes_are_bit_identical(n):
    """per_batch, kscan (k=4, on the device-resident dataset and on a
    host-only one) and epoch give the same fit bit for bit, a poisoned
    lane's quarantine included. n=80 is five full batches (one group of
    four and one eager step in kscan); n=56 three and a remainder of 8
    that takes a program (epoch) or an eager step (kscan) of its own."""
    _, ref = _fit(n, stream_mode="per_batch")
    runs = {"kscan": _fit(n, stream_mode="kscan", scan_batches=4),
            "kscan_host": _fit(n, stream_mode="kscan", scan_batches=4,
                               ds_cls=_HostOnly),
            "epoch": _fit(n, stream_mode="epoch")}
    for name, (runner, res) in runs.items():
        assert runner.dispatch_stats["mode"] == name.split("_")[0]
        assert [e["mode"] for e in res.epochs] == [name.split("_")[0]] * 3
        _assert_same(ref, res)
    assert [f["point"] for f in ref.failures] == [3]


def test_multi_phase_schedule_and_freeze_by_batch_degrade():
    """A pretraining schedule runs its single-phase epochs in epoch mode;
    FreezeByBatch always steps per batch; each bit-identical to
    per_batch."""
    for mode, want in (
            ("pretrain_embedder_then_post_train_factor", "epoch"),
            ("pretrain_embedder_then_post_train_factor_withL1FreezeByBatch",
             "per_batch")):
        _, ref = _fit(56, mode=mode, stream_mode="per_batch")
        runner, res = _fit(56, mode=mode)
        assert runner.dispatch_stats["mode"] == want
        assert {e["mode"] for e in res.epochs} == {want}
        _assert_same(ref, res)


# ------------------------------------- dispatches counted against the budget
@pytest.mark.parametrize("over,mode", [
    ({}, "epoch"), ({"stream_mode": "kscan", "scan_batches": 2}, "kscan"),
    ({"stream_mode": "per_batch"}, "per_batch")])
def test_dispatches_meet_the_budget(over, mode):
    """Counted train and validation dispatches equal epochs x
    ``dispatch_budget``; "auto" is the default and resolves to "epoch"
    (the validation set rides the epoch engine in epoch mode only)."""
    n = 88  # five full batches and a remainder of 8
    runner, res = _fit(n, **over)
    st = runner.dispatch_stats
    assert _tc().stream_mode == "auto"
    assert st["mode"] == mode and st["epochs"] == len(res.epochs) == 3
    nb, rem = n // B, int(n % B > 0)
    assert st["train_dispatches"] == st["epochs"] * tpipe.dispatch_budget(
        nb, rem, scan_batches=over.get("scan_batches", 0), mode=mode)
    val_mode = "epoch" if mode == "epoch" else "per_batch"
    assert st["val_dispatches"] == st["epochs"] * tpipe.dispatch_budget(
        nb, rem, mode=val_mode)
    assert st["graph_captures"] == 0 and st["programs"] == []
    assert st["epoch_ms_by_width"].keys() == {"4"}
    assert st["train_time_ms"] > 0 and st["val_time_ms"] > 0


# --------------------------------------------------- against the JAX grid
@pytest.fixture(scope="module")
def jax_epoch_pair():
    """The JAX grid in epoch mode and the port's from its stacked init."""
    jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**_model_kw()))
    X, Y = _data(56)
    jtc = jtr.RedcliffTrainConfig(**KNOBS, compaction=False,
                                  stream_mode="epoch")
    jrun = jgrid.RedcliffGridRunner(jm, jtc, jgrid.GridSpec(points=POINTS))
    init = jrun.init_grid(jax.random.PRNGKey(4))
    state = jax.tree.map(np.asarray, init)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX grid's quality telemetry changes no result, only compiles
        mp.setenv("REDCLIFF_QUALITY", "0")
        jres = jrun.fit(jax.random.PRNGKey(4), JDataset(X, Y),
                        JDataset(X, Y), init_params=init)
    trun = tgrid.RedcliffGridRunner(
        _tmodel(), _tc(stream_mode="epoch", compaction=False),
        tgrid.GridSpec(POINTS), device="cpu")
    tres = trun.fit(None, TDataset(X, Y), TDataset(X, Y),
                    init_params=interop.grid_state_from_jax(*state))
    return jrun, jres, trun, tres


def test_epoch_mode_matches_jax_epoch_mode(jax_epoch_pair):
    jrun, jres, trun, tres = jax_epoch_pair
    np.testing.assert_array_equal(tres.best_epoch, jres.best_epoch)
    np.testing.assert_array_equal(tres.active, jres.active)
    assert tres.failures == jres.failures
    assert [f["point"] for f in tres.failures] == [3]
    np.testing.assert_allclose(tres.val_history, jres.val_history, **HIST)
    np.testing.assert_allclose(tres.best_criteria, jres.best_criteria,
                               **HIST)
    for a, b in zip(jax.tree.leaves(jres.best_params),
                    jax.tree.leaves(tres.best_params)):
        np.testing.assert_allclose(b[:3], np.asarray(a)[:3], **PARAMS)


def test_dispatch_stats_match_jax(jax_epoch_pair):
    jrun, _, trun, _ = jax_epoch_pair
    for k in ("mode", "epochs", "train_dispatches", "val_dispatches"):
        assert trun.dispatch_stats[k] == jrun.dispatch_stats[k], k
    assert (trun.dispatch_stats["epoch_ms_by_width"].keys()
            == jrun.dispatch_stats["epoch_ms_by_width"].keys())


# ------------------------------------------------- compaction and resume
POINTS8 = ([{"gen_lr": 1e-3 * (1 + i)} for i in range(3)]
           + [{"gen_lr": 0.0, "embed_lr": 0.0}] * 4 + [POISON])


def test_epoch_mode_with_compaction_equals_per_batch():
    """Four zero-lr lanes stop early and the poisoned lane is
    quarantined, so the grid compacts 8 -> 4 at epoch 1: the epoch mode's
    programs of the first era are dropped and the second era's run on the
    gathered leaves, bit for bit as per_batch."""
    r_pb, ref = _fit(56, points=POINTS8, max_iter=4,
                     stream_mode="per_batch")
    r_ep, res = _fit(56, points=POINTS8, max_iter=4)
    widths = [e["width"] for e in res.epochs]
    assert widths[0] == 8 and widths[-1] == 4
    assert r_ep.dispatch_stats["compactions"] == 1
    assert r_ep.dispatch_stats["mode"] == "epoch"
    assert (r_ep.dispatch_stats["epoch_ms_by_width"].keys()
            == {"8", "4"})
    _assert_same(ref, res)


def test_epoch_mode_checkpoint_resumes_bit_for_bit(tmp_path):
    """A fit stopped after 2 of 4 epochs in epoch mode resumes from its
    checkpoint to the uninterrupted fit, bit for bit; the resumed
    runner's first era starts with no programs."""
    _, want = _fit(56, points=POINTS8, max_iter=4)
    X, Y = _data(56)
    ck = str(tmp_path / "ck")

    def fit(max_iter):
        runner = tgrid.RedcliffGridRunner(_tmodel(), _tc(max_iter=4),
                                          tgrid.GridSpec(POINTS8),
                                          device="cpu")
        res = runner.fit(3, TDataset(X, Y), TDataset(X, Y),
                         max_iter=max_iter, checkpoint_dir=ck,
                         checkpoint_every=1)
        return runner, res

    fit(2)
    runner, got = fit(None)
    assert runner.dispatch_stats["resumed_from_epoch"] == 1
    assert [e["epoch"] for e in got.epochs] == [2, 3]
    assert {e["mode"] for e in got.epochs} == {"epoch"}
    _assert_same(want, got)


def test_stream_knobs_join_the_fingerprint(tmp_path):
    """A checkpoint written under the defaults ("auto", 0 — as every
    port checkpoint before the stream knobs were ported wrote them)
    resumes under the defaults and refuses a changed ``stream_mode`` or
    ``scan_batches``."""
    X, Y = _data(56)
    ck = str(tmp_path / "ck")

    def fit(max_iter=None, **over):
        runner = tgrid.RedcliffGridRunner(
            _tmodel(), _tc(max_iter=2, **over), tgrid.GridSpec(POINTS[:2]),
            device="cpu")
        return runner.fit(1, TDataset(X, Y), TDataset(X, Y),
                          max_iter=max_iter, checkpoint_dir=ck,
                          checkpoint_every=1)

    fit(max_iter=1)
    path = os.path.join(ck, tgrid.RedcliffGridRunner.CHECKPOINT_NAME)
    meta = tck.read_checkpoint(path)["meta"]
    assert (meta["stream_mode"], meta["scan_batches"]) == ("auto", 0)
    for over in ({"stream_mode": "per_batch"}, {"scan_batches": 4}):
        with pytest.raises(ValueError, match=next(iter(over))):
            fit(**over)
    res = fit()
    assert [e["epoch"] for e in res.epochs] == [1]


# -------------------------------------------------------- program contract
class _Ops(TorchDispatchMode):
    """The aten ops a block of code runs."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


# ops that read device values on the host, or make a tensor from host data
# (a copy from pageable host memory on the card): none may run inside a
# captured program
HOST_READS = {"aten._local_scalar_dense", "aten.item", "aten.nonzero",
              "aten.is_nonzero", "aten.equal", "aten.allclose",
              "aten.masked_select", "aten.unique", "aten._unique2",
              "aten.lift_fresh", "aten.lift"}


def _engine(mode_cfg, train_ds, val_ds, width):
    runner = tgrid.RedcliffGridRunner(
        tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**mode_cfg)),
        _tc(max_iter=1), tgrid.GridSpec([{"gen_lr": 1e-3}, {}, {}]),
        device="cpu")
    stats = {"train_dispatches": 0, "val_dispatches": 0,
             "graph_captures": 0, "capture_ms": 0.0, "programs": []}
    eng = tengine.EpochEngine(runner, "epoch", train_ds, val_ds, stats)
    eng.new_era(width)
    state = runner.pad_to_width(runner.init_grid(0))
    return runner, eng, state


def test_program_bodies_read_nothing_on_the_host():
    """Every program body of the smoke's model shape (DGCNN embedder,
    conditional readout, cosine and adjacency penalties, post-sim
    weighting, GL prox), at a tiny width: each phase's train program and
    the validation program run no op that reads the device on the host or
    makes a tensor from host data."""
    cfg = dict(num_chans=4, gen_lag=2, gen_hidden=(5,), embed_lag=4,
               embed_hidden_sizes=(0,), num_factors=3,
               num_supervised_factors=3, factor_score_coeff=100.0,
               factor_cos_sim_coeff=0.1, factor_weight_l1_coeff=1e-3,
               adj_l1_reg_coeff=0.1, factor_score_embedder_type="DGCNN",
               dgcnn_num_graph_conv_layers=3, dgcnn_num_hidden_nodes=6,
               primary_gc_est_mode="conditional_factor_fixed_embedder",
               forward_pass_mode="apply_factor_weights_after_sim_completion",
               num_sims=1, training_mode="pretrain_embedder_then_"
               "acclimate_factors_then_combined", num_pretrain_epochs=1,
               num_acclimation_epochs=1)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 5, 4)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 40)][:, :, None]
    ds = TDataset(X, Y)
    runner, eng, (params, optA, optB) = _engine(cfg, ds, ds, 4)
    nstate = tnum.init_numerics_state(lanes=4)
    eng.active.copy_(torch.tensor([True, True, True, False]))
    idx = {"idx": torch.arange(32).reshape(2, 16)}
    with _Ops() as seen:
        for phase in ("embedder_pretrain", "factor_pretrain", "combined"):
            eng._train_body(phase)(idx, 2, (params, optA, optB, nstate))
        eng._val_body()(idx, 2, (params,))
    assert "aten.index_select" in seen.ops
    assert not seen.ops & HOST_READS, seen.ops & HOST_READS


def test_a_program_whose_leaves_moved_raises():
    """A program records its leaves at its first run; a run after a leaf
    was rebound (not updated in place) raises instead of running on the
    old storage."""
    X, Y = _data(48)
    ds = TDataset(X, Y)
    runner, eng, (params, optA, optB) = _engine(_model_kw(), ds, ds, 4)
    nstate = tnum.init_numerics_state(lanes=4)
    state = (params, optA, optB, nstate)
    eng.active.copy_(torch.tensor([True, True, True, False]))
    plan = np.arange(48).reshape(3, 16)
    eng._indexed("combined", plan, state)
    eng._indexed("combined", plan, state)
    assert eng.stats["train_dispatches"] == 2
    assert len(eng.programs) == 1
    nstate["skipped"] = nstate["skipped"].clone()
    with pytest.raises(RuntimeError, match="moved"):
        eng._indexed("combined", plan, state)
    eng.new_era(4)
    assert eng.programs == {}
    eng.active.copy_(torch.tensor([True, True, True, False]))
    eng._indexed("combined", plan, state)


def test_step_updates_its_state_in_place():
    """The grid step writes the params, both Adam states and the numerics
    counters into their own storage (what a replayed program needs), with
    the values of a functional update."""
    X, Y = _data(16)
    ds = TDataset(X, Y)
    runner, eng, (params, optA, optB) = _engine(_model_kw(), ds, ds, 4)
    nstate = tnum.init_numerics_state(lanes=4)
    state = (params, optA, optB, nstate)
    ptrs = [t.data_ptr() for t in interop.tree_leaves(state)]
    active = torch.tensor([True, True, False, True])
    out, combo = runner._step("combined", params, optA, optB, nstate,
                              active, torch.from_numpy(X),
                              torch.from_numpy(Y))
    assert out is nstate
    assert [t.data_ptr() for t in interop.tree_leaves(state)] == ptrs
    np.testing.assert_array_equal(optA["step"].numpy(), [1, 1, 0, 1])
    np.testing.assert_array_equal(nstate["checked"].numpy(), [1, 1, 0, 1])
    assert np.isfinite(combo.numpy()).all()


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
def test_captured_fit_matches_eager_fit_on_card():
    """On the card: the epoch mode's captured fit (and the k-batch
    replays, over a device-resident dataset and over one with no device
    copy, whose prefetch thread copies batches while a group is captured)
    against the eager per_batch fit from the same weights: the same
    decisions, values at the grid bar; graphs captured and both kernels'
    launches counted as executions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    from redcliff_tpu_torch.ops import factor_mix as FM
    from redcliff_tpu_torch.ops import pallas_prox as PX

    X, Y = _data(88)
    model = _tmodel()
    p0 = interop.params_to_jax(model.init(torch.Generator().manual_seed(2)))
    results = {}
    kscan = {"stream_mode": "kscan", "scan_batches": 2}
    for name, over, ds_cls in (
            ("per_batch", {"stream_mode": "per_batch"}, TDataset),
            ("epoch", {}, TDataset), ("kscan", kscan, TDataset),
            ("kscan_host", kscan, _HostOnly)):
        runner = tgrid.RedcliffGridRunner(model, _tc(**over),
                                          tgrid.GridSpec(POINTS))
        FM.factor_mix.launches = PX.gl_prox.launches = 0
        res = runner.fit(None, ds_cls(X, Y), ds_cls(X, Y),
                         init_params=runner.init_grid_from(p0))
        torch.cuda.synchronize()
        results[name] = (runner.dispatch_stats, res, FM.factor_mix.launches,
                         PX.gl_prox.launches)
    ref = results["per_batch"][1]
    for name in ("epoch", "kscan", "kscan_host"):
        st, res, mix, prox = results[name]
        assert st["mode"] == name.split("_")[0] and st["graph_captures"] > 0
        np.testing.assert_array_equal(res.best_epoch, ref.best_epoch)
        np.testing.assert_array_equal(res.active, ref.active)
        assert res.failures == ref.failures
        np.testing.assert_allclose(res.val_history, ref.val_history, **HIST)
        for a, b in zip(interop.tree_leaves(ref.best_params),
                        interop.tree_leaves(res.best_params)):
            np.testing.assert_allclose(b[:3], a[:3], **PARAMS)
        # executions: the per_batch fit's plus the warm-up step before each
        # capture (one step of each program's launches)
        warm = {k: sum(p["launches_per_replay"][k] // p["steps"]
                       for p in st["programs"])
                for k in ("factor_mix", "gl_prox")}
        assert warm["factor_mix"] == st["graph_captures"]
        assert mix == results["per_batch"][2] + warm["factor_mix"]
        assert prox == results["per_batch"][3] + warm["gl_prox"]


@pytest.mark.gpu
def test_published_grid_quarantine_matches_jax():
    """The smoke's ``grid_stream`` fit (the published 27-point D4IC grid
    at 12 epochs over the smoke's data and seed-0 weights) in the port's
    per_batch mode on the card, and in the JAX grid (on the CPU) from the
    same weights and data: the guard quarantines the same points, with
    the same cause, and every other lane stays finite in both. Prints
    both packages' failure records as one JSON line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the smoke's fit runs on it")
    import importlib.util
    import json

    from redcliff_tpu.data.datasets import train_val_split
    from redcliff_tpu.train import driver as jdriver
    from redcliff_tpu_torch.train import driver as tdriver

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    points, _ = smoke._grid_points()
    train_ds, val_ds = smoke._train_data(np)
    # the same windows, split and normalized by the JAX package's own
    # train_val_split (validation takes the training statistics)
    X, Y, _ = smoke._d4ic_like_data(np, smoke.N_TRAIN + smoke.N_VAL, seed=0)
    jtrain_ds, jval_ds = train_val_split(
        X, Y, val_fraction=smoke.N_VAL / (smoke.N_TRAIN + smoke.N_VAL),
        rng=np.random.default_rng(1))
    model = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(
        **smoke.TRAIN_CONFIG))
    params = model.init(torch.Generator().manual_seed(0))
    knobs = {**smoke.TRAIN_KNOBS, "max_iter": smoke.STREAM_MAX_ITER,
             "lookback": smoke.STREAM_LOOKBACK}
    port = tdriver.run_coefficient_grid(
        model, ttr.RedcliffTrainConfig(**knobs, stream_mode="per_batch"),
        points, train_ds, val_ds, init_point_params=params)
    ref = jdriver.run_coefficient_grid(
        jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**smoke.TRAIN_CONFIG)),
        jtr.RedcliffTrainConfig(**knobs), points, jtrain_ds, jval_ds,
        init_point_params=interop.params_to_jax(params))

    def record(res):
        return [(f["point"], f["epoch"], f["cause"]) for f in res.failures]
    print(json.dumps({"grid_stream_quarantine": {
        "port_per_batch_card": record(port), "jax_cpu": record(ref),
        "port_skipped": int(sum(port.numerics["skipped"]))}}))
    assert ({(p, c) for p, _, c in record(port)}
            == {(p, c) for p, _, c in record(ref)})
    for res in (port, ref):
        failed = [f["point"] for f in res.failures]
        healthy = [g for g in range(len(points)) if g not in failed]
        assert np.isfinite(np.asarray(res.val_history)[:, healthy]).all()
