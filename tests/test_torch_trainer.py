"""The port's generic trainer (redcliff_tpu_torch/train/trainer.py) and the
per-point REDCLIFF-S trainer with cLSTM factors against the JAX package.

Weights are made by the JAX package's ``init`` and carried across with
``interop.params_from_jax``; inputs are made with numpy from a seed. Each
fit is 4 epochs at a tiny width on the CPU: 64 training windows (a batch of
40 and a remainder of 24) and 32 validation windows.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.data import datasets as jds  # noqa: E402
from redcliff_tpu.models import clstm_fm as jclstm_fm  # noqa: E402
from redcliff_tpu.models import cmlp_fm as jcmlp_fm  # noqa: E402
from redcliff_tpu.models import dgcnn as jdgcnn  # noqa: E402
from redcliff_tpu.models import navar as jnavar  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.obs.logging import read_jsonl  # noqa: E402
from redcliff_tpu.train import redcliff_trainer as jrtr  # noqa: E402
from redcliff_tpu.train import trainer as jtr  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data import datasets as tds  # noqa: E402
from redcliff_tpu_torch.eval import model_io as tio  # noqa: E402
from redcliff_tpu_torch.models import clstm_fm as tclstm_fm  # noqa: E402
from redcliff_tpu_torch.models import cmlp_fm as tcmlp_fm  # noqa: E402
from redcliff_tpu_torch.models import dgcnn as tdgcnn  # noqa: E402
from redcliff_tpu_torch.models import navar as tnavar  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.runtime import numerics as tnum  # noqa: E402
from redcliff_tpu_torch.train import redcliff_trainer as trtr  # noqa: E402
from redcliff_tpu_torch.train import trainer as ttr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# multi-step fits: f32 drift of a few Adam steps (and the prox) on top of
# the summation-order differences of the forward bar (ROADMAP tolerances)
FIT_HIST_TOL = dict(rtol=1e-4, atol=1e-5)
FIT_PARAM_ATOL = 1e-4
T, C, K = 8, 4, 3

FAMILIES = {
    "cmlp_fm": (lambda: jcmlp_fm.CMLPFM(jcmlp_fm.CMLPFMConfig(
        num_chans=C, gen_lag=2, gen_hidden=(6,), input_length=3,
        forecast_coeff=1.0, adj_l1_coeff=0.1)), {}),
    "cmlp_fm_gista": (lambda: jcmlp_fm.CMLPFM(jcmlp_fm.CMLPFMConfig(
        num_chans=C, gen_lag=2, gen_hidden=(6,), input_length=3,
        adj_l1_coeff=0.1)), dict(prox_penalty="GL", prox_lam=0.2)),
    "clstm_fm": (lambda: jclstm_fm.CLSTMFM(jclstm_fm.CLSTMFMConfig(
        num_chans=C, gen_hidden=5, context=2, max_input_length=5,
        adj_l1_coeff=0.5)), {}),
    "navar": (lambda: jnavar.NAVAR(jnavar.NAVARConfig(
        num_nodes=C, num_hidden=6, maxlags=3, hidden_layers=2,
        lambda1=0.1)), {}),
    "navar_lstm": (lambda: jnavar.NAVARLSTM(jnavar.NAVARLSTMConfig(
        num_nodes=C, num_hidden=6, maxlags=3, hidden_layers=2,
        lambda1=0.1)), {}),
    "dgcnn": (lambda: jdgcnn.DGCNNModel(jdgcnn.DGCNNConfig(
        num_channels=C, num_wavelets_per_chan=1, num_features_per_node=2,
        num_graph_conv_layers=2, num_hidden_nodes=5, num_classes=K)), {}),
}
_PORT = {"CMLPFM": (tcmlp_fm.CMLPFM, tcmlp_fm.CMLPFMConfig),
         "CLSTMFM": (tclstm_fm.CLSTMFM, tclstm_fm.CLSTMFMConfig),
         "NAVAR": (tnavar.NAVAR, tnavar.NAVARConfig),
         "NAVARLSTM": (tnavar.NAVARLSTM, tnavar.NAVARLSTMConfig),
         "DGCNNModel": (tdgcnn.DGCNNModel, tdgcnn.DGCNNConfig)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: leaf}: JAX sorts dict keys, the port keeps them as built."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _models(family, **over):
    make, _ = FAMILIES[family]
    jm = make()
    if over:
        jm = type(jm)(dataclasses.replace(jm.config, **over))
    cls, cfg_cls = _PORT[type(jm).__name__]
    tm = cls(cfg_cls(**dataclasses.asdict(jm.config)))
    return jm, tm, _np(jm.init(jax.random.PRNGKey(0)))


def _data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(96, T, C)).astype(np.float32)
    Y = np.eye(K, dtype=np.float32)[rng.integers(0, K, 96)][:, :, None]
    return X, Y


def _true_gc():
    g = (np.random.default_rng(1).random((C, C, 2)) < 0.3).astype(float)
    return [g]


def _train_config(mod, **over):
    kw = dict(learning_rate=1e-2, max_iter=4, lookback=1, check_every=1,
              batch_size=40, seed=3)
    kw.update(over)
    return mod.TrainConfig(**kw)


def _fit(pkg, ds_mod, model, params, family, save_dir=None, true_gc=None,
         device=None, **over):
    X, Y = _data()
    kw = dict(FAMILIES[family][1], **over)
    extra = {} if device is None else {"device": device}
    trainer = pkg.Trainer(model, _train_config(pkg, **kw),
                          has_labels=family == "dgcnn", **extra)
    return trainer.fit(params, ds_mod.ArrayDataset(X[:64], Y[:64]),
                       ds_mod.ArrayDataset(X[64:], Y[64:]), true_GC=true_gc,
                       save_dir=None if save_dir is None else str(save_dir))


def _assert_fits_agree(jres, tres):
    assert tres.best_it == jres.best_it
    assert tres.aborted == jres.aborted
    assert sorted(tres.histories) == sorted(jres.histories)
    for k, v in jres.histories.items():
        np.testing.assert_allclose(np.asarray(tres.histories[k], float),
                                   np.asarray(v, float), err_msg=k,
                                   **FIT_HIST_TOL)
    np.testing.assert_allclose(tres.best_loss, jres.best_loss,
                               **FIT_HIST_TOL)
    np.testing.assert_allclose(tres.final_val_loss, jres.final_val_loss,
                               **FIT_HIST_TOL)
    got, want = _flat(interop.params_to_jax(tres.params)), \
        _flat(_np(jres.params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=FIT_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fit_matches_jax_trainer(family, tmp_path):
    """4 epochs of each family from copied weights: the same histories,
    best epoch, best params and final validation loss as the JAX
    ``Trainer``; GC tracking against a true graph (the forecasters, NAVAR
    on its first validation batch) agrees too; the artifact loads in both
    packages."""
    jm, tm, jp = _models(family)
    true_gc = None if family == "dgcnn" else _true_gc()
    jres = _fit(jtr, jds, jm, jp, family, tmp_path / "jax", true_gc)
    tres = _fit(ttr, tds, tm, jp, family, tmp_path / "port", true_gc,
                device="cpu")
    # the same epochs run (an early stop included)
    assert [e["epoch"] for e in tres.epochs] == \
        list(range(len(jres.histories["avg_combo_loss"])))
    assert tres.numerics["skipped"] == 0
    _assert_fits_agree(jres, tres)
    if true_gc is not None:
        got, want = tres.tracker.latest_as_dict(), \
            jres.tracker.latest_as_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    tmod, tparams = tio.load_model_for_eval(str(tmp_path / "port"),
                                            device="cpu")
    assert type(tmod).__name__ == type(jm).__name__
    assert dataclasses.asdict(tmod.config) == dataclasses.asdict(jm.config)
    from redcliff_tpu.eval.model_io import load_model_for_eval
    jmod, jparams = load_model_for_eval(str(tmp_path / "port"))
    assert type(jmod) is type(jm)
    fj, ft = _flat(jparams), _flat(interop.params_to_jax(tparams))
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k])
    if family == "cmlp_fm_gista":
        # the prox shrank the first-layer groups below the plain fit's,
        # and zeroed none
        plain = _fit(ttr, tds, tm, jp, family, device="cpu",
                     prox_penalty=None)

        def norms(res):
            w = interop.params_to_jax(res.params)["factor"][0]["w"]
            return np.sqrt((w.astype(np.float64) ** 2).sum(axis=(1, 3)))
        assert norms(tres).sum() < norms(plain).sum()
        assert norms(tres).min() > 0


def test_redcliff_clstm_factor_fit_matches_jax_trainer(tmp_path):
    """The per-point REDCLIFF-S trainer with cLSTM factors (1 pretrain + 1
    acclimation + 2 combined epochs, no prox) against the JAX trainer."""
    cfg = dict(
        num_chans=C, gen_lag=3, gen_hidden=(5,), embed_lag=4,
        embed_hidden_sizes=(0,), num_factors=K, num_supervised_factors=K,
        forecast_coeff=10.0, factor_score_coeff=100.0,
        factor_cos_sim_coeff=1.0 / 3.0, factor_weight_l1_coeff=1e-3,
        adj_l1_reg_coeff=0.1, factor_score_embedder_type="DGCNN",
        dgcnn_num_graph_conv_layers=2, dgcnn_num_hidden_nodes=8,
        use_sigmoid_restriction=False,
        primary_gc_est_mode="conditional_factor_fixed_embedder",
        forward_pass_mode="apply_factor_weights_after_sim_completion",
        num_sims=1, factor_network_type="cLSTM",
        training_mode="pretrain_embedder_then_acclimate_factors_then_"
                      "combined",
        num_pretrain_epochs=1, num_acclimation_epochs=1)
    jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**cfg))
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**cfg))
    jp = _np(jm.init(jax.random.PRNGKey(0)))
    X, Y = _data()
    tc = dict(gen_lr=1e-2, embed_lr=1e-2, gen_eps=1e-4, embed_eps=1e-4,
              gen_weight_decay=1e-4, embed_weight_decay=1e-4, max_iter=4,
              lookback=1, check_every=1, batch_size=40, seed=3,
              stopping_criteria_forecast_coeff=10.0,
              stopping_criteria_factor_coeff=100.0,
              stopping_criteria_cosSim_coeff=1.0)
    X5 = X[:, :5]
    jres = jrtr.RedcliffTrainer(jm, jrtr.RedcliffTrainConfig(**tc)).fit(
        jp, jds.ArrayDataset(X5[:64], Y[:64]),
        jds.ArrayDataset(X5[64:], Y[64:]), save_dir=str(tmp_path / "jax"))
    tres = trtr.RedcliffTrainer(tm, trtr.RedcliffTrainConfig(**tc),
                                device="cpu").fit(
        jp, tds.ArrayDataset(X5[:64], Y[:64]),
        tds.ArrayDataset(X5[64:], Y[64:]), save_dir=str(tmp_path / "port"))
    assert [e["phases"] for e in tres.epochs] == [
        ["embedder_pretrain"], ["factor_pretrain"], ["combined"],
        ["combined"]]
    assert tres.numerics["skipped"] == 0
    _assert_fits_agree(jres, tres)
    with pytest.raises(ValueError, match="cMLP factor"):
        trtr.RedcliffTrainer(tm, trtr.RedcliffTrainConfig(
            **tc, prox_penalty="GL", prox_lam=1.0), device="cpu").fit(
            jp, tds.ArrayDataset(X5[:64], Y[:64]),
            tds.ArrayDataset(X5[64:], Y[64:]))


def test_gista_zero_group_stall_matches_jax(tmp_path):
    """cMLP-FM under a prox_lam that zeroes whole (H, L) groups: the GC's
    sqrt at 0 makes the next gradients NaN (ROADMAP queue 3 item 2), and
    the guard skips the same steps, with the same rollbacks, in both
    packages."""
    jm, tm, jp = _models("cmlp_fm_gista")
    jres = _fit(jtr, jds, jm, jp, "cmlp_fm_gista", tmp_path / "jax",
                prox_lam=40.0)
    tres = _fit(ttr, tds, tm, jp, "cmlp_fm_gista", tmp_path / "port",
                device="cpu", prox_lam=40.0)
    jskips = {e["epoch"]: e["epoch_skipped_steps"]
              for e in read_jsonl(str(tmp_path / "jax"), event="anomaly")}
    tskips = {e["epoch"]: e["skipped"] for e in tres.epochs if e["skipped"]}
    assert tskips == jskips and sum(tskips.values()) > 0
    jroll = [e["epoch"] for e in read_jsonl(str(tmp_path / "jax"),
                                            event="numerics")
             if e["kind"] == "rollback"]
    assert [e["epoch"] for e in tres.epochs
            if e["action"] == "rollback"] == jroll
    assert tres.best_it == jres.best_it and tres.aborted == jres.aborted
    np.testing.assert_allclose(tres.histories["avg_combo_loss"],
                               jres.histories["avg_combo_loss"],
                               **FIT_HIST_TOL)


@pytest.mark.parametrize("family,over", [
    ("cmlp_fm_gista", {}), ("navar", {"dropout": 0.3})])
def test_resume_is_bit_identical_to_uninterrupted_fit(family, over,
                                                      tmp_path):
    """Stop after 2 epochs, resume to 4: the params, best params and
    histories equal the uninterrupted fit bit for bit (the shuffle rng and
    the dropout generator are checkpointed); a JAX trainer checkpoint is
    refused."""
    _, tm, jp = _models(family, **over)
    full = _fit(ttr, tds, tm, jp, family, tmp_path / "full", device="cpu",
                lookback=5)
    first = _fit(ttr, tds, tm, jp, family, tmp_path / "cut", device="cpu",
                 lookback=5, max_iter=2)
    assert [e["epoch"] for e in first.epochs] == [0, 1]
    resumed = _fit(ttr, tds, tm, jp, family, tmp_path / "cut", device="cpu",
                   lookback=5)
    assert [e["epoch"] for e in resumed.epochs] == [2, 3]
    assert resumed.best_it == full.best_it
    assert resumed.histories == full.histories
    a = _flat(interop.params_to_jax(resumed.params))
    for k, v in _flat(interop.params_to_jax(full.params)).items():
        np.testing.assert_array_equal(a[k], v)
    ck = [ttr.durable_ckpt.read_checkpoint(str(d / "trainer_checkpoint.pkl"))
          for d in (tmp_path / "full", tmp_path / "cut")]
    for k, v in _flat(ck[0]["params"]).items():
        np.testing.assert_array_equal(_flat(ck[1]["params"])[k], v)
    # the checkpoint's epoch log spans both calls on the cut save_dir
    for c in ck:
        assert [e["epoch"] for e in c["epoch_log"]] == [0, 1, 2, 3]
    assert [e["steps"] for e in ck[1]["epoch_log"]] == \
        [e["steps"] for e in first.epochs + resumed.epochs]
    jm, _, jp0 = _models("cmlp_fm")
    _fit(jtr, jds, jm, jp0, "cmlp_fm", tmp_path / "jax", max_iter=1)
    _, tm0, _ = _models("cmlp_fm")
    with pytest.raises(ValueError, match="not a trainer checkpoint of the"):
        _fit(ttr, tds, tm0, jp0, "cmlp_fm", tmp_path / "jax", device="cpu")


def test_unported_knobs_raise_and_default_device_is_cuda(monkeypatch,
                                                          tmp_path):
    # the telemetry knobs are ported: they construct and resolve a window
    from redcliff_tpu_torch.obs import profiling

    tc = ttr.TrainConfig(profile_window="epoch:0-1",
                         profile_dir=str(tmp_path),
                         compile_cache_dir=str(tmp_path))
    win = profiling.window_for(tc, max_iter=3, device="cpu")
    assert (win.first_epoch, win.last_epoch) == (0, 1)
    with pytest.raises(NotImplementedError, match="mixed"):
        ttr.TrainConfig(precision_mode="mixed")
    # the async checkpoint writer is ported: the JAX knob and its default
    assert ttr.TrainConfig().async_checkpointing \
        is jtr.TrainConfig().async_checkpointing is True
    assert not ttr.TrainConfig(async_checkpointing=False).async_checkpointing
    with pytest.raises(ValueError, match="prox_penalty"):
        ttr.TrainConfig(prox_penalty="L1")
    # every JAX knob
    assert sorted(f.name for f in dataclasses.fields(ttr.TrainConfig)) == \
        sorted(f.name for f in dataclasses.fields(jtr.TrainConfig))
    _, tm, _ = _models("navar")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttr.Trainer(tm, ttr.TrainConfig())


def test_port_trainer_fits_baselines_without_jax(tmp_path):
    """Importing and running the generic trainer (cMLP-FM with the GL prox,
    NAVAR with dropout) loads no jax and no module of the JAX package."""
    code = f"""
import sys
import numpy as np
import torch
from redcliff_tpu_torch.data.datasets import ArrayDataset
from redcliff_tpu_torch.models.cmlp_fm import CMLPFM, CMLPFMConfig
from redcliff_tpu_torch.models.navar import NAVAR, NAVARConfig
from redcliff_tpu_torch.train.trainer import TrainConfig, Trainer
rng = np.random.default_rng(0)
X = rng.normal(size=(48, 8, 4)).astype(np.float32)
for model, kw in ((CMLPFM(CMLPFMConfig(4, 2, (6,), 3, adj_l1_coeff=0.1)),
                   dict(prox_penalty="GL", prox_lam=0.2)),
                  (NAVAR(NAVARConfig(4, 6, 3, dropout=0.2)), {{}})):
    params = model.init(torch.Generator().manual_seed(0))
    res = Trainer(model, TrainConfig(max_iter=3, batch_size=16,
                                     check_every=1, **kw),
                  device="cpu").fit(params, ArrayDataset(X[:32]),
                                    ArrayDataset(X[32:]),
                                    save_dir={str(tmp_path)!r} + "/" +
                                    type(model).__name__)
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


def _guarded_steps(family, tm, params, device, n):
    """``n`` guarded steps of the generic trainer from ``params`` on the
    first batches of the shuffled stream: the losses and the final params
    as numpy."""
    X, Y = _data()
    trainer = ttr.Trainer(tm, _train_config(ttr, **FAMILIES[family][1]),
                          has_labels=family == "dgcnn", device=device)
    live = trainer.live_params(params)
    opt = trainer.make_optimizer(live)
    nstate = tnum.init_numerics_state()
    rng = np.random.default_rng(0)
    losses = []
    ds = tds.ArrayDataset(X, Y)
    while len(losses) < n:
        for Xb, Yb in trainer._batches(ds, rng=rng):
            combo, _, nstate, ok = trainer.train_step(
                live, opt, Xb, Yb, trainer.make_step_rng(), nstate)
            assert ok
            losses.append(float(combo.detach()))
            if len(losses) == n:
                break
    return np.array(losses), _flat(interop.params_to_jax(live))


@pytest.mark.gpu
@pytest.mark.parametrize("family", list(FAMILIES))
def test_guarded_steps_on_card_match_cpu(family):
    """The smoke's baselines_check: 8 guarded steps of each family from the
    same weights and batches on the card (the GL prox kernel for the GISTA
    fit) and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GL prox kernel has no CPU mode")
    _, tm, jp = _models(family)
    lc, pc = _guarded_steps(family, tm, jp, "cuda", 8)
    lh, ph = _guarded_steps(family, tm, jp, "cpu", 8)
    np.testing.assert_allclose(lc, lh, **FIT_HIST_TOL)
    for k in ph:
        np.testing.assert_allclose(pc[k], ph[k], rtol=0,
                                   atol=FIT_PARAM_ATOL, err_msg=k)
