"""The baseline families' array tasks in the port (redcliff_tpu_torch/
utils/config.py, train/orchestration.py, train/driver.py, eval/
{model_io,gc_estimates}.py) against the JAX package.

The published D4IC cached-args of each family
(``experiments/accuracy_parity_d4ic.py``) are read by both packages' config
readers and model factories. Each family then runs as array task 1 through
both packages' ``set_up_and_run_experiments`` at a tiny width, on one
numpy-made fold written by the port's ``save_cv_split``, from the same
weights (the port's ``init`` is patched to return the JAX init: ROADMAP
"parity by copied weights"); the artifacts load in both packages, and the
eval dispatch and GC readouts agree.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.eval import cross_alg as jcross  # noqa: E402
from redcliff_tpu.eval import gc_estimates as jge  # noqa: E402
from redcliff_tpu.eval import model_io as jio  # noqa: E402
from redcliff_tpu.models import clstm_fm as jclstm_fm  # noqa: E402
from redcliff_tpu.models import cmlp_fm as jcmlp_fm  # noqa: E402
from redcliff_tpu.models import dgcnn as jdgcnn  # noqa: E402
from redcliff_tpu.models import navar as jnavar  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu.train import orchestration as jorch  # noqa: E402
from redcliff_tpu.utils import config as jconfig  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data.shards import save_cv_split  # noqa: E402
from redcliff_tpu_torch.eval import cross_alg as tcross  # noqa: E402
from redcliff_tpu_torch.eval import gc_estimates as tge  # noqa: E402
from redcliff_tpu_torch.eval import model_io as tio  # noqa: E402
from redcliff_tpu_torch.models import clstm_fm as tclstm_fm  # noqa: E402
from redcliff_tpu_torch.models import cmlp_fm as tcmlp_fm  # noqa: E402
from redcliff_tpu_torch.models import dgcnn as tdgcnn  # noqa: E402
from redcliff_tpu_torch.models import navar as tnavar  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.runtime.checkpoint import (  # noqa: E402
    read_checkpoint, write_checkpoint)
from redcliff_tpu_torch.train import driver as tdriver  # noqa: E402
from redcliff_tpu_torch.train import orchestration as torch_orch  # noqa: E402,E501
from redcliff_tpu_torch.utils import config as tconfig  # noqa: E402

HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)
GC_TOL = dict(rtol=1e-5, atol=1e-6)
DATA_SET = "d4IC_fold0"
C, K, T = 4, 3, 10

# the published D4IC cached-args (experiments/accuracy_parity_d4ic.py)
REDCLIFF_ARGS = {
    "output_length": "1", "batch_size": "128", "max_iter": "1000",
    "lookback": "1", "check_every": "10", "verbose": "0", "num_sims": "1",
    "num_factors": "5", "num_supervised_factors": "5",
    "wavelet_level": "None", "gen_hidden": "[25]", "gen_lr": "0.0005",
    "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "gen_lag_and_input_len": "4", "FORECAST_COEFF": "10.0",
    "FACTOR_SCORE_COEFF": "100.0", "FACTOR_COS_SIM_COEFF": "1.0",
    "FACTOR_WEIGHT_L1_COEFF": "0.001", "ADJ_L1_REG_COEFF": "1.0",
    "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
    "DAGNESS_NODE_COEFF": "0.0",
    "primary_gc_est_mode": "conditional_factor_fixed_embedder",
    "forward_pass_mode": "apply_factor_weights_after_sim_completion",
    "training_mode": "pretrain_embedder_then_acclimate_factors_then_combined",
    "num_pretrain_epochs": "50", "num_acclimation_epochs": "15",
    "factor_score_embedder_type": "DGCNN", "embed_hidden_sizes": "[0]",
    "embed_num_hidden_nodes": "100", "embed_num_graph_conv_layers": "3",
    "embed_lr": "0.0002", "embed_eps": "0.0001",
    "embed_weight_decay": "0.0001", "embed_lag": "16",
    "use_sigmoid_restriction": "0", "sigmoid_eccentricity_coeff": "10.0",
    "prior_factors_path": "None", "cost_criteria": "CosineSimilarity",
    "unsupervised_start_index": "0", "max_factor_prior_batches": "10",
    "stopping_criteria_forecast_coeff": "10.",
    "stopping_criteria_factor_coeff": "100.",
    "stopping_criteria_cosSim_coeff": "1.", "deltaConEps": "0.1",
    "in_degree_coeff": "1.", "out_degree_coeff": "1.",
}
CMLP_ARGS = {
    "output_length": "1", "num_sims": "1", "embed_hidden_sizes": "[60]",
    "batch_size": "128", "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "max_iter": "1000", "lookback": "1", "check_every": "10", "verbose": "0",
    "num_factors": "1", "num_supervised_factors": "0",
    "wavelet_level": "None", "gen_hidden": "[50]", "gen_lr": "0.0005",
    "gen_lag_and_input_len": "2", "FORECAST_COEFF": "1.0",
    "FACTOR_SCORE_COEFF": "0.0", "ADJ_L1_REG_COEFF": "1.0",
    "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
    "DAGNESS_NODE_COEFF": "0.0",
}
CLSTM_ARGS = {
    "output_length": "1", "num_sims": "1", "embed_hidden_sizes": "[10]",
    "batch_size": "128", "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "max_iter": "1000", "lookback": "3", "check_every": "5", "verbose": "0",
    "num_factors": "1", "num_supervised_factors": "0",
    "wavelet_level": "None", "gen_hidden": "25", "gen_lr": "0.0005",
    "context": "2", "max_input_length": "4", "FORECAST_COEFF": "1.0",
    "FACTOR_SCORE_COEFF": "0.0", "ADJ_L1_REG_COEFF": "10.0",
    "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
    "DAGNESS_NODE_COEFF": "0.0",
}
DGCNN_ARGS = {
    "batch_size": "128", "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "max_iter": "1000", "lookback": "1", "check_every": "10", "verbose": "0",
    "num_channels": "10", "wavelet_level": "None",
    "num_wavelets_per_chan": "1", "num_features_per_node": "2",
    "num_graph_conv_layers": "1", "num_hidden_nodes": "100",
    "num_classes": "5", "signal_format": "original flattened",
    "gen_lr": "0.0001",
}
NAVAR_ARGS = {
    "num_nodes": "10", "num_hidden": "256", "maxlags": "20",
    "hidden_layers": "2", "dropout": "0", "val_proportion": "0.0",
    "epochs": "250", "batch_size": "128", "check_every": "50",
    "learning_rate": "0.0001", "weight_decay": "0",
    "split_timeseries": "0", "signal_format": "original", "lambda1": "0.0",
}
# experiments/accuracy_parity_d4ic.py DCSFA_ARGS, and the DYNOTEARS args
# of experiments/accuracy_parity_synsys.py (Vanilla) and the Stochastic
# schema
DCSFA_ARGS = {
    "batch_size": "128", "num_high_level_node_features": "5",
    "best_model_name": "dCSFA-NMF-best-model.pt", "num_node_features": "20",
    "n_components": "5", "n_sup_networks": "5",
    "signal_format": "original flattened directed_spectrum vanilla",
    "h": "256", "momentum": "0.5", "lr": "0.001", "recon_weight": "1.0",
    "sup_weight": "2.0", "sup_recon_weight": "1.0",
    "sup_smoothness_weight": "2.0", "n_epochs": "1000",
    "n_pre_epochs": "50", "nmf_max_iter": "20",
}
DYNOTEARS_ARGS = {
    "lambda_w": "0.9", "lambda_a": "0.1", "max_iter": "100",
    "h_tol": "0.00000001", "w_threshold": "0.0", "tabu_edges": "None",
    "tabu_parent_nodes": "None", "tabu_child_nodes": "None",
    "lag_size": "1", "signal_format": "original",
}
DYNOTEARS_STOCHASTIC_ARGS = dict(
    DYNOTEARS_ARGS, batch_size="32", grad_step="1.0", wa_est="None",
    rho="1.0", alpha="0.0", h_value="inf", h_new="inf", max_data_iter="10",
    iter_start="0", num_iters_prior_to_stop="10", reuse_rho="0",
    reuse_alpha="0", reuse_h_val="0", reuse_h_new="0", check_every="5")
# REDCLIFF-S with cLSTM factors: the REDCLIFF args in the cLSTM schema
# (an int LSTM width, context = gen_lag, max_input_length)
REDCLIFF_CLSTM_ARGS = dict(REDCLIFF_ARGS, gen_hidden="25", context="4",
                           max_input_length="4")
PUBLISHED = {"cMLP": CMLP_ARGS, "cLSTM": CLSTM_ARGS, "DGCNN": DGCNN_ARGS,
             "NAVAR_CMLP": NAVAR_ARGS, "NAVAR_CLSTM": NAVAR_ARGS,
             "REDCLIFF_S_CLSTM": REDCLIFF_CLSTM_ARGS}
# ... cut to a tiny width and depth (4 channels, 3 states, T = 10)
TINY = {
    "cMLP": dict(CMLP_ARGS, batch_size="16", max_iter="3", check_every="1",
                 gen_hidden="[6]", gen_lr="0.01"),
    "cLSTM": dict(CLSTM_ARGS, batch_size="16", max_iter="3",
                  check_every="1", gen_hidden="5", gen_lr="0.01"),
    "DGCNN": dict(DGCNN_ARGS, batch_size="16", max_iter="3",
                  check_every="1", num_channels=str(C), num_hidden_nodes="6",
                  num_classes=str(K), gen_lr="0.01"),
    "NAVAR_CMLP": dict(NAVAR_ARGS, num_nodes=str(C), num_hidden="8",
                       maxlags="3", epochs="3", batch_size="16",
                       check_every="1", learning_rate="0.01"),
    "NAVAR_CLSTM": dict(NAVAR_ARGS, num_nodes=str(C), num_hidden="8",
                        maxlags="3", epochs="3", batch_size="16",
                        check_every="1", learning_rate="0.01"),
    "REDCLIFF_S_CLSTM": dict(
        REDCLIFF_CLSTM_ARGS, batch_size="16", max_iter="4", check_every="1",
        num_factors=str(K), num_supervised_factors=str(K), gen_hidden="5",
        context="2", num_pretrain_epochs="1", num_acclimation_epochs="1",
        embed_num_hidden_nodes="6", embed_num_graph_conv_layers="1",
        embed_lag="4", gen_lr="0.005", embed_lr="0.005"),
}
# each family's name in the eval layer's dispatch
ALG = {"cMLP": "CMLP", "cLSTM": "CLSTM", "DGCNN": "DGCNN",
       "NAVAR_CMLP": "NAVAR_CMLP", "NAVAR_CLSTM": "NAVAR_CLSTM",
       "REDCLIFF_S_CLSTM": "REDCLIFF_S_CLSTM"}
_JAX_OF = {
    tcmlp_fm.CMLPFM: (jcmlp_fm.CMLPFM, jcmlp_fm.CMLPFMConfig),
    tclstm_fm.CLSTMFM: (jclstm_fm.CLSTMFM, jclstm_fm.CLSTMFMConfig),
    tnavar.NAVAR: (jnavar.NAVAR, jnavar.NAVARConfig),
    tnavar.NAVARLSTM: (jnavar.NAVARLSTM, jnavar.NAVARLSTMConfig),
    tdgcnn.DGCNNModel: (jdgcnn.DGCNNModel, jdgcnn.DGCNNConfig),
    tred.RedcliffSCMLP: (jred.RedcliffSCMLP, jred.RedcliffSCMLPConfig),
}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _jax_model(tm):
    cls, cfg_cls = _JAX_OF[type(tm)]
    return cls(cfg_cls(**dataclasses.asdict(tm.config)))


def _copy_jax_init(mp):
    """The port's ``init`` returns the JAX init for the same config (both
    dispatches seed with 0)."""
    def init(self, generator, device="cpu"):
        jp = _jax_model(self).init(jax.random.PRNGKey(0))
        return interop.params_from_jax(jax.tree.map(np.asarray, jp), device)
    for cls in _JAX_OF:
        mp.setattr(cls, "init", init)


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    """One fold of K-state sparse VAR(1) recordings (T steps, C channels)
    with one-hot state labels (n, K, 1), and its data cached-args file."""
    base = tmp_path_factory.mktemp("fold")
    rng = np.random.default_rng(0)
    A = [(rng.random((C, C)) < 0.3) * rng.normal(0, 0.4, (C, C))
         + 0.3 * np.eye(C) for _ in range(K)]
    n = 56
    states = rng.integers(0, K, n)
    X = np.zeros((n, T, C))
    for t in range(1, T):
        X[:, t] = np.einsum("nij,nj->ni", np.stack(A)[states], X[:, t - 1]) \
            + rng.normal(size=(n, C))
    Y = np.eye(K, dtype=np.float32)[states][:, :, None]
    pairs = [[x.astype(np.float32), y] for x, y in zip(X, Y)]
    save_cv_split(pairs[:40], pairs[40:], 0, str(base / "data"))
    dargs = str(base / f"{DATA_SET}_data_cached_args.txt")
    graphs = [(a != 0).astype(float)[:, :, None] for a in A]
    with open(dargs, "w") as f:
        json.dump({"data_root_path": str(base / "data" / "fold_0"),
                   "num_channels": str(C),
                   **{f"net{k + 1}_adjacency_tensor":
                      tconfig.serialize_tensor_to_string(g)
                      for k, g in enumerate(graphs)}}, f)
    return {"base": base, "dargs": dargs, "X": X.astype(np.float32)}


def _model_args(path, model_type, args):
    fname = os.path.join(path, f"{model_type}_d4IC_cached_args.txt")
    with open(fname, "w") as f:
        json.dump(args, f)
    return fname


@pytest.mark.parametrize("model_type", list(PUBLISHED))
def test_published_args_readers_and_factory_match_jax(model_type, fold):
    """The published cached-args of each family through both packages'
    readers (model and data), the driver's rescaling and the factory: the
    same args and the same model config."""
    margs = _model_args(fold["base"], model_type, PUBLISHED[model_type])
    base = {"model_type": model_type, "model_cached_args_file": margs,
            "data_cached_args_file": fold["dargs"]}
    want = jconfig.read_in_data_args(jconfig.read_in_model_args(dict(base)))
    got = tconfig.read_in_data_args(tconfig.read_in_model_args(dict(base)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k in ("true_GC_factors", "true_GC_tensor"):
            for a, b in zip(v, got[k]):
                np.testing.assert_array_equal(b, a)
        else:
            assert got[k] == v, k
    if "REDCLIFF" in model_type:
        tdriver.rescale_dataset_dependent_coefficients(got)
        jdriver.rescale_dataset_dependent_coefficients(want)
    want["num_channels"] = got["num_channels"] = 10  # the published width
    jm = jorch.create_model_instance(want)
    tm = torch_orch.create_model_instance(got)
    assert type(tm).__name__ == type(jm).__name__
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)


def test_unported_families_raise_citing_the_roadmap(fold, tmp_path):
    """DCSFA-NMF and DYNOTEARS (which raised until their models were
    ported): their cached-args schemas and the factory agree with JAX, and
    a JAX-written DcsfaNmf artifact loads as ``(model, params, state)``
    with its weights and BatchNorm state as written. The unpublished
    REDCLIFF_S_DGCNN and an unknown family raise as in JAX."""
    from redcliff_tpu.models import dcsfa_nmf as jdc

    for mt, args in (("DCSFANMF", DCSFA_ARGS),
                     ("DYNOTEARS_Vanilla", DYNOTEARS_ARGS),
                     ("DYNOTEARS_Stochastic", DYNOTEARS_STOCHASTIC_ARGS)):
        margs = _model_args(tmp_path, mt, args)
        base = {"model_type": mt, "model_cached_args_file": margs,
                "data_cached_args_file": fold["dargs"]}
        want = jconfig.read_in_data_args(
            jconfig.read_in_model_args(dict(base)))
        got = tconfig.read_in_data_args(
            tconfig.read_in_model_args(dict(base)))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k not in ("true_GC_factors", "true_GC_tensor"):
                assert got[k] == v, k
        jm = jorch.create_model_instance(want)
        tm = torch_orch.create_model_instance(got)
        assert type(tm).__name__ == type(jm).__name__
        assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    with pytest.raises(NotImplementedError, match="never"):
        torch_orch.create_model_instance({"model_type": "REDCLIFF_S_DGCNN"})
    with pytest.raises(ValueError, match="UNRECOGNIZED"):
        torch_orch.create_model_instance({"model_type": "MYSTERY"})
    jm = jdc.DcsfaNmf(jdc.DcsfaNmfConfig(n_components=K, n_sup_networks=2,
                                         h=6))
    jp, js = jm.init(jax.random.PRNGKey(3), 12)
    write_checkpoint(str(tmp_path / "final_best_model.bin"),
                     jm._artifact_payload(jp, js))
    tm, tp, ts = tio.load_model_for_eval(str(tmp_path), device="cpu")
    assert type(tm).__name__ == "DcsfaNmf"
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    for got, want in ((tp, jp), (ts, js)):
        got, want = _flat(interop.params_to_jax(got)), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("model_type", list(TINY))
def test_array_task_matches_jax(model_type, fold, tmp_path, monkeypatch):
    """Array task 1 of each family end to end in both packages from the
    same weights: the same run folder, histories and best epoch, best
    params within the multi-epoch bar; each artifact loads in both
    packages, and the eval dispatch, GC estimates and score estimates of
    the port's model equal the JAX package's on the same artifact."""
    _copy_jax_init(monkeypatch)
    margs = _model_args(tmp_path, model_type, TINY[model_type])
    runs = {}
    for name, pkg, extra in (("jax", jdriver, {}),
                             ("port", tdriver, {"device": "cpu"})):
        root = tmp_path / name
        os.makedirs(root)
        assert pkg.set_up_and_run_experiments(
            {"save_root_path": str(root)}, [margs], [fold["dargs"]],
            [model_type], [DATA_SET], task_id=1, **extra) == 1
        (run,) = os.listdir(root)
        runs[name] = root / run
    assert runs["jax"].name == runs["port"].name
    jmeta = read_checkpoint(str(runs["jax"] / "training_meta_data_and_"
                                              "hyper_parameters.pkl"))
    tmeta = read_checkpoint(str(runs["port"] / "training_meta_data_and_"
                                               "hyper_parameters.pkl"))
    assert tmeta["best_it"] == jmeta["best_it"]
    assert tmeta["epoch"] == jmeta["epoch"]
    # the task's per-epoch log of steps and skips, in its checkpoint
    log = read_checkpoint(str(runs["port"] / "trainer_checkpoint.pkl"))[
        "epoch_log"]
    assert [e["epoch"] for e in log] == list(range(tmeta["epoch"] + 1))
    assert all(e["skipped"] == 0 for e in log)
    for k in ("avg_combo_loss", "avg_forecasting_loss"):
        np.testing.assert_allclose(tmeta[k], jmeta[k], err_msg=k, **HIST)

    # both artifacts load in both packages; the best params agree
    tm, tp = tio.load_model_for_eval(str(runs["port"]), device="cpu")
    jm, jp = jio.load_model_for_eval(str(runs["jax"]))[:2]
    tm2, tp2 = tio.load_model_for_eval(str(runs["jax"]), device="cpu")
    jm2, jp2 = jio.load_model_for_eval(str(runs["port"]))[:2]
    for a, b in ((tm, jm), (tm2, jm2), (tm, tm2)):
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    got, want = _flat(interop.params_to_jax(tp)), _flat(jp)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **PARAMS)
        np.testing.assert_array_equal(_flat(jp2)[k], got[k])

    # the eval layer on the JAX artifact: components, GC and score
    # estimates equal on the same weights
    margs_dict = {"model_type": model_type, "model_cached_args_file": margs,
                  "data_cached_args_file": fold["dargs"]}
    jargs = jconfig.read_in_data_args(jconfig.read_in_model_args(
        dict(margs_dict)))
    targs = tconfig.read_in_data_args(tconfig.read_in_model_args(
        dict(margs_dict)))
    _, jval = jorch.get_data_for_model_training(jargs)
    _, tval = torch_orch.get_data_for_model_training(targs)
    jev = jorch.call_model_eval_method(jm, jp, jargs, jval)
    tev = torch_orch.call_model_eval_method(tm2, tp2, targs, tval)
    assert sorted(tev) == sorted(jev)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tev["components"], jev["components"], **tol)
    X = fold["X"][:8]
    if "REDCLIFF" in model_type:
        X = X[:, : tm2.config.max_lag]
    got = tge.get_model_gc_estimates(tm2, tp2, ALG[model_type], K, X=X)
    want = jge.get_model_gc_estimates(jm, jp, ALG[model_type], K, X=X)
    assert len(got) == len(want) == K
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GC_TOL)
    Xs = X[:1]
    np.testing.assert_allclose(
        tge.get_model_gc_score_estimates(tm2, tp2, ALG[model_type], K, X=Xs),
        jge.get_model_gc_score_estimates(jm, jp, ALG[model_type], K, X=Xs),
        **tol)
    # the cross-algorithm scoring of the run against the fold's truths
    truth = tconfig.load_true_gc_factors(fold["dargs"])
    got = tcross.evaluate_algorithm_on_fold(str(runs["jax"]), ALG[model_type],
                                            truth, X=X, device="cpu")
    want = jcross.evaluate_algorithm_on_fold(str(runs["jax"]),
                                             ALG[model_type], truth, X=X)
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].astype(float), v.astype(float),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("family", ["cmlp_fm", "redcliff_clstm"])
def test_signal_generation_matches_jax(family):
    """``generate_signal_from_sequential_factor_model``: the autoregressive
    rollout of a factor model, on copied weights."""
    if family == "cmlp_fm":
        tm = tcmlp_fm.CMLPFM(tcmlp_fm.CMLPFMConfig(
            num_chans=C, gen_lag=2, gen_hidden=(6,), input_length=3))
        x0 = np.random.default_rng(1).normal(size=(2, 3, C))
    else:
        tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(
            num_chans=C, gen_lag=2, gen_hidden=(5,), embed_lag=3,
            embed_hidden_sizes=(6,), num_factors=K,
            num_supervised_factors=K, factor_score_embedder_type="cEmbedder",
            factor_network_type="cLSTM", training_mode="combined"))
        x0 = np.random.default_rng(1).normal(size=(2, 3, C))
    jm = _jax_model(tm)
    jp = jm.init(jax.random.PRNGKey(2))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    x0 = x0.astype(np.float32)
    got = torch_orch.generate_signal_from_sequential_factor_model(
        tm, tp, x0, 5)
    want = jorch.generate_signal_from_sequential_factor_model(jm, jp, x0, 5)
    assert tuple(got.shape) == (2, 5, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
