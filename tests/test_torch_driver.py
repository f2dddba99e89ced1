"""The port's array-task driver (redcliff_tpu_torch/train/{driver,
orchestration}.py, utils/config.py, data/shards.py) against the JAX
package's.

A fold of the synthetic sVAR benchmark written by the JAX package's
``data/curation`` (4 channels, 2 factors, Oracle labels) and a
``REDCLIFF_S_CMLP`` cached-args file with the published D4IC settings
(``experiments/accuracy_parity_d4ic.py:70-97``) cut to a tiny width. Both
packages' ``set_up_and_run_experiments`` run task 1 from the same weights:
the port's ``init`` is patched to return the JAX init (ROADMAP "parity by
copied weights"). One JAX array task in all (module fixture).
"""
import dataclasses
import json
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.data import shards as jshards  # noqa: E402
from redcliff_tpu.data.curation import curate_synthetic_fold  # noqa: E402
from redcliff_tpu.eval import model_io as jio  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu.train import orchestration as jorch  # noqa: E402
from redcliff_tpu.utils import config as jconfig  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data import shards as tshards  # noqa: E402
from redcliff_tpu_torch.eval import model_io as tio  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.train import driver as tdriver  # noqa: E402
from redcliff_tpu_torch.train import orchestration as torch_orch  # noqa: E402,E501
from redcliff_tpu_torch.utils import config as tconfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TYPE = "REDCLIFF_S_CMLP"
DATA_SET = "data_fold0"
# a multi-epoch fit through the loss and two Adams in both frameworks
# (ROADMAP tolerances); GC readouts of one artifact at the forward bar
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)
GC_TOL = dict(rtol=1e-5, atol=1e-6)

# the reference's REDCLIFF_S_CMLP_d4IC_BSCgs1_cached_args.txt
# (experiments/accuracy_parity_d4ic.py:70-97) ...
# experiments/accuracy_parity_d4ic.py DCSFA_ARGS and
# experiments/accuracy_parity_synsys.py DYNOTEARS_ARGS
DCSFA_PUBLISHED = {
    "batch_size": "128", "num_high_level_node_features": "5",
    "best_model_name": "dCSFA-NMF-best-model.pt", "num_node_features": "20",
    "n_components": "5", "n_sup_networks": "5",
    "signal_format": "original flattened directed_spectrum vanilla",
    "h": "256", "momentum": "0.5", "lr": "0.001", "recon_weight": "1.0",
    "sup_weight": "2.0", "sup_recon_weight": "1.0",
    "sup_smoothness_weight": "2.0", "n_epochs": "1000",
    "n_pre_epochs": "50", "nmf_max_iter": "20",
}
DYNOTEARS_PUBLISHED = {
    "lambda_w": "0.9", "lambda_a": "0.1", "max_iter": "100",
    "h_tol": "0.00000001", "w_threshold": "0.0", "tabu_edges": "None",
    "tabu_parent_nodes": "None", "tabu_child_nodes": "None",
    "lag_size": "1", "signal_format": "original",
}
PUBLISHED = {
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
# ... cut to a tiny width and depth, the learning rates raised so four
# epochs move the weights
TINY = dict(PUBLISHED, batch_size="8", max_iter="4", check_every="1",
            num_factors="2", num_supervised_factors="2", gen_hidden="[8]",
            gen_lag_and_input_len="2", num_pretrain_epochs="1",
            num_acclimation_epochs="1", embed_num_hidden_nodes="8",
            embed_num_graph_conv_layers="1", embed_lag="4", gen_lr="0.005",
            embed_lr="0.005")


def _write_model_args(path, args=TINY):
    with open(path, "w") as f:
        json.dump(args, f)


def _jax_init(config):
    """The JAX package's init for a port config, as numpy."""
    jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(
        **dataclasses.asdict(config)))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _copy_jax_init(mp):
    """Make the port's ``init`` return the JAX init (ROADMAP "parity by
    copied weights"): ``call_model_fit_method`` seeds both with 0."""
    def init(self, generator, device="cpu"):
        return interop.params_from_jax(_jax_init(self.config), device)
    mp.setattr(tred.RedcliffSCMLP, "init", init)


def _run(pkg, root, margs, dargs, **kw):
    os.makedirs(root, exist_ok=True)
    return pkg.set_up_and_run_experiments(
        {"save_root_path": str(root)}, [str(margs)], [dargs], [MODEL_TYPE],
        [DATA_SET], task_id=1, **kw)


def _only_run_dir(root):
    runs = os.listdir(root)
    assert len(runs) == 1, runs
    return os.path.join(root, runs[0])


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    base = tmp_path_factory.mktemp("driver")
    fold_dir, _ = curate_synthetic_fold(
        str(base / "data"), fold_id=0, num_nodes=4, num_factors=2,
        num_supervised_factors=2, num_samples_in_train_set=24,
        num_samples_in_val_set=12, sample_recording_len=10,
        folder_name="toySys")
    margs = base / f"{MODEL_TYPE}_toy_cached_args.txt"
    _write_model_args(str(margs))
    return dict(base=base, fold_dir=fold_dir, margs=margs,
                dargs=os.path.join(fold_dir, "data_fold0_cached_args.txt"))


@pytest.fixture(scope="module")
def array_task(fold):
    """Task 1 through both packages from the same weights."""
    base = fold["base"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REDCLIFF_QUALITY", "0")
        _run(jdriver, base / "jax_runs", fold["margs"], fold["dargs"])
        _copy_jax_init(mp)
        assert _run(tdriver, base / "port_runs", fold["margs"],
                    fold["dargs"], device="cpu") == 1
    return dict(jdir=_only_run_dir(base / "jax_runs"),
                tdir=_only_run_dir(base / "port_runs"))


def _load_pickle(path):
    from redcliff_tpu.runtime.checkpoint import read_checkpoint
    return read_checkpoint(path)


def test_array_task_matches_jax_array_task(array_task):
    """The same run folder name, the same best epoch, validation history
    and best params at the trajectory bar."""
    jdir, tdir = array_task["jdir"], array_task["tdir"]
    assert os.path.basename(tdir) == os.path.basename(jdir)
    assert os.path.basename(tdir).startswith(f"{MODEL_TYPE}_{DATA_SET}")
    meta = "training_meta_data_and_hyper_parameters.pkl"
    jm, tm = (_load_pickle(os.path.join(d, meta)) for d in (jdir, tdir))
    assert tm["best_it"] == jm["best_it"]
    np.testing.assert_allclose(tm["avg_combo_loss"], jm["avg_combo_loss"],
                               **HIST)
    ja, ta = (_load_pickle(os.path.join(d, "final_best_model.bin"))
              for d in (jdir, tdir))
    assert dataclasses.asdict(ta["config"]) \
        == dataclasses.asdict(ja["config"])
    for a, b in zip(jax.tree.leaves(ja["params"]),
                    jax.tree.leaves(ta["params"])):
        np.testing.assert_allclose(b, a, **PARAMS)


def test_port_artifact_loads_in_jax_with_the_same_gc(array_task, fold):
    """The port's final_best_model.bin loads through the JAX
    ``load_model_for_eval``; its GC readouts match the port's."""
    tdir = array_task["tdir"]
    jmodel, jparams = jio.load_model_for_eval(tdir)
    tmodel, tparams = tio.load_model_for_eval(tdir, device="cpu")
    assert dataclasses.asdict(tmodel.config) \
        == dataclasses.asdict(jmodel.config)
    ds = tshards.load_normalized_split_datasets(fold["fold_dir"])[1]
    X = ds.X[:6, : tmodel.config.embed_lag]
    for ignore_lag in (True, False):
        want = np.asarray(jmodel.gc(jparams, X=X, ignore_lag=ignore_lag))
        with torch.no_grad():
            got = tmodel.gc(tparams, X=torch.from_numpy(X),
                            ignore_lag=ignore_lag).numpy()
        np.testing.assert_allclose(got, want, **GC_TOL)


def test_array_task_resumes_and_cleans_a_stale_folder(array_task, fold):
    """A rerun finds final_best_model.bin and resumes: nothing is trained
    again and the artifact keeps its params. Without the artifact the
    folder is stale: cleaned out, and the fit reruns to the same result."""
    tdir = array_task["tdir"]
    art = os.path.join(tdir, "final_best_model.bin")
    before = _load_pickle(art)["params"]
    root = os.path.dirname(tdir)
    with pytest.MonkeyPatch.context() as mp:
        _copy_jax_init(mp)
        _run(tdriver, root, fold["margs"], fold["dargs"], device="cpu")
        for a, b in zip(jax.tree.leaves(before),
                        jax.tree.leaves(_load_pickle(art)["params"])):
            np.testing.assert_array_equal(a, b)
        os.remove(art)
        stale = os.path.join(tdir, "stale.txt")
        with open(stale, "w") as f:
            f.write("left by an earlier attempt")
        _run(tdriver, root, fold["margs"], fold["dargs"], device="cpu")
    assert not os.path.exists(stale)
    for a, b in zip(jax.tree.leaves(before),
                    jax.tree.leaves(_load_pickle(art)["params"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("task_id,seed", [(1, 0), (2, 0), (4, 0), (3, 7)])
def test_task_pick_matches_jax(monkeypatch, tmp_path, task_id, seed):
    """The shuffled cartesian product and the SLURM_ARRAY_TASK_ID pick:
    both packages hand the same args (model, dataset, files, rescaled
    coefficients) to the run."""
    sets = [f"d4IC_fold{i}" for i in range(4)]
    margs = str(tmp_path / f"{MODEL_TYPE}_cached_args.txt")
    _write_model_args(margs)
    dargs = []
    for s in sets:
        dargs.append(str(tmp_path / f"{s}_data_cached_args.txt"))
        with open(dargs[-1], "w") as f:
            json.dump({"data_root_path": str(tmp_path / s),
                       "num_channels": "4"}, f)
    picked = {}
    for name, pkg in (("jax", jdriver), ("port", tdriver)):
        monkeypatch.setattr(pkg, "kick_off_model_training_experiment",
                            lambda args, _n=name, **kw: picked.__setitem__(
                                _n, args))
    monkeypatch.setenv("SLURM_ARRAY_TASK_ID", str(task_id))
    for pkg in (jdriver, tdriver):
        assert pkg.set_up_and_run_experiments(
            {}, [margs], dargs, [MODEL_TYPE], sets,
            shuffle_seed=seed) == task_id
    combos = [(MODEL_TYPE, s) for s in sets]
    random.Random(seed).shuffle(combos)
    j, t = picked["jax"], picked["port"]
    assert (t["model_type"], t["data_set_name"]) == combos[task_id - 1]
    assert t == j


def test_config_readers_and_factory_match_jax(fold):
    """The REDCLIFF cMLP cached-args schema (published and tiny), the data
    cached-args with its true graphs, and the model factory, smoothing
    variant included; the published DCSFA-NMF and DYNOTEARS schemas and
    models; the unpublished REDCLIFF_S_DGCNN raises as in JAX."""
    for margs in (PUBLISHED, TINY):
        path = os.path.join(fold["base"], "published_cached_args.txt")
        _write_model_args(path, margs)
        for mt in (MODEL_TYPE, "REDCLIFF_S_CMLP_WithSmoothing"):
            base = {"model_type": mt, "model_cached_args_file": path,
                    "data_cached_args_file": fold["dargs"]}
            want = jconfig.read_in_data_args(
                jconfig.read_in_model_args(dict(base)))
            got = tconfig.read_in_data_args(
                tconfig.read_in_model_args(dict(base)))
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                if k == "true_GC_factors" or k == "true_GC_tensor":
                    for a, b in zip(v, got[k]):
                        np.testing.assert_array_equal(b, a)
                else:
                    assert got[k] == v, k
            tdriver.rescale_dataset_dependent_coefficients(got)
            jdriver.rescale_dataset_dependent_coefficients(want)
            smooth = "Smoothing" in mt
            jm = jorch.create_model_instance(want, smooth)
            tm = torch_orch.create_model_instance(got, smooth)
            assert dataclasses.asdict(tm.config) \
                == dataclasses.asdict(jm.config)
    t = np.random.default_rng(2).normal(size=(4, 4, 3))
    assert tconfig.serialize_tensor_to_string(t) \
        == jconfig.serialize_tensor_to_string(t)
    np.testing.assert_array_equal(tconfig.parse_tensor_string_representation(
        tconfig.serialize_tensor_to_string(t))[:, :, ::-1], t)
    # the published DCSFA-NMF and DYNOTEARS cached-args read and build
    # alike in both packages
    for mt, margs in (("DCSFANMF", DCSFA_PUBLISHED),
                      ("DYNOTEARS_Vanilla", DYNOTEARS_PUBLISHED)):
        path = os.path.join(fold["base"], f"{mt}_cached_args.txt")
        _write_model_args(path, margs)
        base = {"model_type": mt, "model_cached_args_file": path,
                "data_cached_args_file": fold["dargs"]}
        want = jconfig.read_in_data_args(
            jconfig.read_in_model_args(dict(base)))
        got_ = tconfig.read_in_data_args(
            tconfig.read_in_model_args(dict(base)))
        assert sorted(got_) == sorted(want)
        for k, v in want.items():
            if k not in ("true_GC_factors", "true_GC_tensor"):
                assert got_[k] == v, k
        jm = jorch.create_model_instance(want)
        tm = torch_orch.create_model_instance(got_)
        assert type(tm).__name__ == type(jm).__name__
        assert dataclasses.asdict(tm.config) \
            == dataclasses.asdict(jm.config)
    with pytest.raises(NotImplementedError):
        torch_orch.create_model_instance(dict(got,
                                              model_type="REDCLIFF_S_DGCNN"))
    with pytest.raises(NotImplementedError) as e:
        jorch.create_model_instance(dict(want, model_type="REDCLIFF_S_DGCNN"))
    with pytest.raises(NotImplementedError) as t:
        torch_orch.create_model_instance(dict(got,
                                              model_type="REDCLIFF_S_DGCNN"))
    assert str(t.value) == str(e.value)


def test_shards_round_trip_matches_jax(fold, tmp_path):
    """A fold the port's save_cv_split writes loads identically through
    both packages, and so does the JAX-curated fold, in the original and
    a feature format; with ``device`` the resident copies are placed."""
    rng = np.random.default_rng(4)
    pairs = lambda n: [[rng.normal(size=(1, 7, 3)).astype(np.float32),  # noqa
                        np.eye(2, dtype=np.float32)[i % 2][:, None]]
                       for i in range(n)]
    tshards.save_cv_split(pairs(10), pairs(5), 0, str(tmp_path))
    for root in (str(tmp_path / "fold_0"), fold["fold_dir"]):
        for kw in (dict(), dict(shuffle=False, grid_search=False)):
            want = jshards.load_normalized_split_datasets(root, **kw)
            got = tshards.load_normalized_split_datasets(root, device="cpu",
                                                         **kw)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.X, w.X)
                np.testing.assert_array_equal(g.Y, w.Y)
                assert "cpu" in g._dev
    split = os.path.join(fold["fold_dir"], "train")
    np.testing.assert_array_equal(
        tshards.load_normalized_samples(split).X,
        jshards.load_normalized_samples(split).X)
    with open(os.path.join(tmp_path, "fold_0", "train", "subset_0.pkl"),
              "rb") as f:
        assert len(pickle.load(f)) == 10
    # a feature format loads as in JAX (tests/test_torch_features.py holds
    # every format)
    kw = dict(signal_format="flattened", max_num_features_per_series=5)
    want = jshards.load_normalized_split_datasets(str(tmp_path / "fold_0"),
                                                  **kw)
    got = tshards.load_normalized_split_datasets(str(tmp_path / "fold_0"),
                                                 device="cpu", **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.X_features, w.X_features)
        np.testing.assert_array_equal(g.device_features.numpy(),
                                      w.X_features)


def test_port_driver_loads_no_jax(tmp_path):
    """The array task through the port's own save_cv_split and driver
    loads no jax and no module of the JAX package, and writes its
    artifact."""
    code = f"""
import json, os, sys
import numpy as np
from redcliff_tpu_torch.data.shards import save_cv_split
from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
from redcliff_tpu_torch.utils.config import serialize_tensor_to_string
root = {str(tmp_path)!r}
rng = np.random.default_rng(0)
pairs = lambda n: [[rng.normal(size=(10, 4)).astype(np.float32),
                    np.eye(2, dtype=np.float32)[i % 2][:, None]]
                   for i in range(n)]
save_cv_split(pairs(24), pairs(12), 0, os.path.join(root, "data"))
graphs = {{f"net{{k + 1}}_adjacency_tensor": serialize_tensor_to_string(
    (rng.random((4, 4, 2)) < 0.3).astype(float)) for k in range(2)}}
with open(os.path.join(root, "toy_fold0_cached_args.txt"), "w") as f:
    json.dump({{"data_root_path": os.path.join(root, "data", "fold_0"),
               "num_channels": "4", **graphs}}, f)
with open(os.path.join(root, "{MODEL_TYPE}_cached_args.txt"), "w") as f:
    json.dump({TINY!r}, f)
os.makedirs(os.path.join(root, "runs"))
set_up_and_run_experiments(
    {{"save_root_path": os.path.join(root, "runs")}},
    [os.path.join(root, "{MODEL_TYPE}_cached_args.txt")],
    [os.path.join(root, "toy_fold0_cached_args.txt")], ["{MODEL_TYPE}"],
    ["toy_fold0"], task_id=1, device="cpu")
run, = os.listdir(os.path.join(root, "runs"))
assert os.path.exists(os.path.join(root, "runs", run,
                                   "final_best_model.bin"))
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "redcliff_tpu" or m.startswith("redcliff_tpu."))
print("LEAKED", leaked)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout
