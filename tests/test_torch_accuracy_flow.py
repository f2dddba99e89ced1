"""The paper's accuracy flows in the port: the twins
``redcliff_tpu_torch/experiments/accuracy_parity_{synsys,d4ic}.py`` of the
JAX package's ``experiments/`` scripts, and the artifact lookup their eval
reads (``eval/model_io.py:load_artifact``).

The twins run end to end on the CPU at a tiny size: a port-curated fold
(bit-identical to the JAX package's, tests/test_torch_data.py) through the
port's array tasks (a tiny REDCLIFF-S and a tiny cMLP), the cross-algorithm
comparison and the dynamic readouts, to finite optimal F1s in a JSON written
into the work directory. Their transcribed cached-args are held to the JAX
scripts' by parsing those files (importing them would pin JAX's platform
process-wide). The lone-artifact fallback of ``load_artifact`` is held to
JAX's, and the one deliberate difference, ``.prev``/``.bad`` names never
being candidates in the port, is pinned.
"""
import ast
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.data import synthetic as JS  # noqa: E402
from redcliff_tpu.eval import model_io as jio  # noqa: E402
from redcliff_tpu.models.cmlp_fm import CMLPFM, CMLPFMConfig  # noqa: E402
from redcliff_tpu.train.trainer import save_model  # noqa: E402
from redcliff_tpu_torch.eval import model_io as tio  # noqa: E402
from redcliff_tpu_torch.experiments import accuracy_parity_d4ic as TD  # noqa: E402,E501
from redcliff_tpu_torch.experiments import accuracy_parity_synsys as TSYN  # noqa: E402,E501
from redcliff_tpu_torch.interop import tree_leaves  # noqa: E402
from redcliff_tpu_torch.utils.config import load_true_gc_factors  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the published cached-args cut to a tiny width and depth for the CPU
TINY_REDCLIFF = dict(
    TSYN.REDCLIFF_ARGS, gen_hidden="[4]", batch_size="8", max_iter="3",
    num_pretrain_epochs="1", num_acclimation_epochs="1", check_every="1",
    embed_num_hidden_nodes="8", embed_num_graph_conv_layers="1")
TINY_CMLP = dict(TSYN.CMLP_ARGS, gen_hidden="[4]", batch_size="8",
                 max_iter="2", check_every="1")
TINY_DCSFA = dict(TSYN.DCSFA_ARGS, h="8", batch_size="8", n_epochs="2",
                  n_pre_epochs="1", nmf_max_iter="2")


@pytest.fixture(autouse=True)
def _restore_global_rngs():
    """Curation runs the graph factory, which seeds ``random`` and
    ``np.random`` globally: leave both as they were."""
    import random

    py_state, np_state = random.getstate(), np.random.get_state()
    yield
    random.setstate(py_state)
    np.random.set_state(np_state)


def _literal_dicts(path):
    """The module-level dict literals of a script, by name."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Dict)):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def test_twins_transcribe_the_jax_scripts_cached_args():
    for name, twin in (("accuracy_parity_synsys", TSYN),
                       ("accuracy_parity_d4ic", TD)):
        jax_dicts = _literal_dicts(os.path.join(REPO, "experiments",
                                                f"{name}.py"))
        assert jax_dicts
        for key, value in jax_dicts.items():
            assert getattr(twin, key) == value, (name, key)
    assert [m[0] for m in TSYN.MODELS] == [
        "REDCLIFF_S_CMLP", "cMLP", "cLSTM", "DGCNN", "DCSFANMF",
        "NAVAR_CMLP", "DYNOTEARS_Vanilla"]
    assert TD.NAVAR_ARGS == dict(TSYN.NAVAR_ARGS, num_nodes="10",
                                 epochs="250", check_every="50")
    assert TD.SMOOTH_ARGS["gen_hidden"] == "[100]"
    assert TSYN.SAMPLES == {False: (1040, 240), True: (240, 96)}
    assert TD.SAMPLES == {False: (120, 30), True: (24, 8)}


def _check_flow(out, workdir, algs):
    assert set(out["algorithms"]) == set(algs)
    for alg, stats in out["algorithms"].items():
        assert math.isfinite(stats["offdiag_optimal_f1_mean"]), alg
        assert 0.0 <= stats["offdiag_optimal_f1_mean"] <= 1.0
    for root, _, files in os.walk(workdir):
        assert not [f for f in files if f.endswith((".png", ".pdf"))], root


def test_synsys_twin_runs_end_to_end_on_cpu(tmp_path, monkeypatch):
    """The published flow (no --smoke: plotting asked for, and skipped, as
    on the card's machine without matplotlib) at a tiny size: a curated
    fold equal to JAX's, a tiny REDCLIFF-S, cMLP and DCSFA-NMF array task,
    the cross-algorithm battery and the dynamic readouts (over a DCSFA
    artifact, which loads as a triple: ROADMAP queue 3 item 12); the JSON
    lands in the work directory and every artifact loads back."""
    monkeypatch.setattr(TSYN, "SAMPLES", {False: (24, 12), True: (24, 12)})
    monkeypatch.setattr(TSYN, "MODELS", (
        ("REDCLIFF_S_CMLP", TINY_REDCLIFF, "REDCLIFF_S_CMLP"),
        ("cMLP", TINY_CMLP, "CMLP"), ("DCSFANMF", TINY_DCSFA, "DCSFA")))
    wd = str(tmp_path / "synsys")
    out = TSYN.main([wd, "--folds", "1", "--dynamic"], device="cpu")
    with open(os.path.join(wd, "ACCURACY_SYNSYS_6_2_2.json")) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    _check_flow(out, wd, ["REDCLIFF_S_CMLP", "CMLP", "DCSFA"])
    assert out["train_samples_per_fold"] == 24 and out["folds"] == 1
    assert set(out["wall_s"]["train_s"]) == {"REDCLIFF_S_CMLP", "CMLP",
                                             "DCSFA"}
    assert out["dynamic_readouts"]["DCSFA"]["dynamic_optimal_f1"]["n"] == 12
    dyn = out["dynamic_readouts"]["REDCLIFF_S_CMLP"]
    assert dyn["dynamic_optimal_f1"]["n"] == 12
    assert math.isfinite(dyn["dynamic_optimal_f1"]["mean"])
    # the fold's truth is the JAX package's graph factory at fold_id * 333
    p = JS.reference_curation_params(6)
    jgraphs, _, _ = JS.generate_lagged_adjacency_graphs_for_factor_model(
        num_nodes=6, num_lags=2, num_factors=2, make_factors_orthogonal=True,
        make_factors_singular_components=False, rand_seed=0,
        off_diag_edge_strengths=p["off_diag_edge_strengths"],
        diag_receiving_node_forgetting_coeffs=
            p["diag_receiving_node_forgetting_coeffs"],
        diag_sending_node_forgetting_coeffs=
            p["diag_sending_node_forgetting_coeffs"], num_edges_per_graph=2)
    truth = load_true_gc_factors(os.path.join(
        wd, "data", "synSys6_2_2", "fold_0", "data_fold0_cached_args.txt"))
    for a, b in zip(jgraphs, truth):
        np.testing.assert_array_equal(a, b)
    for alias in ("REDCLIFF_S_CMLP", "CMLP", "DCSFA"):
        root = os.path.join(wd, "runs", f"{alias}_models")
        (run,) = os.listdir(root)
        payload = tio.load_artifact(os.path.join(root, run))
        assert all(np.isfinite(np.asarray(x)).all()
                   for x in tree_leaves(payload["params"]))
    # --eval-only rescoring the same runs gives the same table
    again = TSYN.main([wd, "--folds", "1", "--eval-only"], device="cpu")
    assert again["algorithms"] == out["algorithms"]


def test_d4ic_twin_runs_end_to_end_on_cpu(tmp_path, monkeypatch):
    """The D4IC flow at a tiny size: five networks from the host factory
    (graphs equal to JAX's) with recordings from the device generator on
    the CPU, the D4IC mixture, a tiny cMLP array task and the battery."""
    monkeypatch.setattr(TD, "SAMPLES", {False: (6, 3), True: (6, 3)})
    monkeypatch.setattr(TD, "MODELS", (("cMLP", TINY_CMLP, "CMLP"),))
    wd = str(tmp_path / "d4ic")
    out = TD.main([wd, "--folds", "1"], device="cpu")
    assert os.path.isfile(os.path.join(wd, "ACCURACY_D4IC_HSNR.json"))
    _check_flow(out, wd, ["CMLP"])
    assert out["train_samples_per_fold"] == 30
    truth = load_true_gc_factors(os.path.join(
        wd, "data", "d4ic_HSNR", "fold_0", "data_fold0_cached_args.txt"))
    p = JS.reference_curation_params(10)
    for net_id, got in enumerate(truth):
        (jg,), _, _ = JS.generate_lagged_adjacency_graphs_for_factor_model(
            num_nodes=10, num_lags=2, num_factors=1,
            make_factors_orthogonal=False,
            make_factors_singular_components=False, rand_seed=17 * net_id + 1,
            off_diag_edge_strengths=p["off_diag_edge_strengths"],
            diag_receiving_node_forgetting_coeffs=
                p["diag_receiving_node_forgetting_coeffs"],
            diag_sending_node_forgetting_coeffs=
                p["diag_sending_node_forgetting_coeffs"],
            num_edges_per_graph=13)
        np.testing.assert_array_equal(jg, got)


def test_twins_import_and_curate_with_jax_blocked(tmp_path):
    """``redcliff_tpu_torch.data`` and both twins import, and a tiny fold
    and one D4IC network are curated, in a process where importing jax
    fails; nothing of the JAX package loads."""
    code = f"""
import sys
sys.modules["jax"] = None
import os
import redcliff_tpu_torch.data as D
from redcliff_tpu_torch.data.curation import curate_synthetic_fold
from redcliff_tpu_torch.experiments import accuracy_parity_d4ic as TD
from redcliff_tpu_torch.experiments import accuracy_parity_synsys as TS
fold_dir, graphs = curate_synthetic_fold({str(tmp_path)!r}, 0,
    num_samples_in_train_set=4, num_samples_in_val_set=2,
    sample_recording_len=20)
assert len(graphs) == 2 and os.path.isfile(os.path.join(
    fold_dir, "data_fold0_cached_args.txt"))
g = TD.curate_network(os.path.join({str(tmp_path)!r}, "nets"), 0, 0, 3, 2,
                      device="cpu")
assert g.shape == (10, 10, 2) and D.make_d4ic_fold and TS.main
leaked = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith("jax.")) and sys.modules[m]
                or m == "redcliff_tpu" or m.startswith("redcliff_tpu."))
print("LEAKED", leaked)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout


def _artifact_dir(tmp_path, name):
    """A run dir holding one JAX-written artifact under ``name``."""
    model = CMLPFM(CMLPFMConfig(num_chans=3, gen_lag=2, gen_hidden=(4,),
                                input_length=3))
    params = model.init(jax.random.PRNGKey(0))
    run = tmp_path / "run"
    save_model(str(run), model, params)
    for extra in os.listdir(run):
        if extra != "final_best_model.bin":
            os.remove(run / extra)
    os.rename(run / "final_best_model.bin", run / name)
    return run


def _same_payload(a, b):
    assert a["model_class"] == b["model_class"]
    la, lb = tree_leaves(a["params"]), tree_leaves(b["params"])
    assert len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def test_load_artifact_lone_file_matches_jax(tmp_path):
    """A run dir whose artifact has another name than the standard ones
    loads in both packages; the run's meta data and trainer checkpoint are
    never taken for it; two loose candidates load in neither."""
    run = _artifact_dir(tmp_path, "model.pkl")
    _same_payload(jio.load_artifact(str(run)), tio.load_artifact(str(run)))
    for other in ("training_meta_data_and_hyper_parameters.pkl",
                  "trainer_checkpoint.pkl"):
        shutil.copy(run / "model.pkl", run / other)
    _same_payload(jio.load_artifact(str(run)), tio.load_artifact(str(run)))
    assert tio.load_artifact(str(run))["model_class"] == "CMLPFM"
    shutil.copy(run / "model.pkl", run / "model2.bin")
    for mod in (jio, tio):
        with pytest.raises(FileNotFoundError):
            mod.load_artifact(str(run))


def test_load_artifact_prev_and_bad_are_not_candidates_in_the_port(
        tmp_path):
    """The deliberate difference: the durable writer's older generation
    (``.prev``) and quarantined copies (``.bad``) of a DCSFA best model are
    never loaded by the port, where the JAX package ranks them last."""
    run = _artifact_dir(tmp_path, "dCSFA-NMF-best-model.pt.prev")
    assert jio.load_artifact(str(run))["model_class"] == "CMLPFM"
    with pytest.raises(FileNotFoundError):
        tio.load_artifact(str(run))
    os.rename(run / "dCSFA-NMF-best-model.pt.prev",
              run / "dCSFA-NMF-best-model.pt.bad")
    assert jio.load_artifact(str(run))["model_class"] == "CMLPFM"
    with pytest.raises(FileNotFoundError):
        tio.load_artifact(str(run))
    # beside a current .pt both load the .pt; only JAX warns of a second
    # candidate
    shutil.copy(run / "dCSFA-NMF-best-model.pt.bad",
                run / "dCSFA-NMF-best-model.pt")
    with pytest.warns(UserWarning, match="multiple"):
        jp = jio.load_artifact(str(run))
    _same_payload(jp, tio.load_artifact(str(run)))
