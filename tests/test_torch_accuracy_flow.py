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
being candidates in the port, is pinned. The published flows ask for their
figures, which the port's plotting hooks write where matplotlib imports.

Two ``slow`` tests fit fold 0 of the synSys 6-2-2 study at the published
depth in both packages from the same init (cLSTM and DCSFA-NMF, ROADMAP
queue 3 item 13): they pin where the two agree at the trainer bars and
where rounding, amplified by the fit itself, decides.
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

import torch_depth_parity as DP  # noqa: E402

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
    """Finite F1s for every algorithm; the published flow asks for its
    figures, which are written where matplotlib imports and skipped where
    it does not (the card's machine)."""
    assert set(out["algorithms"]) == set(algs)
    for alg, stats in out["algorithms"].items():
        assert math.isfinite(stats["offdiag_optimal_f1_mean"]), alg
        assert 0.0 <= stats["offdiag_optimal_f1_mean"] <= 1.0
    figures = [f for _, _, files in os.walk(workdir) for f in files
               if f.endswith((".png", ".pdf"))]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert not figures
    else:
        assert any(f.endswith("_by_algorithm.png") for f in figures), figures


def test_synsys_twin_runs_end_to_end_on_cpu(tmp_path, monkeypatch):
    """The published flow (no --smoke: plotting asked for) at a tiny size:
    a curated
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
    """``redcliff_tpu_torch.data`` and the eight twins import, a tiny fold
    and one D4IC network are curated, the grid-search twin curates its
    selection fold and builds its setup, the science check and the
    wavelet flow curate their folds, and the factor-count selection and
    the banded condenser run their host functions, in a process where
    importing jax fails; nothing of the JAX package loads."""
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
from redcliff_tpu_torch.experiments import d4ic_grid_search as TG
base = os.path.join({str(tmp_path)!r}, "gs")
dargs = TG.curate_tier_fold(base, "HSNR", 0, 3, 2, device="cpu")
model_type, margs = TG.arch_args("bscgs1", smoke=True)
margs.update(gen_hidden="[4]", batch_size="8", embed_num_hidden_nodes="8",
             embed_num_graph_conv_layers="1")
args_dict, model, train_ds, val_ds, tc = TG.selection_setup(
    base, model_type, margs, dargs, device="cpu")
points = TG.engine_points(TG.raw_points(*TG.search_axes(True)),
                          args_dict["num_factors"], args_dict["num_channels"])
assert len(train_ds) == 15 and len(val_ds) == 10 and len(points) == 4
assert tc.max_iter == 12 and model.config.num_factors == 5
from redcliff_tpu_torch.experiments import d4ic_smooth_searched as SS
from redcliff_tpu_torch.experiments import grid_science_parity as GP
assert SS.MODEL_TYPE == "REDCLIFF_S_CMLP_Smooth_searched" and SS.main
assert GP.spearman([1.0, 2.0, 3.0], [2.0, 4.0, 9.0]) == 1.0 and GP.main
GP.SAMPLES = {{True: (4, 2), False: (4, 2)}}
gp_dargs = GP.curate_fold(os.path.join({str(tmp_path)!r}, "gsp"), 0, True,
                          "4-1-2")
assert os.path.isfile(gp_dargs)
from redcliff_tpu_torch.experiments import banded_condense as BC
from redcliff_tpu_torch.experiments import factor_count_selection as FC
from redcliff_tpu_torch.experiments import wavelet_flow as WF
wf_dargs = WF.curate_fold(os.path.join({str(tmp_path)!r}, "wav"), 0, 3, 2)
assert os.path.isfile(wf_dargs) and WF.main and WF.MODELS[1][0] == "cMLP"
assert FC.select_k({{K: {{}} for K in FC.K_CANDIDATES}})[1] == 2 and FC.main
assert BC.aggregate_dynamic({{}}) == {{}} and BC.main
leaked =sorted(m for m in sys.modules
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


# ----------------------------------------------- the synSys fold at depth

# each family's array-task name (the JAX model's ``init`` is recorded and
# handed to the port's, as the parity harness does)
_DEPTH = {"CLSTM": "cLSTM", "DCSFA": "DCSFANMF"}
HIST = dict(rtol=1e-4, atol=1e-5)
# cLSTM's early-stopping criterion is the L1 of its GC estimate; it falls
# from ~40 to Adam's noise floor, where the first-layer weights hover at
# about gen_lr. Until it is below this share of its first value, both
# packages hold the trainer bars
CLSTM_FLOOR_SHARE = 0.05


def _pretrain_drift(run, origin):
    """(2, epochs): per encoder-pretrain epoch, the largest relative
    difference of a step's loss, and of the raw W_nmf a step leaves
    (against its largest entry), between two runs."""
    steps = len(origin["pre_loss"])
    loss = np.abs(run["pre_loss"] - origin["pre_loss"]) \
        / np.abs(origin["pre_loss"])
    w = (np.abs(run["pre_w_nmf"] - origin["pre_w_nmf"]).reshape(steps, -1)
         .max(1) / np.abs(origin["pre_w_nmf"]).reshape(steps, -1).max(1))
    epochs = int(TSYN.DCSFA_ARGS["n_pre_epochs"])
    return np.stack([loss, w]).reshape(2, epochs, -1).max(2)


def _parting_epoch(drift):
    """The first epoch whose drift is beyond the trainer bars' rtol."""
    beyond = (drift > HIST["rtol"]).any(0)
    return int(np.argmax(beyond)) if beyond.any() else drift.shape[1]


def fit_synsys_fold_at_depth(alias, workdir, **kw):
    """:func:`_fit_at_depth` with its own patches, undone when it returns
    (so a later fit wraps the models' own methods, not these)."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        return _fit_at_depth(alias, workdir, monkeypatch, **kw)


def _fit_at_depth(alias, workdir, monkeypatch, fold=0, overrides=None,
                  init=None, ulp=0, package="port"):
    """One fold of the synSys 6-2-2 study (fold 0 unless given), curated at
    the published size (1,040 / 240 recordings of (100, 6)), and one
    family's array task at the published depth (its cached-args updated by
    ``overrides``). Without ``init`` both packages fit, the port from the
    JAX package's init; with ``init`` (a recorded JAX init) only
    ``package`` fits, from it, every float element moved by one ulp up
    (``ulp=1``) or down (``ulp=-1``). Returns {package: {"run", "wall_s",
    "gc", and the run's meta data and criterion history (cLSTM) or the
    fit's histories and its encoder pretrain's per-step losses and raw
    ``W_nmf`` (DCSFA)}} and the JAX init under "init"."""
    import time

    from redcliff_tpu_torch.data.curation import curate_synthetic_fold
    from redcliff_tpu_torch.eval import gc_estimates as tge
    from redcliff_tpu_torch.eval import model_io as tio
    from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint
    from redcliff_tpu_torch.train import driver as tdriver

    model_type = _DEPTH[alias]
    fold_dir, _ = curate_synthetic_fold(
        os.path.join(workdir, "data"), fold_id=fold, num_nodes=6, num_lags=2,
        num_factors=2, num_supervised_factors=2, num_edges_per_graph=2,
        num_samples_in_train_set=1040, num_samples_in_val_set=240,
        sample_recording_len=100, burnin_period=50,
        label_type_setting="OneHot", noise_type="gaussian", noise_level=1.0,
        folder_name="synSys6_2_2")
    dargs = os.path.join(fold_dir, f"data_fold{fold}_cached_args.txt")
    margs = os.path.join(workdir, f"{model_type}_cached_args.txt")
    with open(margs, "w") as f:
        json.dump(dict(TSYN.model_args_for(TSYN.MODELS, 6, 2, False)[
            model_type], **(overrides or {})), f)

    jcls, tcls = DP.model_classes(model_type)
    recorded = DP.patch_inits(monkeypatch, model_type, init=init, ulp=ulp)
    fits, pre = {}, {}

    def keep(name, fit):
        def wrapped(self, *a, **kw):
            fits[name] = result = fit(self, *a, **kw)
            return result
        return wrapped

    def criteria(name, fn):
        def wrapped(self, *a, **kw):
            value = fn(self, *a, **kw)
            fits.setdefault(name, []).append(float(value))
            return value
        return wrapped

    # neither the DCSFA fit's histories nor cLSTM's criterion history is in
    # the run dir
    if alias == "DCSFA":
        monkeypatch.setattr(jcls, "fit", keep("jax", jcls.fit))
        monkeypatch.setattr(tcls, "fit", keep("port", tcls.fit))
        # the encoder pretrain's steps: the loss each step takes and the
        # raw W_nmf it leaves
        jbuild, tstep = jcls._build_step, tcls.train_step

        def jax_build(self, pretrain):
            tx, step = jbuild(self, pretrain)
            if not pretrain:
                return tx, step

            def recorded_step(*a):
                out = step(*a)
                pre.setdefault("jax", []).append(
                    (float(out[3][0]), np.asarray(out[0]["W_nmf"])))
                return out
            return tx, recorded_step

        def port_step(self, params, state, phase, batch, pretrain):
            new_state, losses = tstep(self, params, state, phase, batch,
                                      pretrain)
            if pretrain:
                pre.setdefault("port", []).append(
                    (float(losses[0]),
                     params["W_nmf"].detach().cpu().numpy().copy()))
            return new_state, losses
        monkeypatch.setattr(jcls, "_build_step", jax_build)
        monkeypatch.setattr(tcls, "train_step", port_step)
    else:
        monkeypatch.setattr(jcls, "validation_criteria", criteria(
            "jax", jcls.validation_criteria))
        monkeypatch.setattr(tcls, "validation_criteria", criteria(
            "port", tcls.validation_criteria))
    from redcliff_tpu.train import driver as jdriver

    packages = [("jax", jdriver, {}), ("port", tdriver, {"device": "cpu"})]
    if init is not None:
        packages = [p for p in packages if p[0] == package]
    out = {}
    for name, pkg, extra in packages:
        root = os.path.join(workdir, name)
        os.makedirs(root)
        t0 = time.time()
        assert pkg.set_up_and_run_experiments(
            {"save_root_path": root}, [margs], [dargs], [model_type],
            [f"data_fold{fold}"], task_id=1, **extra) == 1
        (run,) = os.listdir(root)
        entry = out[name] = {"wall_s": time.time() - t0,
                             "run": os.path.join(root, run)}
        if alias == "DCSFA":
            entry["histories"] = fits[name][-1]
            steps = pre.get(name, [])
            entry["pre_loss"] = np.asarray([loss for loss, _ in steps])
            entry["pre_w_nmf"] = np.asarray([w for _, w in steps])
        else:
            entry["meta"] = read_checkpoint(os.path.join(
                entry["run"], "training_meta_data_and_hyper_parameters.pkl"))
            entry["criteria"] = fits[name]
    if "jax" in out:
        from redcliff_tpu.eval import gc_estimates as jge
        from redcliff_tpu.eval import model_io as jio

        loaded = jio.load_model_for_eval(out["jax"]["run"])
        out["jax"]["gc"] = [np.asarray(g) for g in jge.get_model_gc_estimates(
            loaded[0], loaded[1], alias, 2)]
    if "port" in out:
        loaded = tio.load_model_for_eval(out["port"]["run"], device="cpu")
        out["port"]["gc"] = [
            np.asarray(g) for g in tge.get_model_gc_estimates(
                loaded[0], loaded[1], alias, 2)]
    out["init"] = recorded["init"]
    return out


@pytest.mark.slow
@pytest.mark.parametrize("alias", ["CLSTM", "DCSFA"])
def test_synsys_fold_at_depth_matches_jax(alias, tmp_path):
    """ROADMAP queue 3 item 13: fold 0 of the synSys 6-2-2 study at the
    published depth, both packages from the same (JAX) init, the batch
    orders drawn by numpy in both.

    cLSTM (``max_iter`` 300): the criterion (the L1 of the GC estimate)
    and the validation histories agree at the trainer bars for as long as
    the criterion is above 5% of its first value (~180 epochs). Then the
    weights sit on Adam's noise floor (|w| ~ gen_lr) and the criterion
    jitters there by percents from epoch to epoch: the best epoch, its
    argmin over that floor, is a rounding draw in either package. Pinned:
    both packages' best and stop epochs lie on the floor, their GC
    estimates are at its scale, and the validation histories stay within
    1e-3 to the end.

    DCSFA-NMF (50 encoder-pretrain and 250 joint epochs): the encoder
    pretrain moves the frozen ``W_nmf`` by +grad (queue 3 item 9), which
    amplifies rounding. Each package also fits from the init moved one ulp
    up and one down. Step by step through the pretrain, the port holds
    JAX's losses and ``W_nmf`` at the trainer bars for as long as each
    moved run holds its own package's (the first epochs); then the ascent
    throws ``W_nmf`` about in every run, and by the first joint epoch the
    port's loss lies no farther from JAX's than the three runs of either
    package lie from each other. Without the encoder pretrain
    the two packages make the same decisions (the best epoch, the F1 and
    ROC-AUC of their GC estimates), the training history starts at the
    trainer bars, and the component graphs agree within 1e-3 of their
    largest entry."""
    from redcliff_tpu_torch.eval.cross_alg import evaluate_algorithm_on_fold

    out = fit_synsys_fold_at_depth(alias, str(tmp_path / "pub"))
    j, t = out["jax"], out["port"]
    if alias == "CLSTM":
        jc, tc = np.asarray(j["criteria"]), np.asarray(t["criteria"])
        floor = int(np.argmax(jc < CLSTM_FLOOR_SHARE * jc[0]))
        assert 150 < floor < 200
        np.testing.assert_allclose(tc[:floor], jc[:floor], rtol=1e-4)
        n = min(len(jc), len(tc))
        for k in ("avg_combo_loss", "avg_forecasting_loss"):
            np.testing.assert_allclose(t["meta"][k][:floor],
                                       j["meta"][k][:floor], err_msg=k,
                                       **HIST)
            np.testing.assert_allclose(t["meta"][k][:n], j["meta"][k][:n],
                                       rtol=1e-3, err_msg=k)
        lr = float(TSYN.CLSTM_ARGS["gen_lr"])
        for meta, crit, gc in ((j["meta"], jc, j["gc"]),
                               (t["meta"], tc, t["gc"])):
            assert meta["best_it"] > floor and meta["epoch"] > floor
            assert crit[meta["best_it"]] < 1e-3 * crit[0]
            assert max(np.abs(g).max() for g in gc) < 10 * lr
        return

    jh, th = j["histories"], t["histories"]
    assert len(th["training"]) == len(jh["training"]) == 250
    # each package again from the JAX init moved one ulp up and down
    runs = {"port": [t], "jax": [j]}
    for package in runs:
        for u in (1, -1):
            runs[package].append(fit_synsys_fold_at_depth(
                alias, str(tmp_path / f"{package}{u:+d}"),
                init=out["init"], ulp=u, package=package)[package])
    # the encoder pretrain epoch by epoch: the port holds JAX at the
    # trainer bars for as long as every moved run holds its origin
    moves = [_pretrain_drift(m, runs[p][0])
             for p in runs for m in runs[p][1:]]
    part = min(_parting_epoch(d) for d in moves)
    assert part >= 3, part
    drift = _pretrain_drift(t, j)
    assert _parting_epoch(drift) >= part, (drift[:, :part + 1], part)
    # by the first joint epoch the W_nmf ascent has walked every run apart:
    # the port lies no farther from JAX than the runs of either package lie
    # from each other
    first = {p: [r["histories"]["training"][0] for r in rs]
             for p, rs in runs.items()}
    spread = max(max(v) - min(v) for v in first.values())
    gap = abs(first["port"][0] - first["jax"][0])
    assert gap <= spread, (gap, first)

    nopre = fit_synsys_fold_at_depth(alias, str(tmp_path / "nopre"),
                                     overrides={"n_pre_epochs": "0"})
    jh, th = nopre["jax"]["histories"], nopre["port"]["histories"]
    assert th["best_epoch"] == jh["best_epoch"]
    np.testing.assert_allclose(th["training"][:10], jh["training"][:10],
                               **HIST)
    # the validation AUCs read eval-mode outputs, which follow the walked
    # BatchNorm bias (queue 3 item 10): a few of 240 windows' ranks move
    np.testing.assert_allclose(th["best_val_aucs"], jh["best_val_aucs"],
                               atol=1e-2)
    for g, w in zip(nopre["port"]["gc"], nopre["jax"]["gc"]):
        np.testing.assert_allclose(g, w, atol=1e-3 * np.abs(w).max())
    truth = load_true_gc_factors(os.path.join(
        str(tmp_path / "nopre"), "data", "synSys6_2_2", "fold_0",
        "data_fold0_cached_args.txt"))
    key = "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag"
    scores = [evaluate_algorithm_on_fold(nopre[p]["run"], alias, truth,
                                         device="cpu")[key]
              for p in ("jax", "port")]
    for k in ("f1_vals_across_factors", "roc_auc_vals_across_factors"):
        assert scores[0][k] == scores[1][k], k
