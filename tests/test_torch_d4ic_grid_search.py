"""The D4IC coefficient-selection study in the port: the twin
``redcliff_tpu_torch/experiments/d4ic_grid_search.py`` of the JAX
package's ``experiments/d4ic_grid_search.py``.

The JAX script is read with ``ast``, never imported (it pins JAX's
platform at import): its axes, constants, smoke cuts, sample counts,
round-4 baselines, ``pooled_offdiag`` and the key set of its JSON are
held to the twin's. The twin's 27 engine points of both architectures
equal the committed JSONs'. At a tiny width, one curated fold goes
through the JAX grid and the twin's grid stage from the same JAX init,
then through both packages' optimal-F1 battery; and the twin's whole
``--smoke`` flow runs on the CPU into its own work directory.
"""
import ast
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.eval import cross_alg as jcross  # noqa: E402
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu.train import orchestration as jorch  # noqa: E402
from redcliff_tpu.train import redcliff_trainer as jtr  # noqa: E402
from redcliff_tpu.utils import config as jconfig  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.experiments import accuracy_parity_d4ic as TD  # noqa: E402,E501
from redcliff_tpu_torch.experiments import d4ic_grid_search as TG  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "d4ic_grid_search.py")

# the grid bars of tests/test_torch_grid.py; the scores' bar
HIST = dict(rtol=1e-4, atol=1e-5)
F1_RTOL = 1e-5

# the published BSCgs1 cached args at a tiny width and depth
TINY = dict(TD.REDCLIFF_ARGS, gen_hidden="[4]", batch_size="8",
            embed_num_hidden_nodes="8", embed_num_graph_conv_layers="1")
TINY_DEPTH = dict(max_iter="3", num_pretrain_epochs="1",
                  num_acclimation_epochs="1", check_every="1")
TINY_SAMPLES = (6, 3)


@pytest.fixture(autouse=True)
def _restore_global_rngs():
    """Curation runs the graph factory, which seeds ``random`` and
    ``np.random`` globally: leave both as they were."""
    import random

    py_state, np_state = random.getstate(), np.random.get_state()
    yield
    random.setstate(py_state)
    np.random.set_state(np_state)


def _script():
    return ast.parse(open(SCRIPT).read())


def _main_def():
    return next(n for n in _script().body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _assigned(fn, name):
    """The value node of ``name = ...`` in a function body."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            return node.value
    raise KeyError(name)


def _out_dict():
    """The JSON dict literal of the JAX script's ``main``."""
    return _assigned(_main_def(), "out")


def test_axes_constants_and_smoke_cuts_are_transcribed():
    consts = {}
    for node in _script().body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                consts[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    for name in ("GEN_LR_AXIS", "ADJ_L1_AXIS", "COS_SIM_AXIS", "OFFDIAG",
                 "TIERS"):
        assert getattr(TG, name) == consts[name], name
    main = _main_def()
    # the --smoke cuts of the cached args
    update = next(n for n in ast.walk(main)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)
                  and n.func.attr == "update"
                  and isinstance(n.func.value, ast.Name)
                  and n.func.value.id == "margs")
    assert TG.SMOKE_CUTS == {k.arg: ast.literal_eval(k.value)
                             for k in update.keywords}
    samples = next(
        n.value for n in ast.walk(main)
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Tuple)
        and [e.id for e in n.targets[0].elts] == ["n_train", "n_val"])
    assert TG.SAMPLES == {True: ast.literal_eval(samples.body),
                          False: ast.literal_eval(samples.orelse)}

    def branch(name, smoke):
        node = _assigned(main, name)
        expr = ast.Expression(node.orelse if smoke else node.body)
        return eval(compile(expr, SCRIPT, "eval"), dict(consts))

    for smoke in (False, True):
        assert TG.search_axes(smoke) == tuple(
            branch(n, smoke) for n in ("gen_axis", "adj_axis", "cos_axis"))
        # the winner's tiers
        want_tiers = branch("tiers", smoke)
        assert (TG.TIERS if not smoke else ("HSNR",)) == want_tiers
    base = dict(zip((k.value for k in _out_dict().keys),
                    _out_dict().values))["transcribed_round4_baseline"]
    assert TG.ROUND4_BASELINE == {"smooth": ast.literal_eval(base.body),
                                  "bscgs1": ast.literal_eval(base.orelse)}
    for arch, smooth in (("bscgs1", False), ("smooth", True)):
        model_type, margs = TG.arch_args(arch, smoke=True)
        assert model_type == ("REDCLIFF_S_CMLP_Smooth" if smooth
                              else "REDCLIFF_S_CMLP")
        src = TD.SMOOTH_ARGS if smooth else TD.REDCLIFF_ARGS
        assert margs == dict(src, **TG.SMOKE_CUTS)
        assert TG.arch_args(arch, smoke=False)[1] == src


@pytest.mark.parametrize("arch, name", [
    ("bscgs1", "D4IC_GRID_SEARCH.json"),
    ("smooth", "D4IC_GRID_SEARCH_SMOOTH.json")])
def test_engine_points_equal_the_committed_jsons(arch, name):
    with open(os.path.join(REPO, "experiments", name)) as f:
        committed = json.load(f)["per_point"]
    raw = TG.raw_points(*TG.search_axes(False))
    assert len(raw) == len(committed) == 27
    assert raw == [p["raw"] for p in committed]
    _, margs = TG.arch_args(arch, smoke=False)
    points = TG.engine_points(raw, int(margs["num_factors"]), TD.NUM_NODES)
    for got, p in zip(points, committed):
        want = p["engine_point"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)


def test_pooled_offdiag_is_the_jax_scripts_bit_for_bit():
    fn = next(n for n in _script().body
              if isinstance(n, ast.FunctionDef) and n.name == "pooled_offdiag")
    ns = {"np": np, "OFFDIAG": TG.OFFDIAG}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), SCRIPT, "exec"), ns)
    rng = np.random.default_rng(11)

    def stats(n, aucs=True):
        s = {"f1_vals_across_factors": list(rng.uniform(size=n))}
        if aucs:
            s["roc_auc_vals_across_factors"] = list(rng.uniform(size=n))
        return {TG.OFFDIAG: s}

    cases = [[stats(5), stats(5), stats(5)], [stats(5, aucs=False)],
             [stats(1)], [stats(3), stats(2, aucs=False)]]
    for case in cases:
        assert TG.pooled_offdiag(case) == ns["pooled_offdiag"](case)


def _jax_setup(base, model_type, dargs_file):
    """The JAX script's selection setup (``:152-214``) over the cached-args
    file the twin wrote."""
    args_dict = {"save_root_path": os.path.join(base, "jax_runs"),
                 "model_type": model_type,
                 "model_cached_args_file": os.path.join(
                     base, f"{model_type}_gs_cached_args.txt"),
                 "data_set_name": "data_fold0",
                 "data_cached_args_file": dargs_file}
    jconfig.read_in_model_args(args_dict)
    jconfig.read_in_data_args(args_dict)
    jdriver.rescale_dataset_dependent_coefficients(args_dict)
    model = jorch.create_model_instance(
        args_dict, employ_version_with_smoothing_loss="Smooth" in model_type)
    train_ds, val_ds = jorch.get_data_for_model_training(args_dict,
                                                         grid_search=False)
    tc = jtr.RedcliffTrainConfig(
        embed_lr=args_dict["embed_lr"], embed_eps=args_dict["embed_eps"],
        embed_weight_decay=args_dict["embed_weight_decay"],
        gen_lr=args_dict["gen_lr"], gen_eps=args_dict["gen_eps"],
        gen_weight_decay=args_dict["gen_weight_decay"],
        max_iter=args_dict["max_iter"], lookback=args_dict["lookback"],
        check_every=args_dict["check_every"],
        batch_size=args_dict["batch_size"],
        stopping_criteria_forecast_coeff=args_dict[
            "stopping_criteria_forecast_coeff"],
        stopping_criteria_factor_coeff=args_dict[
            "stopping_criteria_factor_coeff"],
        stopping_criteria_cosSim_coeff=args_dict[
            "stopping_criteria_cosSim_coeff"])
    return model, train_ds, val_ds, tc


def _tiny_stage(base, device):
    """The twin's curation, setup and grid stage at the tiny width on one
    fold; returns what the comparison needs."""
    dargs = TG.curate_tier_fold(base, "HSNR", 0, *TINY_SAMPLES,
                                device=device)
    model_type, margs = TG.arch_args("bscgs1", smoke=False)
    margs.update(TINY_DEPTH)
    raw = TG.raw_points(*TG.search_axes(True))
    args_dict, model, train_ds, val_ds, tc = TG.selection_setup(
        base, model_type, margs, dargs, device=device)
    points = TG.engine_points(raw, args_dict["num_factors"],
                              args_dict["num_channels"])
    return dargs, model_type, raw, points, model, train_ds, val_ds, tc


def test_grid_stage_and_scores_match_jax(tmp_path, monkeypatch):
    """One curated fold, 4 points, 3 epochs: the JAX grid from
    ``model.init(PRNGKey(0))`` and the twin's grid stage from that init,
    at the grid bars, the same best epochs and selection; each point's
    fold-0 optimal F1 from both packages' battery."""
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    base = str(tmp_path)
    dargs, model_type, raw, points, model, train_ds, val_ds, tc = \
        _tiny_stage(base, "cpu")
    jmodel, jtrain, jval, jtc = _jax_setup(base, model_type, dargs)
    jinit = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jres = jdriver.run_coefficient_grid(
        jmodel, jtc, points, jtrain, jval, key=jax.random.PRNGKey(0),
        init_point_params=jinit)
    tres, _ = TG.fit_grid(model, tc, points, train_ds, val_ds,
                          init_point_params=interop.params_from_jax(jinit),
                          device="cpu")
    assert tres.val_history.shape == (3, 4)
    np.testing.assert_allclose(tres.val_history, jres.val_history, **HIST)
    np.testing.assert_allclose(tres.best_criteria, jres.best_criteria,
                               **HIST)
    np.testing.assert_array_equal(tres.best_epoch, jres.best_epoch)

    per_point = TG.score_points(base, "", model, tres, raw, points,
                                TG.load_true_gc_factors(dargs),
                                device="cpu")
    jtrue = jconfig.load_true_gc_factors(dargs)
    jf1 = []
    for i in range(len(points)):
        run_dir = tmp_path / "jax_points" / f"grid_point{i}"
        run_dir.mkdir(parents=True)
        with open(run_dir / "final_best_model.bin", "wb") as f:
            pickle.dump({"model_class": "RedcliffSCMLP",
                         "config": jmodel.config,
                         "params": jax.tree.map(
                             lambda x, i=i: np.asarray(x)[i],
                             jres.best_params)}, f)
        stats = jcross.evaluate_algorithm_on_fold(str(run_dir),
                                                  "REDCLIFF_S_CMLP", jtrue)
        jf1.append(stats[TG.OFFDIAG]["f1_mean_across_factors"])
    np.testing.assert_allclose([p["optf1_fold0"] for p in per_point], jf1,
                               rtol=F1_RTOL)
    sel, _ = TG.select(per_point)
    assert sel == int(np.argmin(np.asarray(jres.best_criteria,
                                           dtype=np.float64)))
    assert [p["best_epoch"] for p in per_point] == \
        np.asarray(jres.best_epoch).tolist()


def test_smoke_flow_runs_on_cpu_into_its_work_dir(tmp_path, monkeypatch):
    """``main([wd, "--smoke", "--folds", "1"], device="cpu")`` at a tiny
    width: the JSON lands under ``wd + "_smoke"`` with the JAX script's key
    set, and nothing under ``experiments/`` changes."""
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    monkeypatch.setattr(TG, "REDCLIFF_ARGS", TINY)
    monkeypatch.setattr(TG, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})
    exp = os.path.join(REPO, "experiments")
    before = {f: os.path.getmtime(os.path.join(exp, f))
              for f in os.listdir(exp)}
    wd = str(tmp_path / "gs")
    records = {}
    out = TG.main([wd, "--smoke", "--folds", "1"], device="cpu",
                  records=records)
    assert {f: os.path.getmtime(os.path.join(exp, f))
            for f in os.listdir(exp)} == before
    dest = os.path.join(wd + "_smoke", "D4IC_GRID_SEARCH_smoke.json")
    with open(dest) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert not os.path.exists(wd)
    assert set(out) == {k.value for k in _out_dict().keys}
    assert out["grid_size"] == 4 and out["smoke"] is True
    assert out["grid_epochs_run"] == records["grid"].val_history.shape[0]
    crit = [p["best_criteria"] for p in out["per_point"]]
    assert all(np.isfinite(crit))
    assert out["selected_by_criteria"] == \
        out["per_point"][int(np.argmin(crit))]["raw"]
    f1 = [p["optf1_fold0"] for p in out["per_point"]]
    assert out["oracle_point"] == out["per_point"][int(np.argmax(f1))]["raw"]
    assert set(out["winner_rows"]) == {"HSNR"}
    assert np.isfinite(out["winner_rows"]["HSNR"]["offdiag_optimal_f1_mean"])
    assert len(records["winner_runs"]) == 1
    assert os.path.isfile(os.path.join(records["winner_runs"][0],
                                       "final_best_model.bin"))


def test_main_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TG.main([str(tmp_path / "gs"), "--smoke"])
    assert not os.path.exists(str(tmp_path / "gs_smoke"))


@pytest.mark.gpu
def test_grid_stage_on_card_matches_cpu(tmp_path, monkeypatch):
    """On the card: the tiny grid stage from one init against the same
    stage on the CPU, at the grid bars and the same best epochs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lane kernel runs on it")
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    results = []
    for device in ("cpu", "cuda"):
        base = str(tmp_path / device)
        # curation on the CPU in both: the recordings are the same
        dargs = TG.curate_tier_fold(base, "HSNR", 0, *TINY_SAMPLES,
                                    device="cpu")
        model_type, margs = TG.arch_args("bscgs1", smoke=False)
        margs.update(TINY_DEPTH)
        raw = TG.raw_points(*TG.search_axes(True))
        args_dict, model, train_ds, val_ds, tc = TG.selection_setup(
            base, model_type, margs, dargs, device=device)
        points = TG.engine_points(raw, args_dict["num_factors"],
                                  args_dict["num_channels"])
        init = model.init(torch.Generator().manual_seed(0))
        res, _ = TG.fit_grid(model, tc, points, train_ds, val_ds,
                             init_point_params=init, device=device)
        results.append(res)
    cpu, card = results
    np.testing.assert_allclose(card.val_history, cpu.val_history, **HIST)
    np.testing.assert_allclose(card.best_criteria, cpu.best_criteria, **HIST)
    np.testing.assert_array_equal(card.best_epoch, cpu.best_epoch)
