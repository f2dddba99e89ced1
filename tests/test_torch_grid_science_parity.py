"""The grid-vs-array-task science check in the port: the twin
``redcliff_tpu_torch/experiments/grid_science_parity.py`` of the JAX
package's ``experiments/grid_science_parity.py``.

The JAX script is read with ``ast``, never imported (it pins JAX's
platform at import): its axes, points, curation, smoke cuts, the key sets
of its JSON and fold record are held to the twin's, and its ``spearman``
and ``_completed_run_dirs`` are exec'd from its source and held to the
twin's on crafted inputs. The two legs start from the same weights. At a
tiny width and depth on one curated fold (host numpy: the same fold in
both packages), the grid leg goes through both packages'
``run_coefficient_grid`` from one JAX init and both batteries, and one
point's per-point leg through both packages' array task from that init.
The twin's ``--smoke`` flow runs twice on the CPU into its own work
directory: the second call reuses the per-point runs and carries the
trained wall forward.
"""
import ast
import json
import os
import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.eval import cross_alg as jcross  # noqa: E402
from redcliff_tpu.eval.edge_dynamics import vector_spearman as jspearman  # noqa: E402,E501
from redcliff_tpu.runtime.checkpoint import read_checkpoint as jread  # noqa: E402,E501
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu.train import orchestration as jorch  # noqa: E402
from redcliff_tpu.train import redcliff_trainer as jtr  # noqa: E402
from redcliff_tpu.utils import config as jconfig  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.experiments import accuracy_parity_synsys as TSYN  # noqa: E402,E501
from redcliff_tpu_torch.experiments import d4ic_grid_search as TG  # noqa: E402,E501
from redcliff_tpu_torch.experiments import grid_science_parity as GP  # noqa: E402,E501
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint  # noqa: E402,E501
from redcliff_tpu_torch.train import redcliff_trainer as ttr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "grid_science_parity.py")
META = GP.META

# the grid bars (tests/test_torch_grid.py), the trainer bars
# (tests/test_torch_driver.py); the scores' bar
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)
F1_RTOL = 1e-5

# the synSys REDCLIFF-S cached args at a tiny width, and a depth of
# 1 + 1 + 1 epochs
TINY = dict(gen_hidden="[4]", batch_size="8", embed_num_hidden_nodes="8",
            embed_num_graph_conv_layers="1")
TINY_DEPTH = dict(max_iter="3", num_pretrain_epochs="1",
                  num_acclimation_epochs="1", check_every="1")
TINY_SAMPLES = (16, 8)


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


def _def(name):
    return next(n for n in _script().body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _jax_fn(name, **ns):
    """A function of the JAX script, exec'd from its source in ``ns``."""
    exec(compile(ast.Module(body=[_def(name)], type_ignores=[]), SCRIPT,
                 "exec"), ns)
    return ns[name]


def _dict_keys(node):
    return {k.value for k in node.keys}


def _assigned(fn, name):
    for n in ast.walk(fn):
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == name):
            return n.value
    raise KeyError(name)


def _fold_record_keys():
    """The key sets of ``run_fold``'s returned record and of its
    ``wall_clock_s``."""
    ret = next(n.value for n in ast.walk(_def("run_fold"))
               if isinstance(n, ast.Return))
    walls = dict(zip((k.value for k in ret.keys), ret.values))[
        "wall_clock_s"]
    return _dict_keys(ret), _dict_keys(walls)


def _consts():
    out = {}
    for node in _script().body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def test_axes_points_curation_and_cuts_are_transcribed(tmp_path,
                                                       monkeypatch):
    consts = _consts()
    for name in ("GEN_LR_AXIS", "ADJ_L1_AXIS", "OFFDIAG"):
        assert getattr(GP, name) == consts[name], name
    assert GP._grid_points() == _jax_fn("_grid_points", **consts)()
    main = _def("main")
    update = next(n for n in ast.walk(main)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)
                  and n.func.attr == "update"
                  and any(k.arg == "max_iter" for k in n.keywords))
    cuts = {k.arg: ast.literal_eval(k.value) for k in update.keywords}
    assert GP.base_model_args("6-2-2", True) == dict(TSYN.REDCLIFF_ARGS,
                                                     **cuts)
    assert GP.base_model_args("6-2-2", False) == TSYN.REDCLIFF_ARGS
    assert GP.base_model_args("6-2-3", False) == dict(
        TSYN.REDCLIFF_ARGS, num_factors="3", num_supervised_factors="3")
    # the fold's curation: every argument of the JAX call, both depths
    call = next(n for n in ast.walk(_def("run_fold"))
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "curate_synthetic_fold")
    seen = []
    monkeypatch.setattr(GP, "curate_synthetic_fold",
                        lambda *a, **kw: seen.append((a, kw)) or ("d", []))
    for smoke in (True, False):
        base = str(tmp_path)
        ns = {"os": os, "base": base, "fold": 2, "args_smoke": smoke,
              "num_nodes": 6, "num_edges": 3, "num_factors": 4}

        def ev(node, ns=ns):
            return eval(compile(ast.Expression(node), SCRIPT, "eval"), ns)
        want = ([ev(a) for a in call.args],
                {k.arg: ev(k.value) for k in call.keywords})
        assert GP.curate_fold(base, 2, smoke, "6-3-4") == os.path.join(
            "d", "data_fold2_cached_args.txt")
        a, kw = seen.pop()
        assert (list(a), kw) == want
        assert GP.SAMPLES[smoke] == (kw["num_samples_in_train_set"],
                                     kw["num_samples_in_val_set"])


def test_json_and_fold_record_key_sets_are_transcribed():
    """The key sets the twin's flow writes (held in the smoke test) are
    the JAX script's: the JSON, the fold record, its walls, the
    per-point, grid and per-config records."""
    fold_keys, wall_keys = _fold_record_keys()
    assert fold_keys == set(JSON_FOLD_KEYS)
    assert wall_keys == {"per_point_total", "per_point_trained",
                         "points_trained", "grid_total"}
    assert _dict_keys(_assigned(_def("main"), "out")) == set(JSON_KEYS)
    run_fold = _def("run_fold")
    appended = [n.args[0] for n in ast.walk(run_fold)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "append" and n.args
                and isinstance(n.args[0], ast.Dict)]
    assert [_dict_keys(d) for d in appended] == [
        {"point", "run_dir", "best_loss", "best_it", "resumed", "train_s"},
        {"point", "per_point_driver", "grid_engine", "optf1_delta"}]
    stats = next(n for n in ast.walk(run_fold)
                 if isinstance(n, ast.FunctionDef)
                 and n.name == "offdiag_stats")
    ret = next(n.value for n in ast.walk(stats) if isinstance(n, ast.Return))
    assert _dict_keys(ret) == {"optimal_f1", "optimal_f1_sem", "roc_auc"}


JSON_KEYS = ("system", "axes", "smoke", "num_folds", "folds",
             "same_winner_by_fold", "spearman_rank_correlation_by_fold",
             "spearman_rank_correlation_mean",
             "winner_science_delta_optf1_by_fold",
             "winner_science_delta_optf1_mean", "wall_clock_s_by_fold")
JSON_FOLD_KEYS = (
    "fold", "per_point", "grid", "selected_point_per_point_driver",
    "selected_point_grid_engine", "same_winner", "spearman_rank_correlation",
    "winner_science_delta_optf1", "per_config_science",
    "winner_stats_per_point_driver", "winner_stats_grid_engine",
    "grid_selection_rankings", "wall_clock_s")

SPEARMAN_CASES = {
    "distinct": ([0.3, 0.1, 0.4, 0.2], [3.0, 1.0, 4.5, 2.0]),
    "reversed": ([1.0, 2.0, 3.0, 4.0], [4.0, 3.0, 2.0, 1.0]),
    "ties_in_one": ([0.5, 0.5, 0.1, 0.9], [2.0, 3.0, 1.0, 4.0]),
    "ties_in_both": ([1.0, 1.0, 2.0, 2.0], [5.0, 6.0, 6.0, 7.0]),
    "one_constant": ([0.2, 0.2, 0.2, 0.2], [1.0, 2.0, 3.0, 4.0]),
    "both_constant": ([1.0, 1.0, 1.0], [2.0, 2.0, 2.0]),
    "float32_criteria": ([60.58, 60.18, 54.12, 52.72],
                         np.asarray([60.47, 60.06, 54.00, 52.58],
                                    dtype=np.float32)),
}


@pytest.mark.parametrize("case", sorted(SPEARMAN_CASES))
def test_spearman_matches_the_jax_scripts(case):
    a, b = SPEARMAN_CASES[case]
    jax_spearman = _jax_fn("spearman", np=np, vector_spearman=jspearman)
    got = GP.spearman(np.asarray(a), b)
    assert isinstance(got, float)
    assert got == jax_spearman(np.asarray(a), b)
    if "constant" in case:
        assert got == 0.0


def _meta_reader(read):
    """A ``pickle`` stand-in whose ``load`` reads a meta file with ``read``
    (a package's ``read_checkpoint``)."""
    return types.SimpleNamespace(load=lambda f: read(f.name))


@pytest.mark.parametrize("schedule", [(8, 12, 1, 2), (200, 300, 1, 10),
                                      (1, 6, 2, 1)])
def test_completed_run_dirs_matches_the_jax_scripts(tmp_path, schedule):
    """Crafted meta files around each edge of the completion rule: no meta,
    inside pretrain + acclimation, trained to max_iter, stopped by the
    patience rule, interrupted, past max_iter, no best epoch, no epoch.
    Plain pickles, which the JAX script's ``pickle.load`` reads, then the
    same records in the versioned format both packages' trainers write:
    the twin reads them through ``read_checkpoint``; the JAX script's
    ``pickle.load`` cannot (ROADMAP queue 3 item 25), so it is held there
    with the JAX package's reader in its place."""
    from redcliff_tpu_torch.runtime.checkpoint import write_checkpoint

    min_epochs, expected, lookback, check = schedule
    patience = lookback * check
    metas = {
        "b_in_pretrain": dict(epoch=min_epochs - 1, best_it=0),
        "c_at_min": dict(epoch=min_epochs, best_it=min_epochs),
        "d_to_max_iter": dict(epoch=expected - 1, best_it=expected - 1),
        "e_patience": dict(epoch=expected - 2,
                           best_it=expected - 2 - patience),
        "f_interrupted": dict(epoch=expected - 2,
                              best_it=expected - 2 - patience + 1),
        "g_past_max_iter": dict(epoch=expected, best_it=0),
        "h_no_best_it": dict(epoch=expected - 2),
        "i_no_epoch": dict(best_it=0)}
    for fmt in ("plain", "versioned"):
        root = str(tmp_path / fmt)
        os.makedirs(os.path.join(root, "a_no_meta"))
        with open(os.path.join(root, "k_file"), "w") as f:
            f.write("x")
        for name, meta in metas.items():
            os.makedirs(os.path.join(root, name))
            path = os.path.join(root, name, META)
            if fmt == "plain":
                with open(path, "wb") as f:
                    pickle.dump(meta, f)
            else:
                write_checkpoint(path, meta)
        got = GP._completed_run_dirs(root, *schedule)
        assert "d_to_max_iter" in got and "e_patience" in got
        assert "f_interrupted" not in got and "b_in_pretrain" not in got
        if fmt == "plain":
            jax_fn = _jax_fn("_completed_run_dirs", os=os, pickle=pickle)
        else:
            with pytest.raises(pickle.UnpicklingError):
                _jax_fn("_completed_run_dirs", os=os, pickle=pickle)(
                    root, *schedule)
            jax_fn = _jax_fn("_completed_run_dirs", os=os,
                             pickle=_meta_reader(jread))
        assert got == jax_fn(root, *schedule)


@pytest.fixture(scope="module")
def tiny_fold(tmp_path_factory):
    """One tiny 6-2-2 fold (the twin's curation), the tiny cached args,
    the twin's grid setup and the JAX package's, and the JAX init."""
    base = str(tmp_path_factory.mktemp("gsp"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GP, "SAMPLES", {True: TINY_SAMPLES,
                                   False: TINY_SAMPLES})
        import random
        py_state, np_state = random.getstate(), np.random.get_state()
        dargs = GP.curate_fold(base, 0, True, "6-2-2")
        random.setstate(py_state)
        np.random.set_state(np_state)
    margs = dict(GP.base_model_args("6-2-2", False), **TINY, **TINY_DEPTH)
    setup = GP.selection_setup(base, GP.MODEL_TYPE, margs, dargs,
                               arch_tag="_f0", device="cpu", fold=0)
    # the JAX script's grid setup (:189-227) over the same cached args
    margs_file = os.path.join(base, "margs_base.txt")
    with open(margs_file, "w") as f:
        json.dump(margs, f)
    args_dict = {"save_root_path": os.path.join(base, "jax_runs_grid_f0"),
                 "model_type": GP.MODEL_TYPE,
                 "model_cached_args_file": margs_file,
                 "data_set_name": "data_fold0",
                 "data_cached_args_file": dargs}
    jconfig.read_in_model_args(args_dict)
    jconfig.read_in_data_args(args_dict)
    jdriver.rescale_dataset_dependent_coefficients(args_dict)
    jmodel = jorch.create_model_instance(args_dict)
    jtrain, jval = jorch.get_data_for_model_training(args_dict,
                                                     grid_search=False)
    jtc = jtr.RedcliffTrainConfig(
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
    jinit = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return dict(base=base, dargs=dargs, margs=margs, setup=setup,
                jax=(args_dict, jmodel, jtrain, jval, jtc), jinit=jinit)


class _Stop(Exception):
    pass


def test_both_legs_start_from_the_same_weights(tiny_fold, monkeypatch):
    """The array task's fit and the grid leg's lanes are handed the same
    model config and the same weights: the grid's default init is the
    array task's (a generator seeded with 0)."""
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    handed = {}

    def task_fit(self, params, *a, **kw):
        handed["task"] = (self.model.config, params)
        raise _Stop

    def grid(model, tc, points, *a, init_point_params=None, **kw):
        handed["grid"] = (model.config, init_point_params)
        raise _Stop

    monkeypatch.setattr(ttr.RedcliffTrainer, "fit", task_fit)
    monkeypatch.setattr(TG, "run_coefficient_grid", grid)
    base = os.path.join(tiny_fold["base"], "same_init")
    os.makedirs(base)
    with pytest.raises(_Stop):
        GP.per_point_leg(base, 0, tiny_fold["margs"], tiny_fold["dargs"],
                         device="cpu")
    args_dict, model, train_ds, val_ds, tc = tiny_fold["setup"]
    with pytest.raises(_Stop):
        GP.fit_grid(model, tc, [{"gen_lr": 1e-3}], train_ds, val_ds,
                    device="cpu")
    (tcfg, tparams), (gcfg, gparams) = handed["task"], handed["grid"]
    assert tcfg == gcfg
    tl, gl = interop.tree_leaves(tparams), interop.tree_leaves(gparams)
    assert len(tl) == len(gl) > 0
    for a, b in zip(tl, gl):
        assert a.device.type == b.device.type == "cpu"
        assert torch.equal(a, b)


def test_grid_leg_matches_jax_grid(tiny_fold, tmp_path, monkeypatch):
    """4 points, 3 epochs: the JAX script's grid leg from
    ``model.init(PRNGKey(0))`` and the twin's from that init, at the grid
    bars, the same best epochs and winner; each point's optimal F1 from
    both packages' battery."""
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    args_dict, model, train_ds, val_ds, tc = tiny_fold["setup"]
    jargs, jmodel, jtrain, jval, jtc = tiny_fold["jax"]
    points = GP._grid_points()

    def jax_adj(raw):
        d = {"coeff_dict": {"ADJ_L1_REG_COEFF": raw},
             "num_factors": jargs["num_factors"],
             "num_channels": jargs["num_channels"]}
        jdriver.rescale_dataset_dependent_coefficients(d)
        return d["coeff_dict"]["ADJ_L1_REG_COEFF"]

    grid_points = [{"gen_lr": p["gen_lr"],
                    "adj_l1_reg_coeff": GP.rescaled_adj(
                        p["ADJ_L1_REG_COEFF"], args_dict["num_factors"],
                        args_dict["num_channels"])} for p in points]
    assert grid_points == [{"gen_lr": p["gen_lr"],
                            "adj_l1_reg_coeff": jax_adj(
                                p["ADJ_L1_REG_COEFF"])} for p in points]
    jinit = tiny_fold["jinit"]
    jres = jdriver.run_coefficient_grid(
        jmodel, jtc, grid_points, jtrain, jval, key=jax.random.PRNGKey(0),
        init_point_params=jinit)
    tres, _ = GP.fit_grid(model, tc, grid_points, train_ds, val_ds,
                          init_point_params=interop.params_from_jax(jinit),
                          device="cpu")
    assert tres.val_history.shape == (3, 4)
    np.testing.assert_allclose(tres.val_history, jres.val_history, **HIST)
    np.testing.assert_allclose(tres.best_criteria, jres.best_criteria,
                               **HIST)
    np.testing.assert_array_equal(tres.best_epoch, jres.best_epoch)
    assert int(np.argmin(np.asarray(tres.best_criteria, np.float64))) == \
        int(np.argmin(np.asarray(jres.best_criteria, np.float64)))

    true_gcs = GP.load_true_gc_factors(tiny_fold["dargs"])
    jtrue = jconfig.load_true_gc_factors(tiny_fold["dargs"])
    base = str(tmp_path)
    for i in range(len(points)):
        run = GP.write_point(base, "_f0", model, tres, i)
        assert run == os.path.join(base, "runs_grid_f0", f"grid_point{i}")
        got = GP._offdiag_stats(GP.evaluate_algorithm_on_fold(
            run, GP.MODEL_TYPE, true_gcs, device="cpu"))
        jrun = tmp_path / "jax" / f"grid_point{i}"
        jrun.mkdir(parents=True)
        with open(jrun / "final_best_model.bin", "wb") as f:
            pickle.dump({"model_class": "RedcliffSCMLP",
                         "config": jmodel.config,
                         "params": jax.tree.map(
                             lambda x, i=i: np.asarray(x)[i],
                             jres.best_params)}, f)
        want = jcross.evaluate_algorithm_on_fold(str(jrun), GP.MODEL_TYPE,
                                                 jtrue)[GP.OFFDIAG]
        np.testing.assert_allclose(got["optimal_f1"],
                                   want["f1_mean_across_factors"],
                                   rtol=F1_RTOL)
        np.testing.assert_allclose(got["roc_auc"],
                                   want["roc_auc_mean_across_factors"],
                                   rtol=F1_RTOL)


def test_per_point_leg_matches_jax_array_task(tiny_fold, monkeypatch):
    """One point (gen_lr 2e-3, ADJ_L1 0.01) through the twin's per-point
    leg with the port's init patched to the JAX init, against the JAX
    array task on the cached args the leg wrote: the same run folder,
    best epoch, histories and best params at the trainer bars, and both
    scripts' completion rule on both runs."""
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    point = GP._grid_points()[3]
    monkeypatch.setattr(GP, "_grid_points", lambda: [point])
    monkeypatch.setattr(
        tred.RedcliffSCMLP, "init",
        lambda self, generator, device="cpu": interop.params_from_jax(
            tiny_fold["jinit"], device))
    base = os.path.join(tiny_fold["base"], "per_point")
    os.makedirs(base)
    margs = tiny_fold["margs"]
    (rec,), wall, trained = GP.per_point_leg(base, 0, margs,
                                             tiny_fold["dargs"],
                                             device="cpu")
    assert trained == 1 and wall > 0 and rec["resumed"] is False
    assert rec["point"] == point
    margs_file = os.path.join(base, f"{GP.MODEL_TYPE}_point0_cached_args.txt")
    with open(margs_file) as f:
        written = json.load(f)
    assert written == dict(margs, gen_lr=repr(point["gen_lr"]),
                           ADJ_L1_REG_COEFF=repr(point["ADJ_L1_REG_COEFF"]))
    jroot = os.path.join(base, "jax_point0")
    os.makedirs(jroot)
    jdriver.set_up_and_run_experiments(
        {"save_root_path": jroot}, [margs_file], [tiny_fold["dargs"]],
        possible_model_types=[GP.MODEL_TYPE],
        possible_data_sets=["data_fold0"], task_id=1)
    schedule = (int(margs["num_pretrain_epochs"])
                + int(margs["num_acclimation_epochs"]),
                int(margs["max_iter"]), int(margs["lookback"]),
                int(margs["check_every"]))
    jax_done = _jax_fn("_completed_run_dirs", os=os,
                       pickle=_meta_reader(jread))(jroot, *schedule)
    assert len(jax_done) == 1
    assert GP._completed_run_dirs(jroot, *schedule) == jax_done
    jrun = os.path.join(jroot, jax_done[0])
    assert os.path.basename(rec["run_dir"]) == jax_done[0]
    jm = jread(os.path.join(jrun, META))
    tm = read_checkpoint(os.path.join(rec["run_dir"], META))
    assert rec["best_it"] == tm["best_it"] == jm["best_it"]
    np.testing.assert_allclose(rec["best_loss"], jm["best_loss"], **HIST)
    np.testing.assert_allclose(tm["avg_combo_loss"], jm["avg_combo_loss"],
                               **HIST)
    ja = jread(os.path.join(jrun, "final_best_model.bin"))
    ta = read_checkpoint(os.path.join(rec["run_dir"], "final_best_model.bin"))
    for a, b in zip(jax.tree.leaves(ja["params"]),
                    interop.tree_leaves(ta["params"])):
        np.testing.assert_allclose(np.asarray(b), a, **PARAMS)


def _tiny_main(monkeypatch):
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    monkeypatch.setattr(GP, "REDCLIFF_ARGS",
                        dict(GP.REDCLIFF_ARGS, **TINY))
    monkeypatch.setattr(GP, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})


def test_smoke_flow_runs_twice_on_cpu_into_its_work_dir(tmp_path,
                                                         monkeypatch):
    """``main([wd, "--smoke", "--folds", "1"], device="cpu")`` at a tiny
    width with the JAX script's smoke cuts, twice: the JSON lands under
    ``wd + "_6-2-2_smoke"`` with the JAX script's key sets and nothing
    under ``experiments/`` changes; the second call reuses all four
    per-point runs and carries the first call's trained wall forward."""
    _tiny_main(monkeypatch)
    exp = os.path.join(REPO, "experiments")
    before = {f: os.path.getmtime(os.path.join(exp, f))
              for f in os.listdir(exp)}
    wd = str(tmp_path / "gsp")
    base = wd + "_6-2-2_smoke"
    dest = os.path.join(base, "GRID_SCIENCE_PARITY_smoke.json")
    outs, records = [], []
    for _ in range(2):
        records.append([])
        outs.append(GP.main([wd, "--smoke", "--folds", "1"], device="cpu",
                            records=records[-1]))
        with open(dest) as f:
            assert json.load(f) == json.loads(json.dumps(outs[-1]))
    assert {f: os.path.getmtime(os.path.join(exp, f))
            for f in os.listdir(exp)} == before
    assert os.listdir(tmp_path) == [os.path.basename(base)]
    first, second = outs
    for out in outs:
        assert set(out) == set(JSON_KEYS)
        assert out["smoke"] is True and out["num_folds"] == 1
        (fold,) = out["folds"]
        assert set(fold) == set(JSON_FOLD_KEYS)
        losses = [p["best_loss"] for p in fold["per_point"]]
        crit = [g["best_criteria"] for g in fold["grid"]]
        assert len(losses) == len(crit) == 4
        assert np.isfinite(losses).all() and np.isfinite(crit).all()
        assert fold["same_winner"] == (int(np.argmin(losses))
                                       == int(np.argmin(crit)))
        assert fold["spearman_rank_correlation"] == GP.spearman(
            np.asarray(losses), np.asarray(crit, np.float64))
        assert out["wall_clock_s_by_fold"] == [fold["wall_clock_s"]]
    w1 = first["folds"][0]["wall_clock_s"]
    w2 = second["folds"][0]["wall_clock_s"]
    assert w1["points_trained"] == 4 and w1["per_point_trained"] is True
    assert "carried_forward" not in w1
    assert not any(p["resumed"] for p in first["folds"][0]["per_point"])
    assert all(p["resumed"] for p in second["folds"][0]["per_point"])
    assert w2["points_trained"] == 0 and w2["carried_forward"] is True
    assert w2["per_point_trained"] is True
    assert w2["per_point_total"] == w1["per_point_total"]
    assert [p["best_loss"] for p in second["folds"][0]["per_point"]] == \
        [p["best_loss"] for p in first["folds"][0]["per_point"]]
    assert records[0][0]["per_point_runs"] == records[1][0]["per_point_runs"]
    for run in records[0][0]["per_point_runs"] + records[0][0]["grid_runs"]:
        assert run.startswith(base + os.sep)
        assert os.path.isfile(os.path.join(run, "final_best_model.bin"))
    # the flat tree ranks the four per-point runs
    rankings = first["folds"][0]["grid_selection_rankings"]
    assert rankings and all(len(v["ranking"]) == 4
                            for v in rankings.values())


def test_main_names_its_json_by_system(tmp_path, monkeypatch):
    """A system other than 6-2-2 gets its own work dir and file, and its
    factor count in the cached args; a fold whose leg resumed takes the
    trained wall of an earlier JSON of the same system only."""
    seen = []

    def fold_record(base, fold, base_margs, smoke, system, device=None,
                    records=None):
        seen.append((base, base_margs["num_factors"], smoke, system))
        trained = not os.path.exists(os.path.join(
            base, "GRID_SCIENCE_PARITY_6_2_3.json"))
        return {"fold": fold, "same_winner": True,
                "spearman_rank_correlation": 1.0,
                "winner_science_delta_optf1": 0.0,
                "wall_clock_s": {"per_point_total": 7.0 if trained else 0.1,
                                 "per_point_trained": trained,
                                 "points_trained": 4 if trained else 0,
                                 "grid_total": 1.0}}

    monkeypatch.setattr(GP, "run_fold", fold_record)
    wd = str(tmp_path / "gsp")
    out = GP.main([wd, "--system", "6-2-3", "--folds", "2"], device="cpu")
    base = wd + "_6-2-3"
    assert seen == [(base, "3", False, "6-2-3")] * 2
    assert out["system"] == "6-2-3 (reference synSys config)"
    dest = os.path.join(base, "GRID_SCIENCE_PARITY_6_2_3.json")
    assert os.path.isfile(dest)
    again = GP.main([wd, "--system", "6-2-3", "--folds", "2"], device="cpu")
    assert [w["per_point_total"] for w in again["wall_clock_s_by_fold"]] \
        == [7.0, 7.0]
    assert all(w["carried_forward"] for w in again["wall_clock_s_by_fold"])
    # another system's JSON at the path is not carried from
    with open(dest) as f:
        prev = json.load(f)
    prev["system"] = "6-2-2 (reference synSys config)"
    with open(dest, "w") as f:
        json.dump(prev, f)
    third = GP.main([wd, "--system", "6-2-3", "--folds", "2"], device="cpu")
    assert [w["per_point_total"] for w in third["wall_clock_s_by_fold"]] \
        == [0.1, 0.1]


def test_main_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GP.main([str(tmp_path / "gsp"), "--smoke"])
    assert not os.path.exists(str(tmp_path / "gsp_6-2-2_smoke"))


@pytest.mark.gpu
def test_fold_on_card_matches_cpu(tmp_path, monkeypatch):
    """On the card: one tiny fold (1 + 1 + 1 epochs) through both legs
    against the same fold on the CPU: the per-point best losses and the
    grid's criteria at the grid bars, the same best epochs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the factor-mix kernel runs on it")
    _tiny_main(monkeypatch)
    margs = dict(GP.base_model_args("6-2-2", False), **TINY, **TINY_DEPTH)
    folds = []
    for device in ("cpu", "cuda"):
        folds.append(GP.run_fold(str(tmp_path / device), 0, margs, True,
                                 "6-2-2", device=device))
    cpu, card = folds
    for key, sub in (("per_point", "best_loss"), ("grid", "best_criteria")):
        np.testing.assert_allclose([p[sub] for p in card[key]],
                                   [p[sub] for p in cpu[key]], **HIST)
    assert [p["best_it"] for p in card["per_point"]] == \
        [p["best_it"] for p in cpu["per_point"]]
    assert [g["best_epoch"] for g in card["grid"]] == \
        [g["best_epoch"] for g in cpu["grid"]]
