"""The Smooth-searched D4IC study in the port: the twin
``redcliff_tpu_torch/experiments/d4ic_smooth_searched.py`` of the JAX
package's ``experiments/d4ic_smooth_searched.py``.

The JAX script is read with ``ast``, never imported (it pins JAX's
platform at import): its searched coefficients over the Smooth cached
args, the smoke cuts, sample counts, tiers, model type, the rows it
records beside its result and the key set of its JSON are held to the
twin's. At a tiny width and depth one curated fold goes through the twin's
``main`` and through the JAX package's array task and battery from the
same JAX init (the Smooth class on both sides); the twin writes only into
its work directory and asks for CUDA by default.
"""
import ast
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.eval import cross_alg as jcross  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.runtime.checkpoint import read_checkpoint as jread  # noqa: E402,E501
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu.utils import config as jconfig  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.experiments import accuracy_parity_d4ic as TD  # noqa: E402,E501
from redcliff_tpu_torch.experiments import d4ic_grid_search as TG  # noqa: E402,E501
from redcliff_tpu_torch.experiments import d4ic_smooth_searched as SS  # noqa: E402,E501
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "d4ic_smooth_searched.py")
META = "training_meta_data_and_hyper_parameters.pkl"

# the trainer bars (tests/test_torch_driver.py); the scores' bar
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)
F1_RTOL = 1e-5

# the searched Smooth args at a tiny width; a depth of 1 + 1 + 1 epochs
TINY = dict(gen_hidden="[4]", batch_size="8", embed_num_hidden_nodes="8",
            embed_num_graph_conv_layers="1")
TINY_DEPTH = dict(max_iter="3", num_pretrain_epochs="1",
                  num_acclimation_epochs="1", check_every="1")
TINY_SAMPLES = (4, 2)


@pytest.fixture(autouse=True)
def _restore_global_rngs():
    """Curation runs the graph factory, which seeds ``random`` and
    ``np.random`` globally: leave both as they were."""
    import random

    py_state, np_state = random.getstate(), np.random.get_state()
    yield
    random.setstate(py_state)
    np.random.set_state(np_state)


def _tree(path):
    return ast.parse(open(path).read())


def _main_def():
    return next(n for n in _tree(SCRIPT).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _assigned(node, name):
    """The value node of ``name = ...`` under ``node``."""
    for n in ast.walk(node):
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == name):
            return n.value
    raise KeyError(name)


def _out_dict():
    """The JSON dict literal of the JAX script's ``main``, by key."""
    out = _assigned(_main_def(), "out")
    return dict(zip((k.value for k in out.keys), out.values))


def _jax_smooth_args():
    """``SMOOTH_ARGS`` of the JAX ``experiments/accuracy_parity_d4ic.py``,
    evaluated from its source."""
    path = os.path.join(REPO, "experiments", "accuracy_parity_d4ic.py")
    module = _tree(path)
    ns = {"dict": dict,
          "REDCLIFF_ARGS": ast.literal_eval(_assigned(module,
                                                      "REDCLIFF_ARGS"))}
    expr = ast.Expression(_assigned(module, "SMOOTH_ARGS"))
    return eval(compile(expr, path, "eval"), ns)


def test_coefficients_cuts_samples_and_rows_are_transcribed():
    smooth = _jax_smooth_args()
    assert TD.SMOOTH_ARGS == smooth
    expr = ast.Expression(_assigned(_tree(SCRIPT), "SEARCHED"))
    assert SS.SEARCHED == eval(compile(expr, SCRIPT, "eval"),
                               {"dict": dict, "SMOOTH_ARGS": smooth})
    main = _main_def()
    update = next(n for n in ast.walk(main)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)
                  and n.func.attr == "update"
                  and isinstance(n.func.value, ast.Name)
                  and n.func.value.id == "margs")
    cuts = {k.arg: ast.literal_eval(k.value) for k in update.keywords}
    assert SS.model_args(True) == dict(SS.SEARCHED, **cuts)
    assert SS.model_args(False) == SS.SEARCHED
    samples = next(
        n.value for n in ast.walk(main)
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Tuple)
        and [e.id for e in n.targets[0].elts] == ["n_train", "n_val"])
    assert SS.SAMPLES == {True: ast.literal_eval(samples.body),
                          False: ast.literal_eval(samples.orelse)}
    tiers = _assigned(main, "tiers")
    assert isinstance(tiers.body, ast.Name) and tiers.body.id == "TIERS"
    assert ast.literal_eval(tiers.orelse) == ("HSNR",)
    run = next(n for n in ast.walk(main)
               if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               and n.func.id == "set_up_and_run_experiments")
    types = next(k.value for k in run.keywords
                 if k.arg == "possible_model_types")
    assert ast.literal_eval(types) == [SS.MODEL_TYPE]
    out = _out_dict()
    assert ast.literal_eval(out["coefficients"]) == SS.COEFFICIENTS
    assert ast.literal_eval(out["round4_smooth_transcribed"]) == \
        SS.ROUND4_SMOOTH
    assert ast.literal_eval(out["round5_nonsmooth_searched"]) == \
        SS.ROUND5_NONSMOOTH
    # the coefficients the JSON records are the ones trained
    for key, value in SS.COEFFICIENTS.items():
        assert float(SS.SEARCHED[key]) == value


def _jax_pooled_offdiag():
    """``pooled_offdiag`` of the JAX ``experiments/d4ic_grid_search.py``,
    exec'd from its source."""
    path = os.path.join(REPO, "experiments", "d4ic_grid_search.py")
    fn = next(n for n in _tree(path).body
              if isinstance(n, ast.FunctionDef) and n.name == "pooled_offdiag")
    ns = {"np": np, "OFFDIAG": TG.OFFDIAG}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["pooled_offdiag"]


def _tiny(monkeypatch):
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    monkeypatch.setattr(SS, "SEARCHED", dict(SS.SEARCHED, **TINY))
    monkeypatch.setattr(SS, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})


def test_smoke_flow_matches_jax_array_task_from_one_init(tmp_path,
                                                         monkeypatch):
    """The twin's ``main`` at a tiny width and depth with the port's init
    patched to the JAX init, against the JAX array task (the JAX script's
    ``set_up_and_run_experiments`` call on the same cached args and fold),
    its battery and ``pooled_offdiag``: the same run folder, best epoch,
    histories and best params at the trainer bars, the row at the scores'
    bar."""
    _tiny(monkeypatch)
    monkeypatch.setattr(SS, "SMOKE_CUTS", TINY_DEPTH)
    inits = {}

    def jax_init(config):
        if "init" not in inits:
            jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(
                **dataclasses.asdict(config)))
            inits["init"] = jax.tree.map(
                np.asarray, jm.init(jax.random.PRNGKey(0)))
        return inits["init"]

    def copied_init(self, generator, device="cpu"):
        return interop.params_from_jax(jax_init(self.config), device)

    monkeypatch.setattr(tred.RedcliffSCMLP, "init", copied_init)
    wd = str(tmp_path / "ss")
    records = {}
    out = SS.main([wd, "--smoke", "--folds", "1"], device="cpu",
                  records=records)
    (port_run,) = records["run_dirs"]
    base = wd + "_smoke"
    dargs = os.path.join(base, "data", "d4ic_HSNR", "fold_0",
                         "data_fold0_cached_args.txt")
    margs = os.path.join(base, f"{SS.MODEL_TYPE}_cached_args.txt")
    jroot = tmp_path / "jax_runs"
    jroot.mkdir()
    jdriver.set_up_and_run_experiments(
        {"save_root_path": str(jroot)}, [margs], [dargs],
        possible_model_types=[SS.MODEL_TYPE],
        possible_data_sets=["data_fold0"], task_id=1)
    jax_run = jcross.find_run_directory(str(jroot), "data", 0)
    assert os.path.basename(port_run) == os.path.basename(jax_run)
    jm, tm = jread(os.path.join(jax_run, META)), read_checkpoint(
        os.path.join(port_run, META))
    assert tm["epoch"] == jm["epoch"] == 2
    assert tm["best_it"] == jm["best_it"]
    np.testing.assert_allclose(tm["avg_combo_loss"], jm["avg_combo_loss"],
                               **HIST)
    ja = jread(os.path.join(jax_run, "final_best_model.bin"))
    ta = read_checkpoint(os.path.join(port_run, "final_best_model.bin"))
    assert ta["config"].factor_weight_smoothing_penalty_coeff == \
        ja["config"].factor_weight_smoothing_penalty_coeff
    assert dataclasses.asdict(ta["config"]) == \
        dataclasses.asdict(ja["config"])
    for a, b in zip(jax.tree.leaves(ja["params"]),
                    interop.tree_leaves(ta["params"])):
        np.testing.assert_allclose(np.asarray(b), a, **PARAMS)
    jrow = _jax_pooled_offdiag()([jcross.evaluate_algorithm_on_fold(
        jax_run, "REDCLIFF_S_CMLP", jconfig.load_true_gc_factors(dargs))])
    assert set(out["rows"]) == {"HSNR"}
    assert set(out["rows"]["HSNR"]) == set(jrow)
    for key, value in jrow.items():
        np.testing.assert_allclose(out["rows"]["HSNR"][key], value,
                                   rtol=F1_RTOL)


def test_smoke_flow_runs_on_cpu_into_its_work_dir(tmp_path, monkeypatch):
    """``main([wd, "--smoke", "--folds", "1"], device="cpu")`` at a tiny
    width with the JAX script's smoke cuts: the JSON lands under
    ``wd + "_smoke"`` with the JAX script's key set, the run dir holds the
    Smooth model, and nothing under ``experiments/`` changes."""
    _tiny(monkeypatch)
    exp = os.path.join(REPO, "experiments")
    before = {f: os.path.getmtime(os.path.join(exp, f))
              for f in os.listdir(exp)}
    wd = str(tmp_path / "ss")
    records = {}
    out = SS.main([wd, "--smoke", "--folds", "1"], device="cpu",
                  records=records)
    assert {f: os.path.getmtime(os.path.join(exp, f))
            for f in os.listdir(exp)} == before
    dest = os.path.join(wd + "_smoke", "D4IC_SMOOTH_SEARCHED_smoke.json")
    with open(dest) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert not os.path.exists(wd)
    assert os.listdir(tmp_path) == ["ss_smoke"]
    assert set(out) == set(_out_dict())
    assert out["smoke"] is True and out["folds"] == 1
    assert set(out["rows"]) == {"HSNR"}
    assert all(np.isfinite(v) for v in out["rows"]["HSNR"].values())
    (run_dir,) = records["run_dirs"]
    assert os.path.basename(run_dir).startswith(
        f"{SS.MODEL_TYPE}_data_fold0")
    meta = read_checkpoint(os.path.join(run_dir, META))
    assert meta["epoch"] + 1 <= int(SS.SMOKE_CUTS["max_iter"])
    cfg = read_checkpoint(os.path.join(run_dir,
                                       "final_best_model.bin"))["config"]
    assert cfg.embed_lag == int(SS.SEARCHED["embed_lag"]) == 20
    assert cfg.factor_cos_sim_coeff > 0 and cfg.gen_hidden == (4,)


def test_main_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SS.main([str(tmp_path / "ss"), "--smoke"])
    assert not os.path.exists(str(tmp_path / "ss_smoke"))


@pytest.mark.gpu
def test_smooth_fit_on_card_matches_cpu(tmp_path, monkeypatch):
    """On the card: the twin's tiny flow (1 + 1 + 1 epochs, one fold
    curated on the CPU) against the same flow on the CPU from the same
    init: histories and best params at the trainer bars, the same best
    epoch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the factor-mix kernel runs on it")
    _tiny(monkeypatch)
    monkeypatch.setattr(SS, "SMOKE_CUTS", TINY_DEPTH)
    metas, params = [], []
    for device in ("cpu", "cuda"):
        wd = str(tmp_path / device)
        # curation on the CPU in both: the recordings are the same
        TG.curate_tier_fold(wd + "_smoke", "HSNR", 0, *TINY_SAMPLES,
                            device="cpu")
        records = {}
        SS.main([wd, "--smoke", "--folds", "1"], device=device,
                records=records)
        (run_dir,) = records["run_dirs"]
        metas.append(read_checkpoint(os.path.join(run_dir, META)))
        params.append(read_checkpoint(os.path.join(
            run_dir, "final_best_model.bin"))["params"])
    cpu, card = metas
    assert card["best_it"] == cpu["best_it"]
    np.testing.assert_allclose(card["avg_combo_loss"],
                               cpu["avg_combo_loss"], **HIST)
    for a, b in zip(interop.tree_leaves(params[0]),
                    interop.tree_leaves(params[1])):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **PARAMS)
