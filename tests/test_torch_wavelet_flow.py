"""The wavelet-decomposed flow in the port: the twin
``redcliff_tpu_torch/experiments/wavelet_flow.py`` of the JAX package's
``experiments/wavelet_flow.py``.

The JAX script is read with ``ast``, never imported (it pins JAX's
platform at import): its constants, the three configurations built over
the synSys cached args, the smoke cuts, sample counts, the fold's
curation and the key set of its JSON are held to the twin's, and its
``ranked_readout_offdiag`` is exec'd from its source. A tiny fold is
curated bit for bit as the JAX package curates it; at a tiny width and
depth the twin's ``main`` and the JAX package's array tasks train the
wavelet Smooth REDCLIFF-S and the wavelet cMLP from one JAX init; the
twin writes only into its work directory and asks for CUDA by default.
"""
import ast
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.data import curation as jcuration  # noqa: E402
from redcliff_tpu.eval import cross_alg as jcross  # noqa: E402
from redcliff_tpu.eval import stats as jstats  # noqa: E402
from redcliff_tpu.eval.model_io import load_model_for_eval as jload  # noqa: E402,E501
from redcliff_tpu.models import cmlp_fm as jcmlp  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.runtime.checkpoint import read_checkpoint as jread  # noqa: E402,E501
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu.utils import config as jconfig  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.eval import cross_alg as tcross  # noqa: E402
from redcliff_tpu_torch.experiments import accuracy_parity_synsys as TSYN  # noqa: E402,E501
from redcliff_tpu_torch.experiments import wavelet_flow as WF  # noqa: E402
from redcliff_tpu_torch.models import cmlp_fm as tcmlp  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "wavelet_flow.py")
SYNSYS = os.path.join(REPO, "experiments", "accuracy_parity_synsys.py")
META = "training_meta_data_and_hyper_parameters.pkl"

# the trainer bars (tests/test_torch_driver.py); the scores' bar
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)
F1_RTOL = 1e-5

# each configuration at a tiny width (gen_hidden [8]); a depth of
# 1 + 1 + 1 epochs for REDCLIFF-S and 3 for cMLP
TINY = {"REDCLIFF": dict(gen_hidden="[8]", batch_size="8",
                         embed_num_hidden_nodes="8",
                         embed_num_graph_conv_layers="1"),
        "cMLP": dict(gen_hidden="[8]", batch_size="8")}
TINY_DEPTH = {"REDCLIFF": dict(max_iter="3", num_pretrain_epochs="1",
                               num_acclimation_epochs="1", check_every="1"),
              "cMLP": dict(max_iter="3", check_every="1")}
TINY_SAMPLES = (8, 4)
# the wavelet runs both packages train, by alias
WAVELET_RUNS = ("REDCLIFF_Smooth_wav", "CMLP_wav")


@pytest.fixture(autouse=True)
def _restore_global_rngs():
    """Curation runs the graph factory, which seeds ``random`` and
    ``np.random`` globally: leave both as they were."""
    import random

    py_state, np_state = random.getstate(), np.random.get_state()
    yield
    random.setstate(py_state)
    np.random.set_state(np_state)


def _tree(path=SCRIPT):
    return ast.parse(open(path).read())


def _def(name):
    return next(n for n in _tree().body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _assigned(node, name):
    """The value node of ``name = ...`` under ``node``."""
    for n in ast.walk(node):
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == name):
            return n.value
    raise KeyError(name)


def _module_ns():
    """The JAX script's module-level constants and configurations,
    evaluated from its source over the JAX synSys script's cached args."""
    synsys = _tree(SYNSYS)
    ns = {"dict": dict,
          "REDCLIFF_ARGS": ast.literal_eval(_assigned(synsys,
                                                      "REDCLIFF_ARGS")),
          "CMLP_ARGS": ast.literal_eval(_assigned(synsys, "CMLP_ARGS"))}
    for node in _tree().body:
        if isinstance(node, ast.Assign):
            exec(compile(ast.Module(body=[node], type_ignores=[]), SCRIPT,
                         "exec"), ns)
    return ns


def _jax_fn(name, **ns):
    """A function of the JAX script, exec'd from its source in ``ns``."""
    exec(compile(ast.Module(body=[_def(name)], type_ignores=[]), SCRIPT,
                 "exec"), ns)
    return ns[name]


def _out_keys():
    out = _assigned(_def("main"), "out")
    return {k.value for k in out.keys}


def _row_keys():
    """Every key the JAX ``main`` writes into a row."""
    keys = {k.value for k in _assigned(_def("main"), "row").keys}
    for n in ast.walk(_def("main")):
        if (isinstance(n, ast.Assign) and isinstance(n.targets[0],
                                                     ast.Subscript)
                and isinstance(n.targets[0].value, ast.Name)
                and n.targets[0].value.id == "row"):
            keys.add(n.targets[0].slice.value)
    return keys


def test_constants_configurations_cuts_and_keys_are_transcribed():
    ns = _module_ns()
    assert TSYN.REDCLIFF_ARGS == ns["REDCLIFF_ARGS"]
    assert TSYN.CMLP_ARGS == ns["CMLP_ARGS"]
    for name in ("OFFDIAG", "WAVELET_LEVEL", "RECORDING_LEN", "NUM_NODES",
                 "NUM_EDGES", "NUM_STATES", "SMOOTH_WAVELET_ARGS",
                 "CMLP_WAVELET_ARGS", "SMOOTH_CONTROL_ARGS", "MODELS"):
        assert getattr(WF, name) == ns[name], name
    main = _def("main")
    # the smoke cuts: the loop over the two REDCLIFF types, then cMLP's
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For)
                and isinstance(n.iter, ast.Tuple))
    (update,) = [n for n in ast.walk(loop) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)
                 and n.func.attr == "update"]
    cuts = {k.arg: ast.literal_eval(k.value) for k in update.keywords}
    cmlp = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "update"
                and isinstance(n.func.value, ast.Subscript)
                and n.func.value.slice.value == "cMLP")
    want = {name: dict(a) for name, a, _ in ns["MODELS"]}
    for name in ast.literal_eval(loop.iter):
        want[name].update(cuts)
    want["cMLP"].update({k.arg: ast.literal_eval(k.value)
                         for k in cmlp.keywords})
    assert WF.model_args(True) == want
    assert WF.model_args(False) == {name: dict(a)
                                    for name, a, _ in ns["MODELS"]}
    samples = next(
        n.value for n in ast.walk(main)
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Tuple)
        and [e.id for e in n.targets[0].elts] == ["n_train", "n_val"])
    assert WF.SAMPLES == {True: ast.literal_eval(samples.body),
                          False: ast.literal_eval(samples.orelse)}
    folds = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                 and any(isinstance(a, ast.Constant) and a.value == "--folds"
                         for a in n.args))
    default = next(k.value.value for k in folds.keywords
                   if k.arg == "default")
    assert WF.parse_args(["wd"]).folds == default == 2
    assert set(WF.result_row([0.1, 0.2], [])) == _row_keys() - {
        "ranked_offdiag_optimal_f1_mean", "ranked_offdiag_optimal_f1_sem"}
    assert set(WF.result_row([0.1, 0.2], [0.3])) == _row_keys()


@pytest.mark.parametrize("pooled,ranked", [
    ([0.25, 0.5, 0.125], [0.5, 0.75]), ([0.4], [0.3]), ([0.1, 0.3], [])])
def test_result_row_matches_the_jax_scripts(pooled, ranked):
    """The row's expressions of the JAX ``main``, exec'd on the same
    pooled F1s: equal floats, one pooled value giving a 0.0 SEM."""
    loop = next(n for n in ast.walk(_def("main")) if isinstance(n, ast.For)
                and isinstance(n.iter, ast.Name) and n.iter.id == "MODELS")
    start = next(i for i, n in enumerate(loop.body)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "f1")
    body = loop.body[start:start + 3]
    ns = {"np": np, "pooled": pooled, "pooled_ranked": ranked}
    exec(compile(ast.Module(body=body, type_ignores=[]), SCRIPT, "exec"), ns)
    assert WF.result_row(pooled, ranked) == ns["row"]


def _fold_call_kwargs(base, fold, n_train, n_val):
    """The JAX script's ``curate_synthetic_fold`` call, its arguments
    evaluated for this fold."""
    call = next(n for n in ast.walk(_def("main"))
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "curate_synthetic_fold")
    ns = dict(_module_ns(), os=os, base=base, fold=fold, n_train=n_train,
              n_val=n_val)

    def ev(node):
        return eval(compile(ast.Expression(node), SCRIPT, "eval"), ns)
    return [ev(a) for a in call.args], {k.arg: ev(k.value)
                                        for k in call.keywords}


def test_fold_is_curated_as_the_jax_script_curates_it(tmp_path,
                                                      monkeypatch):
    """The twin's ``curate_fold`` calls the port's curation with every
    argument of the JAX call; at a tiny size its fold equals the JAX
    package's file for file, byte for byte (the cached args' data root
    aside)."""
    seen = []
    real = WF.curate_synthetic_fold
    monkeypatch.setattr(WF, "curate_synthetic_fold",
                        lambda *a, **kw: seen.append((a, kw)) or real(*a,
                                                                      **kw))
    port = str(tmp_path / "port")
    dargs = WF.curate_fold(port, 1, *TINY_SAMPLES)
    a, kw = seen.pop()
    assert (list(a), kw) == _fold_call_kwargs(port, 1, *TINY_SAMPLES)
    ja, jkw = _fold_call_kwargs(str(tmp_path / "jax"), 1, *TINY_SAMPLES)
    jdir, _ = jcuration.curate_synthetic_fold(*ja, **jkw)
    assert dargs == os.path.join(os.path.dirname(dargs),
                                 "data_fold1_cached_args.txt")
    pdir = os.path.dirname(dargs)
    files = sorted(os.path.relpath(os.path.join(r, f), pdir)
                   for r, _, fs in os.walk(pdir) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), jdir)
                           for r, _, fs in os.walk(jdir) for f in fs)
    for rel in files:
        got = open(os.path.join(pdir, rel), "rb").read()
        want = open(os.path.join(jdir, rel), "rb").read()
        if rel.endswith("_cached_args.txt"):
            got, want = json.loads(got), json.loads(want)
            assert got.pop("data_root_path") == pdir
            assert want.pop("data_root_path") == jdir
        assert got == want, rel


def _tiny(monkeypatch, depth=True):
    """The twin at a tiny width, depth and sample count."""
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    models = tuple(
        (name, dict(a, **TINY["REDCLIFF" if "REDCLIFF" in name
                              else "cMLP"]), alias)
        for name, a, alias in WF.MODELS)
    monkeypatch.setattr(WF, "MODELS", models)
    if depth:
        monkeypatch.setattr(WF, "SMOKE_CUTS", {
            name: TINY_DEPTH["REDCLIFF" if "REDCLIFF" in name else "cMLP"]
            for name, _, _ in models})
    monkeypatch.setattr(WF, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})


def _copy_jax_inits(monkeypatch):
    """The port's REDCLIFF-S and cMLP-FM inits patched to the JAX
    package's, each from ``PRNGKey(0)`` as its array task seeds it."""
    pairs = ((tred.RedcliffSCMLP, jred.RedcliffSCMLP,
              jred.RedcliffSCMLPConfig),
             (tcmlp.CMLPFM, jcmlp.CMLPFM, jcmlp.CMLPFMConfig))
    for tcls, jcls, jcfg in pairs:
        def copied_init(self, generator, device="cpu", jcls=jcls, jcfg=jcfg):
            jm = jcls(jcfg(**dataclasses.asdict(self.config)))
            tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
            return interop.params_from_jax(tree, device)
        monkeypatch.setattr(tcls, "init", copied_init)


def test_tiny_flow_matches_jax_array_tasks_from_one_init(tmp_path,
                                                         monkeypatch):
    """The twin's ``main`` at a tiny width and depth, inits copied from
    JAX, against the JAX array tasks (the JAX script's
    ``set_up_and_run_experiments`` calls on the same cached args and
    fold) of the wavelet Smooth REDCLIFF-S and the wavelet cMLP: the same
    run folders and best epochs, histories and best params at the trainer
    bars, the same configs. On the JAX runs' params the twin's battery and
    ranked readout equal the JAX script's at the scores' bar, and the
    twin's rows hold to the JAX script's rows there too."""
    _tiny(monkeypatch)
    _copy_jax_inits(monkeypatch)
    wd = str(tmp_path / "wav")
    records = {}
    out = WF.main([wd, "--smoke", "--folds", "1"], device="cpu",
                  records=records)
    base = wd + "_smoke"
    dargs = os.path.join(base, "data", "lfpAnalog6_2_3", "fold_0",
                         "data_fold0_cached_args.txt")
    true = jconfig.load_true_gc_factors(dargs)
    jranked = _jax_fn("ranked_readout_offdiag", np=np,
                      load_model_for_eval=jload,
                      three_view_optimal_f1_stats=(
                          jstats.three_view_optimal_f1_stats),
                      OFFDIAG=WF.OFFDIAG)
    for model_type, _, alias in WF.MODELS:
        if alias not in WAVELET_RUNS:
            continue
        (port_run,) = records["run_dirs"][alias]
        jroot = tmp_path / f"jax_{alias}"
        jroot.mkdir()
        jdriver.set_up_and_run_experiments(
            {"save_root_path": str(jroot)},
            [os.path.join(base, f"{model_type}_cached_args.txt")], [dargs],
            possible_model_types=[model_type],
            possible_data_sets=["data_fold0"], task_id=1)
        jax_run = jcross.find_run_directory(str(jroot), "data", 0)
        assert os.path.basename(port_run) == os.path.basename(jax_run)
        jm = jread(os.path.join(jax_run, META))
        tm = read_checkpoint(os.path.join(port_run, META))
        assert tm["epoch"] == jm["epoch"] == 2
        assert tm["best_it"] == jm["best_it"]
        keys = ["avg_forecasting_loss", "avg_combo_loss"]
        if "REDCLIFF" in model_type:
            keys.append("avg_factor_loss")
        for key in keys:
            np.testing.assert_allclose(tm[key], jm[key], **HIST,
                                       err_msg=f"{alias} {key}")
        ja = jread(os.path.join(jax_run, "final_best_model.bin"))
        ta = read_checkpoint(os.path.join(port_run, "final_best_model.bin"))
        assert dataclasses.asdict(ta["config"]) == \
            dataclasses.asdict(ja["config"])
        assert ta["config"].wavelet_level == WF.WAVELET_LEVEL
        assert ta["config"].num_series == 4 * WF.NUM_NODES
        for a, b in zip(jax.tree.leaves(ja["params"]),
                        interop.tree_leaves(ta["params"])):
            np.testing.assert_allclose(np.asarray(b), a, **PARAMS)
        # the readouts on the same (JAX-trained) params
        alg = "REDCLIFF_S_CMLP" if "REDCLIFF" in model_type else "CMLP"
        want = jranked(jax_run, alg, true)
        assert len(want) == len(true)
        np.testing.assert_allclose(
            WF.ranked_readout_offdiag(jax_run, alg, true, device="cpu"),
            want, rtol=F1_RTOL)
        jstat = jcross.evaluate_algorithm_on_fold(jax_run, alg, true)
        tstat = tcross.evaluate_algorithm_on_fold(jax_run, alg, true,
                                                  device="cpu")
        np.testing.assert_allclose(
            tstat[WF.OFFDIAG]["f1_vals_across_factors"],
            jstat[WF.OFFDIAG]["f1_vals_across_factors"], rtol=F1_RTOL)
        # the twin's row against the JAX script's on the JAX run
        row = WF.result_row(jstat[WF.OFFDIAG]["f1_vals_across_factors"],
                            want)
        assert set(out["algorithms"][alias]) == set(row)
        for key, value in row.items():
            np.testing.assert_allclose(out["algorithms"][alias][key], value,
                                       rtol=F1_RTOL, err_msg=key)


def test_smoke_flow_runs_on_cpu_into_its_work_dir(tmp_path, monkeypatch):
    """``main([wd, "--smoke", "--folds", "1"], device="cpu")`` at a tiny
    width with the JAX script's smoke cuts: the JSON lands under
    ``wd + "_smoke"`` with the JAX script's key sets, the ranked rows on
    the two wavelet runs only, each run reloads with its wavelet level and
    series, and nothing under ``experiments/`` changes."""
    _tiny(monkeypatch, depth=False)
    exp = os.path.join(REPO, "experiments")
    before = {f: os.path.getmtime(os.path.join(exp, f))
              for f in os.listdir(exp)}
    wd = str(tmp_path / "wav")
    records = {}
    out = WF.main([wd, "--smoke", "--folds", "1"], device="cpu",
                  records=records)
    assert {f: os.path.getmtime(os.path.join(exp, f))
            for f in os.listdir(exp)} == before
    dest = os.path.join(wd + "_smoke", "ACCURACY_WAVELET_smoke.json")
    with open(dest) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert os.listdir(tmp_path) == ["wav_smoke"]
    assert set(out) == _out_keys()
    assert out["smoke"] is True and out["folds"] == 1
    assert out["wavelet_level"] == 3
    assert list(out["algorithms"]) == [a for _, _, a in WF.MODELS]
    for alias, row in out["algorithms"].items():
        ranked = alias in WAVELET_RUNS
        assert set(row) == _row_keys() if ranked else set(row) == \
            _row_keys() - {"ranked_offdiag_optimal_f1_mean",
                           "ranked_offdiag_optimal_f1_sem"}
        assert all(np.isfinite(v) for v in row.values())
        (run_dir,) = records["run_dirs"][alias]
        meta = read_checkpoint(os.path.join(run_dir, META))
        cuts = WF.SMOKE_CUTS[next(n for n, _, a in WF.MODELS if a == alias)]
        assert meta["epoch"] + 1 <= int(cuts["max_iter"])
        cfg = read_checkpoint(os.path.join(run_dir,
                                           "final_best_model.bin"))["config"]
        assert (cfg.wavelet_level, cfg.num_series) == (
            (3, 24) if ranked else (None, 6))


def test_main_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WF.main([str(tmp_path / "wav"), "--smoke"])
    assert not os.path.exists(str(tmp_path / "wav_smoke"))


@pytest.mark.gpu
def test_wavelet_fits_on_card_match_cpu(tmp_path, monkeypatch):
    """On the card: the twin's tiny flow (one fold curated on the host)
    against the same flow on the CPU from the same init: every run's
    histories and best params at the trainer bars, the same best epoch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the factor-mix kernel runs on it")
    _tiny(monkeypatch)
    _copy_jax_inits(monkeypatch)
    runs = []
    for device in ("cpu", "cuda"):
        records = {}
        WF.main([str(tmp_path / device), "--smoke", "--folds", "1"],
                device=device, records=records)
        runs.append(records["run_dirs"])
    for alias, (cpu_run,) in runs[0].items():
        (card_run,) = runs[1][alias]
        cpu = read_checkpoint(os.path.join(cpu_run, META))
        card = read_checkpoint(os.path.join(card_run, META))
        assert card["best_it"] == cpu["best_it"], alias
        np.testing.assert_allclose(card["avg_combo_loss"],
                                   cpu["avg_combo_loss"], **HIST)
        for a, b in zip(
                interop.tree_leaves(read_checkpoint(os.path.join(
                    cpu_run, "final_best_model.bin"))["params"]),
                interop.tree_leaves(read_checkpoint(os.path.join(
                    card_run, "final_best_model.bin"))["params"])):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       **PARAMS)
