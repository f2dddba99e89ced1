"""Factor-count selection in the port: the twin
``redcliff_tpu_torch/experiments/factor_count_selection.py`` of the JAX
package's ``experiments/factor_count_selection.py``.

The JAX script is read with ``ast``, never imported (it pins JAX's
platform at import): its candidates, cached args, smoke cuts, sample
counts, the folds' curation, the selection expression, the merge of an
earlier JSON and the key sets of its record and JSON are held to the
twin's. At a tiny width and depth K = 2 and 3 train on one fold in the
twin's ``main`` and in the JAX package's array tasks from one JAX init:
the selection tables agree at the trainer bars and select the same K.
"""
import ast
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.eval import analysis as janalysis  # noqa: E402
from redcliff_tpu.eval import cross_alg as jcross  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.runtime.checkpoint import read_checkpoint as jread  # noqa: E402,E501
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.experiments import accuracy_parity_synsys as TSYN  # noqa: E402,E501
from redcliff_tpu_torch.experiments import factor_count_selection as FC  # noqa: E402,E501
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "factor_count_selection.py")
META = "training_meta_data_and_hyper_parameters.pkl"

# the trainer bars (tests/test_torch_driver.py)
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)

# the synSys REDCLIFF-S cached args at a tiny width; a depth of 1 + 1 + 1
# epochs; two candidates
TINY = dict(gen_hidden="[4]", batch_size="8", embed_num_hidden_nodes="8",
            embed_num_graph_conv_layers="1")
TINY_DEPTH = dict(max_iter="3", num_pretrain_epochs="1",
                  num_acclimation_epochs="1", check_every="1")
TINY_SAMPLES = (8, 4)
TINY_K = (2, 3)
SYSTEM = "3-1-2"


@pytest.fixture(autouse=True)
def _restore_global_rngs():
    """Curation runs the graph factory, which seeds ``random`` and
    ``np.random`` globally: leave both as they were."""
    import random

    py_state, np_state = random.getstate(), np.random.get_state()
    yield
    random.setstate(py_state)
    np.random.set_state(np_state)


def _def(name):
    return next(n for n in ast.parse(open(SCRIPT).read()).body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _const(name):
    for n in ast.parse(open(SCRIPT).read()).body:
        if (isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == name):
            return ast.literal_eval(n.value)
    raise KeyError(name)


def _assigned(node, name):
    for n in ast.walk(node):
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == name):
            return n
    raise KeyError(name)


def _ev(node, ns):
    return eval(compile(ast.Expression(node), SCRIPT, "eval"), ns)


def _exec(stmts, ns):
    exec(compile(ast.Module(body=list(stmts), type_ignores=[]), SCRIPT,
                 "exec"), ns)
    return ns


def _record_dict():
    """The JAX ``run_system``'s returned dict literal, by key."""
    ret = next(n.value for n in ast.walk(_def("run_system"))
               if isinstance(n, ast.Return))
    return dict(zip((k.value for k in ret.keys), ret.values))


def _arg_default(flag):
    call = next(n for n in ast.walk(_def("main")) if isinstance(n, ast.Call)
                and any(isinstance(a, ast.Constant) and a.value == flag
                        for a in n.args))
    return next(ast.literal_eval(k.value) for k in call.keywords
                if k.arg == "default")


def test_candidates_args_cuts_samples_and_curation_are_transcribed(
        tmp_path, monkeypatch):
    assert FC.K_CANDIDATES == _const("K_CANDIDATES") == (2, 3, 4, 5, 6)
    assert FC.OFFDIAG == _const("OFFDIAG")
    run = _def("run_system")
    margs = _assigned(run, "margs").value
    update = next(n for n in ast.walk(run) if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)
                  and n.func.attr == "update")
    cuts = {k.arg: ast.literal_eval(k.value) for k in update.keywords}
    assert FC.SMOKE_CUTS == cuts
    for K in FC.K_CANDIDATES:
        for states in (2, 3):
            want = _ev(margs, {"dict": dict, "str": str, "K": K,
                               "num_states": states,
                               "REDCLIFF_ARGS": TSYN.REDCLIFF_ARGS})
            assert FC.k_model_args(K, states, False) == want
            assert FC.k_model_args(K, states, True) == dict(want, **cuts)
    samples = next(
        n.value for n in ast.walk(run)
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Tuple)
        and [e.id for e in n.targets[0].elts] == ["n_train", "n_val"])
    assert FC.SAMPLES == {True: ast.literal_eval(samples.body),
                          False: ast.literal_eval(samples.orelse)}
    record = _record_dict()
    assert FC.BANDED_STUDY_DEFAULT_K == ast.literal_eval(
        record["banded_study_default_k"])
    assert FC.BANDED_STUDY_REDCLIFF_OPTF1 == ast.literal_eval(
        record["banded_study_redcliff_optf1"].func.value)
    assert FC.parse_args(["wd"]).systems == _arg_default("--systems") == \
        "3-1-2,6-4-2"
    assert FC.parse_args(["wd"]).folds == _arg_default("--folds") == 3
    # the folds' curation: every argument of the JAX call, both depths
    call = next(n for n in ast.walk(run)
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "curate_synthetic_fold")
    seen = []
    monkeypatch.setattr(FC, "curate_synthetic_fold",
                        lambda *a, **kw: seen.append((a, kw)) or ("d", []))
    monkeypatch.setattr(FC, "load_true_gc_factors", lambda p: p)
    for smoke in (True, False):
        base = str(tmp_path)
        dargs, _ = FC.curate_system_folds(base, "6-4-2", 2, smoke)
        assert dargs == {f: os.path.join("d", f"data_fold{f}_cached_args"
                                              f".txt") for f in (0, 1)}
        n_train, n_val = FC.SAMPLES[smoke]
        for fold in (0, 1):
            ns = {"os": os, "base": base, "fold": fold, "num_nodes": 6,
                  "num_edges": 4, "num_states": 2, "n_train": n_train,
                  "n_val": n_val}
            a, kw = seen.pop(0)
            assert (list(a), kw) == ([_ev(x, ns) for x in call.args],
                                     {k.arg: _ev(k.value, ns)
                                      for k in call.keywords})


def test_record_and_json_key_sets_are_transcribed():
    rec = FC.system_record("3-1-2", {K: {} for K in FC.K_CANDIDATES},
                           {K: 1.0 for K in FC.K_CANDIDATES}, 2,
                           {K: {} for K in FC.K_CANDIDATES})
    assert set(rec) == set(_record_dict())
    assert rec["num_labeled_states"] == 2
    assert rec["banded_study_redcliff_optf1"] == 0.460
    assert FC.system_record("6-2-3", {}, {}, 4, {})[
        "banded_study_redcliff_optf1"] is None
    out = _assigned(_def("main"), "out").value
    assert {k.value for k in out.keys} == {"folds", "smoke", "systems"}


def _entry(f=None, g=None):
    e = {}
    if f is not None:
        e["avg_forecasting_loss_mean"] = f
    if g is not None:
        e["avg_factor_loss_mean"] = g
    return e


# crafted selection tables: a clear minimum, a tie (the first K wins), a
# K missing a criterion, a K with no runs at all (an empty entry), every K
# without runs
TABLES = {
    "argmin": {2: _entry(3.0, 1.0), 3: _entry(1.0, 0.5), 4: _entry(2.0, 2.0),
               5: _entry(0.75, 1.0), 6: _entry(4.0, 0.1)},
    "tie": {2: _entry(2.0, 1.0), 3: _entry(1.0, 2.0), 4: _entry(1.5, 1.5),
            5: _entry(5.0, 5.0), 6: _entry(3.0, 0.0)},
    "missing_key": {2: _entry(9.0, 9.0), 3: _entry(0.1), 4: _entry(None, 0.1),
                    5: _entry(8.0, 8.5), 6: _entry(10.0, 1.0)},
    "no_runs": {2: _entry(2.0, 2.0), 3: {}, 4: _entry(1.0, 2.5),
                5: _entry(1.5, 1.25), 6: {}},
    "all_empty": {K: {} for K in (2, 3, 4, 5, 6)},
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_select_k_matches_the_jax_scripts(name):
    """The JAX ``run_system``'s selection statements, exec'd on the same
    table: the same sums (``inf`` where a criterion is missing) and the
    same K."""
    table = TABLES[name]
    run = _def("run_system")
    stmts = [_assigned(run, "selectable"), _assigned(run, "selected")]
    ns = _exec(stmts, {"np": np, "table": table,
                       "K_CANDIDATES": _const("K_CANDIDATES")})
    selectable, selected = FC.select_k(table)
    assert selectable == ns["selectable"]
    assert selected == ns["selected"]
    assert {"argmin": 3, "tie": 2, "missing_key": 6, "no_runs": 5,
            "all_empty": 2}[name] == selected


def _jax_merge(dest, out):
    """The JAX ``main``'s merge of an earlier JSON at ``dest``, exec'd."""
    merge = next(n for n in _def("main").body if isinstance(n, ast.If))
    return _exec([merge], {"os": os, "json": json, "dest": dest,
                           "out": out})["out"]


def test_main_merges_a_second_systems_run(tmp_path, monkeypatch):
    """A second ``--systems`` run adds its system to the JSON in the work
    dir; a rerun of a system replaces its entry; a JSON whose ``smoke``
    flag differs is replaced, not merged; each as the JAX ``main``'s merge
    does it."""
    calls = []

    def fake_run(base, system, folds, smoke, device=None, records=None):
        calls.append((base, system, folds, smoke))
        return {"system": system, "run": len(calls)}
    monkeypatch.setattr(FC, "run_system", fake_run)
    wd = str(tmp_path / "fcs")
    dest = os.path.join(wd, "FACTOR_COUNT_SELECTION_smoke.json")
    FC.main([wd, "--smoke", "--systems", "3-1-2", "--folds", "1"],
            device="cpu")
    assert calls == [(os.path.join(wd, "3-1-2_smoke"), "3-1-2", 1, True)]
    with open(dest) as f:
        prev = json.load(f)
    want = _jax_merge(dest, {"folds": 1, "smoke": True, "systems": {
        "6-4-2": {"system": "6-4-2", "run": 2},
        "3-1-2": {"system": "3-1-2", "run": 3}}})
    out = FC.main([wd, "--smoke", "--systems", "6-4-2,3-1-2", "--folds",
                   "1"], device="cpu")
    with open(dest) as f:
        written = json.load(f)
    assert written == out == want
    assert written["systems"]["3-1-2"]["run"] == 3 != prev["systems"][
        "3-1-2"]["run"]
    assert set(written["systems"]) == {"3-1-2", "6-4-2"}
    # a file at the published name whose smoke flag differs: replaced
    full = os.path.join(wd, "FACTOR_COUNT_SELECTION.json")
    with open(full, "w") as f:
        json.dump(dict(written, smoke=True), f)
    out = FC.main([wd, "--systems", "6-6-2", "--folds", "2"], device="cpu")
    with open(full) as f:
        assert json.load(f) == out
    assert out == {"folds": 2, "smoke": False,
                   "systems": {"6-6-2": {"system": "6-6-2", "run": 4}}}
    # a file that does not parse is replaced too, in both
    with open(full, "w") as f:
        f.write("{not json")
    fresh = {"folds": 2, "smoke": False, "systems": {"x": 1}}
    assert FC.merge_previous(full, dict(fresh)) == _jax_merge(
        full, dict(fresh)) == fresh
    assert sorted(os.listdir(tmp_path)) == ["fcs"]


def _copy_jax_init(monkeypatch):
    def copied_init(self, generator, device="cpu"):
        jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(
            **dataclasses.asdict(self.config)))
        tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        return interop.params_from_jax(tree, device)
    monkeypatch.setattr(tred.RedcliffSCMLP, "init", copied_init)


def _tiny(monkeypatch):
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    monkeypatch.setattr(FC, "K_CANDIDATES", TINY_K)
    monkeypatch.setattr(FC, "REDCLIFF_ARGS", dict(FC.REDCLIFF_ARGS, **TINY))
    monkeypatch.setattr(FC, "SMOKE_CUTS", TINY_DEPTH)
    monkeypatch.setattr(FC, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})


def test_tiny_k_sweep_matches_jax_array_tasks_from_one_init(tmp_path,
                                                           monkeypatch):
    """K = 2 and 3 on a tiny fold of 3-1-2 through the twin's ``main``,
    inits copied from JAX, against the JAX array tasks on the same cached
    args and fold: the same run folders, histories and best params at the
    trainer bars; ``factor_selection_table`` over each package's runs at
    those bars; the same selected K by the JAX script's expression."""
    _tiny(monkeypatch)
    _copy_jax_init(monkeypatch)
    wd = str(tmp_path / "fcs")
    records = {}
    out = FC.main([wd, "--smoke", "--systems", SYSTEM, "--folds", "1"],
                  device="cpu", records=records)
    base = os.path.join(wd, SYSTEM + "_smoke")
    dargs = os.path.join(base, "data", "synSys3_1_2", "fold_0",
                         "data_fold0_cached_args.txt")
    jax_runs = {}
    for K in TINY_K:
        (port_run,) = records["run_dirs"][SYSTEM][K]
        jroot = tmp_path / f"jax_K{K}"
        jroot.mkdir()
        jdriver.set_up_and_run_experiments(
            {"save_root_path": str(jroot)},
            [os.path.join(base, f"REDCLIFF_S_CMLP_K{K}_cached_args.txt")],
            [dargs], possible_model_types=["REDCLIFF_S_CMLP"],
            possible_data_sets=["data_fold0"], task_id=1)
        jax_run = jcross.find_run_directory(str(jroot), "data", 0)
        jax_runs[K] = [jax_run]
        assert os.path.basename(port_run) == os.path.basename(jax_run)
        jm = jread(os.path.join(jax_run, META))
        tm = read_checkpoint(os.path.join(port_run, META))
        assert tm["epoch"] == jm["epoch"] == 2
        assert tm["best_it"] == jm["best_it"]
        for key in ("avg_forecasting_loss", "avg_factor_loss",
                    "avg_combo_loss"):
            np.testing.assert_allclose(tm[key], jm[key], **HIST,
                                       err_msg=f"K={K} {key}")
        ja = jread(os.path.join(jax_run, "final_best_model.bin"))
        ta = read_checkpoint(os.path.join(port_run, "final_best_model.bin"))
        assert ta["config"].num_factors == ja["config"].num_factors == K
        assert ta["config"].num_supervised_factors == 2
        for a, b in zip(jax.tree.leaves(ja["params"]),
                        interop.tree_leaves(ta["params"])):
            np.testing.assert_allclose(np.asarray(b), a, **PARAMS)
    jtable = janalysis.factor_selection_table(jax_runs)
    rec = out["systems"][SYSTEM]
    assert set(rec["selection_table"]) == set(jtable) == set(TINY_K)
    for K in TINY_K:
        assert set(rec["selection_table"][K]) == set(jtable[K])
        for key, value in jtable[K].items():
            np.testing.assert_allclose(rec["selection_table"][K][key],
                                       value, **HIST, err_msg=key)
    run = _def("run_system")
    ns = _exec([_assigned(run, "selectable"), _assigned(run, "selected")],
               {"np": np, "table": jtable, "K_CANDIDATES": TINY_K})
    assert rec["selected_num_factors"] == ns["selected"]
    np.testing.assert_allclose(
        [rec["criteria_sum_by_k"][str(K)] for K in TINY_K],
        [ns["selectable"][K] for K in TINY_K], **HIST)
    assert set(rec["science_by_num_factors"]) == {"2", "3"}
    # the JSON in the work dir, with the JAX script's key sets
    with open(os.path.join(wd, "FACTOR_COUNT_SELECTION_smoke.json")) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(out))
    assert set(written["systems"][SYSTEM]) == set(_record_dict())


def test_main_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FC.main([str(tmp_path / "fcs"), "--smoke"])
    assert not os.path.exists(str(tmp_path / "fcs"))


@pytest.mark.gpu
def test_k_sweep_on_card_matches_cpu(tmp_path, monkeypatch):
    """On the card: the twin's tiny K = 2, 3 sweep (the fold curated on
    the host) against the same sweep on the CPU from the same init: each
    run's histories and best params at the trainer bars, the same table
    at those bars and the same selected K."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the factor-mix kernel runs on it")
    _tiny(monkeypatch)
    _copy_jax_init(monkeypatch)
    outs, runs = [], []
    for device in ("cpu", "cuda"):
        records = {}
        outs.append(FC.main([str(tmp_path / device), "--smoke", "--systems",
                             SYSTEM, "--folds", "1"], device=device,
                            records=records))
        runs.append(records["run_dirs"][SYSTEM])
    cpu, card = (o["systems"][SYSTEM] for o in outs)
    assert card["selected_num_factors"] == cpu["selected_num_factors"]
    for K in TINY_K:
        for key, value in cpu["selection_table"][K].items():
            np.testing.assert_allclose(card["selection_table"][K][key],
                                       value, **HIST, err_msg=key)
        (cpu_run,), (card_run,) = runs[0][K], runs[1][K]
        a = read_checkpoint(os.path.join(cpu_run, META))
        b = read_checkpoint(os.path.join(card_run, META))
        assert a["best_it"] == b["best_it"]
        np.testing.assert_allclose(b["avg_combo_loss"], a["avg_combo_loss"],
                                   **HIST)
        for x, y in zip(
                interop.tree_leaves(read_checkpoint(os.path.join(
                    cpu_run, "final_best_model.bin"))["params"]),
                interop.tree_leaves(read_checkpoint(os.path.join(
                    card_run, "final_best_model.bin"))["params"])):
            np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                                       **PARAMS)
