"""The High-band dynamic-readout sweep in the port: the twin
``redcliff_tpu_torch/experiments/highband_readout_sweep.py`` of the JAX
package's ``experiments/highband_readout_sweep.py``.

The JAX script is read with ``ast``, never imported (it pins JAX's
platform at import): its conditions, the three algorithms' cached args
with the smoke cuts, the sample counts, the folds' curation, the aliases,
the aggregate and the key sets of its JSON are held to the twin's. A tiny
fold is curated bit for bit as the JAX package curates it. At a tiny
width and depth the twin's ``main`` and the JAX package's array tasks
train REDCLIFF-S, cMLP and DGCNN from one JAX init: the same run folders
and best epochs, histories and best params at the trainer bars; on the
JAX runs' params the twin's scoring of the four conditions equals the
JAX package's at rtol 1e-5, atol 1e-6, and on the twin's own runs the
REDCLIFF scores hold to JAX's at the trainer bars; ``round4_convention``
and ``common_grid_last`` score REDCLIFF-S alike.
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
from redcliff_tpu.eval import dynamic_readout as jdyn  # noqa: E402
from redcliff_tpu.models import cmlp_fm as jcmlp  # noqa: E402
from redcliff_tpu.models import dgcnn as jdgcnn  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.runtime.checkpoint import read_checkpoint as jread  # noqa: E402,E501
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.experiments import accuracy_parity_synsys as TSYN  # noqa: E402,E501
from redcliff_tpu_torch.experiments import highband_readout_sweep as HB  # noqa: E402,E501
from redcliff_tpu_torch.models import cmlp_fm as tcmlp  # noqa: E402
from redcliff_tpu_torch.models import dgcnn as tdgcnn  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "highband_readout_sweep.py")
META = "training_meta_data_and_hyper_parameters.pkl"

# the trainer bars (tests/test_torch_driver.py); the scores' bar on one
# set of params
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)
SCORES = dict(rtol=1e-5, atol=1e-6)

# each algorithm at a tiny width; a depth of 1 + 1 + 1 epochs for
# REDCLIFF-S and 2 for cMLP and DGCNN; a 6-node system (DGCNN_ARGS name
# 6 channels) with one edge per graph and two states
TINY = {"REDCLIFF_S_CMLP": dict(gen_hidden="[4]", batch_size="8",
                                embed_num_hidden_nodes="8",
                                embed_num_graph_conv_layers="1"),
        "cMLP": dict(gen_hidden="[4]", batch_size="8"),
        "DGCNN": dict(num_hidden_nodes="8", num_graph_conv_layers="1",
                      batch_size="8")}
TINY_DEPTH = {"REDCLIFF_S_CMLP": dict(max_iter="3", num_pretrain_epochs="1",
                                      num_acclimation_epochs="1",
                                      check_every="1"),
              "cMLP": dict(max_iter="2", check_every="1"),
              "DGCNN": dict(max_iter="2", check_every="1")}
TINY_SAMPLES = (16, 8)
SYSTEM = "6-1-2"


@pytest.fixture(autouse=True)
def _restore_global_rngs():
    """Curation runs the graph factory, which seeds ``random`` and
    ``np.random`` globally: leave both as they were."""
    import random

    py_state, np_state = random.getstate(), np.random.get_state()
    yield
    random.setstate(py_state)
    np.random.set_state(np_state)


def _tree():
    return ast.parse(open(SCRIPT).read())


def _def(name):
    return next(n for n in _tree().body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _const(name):
    for n in _tree().body:
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


def _arg_default(flag):
    call = next(n for n in ast.walk(_def("main")) if isinstance(n, ast.Call)
                and any(isinstance(a, ast.Constant) and a.value == flag
                        for a in n.args))
    return next(ast.literal_eval(k.value) for k in call.keywords
                if k.arg == "default")


def _jax_model_args(num_factors, smoke):
    """The JAX ``run_system``'s ``model_args`` with its smoke ``update``
    calls, exec'd on the port's copies of the synSys cached args (held to
    the JAX script's by tests/test_torch_accuracy_flow.py)."""
    run = _def("run_system")
    smoke_if = next(n for n in run.body if isinstance(n, ast.If)
                    and isinstance(n.test, ast.Name) and n.test.id == "smoke")
    ns = {"dict": dict, "str": str, "num_factors": num_factors,
          "smoke": smoke, "REDCLIFF_ARGS": TSYN.REDCLIFF_ARGS,
          "CMLP_ARGS": TSYN.CMLP_ARGS, "DGCNN_ARGS": TSYN.DGCNN_ARGS}
    return _exec([_assigned(run, "model_args"), smoke_if], ns)["model_args"]


def _jax_aggregate(systems):
    """The JAX ``main``'s cross-system aggregate, exec'd on ``systems``."""
    body = _def("main").body
    start = body.index(next(s for s in body if isinstance(s, ast.Assign)
                            and getattr(s.targets[0], "id", None) == "agg"))
    ns = _exec(body[start:start + 3], {
        "np": np, "CONDITIONS": _const("CONDITIONS"),
        "out": {"systems": systems}})
    return ns["out"]["redcliff_aggregate_by_condition"]


def test_conditions_args_cuts_samples_and_curation_are_transcribed(
        tmp_path, monkeypatch):
    assert HB.CONDITIONS == _const("CONDITIONS")
    assert [c["name"] for c in HB.CONDITIONS] == [
        "round4_convention", "common_grid_last", "common_grid_center",
        "common_grid_majority"]
    for K in (2, 4, 5, 6):
        for smoke in (False, True):
            assert HB.model_args(K, smoke) == _jax_model_args(K, smoke)
    assert list(HB.model_args(4, True)) == ["REDCLIFF_S_CMLP", "cMLP",
                                            "DGCNN"]
    run = _def("run_system")
    assert HB.ALIASES == _ev(next(
        n.value.value for n in ast.walk(run)
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Subscript)
        and isinstance(n.value.value, ast.Dict)), {})
    samples = next(
        n.value for n in ast.walk(run)
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Tuple)
        and [e.id for e in n.targets[0].elts] == ["n_train", "n_val"])
    assert HB.SAMPLES == {True: ast.literal_eval(samples.body),
                          False: ast.literal_eval(samples.orelse)}
    metrics = next(ast.literal_eval(n.iter) for n in ast.walk(_def("main"))
                   if isinstance(n, ast.For) and isinstance(n.target,
                                                            ast.Name)
                   and n.target.id == "metric")
    assert HB.METRICS == metrics
    assert HB.parse_args(["wd"]).systems == _arg_default("--systems") == \
        "6-2-4,6-2-5,6-2-6"
    assert HB.parse_args(["wd"]).folds == _arg_default("--folds") == 3
    # the folds' curation: every argument of the JAX call, both depths
    call = next(n for n in ast.walk(run)
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "curate_synthetic_fold")
    seen = []
    monkeypatch.setattr(HB, "curate_synthetic_fold",
                        lambda *a, **kw: seen.append((a, kw)) or ("d", []))
    monkeypatch.setattr(HB, "load_true_gc_factors", lambda p: p)
    for smoke in (True, False):
        base = str(tmp_path)
        dargs, _ = HB.curate_system_folds(base, "6-2-5", 2, smoke)
        assert dargs == {f: os.path.join("d", f"data_fold{f}_cached_args"
                                              f".txt") for f in (0, 1)}
        n_train, n_val = HB.SAMPLES[smoke]
        for fold in (0, 1):
            ns = {"os": os, "base": base, "fold": fold, "num_nodes": 6,
                  "num_edges": 2, "num_factors": 5, "n_train": n_train,
                  "n_val": n_val, "sys_folder": "synSys6_2_5"}
            a, kw = seen.pop(0)
            assert (list(a), kw) == ([_ev(x, ns) for x in call.args],
                                     {k.arg: _ev(k.value, ns)
                                      for k in call.keywords})


def _stat(mean):
    return None if mean is None else {"mean": mean, "sem": 0.1, "n": 3}


def _system(seed, missing=()):
    """A crafted system result: each condition's REDCLIFF entry with the
    four metrics (``missing`` ones None), the baselines' without state
    scores."""
    rng = np.random.default_rng(seed)
    out = {}
    for cond in HB.CONDITIONS:
        red = {m: _stat(None if m in missing else float(rng.normal()))
               for m in HB.METRICS}
        red["scoring_window"] = 16
        out[cond["name"]] = {
            "REDCLIFF_S_CMLP": red,
            "CMLP": {"dynamic_optimal_f1": _stat(0.2), "state_score_r": None},
            "_conventions": {}}
    return out


def test_aggregate_and_json_key_sets_match_the_jax_scripts():
    """The aggregate of crafted systems (a metric missing on one system,
    a system without a REDCLIFF entry) equals the JAX ``main``'s; the
    JSON's key set is the JAX ``out`` literal's plus the aggregate."""
    systems = {"6-2-4": _system(0), "6-2-5": _system(1, ("state_score_r",)),
               "6-2-6": _system(2)}
    systems["6-2-7"] = {c["name"]: {} for c in HB.CONDITIONS}
    got = HB.aggregate(systems)
    assert got == _jax_aggregate(systems)
    assert got["round4_convention"]["state_score_r"]["n_systems"] == 2
    assert got["common_grid_center"]["edge_tracking_r"]["n_systems"] == 3
    out = _assigned(_def("main"), "out").value
    keys = {k.value for k in out.keys}
    assert keys == {"folds", "smoke", "conditions", "systems"}
    target = next(s for s in _def("main").body if isinstance(s, ast.Assign)
                  and isinstance(s.targets[0], ast.Subscript))
    assert target.targets[0].slice.value == "redcliff_aggregate_by_condition"


def test_main_merges_a_second_systems_run(tmp_path, monkeypatch):
    """A second ``--systems`` run adds its system to the JSON in the work
    dir and the aggregate covers both; a JSON whose fold count differs is
    replaced, not merged."""
    calls = []

    def fake_run(base, system, folds, smoke, device=None, records=None):
        calls.append((base, system, folds, smoke))
        return _system(len(calls))
    monkeypatch.setattr(HB, "run_system", fake_run)
    wd = str(tmp_path / "hb")
    HB.main([wd, "--smoke", "--systems", "6-2-4", "--folds", "1"],
            device="cpu")
    assert calls == [(os.path.join(wd, "6-2-4_smoke"), "6-2-4", 1, True)]
    out = HB.main([wd, "--smoke", "--systems", "6-2-5", "--folds", "1"],
                  device="cpu")
    dest = os.path.join(wd, "HIGHBAND_READOUT_SWEEP_smoke.json")
    with open(dest) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(out))
    assert list(written["systems"]) == ["6-2-4", "6-2-5"]
    assert written["redcliff_aggregate_by_condition"] == json.loads(
        json.dumps(_jax_aggregate(written["systems"])))
    out = HB.main([wd, "--smoke", "--systems", "6-2-6", "--folds", "2"],
                  device="cpu")
    assert list(out["systems"]) == ["6-2-6"]
    assert sorted(os.listdir(tmp_path)) == ["hb"]


def test_fold_is_curated_as_the_jax_package_curates_it(tmp_path):
    """At a tiny size the twin's fold equals the JAX package's file for
    file, byte for byte (the cached args' data root aside)."""
    import shutil

    monkey = pytest.MonkeyPatch()
    monkey.setattr(HB, "SAMPLES", {True: TINY_SAMPLES, False: TINY_SAMPLES})
    try:
        dargs, true = HB.curate_system_folds(str(tmp_path / "port"), SYSTEM,
                                             1, True)
    finally:
        monkey.undo()
    pdir = os.path.dirname(dargs[0])
    jdir, _ = jcuration.curate_synthetic_fold(
        str(tmp_path / "jax" / "data"), fold_id=0, num_nodes=6, num_lags=2,
        num_factors=2, num_supervised_factors=2, num_edges_per_graph=1,
        num_samples_in_train_set=TINY_SAMPLES[0],
        num_samples_in_val_set=TINY_SAMPLES[1], sample_recording_len=100,
        burnin_period=50, label_type_setting="OneHot", noise_type="gaussian",
        noise_level=1.0, folder_name="synSys6_1_2")
    files = sorted(os.path.relpath(os.path.join(r, f), pdir)
                   for r, _, fs in os.walk(pdir) for f in fs)
    assert files and files == sorted(
        os.path.relpath(os.path.join(r, f), jdir)
        for r, _, fs in os.walk(jdir) for f in fs)
    for rel in files:
        got = open(os.path.join(pdir, rel), "rb").read()
        want = open(os.path.join(jdir, rel), "rb").read()
        if rel.endswith("_cached_args.txt"):
            got, want = json.loads(got), json.loads(want)
            assert got.pop("data_root_path") == pdir
            assert want.pop("data_root_path") == jdir
        assert got == want, rel
    assert len(true[0]) == 2
    shutil.rmtree(str(tmp_path / "jax"))


def _tiny(monkeypatch):
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    for name, args in (("REDCLIFF_ARGS", "REDCLIFF_S_CMLP"),
                       ("CMLP_ARGS", "cMLP"), ("DGCNN_ARGS", "DGCNN")):
        monkeypatch.setattr(HB, name, dict(getattr(HB, name), **TINY[args]))
    monkeypatch.setattr(HB, "SMOKE_CUTS", TINY_DEPTH)
    monkeypatch.setattr(HB, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})


def _copy_jax_inits(monkeypatch):
    """The port's REDCLIFF-S, cMLP-FM and DGCNN inits patched to the JAX
    package's, each from ``PRNGKey(0)`` as its array task seeds it."""
    pairs = ((tred.RedcliffSCMLP, jred.RedcliffSCMLP,
              jred.RedcliffSCMLPConfig),
             (tcmlp.CMLPFM, jcmlp.CMLPFM, jcmlp.CMLPFMConfig),
             (tdgcnn.DGCNNModel, jdgcnn.DGCNNModel, jdgcnn.DGCNNConfig))
    for tcls, jcls, jcfg in pairs:
        def copied_init(self, generator, device="cpu", jcls=jcls, jcfg=jcfg):
            jm = jcls(jcfg(**dataclasses.asdict(self.config)))
            tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
            return interop.params_from_jax(tree, device)
        monkeypatch.setattr(tcls, "init", copied_init)


def _close_summaries(got, want, bars, algs=None):
    """Two dynamic-readout summaries: the same algorithms, metrics and
    conventions; every mean and SEM at ``bars``, equal counts."""
    assert set(got) == set(want)
    assert got["_conventions"] == want["_conventions"]
    for alg in (algs or [a for a in want if a != "_conventions"]):
        assert set(got[alg]) == set(want[alg]), alg
        for key, st in want[alg].items():
            if not isinstance(st, dict):
                assert got[alg][key] == st, (alg, key)
                continue
            assert got[alg][key]["n"] == st["n"], (alg, key)
            np.testing.assert_allclose(
                [got[alg][key]["mean"], got[alg][key]["sem"]],
                [st["mean"], st["sem"]], **bars, err_msg=f"{alg} {key}")


def test_tiny_sweep_matches_jax_from_one_init(tmp_path, monkeypatch):
    """The twin's ``main`` on a tiny 6-1-2 fold, inits copied from JAX,
    against the JAX array tasks (the JAX script's
    ``set_up_and_run_experiments`` calls on the same cached args and
    fold): the same run folders and best epochs, histories and best
    params at the trainer bars. The twin's scoring of the JAX runs under
    each condition equals JAX's ``run_dynamic_readout_evaluation`` at
    rtol 1e-5, atol 1e-6; the twin's own REDCLIFF scores hold to JAX's at
    the trainer bars; REDCLIFF-S scores alike under ``round4_convention``
    and ``common_grid_last``."""
    _tiny(monkeypatch)
    _copy_jax_inits(monkeypatch)
    wd = str(tmp_path / "hb")
    records = {}
    out = HB.main([wd, "--smoke", "--systems", SYSTEM, "--folds", "1"],
                  device="cpu", records=records)
    base = os.path.join(wd, SYSTEM + "_smoke")
    dargs = os.path.join(base, "data", "synSys6_1_2", "fold_0",
                         "data_fold0_cached_args.txt")
    true = {0: HB.load_true_gc_factors(dargs)}
    jroots = {}
    for model_type, alias in HB.ALIASES.items():
        jroot = tmp_path / "jax" / f"{alias}_models"
        jroot.mkdir(parents=True)
        jroots[alias] = str(jroot)
        jdriver.set_up_and_run_experiments(
            {"save_root_path": str(jroot)},
            [os.path.join(base, f"{model_type}_cached_args.txt")], [dargs],
            possible_model_types=[model_type],
            possible_data_sets=["data_fold0"], task_id=1)
        jax_run = jcross.find_run_directory(str(jroot), "data", 0)
        port_run = jcross.find_run_directory(records["roots"][SYSTEM][alias],
                                             "data", 0)
        assert os.path.basename(port_run) == os.path.basename(jax_run)
        jm = jread(os.path.join(jax_run, META))
        tm = read_checkpoint(os.path.join(port_run, META))
        assert tm["epoch"] == jm["epoch"]
        assert tm["best_it"] == jm["best_it"]
        keys = ["avg_forecasting_loss", "avg_combo_loss", "avg_factor_loss"
                ] if "REDCLIFF" in model_type else ["avg_combo_loss"]
        for key in keys:
            np.testing.assert_allclose(tm[key], jm[key], **HIST,
                                       err_msg=f"{alias} {key}")
        ja = jread(os.path.join(jax_run, "final_best_model.bin"))
        ta = read_checkpoint(os.path.join(port_run, "final_best_model.bin"))
        for a, b in zip(jax.tree.leaves(ja["params"]),
                        interop.tree_leaves(ta["params"])):
            np.testing.assert_allclose(np.asarray(b), a, **PARAMS)
    # the twin's scoring stage on the JAX runs against JAX's, per condition
    port_on_jax = HB.score_conditions(str(tmp_path / "score"), SYSTEM,
                                      jroots, {0: dargs}, true, 2,
                                      device="cpu")
    res = out["systems"][SYSTEM]
    assert list(res) == list(port_on_jax) == [c["name"]
                                              for c in HB.CONDITIONS]
    for cond in HB.CONDITIONS:
        want = jdyn.run_dynamic_readout_evaluation(
            roots=jroots, data_args_by_fold={0: dargs}, true_by_fold=true,
            num_folds=1, num_supervised_factors=2,
            save_root=str(tmp_path / "jax_evals" / cond["name"]),
            common_window_grid=cond["common_window_grid"],
            label_align=cond["label_align"])
        _close_summaries(port_on_jax[cond["name"]], want, SCORES)
        _close_summaries(res[cond["name"]], want, HIST,
                         algs=["REDCLIFF_S_CMLP"])
        assert res[cond["name"]]["REDCLIFF_S_CMLP"]["dynamic_optimal_f1"][
            "n"] == TINY_SAMPLES[1]
    assert res["round4_convention"]["REDCLIFF_S_CMLP"] == \
        res["common_grid_last"]["REDCLIFF_S_CMLP"]
    # the JSON in the work dir, with the JAX script's key sets
    with open(os.path.join(wd, "HIGHBAND_READOUT_SWEEP_smoke.json")) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(out))
    assert set(written) == {"folds", "smoke", "conditions", "systems",
                            "redcliff_aggregate_by_condition"}
    assert written["redcliff_aggregate_by_condition"] == json.loads(
        json.dumps(_jax_aggregate(written["systems"])))
    assert sorted(os.listdir(wd)) == sorted(
        ["HIGHBAND_READOUT_SWEEP_smoke.json", SYSTEM + "_smoke"])


def test_main_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HB.main([str(tmp_path / "hb"), "--smoke"])
    assert not os.path.exists(str(tmp_path / "hb"))


@pytest.mark.gpu
def test_tiny_sweep_on_card_matches_cpu(tmp_path, monkeypatch):
    """On the card: the twin's tiny sweep (the fold curated on the host)
    against the same sweep on the CPU from the same inits (the port's
    own, seeded as the array task seeds them): each condition's summaries
    at the trainer bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the factor-mix kernel runs on it")
    _tiny(monkeypatch)
    outs = [HB.main([str(tmp_path / device), "--smoke", "--systems",
                     SYSTEM, "--folds", "1"], device=device)
            for device in ("cpu", "cuda")]
    cpu, card = (o["systems"][SYSTEM] for o in outs)
    for cond in HB.CONDITIONS:
        _close_summaries(card[cond["name"]], cpu[cond["name"]], HIST)
