"""The one-init, published-depth parity harness (``tests/torch_depth_parity
.py``) and the port-only history tool (``tools/task_history.py``).

Tier 1: ``parting_epoch`` on crafted histories; the one-ulp move on a
mixed-dtype tree; ``run_task`` at a tiny width and depth for DGCNN, cMLP
and REDCLIFF-S, both packages from one JAX init, held at the trainer bars
(and JAX's one-ulp moves beside them); the bisect inside an epoch at the
same size, and the faults it catches; ``run_grid_lanes`` on two lanes;
the tool's ``run`` and ``compare`` on the CPU at its studies' smoke depth,
once in a process where ``jax`` and ``redcliff_tpu`` cannot be imported.

The tool's card run against its CPU run is the ``gpu`` test of
``tests/test_torch_task_history_gpu.py`` (a file that imports no JAX).

``slow``: the published-depth legs of ROADMAP queue 3's study differences
(items 30, 26, 27, 28, 14 and 24), each asserting the one-ulp verdict
PERF.md records (a miss pinned as a miss) and, where the port parts
first, the bisect inside its parting epoch.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch_depth_parity as DP  # noqa: E402

from redcliff_tpu_torch.experiments import grid_science_parity as GSP  # noqa: E402,E501
from redcliff_tpu_torch.experiments import highband_readout_sweep as HB  # noqa: E402,E501

REPO = DP.REPO
TOOL = os.path.join(REPO, "tools", "task_history.py")
TH = DP.TH

# each algorithm at a tiny width and depth on a 6-node, one-edge,
# two-state system (tests/test_torch_highband_readout_sweep.py's)
TINY = {"REDCLIFF_S_CMLP": dict(gen_hidden="[4]", batch_size="8",
                                embed_num_hidden_nodes="8",
                                embed_num_graph_conv_layers="1",
                                max_iter="3", num_pretrain_epochs="1",
                                num_acclimation_epochs="1", check_every="1"),
        "cMLP": dict(gen_hidden="[4]", batch_size="8", max_iter="3",
                     check_every="1"),
        "DGCNN": dict(num_hidden_nodes="8", num_graph_conv_layers="1",
                      batch_size="8", max_iter="3", check_every="1")}
TINY_SAMPLES = (16, 8)
SYSTEM = "6-1-2"


@pytest.fixture(autouse=True)
def _quiet_and_restore_global_rngs(monkeypatch):
    """No quality monitor; curation seeds ``random`` and ``np.random``
    globally: leave both as they were."""
    import random

    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    py_state, np_state = random.getstate(), np.random.get_state()
    yield
    random.setstate(py_state)
    np.random.set_state(np_state)


# ------------------------------------------------------------ parting epoch
def test_parting_epoch_on_crafted_histories():
    a = [1.0, 2.0, 3.0, 4.0]
    assert DP.parting_epoch(a, list(a)) is None
    # within the bars (rtol 1e-4 of the reference, atol 1e-5)
    assert DP.parting_epoch([1.00009, 2.0, 3.0, 4.0], a) is None
    assert DP.parting_epoch([0.0, 1e-5], [5e-6, 0.0]) is None
    # beyond them at epoch 0, and at epoch 2
    assert DP.parting_epoch([1.0002, 2.0, 3.0, 4.0], a) == 0
    assert DP.parting_epoch([1.0, 2.0, 3.01, 4.0], a) == 2
    # one stops earlier: they part at the first epoch only one has
    assert DP.parting_epoch(a[:3], a) == 3
    assert DP.parting_epoch(a, a[:2]) == 2
    assert DP.parting_epoch([], []) is None
    # NaNs equal each other; None (no criterion yet) equals only None
    nan = float("nan")
    assert DP.parting_epoch([nan, 1.0], [nan, 1.0]) is None
    assert DP.parting_epoch([1.0, nan], [1.0, 1.0]) == 1
    assert DP.parting_epoch([None, None, 2.0], [None, None, 2.0]) is None
    assert DP.parting_epoch([None, 1.0], [1.0, 1.0]) == 0
    # the record form (as JSON writes it): the earliest parting over the
    # criterion and every validation history
    rec = {"criteria": [None, 5.0, 4.0], "val": {"avg_combo_loss": a[:3],
                                                 "avg_factor_loss": a[:3]}}
    other = json.loads(json.dumps(rec))
    assert DP.parting_epoch(other, rec) is None
    other["val"]["avg_factor_loss"][1] = 2.5
    assert DP.parting_epoch(other, rec) == 1
    other["criteria"][0] = 1.0
    assert DP.parting_epoch(other, rec) == 0
    assert DP.parting_epoch({"criteria": ["inf"], "val": {}},
                            {"criteria": [float("inf")], "val": {}}) is None


def test_verdict_rule_on_crafted_runs():
    """Faithful: the port parts no earlier than a one-ulp JAX run, or
    never; where nothing parts, the decisions must be equal."""
    def run(crit, best, stop):
        return {"criteria": crit, "val": {}, "best_it": best,
                "stop_epoch": stop}
    j = run([3.0, 2.0, 1.0, 1.5], 2, 3)
    moved = [run([3.0, 2.0, 1.2, 1.5], 2, 3), j]
    assert DP.verdict(j, run([3.0, 2.0, 1.1, 1.5], 2, 3), moved)[
        "faithful"]
    out = DP.verdict(j, run([3.0, 2.5, 1.0, 1.5], 2, 3), moved)
    assert out == {"p_J": 2, "p_J_by_ulp": [2, None], "p_port": 1,
                   "faithful": False}
    assert DP.verdict(j, j, [j, j])["faithful"]
    # nothing parts: the decisions decide
    assert not DP.verdict(j, run([3.0, 2.0, 1.0, 1.5], 1, 3),
                          [j, j])["faithful"]
    assert not DP.verdict(j, run([3.0, 2.0, 1.0, 1.6], 2, 3),
                          [j, j])["faithful"]


# ------------------------------------------------------------- ulp move
def test_move_ulp_on_a_mixed_dtype_tree():
    tree = {"w": np.array([1.0, -2.5, 0.0], np.float32),
            "b": [np.array([3.0], np.float64), np.array([7], np.int32)],
            "mask": (np.array([True, False]),),
            "h": np.array([0.5], np.float16)}
    up, down = DP.move_ulp(tree, 1), DP.move_ulp(tree, -1)
    assert DP.move_ulp(tree, 0) is tree
    for moved, sign in ((up, 1), (down, -1)):
        for got, orig in ((moved["w"], tree["w"]), (moved["b"][0],
                                                     tree["b"][0]),
                          (moved["h"], tree["h"])):
            assert got.dtype == orig.dtype
            np.testing.assert_array_equal(
                got, np.nextafter(orig, sign * np.inf, dtype=orig.dtype))
            assert (np.sign(got - orig) == sign).all()
        np.testing.assert_array_equal(moved["b"][1], tree["b"][1])
        assert moved["b"][1].dtype == np.int32
        np.testing.assert_array_equal(moved["mask"][0], tree["mask"][0])
    # one ulp of float32 at 1.0 is 2**-23
    assert up["w"][0] - np.float32(1.0) == np.float32(2.0 ** -23)
    assert up["w"][2] > 0 > down["w"][2]


# ---------------------------------------------------------- run_task, tiny
@pytest.mark.parametrize("alg", ["DGCNN", "cMLP", "REDCLIFF_S_CMLP"])
def test_run_task_holds_the_port_to_jax_from_one_init(alg, tmp_path,
                                                      monkeypatch):
    """A tiny High-band fold (curated by the twin's stage), one array task
    in both packages from the JAX init and in JAX from it moved one ulp
    each way: every history at the trainer bars to the stop, the same
    best and stop epochs, the GC estimates' F1 and ROC-AUC at the
    scores' bar; the verdict faithful."""
    monkeypatch.setattr(HB, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})
    leg = DP.l_leg("highband", SYSTEM, 0, alg, str(tmp_path),
                   overrides=TINY[alg])
    j, t = leg["jax"], leg["port"]
    assert j["stop_epoch"] == t["stop_epoch"] == 2
    assert len(j["criteria"]) == len(t["criteria"]) == 3
    assert DP.parting_epoch(t, j) is None
    assert (t["best_it"], t["stop_epoch"]) == (j["best_it"], j["stop_epoch"])
    for k in j["val"]:
        np.testing.assert_allclose(t["val"][k], j["val"][k], **DP.HIST,
                                   err_msg=k)
    if alg == "REDCLIFF_S_CMLP":
        # no criterion before the pretrain and acclimation epochs are over
        assert j["criteria"][:2] == t["criteria"][:2] == [None, None]
    np.testing.assert_allclose([t["f1"], t["roc_auc"]],
                               [j["f1"], j["roc_auc"]], rtol=1e-5)
    assert leg["verdict"]["p_port"] is None and leg["verdict"]["faithful"]
    # the moved inits: every float leaf one ulp away, the same tree shape
    assert j["init"] is t["init"]
    for m, u in ((leg["jax+1"], 1), (leg["jax-1"], -1)):
        assert m["init"] is j["init"] and m["ulp"] == u
        assert m["stop_epoch"] == 2
    summary = DP.summary(leg)
    assert set(summary) == {"verdict", "jax", "port", "jax+1", "jax-1"}
    json.dumps(summary)


def test_run_task_port_needs_a_jax_init(tmp_path, monkeypatch):
    monkeypatch.setattr(HB, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})
    with pytest.raises(ValueError, match="JAX init"):
        DP.run_task("highband", SYSTEM, 0, "cMLP", "port", str(tmp_path),
                    overrides=TINY["cMLP"])


@pytest.mark.parametrize("alg", ["REDCLIFF_S_CMLP", "cMLP"])
def test_epoch_bisect_at_a_tiny_size(alg, tmp_path, monkeypatch):
    """The bisect inside a parting epoch, on a tiny task cut to 3 epochs
    (2 steps each): the cut runs hold the trainer bars, the port sees
    JAX's batches, and no step of epochs 1 and 2 is faulty under the
    stated rule. The rule catches a fault of the size it claims to: the
    port's loss scaled by 1 + 1e-5 makes its loss and gradients faulty,
    and its Adam's second-moment decay set to 0.99 its optimizer."""
    monkeypatch.setattr(HB, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})
    out = DP.epoch_bisect("highband", SYSTEM, 0, alg, str(tmp_path), 2,
                          ulps=(1,), overrides=TINY[alg], keep_traces=True)
    assert out["verdict"]["faithful"] and out["verdict"]["p_port"] is None
    assert out["first_step_parting"] == {"port": None, "jax+1": None}
    assert out["same_batches"] and out["steps_per_epoch"] == 2
    assert [(r["epoch"], r["phase"]) for r in out["steps"]] == [
        (e, ph) for e, ph in ((1, "factor_pretrain"), (2, "combined"))
        for _ in range(2)] if alg == "REDCLIFF_S_CMLP" else [
        (e, "None") for e in (1, 1, 2, 2)]
    assert out["faulty_steps"] == 0, [r["faulty_terms"]
                                      for r in out["steps"]]
    n = len(jax.tree.leaves(out["traces"]["jax"]["steps"][0]["params"]))
    for r in out["steps"]:
        assert len(r["grad"]) == len(r["update"]) == len(r["optimizer"]) \
            == n
    # the gap entering each traced epoch, one value per leaf
    assert set(out["params_gap"]["port"]) == {"1", "2"}
    assert all(g < 1e-4 for g in out["params_gap"]["port"]["2"])
    jrec, trec = out["traces"]["jax"], out["traces"]["port"]
    step = [s for s in jrec["steps"] if "args" in s][-1]

    def check():
        return DP.step_in_epoch(jrec["trainer"], trec["trainer"],
                                jrec["programs"][step["phase"]],
                                step["args"], step["phase"])
    assert not check()["faulty"]
    tcls = DP.model_classes(alg)[1]
    name = "loss_for_phase" if alg == "REDCLIFF_S_CMLP" else "loss"
    loss = getattr(tcls, name)

    def scaled(self, *a, **kw):
        combo, parts = loss(self, *a, **kw)
        return combo * (1 + 1e-5), parts
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcls, name, scaled)
        r = check()
    assert r["faulty"] and "loss" in r["faulty_terms"]
    assert any(t.startswith("grad") for t in r["faulty_terms"])
    trainer = trec["trainer"]
    make = ("make_optimizers" if alg == "REDCLIFF_S_CMLP"
            else "make_optimizer")
    build = getattr(type(trainer), make)

    def skewed(live):
        opts = build(trainer, live)
        for opt in (opts if isinstance(opts, tuple) else (opts,)):
            for group in opt.param_groups:
                group["betas"] = (0.9, 0.99)
        return opts
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, make, skewed)
        r = check()
    assert r["faulty"] and all(t.startswith("opt")
                               for t in r["faulty_terms"]), r


def test_jax_runs_from_the_ports_own_init(tmp_path, monkeypatch):
    """``port_init_tree`` is the port's seeded init as a numpy tree: JAX
    started from it holds the port's own run (the tool's) at the trainer
    bars, with the same decisions."""
    monkeypatch.setattr(HB, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})
    prep = DP.prepare("highband", SYSTEM, 0, "DGCNN", str(tmp_path),
                      overrides=TINY["DGCNN"])
    own = DP.port_init_tree(prep)
    assert all(isinstance(x, np.ndarray) for x in jax.tree.leaves(own))
    j = DP.run_task("highband", SYSTEM, 0, "DGCNN", "jax", str(tmp_path),
                    init=own, prep=prep)
    t = TH.run_port_task(prep, str(tmp_path / "own"), seed=0, device="cpu")
    assert DP.parting_epoch(t, j) is None
    assert (t["best_it"], t["stop_epoch"]) == (j["best_it"], j["stop_epoch"])


def test_step_null_dithers_each_step_by_one_ulp(tmp_path, monkeypatch):
    """The per-step null: ``dither_ulp`` moves every float element exactly
    one ulp (about half up), leaves integers; ``step_null`` runs JAX and
    its dithered runs from one init on a tiny task and reports where each
    parts from JAX."""
    rng = np.random.default_rng(0)
    x = np.linspace(-2.0, 2.0, 4001, dtype=np.float32)
    d = DP.dither_ulp(x, rng)
    up = d > x
    assert ((d == np.nextafter(x, np.inf)) | (d == np.nextafter(
        x, -np.inf))).all() and 0.45 < up.mean() < 0.55
    ints = np.arange(5)
    np.testing.assert_array_equal(DP.dither_ulp(ints, rng), ints)
    monkeypatch.setattr(HB, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})
    monkeypatch.setattr(DP, "prepare", lambda *a, **kw: TH.prepare(
        *a, **dict(kw, overrides=dict(TINY["cMLP"], **kw["overrides"]))))
    out = DP.step_null("highband", SYSTEM, 0, "cMLP", str(tmp_path), 3,
                       seeds=(1,))
    assert set(out["parting"]) == {"1"} and set(out["runs"]) == {
        "jax", "dither1"}
    j, d = out["runs"]["jax"], out["runs"]["dither1"]
    assert j["stop_epoch"] == d["stop_epoch"] == 2
    # the dither reaches the histories
    assert DP.parting_epoch(d, j) == out["parting"]["1"]
    assert j["val"] != d["val"]


# ------------------------------------------------------ run_grid_lanes, tiny
def test_run_grid_lanes_holds_two_lanes_to_jax(tmp_path, monkeypatch):
    """The science check's fold at a tiny size, two of its points as grid
    lanes for 3 epochs, both packages from one JAX init (and JAX moved one
    ulp each way): each lane's history at the grid bars, the same best
    epochs and active flags, every lane faithful."""
    monkeypatch.setattr(GSP, "SAMPLES", {True: TINY_SAMPLES,
                                         False: TINY_SAMPLES})
    prep = DP.prepare("science", SYSTEM, 0, "point0", str(tmp_path))
    margs = dict(GSP.base_model_args(SYSTEM, False),
                 **TINY["REDCLIFF_S_CMLP"])
    points = [{"gen_lr": p["gen_lr"], "adj_l1_reg_coeff": GSP.rescaled_adj(
        p["ADJ_L1_REG_COEFF"], 2, 6)} for p in GSP._grid_points()[:2]]
    first = DP.run_grid_lanes("jax", str(tmp_path / "first"),
                              GSP.MODEL_TYPE, margs, prep["dargs_file"],
                              points)
    leg = DP.grid_l_leg(str(tmp_path / "leg"), GSP.MODEL_TYPE, margs,
                        prep["dargs_file"], points, first["init"])
    j, t = leg["jax"], leg["port"]
    assert j["val_history"].shape == t["val_history"].shape == (3, 2)
    np.testing.assert_array_equal(first["val_history"], j["val_history"])
    np.testing.assert_allclose(t["val_history"], j["val_history"],
                               **DP.HIST)
    np.testing.assert_allclose(t["best_criteria"], j["best_criteria"],
                               **DP.HIST)
    np.testing.assert_array_equal(t["best_epoch"], j["best_epoch"])
    np.testing.assert_array_equal(t["active"], j["active"])
    assert len(leg["verdicts"]) == 2
    for g, v in enumerate(leg["verdicts"]):
        assert DP.parting_epoch(t["lanes"][g]["val"],
                                j["lanes"][g]["val"]) is None
        assert v["p_port"] is None and v["faithful"], (g, v)
    with pytest.raises(ValueError, match="JAX init"):
        DP.run_grid_lanes("port", str(tmp_path / "p"), GSP.MODEL_TYPE,
                          margs, prep["dargs_file"], points)


# ------------------------------------------------------ the command line
def _threads():
    # the command line sets the port's thread count: keep this process's
    return ["--threads", str(torch.get_num_threads())]


def test_command_line_leg_and_epoch_bisect(tmp_path, monkeypatch):
    """``leg`` writes the records, the summary and both verdicts (over
    its moves and over the one-ulp pair); ``epoch-bisect`` writes the
    bisect inside an epoch, each traced step's terms JSON-ready."""
    monkeypatch.setattr(HB, "SAMPLES", {True: TINY_SAMPLES,
                                        False: TINY_SAMPLES})
    sets = [x for k, v in TINY["REDCLIFF_S_CMLP"].items()
            for x in ("--set", f"{k}={v}")]
    out = str(tmp_path / "leg.json")
    leg = DP.main(["leg", "highband", SYSTEM, "0", "REDCLIFF_S_CMLP",
                   "--out", out, "--ulps", "1,-1,2"] + sets + _threads())
    with open(out) as f:
        assert json.load(f)["summary"] == json.loads(json.dumps(
            leg["summary"]))
    assert set(leg) >= {"jax", "port", "jax+1", "jax-1", "jax+2",
                        "summary", "verdict_one_ulp"}
    assert len(leg["summary"]["verdict"]["p_J_by_ulp"]) == 3
    assert len(leg["verdict_one_ulp"]["p_J_by_ulp"]) == 2
    assert "init" not in leg["jax"]
    # the bisect cuts the task to its epoch + 1; the tiny width's model
    # args come in as the leg's did
    monkeypatch.setattr(DP, "prepare", lambda *a, **kw: TH.prepare(
        *a, **dict(kw, overrides=dict(TINY["REDCLIFF_S_CMLP"],
                                      **kw["overrides"]))))
    b = DP.main(["epoch-bisect", "highband", SYSTEM, "0", "REDCLIFF_S_CMLP",
                 "--epoch", "1", "--out", str(tmp_path / "b.json")]
                + _threads())
    with open(str(tmp_path / "b.json")) as f:
        written = json.load(f)
    assert written["faulty_steps"] == b["faulty_steps"] == 0
    assert [r["epoch"] for r in written["steps"]] == [0, 0, 1, 1]
    assert written["runs"]["jax"]["stop_epoch"] == 1
    assert "traces" not in written


def test_command_line_science_fold_and_selection_grid(tmp_path,
                                                      monkeypatch):
    """``science-fold``: four tiny point tasks and the four-lane grid,
    each faithful, with each run set's winners and rank correlation;
    ``selection-grid``: the 27 published points for 2 epochs on a tiny
    D4IC fold, the port's criteria held to JAX's at the grid bars."""
    from redcliff_tpu_torch.experiments import accuracy_parity_d4ic as APD

    monkeypatch.setattr(GSP, "SAMPLES", {True: TINY_SAMPLES,
                                         False: TINY_SAMPLES})
    monkeypatch.setattr(GSP, "REDCLIFF_ARGS", dict(
        GSP.REDCLIFF_ARGS, **TINY["REDCLIFF_S_CMLP"]))
    sci = DP.main(["science-fold", "--out", str(tmp_path / "s.json")]
                  + _threads())
    assert all(v["faithful"] for v in sci["task_verdicts"]
               + sci["lane_verdicts"])
    for name, r in sci["by_run"].items():
        assert len(r["per_point_best_criteria"]) == 4
        assert r["same_winner"] == (r["per_point_winner"]
                                    == r["grid_winner"])
        assert -1.0 <= r["spearman"] <= 1.0
    np.testing.assert_allclose(
        sci["by_run"]["port"]["per_point_best_criteria"],
        sci["by_run"]["jax"]["per_point_best_criteria"], **DP.HIST)
    monkeypatch.setattr(APD, "SAMPLES", {True: (8, 4), False: (8, 4)})
    sel = DP.main(["selection-grid", "--out", str(tmp_path / "g.json"),
                   "--max-iter", "2"] + _threads())
    assert len(sel["points"]) == len(sel["lane_verdicts"]) == 27
    j, t = sel["by_run"]["jax"], sel["by_run"]["port"]
    assert j["epochs"] == t["epochs"] == 2
    np.testing.assert_allclose(t["best_criteria"], j["best_criteria"],
                               **DP.HIST)
    assert t["selected"] == j["selected"] and t["rank_of_jax_pick"] == 1


# -------------------------------------------------------------- the tool
_TOOL_RUN = ["run", "--study", "highband", "--system", "6-2-4", "--fold",
             "0", "--alg", "cMLP", "--device", "cpu", "--smoke"]


def _blocked(code):
    return ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['redcliff_tpu'] = None\n" + code)


def test_tool_imports_and_runs_with_jax_blocked_then_compares(tmp_path):
    """``tools/task_history.py run`` at the High-band sweep's smoke depth
    (the fold curated at its smoke size, the smoke cuts), once in a
    process where ``jax`` and ``redcliff_tpu`` cannot be imported and
    once here: the two records agree (``compare``: no parting, the same
    decisions and scores), and a record from another seed parts at epoch
    0."""
    a, b, c = (str(tmp_path / f"{n}.json") for n in "abc")
    code = _blocked(
        f"sys.argv = ['task_history.py'] + {_TOOL_RUN + ['--out', a]!r}\n"
        "import runpy\n"
        f"runpy.run_path({TOOL!r}, run_name='__main__')\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'redcliff_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None), "
        "sorted(m for m in sys.modules if 'jax' in m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, REDCLIFF_QUALITY="0"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and rec["alg"] == "cMLP"
    TH.main(_TOOL_RUN + ["--out", b])
    TH.main(_TOOL_RUN + ["--out", c, "--seed", "1"])
    with open(a) as f:
        ra = json.load(f)
    # the smoke cuts: 8 epochs, a check every 2
    assert len(ra["criteria"]) == ra["stop_epoch"] + 1 <= 8
    assert set(ra["val"]) == {"avg_forecasting_loss", "avg_adj_penalty",
                              "avg_combo_loss"}
    assert ra["smoke"] is True and ra["wants_rng"] is False
    line = TH.main(["compare", a, b])
    assert line["parting_epoch"] is None
    for k in ("best_it", "stop_epoch"):
        assert line["a"][k] == line["b"][k]
    np.testing.assert_allclose([line["a"]["f1"], line["a"]["roc_auc"]],
                               [line["b"]["f1"], line["b"]["roc_auc"]],
                               rtol=1e-5)
    assert TH.main(["compare", c, a])["parting_epoch"] == 0


def test_tool_compare_declines_dropout_across_devices():
    """A family that draws dropout on the fit's device: a CPU run and a
    card run are not compared."""
    run = {"criteria": [1.0], "val": {}, "best_it": 0, "stop_epoch": 0,
           "wants_rng": True, "device": "cpu"}
    card = dict(run, device="cuda:0")
    assert TH.compare(run, card)["parting_epoch"] == "draws differ by device"
    assert TH.compare(run, dict(run))["parting_epoch"] is None
    assert TH.compare(dict(run, wants_rng=False),
                      dict(card, wants_rng=False))["parting_epoch"] is None


def test_tool_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TH.main(["run", "--study", "highband", "--alg", "cMLP", "--out",
                 str(tmp_path / "h.json")])
    assert not os.listdir(str(tmp_path))


# -------------------------------------------- published depth (slow legs)
# ROADMAP queue 3 items 30, 26, 27, 28, 14 and 24 at published depth, fold
# 0, each asserting the one-ulp verdict PERF.md records (item 13's rule:
# JAX's moves of one ulp up and one down are the null). Where the port
# misses the rule, the test pins the miss (the item stays open until a
# fix or a finer null changes it) and the bisect inside the parting
# epoch. The port's CPU reductions depend on the thread count: PERF.md's
# legs ran with 3.


@pytest.fixture
def three_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(3)
    yield
    torch.set_num_threads(n)


def _bisect_in_parting_epoch(study, system, alg, epoch, workdir, ties=0):
    """The bisect inside the parting epoch ``epoch``: the cut runs part
    there as the full leg did, the port sees JAX's batches, and the steps
    of epochs ``epoch - 1`` and ``epoch`` that the stated rule
    (``torch_depth_parity.FAULT_DECADE``) flags are exactly the recorded
    ``ties``: steps flagged on the gradient alone that one ulp either way
    clears (``kink_check``)."""
    out = DP.epoch_bisect(study, system, 0, alg, workdir, epoch)
    assert out["verdict"]["p_port"] == epoch, out["verdict"]
    assert out["same_batches"]
    assert out["faulty_steps"] == out["tie_steps"] == ties, [
        (r["epoch"], r["faulty_terms"], r.get("kink"))
        for r in out["steps"] if r["faulty"]]
    return out


@pytest.mark.slow
def test_highband_dgcnn_stops_early_in_both_packages(tmp_path,
                                                     three_threads):
    """DGCNN, 6-2-5 fold 0: from JAX's init both packages (and JAX's
    one-ulp moves) stop at epoch 15 after a best at 5, the port never
    parting from JAX; from the port's own seeded init (the one the port's
    High-band study ran from) both stop at epoch 10 after a best at 0.
    That study's 1.3-1.7 s DGCNN tasks on the card (ROADMAP queue 3 item
    30) are this stop, not a fault."""
    leg = DP.l_leg("highband", "6-2-5", 0, "DGCNN", str(tmp_path))
    assert leg["verdict"] == {"p_J": 7, "p_J_by_ulp": [10, 7],
                              "p_port": None, "faithful": True}
    for name in ("jax", "port", "jax+1", "jax-1"):
        assert (leg[name]["best_it"], leg[name]["stop_epoch"]) == (5, 15)
    prep = DP.prepare("highband", "6-2-5", 0, "DGCNN",
                      str(tmp_path / "own"))
    own = DP.port_init_tree(prep)
    j = DP.run_task("highband", "6-2-5", 0, "DGCNN", "jax",
                    str(tmp_path / "own"), init=own, prep=prep)
    t = DP.run_task("highband", "6-2-5", 0, "DGCNN", "port",
                    str(tmp_path / "own"), init=own, prep=prep)
    assert (j["best_it"], j["stop_epoch"]) == (t["best_it"],
                                              t["stop_epoch"]) == (0, 10)
    assert DP.parting_epoch(t, j) is None


@pytest.mark.slow
def test_highband_redcliff_misses_the_one_ulp_rule(tmp_path,
                                                   three_threads):
    """REDCLIFF-S (K = 5), 6-2-5 fold 0 (ROADMAP queue 3 item 30, open):
    the port parts from JAX at epoch 14 of the embedder pretrain, JAX's
    one-ulp moves at 29 and 17; best and stop 280/290 against JAX's
    293/299 (the moves' 269/279 and 265/275). The bisect inside epoch 14
    flags no step; JAX moved one ulp after every step (``step_null``)
    parts at 18, still later than the port."""
    leg = DP.l_leg("highband", "6-2-5", 0, "REDCLIFF_S_CMLP", str(tmp_path))
    assert leg["verdict"] == {"p_J": 17, "p_J_by_ulp": [29, 17],
                              "p_port": 14, "faithful": False}
    assert [(leg[n]["best_it"], leg[n]["stop_epoch"]) for n in (
        "jax", "port", "jax+1", "jax-1")] == [(293, 299), (280, 290),
                                              (269, 279), (265, 275)]
    _bisect_in_parting_epoch("highband", "6-2-5", "REDCLIFF_S_CMLP", 14,
                             str(tmp_path / "bisect"))
    # the per-step null parts later than the port: 18 and 18
    assert DP.step_null("highband", "6-2-5", 0, "REDCLIFF_S_CMLP",
                        str(tmp_path / "null"), 19)["parting"] == {
        "1": 18, "2": 18}


@pytest.mark.slow
def test_highband_cmlp_holds_to_the_end(tmp_path, three_threads):
    """cMLP, 6-2-4 fold 0: no run parts in 300 epochs; every run's best
    and stop epoch is 299 and the F1s are equal."""
    leg = DP.l_leg("highband", "6-2-4", 0, "cMLP", str(tmp_path))
    assert leg["verdict"] == {"p_J": None, "p_J_by_ulp": [None, None],
                              "p_port": None, "faithful": True}
    for name in ("jax", "port", "jax+1", "jax-1"):
        assert (leg[name]["best_it"], leg[name]["stop_epoch"]) == (299, 299)
        assert leg[name]["f1"] == leg["jax"]["f1"]


# ROADMAP queue 3 item 26: fold 0 of the science check, point (5e-4,
# 0.01) as an array task and the four points as grid lanes, one JAX init
@pytest.mark.slow
def test_science_point_and_lanes_at_depth_are_faithful(tmp_path,
                                                       three_threads):
    """The point's task parts from JAX at epoch 4 as JAX's one-ulp move
    does, and ends at JAX's best and stop epochs (219, 229); each lane
    of the grid parts at epoch 9 as JAX's does."""
    prep = DP.prepare("science", "6-2-2", 0, "point1", str(tmp_path))
    j = DP.run_task("science", "6-2-2", 0, "point1", "jax", str(tmp_path),
                    prep=prep)
    t = DP.run_task("science", "6-2-2", 0, "point1", "port", str(tmp_path),
                    init=j["init"], prep=prep)
    moved = [DP.run_task("science", "6-2-2", 0, "point1", "jax",
                         str(tmp_path), init=j["init"], ulp=u, prep=prep)
             for u in (1, -1)]
    assert DP.verdict(j, t, moved) == {"p_J": 4, "p_J_by_ulp": [4, 40],
                                       "p_port": 4, "faithful": True}
    assert (t["best_it"], t["stop_epoch"]) == (j["best_it"],
                                              j["stop_epoch"]) == (219, 229)
    points = [{"gen_lr": p["gen_lr"], "adj_l1_reg_coeff": GSP.rescaled_adj(
        p["ADJ_L1_REG_COEFF"], 2, 6)} for p in GSP._grid_points()]
    leg = DP.grid_l_leg(str(tmp_path / "grid"), GSP.MODEL_TYPE,
                        GSP.base_model_args("6-2-2", False),
                        prep["dargs_file"], points, j["init"])
    assert all(v["faithful"] for v in leg["verdicts"]), leg["verdicts"]


# ROADMAP queue 3 items 27, 28 and 14: one task each at published depth
@pytest.mark.slow
@pytest.mark.parametrize("study,system,alg,recorded,ties,null", [
    ("factor_count", "6-4-2", "K5", {"p_J": 13, "p_J_by_ulp": [13, 13],
                                     "p_port": 25, "faithful": True}, 0,
     None),
    ("factor_count", "6-4-2", "K6", {"p_J": 12, "p_J_by_ulp": [14, 12],
                                     "p_port": 11, "faithful": False}, 1,
     (14, {"1": None, "2": 11})),
    ("wavelet", "6-2-3", "REDCLIFF_S_CMLP_Smooth",
     {"p_J": 18, "p_J_by_ulp": [31, 18], "p_port": 12, "faithful": False},
     0, (20, {"1": 9, "2": 17})),
    ("d4ic", "HSNR", "REDCLIFF_S_CMLP", {"p_J": 15, "p_J_by_ulp": [15, 75],
                                         "p_port": 15, "faithful": True}, 0,
     None),
    ("d4ic", "HSNR", "cLSTM", {"p_J": 74, "p_J_by_ulp": [74, 77],
                               "p_port": 73, "faithful": False}, 0,
     (76, {"1": 75, "2": 72}))])
def test_study_task_at_depth_one_ulp_verdict(study, system, alg, recorded,
                                             ties, null, tmp_path,
                                             three_threads):
    """K = 5 (the port parts at 25, JAX's moves at 13) and the D4IC
    REDCLIFF-S (15 and 15, the same best and stop epochs, F1 and ROC-AUC)
    meet the one-ulp rule. K = 6 (11 against 12), the wavelet Smooth (12
    against 18) and the D4IC cLSTM (73 against 74) miss it: items 27, 28
    and 14 stay open. The bisect inside each parting epoch flags no step
    but one of K = 6's, a graph-conv ReLU input within float32's rounding
    of its kink (one ulp either way clears it). JAX moved one ulp after
    every step (``step_null``, ``null``: its epochs and partings) parts
    no later than the port on these three."""
    leg = DP.l_leg(study, system, 0, alg, str(tmp_path))
    assert leg["verdict"] == recorded, DP.summary(leg)
    if recorded["faithful"]:
        return
    _bisect_in_parting_epoch(study, system, alg, recorded["p_port"],
                             str(tmp_path / "bisect"), ties=ties)
    epochs, partings = null
    assert DP.step_null(study, system, 0, alg, str(tmp_path / "null"),
                        epochs)["parting"] == partings


# ROADMAP queue 3 item 24: the selection grid stage on D4IC HSNR fold 0
@pytest.mark.slow
def test_selection_grid_at_depth_selects_jaxs_point(tmp_path,
                                                    three_threads):
    """The 27 published lanes from JAX's init on one fold's arrays: every
    lane holds JAX as long as JAX's one-ulp moves do, and the port selects
    JAX's point (gen_lr 2e-3, ADJ_L1 0.01, COS_SIM 0.1)."""
    out = DP.selection_grid(str(tmp_path))
    assert all(v["faithful"] for v in out["lane_verdicts"])
    j, t = out["by_run"]["jax"], out["by_run"]["port"]
    assert t["selected"] == j["selected"] == {
        "gen_lr": 0.002, "ADJ_L1_REG_COEFF": 0.01,
        "FACTOR_COS_SIM_COEFF": 0.1}
    assert t["spearman_vs_jax"] > 0.95
