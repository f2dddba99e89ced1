"""The port's analysis layer (redcliff_tpu_torch/eval/analysis.py) and
plotting helpers (utils/plotting.py) against the JAX package's, on the
cases of tests/test_analysis.py and tests/test_plotting.py.

Both are host code, copied. The tables, the condensed trees and every
pickle equal the JAX package's bit for bit; the CSV tables are the same
bytes. The figures need matplotlib: where it imports (this container), the
port writes the same files under the same names as the JAX package; where
it does not (the card's machine), the figure tests skip inside the test,
and the tables are made all the same.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu.eval import analysis as JA  # noqa: E402
from redcliff_tpu.eval import cross_alg as JX  # noqa: E402
from redcliff_tpu.eval.summaries import OFFDIAG_PARADIGM  # noqa: E402
from redcliff_tpu.models.dynotears import DynotearsConfig  # noqa: E402
from redcliff_tpu_torch.eval import analysis as TA  # noqa: E402
from redcliff_tpu_torch.eval import cross_alg as TX  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEMS = {
    # complexity (12^2-12)/11 = 12.0 -> Moderate
    "numF2_numSF2_numN12_numE11_data": {
        "REDCLIFF_S_CMLP_WithSmoothing": [0.9, 0.8], "CMLP": [0.6, 0.5]},
    # complexity 6 -> Low
    "numF2_numSF2_numN3_numE1_data": {
        "REDCLIFF_S_CMLP_WithSmoothing": [0.7, 0.75], "CMLP": [0.72, 0.6]},
    # complexity 15 -> High, one algorithm short of the baseline
    "numF2_numSF2_numN6_numE2_data": {"CMLP": [0.4, 0.3]},
}


def same(got, want, path=""):
    """Equal bit for bit, recursively (NaN equals NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got, key=str) == sorted(
            want, key=str), path
        for k in want:
            same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}/{i}")
    elif want is None or isinstance(want, str):
        assert got == want, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), path


def _needs_matplotlib():
    pytest.importorskip("matplotlib", reason="figures need matplotlib")


def _files(root):
    """Every file under ``root``, relative, with its size > 0 checked."""
    out = []
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            assert os.path.getsize(p) > 0, p
            out.append(os.path.relpath(p, root))
    return sorted(out)


def _fake_summary(alg_vals, cv_keys=("cv_main",)):
    """A full_comparrisson_summary dict in the cross_alg driver's layout."""
    by_alg = {}
    for alg, vals in alg_vals.items():
        vals = np.asarray(vals, dtype=np.float64)
        by_alg[alg] = {
            "f1_vals_across_factors": vals.tolist(),
            "f1_mean_across_factors": float(vals.mean()),
            "f1_median_across_factors": float(np.median(vals)),
            "f1_std_dev_across_factors": float(vals.std()),
            "f1_mean_std_err_across_factors": float(
                vals.std() / np.sqrt(len(vals))),
        }
    return {k: {OFFDIAG_PARADIGM: by_alg} for k in cv_keys}


def _write_eval_tree(root, two_cv=False):
    for i, (sys_key, alg_vals) in enumerate(SYSTEMS.items()):
        d = os.path.join(root, sys_key)
        os.makedirs(d, exist_ok=True)
        keys = ("cv_main", "cv_other") if two_cv and i == 0 else ("cv_main",)
        with open(os.path.join(d, "full_comparrisson_summary.pkl"),
                  "wb") as f:
            pickle.dump(_fake_summary(alg_vals, keys), f)
        sub = os.path.join(d, "cv_main")
        os.makedirs(sub, exist_ok=True)
        with open(os.path.join(sub, f"factor_level_{OFFDIAG_PARADIGM}_f1_"
                                    "vals_by_algorithm.png"), "wb") as f:
            f.write(b"png")


def test_names_and_scores_equal_jax():
    assert TA.__all__ == JA.__all__
    assert TA.ALG_ALIASES == JA.ALG_ALIASES
    for nc, ne in ((12, 11), (3, 1), (6, 2), (10, 13)):
        same(TA.network_complexity(nc, ne), JA.network_complexity(nc, ne))
    for score in (6.0, 7.0, 12.0, 13.0, 15.0):
        for bounds in ((), (5.0, 10.0)):
            assert TA.complexity_category(score, *bounds) == \
                JA.complexity_category(score, *bounds)
    for name in ("numF2_numSF2_numN12_numE11_edgesNonlinear_labelsOneHot_"
                 "noiT-gaussian_noiL-1-0_oFscF_data", "nN6_nE4_nF3",
                 "synSys6_2_2", "numN6x_numE2"):
        assert TA.parse_system_name(name) == JA.parse_system_name(name)
        assert TA.short_system_name(name) == JA.short_system_name(name)


@pytest.mark.parametrize("two_cv", [False, True])
@pytest.mark.parametrize("baseline", [None, "REDCLIFF_S_CMLP_WithSmoothing"])
def test_condense_cross_experiment_equals_jax(tmp_path, two_cv, baseline):
    _write_eval_tree(str(tmp_path), two_cv)
    same(TA.condense_cross_experiment(str(tmp_path), baseline_alg=baseline),
         JA.condense_cross_experiment(str(tmp_path), baseline_alg=baseline))


@pytest.mark.parametrize("plot", [False, True])
def test_run_cross_experiment_analysis_equals_jax(tmp_path, plot):
    """The banding, the returned tree and ``system_details.pkl``; with
    ``plot`` the banded figures, under the JAX package's names."""
    if plot:
        _needs_matplotlib()
    _write_eval_tree(str(tmp_path / "evals"))
    got = TA.run_cross_experiment_analysis(
        str(tmp_path / "evals"), str(tmp_path / "t"), plot=plot,
        datasets_per_figure=1)
    want = JA.run_cross_experiment_analysis(
        str(tmp_path / "evals"), str(tmp_path / "j"), plot=plot,
        datasets_per_figure=1)
    same(got, want)
    assert got["by_category"]["Moderate"] == [
        "numF2_numSF2_numN12_numE11_data"]
    with open(tmp_path / "t" / "system_details.pkl", "rb") as f:
        same(pickle.load(f), want["system_details"])
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    if plot:
        names = _files(tmp_path / "t")
        assert any(n.startswith("Moderate_complexity_cross_synth")
                   for n in names)
        assert any("REDCImprovement" in n for n in names)


def test_summarize_ablations_equals_jax():
    summaries = {
        "full": _fake_summary({"REDCLIFF_S_CMLP": [0.9, 0.8]}),
        "no_cos_sim": _fake_summary({"REDCLIFF_S_CMLP": [0.7, 0.6]}),
        "short": _fake_summary({"REDCLIFF_S_CMLP": [0.5]}),
    }
    same(TA.summarize_ablations(summaries, "full"),
         JA.summarize_ablations(summaries, "full"))
    two = {k: _fake_summary({"A": [0.1, 0.2], "B": [0.3, 0.5]})
           for k in ("full", "v")}
    same(TA.summarize_ablations(two, "full", algorithm="B"),
         JA.summarize_ablations(two, "full", algorithm="B"))


def test_factor_selection_table_equals_jax(tmp_path):
    runs = {}
    for nf, losses in ((2, [3.0, 2.0, 1.5]), (3, [3.0, 1.0, 1.2])):
        fold_dirs = []
        for fold in range(2):
            d = tmp_path / f"nf{nf}_fold{fold}"
            os.makedirs(d)
            meta = {"avg_forecasting_loss": [x + 0.1 * fold for x in losses],
                    "avg_factor_loss": [x * 0.5 for x in losses]}
            if fold:
                meta.pop("avg_factor_loss")
            with open(d / "training_meta_data_and_hyper_parameters.pkl",
                      "wb") as f:
                pickle.dump(meta, f)
            fold_dirs.append(str(d))
        runs[nf] = fold_dirs
    same(TA.factor_selection_table(runs), JA.factor_selection_table(runs))


def test_collect_summary_figures_equals_jax(tmp_path):
    _write_eval_tree(str(tmp_path / "evals"))
    got = TA.collect_summary_figures(str(tmp_path / "evals"),
                                     str(tmp_path / "t"))
    want = JA.collect_summary_figures(str(tmp_path / "evals"),
                                      str(tmp_path / "j"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def test_generate_analysis_report_equals_jax(tmp_path):
    """The one-command report: the tables, the CSVs (same bytes), the
    pickles, and every figure under the same name."""
    _needs_matplotlib()
    _write_eval_tree(str(tmp_path / "evals"))
    got = TA.generate_analysis_report(str(tmp_path / "evals"),
                                      str(tmp_path / "t"))
    want = JA.generate_analysis_report(str(tmp_path / "evals"),
                                       str(tmp_path / "j"))
    rel = [os.path.basename(p) for p in got.pop("figures")]
    assert rel == [os.path.basename(p) for p in want.pop("figures")]
    same(got, want)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    for name in _files(tmp_path / "t"):
        if name.endswith(".csv"):
            with open(tmp_path / "t" / name, "rb") as a, \
                    open(tmp_path / "j" / name, "rb") as b:
                assert a.read() == b.read(), name
    with open(tmp_path / "t" / "analysis_report.pkl", "rb") as f:
        report = pickle.load(f)
    rel_t = [os.path.basename(p) for p in report.pop("figures")]
    assert rel_t == rel
    same(report, want)


def _dynotears_runs(tmp_path, n_folds=2):
    rng = np.random.default_rng(0)
    true_g = (rng.uniform(size=(4, 4, 1)) > 0.5).astype(float)
    runs = []
    for fold in range(n_folds):
        run = tmp_path / f"dset_fold{fold}_run"
        os.makedirs(run)
        with open(run / "final_best_model.bin", "wb") as f:
            pickle.dump({"model_class": "DynotearsVanillaModel",
                         "config": DynotearsConfig(lag_size=1),
                         "a_est": true_g[:, :, 0] + 0.01 * fold}, f)
        runs.append(str(run))
    return runs, true_g


def test_visualize_trained_model_factors_equals_jax(tmp_path):
    """A JAX-written artifact read out by both packages: the same estimates
    and the cross-fold average, and the same figures."""
    _needs_matplotlib()
    runs, true_g = _dynotears_runs(tmp_path)
    got = TA.visualize_trained_model_factors(
        runs[0], "DYNOTEARS_Vanilla", 1, str(tmp_path / "t"),
        true_gcs=[true_g], device="cpu")
    want = JA.visualize_trained_model_factors(
        runs[0], "DYNOTEARS_Vanilla", 1, str(tmp_path / "j"),
        true_gcs=[true_g])
    same([np.asarray(g) for g in got], [np.asarray(w) for w in want])
    got = TA.visualize_factors_across_folds(
        runs, "DYNOTEARS_Vanilla", 1, str(tmp_path / "tf"),
        true_gcs=[true_g], device="cpu")
    want = JA.visualize_factors_across_folds(
        runs, "DYNOTEARS_Vanilla", 1, str(tmp_path / "jf"),
        true_gcs=[true_g])
    same(got, want)
    assert _files(tmp_path / "t") == _files(tmp_path / "j") == [
        "all_factors_gc_est.png", "factor_0_gc_est.png"]
    assert _files(tmp_path / "tf") == _files(tmp_path / "jf")
    assert "avg_across_folds_gc_est.png" in _files(tmp_path / "tf")


# ---------------------------------------------------------------- plotting

def _draw_every_helper(P, root):
    """tests/test_plotting.py's calls, against one plotting module."""
    rng = np.random.default_rng(0)
    p = lambda name: str(root / name)  # noqa: E731
    A = rng.uniform(size=(5, 5))
    true_gc, est_gc = rng.uniform(size=(5, 5, 2)), rng.uniform(size=(5, 5, 2))
    X = rng.normal(size=(50, 3))
    P.plot_heatmap(A, p("hm.png"), title="t")
    P.plot_gc_est_comparison(true_gc, est_gc, p("cmp.png"), include_lags=True)
    P.plot_gc_est_comparison(true_gc, est_gc, p("cmp_nolag.png"))
    P.plot_gc_est_comparisons_by_factor([true_gc, true_gc], [est_gc, est_gc],
                                        p("byfac.png"))
    P.plot_gc_est_comparisons_by_factor([true_gc], None, p("truthonly.png"),
                                        include_lags=True)
    P.make_scatter_and_std_err_of_mean_plot_overlay(
        {"algA": [0.8, 0.9, 0.85], "algB": [0.6, 0.7, None], "empty": []},
        p("scatter.png"), "title", "alg", "f1", alpha=0.5)
    P.make_scatter_and_std_err_of_mean_plot_overlay(
        {"algA": [0.8, 0.9], "algB": [0.6, 0.7]}, p("main.png"), "t", "alg",
        "f1", make_diff_plots=True)
    P.plot_metric_histories({"loss": [3.0, 2.0, 1.5], "val": [3.1, 2.4, 2.0]},
                            p("hist.png"))
    P.plot_all_signal_channels(X, p("sig.png"), fs=100)
    P.plot_x_wavelet_comparison(X, rng.normal(size=(50, 3, 2)), p("wav.png"))
    P.plot_state_score_traces(rng.uniform(size=(3, 40)), p("scores.png"),
                              labels=["HC", "OF", "TS"])
    P.plot_reconstruction_comparison(X, X + 0.1, p("recon.png"))
    P.plot_cross_experiment_summary(
        p("xexp.png"), means=rng.uniform(size=6),
        sems=rng.uniform(size=6) * .1, alg_names=["A", "B", "C"],
        dataset_names=["numN10_numE20", "numN5_numE9"], title="t",
        xlabel="F1", x_domain_lim=(0, 1))
    P.plot_confidence_interval_summary(
        p("ci.png"), [1, 2, 3], [0.5, 1.5, 2.5], [1.5, 2.5, 3.5],
        center_label="median", title="t", criteria_name="loss",
        domain_name="epoch")
    P.make_bar_and_whisker_plot_overlay(
        {"a": [1.0, 2.0, 3.0], "b": [2.0, 2.5]}, p("bw.png"), title="t")
    P.plot_scattered_results([1, 2, 3], [4, 5, 6], p("sc.png"), x_eps=0.1,
                             y_eps=0.1)
    P.plot_training_loss([3.0, 2.0, 1.0], p("tl.png"))
    P.plot_x_simulation_comparison(rng.normal(size=(2, 30, 3)),
                                   rng.normal(size=(2, 30, 3)), p("sim.png"))
    P.plot_scatter([1, 2], [3, 4], "t", "x", "y", p("s2.png"))
    P.plot_curve([1, 2, 3], "t", "x", "y", p("c.png"), domain_start=5)
    P.plot_curve_comparison([[1, 2, 3], [2, 3, 4]], "t", "x", "y",
                            p("cc.png"))
    P.plot_curve_comparison_from_dict({"a": [1, 2], "b": [2, 3]}, "t", "x",
                                      "y", p("ccd.png"))
    P.plot_system_state_score_comparison(p("ssc.png"),
                                         rng.uniform(size=(3, 30)))
    P.plot_avg_system_state_score_comparison(
        p("avg.png"), [rng.uniform(size=(2, 20)) for _ in range(3)],
        [rng.uniform(size=(2, 20)) for _ in range(3)])
    P.plot_estimated_vs_true_curve(p("evt.png"), [1, 2, 3], [1.1, 2.1, 2.9])
    P.plot_all_signal_channels(rng.normal(size=(60, 2)), p("z.png"), zoom=10)
    P.plot_cross_experiment_summary_grid(
        {"dsetA": {"algA": 0.9, "algB": 0.7}, "dsetB": {"algA": 0.85}},
        p("grid.png"), "optimal_f1")


def test_every_plotting_helper_writes_the_jax_files(tmp_path):
    _needs_matplotlib()
    from redcliff_tpu.utils import plotting as JP
    from redcliff_tpu_torch.utils import plotting as TP

    assert TP.__all__ == JP.__all__
    # the reference-spelling aliases resolve to the same callables
    aliases = sorted(n for n in vars(JP) if "comparisson" in n or
                     n.endswith("_vis"))
    assert aliases and aliases == sorted(
        n for n in vars(TP) if "comparisson" in n or n.endswith("_vis"))
    for n in aliases:
        assert getattr(TP, n).__name__ == getattr(JP, n).__name__
    for P, d in ((TP, tmp_path / "t"), (JP, tmp_path / "j")):
        os.makedirs(d)
        _draw_every_helper(P, d)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert {"z_ZOOMED.png", "algA_IMPROVEMENTS/main.png",
            "grid.png"} <= set(_files(tmp_path / "t"))


def test_cross_alg_figures_equal_jax(tmp_path):
    """``run_cross_algorithm_comparison(plot=True)``: the port's hook, live
    where matplotlib imports, writes the JAX package's figures and the
    same summary."""
    _needs_matplotlib()
    runs, true_g = _dynotears_runs(tmp_path / "DYNOTEARS_Vanilla_models", 1)
    root = str(tmp_path / "DYNOTEARS_Vanilla_models")
    truth = {"dset": {0: [true_g]}}
    got = TX.run_cross_algorithm_comparison([root], truth,
                                            str(tmp_path / "t"), 1,
                                            plot=True, device="cpu")
    want = JX.run_cross_algorithm_comparison([root], truth,
                                             str(tmp_path / "j"), 1,
                                             plot=True)
    same(got, want)
    names = _files(tmp_path / "t")
    assert names == _files(tmp_path / "j")
    assert [n for n in names if n.endswith(".png")]


def test_tables_without_matplotlib(tmp_path):
    """With matplotlib unimportable (the card's machine): importing the
    plotting module raises ImportError; the banding with ``plot=False``,
    the off-diagonal F1 tables, their CSV and the factor-selection table
    are made without a figure. ``generate_analysis_report`` draws, so it
    raises there, as the JAX package's does."""
    _write_eval_tree(str(tmp_path / "evals"))
    code = f"""
import os, sys
sys.modules["matplotlib"] = None
sys.modules["jax"] = None
try:
    import redcliff_tpu_torch.utils.plotting
except ImportError:
    print("NO_PLOTTING")
from redcliff_tpu_torch.eval import analysis as A
from redcliff_tpu_torch.eval import summaries as S
out = A.run_cross_experiment_analysis({str(tmp_path / "evals")!r},
                                      {str(tmp_path / "r")!r}, plot=False)
merged = {{k: e["cv_stats"] for k, e in out["condensed"].items()}}
table = S.summarize_off_diag_f1(merged)
S.write_cross_experiment_report(merged, {str(tmp_path / "r")!r})
print("TABLE", sorted(table["mean"]))
try:
    A.generate_analysis_report({str(tmp_path / "evals")!r},
                               {str(tmp_path / "r2")!r})
except ImportError:
    print("REPORT_NEEDS_MATPLOTLIB")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_PLOTTING" in out.stdout
    assert f"TABLE {sorted(SYSTEMS)}" in out.stdout
    assert "REPORT_NEEDS_MATPLOTLIB" in out.stdout
    names = _files(tmp_path / "r")
    assert "system_details.pkl" in names
    assert [n for n in names if n.endswith(".csv")]
    assert not [n for n in names if n.endswith(".png")]
