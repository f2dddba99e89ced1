"""L6 analysis/reporting layer — the notebook-equivalent analysis driver.

Port of ``redcliff_tpu/eval/analysis.py`` (host numpy; its tables and
pickles equal the JAX package's bit for bit, and it imports nothing of
it). Plotting is imported inside the functions that draw, as in JAX, so the
tables need no matplotlib. ``visualize_*`` load a model through
``eval/model_io.py``, on ``cuda`` unless ``device=`` is given.

Rebuilds, as one scripted module, the reporting capability the reference
spreads across its 91-cell analysis notebook
(the reference's evaluate/ICML2025_REDCLIFF_S_CMLP_Experiments_and_Analyses_
CodeRepo_Notebook.ipynb) and the summ_offDiagF1_* / plotCrossExpSummaries_*
condensers:

* network-complexity scoring + Low/Moderate/High banding
  (ref plotCrossExpSummaries_...py:63-66, notebook cell 83);
* cross-experiment condensation of ``full_comparrisson_summary.pkl`` trees
  into dataset-major mean/SEM arrays, segmented horizontal-bar figures, and
  pairwise-improvement-vs-baseline figures (ref plotCross...py:140-262);
* ablation summaries — per-variant factor-level stats and their differences
  against the full model (notebook cell 63);
* trained-model factor visualization, per fold and averaged across folds
  (notebook cells 20-32, 47-50);
* factor-count selection tables from cross-validated stopping criteria
  (notebook cells 34-35);
* figure collection/renaming into one report folder (the summ_offDiagF1_*
  scripts).

``generate_analysis_report`` chains these into the one-command regeneration
of the paper-style summary tables and figures from a tree of evaluation
artifacts.
"""
from __future__ import annotations

import os
import pickle
import shutil

import numpy as np

from redcliff_tpu_torch.eval.summaries import (
    OFFDIAG_PARADIGM, load_full_comparison_summary, summarize_off_diag_f1,
    write_cross_experiment_report)
from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint

__all__ = [
    "network_complexity",
    "complexity_category",
    "parse_system_name",
    "ALG_ALIASES",
    "condense_cross_experiment",
    "run_cross_experiment_analysis",
    "summarize_ablations",
    "visualize_trained_model_factors",
    "visualize_factors_across_folds",
    "factor_selection_table",
    "collect_summary_figures",
    "generate_analysis_report",
]

# paper display names (ref plotCrossExpSummaries_...py:13-28)
ALG_ALIASES = {
    "REDCLIFF_S_CMLP_WithSmoothing": "REDCLIFF-S (cMLP)",
    "REDCLIFF_S_CMLP": "REDCLIFF-S (cMLP)",
    "CMLP": "cMLP",
    "CLSTM": "cLSTM",
    "DCSFA": "dCSFA-NMF",
    "DYNOTEARS_Vanilla": "DYNOTEARS",
    "DYNOTEARS_Stochastic": "DYNOTEARS (Stochastic)",
    "NAVAR_CMLP": "NAVAR-P",
    "NAVAR_CLSTM": "NAVAR-R",
}


def network_complexity(num_nodes, num_edges):
    """Inverse off-diagonal sparsity: (num_edges / (C^2 - C))^-1 — the paper's
    network complexity score (ref plotCrossExpSummaries_...py:63, notebook
    cell 83). Lower edge density => higher complexity."""
    density = num_edges / (num_nodes**2 - num_nodes)
    return 1.0 / density


def complexity_category(score, moderate_lower_bound=7.0,
                        moderate_upper_bound=13.0):
    """Band a complexity score into the paper's Low/Moderate/High categories
    (ref plotCross...py:64-65, 144-149)."""
    if score <= moderate_lower_bound:
        return "Low"
    if score > moderate_upper_bound:
        return "High"
    return "Moderate"


def parse_system_name(name):
    """Extract {num_factors, num_nodes, num_edges} from either the curation
    folder form (``numF2_numSF2_numN12_numE11_...``) or the paper's shorthand
    (``nN12_nE11_nF2``)."""
    out = {}
    keys = {"numF": "num_factors", "numSF": "num_supervised_factors",
            "numN": "num_nodes", "numE": "num_edges",
            "nF": "num_factors", "nN": "num_nodes", "nE": "num_edges"}
    for part in str(name).split("_"):
        for prefix in sorted(keys, key=len, reverse=True):
            tail = part[len(prefix):]
            if part.startswith(prefix) and tail.isdigit():
                out.setdefault(keys[prefix], int(tail))
                break
    return out


def short_system_name(name):
    """``numF2_numSF2_numN12_numE11_...`` -> ``nN12_nE11_nF2`` (the paper's
    axis shorthand)."""
    d = parse_system_name(name)
    if {"num_nodes", "num_edges", "num_factors"} <= set(d):
        return f"nN{d['num_nodes']}_nE{d['num_edges']}_nF{d['num_factors']}"
    return str(name)


# ---------------------------------------------------------------------------
# Cross-experiment condensation (plotCrossExpSummaries capability)
# ---------------------------------------------------------------------------

def _factor_level_stats(cv_stats, paradigm, stat_root):
    """{alg: {mean, sem, vals}} for one cv dataset's paradigm block."""
    out = {}
    for alg, stats in cv_stats.get(paradigm, {}).items():
        if not isinstance(stats, dict):
            continue
        out[alg] = {
            "mean": stats.get(f"{stat_root}_mean_across_factors"),
            "sem": stats.get(f"{stat_root}_mean_std_err_across_factors"),
            "vals": stats.get(f"{stat_root}_vals_across_factors", []),
        }
    return out


def condense_cross_experiment(eval_root, paradigm=OFFDIAG_PARADIGM,
                              stat_root="f1", baseline_alg=None):
    """Walk ``eval_root/<system>/full_comparrisson_summary.pkl`` artifacts and
    condense each into per-algorithm mean/SEM plus (optionally) pairwise
    per-factor improvement of ``baseline_alg`` over each other algorithm
    (ref plotCross...py:160-186).

    Returns {system_key: {"alg_stats": {alg: {mean, sem, vals}},
    "improvements": {alg: {mean, sem}} | None, "complexity": float | None}}.
    """
    out = {}
    for sys_key in sorted(os.listdir(eval_root)):
        pkl_path = os.path.join(eval_root, sys_key,
                                "full_comparrisson_summary.pkl")
        if not os.path.isfile(pkl_path):
            continue
        full = load_full_comparison_summary(pkl_path)
        # cross-alg drivers write one cv entry per system root (ref :167)
        for cv_key, cv_stats in full.items():
            alg_stats = _factor_level_stats(cv_stats, paradigm, stat_root)
            improvements = None
            if baseline_alg is not None and baseline_alg in alg_stats:
                base_vals = alg_stats[baseline_alg]["vals"]
                improvements = {}
                for alg, st in alg_stats.items():
                    diffs = [b - v for b, v in zip(base_vals, st["vals"])]
                    if diffs:
                        improvements[alg] = {
                            "mean": float(np.mean(diffs)),
                            "sem": float(np.std(diffs) / np.sqrt(len(diffs))),
                        }
            meta = parse_system_name(sys_key)
            comp = None
            if {"num_nodes", "num_edges"} <= set(meta):
                comp = network_complexity(meta["num_nodes"],
                                          meta["num_edges"])
            out[f"{sys_key}::{cv_key}" if len(full) > 1 else sys_key] = {
                "alg_stats": alg_stats,
                "improvements": improvements,
                "complexity": comp,
                "cv_stats": cv_stats,
            }
    return out


def _dataset_major_arrays(condensed_items, alg_names, field):
    """Flat dataset-major [d0a0, d0a1, ..., d1a0, ...] mean/sem arrays for
    plot_cross_experiment_summary."""
    means, sems = [], []
    for _, entry in condensed_items:
        src = entry["alg_stats"] if field == "alg_stats" else entry["improvements"]
        for alg in alg_names:
            st = (src or {}).get(alg, {})
            m, s = st.get("mean"), st.get("sem")
            means.append(np.nan if m is None or not np.isfinite(m) else m)
            sems.append(0.0 if s is None or not np.isfinite(s) else s)
    return means, sems


def run_cross_experiment_analysis(eval_root, save_root,
                                  baseline_alg="REDCLIFF_S_CMLP_WithSmoothing",
                                  paradigm=OFFDIAG_PARADIGM, stat_root="f1",
                                  moderate_lower_bound=7.0,
                                  moderate_upper_bound=13.0,
                                  datasets_per_figure=7, plot=True):
    """The plotCrossExpSummaries driver (ref plotCross...py:140-262): band
    systems by network complexity, emit segmented cross-experiment summary
    figures (absolute performance + pairwise improvement vs the baseline)
    per band, and pickle ``system_details.pkl``.

    Returns {"system_details": ..., "by_category": {cat: [system keys]}}.
    """
    os.makedirs(save_root, exist_ok=True)
    condensed = condense_cross_experiment(eval_root, paradigm=paradigm,
                                          stat_root=stat_root,
                                          baseline_alg=baseline_alg)
    system_details = {}
    by_category = {"Low": [], "Moderate": [], "High": []}
    for sys_key, entry in condensed.items():
        cat = None
        if entry["complexity"] is not None:
            cat = complexity_category(entry["complexity"],
                                      moderate_lower_bound,
                                      moderate_upper_bound)
            by_category[cat].append(sys_key)
        system_details[sys_key] = {
            "dataset_name": short_system_name(sys_key),
            "dataset_complexity": entry["complexity"],
            "complexity_category": cat,
        }

    if plot:
        from redcliff_tpu_torch.utils.plotting import (
            plot_cross_experiment_summary)

        alg_names = sorted({a for e in condensed.values()
                            for a in e["alg_stats"]})
        display = [ALG_ALIASES.get(a, a) for a in alg_names]
        for cat, sys_keys in by_category.items():
            items = [(k, condensed[k]) for k in sys_keys]
            if not items:
                continue
            for seg in range(0, len(items), datasets_per_figure):
                chunk = items[seg: seg + datasets_per_figure]
                names = [system_details[k]["dataset_name"]
                         for k, _ in chunk]
                means, sems = _dataset_major_arrays(chunk, alg_names,
                                                    "alg_stats")
                plot_cross_experiment_summary(
                    os.path.join(
                        save_root,
                        f"{cat}_complexity_cross_synth_edge_prediction_"
                        f"plot{seg // datasets_per_figure}.png"),
                    means, sems, display, names,
                    title=f"Synthetic System Edge Prediction: "
                          f"{cat} Complexity",
                    xlabel="Avg. Optimal F1-Score ± SEM",
                    ylabel="Synthetic System Name (nC-nE-nK)",
                    abbreviate_dataset_names=False)
                if any(e["improvements"] for _, e in chunk):
                    means_i, sems_i = _dataset_major_arrays(
                        chunk, alg_names, "improvements")
                    plot_cross_experiment_summary(
                        os.path.join(
                            save_root,
                            f"{cat}_complexity_cross_pairwise_factorLevel_"
                            f"REDCImprovement_synth_edge_prediction_"
                            f"plot{seg // datasets_per_figure}.png"),
                        means_i, sems_i, display, names,
                        title=f"Pairwise Improvement of "
                              f"{ALG_ALIASES.get(baseline_alg, baseline_alg)}"
                              f": {cat} Complexity",
                        xlabel="Avg. Difference in Optimal F1-Score ± SEM",
                        ylabel="Synthetic System Name (nC-nE-nK)",
                        abbreviate_dataset_names=False)

    with open(os.path.join(save_root, "system_details.pkl"), "wb") as f:
        pickle.dump(system_details, f)
    return {"system_details": system_details, "by_category": by_category,
            "condensed": condensed}


# ---------------------------------------------------------------------------
# Ablation summaries (notebook cell 63)
# ---------------------------------------------------------------------------

def summarize_ablations(summaries_by_variant, full_model_key,
                        paradigm=OFFDIAG_PARADIGM, stat_root="f1",
                        algorithm=None):
    """Condense per-variant evaluation summaries into the ablation table: the
    variant's own factor-level mean ± SEM and the per-factor difference of
    the full model against it (notebook cell 63's CosSim-rho / response
    ablation analyses).

    ``summaries_by_variant`` maps variant name -> full_comparrisson_summary
    dict (each with one cv entry). ``algorithm`` selects which algorithm's
    stats to read inside each summary (default: the variant's only
    algorithm).
    """
    per_variant_vals = {}
    for variant, full in summaries_by_variant.items():
        (cv_key, cv_stats), = list(full.items())
        by_alg = cv_stats.get(paradigm, {})
        alg = algorithm
        if alg is None:
            algs = [a for a, v in by_alg.items() if isinstance(v, dict)]
            assert len(algs) == 1, (
                f"variant {variant!r} has algorithms {algs}; pass `algorithm`")
            alg = algs[0]
        per_variant_vals[variant] = by_alg[alg][
            f"{stat_root}_vals_across_factors"]

    full_vals = per_variant_vals[full_model_key]
    table = {}
    for variant, vals in per_variant_vals.items():
        vals = np.asarray(vals, dtype=np.float64)
        diffs = np.asarray(full_vals[: len(vals)]) - vals[: len(full_vals)]
        table[variant] = {
            "mean": float(np.mean(vals)),
            "sem": float(np.std(vals) / np.sqrt(len(vals))),
            "full_minus_variant_mean": float(np.mean(diffs)),
            "full_minus_variant_sem": float(np.std(diffs)
                                            / np.sqrt(len(diffs))),
            "vals": vals.tolist(),
        }
    return table


# ---------------------------------------------------------------------------
# Trained-model factor visualization (notebook cells 20-32, 47-50)
# ---------------------------------------------------------------------------

def visualize_trained_model_factors(run_dir, alg_name, num_factors, save_dir,
                                    X=None, true_gcs=None, device=None):
    """Load one trained run, read out its per-factor GC estimates, and write
    per-factor est(-vs-true) heatmaps plus the lag-summed factor panel
    (the notebook's per-fold model visualization cells). Returns the
    estimates. The model loads on ``device`` (``cuda`` unless given)."""
    from redcliff_tpu_torch.eval.gc_estimates import get_model_gc_estimates
    from redcliff_tpu_torch.eval.model_io import load_model_for_eval
    from redcliff_tpu_torch.utils.plotting import (
        plot_gc_est_comparison, plot_gc_est_comparisons_by_factor)

    loaded = load_model_for_eval(run_dir, device=device)
    model, params = loaded[0], loaded[1]
    ests = get_model_gc_estimates(model, params, alg_name, num_factors, X=X)
    os.makedirs(save_dir, exist_ok=True)
    for k, est in enumerate(ests):
        plot_gc_est_comparison(
            None if true_gcs is None else true_gcs[k], est,
            os.path.join(save_dir, f"factor_{k}_gc_est.png"))
    plot_gc_est_comparisons_by_factor(
        true_gcs, ests, os.path.join(save_dir, "all_factors_gc_est.png"))
    return ests


def visualize_factors_across_folds(run_dirs, alg_name, num_factors, save_dir,
                                   X=None, true_gcs=None, device=None):
    """Per-fold visualization + the cross-fold average panel (notebook
    "Avg. Across Folds" cell 30). Factor estimates are max-normalized before
    averaging so folds with different GC scales contribute equally."""
    from redcliff_tpu_torch.utils.plotting import (
        plot_gc_est_comparisons_by_factor)

    all_ests = []
    for fold, run_dir in enumerate(run_dirs):
        ests = visualize_trained_model_factors(
            run_dir, alg_name, num_factors,
            os.path.join(save_dir, f"fold_{fold}"), X=X, true_gcs=true_gcs,
            device=device)
        normed = []
        for e in ests:
            e = np.asarray(e, dtype=np.float64)
            peak = np.max(e)
            normed.append(e / peak if peak > 0 else e)
        all_ests.append(normed)
    avg = [np.mean([fold[k] for fold in all_ests], axis=0)
           for k in range(num_factors)]
    plot_gc_est_comparisons_by_factor(
        true_gcs, avg, os.path.join(save_dir, "avg_across_folds_gc_est.png"))
    return avg


# ---------------------------------------------------------------------------
# Factor-count selection (notebook cells 34-35)
# ---------------------------------------------------------------------------

def factor_selection_table(run_dirs_by_num_factors,
                           criteria_keys=("avg_forecasting_loss",
                                          "avg_factor_loss")):
    """Cross-validated stopping-criteria comparison across factor counts: for
    each candidate num_factors, the mean and SEM (across folds) of each
    criterion's best (minimum) epoch value. The notebook uses this to pick
    the TST 9-factor model (cells 34-35)."""
    table = {}
    for num_factors, run_dirs in run_dirs_by_num_factors.items():
        per_criterion = {k: [] for k in criteria_keys}
        for run_dir in run_dirs:
            meta_path = os.path.join(
                run_dir, "training_meta_data_and_hyper_parameters.pkl")
            # format-aware read: durable-header metas and legacy pickles
            meta = read_checkpoint(meta_path)
            for k in criteria_keys:
                hist = meta.get(k)
                if hist:
                    per_criterion[k].append(float(np.min(hist)))
        entry = {}
        for k, vals in per_criterion.items():
            if vals:
                entry[f"{k}_mean"] = float(np.mean(vals))
                entry[f"{k}_sem"] = float(np.std(vals) / np.sqrt(len(vals)))
                entry[f"{k}_vals"] = vals
        table[num_factors] = entry
    return table


# ---------------------------------------------------------------------------
# Figure collection (summ_offDiagF1_* capability)
# ---------------------------------------------------------------------------

def collect_summary_figures(eval_root, save_root,
                            figure_suffix="_by_algorithm.png"):
    """Gather per-system evaluation figures into one report folder, renamed
    with their system prefix (ref summ_offDiagF1_...py:21-40). Returns the
    copied paths."""
    os.makedirs(save_root, exist_ok=True)
    copied = []
    for sys_key in sorted(os.listdir(eval_root)):
        sys_dir = os.path.join(eval_root, sys_key)
        if not os.path.isdir(sys_dir):
            continue
        for sub in sorted(os.listdir(sys_dir)):
            sub_dir = os.path.join(sys_dir, sub)
            if not (os.path.isdir(sub_dir) and sub.startswith("cv")):
                continue
            for fname in sorted(os.listdir(sub_dir)):
                if fname.endswith(figure_suffix):
                    dst = os.path.join(save_root, f"{sys_key}_{fname}")
                    shutil.copy(os.path.join(sub_dir, fname), dst)
                    copied.append(dst)
    return copied


# ---------------------------------------------------------------------------
# One-command report
# ---------------------------------------------------------------------------

def generate_analysis_report(eval_root, save_root,
                             baseline_alg="REDCLIFF_S_CMLP_WithSmoothing",
                             paradigm=OFFDIAG_PARADIGM):
    """Regenerate the paper-style summary artifacts from a tree of
    per-system evaluation outputs (each ``eval_root/<system>/`` holding a
    ``full_comparrisson_summary.pkl``): headline off-diagonal-F1 CSV tables
    + grids, complexity-banded cross-experiment figures with improvement
    panels, and the collected per-system figures — the one command that
    replaces re-running the analysis notebook."""
    os.makedirs(save_root, exist_ok=True)
    report = {"tables": {}, "figures": []}

    # complexity-banded cross-experiment figures (one walk/load of the tree;
    # the condensed entries carry the raw cv stats for the tables below)
    cross = run_cross_experiment_analysis(
        eval_root, save_root, baseline_alg=baseline_alg, paradigm=paradigm)
    report["system_details"] = cross["system_details"]
    report["by_category"] = cross["by_category"]

    # per-system headline tables (summ capability)
    merged = {key: entry["cv_stats"]
              for key, entry in cross["condensed"].items()}
    if merged:
        report["tables"]["off_diag_f1"] = summarize_off_diag_f1(merged)
        write_cross_experiment_report(
            merged, save_root, paradigm=paradigm,
            stat="f1_mean_across_factors")

    # collected per-system figures
    report["figures"] = collect_summary_figures(eval_root, save_root)

    with open(os.path.join(save_root, "analysis_report.pkl"), "wb") as f:
        pickle.dump(report, f)
    return report
