"""Cross-experiment summary condensation (a copy of the JAX package's
``eval/summaries.py``; stdlib and numpy).

The reference's summ_offDiagF1_* / plotCrossExpSummaries_* tooling
(its ``evaluate/`` scripts): condense the
``full_comparrisson_summary.pkl`` written by the cross-algorithm driver into
flat per-(dataset, algorithm) tables for the paper's headline statistic
(off-diagonal optimal F1 by default) and render the cross-experiment grid.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = [
    "load_full_comparison_summary",
    "extract_metric_table",
    "summarize_off_diag_f1",
    "write_cross_experiment_report",
]

OFFDIAG_PARADIGM = "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag"


def load_full_comparison_summary(path):
    """Load a full_comparrisson_summary.pkl (file or containing directory)."""
    if os.path.isdir(path):
        path = os.path.join(path, "full_comparrisson_summary.pkl")
    with open(path, "rb") as f:
        return pickle.load(f)


def extract_metric_table(full_summary, paradigm=OFFDIAG_PARADIGM,
                         stat="f1_mean_across_factors"):
    """{dataset: {algorithm: value}} for one paradigm/statistic."""
    table = {}
    for dset, cv_stats in full_summary.items():
        by_alg = cv_stats.get(paradigm, {})
        table[dset] = {alg: stats.get(stat)
                       for alg, stats in by_alg.items()
                       if isinstance(stats, dict)}
    return table


def summarize_off_diag_f1(full_summary):
    """The paper's headline table: mean / median / SEM of the off-diagonal
    optimal-F1 per (dataset, algorithm) (the summ_offDiagF1_* scripts)."""
    out = {}
    for stat_suffix in ("mean", "median", "mean_std_err"):
        out[stat_suffix] = extract_metric_table(
            full_summary, OFFDIAG_PARADIGM,
            f"f1_{stat_suffix}_across_factors")
    return out


def write_cross_experiment_report(full_summary, save_root,
                                  paradigm=OFFDIAG_PARADIGM,
                                  stat="f1_mean_across_factors", plot=True):
    """Write the condensed table as CSV (+ heatmap grid) under save_root.
    Returns the table."""
    table = extract_metric_table(full_summary, paradigm, stat)
    os.makedirs(save_root, exist_ok=True)
    algs = sorted({a for d in table.values() for a in d})
    csv_path = os.path.join(save_root, f"{paradigm}__{stat}.csv")
    with open(csv_path, "w") as f:
        f.write("dataset," + ",".join(algs) + "\n")
        for dset, row in table.items():
            cells = [("" if row.get(a) is None else f"{row[a]:.6f}")
                     for a in algs]
            f.write(dset + "," + ",".join(cells) + "\n")
    if plot:
        try:
            # without matplotlib (the card's machine) the table only
            from redcliff_tpu_torch.utils.plotting import (
                plot_cross_experiment_summary_grid)
            plot_cross_experiment_summary_grid(
                table, os.path.join(save_root, f"{paradigm}__{stat}.png"),
                stat, title=f"{stat} ({paradigm})")
        except ImportError:
            pass
    return table
