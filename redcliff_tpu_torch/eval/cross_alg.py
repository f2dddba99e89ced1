"""Cross-algorithm system-level comparison driver (port of
``eval/cross_alg.py``).

One parameterized driver replacing the reference's 19 near-identical
eval_sysOptF1_crossAlg_* scripts (canonical walk-through: the reference's
evaluate/eval_sysOptF1_crossAlg_d4IC_HSNR_bCgsParsim_REDCSmovNEWcMLP.py:15-322):
for every (cv-dataset × fold × algorithm) it locates the trained run directory
by the shared folder-name convention, loads the artifact, reads per-factor GC
estimates, scores the three optimal-F1 stat paradigms per factor, and
aggregates mean/median/std/SEM across factors and then folds, writing
``results_summary.pkl`` per cv-dataset and a ``full_comparrisson_summary.pkl``
at the root (the reference's artifact names, kept for tooling parity).

The entry points that load a model take ``device`` (default ``cuda``,
raising without a card; the tests pass ``"cpu"``): the model's readout
runs there, the statistics on the host. The port loads the artifacts of
every family (``eval/model_io.py``): REDCLIFF-S, cMLP, cLSTM, NAVAR,
DGCNN, DCSFA-NMF and DYNOTEARS (whose graph is read on the host).
"""
from __future__ import annotations

import os
import pickle

from redcliff_tpu_torch.eval.gc_estimates import get_model_gc_estimates
from redcliff_tpu_torch.eval.model_io import load_model_for_eval
from redcliff_tpu_torch.eval.stats import (summarize_values,
                                           three_view_optimal_f1_stats)

__all__ = [
    "ALL_POSSIBLE_ALGORITHMS",
    "find_run_directory",
    "evaluate_algorithm_on_fold",
    "run_cross_algorithm_comparison",
    "read_in_true_causal_graphs_for_all_datasets",
]


def read_in_true_causal_graphs_for_all_datasets(dataset_names,
                                                files_of_cached_data_args,
                                                data_vis_root_save_path=None):
    """Load every dataset's true per-factor GC tensors from its cached-args
    file, optionally writing ground-truth visualization folders
    (ref eval_utils.py:25-42). Returns [per-dataset [factor tensors]] in
    dataset order."""
    from redcliff_tpu_torch.utils.config import load_true_gc_factors

    true_causal_graphs = []
    for dset_name, dset_args in zip(dataset_names,
                                    files_of_cached_data_args):
        factors = load_true_gc_factors(dset_args)
        if data_vis_root_save_path is not None:
            vis_dir = os.path.join(data_vis_root_save_path, dset_name)
            os.makedirs(vis_dir, exist_ok=True)
            try:
                from redcliff_tpu_torch.utils.plotting import \
                    plot_gc_est_comparisons_by_factor
                plot_gc_est_comparisons_by_factor(
                    factors, None,
                    os.path.join(vis_dir, "true_gc_factors.png"))
            except ImportError:
                pass
        true_causal_graphs.append(factors)
    return true_causal_graphs

# ref eval_sysOptF1...py:75-87
ALL_POSSIBLE_ALGORITHMS = [
    "REDCLIFF_S_CMLP",
    "REDCLIFF_S_CLSTM",
    "REDCLIFF_S_DGCNN",
    "CMLP",
    "CLSTM",
    "DGCNN",
    "DCSFA",
    "DYNOTEARS_Stochastic",
    "DYNOTEARS_Vanilla",
    "NAVAR_CLSTM",
    "NAVAR_CMLP",
]


def select_algorithm_root(alg_name, root_paths):
    """Resolve the one trained-models root matching an algorithm name,
    with the reference's alias edge cases (ref :126-141)."""
    if alg_name in ("CMLP", "CLSTM", "DGCNN"):
        cands = [x for x in root_paths
                 if alg_name in x and "REDCLIFF" not in x and "NAVAR" not in x]
    else:
        cands = [x for x in root_paths if alg_name in x]
    if len(cands) != 1:
        raise ValueError(
            f"expected exactly one trained-models root for {alg_name!r}, "
            f"found {cands!r} in {root_paths!r}")
    return cands[0]


def find_run_directory(alg_root, cv_dset_name, fold_num):
    """Locate the single run dir for (dataset, fold) by folder-name
    convention (ref :143-153)."""
    cands = [
        os.path.join(alg_root, x) for x in os.listdir(alg_root)
        if os.path.isdir(os.path.join(alg_root, x))
        and cv_dset_name in x and f"fold{fold_num}" in x
    ]
    if len(cands) != 1:
        raise ValueError(
            f"expected exactly one run dir for ({cv_dset_name!r}, "
            f"fold {fold_num}) under {alg_root!r}, found {cands!r}")
    return cands[0]


def evaluate_algorithm_on_fold(run_dir, alg_name, true_gcs, X=None,
                               device=None):
    """Per-factor three-view optimal-F1 stats + cross-factor summaries for one
    trained run (ref :169-237), its model loaded on ``device``. Returns the
    alg_level_stats dict. A DCSFA-NMF artifact loads as ``(model, params,
    state)``; its graphs need the params only."""
    loaded = load_model_for_eval(run_dir, device=device)
    model, params = loaded[0], loaded[1]
    estimated_gcs = get_model_gc_estimates(model, params, alg_name,
                                           len(true_gcs), X=X)
    alg_level_stats = {}
    for factor_id, (est, true) in enumerate(zip(estimated_gcs, true_gcs)):
        alg_level_stats[f"factor_{factor_id}"] = \
            three_view_optimal_f1_stats(est, true)

    # cross-factor aggregation (ref :218-237)
    paradigms = {}
    for f_key, f_stats in alg_level_stats.items():
        for paradigm, stats in f_stats.items():
            for stat_key, val in stats.items():
                paradigms.setdefault(paradigm, {}).setdefault(
                    stat_key, []).append(val)
    for paradigm, stat_lists in paradigms.items():
        assert paradigm not in alg_level_stats
        alg_level_stats[paradigm] = {}
        for stat_key, vals in stat_lists.items():
            s = summarize_values(vals)
            alg_level_stats[paradigm][
                f"{stat_key}_vals_across_factors"] = s["vals"]
            alg_level_stats[paradigm][
                f"{stat_key}_mean_across_factors"] = s["mean"]
            alg_level_stats[paradigm][
                f"{stat_key}_median_across_factors"] = s["median"]
            alg_level_stats[paradigm][
                f"{stat_key}_std_dev_across_factors"] = s["std_dev"]
            alg_level_stats[paradigm][
                f"{stat_key}_mean_std_err_across_factors"] = s["mean_std_err"]
    return alg_level_stats


def run_cross_algorithm_comparison(root_paths_to_trained_models,
                                   true_causal_graphs, save_root_path,
                                   num_folds, algorithms=None, plot=False,
                                   eval_inputs=None, device=None):
    """Full comparison flow (ref :96-322).

    Args:
      root_paths_to_trained_models: list of per-algorithm trained-model roots.
      true_causal_graphs: {cv_dset_name: {fold: [true GC per factor]}}.
      save_root_path: output root; per-cv summaries and the full summary
        pickle land here in the reference layout.
      num_folds: folds per cv dataset.
      algorithms: explicit algorithm list; default = all recognized in roots
        (ref :90-94).
      plot: when True and utils.plotting is importable, emit the scatter/SEM
        comparison figures.
      eval_inputs: optional {cv_dset_name: {fold: X}} signal windows for
        families whose GC readout is data-dependent (NAVAR contribution
        statistics, conditional REDCLIFF modes).
      device: where each run's model is loaded and read out (default
        ``cuda``).
    """
    if algorithms is None:
        # an algorithm participates iff its root resolves unambiguously
        # (ref :90-94, with the alias disambiguation of :126-141 applied)
        algorithms = []
        for a in ALL_POSSIBLE_ALGORITHMS:
            try:
                select_algorithm_root(a, root_paths_to_trained_models)
                algorithms.append(a)
            except ValueError:
                continue
    os.makedirs(save_root_path, exist_ok=True)
    full_summary = {}
    for cv_dset_name, folds in true_causal_graphs.items():
        cv_level_stats = {}
        cv_save = os.path.join(save_root_path, f"cv_{cv_dset_name}")
        os.makedirs(cv_save, exist_ok=True)
        for f_num in range(num_folds):
            true_gcs = folds[f_num]
            fold_X = None
            if eval_inputs is not None:
                fold_X = eval_inputs.get(cv_dset_name, {}).get(f_num)
            fold_level_stats = {}
            for alg_name in algorithms:
                alg_root = select_algorithm_root(
                    alg_name, root_paths_to_trained_models)
                run_dir = find_run_directory(alg_root, cv_dset_name, f_num)
                fold_level_stats[alg_name] = evaluate_algorithm_on_fold(
                    run_dir, alg_name, true_gcs, X=fold_X, device=device)
            cv_level_stats[f"fold_{f_num}_details"] = fold_level_stats
            # accumulate per-(paradigm, alg) value lists across folds
            for alg_name, alg_stats in fold_level_stats.items():
                for paradigm, stats in alg_stats.items():
                    if "factor_" in paradigm:
                        continue
                    pd = cv_level_stats.setdefault(paradigm, {}).setdefault(
                        alg_name, {})
                    for stat_key, val in stats.items():
                        if not stat_key.endswith("_vals_across_factors"):
                            continue
                        pd.setdefault(stat_key, []).extend(val)
        # cross-fold aggregation (ref :274-299)
        for paradigm, by_alg in cv_level_stats.items():
            if "_vs_" not in paradigm:
                continue
            for alg_name, stat_map in by_alg.items():
                for stat_val_key in list(stat_map.keys()):
                    if not stat_val_key.endswith("_vals_across_factors"):
                        continue
                    stat_key = stat_val_key[: -len("_vals_across_factors")]
                    s = summarize_values(stat_map[stat_val_key])
                    stat_map[f"{stat_key}_mean_across_factors"] = s["mean"]
                    stat_map[f"{stat_key}_median_across_factors"] = s["median"]
                    stat_map[f"{stat_key}_std_dev_across_factors"] = s["std_dev"]
                    stat_map[f"{stat_key}_mean_std_err_across_factors"] = \
                        s["mean_std_err"]
        if plot:
            _plot_cv_summaries(cv_level_stats, algorithms, cv_save)
        with open(os.path.join(cv_save, "results_summary.pkl"), "wb") as f:
            pickle.dump(cv_level_stats, f)
        full_summary[cv_dset_name] = cv_level_stats
    with open(os.path.join(save_root_path, "full_comparrisson_summary.pkl"),
              "wb") as f:
        pickle.dump(full_summary, f)
    return full_summary


def _plot_cv_summaries(cv_level_stats, algorithms, cv_save):
    # matplotlib is absent on the card's machine: no figures there
    try:
        from redcliff_tpu_torch.utils.plotting import \
            make_scatter_and_std_err_of_mean_plot_overlay
    except ImportError:
        return
    for paradigm, by_alg in cv_level_stats.items():
        if "_vs_" not in paradigm:
            continue
        stat_val_keys = set()
        for alg in by_alg.values():
            stat_val_keys |= {k for k in alg
                              if k.endswith("_vals_across_factors")}
        for svk in sorted(stat_val_keys):
            results = {a: by_alg[a].get(svk, []) for a in algorithms
                       if a in by_alg}
            make_scatter_and_std_err_of_mean_plot_overlay(
                results,
                os.path.join(cv_save,
                             f"factor_level_{paradigm}_{svk}_by_algorithm.png"),
                f"Comparing Factor-Level {svk[:-len('_vals_across_factors')]} "
                f"Between Algorithms", "Algorithm", svk, alpha=0.5)
