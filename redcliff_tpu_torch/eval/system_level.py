"""System-level estimation evaluation drivers, single model family (port of
``eval/system_level.py``).

The two ~600-line drivers at the bottom of the reference's eval machinery
(its evaluate/eval_utils.py:1093
``perform_system_level_estimation_evaluation_of_cv_model`` and :1692
``perform_system_level_estimation_evaluation_of_gs``): walk a trained-
models root, pair every run with its dataset's true factor graphs, read out
GC estimates, and score each factor with the key similarity battery (cosine
similarity, MSE, directed/undirected DeltaCon0, DeltaCon0 with directed
degrees, Deltaffinity, ROC-AUC) on both the normal and transposed views,
aggregating mean/std across factors within a fold and then across folds.
Artifacts pickle under the reference's summary layout so downstream tooling
(grid selection, analysis reports) reads them uniformly.

Options mirror the reference's: Hungarian sorting of unsupervised estimates
onto the ground truth (``sort_unsupervised_ests``), averaging all estimated
graphs into one (``average_estimated_graphs_together``), excluding self
connections, and an identity-matrix baseline
(``evaluate_identity_baseline``).

The drivers that load models take ``device`` (default ``cuda``, raising
without a card): each run's readout runs there, the scoring on the host.
"""
from __future__ import annotations

import os
import pickle
import re

import numpy as np

from redcliff_tpu_torch.utils.config import load_true_gc_factors
from redcliff_tpu_torch.utils.metrics import (
    compute_cosine_similarity,
    compute_mse,
    deltacon0,
    deltacon0_with_directed_degrees,
    deltaffinity,
    roc_auc,
)
from redcliff_tpu_torch.utils.misc import sort_unsupervised_estimates
from redcliff_tpu_torch.eval.gc_estimates import get_model_gc_estimates
from redcliff_tpu_torch.eval.model_io import load_model_for_eval

__all__ = [
    "key_similarity_stats",
    "evaluate_fold_system_level",
    "evaluate_system_level_cv",
    "evaluate_system_level_gs",
]


def key_similarity_stats(est, true, eps=0.1, in_degree_coeff=1.0,
                         out_degree_coeff=1.0, max_path_length=None):
    """The reference's per-factor system-level battery (ref :1286-1364):
    cosine sim, MSE, directed + undirected DeltaCon0, DeltaCon0 with
    directed degrees, Deltaffinity (all called as metric(true, est)), and
    ROC-AUC of the est scores against the binarized truth."""
    out = {
        "cos_sim": compute_cosine_similarity(true, est),
        "mse": compute_mse(true, est),
        "dir_deltacon0": deltacon0(true, est, eps),
        "undir_deltacon0": deltacon0(true, est, eps,
                                     make_graphs_undirected=True),
        "deltacon0_wDD": deltacon0_with_directed_degrees(
            true, est, eps, in_degree_coeff=in_degree_coeff,
            out_degree_coeff=out_degree_coeff),
        "deltaffinity": deltaffinity(true, est, eps,
                                     max_path_length=max_path_length),
    }
    labels = (true.ravel() > 0).astype(int)
    try:
        out["roc_auc"] = (roc_auc(labels, est.ravel())
                          if 0 < labels.sum() < len(labels) else 0.5)
    except ValueError:
        out["roc_auc"] = np.nan
    return out


METRIC_KEYS = ("cos_sim", "mse", "dir_deltacon0", "undir_deltacon0",
               "deltacon0_wDD", "deltaffinity", "roc_auc")


def evaluate_fold_system_level(est_gcs, true_gcs, eps=0.1,
                               in_degree_coeff=1.0, out_degree_coeff=1.0,
                               max_path_length=None,
                               exclude_self_connections=False,
                               sort_unsupervised_ests=False,
                               cost_criteria="CosineSimilarity",
                               unsupervised_start_index=0,
                               average_estimated_graphs_together=False,
                               evaluate_identity_baseline=False):
    """Score one run's per-factor estimates against its true graphs on the
    normal and transposed views.  Returns {"normal": {metric: [per-factor]},
    "transposed": {...}}.

    Operation order matches the reference exactly (ref :1249-1283):
    Hungarian sorting runs on the RAW (possibly lagged) estimates; the
    identity baseline then overwrites them (and skips normalization); self
    connections are excluded from the ESTIMATES only — the truth is never
    masked or normalized; estimates normalize by their full-tensor max
    BEFORE lag-summing; averaging applies only when there are more
    estimates than truths (which requires exactly one truth)."""
    ests = [np.asarray(e, dtype=np.float64) for e in est_gcs]
    trues = [np.asarray(t, dtype=np.float64) for t in true_gcs]
    if sort_unsupervised_ests:
        # the reference sorts on the RAW tensors (ref :1250); when a
        # non-lagged estimator meets lagged truths the raw shapes differ,
        # so the assignment cost falls back to lag-summed views while the
        # permutation still applies to the raw estimates
        same_dims = all(e.shape == t.shape for e, t in zip(ests, trues))
        cost_ests = ests if same_dims else [
            e.sum(axis=2) if e.ndim == 3 else e for e in ests]
        cost_trues = trues if same_dims else [
            t.sum(axis=2) if t.ndim == 3 else t for t in trues]
        _, matched_est, matched_true = sort_unsupervised_estimates(
            cost_ests, cost_trues, cost_criteria=cost_criteria,
            unsupervised_start_index=unsupervised_start_index,
            return_sorting_inds=True)
        u = unsupervised_start_index
        # slots sized by TRUTH count (as in misc.sort_unsupervised_estimates:
        # a truth index from the assignment can exceed the estimate count)
        tail = [None] * (len(trues) - u)
        for est_ind, gt_ind in zip(matched_est, matched_true):
            tail[gt_ind] = ests[u + est_ind]
        leftover = [ests[u + i] for i in range(len(ests) - u)
                    if i not in matched_est]
        # keep None placeholders for unmatched truths so positional pairing
        # with `trues` stays aligned; the scoring loop skips them
        ests = ests[:u] + tail + leftover
    if evaluate_identity_baseline:
        # overwrite with identity, keeping each estimate's rank (ref :1251)
        ests = [None if e is None
                else np.eye(e.shape[0])[:, :, None] if e.ndim == 3
                else np.eye(e.shape[0]) for e in ests]
    if exclude_self_connections:
        # estimates only — the reference never masks the truth (ref :1255)
        ests = [None if e is None
                else e * (1.0 - (np.eye(e.shape[0])[:, :, None] if e.ndim == 3
                                 else np.eye(e.shape[0]))) for e in ests]
    if not evaluate_identity_baseline:
        # full-tensor max BEFORE lag-summing (ref :1260); zero-max guarded
        # (the reference would emit NaNs there)
        ests = [None if e is None
                else e / np.max(e) if np.max(e) > 0 else e for e in ests]
    live_ests = [e for e in ests if e is not None]
    if average_estimated_graphs_together and len(live_ests) > len(trues):
        assert len(trues) == 1, (
            "averaging estimates together requires exactly one true graph "
            "(ref :1265)")
        ests = [np.mean(live_ests, axis=0)]

    out = {"normal": {k: [] for k in METRIC_KEYS},
           "transposed": {k: [] for k in METRIC_KEYS}}
    for true_gc, gc_est in zip(trues, ests):
        if gc_est is None:  # truth left unmatched by the Hungarian sort
            continue
        # lag-summed comparison only, for fairness between lagged and
        # non-lagged estimators (ref :1277-1280)
        if true_gc.ndim == 3:
            true_gc = true_gc.sum(axis=2)
        if gc_est.ndim == 3:
            gc_est = gc_est.sum(axis=2)
        for view, est in (("normal", gc_est), ("transposed", gc_est.T)):
            stats = key_similarity_stats(
                est, true_gc, eps=eps, in_degree_coeff=in_degree_coeff,
                out_degree_coeff=out_degree_coeff,
                max_path_length=max_path_length)
            for k in METRIC_KEYS:
                out[view][k].append(stats[k])
    return out


def _fold_token(name):
    m = re.search(r"fold[_]?(\d+)", name)
    return int(m.group(1)) if m else None


def _aggregate_folds(fold_stats):
    """{view: {metric: {"by_fold": {fold: [per-factor]}, "fold_means": [...],
    "fold_std_devs": [...], "cross_fold_mean", "cross_fold_std_dev"}}}.
    Std devs are population (ddof=0), the reference's convention."""
    out = {}
    for view in ("normal", "transposed"):
        out[view] = {}
        for k in METRIC_KEYS:
            by_fold = {f: s[view][k] for f, s in fold_stats.items()}
            means = [float(np.mean(v)) for v in by_fold.values() if v]
            stds = [float(np.std(v)) for v in by_fold.values() if v]
            out[view][k] = {
                "by_fold": by_fold,
                "fold_means": means,
                "fold_std_devs": stds,
                "cross_fold_mean": float(np.mean(means)) if means else None,
                "cross_fold_std_dev": float(np.std(means)) if means else None,
            }
    return out


def _true_graphs_from_args(data_args_file, model_type):
    return load_true_gc_factors(data_args_file, model_type=model_type)


def evaluate_system_level_cv(model_type, trained_models_root_path,
                             cv_split_names, files_of_cached_data_args,
                             save_dir, X_by_split=None, device=None,
                             **options):
    """The CV-experiment driver (ref :1093-1690): for every cv split, match
    each fold's run directory (``final_best_model.bin`` present, fold token
    in the name) to its data cached-args file, score it, and aggregate
    across folds.  Writes
    ``<save_dir>/<split>_system_level_eval_summary.pkl`` per split and
    returns {split: aggregated stats}.

    ``options`` pass through to :func:`evaluate_fold_system_level` (plus
    ``eps``/degree coefficients). ``X_by_split`` supplies eval windows for
    families whose GC readout is data-dependent; ``device`` is where each
    run's model is loaded and read out (default ``cuda``)."""
    os.makedirs(save_dir, exist_ok=True)
    results = {}
    for split in cv_split_names:
        run_dirs = sorted(
            os.path.join(trained_models_root_path, d)
            for d in os.listdir(trained_models_root_path)
            if split in d
            and os.path.isdir(os.path.join(trained_models_root_path, d))
            and "final_best_model.bin" in os.listdir(
                os.path.join(trained_models_root_path, d)))
        args_files = sorted(f for f in files_of_cached_data_args
                            if split in os.path.basename(f))
        args_by_fold = {_fold_token(os.path.basename(f)): f
                        for f in args_files}
        fold_stats = {}
        for pos, run_dir in enumerate(run_dirs):
            fold = _fold_token(os.path.basename(run_dir))
            data_args = args_by_fold.get(fold)
            if data_args is None:
                if len(args_files) == 1:
                    data_args = args_files[0]
                else:
                    print(f"evaluate_system_level_cv: skipping {run_dir}: "
                          f"no data args for fold {fold}", flush=True)
                    continue
            true_gcs = _true_graphs_from_args(data_args, model_type)
            model, params = load_model_for_eval(run_dir, device=device)[:2]
            X = None if X_by_split is None else X_by_split.get(split)
            est_gcs = get_model_gc_estimates(model, params, model_type,
                                             len(true_gcs), X=X)
            # token-less run dirs get a position-derived string key so they
            # can never collide with a real fold's integer key; duplicate
            # fold tokens (e.g. a rerun directory) keep both results under
            # disambiguated keys instead of silently overwriting
            key = fold if fold is not None else f"pos_{pos}"
            if key in fold_stats:
                print(f"evaluate_system_level_cv: duplicate run for fold "
                      f"{key!r} ({run_dir}); keeping both", flush=True)
                key = f"{key}_pos{pos}"
            fold_stats[key] = evaluate_fold_system_level(est_gcs, true_gcs,
                                                         **options)
        agg = _aggregate_folds(fold_stats)
        results[split] = agg
        with open(os.path.join(save_dir,
                               f"{split}_system_level_eval_summary.pkl"),
                  "wb") as f:
            pickle.dump(agg, f)
    return results


def evaluate_system_level_gs(model_type, trained_models_root_path,
                             true_gc_factors, save_dir, X=None, device=None,
                             **options):
    """The grid-search driver (ref :1692+): score every completed run under
    a grid root against ONE dataset's true factor graphs, so selection
    criteria can be compared against realized GC quality.  Writes
    ``<save_dir>/gs_system_level_eval_summary.pkl``; returns
    {run_name: {"normal": ..., "transposed": ...}}. ``device`` is where
    each run's model is loaded and read out (default ``cuda``)."""
    os.makedirs(save_dir, exist_ok=True)
    results = {}
    for d in sorted(os.listdir(trained_models_root_path)):
        run_dir = os.path.join(trained_models_root_path, d)
        if not (os.path.isdir(run_dir)
                and "final_best_model.bin" in os.listdir(run_dir)):
            continue
        model, params = load_model_for_eval(run_dir, device=device)[:2]
        est_gcs = get_model_gc_estimates(model, params, model_type,
                                         len(true_gc_factors), X=X)
        results[d] = evaluate_fold_system_level(est_gcs, true_gc_factors,
                                                **options)
    with open(os.path.join(save_dir, "gs_system_level_eval_summary.pkl"),
              "wb") as f:
        pickle.dump(results, f)
    return results
