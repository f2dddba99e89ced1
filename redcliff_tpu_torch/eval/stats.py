"""Graph-comparison statistics for the evaluation drivers (a copy of the JAX
package's ``eval/stats.py``; numpy on the host).

The stat kernels of the reference's ``evaluate/eval_utils.py``:
  - compute_OptimalF1_stats_betw_two_gc_graphs (:656-679) — the headline
    optimal-threshold-F1 metric with its edge-case gating
  - compute_f1_stats_betw_two_gc_graphs (:681-704) — fixed-cutoff F1s
  - compute_key_stats_betw_two_gc_graphs (:706-747) — ROC-AUC +
    sensitivity/specificity/likelihood-ratio sweeps
plus the three-view (norm / norm-off-diag / transposed) evaluation paradigm
used by every cross-algorithm sysOptF1 script
(ref eval_sysOptF1_crossAlg_d4IC_HSNR_bCgsParsim_REDCSmovNEWcMLP.py:179-202)
and the mean/median/std/SEM aggregation applied across factors and folds
(ref :218-237, :274-299).
"""
from __future__ import annotations

import numpy as np

from redcliff_tpu_torch.utils.metrics import (
    compute_f1,
    compute_negative_likelihood_ratio,
    compute_optimal_f1,
    compute_positive_likelihood_ratio,
    compute_sensitivity,
    compute_specificity,
    deltacon0,
    deltacon0_with_directed_degrees,
    deltaffinity,
    compute_cosine_similarity,
    path_length_mse,
    roc_auc,
)
from redcliff_tpu_torch.utils.misc import mask_diag_elements, normalize_array

__all__ = [
    "compute_optimal_f1_stats",
    "compute_fixed_f1_stats",
    "compute_key_stats",
    "compute_graph_comparison_stats",
    "three_view_optimal_f1_stats",
    "summarize_values",
    "DEFAULT_PRED_CUTOFFS",
]

DEFAULT_PRED_CUTOFFS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def _gate(est_A, true_A, caller):
    """The reference's shared edge-case gating: skip stats when either graph
    is non-finite or homogeneous (ref eval_utils.py:658-671). Returns the
    integer labels when comparable, else None."""
    est_A = np.asarray(est_A, dtype=np.float64)
    true_A = np.asarray(true_A, dtype=np.float64)
    if not np.isfinite(est_A.sum()):
        print(f"{caller}: WARNING - NON-FINITE VALUE ENCOUNTERED IN est_A",
              flush=True)
        return None
    if est_A.min() == est_A.max():
        print(f"{caller}: WARNING - HOMOGENOUS VALUES DETECTED IN est_A",
              flush=True)
        return None
    if not np.isfinite(true_A.sum()):
        print(f"{caller}: WARNING - NON-FINITE VALUE ENCOUNTERED IN true_A",
              flush=True)
        return None
    labels = true_A.ravel().astype(np.int64)
    if labels.min() == labels.max():
        print(f"{caller}: WARNING - HOMOGENOUS VALUES DETECTED IN labels",
              flush=True)
        return None
    return labels


def compute_optimal_f1_stats(est_A, true_A):
    """{"f1", "decision_threshold", "roc_auc"} via a best-F1 threshold scan,
    or {} when the inputs are degenerate (ref :656-679).

    "roc_auc" is an addition beyond the reference's stats dict (whose
    function name promises it but only emits f1 — ref :656): the flattened
    estimate scored against the binarized truth, same convention as the
    in-training tracking (ref model_utils.py:54-67)."""
    labels = _gate(est_A, true_A, "compute_optimal_f1_stats")
    if labels is None:
        return {}
    thresh, f1 = compute_optimal_f1(labels, np.asarray(est_A).ravel())
    # degrade to None rather than propagate, the same convention
    # compute_key_stats applies to its constituent metrics
    try:
        auc = roc_auc(labels, np.asarray(est_A).ravel())
    except Exception:
        auc = None
    return {"f1": f1, "decision_threshold": thresh, "roc_auc": auc}


def compute_fixed_f1_stats(est_A, true_A, pred_cutoffs=DEFAULT_PRED_CUTOFFS):
    """F1 at each fixed cutoff, keyed "f1_pc<cutoff>" (ref :681-704)."""
    labels = _gate(est_A, true_A, "compute_fixed_f1_stats")
    if labels is None:
        return {}
    out = {}
    for pc in pred_cutoffs:
        try:
            out[f"f1_pc{pc}"] = compute_f1(labels, np.asarray(est_A).ravel(),
                                           pc)
        except Exception:
            out[f"f1_pc{pc}"] = None
    return out


def compute_key_stats(est_A, true_A, pred_cutoffs=DEFAULT_PRED_CUTOFFS):
    """ROC-AUC plus sensitivity/specificity/PLR/NLR sweeps (ref :706-747)."""
    labels = _gate(est_A, true_A, "compute_key_stats")
    if labels is None:
        return {}
    preds = np.asarray(est_A, dtype=np.float64).ravel()
    out = {}
    try:
        out["roc_auc"] = roc_auc(labels, preds)
    except Exception:
        out["roc_auc"] = None
    for pc in pred_cutoffs:
        for name, fn in (
            ("sensitivity", compute_sensitivity),
            ("specificity", compute_specificity),
            ("PLR", compute_positive_likelihood_ratio),
            ("NLR", compute_negative_likelihood_ratio),
        ):
            try:
                out[f"{name}_pc{pc}"] = fn(labels, preds, pred_cutoff=pc)
            except Exception:
                out[f"{name}_pc{pc}"] = None
    return out


def compute_graph_comparison_stats(est_A, true_A, dcon0_eps=0.1,
                                   max_mse_path_length=None,
                                   make_graphs_undirected_for_dcon0=False):
    """Structural-similarity battery: DeltaCon0 family, Deltaffinity,
    path-length MSE, cosine similarity (the reference tracks these per epoch
    via general_utils/model_utils.py:90-209 and in eval summaries)."""
    est_A = np.asarray(est_A, dtype=np.float64)
    true_A = np.asarray(true_A, dtype=np.float64)
    out = {}
    try:
        out["deltacon0"] = deltacon0(
            est_A, true_A, dcon0_eps,
            make_graphs_undirected=make_graphs_undirected_for_dcon0)
    except Exception:
        out["deltacon0"] = None
    try:
        out["deltacon0_with_directed_degrees"] = \
            deltacon0_with_directed_degrees(est_A, true_A, dcon0_eps)
    except Exception:
        out["deltacon0_with_directed_degrees"] = None
    try:
        out["deltaffinity"] = deltaffinity(est_A, true_A, dcon0_eps,
                                           max_path_length=max_mse_path_length)
    except Exception:
        out["deltaffinity"] = None
    try:
        out["path_length_mse"] = path_length_mse(
            est_A, true_A, max_path_length=max_mse_path_length)
    except Exception:
        out["path_length_mse"] = None
    try:
        out["cosine_similarity"] = compute_cosine_similarity(est_A, true_A)
    except Exception:
        out["cosine_similarity"] = None
    return out


def three_view_optimal_f1_stats(est_gc, true_gc):
    """The sysOptF1 per-factor stat paradigms (ref :179-202): lag-summed,
    normalized graphs compared as-is, off-diagonal-masked, and with the
    estimate transposed. Returns the reference's paradigm-keyed dict."""
    est_gc = np.asarray(est_gc, dtype=np.float64)
    true_gc = np.asarray(true_gc, dtype=np.float64)
    if est_gc.ndim == 3:
        est_gc = est_gc.sum(axis=2)
    if true_gc.ndim == 3:
        true_gc = true_gc.sum(axis=2)
    off_est = mask_diag_elements(est_gc)
    off_true = mask_diag_elements(true_gc)
    n_est, n_true = normalize_array(est_gc), normalize_array(true_gc)
    n_off_est, n_off_true = normalize_array(off_est), normalize_array(off_true)
    return {
        "key_stats_estGC_norm_vs_trueGC_norm":
            compute_optimal_f1_stats(n_est, n_true),
        "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag":
            compute_optimal_f1_stats(n_off_est, n_off_true),
        "key_stats_estGC_normOffDiagTransposed_vs_trueGC_normOffDiag":
            compute_optimal_f1_stats(n_off_est.T, n_off_true),
    }


def summarize_values(values):
    """vals/mean/median/std/SEM summary of a list of scalars, the aggregation
    applied across factors then folds (ref :218-237)."""
    vals = [v for v in values if v is not None]
    if not vals:
        return {"vals": [], "mean": None, "median": None, "std_dev": None,
                "mean_std_err": None}
    arr = np.asarray(vals, dtype=np.float64)
    return {
        "vals": list(values),
        "mean": float(np.mean(arr)),
        "median": float(np.median(arr)),
        "std_dev": float(np.std(arr)),
        "mean_std_err": float(np.std(arr) / np.sqrt(len(arr))),
    }
