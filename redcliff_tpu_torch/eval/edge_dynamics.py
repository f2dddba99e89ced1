"""Edge-dynamics statistics (a copy of the JAX package's
``eval/edge_dynamics.py``; numpy/scipy on the host): the
dynamics-evaluation family of the reference's ``evaluate/eval_utils.py``:

  - compute_edgeLockPerformanceV4_stats_betw_two_gc_graphs   (ref :43-105)
  - compute_edgeLockPerformanceV3_stats_betw_two_gc_graphs   (ref :108-170)
  - compute_edgeRankPerformanceV2_stats_betw_two_gc_graphs   (ref :173-275)
  - compute_edgeRankPerformance_stats_betw_two_gc_graphs     (ref :278-406, "V1")
  - compute_smoothed_edge_crossEdgeRank_covariance_stats     (ref :409-471)
  - compute_smoothed_edge_rank_covariance_stats              (ref :474-514)
  - compute_key_edge_covariance_stats                        (ref :517-547)
  - compute_key_covariance_stats (score histories)           (ref :550-565)
  - compute_key_edge_correlation_stats                       (ref :568-606)
  - compute_key_spearman/pearson_correlation_stats (scores)  (ref :609-640)
  - compute_key_stats_betw_two_gc_score_vecs                 (ref :643-653)

These score how well an estimated dynamic graph (a history of (C, C) adjacency
snapshots, one per time window) locks onto the true graph's edge dynamics —
the statistics behind the paper's edge-dynamics analyses.

Implementation is fully vectorized: histories are (T, C, C) arrays, smoothing
is one sliding-mean over the time axis, ranking is one `rankdata(axis=...)`,
and the per-edge Pearson/Spearman statistics are computed for every edge in a
single pass — replacing the reference's O(C^2 * T * W) nested Python loops.
Output dict keys and filtering semantics match the reference exactly
(per-edge keys "i<-j", float aggregation keys on the true average smooth rank,
"smoothWindow{w}_avg_edge_rank_cov" summaries).

DOCUMENTED DIVERGENCE — the reference's
`compute_spearman_numerator_cov_of_ranked_variables` (ref
general_utils/metrics.py:88-94) computes the rank transforms of its inputs and
then DISCARDS them, returning the plain covariance of the raw inputs; every
"rank_cov" the reference reports is therefore just a covariance. This build
implements the documented intent (covariance of the rank-transformed
histories, i.e. the Spearman-correlation numerator). Pass
``match_reference_bug=True`` to any rank-covariance entry point to reproduce
the reference's actual (buggy) numbers.
"""
from __future__ import annotations

import numpy as np
from scipy.stats import rankdata
from scipy.stats import t as _student_t

from redcliff_tpu_torch.utils.metrics import roc_auc

__all__ = [
    "stack_history",
    "smooth_history",
    "dense_rank_per_window",
    "vector_pearson",
    "vector_spearman",
    "covariance",
    "spearman_numerator_cov",
    "compute_edge_lock_performance_v4_stats",
    "compute_edge_lock_performance_v3_stats",
    "compute_edge_rank_performance_v2_stats",
    "compute_edge_rank_performance_v1_stats",
    "compute_smoothed_edge_cross_edge_rank_covariance_stats",
    "compute_smoothed_edge_rank_covariance_stats",
    "compute_key_edge_covariance_stats",
    "compute_key_covariance_stats_betw_two_score_histories",
    "compute_key_edge_correlation_stats",
    "compute_key_spearman_correlation_stats_betw_two_score_histories",
    "compute_key_correlation_stats_betw_two_score_histories",
    "compute_key_stats_betw_two_gc_score_vecs",
    "evaluate_dynamic_graph_estimates",
]


# ---------------------------------------------------------------------------
# primitives


def stack_history(hist):
    """A history (list of (C, C) arrays, or an already-stacked (T, C, C)
    array) as a float64 (T, C, C) ndarray."""
    if isinstance(hist, np.ndarray) and hist.ndim == 3:
        return np.asarray(hist, dtype=np.float64)
    return np.stack([np.asarray(A, dtype=np.float64) for A in hist], axis=0)


def smooth_history(hist, window):
    """Sliding-mean smoothing with the reference's exact window convention:
    output[t] = mean(hist[t : t + window]) for t in 0..T-window-1, i.e. the
    smoothed history has length T - window even for window == 1
    (ref eval_utils.py:68-78)."""
    hist = stack_history(hist)
    T = hist.shape[0]
    if T - window < 1:
        raise ValueError(
            f"history of length {T} too short for smoothing window {window}")
    cs = np.concatenate([np.zeros((1,) + hist.shape[1:]), np.cumsum(hist, axis=0)])
    return (cs[window:T] - cs[: T - window]) / window


def dense_rank_per_window(hist, method="dense"):
    """Rank all C*C entries of each window's matrix jointly (the reference's
    convert_variable_to_rank_variable applied per window, ref metrics.py:72)."""
    hist = np.asarray(hist, dtype=np.float64)
    W = hist.shape[0]
    flat = hist.reshape(W, -1)
    return rankdata(flat, method=method, axis=1).reshape(hist.shape)


def _pearson_with_p(num, sx2, sy2, n):
    """Shared tail of the vectorized correlation statistics: r from the
    centered cross/auto sums plus scipy.linregress's two-sided t-test p-value."""
    den = np.sqrt(sx2 * sy2)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(den > 0, num / np.where(den > 0, den, 1.0), np.nan)
    r = np.clip(r, -1.0, 1.0)
    df = n - 2
    if df <= 0:
        return r, np.full_like(r, np.nan)
    with np.errstate(divide="ignore", invalid="ignore"):
        tstat = r * np.sqrt(df / ((1.0 - r) * (1.0 + r)))
    p = 2.0 * _student_t.sf(np.abs(tstat), df)
    p = np.where(np.isfinite(tstat), p, 0.0)  # |r| == 1 -> p = 0, as scipy
    p = np.where(np.isnan(r), np.nan, p)
    return r, p


def vector_pearson(x, y, axis=0):
    """Pearson r and two-sided p for every lane of x/y along ``axis``,
    matching scipy.stats.linregress's (r, p) on each lane
    (the reference's per-edge linregress call, ref eval_utils.py:98)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[axis]
    xm = x - x.mean(axis=axis, keepdims=True)
    ym = y - y.mean(axis=axis, keepdims=True)
    return _pearson_with_p((xm * ym).sum(axis),
                           (xm ** 2).sum(axis), (ym ** 2).sum(axis), n)


def vector_spearman(x, y, axis=0):
    """Spearman rho and two-sided p for every lane along ``axis``: Pearson on
    average-method ranks with the t-distribution p-value, matching
    scipy.stats.spearmanr per lane (ref eval_utils.py:358)."""
    rx = rankdata(np.asarray(x, dtype=np.float64), axis=axis)
    ry = rankdata(np.asarray(y, dtype=np.float64), axis=axis)
    return vector_pearson(rx, ry, axis=axis)


def covariance(x, y, axis=0):
    """Sample covariance (ddof=1) per lane — np.cov(X, Y)[0, 1] vectorized
    (ref metrics.py:79-86)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[axis]
    xm = x - x.mean(axis=axis, keepdims=True)
    ym = y - y.mean(axis=axis, keepdims=True)
    return (xm * ym).sum(axis) / (n - 1)


def spearman_numerator_cov(x, y, axis=0, match_reference_bug=False):
    """Covariance of the rank-transformed lanes (Spearman numerator).

    The reference's version (ref metrics.py:88-94) ranks its inputs and then
    returns the covariance of the UN-ranked inputs; set
    ``match_reference_bug=True`` to reproduce that behavior."""
    if match_reference_bug:
        return covariance(x, y, axis=axis)
    rx = rankdata(np.asarray(x, dtype=np.float64), axis=axis)
    ry = rankdata(np.asarray(y, dtype=np.float64), axis=axis)
    return covariance(rx, ry, axis=axis)


def _prep(est_A_hist, true_A_hist):
    est = stack_history(est_A_hist)
    true = stack_history(true_A_hist)
    if est.shape != true.shape:
        raise ValueError(
            f"estimated {est.shape} and true {true.shape} histories differ")
    if est.ndim != 3 or est.shape[1] != est.shape[2]:
        raise ValueError(f"expected (T, C, C) histories, got {est.shape}")
    return est, true


def _paradigm_stat(paradigm, x, y):
    """(W, E) lanes -> per-edge stat dicts for one stat_paradigm."""
    if paradigm == "PearsonCorrelation":
        r, p = vector_pearson(x, y, axis=0)
        return [{"pearson_r": r[e], "pearson_p": p[e]} for e in range(x.shape[1])]
    if paradigm == "SpearmanCorrelation":
        r, p = vector_spearman(x, y, axis=0)
        return [{"spearman_r": r[e], "spearman_p": p[e]} for e in range(x.shape[1])]
    raise NotImplementedError(f"stat_paradigm {paradigm!r}")


# ---------------------------------------------------------------------------
# edgeLock family (smoothed-activation tracking)


def _edge_lock_stats(stat_paradigm, est_A_hist, true_A_hist,
                     smoothing_window_size, filter_inactive):
    est, true = _prep(est_A_hist, true_A_hist)
    C = est.shape[1]
    s_est = smooth_history(est, smoothing_window_size).reshape(-1, C * C)
    s_true = smooth_history(true, smoothing_window_size).reshape(-1, C * C)
    if stat_paradigm != "PearsonCorrelation":
        raise NotImplementedError(f"stat_paradigm {stat_paradigm!r}")
    stats = _paradigm_stat(stat_paradigm, s_est, s_true)
    stat_key = stat_paradigm + "_curr_paradigm_smooth_activ_hist_stat"

    if filter_inactive:
        true_ranks = dense_rank_per_window(
            s_true.reshape(-1, C, C)).reshape(-1, C * C)
        avg_true_rank = true_ranks.mean(axis=0)

    key_stats = {}
    for i in range(C):
        for j in range(C):
            e = i * C + j
            if filter_inactive and not (avg_true_rank[e] > 1.0 and i != j):
                continue  # no true activation (rank==1) or self-edge (ref :156)
            key_stats[f"{i}<-{j}"] = {stat_key: stats[e]}
    return key_stats


def compute_edge_lock_performance_v4_stats(stat_paradigm, est_A_hist,
                                           true_A_hist,
                                           smoothing_window_size=1):
    """Per-edge correlation between smoothed estimated and true edge-activation
    histories, for EVERY edge (ref compute_edgeLockPerformanceV4, :43-105)."""
    return _edge_lock_stats(stat_paradigm, est_A_hist, true_A_hist,
                            smoothing_window_size, filter_inactive=False)


def compute_edge_lock_performance_v3_stats(stat_paradigm, est_A_hist,
                                           true_A_hist,
                                           smoothing_window_size=1):
    """V4 restricted to truly-active off-diagonal edges (true average dense
    rank > 1; ref compute_edgeLockPerformanceV3, :108-170)."""
    return _edge_lock_stats(stat_paradigm, est_A_hist, true_A_hist,
                            smoothing_window_size, filter_inactive=True)


# ---------------------------------------------------------------------------
# edgeRank family (smoothed-rank tracking)


def _append_by_rank(key_stats, rank_key, entry):
    """The reference's secondary aggregation: per-edge stats also accumulate
    in lists keyed by the edge's true average smooth rank (a float key —
    ref eval_utils.py:262-273)."""
    if rank_key not in key_stats:
        key_stats[rank_key] = {k: [v] for k, v in entry.items()}
    else:
        for k, v in entry.items():
            key_stats[rank_key][k].append(v)


def compute_edge_rank_performance_v2_stats(stat_paradigm, est_A_hist,
                                           true_A_hist,
                                           smoothing_window_size=1):
    """Rank/activation MSE + correlation between smoothed est/true histories
    for truly-active off-diagonal edges, with per-edge AND per-true-rank
    aggregation (ref compute_edgeRankPerformanceV2, :173-275)."""
    est, true = _prep(est_A_hist, true_A_hist)
    C = est.shape[1]
    s_est = smooth_history(est, smoothing_window_size)
    s_true = smooth_history(true, smoothing_window_size)
    r_est = dense_rank_per_window(s_est).reshape(-1, C * C)
    r_true = dense_rank_per_window(s_true).reshape(-1, C * C)
    s_est = s_est.reshape(-1, C * C)
    s_true = s_true.reshape(-1, C * C)

    avg_true_rank = r_true.mean(axis=0)
    rank_mse = ((r_est - r_true) ** 2).mean(axis=0)
    activ_mse = ((s_est - s_true) ** 2).mean(axis=0)
    ranked_stats = _paradigm_stat(stat_paradigm, r_est, r_true)
    activ_stats = _paradigm_stat(stat_paradigm, s_est, s_true)
    rkey = stat_paradigm + "_curr_paradigm_ranked_smooth_hist_stat"
    akey = stat_paradigm + "_curr_paradigm_smooth_activ_hist_stat"

    key_stats = {}
    for i in range(C):
        for j in range(C):
            e = i * C + j
            if not (avg_true_rank[e] > 1.0 and i != j):
                continue
            entry = {
                "smooth_rank_MSE_across_windows": rank_mse[e],
                "smooth_activ_MSE_across_windows": activ_mse[e],
                rkey: ranked_stats[e],
                akey: activ_stats[e],
            }
            key_stats[f"{i}<-{j}"] = entry
            _append_by_rank(key_stats, avg_true_rank[e], entry)
    return key_stats


def compute_edge_rank_performance_v1_stats(stat_paradigm, est_A_hist,
                                           true_A_hist,
                                           smoothing_window_size=1):
    """Signed rank/activation deviation statistics + paradigm correlation
    (Pearson / Spearman / ROC_AUC) between smoothed est/true histories for
    truly-active off-diagonal edges (ref compute_edgeRankPerformance_stats,
    :278-406)."""
    est, true = _prep(est_A_hist, true_A_hist)
    C = est.shape[1]
    s_est = smooth_history(est, smoothing_window_size)
    s_true = smooth_history(true, smoothing_window_size)
    r_est = dense_rank_per_window(s_est).reshape(-1, C * C)
    r_true = dense_rank_per_window(s_true).reshape(-1, C * C)
    s_est = s_est.reshape(-1, C * C)
    s_true = s_true.reshape(-1, C * C)

    avg_true_rank = r_true.mean(axis=0)
    rank_diffs = r_est - r_true
    activ_diffs = s_est - s_true

    if stat_paradigm == "ROC_AUC":
        ranked_stats, activ_stats = None, None
    else:
        ranked_stats = _paradigm_stat(stat_paradigm, r_est, r_true)
        activ_stats = _paradigm_stat(stat_paradigm, s_est, s_true)
    rkey = stat_paradigm + "_curr_paradigm_ranked_smooth_hist_stat"
    akey = stat_paradigm + "_curr_paradigm_smooth_activ_hist_stat"

    key_stats = {}
    for i in range(C):
        for j in range(C):
            e = i * C + j
            if not (avg_true_rank[e] > 1.0 and i != j):
                continue
            if stat_paradigm == "ROC_AUC":
                # ref: roc_auc_score(true_ranks, est_ranks) in try/except ->
                # None unless the true ranks are binary, in which case sklearn
                # treats the larger rank as the positive class (:360-364);
                # activation stat is always None (:377)
                classes = np.unique(r_true[:, e])
                if classes.size == 2:
                    rstat = roc_auc(r_true[:, e] == classes[1], r_est[:, e])
                else:
                    rstat = None
                astat = None
            else:
                rstat, astat = ranked_stats[e], activ_stats[e]
            entry = {
                "avg_smooth_rank_diff": r_est[:, e].mean() - r_true[:, e].mean(),
                "avg_of_smooth_rank_diffs_across_windows": rank_diffs[:, e].mean(),
                "avg_smooth_activ_diff": s_est[:, e].mean() - s_true[:, e].mean(),
                "avg_of_smooth_activ_diffs_across_windows": activ_diffs[:, e].mean(),
                rkey: rstat,
                akey: astat,
            }
            key_stats[f"{i}<-{j}"] = entry
            _append_by_rank(key_stats, avg_true_rank[e], entry)
    return key_stats


# ---------------------------------------------------------------------------
# covariance / correlation summaries


def compute_smoothed_edge_cross_edge_rank_covariance_stats(
        est_A_hist, true_A_hist, smoothing_window_sizes=(1,),
        match_reference_bug=False):
    """Average per-edge rank-covariance between smoothed histories ranked
    ACROSS the matrix at each window (ref :409-471). One summary per
    smoothing window size."""
    est, true = _prep(est_A_hist, true_A_hist)
    key_stats = {}
    for w in smoothing_window_sizes:
        r_est = dense_rank_per_window(smooth_history(est, w), method="average")
        r_true = dense_rank_per_window(smooth_history(true, w), method="average")
        covs = spearman_numerator_cov(
            r_est.reshape(r_est.shape[0], -1), r_true.reshape(r_true.shape[0], -1),
            match_reference_bug=match_reference_bug)
        key_stats[f"smoothWindow{w}_avg_edge_rank_cov"] = covs.mean()
    return key_stats


def compute_smoothed_edge_rank_covariance_stats(
        est_A_hist, true_A_hist, smoothing_window_sizes=(1,),
        match_reference_bug=False):
    """Average per-edge rank-covariance between smoothed edge histories,
    ranked along each edge's own history (ref :474-514)."""
    est, true = _prep(est_A_hist, true_A_hist)
    key_stats = {}
    for w in smoothing_window_sizes:
        s_est = smooth_history(est, w).reshape(-1, est.shape[1] * est.shape[2])
        s_true = smooth_history(true, w).reshape(s_est.shape)
        covs = spearman_numerator_cov(
            s_est, s_true, match_reference_bug=match_reference_bug)
        key_stats[f"smoothWindow{w}_avg_edge_rank_cov"] = covs.mean()
    return key_stats


def compute_key_edge_covariance_stats(est_A_hist, true_A_hist,
                                      match_reference_bug=False):
    """Average covariance + rank-covariance over all raw edge histories
    (ref :517-547)."""
    est, true = _prep(est_A_hist, true_A_hist)
    E = est.shape[1] * est.shape[2]
    x, y = est.reshape(-1, E), true.reshape(-1, E)
    return {
        "avg_edge_cov": covariance(x, y).mean(),
        "avg_edge_rank_cov": spearman_numerator_cov(
            x, y, match_reference_bug=match_reference_bug).mean(),
    }


def compute_key_covariance_stats_betw_two_score_histories(
        est_h, true_h, match_reference_bug=False):
    """Covariance + rank-covariance between two 1-D score histories
    (ref :550-565)."""
    x = np.asarray(est_h, dtype=np.float64).reshape(-1)
    y = np.asarray(true_h, dtype=np.float64).reshape(-1)
    return {
        "cov": float(covariance(x, y)),
        "rank_cov": float(spearman_numerator_cov(
            x, y, match_reference_bug=match_reference_bug)),
    }


def compute_key_edge_correlation_stats(est_A_hist, true_A_hist):
    """Average Pearson + Spearman statistics over all raw edge histories
    (ref :568-606)."""
    est, true = _prep(est_A_hist, true_A_hist)
    E = est.shape[1] * est.shape[2]
    x, y = est.reshape(-1, E), true.reshape(-1, E)
    pr, pp = vector_pearson(x, y)
    sr, sp = vector_spearman(x, y)
    return {
        "avg_edge_pearson_r": pr.mean(),
        "avg_edge_pearson_p": pp.mean(),
        "avg_edge_spearman_r": sr.mean(),
        "avg_edge_spearman_p": sp.mean(),
    }


def compute_key_spearman_correlation_stats_betw_two_score_histories(est_h, true_h):
    """Spearman rho/p between two 1-D score histories (ref :609-623)."""
    x = np.asarray(est_h, dtype=np.float64).reshape(-1, 1)
    y = np.asarray(true_h, dtype=np.float64).reshape(-1, 1)
    r, p = vector_spearman(x, y)
    return {"sr": float(r[0]), "sp": float(p[0])}


def compute_key_correlation_stats_betw_two_score_histories(est_h, true_h):
    """Pearson r/p between two 1-D score histories (ref :626-640)."""
    x = np.asarray(est_h, dtype=np.float64).reshape(-1, 1)
    y = np.asarray(true_h, dtype=np.float64).reshape(-1, 1)
    r, p = vector_pearson(x, y)
    return {"r": float(r[0]), "p": float(p[0])}


def evaluate_dynamic_graph_estimates(est_A_hist, true_A_hist,
                                     stat_paradigm="PearsonCorrelation",
                                     smoothing_window_sizes=(1, 5, 10),
                                     match_reference_bug=False):
    """One-call bundle of the edge-dynamics family for the cross-algorithm /
    notebook drivers: given an estimated and a true dynamic-graph history,
    returns every dynamics statistic the reference's analysis layer consumes
    (the call pattern of ref eval_utils.py dynamics usage across the ICML
    notebook and eval scripts)."""
    sw = tuple(w for w in smoothing_window_sizes
               if w < stack_history(est_A_hist).shape[0])
    out = {
        "edge_lock_v4": compute_edge_lock_performance_v4_stats(
            stat_paradigm, est_A_hist, true_A_hist,
            smoothing_window_size=sw[0] if sw else 1),
        "edge_lock_v3": compute_edge_lock_performance_v3_stats(
            stat_paradigm, est_A_hist, true_A_hist,
            smoothing_window_size=sw[0] if sw else 1),
        "edge_rank_v2": compute_edge_rank_performance_v2_stats(
            stat_paradigm, est_A_hist, true_A_hist,
            smoothing_window_size=sw[0] if sw else 1),
        "edge_covariance": compute_key_edge_covariance_stats(
            est_A_hist, true_A_hist, match_reference_bug=match_reference_bug),
        "edge_correlation": compute_key_edge_correlation_stats(
            est_A_hist, true_A_hist),
        "smoothed_edge_rank_cov": compute_smoothed_edge_rank_covariance_stats(
            est_A_hist, true_A_hist, smoothing_window_sizes=sw or (1,),
            match_reference_bug=match_reference_bug),
        "smoothed_cross_edge_rank_cov":
            compute_smoothed_edge_cross_edge_rank_covariance_stats(
                est_A_hist, true_A_hist, smoothing_window_sizes=sw or (1,),
                match_reference_bug=match_reference_bug),
    }
    return out


def compute_key_stats_betw_two_gc_score_vecs(est_v, true_v):
    """Cosine similarity + MSE between two score vectors (ref :643-653)."""
    from redcliff_tpu_torch.utils.metrics import (compute_cosine_similarity,
                                                  compute_mse)

    est_v = np.asarray(est_v, dtype=np.float64)
    true_v = np.asarray(true_v, dtype=np.float64)
    return {"cosine_similarity": compute_cosine_similarity(est_v, true_v),
            "mse": compute_mse(est_v, true_v)}
