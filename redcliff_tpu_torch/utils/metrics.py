"""Graph-comparison metrics (a copy of the part of the JAX package's
``utils/metrics.py`` that the trainer and the evaluation layer use;
numpy/scipy on the host).

The reference metric suite (the reference's ``general_utils/metrics.py``)
for scoring Granger-causal graph estimates against ground truth:

- optimal-threshold F1 via precision-recall scan   (ref metrics.py:11)
- fixed-threshold F1                               (ref metrics.py:33)
- confusion rates / sensitivity / specificity / LR (ref metrics.py:43-71)
- DeltaCon0 + directed-degree variant              (ref metrics.py:162,191)
- Deltaffinity / path-length MSE                   (ref metrics.py:218,235)
- Hungarian graph matching                         (ref metrics.py:274)
- cosine similarity / MSE / fixed-edge F1          (ref metrics.py:321-430)
- pairwise cosine sims / L1-norm difference         (ref metrics.py:372-393)
- the numpy acyclicity score                       (ref metrics.py:433-443)
- connected components of a graph                  (ref metrics.py:303-319)

The training path (``train/tracking.py``, ``utils/misc.py``), the
evaluation layer (``eval/``) and the synthetic graph factory
(``data/synthetic.py``) read them; the differentiable counterparts
used inside training losses are in ``ops/losses.py``.
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import null_space
from scipy.optimize import linear_sum_assignment

__all__ = [
    "precision_recall_curve",
    "compute_optimal_f1",
    "compute_f1",
    "roc_auc",
    "confusion_counts",
    "compute_sensitivity",
    "compute_specificity",
    "compute_positive_likelihood_ratio",
    "compute_negative_likelihood_ratio",
    "matsusita_distance",
    "deltacon0",
    "deltacon0_with_directed_degrees",
    "deltaffinity",
    "path_length_mse",
    "solve_linear_sum_assignment_between_graph_options",
    "compute_cosine_similarity",
    "pairwise_cosine_similarities",
    "compute_mse",
    "l1_norm_difference",
    "get_f1_score",
    "dagness_penalty",
    "get_symmetric_graph_laplacian",
    "get_number_of_connected_components",
]


# ---------------------------------------------------------------------------
# Threshold-scan classification metrics
# ---------------------------------------------------------------------------

def precision_recall_curve(labels: np.ndarray, scores: np.ndarray):
    """Precision/recall at every distinct score threshold (descending-score scan).

    Matches sklearn.metrics.precision_recall_curve semantics (which the reference
    relies on at metrics.py:18): thresholds are the distinct predicted scores; a
    sample is predicted positive when score >= threshold. Returns (precision,
    recall, thresholds) with the conventional trailing (1, 0) point appended.
    """
    labels = np.asarray(labels).ravel().astype(np.float64)
    scores = np.asarray(scores).ravel().astype(np.float64)
    order = np.argsort(-scores, kind="mergesort")
    labels = labels[order]
    scores = scores[order]
    # indices where the score changes (last occurrence of each distinct value)
    distinct = np.where(np.diff(scores))[0]
    threshold_idx = np.r_[distinct, labels.size - 1]
    tp = np.cumsum(labels)[threshold_idx]
    fp = (1 + threshold_idx) - tp
    total_pos = labels.sum()
    precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1e-300), 0.0)
    recall = tp / total_pos if total_pos > 0 else np.ones_like(tp)
    thresholds = scores[threshold_idx]
    # reverse so recall is decreasing, then append the conventional (1, 0) endpoint
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    thresholds = thresholds[::-1]
    return precision, recall, thresholds


def compute_optimal_f1(labels, pred_logits):
    """Best-F1 threshold scan over the precision-recall curve (ref metrics.py:11-30)."""
    precision, recall, thresholds = precision_recall_curve(labels, pred_logits)
    precision = precision[:-1]
    recall = recall[:-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = (2.0 * precision * recall) / (precision + recall)
    f1 = np.where(np.isfinite(f1), f1, 0.0)
    opt_threshold = thresholds[int(np.argmax(f1))]
    opt_f1 = float(np.max(f1))
    assert np.isfinite(opt_f1)
    return float(opt_threshold), opt_f1


def compute_f1(labels, pred_logits, pred_cutoff):
    """F1 at a fixed cutoff: positive iff score > cutoff (ref metrics.py:33-41)."""
    labels = np.asarray(labels).ravel()
    preds = (np.asarray(pred_logits).ravel() > pred_cutoff).astype(np.int64)
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    denom = 2 * tp + fp + fn
    return 0.0 if denom == 0 else 2 * tp / denom


def roc_auc(labels, scores):
    """ROC-AUC via the rank-statistic (Mann-Whitney) formulation with tie handling.

    Equivalent to sklearn.metrics.roc_auc_score used throughout the reference
    (e.g. general_utils/model_utils.py:54-67).
    """
    labels = np.asarray(labels).ravel().astype(np.float64)
    scores = np.asarray(scores).ravel().astype(np.float64)
    n_pos = labels.sum()
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc undefined with a single class present")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(scores.size, dtype=np.float64)
    sorted_scores = scores[order]
    # average ranks for ties
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[labels == 1].sum()
    return float((rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def confusion_counts(labels, preds, pred_cutoff=None):
    """(tp, tn, fp, fn) counts; thresholds preds if a cutoff is given (ref metrics.py:43-48)."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    if pred_cutoff is not None:
        preds = (preds > pred_cutoff).astype(np.int64)
    tp = int(np.sum((preds == 1) & (labels == 1)))
    tn = int(np.sum((preds == 0) & (labels == 0)))
    fp = int(np.sum((preds == 1) & (labels == 0)))
    fn = int(np.sum((preds == 0) & (labels == 1)))
    return tp, tn, fp, fn


def compute_sensitivity(labels, preds, pred_cutoff=None):
    tp, _, _, fn = confusion_counts(labels, preds, pred_cutoff)
    return tp / (tp + fn)


def compute_specificity(labels, preds, pred_cutoff=None):
    _, tn, fp, _ = confusion_counts(labels, preds, pred_cutoff)
    return tn / (tn + fp)


def compute_positive_likelihood_ratio(labels, preds, pred_cutoff=None):
    sens = compute_sensitivity(labels, preds, pred_cutoff)
    spec = compute_specificity(labels, preds, pred_cutoff)
    return sens / (1.0 - spec)


def compute_negative_likelihood_ratio(labels, preds, pred_cutoff=None):
    sens = compute_sensitivity(labels, preds, pred_cutoff)
    spec = compute_specificity(labels, preds, pred_cutoff)
    return (1.0 - sens) / spec


# ---------------------------------------------------------------------------
# DeltaCon0 family (Koutra, CMU-CS-15-126 Alg 7.4) — ref metrics.py:109-269
# ---------------------------------------------------------------------------

def matsusita_distance(S1, S2):
    """sqrt(sum((sqrt(S1)-sqrt(S2))^2)) — eq. 7.3 (ref metrics.py:130-134).

    Deliberate deviation from the reference: affinity matrices from signed
    (negative-valued) graph estimates produce negative entries, where the
    reference silently emits NaN; we clamp entries at zero before the sqrt
    so the distance stays finite (negative affinity ~ zero similarity mass).
    """
    S1 = np.maximum(np.asarray(S1, dtype=np.float64), 0.0)
    S2 = np.maximum(np.asarray(S2, dtype=np.float64), 0.0)
    return float(np.sqrt(np.sum((np.sqrt(S1) - np.sqrt(S2)) ** 2.0)))


def _node_affinity(I, D, A, eps):
    return np.linalg.inv(I + (eps**2.0) * D - eps * A)


def deltacon0(A1, A2, eps, make_graphs_undirected=False):
    """DeltaCon0 similarity 1/(1+d) between adjacency matrices (ref metrics.py:162-189).

    In-degree is taken as the column sum (axis=0 row-sum of the transpose), matching
    the reference's choice for directed Granger graphs.
    """
    G1 = np.array(A1, dtype=np.float64, copy=True)
    G2 = np.array(A2, dtype=np.float64, copy=True)
    assert G1.shape == G2.shape and G1.ndim == 2 and G1.shape[0] == G1.shape[1]
    if make_graphs_undirected:
        G1 = np.maximum(G1, G1.T)
        G2 = np.maximum(G2, G2.T)
    n = G1.shape[0]
    I = np.eye(n)
    S1 = _node_affinity(I, np.diag(G1.sum(axis=0)), G1, eps)
    S2 = _node_affinity(I, np.diag(G2.sum(axis=0)), G2, eps)
    return 1.0 / (1.0 + matsusita_distance(S1, S2))


def deltacon0_with_directed_degrees(A1, A2, eps, in_degree_coeff=1.0, out_degree_coeff=1.0):
    """Directed DeltaCon0: averages matsusita distances over in- and out-degree
    affinity matrices (ref metrics.py:191-216)."""
    A1 = np.asarray(A1, dtype=np.float64)
    A2 = np.asarray(A2, dtype=np.float64)
    assert A1.shape == A2.shape and A1.ndim == 2 and A1.shape[0] == A1.shape[1]
    n = A1.shape[0]
    I = np.eye(n)
    d_in = matsusita_distance(
        _node_affinity(I, np.diag(A1.sum(axis=0)), A1, eps),
        _node_affinity(I, np.diag(A2.sum(axis=0)), A2, eps),
    )
    d_out = matsusita_distance(
        _node_affinity(I, np.diag(A1.sum(axis=1)), A1, eps),
        _node_affinity(I, np.diag(A2.sum(axis=1)), A2, eps),
    )
    d = (in_degree_coeff * d_in + out_degree_coeff * d_out) / 2.0
    return 1.0 / (1.0 + d)


def _affinity_no_echo(A, eps, max_path_length):
    n = A.shape[0]
    S = np.eye(n)
    Ak = np.eye(n)
    for k in range(1, max_path_length + 1):
        Ak = Ak @ A
        S = S + (eps**k) * Ak
    return S


def deltaffinity(A1, A2, eps, max_path_length=None):
    """DeltaCon without degree attenuation: power-series affinity (ref metrics.py:218-233)."""
    A1 = np.asarray(A1, dtype=np.float64)
    A2 = np.asarray(A2, dtype=np.float64)
    assert A1.shape == A2.shape and A1.ndim == 2 and A1.shape[0] == A1.shape[1]
    n = A1.shape[0]
    if max_path_length is None:
        max_path_length = n - 1
    assert 0 < max_path_length < n
    S1 = _affinity_no_echo(A1, eps, max_path_length)
    S2 = _affinity_no_echo(A2, eps, max_path_length)
    return 1.0 / (1.0 + matsusita_distance(S1, S2))


def path_length_mse(A1, A2, max_path_length=None):
    """Per-path-length MSE between A^k powers; returns (sum, per-k list)
    (ref metrics.py:235-251)."""
    A1 = np.asarray(A1, dtype=np.float64)
    A2 = np.asarray(A2, dtype=np.float64)
    assert A1.shape == A2.shape and A1.ndim == 2 and A1.shape[0] == A1.shape[1]
    n = A1.shape[0]
    if max_path_length is None:
        max_path_length = n - 1
    mses = []
    P1 = np.eye(n)
    P2 = np.eye(n)
    for _ in range(max_path_length):
        P1 = P1 @ A1
        P2 = P2 @ A2
        mses.append(float(((P1 - P2) ** 2.0).mean()))
    return float(sum(mses)), mses


# ---------------------------------------------------------------------------
# Matching / graph structure helpers
# ---------------------------------------------------------------------------

def solve_linear_sum_assignment_between_graph_options(
    graph_estimates, true_graphs, cost_criteria="CosineSimilarity", inf_approximation=1e10
):
    """Hungarian matching of estimated graphs to ground-truth graphs using cosine
    similarity as cost (ref metrics.py:274-301). Note: the reference minimizes
    cosine similarity (scipy's default), matching that exactly."""
    if cost_criteria != "CosineSimilarity":
        raise NotImplementedError(cost_criteria)
    n_w, n_j = len(graph_estimates), len(true_graphs)
    cost = np.zeros((n_w, n_j))
    for w in range(n_w):
        for j in range(n_j):
            cost[w, j] = compute_cosine_similarity(graph_estimates[w], true_graphs[j])
    finite = np.isfinite(cost)
    cost[~finite] = 0.0
    cost = cost + inf_approximation * (1 - finite)
    return linear_sum_assignment(cost)


# ---------------------------------------------------------------------------
# Cosine similarity / elementwise comparisons
# ---------------------------------------------------------------------------

def compute_cosine_similarity(A, B, epsilon=1e-8):
    """Flattened cosine similarity with epsilon-floored norms (ref metrics.py:321-339)."""
    A = np.asarray(A, dtype=np.float64).ravel()
    B = np.asarray(B, dtype=np.float64).ravel()
    a_norm = np.linalg.norm(A)
    b_norm = np.linalg.norm(B)
    if not np.isfinite(a_norm):
        a_norm = -1.0
    if not np.isfinite(b_norm):
        b_norm = -1.0
    return float(A @ B / (max(a_norm, epsilon) * max(b_norm, epsilon)))


def pairwise_cosine_similarities(tensors, include_diag=True):
    """Upper-triangle pairwise cosine sims within a set of same-shape arrays
    (ref metrics.py:372-381). With include_diag=False, identity is subtracted
    from each (per lag slice for 3-D inputs) before comparison. A copy of
    ``redcliff_tpu/utils/metrics.py:328 pairwise_cosine_similarities``."""
    if len(tensors) <= 1:
        return None
    prepped = []
    for T in tensors:
        T = np.asarray(T, dtype=np.float64)
        if not include_diag:
            if T.ndim == 2:
                T = T - np.eye(T.shape[0])
            elif T.ndim == 3:
                T = T - np.eye(T.shape[0])[:, :, None]
            else:
                raise NotImplementedError(T.shape)
        prepped.append(T.ravel())
    sims = []
    for i in range(len(prepped)):
        for j in range(i + 1, len(prepped)):
            a, b = prepped[i], prepped[j]
            denom = max(np.linalg.norm(a), 1e-8) * max(np.linalg.norm(b), 1e-8)
            sims.append(float(a @ b / denom))
    return np.asarray(sims)


def compute_mse(A, B):
    return float(((np.asarray(A) - np.asarray(B)) ** 2).mean())


def l1_norm_difference(A_hat, A):
    """|  ||A_hat||_1 - ||A||_1 | over flattened entries (ref metrics.py:387-393).
    A copy of ``redcliff_tpu/utils/metrics.py:358 l1_norm_difference``."""
    return float(abs(np.abs(np.asarray(A_hat)).sum() - np.abs(np.asarray(A)).sum()))


def get_f1_score(A_hat, A):
    """F1 treating strictly-positive entries as predicted/true edges (ref metrics.py:396-430)."""
    A_hat = np.asarray(A_hat)
    A = np.asarray(A)
    pos_pred = A_hat > 0.0
    pos_label = A > 0.0
    tp = float(np.sum(pos_pred & pos_label))
    fp = float(np.sum(pos_pred & ~pos_label))
    fn = float(np.sum(~pos_pred & pos_label))
    precision = tp / (tp + fp) if (tp + fp) > 0 else np.nan
    recall = tp / (tp + fn) if (tp + fn) > 0 else np.nan
    if not np.isfinite(precision) or not np.isfinite(recall) or (precision + recall) == 0.0:
        return 0.0
    return float(2.0 * precision * recall / (precision + recall))


def dagness_penalty(W0):
    """(tr(exp(W∘W)) - N)^2 acyclicity score (ref metrics.py:433-443).

    Matches the reference's literal computation: elementwise exp of the squared
    weights, so the trace reduces to sum_i exp(W_ii^2). Host/numpy version, a
    copy of ``redcliff_tpu/utils/metrics.py:379 dagness_penalty``; the
    differentiable torch version lives in ``redcliff_tpu_torch.ops.losses``.
    """
    W0 = np.asarray(W0, dtype=np.float64)
    if W0.ndim == 3 and W0.shape[2] == 1:
        W0 = W0[:, :, 0]
    assert W0.ndim == 2 and W0.shape[0] == W0.shape[1]
    n = W0.shape[0]
    return float((np.trace(np.exp(W0 * W0)) - n) ** 2.0)


# ---------------------------------------------------------------------------
# Connectivity (the synthetic graph factory's constraint)
# ---------------------------------------------------------------------------

def get_symmetric_graph_laplacian(A):
    symm = A + A.T
    return np.diag(symm.sum(axis=1)) - symm


def get_number_of_connected_components(A, add_self_connections=True):
    """Nullity of the symmetrized Laplacian (ref metrics.py:303-319)."""
    A = np.asarray(A, dtype=np.float64)
    if add_self_connections:
        A = A + np.eye(A.shape[0])
    L = get_symmetric_graph_laplacian(A)
    return null_space(L).shape[1]
