"""Small host-side helpers (a copy of the JAX package's ``utils/misc.py``;
numpy on the host): top-k edge filters, normalization and diagonal
masking, min-max rescaling, Hungarian alignment of unsupervised factor
estimates and of factor indices to supervised labels, the flattening of
lagged GC tensors and of directed-spectrum features, and the sequential
k-fold splits of the DREAM4 curation."""
from __future__ import annotations

import numpy as np

from redcliff_tpu_torch.utils.metrics import (
    compute_cosine_similarity,
    solve_linear_sum_assignment_between_graph_options,
)

__all__ = [
    "apply_top_k_filter_to_edges",
    "normalize_array",
    "mask_diag_elements",
    "place_on_zero_to_one_scale",
    "sort_unsupervised_estimates",
    "factor_alignment_order",
    "get_avg_cosine_similarity_between_combos",
    "get_topk_graph_mask",
    "get_preds_from_masked_normalized_matrix",
    "flatten_gc_with_lags",
    "unflatten_gc_with_lags",
    "flatten_directed_spectrum_features",
    "unflatten_directed_spectrum_features",
    "make_kfolds_cv_splits",
]


def apply_top_k_filter_to_edges(A, k=None):
    """Zero all but the k largest entries (ref misc.py:21-37). A copy of
    ``redcliff_tpu/utils/misc.py:35 apply_top_k_filter_to_edges``."""
    if k is None:
        return A
    A = np.asarray(A)
    flat = A.ravel()
    # k may exceed the entry count; the reference's list slice [-k:] then keeps
    # every entry, so clamp rather than raise
    kth_largest = np.sort(flat)[-min(k, flat.size)]
    return np.where(A >= kth_largest, A, 0.0)


def normalize_array(A):
    """Scale by the max entry (ref misc.py:39-40)."""
    A = np.asarray(A)
    return A / np.max(A)


def mask_diag_elements(A):
    """Zero the diagonal of a square matrix, returning a copy (ref misc.py:42-48)."""
    A = np.array(A, copy=True)
    assert A.ndim == 2 and A.shape[0] == A.shape[1]
    np.fill_diagonal(A, 0.0)
    return A


def place_on_zero_to_one_scale(elements):
    """Min-max rescale a list of scalars (ref misc.py:50-55). A copy of
    ``redcliff_tpu/utils/misc.py:61 place_on_zero_to_one_scale``."""
    lo = np.min(elements)
    hi = np.max(elements)
    return [float((x - lo) / (hi - lo)) for x in elements]


def sort_unsupervised_estimates(
    graph_estimates,
    true_graphs,
    cost_criteria="CosineSimilarity",
    unsupervised_start_index=0,
    return_sorting_inds=False,
):
    """Hungarian-align unsupervised factor estimates to ground-truth graphs
    (ref misc.py:83-91): estimates before unsupervised_start_index keep their
    position; the remainder are permuted to their matched truth slots, with any
    unmatched estimates appended."""
    tail_est = list(graph_estimates[unsupervised_start_index:])
    tail_true = list(true_graphs[unsupervised_start_index:])
    matched_est, matched_true = solve_linear_sum_assignment_between_graph_options(
        tail_est, tail_true, cost_criteria=cost_criteria
    )
    sorted_ests = [None] * len(tail_true)
    for est_ind, gt_ind in zip(matched_est, matched_true):
        sorted_ests[gt_ind] = tail_est[est_ind]
    unsorted = [tail_est[i] for i in range(len(tail_est)) if i not in matched_est]
    result = list(graph_estimates[:unsupervised_start_index]) + sorted_ests + unsorted
    if return_sorting_inds:
        return result, matched_est, matched_true
    return result


def factor_alignment_order(preds, labels, num_factors, unsupervised_start_index=0):
    """Permutation of range(num_factors) aligning factor indices to supervised
    labels via Hungarian assignment on the predicted factor-weighting series
    (ref redcliff_s_cmlp.py:147-202 initialize_factors_with_prior).

    preds: (N, K) factor-weighting predictions; labels: (N, S) label traces.
    Factors before unsupervised_start_index keep their position. The matched-slot
    list is sized by the LABEL count (S may exceed the match count when labels
    carry more columns than factors), so no index can overflow it.
    """
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    usi = unsupervised_start_index
    est_series = [preds[:, i] for i in range(preds.shape[1])]
    true_series = [labels[:, i] for i in range(labels.shape[1])]
    _, matched_est, matched_gt = sort_unsupervised_estimates(
        est_series, true_series, unsupervised_start_index=usi,
        return_sorting_inds=True)
    K = num_factors
    tail = list(range(usi, K))
    order_tail = [None] * (len(true_series) - usi)
    for e, g in zip(matched_est, matched_gt):
        order_tail[g] = tail[e]
    unmatched = [tail[i] for i in range(len(tail)) if i not in list(matched_est)]
    order = list(range(usi)) + [o for o in order_tail if o is not None] + unmatched
    order = order + [k for k in range(K) if k not in order]
    return order[:K]


def get_avg_cosine_similarity_between_combos(elements):
    """Mean pairwise cosine similarity after per-element max-normalization
    (ref misc.py:93-104). A copy of ``redcliff_tpu/utils/misc.py:123
    get_avg_cosine_similarity_between_combos``."""
    total, count = 0.0, 0
    for i in range(len(elements)):
        for j in range(i + 1, len(elements)):
            a = np.asarray(elements[i]) / np.max(elements[i])
            b = np.asarray(elements[j]) / np.max(elements[j])
            total += compute_cosine_similarity(a, b)
            count += 1
    return total / count


def get_topk_graph_mask(A, k, for_no_lag=True):
    """Keep entries >= the k-th largest value; optionally lag-summed first
    (ref misc.py:106-112). A copy of ``redcliff_tpu/utils/misc.py:136
    get_topk_graph_mask``."""
    A = np.asarray(A)
    if for_no_lag:
        A = A.sum(axis=2)
    kth = np.sort(A.ravel())[-k]
    return (A >= kth) * A, kth


def get_preds_from_masked_normalized_matrix(matrix, pred_scale, mask_thresh):
    """Max-normalize, threshold-mask, rescale (ref misc.py:114-122). A copy
    of ``redcliff_tpu/utils/misc.py:146
    get_preds_from_masked_normalized_matrix``."""
    matrix = np.asarray(matrix, dtype=np.float64)
    matrix = matrix / np.max(matrix)
    return pred_scale * matrix * (matrix >= mask_thresh)


def flatten_gc_with_lags(GC):
    """(m, n, L) -> (m, n*L) with lag-major column blocks (ref misc.py:131-138).
    A copy of ``redcliff_tpu/utils/misc.py:153 flatten_gc_with_lags``."""
    GC = np.asarray(GC)
    m, n, L = GC.shape
    return np.transpose(GC, (0, 2, 1)).reshape(m, n * L)


def unflatten_gc_with_lags(GC):
    """(m, m*L) -> (m, m, L) inverse of flatten_gc_with_lags (ref misc.py:140-146).
    A copy of ``redcliff_tpu/utils/misc.py:160 unflatten_gc_with_lags``."""
    GC = np.asarray(GC)
    m = GC.shape[0]
    L = GC.shape[1] // m
    return np.transpose(GC.reshape(m, L, m), (0, 2, 1))


def flatten_directed_spectrum_features(x):
    """(n, n, m) directed-spectrum tensor -> (n, m*(2n-1)) row layout
    (ref misc.py:159-176): for each feature block, row j holds x[j, :, i] followed
    by the off-diagonal column entries x[:j, j, i] and x[j+1:, j, i]."""
    x = np.asarray(x)
    assert x.ndim == 3 and x.shape[0] == x.shape[1]
    n, _, m = x.shape
    x_flat = np.zeros((n, m * (2 * n - 1)), dtype=x.dtype)
    for i in range(m):
        c0 = i * (2 * n - 1)
        for j in range(n):
            x_flat[j, c0 : c0 + n] = x[j, :, i]
            x_flat[j, c0 + n : c0 + n + j] = x[:j, j, i]
            x_flat[j, c0 + n + j : c0 + (2 * n - 1)] = x[j + 1 :, j, i]
    return x_flat


def unflatten_directed_spectrum_features(x_flat, accumulate_shared_entries=False):
    """Inverse of flatten_directed_spectrum_features (ref misc.py:178-195).

    The reference's implementation ACCUMULATES the row and column writes
    (``x[...] = x_flat[...] + x[...]``), so every off-diagonal entry — which
    appears in two nodes' flattened rows — comes out doubled; it is not a
    true inverse. ``accumulate_shared_entries=True`` reproduces that exactly
    (the reference's only call site, the DCSFA GC readout
    ref dcsfa_nmf.py:1305, inherits the doubling); the default keeps the
    exact inverse for feature round-trips.
    """
    x_flat = np.asarray(x_flat)
    assert x_flat.ndim == 2
    n = x_flat.shape[0]
    m = x_flat.shape[1] // (2 * n - 1)
    # float64 output like the reference's np.zeros (also keeps the halving
    # below exact for integer inputs)
    x = np.zeros((n, n, m))
    for i in range(m):
        c0 = i * (2 * n - 1)
        for j in range(n):
            x[j, :, i] += x_flat[j, c0 : c0 + n]
            x[:j, j, i] += x_flat[j, c0 + n : c0 + n + j]
            x[j + 1 :, j, i] += x_flat[j, c0 + n + j : c0 + (2 * n - 1)]
    if not accumulate_shared_entries:
        # halve the doubled off-diagonal entries back to the true inverse
        off = ~np.eye(n, dtype=bool)
        x[off] *= 0.5
    return x


def make_kfolds_cv_splits(data, labels, num_folds=10):
    """Sequential (non-shuffled) k-fold CV splits keyed by fold id
    (ref misc.py:197-220). Each fold maps to {"train": [[x, y], ...],
    "validation": [[x, y], ...]}."""
    assert len(data) == len(labels)
    n = len(data)
    min_val = n // num_folds
    assert min_val > 0
    extra = n % num_folds
    folds = {}
    for fold_id in range(num_folds):
        n_val = min_val + (1 if fold_id < extra else 0)
        start = fold_id * min_val
        val_idx = list(range(start, start + n_val))
        train_idx = [i for i in range(n) if i < start or i >= start + n_val]
        folds[fold_id] = {
            "train": [[data[i], labels[i]] for i in train_idx],
            "validation": [[data[i], labels[i]] for i in val_idx],
        }
    return folds
