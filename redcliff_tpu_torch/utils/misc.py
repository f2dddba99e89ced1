"""Small host-side helpers (a copy of the part of the JAX package's
``utils/misc.py`` that the trainer and the evaluation layer use; numpy on
the host): normalization and diagonal masking, Hungarian alignment of
unsupervised factor estimates and of factor indices to supervised
labels."""
from __future__ import annotations

import numpy as np

from redcliff_tpu_torch.utils.metrics import (
    compute_cosine_similarity,
    solve_linear_sum_assignment_between_graph_options,
)

__all__ = [
    "normalize_array",
    "mask_diag_elements",
    "sort_unsupervised_estimates",
    "factor_alignment_order",
]


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
