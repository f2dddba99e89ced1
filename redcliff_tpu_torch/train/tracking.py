"""Host-side per-epoch GC progress tracking (a copy of the JAX package's
``train/tracking.py``; numpy on the host).

Semantics-parity rebuild of the reference's metric trackers
(ref general_utils/model_utils.py:18-209): per-factor F1/ROC-AUC at fixed
thresholds, DeltaCon0-family similarities, normalized L1 norms, and pairwise
cosine similarities, each appended to history lists every epoch. Estimates and
truths are max-normalized before comparison; 3-D (lagged) inputs are lag-summed.

Inputs here are plain numpy: ``true_GC`` is a list of (C, C, L) ground-truth
tensors; ``est_by_sample`` is a list (samples) of lists (factors) of (C, C[, L])
estimate arrays — the same nesting the reference's GC() returns.
"""
from __future__ import annotations

import numpy as np

from redcliff_tpu_torch.utils.metrics import (
    compute_cosine_similarity,
    deltacon0,
    deltacon0_with_directed_degrees,
    deltaffinity,
    get_f1_score,
    path_length_mse,
    roc_auc,
)

__all__ = ["GCProgressTracker"]


def _prep(mat, remove_self_connections):
    mat = np.asarray(mat, dtype=np.float64)
    if mat.ndim == 3:
        mat = mat.sum(axis=2)
    if remove_self_connections:
        mat = mat.copy()
        np.fill_diagonal(mat, 0.0)
    m = np.max(mat)
    if m != 0.0:
        mat = mat / m
    return mat


class GCProgressTracker:
    """Accumulates the reference's per-epoch GC metric histories."""

    def __init__(self, num_supervised_factors, num_chans, num_factors=None,
                 f1_thresholds=(0.0,), deltacon_eps=0.1):
        S = num_supervised_factors
        self.S = S
        self.num_chans = num_chans
        K = num_factors if num_factors is not None else S
        self.K = K
        self.deltacon_eps = deltacon_eps
        self.f1_thresholds = list(f1_thresholds)
        self.f1score_histories = {t: [[] for _ in range(S)] for t in self.f1_thresholds}
        self.f1score_OffDiag_histories = {t: [[] for _ in range(S)] for t in self.f1_thresholds}
        self.roc_auc_histories = {t: [[] for _ in range(S)] for t in self.f1_thresholds}
        self.roc_auc_OffDiag_histories = {t: [[] for _ in range(S)] for t in self.f1_thresholds}
        self.gc_factor_l1_loss_histories = [[] for _ in range(S)]
        self.gc_factor_cosine_sim_histories = {
            f"{i}and{j}": [] for i in range(S) for j in range(S) if i < j
        }
        self.gc_factorUnsupervised_cosine_sim_histories = {
            f"{i}and{j}": [] for i in range(S, K) for j in range(S, K) if i < j
        }
        self.deltacon0_histories = [[] for _ in range(S)]
        self.deltacon0_with_directed_degrees_histories = [[] for _ in range(S)]
        self.deltaffinity_histories = [[] for _ in range(S)]
        self.path_length_mse_histories = {
            p: [[] for _ in range(S)] for p in range(1, num_chans)
        }

    # -- individual trackers (each mirrors one reference function) ----------

    def _roc_stats(self, true_GC, est_by_sample, remove_self):
        """ref model_utils.py:18-88."""
        out_f1 = {t: [] for t in self.f1_thresholds}
        out_auc = {t: [] for t in self.f1_thresholds}
        n_est = min(len(est_by_sample[0]), len(true_GC))
        n_s = len(est_by_sample)
        # normalization/diag-masking is threshold- and sample-invariant: prep once
        truths = [_prep(true_GC[i], remove_self) for i in range(n_est)]
        labels = [t.ravel().astype(int) for t in truths]
        prepped = [[_prep(sample[i], remove_self) for i in range(n_est)]
                   for sample in est_by_sample]
        for thresh in self.f1_thresholds:
            f1_sums = np.zeros(n_est)
            auc_sums = np.zeros(n_est)
            for sample in prepped:
                for i in range(n_est):
                    est = sample[i] * (sample[i] > thresh)
                    f1_sums[i] += get_f1_score(est, truths[i])
                    if labels[i].sum() == 0:
                        auc_sums[i] += 0.5
                    else:
                        auc_sums[i] += roc_auc(labels[i], est.ravel())
            # single shared estimate replicated across supervised slots when the
            # model produces fewer estimates than supervised states
            for i in range(self.S):
                src = 0 if n_est == 1 and self.S > 1 else min(i, n_est - 1)
                out_f1[thresh].append(f1_sums[src] / n_s)
                out_auc[thresh].append(auc_sums[src] / n_s)
        return out_f1, out_auc

    def update(self, true_GC, est_by_sample, est_by_sample_lagsummed=None):
        """Append one epoch of metrics. ``est_by_sample`` carries lagged (C, C, L)
        estimates (used for F1/AUC/deltacon after lag-summing, ref fit loop at
        redcliff_s_cmlp.py:1349-1400); ``est_by_sample_lagsummed`` optionally
        carries the ignore_lag readouts used for the cosine histories.

        ``true_GC=None`` skips the truth-dependent histories (F1/AUC/deltacon
        family) while still tracking the truth-free ones — L1 norms and the
        pairwise cosines the stopping criterion consumes. The reference's fit
        always has ground truth in hand, so its tracking is unconditional
        (ref :1349-1403); this keeps the same criteria semantics on unlabeled
        runs."""
        n_s = len(est_by_sample)
        if true_GC is not None:
            f1, auc = self._roc_stats(true_GC, est_by_sample, remove_self=False)
            f1_od, auc_od = self._roc_stats(true_GC, est_by_sample, remove_self=True)
            for t in self.f1_thresholds:
                for i in range(self.S):
                    self.f1score_histories[t][i].append(f1[t][i])
                    self.roc_auc_histories[t][i].append(auc[t][i])
                    self.f1score_OffDiag_histories[t][i].append(f1_od[t][i])
                    self.roc_auc_OffDiag_histories[t][i].append(auc_od[t][i])

            # deltacon0 family (ref model_utils.py:90-161); note reference
            # argument order: similarity(truth, estimate)
            n_est = min(len(est_by_sample[0]), len(true_GC))
            dc0 = np.zeros(n_est)
            dc0dd = np.zeros(n_est)
            daf = np.zeros(n_est)
            plm = {p: np.zeros(n_est) for p in self.path_length_mse_histories}
            for sample in est_by_sample:
                for i in range(n_est):
                    truth = _prep(true_GC[i], False)
                    est = _prep(sample[i], False)
                    dc0[i] += deltacon0(truth, est, self.deltacon_eps)
                    dc0dd[i] += deltacon0_with_directed_degrees(truth, est, self.deltacon_eps)
                    daf[i] += deltaffinity(truth, est, self.deltacon_eps)
                    _, per_k = path_length_mse(truth, est)
                    for p, mse in zip(range(1, self.num_chans), per_k):
                        plm[p][i] += mse
            for i in range(self.S):
                src = 0 if n_est == 1 and self.S > 1 else min(i, n_est - 1)
                self.deltacon0_histories[i].append(dc0[src] / n_s)
                self.deltacon0_with_directed_degrees_histories[i].append(dc0dd[src] / n_s)
                self.deltaffinity_histories[i].append(daf[src] / n_s)
                for p in plm:
                    self.path_length_mse_histories[p][i].append(plm[p][src] / n_s)

        # normalized L1 norms (ref model_utils.py:163-189)
        K_est = len(est_by_sample[0])
        l1_sums = np.zeros(K_est)
        for sample in est_by_sample:
            for i in range(K_est):
                e = np.asarray(sample[i], dtype=np.float64)
                m = np.max(e)
                if m != 0:
                    e = e / m
                l1_sums[i] += np.abs(e).sum()
        for i in range(self.S):
            self.gc_factor_l1_loss_histories[i].append(l1_sums[min(i, K_est - 1)] / n_s)

        # pairwise cosine similarities (ref model_utils.py:191-209)
        cos_src = est_by_sample_lagsummed if est_by_sample_lagsummed is not None else est_by_sample
        self._track_cosines(
            [[np.asarray(s[i]) for i in range(min(self.S, len(s)))] for s in cos_src],
            self.gc_factor_cosine_sim_histories, label_offset=0,
        )
        self._track_cosines(
            [[np.asarray(s[i]) for i in range(self.S, len(s))] for s in cos_src],
            self.gc_factorUnsupervised_cosine_sim_histories, label_offset=self.S,
        )

    def _track_cosines(self, est_by_sample, histories, label_offset):
        sums = {}
        n_s = 0
        for sample in est_by_sample:
            n_s += 1
            for i in range(len(sample)):
                for j in range(i + 1, len(sample)):
                    # DOCUMENTED DEVIATION from ref model_utils.py:191-209,
                    # which divides by max(np.max(x), 1e-300): when an
                    # estimate is all-non-positive (possible for conditional
                    # GC modes with unrestricted, sign-free embedder
                    # weightings) that floor scales entries by ~1e300 and the
                    # cosine dot product overflows to +-inf — an -inf then
                    # poisons the stopping criterion and auto-wins model
                    # selection. Guard like the grid engine's point_cos
                    # (parallel/grid.py): scale only by a strictly positive
                    # max; cosine's own norm floor keeps the result finite.
                    a = np.asarray(sample[i], dtype=np.float64)
                    b = np.asarray(sample[j], dtype=np.float64)
                    ma, mb = np.max(a), np.max(b)
                    a = a / ma if ma > 0 else a
                    b = b / mb if mb > 0 else b
                    key = f"{i + label_offset}and{j + label_offset}"
                    sums[key] = sums.get(key, 0.0) + compute_cosine_similarity(a, b)
        for key, total in sums.items():
            if key in histories:
                histories[key].append(total / n_s)

    def latest_as_dict(self):
        """Most recent epoch's metrics, flattened for structured logging
        (one key per factor/threshold/pair)."""
        out = {}
        for t in self.f1_thresholds:
            for i in range(self.S):
                if self.f1score_histories[t][i]:
                    out[f"f1_t{t}_factor{i}"] = self.f1score_histories[t][i][-1]
                    out[f"roc_auc_t{t}_factor{i}"] = self.roc_auc_histories[t][i][-1]
                    out[f"f1_offdiag_t{t}_factor{i}"] = self.f1score_OffDiag_histories[t][i][-1]
                    out[f"roc_auc_offdiag_t{t}_factor{i}"] = self.roc_auc_OffDiag_histories[t][i][-1]
        for i in range(self.S):
            if self.deltacon0_histories[i]:
                out[f"deltacon0_factor{i}"] = self.deltacon0_histories[i][-1]
                out[f"deltaffinity_factor{i}"] = self.deltaffinity_histories[i][-1]
            # tracked even without ground truth (unlabeled runs): own gate
            if self.gc_factor_l1_loss_histories[i]:
                out[f"gc_l1_factor{i}"] = self.gc_factor_l1_loss_histories[i][-1]
        for key, h in self.gc_factor_cosine_sim_histories.items():
            if h:
                out[f"cosine_sim_{key}"] = h[-1]
        return out

    def latest_mean_supervised_cosine(self):
        """Mean of the most recent supervised pairwise cosines — the stopping
        criterion component (ref redcliff_s_cmlp.py:1467)."""
        vals = [h[-1] for h in self.gc_factor_cosine_sim_histories.values() if h]
        return float(np.mean(vals)) if vals else 0.0

    def as_dict(self):
        return {
            "f1score_histories": self.f1score_histories,
            "f1score_OffDiag_histories": self.f1score_OffDiag_histories,
            "roc_auc_histories": self.roc_auc_histories,
            "roc_auc_OffDiag_histories": self.roc_auc_OffDiag_histories,
            "gc_factor_l1_loss_histories": self.gc_factor_l1_loss_histories,
            "gc_factor_cosine_sim_histories": self.gc_factor_cosine_sim_histories,
            "gc_factorUnsupervised_cosine_sim_histories": self.gc_factorUnsupervised_cosine_sim_histories,
            "deltacon0_histories": self.deltacon0_histories,
            "deltacon0_with_directed_degrees_histories": self.deltacon0_with_directed_degrees_histories,
            "deltaffinity_histories": self.deltaffinity_histories,
            "path_length_mse_histories": self.path_length_mse_histories,
        }
