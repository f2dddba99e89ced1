"""The model-quality observatory: live Granger-graph readouts during
training (port of ``redcliff_tpu/obs/quality.py``).

:func:`make_summary_fn` builds ``summary(params, X) -> dict`` of small
tensors for one REDCLIFF-S model: the per-factor lag-summed GC matrices,
their column norms, edge energy, the sparsity fraction of the combined
graph, its top-k edge indices and the factor-score entropy of the embedder
weightings on ``X``. The serve engine reads the static per-factor graphs
out of it once at load.

:func:`readout_mode` forces conditional (X-dependent) and raw-embedder
(non-square) modes to ``fixed_factor_exclusive``, as the system-level eval
does, so the summary is a pure function of params.

The host half is the JAX module's numpy code, copied bit for bit:
:func:`summarize_host` (the generic trainer's readout path),
:func:`topk_indices_np` (``lax.top_k``'s tie order), :func:`topk_hash`,
:func:`jaccard`, :func:`average_precision`, :func:`graph_scores` and
:class:`QualityMonitor` — per-original-point-id convergence diagnostics
across check windows (top-k edge-set Jaccard stability, edge-energy
plateau detection with ``plateaued_at_epoch``) and live AUROC/AUPR when
ground-truth graphs are given. The trainers and the grid fold one summary
per check window into one ``quality`` event each.

Zero-cost contract: ``REDCLIFF_QUALITY=0`` disables everything — no
summary is built, no per-window work runs, and fits are bit-identical
either way (the summary only reads params). Knobs, as in JAX:

* ``REDCLIFF_QUALITY`` — 1 (default) on / 0 off;
* ``REDCLIFF_QUALITY_TOPK`` — top-k edge-set size (default 8);
* ``REDCLIFF_QUALITY_PLATEAU_WINDOW`` — consecutive flat check windows
  before a lane counts as plateaued (default 3);
* ``REDCLIFF_QUALITY_PLATEAU_TOL`` — relative edge-energy change below
  which a window counts as flat (default 0.01).
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from redcliff_tpu_torch.utils.metrics import roc_auc

__all__ = ["enabled", "topk_k", "plateau_window", "plateau_tol",
           "readout_mode", "make_summary_fn", "summarize_host",
           "topk_indices_np", "topk_hash", "jaccard", "average_precision",
           "graph_scores", "QualityMonitor",
           "SPARSITY_REL_EPS", "ENV_ENABLE", "ENV_TOPK",
           "ENV_PLATEAU_WINDOW", "ENV_PLATEAU_TOL"]

ENV_ENABLE = "REDCLIFF_QUALITY"
ENV_TOPK = "REDCLIFF_QUALITY_TOPK"
ENV_PLATEAU_WINDOW = "REDCLIFF_QUALITY_PLATEAU_WINDOW"
ENV_PLATEAU_TOL = "REDCLIFF_QUALITY_PLATEAU_TOL"

# combined-graph entries at or below this fraction of the max |edge| count
# as "off" for the sparsity fraction
SPARSITY_REL_EPS = 1e-2


def enabled():
    """Whether the quality observatory is on (``REDCLIFF_QUALITY``,
    default on). Read per fit, so tests/tools can flip it per run."""
    return os.environ.get(ENV_ENABLE, "1") != "0"


def topk_k(default=8):
    try:
        return max(int(os.environ.get(ENV_TOPK, default)), 1)
    except ValueError:
        return default


def plateau_window(default=3):
    try:
        return max(int(os.environ.get(ENV_PLATEAU_WINDOW, default)), 1)
    except ValueError:
        return default


def plateau_tol(default=0.01):
    try:
        return float(os.environ.get(ENV_PLATEAU_TOL, default))
    except ValueError:
        return default


def readout_mode(config):
    """The GC readout mode the summary uses: the primary mode with
    conditional and raw-embedder modes forced to ``fixed_factor_exclusive``."""
    mode = config.primary_gc_est_mode
    if "conditional" in mode or mode == "raw_embedder":
        return "fixed_factor_exclusive"
    return mode


def _topk_stable(flat, k):
    """The k largest entries of a 1-D tensor, ties toward the smaller index
    (``lax.top_k``'s order; ``torch.topk`` does not promise it)."""
    order = torch.sort(flat, descending=True, stable=True).indices[:k]
    return flat[order], order


def make_summary_fn(model, k=None):
    """Build ``summary(params, X) -> dict`` (one model):

    * ``gc`` — per-factor LAG-SUMMED GC matrices ``(K, C, C)``, float32;
    * ``col_norms`` — per-factor column L2 norms ``(K, C)``;
    * ``edge_energy`` — ``sum(gc**2)``;
    * ``sparsity`` — fraction of combined-graph entries with magnitude
      <= :data:`SPARSITY_REL_EPS` x max magnitude;
    * ``topk_idx`` / ``topk_val`` — the k largest-|edge| flat indices of the
      combined (factor-summed) graph;
    * ``entropy`` — mean Shannon entropy (nats) of the normalized first-sim
      factor weightings on ``X``.
    """
    cfg = model.config
    mode = readout_mode(cfg)
    kk = k if k is not None else topk_k()

    def summary(params, X):
        est = model.gc(params, mode, threshold=False, ignore_lag=False,
                       combine_wavelet_representations=True,
                       rank_wavelets=False)
        E = torch.sum(est.reshape((-1,) + tuple(est.shape[-3:])), dim=-1)
        col_norms = torch.linalg.norm(E, dim=-2)
        edge_energy = torch.sum(E * E)
        A = torch.sum(E, dim=0)
        mag = torch.abs(A)
        m = torch.max(mag)
        thr = SPARSITY_REL_EPS * torch.where(m > 0, m, torch.ones_like(m))
        sparsity = torch.mean((mag <= thr).to(torch.float32))
        topk_val, topk_idx = _topk_stable(mag.reshape(-1),
                                          min(kk, mag.numel()))
        w = torch.abs(model.forward(params, X)[2][0])
        p = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
        entropy = torch.mean(-torch.sum(p * torch.log(p + 1e-12), dim=-1))
        return {"gc": E.to(torch.float32), "col_norms": col_norms,
                "edge_energy": edge_energy, "sparsity": sparsity,
                "topk_idx": topk_idx.to(torch.int32),
                "topk_val": topk_val, "entropy": entropy}

    return summary


# ---------------------------------------------------------------------------
# host-side twins (numpy): the generic trainer's readout path and the
# golden-parity test both consume these
# ---------------------------------------------------------------------------

def _lagsum(mat):
    mat = np.asarray(mat, dtype=np.float32)
    return mat.sum(axis=2) if mat.ndim == 3 else mat


def topk_indices_np(A, k):
    """Flat indices of the k largest-|entry| edges, replicating
    ``lax.top_k`` tie order (ties resolve to the smaller index)."""
    flat = np.abs(np.asarray(A)).ravel()
    order = np.argsort(-flat, kind="stable")
    return order[: min(k, flat.size)].astype(np.int64)


def summarize_host(mats, k=None):
    """Numpy twin of :func:`make_summary_fn` for models whose GC readout is
    host-side (the generic trainer's per-family ``model.gc`` lists).
    ``mats``: per-factor ``(C, C[, L])`` arrays. Returns the summary dict
    WITH a leading 1-lane axis (QualityMonitor's input convention);
    ``entropy`` is None (no factor scores on this path)."""
    E = np.stack([_lagsum(m) for m in mats])                     # (K, C, C)
    col_norms = np.linalg.norm(E, axis=-2)
    edge_energy = float(np.sum(E * E))
    A = E.sum(axis=0)
    mag = np.abs(A)
    m = float(mag.max()) if mag.size else 0.0
    thr = SPARSITY_REL_EPS * (m if m > 0 else 1.0)
    sparsity = float(np.mean(mag <= thr))
    idx = topk_indices_np(A, k if k is not None else topk_k())
    return {"gc": E[None], "col_norms": col_norms[None],
            "edge_energy": np.asarray([edge_energy], np.float32),
            "sparsity": np.asarray([sparsity], np.float32),
            "topk_idx": idx[None].astype(np.int32),
            "topk_val": mag.ravel()[idx][None],
            "entropy": None}


def topk_hash(indices):
    """Stable 12-hex-digit hash of a top-k edge SET (order-free: the set is
    sorted before hashing, so hash equality == identical edge sets)."""
    blob = ",".join(str(int(i)) for i in sorted(int(i) for i in indices))
    return hashlib.sha1(blob.encode("ascii")).hexdigest()[:12]


def jaccard(a, b):
    """Jaccard similarity of two edge-index collections (1.0 for two empty
    sets — a degenerate but stable graph is "stable")."""
    sa, sb = set(int(i) for i in a), set(int(i) for i in b)
    union = sa | sb
    if not union:
        return 1.0
    return len(sa & sb) / len(union)


def average_precision(labels, scores):
    """Area under the precision-recall curve (sklearn-style step AP, ties
    grouped). None when no positive labels exist."""
    labels = np.asarray(labels).ravel().astype(bool)
    scores = np.asarray(scores).ravel().astype(np.float64)
    n_pos = int(labels.sum())
    if n_pos == 0 or labels.size == 0:
        return None
    order = np.argsort(-scores, kind="mergesort")
    lab, sc = labels[order], scores[order]
    tp = np.cumsum(lab)
    fp = np.cumsum(~lab)
    prec = tp / (tp + fp)
    rec = tp / n_pos
    distinct = np.r_[sc[1:] != sc[:-1], True]
    prec, rec = prec[distinct], rec[distinct]
    return float(np.sum(np.diff(np.r_[0.0, rec]) * prec))


def _prep_like_tracker(mat):
    """The tracker's comparison prep (train/tracking.py _prep): lag-sum,
    max-normalize. Self-connections kept (remove_self=False convention)."""
    mat = np.asarray(mat, dtype=np.float64)
    if mat.ndim == 3:
        mat = mat.sum(axis=2)
    m = np.max(mat)
    return mat / m if m != 0.0 else mat


def graph_scores(true_gc, est_mats):
    """Mean per-factor (AUROC, AUPR) of lag-summed estimates against the
    true graphs — the live counterpart of the oracle metrics the offline
    eval computes on the ``eval/gc_estimates`` readout. ``est_mats``:
    ``(K, C, C)`` (already lag-summed); ``true_gc``: list of
    ``(C, C[, L])`` truths. Factor i scores against truth i (single-class
    truths contribute the 0.5 / base-rate convention like the tracker)."""
    est = np.asarray(est_mats, dtype=np.float64)
    n = min(est.shape[0], len(true_gc))
    if n == 0:
        return None, None
    aucs, aps = [], []
    for i in range(n):
        truth = _prep_like_tracker(true_gc[i])
        labels = (truth.ravel() > 0).astype(int)
        scores = _prep_like_tracker(est[i]).ravel()
        if labels.sum() == 0 or labels.sum() == labels.size:
            aucs.append(0.5)
            aps.append(float(labels.sum()) / labels.size)
            continue
        aucs.append(roc_auc(labels, scores))
        ap = average_precision(labels, scores)
        aps.append(ap if ap is not None else 0.0)
    return float(np.mean(aucs)), float(np.mean(aps))


# ---------------------------------------------------------------------------
# host-side convergence monitor
# ---------------------------------------------------------------------------

class QualityMonitor:
    """Per-lane convergence diagnostics across check windows.

    State is keyed by ORIGINAL point id (the ``orig_ids`` lane->point map),
    so diagnostics survive lane compaction unchanged. One
    :meth:`update` per check window consumes the gathered device summary
    and returns the ``quality`` event payload; :meth:`snapshot` is the
    rolling JSON-able view the grid engine stamps into
    ``dispatch_stats["quality"]`` and the trainers into ``fit_end``.

    Diagnostics are per-ATTEMPT: a resumed fit restarts the Jaccard /
    plateau history (the durable artifacts — quality events + the
    checkpointed snapshot — carry the prior attempt's story)."""

    def __init__(self, true_gc=None, window=None, tol=None, mode=None):
        self.true_gc = ([np.asarray(g) for g in true_gc]
                        if true_gc is not None and len(true_gc) else None)
        self.window = window if window is not None else plateau_window()
        self.tol = tol if tol is not None else plateau_tol()
        self.mode = mode
        self.windows = 0
        self.plateaued = {}       # pid -> epoch the plateau was confirmed
        self._energy = {}         # pid -> last edge energy
        self._flat = {}           # pid -> consecutive flat windows
        self._topk = {}           # pid -> previous top-k index set
        self._last = {}           # pid -> last per-lane record

    def update(self, epoch, host, orig_ids):
        """Fold one gathered check-window summary. ``host``: numpy arrays
        with a leading lane axis (``gc``/``col_norms``/``edge_energy``/
        ``sparsity``/``topk_idx``/``topk_val``/``entropy``; ``entropy``
        may be None); ``orig_ids``: lane -> original point id (< 0 =
        bucket filler, skipped). Returns the ``quality`` event payload."""
        ids = np.asarray(orig_ids).ravel()
        rows = [(r, int(p)) for r, p in enumerate(ids) if p >= 0]
        ent = host.get("entropy")
        lanes, energy, sparsity, entropy = [], [], [], []
        hashes, jacs, plats = [], [], []
        aurocs, auprs = [], []
        for r, pid in rows:
            e = float(np.asarray(host["edge_energy"]).ravel()[r])
            idx = np.asarray(host["topk_idx"])[r].ravel()
            cur = frozenset(int(i) for i in idx)
            prev = self._topk.get(pid)
            jac = jaccard(cur, prev) if prev is not None else None
            self._topk[pid] = cur
            prev_e = self._energy.get(pid)
            if prev_e is not None:
                rel = abs(e - prev_e) / max(abs(prev_e), 1e-12)
                self._flat[pid] = self._flat.get(pid, 0) + 1 \
                    if rel < self.tol else 0
                if (self._flat[pid] >= self.window
                        and pid not in self.plateaued):
                    self.plateaued[pid] = int(epoch)
            self._energy[pid] = e
            lanes.append(pid)
            energy.append(e)
            sparsity.append(float(np.asarray(host["sparsity"]).ravel()[r]))
            entropy.append(float(np.asarray(ent).ravel()[r])
                           if ent is not None else None)
            hashes.append(topk_hash(cur))
            jacs.append(jac)
            plats.append(self.plateaued.get(pid))
            if self.true_gc is not None:
                auc, ap = graph_scores(self.true_gc,
                                       np.asarray(host["gc"])[r])
                aurocs.append(auc)
                auprs.append(ap)
            self._last[pid] = {
                "edge_energy": e, "sparsity": sparsity[-1],
                "entropy": entropy[-1], "topk_hash": hashes[-1],
                "jaccard": jac,
                "auroc": aurocs[-1] if self.true_gc is not None else None,
                "aupr": auprs[-1] if self.true_gc is not None else None,
            }
        self.windows += 1
        known_j = [j for j in jacs if j is not None]
        known_a = [a for a in aurocs if a is not None]
        known_p = [a for a in auprs if a is not None]
        return {
            "epoch": int(epoch),
            "mode": self.mode,
            "lanes": lanes,
            "topk_k": int(np.asarray(host["topk_idx"]).shape[-1]),
            "edge_energy": energy,
            "sparsity": sparsity,
            "entropy": entropy,
            "topk_hash": hashes,
            "jaccard": jacs,
            "plateaued": plats,
            "auroc": aurocs if self.true_gc is not None else None,
            "aupr": auprs if self.true_gc is not None else None,
            "mean_jaccard": (float(np.mean(known_j)) if known_j else None),
            "mean_auroc": (float(np.mean(known_a)) if known_a else None),
            "mean_aupr": (float(np.mean(known_p)) if known_p else None),
            "plateaued_count": sum(p is not None for p in plats),
        }

    def snapshot(self):
        """Rolling JSON-able view (string point-id keys — the checkpoint /
        fit_end / fleet results consumers round-trip through JSON)."""
        pids = sorted(self._last)
        last = self._last
        has_gt = self.true_gc is not None
        jacs = [last[p]["jaccard"] for p in pids
                if last[p]["jaccard"] is not None]
        aucs = [last[p]["auroc"] for p in pids
                if last[p]["auroc"] is not None]
        aps = [last[p]["aupr"] for p in pids
               if last[p]["aupr"] is not None]
        return {
            "windows": self.windows,
            "mode": self.mode,
            "lanes": len(pids),
            "plateaued_count": len(self.plateaued),
            # per-fit convergence epoch: when the SLOWEST lane plateaued;
            # None while any lane is still moving
            "converged_at_epoch": (max(self.plateaued.values())
                                   if self.plateaued
                                   and len(self.plateaued) == len(pids)
                                   and pids else None),
            "plateaued_at_epoch": {str(p): self.plateaued.get(p)
                                   for p in pids},
            "edge_stability": {str(p): last[p]["jaccard"] for p in pids},
            "topk_hash": {str(p): last[p]["topk_hash"] for p in pids},
            "edge_energy": {str(p): last[p]["edge_energy"] for p in pids},
            "entropy": {str(p): last[p]["entropy"] for p in pids},
            "auroc": ({str(p): last[p]["auroc"] for p in pids}
                      if has_gt else None),
            "aupr": ({str(p): last[p]["aupr"] for p in pids}
                     if has_gt else None),
            "mean_edge_stability": (float(np.mean(jacs)) if jacs else None),
            "mean_auroc": (float(np.mean(aucs)) if aucs else None),
            "mean_aupr": (float(np.mean(aps)) if aps else None),
        }
