"""Dynamic-readout evaluation: state-score tracking + conditional-GC dynamics
(port of ``eval/dynamic_readout.py``).

The paper's separating claim is not raw static edge prediction (its own D4IC
numbers put every algorithm within ~0.03 of each other on off-diag optimal-F1)
— it is that REDCLIFF-S produces *dynamic* readouts: a per-window factor-score
trace (which state is active now) and a window-conditioned causal graph
(which edges are active now). Static baselines emit one graph for the whole
recording and no state scores, so they structurally cannot track the oracle's
state activations. This module scores exactly that capability, rebuilt from
the reference's analysis surfaces:

* state-score traces vs oracle activations — the notebook's avg-factor-score
  trace panels (the reference's evaluate/eval_utils.py:953-1092) turned into
  numbers: per-factor Pearson correlation of the embedder weighting trace
  against the oracle activation trace, plus dominant-state accuracy;
* conditional-GC edge dynamics — the eval scripts' conditional modes
  (the reference's models/redcliff_s_cmlp.py:477-494) scored per window
  against the time-varying true graph (dominant state's graph at each step),
  via per-window off-diagonal optimal-F1 and per-edge Pearson tracking
  (the edge-dynamics statistic family, ref eval_utils.py:517-606).

Scoring conventions (documented, deliberate):
* the true dynamic graph at step t is the DOMINANT state's lag-normed
  adjacency (states ramp linearly between activations; dominance = argmax of
  the oracle trace, which for OneHot labels is the label itself);
* a static algorithm is scored with its single graph replicated across all
  windows — its per-window optimal-F1 is computed honestly (it can do well
  when factor graphs overlap), while its tracking correlation is 0 by
  definition (a constant trajectory has no covariance with the dynamics);
* supervised REDCLIFF factors are label-aligned by the training contract
  (factor-score loss ties factor k to label k; Hungarian alignment at the
  pretrain->train transition), so no re-alignment is applied at eval time.

On the device (``device``, default ``cuda``): each recording's windows go
to the params' device as one tensor, through one embedder call; the
conditional readout's factor sum, sum_k w[b, k] G_k, is one ``graph_mix``
(the factor-mix kernel on the card) of the (T', K) weightings and the
(K, C, C) factor graphs, never the (T', K, C, C) conditional tensor. The
scores are computed on the host.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from redcliff_tpu_torch.eval.cross_alg import find_run_directory
from redcliff_tpu_torch.eval.gc_estimates import get_model_gc_estimates
from redcliff_tpu_torch.eval.model_io import (load_artifact,
                                              load_model_for_eval,
                                              to_params_device)
from redcliff_tpu_torch.eval.stats import (compute_optimal_f1_stats,
                                           summarize_values)
from redcliff_tpu_torch.ops.factor_mix import graph_mix

__all__ = [
    "lag_normed_graph",
    "true_dynamic_graph_history",
    "score_state_tracking",
    "score_dynamic_graph_tracking",
    "static_graph_history",
    "evaluate_dynamic_readouts_on_fold",
    "run_dynamic_readout_evaluation",
]


def lag_normed_graph(G):
    """(C, C[, L]) -> (C, C) L2 over the lag axis, scaled to max 1 (the
    normalized view the optimal-F1 battery scores, ref misc.py:39-44)."""
    G = np.asarray(G, dtype=np.float64)
    if G.ndim == 3:
        G = np.sqrt(np.sum(G * G, axis=-1))
    m = np.max(np.abs(G))
    return G / m if m > 0 else G


def _score_steps(recording_len, history, label_align="last"):
    """Number of scoreable windows and the label offset. Window i covers
    steps [i, i+history); its label anchor follows ``label_align``:
    "last" (the original convention — the window's final step), or "center"
    (step i + history//2 — for fast-switching systems the window's content
    reflects its middle, not its edge)."""
    num = recording_len - history
    off = history - 1 if label_align != "center" else history // 2
    return num, off


def _dominant_trace(Y, history, label_align):
    """(T',) dominant-state index per scoreable window under the alignment
    convention; "majority" votes over each window's steps (argmax per step,
    then the window's most frequent state)."""
    Y = np.asarray(Y)
    num, off = _score_steps(Y.shape[1], history, label_align)
    if label_align == "majority":
        per_step = np.argmax(Y, axis=0)  # (T,)
        win = np.lib.stride_tricks.sliding_window_view(per_step, history)
        win = win[:num]
        S = Y.shape[0]
        counts = np.stack([(win == s).sum(axis=1) for s in range(S)])
        return np.argmax(counts, axis=0)
    return np.argmax(Y[:, off: off + num], axis=0)


def true_dynamic_graph_history(Y, true_graphs, history, label_align="last"):
    """(T', C, C) truth: at each scoreable step, the dominant state's
    normalized graph. Y is the oracle (S, T) activation trace.

    Returns (hist, dom, valid): windows whose dominant label row has no
    corresponding truth graph (the pooled unsupervised-states row the curation
    appends when num_supervised < num_factors) are marked invalid — their true
    graph is a mixture of unidentified factors, so they cannot be scored."""
    num, _ = _score_steps(np.asarray(Y).shape[1], history, label_align)
    normed = np.stack([lag_normed_graph(g) for g in true_graphs])
    dom = _dominant_trace(Y, history, label_align)  # (T',)
    valid = dom < len(true_graphs)
    return normed[np.minimum(dom, len(true_graphs) - 1)], dom, valid


def _sliding_windows(recording, history):
    recording = np.asarray(recording)
    view = np.lib.stride_tricks.sliding_window_view(
        recording, history, axis=0)  # (T-history+1, C, history)
    num, _ = _score_steps(recording.shape[0], history)
    return np.transpose(view[:num], (0, 2, 1))


def score_state_tracking(weight_trace, Y, history, valid=None,
                         label_align="last"):
    """Embedder state-score tracking vs the oracle trace.

    weight_trace: (K, T') factor weightings per scoreable step;
    Y: (S, T) oracle activations; valid: optional (T',) window mask (windows
    dominated by the pooled unsupervised row have no supervised truth and are
    excluded from BOTH metrics, same rule as the graph-tracking path).
    Returns {state_score_r, dominant_state_acc} (None when unscoreable).
    ("majority" applies window-majority voting to the dominance
    classification; the continuous trace correlates against the CENTER-step
    activations in that mode, since a vote has no continuous analog.)
    """
    Y = np.asarray(Y, dtype=np.float64)
    w = np.asarray(weight_trace, dtype=np.float64)
    num, off = _score_steps(
        Y.shape[1], history,
        "center" if label_align == "majority" else label_align)
    dom_truth = _dominant_trace(Y[: w.shape[0]], history, label_align)
    truth = Y[: w.shape[0], off: off + num]
    w = w[:, :num]
    dom_truth = dom_truth[:num]
    if valid is not None:
        truth = truth[:, valid[:num]]
        w = w[:, valid[:num]]
        dom_truth = dom_truth[valid[:num]]
    if truth.shape[1] == 0:
        return {"state_score_r": None, "dominant_state_acc": None}
    rs = []
    for k in range(truth.shape[0]):
        a, b = w[k], truth[k]
        if np.std(b) <= 0:
            # a constant oracle trace defines no tracking target on this
            # recording — skip it (same convention as the degenerate-window
            # handling on the graph side), rather than scoring it 0 or 1
            continue
        rs.append(float(np.corrcoef(a, b)[0, 1]) if np.std(a) > 0 else 0.0)
    acc = float(np.mean(np.argmax(w, axis=0) == dom_truth))
    return {"state_score_r": float(np.mean(rs)) if rs else None,
            "dominant_state_acc": acc}


def score_dynamic_graph_tracking(est_hist, true_hist):
    """Per-window off-diag optimal-F1 + per-edge Pearson tracking between an
    estimated and the true dynamic graph history (both (T', C, C))."""
    est = np.asarray(est_hist, dtype=np.float64)
    true = np.asarray(true_hist, dtype=np.float64)
    C = est.shape[-1]
    off_mask = ~np.eye(C, dtype=bool)

    f1s = []
    for t in range(est.shape[0]):
        e, g = est[t][off_mask], (true[t][off_mask] > 1e-12).astype(np.float64)
        st = compute_optimal_f1_stats(e, g)
        if st:  # {} when the window's truth is degenerate (all 0 / all 1)
            f1s.append(st["f1"])

    # per-edge tracking: Pearson over time for off-diag edges whose true
    # trajectory varies; constant estimates score 0 (no tracking)
    et = est[:, off_mask]     # (T', E)
    tt = true[:, off_mask]
    varies = np.std(tt, axis=0) > 1e-12
    rs = []
    for j in np.nonzero(varies)[0]:
        if np.std(et[:, j]) > 1e-12:
            rs.append(float(np.corrcoef(et[:, j], tt[:, j])[0, 1]))
        else:
            rs.append(0.0)
    return {"dynamic_optimal_f1": float(np.mean(f1s)) if f1s else None,
            "edge_tracking_r": float(np.mean(rs)) if rs else None,
            "num_tracked_edges": int(varies.sum())}


def static_graph_history(G, num_steps):
    """Replicate a static (C, C[, L]) estimate across all windows."""
    normed = lag_normed_graph(G)
    return np.broadcast_to(normed[None], (num_steps,) + normed.shape)


def _redcliff_conditional_history(model, params, windows, weightings=None):
    """(T', C, C) window-conditioned system-graph estimate: the conditional
    factor mixture (ref conditional_factor_exclusive, :477-494), factor axis
    summed into one active graph per window, each scaled to max |edge| 1.

    ``windows`` is a (T', history, C) tensor on the params' device;
    ``weightings`` the embedder's (T', K) output on them, when the caller
    has it. The sum over k of w[b, k] G_k is one ``graph_mix`` of the
    weightings and the (K, C, C) factor graphs."""
    with torch.no_grad():
        if weightings is None:
            weightings, _ = model._embed(params, windows)
        static_gc = model.factor_gc(params, ignore_lag=True)  # (K, C, C)
        G = graph_mix(weightings.contiguous(), static_gc.contiguous())
    G = G.cpu().numpy()
    m = np.max(np.abs(G), axis=(1, 2), keepdims=True)
    return G / np.where(m > 0, m, 1.0)


def default_history(run_dir, alg_name, true_graphs):
    """The per-algorithm window convention: REDCLIFF's embedder window
    (embed_lag — its conditional readout needs full windows), a static
    algorithm's lag depth (its estimate is window-independent). Reads the
    artifact's config only."""
    if alg_name.startswith("REDCLIFF"):
        return int(load_artifact(run_dir)["config"].embed_lag)
    return max(int(np.asarray(true_graphs[0]).shape[-1]), 2)


def evaluate_dynamic_readouts_on_fold(run_dir, alg_name, true_graphs, samples,
                                      num_supervised_factors,
                                      max_recordings=16, history=None,
                                      label_align="last", device=None):
    """Score one trained run's dynamic readouts over validation recordings.

    samples: sequence of (x (T, C), y (S, T)) oracle-labeled recordings.
    Returns per-recording metric lists, aggregated by the caller.

    history: scoring window length; None = the per-algorithm default.
    For REDCLIFF it cannot be smaller than embed_lag (the embedder consumes
    full windows). label_align picks the window's label anchor ("last",
    "center", "majority") — fast-switching systems blur under "last".
    device: where the model is loaded and read out (default ``cuda``).
    """
    # a DCSFA-NMF artifact loads as (model, params, state); the readout
    # needs the first two, as in the JAX package
    model, params = load_model_for_eval(run_dir, device=device)[:2]
    is_redcliff = alg_name.startswith("REDCLIFF")
    if history is None:
        history = default_history(run_dir, alg_name, true_graphs)
    if is_redcliff:
        assert history >= int(model.config.embed_lag), (
            "REDCLIFF readout windows cannot be narrower than embed_lag")

    static_est = None
    if not is_redcliff:
        # X for the data-dependent readouts (NAVAR contribution statistics)
        X = np.stack([np.asarray(x) for x, _ in samples[:max_recordings]])
        ests = get_model_gc_estimates(model, params, alg_name,
                                      len(true_graphs), X=X)
        # a static algorithm's best shot at a time-varying truth is the union
        # of its per-component graphs (families with one graph replicate it,
        # so the max is a no-op; DCSFA emits one graph per NMF component and
        # scoring only component 0 would bias by arbitrary ordering)
        static_est = np.max([lag_normed_graph(g) for g in ests], axis=0)

    metrics = {"state_score_r": [], "dominant_state_acc": [],
               "dynamic_optimal_f1": [], "edge_tracking_r": []}
    for x, y in samples[:max_recordings]:
        x = np.asarray(x)
        y = np.asarray(y)
        true_hist, _, valid = true_dynamic_graph_history(
            y, true_graphs, history, label_align=label_align)
        num_steps = true_hist.shape[0]
        if is_redcliff:
            windows = _sliding_windows(x, history)
            # a common scoring grid wider than the embedder window trims each
            # window to embed_lag steps, preserving the label anchor's
            # RELATIVE position (last-anchor -> trailing slice, center-anchor
            # -> centered slice) so the model observes the span the truth is
            # anchored in
            el = int(model.config.embed_lag)
            if windows.shape[1] > el:
                # the trim anchor must use the SAME offset mapping as
                # score_state_tracking: "majority" has no continuous analog,
                # so its continuous truth is anchored at the window CENTER —
                # a trailing-slice trim there would score the model on a span
                # the truth is not anchored in
                _, off = _score_steps(
                    x.shape[0], history,
                    "center" if label_align == "majority" else label_align)
                rel = (off % history) / max(history - 1, 1)
                start = int(round(rel * (history - el)))
                windows = windows[:, start: start + el, :]
            windows = to_params_device(params, windows)
            with torch.no_grad():
                weightings, _ = model._embed(params, windows)
            w = weightings[:, :num_supervised_factors].T.cpu().numpy()
            st = score_state_tracking(w, y, history, valid=valid,
                                      label_align=label_align)
            if st["state_score_r"] is not None:
                metrics["state_score_r"].append(st["state_score_r"])
            if st["dominant_state_acc"] is not None:
                metrics["dominant_state_acc"].append(st["dominant_state_acc"])
            est_hist = _redcliff_conditional_history(model, params, windows,
                                                     weightings)
        else:
            est_hist = static_graph_history(static_est, num_steps)
        if not valid.all():
            if not valid.any():
                continue
            est_hist, true_hist = est_hist[valid], true_hist[valid]
        gt = score_dynamic_graph_tracking(est_hist, true_hist)
        if gt["dynamic_optimal_f1"] is not None:
            metrics["dynamic_optimal_f1"].append(gt["dynamic_optimal_f1"])
        if gt["edge_tracking_r"] is not None:
            metrics["edge_tracking_r"].append(gt["edge_tracking_r"])
    return metrics


def run_dynamic_readout_evaluation(roots, data_args_by_fold, true_by_fold,
                                   num_folds, num_supervised_factors,
                                   save_root, max_recordings=16,
                                   cv_dset_name="data",
                                   common_window_grid=False,
                                   label_align="last", device=None):
    """Dynamic-readout comparison across all trained algorithms and folds.

    roots: {alg_alias: trained-models root}; the run directory per fold is
    located by the same folder-name convention as the static cross-alg eval.
    Returns {alg: {metric: {mean, sem, n}}} and writes it to
    ``save_root/dynamic_readout_summary.json``.

    common_window_grid=True scores every algorithm over the SAME window
    count and label offsets (the max of the per-algorithm window defaults)
    so the cross-algorithm table compares like windows; False keeps the
    per-algorithm conventions, recorded in the emitted summary either way.
    device: where each run's model is loaded and read out (default
    ``cuda``).
    """
    import json

    from redcliff_tpu_torch.data.shards import load_normalized_samples

    os.makedirs(save_root, exist_ok=True)
    # one shard load per fold, shared by every algorithm (the validation split
    # is hundreds of recordings; reloading it per (alg, fold) would dominate
    # wall-clock on a single core); recordings arrive z-scored like training
    samples_by_fold = {}
    for fold in range(num_folds):
        ds = load_normalized_samples(os.path.join(
            os.path.dirname(data_args_by_fold[fold]), "validation"))
        samples_by_fold[fold] = list(zip(ds.X, ds.Y))
    hist_by_alg = {
        alg: default_history(find_run_directory(alg_root, cv_dset_name, 0),
                             alg, true_by_fold[0])
        for alg, alg_root in roots.items()}
    common = max(hist_by_alg.values()) if common_window_grid else None
    out = {}
    for alg, alg_root in roots.items():
        per_alg = {}
        for fold in range(num_folds):
            samples = samples_by_fold[fold]
            run_dir = find_run_directory(alg_root, cv_dset_name, fold)
            m = evaluate_dynamic_readouts_on_fold(
                run_dir, alg, true_by_fold[fold], samples,
                num_supervised_factors, max_recordings=max_recordings,
                history=common, label_align=label_align, device=device)
            for key, vals in m.items():
                per_alg.setdefault(key, []).extend(vals)
        out[alg] = {}
        for key, vals in per_alg.items():
            if not vals:
                out[alg][key] = None
                continue
            s = summarize_values(vals)
            out[alg][key] = {"mean": s["mean"], "sem": s["mean_std_err"],
                             "n": len(vals)}
        out[alg]["scoring_window"] = (common if common is not None
                                      else hist_by_alg[alg])
    out["_conventions"] = {
        "common_window_grid": bool(common_window_grid),
        "label_align": label_align,
        "window_by_algorithm_default": hist_by_alg,
        "common_window": common,
    }
    with open(os.path.join(save_root, "dynamic_readout_summary.json"),
              "w") as f:
        json.dump(out, f, indent=2)
    return out
