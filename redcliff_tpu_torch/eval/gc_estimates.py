"""Per-family Granger-causal estimate dispatch for evaluation (port of
``eval/gc_estimates.py``).

The reference's get_model_gc_estimates / get_model_gc_score_estimates
(its ``evaluate/eval_utils.py:893-948``): every model family exposes its
GC readout differently, and single-graph baselines are replicated K times
so cross-algorithm comparisons always see one estimate per true factor.
The port reads every family of the JAX dispatch: REDCLIFF-S, NCFM, cMLP,
cLSTM, NAVAR, DGCNN, DCSFA-NMF (one graph per NMF component) and DYNOTEARS
(its one host graph, replicated).

Readouts run without autograd on the params' device and come back to the
host once per call (DYNOTEARS has no params: its graph is host numpy).
:func:`get_model_gc_score_estimates` runs ``model.forward``, which launches
the factor-mix kernel on the card, for REDCLIFF; DCSFA-NMF's are its
predicted probabilities.
"""
from __future__ import annotations

import numpy as np
import torch

from redcliff_tpu_torch.eval.model_io import to_params_device

__all__ = ["get_model_gc_estimates", "get_model_gc_score_estimates",
           "get_model_gc_summary_matrices",
           "get_combined_gc_representations_across_factors"]

def _unrecognized(model_type):
    raise NotImplementedError(f"unrecognized model_type: {model_type!r}")


def _np_list(graphs):
    return [g.detach().cpu().numpy() for g in graphs]


def _replicate(graphs, num_required):
    assert len(graphs) == 1, (
        f"expected a single generic estimate, got {len(graphs)}")
    return [graphs[0].copy() for _ in range(num_required)]


def get_model_gc_estimates(model, params, model_type, num_ests_required,
                           X=None):
    """List of ``num_ests_required`` per-factor GC matrices (numpy) for any
    family (ref eval_utils.py:908-948). ``model_type`` uses the
    reference's naming: substring dispatch over REDCLIFF / DCSFA / NCFM /
    DYNOTEARS / NAVAR / DGCNN / cMLP / cLSTM."""
    mt = model_type
    if "DYNOTEARS" in mt:
        return _replicate([np.asarray(model.gc())], num_ests_required)
    if "DCSFA" in mt:
        return list(model.gc(params, threshold=False, ignore_features=True))
    if X is not None:
        X = to_params_device(params, X)
    if "REDCLIFF" in mt:
        mode = model.config.primary_gc_est_mode
        if "conditional" in mode:
            # system-level eval always forces the sample-independent
            # readout (ref eval_sysOptF1...py:172-175 overrides
            # unconditionally)
            mode = "fixed_factor_exclusive"
        with torch.no_grad():
            ests_by_sample = model.gc_as_lists(
                params, gc_est_mode=mode, X=X, threshold=False,
                ignore_lag=False, combine_wavelet_representations=True,
                rank_wavelets=False)
        assert len(ests_by_sample) == 1, (
            "expected a single sample-level estimate for system-level eval")
        gc_ests = list(ests_by_sample[0])
        if len(gc_ests) < num_ests_required:
            gc_ests = _replicate(gc_ests, num_ests_required)
        return gc_ests

    with torch.no_grad():
        if "NCFM" in mt:
            # single-factor forecaster baselines keep their own factor count
            if "CMLP" in mt.upper():
                return _np_list(model.gc(
                    params, threshold=False, ignore_lag=True,
                    combine_wavelet_representations=True,
                    rank_wavelets=False))
            return _np_list(model.gc(params, threshold=False,
                                     combine_wavelet_representations=True,
                                     rank_wavelets=False))
        if "NAVAR" in mt:
            generic = _np_list(model.gc(params, X=X, threshold=False,
                                        ignore_lag=True))
        elif "DGCNN" in mt:
            generic = _np_list(model.gc(params, threshold=False,
                                        combine_wavelet_representations=True))
        elif "cMLP" in mt or "CMLP" in mt:
            generic = _np_list(model.gc(
                params, threshold=False, ignore_lag=True,
                combine_wavelet_representations=True, rank_wavelets=False))
        elif "cLSTM" in mt or "CLSTM" in mt:
            generic = _np_list(model.gc(
                params, threshold=False,
                combine_wavelet_representations=True, rank_wavelets=False))
        else:
            _unrecognized(mt)
    return _replicate(generic, num_ests_required)


def get_model_gc_summary_matrices(model, params, model_type,
                                  num_ests_required, X=None):
    """Per-factor LAG-SUMMED GC matrices ``(C, C)`` on the standard eval
    readout path: the offline counterpart of the live graph summary
    (``obs/quality.py``), whose per-factor matrices and column norms match
    these within 1e-6 with identical top-k edge sets."""
    ests = get_model_gc_estimates(model, params, model_type,
                                  num_ests_required, X=X)
    out = []
    for e in ests:
        e = np.asarray(e, dtype=np.float32)
        out.append(e.sum(axis=2) if e.ndim == 3 else e)
    return out


def get_model_gc_score_estimates(model, params, model_type,
                                 num_ests_required, X=None, state=None):
    """Factor-score estimates (ref eval_utils.py:893-906): a REDCLIFF
    model's first-sim state-label predictions on ``X`` (one window), from
    one ``model.forward`` (the factor-mix kernel on the card); DCSFA-NMF's
    predicted probabilities on ``X`` (one feature row, ``state`` its
    BatchNorm statistics); a flat ones vector for the graph-only
    baselines."""
    mt = model_type
    if "REDCLIFF" in mt:
        with torch.no_grad():
            _, _, _, weights = model.forward(params,
                                             to_params_device(params, X))
        return weights[0].cpu().numpy().reshape(num_ests_required)
    if "DCSFA" in mt:
        scores = model.predict_proba(params, state, X)
        return np.asarray(scores).reshape(num_ests_required)
    if any(tag in mt for tag in ("cMLP", "CMLP", "cLSTM", "CLSTM", "DGCNN",
                                 "DYNOTEARS", "NAVAR")):
        return np.ones(num_ests_required)
    _unrecognized(mt)


def get_combined_gc_representations_across_factors(estimated_gcs, true_gcs):
    """Element-wise sums of the per-factor estimates and truths — the
    "system graph" view used by combined-representation analyses
    (ref eval_utils.py:884-891). Returns (combo_est, combo_true)."""
    combo_true = np.sum([np.asarray(t, dtype=np.float64) for t in true_gcs],
                        axis=0)
    combo_est = np.sum([np.asarray(e, dtype=np.float64)
                        for e in estimated_gcs], axis=0)
    return combo_est, combo_true
