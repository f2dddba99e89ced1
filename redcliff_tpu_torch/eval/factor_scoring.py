"""Factor-score sweeps across recordings (port of ``eval/factor_scoring.py``).

The reference's obtain_factor_score_weightings/classifications_across_recording
(its general_utils/misc.py:57-82) and
evaluate_avg_factor_scoring_across_recordings (its
evaluate/eval_utils.py:953-1092): slide the trained embedder across a
recording to trace per-state factor scores, average the traces per dominant
state, and plot them against the label traces.

The reference loops one embedder call per timestep; here all sliding windows
go to the params' device as ONE tensor and through one ``model._embed``
call, and the traces come back to the host once.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from redcliff_tpu_torch.eval.model_io import to_params_device

__all__ = [
    "factor_score_sweep",
    "average_factor_scoring_by_state",
    "evaluate_avg_factor_scoring_across_recordings",
]


def _sliding_windows(recording, history, num_steps):
    """(T, C) -> (num_steps, history, C) windows ending at steps
    history..history+num_steps-1 (a strided view, no copies)."""
    recording = np.asarray(recording)
    view = np.lib.stride_tricks.sliding_window_view(
        recording, history, axis=0)          # (T-history+1, C, history)
    return np.transpose(view[:num_steps], (0, 2, 1))


def factor_score_sweep_both(model, params, recording,
                            num_supervised_factors, num_timesteps_to_score,
                            num_timesteps_in_input_history):
    """(weightings, classifications) traces, each
    (num_supervised_factors, num_timesteps_to_score), from ONE batched
    embedder pass over all sliding windows (ref misc.py:57-82 loops one
    embedder call per step and once per trace kind)."""
    recording = np.asarray(recording)
    if recording.ndim == 3:
        assert recording.shape[0] == 1
        recording = recording[0]
    assert recording.shape[0] >= (num_timesteps_to_score
                                  + num_timesteps_in_input_history)
    windows = _sliding_windows(recording, num_timesteps_in_input_history,
                               num_timesteps_to_score)
    with torch.no_grad():
        weightings, class_preds = model._embed(
            params, to_params_device(params, windows))
        K = weightings.shape[1]
        both = weightings if class_preds is None \
            else torch.cat([weightings, class_preds], dim=1)
    both = both.cpu().numpy()
    w = both[:, :num_supervised_factors].T
    c = w if class_preds is None \
        else both[:, K:K + num_supervised_factors].T
    return w, c


def factor_score_sweep(model, params, recording, num_supervised_factors,
                       num_timesteps_to_score, num_timesteps_in_input_history,
                       kind="weightings"):
    """(num_supervised_factors, num_timesteps_to_score) trace of embedder
    outputs across a recording (ref misc.py:57-82).

    kind: "weightings" (factor mixture weights) or "classifications"
    (supervised class logits/predictions).
    """
    w, c = factor_score_sweep_both(model, params, recording,
                                   num_supervised_factors,
                                   num_timesteps_to_score,
                                   num_timesteps_in_input_history)
    return w if kind == "weightings" else c


def _dominant_state(Y):
    """Window-level dominant state from a label array: (S, T) traces use the
    per-step argmax mode, flat labels the argmax (ref eval_utils.py:991-1011
    label-shape branches)."""
    Y = np.asarray(Y)
    while Y.ndim > 2 and Y.shape[-1] == 1:
        Y = Y[..., 0]
    if Y.ndim == 2 and Y.shape[1] > 1:
        per_step = np.argmax(Y, axis=0)
        vals, counts = np.unique(per_step, return_counts=True)
        return int(vals[np.argmax(counts)])
    return int(np.argmax(Y))


def average_factor_scoring_by_state(model, params, dataset, num_states,
                                    num_timesteps_to_score,
                                    num_timesteps_in_input_history,
                                    max_recordings_per_state=100):
    """{state: {"weightings": (K, T') mean trace, "classifications": ...,
    "count": n}} averaged over recordings whose dominant label is the state
    (ref eval_utils.py:953-1092 without the plotting side effects)."""
    sums = {s: {"weightings": None, "classifications": None, "count": 0}
            for s in range(num_states)}
    for idx in range(len(dataset.X)):
        x = dataset.X[idx]
        y = dataset.Y[idx]
        state = _dominant_state(y)
        if state >= num_states:
            continue
        if sums[state]["count"] >= max_recordings_per_state:
            continue
        w, c = factor_score_sweep_both(model, params, x, num_states,
                                       num_timesteps_to_score,
                                       num_timesteps_in_input_history)
        slot = sums[state]
        slot["weightings"] = w if slot["weightings"] is None \
            else slot["weightings"] + w
        slot["classifications"] = c if slot["classifications"] is None \
            else slot["classifications"] + c
        slot["count"] += 1
    for s, slot in sums.items():
        if slot["count"]:
            slot["weightings"] = slot["weightings"] / slot["count"]
            slot["classifications"] = slot["classifications"] / slot["count"]
    return sums


def evaluate_avg_factor_scoring_across_recordings(
        model, params, dataset, num_states, num_timesteps_to_score,
        num_timesteps_in_input_history, save_root_path, labels=None,
        max_recordings_per_state=100):
    """Average the factor-score traces per state and plot one figure per
    state (the reference's HC/OF/TS trace panels)."""
    summary = average_factor_scoring_by_state(
        model, params, dataset, num_states, num_timesteps_to_score,
        num_timesteps_in_input_history,
        max_recordings_per_state=max_recordings_per_state)
    # without matplotlib (the card's machine): the summary only
    try:
        from redcliff_tpu_torch.utils.plotting import plot_state_score_traces
    except ImportError:
        return summary
    os.makedirs(save_root_path, exist_ok=True)
    for s, slot in summary.items():
        if slot["count"] == 0:
            continue
        name = labels[s] if labels else f"state {s}"
        plot_state_score_traces(
            slot["weightings"],
            os.path.join(save_root_path,
                         f"avg_factor_weightings_state_{s}.png"),
            labels=labels, title=f"mean factor weightings | dominant {name}")
    return summary
