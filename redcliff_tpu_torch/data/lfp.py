"""Local-field-potential curation: TST and Social-Preference pipelines (a
copy of ``redcliff_tpu/data/lfp.py``; numpy/scipy on the host).

Rebuilds the reference's data/tst_100HzLP.py and
socialPreference_100HzLP.py: load per-channel .mat LFP recordings, mark MAD
outliers as NaN, Butterworth-filter (+ notch), draw NaN-avoiding random
windows per behavioral epoch, downsample (1 kHz -> 100 Hz by strided
decimation), and shard the windows in the shared pickle layout.  The epochs:
  TST (ref tst_100HzLP.py:147-158): HomeCage = first 300 s, OpenField and
  TailSuspension from the INT_TIME vector [of_start, of_dur, ts_start,
  ts_dur] (seconds); labels one-hot over (HC, OF, TS).
  SocPref (ref socialPreference_100HzLP.py:157-177): windows where the
  per-timestep S_Class / O_Class traces are active for the whole window;
  labels one-hot over (social, object).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import scipy.io as scio

from redcliff_tpu_torch.utils.time_series import (
    DEFAULT_MAD_THRESHOLD,
    HIGHCUT,
    LOW_PASS_CUTOFF,
    LOWCUT,
    ORDER,
    Q,
    draw_timesteps_to_sample_from,
    draw_timesteps_to_sample_from_using_label_reference,
    filter_signal,
    mark_outliers,
)

__all__ = [
    "load_lfp_data_matrix",
    "determine_keys_of_interest",
    "extract_epoch_windows",
    "preprocess_tst_raw_lfps_for_windowed_training",
    "preprocess_socpref_raw_lfps_for_windowed_training",
]


def load_lfp_data_matrix(raw_data_path, raw_file_name, keys_of_interest,
                         num_channels_in_samples, sample_freq=1000,
                         cutoff=LOW_PASS_CUTOFF, lowcut=LOWCUT,
                         highcut=HIGHCUT,
                         mad_threshold=DEFAULT_MAD_THRESHOLD, q=Q, order=ORDER,
                         apply_notch_filters=True, filter_type="lowpass"):
    """(C, T) filtered matrix with outliers NaN-masked
    (ref tst_100HzLP.py:18-64)."""
    raw = scio.loadmat(os.path.join(raw_data_path, raw_file_name))
    raw = {k: raw[k].reshape(-1).astype(float) for k in keys_of_interest}
    raw = mark_outliers(raw, sample_freq, cutoff=cutoff, lowcut=lowcut,
                        highcut=highcut, mad_threshold=mad_threshold,
                        filter_type=filter_type)
    rows = [
        filter_signal(raw[k], sample_freq, cutoff=cutoff, lowcut=lowcut,
                      highcut=highcut, q=q, order=order,
                      apply_notch_filters=apply_notch_filters,
                      filter_type=filter_type).reshape(1, -1)
        for k in keys_of_interest
    ]
    combined = np.vstack(rows)
    assert combined.shape[0] == num_channels_in_samples
    return combined


def determine_keys_of_interest(files_to_process, raw_data_path):
    """Channel keys present in every .mat file (ref tst_100HzLP.py:66-81)."""
    keys = None
    for name in files_to_process:
        raw = scio.loadmat(os.path.join(raw_data_path, name))
        useful = {k for k in raw.keys() if "__" not in k}
        keys = useful if keys is None else (keys & useful)
    return sorted(keys or [])


def extract_epoch_windows(raw_combined, epochs, window_size,
                          num_samples_per_label_type, downsampling_step_size,
                          rng=None, max_num_draws=10):
    """Draw NaN-avoiding windows per epoch from a (C, T) matrix.

    ``epochs``: [(start, stop, one_hot_label)].  Returns {epoch_index:
    [[window (T', C), label], ...]} with windows transposed and strided-
    decimated like the reference (ref tst_100HzLP.py:160-238).
    """
    rng = rng or np.random.default_rng()
    out = {}
    nan_cols = np.flatnonzero(np.isnan(raw_combined).any(axis=0))
    for e_idx, (start, stop, label) in enumerate(epochs):
        start, stop = int(start), int(stop)
        nan_locs = nan_cols[(nan_cols >= start) & (nan_cols < stop)]
        starts = draw_timesteps_to_sample_from(
            start, stop, window_size, num_samples_per_label_type, nan_locs,
            max_num_draws=max_num_draws, rng=rng)
        samples = []
        for s in starts:
            if s is None:
                continue
            win = raw_combined[:, s : s + window_size].T
            if np.isnan(np.sum(win)):
                # residual NaN despite the draw filter: stop collecting from
                # this recording, as the reference does (ref :196-201)
                break
            if downsampling_step_size > 1:
                win = win[::downsampling_step_size, :]
            samples.append([win, np.asarray(label, dtype=np.float64)])
        out[e_idx] = samples
    return out


def _save_subsets(samples, save_path, prefix, max_per_file):
    os.makedirs(save_path, exist_ok=True)
    for counter, i in enumerate(range(0, len(samples), max_per_file)):
        with open(os.path.join(
                save_path,
                f"{prefix}_processed_data_subset_{counter}.pkl"), "wb") as f:
            pickle.dump(samples[i : i + max_per_file], f)


def preprocess_tst_raw_lfps_for_windowed_training(
        lfp_data_path, label_data_path, preprocessed_data_save_path,
        post_processing_sample_freq, num_processed_samples=10000,
        sample_temp_window_size=1000, max_num_samps_per_preprocessed_file=100,
        sample_freq=1000, cutoff=LOW_PASS_CUTOFF, lowcut=LOWCUT,
        highcut=HIGHCUT, mad_threshold=DEFAULT_MAD_THRESHOLD, q=Q, order=ORDER,
        apply_notch_filters=True, filter_type="lowpass", rng=None):
    """Tail-Suspension-Test curation (ref tst_100HzLP.py:83-330): per mouse,
    pair ``*_LFP*.mat`` recordings with ``*_TIME*.mat`` INT_TIME epochs, draw
    windows per (HomeCage, OpenField, TailSuspension), decimate to
    ``post_processing_sample_freq`` and shard per mouse/state."""
    assert sample_freq > post_processing_sample_freq
    step = sample_freq // post_processing_sample_freq
    rng = rng or np.random.default_rng()

    lfp_files = sorted(x for x in os.listdir(lfp_data_path)
                       if "_LFP" in x and x.endswith(".mat"))
    time_files = sorted(x for x in os.listdir(label_data_path)
                        if "_TIME" in x and x.endswith(".mat"))
    mice = sorted({x.split("_")[0] for x in lfp_files})
    num_per_mouse = num_processed_samples // max(len(mice), 1)
    num_per_label = num_per_mouse // 3

    keys = determine_keys_of_interest(lfp_files, lfp_data_path)
    if "TailSuspension" in keys:
        keys.remove("TailSuspension")
    n_chans = len(keys)

    state_names = ("homeCage", "openField", "tailSuspension")
    for mouse in mice:
        m_lfp = [x for x in lfp_files if x.split("_")[0] == mouse]
        m_time = [x for x in time_files if x.split("_")[0] == mouse]
        if len(m_lfp) != len(m_time):
            print(f"preprocess_tst: skipping mouse {mouse}: "
                  f"{len(m_lfp)} LFP vs {len(m_time)} TIME files", flush=True)
            continue
        per_state = {0: [], 1: [], 2: []}
        for lfp_name, time_name in zip(m_lfp, m_time):
            assert lfp_name[:23] == time_name[:23]
            int_time = scio.loadmat(
                os.path.join(label_data_path, time_name))["INT_TIME"]
            int_time = np.asarray(int_time).reshape(-1)
            raw = load_lfp_data_matrix(
                lfp_data_path, lfp_name, keys, n_chans,
                sample_freq=sample_freq, cutoff=cutoff, lowcut=lowcut,
                highcut=highcut, mad_threshold=mad_threshold, q=q,
                order=order, apply_notch_filters=apply_notch_filters,
                filter_type=filter_type)
            epochs = [
                (0, 300 * sample_freq, [1.0, 0.0, 0.0]),
                (int_time[0] * sample_freq,
                 (int_time[0] + int_time[1]) * sample_freq, [0.0, 1.0, 0.0]),
                (int_time[2] * sample_freq,
                 (int_time[2] + int_time[3]) * sample_freq, [0.0, 0.0, 1.0]),
            ]
            wins = extract_epoch_windows(raw, epochs,
                                         sample_temp_window_size,
                                         num_per_label, step, rng=rng)
            for e_idx, samples in wins.items():
                per_state[e_idx].extend(samples)
        for e_idx, name in enumerate(state_names):
            _save_subsets(per_state[e_idx], preprocessed_data_save_path,
                          f"{mouse}_{name}",
                          max_num_samps_per_preprocessed_file)


def preprocess_socpref_raw_lfps_for_windowed_training(
        lfp_data_path, label_data_path, preprocessed_data_save_path,
        post_processing_sample_freq, num_processed_samples=10000,
        sample_temp_window_size=1000, max_num_samps_per_preprocessed_file=100,
        sample_freq=1000, cutoff=LOW_PASS_CUTOFF, lowcut=LOWCUT,
        highcut=HIGHCUT, mad_threshold=DEFAULT_MAD_THRESHOLD, q=Q, order=ORDER,
        apply_notch_filters=True, filter_type="lowpass", rng=None,
        recording_duration_sec=600):
    """Social-Preference curation (ref socialPreference_100HzLP.py:93-340):
    windows where S_Class / O_Class behavior traces stay active; labels
    one-hot (social, object)."""
    assert sample_freq > post_processing_sample_freq
    step = sample_freq // post_processing_sample_freq
    rng = rng or np.random.default_rng()
    rec_steps = recording_duration_sec * sample_freq

    label_files = sorted(x for x in os.listdir(label_data_path)
                         if "_Class" in x and x.endswith(".mat"))
    lfp_files = sorted(
        x for x in os.listdir(lfp_data_path)
        if "_LFP" in x and x.endswith(".mat")
        and any(x[:23] == lf[:23] for lf in label_files))
    mice = sorted({x.split("_")[0] for x in lfp_files})
    num_per_mouse = num_processed_samples // max(len(mice), 1)
    num_per_label = num_per_mouse // 2

    keys = determine_keys_of_interest(lfp_files, lfp_data_path)
    n_chans = len(keys)

    for mouse in mice:
        m_lfp = [x for x in lfp_files if x.split("_")[0] == mouse]
        m_cls = [x for x in label_files
                 if any(x[:23] == lf[:23] for lf in m_lfp)]
        if len(m_lfp) != len(m_cls):
            continue
        soc_samples, obj_samples = [], []
        for lfp_name, cls_name in zip(m_lfp, m_cls):
            assert lfp_name[:23] == cls_name[:23]
            mat = scio.loadmat(os.path.join(label_data_path, cls_name))
            start_step = sample_freq * int(
                np.asarray(mat["StartTime"]).reshape(-1)[0])
            raw = load_lfp_data_matrix(
                lfp_data_path, lfp_name, keys, n_chans,
                sample_freq=sample_freq, cutoff=cutoff, lowcut=lowcut,
                highcut=highcut, mad_threshold=mad_threshold, q=q,
                order=order, apply_notch_filters=apply_notch_filters,
                filter_type=filter_type)
            # shift the recording to the labeled interval so window starts
            # index signal and behavior traces identically
            # (ref socialPreference_100HzLP.py:175-177)
            raw = raw[:, start_step : start_step + rec_steps]
            soc_trace = np.asarray(mat["S_Class"])[0,
                start_step : start_step + rec_steps]
            obj_trace = np.asarray(mat["O_Class"])[0,
                start_step : start_step + rec_steps]
            nan_locs = np.flatnonzero(np.isnan(raw).any(axis=0))
            for trace, label, bucket in (
                    (soc_trace, [1.0, 0.0], soc_samples),
                    (obj_trace, [0.0, 1.0], obj_samples)):
                # per-mouse cap across recordings (ref :207-241)
                remaining = num_per_label - len(bucket)
                if remaining <= 0:
                    continue
                starts = draw_timesteps_to_sample_from_using_label_reference(
                    trace, sample_temp_window_size, remaining, nan_locs,
                    rng=rng)
                for s in starts:
                    if s is None:
                        continue
                    win = raw[:, s : s + sample_temp_window_size].T
                    if np.isnan(np.sum(win)):
                        break
                    if step > 1:
                        win = win[::step, :]
                    bucket.append([win, np.asarray(label)])
        _save_subsets(soc_samples, preprocessed_data_save_path,
                      f"{mouse}_social", max_num_samps_per_preprocessed_file)
        _save_subsets(obj_samples, preprocessed_data_save_path,
                      f"{mouse}_object", max_num_samps_per_preprocessed_file)
