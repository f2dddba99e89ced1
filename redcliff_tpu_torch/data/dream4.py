"""DREAM4 InSilico preprocessing and the D4IC combo benchmark (a copy of
``redcliff_tpu/data/dream4.py``; numpy on the host).

Rebuilds the reference's data/dream4.py and dream4_insilicoCombo.py:
  - parse the original DREAM4 time-series TSVs with their blank-line-separated
    recordings and perturbation halves (parse_orig_DREAM4_time_series_file,
    ref dream4.py:82-166)
  - individual and "singleDominantSuperPositional" preprocessed variants
    (ref dream4.py:168-254)
  - the D4IC benchmark: for each fold/split, superimpose the 5 DREAM4
    networks' signals with a dominant coefficient on one network and a
    background coefficient on the rest; the label is the coefficient vector
    (make_dream4_combo_dataset, ref dream4_insilicoCombo.py:83-151)
SNR tiers come from the background coefficient (ref :256-261): dominant 10.0
with background 0.0 (HSNR), 0.1 (MSNR), 1.0 (LSNR).
"""
from __future__ import annotations

import copy
import os
import pickle

import numpy as np

from redcliff_tpu_torch.data.shards import save_cv_split
from redcliff_tpu_torch.utils.misc import make_kfolds_cv_splits

__all__ = [
    "parse_dream4_timeseries",
    "make_dream4_individual_dataset",
    "make_dream4_single_dominant_superpositional_dataset",
    "make_dream4_combo_dataset",
    "D4IC_SNR_TIERS",
]

POSSIBLE_NUM_CHANNELS = (10, 100)
POSSIBLE_NUM_TIME_POINTS = (21,)

# (dominant_coeff, background_coeff) per SNR tier
# (ref dream4_insilicoCombo.py:256-261: DOMINANT 10.0, BACKGROUND {0,0.1,1})
D4IC_SNR_TIERS = {"HSNR": (10.0, 0.0), "MSNR": (10.0, 0.1),
                  "LSNR": (10.0, 1.0)}


def parse_dream4_timeseries(orig_ts_file, apply_state_perspective=False):
    """Parse an original DREAM4 ``*_timeseries.tsv``.

    Layout (ref dream4.py:82-166): a quoted tab-separated header
    ("Time", gene ids), then recordings of 21 rows separated by blank lines;
    the first column is the measurement time.  With
    ``apply_state_perspective=True`` each recording splits into the
    first-half (perturbation applied, label [1, 0]) and second-half
    (perturbation removed, label [0, 1]) series; otherwise whole recordings
    carry label [1, 0].

    Returns (time_series list of (t, C) arrays, state_labels, meta_data).
    """
    with open(orig_ts_file, "r") as f:
        all_lines = [ln.rstrip("\n") for ln in f]

    header = [x.strip('"') for x in all_lines[0].split("\t")]
    assert header[0] == "Time"
    channel_ids = header[1:]
    num_channels = len(channel_ids)
    assert num_channels in POSSIBLE_NUM_CHANNELS

    recordings, time_points = [], []
    current = []
    first_recording = True
    for line in all_lines[1:]:
        if len(line) == 0:
            if current:
                recordings.append(np.concatenate(current, axis=0))
                first_recording = False
                current = []
            continue
        vals = [float(v) for v in line.split("\t")]
        current.append(np.asarray(vals[1:]).reshape(1, num_channels))
        if first_recording:
            time_points.append(int(vals[0]))
    if current:
        recordings.append(np.concatenate(current, axis=0))

    num_time_points = len(time_points)
    assert num_time_points in POSSIBLE_NUM_TIME_POINTS
    for rec in recordings:
        assert rec.shape == (num_time_points, num_channels)

    time_series, state_labels = [], []
    half = num_time_points // 2
    for rec in recordings:
        if apply_state_perspective:
            # first half: perturbation active; second half: relaxed
            # (ref dream4.py:121-125)
            time_series.append(rec[: half + 1])
            state_labels.append(np.array([1, 0]))
            time_series.append(rec[half + 1 :])
            state_labels.append(np.array([0, 1]))
        else:
            time_series.append(rec)
            state_labels.append(np.array([1, 0]))

    meta_data = {
        "num_channels": num_channels,
        "channel_ids": channel_ids,
        "num_time_points": num_time_points,
        "time_points": time_points,
        "apply_state_perspective": apply_state_perspective,
    }
    return time_series, state_labels, meta_data


def _num_kfolds_for(save_path):
    if "size10_" in save_path:
        return 5
    if "size100_" in save_path:
        return 10
    raise ValueError("Network Size must be stated as 10 or 100 in save_path")


def make_dream4_individual_dataset(orig_data_path, save_path,
                                   state_label_setting):
    """Per-network CV folds in the shared shard layout
    (ref dream4.py:168-189)."""
    num_kfolds = _num_kfolds_for(save_path)
    ts, labels, _ = parse_dream4_timeseries(
        orig_data_path, apply_state_perspective=state_label_setting)
    kfolds = make_kfolds_cv_splits(ts, labels, num_folds=num_kfolds)
    for cv_id in range(num_kfolds):
        save_cv_split(kfolds[cv_id]["train"], kfolds[cv_id]["validation"],
                      cv_id, save_path)


def make_dream4_single_dominant_superpositional_dataset(
        orig_data_path, save_path, state_label_setting,
        dominant_net_coeff=5.0, background_net_coeff=0.1):
    """For each network: scale its recordings by the dominant coefficient and
    add every other network's fold-aligned recordings scaled by the background
    coefficient (ref dream4.py:193-254)."""
    num_kfolds = _num_kfolds_for(save_path)
    network_folders = sorted(os.listdir(orig_data_path))
    kfolds_by_network, meta_data = [], []
    for net_folder in network_folders:
        folder = os.path.join(orig_data_path, net_folder)
        ts_files = [x for x in os.listdir(folder) if "_timeseries.tsv" in x]
        assert len(ts_files) == 1
        ts, labels, meta = parse_dream4_timeseries(
            os.path.join(folder, ts_files[0]),
            apply_state_perspective=state_label_setting)
        kfolds_by_network.append(
            make_kfolds_cv_splits(ts, labels, num_folds=num_kfolds))
        meta_data.append(meta)
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "meta_data.pkl"), "wb") as f:
        pickle.dump(meta_data, f)

    for i, dominant in enumerate(kfolds_by_network):
        net_save = os.path.join(save_path, network_folders[i])
        os.makedirs(net_save, exist_ok=True)
        combined = copy.deepcopy(dominant)
        for cv_id in range(num_kfolds):
            for split in ("train", "validation"):
                for el in combined[cv_id][split]:
                    el[0] = dominant_net_coeff * el[0]
        for j, background in enumerate(kfolds_by_network):
            if i == j:
                continue
            for cv_id in range(num_kfolds):
                for split in ("train", "validation"):
                    for el, bg_el in zip(combined[cv_id][split],
                                         background[cv_id][split]):
                        el[0] = el[0] + background_net_coeff * bg_el[0]
        for cv_id in range(num_kfolds):
            save_cv_split(combined[cv_id]["train"],
                          combined[cv_id]["validation"], cv_id, net_save)


def make_dream4_combo_dataset(orig_data_path, save_path, fold_id, split_name,
                              num_factors, dominant_coeff, background_coeff,
                              shuffle_rng=None):
    """Build one split of the D4IC benchmark
    (ref dream4_insilicoCombo.py:83-151): every factor network takes a turn as
    the dominant signal over sample-aligned background mixtures of the others;
    the label is the (num_factors, 1) coefficient vector."""
    factor_dirs = sorted(
        os.path.join(orig_data_path, x, f"fold_{fold_id}", split_name)
        for x in os.listdir(orig_data_path)
        if os.path.isdir(os.path.join(orig_data_path, x, f"fold_{fold_id}",
                                      split_name)))
    assert len(factor_dirs) == num_factors, (
        f"expected {num_factors} factor networks, found {factor_dirs!r}")

    factor_samples = []
    num_factor_samples = None
    for d in factor_dirs:
        data = []
        for shard in sorted(x for x in os.listdir(d)
                            if "subset" in x and x.endswith(".pkl")):
            with open(os.path.join(d, shard), "rb") as f:
                data.extend(s[0] for s in pickle.load(f))
        factor_samples.append(data)
        if num_factor_samples is None:
            num_factor_samples = len(data)
        assert num_factor_samples == len(data)

    combined = []
    for factor_id in range(num_factors):
        for samp_id in range(num_factor_samples):
            x = dominant_coeff * factor_samples[factor_id][samp_id]
            for bg in range(num_factors):
                if bg != factor_id:
                    x = x + background_coeff * factor_samples[bg][samp_id]
            y = np.full((num_factors, 1), background_coeff, dtype=np.float64)
            y[factor_id] = dominant_coeff
            combined.append([x, y])

    rng = shuffle_rng or np.random.default_rng(5)
    rng.shuffle(combined)

    split_dir = os.path.join(save_path, split_name)
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, "subset_0.pkl"), "wb") as f:
        pickle.dump(combined, f)
    return combined


def make_d4ic_fold(orig_data_path, save_path, fold_id, num_factors=5,
                   snr_tier="HSNR", shuffle_rng=None):
    """Both splits of one D4IC fold at a named SNR tier
    (ref dream4_insilicoCombo.py kick_off_preprocessing_run :156-198)."""
    dominant, background = D4IC_SNR_TIERS[snr_tier]
    os.makedirs(save_path, exist_ok=True)
    for split in ("train", "validation"):
        make_dream4_combo_dataset(orig_data_path, save_path, fold_id, split,
                                  num_factors, dominant, background,
                                  shuffle_rng=shuffle_rng)
