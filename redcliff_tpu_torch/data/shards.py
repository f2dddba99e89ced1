"""Shared on-disk shard layout and the signal-format feature transforms
(port of ``data/shards.py``).

The reference's datasets live as ``fold_<k>/{train,validation}/subset_*.pkl``
shards holding ``[[x (T, C), y], ...]`` pairs. This layout is the
cross-process results contract both packages read and write; shards are
loaded once into dense arrays.

Signal formats: "original" (T, C) windows, "wavelet_decomp" (the raw
windows swt-decomposed before normalization), "flattened" feature vectors,
and "directed_spectrum" / "directed_spectrum vanilla" high-level spectral
features (``utils/time_series.make_high_level_signal_features``). Features
are computed on the host in numpy, as in the JAX package, and kept on the
dataset as ``X_features``; with ``device`` they are placed there as
``device_features``, beside the windows.

Not ported yet: the streaming ``ShardedBatchDataset`` with its watchdog,
fault-injection and span hooks (ROADMAP queue 1, item 11).

The datasets come back as the port's
:class:`~redcliff_tpu_torch.data.datasets.ArrayDataset`.
"""
from __future__ import annotations

import os
import pickle
import warnings

import numpy as np
import torch

from redcliff_tpu_torch.data.datasets import ArrayDataset
from redcliff_tpu_torch.utils.misc import flatten_directed_spectrum_features
from redcliff_tpu_torch.utils.time_series import (
    make_high_level_signal_features, swt)

__all__ = [
    "save_cv_split",
    "load_shard_samples",
    "load_normalized_samples",
    "samples_to_arrays",
    "apply_signal_format",
    "decompose_windows",
    "load_normalized_split_datasets",
]


def save_cv_split(train_data, val_data, cv_id, save_path):
    """Write one CV fold in the reference layout."""
    root = os.path.join(save_path, f"fold_{cv_id}")
    os.makedirs(os.path.join(root, "train"))
    os.makedirs(os.path.join(root, "validation"))
    with open(os.path.join(root, "train", "subset_0.pkl"), "wb") as f:
        pickle.dump(train_data, f)
    with open(os.path.join(root, "validation", "subset_0.pkl"), "wb") as f:
        pickle.dump(val_data, f)


def load_shard_samples(data_path, drop_nan=True, report=None):
    """Load every ``subset_*.pkl`` under a split dir into a [[x, y], ...]
    list, quarantining non-finite samples as a COUNTED drop (per-file
    tallies in ``report`` when a dict is passed, plus a RuntimeWarning)."""
    files = sorted(x for x in os.listdir(data_path)
                   if "subset_" in x and x.endswith(".pkl")
                   and "metadata" not in x)
    samples = []
    skipped = 0
    per_file = {}
    for name in files:
        with open(os.path.join(data_path, name), "rb") as f:
            for pair in pickle.load(f):
                x = np.asarray(pair[0], dtype=np.float32)
                if drop_nan and not np.isfinite(x).all():
                    skipped += 1
                    per_file[name] = per_file.get(name, 0) + 1
                    continue
                samples.append([x, np.asarray(pair[1], dtype=np.float32)])
    if report is not None:
        report["quarantined"] = skipped
        report["loaded"] = len(samples)
        report["quarantined_by_file"] = per_file
    if skipped:
        warnings.warn(
            f"load_shard_samples: quarantined {skipped} non-finite samples "
            f"under {data_path} ({per_file})", RuntimeWarning, stacklevel=2)
    return samples


def samples_to_arrays(samples):
    """[[x, y], ...] -> (X (N, T, C), Y (N, ...)) dense arrays. x is
    squeezed like the reference loaders; y keeps its stored shape."""
    X = np.stack([np.squeeze(s[0]) for s in samples]).astype(np.float32)
    Y = np.stack([np.atleast_1d(np.asarray(s[1]))
                  for s in samples]).astype(np.float32)
    return X, Y


def load_normalized_samples(split_dir):
    """One split's recordings z-scored with the same per-split channel
    statistics the training loaders apply. Returns an ArrayDataset."""
    X, Y = samples_to_arrays(load_shard_samples(split_dir))
    return ArrayDataset(X, Y, normalize=True, grid_search=False)


def apply_signal_format(X, signal_format, max_num_features_per_series=None,
                        dirspec_params=None):
    """Transform normalized (N, T, C) windows per the signal_format switch
    (ref dream4_datasets.py:120-151). Returns (N, F) features for flattened /
    dirspec formats, or X unchanged for "original" and "wavelet_decomp"
    (decomposed before normalization by
    :func:`load_normalized_split_datasets`)."""
    if signal_format in ("original", "wavelet_decomp"):
        return X
    if "directed_spectrum" in signal_format:
        assert dirspec_params is not None
        feats = []
        for i in range(X.shape[0]):
            x = X[i]
            if max_num_features_per_series is not None:
                x = x[:max_num_features_per_series, :]
            hl = make_high_level_signal_features(
                x, fs=dirspec_params["fs"],
                min_freq=dirspec_params["min_freq"],
                max_freq=dirspec_params["max_freq"],
                directed_spectrum=dirspec_params["directed_spectrum"],
                csd_params=dirspec_params["csd_params"])
            ds = np.asarray(hl["dir_spec"])[0]
            if "vanilla" in signal_format:
                feats.append(ds.reshape(-1))
            else:
                feats.append(flatten_directed_spectrum_features(ds).reshape(-1))
        return np.stack(feats).astype(np.float32)
    if "power_features" in signal_format:
        raise NotImplementedError(
            "power_features format is declared but unimplemented in the "
            "reference as well (ref dream4_datasets.py:146)")
    if "flattened" in signal_format:
        assert max_num_features_per_series is not None
        assert max_num_features_per_series > 0
        return X[:, :max_num_features_per_series, :].reshape(
            X.shape[0], -1).astype(np.float32)
    raise ValueError(f"unknown signal_format: {signal_format!r}")


def decompose_windows(X, wavelet_level, wavelet_type="db1"):
    """Stationary-wavelet-decompose a batch of raw (N, T, C) windows into
    (N, T, C*(level+1)), channel c's bands contiguous in
    [cA, cD_level, ..., cD_1] order — the layout the reference's curation
    stores and the models' wavelet GC condensation reads."""
    N, T, C = X.shape
    assert T % (2 ** wavelet_level) == 0, (
        f"swt needs T divisible by 2**level; got T={T}, "
        f"level={wavelet_level}")
    bands = swt(np.transpose(X, (0, 2, 1)), wavelet_type, wavelet_level)
    stacked = np.stack(bands, axis=2)  # (N, C, level+1, T)
    return np.transpose(
        stacked.reshape(N, C * (wavelet_level + 1), T), (0, 2, 1)
    ).astype(np.float32)


def load_normalized_split_datasets(data_root_path, signal_format="original",
                                   shuffle=True, shuffle_seed=0,
                                   max_num_features_per_series=None,
                                   dirspec_params=None, grid_search=True,
                                   average_region_map=None,
                                   wavelet_level=None, device=None):
    """(train, validation) ArrayDatasets from a fold directory, z-scored
    with per-split dataset-wide channel statistics like the reference
    loaders. ``average_region_map`` ({region: [channel indices]}) averages
    channel groups before normalization.

    For "wavelet_decomp" formats the raw windows are swt-decomposed FIRST
    and the z-scoring applies to the decomposed representation. Any other
    format but "original" adds its host features as ``X_features`` (the
    windows themselves for "wavelet_decomp"). With ``device`` each
    dataset's resident copy, and the features of a feature format as
    ``device_features``, are placed there at once."""
    out = []
    for split in ("train", "validation"):
        split_dir = os.path.join(data_root_path, split)
        report = {}
        X, Y = samples_to_arrays(load_shard_samples(split_dir,
                                                    report=report))
        if average_region_map is not None:
            X = np.stack([X[:, :, idxs].mean(axis=2)
                          for idxs in average_region_map.values()], axis=2)
        if "wavelet_decomp" in signal_format:
            assert wavelet_level, (
                "signal_format 'wavelet_decomp' requires wavelet_level >= 1")
            X = decompose_windows(X, wavelet_level)
        if shuffle:
            rng = np.random.default_rng(shuffle_seed)
            order = rng.permutation(len(X))
            X, Y = X[order], Y[order]
        ds = ArrayDataset(X, Y, normalize=True, grid_search=grid_search)
        ds.source_quarantine_report = report
        if signal_format != "original":
            ds.X_features = apply_signal_format(
                ds.X, signal_format,
                max_num_features_per_series=max_num_features_per_series,
                dirspec_params=dirspec_params)
        if device is not None:
            ds.device_arrays(device)
            feats = getattr(ds, "X_features", None)
            if feats is not None and feats is not ds.X:
                ds.device_features = torch.from_numpy(feats).to(device)
        out.append(ds)
    return tuple(out)
