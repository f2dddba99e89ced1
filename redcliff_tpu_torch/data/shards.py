"""Shared on-disk shard layout (the port's copy of the ``original``-format
half of ``data/shards.py``).

The reference's datasets live as ``fold_<k>/{train,validation}/subset_*.pkl``
shards holding ``[[x (T, C), y], ...]`` pairs. This layout is the
cross-process results contract both packages read and write; shards are
loaded once into dense arrays.

Not ported yet: the streaming ``ShardedBatchDataset`` with its watchdog,
fault-injection and span hooks (ROADMAP queue 1, item 11), and the feature
formats (``wavelet_decomp``, ``flattened``, ``directed_spectrum*``), which
need ``utils/time_series`` and the directed spectrum; asking for one
raises ``NotImplementedError``.

numpy + stdlib only; the datasets come back as the port's
:class:`~redcliff_tpu_torch.data.datasets.ArrayDataset`.
"""
from __future__ import annotations

import os
import pickle
import warnings

import numpy as np

from redcliff_tpu_torch.data.datasets import ArrayDataset

__all__ = [
    "save_cv_split",
    "load_shard_samples",
    "load_normalized_samples",
    "samples_to_arrays",
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


def load_normalized_split_datasets(data_root_path, signal_format="original",
                                   shuffle=True, shuffle_seed=0,
                                   grid_search=True, average_region_map=None,
                                   device=None):
    """(train, validation) ArrayDatasets from a fold directory, z-scored
    with per-split dataset-wide channel statistics like the reference
    loaders. ``average_region_map`` ({region: [channel indices]}) averages
    channel groups before normalization. With ``device`` each dataset's
    resident copy is placed there at once. ``signal_format`` "original"
    only."""
    if signal_format != "original":
        raise NotImplementedError(
            f"signal_format {signal_format!r} needs utils/time_series and "
            f"the directed spectrum, which are not ported yet (ROADMAP "
            f"queue 1, item 13); the port loads 'original' windows")
    out = []
    for split in ("train", "validation"):
        split_dir = os.path.join(data_root_path, split)
        report = {}
        X, Y = samples_to_arrays(load_shard_samples(split_dir,
                                                    report=report))
        if average_region_map is not None:
            X = np.stack([X[:, :, idxs].mean(axis=2)
                          for idxs in average_region_map.values()], axis=2)
        if shuffle:
            rng = np.random.default_rng(shuffle_seed)
            order = rng.permutation(len(X))
            X, Y = X[order], Y[order]
        ds = ArrayDataset(X, Y, normalize=True, grid_search=grid_search)
        ds.source_quarantine_report = report
        if device is not None:
            ds.device_arrays(device)
        out.append(ds)
    return tuple(out)
