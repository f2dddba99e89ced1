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

:class:`ShardedBatchDataset` streams a split directory too large to hold
in memory, one shard file at a time (the JAX class, bit for bit: the same
statistics, quarantine records, batch order and host slices), with the
``shard_loader`` heartbeat of ``runtime/watchdog.py``, the ring-only
``shard.load`` span and the ``hang_in:shard_loader`` and ``slow_io``
fault points.

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
from redcliff_tpu_torch.obs import spans as _spans
from redcliff_tpu_torch.runtime import faultinject as _faultinject
from redcliff_tpu_torch.runtime import watchdog as _watchdog
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
    "ShardedBatchDataset",
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


class ShardedBatchDataset:
    """Streaming batch source for split dirs too large to materialize: holds
    ONE shard file in memory at a time instead of the whole fold.

    The train engines duck-type on ``supports_device_batches`` — this class
    reports False, so the grid runner / trainers route it through the
    host-side per-batch path behind the double-buffered prefetcher
    (data/pipeline.py): shard unpickling + normalization + slicing of batch
    t+1 overlap device compute of batch t. On the card that path launches
    the kernels eagerly, outside any CUDA-graph capture (the grid's epoch
    engine needs a device-resident dataset).

    Construction makes one streaming statistics pass (per-channel sum /
    sum-of-squares over every shard) so batches z-score with the SAME
    dataset-wide channel stats the in-memory loaders use; non-finite samples
    are quarantined with a counted RuntimeWarning exactly like
    :func:`load_shard_samples`. Shuffling (``rng`` passed to ``batches``)
    permutes the shard ORDER and the samples within each shard — a bounded-
    memory approximation of a global shuffle (documented deviation from
    ``ArrayDataset``'s exact permutation); unshuffled iteration matches the
    concatenated-shard order bit-for-bit, which tests pin against
    ``ArrayDataset``.

    Torn files: a shard that fails to read back — truncated mid-write,
    bit-rotted pickle, vanished file — is quarantined PER FILE
    (``quarantined_files[name] = reason``, with a RuntimeWarning) and the
    stream continues with the remaining shards, the same degrade-don't-crash
    contract the per-sample non-finite quarantine established. This covers
    both construction and mid-stream reads (the file may tear between the
    stats pass and epoch N). Each shard read stamps the ``"shard_loader"``
    heartbeat so a read wedged on dead storage is a watchdog-visible hang,
    not a silent stall.

    Host-local streaming (multi-host scale-out): ``host_id``/``n_hosts`` restrict this instance to its host's round-robin
    slice of the sorted shard list (``files[host_id::n_hosts]`` by sorted
    index) — every shard is owned by exactly one host, uneven counts
    included (no shard dropped, none read twice). Quarantine — per-sample
    tallies AND torn-file records — stays per host: each host reports only
    the shards it owns, so one host's dead storage never poisons another's
    stream. The heartbeat is host-scoped too (``host<h>:shard_loader``),
    giving the watchdog's per-host staleness detector a real producer.
    Normalization statistics are computed over the host-local slice
    (documented deviation: the global-stats path is the in-memory loader;
    callers needing cross-host-identical stats precompute and pass
    ``normalize=False`` plus their own transform).
    """

    supports_device_batches = False

    def __init__(self, split_dir, normalize=True, host_id=None, n_hosts=None):
        self.split_dir = split_dir
        all_files = sorted(
            x for x in os.listdir(split_dir)
            if "subset_" in x and x.endswith(".pkl") and "metadata" not in x)
        if not all_files:
            raise FileNotFoundError(f"no subset_*.pkl shards under {split_dir}")
        if (host_id is None) != (n_hosts is None):
            raise ValueError("host_id and n_hosts must be given together")
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._hb = ("shard_loader" if host_id is None
                    else _watchdog.host_component(host_id, "shard_loader"))
        if n_hosts is not None:
            if not (0 <= int(host_id) < int(n_hosts)):
                raise ValueError(
                    f"host_id {host_id} out of range for n_hosts {n_hosts}")
            # round-robin by sorted index: a partition of the shard list for
            # ANY (n_files, n_hosts) — no shard dropped, none assigned twice
            self.files = all_files[int(host_id)::int(n_hosts)]
            if not self.files:
                raise FileNotFoundError(
                    f"host {host_id}/{n_hosts} owns no shards under "
                    f"{split_dir} ({len(all_files)} shard file(s) < "
                    f"{n_hosts} hosts) — reduce n_hosts or write more "
                    f"shards")
        else:
            self.files = all_files
        self.normalize = normalize
        self.quarantined_samples = 0
        self.quarantined_files = {}
        self._shape_tc = None
        n = 0
        s = ss = None
        for name in self.files:
            X, _ = self._load_shard(name, count_quarantine=True)
            if not len(X):
                continue  # fully-quarantined shard
            if self._shape_tc is None:
                self._shape_tc = X.shape[1:]
            elif X.shape[1:] != self._shape_tc:
                raise ValueError(
                    f"shard {name} window shape {X.shape[1:]} != first "
                    f"shard's {self._shape_tc}")
            n += X.shape[0]
            # f64 accumulators: a streaming f32 sum over a big fold drifts
            part = X.astype(np.float64)
            s = part.sum(axis=(0, 1)) if s is None else s + part.sum(axis=(0, 1))
            ss = ((part ** 2).sum(axis=(0, 1)) if ss is None
                  else ss + (part ** 2).sum(axis=(0, 1)))
        self._n = n
        _watchdog.retire(self._hb)  # stats pass done; batches() re-arms
        if self._shape_tc is None:
            raise ValueError(
                f"every sample under {split_dir} was quarantined "
                f"(non-finite data or torn shard files: "
                f"{sorted(self.quarantined_files) or 'none torn'}) — "
                f"nothing to train on")
        shape_tc = self._shape_tc
        if normalize:
            cnt = max(n * shape_tc[0], 1)
            mean = s / cnt
            var = np.maximum(ss / cnt - mean ** 2, 0.0)
            std = np.sqrt(var)
            std = np.where(std == 0.0, 1.0, std)
            self.stats = (mean.astype(np.float32), std.astype(np.float32))
        else:
            self.stats = None
        if self.quarantined_samples:
            warnings.warn(
                f"ShardedBatchDataset: quarantined {self.quarantined_samples} "
                f"non-finite samples under {split_dir}", RuntimeWarning,
                stacklevel=2)

    def _empty(self):
        return (np.zeros((0,) + (self._shape_tc or (0, 0)), np.float32),
                np.zeros((0, 1), np.float32))

    def _load_shard(self, name, count_quarantine=False):
        # liveness + chaos hooks: stamped while a read is in flight (the
        # budget measures one shard load, not inter-load idle — batches()
        # retires the heartbeat when the stream ends). Host-local instances
        # stamp their host-scoped beat (host<h>:shard_loader)
        _watchdog.stamp(self._hb)
        _faultinject.hang_point("shard_loader")
        _faultinject.io_point("shard_read")
        try:
            # traced load span (ring-only, under the heartbeat's component
            # name): a flight record after a wedged/slow storage incident
            # shows which shard files were read last and how long each took
            with _spans.span("shard.load", component=self._hb, file=name):
                with open(os.path.join(self.split_dir, name), "rb") as f:
                    pairs = pickle.load(f)
        except (OSError, pickle.UnpicklingError, EOFError, ValueError,
                AttributeError, ImportError, IndexError) as e:
            # torn/truncated/vanished shard: quarantine the FILE and keep
            # streaming — the same degrade-don't-crash contract as the
            # per-sample non-finite quarantine
            if name not in self.quarantined_files:
                self.quarantined_files[name] = repr(e)
                warnings.warn(
                    f"ShardedBatchDataset: quarantined torn shard file "
                    f"{name} under {self.split_dir} ({e!r}); continuing "
                    f"with the remaining shards", RuntimeWarning,
                    stacklevel=3)
            return self._empty()
        keep = []
        for pair in pairs:
            x = np.asarray(pair[0], dtype=np.float32)
            y = np.asarray(pair[1], dtype=np.float32)
            # quarantine on non-finite X OR Y — the same per-sample
            # contract ArrayDataset enforces, so the shard stream and the
            # in-memory path train on identical sample sets
            if not np.isfinite(x).all() or not np.isfinite(y).all():
                if count_quarantine:
                    self.quarantined_samples += 1
                continue
            keep.append([x, pair[1]])
        return samples_to_arrays(keep) if keep else self._empty()

    def __len__(self):
        return self._n

    @property
    def num_timesteps(self):
        return self._shape_tc[0]

    @property
    def num_channels(self):
        return self._shape_tc[1]

    def batches(self, batch_size, rng=None, drop_remainder=False):
        """Yield normalized (X, Y) minibatches, streaming one shard at a
        time; samples left over from a shard carry into the next shard's
        pool, so only the final batch of the epoch can be short.

        One concatenation per shard (the short carry-over head is prepended
        once), then batches are yielded as views via a cursor — no
        per-batch recopying of the remaining buffer.

        A shard that tears between epochs is quarantined per file (see the
        class docstring) and the stream continues over the survivors."""
        try:
            files = list(self.files)
            if rng is not None:
                rng.shuffle(files)
            carry_X = carry_Y = None
            for name in files:
                X, Y = self._load_shard(name)
                if not len(X):
                    continue  # fully-quarantined shard: nothing to buffer
                if rng is not None:
                    order = rng.permutation(len(X))
                    X, Y = X[order], Y[order]
                if self.normalize:
                    X = (X - self.stats[0]) / self.stats[1]
                if carry_X is not None and len(carry_X):
                    X = np.concatenate([carry_X, X])
                    Y = np.concatenate([carry_Y, Y])
                stop = (len(X) // batch_size) * batch_size
                for start in range(0, stop, batch_size):
                    yield X[start : start + batch_size], \
                        Y[start : start + batch_size]
                carry_X, carry_Y = X[stop:], Y[stop:]
            if carry_X is not None and len(carry_X) and not drop_remainder:
                yield carry_X, carry_Y
        finally:
            # op-scoped liveness: idle between epochs is not a hang
            _watchdog.retire(self._hb)

    def num_batches(self, batch_size, drop_remainder=False):
        n = self._n
        return n // batch_size if drop_remainder else int(np.ceil(n / batch_size))


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
