"""Device-resident dataset containers (port of ``data/datasets.py``).

One-shot loads into (N, T, C) arrays with dataset-wide per-channel z-score
statistics. Input contracts: construction validates shape/dtype (a ragged
or non-(N, T, C) input raises :class:`InputContractError` naming the
violation) and quarantines non-finite samples with a COUNT
(``quarantined_samples``) plus a RuntimeWarning — never a silent drop, and
never a NaN row poisoning the normalization statistics.

``batches(..., device=dev)`` keeps ONE copy of the whole dataset on the
device and gathers each batch there by index, so an epoch ships only the
small index arrays host to device, not the batch data.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["ArrayDataset", "InputContractError", "train_val_split"]


class InputContractError(ValueError):
    """Input data violates the dataset contract (shape/dtype/label
    length)."""


class ArrayDataset:
    """In-memory (N, T, C) signals + (N, ...) labels with channel
    normalization; the same input contract as the JAX package's.
    ``contract=False`` skips the checks and the quarantine."""

    supports_device_batches = True  # the trainer probes this
    quarantined_samples = 0

    def __init__(self, X, Y=None, normalize=True, stats=None,
                 grid_search=False, contract=True):
        X = np.asarray(X)
        if contract:
            if X.dtype == object:
                raise InputContractError(
                    "X is an object array (ragged sample list?); the dataset "
                    "contract requires a dense (N, T, C) numeric array")
            if X.ndim != 3:
                raise InputContractError(
                    f"X must be (num_samples, num_timesteps, num_channels); "
                    f"got shape {X.shape}")
            if not np.issubdtype(X.dtype, np.floating) \
                    and not np.issubdtype(X.dtype, np.integer):
                raise InputContractError(f"X dtype {X.dtype} is not numeric")
        X = np.asarray(X, dtype=np.float32)
        Y = None if Y is None else np.asarray(Y, dtype=np.float32)
        if contract and Y is not None and len(Y) != len(X):
            raise InputContractError(
                f"label length {len(Y)} != sample count {len(X)}")
        if contract and len(X):
            good = np.isfinite(X).all(axis=(1, 2))
            if Y is not None:
                good &= np.isfinite(Y.reshape(len(Y), -1)).all(axis=1)
            n_bad = int(len(X) - good.sum())
            if n_bad:
                # quarantine BEFORE the statistics: one NaN sample would
                # otherwise normalize every clean sample to NaN
                warnings.warn(
                    f"ArrayDataset: quarantined {n_bad}/{len(X)} samples "
                    f"containing non-finite values", RuntimeWarning,
                    stacklevel=2)
                X = X[good]
                Y = None if Y is None else Y[good]
            self.quarantined_samples = n_bad
        if normalize:
            # statistics from the FULL dataset even under grid_search
            # subsetting (stats first, slice after)
            if stats is None:
                mean = X.mean(axis=(0, 1))
                std = X.std(axis=(0, 1))
                std = np.where(std == 0.0, 1.0, std)
                stats = (mean, std)
            self.stats = stats
        else:
            self.stats = None
        if grid_search:
            keep = max(1, len(X) // 4)
            X = X[:keep]
            Y = None if Y is None else Y[:keep]
        if normalize:
            X = (X - self.stats[0]) / self.stats[1]
        self.X = X
        self.Y = Y
        self._dev = {}

    def __len__(self):
        return len(self.X)

    @property
    def num_channels(self):
        return self.X.shape[2]

    @property
    def num_timesteps(self):
        return self.X.shape[1]

    def device_arrays(self, device):
        """The one device-resident (X, Y) copy per device, made at first
        use."""
        device = torch.device(device)
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (
                torch.from_numpy(self.X).to(device),
                None if self.Y is None else torch.from_numpy(self.Y).to(
                    device))
        return self._dev[key]

    def batches(self, batch_size, rng=None, drop_remainder=False,
                device=None):
        """Yield (X, Y) minibatches; shuffled when an np.random.Generator
        is given (one ``rng.shuffle`` of ``arange(n)`` per call, as the JAX
        package). ``device=None`` yields numpy slices; a device yields
        tensors gathered on that device from its resident copy."""
        n = len(self.X)
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
        if device is not None:
            Xs, Ys = self.device_arrays(device)
            idx_dev = torch.from_numpy(idx).to(Xs.device)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for start in range(0, stop, batch_size):
            if device is None:
                sel = idx[start: start + batch_size]
                if len(sel) == 0:
                    break
                yield self.X[sel], (None if self.Y is None else self.Y[sel])
            else:
                sel = idx_dev[start: start + batch_size]
                yield Xs[sel], (None if Ys is None else Ys[sel])

    def num_batches(self, batch_size, drop_remainder=False):
        n = len(self.X)
        return (n // batch_size if drop_remainder
                else int(np.ceil(n / batch_size)))


def train_val_split(X, Y, val_fraction=0.2, rng=None, normalize=True,
                    grid_search=False):
    """Split into normalized train/val ArrayDatasets; validation reuses the
    training normalization statistics."""
    n = len(X)
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    n_val = int(round(n * val_fraction))
    val_idx, train_idx = idx[:n_val], idx[n_val:]
    train = ArrayDataset(X[train_idx], None if Y is None else Y[train_idx],
                         normalize=normalize, grid_search=grid_search)
    val = ArrayDataset(X[val_idx], None if Y is None else Y[val_idx],
                       normalize=normalize, stats=train.stats)
    return train, val
