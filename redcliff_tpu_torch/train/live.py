"""The live parameter tree and the batch stream of a fit, shared by the
generic trainer (``train/trainer.py``) and the REDCLIFF-S trainer
(``train/redcliff_trainer.py``).

The optimizers and the prox update the live leaves in place, so every
tree kept beside them (best, accepted, snapshots, checkpoints) is a copy
(:func:`copy_tree`), put back with :func:`assign_tree`.
"""
from __future__ import annotations

import numpy as np
import torch

from redcliff_tpu_torch.data import pipeline
from redcliff_tpu_torch.interop import tree_leaves, tree_map

__all__ = ["copy_tree", "assign_tree", "LiveTreeMixin"]


def copy_tree(tree):
    """A detached copy of a tensor tree."""
    return tree_map(lambda x: x.detach().clone(), tree)


def assign_tree(live, tree):
    """Copy ``tree``'s values into the live leaves, in place."""
    with torch.no_grad():
        for dst, src in zip(tree_leaves(live), tree_leaves(tree)):
            if dst is not src:
                dst.copy_(src)


class LiveTreeMixin:
    """Batch placement and live leaves of a trainer that has ``device``
    and a ``config`` with ``batch_size`` and ``prefetch_batches``."""

    def _to_device(self, x):
        return None if x is None else torch.as_tensor(x).to(self.device)

    def _batches(self, ds, rng=None):
        """(X, Y) tensors on the trainer's device: gathered from the
        dataset's device-resident copy when it has one, else prefetched."""
        if getattr(ds, "supports_device_batches", False):
            return ds.batches(self.config.batch_size, rng=rng,
                              device=self.device)
        src = ds.batches(self.config.batch_size, rng=rng)
        depth = self.config.prefetch_batches
        if depth > 0:
            return pipeline.prefetch_batches(src, depth=depth,
                                             put=self._to_device)
        return ((self._to_device(X), self._to_device(Y)) for X, Y in src)

    def live_params(self, params):
        """Fresh leaf tensors on the device (requires_grad) from a numpy or
        torch params tree."""
        def leaf(x):
            t = x.detach() if isinstance(x, torch.Tensor) \
                else torch.from_numpy(np.array(x))
            return t.to(self.device).clone().requires_grad_(True)
        return tree_map(leaf, params)
