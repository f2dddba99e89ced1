"""Weights across the two packages.

The port keeps the JAX package's parameter layout exactly — nested dicts and
lists, per-leaf shapes as ``models/redcliff.py`` (stacked K-factor
``[{"w", "b"}, ...]`` lists or stacked cLSTM dicts), ``models/cmlp.py``,
``models/clstm.py``, ``models/dgcnn.py``, ``models/navar.py`` and
``models/embedders.py`` build them, and DCSFA-NMF's ``W_nmf``, ``phi``,
``beta``, ``enc1``/``enc2`` ``{w, b}``, ``bn_scale``, ``bn_shift`` with its
BatchNorm state ``{bn_mean, bn_var}`` from ``models/dcsfa_nmf.py`` (a tree
without ``enc2`` is the linear encoder, its state ``{}``) — so moving
weights is a leaf-by-leaf conversion:

* :func:`params_from_jax` — a tree of numpy arrays (what the JAX package
  saves, or ``np.asarray`` of its device arrays) -> the same tree of torch
  tensors on ``device``;
* :func:`params_to_jax` — back to numpy, byte for byte;
* :func:`grid_state_from_jax` — a JAX coefficient grid's stacked state
  (``(G, ...)`` params and each lane's Adam moments and step counts, from
  ``RedcliffGridRunner.init_grid``/``init_grid_from``) -> the port
  runner's ``init_params``, so both grids start from the same state;
* :func:`tree_map` / :func:`tree_leaves` — the walk over such trees that
  every module of the port uses (dict order as built; the JAX package's
  ``jax.tree`` sorts dict keys instead).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "grid_state_from_jax",
           "tree_map", "tree_leaves"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), keeping the dict/list/tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of ``tree`` in :func:`tree_map` order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_jax(tree, device="cpu"):
    """Numpy tree -> torch tree on ``device`` (dtypes kept)."""
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)


def params_to_jax(params):
    """Torch tree -> numpy tree (host copies, dtypes kept)."""
    return tree_map(lambda x: x.detach().cpu().numpy().copy(), params)


def grid_state_from_jax(params, embed_adam, factor_adam, device="cpu"):
    """A JAX grid's stacked state as numpy trees -> ``(params, embedder
    Adam, factor Adam)`` for the port's ``RedcliffGridRunner.fit
    (init_params=...)``. The Adam states are optax ``scale_by_adam``
    states (named tuples, as ``jax.tree.map(np.asarray, ...)`` leaves
    them): the per-lane ``count`` becomes the lane step count, ``mu`` /
    ``nu`` the first and second moments."""
    def adam(state):
        return {"step": torch.from_numpy(
                    np.asarray(state.count).astype(np.int64)).to(device),
                "exp_avg": params_from_jax(state.mu, device),
                "exp_avg_sq": params_from_jax(state.nu, device)}
    return (params_from_jax(params, device), adam(embed_adam),
            adam(factor_adam))
