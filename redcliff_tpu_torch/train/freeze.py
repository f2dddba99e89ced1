"""Freeze-mode accept/revert choreography (port of ``train/freeze.py``).

The Freeze training modes keep a candidate and an accepted copy of every
factor network; after each batch (FreezeByBatch) or epoch (FreezeByEpoch)
a per-factor decision statistic chooses, factor by factor, whether the
candidate update is kept or reverted. Two params trees merged with
per-factor ``torch.where`` masks, as in the JAX package.
:func:`apply_freeze_lanes` runs the round for every lane of the coefficient
grid's stacked trees (``torch.func.vmap``, as the JAX grid vmaps it).
"""
from __future__ import annotations

import torch

from redcliff_tpu_torch.interop import tree_leaves, tree_map
from redcliff_tpu_torch.parallel.mesh import FactorShards, factor_slices

__all__ = ["factor_decision_stats", "freeze_accept_vector", "swap_factors",
           "apply_freeze", "apply_freeze_lanes"]


def factor_decision_stats(model, params):
    """Per-factor (matrix 1-norm, mean pairwise cosine) of the unlagged
    factor GC estimates. The 1-norm is the MATRIX 1-norm of each
    max-normalized (C, C) estimate: the largest column sum of |G|."""
    G = model.factor_gc(params, ignore_lag=True)  # (K, C, C)
    G = G / torch.clamp_min(torch.amax(torch.abs(G), dim=(1, 2),
                                       keepdim=True), 1e-12)
    l1 = torch.amax(torch.sum(torch.abs(G), dim=1), dim=-1)  # (K,)
    flat = G.reshape(G.shape[0], -1)
    norms = torch.clamp_min(torch.sqrt(torch.sum(flat * flat, dim=1)), 1e-8)
    cos = (flat @ flat.T) / (norms[:, None] * norms[None, :])
    K = G.shape[0]
    off = 1.0 - torch.eye(K, dtype=G.dtype, device=G.device)
    avg_cos = torch.sum(cos * off, dim=1) / max(K - 1.0, 1.0)
    return l1, avg_cos


def freeze_accept_vector(mode, new_stats, old_stats):
    """(K,) bool accept mask from the training mode's decision rule:
    'withComboCosSimL1' accepts when cos*l1 shrinks, 'withL1' when l1
    shrinks."""
    l1_new, cos_new = new_stats
    l1_old, cos_old = old_stats
    if "withComboCosSimL1" in mode:
        return (cos_new * l1_new) < (cos_old * l1_old)
    if "withL1" in mode:
        return l1_new < l1_old
    raise NotImplementedError(f"no freeze decision rule in mode {mode!r}")


def swap_factors(candidate, accepted, accept_vec):
    """accept_vec (K,) bool: True takes the candidate factor into the
    accepted tree and keeps it in the candidate; False reverts the
    candidate factor to the accepted one. The accepted tree's embedder
    follows the candidate only on rounds where some factor was accepted."""

    def pick(vec):
        def leaf(c_leaf, a_leaf):
            m = vec.reshape((-1,) + (1,) * (c_leaf.dim() - 1))
            return torch.where(m, c_leaf, a_leaf)
        return leaf

    any_accept = torch.any(accept_vec)
    if isinstance(candidate["factors"], FactorShards):
        # factor blocks: each block takes its K slice of the decision
        merged = FactorShards(
            tree_map(pick(accept_vec[lo:hi].to(tree_leaves(c)[0].device)),
                     c, a)
            for (lo, hi), c, a in zip(factor_slices(candidate["factors"]),
                                      candidate["factors"],
                                      accepted["factors"]))
    else:
        merged = tree_map(pick(accept_vec), candidate["factors"],
                          accepted["factors"])
    emb = tree_map(lambda c, a: torch.where(any_accept, c, a),
                    candidate["embedder"], accepted["embedder"])
    return (dict(candidate, factors=merged),
            dict(accepted, factors=merged, embedder=emb))


def apply_freeze(model, mode, candidate, accepted):
    """One accept/revert round for a (candidate, accepted) pair."""
    accept = freeze_accept_vector(
        mode,
        factor_decision_stats(model, candidate),
        factor_decision_stats(model, accepted))
    return swap_factors(candidate, accepted, accept)


def apply_freeze_lanes(model, mode, candidate, accepted):
    """:func:`apply_freeze` for every lane of stacked ``(G, ...)`` trees:
    returns the merged candidates and the new accepted trees, stacked."""
    return torch.func.vmap(
        lambda c, a: apply_freeze(model, mode, c, a))(candidate, accepted)
