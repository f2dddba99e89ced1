"""Proximal operators for the Granger-causal first-layer block (port of
``ops/prox.py``).

The K factors x C output series are one weight block

    W1: (..., C_out, H, C_in, L)

and each penalty is one soft-threshold over group norms. These are the
plain PyTorch versions: the CPU path, the GSGL and H path on every device,
and the reference the GL kernel (``ops/pallas_prox.py``) is held against.

Group structures:
  GL   — one group per (output series, input series): norm over (H, L)
  GSGL — per-lag groups (norm over H), THEN the GL group
  H    — hierarchical: nested prefixes [:l+1] of the lag axis, lowest lag
         index = most-lagged value
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["prox_update", "prox_update_at", "soft_threshold_by_group_norm",
           "group_lasso_penalty", "ridge_penalty", "threshold"]


def threshold(lam, lr):
    """``lr * lam`` as the float32 value both frameworks use: the JAX
    package computes it as a Python float and it meets float32 operands."""
    return float(np.float32(lr * lam))


def _group_norm(W, dims):
    return torch.sqrt(torch.sum(W * W, dim=dims, keepdim=True))


def soft_threshold_by_group_norm(W, norm, thresh):
    """W <- (W / max(norm, thresh)) * max(norm - thresh, 0)."""
    return (W / torch.clamp_min(norm, thresh)) \
        * torch.clamp_min(norm - thresh, 0.0)


def prox_update(W1, lam, lr, penalty="GL"):
    """Proximal update on a first-layer block ``(..., H, C_in, L)``; any
    leading axes are batched. Functional: returns a new tensor."""
    return prox_update_at(W1, threshold(lam, lr), penalty)


def prox_update_at(W1, t, penalty="GL"):
    """:func:`prox_update` at the threshold ``t``: a number, or a tensor
    that broadcasts against ``W1`` (the coefficient grid's per-lane
    thresholds, shaped ``(G, 1, ..., 1)``)."""
    h_axis, lag_axis = -3, -1
    if penalty == "GL":
        return soft_threshold_by_group_norm(
            W1, _group_norm(W1, (h_axis, lag_axis)), t)
    if penalty == "GSGL":
        W1 = soft_threshold_by_group_norm(W1, _group_norm(W1, (h_axis,)), t)
        return soft_threshold_by_group_norm(
            W1, _group_norm(W1, (h_axis, lag_axis)), t)
    if penalty == "H":
        for i in range(W1.shape[lag_axis]):
            prefix = W1[..., : i + 1]
            updated = soft_threshold_by_group_norm(
                prefix, _group_norm(prefix, (h_axis, lag_axis)), t)
            W1 = torch.cat([updated, W1[..., i + 1:]], dim=lag_axis)
        return W1
    raise ValueError(f"unsupported penalty: {penalty}")


def group_lasso_penalty(W1, lam, penalty="GL"):
    """Nonsmooth penalty value matching the prox's group structure."""
    h_axis, lag_axis = -3, -1

    def norms(W, dims):
        return torch.sqrt(torch.sum(W * W, dim=dims))

    if penalty == "GL":
        return lam * torch.sum(norms(W1, (h_axis, lag_axis)))
    if penalty == "GSGL":
        return lam * (torch.sum(norms(W1, (h_axis, lag_axis)))
                      + torch.sum(norms(W1, (h_axis,))))
    if penalty == "H":
        total = 0.0
        for i in range(W1.shape[lag_axis]):
            total = total + torch.sum(norms(W1[..., : i + 1],
                                            (h_axis, lag_axis)))
        return lam * total
    raise ValueError(f"unsupported penalty: {penalty}")


def ridge_penalty(params_l2_leaves, lam):
    """Ridge penalty over the non-first-layer weights."""
    total = 0.0
    for leaf in params_l2_leaves:
        total = total + torch.sum(leaf * leaf)
    return lam * total
