"""Differentiable loss terms of the REDCLIFF-S loss (port of
``ops/losses.py``). Plain PyTorch over batched tensors.

Norms are written as ``sqrt(sum(x * x))``, as the JAX package computes
them, so their gradients agree at zero too (``torch.linalg.norm`` masks
the zero case; ``jnp.linalg.norm`` does not).
"""
from __future__ import annotations

import torch

__all__ = [
    "channelwise_forecast_mse",
    "lag_weighted_adjacency_l1",
    "pairwise_cosine_penalty",
    "factor_weight_l1",
    "dagness_penalty",
]


def channelwise_forecast_mse(preds, targets):
    """sum_c MSE(preds[..., c], targets[..., c]) = C * mean over all
    entries."""
    return preds.shape[-1] * torch.mean((preds - targets) ** 2)


def lag_weighted_adjacency_l1(gc_lagged):
    """Sum over leading axes and lags of log(l+2) * ||A[..., l]||_1.
    gc_lagged: (..., C, C, L)."""
    L = gc_lagged.shape[-1]
    lag_w = torch.log(torch.arange(L, dtype=gc_lagged.dtype,
                                   device=gc_lagged.device) + 2.0)
    return torch.sum(torch.sum(torch.abs(gc_lagged), dim=(-3, -2)) * lag_w)


def pairwise_cosine_penalty(G, include_diag=False, epsilon=1e-8):
    """Sum of the upper-triangle pairwise cosine similarities between the
    K factor graphs of ``G (..., K, C, C)``; with ``include_diag=False``
    the identity is subtracted from each graph first."""
    K = G.shape[-3]
    if K <= 1:
        return torch.zeros(G.shape[:-3], dtype=G.dtype, device=G.device)
    C = G.shape[-1]
    if include_diag:
        flat = G.reshape(G.shape[:-2] + (-1,))
    else:
        eye = torch.eye(C, dtype=G.dtype, device=G.device)
        flat = (G - eye).reshape(G.shape[:-2] + (C * C,))
    norms = torch.sqrt(torch.sum(flat * flat, dim=-1))   # (..., K)
    gram = torch.einsum("...kd,...jd->...kj", flat, flat)
    denom = (torch.clamp_min(norms[..., :, None], epsilon)
             * torch.clamp_min(norms[..., None, :], epsilon))
    cos = gram / denom
    iu = torch.triu_indices(K, K, offset=1, device=G.device)
    return cos[..., iu[0], iu[1]].sum(dim=-1)


def factor_weight_l1(scores):
    """FACTOR_WEIGHT penalty ||s||_1 - 1 on the first-step factor scores."""
    return torch.sum(torch.abs(scores)) - 1.0


def dagness_penalty(W0):
    """(tr(exp(W∘W)) - N)^2 with ELEMENTWISE exp, as the JAX package."""
    if W0.dim() == 3 and W0.shape[2] == 1:
        W0 = W0[:, :, 0]
    n = W0.shape[0]
    return (torch.trace(torch.exp(W0 * W0)) - n) ** 2.0

