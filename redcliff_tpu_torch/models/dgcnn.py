"""DGCNN — dynamical graph CNN over a learned adjacency (port of
``models/dgcnn.py``).

  L = D^{-1/2} relu(A) D^{-1/2}
  supports = [I, L, L@L, ...]                     (num_layers entries)
  h = relu(sum_k  supports[k] @ x @ W_k)          x: (B, N, F)
  out = fc2(relu(fc1(flatten(h))))

Input features are normalized with per-BATCH statistics (population
variance) and a learned scale/shift, as in the JAX package. In the serve
engine the batch is the slot table, so these statistics mix lanes; the
port reproduces that behaviour rather than fixing it. The learned adjacency
is the model's Granger-graph estimate, read out transposed.

:class:`DGCNNModel` is the supervised baseline: it predicts state labels
from a signal window, fitted by the generic trainer; its adjacency is its
one graph estimate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["DGCNNConfig", "DGCNNModel", "init_dgcnn_params",
           "dgcnn_forward", "dgcnn_gc"]


@dataclass(frozen=True)
class DGCNNConfig:
    num_channels: int
    num_wavelets_per_chan: int  # 1 when no wavelet decomposition
    num_features_per_node: int
    num_graph_conv_layers: int
    num_hidden_nodes: int
    num_classes: int
    fc_hidden: int = 64

    @property
    def num_nodes(self):
        return self.num_channels * self.num_wavelets_per_chan


def init_dgcnn_params(generator, cfg: DGCNNConfig, device="cpu"):
    """Same distributions as the JAX init: xavier-normal adjacency, dense
    layers U(±1/sqrt(d_in)), unit scale and zero shift."""
    N, F, H = cfg.num_nodes, cfg.num_features_per_node, cfg.num_hidden_nodes
    A = torch.randn((N, N), generator=generator) * math.sqrt(2.0 / (N + N))

    def dense(d_in, d_out):
        bound = 1.0 / math.sqrt(d_in)

        def u(shape):
            r = torch.rand(shape, generator=generator)
            return (r * (2.0 * bound) - bound).to(device)
        return {"w": u((d_in, d_out)), "b": u((d_out,))}

    return {
        "A": A.to(device),
        "bn_scale": torch.ones((F,), device=device),
        "bn_shift": torch.zeros((F,), device=device),
        "gconv": [dense(F, H) for _ in range(cfg.num_graph_conv_layers)],
        "fc1": dense(N * H, cfg.fc_hidden),
        "fc2": dense(cfg.fc_hidden, cfg.num_classes),
    }


def _normalize_adjacency(A):
    A = torch.relu(A)
    d = torch.sum(A, dim=1)
    d_inv_sqrt = 1.0 / torch.sqrt(d + 1e-10)
    return d_inv_sqrt[:, None] * A * d_inv_sqrt[None, :]


def dgcnn_forward(params, X, eps=1e-5):
    """X: (B, N, F) node-feature matrix -> (B, num_classes) logits."""
    mean = X.mean(dim=(0, 1))
    var = X.var(dim=(0, 1), correction=0)   # population variance, as jnp.var
    Xn = (X - mean) / torch.sqrt(var + eps)
    Xn = Xn * params["bn_scale"] + params["bn_shift"]

    L = _normalize_adjacency(params["A"])
    h = 0.0
    support = torch.eye(L.shape[0], dtype=X.dtype, device=X.device)
    for layer in params["gconv"]:
        prop = torch.einsum("nm,bmf->bnf", support, Xn)
        h = h + torch.einsum("bnf,fh->bnh", prop, layer["w"]) + layer["b"]
        support = support @ L
    h = torch.relu(h)
    flat = h.reshape(h.shape[0], -1)
    z = torch.relu(flat @ params["fc1"]["w"] + params["fc1"]["b"])
    return z @ params["fc2"]["w"] + params["fc2"]["b"]


def dgcnn_gc(params, cfg: DGCNNConfig, threshold=False,
             combine_node_feature_edges=False):
    """Learned adjacency read out as the GC estimate, TRANSPOSED."""
    GC = params["A"]
    if combine_node_feature_edges:
        w = cfg.num_wavelets_per_chan
        c = cfg.num_channels
        blocks = GC.reshape(c, w, c, w)
        GC = torch.sqrt(torch.sum(blocks * blocks, dim=(1, 3)))
    GC = GC.T
    if threshold:
        return (GC > 0).to(torch.int32)
    return GC


class DGCNNModel:
    """Graph-conv state classifier baseline over a params tree of
    :func:`init_dgcnn_params`; its trained adjacency is the (single)
    system GC estimate."""

    def __init__(self, config: DGCNNConfig):
        self.config = config

    def init(self, generator, device="cpu"):
        return init_dgcnn_params(generator, self.config, device)

    def forward(self, params, X):
        return dgcnn_forward(params, X)

    def loss(self, params, X, Y):
        """MSE between the predicted logits and the labels, on the first
        ``num_features_per_node`` steps; labels (B, S, T) are read at the
        feature horizon (or step 0 when shorter), (B, S) as they are."""
        F = self.config.num_features_per_node
        Y_pred = self.forward(params, X[:, :F, :].transpose(1, 2))
        if Y.dim() == 3:
            Y_t = Y[:, :, F] if Y.shape[2] > F else Y[:, :, 0]
        else:
            Y_t = Y
        loss = torch.mean((Y_pred - Y_t) ** 2)
        return loss, {"factor_loss": loss}

    def gc(self, params, threshold=False, ignore_lag=True,
           combine_wavelet_representations=False, rank_wavelets=False):
        g = dgcnn_gc(params, self.config, threshold=threshold,
                     combine_node_feature_edges=
                     combine_wavelet_representations)
        return [g if ignore_lag else g[:, :, None]]

    def validation_criteria(self, params, val_metrics):
        """The L1 of the max-normalized GC estimate plus the factor
        loss."""
        g = torch.abs(self.gc(params)[0])
        g = g / torch.clamp_min(torch.max(g), 1e-12)
        return torch.sum(g) + val_metrics.get("factor_loss", 0.0)
