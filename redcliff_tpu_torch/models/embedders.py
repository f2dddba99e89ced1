"""Factor-score embedders (port of ``models/embedders.py``): map a recent
signal window to (factor weightings, optional class logits).

* ``VanillaSingleObjective`` — bias-free 2-D conv trunk to an embedding,
  then a bias-free linear to K factor scores;
* ``VanillaMultiObjective`` — same trunk; the first num_out_classes
  embedding dims are both the supervised factor scores and the logits;
* ``CEmbedder`` — one cMLP-style network per factor; first-layer weight
  norms give a (K, C[, L]) GC readout;
* ``DGCNNEmbedder`` — the DGCNN; node-major input (B, C, T).

Each class bundles init/apply/gc: ``apply(params, X) -> (weightings (B, K),
class_logits (B, n_classes) | None)``. The parameter layouts are those of
the JAX package, so weights carry across unchanged (``interop.py``).

The Vanilla trunk's and heads' contractions go through
``utils/precision.py`` (:func:`~redcliff_tpu_torch.utils.precision.einsum`,
:func:`~redcliff_tpu_torch.utils.precision.matmul`): the same ops as plain
torch outside a bf16 context, bf16-rounded operands inside one (the serve
engine's mixed mode).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from redcliff_tpu_torch.models import cmlp as cmlp_mod
from redcliff_tpu_torch.models import dgcnn as dgcnn_mod
from redcliff_tpu_torch.utils import precision as _prec

__all__ = [
    "VanillaSingleObjective",
    "VanillaMultiObjective",
    "CEmbedder",
    "DGCNNEmbedder",
    "build_embedder",
]


def _uniform_fanin(generator, shape, fan_in, device):
    bound = 1.0 / math.sqrt(fan_in)
    r = torch.rand(shape, generator=generator)
    return (r * (2.0 * bound) - bound).to(device)


def _sigmoid_restrict(scores, ecc):
    """Sigmoid restriction with eccentricity coefficient."""
    return torch.sigmoid(ecc * scores)


def _trunk_width(num_in_timesteps):
    """Odd time-kernel width of the first trunk conv."""
    return num_in_timesteps - ((num_in_timesteps - 1) % 2)


def _init_trunk(generator, num_series, num_in_timesteps, hidden, device):
    tkw = _trunk_width(num_in_timesteps)
    return {
        "conv1": _uniform_fanin(generator, (hidden, num_series, tkw),
                                num_series * tkw, device),
        "conv2": _uniform_fanin(generator,
                                (hidden, hidden, num_in_timesteps),
                                hidden * num_in_timesteps, device),
    }


def _apply_trunk(trunk, X, num_series, num_in_timesteps):
    """X: (B, T, C) -> (B, hidden): two bias-free convs, the first padded
    tkw//2 on both sides of time."""
    B, T, C = X.shape
    if T != num_in_timesteps or C != num_series:
        raise ValueError(f"embedder window {(T, C)} != "
                         f"{(num_in_timesteps, num_series)}")
    tkw = _trunk_width(num_in_timesteps)
    x = X.transpose(1, 2)                                 # (B, C, T)
    pad = tkw // 2
    xp = torch.nn.functional.pad(x, (pad, pad))
    Tout = T + 2 * pad - tkw + 1
    wins = torch.stack([xp[:, :, t: t + tkw] for t in range(Tout)], dim=1)
    h = torch.relu(_prec.einsum("btcw,hcw->bht", wins, trunk["conv1"]))
    return torch.relu(_prec.einsum("bht,ght->bg", h, trunk["conv2"]))


@dataclass(frozen=True)
class VanillaSingleObjective:
    """Unsupervised factor weighting embedder."""

    num_series: int
    num_in_timesteps: int
    num_factor_scores: int
    hidden: int
    use_sigmoid_restriction: bool = True
    sigmoid_eccentricity_coeff: float = 10.0

    def init(self, generator, device="cpu"):
        return {
            "trunk": _init_trunk(generator, self.num_series,
                                 self.num_in_timesteps, self.hidden, device),
            "head": _uniform_fanin(generator,
                                   (self.hidden, self.num_factor_scores),
                                   self.hidden, device),
        }

    def apply(self, params, X, use_final_activation=True):
        emb = _apply_trunk(params["trunk"], X, self.num_series,
                           self.num_in_timesteps)
        scores = _prec.matmul(emb, params["head"])
        if self.use_sigmoid_restriction:
            scores = _sigmoid_restrict(scores,
                                       self.sigmoid_eccentricity_coeff)
        return scores, None


@dataclass(frozen=True)
class VanillaMultiObjective:
    """Supervised+unsupervised embedder: supervised scores are the first
    num_out_classes embedding dims; class logits share those dims."""

    num_series: int
    num_in_timesteps: int
    num_factor_scores: int
    num_out_classes: int
    hidden: int
    use_sigmoid_restriction: bool = True
    sigmoid_eccentricity_coeff: float = 10.0

    def init(self, generator, device="cpu"):
        p = {"trunk": _init_trunk(generator, self.num_series,
                                  self.num_in_timesteps, self.hidden,
                                  device)}
        n_unsup = self.num_factor_scores - self.num_out_classes
        if n_unsup > 0:
            p["unsup_head"] = _uniform_fanin(
                generator, (self.hidden - self.num_out_classes, n_unsup),
                self.hidden - self.num_out_classes, device)
        return p

    def apply(self, params, X, use_final_activation=True):
        emb = _apply_trunk(params["trunk"], X, self.num_series,
                           self.num_in_timesteps)
        sup = emb[:, : self.num_out_classes]
        if self.num_factor_scores - self.num_out_classes > 0:
            unsup = _prec.matmul(emb[:, self.num_out_classes:],
                                 params["unsup_head"])
            scores = torch.cat([sup, unsup], dim=1)
        else:
            scores = sup
        logits = emb[:, : self.num_out_classes]
        if self.use_sigmoid_restriction:
            scores = _sigmoid_restrict(scores,
                                       self.sigmoid_eccentricity_coeff)
            if use_final_activation:
                # class logits get a plain sigmoid without eccentricity
                logits = torch.sigmoid(logits)
        return scores, logits


@dataclass(frozen=True)
class CEmbedder:
    """One cMLP-style network per factor prediction, K-stacked; exposes a
    (K, C[, L]) GC readout from first-layer norms."""

    num_chans: int
    num_class_preds: int
    num_factor_preds: int
    use_sigmoid_restriction: bool
    sigmoid_eccentricity_coeff: float
    lag: int
    hidden: tuple
    wavelet_level: int | None = None

    @property
    def num_series(self):
        if self.wavelet_level is not None:
            return self.num_chans * (self.wavelet_level + 1)
        return self.num_chans

    def init(self, generator, device="cpu"):
        nets = [cmlp_mod.init_mlp_params(generator, self.num_series,
                                         self.lag, list(self.hidden), device)
                for _ in range(self.num_factor_preds)]
        stacked = [{k: torch.stack([net[i][k] for net in nets])
                    for k in nets[0][i]} for i in range(len(nets[0]))]
        return {"nets": stacked}

    def apply(self, params, X, use_final_activation=True):
        """X: (B, T, C) with T == lag: each factor's MLP emits one scalar;
        the concatenation is the weighting vector."""
        out = cmlp_mod.mlp_forward(params["nets"], X)     # (K, B, T', 1)
        weightings = out[:, :, -1, 0].transpose(0, 1)     # (B, K)
        logits = None
        if self.num_class_preds > 0:
            logits = weightings[:, : self.num_class_preds]
            if use_final_activation and self.use_sigmoid_restriction:
                logits = torch.sigmoid(logits)
        if self.use_sigmoid_restriction:
            weightings = _sigmoid_restrict(weightings,
                                           self.sigmoid_eccentricity_coeff)
        return weightings, logits

    def gc(self, params, threshold=False, ignore_lag=True,
           combine_wavelet_representations=False, rank_wavelets=False):
        """(K, C[, L]) first-layer norms per factor network."""
        w0 = params["nets"][0]["w"]  # (K, H, C, L)
        if ignore_lag:
            G = torch.sqrt(torch.sum(w0 * w0, dim=(1, 3)))
        else:
            G = torch.sqrt(torch.sum(w0 * w0, dim=1))
        if rank_wavelets:
            if self.wavelet_level is None:
                raise ValueError("rank_wavelets needs a wavelet_level")
            mask = self._wavelet_mask(G.device)
            G = mask * G if ignore_lag else mask[:, :, None] * G
        if self.wavelet_level is not None and combine_wavelet_representations:
            w = self.num_series // self.num_chans
            if ignore_lag:
                G = G.reshape(G.shape[0], self.num_chans, w).sum(dim=2)
            else:
                G = G.reshape(G.shape[0], self.num_chans, w,
                              G.shape[-1]).sum(dim=2)
        if threshold:
            return (G > 0).to(torch.int32)
        return G

    def _wavelet_mask(self, device):
        """(K, num_series) ranking mask."""
        w = self.num_series // self.num_chans
        if w != 4:
            raise ValueError("the wavelet ranking supports 4 wavelets per "
                             "channel")
        rank_factor = w // 4
        col = 1.3 ** (2.0 * (rank_factor
                             - 1.0 * (np.arange(self.num_series) % w)))
        row = np.full(self.num_factor_preds, 1.3 ** (2.0 * rank_factor))
        return torch.tensor(row[:, None] * col[None, :], dtype=torch.float32,
                            device=device)


@dataclass(frozen=True)
class DGCNNEmbedder:
    """DGCNN-backed embedder. Input is node-major (B, C, T)."""

    num_channels: int
    num_wavelets_per_chan: int
    num_features_per_node: int
    num_graph_conv_layers: int
    num_hidden_nodes: int
    sigmoid_eccentricity_coeff: float
    use_sigmoid_restriction: bool
    num_factors: int
    num_classes: int

    def _cfg(self):
        return dgcnn_mod.DGCNNConfig(
            num_channels=self.num_channels,
            num_wavelets_per_chan=self.num_wavelets_per_chan,
            num_features_per_node=self.num_features_per_node,
            num_graph_conv_layers=self.num_graph_conv_layers,
            num_hidden_nodes=self.num_hidden_nodes,
            num_classes=self.num_factors,
        )

    def init(self, generator, device="cpu"):
        return dgcnn_mod.init_dgcnn_params(generator, self._cfg(), device)

    def apply(self, params, X, use_final_activation=True):
        """X: (B, N, F) node-major."""
        if X.shape[2] != self.num_features_per_node:
            X = X.transpose(1, 2)
        weightings = dgcnn_mod.dgcnn_forward(params, X)
        logits = None
        if self.num_classes > 0:
            logits = weightings[:, : self.num_classes]
            if use_final_activation and self.use_sigmoid_restriction:
                logits = torch.sigmoid(logits)
        if self.use_sigmoid_restriction:
            weightings = _sigmoid_restrict(weightings,
                                           self.sigmoid_eccentricity_coeff)
        return weightings, logits

    def gc(self, params, threshold=False, combine_node_feature_edges=False):
        return dgcnn_mod.dgcnn_gc(
            params, self._cfg(), threshold=threshold,
            combine_node_feature_edges=combine_node_feature_edges)


def build_embedder(embedder_type, *, num_chans, num_series, embed_lag,
                   embed_hidden_sizes, num_factors, num_supervised_factors,
                   use_sigmoid_restriction, sigmoid_eccentricity_coeff=10.0,
                   wavelet_level=None, dgcnn_args=None):
    """Embedder factory, the same dispatch as the JAX package."""
    if embedder_type == "Vanilla_Embedder":
        if num_supervised_factors > 0:
            return VanillaMultiObjective(
                num_series=num_series, num_in_timesteps=embed_lag,
                num_factor_scores=num_factors,
                num_out_classes=num_supervised_factors,
                hidden=embed_hidden_sizes[0],
                use_sigmoid_restriction=use_sigmoid_restriction,
                sigmoid_eccentricity_coeff=sigmoid_eccentricity_coeff,
            )
        return VanillaSingleObjective(
            num_series=num_series, num_in_timesteps=embed_lag,
            num_factor_scores=num_factors, hidden=embed_hidden_sizes[0],
            use_sigmoid_restriction=use_sigmoid_restriction,
            sigmoid_eccentricity_coeff=sigmoid_eccentricity_coeff,
        )
    if embedder_type == "cEmbedder":
        return CEmbedder(
            num_chans=num_chans, num_class_preds=num_supervised_factors,
            num_factor_preds=num_factors,
            use_sigmoid_restriction=use_sigmoid_restriction,
            sigmoid_eccentricity_coeff=sigmoid_eccentricity_coeff,
            lag=embed_lag, hidden=tuple(embed_hidden_sizes),
            wavelet_level=wavelet_level,
        )
    if embedder_type == "DGCNN":
        args = dgcnn_args or {}
        return DGCNNEmbedder(
            num_channels=num_chans,
            num_wavelets_per_chan=((wavelet_level + 1)
                                   if wavelet_level is not None else 1),
            num_features_per_node=args.get("num_features_per_node",
                                           embed_lag),
            num_graph_conv_layers=args.get("num_graph_conv_layers", 2),
            num_hidden_nodes=args.get("num_hidden_nodes", 32),
            sigmoid_eccentricity_coeff=sigmoid_eccentricity_coeff,
            use_sigmoid_restriction=use_sigmoid_restriction,
            num_factors=num_factors, num_classes=num_supervised_factors,
        )
    raise NotImplementedError(f"factor_score_embedder_type == {embedder_type}")
