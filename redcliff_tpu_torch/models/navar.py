"""NAVAR — Neural Additive Vector AutoRegression, MLP and LSTM variants
(port of ``models/navar.py``).

Each source node feeds its own small network whose outputs are additive
contributions to every target node's next value; predictions are the
contribution sums plus a bias, and the causal-score matrix is the standard
deviation of each contribution stream over the data (``causal_matrix[j,
i]`` scores source j driving target i). The per-node networks are one
weight block each, so the MLP variant is a few batched einsums and the
LSTM variant one recurrence per layer over the node axis
(``models/clstm.py`` ``lstm_recurrence``).

Dropout: the JAX package draws its masks from ``jax.random``, which torch
cannot reproduce. Here a mask comes from a ``torch.Generator`` on the
data's device that the trainer hands ``loss`` each step (``rng``); the
keep rate and the ``1/keep`` scaling are the JAX package's. ``rng=None``
is eval mode. Parity with JAX holds at dropout 0, the published value.

The contractions go through ``utils/precision.py`` (``_prec.einsum``):
``torch.einsum`` itself outside a bf16 matmul context, bf16-rounded
operands with float32 sums inside one (``precision_mode="mixed"``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from redcliff_tpu_torch.models.clstm import lstm_recurrence
from redcliff_tpu_torch.utils import precision as _prec

__all__ = ["NAVARConfig", "NAVAR", "NAVARLSTMConfig", "NAVARLSTM"]


def _uniform(generator, shape, bound, device):
    r = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (r * (2.0 * bound) - bound).to(device)


def _dropout(h, keep, rng):
    """Inverted dropout at keep rate ``keep`` from the generator ``rng``."""
    mask = torch.rand(h.shape, generator=rng, dtype=h.dtype,
                      device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))


@dataclass(frozen=True)
class NAVARConfig:
    num_nodes: int
    num_hidden: int
    maxlags: int
    hidden_layers: int = 1
    dropout: float = 0.0
    lambda1: float = 0.0


class NAVAR:
    """MLP variant: per-node lag window -> hidden -> N contributions."""

    gc_requires_data = True

    def __init__(self, config: NAVARConfig):
        self.config = config

    @property
    def wants_rng(self):
        return self.config.dropout > 0.0

    def init(self, generator, device="cpu"):
        """The JAX init's distributions (torch's grouped-conv defaults)."""
        cfg = self.config
        N, H, L = cfg.num_nodes, cfg.num_hidden, cfg.maxlags

        def u(shape, bound):
            return _uniform(generator, shape, bound, device)

        params = {
            "w1": u((N, H, L), 1.0 / math.sqrt(L)),
            "b1": u((N, H), 1.0 / math.sqrt(L)),
            "hidden": [],
            "bias": torch.full((N,), 1e-4, device=device),
        }
        for _ in range(cfg.hidden_layers - 1):
            params["hidden"].append({"w": u((N, H, H), 1.0 / math.sqrt(H)),
                                     "b": u((N, H), 1.0 / math.sqrt(H))})
        params["wc"] = u((N, N, H), 1.0 / math.sqrt(H))
        params["bc"] = u((N, N), 1.0 / math.sqrt(H))
        return params

    def forward(self, params, Xw, rng=None):
        """``Xw (B, L, N)`` lag windows -> (predictions (B, N),
        contributions (B, N_src, N_tgt))."""
        keep = 1.0 - self.config.dropout
        drop = self.config.dropout > 0.0 and rng is not None
        h = torch.relu(_prec.einsum("bln,nhl->bnh", Xw, params["w1"])
                       + params["b1"])
        if drop:
            h = _dropout(h, keep, rng)
        for layer in params["hidden"]:
            h = torch.relu(_prec.einsum("bnh,ngh->bng", h, layer["w"])
                           + layer["b"])
            if drop:
                h = _dropout(h, keep, rng)
        contributions = _prec.einsum("bnh,nmh->bnm", h, params["wc"]) \
            + params["bc"]
        return torch.sum(contributions, dim=1) + params["bias"], \
            contributions

    def _windows(self, X):
        """Every (lag window -> next step) pair of a raw batch (B, T, N)."""
        L = self.config.maxlags
        B, T, N = X.shape
        n = T - L
        Xw = X[:, :T - 1, :].unfold(1, L, 1)             # (B, n, N, L)
        return (Xw.transpose(-1, -2).reshape(B * n, L, N),
                X[:, L:, :].reshape(B * n, N))

    def loss(self, params, X, rng=None):
        """MSE of the next-step predictions plus the contribution L1
        (lambda1 / N times the mean over windows of the summed absolute
        contributions). ``rng`` turns dropout on."""
        cfg = self.config
        Xw, Yt = self._windows(X)
        preds, contributions = self.forward(params, Xw, rng)
        loss_pred = torch.mean((preds - Yt) ** 2)
        loss_l1 = (cfg.lambda1 / cfg.num_nodes) * torch.mean(
            torch.sum(torch.abs(contributions), dim=(1, 2)))
        return loss_pred + loss_l1, {"forecasting_loss": loss_pred,
                                     "contribution_l1": loss_l1}

    def causal_matrix(self, params, X):
        """Unbiased std of each contribution stream over all windows of
        ``X``: (N_src, N_tgt)."""
        Xw, _ = self._windows(X)
        _, contributions = self.forward(params, Xw)
        return torch.std(contributions, dim=0, correction=1)

    def gc(self, params, X=None, threshold=False, ignore_lag=True,
           combine_wavelet_representations=False, rank_wavelets=False):
        """The causal matrix in a list, in the (source, target)
        orientation; NAVAR's scores are statistics over data, so ``X`` is
        required."""
        if X is None:
            raise ValueError("NAVAR GC estimates require data (X)")
        cm = self.causal_matrix(params, X)
        if threshold:
            cm = (cm > 0).to(torch.int32)
        return [cm if ignore_lag else cm[:, :, None]]

    def normalization_coeffs(self):
        return {}


@dataclass(frozen=True)
class NAVARLSTMConfig:
    num_nodes: int
    num_hidden: int
    maxlags: int
    hidden_layers: int = 1
    dropout: float = 0.0
    lambda1: float = 0.0


class NAVARLSTM:
    """LSTM variant: one stacked LSTM per source node over its scalar
    series, a linear head emitting N contributions per step."""

    gc_requires_data = True

    def __init__(self, config: NAVARLSTMConfig):
        self.config = config

    @property
    def wants_rng(self):
        return self.config.dropout > 0.0

    def init(self, generator, device="cpu"):
        cfg = self.config
        N, H = cfg.num_nodes, cfg.num_hidden
        bound = 1.0 / math.sqrt(H)

        def u(shape):
            return _uniform(generator, shape, bound, device)

        layers = []
        for layer in range(cfg.hidden_layers):
            d_in = 1 if layer == 0 else H
            layers.append({"w_ih": u((N, 4 * H, d_in)),
                           "w_hh": u((N, 4 * H, H)),
                           "b": u((N, 4 * H)) + u((N, 4 * H))})
        return {"lstm": layers,
                "fc": {"w": u((N, H, N)), "b": u((N, N))},
                "bias": torch.full((N,), 1e-4, device=device)}

    def forward(self, params, Xw, rng=None):
        """``Xw (B, T, N)`` -> (predictions (B, T, N_tgt), contributions
        (B, T, N_src, N_tgt)). ``rng`` turns on the dropout after every
        layer but the last (torch ``nn.LSTM`` semantics)."""
        cfg = self.config
        keep = 1.0 - cfg.dropout
        x = Xw.transpose(0, 1)[..., None]                 # (T, B, N, 1)
        n_layers = len(params["lstm"])
        for li, layer in enumerate(params["lstm"]):
            zx = _prec.einsum("tbnd,ngd->tbng", x, layer["w_ih"]) \
                + layer["b"]
            x, _ = lstm_recurrence(zx, layer["w_hh"])     # (T, B, N, H)
            if cfg.dropout > 0.0 and rng is not None and li < n_layers - 1:
                x = _dropout(x, keep, rng)
        contributions = _prec.einsum("tbnh,nhm->btnm", x,
                                     params["fc"]["w"]) + params["fc"]["b"]
        return torch.sum(contributions, dim=2) + params["bias"], \
            contributions

    def loss(self, params, X, rng=None):
        """The LSTM over ``X[:, :-1]`` whole, the MSE at the final step and
        the contribution L1 over every step."""
        cfg = self.config
        preds, contributions = self.forward(params, X[:, :-1, :], rng)
        loss_pred = torch.mean((preds[:, -1, :] - X[:, -1, :]) ** 2)
        B, T = contributions.shape[:2]
        loss_l1 = (cfg.lambda1 / cfg.num_nodes) * torch.mean(torch.sum(
            torch.abs(contributions.reshape(B * T, -1)), dim=1))
        return loss_pred + loss_l1, {"forecasting_loss": loss_pred,
                                     "contribution_l1": loss_l1}

    def causal_matrix(self, params, X):
        """Unbiased std over (batch x time) of the (N, N) contribution
        streams of the full sequences."""
        _, contributions = self.forward(params, X[:, :-1, :])
        N = self.config.num_nodes
        return torch.std(contributions.reshape(-1, N, N), dim=0,
                         correction=1)

    def gc(self, params, X=None, threshold=False, ignore_lag=True,
           combine_wavelet_representations=False, rank_wavelets=False):
        """See :meth:`NAVAR.gc`."""
        if X is None:
            raise ValueError("NAVARLSTM GC estimates require data (X)")
        cm = self.causal_matrix(params, X)
        if threshold:
            cm = (cm > 0).to(torch.int32)
        return [cm if ignore_lag else cm[:, :, None]]

    def normalization_coeffs(self):
        return {}
