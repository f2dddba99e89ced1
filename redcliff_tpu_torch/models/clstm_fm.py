"""cLSTM_FM — the single-factor cLSTM forecaster baseline (port of
``models/clstm_fm.py``).

A cLSTM (one LSTM per series, tensorized in ``models/clstm.py``) trained
teacher-forced on overlapping context windows, with Adam and an L1
adjacency penalty in the loss. The prox is optional and plain PyTorch (the
cLSTM's column-group soft-threshold is no TPU kernel in the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from redcliff_tpu_torch.models import clstm as clstm_mod
from redcliff_tpu_torch.models import cmlp as cmlp_mod
from redcliff_tpu_torch.ops import losses as L

__all__ = ["CLSTMFMConfig", "CLSTMFM", "arrange_input"]


def arrange_input(X, context):
    """Overlapping teacher-forcing windows: ``X (B, T, C)`` -> (inputs,
    targets), both ``(B*(T-context), context, C)``; the target window is
    the input window shifted one step forward."""
    if context < 1:
        raise ValueError(f"context must be >= 1, got {context}")
    B, T, C = X.shape
    n = T - context
    inp = X[:, :T - 1, :].unfold(1, context, 1)       # (B, n, C, context)
    tgt = X[:, 1:, :].unfold(1, context, 1)
    return (inp.transpose(-1, -2).reshape(B * n, context, C),
            tgt.transpose(-1, -2).reshape(B * n, context, C))


@dataclass(frozen=True)
class CLSTMFMConfig:
    num_chans: int
    gen_hidden: int
    context: int
    max_input_length: int | None = None
    forecast_coeff: float = 1.0
    adj_l1_coeff: float = 0.0
    dagness_coeff: float = 0.0  # defined but unused by the loss
    wavelet_level: int | None = None

    @property
    def num_series(self):
        if self.wavelet_level is not None:
            return self.num_chans * (self.wavelet_level + 1)
        return self.num_chans


class CLSTMFM:
    """Functional model over ``{"factor": <cLSTM tree>}``."""

    def __init__(self, config: CLSTMFMConfig):
        self.config = config

    def init(self, generator, device="cpu"):
        cfg = self.config
        return {"factor": clstm_mod.init_clstm_params(
            generator, cfg.num_series, cfg.gen_hidden, device)}

    def forward(self, params, X_in, hidden=None):
        """Teacher-forced predictions over a context window: (B', ctx, C)
        -> ((B', ctx, C), (h, c))."""
        return clstm_mod.clstm_forward(params["factor"], X_in, hidden)

    def gc(self, params, threshold=False, ignore_lag=True,
           combine_wavelet_representations=False, rank_wavelets=False):
        """One GC estimate in a list: (C, C), with a trailing singleton
        lag axis when ``ignore_lag`` is False."""
        cfg = self.config
        mask = None
        if rank_wavelets and cfg.wavelet_level is not None:
            mask = cmlp_mod.build_wavelet_ranking_mask(
                cfg.num_series,
                wavelets_per_chan=cfg.num_series // cfg.num_chans,
                device=params["factor"]["w_ih"].device)
        g = clstm_mod.clstm_gc(
            params["factor"], threshold=threshold, wavelet_mask=mask,
            rank_wavelets=rank_wavelets, num_chans=cfg.num_chans,
            combine_wavelet_representations=combine_wavelet_representations)
        return [g if ignore_lag else g[:, :, None]]

    def loss(self, params, X):
        """Context-windowed teacher-forced forecasting MSE summed per
        channel, plus the L1 of the GC estimate."""
        cfg = self.config
        if cfg.max_input_length is not None:
            X = X[:, : cfg.max_input_length, :]
        X_in, X_tgt = arrange_input(X, cfg.context)
        preds, _ = self.forward(params, X_in)
        forecasting = cfg.forecast_coeff * L.channelwise_forecast_mse(
            preds, X_tgt)
        adj_l1 = cfg.adj_l1_coeff * torch.sum(torch.abs(
            self.gc(params)[0]))
        return forecasting + adj_l1, {"forecasting_loss": forecasting,
                                      "adj_l1_penalty": adj_l1}

    def apply_prox(self, params, lam, lr, penalty="GL"):
        """GISTA prox on the input-hidden columns; GL only (an LSTM weight
        has no lag axis to group). Functional."""
        if penalty != "GL":
            raise ValueError(
                f"cLSTM prox supports only the 'GL' penalty (got {penalty!r})")
        return dict(params, factor=clstm_mod.clstm_prox_update(
            params["factor"], lam, lr))

    def apply_prox_(self, params, lam, lr, penalty="GL"):
        """:meth:`apply_prox` written into the live ``w_ih``. Call under
        ``torch.no_grad()``. Returns ``params``."""
        new = self.apply_prox(params, lam, lr, penalty)
        params["factor"]["w_ih"].copy_(new["factor"]["w_ih"])
        return params

    # ---- trainer protocol -------------------------------------------------
    def normalization_coeffs(self):
        return {"forecasting_loss": self.config.forecast_coeff,
                "adj_l1_penalty": self.config.adj_l1_coeff}

    def validation_criteria(self, params, val_metrics):
        """The L1 of the (unthresholded) GC estimate."""
        return torch.sum(torch.abs(self.gc(params)[0]))
