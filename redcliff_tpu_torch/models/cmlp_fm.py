"""cMLP_FM — the single-factor cMLP forecaster baseline (port of
``models/cmlp_fm.py``).

A cMLP rolled out autoregressively for ``num_sims`` steps, trained on the
channelwise forecasting MSE plus an L1 adjacency penalty on the unlagged
GC estimate. The GISTA prox is optional (``TrainConfig.prox_penalty``):
the trainer calls :meth:`CMLPFM.apply_prox_`, which updates the live
first-layer block in place through the GL prox kernel on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from redcliff_tpu_torch.models import cmlp as cmlp_mod
from redcliff_tpu_torch.ops import losses as L
from redcliff_tpu_torch.ops.pallas_prox import gl_prox, gl_prox_

__all__ = ["CMLPFMConfig", "CMLPFM"]


@dataclass(frozen=True)
class CMLPFMConfig:
    num_chans: int
    gen_lag: int
    gen_hidden: Tuple[int, ...]
    input_length: int
    num_sims: int = 1
    forecast_coeff: float = 1.0
    adj_l1_coeff: float = 0.0
    wavelet_level: int | None = None

    @property
    def num_series(self):
        if self.wavelet_level is not None:
            return self.num_chans * (self.wavelet_level + 1)
        return self.num_chans

    @property
    def sim_output_length(self):
        """Per-sim prediction length: the cMLP emits T-lag+1 steps per
        window."""
        return self.input_length - self.gen_lag + 1

    @property
    def total_output_length(self):
        return self.num_sims * self.sim_output_length


class CMLPFM:
    """Functional model over ``{"factor": [{"w", "b"}, ...]}``, the JAX
    package's tree."""

    def __init__(self, config: CMLPFMConfig):
        self.config = config

    def init(self, generator, device="cpu"):
        """Fresh parameters from a CPU ``torch.Generator`` with the JAX
        init's distributions, placed on ``device``."""
        cfg = self.config
        return {"factor": cmlp_mod.init_cmlp_params(
            generator, cfg.num_series, cfg.gen_lag, list(cfg.gen_hidden),
            device)}

    def forward(self, params, X_in):
        """Autoregressive multi-sim forecast: ``X_in (B, input_length, C)``
        -> ``(B, num_sims * T', C)`` with ``T' = input_length - lag + 1``;
        each sim's window is the last one shifted by T' with its
        predictions appended."""
        window = X_in
        sims = []
        for _ in range(self.config.num_sims):
            preds = cmlp_mod.cmlp_forward(params["factor"], window)
            sims.append(preds)
            Tp = preds.shape[1]
            if Tp == window.shape[1]:
                window = preds
            else:
                window = torch.cat([window[:, Tp:, :], preds], dim=1)
        return torch.cat(sims, dim=1)

    def gc(self, params, threshold=False, ignore_lag=True,
           combine_wavelet_representations=False, rank_wavelets=False):
        """One GC estimate in a list: (C, C), or (C, C, L) lagged."""
        cfg = self.config
        mask = None
        if rank_wavelets and cfg.wavelet_level is not None:
            mask = cmlp_mod.build_wavelet_ranking_mask(
                cfg.num_series,
                wavelets_per_chan=cfg.num_series // cfg.num_chans,
                device=params["factor"][0]["w"].device)
        return [cmlp_mod.cmlp_gc(
            params["factor"], threshold=threshold, ignore_lag=ignore_lag,
            wavelet_mask=mask, rank_wavelets=rank_wavelets,
            num_chans=cfg.num_chans,
            combine_wavelet_representations=combine_wavelet_representations)]

    def loss(self, params, X):
        """The combined loss on a raw batch ``X (B, T, C)`` with ``T >=
        input_length + total_output_length``: forecasting MSE summed per
        channel and the L1 of the unlagged GC."""
        cfg = self.config
        preds = self.forward(params, X[:, : cfg.input_length, :])
        targets = X[:, cfg.input_length: cfg.input_length
                    + cfg.total_output_length, :]
        forecasting = cfg.forecast_coeff * L.channelwise_forecast_mse(
            preds, targets)
        adj_l1 = cfg.adj_l1_coeff * torch.sum(torch.abs(
            self.gc(params, ignore_lag=True)[0]))
        return forecasting + adj_l1, {"forecasting_loss": forecasting,
                                      "adj_l1_penalty": adj_l1}

    def apply_prox(self, params, lam, lr, penalty="GL"):
        """GISTA prox on the first-layer block (C_out, H, C_in, L); GL on
        the card is the CUDA kernel. Functional: returns a new tree."""
        new_w = gl_prox(params["factor"][0]["w"], lam, lr, penalty)
        factor = [dict(params["factor"][0], w=new_w)] \
            + list(params["factor"][1:])
        return dict(params, factor=factor)

    def apply_prox_(self, params, lam, lr, penalty="GL"):
        """:meth:`apply_prox` in place on ``params["factor"][0]["w"]``: on
        the card one kernel launch with no allocation or copy (the trainer
        keeps every other tree as a copy). Call under ``torch.no_grad()``.
        Returns ``params``."""
        gl_prox_(params["factor"][0]["w"], lam, lr, penalty)
        return params

    # ---- trainer protocol -------------------------------------------------
    def normalization_coeffs(self):
        return {"forecasting_loss": self.config.forecast_coeff,
                "adj_l1_penalty": self.config.adj_l1_coeff}

    def validation_criteria(self, params, val_metrics):
        """The max-normalized lagged GC's L1 plus the validation
        forecasting loss."""
        gc = self.gc(params, ignore_lag=False)[0]
        gc = gc / torch.clamp_min(torch.max(gc), 1e-12)
        return torch.sum(torch.abs(gc)) + val_metrics["forecasting_loss"]
