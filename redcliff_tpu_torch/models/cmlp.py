"""Tensorized cMLP Granger-causal forecaster (port of ``models/cmlp.py``).

The C per-series networks are one weight block batched over the
output-series axis, so the forward pass is two einsums:

    layer 0:  w (C_out, H, C_in, L), b (C_out, H)
    layer i:  w (C_out, H_out, H_in), b (C_out, H_out)       [1x1 convs]
    final layer has H_out == 1.

Every function also takes parameters with extra LEADING axes (the K
stacked factors of REDCLIFF-S, where the JAX package uses ``vmap``): the
einsums broadcast over them.

Lag-axis convention: weight index l multiplies input timestep t+l within a
window, so l == 0 touches the MOST-lagged value.

The contractions go through ``utils/precision.py`` (``_prec.einsum``):
``torch.einsum`` itself outside a bf16 matmul context, bf16-rounded
operands with float32 sums inside one (``precision_mode="mixed"``).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from redcliff_tpu_torch.utils import precision as _prec

__all__ = [
    "init_cmlp_params",
    "cmlp_forward",
    "cmlp_gc",
    "init_mlp_params",
    "mlp_forward",
    "lagged_windows",
    "build_wavelet_ranking_mask",
    "condense_wavelet_gc",
]


def _uniform(generator, shape, bound, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2.0 * bound) - bound).to(device)


def init_cmlp_params(generator, num_series: int, lag: int,
                     hidden: Sequence[int], device="cpu"):
    """Parameters for C per-series MLPs, the same distributions as the JAX
    package: layer 0 xavier-uniform, later layers and all biases torch's
    conv default U(±1/sqrt(fan_in)). Returns a list of {"w", "b"} dicts."""
    C = num_series
    dims = list(hidden) + [1]
    xavier = math.sqrt(6.0 / (C * lag + dims[0] * lag))
    layers = [{
        "w": _uniform(generator, (C, dims[0], C, lag), xavier, device),
        "b": _uniform(generator, (C, dims[0]), 1.0 / math.sqrt(C * lag),
                      device),
    }]
    d_in = dims[0]
    for d_out in dims[1:]:
        bound = 1.0 / math.sqrt(d_in)
        layers.append({"w": _uniform(generator, (C, d_out, d_in), bound,
                                     device),
                       "b": _uniform(generator, (C, d_out), bound, device)})
        d_in = d_out
    return layers


def init_mlp_params(generator, num_series: int, lag: int,
                    hidden: Sequence[int], device="cpu"):
    """Single MLP (one output stream): init_cmlp_params with the output-
    series axis stripped."""
    batched = init_cmlp_params(generator, num_series, lag, hidden, device)
    return [{k: v[0] for k, v in layer.items()} for layer in batched]


def lagged_windows(X, lag):
    """(..., B, T, C) -> (..., B, T-lag+1, C, L) sliding windows; window t
    covers steps [t, t+lag), so the window predicts step t+lag."""
    T = X.shape[-2]
    return torch.stack([X[..., l: T - lag + 1 + l, :] for l in range(lag)],
                       dim=-1)


def cmlp_forward(params, X):
    """Every output series at once: ``X (..., B, T, C)`` with ``T >= lag``
    -> ``(..., B, T-lag+1, C)`` one-step predictions. Leading axes of the
    parameters and of ``X`` broadcast against each other."""
    w0 = params[0]["w"]
    lag = w0.shape[-1]
    Xw = lagged_windows(X, lag)                       # (..., B, T', C_in, L)
    h = _prec.einsum("...btcl,...ohcl->...btoh", Xw, w0) \
        + params[0]["b"].unsqueeze(-3).unsqueeze(-3)
    for layer in params[1:]:
        h = torch.relu(h)
        h = _prec.einsum("...btoh,...ogh->...btog", h, layer["w"]) \
            + layer["b"].unsqueeze(-3).unsqueeze(-3)
    return h[..., 0]


def mlp_forward(params, X):
    """Single-MLP forward: (B, T, C) -> (..., B, T-lag+1, 1), through
    cmlp_forward with a singleton output-series axis."""
    batched = []
    for i, layer in enumerate(params):
        w_axis = -4 if i == 0 else -3
        batched.append({"w": layer["w"].unsqueeze(w_axis),
                        "b": layer["b"].unsqueeze(-2)})
    return cmlp_forward(batched, X)


def cmlp_gc(params, threshold=False, ignore_lag=True, wavelet_mask=None,
            rank_wavelets=False, num_chans=None,
            combine_wavelet_representations=False):
    """Granger-causal readout: norms of the layer-0 block over H[, L].
    Returns (..., C_out, C_in) if ignore_lag else (..., C_out, C_in, L)."""
    w0 = params[0]["w"]  # (..., C_out, H, C_in, L)
    if ignore_lag:
        GC = torch.sqrt(torch.sum(w0 * w0, dim=(-3, -1)))
    else:
        GC = torch.sqrt(torch.sum(w0 * w0, dim=-3))
    if rank_wavelets:
        if wavelet_mask is None:
            raise ValueError("rank_wavelets needs a wavelet_mask")
        GC = wavelet_mask * GC if ignore_lag else wavelet_mask[:, :, None] * GC
    ns_axis = -2 if ignore_lag else -3
    if (combine_wavelet_representations and num_chans is not None
            and GC.shape[ns_axis] != num_chans):
        GC = condense_wavelet_gc(GC, num_chans, lagged=not ignore_lag)
    if threshold:
        return (GC > 0).to(torch.int32)
    return GC


def build_wavelet_ranking_mask(num_series, wavelets_per_chan=4,
                               device="cpu"):
    """Wavelet-ranking mask weighting low-frequency bands up:
    mask[i, j] = 1.3^(2*(r - i%w)) * 1.3^(2*(r - j%w)) with r = w // 4."""
    if wavelets_per_chan != 4:
        raise ValueError("the wavelet ranking supports 4 wavelets per channel")
    rank_factor = wavelets_per_chan // 4
    idx = np.arange(num_series) % wavelets_per_chan
    row = 1.3 ** (2.0 * (rank_factor - 1.0 * idx))
    return torch.tensor(row[:, None] * row[None, :], dtype=torch.float32,
                        device=device)


def condense_wavelet_gc(GC, num_chans, lagged=None):
    """Sum wavelet-band blocks down to channel granularity (block stride
    num_series // num_chans). ``GC`` is (..., ns, ns) or, with ``lagged``,
    (..., ns, ns, L); ``lagged=None`` reads 2-D as unlagged and 3-D as
    lagged, like the JAX function."""
    if lagged is None:
        lagged = GC.dim() == 3
    lead = GC.shape[:-3] if lagged else GC.shape[:-2]
    ns = GC.shape[-2] if lagged else GC.shape[-1]
    w = ns // num_chans
    tail = (GC.shape[-1],) if lagged else ()
    n = len(lead)
    blocks = GC.reshape(lead + (num_chans, w, num_chans, w) + tail)
    return blocks.sum(dim=(n + 1, n + 3))
