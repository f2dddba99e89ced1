"""Tensorized cLSTM Granger-causal forecaster (port of ``models/clstm.py``).

The C per-series LSTMs are one stacked weight block:

    w_ih: (S, 4H, C)   input->gate weights, gate order (i, f, g, o)
    w_hh: (S, 4H, H)   hidden->gate weights
    b:    (S, 4H)      merged input+hidden bias
    head: w (S, H), b (S,)   the Conv1d(hidden, 1, 1) readout per series

The input projection for every series and timestep is one einsum; the
recurrence is a loop over T of the small recurrent einsum and the gate
math (the JAX package's ``lax.scan``). The gates are written out rather
than run through ``torch.nn.LSTM``: its weight layout and split biases
differ from this tree, and parity is held by copied weights.

Every function also takes parameters with extra LEADING axes (the K
stacked factors of REDCLIFF-S, where the JAX package uses ``vmap``), and
an input with its own leading axes; the einsums broadcast over them.

The Granger-causal readout is the column norm of ``w_ih`` over the gate
axis; the proximal update soft-thresholds the same column groups. Both are
plain PyTorch here, as they are plain ``jnp`` in the JAX package.
"""
from __future__ import annotations

import math

import torch

from redcliff_tpu_torch.models import cmlp as cmlp_mod
from redcliff_tpu_torch.ops.prox import soft_threshold_by_group_norm

__all__ = ["init_clstm_params", "lstm_recurrence", "clstm_forward",
           "clstm_gc", "clstm_prox_update"]


def init_clstm_params(generator, num_series: int, hidden: int,
                      device="cpu"):
    """C per-series LSTMs as one tree, the JAX init's distributions: every
    LSTM weight U(±1/sqrt(hidden)), the merged bias the sum of two such
    draws (torch's separate b_ih and b_hh), the head U(±1/sqrt(hidden))."""
    S = num_series
    bound = 1.0 / math.sqrt(hidden)

    def u(shape):
        r = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (r * (2.0 * bound) - bound).to(device)

    return {
        "w_ih": u((S, 4 * hidden, num_series)),
        "w_hh": u((S, 4 * hidden, hidden)),
        "b": u((S, 4 * hidden)) + u((S, 4 * hidden)),
        "head": {"w": u((S, hidden)), "b": u((S,))},
    }


def lstm_recurrence(zx, w_hh, hidden=None):
    """The LSTM recurrence over precomputed input contributions ``zx
    (..., T, B, S, 4H)`` (bias included) with the per-series recurrent
    block ``w_hh (..., S, 4H, H)``: a loop over T of one einsum and the gate
    math, gate order (i, f, g, o). Returns ``(hs (..., T, B, S, H), (h,
    c))``; ``hidden`` is an optional ``(h, c)`` carry, else zeros."""
    H = w_hh.shape[-1]
    if hidden is None:
        shape = zx.shape[:-4] + zx.shape[-3:-1] + (H,)
        h = torch.zeros(shape, dtype=zx.dtype, device=zx.device)
        c = torch.zeros(shape, dtype=zx.dtype, device=zx.device)
    else:
        h, c = hidden
    hs = []
    for t in range(zx.shape[-4]):
        z = zx[..., t, :, :, :] + torch.einsum("...bsh,...sgh->...bsg",
                                               h, w_hh)
        zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        h = torch.sigmoid(zo) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=-4), (h, c)


def clstm_forward(params, X, hidden=None):
    """Every output series at once: ``X (..., B, T, C)`` -> ``(preds
    (..., B, T, S), (h, c))`` with ``h``, ``c`` of shape ``(..., B, S, H)``.
    ``hidden`` optionally continues a sequence from an ``(h, c)`` carry.
    Leading axes of the parameters and of ``X`` broadcast."""
    w_ih, w_hh, b = params["w_ih"], params["w_hh"], params["b"]
    # the input contributions of every series and step: (..., T, B, S, 4H)
    zx = torch.einsum("...btc,...sgc->...tbsg", X, w_ih) \
        + b.unsqueeze(-3).unsqueeze(-3)
    hs, (h, c) = lstm_recurrence(zx, w_hh, hidden)    # (..., T, B, S, H)
    head = params["head"]
    preds = torch.einsum("...tbsh,...sh->...bts", hs, head["w"]) \
        + head["b"].unsqueeze(-2).unsqueeze(-2)
    return preds, (h, c)


def clstm_gc(params, threshold=False, wavelet_mask=None, rank_wavelets=False,
             num_chans=None, combine_wavelet_representations=False):
    """Column norms of the input-hidden block over the gate axis:
    ``(..., C_out, C_in)``, entry (i, j) scoring series j driving i."""
    w = params["w_ih"]
    GC = torch.sqrt(torch.sum(w * w, dim=-2))
    if rank_wavelets:
        if wavelet_mask is None:
            raise ValueError("rank_wavelets needs a wavelet_mask")
        GC = wavelet_mask * GC
    if (combine_wavelet_representations and num_chans is not None
            and GC.shape[-2] != num_chans):
        GC = cmlp_mod.condense_wavelet_gc(GC, num_chans, lagged=False)
    if threshold:
        return (GC > 0).to(torch.int32)
    return GC


def clstm_prox_update(params, lam, lr):
    """Group soft-threshold of the input-hidden columns at ``lam * lr``.
    Functional: returns a new tree."""
    W = params["w_ih"]
    norm = torch.sqrt(torch.sum(W * W, dim=-2, keepdim=True))
    return dict(params, w_ih=soft_threshold_by_group_norm(W, norm, lam * lr))
