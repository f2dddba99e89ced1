"""Time-series transformer encoder (port of ``models/ts_transformer.py``).

The JAX module rebuilds the reference's vendored mvts_transformer
(Zerveas et al., KDD 2021): ``TSTransformerEncoder`` (masked-reconstruction
head) and ``TSTransformerEncoderClassiregressor`` (flattened masked pooling
into a linear class/regression head). Nothing in either package's pipeline
instantiates it; it is a usable module of its own.

The port keeps the JAX package's plain functions on a params dict, with the
same keys and shapes, so ``interop.params_from_jax`` carries JAX params
across unchanged:

- input projection × sqrt(d_model), plus the fixed sinusoid table or a
  learnable positional encoding;
- N encoder layers: multi-head self-attention (bias-free projections) and a
  feed-forward block, each followed by a residual and a norm, either
  ``LayerNorm`` or the mvts "BatchNorm" (each feature normalized over
  batch × time, population variance, functional batch statistics);
- exact-erf gelu (torch's default, as JAX's ``approximate=False``) or relu;
- the padding mask fills masked attention logits with ``finfo.min``.

Attention is plain PyTorch (``einsum`` and ``softmax``), as the JAX
module's is plain jnp: no TPU kernel is on this path. With ``seq_mesh``
(``parallel/sequence.py``, as in JAX) the time axis splits into one block
per mesh entry: attention runs as ring attention, the time-local layers
(projections, feed-forward, LayerNorm) run on each block's device, and
the mvts BatchNorm's batch × time statistics are summed over the blocks
on the first one, as the JAX mesh psums them; the output is joined on the
input's device. Padding masks are refused under ``seq_mesh``, as in JAX.

``init`` takes a ``torch.Generator`` and draws from the JAX init's
distributions; it places the params on ``cuda`` unless ``device`` is given,
and raises without a card and without a device. ``forward`` and ``loss``
run where the params are.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from redcliff_tpu_torch.utils.precision import resolve_device

__all__ = [
    "TSTransformerConfig",
    "TSTransformerEncoder",
    "TSTransformerEncoderClassiregressor",
    "init_ts_transformer_params",
    "ts_transformer_encode",
]

@dataclass(frozen=True)
class TSTransformerConfig:
    feat_dim: int
    max_len: int
    d_model: int
    n_heads: int
    num_layers: int
    dim_feedforward: int
    num_classes: int = 0          # 0 -> reconstruction head (encoder)
    pos_encoding: str = "fixed"   # {"fixed", "learnable"}
    activation: str = "gelu"      # {"gelu", "relu"}
    norm: str = "BatchNorm"       # {"BatchNorm", "LayerNorm"}

    def __post_init__(self):
        assert self.d_model % self.n_heads == 0
        assert self.pos_encoding in ("fixed", "learnable")
        assert self.activation in ("gelu", "relu")
        assert self.norm in ("BatchNorm", "LayerNorm")


def _act(cfg, x):
    # exact (erf) gelu: torch's default, as the JAX module asks for
    return F.gelu(x) if cfg.activation == "gelu" else F.relu(x)


def _uniform(generator, shape, bound, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2.0 * bound) - bound).to(device)


def _dense_init(generator, d_in, d_out, device):
    bound = 1.0 / math.sqrt(d_in)
    return {"w": _uniform(generator, (d_in, d_out), bound, device),
            "b": _uniform(generator, (d_out,), bound, device)}


@lru_cache(maxsize=32)
def _fixed_pos_encoding_np(max_len, d_model):
    """Sinusoidal table (ref FixedPositionalEncoding :37-60), float32, the
    JAX module's numpy table."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: pe[:, 1::2].shape[1]])
    return pe


@lru_cache(maxsize=32)
def _fixed_pos_encoding(max_len, d_model, device):
    """The table on ``device``, copied there once."""
    return torch.from_numpy(_fixed_pos_encoding_np(max_len, d_model)).to(
        device)


def init_ts_transformer_params(generator, cfg: TSTransformerConfig,
                               device=None):
    """Fresh params with the JAX init's distributions (uniform ±1/sqrt(d_in)
    weights and biases, unit/zero norm scales and shifts, learnable
    positions 0.02 · normal), drawn from a CPU ``torch.Generator`` and
    placed on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    params = {"project_inp": _dense_init(generator, cfg.feat_dim,
                                         cfg.d_model, dev)}
    if cfg.pos_encoding == "learnable":
        params["pos"] = (0.02 * torch.randn(
            (cfg.max_len, cfg.d_model), generator=generator,
            dtype=torch.float32)).to(dev)
    D, Hf = cfg.d_model, cfg.dim_feedforward
    bound = 1.0 / math.sqrt(D)
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            # attention projections carry no bias, as in JAX
            "wq": _uniform(generator, (D, D), bound, dev),
            "wk": _uniform(generator, (D, D), bound, dev),
            "wv": _uniform(generator, (D, D), bound, dev),
            "wo": _uniform(generator, (D, D), bound, dev),
            "ff1": _dense_init(generator, D, Hf, dev),
            "ff2": _dense_init(generator, Hf, D, dev),
            "norm1_scale": torch.ones(D, device=dev),
            "norm1_shift": torch.zeros(D, device=dev),
            "norm2_scale": torch.ones(D, device=dev),
            "norm2_shift": torch.zeros(D, device=dev),
        })
    params["layers"] = layers
    if cfg.num_classes > 0:
        params["output"] = _dense_init(generator, D * cfg.max_len,
                                       cfg.num_classes, dev)
    else:
        params["output"] = _dense_init(generator, D, cfg.feat_dim, dev)
    return params


def _norm(x, scale, shift, kind, eps=1e-5):
    if kind == "LayerNorm":
        dims = (-1,)
    else:
        # mvts "BatchNorm": each feature normalized over batch and time
        dims = (0, 1)
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps) * scale + shift


def _attention(layer, x, pad_mask, n_heads):
    """Batched multi-head self-attention. x: (B, T, D); pad_mask: (B, T)
    True = keep."""
    B, T, D = x.shape
    H, hd = n_heads, D // n_heads
    q = (x @ layer["wq"]).reshape(B, T, H, hd)
    k = (x @ layer["wk"]).reshape(B, T, H, hd)
    v = (x @ layer["wv"]).reshape(B, T, H, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if pad_mask is not None:
        neg = torch.finfo(x.dtype).min
        logits = torch.where(pad_mask[:, None, None, :].bool(), logits,
                             torch.full_like(logits, neg))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, D)
    return out @ layer["wo"]


def _block_norm(xs, scale, shift, kind, eps=1e-5):
    """:func:`_norm` over time blocks ``xs`` (one per mesh entry, each on
    its device): LayerNorm is per position; the mvts BatchNorm's mean and
    (population) variance over batch x time are sums of per-block partial
    sums, added on the first block's device in mesh order."""
    if kind == "LayerNorm":
        return [_norm(x, scale.to(x.device), shift.to(x.device), kind, eps)
                for x in xs]
    home = xs[0].device
    count = sum(x.shape[0] * x.shape[1] for x in xs)

    def total(parts):
        out = None
        for p in parts:
            p = p.to(home)
            out = p if out is None else out + p
        return out
    mean = total(x.sum(dim=(0, 1), keepdim=True) for x in xs) / count
    var = total(((x - mean.to(x.device)) ** 2).sum(dim=(0, 1), keepdim=True)
                for x in xs) / count
    return [(x - mean.to(x.device)) / torch.sqrt(var.to(x.device) + eps)
            * scale.to(x.device) + shift.to(x.device) for x in xs]


def _encode_blocks(params, cfg, X, mesh):
    """The encoder under sequence parallelism: X split into time blocks
    over ``mesh``, each block's time-local layers on its device, attention
    as ring attention; the blocks joined on X's device."""
    from redcliff_tpu_torch.interop import tree_map
    from redcliff_tpu_torch.parallel.sequence import (ring_attention,
                                                      sequence_gathered,
                                                      sequence_sharded)

    blocks = sequence_sharded(X, mesh)
    T_loc = blocks[0].shape[1]
    local = mesh.local_indices()
    # the params on every distinct device of the blocks
    on = {}
    for b in blocks:
        if str(b.device) not in on:
            on[str(b.device)] = tree_map(lambda t, _d=b.device: t.to(_d),
                                         params)
    P = [on[str(b.device)] for b in blocks]
    pos = (None if cfg.pos_encoding == "learnable"
           else _fixed_pos_encoding(cfg.max_len, cfg.d_model, X.device))
    xs = []
    for j, (i, b) in enumerate(zip(local, blocks)):
        p = P[j]
        x = (b @ p["project_inp"]["w"] + p["project_inp"]["b"]) \
            * math.sqrt(cfg.d_model)
        lo = i * T_loc
        if cfg.pos_encoding == "learnable":
            x = x + p["pos"][None, lo:lo + T_loc]
        else:
            x = x + pos[lo:lo + T_loc].to(b.device)[None]
        xs.append(x)
    B = X.shape[0]
    H = cfg.n_heads
    hd = cfg.d_model // H
    for li in range(len(params["layers"])):
        L = [p["layers"][li] for p in P]
        q = [(x @ l["wq"]).reshape(B, T_loc, H, hd) for x, l in zip(xs, L)]
        k = [(x @ l["wk"]).reshape(B, T_loc, H, hd) for x, l in zip(xs, L)]
        v = [(x @ l["wv"]).reshape(B, T_loc, H, hd) for x, l in zip(xs, L)]
        att = ring_attention(q, k, v, mesh)
        a = [o.reshape(B, T_loc, cfg.d_model) @ l["wo"]
             for o, l in zip(att, L)]
        xs = _block_norm([x + y for x, y in zip(xs, a)],
                         params["layers"][li]["norm1_scale"],
                         params["layers"][li]["norm1_shift"], cfg.norm)
        h = [_act(cfg, x @ l["ff1"]["w"] + l["ff1"]["b"]) @ l["ff2"]["w"]
             + l["ff2"]["b"] for x, l in zip(xs, L)]
        xs = _block_norm([x + y for x, y in zip(xs, h)],
                         params["layers"][li]["norm2_scale"],
                         params["layers"][li]["norm2_shift"], cfg.norm)
    return sequence_gathered([_act(cfg, x) for x in xs], mesh, X.device)


def ts_transformer_encode(params, cfg: TSTransformerConfig, X,
                          padding_masks=None, seq_mesh=None):
    """(B, T, feat_dim) -> (B, T, d_model) encoder embeddings
    (ref TSTransformerEncoder.forward :169-190 up to the output head).

    ``seq_mesh`` turns on sequence parallelism for long recordings (see the
    module docstring); T must divide by the mesh size."""
    if seq_mesh is not None:
        assert padding_masks is None, \
            "padding_masks unsupported under sequence parallelism"
        return _encode_blocks(params, cfg, X, seq_mesh)
    T = X.shape[1]
    x = (X @ params["project_inp"]["w"] + params["project_inp"]["b"]) \
        * math.sqrt(cfg.d_model)
    if cfg.pos_encoding == "learnable":
        x = x + params["pos"][None, :T]
    else:
        x = x + _fixed_pos_encoding(cfg.max_len, cfg.d_model,
                                    X.device)[None, :T]
    for layer in params["layers"]:
        a = _attention(layer, x, padding_masks, cfg.n_heads)
        x = _norm(x + a, layer["norm1_scale"], layer["norm1_shift"], cfg.norm)
        h = _act(cfg, x @ layer["ff1"]["w"] + layer["ff1"]["b"])
        h = h @ layer["ff2"]["w"] + layer["ff2"]["b"]
        x = _norm(x + h, layer["norm2_scale"], layer["norm2_shift"], cfg.norm)
    return _act(cfg, x)


class TSTransformerEncoder:
    """Masked-reconstruction transformer (ref TSTransformerEncoder :145-190):
    embeddings project back to feat_dim per step."""

    def __init__(self, config: TSTransformerConfig):
        assert config.num_classes == 0, \
            "use TSTransformerEncoderClassiregressor for a class head"
        self.config = config

    def init(self, generator, device=None):
        return init_ts_transformer_params(generator, self.config, device)

    def forward(self, params, X, padding_masks=None, seq_mesh=None):
        z = ts_transformer_encode(params, self.config, X, padding_masks,
                                  seq_mesh=seq_mesh)
        return z @ params["output"]["w"] + params["output"]["b"]

    def loss(self, params, X, Y=None, padding_masks=None):
        """Masked reconstruction MSE (the mvts pretraining objective)."""
        recon = self.forward(params, X, padding_masks)
        target = X if Y is None else Y
        err = (recon - target) ** 2
        if padding_masks is not None:
            err = err * padding_masks[:, :, None]
            denom = torch.clamp(padding_masks.sum() * X.shape[2], min=1)
            loss = err.sum() / denom
        else:
            loss = err.mean()
        return loss, {"recon_loss": loss}


class TSTransformerEncoderClassiregressor:
    """Classifier/regressor head over flattened masked embeddings
    (ref :192-250): padding embeddings are zeroed before the flattened linear
    output layer; no softmax (loss applies it)."""

    def __init__(self, config: TSTransformerConfig):
        assert config.num_classes > 0
        self.config = config

    def init(self, generator, device=None):
        return init_ts_transformer_params(generator, self.config, device)

    def forward(self, params, X, padding_masks=None):
        cfg = self.config
        z = ts_transformer_encode(params, cfg, X, padding_masks)
        if padding_masks is not None:
            z = z * padding_masks[:, :, None]
        # pad the time axis to max_len so the flattened head is static-shape
        T = z.shape[1]
        if T < cfg.max_len:
            z = F.pad(z, (0, 0, 0, cfg.max_len - T))
        flat = z.reshape(z.shape[0], -1)
        return flat @ params["output"]["w"] + params["output"]["b"]

    def loss(self, params, X, Y, padding_masks=None):
        """Softmax cross-entropy on integer or one-hot labels."""
        logits = self.forward(params, X, padding_masks)
        if Y.ndim == 1:
            Y = F.one_hot(Y.long(), self.config.num_classes).to(logits.dtype)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.mean(torch.sum(Y * logp, dim=-1))
        return loss, {"class_loss": loss}
