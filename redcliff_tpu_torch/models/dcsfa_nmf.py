"""dCSFA-NMF — supervised NMF autoencoder over directed-spectrum features
(port of ``models/dcsfa_nmf.py``).

The model learns K non-negative factors ``W_nmf`` (k, d) over high-level
signal features, an encoder mapping features to non-negative factor scores
``s`` (B, k), and one logistic-regression head per *supervised* factor. The
first ``n_sup_networks`` components are tied to task labels; the supervised
rows of ``W_nmf`` are the per-state networks whose directed-spectrum blocks
are read out as Granger-causal graphs.

What runs where:

* host (numpy, copies of the JAX package's code): the NNDSVD initialization
  (:func:`nndsvd_init`, float64), the Mann-Whitney AUC ranking that orders
  the components (:func:`mann_whitney_auc`, :func:`order_components`), the
  weighted batch draw and the epoch-end AUCs;
* device: the multiplicative-update NMF (:func:`nmf_fit`, float32, eager
  iterations with TF32 off), and every encoder-pretrain and joint step:
  one autograd pass and one optimizer step on the fit's device-resident
  features, gathered per batch by index. A step's three losses go into a
  device buffer that the host reads once per epoch and sums in float64 in
  step order, so the histories equal the JAX package's for equal losses.

The model is a set of plain functions on a dict of tensors in the JAX
layout (``x @ w``): ``W_nmf``, ``phi``, ``beta``, ``enc1``/``enc2``
``{w, b}``, ``bn_scale``, ``bn_shift``; the encoder's BatchNorm running
statistics are a separate ``state`` dict (``bn_mean``, ``bn_var``). A tree
without ``enc2`` is the linear encoder. ``interop.params_from_jax`` /
``params_to_jax`` carry both across.

Optimizers: ``AdamW`` is ``torch.optim.AdamW(weight_decay=0.01)`` (optax's
``adamw`` adds ``wd * p`` to the Adam direction; torch scales ``p`` by
``1 - lr * wd`` first: equal in exact arithmetic, rounded differently),
``Adam`` is ``torch.optim.Adam``, ``SGD`` with momentum is
``torch.optim.SGD`` (optax's ``trace``: the first step's buffer is the
gradient). The encoder pretrain builds its optimizer over the trainable
leaves only; the leaves it masks out follow ``optax.masked``, which passes
their raw gradient through as the update, so ``apply_updates`` adds it:
``W_nmf`` moves by ``+grad`` each pretrain step in the JAX package, and so
it does here. The joint fit starts from a fresh optimizer.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from redcliff_tpu_torch.interop import params_to_jax
from redcliff_tpu_torch.runtime.checkpoint import write_checkpoint
from redcliff_tpu_torch.utils.metrics import roc_auc
from redcliff_tpu_torch.utils.misc import unflatten_directed_spectrum_features
from redcliff_tpu_torch.utils.precision import resolve_device

__all__ = [
    "nndsvd_init",
    "nmf_fit",
    "mann_whitney_auc",
    "order_components",
    "DcsfaNmfConfig",
    "DcsfaNmf",
    "FullDCSFAModel",
    "FIT_LOG_NAME",
]

_EPS = 1e-7
# the per-phase timings and histories a fit writes beside its best model
FIT_LOG_NAME = "dcsfa_fit_log.pkl"


# ---------------------------------------------------------------------------
# NMF pretraining
# ---------------------------------------------------------------------------

def nndsvd_init(X, n_components, fill_mean=False, random_state=0):
    """Nonnegative double SVD initialization (Boutsidis & Gallopoulos 2008).

    ``fill_mean=True`` matches sklearn's "nndsvda" (zeros replaced by the data
    mean, required for multiplicative updates so zeros aren't absorbing).
    """
    X = np.asarray(X, dtype=np.float64)
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    U, S, Vt = U[:, :n_components], S[:n_components], Vt[:n_components]
    W = np.zeros((X.shape[0], n_components))
    H = np.zeros((n_components, X.shape[1]))
    W[:, 0] = np.sqrt(S[0]) * np.abs(U[:, 0])
    H[0, :] = np.sqrt(S[0]) * np.abs(Vt[0, :])
    for j in range(1, n_components):
        u, v = U[:, j], Vt[j, :]
        u_p, u_n = np.maximum(u, 0), np.maximum(-u, 0)
        v_p, v_n = np.maximum(v, 0), np.maximum(-v, 0)
        n_up, n_un = np.linalg.norm(u_p), np.linalg.norm(u_n)
        n_vp, n_vn = np.linalg.norm(v_p), np.linalg.norm(v_n)
        term_p, term_n = n_up * n_vp, n_un * n_vn
        if term_p >= term_n:
            sigma = term_p
            u_sel = u_p / max(n_up, _EPS)
            v_sel = v_p / max(n_vp, _EPS)
        else:
            sigma = term_n
            u_sel = u_n / max(n_un, _EPS)
            v_sel = v_n / max(n_vn, _EPS)
        W[:, j] = np.sqrt(S[j] * sigma) * u_sel
        H[j, :] = np.sqrt(S[j] * sigma) * v_sel
    if fill_mean:
        avg = X.mean()
        W[W == 0] = avg
        H[H == 0] = avg
    return W, H


def _host_f32(X):
    if isinstance(X, torch.Tensor):
        return X.detach().to("cpu", torch.float32).numpy()
    return np.asarray(X, dtype=np.float32)


def nmf_fit(X, n_components, max_iter=100, loss="MSE", device=None):
    """Unsupervised NMF by multiplicative updates on ``device`` (``cuda``
    unless given), float32.

    loss="MSE" uses Lee-Seung Frobenius updates; loss="IS" uses the
    beta-divergence (beta=0, Itakura-Saito) rules. The NNDSVD start is made
    on the host in float64. ``X`` is numpy or a tensor (a tensor already on
    ``device`` is used as is). Returns host (scores S, components H):
    X ≈ S @ H.
    """
    dev = resolve_device(device)
    Xn = _host_f32(X)
    W0, H0 = nndsvd_init(Xn, n_components, fill_mean=(loss == "IS"))
    if loss == "MSE" and max_iter > 0:
        # plain nndsvd zeros are absorbing under MU; nudge them off zero
        W0[W0 == 0] = _EPS
        H0[H0 == 0] = _EPS
    if isinstance(X, torch.Tensor):
        Xd = X.detach().to(dev, torch.float32)
    else:
        Xd = torch.from_numpy(Xn).to(dev)
    W = torch.from_numpy(W0.astype(np.float32)).to(dev)
    H = torch.from_numpy(H0.astype(np.float32)).to(dev)
    with torch.no_grad():
        for _ in range(max_iter):
            if loss == "IS":
                V = W @ H + _EPS
                H = H * (W.T @ (Xd / (V * V))) / (W.T @ (1.0 / V) + _EPS)
                V = W @ H + _EPS
                W = W * ((Xd / (V * V)) @ H.T) / ((1.0 / V) @ H.T + _EPS)
            else:
                H = H * (W.T @ Xd) / (W.T @ W @ H + _EPS)
                W = W * (Xd @ H.T) / (W @ (H @ H.T) + _EPS)
    return W.cpu().numpy(), H.cpu().numpy()


def mann_whitney_auc(pos, neg):
    """AUC = U / (n_pos * n_neg) with average-rank tie handling — identical to
    scipy.stats.mannwhitneyu's U."""
    pos = np.asarray(pos, dtype=np.float64).ravel()
    neg = np.asarray(neg, dtype=np.float64).ravel()
    if len(pos) == 0 or len(neg) == 0:
        # degenerate single-class task (e.g. under the 0.6 pretrain split):
        # no ordering information, fall back to chance
        return 0.5
    combined = np.concatenate([pos, neg])
    order = np.argsort(combined, kind="mergesort")
    ranks = np.empty(len(combined))
    ranks[order] = np.arange(1, len(combined) + 1)
    # average ranks over ties
    sorted_vals = combined[order]
    i = 0
    while i < len(sorted_vals):
        j = i
        while j + 1 < len(sorted_vals) and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = ranks[order[i : j + 1]].mean()
        i = j + 1
    U = ranks[: len(pos)].sum() - len(pos) * (len(pos) + 1) / 2.0
    return U / (len(pos) * len(neg))


def order_components(s_nmf, y, n_components, fixed_corr):
    """The NMF components in task order: for each supervised network in
    turn, the not yet taken component whose Mann-Whitney AUC against the
    network's labels (split at 0.6) is furthest from chance (or highest /
    lowest under a fixed positive / negative correlation), then the rest in
    index order. Returns (order, the selected components' AUCs)."""
    y = np.asarray(y)
    selected, selected_aucs = [], []
    remaining = list(range(n_components))
    for sup_net, corr in enumerate(fixed_corr):
        aucs = np.array([
            mann_whitney_auc(s_nmf[y[:, sup_net] >= 0.6, c],
                             s_nmf[y[:, sup_net] < 0.6, c])
            for c in range(n_components)])
        order_abs = np.argsort(np.abs(aucs - 0.5))[::-1]
        order_pos = np.argsort(aucs)[::-1]
        order_neg = np.argsort(1.0 - aucs)[::-1]
        for taken in selected:
            order_abs = order_abs[order_abs != taken]
            order_pos = order_pos[order_pos != taken]
            order_neg = order_neg[order_neg != taken]
        current = {"n/a": order_abs, "positive": order_pos,
                   "negative": order_neg}[corr][0]
        selected.append(int(current))
        selected_aucs.append(float(aucs[current]))
        remaining = [c for c in remaining if c != current]
    return (selected + [c for c in remaining if c not in selected],
            selected_aucs)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DcsfaNmfConfig:
    """Hyper-parameters of DcsfaNmf (ref dcsfa_nmf.py:557-576 defaults)."""
    n_components: int = 32
    n_sup_networks: int = 1
    n_intercepts: int = 1
    use_deep_encoder: bool = True
    h: int = 256
    optim_name: str = "AdamW"      # {"AdamW","Adam","SGD"} (ref :164-175)
    recon_loss: str = "MSE"        # {"MSE","IS"} (ref :147-161)
    recon_weight: float = 1.0
    sup_weight: float = 1.0
    sup_recon_weight: float = 1.0
    sup_recon_type: str = "Residual"   # {"Residual","All"} (ref :418-423)
    sup_smoothness_weight: float = 1.0
    feature_groups: Optional[tuple] = None   # ((lb, ub), ...) feature spans
    group_weights: Optional[tuple] = None
    fixed_corr: tuple = ()         # per-sup-net in {"n/a","positive","negative"}
    momentum: float = 0.9
    lr: float = 1e-3

    def __post_init__(self):
        if self.recon_loss not in ("MSE", "IS"):
            raise ValueError(f"{self.recon_loss} is not supported")
        if self.optim_name not in ("AdamW", "Adam", "SGD"):
            raise ValueError(f"{self.optim_name} is not supported")
        # normalize fixed_corr exactly like ref :89-103
        fc = self.fixed_corr
        if not fc:
            fc = tuple("n/a" for _ in range(self.n_sup_networks))
        elif isinstance(fc, str):
            if fc.lower() not in ("positive", "negative", "n/a"):
                raise ValueError(
                    "fixed corr must be a list or in {positive,negative,n/a}")
            # replicated across all supervised networks (the reference keeps
            # a length-1 list here, which breaks for n_sup_networks > 1)
            fc = tuple(fc.lower() for _ in range(self.n_sup_networks))
        else:
            fc = tuple(str(c).lower() for c in fc)
            assert len(fc) == self.n_sup_networks
        for c in fc:
            if c not in ("n/a", "positive", "negative"):
                raise ValueError(f"Unsupported fixed_corr value: {c}")
        object.__setattr__(self, "fixed_corr", fc)
        if self.feature_groups is not None and self.group_weights is None:
            fg = self.feature_groups
            span = fg[-1][-1] - fg[0][0]
            object.__setattr__(
                self, "group_weights",
                tuple(span / (ub - lb) for (lb, ub) in fg))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class DcsfaNmf:
    """Functional dCSFA-NMF with the reference's full training recipe: NMF
    pretrain → encoder pretrain → joint supervised fit with best-model
    checkpointing on ``val_mse/var + (1 - mean val AUC)``."""

    def __init__(self, config: DcsfaNmfConfig):
        self.config = config

    # -- parameters ---------------------------------------------------------

    def init(self, generator, dim_in, device="cpu"):
        """``(params, state)`` drawn from ``generator`` with the JAX init's
        distributions: ``W_nmf`` U(0, 1), ``phi`` and ``beta`` N(0, 1),
        dense layers U(±1/sqrt(d_in)), unit BatchNorm scale and running
        variance, zero shift and running mean."""
        cfg = self.config

        def dense(d_in, d_out):
            bound = 1.0 / math.sqrt(d_in)

            def u(shape):
                r = torch.rand(shape, generator=generator)
                return (r * (2.0 * bound) - bound).to(device)
            return {"w": u((d_in, d_out)), "b": u((d_out,))}

        params = {
            # raw parameter; softplus() makes it non-negative
            "W_nmf": torch.rand((cfg.n_components, dim_in),
                                generator=generator).to(device),
            "phi": torch.randn((cfg.n_sup_networks,),
                               generator=generator).to(device),
            "beta": torch.randn((cfg.n_sup_networks, cfg.n_intercepts),
                                generator=generator).to(device),
        }
        if cfg.use_deep_encoder:
            params["enc1"] = dense(dim_in, cfg.h)
            params["enc2"] = dense(cfg.h, cfg.n_components)
            params["bn_scale"] = torch.ones((cfg.h,), device=device)
            params["bn_shift"] = torch.zeros((cfg.h,), device=device)
            state = {"bn_mean": torch.zeros((cfg.h,), device=device),
                     "bn_var": torch.ones((cfg.h,), device=device)}
        else:
            params["enc1"] = dense(dim_in, cfg.n_components)
            state = {}
        return params, state

    # -- pieces -------------------------------------------------------------

    def get_w_nmf(self, params):
        return F.softplus(params["W_nmf"])

    def encode(self, params, state, X, train):
        """features -> non-negative factor scores s. BatchNorm normalizes by
        the batch statistics (biased variance) in training and updates the
        running ones (unbiased variance, momentum 0.1); eval uses the
        running ones. Returns (s, new state)."""
        cfg = self.config
        z = X @ params["enc1"]["w"] + params["enc1"]["b"]
        if cfg.use_deep_encoder:
            if train:
                mean = z.mean(dim=0)
                var = z.var(dim=0, correction=0)
                n = z.shape[0]
                with torch.no_grad():
                    unbiased = var * n / max(n - 1, 1)
                    state = {
                        "bn_mean": 0.9 * state["bn_mean"] + 0.1 * mean,
                        "bn_var": 0.9 * state["bn_var"] + 0.1 * unbiased,
                    }
            else:
                mean, var = state["bn_mean"], state["bn_var"]
            z = (z - mean) / torch.sqrt(var + 1e-5)
            z = z * params["bn_scale"] + params["bn_shift"]
            z = F.leaky_relu(z, 0.01)
            z = z @ params["enc2"]["w"] + params["enc2"]["b"]
        return F.softplus(z), state

    def get_phi(self, params):
        """(n_sup_networks,) logistic slopes with correlation constraints."""
        cols = []
        for j, corr in enumerate(self.config.fixed_corr):
            p = params["phi"][j]
            if corr == "positive":
                p = F.softplus(p)
            elif corr == "negative":
                p = -F.softplus(p)
            cols.append(p)
        return torch.stack(cols)

    def class_predictions(self, params, s, intercept_mask=None,
                          avg_intercept=False):
        """Per-sup-network logistic predictions."""
        cfg = self.config
        phi = self.get_phi(params)                       # (S,)
        if cfg.n_intercepts == 1:
            icpt = params["beta"][:, 0]                  # (S,)
        elif intercept_mask is not None and not avg_intercept:
            icpt = intercept_mask @ params["beta"].T     # (B, S)
        else:
            icpt = params["beta"].mean(dim=1)            # (S,)
        logits = s[:, : cfg.n_sup_networks] * phi[None, :] + icpt
        return torch.sigmoid(logits)

    def _recon_terms(self, params, X, s):
        """recon_weight*full + sup_recon_weight*supervised."""
        cfg = self.config
        W = self.get_w_nmf(params)
        X_recon = s @ W
        recon = cfg.recon_weight * self._eval_recon_loss(X_recon, X)
        S = cfg.n_sup_networks
        if cfg.sup_recon_type == "Residual":
            # scores that would best explain the unsupervised residual; the
            # inverse does not check for singular input (a host sync on
            # CUDA): non-finite values flow on, as in JAX
            resid = X - s[:, S:] @ W[S:, :]
            w_sup = W[:S, :]
            inv, _ = torch.linalg.inv_ex(w_sup @ w_sup.T, check_errors=False)
            s_h = resid @ w_sup.T @ inv
            sup_loss = torch.linalg.norm(s[:, :S] - s_h) / (
                1.0 - cfg.sup_smoothness_weight
                * torch.exp(-torch.linalg.norm(s_h)))
        elif cfg.sup_recon_type == "All":
            sup_loss = self._recon_loss_f(s[:, :S] @ W[:S, :], X)
        else:
            raise ValueError(f"{cfg.sup_recon_type} is not supported")
        return recon + cfg.sup_recon_weight * sup_loss

    def _recon_loss_f(self, X_pred, X_true):
        if self.config.recon_loss == "IS":
            ratio = (X_true + _EPS) / (X_pred + _EPS)
            return torch.mean(ratio - torch.log(ratio) - 1.0)
        return torch.mean((X_pred - X_true) ** 2)

    def _eval_recon_loss(self, X_pred, X_true):
        cfg = self.config
        if cfg.feature_groups is None:
            return self._recon_loss_f(X_pred, X_true)
        total = 0.0
        for wgt, (lb, ub) in zip(cfg.group_weights, cfg.feature_groups):
            total = total + wgt * self._recon_loss_f(X_pred[:, lb:ub],
                                                     X_true[:, lb:ub])
        return total

    def loss(self, params, state, batch, train):
        """Returns (recon_loss, pred_loss, new_state); ``batch`` is
        (X, y, task_mask, pred_weight, intercept_mask)."""
        X, y, task_mask, pred_weight, intercept_mask = batch
        s, new_state = self.encode(params, state, X, train)
        recon_loss = self._recon_terms(params, X, s)
        y_pred = self.class_predictions(params, s, intercept_mask,
                                        avg_intercept=False)
        p = torch.clamp(y_pred * task_mask, _EPS, 1.0 - _EPS)
        t = y * task_mask
        bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
        pred_loss = self.config.sup_weight * torch.mean(pred_weight * bce)
        return recon_loss, pred_loss, new_state

    # -- optimizers ---------------------------------------------------------

    def trainable_keys(self, params, pretrain):
        """The top-level keys a phase's optimizer updates: the encoder in
        the encoder pretrain, everything in the joint fit."""
        if not pretrain:
            return list(params)
        if self.config.use_deep_encoder:
            return [k for k in params
                    if k in ("enc1", "enc2", "bn_scale", "bn_shift")]
        return [k for k in params if k == "enc1"]

    def make_optimizer(self, leaves, lr=None):
        """The configured optimizer over ``leaves``."""
        cfg = self.config
        lr = cfg.lr if lr is None else lr
        if cfg.optim_name == "AdamW":
            return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=0.01)
        if cfg.optim_name == "Adam":
            return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        return torch.optim.SGD(leaves, lr=lr, momentum=cfg.momentum)

    @staticmethod
    def _leaves(params, keys):
        out = []
        for k in keys:
            v = params[k]
            out.extend(v.values() if isinstance(v, dict) else [v])
        return out

    def make_phase(self, params, pretrain):
        """``(optimizer, trainable leaves, frozen leaves)`` of a phase over
        live params (leaf tensors with ``requires_grad``)."""
        keys = self.trainable_keys(params, pretrain)
        train = self._leaves(params, keys)
        frozen = self._leaves(params, [k for k in params if k not in keys])
        return self.make_optimizer(train), train, frozen

    def train_step(self, params, state, phase, batch, pretrain):
        """One step in place on the live ``params``: the loss (recon only in
        the encoder pretrain), its gradient and :meth:`apply_grads`.
        Returns (new state, stacked (loss, recon, pred) detached on the
        device)."""
        opt, train, frozen = phase
        recon, pred, new_state = self.loss(params, state, batch, True)
        loss = recon if pretrain else recon + pred
        grads = torch.autograd.grad(loss, train + frozen, allow_unused=True)
        self.apply_grads(phase, grads)
        return new_state, torch.stack([loss, recon, pred]).detach()

    @staticmethod
    def apply_grads(phase, grads):
        """The optimizer step on the trainable leaves (a missing gradient
        counts as zero, so weight decay still applies, as in optax) and
        optax.masked's pass-through (``p += g``) on the frozen ones;
        ``grads`` lists the trainable leaves' then the frozen ones'."""
        opt, train, frozen = phase
        for p, g in zip(train, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        opt.step()
        with torch.no_grad():
            for p, g in zip(frozen, grads[len(train):]):
                if g is not None:
                    p.add_(g)
        for p in train:
            p.grad = None

    # -- pretraining --------------------------------------------------------

    def pretrain_nmf(self, params, X, y, nmf_max_iter=100):
        """NMF pretrain (on the params' device) + Mann-Whitney-AUC
        component→task ordering. Returns (params, per-task AUCs); the order
        is kept as ``self.component_order``."""
        cfg = self.config
        dev = params["W_nmf"].device
        s_nmf, components = nmf_fit(X, cfg.n_components,
                                    max_iter=nmf_max_iter,
                                    loss=cfg.recon_loss, device=dev)
        final_order, selected_aucs = order_components(
            s_nmf, y, cfg.n_components, cfg.fixed_corr)
        self.component_order = final_order
        sorted_H = components[final_order].astype(np.float64)
        # inverse softplus so softplus(param) reproduces the NMF components;
        # numerically stable form x + log1p(-exp(-x)) above the expm1
        # overflow range
        xe = sorted_H + 1e-5
        w_raw = np.where(
            xe > 30.0, xe + np.log1p(-np.exp(-np.minimum(xe, 700.0))),
            np.log(np.expm1(np.minimum(xe, 30.0)) + 1e-5)).astype(np.float32)
        params = dict(params)
        params["W_nmf"] = torch.from_numpy(w_raw).to(dev)
        return params, selected_aucs

    # -- fit ----------------------------------------------------------------

    @staticmethod
    def _weighted_batches(rng, n, batch_size, weights):
        """WeightedRandomSampler(+DataLoader) equivalent: n draws with
        replacement ∝ weights, chunked into batches."""
        p = np.asarray(weights, dtype=np.float64)
        p = p / p.sum()
        idx = rng.choice(n, size=n, replace=True, p=p)
        return [idx[i : i + batch_size] for i in range(0, n, batch_size)]

    def _device_batches(self, rng, n, batch_size, weights, dev):
        """One epoch's weighted batches as slices of one index tensor on
        ``dev`` (one host-to-device copy per epoch)."""
        idx = torch.from_numpy(np.concatenate(self._weighted_batches(
            rng, n, batch_size, weights))).to(dev)
        return [idx[i : i + batch_size] for i in range(0, n, batch_size)]

    def _epoch_aucs(self, y, y_pred, task_mask):
        aucs = []
        for j in range(self.config.n_sup_networks):
            m = task_mask[:, j] == 1
            try:
                aucs.append(roc_auc(y[m, j] >= 0.6,
                                    (y_pred[m, j] >= 0.6).astype(np.float64)))
            except ValueError:
                aucs.append(float("nan"))
        return aucs

    def fit(self, generator, X, y, y_pred_weights=None, task_mask=None,
            intercept_mask=None, y_sample_groups=None, n_epochs=100,
            n_pre_epochs=100, nmf_max_iter=100, batch_size=128, lr=None,
            pretrain=True, X_val=None, y_val=None, y_pred_weights_val=None,
            task_mask_val=None, save_folder=None,
            best_model_name="dCSFA-NMF-best-model.pkl", verbose=False,
            seed=0, device=None):
        """Full training recipe on ``device`` (``cuda`` unless given).
        ``X`` / ``X_val`` are numpy or tensors (a tensor on the device is
        used in place). Returns (params, state, histories), the params and
        state as tensors on the device. Per-phase timings and the per-epoch
        log are kept as ``self.fit_log`` and, with ``save_folder``, written
        there as ``dcsfa_fit_log.pkl``."""
        cfg = self.config
        dev = resolve_device(device)
        if lr is not None and lr != cfg.lr:
            self.config = dataclasses.replace(cfg, lr=lr)
            cfg = self.config
        X_host = _host_f32(X)
        y = np.asarray(y, dtype=np.float32)
        n = X_host.shape[0]
        if intercept_mask is None:
            intercept_mask = np.ones((n, cfg.n_intercepts), dtype=np.float32)
        if task_mask is None:
            task_mask = np.ones_like(y)
        if y_pred_weights is None:
            y_pred_weights = np.ones((n, 1), dtype=np.float32)
        if y_sample_groups is None:
            sample_weights = np.ones(n)
        else:
            y_sample_groups = np.asarray(y_sample_groups).squeeze()
            counts = {g: np.sum(y_sample_groups == g)
                      for g in np.unique(y_sample_groups)}
            sample_weights = np.array(
                [1.0 / counts[g] for g in y_sample_groups])
        intercept_mask = np.asarray(intercept_mask, dtype=np.float32)
        task_mask = np.asarray(task_mask, dtype=np.float32)
        y_pred_weights = np.asarray(y_pred_weights, dtype=np.float32)

        # the fit's device-resident table: features | y | task mask | pred
        # weight | intercept mask; one gather by index per batch
        Xd = (X.detach().to(dev, torch.float32)
              if isinstance(X, torch.Tensor) else torch.from_numpy(X_host)
              .to(dev))
        extras = torch.from_numpy(np.concatenate(
            [y, task_mask, y_pred_weights, intercept_mask], axis=1)).to(dev)
        table = torch.cat([Xd, extras], dim=1)
        d, S = X_host.shape[1], y.shape[1]
        cuts = np.cumsum([d, S, S, 1]).tolist()

        def batch_of(idx_dev):
            b = table.index_select(0, idx_dev)
            return (b[:, : cuts[0]], b[:, cuts[0]: cuts[1]],
                    b[:, cuts[1]: cuts[2]], b[:, cuts[2]: cuts[3]],
                    b[:, cuts[3]:])

        params, state = self.init(generator, d, dev)
        histories = {"training": [], "recon": [], "pred": [],
                     "val_recon": [], "val_pred": []}
        log = {"device": str(dev), "n": n, "dim_in": d,
               "batch_size": batch_size, "nmf_ms": 0.0, "pre_steps": 0,
               "pre_s": 0.0, "joint_steps": 0, "joint_s": 0.0, "epochs": []}
        rng = np.random.default_rng(seed)

        if pretrain:
            t0 = time.perf_counter()
            params, _ = self.pretrain_nmf(params, X if isinstance(
                X, torch.Tensor) else X_host, y, nmf_max_iter)
            log["nmf_ms"] = (time.perf_counter() - t0) * 1e3
            log["component_order"] = list(self.component_order)
            live = _live(params)
            phase = self.make_phase(live, pretrain=True)
            t0 = time.perf_counter()
            for _ in range(n_pre_epochs):
                for sel in self._device_batches(rng, n, batch_size,
                                                sample_weights, dev):
                    state, _ = self.train_step(live, state, phase,
                                               batch_of(sel), True)
                    log["pre_steps"] += 1
            _sync(dev)
            log["pre_s"] = time.perf_counter() - t0
            params = live
        else:
            params = _live(params)

        phase = self.make_phase(params, pretrain=False)

        has_val = X_val is not None and y_val is not None
        if has_val:
            Xv_host = _host_f32(X_val)
            Xvd = (X_val.detach().to(dev, torch.float32)
                   if isinstance(X_val, torch.Tensor)
                   else torch.from_numpy(Xv_host).to(dev))
            y_val = np.asarray(y_val, dtype=np.float32)
            if task_mask_val is None:
                task_mask_val = np.ones_like(y_val)
            best = {"performance": 1e8, "epoch": -1, "params": params,
                    "state": state, "val_recon": 1e8, "val_aucs": None}
            val_var = float(np.var(Xv_host))
        im_d = torch.from_numpy(intercept_mask).to(dev)

        for epoch in range(n_epochs):
            t0 = time.perf_counter()
            batches = self._device_batches(rng, n, batch_size,
                                           sample_weights, dev)
            losses = torch.empty((len(batches), 3), device=dev)
            for i, sel in enumerate(batches):
                state, losses[i] = self.train_step(params, state, phase,
                                                   batch_of(sel), False)
            # the epoch's one read of the step losses, summed as JAX does
            e_loss = 0.0
            for step_loss in losses[:, 0].tolist():
                e_loss += step_loss
            t_steps = time.perf_counter()
            log["joint_steps"] += len(batches)
            log["joint_s"] += t_steps - t0
            histories["training"].append(e_loss / len(batches))

            # epoch-end train metrics: MSE + binarized AUC
            with torch.no_grad():
                Xr, yp, _ = self._transform(params, state, Xd, im_d, False)
                mse = torch.mean((Xd - Xr) ** 2)
            histories["recon"].append(float(mse))
            histories["pred"].append(self._epoch_aucs(
                y, yp.cpu().numpy(), task_mask))

            if has_val:
                with torch.no_grad():
                    Xr_val, yp_val, _ = self._transform(params, state, Xvd)
                    val_mse = float(torch.mean((Xvd - Xr_val) ** 2))
                val_aucs = self._epoch_aucs(y_val, yp_val.cpu().numpy(),
                                            task_mask_val)
                histories["val_recon"].append(val_mse)
                histories["val_pred"].append(val_aucs)
                perf = val_mse / max(val_var, _EPS) + (
                    1.0 - float(np.nanmean(val_aucs))
                    if not np.all(np.isnan(val_aucs)) else 1.0)
                if not np.isnan(perf) and perf < best["performance"]:
                    best.update(performance=perf, epoch=epoch,
                                params=_copy(params), state=_copy(state),
                                val_recon=val_mse, val_aucs=val_aucs)
                    if save_folder:
                        # durable write: a preemption mid-save can't tear
                        # the best-model artifact
                        write_checkpoint(
                            os.path.join(save_folder, best_model_name),
                            self._artifact_payload(params, state))
            log["epochs"].append({
                "epoch": epoch, "steps": len(batches),
                "steps_ms": (t_steps - t0) * 1e3,
                "ms": (time.perf_counter() - t0) * 1e3})
            if verbose:
                print(f"dCSFA-NMF epoch {epoch}: loss "
                      f"{histories['training'][-1]:.6f}", flush=True)

        params = _copy(params)
        self.last_params, self.last_state = params, state
        if has_val:
            histories["best_epoch"] = best["epoch"]
            histories["best_val_recon"] = best["val_recon"]
            histories["best_val_aucs"] = best["val_aucs"]
            if best["epoch"] < 0:
                # no epoch ever produced a finite validation criterion
                # (e.g. single-class y_val); fall back to the final params
                # rather than silently returning the untrained initial ones
                warnings.warn(
                    "dCSFA-NMF: validation criterion was never finite; "
                    "returning last-epoch parameters")
            else:
                params, state = best["params"], best["state"]
        self.fit_log = log
        if save_folder:
            write_checkpoint(os.path.join(save_folder, FIT_LOG_NAME),
                             {"histories": histories, **log})
        return params, state, histories

    def _artifact_payload(self, params, state):
        """Self-describing artifact (numpy leaves) so either package's
        ``eval.model_io`` can reconstruct the exact class, including
        FullDCSFAModel's graph-shape metadata."""
        payload = {"model_class": type(self).__name__,
                   "config": self.config,
                   "params": params_to_jax(params),
                   "state": params_to_jax(state)}
        for attr in ("num_nodes", "num_high_level_node_features",
                     "gc_feature_layout"):
            if hasattr(self, attr):
                payload[attr] = getattr(self, attr)
        return payload

    # -- inference ----------------------------------------------------------

    def _transform(self, params, state, X, intercept_mask=None,
                   avg_intercept=True):
        """(X_recon, y_pred, s) tensors in eval mode on X's device."""
        s, _ = self.encode(params, state, X, train=False)
        X_recon = s @ self.get_w_nmf(params)
        y_pred = self.class_predictions(params, s, intercept_mask,
                                        avg_intercept=avg_intercept)
        return X_recon, y_pred, s

    def transform(self, params, state, X, intercept_mask=None,
                  avg_intercept=True):
        """(X_recon, y_pred, s) as host numpy, computed in eval mode on the
        params' device."""
        dev = params["W_nmf"].device
        X = torch.as_tensor(np.asarray(X, dtype=np.float32)
                            if not isinstance(X, torch.Tensor) else X)
        if intercept_mask is not None:
            intercept_mask = torch.as_tensor(
                np.asarray(intercept_mask, dtype=np.float32)).to(dev)
        with torch.no_grad():
            out = self._transform(params, state,
                                  X.to(dev, torch.float32), intercept_mask,
                                  avg_intercept)
        return tuple(t.cpu().numpy() for t in out)

    def predict_proba(self, params, state, X, return_scores=False):
        _, y_pred, s = self.transform(params, state, X)
        return (y_pred, s) if return_scores else y_pred

    def predict(self, params, state, X, return_scores=False):
        _, y_pred, s = self.transform(params, state, X)
        return (y_pred > 0.5, s) if return_scores else (y_pred > 0.5)

    def project(self, params, state, X):
        return self.transform(params, state, X)[2]

    def reconstruct(self, params, state, X, component=None):
        X_recon, _, s = self.transform(params, state, X)
        if component is not None:
            with torch.no_grad():
                W = self.get_w_nmf(params).cpu().numpy()
            return np.outer(s[:, component], W[component, :])
        return X_recon

    def score(self, params, state, X, y, groups=None, return_dict=False):
        """Per-task AUCs, optionally split by group (each group masked)."""
        _, y_pred, _ = self.transform(params, state, X)
        y = np.asarray(y)
        if groups is None:
            return np.array([roc_auc(y[:, j], y_pred[:, j])
                             for j in range(self.config.n_sup_networks)])
        groups = np.asarray(groups).squeeze()
        auc_dict = {
            g: [roc_auc(y[groups == g, j], y_pred[groups == g, j])
                for j in range(self.config.n_sup_networks)]
            for g in np.unique(groups)}
        if return_dict:
            return auc_dict
        return np.mean(np.vstack([auc_dict[g] for g in np.unique(groups)]),
                       axis=0)


def _live(params):
    """Fresh leaf tensors with ``requires_grad`` (same device)."""
    return {k: ({kk: vv.detach().clone().requires_grad_(True)
                 for kk, vv in v.items()} if isinstance(v, dict)
                else v.detach().clone().requires_grad_(True))
            for k, v in params.items()}


def _copy(tree):
    return {k: ({kk: vv.detach().clone() for kk, vv in v.items()}
                if isinstance(v, dict) else v.detach().clone())
            for k, v in tree.items()}


class FullDCSFAModel(DcsfaNmf):
    """DcsfaNmf + Granger-graph readout over directed-spectrum feature
    blocks.

    gc_feature_layout:
      "dirspec" — W_nmf rows are per-node blocks of flattened
        directed-spectrum features, unflattened via the (2n-1)-per-node
        layout;
      "vanilla" — W_nmf rows reshape directly to (n, n, F).
    """

    def __init__(self, num_nodes=5, num_high_level_node_features=25,
                 config: DcsfaNmfConfig = None, gc_feature_layout="dirspec",
                 **cfg_kw):
        if config is None:
            config = DcsfaNmfConfig(**cfg_kw)
        super().__init__(config)
        assert gc_feature_layout in ("dirspec", "vanilla")
        self.num_nodes = num_nodes
        self.num_high_level_node_features = num_high_level_node_features
        self.gc_feature_layout = gc_feature_layout

    @property
    def dim_in(self):
        n, F_ = self.num_nodes, self.num_high_level_node_features
        if self.gc_feature_layout == "dirspec":
            return n * F_ * (2 * n - 1)
        return n * n * F_

    def get_factor_gc(self, factor, threshold=True, ignore_features=True):
        n, F_ = self.num_nodes, self.num_high_level_node_features
        factor = np.asarray(factor).reshape(1, -1)
        if self.gc_feature_layout == "dirspec":
            node_len = F_ * (2 * n - 1)
            assert factor.shape[1] == n * node_len
            node_subfactors = factor.reshape(n, node_len)
            # accumulate_shared_entries matches the reference readout, whose
            # unflatten doubles off-diagonal entries
            raw = unflatten_directed_spectrum_features(
                node_subfactors, accumulate_shared_entries=True)
        else:
            raw = factor.reshape(n, n, F_)
        GC = raw * raw
        if ignore_features:
            GC = GC.sum(axis=2)
        if threshold:
            return (GC > 0).astype(np.int32)
        return GC

    def gc(self, params, threshold=True, ignore_features=True):
        """One (n, n) graph per NMF component, supervised components first
        (numpy; ``softplus(W_nmf)`` on the params' device, one copy to the
        host)."""
        with torch.no_grad():
            W = self.get_w_nmf(params).cpu().numpy()
        return [self.get_factor_gc(W[i], threshold=threshold,
                                   ignore_features=ignore_features)
                for i in range(W.shape[0])]

    GC = gc

    def evaluate(self, params, state, X, y, GC_true, save_path=None,
                 threshold=False, ignore_features=True):
        """Recon/score/GC MSE summary."""
        GC_est = self.gc(params, threshold=threshold,
                         ignore_features=ignore_features)
        gc_mse = [(i, j, float(np.mean((np.asarray(ge, dtype=np.float64)
                                        - np.asarray(gt, dtype=np.float64))
                                       ** 2)))
                  for i, ge in enumerate(GC_est)
                  for j, gt in enumerate(GC_true)]
        X = _host_f32(X)
        X_hat = self.reconstruct(params, state, X)
        y_hat = self.predict_proba(params, state, X)
        recon_mse = float(np.mean((X_hat - X) ** 2))
        score_mse = float(np.mean((y_hat - np.asarray(y)) ** 2))
        summary = {"gc_mse": gc_mse, "recon_mse": recon_mse,
                   "score_mse": score_mse, "avg_recon_mse": recon_mse,
                   "avg_score_mse": score_mse}
        if save_path:
            with open(os.path.join(save_path, "eval_summary.pkl"), "wb") as f:
                pickle.dump(summary, f)
        return summary
