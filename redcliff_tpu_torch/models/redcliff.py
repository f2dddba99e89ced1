"""REDCLIFF-S-cMLP — the paper's model (port of ``models/redcliff.py``).

K cMLP factor forecasters + a factor-score embedder whose window-
conditioned weightings mix the per-factor one-step predictions; first-layer
weight norms of each factor are the per-state Granger-causal graph
estimates. The K factors are one stacked weight block (leading K axis,
the JAX package's ``vmap`` written out as broadcasting einsums).

Ported: the config with its validation, ``init``, both forward modes, all
9 GC readout modes (the serve slice) with their host view
``gc_as_lists`` (the evaluation layer), and the training half — the phase
schedule, the multi-term loss with its smoothing variant, ``apply_prox``
and its in-place form ``apply_prox_`` (the GL prox kernel on the card),
``permute_factors`` and the validation normalization coefficients. The
factors are cMLPs (``models/cmlp.py``) or cLSTMs (``models/clstm.py``):
with cLSTM factors the K stacked LSTMs run as one recurrence (K folded
into the einsums' leading axes), their last-step forecasts go through the
factor mix, and the GISTA prox is refused, as in the JAX package.

The coefficient grid runs the loss for G lanes at once under
``torch.func.vmap(torch.func.grad_and_value(loss_for_phase))`` with the
parameters and coefficients stacked on a lane axis and the batch shared,
as the JAX grid vmaps it: every op here is functional and data-independent
in its control flow (the factor mix reaches the kernel's lane form through
the vmap rule of ``FactorMixFn``). ``apply_prox_lanes_`` is the grid's
prox over the stacked block.

The contractions (the GC outer products and their weightings) go through
``utils/precision.py`` (``_prec.einsum``): ``torch.einsum`` itself
outside a bf16 matmul context, bf16-rounded operands with float32 sums
inside one (``precision_mode="mixed"``), where the factor mix takes its
bf16 training form (``ops/factor_mix.py factor_mix_bf16``).

Factor parallelism (``RedcliffTrainer.fit(factor_mesh=)``, as JAX's
``shard_factor_axis``): a params tree whose ``"factors"`` is a
``parallel.mesh.FactorShards`` holds K/n factors per mesh entry on that
entry's device. Each block computes its factors' one-step predictions on
its device, the factor-mix kernel mixes the block's K slice there (the
weightings' slice made contiguous: the wrapper refuses a strided ``w``),
and the partial outputs are summed on the first block's device in mesh
order — the psum of JAX's mesh. The GC readouts join the blocks' per-factor
graphs on the first device, and the GL prox runs on each block's leaves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from redcliff_tpu_torch.interop import tree_leaves, tree_map
from redcliff_tpu_torch.models import clstm as clstm_mod
from redcliff_tpu_torch.models import cmlp as cmlp_mod
from redcliff_tpu_torch.models.embedders import (CEmbedder, DGCNNEmbedder,
                                                 build_embedder)
from redcliff_tpu_torch.ops import losses as L
from redcliff_tpu_torch.ops.factor_mix import factor_mix
from redcliff_tpu_torch.ops.pallas_prox import gl_prox, gl_prox_, gl_prox_lanes_
from redcliff_tpu_torch.parallel.mesh import (FactorShards, factor_slices,
                                              shard_factor_axis,
                                              unshard_factor_axis)
from redcliff_tpu_torch.utils import precision as _prec

__all__ = ["RedcliffSCMLPConfig", "RedcliffSCMLP", "TRAINING_MODES",
           "GC_EST_MODES", "FORWARD_PASS_MODES", "phase_schedule",
           "FACTOR_BLOCK_LAUNCHES"]

# each factor block's kernel launches (block index -> count) in
# factor-sharded fits on the card, counted where the wrappers count theirs
FACTOR_BLOCK_LAUNCHES = {"factor_mix": {}, "gl_prox": {}}


def _block_launch(kernel, block, t):
    if t.is_cuda:
        by = FACTOR_BLOCK_LAUNCHES[kernel]
        by[block] = by.get(block, 0) + 1

TRAINING_MODES = (
    "pretrain_embedder_then_acclimate_factors_then_combined",
    "pretrain_embedder_then_post_train_factor_withComboCosSimL1FreezeByEpoch",
    "pretrain_embedder_then_post_train_factor_withComboCosSimL1FreezeByBatch",
    "pretrain_embedder_then_post_train_factor_withL1FreezeByEpoch",
    "pretrain_embedder_then_post_train_factor_withL1FreezeByBatch",
    "pretrain_embedder_then_post_train_factor",
    "pretrain_embedder_and_pretrain_factor_then_combined",
    "pretrain_embedder_then_combined",
    "pretrain_factor_then_combined",
    "combined",
)

GC_EST_MODES = (
    "fixed_factor_exclusive",
    "raw_embedder",
    "conditional_factor_exclusive",
    "fixed_embedder_exclusive",
    "conditional_embedder_exclusive",
    "fixed_factor_fixed_embedder",
    "conditional_factor_fixed_embedder",
    "fixed_factor_conditional_embedder",
    "conditional_factor_conditional_embedder",
)

FORWARD_PASS_MODES = (
    "apply_factor_weights_at_each_sim_step",
    "apply_factor_weights_after_sim_completion",
)


def phase_schedule(cfg, epoch):
    """Epoch -> tuple of phase names under cfg.training_mode."""
    mode = cfg.training_mode
    if epoch <= cfg.num_pretrain_epochs - 1:
        phases = []
        if "pretrain_embedder" in mode:
            phases.append("embedder_pretrain")
        if "pretrain_factor" in mode:
            phases.append("factor_pretrain")
        return tuple(phases)
    if ("acclimate_factors" in mode
            and epoch <= cfg.num_pretrain_epochs
            + cfg.num_acclimation_epochs - 1):
        return ("factor_pretrain",)
    if "combined" in mode:
        return ("combined",)
    if "post_train_factor" in mode:
        return ("post_train",)
    raise NotImplementedError(mode)


def _smooth_on(coeff):
    """True when a coefficient's term is computed: decided by value for a
    Python number; always on for a tensor coefficient (the JAX package's
    traced grid-axis coefficients)."""
    if isinstance(coeff, torch.Tensor):
        return True
    return float(coeff) > 0.0


def _require(ok, what):
    if not ok:
        raise ValueError(what)


@dataclass(frozen=True)
class RedcliffSCMLPConfig:
    """The JAX package's config, field for field, so a pickled JAX config
    unpickles into this class (runtime/checkpoint.py)."""

    num_chans: int
    gen_lag: int
    gen_hidden: Tuple[int, ...]
    embed_lag: int
    embed_hidden_sizes: Tuple[int, ...]
    num_factors: int
    num_supervised_factors: int
    forecast_coeff: float = 1.0
    factor_score_coeff: float = 1.0
    factor_cos_sim_coeff: float = 0.0
    factor_weight_l1_coeff: float = 0.0
    adj_l1_reg_coeff: float = 0.0
    dagness_reg_coeff: float = 0.0
    dagness_lag_coeff: float = 0.0
    dagness_node_coeff: float = 0.0
    use_sigmoid_restriction: bool = True
    sigmoid_eccentricity_coeff: float = 10.0
    factor_score_embedder_type: str = "DGCNN"
    dgcnn_num_graph_conv_layers: int = 2
    dgcnn_num_hidden_nodes: int = 32
    primary_gc_est_mode: str = "conditional_factor_fixed_embedder"
    forward_pass_mode: str = "apply_factor_weights_at_each_sim_step"
    num_sims: int = 1
    wavelet_level: int | None = None
    factor_network_type: str = "cMLP"
    training_mode: str = "pretrain_embedder_and_pretrain_factor_then_combined"
    num_pretrain_epochs: int = 0
    num_acclimation_epochs: int = 0
    factor_weight_smoothing_penalty_coeff: float = 0.0
    state_score_smoothing_epsilon: float = 0.0001

    def __post_init__(self):
        _require(self.factor_network_type in ("cMLP", "cLSTM"),
                 f"factor_network_type {self.factor_network_type!r}")
        _require(self.training_mode in TRAINING_MODES,
                 f"training_mode {self.training_mode!r}")
        _require(self.primary_gc_est_mode in GC_EST_MODES,
                 f"primary_gc_est_mode {self.primary_gc_est_mode!r}")
        _require(self.forward_pass_mode in FORWARD_PASS_MODES,
                 f"forward_pass_mode {self.forward_pass_mode!r}")
        if "pretrain" in self.training_mode:
            _require(self.num_pretrain_epochs > 0,
                     f"{self.training_mode} needs num_pretrain_epochs > 0")
        else:
            _require(self.num_pretrain_epochs == 0,
                     f"{self.training_mode} takes num_pretrain_epochs == 0")
        if "acclimate" in self.training_mode:
            _require(self.num_acclimation_epochs > 0,
                     f"{self.training_mode} needs num_acclimation_epochs > 0")
        else:
            _require(self.num_acclimation_epochs == 0,
                     f"{self.training_mode} takes num_acclimation_epochs == 0")
        if self.factor_score_embedder_type == "DGCNN":
            _require(self.primary_gc_est_mode
                     != "conditional_embedder_exclusive",
                     "conditional_embedder_exclusive is not supported for "
                     "DGCNN embedders")
        if ("embedder" in self.primary_gc_est_mode
                and self.factor_score_embedder_type
                not in ("cEmbedder", "DGCNN")):
            raise ValueError(
                f"primary_gc_est_mode={self.primary_gc_est_mode!r} reads a GC "
                f"estimate out of the embedder, which requires "
                f"factor_score_embedder_type 'cEmbedder' or 'DGCNN' (got "
                f"{self.factor_score_embedder_type!r})")

    @property
    def num_series(self):
        if self.wavelet_level is not None:
            return self.num_chans * (self.wavelet_level + 1)
        return self.num_chans

    @property
    def max_lag(self):
        return max(self.gen_lag, self.embed_lag)

    @property
    def output_length(self):
        return 1


class RedcliffSCMLP:
    """Functional model over a params tree of tensors laid out as the JAX
    package's: ``{"embedder": ..., "factors": [{"w", "b"}, ...]}`` with a
    leading K axis on every factor leaf."""

    def __init__(self, config: RedcliffSCMLPConfig):
        self.config = config
        cfg = config
        self.embedder = build_embedder(
            cfg.factor_score_embedder_type,
            num_chans=cfg.num_chans, num_series=cfg.num_series,
            embed_lag=cfg.embed_lag,
            embed_hidden_sizes=list(cfg.embed_hidden_sizes),
            num_factors=cfg.num_factors,
            num_supervised_factors=cfg.num_supervised_factors,
            use_sigmoid_restriction=cfg.use_sigmoid_restriction,
            sigmoid_eccentricity_coeff=cfg.sigmoid_eccentricity_coeff,
            wavelet_level=cfg.wavelet_level,
            dgcnn_args={
                "num_features_per_node": cfg.embed_lag,
                "num_graph_conv_layers": cfg.dgcnn_num_graph_conv_layers,
                "num_hidden_nodes": cfg.dgcnn_num_hidden_nodes,
            },
        )

    # ------------------------------------------------------------------ params
    def init(self, generator, device="cpu"):
        """Fresh parameters from a CPU ``torch.Generator``, with the JAX
        init's distributions (not its numbers), placed on ``device``."""
        cfg = self.config
        embedder = self.embedder.init(generator, device)
        if cfg.factor_network_type == "cLSTM":
            per_factor = [clstm_mod.init_clstm_params(
                generator, cfg.num_series, cfg.gen_hidden[0], device)
                for _ in range(cfg.num_factors)]
        else:
            per_factor = [cmlp_mod.init_cmlp_params(
                generator, cfg.num_series, cfg.gen_lag, list(cfg.gen_hidden),
                device) for _ in range(cfg.num_factors)]
        factors = tree_map(lambda *leaves: torch.stack(leaves),
                           *per_factor)
        return {"embedder": embedder, "factors": factors}

    def _factors_apply(self, factors, window):
        """The stacked factors' one-step predictions on ``window``
        ((B, lag, C), shared, or (K, B, lag, C), one per factor):
        (K, B, 1, C). cLSTM factors consume the window step by step and
        emit the last step's forecast. Factor blocks give one
        prediction per block, on its device (``window`` a shared tensor
        or one per block)."""
        if isinstance(factors, FactorShards):
            wins = (window if isinstance(window, list)
                    else [window] * len(factors))
            return [self._factors_apply(f, w.to(_block_device(f)))
                    for f, w in zip(factors, wins)]
        if self.config.factor_network_type == "cLSTM":
            preds, _ = clstm_mod.clstm_forward(factors, window)
            return preds[..., -1:, :]
        return cmlp_mod.cmlp_forward(factors, window)

    # ----------------------------------------------------------------- forward
    def _embed(self, params, window):
        """Embedder call on the last embed_lag steps; DGCNN takes node-major
        input."""
        cfg = self.config
        w = window[:, -cfg.embed_lag:, :]
        if cfg.factor_score_embedder_type == "DGCNN":
            return self.embedder.apply(params["embedder"], w.transpose(1, 2))
        return self.embedder.apply(params["embedder"], w)

    def _factor_step(self, params, window):
        """All K factors' one-step predictions on the last gen_lag steps:
        (K, B, 1, C) (one per block for factor blocks)."""
        w = window[:, -self.config.gen_lag:, :]
        return self._factors_apply(params["factors"], w)

    @staticmethod
    def _mix(weightings, preds, factors):
        """The factor mix of ``preds`` by ``weightings`` (B, K): one kernel
        launch, or for factor blocks one launch per block on the block's
        K slice and device, the partial sums added on the first block's
        device in mesh order."""
        if not isinstance(factors, FactorShards):
            return factor_mix(weightings.contiguous(), preds.contiguous())
        out = None
        home = preds[0].device
        for b, ((lo, hi), p) in enumerate(zip(factor_slices(factors),
                                               preds)):
            w = weightings[:, lo:hi].to(p.device).contiguous()
            part = factor_mix(w, p.contiguous()).to(home)
            _block_launch("factor_mix", b, p)
            out = part if out is None else out + part
        return out

    @staticmethod
    def _joined(preds):
        """Per-block predictions joined along K on the first block's
        device (the unsharded layout)."""
        if not isinstance(preds, list):
            return preds
        return torch.cat([p.to(preds[0].device) for p in preds])

    def forward(self, params, X, factor_weightings=None):
        """Returns (x_sims (B, num_sims, C), factor_preds, factor_weighting
        preds list, state_label_preds list)."""
        if self.config.forward_pass_mode == \
                "apply_factor_weights_at_each_sim_step":
            return self._forward_stepwise(params, X, factor_weightings)
        return self._forward_post_weighted(params, X, factor_weightings)

    def _forward_stepwise(self, params, X, fixed_weightings=None):
        """New weightings from the sliding window at every sim step."""
        window = X
        sims, fw_preds, label_preds, factor_preds = [], [], [], []
        for _ in range(self.config.num_sims):
            weightings, logits = self._embed(params, window)
            if fixed_weightings is not None:
                weightings = fixed_weightings
            label_preds.append(logits if logits is not None else weightings)
            preds = self._factor_step(params, window)  # (K, B, 1, C)
            combined = self._mix(weightings, preds, params["factors"])
            sims.append(combined)
            fw_preds.append(weightings)
            factor_preds.append(self._joined(preds))
            window = torch.cat([window[:, combined.shape[1]:, :], combined],
                               dim=1)
        return torch.cat(sims, dim=1), factor_preds, fw_preds, label_preds

    def _forward_post_weighted(self, params, X, fixed_weightings=None):
        """Weightings computed once; each factor rolls out its own
        autoregressive simulation; the weighted sum happens at completion."""
        cfg = self.config
        weightings, logits = self._embed(params, X)
        if fixed_weightings is not None:
            weightings = fixed_weightings
        if logits is None:
            logits = weightings
        label_preds = [logits for _ in range(cfg.num_sims)]

        last = X[:, -cfg.gen_lag:, :]
        factors = params["factors"]
        if isinstance(factors, FactorShards):
            # each block rolls out its own factors on its device
            per_block = [self._roll_out(f, last.to(_block_device(f)))
                         for f in factors]
            x_sims = self._mix(weightings, [fs for fs, _ in per_block],
                               factors)
            per_factor_sims = [self._joined([steps[i] for _, steps
                                             in per_block])
                               for i in range(cfg.num_sims)]
            return x_sims, per_factor_sims, [weightings], label_preds
        factor_sims, per_factor_sims = self._roll_out(factors, last)
        x_sims = factor_mix(weightings.contiguous(), factor_sims.contiguous())
        return x_sims, per_factor_sims, [weightings], label_preds

    def _roll_out(self, factors, last):
        """Every factor of ``factors`` simulates ``num_sims`` steps from
        ``last`` (B, gen_lag, C) on its own predictions: the stacked
        (K, B, S, C) simulations and the per-step (K, B, 1, C) list."""
        K = tree_leaves(factors)[0].shape[0]
        win = last[None].expand((K,) + tuple(last.shape))
        per_factor_sims = []
        for _ in range(self.config.num_sims):
            preds = self._factors_apply(factors, win)
            per_factor_sims.append(preds)                 # (K, B, 1, C)
            win = torch.cat([win[:, :, preds.shape[2]:, :], preds], dim=2)
        return torch.cat(per_factor_sims, dim=2), per_factor_sims

    # ---------------------------------------------------------------------- GC
    def factor_gc(self, params, threshold=False, ignore_lag=True,
                  combine_wavelet_representations=False, rank_wavelets=False):
        """(K, C, C[, L]) per-factor readouts; cLSTM factors read the
        input-weight column norms (a singleton lag axis when lagged).
        Factor blocks read each block on its device and join the graphs
        on the first block's."""
        cfg = self.config
        if isinstance(params["factors"], FactorShards):
            kw = dict(threshold=threshold, ignore_lag=ignore_lag,
                      combine_wavelet_representations=
                      combine_wavelet_representations,
                      rank_wavelets=rank_wavelets)
            return self._joined([self.factor_gc({"factors": f}, **kw)
                                 for f in params["factors"]])
        mask = None
        if rank_wavelets and cfg.wavelet_level is not None:
            mask = cmlp_mod.build_wavelet_ranking_mask(
                cfg.num_series,
                wavelets_per_chan=cfg.num_series // cfg.num_chans,
                device=tree_leaves(params["factors"])[0].device)
        if cfg.factor_network_type == "cLSTM":
            G = clstm_mod.clstm_gc(
                params["factors"], threshold=threshold, wavelet_mask=mask,
                rank_wavelets=rank_wavelets, num_chans=cfg.num_chans,
                combine_wavelet_representations=
                combine_wavelet_representations)
            return G if ignore_lag else G[..., None]
        return cmlp_mod.cmlp_gc(
            params["factors"], threshold=threshold, ignore_lag=ignore_lag,
            wavelet_mask=mask, rank_wavelets=rank_wavelets,
            num_chans=cfg.num_chans,
            combine_wavelet_representations=combine_wavelet_representations)

    def _raw_embedder_gc(self, params, threshold=False, ignore_lag=True,
                         combine_wavelet_representations=False,
                         rank_wavelets=False):
        """(K, C, Le) or (C, C, 1) depending on embedder type."""
        if isinstance(self.embedder, CEmbedder):
            G = self.embedder.gc(
                params["embedder"], threshold=threshold,
                ignore_lag=ignore_lag,
                combine_wavelet_representations=
                combine_wavelet_representations,
                rank_wavelets=rank_wavelets)
            if G.dim() == 2:
                G = G[:, :, None]
            return G
        if isinstance(self.embedder, DGCNNEmbedder):
            G = self.embedder.gc(
                params["embedder"], threshold=threshold,
                combine_node_feature_edges=combine_wavelet_representations)
            return G[:, :, None]
        raise ValueError("raw_embedder GC requires a causal embedder type "
                         "(cEmbedder or DGCNN)")

    def _fixed_embedder_gc(self, params, **kw):
        """'System' graph: per-lag outer product of the embedder rows over
        the factor axis, E[:, :, l] = R[:, :, l]^T R[:, :, l]."""
        R = self._raw_embedder_gc(params, **kw)
        if isinstance(self.embedder, DGCNNEmbedder):
            return R
        return _prec.einsum("kal,kbl->abl", R, R)

    def _conditional_embedder_gc(self, params, X, **kw):
        """(B, K, C, C, Le): per-sample per-factor outer products weighted by
        the window-conditioned factor weightings."""
        if isinstance(self.embedder, DGCNNEmbedder):
            raise ValueError("conditional_embedder_exclusive is not "
                             "supported for DGCNN embedders")
        R = self._raw_embedder_gc(params, **kw)
        weightings, _ = self._embed(params, X)
        outer = _prec.einsum("kal,kcl->kacl", R, R)  # (K, C, C, Le)
        return _prec.einsum("bk,kacl->bkacl", weightings, outer)

    def gc(self, params, gc_est_mode=None, X=None, threshold=False,
           ignore_lag=True, combine_wavelet_representations=False,
           rank_wavelets=False):
        """All 9 readout modes. Returns a (S, K', C, C, L') tensor, as the
        JAX package's ``gc``."""
        cfg = self.config
        mode = gc_est_mode or cfg.primary_gc_est_mode
        kw = dict(threshold=threshold, ignore_lag=ignore_lag,
                  combine_wavelet_representations=
                  combine_wavelet_representations,
                  rank_wavelets=rank_wavelets)

        def factor_g():
            G = self.factor_gc(params, **kw)
            return G[:, :, :, None] if G.dim() == 3 else G  # (K, C, C, L)

        lag_clip = min(cfg.gen_lag, cfg.embed_lag)

        if mode == "fixed_factor_exclusive":
            return factor_g()[None]
        if mode == "raw_embedder":
            return self._raw_embedder_gc(params, **kw)[None, None]
        if mode == "fixed_embedder_exclusive":
            return self._fixed_embedder_gc(params, **kw)[None, None]
        if mode == "conditional_factor_exclusive":
            weightings, _ = self._embed(params, X)
            return _prec.einsum("bk,kacl->bkacl", weightings, factor_g())
        if mode == "conditional_embedder_exclusive":
            return self._conditional_embedder_gc(params, X, **kw)
        if mode == "fixed_factor_fixed_embedder":
            G = factor_g()
            E = self._fixed_embedder_gc(params, **kw)
            if not ignore_lag:
                return (G[:, :, :, -lag_clip:]
                        + E[None, :, :, -lag_clip:])[None]
            return (G + E[None])[None]
        if mode == "conditional_factor_fixed_embedder":
            weightings, _ = self._embed(params, X)
            G = _prec.einsum("bk,kacl->bkacl", weightings, factor_g())
            E = self._fixed_embedder_gc(params, **kw)
            if not ignore_lag:
                return G[..., -lag_clip:] + E[None, None, :, :, -lag_clip:]
            return G + E[None, None]
        if mode == "fixed_factor_conditional_embedder":
            G = factor_g()
            Ec = self._conditional_embedder_gc(params, X, **kw)
            if not ignore_lag:
                return Ec[..., -lag_clip:] + G[None, :, :, :, -lag_clip:]
            return Ec + G[None]
        if mode == "conditional_factor_conditional_embedder":
            weightings, _ = self._embed(params, X)
            G = _prec.einsum("bk,kacl->bkacl", weightings, factor_g())
            Ec = self._conditional_embedder_gc(params, X, **kw)
            if not ignore_lag:
                return G[..., -lag_clip:] + Ec[..., -lag_clip:]
            return G + Ec
        raise ValueError(f"GC EST MODE == {mode} IS NOT SUPPORTED")

    def gc_as_lists(self, params, gc_est_mode=None, X=None, **kw):
        """Host view of :meth:`gc` in the reference's list-of-lists
        contract: outer list by sample, inner by factor, numpy (C, C, L)
        arrays, from one device-to-host copy."""
        arr = self.gc(params, gc_est_mode, X=X, **kw).detach().cpu().numpy()
        return [[arr[s, k] for k in range(arr.shape[1])]
                for s in range(arr.shape[0])]

    # -------------------------------------------------------------------- loss
    def compute_loss(self, params, conditioning_X, preds, targets,
                     factor_scores, factor_labels, gc_est_mode=None,
                     embedder_pretrain_loss=False, factor_pretrain_loss=False,
                     coeffs=None, need_gc=None, need_gc_lagged=None):
        """The multi-term loss and its parts, as the JAX package's.

        factor_scores: list (num_sims) of (B, n) state-label predictions.
        factor_labels: Y with shape (B, S, T) | (B, S, 1) | (B, S).
        coeffs: optional per-call coefficient overrides (numbers or
        tensors); with tensor coefficients the caller decides
        ``need_gc``/``need_gc_lagged``, as with JAX's traced ones.
        """
        cfg = self.config
        mode = gc_est_mode or cfg.primary_gc_est_mode

        def C(name):
            if coeffs is not None and name in coeffs:
                return coeffs[name]
            return getattr(cfg, name)

        if need_gc is None:
            need_gc = _smooth_on(C("factor_cos_sim_coeff"))
        if need_gc_lagged is None:
            need_gc_lagged = _smooth_on(C("adj_l1_reg_coeff"))
        gc = (self.gc(params, mode, X=conditioning_X, threshold=False,
                      ignore_lag=True) if need_gc else None)
        gc_lagged = (self.gc(params, mode, X=conditioning_X, threshold=False,
                             ignore_lag=False) if need_gc_lagged else None)

        zero = torch.zeros((), dtype=preds.dtype, device=preds.device)
        forecasting_loss = C("forecast_coeff") * L.channelwise_forecast_mse(
            preds, targets)

        factor_loss = zero
        S = cfg.num_supervised_factors
        if factor_scores and factor_scores[0] is not None and S > 0:
            Y = factor_labels
            if Y.dim() == 3:
                if Y.shape[2] > cfg.max_lag:
                    # per-sim-step supervision from the aligned label trace
                    for l, yhat in enumerate(factor_scores):
                        if cfg.max_lag + l >= Y.shape[2]:
                            break
                        y = Y[:, :, cfg.max_lag + l]
                        factor_loss = factor_loss + C("factor_score_coeff") \
                            * torch.mean((yhat[:, :S] - y[:, :S]) ** 2)
                else:
                    # static-label datasets (D4IC): average all sim scores
                    y = Y[:, :, 0]
                    yhat = sum(factor_scores) / float(len(factor_scores))
                    factor_loss = factor_loss + C("factor_score_coeff") \
                        * torch.mean((yhat[:, :S] - y[:, :S]) ** 2)
            elif Y.dim() == 2:
                yhat = sum(factor_scores) / float(len(factor_scores))
                factor_loss = factor_loss + C("factor_score_coeff") \
                    * torch.mean((yhat[:, :S] - Y[:, :S]) ** 2)
            else:
                raise NotImplementedError(f"labels with ndim {Y.dim()}")

        fw_l1_penalty = C("factor_weight_l1_coeff") * L.factor_weight_l1(
            factor_scores[0])

        # smoothing penalty on factor scores across sim steps; the masks
        # carry no gradient (stop_gradient in the JAX package)
        fw_smoothing_penalty = zero
        if (_smooth_on(C("factor_weight_smoothing_penalty_coeff"))
                and cfg.num_sims >= 2):
            if cfg.num_sims == 2:
                diff = factor_scores[0] - factor_scores[1]
                mask = (diff > cfg.state_score_smoothing_epsilon).to(
                    diff.dtype)
                fw_smoothing_penalty = torch.sum((diff * mask) ** 2)
            else:
                for i in range(cfg.num_sims - 2):
                    s0, s1, s2 = (factor_scores[i], factor_scores[i + 1],
                                  factor_scores[i + 2])
                    full = (s2 - s0).detach().abs()
                    d21 = s2 - s1
                    m21 = (d21.detach().abs() > full).to(d21.dtype)
                    fw_smoothing_penalty = fw_smoothing_penalty \
                        + torch.sum((d21 * m21) ** 2)
                    if i == 0:
                        d10 = s1 - s0
                        m10 = (d10.detach().abs() > full).to(d10.dtype)
                        fw_smoothing_penalty = fw_smoothing_penalty \
                            + torch.sum((d10 * m10) ** 2)
            fw_smoothing_penalty = (
                C("factor_weight_smoothing_penalty_coeff")
                * fw_smoothing_penalty)

        # cosine-similarity penalty between factor graphs, summed over
        # samples; the lag axis of the unlagged readout has size 1
        factor_cos_sim_penalty = zero
        if need_gc and gc.shape[1] > 1:
            G2 = gc[..., 0] if gc.dim() == 5 else gc
            factor_cos_sim_penalty = C("factor_cos_sim_coeff") * torch.sum(
                L.pairwise_cosine_penalty(G2, include_diag=False))

        adj_l1_penalty = zero
        if need_gc_lagged:
            adj_l1_penalty = C("adj_l1_reg_coeff") \
                * L.lag_weighted_adjacency_l1(gc_lagged)

        if embedder_pretrain_loss:
            if factor_pretrain_loss:
                raise ValueError("embedder and factor pretrain losses are "
                                 "exclusive")
            combo = factor_loss + fw_l1_penalty + fw_smoothing_penalty
        elif factor_pretrain_loss:
            combo = (forecasting_loss + fw_l1_penalty + fw_smoothing_penalty
                     + adj_l1_penalty + factor_cos_sim_penalty)
        else:
            combo = (forecasting_loss + factor_loss + fw_l1_penalty
                     + fw_smoothing_penalty + adj_l1_penalty
                     + factor_cos_sim_penalty)

        parts = {
            "forecasting_loss": forecasting_loss,
            "factor_loss": factor_loss,
            "factor_cos_sim_penalty": factor_cos_sim_penalty,
            "fw_l1_penalty": fw_l1_penalty,
            "fw_smoothing_penalty": fw_smoothing_penalty,
            "adj_l1_penalty": adj_l1_penalty,
        }
        return combo, parts

    def loss_for_phase(self, params, X, Y, phase, coeffs=None, need_gc=None,
                       need_gc_lagged=None):
        """One batch's loss under a training phase: 'embedder_pretrain',
        'factor_pretrain', 'combined' or 'post_train'."""
        cfg = self.config
        W = cfg.max_lag
        x_sims, _, _, label_preds = self.forward(params, X[:, :W, :])
        targets = X[:, W: W + cfg.num_sims * cfg.output_length, :]
        conditioning = X[:, : cfg.embed_lag, :]
        return self.compute_loss(
            params, conditioning, x_sims, targets, label_preds, Y,
            embedder_pretrain_loss=(phase == "embedder_pretrain"),
            factor_pretrain_loss=(phase in ("factor_pretrain", "post_train")),
            coeffs=coeffs, need_gc=need_gc, need_gc_lagged=need_gc_lagged,
        )

    # ------------------------------------------------------------------- prox
    def apply_prox(self, params, lam, lr, penalty="GL"):
        """GISTA proximal update on the stacked factor first-layer block
        (K, C_out, H, C_in, L); GL on the card runs the CUDA kernel
        (ops/pallas_prox.py). Functional: returns a new params tree.
        cMLP factors only: a cLSTM factor has no lag-structured first-layer
        block to group."""
        self._require_cmlp_factors()
        factors = params["factors"]
        if isinstance(factors, FactorShards):
            return dict(params, factors=FactorShards(
                self.apply_prox({"factors": f}, lam, lr, penalty)["factors"]
                for f in factors))
        new_w = gl_prox(factors[0]["w"], lam, lr, penalty)
        new_factors = [dict(factors[0], w=new_w)] + list(factors[1:])
        return dict(params, factors=new_factors)

    def apply_prox_(self, params, lam, lr, penalty="GL"):
        """:meth:`apply_prox` in place on ``params["factors"][0]["w"]``
        (ops/pallas_prox.py ``gl_prox_``): on the card, GL is one kernel
        launch with no allocation or copy. JAX's update is functional; the
        port updates the live block in place because nothing else holds
        its storage (the trainer keeps every other tree as a copy). Call
        under ``torch.no_grad()``. Returns ``params``."""
        self._require_cmlp_factors()
        factors = params["factors"]
        if not isinstance(factors, FactorShards):
            gl_prox_(factors[0]["w"], lam, lr, penalty)
            return params
        # one launch per factor block, each on its block's device
        for b, f in enumerate(factors):
            gl_prox_(f[0]["w"], lam, lr, penalty)
            _block_launch("gl_prox", b, f[0]["w"])
        return params

    def apply_prox_lanes_(self, params, thresholds, gate, penalty="GL"):
        """The coefficient grid's prox: :meth:`apply_prox_` in place on the
        stacked block ``params["factors"][0]["w"]`` of shape
        ``(G, K, C_out, H, C_in, L)``, lane g at threshold
        ``thresholds[g]`` where ``gate[g]`` and untouched elsewhere
        (``ops/pallas_prox.py gl_prox_lanes_``: one kernel launch for all
        lanes on the card). Call under ``torch.no_grad()``. Returns
        ``params``."""
        self._require_cmlp_factors()
        gl_prox_lanes_(params["factors"][0]["w"], thresholds, gate, penalty)
        return params

    def _require_cmlp_factors(self):
        if self.config.factor_network_type != "cMLP":
            raise ValueError(
                "apply_prox requires cMLP factor networks (the GL group "
                "structure lives in the lagged first-layer block)")

    # -------------------------------------------------------- factor alignment
    def permute_factors(self, params, order):
        """Reorder the stacked factor params along K (factor blocks are
        joined, reordered and split again over their devices)."""
        if isinstance(params["factors"], FactorShards):
            from redcliff_tpu_torch.parallel.mesh import DeviceMesh

            mesh = DeviceMesh([_block_device(f) for f in params["factors"]])
            joined = unshard_factor_axis(params)
            return shard_factor_axis(self.permute_factors(joined, order),
                                     mesh)
        idx = torch.as_tensor(list(order), dtype=torch.long)
        factors = tree_map(lambda v: v[idx.to(v.device)], params["factors"])
        return dict(params, factors=factors)

    def normalization_coeffs(self):
        cfg = self.config
        return {
            "forecasting_loss": cfg.forecast_coeff,
            "factor_loss": cfg.factor_score_coeff,
            "factor_cos_sim_penalty": cfg.factor_cos_sim_coeff,
            "fw_l1_penalty": cfg.factor_weight_l1_coeff,
            "fw_smoothing_penalty": cfg.factor_weight_smoothing_penalty_coeff,
            "adj_l1_penalty": cfg.adj_l1_reg_coeff,
        }


def _block_device(factors):
    """The device a factor block lives on."""
    return tree_leaves(factors)[0].device
