"""Orchestration: model factory, data dispatch, fit and eval dispatch
(port of ``train/orchestration.py``).

An args dict produced by ``utils/config.py`` maps onto the model config
and the trainer:

* :func:`create_model_instance` builds every family of the JAX dispatch:
  REDCLIFF-S with cMLP factors (and its smoothing variant) or cLSTM
  factors (``REDCLIFF_S_CLSTM``), cMLP-FM, cLSTM-FM, NAVAR (MLP and LSTM),
  DGCNN, DCSFA-NMF (``FullDCSFAModel``, its GC layout from the signal
  format) and DYNOTEARS (Vanilla and Stochastic). The reference's
  declared-but-absent ``REDCLIFF_S_DGCNN`` raises as in the JAX package.
* :func:`get_data_for_model_training` loads the fold's (train,
  validation) datasets, with the feature format and directed-spectrum
  parameters the family asks for.
* :func:`call_model_fit_method` fits REDCLIFF-S with the port's
  ``RedcliffTrainer``, DCSFA-NMF with its own fit loop on the device, the
  two DYNOTEARS models with their host solver, and the other families
  with the generic ``Trainer``. A model is initialised by the port's own
  ``init`` from a generator seeded with ``seed`` (the JAX package draws
  from ``jax.random.PRNGKey(seed)``, which torch cannot match). As in the
  JAX dispatch, neither trainer's config sets a prox.
* :func:`call_model_eval_method` decomposes a fitted model's validation
  loss per family, in the reference's positional order.
* :func:`generate_signal_from_sequential_factor_model` rolls a factor
  model forward autoregressively.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from redcliff_tpu_torch.interop import tree_leaves

__all__ = ["create_model_instance", "get_data_for_model_training",
           "call_model_fit_method", "call_model_eval_method",
           "generate_signal_from_sequential_factor_model"]


def generate_signal_from_sequential_factor_model(model, params, x0,
                                                 sim_steps):
    """Autoregressive signal generation from a trained factor model: from
    the context window ``x0`` (B, context, C), predict one step, slide the
    window, repeat ``sim_steps`` times. Works with any model whose
    ``forward(params, window)`` returns the simulated steps first (the
    REDCLIFF variants, cMLP-FM, cLSTM-FM). Returns (B, sim_steps, C) on the
    params' device."""
    window = torch.as_tensor(x0, dtype=torch.float32).to(
        tree_leaves(params)[0].device)
    preds = []
    with torch.no_grad():
        for _ in range(sim_steps):
            out = model.forward(params, window)
            sims = out[0] if isinstance(out, tuple) else out
            pred = sims[:, 0, :]
            preds.append(pred)
            window = torch.cat([window[:, 1:, :], pred[:, None, :]], dim=1)
    return torch.stack(preds, dim=1)


def _coeff(args_dict, key, default=0.0):
    return float(args_dict.get("coeff_dict", {}).get(key, default))


def _build_redcliff(args_dict, employ_version_with_smoothing_loss,
                    factor_network_type, gen_lag, gen_hidden, embed_lag,
                    **coeff_overrides):
    """The REDCLIFF-S config shared by the cMLP and cLSTM factor variants
    (they differ in lag and width sourcing and factor_network_type)."""
    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)

    emb_args = dict(args_dict.get("factor_score_embedder_args", []))
    smoothing_coeff = _coeff(args_dict,
                             "FACTOR_WEIGHT_SMOOTHING_PENALTY_COEFF") \
        if employ_version_with_smoothing_loss else 0.0
    cfg = RedcliffSCMLPConfig(
        num_chans=args_dict["num_channels"],
        gen_lag=gen_lag,
        gen_hidden=gen_hidden,
        embed_lag=embed_lag,
        embed_hidden_sizes=tuple(args_dict["embed_hidden_sizes"]),
        num_factors=args_dict["num_factors"],
        num_supervised_factors=args_dict["num_supervised_factors"],
        factor_network_type=factor_network_type,
        forecast_coeff=_coeff(args_dict, "FORECAST_COEFF", 1.0),
        factor_score_coeff=_coeff(args_dict, "FACTOR_SCORE_COEFF"),
        factor_cos_sim_coeff=_coeff(args_dict, "FACTOR_COS_SIM_COEFF"),
        factor_weight_l1_coeff=_coeff(args_dict, "FACTOR_WEIGHT_L1_COEFF"),
        adj_l1_reg_coeff=_coeff(args_dict, "ADJ_L1_REG_COEFF"),
        dagness_reg_coeff=_coeff(args_dict, "DAGNESS_REG_COEFF"),
        use_sigmoid_restriction=args_dict["use_sigmoid_restriction"],
        sigmoid_eccentricity_coeff=emb_args.get(
            "sigmoid_eccentricity_coeff", 10.0),
        factor_score_embedder_type=args_dict["factor_score_embedder_type"],
        dgcnn_num_graph_conv_layers=emb_args.get("num_graph_conv_layers", 2),
        dgcnn_num_hidden_nodes=emb_args.get("num_hidden_nodes", 32),
        primary_gc_est_mode=args_dict["primary_gc_est_mode"],
        forward_pass_mode=args_dict["forward_pass_mode"],
        num_sims=args_dict["num_sims"],
        wavelet_level=args_dict.get("wavelet_level"),
        training_mode=args_dict["training_mode"],
        num_pretrain_epochs=args_dict["num_pretrain_epochs"],
        num_acclimation_epochs=args_dict.get("num_acclimation_epochs", 0),
        factor_weight_smoothing_penalty_coeff=smoothing_coeff,
        **coeff_overrides,
    )
    return RedcliffSCMLP(cfg)


def _navar_config(cls, args_dict):
    return cls(num_nodes=args_dict["num_nodes"],
               num_hidden=args_dict["num_hidden"],
               maxlags=args_dict["maxlags"],
               hidden_layers=args_dict["hidden_layers"],
               dropout=args_dict["dropout"],
               lambda1=float(args_dict.get("lambda1", 0.0)))


def create_model_instance(args_dict, employ_version_with_smoothing_loss=False):
    """The model an args dict describes (substring dispatch on
    ``model_type``, in the JAX package's order)."""
    model_type = args_dict["model_type"]

    if "REDCLIFF" in model_type and "DGCNN" in model_type:
        raise NotImplementedError(
            f"{model_type} is declared by the reference factory "
            "(model_utils.py:344) but its model file was never "
            "published; see SURVEY.md §2.2")

    if "REDCLIFF" in model_type and "CLSTM" in model_type:
        # the cLSTM-family schema carries context / num_in_timesteps
        # instead of gen_lag / embed_lag, and an int gen_hidden
        if "_S_" not in model_type:
            raise NotImplementedError(
                "only the supervised REDCLIFF_S_CLSTM variant is defined")
        gen_hidden = args_dict["gen_hidden"]
        if isinstance(gen_hidden, int):
            gen_hidden = (gen_hidden,)
        return _build_redcliff(
            args_dict, employ_version_with_smoothing_loss,
            factor_network_type="cLSTM",
            gen_lag=args_dict["context"],
            gen_hidden=tuple(gen_hidden),
            embed_lag=args_dict.get("num_in_timesteps",
                                    args_dict.get("embed_lag",
                                                  args_dict["context"])))

    if "REDCLIFF" in model_type and "CMLP" in model_type:
        if "_S_" not in model_type:
            # the reference factory raises here too
            raise NotImplementedError(
                "only the supervised REDCLIFF_S_CMLP variant exists; the "
                "unsupervised REDCLIFF_CMLP is unimplemented in the "
                "reference as well")
        return _build_redcliff(
            args_dict, employ_version_with_smoothing_loss,
            factor_network_type="cMLP",
            gen_lag=args_dict["gen_lag"],
            gen_hidden=tuple(args_dict["gen_hidden"]),
            embed_lag=args_dict["embed_lag"],
            dagness_lag_coeff=_coeff(args_dict, "DAGNESS_LAG_COEFF"),
            dagness_node_coeff=_coeff(args_dict, "DAGNESS_NODE_COEFF"))

    if "cMLP" in model_type or "CMLP" in model_type:
        if "NAVAR" in model_type:
            from redcliff_tpu_torch.models.navar import NAVAR, NAVARConfig
            return NAVAR(_navar_config(NAVARConfig, args_dict))
        from redcliff_tpu_torch.models.cmlp_fm import CMLPFM, CMLPFMConfig
        return CMLPFM(CMLPFMConfig(
            num_chans=args_dict["num_channels"],
            gen_lag=args_dict["gen_lag"],
            gen_hidden=tuple(args_dict["gen_hidden"]),
            input_length=args_dict["input_length"],
            num_sims=args_dict["num_sims"],
            forecast_coeff=_coeff(args_dict, "FORECAST_COEFF", 1.0),
            adj_l1_coeff=_coeff(args_dict, "ADJ_L1_REG_COEFF"),
            wavelet_level=args_dict.get("wavelet_level")))

    if "cLSTM" in model_type or "CLSTM" in model_type:
        if "NAVAR" in model_type:
            from redcliff_tpu_torch.models.navar import (NAVARLSTM,
                                                         NAVARLSTMConfig)
            return NAVARLSTM(_navar_config(NAVARLSTMConfig, args_dict))
        from redcliff_tpu_torch.models.clstm_fm import CLSTMFM, CLSTMFMConfig
        return CLSTMFM(CLSTMFMConfig(
            num_chans=args_dict["num_channels"],
            gen_hidden=args_dict["gen_hidden"],
            context=args_dict["context"],
            max_input_length=args_dict.get("max_input_length"),
            forecast_coeff=_coeff(args_dict, "FORECAST_COEFF", 1.0),
            adj_l1_coeff=_coeff(args_dict, "ADJ_L1_REG_COEFF"),
            dagness_coeff=_coeff(args_dict, "DAGNESS_REG_COEFF"),
            wavelet_level=args_dict.get("wavelet_level")))

    if "DCSFA" in model_type:
        from redcliff_tpu_torch.models.dcsfa_nmf import (DcsfaNmfConfig,
                                                         FullDCSFAModel)
        layout = "vanilla" if "vanilla" in args_dict.get(
            "signal_format", "") else "dirspec"
        return FullDCSFAModel(
            num_nodes=args_dict["num_channels"],
            num_high_level_node_features=args_dict[
                "num_high_level_node_features"],
            gc_feature_layout=layout,
            config=DcsfaNmfConfig(
                n_components=args_dict["n_components"],
                n_sup_networks=args_dict["n_sup_networks"],
                h=args_dict["h"],
                momentum=args_dict["momentum"],
                lr=args_dict["lr"],
                recon_weight=args_dict["recon_weight"],
                sup_weight=args_dict["sup_weight"],
                sup_recon_weight=args_dict["sup_recon_weight"],
                sup_smoothness_weight=args_dict["sup_smoothness_weight"]))

    if "DGCNN" in model_type:
        from redcliff_tpu_torch.models.dgcnn import DGCNNConfig, DGCNNModel
        return DGCNNModel(DGCNNConfig(
            num_channels=args_dict["num_channels"],
            num_wavelets_per_chan=args_dict.get("num_wavelets_per_chan", 1),
            num_features_per_node=args_dict["num_features_per_node"],
            num_graph_conv_layers=args_dict["num_graph_conv_layers"],
            num_hidden_nodes=args_dict["num_hidden_nodes"],
            num_classes=args_dict["num_classes"]))

    if "DYNOTEARS" in model_type:
        from redcliff_tpu_torch.models.dynotears import (
            DynotearsConfig, DynotearsModel, DynotearsVanillaModel)
        cfg = DynotearsConfig(
            lambda_w=args_dict["lambda_w"],
            lambda_a=args_dict["lambda_a"],
            max_iter=args_dict["max_iter"],
            h_tol=args_dict["h_tol"],
            w_threshold=args_dict["w_threshold"],
            lag_size=args_dict["lag_size"],
            grad_step=float(args_dict.get("grad_step", 1.0)),
            tabu_edges=args_dict.get("tabu_edges"),
            tabu_parent_nodes=args_dict.get("tabu_parent_nodes"),
            tabu_child_nodes=args_dict.get("tabu_child_nodes"),
            reuse_rho=bool(args_dict.get("reuse_rho", False)),
            reuse_alpha=bool(args_dict.get("reuse_alpha", False)),
            reuse_h_val=bool(args_dict.get("reuse_h_val", False)),
            reuse_h_new=bool(args_dict.get("reuse_h_new", False)))
        if "Vanilla" in model_type:
            return DynotearsVanillaModel(cfg)
        return DynotearsModel(cfg)

    raise ValueError(f"UNRECOGNIZED model_type == {model_type}")


def get_data_for_model_training(args_dict, grid_search=True, shuffle=True,
                                shuffle_seed=0, device=None):
    """(train, validation) datasets for a parsed args dict: the
    data_root_path holds the fold in the shared shard layout; the signal
    format and directed-spectrum parameters follow the model family. With
    ``device`` the resident copies are placed there, except for DYNOTEARS,
    whose solver reads host windows only."""
    from redcliff_tpu_torch.data.shards import load_normalized_split_datasets

    if "DYNOTEARS" in args_dict.get("model_type", ""):
        device = None
    return load_normalized_split_datasets(
        args_dict["data_root_path"],
        signal_format=args_dict.get("signal_format", "original"),
        shuffle=shuffle, shuffle_seed=shuffle_seed,
        max_num_features_per_series=args_dict.get(
            "max_num_features_per_series",
            args_dict.get("num_node_features")),
        dirspec_params=args_dict.get("dirspec_params"),
        grid_search=grid_search,
        average_region_map=args_dict.get("average_region_map"),
        wavelet_level=args_dict.get("wavelet_level"),
        device=device)


def call_model_fit_method(model, args_dict, train_ds, val_ds, save_dir=None,
                          seed=0, device=None):
    """Fit a model from its port-drawn init on ``device`` (``cuda``
    unless given): REDCLIFF-S through ``RedcliffTrainer``, DCSFA-NMF
    through its own fit (returns ``((params, state), histories)``),
    DYNOTEARS on the host whatever ``device`` says (returns ``(its GC
    matrix, the model)``), the other families through the generic
    ``Trainer``. Returns ``(best params, fit result)``."""
    from redcliff_tpu_torch.models.dcsfa_nmf import DcsfaNmf
    from redcliff_tpu_torch.models.dynotears import (DynotearsModel,
                                                     DynotearsVanillaModel)
    from redcliff_tpu_torch.models.redcliff import RedcliffSCMLP

    save_dir = save_dir or args_dict.get("save_path")
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    generator = torch.Generator().manual_seed(seed)

    if isinstance(model, RedcliffSCMLP):
        from redcliff_tpu_torch.train.redcliff_trainer import (
            RedcliffTrainConfig, RedcliffTrainer)
        tc = RedcliffTrainConfig(
            embed_lr=args_dict["embed_lr"],
            embed_eps=args_dict["embed_eps"],
            embed_weight_decay=args_dict["embed_weight_decay"],
            gen_lr=args_dict["gen_lr"],
            gen_eps=args_dict["gen_eps"],
            gen_weight_decay=args_dict["gen_weight_decay"],
            max_iter=args_dict["max_iter"],
            lookback=args_dict["lookback"],
            check_every=args_dict["check_every"],
            batch_size=args_dict["batch_size"],
            verbose=args_dict.get("verbose", 0),
            seed=seed,
            stopping_criteria_forecast_coeff=args_dict.get(
                "stopping_criteria_forecast_coeff", 1.0),
            stopping_criteria_factor_coeff=args_dict.get(
                "stopping_criteria_factor_coeff", 1.0),
            stopping_criteria_cosSim_coeff=args_dict.get(
                "stopping_criteria_cosSim_coeff", 1.0),
            max_factor_prior_batches=args_dict.get(
                "max_factor_prior_batches", 10),
            unsupervised_start_index=args_dict.get(
                "unsupervised_start_index", 0))
        trainer = RedcliffTrainer(model, tc, device=device)
    elif isinstance(model, (DynotearsModel, DynotearsVanillaModel)):
        if isinstance(model, DynotearsVanillaModel):
            model.fit(train_ds.X, save_dir=save_dir)
            return model.gc(), model
        model.fit(train_ds, val_ds, save_dir=save_dir,
                  max_data_iter=args_dict.get("max_data_iter", 10),
                  batch_size=args_dict.get("batch_size", 32),
                  num_iters_prior_to_stop=args_dict.get(
                      "num_iters_prior_to_stop", 10),
                  check_every=args_dict.get("check_every", 5),
                  verbose=bool(args_dict.get("verbose", 0)))
        return model.gc(), model
    elif isinstance(model, DcsfaNmf):
        if getattr(train_ds, "X_features", None) is None:
            raise ValueError(
                "DCSFA training requires feature-format datasets "
                "(signal_format='directed_spectrum*'); got raw windows")

        def features(ds):
            """The features on the device when the loader placed them."""
            return getattr(ds, "device_features", ds.X_features)

        def dcsfa_labels(ds):
            """Label traces (N, R, T) average over time (the reference's
            average_label_over_time_steps=True) and slice to the fit
            contract's n_sup_networks columns."""
            y = np.asarray(ds.Y)
            if y.ndim == 3:
                y = y.mean(axis=2)
            y = y.reshape(len(ds), -1)
            return y[:, : model.config.n_sup_networks]

        params, state, hist = model.fit(
            generator, features(train_ds), dcsfa_labels(train_ds),
            X_val=features(val_ds), y_val=dcsfa_labels(val_ds),
            n_epochs=args_dict.get("n_epochs", 100),
            n_pre_epochs=args_dict.get("n_pre_epochs", 100),
            nmf_max_iter=args_dict.get("nmf_max_iter", 100),
            batch_size=args_dict.get("batch_size", 128),
            save_folder=save_dir,
            best_model_name=args_dict.get("best_model_name",
                                          "dCSFA-NMF-best-model.pkl"),
            device=device)
        return (params, state), hist
    else:
        # the generic single-optimizer families (cMLP-FM, cLSTM-FM, NAVAR,
        # NAVAR-LSTM, DGCNN)
        from redcliff_tpu_torch.train.trainer import TrainConfig, Trainer
        tc = TrainConfig(
            learning_rate=args_dict.get("gen_lr",
                                        args_dict.get("learning_rate", 1e-3)),
            max_iter=args_dict.get("max_iter", args_dict.get("epochs", 100)),
            lookback=args_dict.get("lookback", 5),
            check_every=args_dict.get("check_every", 50),
            batch_size=args_dict.get("batch_size", 32),
            seed=seed,
            verbose=args_dict.get("verbose", 0))
        # DGCNN is the one supervised classifier among the generic
        # families; the forecasters use labels only for GC tracking
        trainer = Trainer(model, tc,
                          has_labels="DGCNN" in args_dict["model_type"],
                          device=device)
    params = model.init(generator, trainer.device)
    result = trainer.fit(params, train_ds, val_ds,
                         true_GC=args_dict.get("true_GC_factors"),
                         save_dir=save_dir)
    return result.params, result



def _avg_loss_parts(loss_fn, val_ds, batch_size, device):
    """Average (combo, parts) of ``loss_fn(X, Y)`` over the validation
    batches, accumulated on the device (one host copy at the end)."""
    combo_sum = 0.0
    part_sums = {}
    n = 0
    with torch.no_grad():
        for X, Y in val_ds.batches(batch_size, device=device):
            combo, parts = loss_fn(X, Y)
            combo_sum = combo_sum + combo
            for k, v in parts.items():
                part_sums[k] = part_sums.get(k, 0.0) + v
            n += 1
    if n == 0:
        raise ValueError("validation dataset yielded no batches")
    names = list(part_sums)
    host = torch.stack([torch.as_tensor(combo_sum, device=device)]
                       + [torch.as_tensor(part_sums[k], device=device)
                          for k in names]).tolist()
    out = {k: v / n for k, v in zip(names, host[1:])}
    out["combo_loss"] = host[0] / n
    return out


def _normalized_gc_l1(gc):
    gc = np.asarray(gc, dtype=np.float64)
    return float(np.abs(gc / max(np.max(np.abs(gc)), 1e-12)).sum())


def call_model_eval_method(model, params, args_dict, val_ds, state=None):
    """The per-family "evaluate this trained model" dispatch: each family's
    validation-loss decomposition (plus the GC-L1 terms grid selection
    reads), on the device the params live on. DCSFA-NMF takes its
    ``(params, state)`` as ``params`` or its state as ``state``; the
    DYNOTEARS models evaluate on the host.

    Returns a dict with a ``components`` list in the reference's
    positional order for that family plus the same values under stable
    names. The reference's cMLP and cLSTM branches append ``components +
    components + [l1]`` (the list doubled before the L1 is appended); that
    layout is kept so index-based consumers match."""
    from redcliff_tpu_torch.models.clstm_fm import CLSTMFM
    from redcliff_tpu_torch.models.cmlp_fm import CMLPFM
    from redcliff_tpu_torch.models.dcsfa_nmf import DcsfaNmf
    from redcliff_tpu_torch.models.dgcnn import DGCNNModel
    from redcliff_tpu_torch.models.dynotears import (DynotearsModel,
                                                     DynotearsVanillaModel)
    from redcliff_tpu_torch.models.navar import NAVAR, NAVARLSTM
    from redcliff_tpu_torch.models.redcliff import RedcliffSCMLP

    batch_size = int(args_dict.get("batch_size", 32))

    if isinstance(model, DcsfaNmf):
        # the recon and score MSEs on the params' device, the GC MSEs
        # against the summed truth on the host (an empty list for real
        # datasets, whose config sets true_GC_tensor to None)
        if state is None and isinstance(params, tuple) and len(params) == 2:
            params, state = params
        true_gc = args_dict.get("true_GC_tensor")
        if true_gc is None:
            true_gc = []
        summary = model.evaluate(
            params, state, getattr(val_ds, "X_features", val_ds.X),
            np.asarray(val_ds.Y).reshape(len(val_ds), -1),
            true_gc,
            save_path=args_dict.get("save_root_path"),
            threshold=False, ignore_features=True)
        return {"components": [summary["recon_mse"], summary["avg_recon_mse"],
                               summary["score_mse"], summary["avg_score_mse"],
                               summary["gc_mse"]], **summary}

    if isinstance(model, DynotearsModel):
        avg = float(model._mean_objective(val_ds, batch_size))
        return {"components": [avg], "avg_val_loss": avg}

    if isinstance(model, DynotearsVanillaModel):
        from redcliff_tpu_torch.models.dynotears import (_split_windows,
                                                         dynotears_objective)
        cfg = model.config
        a = np.asarray(model.gc(), dtype=np.float64)
        d = a.shape[0]
        # score the averaged lagged graph as a single-lag solution with no
        # intra-window W, in the solver's (plus, minus)-split vector layout
        # (reshape_wa contract: W+ rows, W- rows, then A+/A- flat blocks)
        wa = np.concatenate([
            np.zeros(2 * d * d),              # W+ = W- = 0
            np.maximum(a, 0.0).reshape(-1),   # A+
            np.maximum(-a, 0.0).reshape(-1),  # A-
        ])
        total, count = 0.0, 0
        for X, _ in val_ds.batches(batch_size):
            for b in range(X.shape[0]):
                x_in, x_lag = _split_windows(
                    np.asarray(X[b], np.float64), cfg.lag_size)
                total += dynotears_objective(
                    x_in, x_lag, wa, 0.0, 0.0, d, 1,
                    cfg.lambda_a, cfg.lambda_w, x_in.shape[0])
                count += 1
        avg = total / max(count, 1)
        return {"components": [avg], "avg_val_loss": avg}

    device = tree_leaves(params)[0].device

    def avg(loss_fn):
        return _avg_loss_parts(loss_fn, val_ds, batch_size, device)

    if isinstance(model, RedcliffSCMLP):
        coeffs = model.normalization_coeffs()
        parts = avg(lambda X, Y: model.loss_for_phase(params, X, Y,
                                                      "combined"))
        norm = {k: v / (coeffs.get(k, 1.0) or 1.0) for k, v in parts.items()}
        if model.config.factor_network_type == "cLSTM":
            order = ("forecasting_loss", "factor_loss",
                     "factor_cos_sim_penalty", "fw_l1_penalty",
                     "adj_l1_penalty", "dagness_reg_penalty", "combo_loss")
        else:  # the cMLP variant carries the lag and node dagness terms
            order = ("forecasting_loss", "factor_loss",
                     "factor_cos_sim_penalty", "fw_l1_penalty",
                     "adj_l1_penalty", "dagness_reg_penalty",
                     "dagness_lag_penalty", "dagness_node_penalty",
                     "combo_loss")
        named = {k: norm.get(k, 0.0) for k in order}
        return {"components": [named[k] for k in order], **named}

    if isinstance(model, (NAVAR, NAVARLSTM)):
        parts = avg(lambda X, Y: model.loss(params, X))
        named = {
            "forecasting_loss": parts.get("forecasting_loss", 0.0),
            "contribution_l1": parts.get("contribution_l1", 0.0),
            "combo_loss": parts["combo_loss"],
        }
        return {"components": list(named.values()), **named}

    if isinstance(model, CMLPFM):
        parts = avg(lambda X, Y: model.loss(params, X))
        named = {
            "forecasting_loss": parts.get("forecasting_loss", 0.0),
            "adj_l1_penalty": parts.get("adj_l1_penalty", 0.0),
            "dagness_reg_penalty": parts.get("dagness_reg_penalty", 0.0),
            "dagness_lag_penalty": parts.get("dagness_lag_penalty", 0.0),
            "dagness_node_penalty": parts.get("dagness_node_penalty", 0.0),
            "combo_loss": parts["combo_loss"],
        }
        comps = list(named.values())
        with torch.no_grad():
            gc = model.gc(params, ignore_lag=False)[0].cpu().numpy()
        l1 = _normalized_gc_l1(gc)
        named["normalized_gc_l1"] = l1
        return {"components": comps + comps + [l1], **named}

    if isinstance(model, CLSTMFM):
        parts = avg(lambda X, Y: model.loss(params, X))
        named = {
            "forecasting_loss": parts.get("forecasting_loss", 0.0),
            "adj_l1_penalty": parts.get("adj_l1_penalty", 0.0),
            "dagness_penalty": parts.get("dagness_penalty", 0.0),
            "smoothing_penalty": parts.get("smoothing_penalty", 0.0),
            "combo_loss": parts["combo_loss"],
        }
        comps = list(named.values())
        with torch.no_grad():
            l1 = float(torch.sum(torch.abs(model.gc(params)[0])))
        named["gc_l1"] = l1
        return {"components": comps + comps + [l1], **named}

    if isinstance(model, DGCNNModel):
        parts = avg(lambda X, Y: model.loss(params, X, Y))
        # the GC estimate rescaled to the true no-lag max (1.6) before the
        # L1, as the reference does
        with torch.no_grad():
            gc = model.gc(params)[0].cpu().numpy().astype(np.float64)
        gc = 1.6 * gc / max(np.max(gc), 1e-12)
        gc = gc * (gc >= 0.0)
        l1 = float(np.abs(gc).sum())
        return {"components": [parts["factor_loss"], l1],
                "factor_loss": parts["factor_loss"], "scaled_gc_l1": l1}

    raise ValueError(
        f"call_model_eval_method: unsupported model type "
        f"{type(model).__name__}")
