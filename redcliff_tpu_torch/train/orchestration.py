"""Orchestration: model factory, data dispatch and fit dispatch (port of
the REDCLIFF-S half of ``train/orchestration.py``).

An args dict produced by ``utils/config.py`` maps onto the model config
and the trainer:

* :func:`create_model_instance` builds ``REDCLIFF_S_CMLP`` (and its
  smoothing variant). The reference's declared-but-absent
  ``REDCLIFF_S_DGCNN`` raises as in the JAX package; cLSTM factors and
  the other model families are not ported yet (ROADMAP queue 1, item 13)
  and raise.
* :func:`get_data_for_model_training` loads the fold's (train,
  validation) datasets.
* :func:`call_model_fit_method` fits a REDCLIFF-S model with the port's
  ``RedcliffTrainer``. The model is initialised by the port's own
  ``init`` from a generator seeded with ``seed`` (the JAX package draws
  from ``jax.random.PRNGKey(seed)``, which torch cannot match). As in the
  JAX dispatch, the trainer's config sets no prox.
"""
from __future__ import annotations

import os

import torch

__all__ = ["create_model_instance", "get_data_for_model_training",
           "call_model_fit_method"]


def _coeff(args_dict, key, default=0.0):
    return float(args_dict.get("coeff_dict", {}).get(key, default))


def create_model_instance(args_dict, employ_version_with_smoothing_loss=False):
    """The REDCLIFF-S cMLP model an args dict describes."""
    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)

    model_type = args_dict["model_type"]
    if "REDCLIFF" in model_type and "DGCNN" in model_type:
        raise NotImplementedError(
            f"{model_type} is declared by the reference factory "
            "(model_utils.py:344) but its model file was never "
            "published; see SURVEY.md §2.2")
    if not ("REDCLIFF" in model_type and "CMLP" in model_type):
        raise NotImplementedError(
            f"{model_type} is not ported yet (ROADMAP queue 1, item 13: "
            f"cLSTM factors and the other model families); the port builds "
            f"REDCLIFF_S_CMLP only")
    if "_S_" not in model_type:
        # the reference factory raises here too
        raise NotImplementedError(
            "only the supervised REDCLIFF_S_CMLP variant exists; the "
            "unsupervised REDCLIFF_CMLP is unimplemented in the "
            "reference as well")
    emb_args = dict(args_dict.get("factor_score_embedder_args", []))
    smoothing_coeff = _coeff(args_dict,
                             "FACTOR_WEIGHT_SMOOTHING_PENALTY_COEFF") \
        if employ_version_with_smoothing_loss else 0.0
    cfg = RedcliffSCMLPConfig(
        num_chans=args_dict["num_channels"],
        gen_lag=args_dict["gen_lag"],
        gen_hidden=tuple(args_dict["gen_hidden"]),
        embed_lag=args_dict["embed_lag"],
        embed_hidden_sizes=tuple(args_dict["embed_hidden_sizes"]),
        num_factors=args_dict["num_factors"],
        num_supervised_factors=args_dict["num_supervised_factors"],
        factor_network_type="cMLP",
        forecast_coeff=_coeff(args_dict, "FORECAST_COEFF", 1.0),
        factor_score_coeff=_coeff(args_dict, "FACTOR_SCORE_COEFF"),
        factor_cos_sim_coeff=_coeff(args_dict, "FACTOR_COS_SIM_COEFF"),
        factor_weight_l1_coeff=_coeff(args_dict, "FACTOR_WEIGHT_L1_COEFF"),
        adj_l1_reg_coeff=_coeff(args_dict, "ADJ_L1_REG_COEFF"),
        dagness_reg_coeff=_coeff(args_dict, "DAGNESS_REG_COEFF"),
        dagness_lag_coeff=_coeff(args_dict, "DAGNESS_LAG_COEFF"),
        dagness_node_coeff=_coeff(args_dict, "DAGNESS_NODE_COEFF"),
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
    )
    return RedcliffSCMLP(cfg)


def get_data_for_model_training(args_dict, grid_search=True, shuffle=True,
                                shuffle_seed=0, device=None):
    """(train, validation) datasets for a parsed args dict: the
    data_root_path holds the fold in the shared shard layout; with
    ``device`` their resident copies are placed there."""
    from redcliff_tpu_torch.data.shards import load_normalized_split_datasets

    return load_normalized_split_datasets(
        args_dict["data_root_path"],
        signal_format=args_dict.get("signal_format", "original"),
        shuffle=shuffle, shuffle_seed=shuffle_seed,
        grid_search=grid_search,
        average_region_map=args_dict.get("average_region_map"),
        device=device)


def call_model_fit_method(model, args_dict, train_ds, val_ds, save_dir=None,
                          seed=0, device=None):
    """Fit a REDCLIFF-S model from its port-drawn init on ``device``
    (``cuda`` unless given). Returns ``(best params, fit result)``."""
    from redcliff_tpu_torch.models.redcliff import RedcliffSCMLP
    from redcliff_tpu_torch.train.redcliff_trainer import (
        RedcliffTrainConfig, RedcliffTrainer)

    if not isinstance(model, RedcliffSCMLP):
        raise NotImplementedError(
            f"fitting {type(model).__name__} is not ported yet (ROADMAP "
            f"queue 1, item 13)")
    save_dir = save_dir or args_dict.get("save_path")
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
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
    params = model.init(torch.Generator().manual_seed(seed), trainer.device)
    result = trainer.fit(params, train_ds, val_ds,
                         true_GC=args_dict.get("true_GC_factors"),
                         save_dir=save_dir)
    return result.params, result
