"""Legacy cached-args readers (the port's copy of ``utils/config.py``).

The reference's config system is two levels of stringly-typed JSON: model
cached-args (every value a string, "None" sentinels, "[1,2]" int lists)
and data cached-args carrying the fold path, the channel count and the
ground-truth adjacency tensors serialized as Python-repr strings. The
port reads the model schemas of every family of the JAX package: the
REDCLIFF cMLP and cLSTM variants, cMLP, cLSTM, DGCNN, NAVAR, DCSFA-NMF
(with the directed-spectrum parameters its features take) and DYNOTEARS
(Vanilla and Stochastic), and every data cached-args file.

stdlib + numpy only.
"""
from __future__ import annotations

import copy
import json

import numpy as np

__all__ = [
    "parse_input_list_of_ints",
    "parse_tensor_string_representation",
    "serialize_tensor_to_string",
    "read_in_model_args",
    "read_in_data_args",
    "load_true_gc_factors",
]


def load_true_gc_factors(data_cached_args_file,
                         model_type="REDCLIFF_S_CMLP"):
    """The per-dataset true factor graphs from a cached-args file, the one
    place the eval layer reads the cached-args truth (``model_type`` only
    selects the parsing schema)."""
    args = read_in_data_args({"model_type": model_type,
                              "data_cached_args_file": data_cached_args_file},
                             read_in_gc_factors_for_eval=True)
    return args["true_GC_factors"]


def parse_input_list_of_ints(list_string):
    """'[1,2,3]' -> [1, 2, 3]."""
    if list_string == "[]":
        return []
    return [int(chars) for chars in list_string[1:-1].split(",")]


def parse_tensor_string_representation(tensor_string):
    """Parse a '[[[...]]]' Python-repr 3D tensor string.

    Lagged adjacency tensors are stored lag-major ('[[[..C..]..C..]..L..]');
    square slices are transposed to (C, C, L). The single-element case
    follows the reference's special path.
    """
    if ",],],]" in tensor_string:
        slices = [[[float(tensor_string[3:-6])]]]
    else:
        slices = tensor_string[3:-3].split("]], [[")
        for i, matrix_slice in enumerate(slices):
            rows = matrix_slice.split("], [")
            slices[i] = [[float(x) for x in row.split(",")] for row in rows]
    tensor = np.array(slices)
    assert tensor.ndim == 3
    if tensor.shape[1] == tensor.shape[2]:
        tensor = np.transpose(tensor, axes=[1, 2, 0])
    assert tensor.shape[0] == tensor.shape[1]
    return tensor


def serialize_tensor_to_string(tensor, reverse_lags=True):
    """Inverse writer for data cached-args: (C, C, L) -> repr string in the
    curation's on-disk format (reverse-lag-major, which the readers correct
    back). Contract: ``parse_tensor_string_representation(s)[:, :, ::-1]
    == tensor``."""
    tensor = np.asarray(tensor)
    assert tensor.ndim == 3
    if reverse_lags:
        tensor = tensor[:, :, ::-1]
    lag_major = np.transpose(tensor, (2, 0, 1))
    return repr([[list(map(float, row)) for row in sl] for sl in lag_major])


def _factor_index(key):
    """'net<i>_adjacency_tensor' -> i-1, parsing the full integer."""
    assert key.startswith("net"), key
    return int(key[3: key.index("_")]) - 1


def _opt(value, cast=str):
    return None if value == "None" else cast(value)


def _read_redcliff_common(args_dict, a):
    """Shared REDCLIFF(+_S_) fields."""
    args_dict["num_factors"] = int(a["num_factors"])
    args_dict["num_supervised_factors"] = int(a["num_supervised_factors"])
    model_type = args_dict["model_type"]
    if "_S_" in model_type:
        args_dict["use_sigmoid_restriction"] = bool(
            int(a["use_sigmoid_restriction"]))
        args_dict["factor_score_embedder_type"] = \
            a["factor_score_embedder_type"]
        emb_type = a["factor_score_embedder_type"]
        if emb_type == "cEmbedder":
            args_dict["factor_score_embedder_args"] = [
                ("sigmoid_eccentricity_coeff",
                 float(a["sigmoid_eccentricity_coeff"])),
                ("lag", int(a["embed_lag"])),
                ("hidden", copy.deepcopy(args_dict["embed_hidden_sizes"])),
            ]
        elif emb_type == "DGCNN":
            args_dict["factor_score_embedder_args"] = [
                ("num_features_per_node", int(a["embed_lag"])),
                ("num_graph_conv_layers",
                 int(a["embed_num_graph_conv_layers"])),
                ("num_hidden_nodes", int(a["embed_num_hidden_nodes"])),
                ("sigmoid_eccentricity_coeff",
                 float(a["sigmoid_eccentricity_coeff"])),
            ]
        elif emb_type == "Vanilla_Embedder":
            args_dict["factor_score_embedder_args"] = []
        else:
            raise ValueError(
                f"UNRECOGNIZED factor_score_embedder_type == {emb_type}")
        args_dict["primary_gc_est_mode"] = a["primary_gc_est_mode"]
        args_dict["forward_pass_mode"] = a["forward_pass_mode"]

    cd = args_dict["coeff_dict"]
    cd["FACTOR_SCORE_COEFF"] = float(a["FACTOR_SCORE_COEFF"])
    cd["DAGNESS_REG_COEFF"] = float(a["DAGNESS_REG_COEFF"])
    cd["DAGNESS_LAG_COEFF"] = float(a["DAGNESS_LAG_COEFF"])
    cd["DAGNESS_NODE_COEFF"] = float(a["DAGNESS_NODE_COEFF"])
    if "_S_" in model_type:
        cd["FACTOR_WEIGHT_L1_COEFF"] = float(a["FACTOR_WEIGHT_L1_COEFF"])
        cd["FACTOR_COS_SIM_COEFF"] = float(a["FACTOR_COS_SIM_COEFF"])
        if "FACTOR_WEIGHT_SMOOTHING_PENALTY_COEFF" in a:
            cd["FACTOR_WEIGHT_SMOOTHING_PENALTY_COEFF"] = float(
                a["FACTOR_WEIGHT_SMOOTHING_PENALTY_COEFF"])
    args_dict["training_mode"] = a["training_mode"]
    args_dict["embed_lr"] = float(a["embed_lr"])
    args_dict["embed_eps"] = float(a["embed_eps"])
    args_dict["embed_weight_decay"] = float(a["embed_weight_decay"])
    args_dict["num_pretrain_epochs"] = int(a["num_pretrain_epochs"])
    if "_S_" in model_type:
        args_dict["num_acclimation_epochs"] = int(a["num_acclimation_epochs"])
    args_dict["prior_factors_path"] = _opt(a["prior_factors_path"])
    args_dict["cost_criteria"] = a["cost_criteria"]
    args_dict["unsupervised_start_index"] = int(a["unsupervised_start_index"])
    args_dict["max_factor_prior_batches"] = int(a["max_factor_prior_batches"])
    args_dict["stopping_criteria_forecast_coeff"] = float(
        a["stopping_criteria_forecast_coeff"])
    args_dict["stopping_criteria_factor_coeff"] = float(
        a["stopping_criteria_factor_coeff"])
    args_dict["stopping_criteria_cosSim_coeff"] = float(
        a["stopping_criteria_cosSim_coeff"])
    args_dict["deltaConEps"] = float(a["deltaConEps"])
    args_dict["in_degree_coeff"] = float(a["in_degree_coeff"])
    args_dict["out_degree_coeff"] = float(a["out_degree_coeff"])


def read_in_model_args(args_dict):
    """Per-family cached-args schema reader: ``args_dict`` must carry
    "model_type" and "model_cached_args_file"; returns it with the
    family's typed fields filled in."""
    model_type = args_dict["model_type"]
    is_redcliff = "REDCLIFF" in model_type
    is_cmlp = "cMLP" in model_type or ("CMLP" in model_type and is_redcliff)
    is_clstm = "cLSTM" in model_type or ("CLSTM" in model_type
                                         and is_redcliff)
    with open(args_dict["model_cached_args_file"], "r") as f:
        a = json.load(f)

    if is_cmlp:
        args_dict["num_sims"] = int(a["num_sims"])
        args_dict["embed_hidden_sizes"] = parse_input_list_of_ints(
            a["embed_hidden_sizes"])
        args_dict["batch_size"] = int(a["batch_size"])
        args_dict["gen_eps"] = float(a["gen_eps"])
        args_dict["gen_weight_decay"] = float(a["gen_weight_decay"])
        args_dict["max_iter"] = int(a["max_iter"])
        args_dict["lookback"] = int(a["lookback"])
        args_dict["check_every"] = int(a["check_every"])
        args_dict["verbose"] = int(a["verbose"])
        args_dict["output_length"] = int(a["output_length"])
        args_dict["wavelet_level"] = _opt(a["wavelet_level"], int)
        args_dict["gen_hidden"] = parse_input_list_of_ints(a["gen_hidden"])
        args_dict["gen_lr"] = float(a["gen_lr"])
        args_dict["input_length"] = int(a["gen_lag_and_input_len"])
        args_dict["gen_lag"] = int(a["gen_lag_and_input_len"])
        args_dict["coeff_dict"] = {
            "FORECAST_COEFF": float(a["FORECAST_COEFF"]),
            "ADJ_L1_REG_COEFF": float(a["ADJ_L1_REG_COEFF"]),
        }
        args_dict["signal_format"] = (
            "wavelet_decomp" if args_dict["wavelet_level"] is not None
            else "original")
        if not is_redcliff:
            for key in ("DAGNESS_REG_COEFF", "DAGNESS_LAG_COEFF",
                        "DAGNESS_NODE_COEFF"):
                args_dict["coeff_dict"][key] = float(a[key])
        else:
            if "_S_" in model_type:
                args_dict["embed_lag"] = int(a["embed_lag"])
            _read_redcliff_common(args_dict, a)

    elif is_clstm:
        args_dict["num_sims"] = int(a["num_sims"])
        args_dict["embed_hidden_sizes"] = parse_input_list_of_ints(
            a["embed_hidden_sizes"])
        args_dict["coeff_dict"] = {
            "FORECAST_COEFF": float(a["FORECAST_COEFF"]),
            "ADJ_L1_REG_COEFF": float(a["ADJ_L1_REG_COEFF"]),
            "DAGNESS_REG_COEFF": float(a["DAGNESS_REG_COEFF"]),
        }
        args_dict["batch_size"] = int(a["batch_size"])
        args_dict["gen_eps"] = float(a["gen_eps"])
        args_dict["gen_weight_decay"] = float(a["gen_weight_decay"])
        args_dict["max_iter"] = int(a["max_iter"])
        args_dict["lookback"] = int(a["lookback"])
        args_dict["check_every"] = int(a["check_every"])
        args_dict["verbose"] = int(a["verbose"])
        args_dict["wavelet_level"] = _opt(a["wavelet_level"], int)
        args_dict["gen_hidden"] = int(a["gen_hidden"])
        args_dict["gen_lr"] = float(a["gen_lr"])
        args_dict["context"] = int(a["context"])
        args_dict["max_input_length"] = int(a["max_input_length"])
        args_dict["signal_format"] = (
            "wavelet_decomp" if args_dict["wavelet_level"] is not None
            else "original")
        if is_redcliff:
            if "_S_" in model_type:
                args_dict["num_in_timesteps"] = int(a["embed_lag"])
            _read_redcliff_common(args_dict, a)
            # the reference zeroes lag/node DAGness for CLSTM
            args_dict["coeff_dict"]["DAGNESS_LAG_COEFF"] = 0
            args_dict["coeff_dict"]["DAGNESS_NODE_COEFF"] = 0

    elif "DCSFA" in model_type:
        args_dict["batch_size"] = int(a["batch_size"])
        args_dict["best_model_name"] = a["best_model_name"]
        args_dict["num_high_level_node_features"] = int(
            a["num_high_level_node_features"])
        args_dict["num_node_features"] = int(a["num_node_features"])
        args_dict["n_components"] = int(a["n_components"])
        args_dict["n_sup_networks"] = int(a["n_sup_networks"])
        args_dict["signal_format"] = a["signal_format"]
        args_dict["h"] = int(a["h"])
        args_dict["momentum"] = float(a["momentum"])
        args_dict["lr"] = float(a["lr"])
        args_dict["recon_weight"] = float(a["recon_weight"])
        args_dict["sup_weight"] = float(a["sup_weight"])
        args_dict["sup_recon_weight"] = float(a["sup_recon_weight"])
        args_dict["sup_smoothness_weight"] = float(a["sup_smoothness_weight"])
        args_dict["n_epochs"] = int(a["n_epochs"])
        args_dict["n_pre_epochs"] = int(a["n_pre_epochs"])
        args_dict["nmf_max_iter"] = int(a["nmf_max_iter"])
        nnf = args_dict["num_node_features"]
        # recordings are truncated to num_node_features steps before feature
        # extraction (ref model_utils.py:692-717 max_num_features_per_series)
        args_dict["max_num_features_per_series"] = nnf
        args_dict["dirspec_params"] = {
            "fs": 1000, "min_freq": 0.0, "max_freq": 250.0,
            "directed_spectrum": True,
            "csd_params": {"detrend": "constant", "window": "hann",
                           "nperseg": nnf, "noverlap": int(nnf * 0.5),
                           "nfft": None},
        }

    elif "DGCNN" in model_type:
        if not is_redcliff:
            args_dict["num_classes"] = int(a["num_classes"])
            args_dict["batch_size"] = int(a["batch_size"])
            args_dict["gen_eps"] = float(a["gen_eps"])
            args_dict["gen_weight_decay"] = float(a["gen_weight_decay"])
            args_dict["max_iter"] = int(a["max_iter"])
            args_dict["lookback"] = int(a["lookback"])
            args_dict["check_every"] = int(a["check_every"])
            args_dict["verbose"] = int(a["verbose"])
            args_dict["num_features_per_node"] = int(
                a["num_features_per_node"])
            args_dict["num_graph_conv_layers"] = int(
                a["num_graph_conv_layers"])
            args_dict["num_hidden_nodes"] = int(a["num_hidden_nodes"])
            args_dict["wavelet_level"] = (
                0 if a["wavelet_level"] == "None" else int(a["wavelet_level"]))
            args_dict["num_wavelets_per_chan"] = int(
                a["num_wavelets_per_chan"])
            args_dict["gen_lr"] = float(a["gen_lr"])
            args_dict["signal_format"] = (
                "wavelet_decomp" if args_dict["wavelet_level"] else "original")
        else:
            args_dict["num_sims"] = int(a["num_sims"])
            args_dict["embed_hidden_sizes"] = parse_input_list_of_ints(
                a["embed_hidden_sizes"])
            args_dict["coeff_dict"] = {
                "FORECAST_COEFF": float(a["FORECAST_COEFF"]),
                "ADJ_L1_REG_COEFF": float(a["ADJ_L1_REG_COEFF"]),
                "DAGNESS_REG_COEFF": float(a["DAGNESS_REG_COEFF"]),
            }
            if "_S_" in model_type:
                args_dict["embed_num_features_per_node"] = int(a["embed_lag"])
            _read_redcliff_common(args_dict, a)
            args_dict["coeff_dict"]["DAGNESS_LAG_COEFF"] = 0
            args_dict["coeff_dict"]["DAGNESS_NODE_COEFF"] = 0

    elif "DYNOTEARS" in model_type:
        args_dict["signal_format"] = a["signal_format"]
        args_dict["lambda_w"] = float(a["lambda_w"])
        args_dict["lambda_a"] = float(a["lambda_a"])
        args_dict["max_iter"] = int(a["max_iter"])
        args_dict["h_tol"] = float(a["h_tol"])
        args_dict["w_threshold"] = float(a["w_threshold"])
        args_dict["tabu_edges"] = _opt(a["tabu_edges"])
        args_dict["tabu_parent_nodes"] = _opt(a["tabu_parent_nodes"])
        args_dict["tabu_child_nodes"] = _opt(a["tabu_child_nodes"])
        args_dict["X_train"] = None
        args_dict["X_val"] = None
        args_dict["lag_size"] = int(a["lag_size"])
        if "Vanilla" not in model_type:
            args_dict["batch_size"] = int(a["batch_size"])
            args_dict["grad_step"] = float(a["grad_step"])
            args_dict["wa_est"] = _opt(a["wa_est"])
            args_dict["rho"] = float(a["rho"])
            args_dict["alpha"] = float(a["alpha"])
            args_dict["h_value"] = (np.inf if a["h_value"] == "inf"
                                    else float(a["h_value"]))
            args_dict["h_new"] = (np.inf if a["h_new"] == "inf"
                                  else float(a["h_new"]))
            args_dict["max_data_iter"] = int(a["max_data_iter"])
            args_dict["iter_start"] = int(a["iter_start"])
            args_dict["num_iters_prior_to_stop"] = int(
                a["num_iters_prior_to_stop"])
            args_dict["reuse_rho"] = bool(int(a["reuse_rho"]))
            args_dict["reuse_alpha"] = bool(int(a["reuse_alpha"]))
            args_dict["reuse_h_val"] = bool(int(a["reuse_h_val"]))
            args_dict["reuse_h_new"] = bool(int(a["reuse_h_new"]))
            args_dict["check_every"] = int(a["check_every"])

    elif "NAVAR" in model_type:
        args_dict["num_nodes"] = int(a["num_nodes"])
        args_dict["num_hidden"] = int(a["num_hidden"])
        args_dict["maxlags"] = int(a["maxlags"])
        args_dict["hidden_layers"] = int(a["hidden_layers"])
        args_dict["dropout"] = float(a["dropout"])
        args_dict["X_train"] = None
        args_dict["y_train"] = None
        args_dict["X_val"] = None
        args_dict["y_val"] = None
        args_dict["batch_size"] = int(a["batch_size"])
        args_dict["signal_format"] = a.get("signal_format", "original")
        for key in ("epochs", "val_proportion", "learning_rate",
                    "lambda1", "check_every", "verbose"):
            if key in a:
                cast = (int if key in ("epochs", "check_every", "verbose")
                        else float)
                args_dict[key] = cast(a[key])

    else:
        raise ValueError(f"UNRECOGNIZED model_type == {model_type}")

    return args_dict


def read_in_data_args(args_dict, read_in_gc_factors_for_eval=False):
    """Data cached-args reader: fills data_root_path / num_channels and
    the true graphs — for cMLP/REDCLIFF the per-factor lagged tensors
    (``true_GC_factors``) and their sum, for the lag-collapsing families
    the summed nontemporal view. ``read_in_gc_factors_for_eval=True``
    returns the per-factor lagged tensors whatever the family (the eval
    drivers read them)."""
    with open(args_dict["data_cached_args_file"], "r") as f:
        a = json.load(f)
    args_dict["data_root_path"] = a["data_root_path"]
    args_dict["num_channels"] = int(a["num_channels"])
    model_type = args_dict.get("model_type", "")

    lagged_tensors = {}
    for key, val in a.items():
        if "adjacency_tensor" in key:
            t = parse_tensor_string_representation(val)
            lagged_tensors[key] = t[:, :, ::-1].copy()

    # order by the parsed factor index, not lexicographically (net10 < net2)
    keys_sorted = sorted(lagged_tensors, key=_factor_index)
    if read_in_gc_factors_for_eval:
        args_dict["true_GC_factors"] = [lagged_tensors[k]
                                        for k in keys_sorted]

    if "cMLP" in model_type or "REDCLIFF" in model_type:
        factors = [lagged_tensors[k] for k in keys_sorted]
        args_dict["true_GC_factors"] = factors
        total = None
        for t in factors:
            total = t if total is None else total + t
        # the reference overwrites the sum with the LAST factor (latent
        # bug); here the summed tensor is kept, as in the JAX package
        args_dict["true_GC_tensor"] = [total] if factors else None
    elif model_type:
        total = None
        for k in keys_sorted:
            nt = lagged_tensors[k].sum(axis=2)
            total = nt if total is None else total + nt
        args_dict["true_GC_tensor"] = [total] if total is not None else None

    for extra in ("num_samples", "num_folds", "num_states",
                  "sample_recording_len"):
        if extra in a:
            args_dict[extra] = int(a[extra])
    if "data_set_name" in a and "data_set_name" not in args_dict:
        args_dict["data_set_name"] = a["data_set_name"]
    return args_dict
