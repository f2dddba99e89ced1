"""Synthetic sVAR dataset curation: shards + data cached-args (a copy of
``redcliff_tpu/data/curation.py``; numpy on the host).

A fold curated here equals the JAX package's: the same shard contents and
the same cached-args text, since both run the host half of
``data/synthetic.py`` from the same seeds.

Rebuilds the curation drivers around the generator (the reference's
data/currate_sVARwInnovativeContinuousGaussianNoise_data_etNL.py,
clean_...etNL.py, aggregate_synthetic_systems_datasets.py, and the save
helpers at data/data_utils.py:21-45): generate per-fold factor graphs and
superimposed recordings, shard the samples, and write the fold's cached-args
file with the ground-truth adjacency tensors serialized as strings.
"""
from __future__ import annotations

import os
import pickle
import shutil

import numpy as np

from redcliff_tpu_torch.utils.config import serialize_tensor_to_string
from redcliff_tpu_torch.data.synthetic import (
    generate_lagged_adjacency_graphs_for_factor_model,
    generate_synthetic_data_np,
    reference_curation_params,
)

__all__ = [
    "save_data",
    "save_cached_args_file_for_data",
    "experiment_folder_name",
    "curate_synthetic_fold",
    "clean_incomplete_experiment_folders",
    "aggregate_synthetic_systems_datasets",
]


def save_data(save_path_for_data, samples, num_samples_in_dataset,
              num_samps_per_file, file_prefix="subset_"):
    """Shard [[x, y], ...] samples into subset pickles
    (ref data_utils.py:21-30)."""
    start, counter = 0, 0
    while start < num_samples_in_dataset:
        with open(os.path.join(save_path_for_data,
                               f"{file_prefix}{counter}.pkl"), "wb") as f:
            pickle.dump(samples[start : start + num_samps_per_file], f)
        start += num_samps_per_file
        counter += 1


def save_cached_args_file_for_data(data_root_path, num_channels,
                                   adjacency_tensors, final_file_name):
    """Write the data cached-args JSON with stringified ground-truth tensors
    (ref data_utils.py:32-45).  Tensors are stored reverse-lag-major so the
    readers' lag reversal restores them."""
    import json

    entries = {
        "data_root_path": data_root_path,
        "num_channels": str(num_channels),
    }
    for i, tensor in enumerate(adjacency_tensors):
        entries[f"net{i + 1}_adjacency_tensor"] = \
            serialize_tensor_to_string(np.asarray(tensor, dtype=np.float64))
    with open(os.path.join(data_root_path, final_file_name), "w") as f:
        json.dump(entries, f)


def experiment_folder_name(num_factors, num_supervised_factors, num_nodes,
                           num_edges_per_graph, edge_type_setting,
                           label_type_setting, noise_type, noise_level,
                           restriction_setting=""):
    """The hyperparameter-encoded folder-name convention the eval layer
    parses back (ref currate_...py:92-108)."""
    return "_".join([
        f"numF{num_factors}",
        f"numSF{num_supervised_factors}",
        f"numN{num_nodes}",
        f"numE{num_edges_per_graph}",
        f"edges{edge_type_setting}",
        f"labels{label_type_setting}",
        f"noiT-{noise_type}",
        "noiL-" + str(noise_level).replace(".", "-"),
        restriction_setting,
    ]).rstrip("_")


def curate_synthetic_fold(save_root, fold_id, num_nodes=6, num_lags=2,
                          num_factors=2, num_supervised_factors=2,
                          num_edges_per_graph=None,
                          num_samples_in_train_set=40,
                          num_samples_in_val_set=10,
                          sample_recording_len=100, burnin_period=10,
                          label_type_setting="Oracle", noise_type="white",
                          noise_level=0.1, make_factors_orthogonal=True,
                          make_factors_singular_components=False,
                          num_samples_per_file=100, folder_name=None,
                          rng=None):
    """Generate one CV fold of the synthetic sVAR benchmark
    (ref currate_...py:18-230): factor graphs seeded by fold (fold_id*333 so
    graphs repeat across hyperparameter settings), train/validation shards,
    and the fold's cached-args with stringified true graphs.

    Returns (fold_dir, graphs).
    """
    p = reference_curation_params(num_nodes)
    graphs, acts, _ = generate_lagged_adjacency_graphs_for_factor_model(
        num_nodes=num_nodes, num_lags=num_lags, num_factors=num_factors,
        make_factors_orthogonal=make_factors_orthogonal,
        make_factors_singular_components=make_factors_singular_components,
        rand_seed=fold_id * 333,
        off_diag_edge_strengths=p["off_diag_edge_strengths"],
        diag_receiving_node_forgetting_coeffs=
            p["diag_receiving_node_forgetting_coeffs"],
        diag_sending_node_forgetting_coeffs=
            p["diag_sending_node_forgetting_coeffs"],
        num_edges_per_graph=num_edges_per_graph)

    if folder_name is None:
        folder_name = experiment_folder_name(
            num_factors, num_supervised_factors, num_nodes,
            num_edges_per_graph if num_edges_per_graph is not None else "Auto",
            "Linear", label_type_setting, noise_type, noise_level)
    fold_dir = os.path.join(save_root, folder_name, f"fold_{fold_id}")
    train_dir = os.path.join(fold_dir, "train")
    val_dir = os.path.join(fold_dir, "validation")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)

    rng = rng or np.random.default_rng(9999 + fold_id)
    sets = {}
    for split, n in (("train", num_samples_in_train_set),
                     ("validation", num_samples_in_val_set)):
        X, Y = generate_synthetic_data_np(
            rng, graphs, acts, p["base_freqs"], p["noise_mu"],
            p["noise_var"], p["innovation_amp"], n, sample_recording_len,
            burnin_period, num_supervised_factors,
            label_type=label_type_setting, noise_type=noise_type,
            noise_amp=noise_level)
        sets[split] = [[X[i], Y[i]] for i in range(n)]
    save_data(train_dir, sets["train"], num_samples_in_train_set,
              num_samples_per_file)
    save_data(val_dir, sets["validation"], num_samples_in_val_set,
              num_samples_per_file)
    save_cached_args_file_for_data(
        fold_dir, num_nodes, graphs,
        f"data_fold{fold_id}_cached_args.txt")
    return fold_dir, graphs


def clean_incomplete_experiment_folders(root, num_folds):
    """Delete experiment folders missing folds or cached-args, and collect
    the surviving cached-args paths (ref clean_...etNL.py:30-40)."""
    kept = []
    for exp in sorted(os.listdir(root)):
        exp_dir = os.path.join(root, exp)
        if not os.path.isdir(exp_dir):
            continue
        complete = True
        cached = []
        for fold_id in range(num_folds):
            fold_dir = os.path.join(exp_dir, f"fold_{fold_id}")
            args_files = [
                os.path.join(fold_dir, x)
                for x in (os.listdir(fold_dir)
                          if os.path.isdir(fold_dir) else [])
                if "cached_args" in x
            ]
            if not os.path.isdir(fold_dir) or not args_files:
                complete = False
                break
            cached.extend(args_files)
        if complete:
            kept.extend(cached)
        else:
            print(f"clean: removing incomplete experiment {exp}", flush=True)
            shutil.rmtree(exp_dir)
    return kept


def aggregate_synthetic_systems_datasets(system_folders, dest_root,
                                         benchmark_name):
    """Collect selected system folders into one supervised-discovery
    benchmark directory (ref aggregate_synthetic_systems_datasets.py:23-62)."""
    dest = os.path.join(dest_root, benchmark_name)
    os.makedirs(dest, exist_ok=True)
    for folder in system_folders:
        name = os.path.basename(os.path.normpath(folder))
        target = os.path.join(dest, name)
        if not os.path.exists(target):
            shutil.copytree(folder, target)
    return dest
