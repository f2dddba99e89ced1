"""Port twin of ``experiments/accuracy_parity_d4ic.py``: the D4IC-pattern
accuracy study, run by the PyTorch port on the card.

The flow, the command line, the transcribed reference cached-args and the
sample counts are the JAX script's. The DREAM4 TSVs are not shipped, so,
as there, five 10-node single-state sVAR "networks" stand in for the
DREAM4 gene networks:

1. each network's lagged graph comes from the host graph factory
   (``data/synthetic.py``, seeded by the network id: bit-identical to the
   JAX package's), and its recordings from the device generator
   (``generate_synthetic_dataset`` on the card, from a ``torch.Generator``
   seeded ``fold * 1000 + net_id`` where the JAX script seeds a
   ``jax.random.PRNGKey``: the recordings match the JAX package's in
   distribution only), in the per-network fold/split shard layout;
2. ``data/dream4.py:make_d4ic_fold`` builds the D4IC mixture at a named
   SNR tier (dominant/background coefficients, label = coefficient
   vector);
3. every algorithm of the reference's d4IC roster trains through the
   port's array-task driver at the reference's own d4IC cached-args;
4. the cross-algorithm optimal-F1 battery scores each run against the
   five network graphs; the result, with the wall of each curation, array
   task and evaluation, lands in ``<workdir>_smoke/ACCURACY_D4IC_<tier>_smoke.json``
   or ``<workdir>/ACCURACY_D4IC_<tier>.json``.

Recordings are 48 steps and the per-network budget 120 train / 30
validation recordings per fold, as in the JAX script. It imports only
``redcliff_tpu_torch`` and runs on ``cuda`` through the entry points'
defaults; ``main(argv, device=...)`` runs it elsewhere (the generator
included).

Run:  python -m redcliff_tpu_torch.experiments.accuracy_parity_d4ic
      <workdir> [--folds N] [--snr HSNR|MSNR|LSNR] [--smoke]
      [--algs all|core]
"""
import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from redcliff_tpu_torch.data import synthetic as S
from redcliff_tpu_torch.data.curation import save_cached_args_file_for_data
from redcliff_tpu_torch.data.dream4 import make_d4ic_fold
from redcliff_tpu_torch.data.shards import load_normalized_samples
from redcliff_tpu_torch.eval.cross_alg import run_cross_algorithm_comparison
from redcliff_tpu_torch.experiments.accuracy_parity_synsys import (
    DYNOTEARS_ARGS, summarize)
from redcliff_tpu_torch.experiments.accuracy_parity_synsys import (
    NAVAR_ARGS as _NAVAR_SYNSYS)
from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
from redcliff_tpu_torch.utils.config import load_true_gc_factors
from redcliff_tpu_torch.utils.precision import resolve_device

NUM_NETWORKS = 5
NUM_NODES = 10
RECORDING_LEN = 48

# ref train/REDCLIFF_S_CMLP_d4IC_BSCgs1_cached_args.txt (transcribed)
REDCLIFF_ARGS = {
    "output_length": "1", "batch_size": "128", "max_iter": "1000",
    "lookback": "1", "check_every": "10", "verbose": "0", "num_sims": "1",
    "num_factors": "5", "num_supervised_factors": "5",
    "wavelet_level": "None", "gen_hidden": "[25]", "gen_lr": "0.0005",
    "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "gen_lag_and_input_len": "4", "FORECAST_COEFF": "10.0",
    "FACTOR_SCORE_COEFF": "100.0", "FACTOR_COS_SIM_COEFF": "1.0",
    "FACTOR_WEIGHT_L1_COEFF": "0.001", "ADJ_L1_REG_COEFF": "1.0",
    "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
    "DAGNESS_NODE_COEFF": "0.0",
    "primary_gc_est_mode": "conditional_factor_fixed_embedder",
    "forward_pass_mode": "apply_factor_weights_after_sim_completion",
    "training_mode": "pretrain_embedder_then_acclimate_factors_then_combined",
    "num_pretrain_epochs": "50", "num_acclimation_epochs": "15",
    "factor_score_embedder_type": "DGCNN", "embed_hidden_sizes": "[0]",
    "embed_num_hidden_nodes": "100", "embed_num_graph_conv_layers": "3",
    "embed_lr": "0.0002", "embed_eps": "0.0001",
    "embed_weight_decay": "0.0001", "embed_lag": "16",
    "use_sigmoid_restriction": "0", "sigmoid_eccentricity_coeff": "10.0",
    "prior_factors_path": "None", "cost_criteria": "CosineSimilarity",
    "unsupervised_start_index": "0", "max_factor_prior_batches": "10",
    "stopping_criteria_forecast_coeff": "10.",
    "stopping_criteria_factor_coeff": "100.",
    "stopping_criteria_cosSim_coeff": "1.", "deltaConEps": "0.1",
    "in_degree_coeff": "1.", "out_degree_coeff": "1.",
}
# ref train/cMLP_d4IC_BLgs1Parsim_cached_args.txt
CMLP_ARGS = {
    "output_length": "1", "num_sims": "1", "embed_hidden_sizes": "[60]",
    "batch_size": "128", "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "max_iter": "1000", "lookback": "1", "check_every": "10", "verbose": "0",
    "num_factors": "1", "num_supervised_factors": "0",
    "wavelet_level": "None", "gen_hidden": "[50]", "gen_lr": "0.0005",
    "gen_lag_and_input_len": "2", "FORECAST_COEFF": "1.0",
    "FACTOR_SCORE_COEFF": "0.0", "ADJ_L1_REG_COEFF": "1.0",
    "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
    "DAGNESS_NODE_COEFF": "0.0",
}
# ref train/cLSTM_d4IC_BLgs1Parsim_cached_args.txt
CLSTM_ARGS = {
    "output_length": "1", "num_sims": "1", "embed_hidden_sizes": "[10]",
    "batch_size": "128", "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "max_iter": "1000", "lookback": "3", "check_every": "5", "verbose": "0",
    "num_factors": "1", "num_supervised_factors": "0",
    "wavelet_level": "None", "gen_hidden": "25", "gen_lr": "0.0005",
    "context": "2", "max_input_length": "4", "FORECAST_COEFF": "1.0",
    "FACTOR_SCORE_COEFF": "0.0", "ADJ_L1_REG_COEFF": "10.0",
    "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
    "DAGNESS_NODE_COEFF": "0.0",
}
# ref train/DGCNN_d4IC_BLgs1Parsim_cached_args.txt
DGCNN_ARGS = {
    "batch_size": "128", "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "max_iter": "1000", "lookback": "1", "check_every": "10", "verbose": "0",
    "num_channels": "10", "wavelet_level": "None",
    "num_wavelets_per_chan": "1", "num_features_per_node": "2",
    "num_graph_conv_layers": "1", "num_hidden_nodes": "100",
    "num_classes": "5", "signal_format": "original flattened",
    "gen_lr": "0.0001",
}
# ref train/DCSFANMF_d4IC_OBPgs1_cached_args.txt
DCSFA_ARGS = {
    "batch_size": "128", "num_high_level_node_features": "5",
    "best_model_name": "dCSFA-NMF-best-model.pt", "num_node_features": "20",
    "n_components": "5", "n_sup_networks": "5",
    "signal_format": "original flattened directed_spectrum vanilla",
    "h": "256", "momentum": "0.5", "lr": "0.001", "recon_weight": "1.0",
    "sup_weight": "2.0", "sup_recon_weight": "1.0",
    "sup_smoothness_weight": "2.0", "n_epochs": "1000",
    "n_pre_epochs": "50", "nmf_max_iter": "20",
}
# NAVAR/DYNOTEARS are the reference's d4IC-only baselines; their transcribed
# cached-args live in the synSys twin — one transcription, shared. NAVAR's
# num_nodes follows this dataset.
# the JAX script's deviation from the reference's d4IC epochs=1000, as in
# the synSys study
NAVAR_ARGS = dict(_NAVAR_SYNSYS, num_nodes=str(NUM_NODES), epochs="250",
                  check_every="50")

# ref train/REDCLIFF_S_CMLP_Smooth_d4IC_BSCgs4ParsimSmo0_cached_args.txt —
# the state-smoothing class at its d4IC "Parsim" configuration, expressed as
# the overlay on BSCgs1 so the actual differences are visible: wider factor
# networks, smaller 2-layer DGCNN embedder, longer embed_lag, 10x smaller
# ADJ_L1, plus the (zero-valued, with num_sims=1 structurally inert)
# smoothing coefficient the Smooth class requires
SMOOTH_ARGS = dict(
    REDCLIFF_ARGS,
    gen_hidden="[100]",
    ADJ_L1_REG_COEFF="0.1",
    FACTOR_WEIGHT_SMOOTHING_PENALTY_COEFF="0.0",
    embed_num_hidden_nodes="30",
    embed_num_graph_conv_layers="2",
    embed_lag="20",
)

MODELS = (
    ("REDCLIFF_S_CMLP", REDCLIFF_ARGS, "REDCLIFF_S_CMLP"),
    # alias avoids substring collision with the non-smooth root in
    # select_algorithm_root while keeping the REDCLIFF GC dispatch
    ("REDCLIFF_S_CMLP_Smooth", SMOOTH_ARGS, "REDCLIFF_Smooth"),
    ("cMLP", CMLP_ARGS, "CMLP"),
    ("cLSTM", CLSTM_ARGS, "CLSTM"),
    ("DGCNN", DGCNN_ARGS, "DGCNN"),
    ("DCSFANMF", DCSFA_ARGS, "DCSFA"),
    ("NAVAR_CMLP", NAVAR_ARGS, "NAVAR_CMLP"),
    ("DYNOTEARS_Vanilla", DYNOTEARS_ARGS, "DYNOTEARS_Vanilla"),
)


# (train, validation) recordings per network and fold
SAMPLES = {False: (120, 30), True: (24, 8)}


def curate_network(nets_root, net_id, fold, n_train, n_val, device=None):
    """One synthetic 'gene network': a single-state 10-node sVAR with its own
    lagged graph; per-network recordings in the per-network shard layout the
    D4IC builder consumes. Returns the network's (C, C, L) graph.

    The five network GRAPHS are fixed across folds (seeded by net_id only),
    matching the D4IC design where folds are CV resamplings of the same five
    DREAM4 networks; only the recordings are redrawn per fold, here on
    ``device`` from a generator there seeded ``fold * 1000 + net_id``."""
    p = S.reference_curation_params(NUM_NODES)
    graph_seed = 17 * net_id + 1
    graphs, acts, _ = S.generate_lagged_adjacency_graphs_for_factor_model(
        num_nodes=NUM_NODES, num_lags=2, num_factors=1,
        make_factors_orthogonal=False,
        make_factors_singular_components=False, rand_seed=graph_seed,
        off_diag_edge_strengths=p["off_diag_edge_strengths"],
        diag_receiving_node_forgetting_coeffs=
            p["diag_receiving_node_forgetting_coeffs"],
        diag_sending_node_forgetting_coeffs=
            p["diag_sending_node_forgetting_coeffs"],
        num_edges_per_graph=13)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(fold * 1000 + net_id)
    X, _ = S.generate_synthetic_dataset(
        gen, graphs, acts,
        p["base_freqs"], p["noise_mu"], p["noise_var"], p["innovation_amp"],
        num_samples=n_train + n_val, recording_length=RECORDING_LEN,
        burnin_period=50, num_labeled_sys_states=1, label_type="Oracle",
        noise_type="gaussian", device=dev)
    for split, sl in (("train", slice(0, n_train)),
                      ("validation", slice(n_train, None))):
        d = os.path.join(nets_root, f"net{net_id}", f"fold_{fold}", split)
        os.makedirs(d, exist_ok=True)
        samples = [[X[i], np.zeros((1,))] for i in range(len(X))[sl]]
        with open(os.path.join(d, "subset_0.pkl"), "wb") as f:
            pickle.dump(samples, f)
    return np.asarray(graphs[0])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--folds", type=int, default=3)
    ap.add_argument("--snr", default="HSNR", choices=["HSNR", "MSNR", "LSNR"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--algs", default="all", choices=["all", "core"],
                    help="'core' drops NAVAR/DYNOTEARS")
    return ap.parse_args(argv)


def main(argv=None, device=None):
    """Run the study; ``device`` is handed to the generator, every array
    task and the eval (``cuda`` unless given). Returns the JSON it
    writes."""
    args = parse_args(argv)
    base = os.path.abspath(args.workdir) + ("_smoke" if args.smoke else "")
    os.makedirs(base, exist_ok=True)
    n_train, n_val = SAMPLES[bool(args.smoke)]
    models = MODELS if args.algs == "all" else tuple(
        m for m in MODELS if m[0] not in ("NAVAR_CMLP", "DYNOTEARS_Vanilla"))

    model_args = {name: dict(a) for name, a, _ in models}
    if args.smoke:
        for key in ("REDCLIFF_S_CMLP", "REDCLIFF_S_CMLP_Smooth"):
            model_args[key].update(
                max_iter="12", num_pretrain_epochs="4",
                num_acclimation_epochs="4", check_every="2")
        for key in ("cMLP", "cLSTM", "DGCNN"):
            model_args[key].update(max_iter="10", check_every="2")
        model_args["DCSFANMF"].update(n_epochs="10", n_pre_epochs="4")
        if "NAVAR_CMLP" in model_args:
            model_args["NAVAR_CMLP"].update(epochs="40", check_every="20")
    walls = {"curate_s": {}, "train_s": {}}

    # ------------------------------------------------------------- curation
    data_args_by_fold = {}
    true_by_fold = {}
    nets_root = os.path.join(base, "networks")
    for fold in range(args.folds):
        t0 = time.time()
        graphs = [curate_network(nets_root, n, fold, n_train, n_val,
                                 device=device)
                  for n in range(NUM_NETWORKS)]
        fold_dir = os.path.join(base, "data", f"d4ic_{args.snr}",
                                f"fold_{fold}")
        make_d4ic_fold(nets_root, fold_dir, fold_id=fold,
                       num_factors=NUM_NETWORKS, snr_tier=args.snr,
                       shuffle_rng=np.random.default_rng(fold))
        save_cached_args_file_for_data(
            fold_dir, NUM_NODES, graphs, f"data_fold{fold}_cached_args.txt")
        data_args_by_fold[fold] = os.path.join(
            fold_dir, f"data_fold{fold}_cached_args.txt")
        true_by_fold[fold] = load_true_gc_factors(data_args_by_fold[fold])
        walls["curate_s"][fold] = time.time() - t0
        print(f"[curate] fold {fold}: {time.time()-t0:.1f}s -> {fold_dir}",
              flush=True)

    # ------------------------------------------------------------- training
    roots = {}
    for model_type, _, alias in models:
        margs_file = os.path.join(base, f"{model_type}_d4ic_cached_args.txt")
        with open(margs_file, "w") as f:
            json.dump(model_args[model_type], f)
        # tier-namespaced: run folder names do not encode the SNR tier, so a
        # shared runs/ dir would let a second tier resume the first's models
        save_root = os.path.join(base, f"runs_{args.snr}", f"{alias}_models")
        os.makedirs(save_root, exist_ok=True)
        roots[alias] = save_root
        for fold in range(args.folds):
            t0 = time.time()
            set_up_and_run_experiments(
                {"save_root_path": save_root}, [margs_file],
                [data_args_by_fold[fold]],
                possible_model_types=[model_type],
                possible_data_sets=[f"data_fold{fold}"], task_id=1,
                device=device)
            walls["train_s"].setdefault(alias, {})[fold] = time.time() - t0
            print(f"[train] {model_type} fold {fold}: {time.time()-t0:.1f}s",
                  flush=True)

    # ----------------------------------------------------------------- eval
    t0 = time.time()
    eval_inputs = {"data": {}}
    for fold in range(args.folds):
        val_dir = os.path.join(os.path.dirname(data_args_by_fold[fold]),
                               "validation")
        eval_inputs["data"][fold] = np.asarray(
            load_normalized_samples(val_dir).X[:128])

    full = run_cross_algorithm_comparison(
        list(roots.values()), {"data": true_by_fold},
        os.path.join(base, "evals", f"d4ic_{args.snr}"),
        num_folds=args.folds, plot=not args.smoke,
        algorithms=[alias for _, _, alias in models],
        eval_inputs=eval_inputs, device=device)
    walls["eval_s"] = time.time() - t0

    out = {"dataset": f"synthetic-source D4IC analog, {args.snr} "
                      f"({NUM_NETWORKS} x {NUM_NODES}-node networks, "
                      f"T={RECORDING_LEN}, dominant/background mixing)",
           "snr_tier": args.snr, "folds": args.folds,
           "smoke": bool(args.smoke),
           "train_samples_per_fold": n_train * NUM_NETWORKS,
           "algorithms": summarize(full), "wall_s": walls}

    dest = os.path.join(base, f"ACCURACY_D4IC_{args.snr}.json"
                        if not args.smoke
                        else f"ACCURACY_D4IC_{args.snr}_smoke.json")
    with open(dest, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[done] wrote {dest}", flush=True)
    return out


if __name__ == "__main__":
    main()
