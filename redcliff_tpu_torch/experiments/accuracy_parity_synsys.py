"""Port twin of ``experiments/accuracy_parity_synsys.py``: the paper's
canonical synSys accuracy study, run by the PyTorch port on the card.

The flow, the command line, the transcribed reference cached-args, the
NAVAR and smoke overrides and the sample counts are the JAX script's:

1. curate the numF<F>_numSF<F>_numN<N>_numE<E> synthetic system across
   folds (``data/curation.py:curate_synthetic_fold``, host numpy, so a fold
   equals the JAX package's bit for bit) at 1,040 train / 240 validation
   recordings, T=100, gaussian innovations, OneHot labels;
2. train REDCLIFF-S (DGCNN embedder, 300-epoch schedule with 100 pretrain
   + 100 acclimation) and the baselines through the port's array-task
   driver (``train/driver.py:set_up_and_run_experiments``);
3. score every run's GC estimates against the fold's true factor graphs
   with the cross-algorithm optimal-F1 battery (``eval/cross_alg.py``);
4. optionally (``--dynamic``) score the dynamic readouts
   (``eval/dynamic_readout.py``: one ``graph_mix`` per REDCLIFF recording);
5. write mean +- SEM off-diagonal optimal F1 / ROC-AUC per algorithm, and
   the wall of each curation, array task and evaluation, to
   ``<workdir>/ACCURACY_SYNSYS_<N>_<E>_<F>.json`` (smoke:
   ``ACCURACY_SYNSYS_smoke.json``).

It imports only ``redcliff_tpu_torch`` and runs on ``cuda`` through the
entry points' defaults (the JAX script pins its CPU); ``main(argv,
device=...)`` runs it elsewhere.

Run:  python -m redcliff_tpu_torch.experiments.accuracy_parity_synsys \
      <workdir> [--folds N] [--smoke] [--only-fold K] [--eval-only]
      [--system N-E-F] [--dynamic] [--algs all|ref]
"""
import argparse
import json
import os
import time

import numpy as np

from redcliff_tpu_torch.data.curation import curate_synthetic_fold
from redcliff_tpu_torch.data.shards import load_normalized_samples
from redcliff_tpu_torch.eval.cross_alg import run_cross_algorithm_comparison
from redcliff_tpu_torch.eval.dynamic_readout import (
    run_dynamic_readout_evaluation)
from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
from redcliff_tpu_torch.utils.config import load_true_gc_factors

# reference cached-args, transcribed (stringly-typed like the originals)
REDCLIFF_ARGS = {
    "output_length": "1", "batch_size": "128", "max_iter": "300",
    "lookback": "1", "check_every": "10", "verbose": "0", "num_sims": "1",
    "num_factors": "2", "num_supervised_factors": "2",
    "wavelet_level": "None", "gen_hidden": "[25]", "gen_lr": "0.0005",
    "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "gen_lag_and_input_len": "4", "FORECAST_COEFF": "10.0",
    "FACTOR_SCORE_COEFF": "100.0", "FACTOR_COS_SIM_COEFF": "1.0",
    "FACTOR_WEIGHT_L1_COEFF": "0.001",
    "FACTOR_WEIGHT_SMOOTHING_PENALTY_COEFF": "0.0",
    "ADJ_L1_REG_COEFF": "0.1", "DAGNESS_REG_COEFF": "0.0",
    "DAGNESS_LAG_COEFF": "0.0", "DAGNESS_NODE_COEFF": "0.0",
    "primary_gc_est_mode": "conditional_factor_fixed_embedder",
    "forward_pass_mode": "apply_factor_weights_after_sim_completion",
    "training_mode": "pretrain_embedder_then_acclimate_factors_then_combined",
    "num_pretrain_epochs": "100", "num_acclimation_epochs": "100",
    "factor_score_embedder_type": "DGCNN", "embed_hidden_sizes": "[0]",
    "embed_num_hidden_nodes": "100", "embed_num_graph_conv_layers": "3",
    "embed_lr": "0.0005", "embed_eps": "0.0001",
    "embed_weight_decay": "0.0001", "embed_lag": "16",
    "use_sigmoid_restriction": "0", "sigmoid_eccentricity_coeff": "10.0",
    "prior_factors_path": "None", "cost_criteria": "CosineSimilarity",
    "unsupervised_start_index": "0", "max_factor_prior_batches": "10",
    "stopping_criteria_forecast_coeff": "10.",
    "stopping_criteria_factor_coeff": "100.",
    "stopping_criteria_cosSim_coeff": "1.", "deltaConEps": "0.1",
    "in_degree_coeff": "1.", "out_degree_coeff": "1.",
}
# ref train/cMLP_synSysInnovGauss1030_BLgs2Parsim_mi300_cached_args.txt
CMLP_ARGS = {
    "output_length": "1", "num_sims": "1", "embed_hidden_sizes": "[10]",
    "batch_size": "128", "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "max_iter": "300", "lookback": "1", "check_every": "10", "verbose": "0",
    "num_factors": "1", "num_supervised_factors": "0",
    "wavelet_level": "None", "gen_hidden": "[25]", "gen_lr": "0.0001",
    "gen_lag_and_input_len": "2", "FORECAST_COEFF": "1.0",
    "FACTOR_SCORE_COEFF": "0.0", "ADJ_L1_REG_COEFF": "1.0",
    "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
    "DAGNESS_NODE_COEFF": "0.0",
}
# ref train/NAVAR_CMLP_d4IC_BCTVgs1Parsim_cached_args.txt, nodes adjusted
NAVAR_ARGS = {
    "num_nodes": "6", "num_hidden": "256", "maxlags": "20",
    "hidden_layers": "2", "dropout": "0", "val_proportion": "0.0",
    "epochs": "1000", "batch_size": "128", "check_every": "100",
    "learning_rate": "0.0001", "weight_decay": "0",
    "split_timeseries": "0", "signal_format": "original", "lambda1": "0.0",
}
# ref train/DYNOTEARS_Vanilla_d4IC_BCNIBCHVgs1Parsim_cached_args.txt
DYNOTEARS_ARGS = {
    "lambda_w": "0.9", "lambda_a": "0.1", "max_iter": "100",
    "h_tol": "0.00000001", "w_threshold": "0.0", "tabu_edges": "None",
    "tabu_parent_nodes": "None", "tabu_child_nodes": "None",
    "lag_size": "1", "signal_format": "original",
}
# ref train/cLSTM_synSysInnovGauss1030_BLgs2_mi300_cached_args.txt
CLSTM_ARGS = {
    "output_length": "1", "num_sims": "1", "embed_hidden_sizes": "[10]",
    "batch_size": "128", "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "max_iter": "300", "lookback": "3", "check_every": "5", "verbose": "0",
    "num_factors": "1", "num_supervised_factors": "0",
    "wavelet_level": "None", "gen_hidden": "25", "gen_lr": "0.0001",
    "context": "2", "max_input_length": "4", "FORECAST_COEFF": "1.0",
    "FACTOR_SCORE_COEFF": "0.0", "ADJ_L1_REG_COEFF": "1.0",
    "DAGNESS_REG_COEFF": "0.0", "DAGNESS_LAG_COEFF": "0.0",
    "DAGNESS_NODE_COEFF": "0.0",
}
# ref train/DGCNN_synSysInnovGauss1030_BLgs2_mi300_cached_args.txt
# (num_channels/num_classes follow the 6-node 2-factor dataset, as the
# reference's per-dataset overwrite would set them)
DGCNN_ARGS = {
    "batch_size": "128", "gen_eps": "0.0001", "gen_weight_decay": "0.0001",
    "max_iter": "300", "lookback": "1", "check_every": "10", "verbose": "0",
    "num_channels": "6", "wavelet_level": "None",
    "num_wavelets_per_chan": "1", "num_features_per_node": "2",
    "num_graph_conv_layers": "3", "num_hidden_nodes": "250",
    "num_classes": "2", "signal_format": "original flattened",
    "gen_lr": "0.0001",
}
# ref train/DCSFANMF_synSysInnovGauss1030_BOBPgs2Parsim_cached_args.txt
# (n_components/n_sup_networks follow the 2-factor dataset)
DCSFA_ARGS = {
    "batch_size": "128", "num_high_level_node_features": "13",
    "best_model_name": "dCSFA-NMF-best-model.pt", "num_node_features": "50",
    "n_components": "2", "n_sup_networks": "2",
    "signal_format": "original flattened directed_spectrum vanilla",
    "h": "256", "momentum": "0.9", "lr": "0.0005", "recon_weight": "2.0",
    "sup_weight": "1.0", "sup_recon_weight": "1.0",
    "sup_smoothness_weight": "1.0", "n_epochs": "250",
    "n_pre_epochs": "50", "nmf_max_iter": "10",
}

# the reference's synSys experiment matrix is REDCLIFF-S vs
# {cMLP, cLSTM, DGCNN, DCSFA-NMF} (train/*_synSysInnovGauss1030_*); NAVAR and
# DYNOTEARS are its d4IC-only baselines, included here as extended baselines
MODELS = (
    ("REDCLIFF_S_CMLP", REDCLIFF_ARGS, "REDCLIFF_S_CMLP"),
    ("cMLP", CMLP_ARGS, "CMLP"),
    ("cLSTM", CLSTM_ARGS, "CLSTM"),
    ("DGCNN", DGCNN_ARGS, "DGCNN"),
    ("DCSFANMF", DCSFA_ARGS, "DCSFA"),
    ("NAVAR_CMLP", NAVAR_ARGS, "NAVAR_CMLP"),
    ("DYNOTEARS_Vanilla", DYNOTEARS_ARGS, "DYNOTEARS_Vanilla"),
)



# (train, validation) recordings per fold: the reference's per-class
# budget kept as the total, as in the JAX script
SAMPLES = {False: (1040, 240), True: (240, 96)}
PARADIGM = "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--folds", type=int, default=3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--only-fold", type=int, default=None,
                    help="curate+train just this fold (for cross-process "
                         "fold parallelism), skip evaluation")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training (runs must exist) and just evaluate")
    ap.add_argument("--system", default="6-2-2",
                    help="synthetic system (nodes-edges-factors shorthand "
                         "N-E-F as in the paper, e.g. 6-2-2, 12-11-2, 3-1-2, "
                         "6-4-2, 6-2-3 — any of the reference synSysIG1030 "
                         "complexity-sweep configurations)")
    ap.add_argument("--dynamic", action="store_true",
                    help="additionally score the DYNAMIC readouts (embedder "
                         "state-score tracking + conditional-GC edge dynamics "
                         "vs the oracle activations) for every algorithm")
    ap.add_argument("--algs", default="all", choices=["all", "ref"],
                    help="'ref' = the reference's synSys baseline set only "
                         "(REDCLIFF, cMLP, cLSTM, DGCNN, DCSFA)")
    return ap.parse_args(argv)


def model_args_for(models, num_nodes, num_factors, smoke):
    """Each family's cached-args for this system: the JAX script's
    per-dataset overwrites, NAVAR's epoch cut and the smoke's depth cuts."""
    model_args = {name: dict(a) for name, a, _ in models}
    if num_nodes != 6 and "NAVAR_CMLP" in model_args:
        # NAVAR's num_nodes comes from its model cached-args; every other
        # family's channel count is overwritten from the DATA cached-args
        model_args["NAVAR_CMLP"]["num_nodes"] = str(num_nodes)
    if num_factors != 2:
        # the reference's per-dataset factor-count overwrite
        model_args["REDCLIFF_S_CMLP"].update(
            num_factors=str(num_factors),
            num_supervised_factors=str(num_factors))
        if "DGCNN" in model_args:
            model_args["DGCNN"]["num_classes"] = str(num_factors)
        if "DCSFANMF" in model_args:
            model_args["DCSFANMF"].update(
                n_components=str(num_factors),
                n_sup_networks=str(num_factors))
    # the JAX script's deviation from the reference's d4IC NAVAR epochs=1000
    if "NAVAR_CMLP" in model_args:
        model_args["NAVAR_CMLP"].update(epochs="250", check_every="50")
    if smoke:
        model_args["REDCLIFF_S_CMLP"].update(
            max_iter="12", num_pretrain_epochs="4",
            num_acclimation_epochs="4", check_every="2")
        model_args["cMLP"].update(max_iter="10", check_every="2")
        model_args["cLSTM"].update(max_iter="10", check_every="2")
        model_args["DGCNN"].update(max_iter="10", check_every="2")
        model_args["DCSFANMF"].update(n_epochs="10", n_pre_epochs="4")
        if "NAVAR_CMLP" in model_args:
            model_args["NAVAR_CMLP"].update(epochs="40", check_every="20")
    return model_args


def summarize(full):
    """Mean +- SEM of the off-diagonal optimal F1 and ROC-AUC per
    algorithm, as the JAX script writes them."""
    out = {}
    for alg, stats in full["data"][PARADIGM].items():
        out[alg] = {
            "offdiag_optimal_f1_mean": stats["f1_mean_across_factors"],
            "offdiag_optimal_f1_sem": stats["f1_mean_std_err_across_factors"],
            "offdiag_roc_auc_mean": stats.get("roc_auc_mean_across_factors"),
            "offdiag_roc_auc_sem": stats.get(
                "roc_auc_mean_std_err_across_factors"),
        }
        print(f"[result] {alg}: optF1 "
              f"{out[alg]['offdiag_optimal_f1_mean']:.3f} ± "
              f"{out[alg]['offdiag_optimal_f1_sem']:.3f}  "
              f"ROC-AUC {out[alg]['offdiag_roc_auc_mean']}", flush=True)
    return out


def main(argv=None, device=None):
    """Run the study; ``device`` is handed to every array task and eval
    entry point (``cuda`` unless given). Returns the JSON it writes, or
    None after ``--only-fold``."""
    args = parse_args(argv)
    base = args.workdir
    os.makedirs(base, exist_ok=True)
    num_nodes, num_edges, num_factors = (int(v)
                                         for v in args.system.split("-"))
    sys_folder = f"synSys{num_nodes}_{num_edges}_{num_factors}"
    models = MODELS
    if args.algs == "ref":
        models = tuple(m for m in MODELS
                       if m[0] not in ("NAVAR_CMLP", "DYNOTEARS_Vanilla"))
    n_train, n_val = SAMPLES[bool(args.smoke)]
    model_args = model_args_for(models, num_nodes, num_factors, args.smoke)
    walls = {"curate_s": {}, "train_s": {}}

    folds_to_run = (range(args.folds) if args.only_fold is None
                    else [args.only_fold])
    data_args_by_fold = {}
    true_by_fold = {}
    for fold in folds_to_run:
        t0 = time.time()
        fold_dir, _ = curate_synthetic_fold(
            os.path.join(base, "data"), fold_id=fold, num_nodes=num_nodes,
            num_lags=2, num_factors=num_factors,
            num_supervised_factors=num_factors,
            num_edges_per_graph=num_edges, num_samples_in_train_set=n_train,
            num_samples_in_val_set=n_val, sample_recording_len=100,
            burnin_period=50, label_type_setting="OneHot",
            noise_type="gaussian", noise_level=1.0,
            folder_name=sys_folder)
        data_args_by_fold[fold] = os.path.join(
            fold_dir, f"data_fold{fold}_cached_args.txt")
        true_by_fold[fold] = load_true_gc_factors(data_args_by_fold[fold])
        walls["curate_s"][fold] = time.time() - t0
        print(f"[curate] fold {fold}: {time.time()-t0:.1f}s -> {fold_dir}",
              flush=True)

    roots = {}
    for model_type, _, alias in models:
        margs_file = os.path.join(base, f"{model_type}_synSys_cached_args.txt")
        with open(margs_file, "w") as f:
            json.dump(model_args[model_type], f)
        save_root = os.path.join(base, "runs", f"{alias}_models")
        os.makedirs(save_root, exist_ok=True)
        roots[alias] = save_root
        if args.eval_only:
            continue
        for fold in folds_to_run:
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

    if args.only_fold is not None:
        print(f"[done] fold {args.only_fold} trained; run --eval-only "
              "after all folds finish", flush=True)
        return None

    # eval windows for data-dependent GC readouts (NAVAR contribution
    # stats), z-scored exactly as the training loaders normalized them
    t0 = time.time()
    eval_inputs = {"data": {}}
    for fold in range(args.folds):
        if fold not in data_args_by_fold:
            fd = os.path.join(base, "data", sys_folder, f"fold_{fold}")
            data_args_by_fold[fold] = os.path.join(
                fd, f"data_fold{fold}_cached_args.txt")
            true_by_fold[fold] = load_true_gc_factors(data_args_by_fold[fold])
        val_dir = os.path.join(os.path.dirname(data_args_by_fold[fold]),
                               "validation")
        eval_inputs["data"][fold] = np.asarray(
            load_normalized_samples(val_dir).X[:128])

    system_key = (f"numF{num_factors}_numSF{num_factors}_"
                  f"numN{num_nodes}_numE{num_edges}_{sys_folder}")
    full = run_cross_algorithm_comparison(
        list(roots.values()), {"data": true_by_fold},
        os.path.join(base, "evals", system_key),
        num_folds=args.folds, plot=not args.smoke,
        algorithms=[alias for _, _, alias in models],
        eval_inputs=eval_inputs, device=device)
    walls["eval_s"] = time.time() - t0

    out = {"dataset": f"{system_key} (OneHot, gaussian innovations)",
           "system": args.system,
           "folds": args.folds, "smoke": bool(args.smoke),
           "train_samples_per_fold": n_train,
           "algorithms": summarize(full)}

    if args.dynamic:
        t0 = time.time()
        out["dynamic_readouts"] = run_dynamic_readout_evaluation(
            roots=roots, data_args_by_fold=data_args_by_fold,
            true_by_fold=true_by_fold, num_folds=args.folds,
            num_supervised_factors=num_factors,
            save_root=os.path.join(base, "evals", system_key, "dynamic"),
            device=device)
        walls["dynamic_s"] = time.time() - t0
    out["wall_s"] = walls

    tag = "_" + args.system.replace("-", "_")
    dest = os.path.join(base, f"ACCURACY_SYNSYS{tag}.json"
                        if not args.smoke else "ACCURACY_SYNSYS_smoke.json")
    with open(dest, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[done] wrote {dest}", flush=True)
    return out


if __name__ == "__main__":
    main()
