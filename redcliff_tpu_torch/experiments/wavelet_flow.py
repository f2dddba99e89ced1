"""Port twin of ``experiments/wavelet_flow.py``: the wavelet-decomposed
training flow (the TST gsSmooth1 shape), run by the PyTorch port on the
card.

The flow, the command line, the configurations and the smoke cuts are the
JAX script's:

1. curate a synthetic LFP analog with the TST structure, 6 channels, 2
   edges a graph, 3 labeled states, recordings of 128 steps (divisible by
   2**3, as the stationary wavelet transform asks), through
   ``data/curation.py:curate_synthetic_fold`` (host numpy: the JAX
   package's fold bit for bit);
2. train through the array-task driver at ``wavelet_level`` 3 (4 bands a
   channel, 24 series): REDCLIFF-S Smooth (9 factors, 3 supervised; the
   factor-mix kernel at every forward) and the cMLP baseline on
   ``wavelet_decomp`` input, and a REDCLIFF-S Smooth control on the raw
   6 channels of the same folds;
3. score each run with the off-diagonal optimal-F1 battery (the condensed
   readout, ``combine_wavelet_representations=True``) and, for the wavelet
   runs, with the wavelet-ranked readout (:func:`ranked_readout_offdiag`);
4. write the JSON the JAX script writes (its key set) to
   ``<workdir>/ACCURACY_WAVELET_6_2_3.json`` or, with ``--smoke``,
   ``<workdir>_smoke/ACCURACY_WAVELET_smoke.json``. Nothing is written
   beside this file.

The cached args set no ``prox_penalty``, so the GL prox is off on this
path, as in the JAX script. It imports only ``redcliff_tpu_torch`` and
runs on ``cuda`` unless ``main(argv, device=...)`` says otherwise.

Run:  python -m redcliff_tpu_torch.experiments.wavelet_flow <workdir>
      [--smoke] [--folds N]
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from redcliff_tpu_torch.data.curation import curate_synthetic_fold
from redcliff_tpu_torch.eval.cross_alg import (evaluate_algorithm_on_fold,
                                               find_run_directory)
from redcliff_tpu_torch.eval.model_io import load_model_for_eval
from redcliff_tpu_torch.eval.stats import three_view_optimal_f1_stats
from redcliff_tpu_torch.experiments.accuracy_parity_synsys import (
    CMLP_ARGS, REDCLIFF_ARGS)
from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
from redcliff_tpu_torch.utils.config import load_true_gc_factors
from redcliff_tpu_torch.utils.precision import resolve_device

OFFDIAG = "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag"
WAVELET_LEVEL = 3          # 4 bands a channel: the ranking mask's domain
RECORDING_LEN = 128        # divisible by 2**3; the TST windows are 1024
NUM_NODES, NUM_EDGES, NUM_STATES = 6, 2, 3

# the TST gsSmooth1 configuration at the analog's size: 9 factors, 3
# supervised, as the reference sets them for TST's 3 behavioral states
SMOOTH_WAVELET_ARGS = dict(
    REDCLIFF_ARGS,
    num_factors="9", num_supervised_factors="3",
    wavelet_level=str(WAVELET_LEVEL),
    FACTOR_WEIGHT_SMOOTHING_PENALTY_COEFF="25.0",
    ADJ_L1_REG_COEFF="0.1",
)
CMLP_WAVELET_ARGS = dict(CMLP_ARGS, wavelet_level=str(WAVELET_LEVEL))
SMOOTH_CONTROL_ARGS = dict(SMOOTH_WAVELET_ARGS, wavelet_level="None")

# (model type, cached args, alias); the driver picks the Smooth class for
# any model type naming "Smooth"
MODELS = (
    ("REDCLIFF_S_CMLP_Smooth", SMOOTH_WAVELET_ARGS, "REDCLIFF_Smooth_wav"),
    ("cMLP", CMLP_WAVELET_ARGS, "CMLP_wav"),
    ("REDCLIFF_S_CMLP_SmoothCtl", SMOOTH_CONTROL_ARGS, "REDCLIFF_Smooth_raw"),
)

# (train, validation) recordings of a fold
SAMPLES = {False: (1040, 240), True: (24, 8)}
# the smoke's depth cuts, by model type: both REDCLIFF-S runs alike
_REDCLIFF_CUTS = dict(max_iter="10", num_pretrain_epochs="3",
                      num_acclimation_epochs="3", check_every="2")
SMOKE_CUTS = {"REDCLIFF_S_CMLP_Smooth": _REDCLIFF_CUTS,
              "REDCLIFF_S_CMLP_SmoothCtl": _REDCLIFF_CUTS,
              "cMLP": dict(max_iter="8", check_every="2")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--folds", type=int, default=2)
    return ap.parse_args(argv)


def model_args(smoke):
    """{model type: cached args trained}, the smoke cuts applied under
    ``--smoke``."""
    out = {name: dict(a) for name, a, _ in MODELS}
    if smoke:
        for name, cuts in SMOKE_CUTS.items():
            out[name].update(cuts)
    return out


def curate_fold(base, fold, n_train, n_val):
    """The fold of the LFP analog under ``base/data``. Returns its data
    cached-args path."""
    fold_dir, _ = curate_synthetic_fold(
        os.path.join(base, "data"), fold_id=fold, num_nodes=NUM_NODES,
        num_lags=2, num_factors=NUM_STATES,
        num_supervised_factors=NUM_STATES, num_edges_per_graph=NUM_EDGES,
        num_samples_in_train_set=n_train, num_samples_in_val_set=n_val,
        sample_recording_len=RECORDING_LEN, burnin_period=50,
        label_type_setting="OneHot", noise_type="gaussian", noise_level=1.0,
        folder_name="lfpAnalog6_2_3")
    return os.path.join(fold_dir, f"data_fold{fold}_cached_args.txt")


def train_model(save_root, model_type, margs_file, dargs_file, fold,
                device=None):
    """One array task: ``model_type`` on the fold. Returns its run dir."""
    set_up_and_run_experiments(
        {"save_root_path": save_root}, [margs_file], [dargs_file],
        possible_model_types=[model_type],
        possible_data_sets=[f"data_fold{fold}"], task_id=1, device=device)
    return find_run_directory(save_root, "data", fold)


def ranked_readout_offdiag(run_dir, alg, true_gcs, device=None):
    """The wavelet-ranked condensed readout (``rank_wavelets=True``),
    scored with the same off-diagonal statistic, one F1 a true graph; None
    for a run without wavelets."""
    model, params = load_model_for_eval(run_dir, device=device)[:2]
    cfg = getattr(model, "config", None)
    if getattr(cfg, "wavelet_level", None) is None:
        return None
    with torch.no_grad():
        if "REDCLIFF" in alg:
            # the battery's list-of-factors readout with the ranking mask
            ests_by_sample = model.gc_as_lists(
                params, gc_est_mode="fixed_factor_exclusive",
                threshold=False, ignore_lag=False,
                combine_wavelet_representations=True, rank_wavelets=True)
            est = np.stack([np.asarray(e, np.float64)
                            for e in ests_by_sample[0]])
        else:
            # a generic family's list of estimates (length 1)
            est = np.stack([g.detach().cpu().numpy().astype(np.float64)
                            for g in model.gc(
                                params, threshold=False, ignore_lag=False,
                                combine_wavelet_representations=True,
                                rank_wavelets=True)])
    f1s = []
    for k, true in enumerate(true_gcs):
        e = est[min(k, est.shape[0] - 1)]
        f1s.append(three_view_optimal_f1_stats(
            np.asarray(e, np.float64), true)[OFFDIAG]["f1"])
    return f1s


def _mean_sem(vals):
    a = np.asarray(vals, dtype=np.float64)
    sem = float(a.std(ddof=1) / np.sqrt(len(a))) if len(a) > 1 else 0.0
    return float(a.mean()), sem


def result_row(pooled, pooled_ranked):
    """The JSON row of one algorithm: mean +- SEM of its pooled per-factor
    F1s, and of the ranked readout's where there are any."""
    row = dict(zip(("offdiag_optimal_f1_mean", "offdiag_optimal_f1_sem"),
                   _mean_sem(pooled)))
    if pooled_ranked:
        row.update(zip(("ranked_offdiag_optimal_f1_mean",
                        "ranked_offdiag_optimal_f1_sem"),
                       _mean_sem(pooled_ranked)))
    return row


def main(argv=None, device=None, records=None):
    """Run the study on ``device`` (``cuda`` unless given: raises without
    CUDA). Returns the JSON it writes. ``records``, a dict, receives the
    run dirs it scored by alias (``"run_dirs"``), for a caller that checks
    the run."""
    args = parse_args(argv)
    device = resolve_device(device)
    base = os.path.abspath(args.workdir) + ("_smoke" if args.smoke else "")
    os.makedirs(base, exist_ok=True)
    n_train, n_val = SAMPLES[bool(args.smoke)]
    margs_by_type = model_args(args.smoke)

    dargs_by_fold, true_by_fold = {}, {}
    for fold in range(args.folds):
        t0 = time.time()
        dargs_by_fold[fold] = curate_fold(base, fold, n_train, n_val)
        true_by_fold[fold] = load_true_gc_factors(dargs_by_fold[fold])
        print(f"[curate] fold {fold}: {time.time()-t0:.1f}s", flush=True)

    out = {"dataset": f"synthetic LFP-analog {NUM_NODES}-{NUM_EDGES}-"
                      f"{NUM_STATES}, T={RECORDING_LEN}, OneHot",
           "wavelet_level": WAVELET_LEVEL, "folds": args.folds,
           "smoke": bool(args.smoke), "algorithms": {}}
    run_dirs = {}
    for model_type, _, alias in MODELS:
        margs_file = os.path.join(base, f"{model_type}_cached_args.txt")
        with open(margs_file, "w") as f:
            json.dump(margs_by_type[model_type], f)
        save_root = os.path.join(base, "runs", f"{alias}_models")
        os.makedirs(save_root, exist_ok=True)
        # the Smooth control shares the REDCLIFF readout
        alg = "REDCLIFF_S_CMLP" if "REDCLIFF" in model_type else "CMLP"
        pooled, pooled_ranked = [], []
        for fold in range(args.folds):
            t0 = time.time()
            run_dir = train_model(save_root, model_type, margs_file,
                                  dargs_by_fold[fold], fold, device=device)
            print(f"[train] {alias} fold {fold}: {time.time()-t0:.1f}s",
                  flush=True)
            run_dirs.setdefault(alias, []).append(run_dir)
            stats = evaluate_algorithm_on_fold(run_dir, alg,
                                               true_by_fold[fold],
                                               device=device)
            pooled.extend(stats[OFFDIAG]["f1_vals_across_factors"])
            ranked = ranked_readout_offdiag(run_dir, alg, true_by_fold[fold],
                                            device=device)
            if ranked is not None:
                pooled_ranked.extend(ranked)
        out["algorithms"][alias] = result_row(pooled, pooled_ranked)
        print(f"[result] {alias}: {out['algorithms'][alias]}", flush=True)
    if records is not None:
        records.update(run_dirs=run_dirs)

    dest = os.path.join(base, "ACCURACY_WAVELET_6_2_3.json"
                        if not args.smoke else "ACCURACY_WAVELET_smoke.json")
    with open(dest, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[done] wrote {dest}", flush=True)
    return out


if __name__ == "__main__":
    main()
