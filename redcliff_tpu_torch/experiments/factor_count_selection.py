"""Port twin of ``experiments/factor_count_selection.py``: the number of
factors selected by cross-validated stopping criteria (the notebook's
model-selection flow), run by the PyTorch port on the card.

The flow, the command line, the candidates and the smoke cuts are the JAX
script's. For each synSys system:

1. curate its folds (:func:`curate_system_folds`: ``data/curation.py``
   ``curate_synthetic_fold``, host numpy, the JAX package's folds bit for
   bit) at the banded study's sample budget;
2. train REDCLIFF-S at each ``num_factors`` K in :data:`K_CANDIDATES`
   through the array-task driver (:func:`train_k`; the factor-mix kernel
   at every forward), ``num_supervised_factors`` held at the system's
   labeled-state count, and score each run with the off-diagonal
   optimal-F1 battery;
3. read the run tree with ``eval/analysis.py:factor_selection_table`` and
   select K by the summed forecast and factor criteria minima
   (:func:`select_k`);
4. write the JSON the JAX script writes (its key set) to
   ``<workdir>/FACTOR_COUNT_SELECTION.json`` or, with ``--smoke``,
   ``<workdir>/FACTOR_COUNT_SELECTION_smoke.json``, merged with the
   systems of an earlier run in that file whose ``smoke`` flag matches.

Each system's folds and runs go under ``<workdir>/<system>[_smoke]``
(the JAX script puts them beside the work dir, ``<workdir>_<system>``):
the twin writes nothing outside its work dir. The cached args set no
``prox_penalty``, so the GL prox is off on this path, as in the JAX
script. It imports only ``redcliff_tpu_torch`` and runs on ``cuda``
unless ``main(argv, device=...)`` says otherwise.

Run:  python -m redcliff_tpu_torch.experiments.factor_count_selection
      <workdir> [--smoke] [--systems 3-1-2,6-4-2] [--folds N]
"""
import argparse
import json
import os
import time

import numpy as np

from redcliff_tpu_torch.data.curation import curate_synthetic_fold
from redcliff_tpu_torch.eval.analysis import factor_selection_table
from redcliff_tpu_torch.eval.cross_alg import (evaluate_algorithm_on_fold,
                                               find_run_directory)
from redcliff_tpu_torch.experiments.accuracy_parity_synsys import (
    REDCLIFF_ARGS)
from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
from redcliff_tpu_torch.utils.config import load_true_gc_factors
from redcliff_tpu_torch.utils.precision import resolve_device

OFFDIAG = "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag"
K_CANDIDATES = (2, 3, 4, 5, 6)
MODEL_TYPE = "REDCLIFF_S_CMLP"

# (train, validation) recordings of a fold
SAMPLES = {False: (1040, 240), True: (240, 96)}
SMOKE_CUTS = dict(max_iter="12", num_pretrain_epochs="4",
                  num_acclimation_epochs="4", check_every="2")
# the banded study's factor count and its REDCLIFF-S optimal F1 on the two
# systems this study exists for, which the JAX script records beside its
# result
BANDED_STUDY_DEFAULT_K = 2
BANDED_STUDY_REDCLIFF_OPTF1 = {"3-1-2": 0.460, "6-4-2": 0.397}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--systems", default="3-1-2,6-4-2")
    ap.add_argument("--folds", type=int, default=3)
    return ap.parse_args(argv)


def parse_system(system):
    """``"nodes-edges-states"`` as three ints."""
    return tuple(int(v) for v in system.split("-"))


def curate_system_folds(base, system, folds, smoke):
    """Each fold of ``system`` under ``base/data``. Returns ``({fold: data
    cached-args path}, {fold: true factor graphs})``."""
    num_nodes, num_edges, num_states = parse_system(system)
    n_train, n_val = SAMPLES[bool(smoke)]
    dargs_by_fold, true_by_fold = {}, {}
    for fold in range(folds):
        fold_dir, _ = curate_synthetic_fold(
            os.path.join(base, "data"), fold_id=fold, num_nodes=num_nodes,
            num_lags=2, num_factors=num_states,
            num_supervised_factors=num_states,
            num_edges_per_graph=num_edges, num_samples_in_train_set=n_train,
            num_samples_in_val_set=n_val, sample_recording_len=100,
            burnin_period=50, label_type_setting="OneHot",
            noise_type="gaussian", noise_level=1.0,
            folder_name=f"synSys{num_nodes}_{num_edges}_{num_states}")
        dargs_by_fold[fold] = os.path.join(
            fold_dir, f"data_fold{fold}_cached_args.txt")
        true_by_fold[fold] = load_true_gc_factors(dargs_by_fold[fold])
    return dargs_by_fold, true_by_fold


def k_model_args(K, num_states, smoke):
    """The cached args of the K-factor runs: the reference config with
    ``num_factors`` K and the system's supervised count, the smoke cuts
    under ``--smoke``."""
    margs = dict(REDCLIFF_ARGS, num_factors=str(K),
                 num_supervised_factors=str(num_states))
    if smoke:
        margs.update(SMOKE_CUTS)
    return margs


def train_k(base, system, K, num_states, dargs_by_fold, true_by_fold, smoke,
            device=None):
    """One array task per fold at ``num_factors`` K, each scored. Returns
    ``(run dirs, {offdiag_optimal_f1_mean, offdiag_optimal_f1_sem})`` over
    the pooled per-factor F1s."""
    margs_file = os.path.join(base, f"{MODEL_TYPE}_K{K}_cached_args.txt")
    with open(margs_file, "w") as f:
        json.dump(k_model_args(K, num_states, smoke), f)
    save_root = os.path.join(base, f"runs_K{K}")
    os.makedirs(save_root, exist_ok=True)
    run_dirs, pooled = [], []
    for fold, dargs in dargs_by_fold.items():
        t0 = time.time()
        set_up_and_run_experiments(
            {"save_root_path": save_root}, [margs_file], [dargs],
            possible_model_types=[MODEL_TYPE],
            possible_data_sets=[f"data_fold{fold}"], task_id=1,
            device=device)
        print(f"[{system} K={K}] fold {fold}: {time.time()-t0:.1f}s",
              flush=True)
        run_dir = find_run_directory(save_root, "data", fold)
        run_dirs.append(run_dir)
        stats = evaluate_algorithm_on_fold(run_dir, MODEL_TYPE,
                                           true_by_fold[fold], device=device)
        pooled.extend(stats[OFFDIAG]["f1_vals_across_factors"])
    f1 = np.asarray(pooled, dtype=np.float64)
    science = {
        "offdiag_optimal_f1_mean": float(f1.mean()),
        "offdiag_optimal_f1_sem": float(f1.std(ddof=1) / np.sqrt(len(f1)))
        if len(f1) > 1 else 0.0,
    }
    print(f"[{system} K={K}] optF1 {science['offdiag_optimal_f1_mean']:.3f}"
          f" ± {science['offdiag_optimal_f1_sem']:.3f}", flush=True)
    return run_dirs, science


def select_k(table):
    """``({K: forecast + factor criteria minima}, selected K)``: a missing
    criterion counts as ``inf``; the smallest sum wins, a tie going to the
    first K of :data:`K_CANDIDATES`."""
    selectable = {K: (table[K].get("avg_forecasting_loss_mean", np.inf)
                      + table[K].get("avg_factor_loss_mean", np.inf))
                  for K in K_CANDIDATES}
    return selectable, min(selectable, key=selectable.get)


def system_record(system, table, selectable, selected, science_by_k):
    """The JSON entry of one system."""
    return {
        "system": system,
        "num_labeled_states": parse_system(system)[2],
        "selection_table": table,
        "criteria_sum_by_k": {str(k): float(v)
                              for k, v in selectable.items()},
        "selected_num_factors": int(selected),
        "science_by_num_factors": {str(k): v
                                   for k, v in science_by_k.items()},
        "banded_study_default_k": BANDED_STUDY_DEFAULT_K,
        "banded_study_redcliff_optf1": BANDED_STUDY_REDCLIFF_OPTF1.get(
            system),
    }


def run_system(base, system, folds, smoke, device=None, records=None):
    """Curate, train every K, select and score one system. Returns its
    JSON entry; ``records`` (a dict) receives its run dirs by K."""
    num_states = parse_system(system)[2]
    dargs_by_fold, true_by_fold = curate_system_folds(base, system, folds,
                                                      smoke)
    run_dirs_by_k, science_by_k = {}, {}
    for K in K_CANDIDATES:
        run_dirs_by_k[K], science_by_k[K] = train_k(
            base, system, K, num_states, dargs_by_fold, true_by_fold, smoke,
            device=device)
    if records is not None:
        records[system] = run_dirs_by_k
    table = factor_selection_table(run_dirs_by_k)
    selectable, selected = select_k(table)
    print(f"[{system}] criteria-selected K = {selected} "
          f"(sums: { {k: round(v, 3) for k, v in selectable.items()} })",
          flush=True)
    return system_record(system, table, selectable, selected, science_by_k)


def merge_previous(dest, out):
    """``out`` with the systems of the JSON at ``dest`` that it does not
    replace, where that JSON's ``smoke`` flag matches (separate
    ``--systems`` runs build one file; a rerun of a system replaces its
    entry)."""
    if os.path.isfile(dest):
        try:
            with open(dest) as f:
                prev = json.load(f)
            if prev.get("smoke") == out["smoke"]:
                merged = dict(prev.get("systems", {}))
                merged.update(out["systems"])
                out["systems"] = merged
        except (OSError, json.JSONDecodeError):
            pass
    return out


def main(argv=None, device=None, records=None):
    """Run the study on ``device`` (``cuda`` unless given: raises without
    CUDA). Returns the JSON it writes. ``records``, a dict, receives each
    system's run dirs by K (``records["run_dirs"][system][K]``)."""
    args = parse_args(argv)
    device = resolve_device(device)
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    run_dirs = {}
    out = {"folds": args.folds, "smoke": bool(args.smoke), "systems": {}}
    for system in args.systems.split(","):
        base = os.path.join(workdir, system + ("_smoke" if args.smoke
                                               else ""))
        os.makedirs(base, exist_ok=True)
        out["systems"][system] = run_system(base, system, args.folds,
                                            args.smoke, device=device,
                                            records=run_dirs)
    if records is not None:
        records.update(run_dirs=run_dirs)
    dest = os.path.join(workdir, "FACTOR_COUNT_SELECTION.json"
                        if not args.smoke
                        else "FACTOR_COUNT_SELECTION_smoke.json")
    out = merge_previous(dest, out)
    with open(dest, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[done] wrote {dest}", flush=True)
    return out


if __name__ == "__main__":
    main()
