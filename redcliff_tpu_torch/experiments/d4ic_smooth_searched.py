"""Port twin of ``experiments/d4ic_smooth_searched.py``: the Smooth
"Parsim" D4IC architecture with the searched coefficients, run by the
PyTorch port on the card.

The flow, the command line, the coefficients and the smoke cuts are the
JAX script's. It applies the coefficients that the JAX selection study
picked (``experiments/D4IC_GRID_SEARCH.json``: gen_lr 2e-3, ADJ_L1 0.1,
COS_SIM 0.1) to the Smooth architecture (``gen_hidden`` [100], a 2 x 30
DGCNN embedder, ``embed_lag`` 20) and scores it in the ACCURACY_D4IC
setup:

1. curate each SNR tier x fold of the D4IC analog (the grid-search
   twin's ``curate_tier_fold``, recordings from the device generator);
2. train ``REDCLIFF_S_CMLP_Smooth_searched`` on it through the array-task
   driver (``set_up_and_run_experiments``: the Smooth class, the
   factor-mix kernel at every forward);
3. score the run with the off-diagonal optimal-F1 battery and pool the
   folds of a tier (``pooled_offdiag``);
4. write the JSON the JAX script writes (its key set) to
   ``<workdir>/D4IC_SMOOTH_SEARCHED.json`` or, with ``--smoke``,
   ``<workdir>_smoke/D4IC_SMOOTH_SEARCHED_smoke.json``. Nothing is written
   beside this file.

The coefficients are the JAX script's constants, not the port's own
selection, so the rows compare with the committed JAX JSON row for row.
The cached args set no ``prox_penalty``, so the GL prox is off on this
path, as in the JAX script. It imports only ``redcliff_tpu_torch`` and
runs on ``cuda`` unless ``main(argv, device=...)`` says otherwise.

Run:  python -m redcliff_tpu_torch.experiments.d4ic_smooth_searched
      <workdir> [--smoke] [--folds N]
"""
import argparse
import json
import os
import time

from redcliff_tpu_torch.eval.cross_alg import (evaluate_algorithm_on_fold,
                                               find_run_directory)
from redcliff_tpu_torch.experiments.accuracy_parity_d4ic import SMOOTH_ARGS
from redcliff_tpu_torch.experiments.d4ic_grid_search import (
    SMOKE_CUTS, TIERS, curate_tier_fold, pooled_offdiag)
from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
from redcliff_tpu_torch.utils.config import load_true_gc_factors
from redcliff_tpu_torch.utils.precision import resolve_device

# the searched coefficients (D4IC_GRID_SEARCH.json's selected point),
# applied to the Smooth architecture: gen_lr 5e-4 -> 2e-3 and COS_SIM
# 1.0 -> 0.1 (ADJ_L1 was already 0.1 in the Smooth config)
SEARCHED = dict(SMOOTH_ARGS, gen_lr="0.002", FACTOR_COS_SIM_COEFF="0.1",
                ADJ_L1_REG_COEFF="0.1")
COEFFICIENTS = {"gen_lr": 0.002, "ADJ_L1_REG_COEFF": 0.1,
                "FACTOR_COS_SIM_COEFF": 0.1}
# the driver dispatches any model type naming "Smooth" to the Smooth class
MODEL_TYPE = "REDCLIFF_S_CMLP_Smooth_searched"

# (train, validation) recordings per network and fold
SAMPLES = {False: (120, 30), True: (24, 8)}

# the rows the JAX script records beside its result
ROUND4_SMOOTH = {"HSNR": 0.315, "MSNR": 0.319, "LSNR": 0.211}
ROUND5_NONSMOOTH = {"HSNR": 0.285, "MSNR": 0.280, "LSNR": 0.229}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--folds", type=int, default=3)
    return ap.parse_args(argv)


def model_args(smoke):
    """The cached args trained: :data:`SEARCHED`, with the smoke cuts
    applied under ``--smoke``."""
    margs = dict(SEARCHED)
    if smoke:
        margs.update(SMOKE_CUTS)
    return margs


def main(argv=None, device=None, records=None):
    """Run the study on ``device`` (``cuda`` unless given: raises without
    CUDA). Returns the JSON it writes. ``records``, a dict, receives the
    run dirs it scored (``"run_dirs"``), for a caller that checks the
    run."""
    args = parse_args(argv)
    device = resolve_device(device)
    base = os.path.abspath(args.workdir) + ("_smoke" if args.smoke else "")
    os.makedirs(base, exist_ok=True)
    n_train, n_val = SAMPLES[bool(args.smoke)]

    margs_file = os.path.join(base, f"{MODEL_TYPE}_cached_args.txt")
    with open(margs_file, "w") as f:
        json.dump(model_args(args.smoke), f)

    tiers = TIERS if not args.smoke else ("HSNR",)
    rows, run_dirs = {}, []
    for snr in tiers:
        stats_by_fold = []
        for fold in range(args.folds):
            dargs = curate_tier_fold(base, snr, fold, n_train, n_val,
                                     device=device)
            save_root = os.path.join(base, f"runs_{snr}")
            os.makedirs(save_root, exist_ok=True)
            t0 = time.time()
            set_up_and_run_experiments(
                {"save_root_path": save_root}, [margs_file], [dargs],
                possible_model_types=[MODEL_TYPE],
                possible_data_sets=[f"data_fold{fold}"], task_id=1,
                device=device)
            print(f"[{snr}] fold {fold}: {time.time()-t0:.1f}s", flush=True)
            run_dir = find_run_directory(save_root, "data", fold)
            run_dirs.append(run_dir)
            stats_by_fold.append(evaluate_algorithm_on_fold(
                run_dir, "REDCLIFF_S_CMLP", load_true_gc_factors(dargs),
                device=device))
        rows[snr] = pooled_offdiag(stats_by_fold)
        print(f"[{snr}] optF1 {rows[snr]['offdiag_optimal_f1_mean']:.3f} ± "
              f"{rows[snr]['offdiag_optimal_f1_sem']:.3f}", flush=True)
    if records is not None:
        records.update(run_dirs=run_dirs)

    out = {
        "description": "Smooth (BSCgs4ParsimSmo0) architecture with the "
                       "round-5 grid-searched coefficients, ACCURACY_D4IC "
                       "setup",
        "coefficients": dict(COEFFICIENTS),
        "folds": args.folds, "smoke": bool(args.smoke),
        "rows": rows,
        "round4_smooth_transcribed": dict(ROUND4_SMOOTH),
        "round5_nonsmooth_searched": dict(ROUND5_NONSMOOTH),
    }
    dest = os.path.join(base, "D4IC_SMOOTH_SEARCHED.json" if not args.smoke
                        else "D4IC_SMOOTH_SEARCHED_smoke.json")
    with open(dest, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[done] wrote {dest}", flush=True)
    return out


if __name__ == "__main__":
    main()
