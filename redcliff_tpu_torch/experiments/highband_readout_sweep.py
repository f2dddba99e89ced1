"""Port twin of ``experiments/highband_readout_sweep.py``: the High-band
dynamic-readout sweep, run by the PyTorch port on the card.

The JAX script retrains the High-band factor-sweep systems (6-2-4, 6-2-5,
6-2-6: the banded study's configurations, generator, seeds and budgets)
with REDCLIFF-S (cMLP factors), cMLP and DGCNN, then scores the dynamic
readouts under :data:`CONDITIONS`: the round-4 convention (each algorithm
on its own window, the label anchored at the window's last step) and a
common window grid x ``label_align`` in {last, center, majority}. The flow,
the command line, the conditions and the smoke cuts are the JAX script's.
For each system:

1. curate its folds (:func:`curate_system_folds`: ``data/curation.py``
   ``curate_synthetic_fold``, host numpy, the JAX package's folds bit for
   bit);
2. train each algorithm on each fold through the array-task driver
   (:func:`train_models`; the factor-mix kernel at every REDCLIFF
   forward, cMLP and DGCNN launch none);
3. score the dynamic readouts under each condition
   (:func:`score_conditions`: ``eval/dynamic_readout.py``
   ``run_dynamic_readout_evaluation``, one ``graph_mix`` launch per
   REDCLIFF recording);
4. average the REDCLIFF means over the systems per condition
   (:func:`aggregate`) and write the JSON the JAX script writes (its key
   set) to ``<workdir>/HIGHBAND_READOUT_SWEEP.json`` or, with ``--smoke``,
   ``<workdir>/HIGHBAND_READOUT_SWEEP_smoke.json``, merged with the
   systems of an earlier run in that file whose ``smoke`` and ``folds``
   match (the aggregate is taken over the merged systems; runs of other
   ``--systems`` into one work dir may go side by side).

Each system's folds, runs and evaluations go under
``<workdir>/<system>[_smoke]`` (the JAX script puts them beside the work
dir, ``<workdir>_<system>[_smoke]``, and its JSON into ``experiments/``):
the twin writes nothing outside its work dir. No algorithm's cached args
set ``prox_penalty``, so the GL prox is off on this path, as in the JAX
script. It imports only ``redcliff_tpu_torch`` and runs on ``cuda``
unless ``main(argv, device=...)`` says otherwise.

Run:  python -m redcliff_tpu_torch.experiments.highband_readout_sweep
      <workdir> [--smoke] [--systems 6-2-4,6-2-5,6-2-6] [--folds N]
"""
import argparse
import fcntl
import json
import os
import time

import numpy as np

from redcliff_tpu_torch.data.curation import curate_synthetic_fold
from redcliff_tpu_torch.eval.dynamic_readout import (
    run_dynamic_readout_evaluation)
from redcliff_tpu_torch.experiments.accuracy_parity_synsys import (
    CMLP_ARGS, DGCNN_ARGS, REDCLIFF_ARGS)
from redcliff_tpu_torch.train.driver import set_up_and_run_experiments
from redcliff_tpu_torch.utils.config import load_true_gc_factors
from redcliff_tpu_torch.utils.precision import resolve_device

CONDITIONS = (
    {"name": "round4_convention", "common_window_grid": False,
     "label_align": "last"},
    {"name": "common_grid_last", "common_window_grid": True,
     "label_align": "last"},
    {"name": "common_grid_center", "common_window_grid": True,
     "label_align": "center"},
    {"name": "common_grid_majority", "common_window_grid": True,
     "label_align": "majority"},
)
# the model type of each algorithm and the alias its runs root carries
ALIASES = {"REDCLIFF_S_CMLP": "REDCLIFF_S_CMLP", "cMLP": "CMLP",
           "DGCNN": "DGCNN"}
# the REDCLIFF readout metrics the cross-system aggregate averages
METRICS = ("edge_tracking_r", "dynamic_optimal_f1", "state_score_r",
           "dominant_state_acc")

# (train, validation) recordings of a fold
SAMPLES = {False: (1040, 240), True: (240, 96)}
SMOKE_CUTS = {
    "REDCLIFF_S_CMLP": dict(max_iter="12", num_pretrain_epochs="4",
                            num_acclimation_epochs="4", check_every="2"),
    "cMLP": dict(max_iter="8", check_every="2"),
    "DGCNN": dict(max_iter="8", check_every="2"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--systems", default="6-2-4,6-2-5,6-2-6")
    ap.add_argument("--folds", type=int, default=3)
    return ap.parse_args(argv)


def parse_system(system):
    """``"nodes-edges-factors"`` as three ints."""
    return tuple(int(v) for v in system.split("-"))


def model_args(num_factors, smoke):
    """The cached args of each algorithm by model type: the synSys
    reference configs with the system's factor count (REDCLIFF-S's
    factors all supervised, DGCNN's classes), the smoke cuts under
    ``--smoke``."""
    margs = {
        "REDCLIFF_S_CMLP": dict(REDCLIFF_ARGS,
                                num_factors=str(num_factors),
                                num_supervised_factors=str(num_factors)),
        "cMLP": dict(CMLP_ARGS),
        "DGCNN": dict(DGCNN_ARGS, num_classes=str(num_factors)),
    }
    if smoke:
        for model_type, cuts in SMOKE_CUTS.items():
            margs[model_type].update(cuts)
    return margs


def curate_system_folds(base, system, folds, smoke):
    """Each fold of ``system`` under ``base/data``. Returns ``({fold: data
    cached-args path}, {fold: true factor graphs})``."""
    num_nodes, num_edges, num_factors = parse_system(system)
    n_train, n_val = SAMPLES[bool(smoke)]
    dargs_by_fold, true_by_fold = {}, {}
    for fold in range(folds):
        fold_dir, _ = curate_synthetic_fold(
            os.path.join(base, "data"), fold_id=fold, num_nodes=num_nodes,
            num_lags=2, num_factors=num_factors,
            num_supervised_factors=num_factors,
            num_edges_per_graph=num_edges, num_samples_in_train_set=n_train,
            num_samples_in_val_set=n_val, sample_recording_len=100,
            burnin_period=50, label_type_setting="OneHot",
            noise_type="gaussian", noise_level=1.0,
            folder_name=f"synSys{num_nodes}_{num_edges}_{num_factors}")
        dargs_by_fold[fold] = os.path.join(
            fold_dir, f"data_fold{fold}_cached_args.txt")
        true_by_fold[fold] = load_true_gc_factors(dargs_by_fold[fold])
    return dargs_by_fold, true_by_fold


def train_models(base, system, margs_by_type, dargs_by_fold, device=None):
    """One array task per algorithm x fold. Returns ``{alias: runs
    root}`` in the order of ``margs_by_type``."""
    roots = {}
    for model_type, margs in margs_by_type.items():
        margs_file = os.path.join(base, f"{model_type}_cached_args.txt")
        with open(margs_file, "w") as f:
            json.dump(margs, f)
        alias = ALIASES[model_type]
        save_root = os.path.join(base, "runs", f"{alias}_models")
        os.makedirs(save_root, exist_ok=True)
        roots[alias] = save_root
        for fold, dargs in dargs_by_fold.items():
            t0 = time.time()
            set_up_and_run_experiments(
                {"save_root_path": save_root}, [margs_file], [dargs],
                possible_model_types=[model_type],
                possible_data_sets=[f"data_fold{fold}"], task_id=1,
                device=device)
            print(f"[{system} train] {alias} fold {fold}: "
                  f"{time.time()-t0:.1f}s", flush=True)
    return roots


def score_conditions(base, system, roots, dargs_by_fold, true_by_fold,
                     num_factors, device=None):
    """The dynamic readouts of every algorithm under each of
    :data:`CONDITIONS`, each summary also written under
    ``base/evals/dynamic/<condition>``. Returns ``{condition: summary}``."""
    results = {}
    for cond in CONDITIONS:
        dyn = run_dynamic_readout_evaluation(
            roots=roots, data_args_by_fold=dargs_by_fold,
            true_by_fold=true_by_fold, num_folds=len(dargs_by_fold),
            num_supervised_factors=num_factors,
            save_root=os.path.join(base, "evals", "dynamic", cond["name"]),
            common_window_grid=cond["common_window_grid"],
            label_align=cond["label_align"], device=device)
        results[cond["name"]] = dyn
        r = dyn.get("REDCLIFF_S_CMLP", {})
        print(f"[{system} {cond['name']}] REDCLIFF edge_tracking_r="
              f"{(r.get('edge_tracking_r') or {}).get('mean')} "
              f"dyn_optF1={(r.get('dynamic_optimal_f1') or {}).get('mean')} "
              f"state_r={(r.get('state_score_r') or {}).get('mean')}",
              flush=True)
    return results


def run_system(base, system, folds, smoke, device=None, records=None):
    """Curate, train and score one system. Returns its results by
    condition; ``records`` (a dict) receives its runs roots by alias."""
    num_factors = parse_system(system)[2]
    dargs_by_fold, true_by_fold = curate_system_folds(base, system, folds,
                                                      smoke)
    roots = train_models(base, system, model_args(num_factors, smoke),
                         dargs_by_fold, device=device)
    if records is not None:
        records[system] = roots
    return score_conditions(base, system, roots, dargs_by_fold,
                            true_by_fold, num_factors, device=device)


def aggregate(systems):
    """Per condition, each REDCLIFF metric's mean of the per-system means
    (systems without the metric left out)."""
    agg = {}
    for cond in CONDITIONS:
        per_metric = {}
        for system, res in systems.items():
            r = res[cond["name"]].get("REDCLIFF_S_CMLP", {})
            for metric in METRICS:
                st = r.get(metric)
                if isinstance(st, dict) and st.get("mean") is not None:
                    per_metric.setdefault(metric, []).append(st["mean"])
        agg[cond["name"]] = {
            m: {"mean": float(np.mean(v)), "n_systems": len(v)}
            for m, v in per_metric.items()}
    return agg


def merge_previous(dest, out):
    """``out`` with the systems of the JSON at ``dest`` that it does not
    replace, where that JSON's ``smoke`` flag and fold count match
    (separate ``--systems`` runs build one file; a rerun of a system
    replaces its entry)."""
    if os.path.isfile(dest):
        try:
            with open(dest) as f:
                prev = json.load(f)
            if (prev.get("smoke") == out["smoke"]
                    and prev.get("folds") == out["folds"]):
                merged = dict(prev.get("systems", {}))
                merged.update(out["systems"])
                out["systems"] = merged
        except (OSError, json.JSONDecodeError):
            pass
    return out


def main(argv=None, device=None, records=None):
    """Run the sweep on ``device`` (``cuda`` unless given: raises without
    CUDA). Returns the JSON it writes. ``records``, a dict, receives each
    system's runs roots by alias (``records["roots"][system][alias]``)."""
    args = parse_args(argv)
    device = resolve_device(device)
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    roots = {}
    out = {"folds": args.folds, "smoke": bool(args.smoke),
           "conditions": [c["name"] for c in CONDITIONS], "systems": {}}
    for system in args.systems.split(","):
        base = os.path.join(workdir, system + ("_smoke" if args.smoke
                                               else ""))
        os.makedirs(base, exist_ok=True)
        out["systems"][system] = run_system(base, system, args.folds,
                                            args.smoke, device=device,
                                            records=roots)
    if records is not None:
        records.update(roots=roots)
    dest = os.path.join(workdir, "HIGHBAND_READOUT_SWEEP.json"
                        if not args.smoke
                        else "HIGHBAND_READOUT_SWEEP_smoke.json")
    # runs of other --systems into this work dir may finish at once: the
    # merge and the write hold a lock on the work dir
    fd = os.open(workdir, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        out = merge_previous(dest, out)
        out["redcliff_aggregate_by_condition"] = aggregate(out["systems"])
        with open(dest + ".tmp", "w") as f:
            json.dump(out, f, indent=2)
        os.replace(dest + ".tmp", dest)
    finally:
        os.close(fd)
    print(f"[done] wrote {dest}", flush=True)
    return out


if __name__ == "__main__":
    main()
