"""Port twin of ``experiments/d4ic_grid_search.py``: the D4IC
coefficient-selection study, run by the PyTorch port on the card.

The flow, the command line, the axes and the smoke cuts are the JAX
script's. It searches the gen_lr x ADJ_L1_REG_COEFF x FACTOR_COS_SIM_COEFF
axes of one REDCLIFF-S architecture (``--arch bscgs1``, the transcribed
BSCgs1 config, or ``--arch smooth``, the Smooth gs4 config) with the
port's own grid engine:

1. curate the D4IC-analog HSNR fold 0 (:func:`curate_tier_fold`, the
   curation of ``accuracy_parity_d4ic.py``, recordings from the device
   generator);
2. build the selection setup (:func:`selection_setup`): the cached args
   read and rescaled through the array-task driver's own path, the model,
   the whole fold (``grid_search=False``), the grid's train config and
   the per-point engine axes (:func:`engine_points`: the searched
   coefficients rescaled, the stopping cos-sim mirroring the loss
   coefficient);
3. fit every point at once (:func:`fit_grid`: ``run_coefficient_grid`` ->
   ``RedcliffGridRunner`` -> the epoch engine -> the factor-mix lane
   kernel), all lanes from ONE seeded init;
4. score every point's best model with the off-diagonal optimal-F1
   battery (:func:`score_points`);
5. select by the minimum stopping criteria (:func:`select`) and re-train
   the winner through the array-task driver at each SNR tier x fold
   (:func:`winner_rows`);
6. write the JSON the JAX script writes (its key set) to
   ``<workdir>/D4IC_GRID_SEARCH[_SMOOTH].json`` or, with ``--smoke``,
   ``<workdir>_smoke/D4IC_GRID_SEARCH[_SMOOTH]_smoke.json``. Nothing is
   written beside this file.

The flow's train config sets no ``prox_penalty``, so the GL prox is off
on this path, as in the JAX script. It imports only
``redcliff_tpu_torch`` and runs on ``cuda`` unless ``main(argv,
device=...)`` says otherwise; every stage gets the device.

Run:  python -m redcliff_tpu_torch.experiments.d4ic_grid_search <workdir>
      [--smoke] [--max-iter N] [--folds N] [--arch bscgs1|smooth]
"""
import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from redcliff_tpu_torch import interop
from redcliff_tpu_torch.data.curation import save_cached_args_file_for_data
from redcliff_tpu_torch.data.dream4 import make_d4ic_fold
from redcliff_tpu_torch.eval.cross_alg import evaluate_algorithm_on_fold
from redcliff_tpu_torch.experiments.accuracy_parity_d4ic import (
    NUM_NETWORKS, NUM_NODES, REDCLIFF_ARGS, SMOOTH_ARGS, curate_network)
from redcliff_tpu_torch.train.driver import (
    rescale_dataset_dependent_coefficients, run_coefficient_grid,
    set_up_and_run_experiments)
from redcliff_tpu_torch.train.orchestration import (
    create_model_instance, get_data_for_model_training)
from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig
from redcliff_tpu_torch.utils.config import (
    load_true_gc_factors, read_in_data_args, read_in_model_args)
from redcliff_tpu_torch.utils.precision import resolve_device

# the axes the reference's own d4IC gs points span: BSCgs1 sits at
# (5e-4, 1.0, 1.0); the Smooth gs4 sibling moved ADJ_L1 to 0.1; lr and
# cos-sim bracket the published settings one decade each way
GEN_LR_AXIS = (0.0002, 0.0005, 0.002)
ADJ_L1_AXIS = (1.0, 0.1, 0.01)
COS_SIM_AXIS = (10.0, 1.0, 0.1)
OFFDIAG = "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag"
TIERS = ("HSNR", "MSNR", "LSNR")

# (train, validation) recordings per network and fold
SAMPLES = {False: (120, 30), True: (24, 8)}
# the --smoke cuts of the cached args
SMOKE_CUTS = dict(max_iter="12", num_pretrain_epochs="4",
                  num_acclimation_epochs="4", check_every="2")

# the round-4 un-searched rows the JAX script records beside its result
ROUND4_BASELINE = {
    "smooth": {"HSNR": 0.315, "MSNR": 0.319, "LSNR": 0.211,
               "note": "round-4 ACCURACY_D4IC tables, the un-searched "
                       "Smooth gs4 transcription"},
    "bscgs1": {"HSNR": 0.178, "MSNR": 0.177, "LSNR": 0.178,
               "note": "round-4 ACCURACY_D4IC tables, the un-searched "
                       "BSCgs1 transcription (gen_lr 5e-4, ADJ_L1 1.0, "
                       "COS_SIM 1.0)"},
}


def curate_tier_fold(base, snr, fold, n_train, n_val, device=None):
    """D4IC-analog mixture fold for one SNR tier (accuracy_parity_d4ic's
    curation flow, shared network pool); the recordings are drawn on
    ``device``. Returns the fold's data cached-args path."""
    nets_root = os.path.join(base, "networks")
    graphs = [curate_network(nets_root, n, fold, n_train, n_val,
                             device=device)
              for n in range(NUM_NETWORKS)]
    fold_dir = os.path.join(base, "data", f"d4ic_{snr}", f"fold_{fold}")
    if not os.path.isfile(os.path.join(
            fold_dir, f"data_fold{fold}_cached_args.txt")):
        make_d4ic_fold(nets_root, fold_dir, fold_id=fold,
                       num_factors=NUM_NETWORKS, snr_tier=snr,
                       shuffle_rng=np.random.default_rng(fold))
        save_cached_args_file_for_data(
            fold_dir, NUM_NODES, graphs, f"data_fold{fold}_cached_args.txt")
    return os.path.join(fold_dir, f"data_fold{fold}_cached_args.txt")


def pooled_offdiag(stats_by_fold):
    """Mean +/- SEM over per-factor optF1 values pooled across folds (the
    ACCURACY_D4IC tables' across-factors-then-folds statistic)."""
    vals = []
    aucs = []
    for stats in stats_by_fold:
        s = stats[OFFDIAG]
        vals.extend(s["f1_vals_across_factors"])
        aucs.extend(s.get("roc_auc_vals_across_factors", []))
    vals = np.asarray(vals, dtype=np.float64)
    out = {"offdiag_optimal_f1_mean": float(vals.mean()),
           "offdiag_optimal_f1_sem": float(vals.std(ddof=1)
                                           / np.sqrt(len(vals)))
           if len(vals) > 1 else 0.0}
    if aucs:
        aucs = np.asarray(aucs, dtype=np.float64)
        out["offdiag_roc_auc_mean"] = float(aucs.mean())
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--max-iter", type=int, default=None,
                    help="cap the selection grid's epochs (default: the "
                         "reference max_iter=1000; the all-inactive early "
                         "exit usually stops far earlier)")
    ap.add_argument("--folds", type=int, default=3)
    ap.add_argument("--arch", default="bscgs1", choices=["bscgs1", "smooth"],
                    help="architecture to search: the non-Smooth BSCgs1 "
                         "shape or the Smooth gs4 shape; different shapes "
                         "cannot share one grid, so each runs as its own")
    return ap.parse_args(argv)


def arch_args(arch, smoke):
    """``(model_type, cached args)`` of an architecture, with the smoke
    cuts applied under ``--smoke``."""
    model_type = ("REDCLIFF_S_CMLP_Smooth" if arch == "smooth"
                  else "REDCLIFF_S_CMLP")
    margs = dict(SMOOTH_ARGS if arch == "smooth" else REDCLIFF_ARGS)
    if smoke:
        margs.update(SMOKE_CUTS)
    return model_type, margs


def search_axes(smoke):
    """``(gen_lr, ADJ_L1, COS_SIM)`` axes searched: all 27 points, or the
    2 x 2 x 1 smoke grid."""
    if not smoke:
        return GEN_LR_AXIS, ADJ_L1_AXIS, COS_SIM_AXIS
    return GEN_LR_AXIS[:2], ADJ_L1_AXIS[:2], COS_SIM_AXIS[1:2]


def raw_points(gen_axis, adj_axis, cos_axis):
    """The grid's points in raw coefficients, lane order lr x adj x cos."""
    return [{"gen_lr": lr, "ADJ_L1_REG_COEFF": adj,
             "FACTOR_COS_SIM_COEFF": cs}
            for lr in gen_axis for adj in adj_axis for cs in cos_axis]


def engine_points(points_raw, num_factors, num_channels):
    """Per-point engine axes: the searched coefficients rescaled by the
    driver's own helper, the stopping cos-sim coefficient mirroring the
    loss coefficient per point, as the reference driver overwrites it."""
    def rescaled(key, raw):
        d = {"coeff_dict": {key: raw}, "num_factors": num_factors,
             "num_channels": num_channels}
        rescale_dataset_dependent_coefficients(d)
        return d["coeff_dict"][key]

    out = []
    for pt in points_raw:
        cs = rescaled("FACTOR_COS_SIM_COEFF", pt["FACTOR_COS_SIM_COEFF"])
        out.append({
            "gen_lr": pt["gen_lr"],
            "adj_l1_reg_coeff": rescaled("ADJ_L1_REG_COEFF",
                                         pt["ADJ_L1_REG_COEFF"]),
            "factor_cos_sim_coeff": cs,
            "stopping_criteria_cosSim_coeff": cs,
        })
    return out


def selection_setup(base, model_type, margs, dargs_file, arch_tag="",
                    device=None, fold=0):
    """The grid's base setup on the selection fold (``data_fold<fold>``),
    through the driver's own read/rescale path, so the base config
    matches what a per-job run builds. Returns ``(args_dict, model,
    train_ds, val_ds, train config)``."""
    margs_file = os.path.join(base, f"{model_type}_gs_cached_args.txt")
    with open(margs_file, "w") as f:
        json.dump(margs, f)
    args_dict = {"save_root_path": os.path.join(base, f"runs_grid{arch_tag}"),
                 "model_type": model_type,
                 "model_cached_args_file": margs_file,
                 "data_set_name": f"data_fold{fold}",
                 "data_cached_args_file": dargs_file}
    read_in_model_args(args_dict)
    read_in_data_args(args_dict)
    rescale_dataset_dependent_coefficients(args_dict)
    model = create_model_instance(
        args_dict, employ_version_with_smoothing_loss="Smooth" in model_type)
    # grid_search=False: the winner re-runs train through the driver on the
    # full fold, so selection must see the same data (the default keeps
    # only a quarter, the reference's cheap-search subsampling)
    train_ds, val_ds = get_data_for_model_training(
        args_dict, grid_search=False, device=device)
    tc = RedcliffTrainConfig(
        embed_lr=args_dict["embed_lr"], embed_eps=args_dict["embed_eps"],
        embed_weight_decay=args_dict["embed_weight_decay"],
        gen_lr=args_dict["gen_lr"], gen_eps=args_dict["gen_eps"],
        gen_weight_decay=args_dict["gen_weight_decay"],
        max_iter=args_dict["max_iter"], lookback=args_dict["lookback"],
        check_every=args_dict["check_every"],
        batch_size=args_dict["batch_size"],
        stopping_criteria_forecast_coeff=args_dict[
            "stopping_criteria_forecast_coeff"],
        stopping_criteria_factor_coeff=args_dict[
            "stopping_criteria_factor_coeff"],
        stopping_criteria_cosSim_coeff=args_dict[
            "stopping_criteria_cosSim_coeff"])
    return args_dict, model, train_ds, val_ds, tc


def fit_grid(model, tc, grid_points, train_ds, val_ds, max_iter=None,
             init_point_params=None, device=None):
    """Every point at once through ``run_coefficient_grid`` on ``device``,
    all lanes from one init (the model's seeded ``init`` unless given).
    Returns ``(GridResult, wall s)``."""
    if init_point_params is None:
        init_point_params = model.init(torch.Generator().manual_seed(0))
    t0 = time.time()
    res = run_coefficient_grid(model, tc, grid_points, train_ds, val_ds,
                               key=0, max_iter=max_iter,
                               init_point_params=init_point_params,
                               device=device)
    return res, time.time() - t0


def write_point(base, arch_tag, model, res, i):
    """Point ``i``'s best params as the headerless pickle
    ``runs_grid<tag>/grid_point<i>/final_best_model.bin``. Returns the
    run dir."""
    run_dir = os.path.join(base, f"runs_grid{arch_tag}", f"grid_point{i}")
    os.makedirs(run_dir, exist_ok=True)
    pt_params = interop.tree_map(lambda x: np.asarray(x)[i], res.best_params)
    with open(os.path.join(run_dir, "final_best_model.bin"), "wb") as f:
        pickle.dump({"model_class": "RedcliffSCMLP",
                     "config": model.config, "params": pt_params}, f)
    return run_dir


def score_points(base, arch_tag, model, res, points_raw, grid_points,
                 true_gcs, device=None):
    """Each point's best params written by :func:`write_point`, scored
    with the off-diagonal optimal-F1 battery on ``device``. Returns the
    per-point records of the JSON."""
    criteria = np.asarray(res.best_criteria, dtype=np.float64)
    per_point = []
    for i, (raw, gp) in enumerate(zip(points_raw, grid_points)):
        run_dir = write_point(base, arch_tag, model, res, i)
        stats = evaluate_algorithm_on_fold(run_dir, "REDCLIFF_S_CMLP",
                                           true_gcs, device=device)
        s = stats[OFFDIAG]
        per_point.append({
            "raw": raw, "engine_point": gp,
            "best_criteria": float(criteria[i]),
            "best_epoch": int(res.best_epoch[i]),
            "optf1_fold0": s["f1_mean_across_factors"],
            "optf1_fold0_sem": s["f1_mean_std_err_across_factors"],
        })
        print(f"[score] {raw}: criteria={criteria[i]:.4f} "
              f"optF1={s['f1_mean_across_factors']:.3f}", flush=True)
    return per_point


def select(per_point):
    """``(criteria winner, oracle)``: the argmin of the stopping criteria,
    the argmax of the fold-0 optimal F1."""
    sel = int(np.argmin([p["best_criteria"] for p in per_point]))
    oracle = int(np.argmax([p["optf1_fold0"] for p in per_point]))
    return sel, oracle


def winner_rows(base, model_type, margs, winner_raw, tiers, folds, n_train,
                n_val, arch_tag="", device=None):
    """The winner config re-trained through the array-task driver at each
    tier x fold and scored. Returns ``({tier: pooled row}, [run dirs])``."""
    wm = dict(margs,
              gen_lr=repr(winner_raw["gen_lr"]),
              ADJ_L1_REG_COEFF=repr(winner_raw["ADJ_L1_REG_COEFF"]),
              FACTOR_COS_SIM_COEFF=repr(winner_raw["FACTOR_COS_SIM_COEFF"]))
    wm_file = os.path.join(base, f"{model_type}_winner_cached_args.txt")
    with open(wm_file, "w") as f:
        json.dump(wm, f)

    # winner-config-encoded save root: run_folder_name encodes only
    # RESCALED coefficients (and not gen_lr at all, the reference layout's
    # limitation), so a re-invocation selecting a different winner must
    # land in its own tree rather than resume this one's
    wtag = "_".join(f"{k[:3]}{v}" for k, v in sorted(
        winner_raw.items())).replace(".", "-")
    rows, run_dirs = {}, []
    for snr in tiers:
        stats_by_fold = []
        for fold in range(folds):
            dargs = curate_tier_fold(base, snr, fold, n_train, n_val,
                                     device=device)
            save_root = os.path.join(base,
                                     f"runs_winner{arch_tag}_{snr}_{wtag}")
            os.makedirs(save_root, exist_ok=True)
            t0 = time.time()
            set_up_and_run_experiments(
                {"save_root_path": save_root}, [wm_file], [dargs],
                possible_model_types=[model_type],
                possible_data_sets=[f"data_fold{fold}"], task_id=1,
                device=device)
            print(f"[winner] {snr} fold {fold}: {time.time()-t0:.1f}s",
                  flush=True)
            matches = [os.path.join(save_root, d)
                       for d in sorted(os.listdir(save_root))
                       if f"data_fold{fold}" in d]
            assert len(matches) == 1, (save_root, fold, matches)
            run_dirs.append(matches[0])
            stats_by_fold.append(evaluate_algorithm_on_fold(
                matches[0], "REDCLIFF_S_CMLP", load_true_gc_factors(dargs),
                device=device))
        rows[snr] = pooled_offdiag(stats_by_fold)
        print(f"[winner] {snr}: optF1 "
              f"{rows[snr]['offdiag_optimal_f1_mean']:.3f} ± "
              f"{rows[snr]['offdiag_optimal_f1_sem']:.3f}", flush=True)
    return rows, run_dirs


def main(argv=None, device=None, records=None):
    """Run the study on ``device`` (``cuda`` unless given: raises without
    CUDA). Returns the JSON it writes. ``records``, a dict, receives the
    grid's ``GridResult`` (``"grid"``), the selection fold's datasets
    (``"train_ds"``, ``"val_ds"``) and the winner's run dirs
    (``"winner_runs"``), for a caller that checks the run."""
    args = parse_args(argv)
    device = resolve_device(device)
    # curation is fully seeded and architecture-independent: share the
    # workdir across archs and isolate only the run roots / args files
    base = os.path.abspath(args.workdir) + ("_smoke" if args.smoke else "")
    os.makedirs(base, exist_ok=True)
    arch_tag = "_smooth" if args.arch == "smooth" else ""
    n_train, n_val = SAMPLES[bool(args.smoke)]
    model_type, margs = arch_args(args.arch, args.smoke)
    gen_axis, adj_axis, cos_axis = search_axes(args.smoke)
    points_raw = raw_points(gen_axis, adj_axis, cos_axis)

    # ------------------------------------------------- selection data (fold 0)
    t0 = time.time()
    dargs_file = curate_tier_fold(base, "HSNR", 0, n_train, n_val,
                                  device=device)
    true_gcs = load_true_gc_factors(dargs_file)
    print(f"[curate] HSNR fold 0: {time.time()-t0:.1f}s", flush=True)
    args_dict, model, train_ds, val_ds, tc = selection_setup(
        base, model_type, margs, dargs_file, arch_tag, device=device)
    grid_points = engine_points(points_raw, args_dict["num_factors"],
                                args_dict["num_channels"])

    G = len(grid_points)
    print(f"[grid] training {G} points at once "
          f"(axes {len(gen_axis)}x{len(adj_axis)}x{len(cos_axis)})",
          flush=True)
    res, grid_wall = fit_grid(model, tc, grid_points, train_ds, val_ds,
                              max_iter=args.max_iter, device=device)
    print(f"[grid] done in {grid_wall:.0f}s "
          f"({res.val_history.shape[0]} epochs run)", flush=True)

    # --------------------------------------- score EVERY point on fold 0
    per_point = score_points(base, arch_tag, model, res, points_raw,
                             grid_points, true_gcs, device=device)
    sel, oracle = select(per_point)
    print(f"[select] criteria winner: {points_raw[sel]} "
          f"(optF1 {per_point[sel]['optf1_fold0']:.3f}); "
          f"oracle best: {points_raw[oracle]} "
          f"(optF1 {per_point[oracle]['optf1_fold0']:.3f})", flush=True)

    # ------------------------- winner re-run: real driver, 3 tiers x N folds
    winner_raw = points_raw[sel]
    tiers = TIERS if not args.smoke else ("HSNR",)
    rows, run_dirs = winner_rows(base, model_type, margs, winner_raw, tiers,
                                 args.folds, n_train, n_val, arch_tag,
                                 device=device)
    if records is not None:
        records.update(grid=res, train_ds=train_ds, val_ds=val_ds,
                       winner_runs=run_dirs)

    out = {
        "dataset": "synthetic-source D4IC analog (accuracy_parity_d4ic "
                   "curation), selection on HSNR fold 0",
        "architecture": args.arch,
        "smoke": bool(args.smoke),
        "axes_raw": {"gen_lr": list(gen_axis),
                     "ADJ_L1_REG_COEFF": list(adj_axis),
                     "FACTOR_COS_SIM_COEFF": list(cos_axis)},
        "grid_size": G,
        "grid_wall_clock_s": round(grid_wall, 1),
        "grid_epochs_run": int(res.val_history.shape[0]),
        "per_point": per_point,
        "selected_by_criteria": winner_raw,
        "selected_optf1_fold0": per_point[sel]["optf1_fold0"],
        "oracle_point": points_raw[oracle],
        "oracle_optf1_fold0": per_point[oracle]["optf1_fold0"],
        "transcribed_round4_baseline": ROUND4_BASELINE[args.arch],
        "winner_rows": rows,
    }
    tag = "_SMOOTH" if args.arch == "smooth" else ""
    dest = os.path.join(base, f"D4IC_GRID_SEARCH{tag}.json"
                        if not args.smoke
                        else f"D4IC_GRID_SEARCH{tag}_smoke.json")
    with open(dest, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[done] wrote {dest}", flush=True)
    return out


if __name__ == "__main__":
    main()
