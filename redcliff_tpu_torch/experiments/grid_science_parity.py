"""Port twin of ``experiments/grid_science_parity.py``: the grid engine
reaches the same science as the one-process-per-point array-task pattern,
run by the PyTorch port on the card.

The flow, the command line, the axes and the smoke cuts are the JAX
script's. For each fold of a synSys system:

1. curate (or reuse) the fold (``data/curation.py``
   ``curate_synthetic_fold``, host numpy: the JAX package's fold bit for
   bit);
2. per-point leg: train the REDCLIFF-S reference config at each point of
   the gen_lr x ADJ_L1_REG_COEFF grid through the array-task driver, one
   save root a point; a point whose root holds a completed run is not
   trained again (:func:`_completed_run_dirs`), and the leg's wall is the
   first trained one;
3. grid leg: every point at once through ``run_coefficient_grid`` on the
   whole fold (the grid-search twin's ``selection_setup`` and
   ``fit_grid``), all lanes from ``model.init(torch.Generator()
   .manual_seed(0))``, the weights each array task starts from (the
   driver seeds its generator with 0, as the reference's array tasks fix
   every seed);
4. select the best point both ways; score every point's model from both
   legs with the off-diagonal optimal-F1 battery; the rank correlation of
   the two legs' orderings and the winner's F1 delta.

It writes the JSON the JAX script writes (its key set) to
``<base>/GRID_SCIENCE_PARITY[_<system>][_smoke].json``, ``base`` being
``<workdir>_<system>[_smoke]``. A re-invocation whose per-point leg
resumed carries the trained wall forward from an earlier JSON at that
path. Nothing is written beside this file.

The cached args set no ``prox_penalty``, so the GL prox is off on this
path, as in the JAX script. It imports only ``redcliff_tpu_torch`` and
runs on ``cuda`` unless ``main(argv, device=...)`` says otherwise.

Run:  python -m redcliff_tpu_torch.experiments.grid_science_parity
      <workdir> [--smoke] [--folds N] [--system N-E-F]
"""
import argparse
import json
import os
import time

import numpy as np

from redcliff_tpu_torch.data.curation import curate_synthetic_fold
from redcliff_tpu_torch.eval.cross_alg import evaluate_algorithm_on_fold
from redcliff_tpu_torch.eval.edge_dynamics import vector_spearman
from redcliff_tpu_torch.eval.grid_selection import select_best_models
from redcliff_tpu_torch.experiments.accuracy_parity_synsys import (
    REDCLIFF_ARGS)
from redcliff_tpu_torch.experiments.d4ic_grid_search import (
    SMOKE_CUTS, fit_grid, selection_setup, write_point)
from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint
from redcliff_tpu_torch.train.driver import (
    rescale_dataset_dependent_coefficients, set_up_and_run_experiments)
from redcliff_tpu_torch.utils.config import load_true_gc_factors
from redcliff_tpu_torch.utils.precision import resolve_device

# the reference synSys gs drivers' axes include gen_lr and ADJ_L1_REG_COEFF
# (ref train/...tst100hzRerun1024AvgReg_gsSmooth1.py:103,108 and the synSys
# cached-args' values); 2x2 around the published setting
GEN_LR_AXIS = (0.0005, 0.002)
ADJ_L1_AXIS = (0.1, 0.01)
OFFDIAG = "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag"
MODEL_TYPE = "REDCLIFF_S_CMLP"
META = "training_meta_data_and_hyper_parameters.pkl"

# (train, validation) recordings of a fold
SAMPLES = {False: (1040, 240), True: (240, 96)}


def _grid_points():
    return [{"gen_lr": lr, "ADJ_L1_REG_COEFF": adj}
            for lr in GEN_LR_AXIS for adj in ADJ_L1_AXIS]


def spearman(a, b):
    """Spearman rank correlation of two score vectors (the tie-averaged
    ``vector_spearman``, one lane); 0.0 where a vector is constant (zero
    rank variance leaves rho undefined)."""
    rho, _ = vector_spearman(np.asarray(a).reshape(-1, 1),
                             np.asarray(b).reshape(-1, 1))
    return float(rho[0]) if np.isfinite(rho[0]) else 0.0


def _completed_run_dirs(save_root, min_epochs, expected_iters, lookback,
                        check_every):
    """Run dirs under save_root whose recorded schedule marks a COMPLETED
    training for this config: past pretrain+acclimation, and either trained
    to max_iter or stopped by the patience rule (epoch - best_it >=
    lookback*check_every). A mid-training interruption passes neither."""
    done = []
    for d in sorted(os.listdir(save_root)):
        meta_p = os.path.join(save_root, d, META)
        if not os.path.isfile(meta_p):
            continue
        meta = read_checkpoint(meta_p)
        epoch = meta.get("epoch", -1)
        best_it = meta.get("best_it", None)
        if not (min_epochs < epoch + 1 <= expected_iters):
            continue
        finished = (epoch + 1 == expected_iters
                    or (best_it is not None
                        and epoch - best_it >= lookback * check_every))
        if finished:
            done.append(d)
    return done


def curate_fold(base, fold, smoke, system):
    """The fold of ``system`` ("nodes-edges-factors"), curated once.
    Returns its data cached-args path."""
    num_nodes, num_edges, num_factors = (int(v) for v in system.split("-"))
    n_train, n_val = SAMPLES[bool(smoke)]
    fold_dir, _ = curate_synthetic_fold(
        os.path.join(base, "data"), fold_id=fold, num_nodes=num_nodes,
        num_lags=2, num_factors=num_factors,
        num_supervised_factors=num_factors, num_edges_per_graph=num_edges,
        num_samples_in_train_set=n_train, num_samples_in_val_set=n_val,
        sample_recording_len=100, burnin_period=50,
        label_type_setting="OneHot", noise_type="gaussian", noise_level=1.0,
        folder_name=f"synSys{num_nodes}_{num_edges}_{num_factors}")
    return os.path.join(fold_dir, f"data_fold{fold}_cached_args.txt")


def per_point_leg(base, fold, base_margs, dargs_file, device=None):
    """One array task a point, each in its own save root, skipped where a
    completed run is there. Returns ``(records, wall s of the trained
    tasks, points trained)``."""
    pp_root = os.path.join(base, f"runs_per_point_f{fold}")
    pp_results = []
    pp_wall = 0.0
    pp_trained = 0
    expected_iters = int(base_margs["max_iter"])
    min_epochs = (int(base_margs["num_pretrain_epochs"])
                  + int(base_margs["num_acclimation_epochs"]))
    lookback = int(base_margs["lookback"])
    check_every = int(base_margs["check_every"])
    for i, pt in enumerate(_grid_points()):
        margs = dict(base_margs)
        margs["gen_lr"] = repr(pt["gen_lr"])
        margs["ADJ_L1_REG_COEFF"] = repr(pt["ADJ_L1_REG_COEFF"])
        margs_file = os.path.join(
            base, f"{MODEL_TYPE}_point{i}_cached_args.txt")
        with open(margs_file, "w") as f:
            json.dump(margs, f)
        # the run-folder name does not encode gen_lr (ref :19-30), so each
        # point gets its own save root to avoid collisions across lr values
        save_root = os.path.join(pp_root, f"point{i}")
        os.makedirs(save_root, exist_ok=True)
        t0 = time.time()
        done = _completed_run_dirs(save_root, min_epochs, expected_iters,
                                   lookback, check_every)
        resumed = bool(done)
        if not done:
            set_up_and_run_experiments(
                {"save_root_path": save_root}, [margs_file], [dargs_file],
                possible_model_types=[MODEL_TYPE],
                possible_data_sets=[f"data_fold{fold}"], task_id=1,
                device=device)
            pp_trained += 1
            pp_wall += time.time() - t0
            done = _completed_run_dirs(save_root, min_epochs, expected_iters,
                                       lookback, check_every)
            assert done, f"training left no completed run in {save_root}"
        run_dir = os.path.join(save_root, done[0])
        meta = read_checkpoint(os.path.join(run_dir, META))
        pp_results.append({"point": pt, "run_dir": run_dir,
                           "best_loss": meta["best_loss"],
                           "best_it": meta["best_it"],
                           "resumed": resumed,
                           "train_s": round(time.time() - t0, 1)})
        print(f"[f{fold} per-point] {pt}: best_loss={meta['best_loss']:.5f} "
              f"best_it={meta['best_it']} resumed={resumed}", flush=True)
    return pp_results, pp_wall, pp_trained


def rescaled_adj(raw, num_factors, num_channels):
    """ADJ_L1_REG_COEFF as the driver rescales it for this dataset."""
    d = {"coeff_dict": {"ADJ_L1_REG_COEFF": raw},
         "num_factors": num_factors, "num_channels": num_channels}
    rescale_dataset_dependent_coefficients(d)
    return d["coeff_dict"]["ADJ_L1_REG_COEFF"]


def _offdiag_stats(stats):
    s = stats[OFFDIAG]
    return {"optimal_f1": s["f1_mean_across_factors"],
            "optimal_f1_sem": s["f1_mean_std_err_across_factors"],
            "roc_auc": s.get("roc_auc_mean_across_factors")}


def run_fold(base, fold, base_margs, smoke, system, device=None,
             records=None):
    """Both legs on one fold, selected and scored. Returns the fold's
    record of the JSON; ``records`` (a list) receives the grid's
    ``GridResult``, its datasets and both legs' run dirs."""
    dargs_file = curate_fold(base, fold, smoke, system)
    true_gcs = load_true_gc_factors(dargs_file)
    points = _grid_points()

    # -------------------------------------------------- per-point (SLURM) leg
    pp_results, pp_wall, pp_trained = per_point_leg(
        base, fold, base_margs, dargs_file, device=device)

    # flat artifact tree (the eval_gs layout) for grid-selection ranking
    flat = os.path.join(base, f"runs_flat_f{fold}")
    os.makedirs(flat, exist_ok=True)
    for i, r in enumerate(pp_results):
        link = os.path.join(flat,
                            f"point{i}_" + os.path.basename(r["run_dir"]))
        if not os.path.exists(link):
            os.symlink(r["run_dir"], link)
    gs_rankings = select_best_models(flat)

    # ------------------------------------------------------------- grid leg
    # grid_search=False inside: both legs train on the full fold
    args_dict, model, train_ds, val_ds, tc = selection_setup(
        base, MODEL_TYPE, base_margs, dargs_file, arch_tag=f"_f{fold}",
        device=device, fold=fold)
    grid_points = [{"gen_lr": pt["gen_lr"],
                    "adj_l1_reg_coeff": rescaled_adj(
                        pt["ADJ_L1_REG_COEFF"], args_dict["num_factors"],
                        args_dict["num_channels"])}
                   for pt in points]
    # fit_grid's default init is the array task's: model.init of a
    # generator seeded with 0, one tree for every lane
    res, grid_wall = fit_grid(model, tc, grid_points, train_ds, val_ds,
                              device=device)
    grid_criteria = np.asarray(res.best_criteria, dtype=np.float64)

    # ------------------------------------------------------------ selection
    pp_losses = [r["best_loss"] for r in pp_results]
    pp_best = int(np.argmin(pp_losses))
    grid_best = int(np.argmin(grid_criteria))
    rank_corr = spearman(np.asarray(pp_losses), grid_criteria)

    # ----------------------------------------------- per-config science table
    per_config, grid_runs = [], []
    for i, pt in enumerate(points):
        pp_stats = _offdiag_stats(evaluate_algorithm_on_fold(
            pp_results[i]["run_dir"], MODEL_TYPE, true_gcs, device=device))
        grid_runs.append(write_point(base, f"_f{fold}", model, res, i))
        grid_stats = _offdiag_stats(evaluate_algorithm_on_fold(
            grid_runs[-1], MODEL_TYPE, true_gcs, device=device))
        per_config.append({
            "point": pt,
            "per_point_driver": pp_stats,
            "grid_engine": grid_stats,
            "optf1_delta": grid_stats["optimal_f1"] - pp_stats["optimal_f1"],
        })
        print(f"[f{fold} science] {pt}: driver optF1 "
              f"{pp_stats['optimal_f1']:.3f}±{pp_stats['optimal_f1_sem']:.3f}"
              f" vs grid {grid_stats['optimal_f1']:.3f}±"
              f"{grid_stats['optimal_f1_sem']:.3f}", flush=True)
    if records is not None:
        records.append({"grid": res, "train_ds": train_ds, "val_ds": val_ds,
                        "per_point_runs": [r["run_dir"] for r in pp_results],
                        "grid_runs": grid_runs})

    winner_delta = (per_config[grid_best]["grid_engine"]["optimal_f1"]
                    - per_config[pp_best]["per_point_driver"]["optimal_f1"])
    # the wall-clock comparison is only a measurement when EVERY point
    # trained in this invocation; a partially-resumed leg would understate
    # the per-point cost by the number of resumed points
    pp_all_trained = pp_trained == len(points)
    print(f"[f{fold} done] same_winner={pp_best == grid_best} "
          f"rank_corr={rank_corr:.3f} winner_optf1_delta={winner_delta:.3f} "
          f"wall: pp {pp_wall:.0f}s ({pp_trained}/{len(points)} trained) "
          f"grid {grid_wall:.0f}s", flush=True)

    return {
        "fold": fold,
        "per_point": [{k: v for k, v in r.items() if k != "run_dir"}
                      for r in pp_results],
        "grid": [{"point": pt, "best_criteria": float(c),
                  "best_epoch": int(e)}
                 for pt, c, e in zip(points, grid_criteria, res.best_epoch)],
        "selected_point_per_point_driver": points[pp_best],
        "selected_point_grid_engine": points[grid_best],
        "same_winner": bool(pp_best == grid_best),
        "spearman_rank_correlation": rank_corr,
        "winner_science_delta_optf1": winner_delta,
        "per_config_science": per_config,
        "winner_stats_per_point_driver":
            per_config[pp_best]["per_point_driver"],
        "winner_stats_grid_engine": per_config[grid_best]["grid_engine"],
        "grid_selection_rankings": {
            crit: {"best_run": v["best_run"],
                   "ranking": [[n, float(x), int(e)]
                               for n, x, e in v["ranking"]]}
            for crit, v in gs_rankings.items()},
        "wall_clock_s": {
            "per_point_total": round(pp_wall, 1),
            "per_point_trained": pp_all_trained,
            "points_trained": pp_trained,
            "grid_total": round(grid_wall, 1)},
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--folds", type=int, default=3)
    ap.add_argument("--system", default="6-2-2")
    return ap.parse_args(argv)


def base_model_args(system, smoke):
    """The synSys REDCLIFF-S cached args for ``system``'s factor count,
    with the smoke cuts applied under ``--smoke``."""
    base_margs = dict(REDCLIFF_ARGS)
    nf = int(system.split("-")[2])
    if nf != 2:
        base_margs.update(num_factors=str(nf), num_supervised_factors=str(nf))
    if smoke:
        base_margs.update(SMOKE_CUTS)
    return base_margs


def carry_walls_forward(folds, dest, system):
    """A fold whose per-point leg resumed takes the trained wall of the
    same fold from an earlier JSON of the same system at ``dest``."""
    prev = None
    if os.path.isfile(dest):
        try:
            with open(dest) as f:
                prev = json.load(f)
        except (OSError, json.JSONDecodeError):
            prev = None
    prev_same_system = (prev is not None
                        and prev.get("system", "").startswith(system))
    for fr in folds:
        if not fr["wall_clock_s"]["per_point_trained"] and prev_same_system:
            for pfr in prev.get("folds", []):
                if (pfr.get("fold") == fr["fold"]
                        and pfr.get("wall_clock_s", {}).get(
                            "per_point_trained")):
                    fr["wall_clock_s"]["per_point_total"] = \
                        pfr["wall_clock_s"]["per_point_total"]
                    fr["wall_clock_s"]["per_point_trained"] = True
                    fr["wall_clock_s"]["carried_forward"] = True


def main(argv=None, device=None, records=None):
    """Run the check on ``device`` (``cuda`` unless given: raises without
    CUDA). Returns the JSON it writes. ``records``, a list, receives one
    dict a fold (:func:`run_fold`), for a caller that checks the run."""
    args = parse_args(argv)
    device = resolve_device(device)
    # smoke/full runs and different systems use disjoint workdirs: run-dir
    # names encode neither max_iter, sample counts, nor the system, so
    # sharing one tree would let the per-point resume guard reuse stale
    # artifacts (smoke inside full, or one system's models for another's)
    base = (os.path.abspath(args.workdir) + f"_{args.system}"
            + ("_smoke" if args.smoke else ""))
    os.makedirs(base, exist_ok=True)
    base_margs = base_model_args(args.system, args.smoke)

    folds = [run_fold(base, f, base_margs, args.smoke, args.system,
                      device=device, records=records)
             for f in range(args.folds)]

    corr = [f["spearman_rank_correlation"] for f in folds]
    deltas = [f["winner_science_delta_optf1"] for f in folds]
    # the default system keeps the canonical artifact name; other systems
    # get their own file so runs cannot overwrite each other
    tag = "" if args.system == "6-2-2" else "_" + args.system.replace("-", "_")
    dest = os.path.join(base, f"GRID_SCIENCE_PARITY{tag}.json"
                        if not args.smoke
                        else f"GRID_SCIENCE_PARITY{tag}_smoke.json")
    # preserve trained wall-clock across re-invocations: a resumed leg would
    # otherwise overwrite the measurement with the no-op resume scan time
    carry_walls_forward(folds, dest, args.system)

    out = {
        "system": f"{args.system} (reference synSys config)",
        "axes": {"gen_lr": list(GEN_LR_AXIS),
                 "ADJ_L1_REG_COEFF": list(ADJ_L1_AXIS)},
        "smoke": bool(args.smoke),
        "num_folds": args.folds,
        "folds": folds,
        "same_winner_by_fold": [f["same_winner"] for f in folds],
        "spearman_rank_correlation_by_fold": corr,
        "spearman_rank_correlation_mean": float(np.mean(corr)),
        "winner_science_delta_optf1_by_fold": deltas,
        "winner_science_delta_optf1_mean": float(np.mean(deltas)),
        "wall_clock_s_by_fold": [f["wall_clock_s"] for f in folds],
    }
    with open(dest, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[done] folds={args.folds} "
          f"same_winner={out['same_winner_by_fold']} "
          f"rank_corr={['%.3f' % c for c in corr]} "
          f"winner_delta={['%.3f' % d for d in deltas]}; wrote {dest}",
          flush=True)
    return out


if __name__ == "__main__":
    main()
