"""Experiment drivers (port of ``train/driver.py``): the array-task
driver of the reference's train-script template and the coefficient-grid
entry.

* :func:`set_up_and_run_experiments` — the array-task entry point: one
  (model type, dataset) from the shuffled cartesian product, picked by a
  1-based task id (or ``SLURM_ARRAY_TASK_ID``), its cached-args files
  read, the coefficients rescaled, and
  :func:`kick_off_model_training_experiment` run: the hyperparameter-named
  run folder (auto-resume when ``final_best_model.bin`` is there, a stale
  folder cleaned out), the fold's datasets, the model and its fit
  (``train/orchestration.py``: REDCLIFF-S with cMLP or cLSTM factors,
  cMLP, cLSTM, NAVAR, DGCNN, DCSFA-NMF on the device, DYNOTEARS on the
  host).
* :func:`run_coefficient_grid` — train G coefficient/optimizer variations
  of one REDCLIFF-S model at once through
  :class:`~redcliff_tpu_torch.parallel.grid.RedcliffGridRunner`, replacing
  one process per grid point; writes ``failures.json`` for quarantined
  points.
* :func:`rescale_dataset_dependent_coefficients` and
  :func:`run_folder_name` — copies of the JAX package's helpers.

Both entry points take ``device=`` (``cuda`` unless given), which the JAX
signatures lack.
"""
from __future__ import annotations

import json
import os
import random
from itertools import product

import numpy as np

__all__ = ["run_folder_name", "rescale_dataset_dependent_coefficients",
           "kick_off_model_training_experiment",
           "set_up_and_run_experiments", "run_coefficient_grid"]


def run_folder_name(args_dict):
    """Hyperparameter-encoded run folder; the eval layer locates runs by
    dataset/fold substrings of this name."""
    cd = args_dict.get("coeff_dict", {})

    def fmt(v, clip=None):
        s = str(v).replace(".", "-")
        return s[:clip] if clip else s

    parts = [str(args_dict["model_type"]), str(args_dict["data_set_name"])]
    if "FORECAST_COEFF" in cd:
        parts.append("fc" + fmt(cd["FORECAST_COEFF"]))
    if "FACTOR_SCORE_COEFF" in cd:
        parts.append("fsc" + fmt(cd["FACTOR_SCORE_COEFF"]))
    if "FACTOR_COS_SIM_COEFF" in cd:
        parts.append("fcsc" + fmt(cd["FACTOR_COS_SIM_COEFF"], 8))
    if "FACTOR_WEIGHT_L1_COEFF" in cd:
        parts.append("fwl1c" + fmt(cd["FACTOR_WEIGHT_L1_COEFF"]))
    if "ADJ_L1_REG_COEFF" in cd:
        parts.append("al1c" + fmt(cd["ADJ_L1_REG_COEFF"], 8))
    return "_".join(parts)


def rescale_dataset_dependent_coefficients(args_dict):
    """The per-driver coefficient normalization: FACTOR_COS_SIM_COEFF is
    divided by the number of factor pairs' triangular sum, ADJ_L1_REG_COEFF
    by K*sqrt(C^2 - 1), and the stopping-criteria coefficients mirror the
    loss coefficients."""
    cd = args_dict["coeff_dict"]
    K = args_dict["num_factors"]
    C = args_dict["num_channels"]
    if "FACTOR_COS_SIM_COEFF" in cd and K > 1:
        cd["FACTOR_COS_SIM_COEFF"] = (
            cd["FACTOR_COS_SIM_COEFF"] / sum(1.0 * i for i in range(1, K)))
    if "ADJ_L1_REG_COEFF" in cd:
        cd["ADJ_L1_REG_COEFF"] = (
            cd["ADJ_L1_REG_COEFF"] * (1.0 / K)
            * (1.0 / np.sqrt(C ** 2.0 - 1.0)))
    args_dict["stopping_criteria_forecast_coeff"] = cd.get(
        "FORECAST_COEFF", 1.0)
    args_dict["stopping_criteria_factor_coeff"] = cd.get(
        "FACTOR_SCORE_COEFF", 1.0)
    args_dict["stopping_criteria_cosSim_coeff"] = cd.get(
        "FACTOR_COS_SIM_COEFF", 1.0)
    return args_dict


def kick_off_model_training_experiment(args_dict, grid_search=False, seed=0,
                                       device=None):
    """One training run end to end: the run folder (a folder without
    ``final_best_model.bin`` is stale and cleaned out; one with it resumes
    through the trainer's checkpoint), the fold, the model, the fit on
    ``device``. Returns ``(model, params, fit result)``."""
    from redcliff_tpu_torch.train.orchestration import (
        call_model_fit_method, create_model_instance,
        get_data_for_model_training)

    save_dir = os.path.join(args_dict["save_root_path"],
                            run_folder_name(args_dict))
    args_dict["save_path"] = save_dir
    os.makedirs(save_dir, exist_ok=True)
    if "final_best_model.bin" not in os.listdir(save_dir):
        for f in os.listdir(save_dir):
            path = os.path.join(save_dir, f)
            if os.path.isfile(path):
                os.remove(path)

    train_ds, val_ds = get_data_for_model_training(
        args_dict, grid_search=grid_search, device=device)
    model = create_model_instance(
        args_dict,
        employ_version_with_smoothing_loss="Smooth" in
        args_dict["model_type"] or "WithSmoothing" in args_dict["model_type"])
    params, result = call_model_fit_method(
        model, args_dict, train_ds, val_ds, save_dir=save_dir, seed=seed,
        device=device)
    return model, params, result


def set_up_and_run_experiments(args_dict, files_of_cached_model_args,
                               files_of_cached_data_args,
                               possible_model_types, possible_data_sets,
                               shuffle_seed=0, task_id=None,
                               grid_search=False, device=None):
    """Array-task entry point: pick one (model_type, dataset) from the
    shuffled cartesian product by task id (1-based, from
    ``SLURM_ARRAY_TASK_ID`` when not given), read its cached-args files,
    rescale the coefficients, and run it on ``device``. Returns the task
    id."""
    from redcliff_tpu_torch.utils.config import (read_in_data_args,
                                                 read_in_model_args)

    combos = list(product(possible_model_types, possible_data_sets))
    random.Random(shuffle_seed).shuffle(combos)
    if task_id is None:
        task_id = int(os.environ["SLURM_ARRAY_TASK_ID"])
    model_type, data_set_name = combos[task_id - 1]

    def only(name, files):
        matches = [x for x in files if name in x]
        if len(matches) != 1:
            raise ValueError(f"{name!r} names {len(matches)} cached-args "
                             f"files, not one: {matches}")
        return matches[0]

    args_dict["model_type"] = model_type
    args_dict["model_cached_args_file"] = only(model_type,
                                               files_of_cached_model_args)
    args_dict["data_set_name"] = data_set_name
    args_dict["data_cached_args_file"] = only(data_set_name,
                                              files_of_cached_data_args)

    read_in_model_args(args_dict)
    read_in_data_args(args_dict)
    if "coeff_dict" in args_dict and "REDCLIFF" in model_type:
        rescale_dataset_dependent_coefficients(args_dict)

    kick_off_model_training_experiment(args_dict, grid_search=grid_search,
                                       device=device)
    return task_id


def run_coefficient_grid(model, train_config, grid_points, train_ds, val_ds,
                         key=None, mesh=None, max_iter=None,
                         init_point_params=None, checkpoint_dir=None,
                         checkpoint_every=None, run_dir=None,
                         fit_deadline_s=None, grid_deadline_s=None,
                         true_gc=None, device=None):
    """Train G coefficient/optimizer variations of one REDCLIFF-S model at
    once (see :class:`~redcliff_tpu_torch.parallel.grid.RedcliffGridRunner`)
    on ``device`` (``cuda`` unless given). Returns the GridResult.

    grid_points: list of dicts over the grid axes (e.g. {"gen_lr": ...,
    "factor_cos_sim_coeff": ...}).

    init_point_params: ONE unstacked parameter tree (numpy or torch)
    replicated across the grid axis — the SLURM-array pattern's
    initialization, where every per-point process seeds identically;
    default = independent per-lane draws from the int seed ``key``
    (``train_config.seed`` when None; the JAX package takes a PRNG key).

    checkpoint_dir + checkpoint_every: periodic whole-state checkpoints
    with bit-identical resume, and a final checkpoint on SIGTERM/SIGINT
    (``Preempted``); ``fit_deadline_s`` (scalar or per point) evicts
    over-budget lanes with cause ``"deadline"``, ``grid_deadline_s`` ends
    the fit resumably with ``DeadlineExceeded``
    (:meth:`RedcliffGridRunner.fit`). The grid runs on the bucket ladder
    and compacts as lanes stop (``train_config.g_bucket`` /
    ``compaction``); results stay indexed by original point id.

    Points whose validation loss goes non-finite, or whose numerics guard
    reports a stuck lane, are quarantined (the lane freezes; the rest of
    the grid trains on) and recorded to ``failures.json`` in ``run_dir``
    (default: ``checkpoint_dir``) — one {"point", "epoch", "cause",
    "hparams"} record each, plus the run context. No file is written when
    the run has no failures.

    ``true_gc``: the dataset's ground-truth graphs, which the quality
    monitor scores every lane's graphs against (``quality`` events,
    ``dispatch_stats["quality"]``). As in JAX, no ``log_dir`` is taken
    here: drive :class:`RedcliffGridRunner` for a metrics log.

    Not ported yet, and raising when asked for: a device mesh (``mesh``,
    ROADMAP item 15)."""
    from redcliff_tpu_torch.parallel.grid import GridSpec, RedcliffGridRunner

    if mesh is not None:
        raise NotImplementedError(
            "a device mesh for the grid is not ported yet (ROADMAP queue 1, "
            "item 15, multi-GPU); pass mesh=None")
    grid_points = list(grid_points)
    spec = GridSpec(points=grid_points, fit_deadline_s=fit_deadline_s,
                    grid_deadline_s=grid_deadline_s)
    runner = RedcliffGridRunner(model, train_config, spec, device=device)
    init = (runner.init_grid_from(init_point_params)
            if init_point_params is not None else None)
    # the stacked init is built here solely for this fit: hand ownership
    # over instead of paying a copy of the whole grid state
    result = runner.fit(key, train_ds, val_ds, max_iter=max_iter,
                        init_params=init, copy_init=False,
                        checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every, true_gc=true_gc)
    failures_dir = run_dir if run_dir is not None else checkpoint_dir
    if result.failures and failures_dir is not None:
        os.makedirs(failures_dir, exist_ok=True)
        with open(os.path.join(failures_dir, "failures.json"), "w") as f:
            json.dump({"grid_size": len(spec.points),
                       "training_mode": model.config.training_mode,
                       "seed": train_config.seed,
                       "failures": result.failures}, f, indent=2)
    return result
