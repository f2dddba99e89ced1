"""Experiment drivers (port of ``train/driver.py``): the coefficient-grid
entry and the two pure helpers every driver uses.

* :func:`run_coefficient_grid` — train G coefficient/optimizer variations
  of one REDCLIFF-S model at once through
  :class:`~redcliff_tpu_torch.parallel.grid.RedcliffGridRunner`, replacing
  one process per grid point; writes ``failures.json`` for quarantined
  points.
* :func:`rescale_dataset_dependent_coefficients` and
  :func:`run_folder_name` — copies of the JAX package's helpers.

The array-task driver (``kick_off_model_training_experiment``,
``set_up_and_run_experiments``) and ``train/orchestration.py`` are not
ported yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["run_folder_name", "rescale_dataset_dependent_coefficients",
           "run_coefficient_grid"]


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

    Points whose validation loss goes non-finite, or whose numerics guard
    reports a stuck lane, are quarantined (the lane freezes; the rest of
    the grid trains on) and recorded to ``failures.json`` in ``run_dir`` —
    one {"point", "epoch", "cause", "hparams"} record each, plus the run
    context. No file is written when the run has no failures.

    Not ported yet, and raising when asked for: a device mesh (``mesh``,
    ROADMAP item 15), checkpoints (``checkpoint_dir``/``checkpoint_every``,
    item 9), deadlines (``fit_deadline_s``/``grid_deadline_s``, item 9) and
    the quality monitor's ground truth (``true_gc``, item 11)."""
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
    if result.failures and run_dir is not None:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "failures.json"), "w") as f:
            json.dump({"grid_size": len(spec.points),
                       "training_mode": model.config.training_mode,
                       "seed": train_config.seed,
                       "failures": result.failures}, f, indent=2)
    return result
