"""Grid-search model selection over training-history artifacts (a copy of
the JAX package's ``eval/grid_selection.py``; host only).

The reference's eval_gs_* flow
(its evaluate/eval_gs_REDCLIFF_S_CMLP_tst100hzRerun1024AvgReg_BSCgsSmooth1_dataFULL.py:26-175):
scan every run folder under a grid root for
``training_meta_data_and_hyper_parameters.pkl`` (durable or legacy, written
by either package's trainer; the port's ``runtime/checkpoint.py`` reads
both), average per-factor metric histories into per-epoch scalars, drop
incomplete runs, and rank runs under each selection criterion (minimize
losses / maximize AUCs, plus summed combinations), reporting the best run
and best epoch per criterion.
"""
from __future__ import annotations

import os

import numpy as np

from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint

__all__ = [
    "load_grid_summaries",
    "average_factor_histories",
    "filter_incomplete_runs",
    "rank_runs",
    "select_best_models",
]

# criterion -> (history key, direction).  "min" selects argmin, "max" argmax.
CRITERION_KEYS = {
    "roc_auc": ("avg_roc_auc_score_history", "max"),
    "roc_auc_OffDiag": ("avg_roc_auc_OffDiag_score_history", "max"),
    "forecasting_loss": ("avg_forecasting_loss", "min"),
    "factor_loss": ("avg_factor_loss", "min"),
    "fw_l1_penalty_history": ("avg_fw_l1_penalty_history", "min"),
    "gc_l1_history": ("avg_gc_factor_l1_history", "min"),
    "gc_cosine_sim_history": ("avg_gc_factor_cos_sim_history", "min"),
}


def load_grid_summaries(trained_models_root_path):
    """{run_folder_name: meta dict} for every run with a summary pickle
    (ref :70-76)."""
    out = {}
    for name in sorted(os.listdir(trained_models_root_path)):
        p = os.path.join(trained_models_root_path, name,
                         "training_meta_data_and_hyper_parameters.pkl")
        if os.path.isfile(p):
            # format-aware read: durable-header metas and legacy pickles
            out[name] = read_checkpoint(p)
    return out


def _mean_across_factors(history):
    """Per-epoch mean over a per-factor history laid out as either a list of
    per-epoch per-factor lists or a dict of per-factor lists (ref :83-110)."""
    if isinstance(history, dict):
        series = list(history.values())
        return [float(np.mean(t)) for t in zip(*series)]
    if history and isinstance(history[0], (list, tuple, np.ndarray)):
        return [float(np.mean(t)) for t in zip(*history)]
    return [float(x) for x in history]


def average_factor_histories(meta):
    """Attach avg_* per-epoch histories to a run's meta dict (ref :79-110).
    Missing histories yield empty lists so filter_incomplete_runs can drop
    the run."""
    out = dict(meta)

    def get(key, default=()):
        return meta.get(key, default)

    # roc histories are keyed by threshold; the reference reads entry 0.0
    for src, dst in (("roc_auc_histories", "avg_roc_auc_score_history"),
                     ("roc_auc_OffDiag_histories",
                      "avg_roc_auc_OffDiag_score_history")):
        hist = get(src, {})
        if isinstance(hist, dict):
            hist = hist.get(0.0, [])
        out[dst] = _mean_across_factors(hist) if len(hist) else []
    out["avg_fw_l1_penalty_history"] = [
        float(x) for x in get("avg_fw_l1_penalty", [])]
    out["avg_gc_factor_l1_history"] = _mean_across_factors(
        get("gc_factor_l1_loss_histories", []))
    out["avg_gc_factor_cos_sim_history"] = _mean_across_factors(
        get("gc_factor_cosine_sim_histories", {}))
    out["avg_gc_factor_deltacon0_history"] = _mean_across_factors(
        get("deltacon0_histories", []))
    out["avg_gc_factor_deltacon0_with_directed_degrees_history"] = \
        _mean_across_factors(get("deltacon0_with_directed_degrees_histories",
                                 []))
    out["avg_gc_factor_deltaffinity_history"] = _mean_across_factors(
        get("deltaffinity_histories", []))
    if "avg_forecasting_loss" in meta:
        out["avg_forecasting_loss"] = [
            float(x) for x in meta["avg_forecasting_loss"]]
    if "avg_factor_loss" in meta:
        out["avg_factor_loss"] = [float(x) for x in meta["avg_factor_loss"]]
    return out


def filter_incomplete_runs(summaries, vital_keys=("avg_forecasting_loss",
                                                  "avg_factor_loss",
                                                  "avg_gc_factor_cos_sim_history")):
    """Drop runs whose vital histories are missing or length-mismatched
    (ref :112-131)."""
    kept = {}
    for name, meta in summaries.items():
        lens = [len(meta.get(k, [])) for k in vital_keys]
        if 0 in lens or len(set(lens)) != 1:
            print(f"grid_selection: REMOVING run {name} ON ACCOUNT OF "
                  f"MISSING DATA", flush=True)
            continue
        kept[name] = meta
    return kept


def _criterion_history(meta, criterion):
    """Per-epoch history for a (possibly summed-combination) criterion
    (ref :140-175)."""
    if criterion in CRITERION_KEYS:
        key, direction = CRITERION_KEYS[criterion]
        return list(meta.get(key, [])), direction
    if "_and_" in criterion:
        parts = criterion.split("_and_")
        hists = []
        for p in parts:
            if p not in CRITERION_KEYS:
                raise ValueError(f"unknown criterion component: {p!r}")
            key, direction = CRITERION_KEYS[p]
            if direction != "min":
                raise ValueError(
                    f"combined criteria must minimize; {p!r} maximizes")
            hists.append(meta.get(key, []))
        combo = [float(sum(t)) for t in zip(*hists)]
        return combo, "min"
    raise ValueError(f"unknown criterion: {criterion!r}")


def rank_runs(summaries, criterion):
    """[(run_name, best_value, best_epoch)] sorted best-first under the
    criterion."""
    rows = []
    direction = "min"
    for name, meta in summaries.items():
        hist, direction = _criterion_history(meta, criterion)
        if not hist:
            continue
        arr = np.asarray(hist, dtype=np.float64)
        idx = int(np.argmax(arr)) if direction == "max" else int(np.argmin(arr))
        rows.append((name, float(arr[idx]), idx))
    rows.sort(key=lambda r: r[1], reverse=(direction == "max"))
    return rows


def select_best_models(trained_models_root_path,
                       selection_criteria=("forecasting_loss", "factor_loss",
                                           "gc_cosine_sim_history",
                                           "forecasting_loss_and_factor_loss_and_gc_cosine_sim_history")):
    """End-to-end grid selection (the eval_gs script flow): returns
    {criterion: {"ranking": [...], "best_run": name, "best_epoch": int}}."""
    raw = load_grid_summaries(trained_models_root_path)
    summaries = {k: average_factor_histories(v) for k, v in raw.items()}
    summaries = filter_incomplete_runs(summaries)
    out = {}
    for criterion in selection_criteria:
        ranking = rank_runs(summaries, criterion)
        out[criterion] = {
            "ranking": ranking,
            "best_run": ranking[0][0] if ranking else None,
            "best_epoch": ranking[0][2] if ranking else None,
        }
    return out
