"""Port twin of ``experiments/banded_condense.py``: condense the
multi-system synSys study into the paper's separating result, on the host.

It walks the shared eval root that repeated runs of the synSys twin
(``python -m redcliff_tpu_torch.experiments.accuracy_parity_synsys
--system N-E-F``) fill, one eval tree a system, then:

1. runs the complexity-banded cross-experiment analysis
   (``eval/analysis.py:run_cross_experiment_analysis``): per band and
   algorithm the absolute optimal F1, and the per-factor improvement of
   REDCLIFF-S over every baseline (:func:`band_improvement_table`);
2. gathers the per-system dynamic-readout summaries
   (:func:`collect_dynamic_summaries`) into one table, across all systems
   and per band (:func:`aggregate_dynamic`);
3. writes the JSON the JAX condenser writes, equal to it bit for bit on
   the same ``evals/`` tree, to ``<workdir>/BANDED_SYNSYS.json`` unless
   ``--out`` names another file.

It reads only pickles and JSON and launches no kernel; figures are drawn,
and matplotlib imported, only with ``--plot``. ``run_banded_sweep.sh``
beside it runs the six-system sweep and this condenser.

Run:  python -m redcliff_tpu_torch.experiments.banded_condense <workdir>
      [--out FILE] [--plot]
"""
import argparse
import json
import os

import numpy as np

from redcliff_tpu_torch.eval.analysis import run_cross_experiment_analysis
from redcliff_tpu_torch.eval.stats import summarize_values

BASELINE_ALG = "REDCLIFF_S_CMLP"


def _mean_sem(vals):
    s = summarize_values(vals)
    return s["mean"], s["mean_std_err"]


def band_improvement_table(condensed, by_category):
    """{band: {alg: {mean_improvement, sem, n_systems, per_system}}}: over
    the systems of a band, the mean of each system's mean per-factor
    improvement of REDCLIFF-S over ``alg`` (baseline minus ``alg``, per
    factor)."""
    out = {}
    for band, sys_keys in by_category.items():
        alg_accum = {}
        for key in sys_keys:
            imps = condensed[key]["improvements"] or {}
            for alg, st in imps.items():
                if alg == BASELINE_ALG:
                    continue
                alg_accum.setdefault(alg, {})[key] = st["mean"]
        out[band] = {}
        for alg, per_sys in alg_accum.items():
            vals = [v for v in per_sys.values()
                    if v is not None and np.isfinite(v)]
            if not vals:
                continue
            mean, sem = _mean_sem(vals)
            out[band][alg] = {
                "mean_improvement": mean,
                "sem": sem,
                "n_systems": len(vals),
                "per_system": {k: float(v) for k, v in per_sys.items()},
            }
    return out


def collect_dynamic_summaries(eval_root):
    """{system key: {alg: {metric: {mean, sem, n}}}} from the systems'
    ``dynamic/dynamic_readout_summary.json`` files."""
    out = {}
    for sys_key in sorted(os.listdir(eval_root)):
        p = os.path.join(eval_root, sys_key, "dynamic",
                         "dynamic_readout_summary.json")
        if os.path.isfile(p):
            with open(p) as f:
                out[sys_key] = json.load(f)
    return out


def aggregate_dynamic(dyn_by_system, systems=None):
    """{alg: {metric: {mean, sem, n_systems}}} across systems: the mean of
    the per-system means, the SEM across systems. ``systems`` restricts
    the aggregate (to one complexity band, say)."""
    accum = {}
    for sys_key, stats in dyn_by_system.items():
        if systems is not None and sys_key not in systems:
            continue
        for alg, metrics in stats.items():
            if alg.startswith("_") or not isinstance(metrics, dict):
                continue  # the summary's metadata (_conventions)
            for metric, st in metrics.items():
                # scalar convention fields (scoring_window) ride beside
                # the {mean, sem, n} metrics
                if not isinstance(st, dict) or st.get("mean") is None:
                    continue
                accum.setdefault(alg, {}).setdefault(metric, []).append(
                    st["mean"])
    out = {}
    for alg, metrics in accum.items():
        out[alg] = {}
        for metric, vals in metrics.items():
            mean, sem = _mean_sem(vals)
            out[alg][metric] = {"mean": mean, "sem": sem,
                                "n_systems": len(vals)}
    return out


def condense(workdir, plot=False):
    """The condensed study of ``<workdir>/evals`` (the JSON's dict); the
    analysis's own files go to ``<workdir>/banded_analysis``."""
    eval_root = os.path.join(workdir, "evals")
    save_root = os.path.join(workdir, "banded_analysis")
    res = run_cross_experiment_analysis(
        eval_root, save_root, baseline_alg=BASELINE_ALG, plot=plot)
    bands = band_improvement_table(res["condensed"], res["by_category"])
    dyn_by_system = collect_dynamic_summaries(eval_root)

    per_system = {}
    for key, entry in res["condensed"].items():
        per_system[key] = {
            "complexity": entry["complexity"],
            "band": res["system_details"][key]["complexity_category"],
            "alg_optf1": {a: {"mean": st["mean"], "sem": st["sem"]}
                          for a, st in entry["alg_stats"].items()},
            "improvements_of_redcliff": {
                a: st for a, st in (entry["improvements"] or {}).items()
                if a != BASELINE_ALG},
        }
    return {
        "baseline_alg": BASELINE_ALG,
        "paradigm": "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag / f1",
        "banded_improvement": bands,
        "dynamic_readouts_by_system": dyn_by_system,
        "dynamic_readouts_aggregate": aggregate_dynamic(dyn_by_system),
        "dynamic_readouts_by_band": {
            band: aggregate_dynamic(dyn_by_system, systems=set(keys))
            for band, keys in res["by_category"].items() if keys},
        "per_system": per_system,
        "by_category": res["by_category"],
    }


def main(argv=None):
    """Condense ``<workdir>/evals`` and write the JSON. Returns it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args(argv)
    out = condense(args.workdir, plot=args.plot)
    dest = args.out or os.path.join(args.workdir, "BANDED_SYNSYS.json")
    with open(dest, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[done] wrote {dest}", flush=True)
    for band in ("High", "Moderate", "Low"):
        for alg, st in out["banded_improvement"].get(band, {}).items():
            print(f"[band {band}] REDCLIFF-S vs {alg}: "
                  f"{st['mean_improvement']:+.3f} ± {st['sem']:.3f} "
                  f"({st['n_systems']} systems)", flush=True)
    return out


if __name__ == "__main__":
    main()
