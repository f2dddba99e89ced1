"""One array task of a study twin at its published depth, run by the port
alone, and two such runs compared epoch by epoch.

    python3 tools/task_history.py run --study highband --system 6-2-5
        --fold 0 --alg DGCNN [--seed 0] [--device cpu|cuda] --out H.json
        [--workdir W] [--smoke] [--set KEY=VALUE ...]
    python3 tools/task_history.py compare A.json B.json

``run`` curates the fold through the twin's own stage (the JAX package's
fold bit for bit; a D4IC fold's recordings are always drawn on the CPU,
so runs on two devices read one fold), writes the JAX script's model args
(``--set`` overrides one of them), and runs the array task from the
port's init of a CPU ``torch.Generator`` seeded with ``--seed`` (the
array task's seed is 0), which is then placed on ``--device``: a CPU run
and a card run start from the same weights. It writes, per epoch, the
validation losses and the early-stopping criterion (the fit's
``metrics.jsonl`` epoch records), the best and stop epochs, the wall, and
the GC estimate's off-diagonal optimal F1 and ROC-AUC against the fold's
true graphs.

``compare`` prints the first epoch at which the two histories part
beyond the trainer bars (rtol 1e-4, atol 1e-5), both best and stop
epochs and both F1 and ROC-AUC values as one JSON line. A family that
draws dropout (``wants_rng``) draws it from a generator on the fit's
device, so a run on one device is not compared with a run on another:
the line says "draws differ by device" instead.

Studies (``--study``, ``--system``, ``--alg``):
- ``highband``: ``experiments/highband_readout_sweep.py``'s systems
  (6-2-4, 6-2-5, 6-2-6); REDCLIFF_S_CMLP, cMLP or DGCNN.
- ``science``: ``grid_science_parity.py``'s system (6-2-2); ``point<i>``,
  the i-th point of its gen_lr x ADJ_L1_REG_COEFF grid.
- ``factor_count``: ``factor_count_selection.py``'s systems (3-1-2,
  6-4-2); ``K<k>``, REDCLIFF-S at k factors.
- ``wavelet``: ``wavelet_flow.py``'s LFP analog (6-2-3);
  REDCLIFF_S_CMLP_Smooth, cMLP or REDCLIFF_S_CMLP_SmoothCtl.
- ``d4ic``: ``accuracy_parity_d4ic.py``'s SNR tiers (HSNR, MSNR, LSNR);
  REDCLIFF_S_CMLP, cMLP, cLSTM or DGCNN.

It imports ``redcliff_tpu_torch``, never ``jax`` or ``redcliff_tpu``.
"""
import argparse
import json
import math
import numbers
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

OFFDIAG = "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag"
META = "training_meta_data_and_hyper_parameters.pkl"
# the trainer bars of the port's multi-epoch tests
HIST = dict(rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- studies
def _highband_curate(base, system, fold, smoke):
    from redcliff_tpu_torch.experiments import highband_readout_sweep as HB

    dargs, true = HB.curate_system_folds(base, system, fold + 1, smoke)
    return dargs[fold], true[fold]


def _highband_args(system, alg, smoke):
    from redcliff_tpu_torch.experiments import highband_readout_sweep as HB

    margs = HB.model_args(HB.parse_system(system)[2], smoke)
    return alg, margs[alg], HB.ALIASES[alg]


def _science_curate(base, system, fold, smoke):
    from redcliff_tpu_torch.experiments import grid_science_parity as GSP
    from redcliff_tpu_torch.utils.config import load_true_gc_factors

    dargs = GSP.curate_fold(base, fold, smoke, system)
    return dargs, load_true_gc_factors(dargs)


def _science_args(system, alg, smoke):
    """``point<i>``: the per-point leg's cached args at grid point i, its
    coefficients written as ``per_point_leg`` writes them."""
    from redcliff_tpu_torch.experiments import grid_science_parity as GSP

    pt = GSP._grid_points()[int(alg[len("point"):])]
    margs = GSP.base_model_args(system, smoke)
    margs["gen_lr"] = repr(pt["gen_lr"])
    margs["ADJ_L1_REG_COEFF"] = repr(pt["ADJ_L1_REG_COEFF"])
    return GSP.MODEL_TYPE, margs, GSP.MODEL_TYPE


def _factor_count_curate(base, system, fold, smoke):
    from redcliff_tpu_torch.experiments import factor_count_selection as FCS

    dargs, true = FCS.curate_system_folds(base, system, fold + 1, smoke)
    return dargs[fold], true[fold]


def _factor_count_args(system, alg, smoke):
    from redcliff_tpu_torch.experiments import factor_count_selection as FCS

    margs = FCS.k_model_args(int(alg[len("K"):]),
                             FCS.parse_system(system)[2], smoke)
    return FCS.MODEL_TYPE, margs, FCS.MODEL_TYPE


def _wavelet_curate(base, system, fold, smoke):
    from redcliff_tpu_torch.experiments import wavelet_flow as WF
    from redcliff_tpu_torch.utils.config import load_true_gc_factors

    dargs = WF.curate_fold(base, fold, *WF.SAMPLES[bool(smoke)])
    return dargs, load_true_gc_factors(dargs)


def _wavelet_args(system, alg, smoke):
    from redcliff_tpu_torch.experiments import wavelet_flow as WF

    # the Smooth control shares the REDCLIFF readout (wavelet_flow.main)
    alias = "REDCLIFF_S_CMLP" if "REDCLIFF" in alg else "CMLP"
    return alg, WF.model_args(smoke)[alg], alias


def _d4ic_curate(base, system, fold, smoke):
    from redcliff_tpu_torch.experiments import accuracy_parity_d4ic as APD
    from redcliff_tpu_torch.experiments import d4ic_grid_search as DGS
    from redcliff_tpu_torch.utils.config import load_true_gc_factors

    # the recordings come from the device generator: drawn on the CPU
    # whatever the fit's device, so every run reads one fold
    dargs = DGS.curate_tier_fold(base, system, fold,
                                 *APD.SAMPLES[bool(smoke)], device="cpu")
    return dargs, load_true_gc_factors(dargs)


def _d4ic_args(system, alg, smoke):
    from redcliff_tpu_torch.experiments import accuracy_parity_d4ic as APD

    margs = dict({"REDCLIFF_S_CMLP": APD.REDCLIFF_ARGS,
                  "cMLP": APD.CMLP_ARGS, "cLSTM": APD.CLSTM_ARGS,
                  "DGCNN": APD.DGCNN_ARGS}[alg])
    if smoke:
        from redcliff_tpu_torch.experiments import d4ic_grid_search as DGS

        cuts = (DGS.SMOKE_CUTS if "REDCLIFF" in alg
                else dict(max_iter="8", check_every="2"))
        margs.update(cuts)
    alias = {"REDCLIFF_S_CMLP": "REDCLIFF_S_CMLP", "cMLP": "CMLP",
             "cLSTM": "CLSTM", "DGCNN": "DGCNN"}[alg]
    return alg, margs, alias


# study -> (default system, curation, model args)
STUDIES = {
    "highband": ("6-2-5", _highband_curate, _highband_args),
    "science": ("6-2-2", _science_curate, _science_args),
    "factor_count": ("6-4-2", _factor_count_curate, _factor_count_args),
    "wavelet": ("6-2-3", _wavelet_curate, _wavelet_args),
    "d4ic": ("HSNR", _d4ic_curate, _d4ic_args),
}


def prepare(study, system, fold, alg, workdir, smoke=False, overrides=None):
    """Curate the fold and write the model args. Returns ``{"model_type",
    "margs_file", "dargs_file", "true_gc", "eval_alias"}``."""
    _, curate, args = STUDIES[study]
    os.makedirs(workdir, exist_ok=True)
    dargs, true = curate(workdir, system, fold, smoke)
    model_type, margs, alias = args(system, alg, smoke)
    margs = dict(margs, **(overrides or {}))
    margs_file = os.path.join(workdir, f"{model_type}_cached_args.txt")
    with open(margs_file, "w") as f:
        json.dump(margs, f)
    return {"model_type": model_type, "margs_file": margs_file,
            "dargs_file": dargs, "true_gc": true, "eval_alias": alias}


def data_set_name(dargs_file):
    """``data_fold<f>`` of a fold's ``data_fold<f>_cached_args.txt``."""
    return os.path.basename(dargs_file).rsplit("_cached_args", 1)[0]


# ---------------------------------------------------------------- records
def _num(x):
    """A float for JSON (None for a missing value; NaN and inf as
    strings, which ``_value`` reads back)."""
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else repr(x)


def _value(x):
    return None if x is None else float(x)


def read_history(run_dir, read_meta, read_events):
    """The run's per-epoch record: the criterion of each epoch's
    ``metrics.jsonl`` record (None before REDCLIFF-S is past its
    pretrain), each validation history of the meta file (``avg_*``), the
    best and stop epochs. ``read_meta`` and ``read_events`` are the
    package's own readers, so either package's run dir reads alike."""
    meta = read_meta(os.path.join(run_dir, META))
    epochs = read_events(run_dir, "epoch")
    val = {k: [_num(x) for x in v] for k, v in meta.items()
           if k.startswith("avg_") and isinstance(v, (list, tuple))
           and all(isinstance(x, numbers.Real) for x in v)}
    return {"epochs": [int(e["epoch"]) for e in epochs],
            "criteria": [_num(e.get("criteria")) for e in epochs],
            "val": val, "best_it": int(meta["best_it"]),
            "stop_epoch": int(meta["epoch"])}


def scores(stats):
    """The off-diagonal optimal F1 and ROC-AUC means of an
    ``evaluate_algorithm_on_fold`` result, and their per-factor values."""
    s = stats[OFFDIAG]
    return {"f1": _num(s["f1_mean_across_factors"]),
            "roc_auc": _num(s.get("roc_auc_mean_across_factors")),
            "f1_vals": [_num(v) for v in s["f1_vals_across_factors"]],
            "roc_auc_vals": [_num(v) for v in
                             s.get("roc_auc_vals_across_factors", [])]}


def run_port_task(prep, workdir, seed=0, device="cpu"):
    """The array task of ``prep`` in the port, from its init of a CPU
    generator seeded with ``seed``, on ``device``. Returns the task's
    record (:func:`read_history`, the wall, the scores, whether the family
    draws dropout)."""
    from redcliff_tpu_torch.eval.cross_alg import evaluate_algorithm_on_fold
    from redcliff_tpu_torch.eval.model_io import load_model_for_eval
    from redcliff_tpu_torch.obs.logging import read_jsonl
    from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint
    from redcliff_tpu_torch.train import driver

    root = os.path.join(workdir, "runs")
    os.makedirs(root, exist_ok=True)
    args_dict = {"save_root_path": root}
    t0 = time.time()
    driver.set_up_and_run_experiments(
        args_dict, [prep["margs_file"]], [prep["dargs_file"]],
        [prep["model_type"]], [data_set_name(prep["dargs_file"])],
        task_id=1, seed=seed, device=device)
    wall = time.time() - t0
    run_dir = args_dict["save_path"]
    out = read_history(run_dir, read_checkpoint, read_jsonl)
    model = load_model_for_eval(run_dir, device="cpu")[0]
    out.update(wall_s=wall, run_dir=run_dir, device=str(device), seed=seed,
               wants_rng=bool(getattr(model, "wants_rng", False)),
               **scores(evaluate_algorithm_on_fold(
                   run_dir, prep["eval_alias"], prep["true_gc"],
                   device="cpu")))
    return out


# ---------------------------------------------------------------- compare
def _close(x, ref, rtol, atol):
    if x is None or ref is None:
        return (x is None) == (ref is None)
    x, ref = _value(x), _value(ref)
    if math.isnan(x) or math.isnan(ref):
        return math.isnan(x) and math.isnan(ref)
    if math.isinf(x) or math.isinf(ref):
        return x == ref
    return abs(x - ref) <= atol + rtol * abs(ref)


def _series(h):
    if isinstance(h, dict):
        return {"criteria": h["criteria"], **h["val"]}
    return {"": list(h)}


def parting_epoch(a, b, rtol=HIST["rtol"], atol=HIST["atol"]):
    """The first epoch at which ``a`` differs from ``b`` beyond ``atol +
    rtol * |b|``, or None. ``a`` and ``b`` are per-epoch sequences or task
    records (their criterion and every validation history both hold).
    Where one history is longer and the common epochs agree, they part at
    the first epoch only one of them has."""
    sa, sb = _series(a), _series(b)
    part = None
    for key in [k for k in sa if k in sb]:
        x, y = sa[key], sb[key]
        n = min(len(x), len(y))
        p = next((e for e in range(n)
                  if not _close(x[e], y[e], rtol, atol)),
                 n if len(x) != len(y) else None)
        if p is not None and (part is None or p < part):
            part = p
    return part


def compare(a, b):
    """The comparison line of two task records."""
    out = {"a": {k: a.get(k) for k in ("device", "best_it", "stop_epoch",
                                       "f1", "roc_auc", "wall_s")},
           "b": {k: b.get(k) for k in ("device", "best_it", "stop_epoch",
                                       "f1", "roc_auc", "wall_s")}}
    if (a.get("wants_rng") or b.get("wants_rng")) \
            and a.get("device") != b.get("device"):
        out["parting_epoch"] = "draws differ by device"
    else:
        out["parting_epoch"] = parting_epoch(a, b)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--study", required=True, choices=sorted(STUDIES))
    r.add_argument("--system")
    r.add_argument("--fold", type=int, default=0)
    r.add_argument("--alg", required=True)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cuda")
    r.add_argument("--out", required=True)
    r.add_argument("--workdir")
    r.add_argument("--smoke", action="store_true")
    r.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "compare":
        with open(args.a) as f:
            a = json.load(f)
        with open(args.b) as f:
            b = json.load(f)
        line = compare(a, b)
        print(json.dumps(line))
        return line

    from redcliff_tpu_torch.utils.precision import resolve_device

    device = resolve_device(args.device)
    system = args.system or STUDIES[args.study][0]
    workdir = os.path.abspath(args.workdir or os.path.splitext(
        args.out)[0] + "_work")
    overrides = dict(kv.split("=", 1) for kv in args.set)
    prep = prepare(args.study, system, args.fold, args.alg, workdir,
                   smoke=args.smoke, overrides=overrides)
    out = run_port_task(prep, workdir, seed=args.seed, device=device)
    out.update(study=args.study, system=system, fold=args.fold,
               alg=args.alg, overrides=overrides, smoke=bool(args.smoke))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in (
        "study", "system", "fold", "alg", "device", "best_it", "stop_epoch",
        "f1", "roc_auc", "wall_s")}))
    return out


if __name__ == "__main__":
    main()
