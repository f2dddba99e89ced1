"""The High-band readout sweep's results against another run of it: each
system's and condition's REDCLIFF-S readout metrics and the two static
baselines' dynamic optimal F1, as mean ± SEM beside the reference's, with
the gap in combined SEMs, (a - b) / sqrt(sem_a^2 + sem_b^2).

    python3 tools/highband_compare.py <HIGHBAND_READOUT_SWEEP.json>
        [--reference experiments/HIGHBAND_READOUT_SWEEP.json] [--json OUT]

Prints one markdown table row per system x condition x metric and a last
line with the count of rows within 2 combined SEMs. Host only.
"""
import argparse
import json
import math
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("edge_tracking_r", "dynamic_optimal_f1", "state_score_r",
           "dominant_state_acc")
BASELINES = ("CMLP", "DGCNN")


def gap(a, b):
    """``(a - b)`` in combined SEMs, or None where either side is missing
    (a zero combined SEM gives 0 for equal means, else inf)."""
    if not (isinstance(a, dict) and isinstance(b, dict)):
        return None
    diff = a["mean"] - b["mean"]
    sem = math.hypot(a["sem"], b["sem"])
    if sem == 0:
        return 0.0 if diff == 0 else math.copysign(math.inf, diff)
    return diff / sem


def rows(run, ref):
    """``[(system, condition, algorithm, metric, run stat, ref stat, gap)]``
    over the systems both hold."""
    out = []
    for system in run["systems"]:
        if system not in ref["systems"]:
            continue
        for cond, res in run["systems"][system].items():
            want = ref["systems"][system][cond]
            pairs = [("REDCLIFF_S_CMLP", m) for m in METRICS]
            pairs += [(alg, "dynamic_optimal_f1") for alg in BASELINES]
            for alg, metric in pairs:
                a, b = res[alg].get(metric), want[alg].get(metric)
                out.append((system, cond, alg, metric, a, b, gap(a, b)))
    return out


def _fmt(st):
    return "—" if not isinstance(st, dict) else (
        f"{st['mean']:.4f} ± {st['sem']:.4f} (n {st['n']})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run")
    ap.add_argument("--reference", default=os.path.join(
        HERE, "experiments", "HIGHBAND_READOUT_SWEEP.json"))
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    with open(args.run) as f:
        run = json.load(f)
    with open(args.reference) as f:
        ref = json.load(f)
    table = rows(run, ref)
    print("| system | condition | algorithm | metric | run | reference | "
          "gap (combined SEMs) |")
    print("|---|---|---|---|---|---|---|")
    for system, cond, alg, metric, a, b, g in table:
        print(f"| {system} | {cond} | {alg} | {metric} | {_fmt(a)} | "
              f"{_fmt(b)} | {'—' if g is None else f'{g:+.2f}'} |")
    scored = [g for *_, g in table if g is not None]
    within = sum(abs(g) <= 2 for g in scored)
    print(json.dumps({"rows": len(table), "scored": len(scored),
                      "within_2_sems": within,
                      "beyond_2_sems": [
                          {"system": s, "condition": c, "algorithm": al,
                           "metric": m, "gap": g}
                          for s, c, al, m, _, _, g in table
                          if g is not None and abs(g) > 2]}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump([{"system": s, "condition": c, "algorithm": al,
                        "metric": m, "run": a, "reference": b, "gap": g}
                       for s, c, al, m, a, b, g in table], f, indent=2)


if __name__ == "__main__":
    main()
