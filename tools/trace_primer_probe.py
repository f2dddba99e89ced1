"""How many kernel records a traced grid epoch loses on the card, with and
without the capture window's primer (``redcliff_tpu_torch/obs/profiling.py``).

Runs ``--fits`` traced fits in one process: each is ``chip_smoke.py``'s mesh
leg (a) fit (the published 27-point D4IC grid on ``[cuda:0] * 4``, 4 epochs,
the first replayed epoch traced). For each fit it prints one JSON line: the
wrappers' kernel launches over the window, the trace's executions of the two
CUDA kernels, the kernels recorded under each of the trace's first CUDA-graph
launches, and the records missing from the head of the window's first
full-epoch replay (against the largest replay of the same program).

    python3 tools/trace_primer_probe.py [--no-primer] [--fits 8]

Needs a CUDA card; run from the root of a checkout.
"""
import argparse
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def graph_replays(path):
    """Kernels recorded under each CUDA-graph launch of a Chrome trace, in
    launch order."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    by_corr = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            c = ev.get("args", {}).get("correlation")
            by_corr[c] = by_corr.get(c, 0) + 1
    launches = sorted((ev["ts"], ev.get("args", {}).get("correlation"))
                      for ev in events if ev.get("cat") == "cuda_runtime"
                      and "GraphLaunch" in ev.get("name", ""))
    return [by_corr.get(c, 0) for _, c in launches]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-primer", action="store_true",
                    help="open each window without the primer")
    ap.add_argument("--fits", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as CS
    from redcliff_tpu_torch.obs import profiling
    from redcliff_tpu_torch.ops import factor_mix as FM
    from redcliff_tpu_torch.ops import pallas_prox as PX
    from redcliff_tpu_torch.parallel.mesh import grid_mesh
    from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig

    if not torch.cuda.is_available():
        print("trace_primer_probe: CUDA is not available", file=sys.stderr)
        return 2
    if args.no_primer:
        profiling._primers = lambda torch: []
    os.environ["REDCLIFF_QUALITY"] = "0"
    CS.phase_build(torch, {"factor_mix": FM, "gl_prox": PX})
    dev = torch.device("cuda", 0)
    model, params, points, train_ds, val_ds = CS._mesh_grid_parts(torch)
    tc = RedcliffTrainConfig(**CS.TRAIN_KNOBS,
                             profile_window=f"epoch:{CS.MESH_REPLAY_EPOCH}")
    mesh = grid_mesh(devices=[dev] * CS.MESH_SHARDS)
    primed = not args.no_primer
    for fit in range(args.fits):
        run_dir = os.path.join(HERE, "build", "trace_primer_probe",
                               f"{'primer' if primed else 'none'}_{fit}")
        shutil.rmtree(run_dir, ignore_errors=True)
        with CS._WindowCounters(FM, PX) as wc:
            CS._mesh_fit(torch, model, tc, points, params, train_ds, val_ds,
                         mesh, log_dir=run_dir)
        prof, = [r for r in CS._records(run_dir) if r["event"] == "profile"]
        counts, _, _ = CS._trace_kernels(prof["path"])
        replays = graph_replays(prof["path"])
        work = replays[1:] if primed else replays
        full = max(work)
        first = next(n for n in work if full - n < full // 2)
        print(json.dumps({
            "primer": primed and profiling.PRIMER_KERNELS, "fit": fit,
            "wrappers": wc.window_launches(), "trace": counts,
            "equal": counts == wc.window_launches(),
            "primer_recorded": replays[0] if primed else None,
            "graph_launches": len(replays),
            "first_epoch_replay_lost": full - first,
            "largest_replay": full}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
