"""CLI for the port's streaming inference service.

``run`` serves a fitted artifact until SIGTERM, then drains; ``smoke`` is
the self-contained check: a seeded tiny model, three subscriber streams —
one streaming NaNs — and the robustness story end to end (poisoner
quarantined, siblings answer with finite scores, graceful drain writes a
resumable checkpoint). ``ladder-smoke`` is the elastic data plane's check:
churn 3 -> 17 -> 2 streams through a capacity-32 table under the forced
occupancy ladder and assert the rung transitions 4 -> 32 -> 4, zero
quarantines, and victim records byte-identical to a ladder-off run. Exit 0
iff every assertion holds. All run on ``cuda`` unless ``--device`` names
another device.

Usage::

    python -m redcliff_tpu_torch.serve run --artifact RUN_DIR \
        --root SERVE_DIR [--slots N] [--interval-s S] \
        [--precision-mode MODE] [--ladder MODE] [--fuse N] [--device DEV]
    python -m redcliff_tpu_torch.serve smoke [--root DIR] [--device DEV]
    python -m redcliff_tpu_torch.serve ladder-smoke [--root DIR] \
        [--device DEV]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

# ladder on vs off: the largest difference a victim's record may show
LADDER_ATOL = 1e-6


def _tiny_config():
    from redcliff_tpu_torch.models.redcliff import RedcliffSCMLPConfig

    return RedcliffSCMLPConfig(
        num_chans=4, gen_lag=2, gen_hidden=(8,), embed_lag=4,
        embed_hidden_sizes=(8,), num_factors=2, num_supervised_factors=2,
        factor_weight_l1_coeff=0.01, adj_l1_reg_coeff=0.001,
        factor_cos_sim_coeff=0.01,
        factor_score_embedder_type="Vanilla_Embedder",
        primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
        training_mode="combined")


def _build_tiny_artifact(root, seed=0):
    """A seeded tiny REDCLIFF-S model saved through the artifact writer, so
    the smoke exercises the real artifact load path."""
    import torch

    from redcliff_tpu_torch.models.redcliff import RedcliffSCMLP
    from redcliff_tpu_torch.train.trainer import save_model

    model = RedcliffSCMLP(_tiny_config())
    params = model.init(torch.Generator().manual_seed(seed))
    save_model(root, model, params)
    return root


def _smoke(args):
    import numpy as np

    from redcliff_tpu_torch.serve.service import ServeService

    root = args.root or tempfile.mkdtemp(prefix="redcliff-torch-smoke-")
    os.makedirs(root, exist_ok=True)
    artifact = _build_tiny_artifact(root)
    svc = ServeService.from_artifact(artifact, root=root, capacity=4,
                                     device=args.device)

    chans = svc.engine.num_chans
    warmup = svc.engine.window_len
    n = warmup + 8
    rng = np.random.default_rng(7)
    streams = {sid: rng.normal(size=(n, chans)).astype(np.float32)
               for sid in ("good-a", "good-b", "poisoner")}
    # the poisoner turns toxic mid-stream, after its ring has warmed up
    streams["poisoner"][warmup + 2, 1] = np.nan
    for sid in streams:
        svc.connect(sid=sid, now=0.0)

    now = 0.0
    for t in range(n):
        now += 0.01
        for sid, arr in streams.items():
            svc.ingest(sid, arr[t], now=now)
        svc.pump(now=now)

    failures = []
    polls = {sid: svc.poll(sid, now=now) for sid in streams}
    for sid in ("good-a", "good-b"):
        recs = [r for r in polls[sid] if "scores" in r]
        if len(recs) != n - warmup + 1:
            failures.append(f"{sid}: answered {len(recs)}, "
                            f"want {n - warmup + 1}")
        if any(not np.all(np.isfinite(r["scores"])) for r in recs):
            failures.append(f"{sid}: non-finite scores leaked")
    sess = svc.registry.get("poisoner")
    if sess is None or sess.state != "quarantined":
        failures.append(f"poisoner not quarantined "
                        f"(state={getattr(sess, 'state', 'gone')})")
    if not any("error" in r for r in polls["poisoner"]):
        failures.append("poisoner got no structured error record")

    ckpt = svc.drain(now=now)
    if ckpt is None or not os.path.exists(ckpt):
        failures.append(f"drain checkpoint missing: {ckpt!r}")

    if failures:
        print("serve smoke FAILED:")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"serve smoke OK on {svc.engine.device}: 2 siblings answered "
          f"{n - warmup + 1} samples each, poisoner quarantined, drain "
          f"checkpoint at {ckpt}")
    return 0


def _ladder_smoke(args):
    """The elastic data plane's check: capacity-32 table, forced ladder,
    churn 3 -> 17 -> 2 streams, deterministic virtual clock. Asserts the
    rung rides 4 -> 32 -> 4, nobody is quarantined, and the two persistent
    victim streams' records equal a ladder-off run's: byte for byte where
    the device's matrix products round a row the same at every width, and
    within :data:`LADDER_ATOL` everywhere (torch's CPU GEMMs block by the
    row count, so a lane's last bits can move with the rung; ROADMAP queue
    3). Prints which held."""
    import json
    import shutil

    import numpy as np

    from redcliff_tpu_torch.serve import chaos
    from redcliff_tpu_torch.serve.service import ServeService

    # tight hysteresis so the forced shrink lands inside the smoke's churn
    # phases (the decision logic is identical at any hold)
    os.environ.setdefault("REDCLIFF_SERVE_LADDER_HOLD", "2")
    base = args.root or tempfile.mkdtemp(prefix="redcliff-serve-ladder-")
    for sub in ("artifact", "forced", "off"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    artifact = _build_tiny_artifact(os.path.join(base, "artifact"))

    capacity, chans, warmup = 32, 4, 4
    n = warmup + 20
    victims = {f"victim-{i}": chaos.stream_samples(100 + i, n, chans)
               for i in range(2)}
    # churn plan on the virtual tick clock: phase A runs 3 streams
    # (2 victims + 1 extra), phase B connects 14 more (17 live -> rung 32),
    # phase C disconnects all extras (2 live -> rung 4)
    phase_b, phase_c = 8, 16

    def churn(svc, t, now):
        if t == 0:
            svc.connect(sid="extra-0", now=now)
        if t == phase_b:
            for i in range(1, 15):
                svc.connect(sid=f"extra-{i}", now=now)
        if t == phase_c:
            for i in range(15):
                svc.disconnect(f"extra-{i}")
        # extras stream clean samples while connected (never poll: they
        # are load, not subscribers)
        rng = np.random.default_rng(1000 + t)
        for i in range(15):
            x = rng.normal(size=chans).astype(np.float32)
            svc.ingest(f"extra-{i}", x, now=now)

    def run(mode, root):
        svc = ServeService.from_artifact(artifact, root=root,
                                         capacity=capacity, ladder=mode,
                                         resume=False, device=args.device)
        for sid in victims:
            svc.connect(sid=sid, now=0.0)
        res = chaos.drive(svc, victims, ticks=n + 8, chaos_fn=churn)
        svc.stop()
        return res, svc

    forced_root = os.path.join(base, "forced")
    res_on, svc_on = run("force", forced_root)
    res_off, _svc_off = run("off", os.path.join(base, "off"))

    failures = []
    identical, compared, detail = chaos.outputs_identical(res_on, res_off)
    worst = chaos.max_abs_difference(res_on, res_off)
    if compared == 0 or not worst <= LADDER_ATOL:
        failures.append(f"victim records diverge under the ladder "
                        f"({compared} compared, max abs {worst}, bar "
                        f"{LADDER_ATOL}): {detail}")
    quarantined = [s.sid for s in svc_on.registry.sessions.values()
                   if s.state != "active"]
    if quarantined:
        failures.append(f"unexpected quarantines: {quarantined}")

    rungs = []
    with open(os.path.join(forced_root, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("event") == "serve_ladder" and \
                    rec.get("kind") in ("grow", "shrink"):
                rungs.append(int(rec["to_width"]))
    want = [4, 32, 4]
    if rungs != want:
        failures.append(f"rung transitions {rungs}, want {want}")

    if args.root is None:
        shutil.rmtree(base, ignore_errors=True)
    if failures:
        print("serve ladder smoke FAILED:")
        for f in failures:
            print(f"  - {f}")
        return 1
    same = ("byte-identical" if identical
            else f"within {worst:.3g} (bar {LADDER_ATOL:g}; not bitwise)")
    print(f"serve ladder smoke OK on {svc_on.engine.device}: rungs {rungs}, "
          f"{compared} victim records {same} across ladder on/off, "
          f"0 quarantines")
    return 0


def _run(args):
    from redcliff_tpu_torch.serve.service import ServeService

    svc = ServeService.from_artifact(
        args.artifact, root=args.root, capacity=args.slots,
        precision_mode=args.precision_mode, ladder=args.ladder,
        fuse=args.fuse, device=args.device)
    svc.install_signal_handlers()
    svc.run_loop(interval_s=args.interval_s)
    if not svc._stopped:
        svc.drain()
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m redcliff_tpu_torch.serve")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("smoke", help="self-contained robustness smoke")
    ps.add_argument("--root", default=None)
    ps.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ps.set_defaults(fn=_smoke)
    pl = sub.add_parser("ladder-smoke",
                        help="occupancy-ladder churn smoke")
    pl.add_argument("--root", default=None)
    pl.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    pl.set_defaults(fn=_ladder_smoke)
    pr = sub.add_parser("run", help="serve an artifact until SIGTERM")
    pr.add_argument("--artifact", required=True)
    pr.add_argument("--root", required=True)
    pr.add_argument("--slots", type=int, default=None)
    pr.add_argument("--interval-s", type=float, default=0.005)
    pr.add_argument("--precision-mode", default=None,
                    choices=("f32", "mixed"),
                    help="serve-table precision (default: "
                         "REDCLIFF_SERVE_PRECISION or f32)")
    pr.add_argument("--ladder", default=None,
                    choices=("off", "auto", "force"),
                    help="occupancy-ladder mode (default: "
                         "REDCLIFF_SERVE_LADDER or auto)")
    pr.add_argument("--fuse", type=int, default=None,
                    help="max samples fused per dispatch (default: "
                         "REDCLIFF_SERVE_FUSE or 1)")
    pr.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    pr.set_defaults(fn=_run)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
