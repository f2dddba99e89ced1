"""Fleet batch driver: one merged multi-tenant grid fit, supervised.

``python -m redcliff_tpu_torch.fleet.run_batch <batch.json> [--device D]
[--sim-devices N]``
is the torch-side child the fleet worker runs under the crash-loop
supervisor (port of ``redcliff_tpu/fleet/run_batch.py``). The batch file
(written by fleet/worker.py from the claimed composition) holds the merged
member requests in claim order; this driver:

1. validates that every member shares the identical non-point spec (same
   model config, train config, data, horizon — the planner's
   ``batch_key`` contract re-checked at the trust boundary);
2. concatenates the members' grid points into ONE
   :class:`~redcliff_tpu_torch.parallel.grid.GridSpec` and fits it with the
   grid engine (on the card: both CUDA kernels, the factor mix's lane form
   and the GL prox's, through the CUDA-graph epoch engine) — checkpointed
   into the batch run dir every ``checkpoint_every`` epochs, so a SIGKILLed
   worker's reclaimed batch RESUMES bit-identically instead of restarting;
3. logs the tenant manifest (request id + trace id -> merged point range)
   as a ``fleet`` metrics event in the run dir, so ``obs report`` can
   attribute fits/lane-epochs/quarantines per tenant. The worker exports
   ``REDCLIFF_TRACE_CTX`` into this child, so every span and metrics
   record the fit writes additionally carries the batch/request trace
   join keys (obs/spans.py trace context — zero-cost when
   ``REDCLIFF_TRACE=0``);
4. splits the :class:`~redcliff_tpu_torch.parallel.grid.GridResult` back into
   per-request ``results/<request_id>.json`` records (criteria, epochs,
   val history slice, quarantine causes — strict JSON, no params: the
   checkpoint owns the heavy artifacts), and writes the merged-grid
   ``failures.json`` (every quarantined point with its owning request and
   tenant) — the worker's poison-attribution artifact.

Containment plumbing (docs/ARCHITECTURE.md "Fleet failure containment"):
every lane's init key derives from a CONTENT hash of its own point
(``GridSpec.lane_seeds``), never from its position or the grid width — so a
request fits identically whatever batch the planner (or a bisection) lands
it in, which is what makes bisected survivors bit-identical to an
uninterrupted merged run. ``__chaos__`` sentinel keys in points (the fleet
chaos harness's poison request specs, fleet/chaos.py) are always STRIPPED
before the fit and only ACTED on when the fault grammar arms
``fleet_poison`` — an unarmed replay of a chaos spool completes instead of
crash-looping.

Exit codes follow the watchdog taxonomy (runtime/watchdog.py) exactly like
the faultinject child: preempted 17, deadline 20 — so the supervisor's
restart/stop classification applies unchanged, and host_lost 21 on a
``parallel.remesh.HostLostError`` (part of the batch's mesh is gone: the
supervisor re-meshes and the restart re-shards the checkpoint).

This is the ONE fleet module that imports torch; the queue, planner, and
worker stay backend-free by design. The port's differences from the JAX
module:

* the device: the fit runs on ``device`` (``--device``; ``cuda`` when not
  given). Without CUDA and without a device the child raises before it
  writes anything, and the supervisor classifies that exit as any crash:
  it never fits on the CPU unasked;
* the mesh: ``spec["mesh"] == "auto"`` meshes over the visible cards,
  or over a packed worker's sub-mesh ``slot`` of them, as in JAX;
  ``--sim-devices N`` makes the visible devices N entries of ``--device``
  (one device simulating a pool, as the faultinject child's flag does).
  A slot without ``mesh`` fits on the one device, as in JAX;
* the grid's seed is the int ``train_config.seed`` (JAX: a PRNG key made
  from it); each lane's init still comes from its content seed.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

__all__ = ["run_batch_file", "main", "lane_seed"]

# spec keys every member of a batch must agree on, byte-for-byte after
# canonical JSON: one merged GridSpec must mean the same math for everyone
_MERGE_KEYS = ("model", "model_config", "train_config", "data", "epochs",
               "mesh")


def _canon(spec):
    return json.dumps({k: spec.get(k) for k in _MERGE_KEYS}, sort_keys=True)


def _tupled(d):
    """JSON round-trips tuples as lists; model/train config dataclasses
    expect tuples for the size fields."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def lane_seed(point):
    """Composition-independent lane seed: a stable hash of the point's own
    (chaos-stripped) content. Two submissions of the same point — in any
    batch, any position, any leg of a chaos test — init identically."""
    blob = json.dumps(point, sort_keys=True)
    return int(hashlib.sha1(blob.encode("utf-8")).hexdigest()[:8], 16) \
        & 0x7FFFFFFF


def _build_dataset(data_spec, cfg):
    import numpy as np

    from redcliff_tpu_torch.data.datasets import ArrayDataset

    kind = (data_spec or {}).get("kind", "synthetic")
    if kind == "synthetic":
        # the faultinject tiny-fit contract: deterministic arrays from the
        # seed + the model's window shape (bit-identical across workers)
        rng = np.random.default_rng(int(data_spec.get("seed", 0)))
        n = int(data_spec.get("n", 48))
        T = cfg.max_lag + cfg.num_sims
        X = rng.normal(size=(n, T, cfg.num_chans)).astype(np.float32)
        Y = rng.uniform(size=(n, 3, 1)).astype(np.float32)
        return ArrayDataset(X, Y), ArrayDataset(X, Y)
    if kind == "npz":
        blob = np.load(data_spec["path"])
        train = ArrayDataset(blob["X"], blob.get("Y"))
        if "X_val" in blob:
            return train, ArrayDataset(blob["X_val"], blob.get("Y_val"))
        return train, train
    raise ValueError(f"unknown fleet data kind {kind!r}")


def run_batch_file(batch_file, device=None, sim_devices=None):
    """Run one batch file end-to-end on ``device`` (``cuda`` when None);
    returns the GridResult. ``sim_devices``: the device pool of a mesh
    "auto" batch is this many entries of ``device``."""
    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)
    from redcliff_tpu_torch.obs.logging import MetricLogger, jsonable
    from redcliff_tpu_torch.parallel.grid import (GridSpec,
                                                  RedcliffGridRunner)
    from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig
    from redcliff_tpu_torch.utils.precision import resolve_device

    # before anything is read or written: no card and no device asked for
    # is a failed child, never a CPU fit
    device = resolve_device(device)
    with open(batch_file) as f:
        batch = json.load(f)
    run_dir = batch["run_dir"]
    requests = batch["requests"]
    if not requests:
        raise ValueError(f"{batch_file}: empty batch")
    canon = _canon(requests[0].get("spec") or {})
    for r in requests[1:]:
        if _canon(r.get("spec") or {}) != canon:
            raise ValueError(
                f"{batch_file}: members disagree on the non-point spec — "
                f"the planner must never merge them "
                f"({requests[0]['request_id']} vs {r['request_id']})")
    spec0 = requests[0].get("spec") or {}
    model_name = spec0.get("model", "RedcliffSCMLP")
    if model_name != "RedcliffSCMLP":
        raise ValueError(f"unsupported fleet model {model_name!r}")
    model = RedcliffSCMLP(RedcliffSCMLPConfig(
        **_tupled(spec0.get("model_config") or {})))
    tc_kwargs = dict(spec0.get("train_config") or {})
    epochs = spec0.get("epochs") or requests[0].get("epochs")
    if epochs is not None:
        tc_kwargs["max_iter"] = int(epochs)
    if isinstance(tc_kwargs.get("numerics"), dict):
        # JSON round-trips the sentinel policy as a plain dict
        from redcliff_tpu_torch.runtime.numerics import NumericsPolicy

        tc_kwargs["numerics"] = NumericsPolicy(**tc_kwargs["numerics"])
    tc = RedcliffTrainConfig(**_tupled(tc_kwargs))
    train_ds, val_ds = _build_dataset(spec0.get("data"), model.config)

    from redcliff_tpu_torch.fleet import chaos as _chaos
    from redcliff_tpu_torch.runtime import faultinject as _fi

    merged, manifest, start = [], [], 0
    chaos_specs = []
    for r in requests:
        pts = [_chaos.strip_chaos(p, chaos_specs) for p in
               (r.get("points") or ())]
        merged.extend(pts)
        row = {"request_id": r["request_id"],
               "tenant": str(r.get("tenant")),
               "trace_id": r.get("trace_id"),
               "start": start, "stop": start + len(pts)}
        if r.get("qos"):
            # degraded-QoS stamp (fleet/autoscale.py apply_qos): the rung
            # this request was admitted under rides into the manifest and
            # its results record — the durable "completed at degraded
            # settings" evidence
            row["qos"] = r["qos"]
        manifest.append(row)
        start += len(pts)
    if chaos_specs and _fi.fleet_poison_armed():
        # a poison request spec (fleet chaos harness): die the way the
        # sentinel says, BEFORE any fit — the blind-failure mode the
        # worker's bisection must corner without attribution
        _chaos.detonate(chaos_specs[0])

    # sub-mesh slot: a PACKED worker assigned this batch a disjoint device
    # interval of the pool — mesh over exactly those devices so co-resident
    # batches never share one. Device ids are stable
    # (remesh.visible_devices), so a reclaimed batch meshes over the SAME
    # devices its checkpoint was fitted on. A slot that no longer fits the
    # visible pool (devices lost since the claim) degrades to the auto-mesh
    # recipe rather than crash-looping the batch
    mesh = None
    slot = batch.get("slot")
    if spec0.get("mesh") == "auto":
        from redcliff_tpu_torch.parallel import remesh as _remesh
        from redcliff_tpu_torch.parallel.mesh import grid_mesh

        pool = [device] * int(sim_devices) if sim_devices else None
        if isinstance(slot, dict):
            try:
                lo, width = int(slot["lo"]), int(slot["width"])
            except (KeyError, TypeError, ValueError):
                lo = width = None
            if width:
                devs = _remesh.visible_devices(pool)[lo:lo + width]
                if len(devs) == width:
                    mesh = grid_mesh(devices=devs, axis_name="grid")
        if mesh is None:
            mesh = _remesh.visible_mesh(devices=pool, n_lanes=len(merged))

    # predictive-policy widening ceiling (parallel/policy.py
    # ENV_POLICY_MAX_WIDTH): the admission planner's HBM gate and
    # max_bucket cap were priced at the ADMITTED width recorded in the
    # batch file — a warm-rung initial-width widening inside this child
    # must never exceed it (per-lane footprint scales with width)
    if batch.get("g_bucket"):
        os.environ["REDCLIFF_POLICY_MAX_WIDTH"] = str(int(batch["g_bucket"]))

    import numpy as np

    results_dir = os.path.join(run_dir, "results")
    os.makedirs(results_dir, exist_ok=True)

    def _owner(point):
        return next((m for m in manifest
                     if m["start"] <= point < m["stop"]), None)

    # per-point result streaming: lanes the compaction ladder
    # retires at a check window (early-stopped or quarantined — their state
    # never changes again) are appended to the owning tenant's
    # results/<id>.partial.jsonl IMMEDIATELY, not at batch settle, each
    # also landing as a schema-registered `partial_result` event. Delivery
    # is at-least-once: a resumed attempt may re-append rows an earlier
    # attempt already streamed (and batch settle re-appends every point
    # with final=true) — consumers keep the LAST record per point.
    streamed = set()

    # tenant manifest into the run dir's metrics chain BEFORE the fit, so
    # even a crashed attempt's telemetry is tenant-attributable; the grid
    # engine appends its own events to the same chain next. The logger
    # stays open across the fit: it is also the partial-result event sink
    with MetricLogger(run_dir) as plog:
        plog.log("fleet", kind="manifest", batch_id=batch.get("batch_id"),
                 requests=manifest,
                 tenants=sorted({m["tenant"] for m in manifest}),
                 n_points=len(merged))

        def _stream_partial(pid, rec, epoch, final=False):
            own = _owner(int(pid))
            if own is None:
                return
            failed_epoch = rec.get("failed_epoch")
            failed = isinstance(failed_epoch, (int, float)) \
                and failed_epoch >= 0
            row = jsonable({
                "request_id": own["request_id"],
                "tenant": own["tenant"],
                "batch_id": batch.get("batch_id"),
                "point": int(pid) - own["start"],
                "merged_point": int(pid),
                "epoch": int(epoch),
                "best_criterion": rec.get("best_crit"),
                "best_epoch": rec.get("best_epoch"),
                "failed": bool(failed),
                "final": bool(final),
            })
            path = os.path.join(results_dir,
                                f"{own['request_id']}.partial.jsonl")
            try:
                with open(path, "a") as fh:
                    fh.write(json.dumps(row, allow_nan=False) + "\n")
                plog.log("partial_result", **row)
                streamed.add(int(pid))
            except (OSError, ValueError):
                pass  # streaming is a tenant convenience, never fatal

        runner = RedcliffGridRunner(
            model, tc,
            GridSpec(points=merged,
                     lane_seeds=[lane_seed(p) for p in merged]),
            mesh=mesh, device=None if mesh is not None else device)
        result = runner.fit(tc.seed, train_ds, val_ds,
                            checkpoint_dir=run_dir,
                            checkpoint_every=int(
                                batch.get("checkpoint_every") or 1),
                            log_dir=run_dir,
                            on_lane_retire=_stream_partial)

        # complete the stream at batch settle: every lane that ran to the
        # end (never early-retired) gets its terminal row, final=true
        best_crit_arr = np.asarray(result.best_criteria)
        best_epoch_arr = np.asarray(result.best_epoch)
        failed_pts = {int(f["point"]) for f in result.failures}
        for pid in range(len(merged)):
            if pid in streamed:
                continue
            _stream_partial(pid, {
                "best_crit": float(best_crit_arr[pid]),
                "best_epoch": int(best_epoch_arr[pid]),
                "failed_epoch": 0 if pid in failed_pts else -1,
            }, epoch=int(best_epoch_arr[pid]), final=True)

    # ---- split the merged result into per-request records ----------------
    val_hist = np.asarray(result.val_history)

    # model-quality observatory (obs/quality.py): the engine's rolling
    # convergence snapshot, keyed by ORIGINAL merged point id — sliced per
    # request below so results/<id>.json carries each tenant's own quality
    # block (None when REDCLIFF_QUALITY=0 or no check window ran)
    qstats = (getattr(runner, "dispatch_stats", None) or {}).get("quality")

    def _request_quality(lo, hi):
        if not isinstance(qstats, dict) or not qstats.get("windows"):
            return None
        pick = lambda key: ([(qstats.get(key) or {}).get(str(p))
                             for p in range(lo, hi)]
                            if qstats.get(key) is not None else None)
        plats = pick("plateaued_at_epoch") or []
        return {
            "windows": qstats.get("windows"),
            "mode": qstats.get("mode"),
            "plateaued_at_epoch": plats,
            "converged_at_epoch": (max(plats) if plats
                                   and all(p is not None for p in plats)
                                   else None),
            "edge_stability": pick("edge_stability"),
            "topk_hash": pick("topk_hash"),
            "auroc": pick("auroc"),
            "aupr": pick("aupr"),
        }

    # merged-grid failures.json (train/driver.py's artifact, with per-point
    # request/tenant attribution): the worker's poison-attribution input
    # and the dead-letter dossier's quarantine evidence
    attributed = []
    for f in result.failures:
        own = _owner(int(f["point"])) or {}
        attributed.append(dict(f, request_id=own.get("request_id"),
                               tenant=own.get("tenant")))
    tmp = os.path.join(run_dir, f".failures.json.tmp.{os.getpid()}")
    with open(tmp, "w") as fh:
        json.dump({"batch_id": batch.get("batch_id"),
                   "grid_size": len(merged),
                   "failures": jsonable(attributed)}, fh, allow_nan=False)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, os.path.join(run_dir, "failures.json"))
    for row in manifest:
        lo, hi = row["start"], row["stop"]
        failures = [dict(f, point=int(f["point"]) - lo,
                         merged_point=int(f["point"]))
                    for f in result.failures if lo <= f["point"] < hi]
        rec = {
            "request_id": row["request_id"],
            "tenant": row["tenant"],
            "batch_id": batch.get("batch_id"),
            "n_points": hi - lo,
            "best_criteria": jsonable(result.best_criteria[lo:hi]),
            "best_epoch": jsonable(result.best_epoch[lo:hi]),
            "active": jsonable(result.active[lo:hi]),
            "val_history": jsonable(val_hist[:, lo:hi]),
            "failures": jsonable(failures),
            "quality": jsonable(_request_quality(lo, hi)),
        }
        if row.get("qos"):
            rec["qos"] = row["qos"]
        tmp = os.path.join(results_dir,
                           f".{row['request_id']}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(rec, f, allow_nan=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(results_dir,
                                     f"{row['request_id']}.json"))
    return result


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"--device": None, "--sim-devices": None}
    rest = []
    while argv:
        a = argv.pop(0)
        if a in opts and argv:
            opts[a] = argv.pop(0)
        else:
            rest.append(a)
    if len(rest) != 1 or rest[0].startswith("-"):
        print("usage: python -m redcliff_tpu_torch.fleet.run_batch "
              "<batch.json> [--device D] [--sim-devices N]",
              file=sys.stderr)
        return 2
    from redcliff_tpu_torch.parallel.remesh import HostLostError
    from redcliff_tpu_torch.runtime.preempt import (DeadlineExceeded,
                                                    Preempted)
    from redcliff_tpu_torch.runtime.watchdog import (EXIT_DEADLINE,
                                                     EXIT_HOST_LOST,
                                                     EXIT_PREEMPTED)

    sim = opts["--sim-devices"]
    try:
        run_batch_file(rest[0], device=opts["--device"],
                       sim_devices=int(sim) if sim else None)
    except HostLostError as e:
        print(f"fleet run_batch: {e}", file=sys.stderr)
        return EXIT_HOST_LOST
    except Preempted as e:
        print(f"fleet run_batch: {e}", file=sys.stderr)
        return EXIT_PREEMPTED
    except DeadlineExceeded as e:
        print(f"fleet run_batch: {e}", file=sys.stderr)
        return EXIT_DEADLINE
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
