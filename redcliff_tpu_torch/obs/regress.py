"""Cross-round bench regression sentinel (port of ``obs/regress.py``).

A copy of ``redcliff_tpu/obs/regress.py`` on the port's schema, stdlib
only, with one difference: the JAX module's default trajectory is the
repository root, whose ``BENCH_r*.json`` are runs of the JAX package on a
TPU. They are not the port's, so the port has no default: the trajectory
is the ``--bench-dir`` (or ``bench_dir`` / ``trajectory``) the caller
names, ``python -m redcliff_tpu_torch.obs regress`` without one exits 2
("no port benchmark trajectory yet"), and the block's ``tpu_cache`` is
None (the port shows no TPU evidence as its own).

The JAX module's description of the families and the noise model holds
as it is: each family is judged against at least
:data:`MIN_PRIOR_SAMPLES` prior samples from the same platform (and the
same headline grid size for G-dependent families), the band widens to the
priors' own spread, and timing families carry an absolute floor.
Verdicts: ``regressions`` (worse than the prior median beyond the band),
``improvements`` (reported, never fatal). Unusable rounds are skipped and
counted.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

from redcliff_tpu_torch.obs import schema as _schema

__all__ = ["Family", "FAMILIES", "MIN_PRIOR_SAMPLES", "NO_TRAJECTORY",
           "load_trajectory", "payload_samples", "run_sentinel",
           "render_text", "main"]

MIN_PRIOR_SAMPLES = 2

# default relative noise bands by family character
_BAND_THROUGHPUT = 0.35   # container step noise measured at ~±25 %
_BAND_TIMING = 0.50       # compile/stall/plan latencies are spikier still


class Family:
    """One tracked metric family: where it lives in the payload, which
    direction is good, and how much noise to forgive."""

    def __init__(self, key, path=None, better="higher",
                 band=_BAND_THROUGHPUT, abs_floor=None, g_dependent=True,
                 contract_max=None, contract_min=None):
        self.key = key
        self.path = path or key
        self.better = better
        self.band = band
        # regressions below this absolute value are ignored (timing dust)
        self.abs_floor = abs_floor
        # compare only against priors at the same headline grid size
        self.g_dependent = g_dependent
        # absolute ceiling that flags REGARDLESS of the prior trajectory:
        # a documented contract breach is a finding even when every prior
        # round was already in breach (relative bands would hide the drift)
        self.contract_max = contract_max
        # absolute FLOOR for higher-is-better scientific families
        # (obs/quality.py): a model-quality metric dropping below it flags
        # regardless of the trajectory — a perf PR that silently degrades
        # graph recovery fails exactly like a throughput regression
        self.contract_min = contract_min

    def extract(self, payload):
        cur = payload
        for part in self.path.split("."):
            if not isinstance(cur, dict):
                return None
            cur = cur.get(part)
        return cur if isinstance(cur, (int, float)) \
            and not isinstance(cur, bool) else None


FAMILIES = [
    # production-path throughput (scanned / epoch-engine dispatches)
    Family("value"),
    Family("epoch_scan_wps"),
    Family("vs_baseline"),
    Family("mfu_pct"),
    Family("bf16.ratio_vs_f32"),
    # the promoted mixed-precision probe: the production
    # precision_mode="mixed" wps ratio vs f32 at the same grid point —
    # a kernel/precision regression fails the round like a throughput one.
    # sentinel_skips is judged as lower-is-better with an absolute floor:
    # an occasional skip is the guard working, a growing count is a cliff
    Family("mixed_precision.wps_ratio_vs_f32"),
    Family("mixed_precision.sentinel_skips", better="lower",
           band=_BAND_TIMING, abs_floor=3.0, g_dependent=False),
    # kernel-tiling autotune (ops/autotune.py): the winner's measured edge
    # over the default tile must not erode, and the per-round fresh search
    # must stay cheap (it runs on every fit's first encounter of a shape)
    Family("autotune.speedup_vs_default", band=_BAND_TIMING,
           g_dependent=False),
    Family("autotune.search_ms", better="lower", band=_BAND_TIMING,
           abs_floor=2000.0, g_dependent=False),
    Family("dead_lane_flops_saved_pct", band=_BAND_TIMING),
    # cost probes: lower is better, with absolute floors for timing dust
    Family("ckpt_stall_ms.async_ms", better="lower", band=_BAND_TIMING,
           abs_floor=50.0),
    Family("compile_cache.warm_compile_ms", better="lower",
           band=_BAND_TIMING, abs_floor=100.0),
    Family("compile_cache.warm_vs_cold_speedup", band=_BAND_TIMING),
    Family("remesh.plan_ms", better="lower", band=_BAND_TIMING,
           abs_floor=50.0, g_dependent=False),
    # the telemetry-spine contract (<= 2 %): wobble below the ceiling never
    # flags (abs_floor), a breach past it ALWAYS does (contract_max) — even
    # when the prior rounds were already in breach
    Family("obs_overhead_pct", better="lower", band=_BAND_TIMING,
           abs_floor=2.0, g_dependent=False, contract_max=2.0),
    # real-TPU Pallas prox parity error (rides the bench cache provenance):
    # 10x band — ulp-level jitter is documented, an order of magnitude is a
    # kernel bug
    Family("pallas_prox_max_abs_err", path="pallas_prox_check.max_abs_err",
           better="lower", band=9.0, abs_floor=1e-5, g_dependent=False),
    # device-memory observatory (obs/memory.py): the analytical
    # HBM model's error vs the measured watermark — null (skipped) on
    # backends without memory_stats; the ±20% acceptance contract is the
    # absolute ceiling, judged even when priors were already in breach
    Family("mem_model_err_pct", path="mem_model.abs_err_pct",
           better="lower", band=_BAND_TIMING, abs_floor=20.0,
           g_dependent=False, contract_max=20.0),
    # span -> Perfetto round-trip cost (obs/trace_export.py): a post-mortem
    # tool, but an O(n^2) regression in the exporter would make real run
    # dirs unexportable — keep it on the trajectory
    Family("trace_export.export_ms", better="lower", band=_BAND_TIMING,
           abs_floor=250.0, g_dependent=False),
    # fleet admission planner (the JAX package's fleet): the packed-vs-FIFO
    # mesh-slot utilization gain on the synthetic heterogeneous request mix
    # must not erode (the packing IS the service's perf claim), and the
    # host-only planning latency must stay queue-scan cheap
    Family("fleet.packed_utilization_pct", band=_BAND_TIMING,
           g_dependent=False),
    Family("fleet.utilization_gain", band=_BAND_TIMING, g_dependent=False),
    Family("fleet.plan_ms", better="lower", band=_BAND_TIMING,
           abs_floor=50.0, g_dependent=False),
    # fleet failure containment: healthy-sibling completion
    # latency with a poison co-tenant over without one, end-to-end through
    # real drains at the same bucket width. ~1.0 means the poison tenant
    # costs its siblings nothing; a creeping ratio means containment is
    # leaking wall-clock back into healthy requests
    Family("fleet_containment.latency_ratio", better="lower",
           band=_BAND_TIMING, g_dependent=False),
    # fleet trace export (obs/trace_export.py --fleet): the
    # ledger-join cost on a synthetic 50-request history — the whole-fleet
    # post-mortem must stay cheap enough to run on every incident
    Family("fleet_trace.export_ms", better="lower", band=_BAND_TIMING,
           abs_floor=250.0, g_dependent=False),
    # predictive scheduling policy (parallel/policy.py): the
    # simulated mixed-shape sweep makespan under the predictive policy over
    # the heuristic ladder — < 1.0 is the win the policy exists for, and
    # the absolute ceiling (contract_max) pins the acceptance bound even on
    # a trajectory whose priors were already in breach. decide_ms keeps the
    # pure-host decision pricing queue-scan cheap (it runs at every check
    # window and every worker claim cycle)
    Family("predictive_policy.makespan_ratio", better="lower",
           band=_BAND_TIMING, g_dependent=False, contract_max=1.0),
    Family("predictive_policy.decide_ms", better="lower", band=_BAND_TIMING,
           abs_floor=50.0, g_dependent=False),
    # SLO-driven autoscaling (fleet/autoscale.py): wall time
    # from the first windowed breach detection of a seeded submit storm to
    # the queue fully drained with the pool grown — the breach-absorption
    # latency the subsystem exists to bound. Storms drain real tiny fits,
    # so the floor forgives scheduler/compile jitter on small absolutes.
    # reject_eta_err_pct tracks the backpressure gate's reject-with-ETA
    # accuracy (|predicted wait - observed drain| as % of observed): a
    # creeping error means tenants are told wrong retry times
    # spatial mesh packing (parallel/packing.py + the worker's
    # gang loop): packed/serial wall-clock of two heterogeneous batches on
    # a simulated 4-device pool — the contract_max flags any round where
    # co-residency stops beating serial outright — and the busy
    # device-seconds pool utilization the packer achieved. Both legs run
    # real tiny drains, so the timing band forgives process-spawn jitter.
    Family("packing.makespan_ratio", better="lower", band=_BAND_TIMING,
           g_dependent=False, contract_max=1.0),
    Family("packing.utilization_pct", band=_BAND_TIMING,
           g_dependent=False),
    Family("autoscale.breach_to_recovery_s", better="lower",
           band=_BAND_TIMING, abs_floor=30.0, g_dependent=False),
    Family("autoscale.reject_eta_err_pct", better="lower",
           band=_BAND_TIMING, abs_floor=50.0, g_dependent=False),
    # scientific regression families (obs/quality.py): the
    # quality probe's graph-recovery score on the deterministic synthetic
    # sVAR grid fit, the top-k edge-set stability at the end of that fit,
    # and the per-check-window readout cost. The AUROC floor is absolute
    # (contract_min): a perf PR that silently degrades graph recovery
    # fails the sentinel exactly like a throughput regression, even on a
    # trajectory with no quality-bearing priors yet. Rounds predating the
    # probe simply lack the fields (skipped, never noise)
    Family("quality.synthetic_auroc", path="quality.final_auroc",
           band=_BAND_TIMING, g_dependent=False, contract_min=0.65),
    Family("quality.edge_stability", path="quality.edge_stability",
           band=_BAND_TIMING, g_dependent=False),
    Family("quality.overhead_pct", path="quality.overhead_pct",
           better="lower", band=_BAND_TIMING, abs_floor=2.0,
           g_dependent=False, contract_max=2.0),
    # streaming inference service (serve/): the
    # saturated-slot-table per-sample dispatch p99 (ingest->answer wall
    # clock; the abs_floor forgives sub-5ms scheduler dust), sustained
    # samples/s at full stream occupancy, and the churn-isolation pin —
    # isolation_ok is 1.0 iff co-resident lanes are byte-identical with
    # vs without a chaos storm; contract_min pins it as an acceptance
    # bound even on trajectories whose priors were already green
    Family("serve.p99_ms", path="serve.p99_ms", better="lower",
           band=_BAND_TIMING, abs_floor=5.0, g_dependent=False),
    Family("serve.samples_per_s", path="serve.samples_per_s",
           band=_BAND_TIMING, g_dependent=False),
    Family("serve.isolation_ok", path="serve.isolation_ok",
           band=_BAND_TIMING, g_dependent=False, contract_min=1.0),
    # elastic serve data plane: the 25%-occupancy leg's
    # structural dead-lane saving (forced occupancy ladder riding the min
    # rung — contract_min pins that the ladder actually shrinks; 10% is
    # far below the ~50% a healthy min-rung ride yields at capacity//4
    # streams, so it trips only on a ladder that stopped engaging), the
    # backlogged single-scan fusion drain throughput, and the
    # mixed-vs-f32 throughput ratio (<1 under CPU bf16 EMULATION — the
    # MXU speedup only shows on TPU hardware; the family tracks the
    # trajectory so a silently broken mixed path shows as a cliff, it is
    # not a speedup floor)
    Family("serve.dead_lane_flops_saved_pct",
           path="serve.dead_lane_flops_saved_pct", band=_BAND_TIMING,
           g_dependent=False, contract_min=10.0),
    Family("serve.fused_samples_per_s", path="serve.fused_samples_per_s",
           band=_BAND_TIMING, g_dependent=False),
    Family("serve.mixed_ratio_vs_f32", path="serve.mixed_ratio_vs_f32",
           band=_BAND_TIMING, g_dependent=False),
]


def _g_scaling_families(payload):
    """Dynamic per-G families for the scanned dispatch (wps_scan /
    epoch_scan only — see the module docstring's noise model for why the
    per-batch wps entries are exempt)."""
    out = []
    for g, entry in ((payload or {}).get("g_scaling") or {}).items():
        if isinstance(entry, dict):
            for field in ("wps_scan", "epoch_scan"):
                if isinstance(entry.get(field), (int, float)):
                    out.append(Family(f"g_scaling.{g}.{field}",
                                      g_dependent=False))
    return out


_ROUND_RE = re.compile(r"BENCH_r(\d+)\.json$")


def _payload_from_artifact(art):
    """The emitted bench payload inside one round artifact: the ``parsed``
    field, else the last parseable ``{"metric": ...}`` line recovered from
    ``tail`` (an artifact keeps a truncated tail, so recovery can fail — that
    round is then skipped, not fatal)."""
    if isinstance(art.get("parsed"), dict):
        return art["parsed"]
    for line in reversed(str(art.get("tail") or "").splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            payload = json.loads(line)
        except ValueError:
            continue
        if isinstance(payload, dict) and payload.get("metric"):
            return payload
    return None


def payload_samples(payload):
    """Comparable samples inside one round's payload: the headline, plus
    the CPU ``live_fallback`` leg a cached-TPU headline carries (so the CPU
    trajectory stays comparable across rounds where the real-TPU cache was
    the headline)."""
    if not isinstance(payload, dict):
        return []
    samples = [payload]
    fb = payload.get("live_fallback")
    if isinstance(fb, dict) and fb.get("metric"):
        samples.append(fb)
    return samples


NO_TRAJECTORY = "no port benchmark trajectory yet"


def load_trajectory(bench_dir):
    """All BENCH_r*.json rounds under ``bench_dir``, round-ordered:
    ``[{"round", "path", "payload"}]``; rounds whose payload cannot be
    recovered carry ``payload=None``. There is no default directory (the
    module docstring): ``None`` raises."""
    if not bench_dir:
        raise ValueError(f"{NO_TRAJECTORY}: name a --bench-dir holding the "
                         f"port's BENCH_r*.json rounds")
    rounds = []
    for path in glob.glob(os.path.join(bench_dir, "BENCH_r*.json")):
        m = _ROUND_RE.search(os.path.basename(path))
        if not m:
            continue
        try:
            with open(path) as f:
                art = json.load(f)
        except (OSError, ValueError):
            art = {}
        rounds.append({"round": int(m.group(1)), "path": path,
                       "payload": _payload_from_artifact(art)})
    rounds.sort(key=lambda r: r["round"])
    return rounds


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def _comparable(fam, current, sample):
    if sample.get("platform") != current.get("platform"):
        return False
    if fam.g_dependent and current.get("grid_points") is not None \
            and sample.get("grid_points") is not None \
            and sample["grid_points"] != current["grid_points"]:
        return False
    return True


def run_sentinel(current, trajectory=None, bench_dir=None, now=None):
    """Judge ``current`` (one bench payload dict) against the prior rounds.

    Returns the machine-readable sentinel block (``event="regression"``,
    validates against the registered schema). ``trajectory`` defaults to
    :func:`load_trajectory` of ``bench_dir``; the current round (matched by identical
    payload identity or the highest round whose payload IS ``current``) is
    never compared against itself.
    """
    now = time.time() if now is None else now
    trajectory = (load_trajectory(bench_dir) if trajectory is None
                  else trajectory)
    current_round = None
    prior_rounds = []
    for r in trajectory:
        if r["payload"] is current or (
                r["payload"] is not None and current is not None
                and r["payload"] == current):
            current_round = r["round"]
            continue
        prior_rounds.append(r)
    regressions, improvements, skipped = [], [], []
    checked = 0
    notes = [
        "bands absorb the documented ~±25% container dispatch noise "
        "(per-batch wps families exempt entirely); the ~1 ulp XLA "
        "width-rounding caveat is numerics-only and cannot move a timing "
        "family",
    ]
    if not isinstance(current, dict) or not current.get("metric"):
        notes.append("no usable current payload — nothing to judge")
        current = {}
    # judge EVERY leg of the current round: the headline, and — when the
    # headline is a replayed cached-TPU measurement — the fresh CPU
    # live_fallback leg too (otherwise a slowdown in the only measurement
    # this round actually ran would ship behind a byte-identical cache)
    legs = [("headline", current)]
    fb = current.get("live_fallback")
    if isinstance(fb, dict) and fb.get("metric"):
        legs.append(("live_fallback", fb))
    for leg_name, leg in legs:
        for fam in FAMILIES + _g_scaling_families(leg):
            cur = fam.extract(leg)
            if cur is None:
                continue
            if fam.contract_max is not None and cur > fam.contract_max:
                # absolute contract breach: judged against the documented
                # ceiling, not the (possibly already-breached) trajectory
                checked += 1
                regressions.append({
                    "metric": fam.key, "direction": fam.better,
                    "sample": leg_name, "current": cur,
                    "baseline_median": fam.contract_max,
                    "change_pct": round(
                        100.0 * (cur - fam.contract_max)
                        / fam.contract_max, 1),
                    "band_pct": 0.0, "contract": True, "priors": {}})
                continue
            if fam.contract_min is not None and cur < fam.contract_min:
                # scientific floor breach (obs/quality.py families): a
                # quality score under the documented floor is a finding
                # even with no prior trajectory to compare against
                checked += 1
                regressions.append({
                    "metric": fam.key, "direction": fam.better,
                    "sample": leg_name, "current": cur,
                    "baseline_median": fam.contract_min,
                    "change_pct": round(
                        100.0 * (cur - fam.contract_min)
                        / fam.contract_min, 1),
                    "band_pct": 0.0, "contract": True, "priors": {}})
                continue
            priors = {}
            for r in prior_rounds:
                for sample in payload_samples(r["payload"]):
                    if not _comparable(fam, leg, sample):
                        continue
                    v = fam.extract(sample)
                    if v is not None:
                        priors.setdefault(f"r{r['round']:02d}", v)
            if len(priors) < MIN_PRIOR_SAMPLES:
                skipped.append({"metric": fam.key, "sample": leg_name,
                                "reason":
                                f"{len(priors)} prior sample(s) "
                                f"< {MIN_PRIOR_SAMPLES}"})
                continue
            checked += 1
            vals = list(priors.values())
            med = _median(vals)
            if med == 0:
                skipped.append({"metric": fam.key, "sample": leg_name,
                                "reason": "zero baseline"})
                continue
            # widen the band to the priors' own spread: history noisier
            # than the default band raises the bar for a finding
            spread = (max(vals) - min(vals)) / abs(med)
            band = max(fam.band, spread)
            change = (cur - med) / abs(med)
            worse = (change < -band if fam.better == "higher"
                     else change > band)
            better = (change > band if fam.better == "higher"
                      else change < -band)
            if worse and fam.abs_floor is not None:
                # timing dust / contract floors: tiny values never flag
                bad_side = cur if fam.better == "lower" else med
                if bad_side < fam.abs_floor:
                    worse = False
            entry = {
                "metric": fam.key, "direction": fam.better,
                "sample": leg_name,
                "current": cur, "baseline_median": round(med, 6),
                "change_pct": round(100.0 * change, 1),
                "band_pct": round(100.0 * band, 1),
                "priors": priors,
            }
            if worse:
                regressions.append(entry)
            elif better:
                improvements.append(entry)
    block = {
        "event": "regression",
        "wall_time": now,
        "schema_version": _schema.SCHEMA_VERSION,
        "current_round": current_round,
        "rounds_compared": [f"r{r['round']:02d}" for r in prior_rounds
                            if r["payload"] is not None],
        "families_checked": checked,
        "regressions": regressions,
        "improvements": improvements,
        "skipped": skipped,
        "notes": notes,
        # the port shows no TPU evidence as its own
        "tpu_cache": None,
    }
    return block


def render_text(block):
    out = [f"regression sentinel: {block['families_checked']} family(ies) "
           f"judged against rounds "
           f"[{', '.join(block['rounds_compared']) or 'none'}]"]
    leg = lambda r: (f" [{r['sample']}]"
                     if r.get("sample") not in (None, "headline") else "")
    for r in block["regressions"]:
        out.append(f"  REGRESSION {r['metric']}{leg(r)}: {r['current']} vs "
                   f"median {r['baseline_median']} ({r['change_pct']:+.1f}% "
                   f"past the ±{r['band_pct']:.0f}% band)")
    for r in block["improvements"]:
        out.append(f"  improvement {r['metric']}{leg(r)}: {r['current']} vs "
                   f"median {r['baseline_median']} ({r['change_pct']:+.1f}%)")
    if not block["regressions"]:
        out.append("  clean: no family outside its noise band")
    tc = block.get("tpu_cache")
    if tc:
        out.append(f"  cached TPU evidence: {tc['value']} w/s on "
                   f"{tc.get('device')} measured {tc.get('measured_at')} "
                   f"({tc['file']}; pallas prox max err "
                   f"{tc.get('pallas_prox_max_abs_err')})")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m redcliff_tpu_torch.obs regress",
        description="Compare the newest BENCH_r*.json round against the "
                    "prior trajectory per metric family with noise bands.")
    ap.add_argument("--bench-dir", default=None,
                    help="directory holding the port's BENCH_r*.json "
                         "(required: the port has no default trajectory)")
    ap.add_argument("--current", default=None,
                    help="payload JSON to judge (a bench payload or a "
                         "round artifact with a 'parsed' field; default: "
                         "the highest round in --bench-dir)")
    ap.add_argument("--json", action="store_true",
                    help="print the sentinel block as JSON")
    args = ap.parse_args(argv)
    if not args.bench_dir:
        print(f"obs regress: {NO_TRAJECTORY} (the repository's "
              f"BENCH_r*.json are TPU runs of the JAX package); pass "
              f"--bench-dir", file=sys.stderr)
        return 2
    trajectory = load_trajectory(args.bench_dir)
    if args.current:
        try:
            with open(args.current) as f:
                cur = json.load(f)
        except (OSError, ValueError) as e:
            print(f"obs regress: cannot read --current: {e}",
                  file=sys.stderr)
            return 2
        if isinstance(cur, dict) and not cur.get("metric"):
            cur = _payload_from_artifact(cur)
        if not (isinstance(cur, dict) and cur.get("metric")):
            # exiting 0 here would make a CI gate pass forever while
            # judging nothing — unusable input is a hard error, like the
            # no---current path below
            print(f"obs regress: no bench payload recoverable from "
                  f"--current {args.current} (expected an emitted payload "
                  f"or a round artifact with a 'parsed' field)",
                  file=sys.stderr)
            return 2
    else:
        usable = [r for r in trajectory if r["payload"] is not None]
        if not usable:
            print("obs regress: no BENCH_r*.json round with a recoverable "
                  "payload — nothing to judge", file=sys.stderr)
            return 2
        cur = usable[-1]["payload"]
    block = run_sentinel(cur, trajectory=trajectory,
                         bench_dir=args.bench_dir)
    if args.json:
        json.dump(block, sys.stdout, indent=2, allow_nan=False)
        sys.stdout.write("\n")
    else:
        print(render_text(block))
    return 3 if block["regressions"] else 0
