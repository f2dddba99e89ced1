"""Spatial mesh packing: disjoint sub-mesh slots over one device pool.

The fleet v2 tentpole (ROADMAP item 2): one worker runs CONCURRENT batches
on disjoint power-of-two device groups of the same pool instead of parking
the whole mesh on one fit at a time. This module is the pure decision /
bookkeeping layer:

* :class:`SlotTable` — a buddy-style allocator over the pool's largest
  power-of-two prefix. Slots are aligned device intervals ``{"lo", "width"}``
  (``lo % width == 0``), so any two live slots are disjoint by construction
  and a slot freed at a check-window boundary re-coalesces for free;
* :func:`devices_for` — the sub-mesh width a planned batch occupies, riding
  the bucket ladder (an admitted ``g_bucket`` of lanes runs on
  ``min(g_bucket, pool)`` devices — the same G' < n_devices sub-mesh case
  ``compaction.bucket_width`` already prices);
* :func:`price_packing` — the predictive packing decision: simulate the
  plan's batches draining through the slot table (first-fit in plan order,
  co-resident HBM never over ``budget_bytes``) and compare the packed
  makespan against the serial worker's ``sum(eta)``. The decision record is
  what the planner emits as a schema-registered ``packing`` event. With an
  EMPTY cost store (any batch unpriced) the verdict is ``serial`` — the
  worker's behavior stays bit-identical to the pre-packing heuristic, the
  same fallback discipline as parallel/policy.py;
* :func:`publish_state` / :func:`load_state` — the worker publishes its
  live slot occupancy to ``<root>/packing.json`` so the autoscaler's
  ``predicted_drain`` can divide the queue ETA by the real packing width
  instead of assuming one batch at a time.

Gating rides ``REDCLIFF_FLEET_PACKING``: ``0``/unset = off (the serial
worker, unchanged), ``1``/``auto`` = pack only when the priced makespan
beats serial, ``force`` = always pack (bench/CI legs that must exercise
concurrency without warming a cost store first).

stdlib only, no torch and no jax (obs/schema.py ``--check`` enforces
it): packing decisions run in the worker control process, which must never
initialize a backend. The sub-mesh construction lives in
``fleet/run_batch.py``: a packed batch meshes over its slot ``[lo, lo +
width)`` of ``parallel.remesh.visible_devices()``.

Port of ``redcliff_tpu/parallel/packing.py``, a copy: it computes and
writes what the JAX module does.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["SlotTable", "devices_for", "price_packing", "packing_mode",
           "packing_enabled", "publish_state", "load_state", "ENV_PACKING",
           "STATE_FILE", "STATE_FRESH_S"]

ENV_PACKING = "REDCLIFF_FLEET_PACKING"

# worker-published slot occupancy (autoscaler input); stale files are
# ignored the same way autoscale.json freshness works
STATE_FILE = "packing.json"
STATE_FRESH_S = 120.0


def packing_mode(env=None):
    """The packing gate: ``"off"`` (default), ``"auto"`` (pack only on a
    priced makespan win), or ``"force"`` (always pack — bench/CI legs)."""
    raw = (os.environ.get(ENV_PACKING, "") if env is None else env)
    raw = str(raw).strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return "off"
    if raw in ("force", "always", "2"):
        return "force"
    return "auto"


def packing_enabled(env=None):
    return packing_mode(env) != "off"


def largest_pow2(n):
    """Largest power of two <= n (0 for n < 1)."""
    n = int(n)
    return 1 << (n.bit_length() - 1) if n >= 1 else 0


def devices_for(g_bucket, n_devices):
    """Sub-mesh width (device count) a batch admitted at ``g_bucket`` lanes
    occupies on an ``n_devices`` pool: the bucket width itself while it fits
    (bucket widths are ladder powers of two, so the slot stays aligned),
    else the pool's whole packable region — the G' < n_devices sub-mesh
    case from parallel/compaction.py, now packable side by side."""
    pool = largest_pow2(n_devices)
    if pool <= 0:
        return 1
    return min(max(int(g_bucket or 1), 1), pool)


class SlotTable:
    """Aligned power-of-two slot allocator over a device pool.

    The packable region is the largest power-of-two prefix of the pool
    (device ids are stable — parallel/remesh.py ``visible_devices`` — so
    slot ``{"lo": 2, "width": 2}`` means the same two devices to every
    worker and every reclaim). Alignment (``lo % width == 0``) makes slots
    buddy-disjoint: no two live slots ever overlap, and :meth:`reserve`
    lets a reclaiming worker re-occupy the EXACT slot a dead worker's
    batch.json recorded."""

    def __init__(self, n_devices):
        self.n_devices = max(int(n_devices), 1)
        self.pool = largest_pow2(self.n_devices)
        self._busy = {}  # lo -> width

    def _overlaps(self, lo, width):
        hi = lo + width
        return any(not (hi <= b_lo or lo >= b_lo + b_w)
                   for b_lo, b_w in self._busy.items())

    def alloc(self, width):
        """Claim the lowest free aligned slot of ``width`` devices (width
        is clamped to a power of two within the pool). None when no slot of
        that width is free."""
        width = largest_pow2(min(max(int(width), 1), self.pool))
        for lo in range(0, self.pool, width):
            if not self._overlaps(lo, width):
                self._busy[lo] = width
                return {"lo": lo, "width": width}
        return None

    def reserve(self, slot):
        """Re-occupy an exact recorded slot (reclaim path). False when the
        slot is malformed, out of range, or overlaps a live slot."""
        try:
            lo, width = int(slot["lo"]), int(slot["width"])
        except (TypeError, KeyError, ValueError):
            return False
        if width < 1 or lo < 0 or lo % width or lo + width > self.pool:
            return False
        if self._overlaps(lo, width):
            return False
        self._busy[lo] = width
        return True

    def free(self, slot):
        """Release a slot (idempotent — double-free at settle races is a
        no-op, first-writer-wins like every fleet terminal record)."""
        try:
            self._busy.pop(int(slot["lo"]), None)
        except (TypeError, KeyError, ValueError):
            pass

    def free_widths(self):
        """Descending widths still allocatable — the planner is called
        with ``n_devices=max(free_widths())`` so its bucket ladder prices
        the sub-mesh the claim will actually land on."""
        out = set()
        width = self.pool
        while width >= 1:
            if any(not self._overlaps(lo, width)
                   for lo in range(0, self.pool, width)):
                out.add(width)
            width //= 2
        return sorted(out, reverse=True)

    def occupancy(self):
        busy = sum(self._busy.values())
        return {
            "n_devices": self.n_devices,
            "pool": self.pool,
            "busy_devices": busy,
            "free_devices": self.pool - busy,
            "slots": [{"lo": lo, "width": w}
                      for lo, w in sorted(self._busy.items())],
            "utilization_pct": (round(100.0 * busy / self.pool, 1)
                                if self.pool else None),
        }


def price_packing(batches, n_devices, budget_bytes=None):
    """Predictive packing decision over a plan's ordered batch views.

    Simulates the batches draining through a :class:`SlotTable` — first-fit
    in plan order at :func:`devices_for` widths, a batch co-residing only
    while the co-resident ``predicted_bytes`` sum stays within
    ``budget_bytes`` (the per-lane HBM model; zero headroom violations
    by construction) — and prices the packed makespan against the serial
    worker's ``sum(eta_s)``.

    Returns a decision record: ``{"decision": "packed"|"serial", "reason",
    "makespan_s", "serial_s", "makespan_ratio", "n_devices", "pool",
    "assignments": [{batch_id, lo, width, start_s}], "headroom_violations":
    0}``. The verdict is ``serial`` whenever any batch is unpriced (empty
    cost store — the bit-identical heuristic fallback), the pool has no
    room for two slots, or the simulated packing does not beat serial."""
    batches = list(batches or ())
    pool = largest_pow2(n_devices)
    base = {"n_devices": int(n_devices or 0), "pool": pool,
            "headroom_violations": 0}
    if len(batches) < 2:
        return dict(base, decision="serial", reason="single_batch",
                    makespan_s=None, serial_s=None, makespan_ratio=None,
                    assignments=[])
    if pool < 2:
        return dict(base, decision="serial", reason="pool_too_small",
                    makespan_s=None, serial_s=None, makespan_ratio=None,
                    assignments=[])
    etas = [b.get("eta_s") for b in batches]
    if any(not isinstance(e, (int, float)) or e <= 0 for e in etas):
        # empty/partial cost store: no pricing evidence — fall back to the
        # serial heuristic bit-identically (parallel/policy.py discipline)
        return dict(base, decision="serial", reason="unpriced",
                    makespan_s=None, serial_s=None, makespan_ratio=None,
                    assignments=[])
    serial_s = float(sum(etas))

    # event-driven simulation: running = [(end_s, slot, bytes)]
    table = SlotTable(n_devices)
    queue = list(zip(batches, etas))
    running, assignments = [], []
    now = 0.0
    resident_bytes = 0
    makespan = 0.0
    while queue or running:
        progressed = True
        while progressed and queue:
            progressed = False
            for i, (b, eta) in enumerate(queue):
                width = devices_for(b.get("g_bucket"), n_devices)
                pb = b.get("predicted_bytes")
                if budget_bytes is not None:
                    if pb is None and running:
                        continue  # no memory evidence: never co-resident
                    if pb is not None and running \
                            and resident_bytes + pb > budget_bytes:
                        continue
                slot = table.alloc(width)
                if slot is None:
                    continue
                running.append((now + float(eta), slot, pb or 0))
                resident_bytes += pb or 0
                assignments.append({"batch_id": b.get("batch_id"),
                                    "lo": slot["lo"],
                                    "width": slot["width"],
                                    "start_s": round(now, 3)})
                del queue[i]
                progressed = True
                break
        if not running:
            # nothing placeable (shouldn't happen: a solo batch always
            # fits the admission gate) — price it serially and bail
            return dict(base, decision="serial", reason="unpackable",
                        makespan_s=None, serial_s=round(serial_s, 3),
                        makespan_ratio=None, assignments=[])
        running.sort(key=lambda t: t[0])
        end, slot, pb = running.pop(0)
        now = makespan = end
        table.free(slot)
        resident_bytes -= pb

    ratio = makespan / serial_s if serial_s > 0 else None
    packed = ratio is not None and ratio < 1.0 \
        and any(a["width"] < pool for a in assignments)
    return dict(base,
                decision="packed" if packed else "serial",
                reason="priced" if packed else "no_predicted_win",
                makespan_s=round(makespan, 3),
                serial_s=round(serial_s, 3),
                makespan_ratio=(round(ratio, 4) if ratio is not None
                                else None),
                assignments=assignments)


def publish_state(root, occupancy, concurrent_batches=0, now=None):
    """Atomically publish the worker's live slot occupancy to
    ``<root>/packing.json`` — the autoscaler's slot-awareness input
    (``predicted_drain`` divides the serial queue ETA by the published
    packing width) and an ``obs watch``/``fleet status`` surface."""
    state = dict(occupancy or {})
    state["concurrent_batches"] = int(concurrent_batches)
    state["updated_at"] = float(time.time() if now is None else now)
    path = os.path.join(str(root), STATE_FILE)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(state, f, allow_nan=False)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_state(root, now=None, fresh_s=STATE_FRESH_S):
    """The live published packing state, or None (missing, corrupt, or
    stale past ``fresh_s`` — a dead packed worker must not keep scaling
    decisions slot-optimistic forever)."""
    path = os.path.join(str(root), STATE_FILE)
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(state, dict):
        return None
    age = (time.time() if now is None else now) \
        - float(state.get("updated_at") or 0.0)
    if age > fresh_s:
        return None
    return state
