"""Elastic grid scheduling: live-lane compaction and the bucket ladder
(the port's copy of ``parallel/compaction.py``).

A batched grid program has a fixed width: every step computes all G lanes
whether or not the ``active`` mask has already retired them. This module
owns the pure-host planning half; the grid engine (``parallel/grid.py``)
executes it:

* **Bucket ladder** (:func:`bucket_width`) — execution widths are drawn
  from a power-of-two ladder. Real lanes beyond the live count are padded
  with masked FILLER lanes (``active`` False from birth, ``orig_id`` -1),
  which never surface in results.
* **Compaction plan** (:func:`plan_compaction`) — at a check-window
  boundary, when the live-lane count drops below the next ladder rung, the
  surviving lanes' state is gathered into a compacted grid of the new
  width and point indices are remapped. Each surviving lane's update reads
  only its own state and the shared batch, so removing sibling lanes
  changes which program runs, never what a lane computes.
* **History expansion** (:func:`expand_history`) — per-epoch loss rows are
  recorded at execution width; this scatters them back to original point
  ids and carries retired lanes' last value forward (an inactive lane's
  parameters are frozen, so the uncompacted run recomputes the identical
  loss every epoch).

Results and failures are always reported under ORIGINAL point ids.

* **Serve rung** (:func:`serve_rung`) — the serving twin of the ladder:
  the slot table's dispatch width for the live lanes
  (``serve/service.py`` ``ServeLadder``).

numpy only.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "bucket_width",
    "next_pow2",
    "serve_rung",
    "ladder_widths",
    "plan_compaction",
    "assemble_plan",
    "unretired_frozen_rows",
    "expand_history",
    "CompactionPlan",
]


def next_pow2(n):
    """Smallest power of two >= max(n, 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def bucket_width(n_lanes, n_devices=1):
    """Execution width for ``n_lanes`` live lanes on an ``n_devices`` mesh.

    The ladder is powers of two, adjusted for mesh divisibility so the
    compacted grid always re-shards cleanly:

    - no mesh (``n_devices <= 1``): the next power of two;
    - width >= mesh: rounded up to a multiple of ``n_devices``;
    - width < mesh: kept when it divides ``n_devices``, otherwise rounded
      up to ``n_devices``.
    """
    b = next_pow2(n_lanes)
    n_devices = int(n_devices or 1)
    if n_devices <= 1:
        return b
    if b >= n_devices:
        return -(-b // n_devices) * n_devices
    return b if n_devices % b == 0 else n_devices


def ladder_widths(n_lanes, n_devices=1, max_width=None):
    """The bucket-ladder rungs from the width ``n_lanes`` requires up to
    ``max_width`` (default: 8x the base rung), ascending."""
    base = bucket_width(n_lanes, n_devices)
    if max_width is None:
        max_width = base * 8
    out = []
    w = base
    while w <= int(max_width):
        out.append(w)
        w = bucket_width(w + 1, n_devices)
    return out


def serve_rung(n_live, capacity, min_rung=1):
    """Slot-table dispatch width for ``n_live`` leased serve lanes.

    The serving twin of :func:`bucket_width`: the smallest power-of-two
    rung >= ``max(n_live, min_rung)``, clamped to ``capacity`` (the full
    table is always a legal rung even when capacity is not itself a power
    of two). The serve engine dispatches at this width and pads/slices its
    slot table at tick boundaries; ``min_rung`` is the churn floor — below
    it, saving another lane is not worth a cold program (serve/service.py
    sets 4)."""
    cap = max(int(capacity), 1)
    return min(next_pow2(max(int(n_live), int(min_rung), 1)), cap)


class CompactionPlan:
    """Host-side recipe for one compaction event.

    Attributes:
      sel: (new_width,) int32 — exec-row gather indices into the CURRENT
        grid (surviving lanes first, then filler rows replicating the first
        survivor so every gathered row holds finite, valid state).
      orig_ids: (new_width,) int32 — original point id per new exec row,
        -1 for filler.
      active: (new_width,) bool — True for the surviving (live) rows only.
      retire_rows: (k,) int32 — CURRENT exec rows holding real, inactive,
        not-yet-retired lanes whose frozen results must be gathered to host
        before their rows are dropped.
      retire_ids: (k,) int32 — those rows' original point ids.
    """

    def __init__(self, sel, orig_ids, active, retire_rows, retire_ids):
        self.sel = sel
        self.orig_ids = orig_ids
        self.active = active
        self.retire_rows = retire_rows
        self.retire_ids = retire_ids

    @property
    def new_width(self):
        return int(self.sel.shape[0])


def unretired_frozen_rows(active, orig_ids, retired_ids):
    """Exec rows holding real, inactive, NOT-yet-retired lanes — the lanes
    whose frozen results a plan must gather to host before their rows
    drop."""
    already = set(int(i) for i in retired_ids)
    return np.asarray(
        [r for r in np.flatnonzero(~active & (orig_ids >= 0))
         if int(orig_ids[r]) not in already], np.int32)


def assemble_plan(orig_ids, keep_rows, keep_active, fill_row, new_w,
                  retire_rows):
    """Build a :class:`CompactionPlan` from a keep-row selection: kept rows
    first (their active flags preserved), then filler rows replicating
    ``fill_row``, which must hold finite, valid state (filler lanes run
    real masked math)."""
    orig_ids = np.asarray(orig_ids, np.int32)
    keep_rows = np.asarray(keep_rows, np.int32)
    retire_rows = np.asarray(retire_rows, np.int32)
    pad = int(new_w) - keep_rows.size
    sel = np.concatenate([keep_rows, np.full((pad,), fill_row, np.int32)])
    new_ids = np.concatenate(
        [orig_ids[keep_rows], np.full((pad,), -1, np.int32)])
    new_active = np.zeros((int(new_w),), bool)
    new_active[: keep_rows.size] = keep_active
    return CompactionPlan(sel, new_ids, new_active, retire_rows,
                          orig_ids[retire_rows].astype(np.int32))


def plan_compaction(active, orig_ids, retired_ids, n_devices=1):
    """Plan a compaction, or return None when the current width is already
    the right bucket.

    ``active``: (G_exec,) bool host mask; ``orig_ids``: (G_exec,) int32
    original point id per exec row (-1 = filler); ``retired_ids``: ids
    whose results were already captured by an earlier compaction (their
    rows are gone). Lanes are kept in exec-row order, so surviving lanes'
    relative order is stable across compactions.
    """
    active = np.asarray(active, bool)
    orig_ids = np.asarray(orig_ids, np.int32)
    live_rows = np.flatnonzero(active & (orig_ids >= 0)).astype(np.int32)
    n_live = int(live_rows.size)
    if n_live == 0:
        return None  # nothing to run; the fit's own exit paths handle this
    new_w = bucket_width(n_live, n_devices)
    if new_w >= orig_ids.size:
        return None
    return assemble_plan(
        orig_ids, live_rows, True, live_rows[0], new_w,
        unretired_frozen_rows(active, orig_ids, retired_ids))


def expand_history(rows, row_eras, eras, n_points):
    """Scatter exec-width per-epoch rows back to (epochs, n_points) under
    original point ids, carrying retired lanes' last value forward.

    ``rows``: per-epoch host arrays — exec width (era-indexed) or already
    full width (``row_eras`` entry -1, e.g. restored from a checkpoint that
    stored expanded history). ``eras``: list of orig_ids arrays, one per
    compaction era. Filler entries (orig_id -1) are dropped.
    """
    carry = np.full((int(n_points),), np.nan, np.float32)
    out = []
    for row, era in zip(rows, row_eras):
        row = np.asarray(row, np.float32)
        if era < 0:
            carry = row.copy()
        else:
            ids = eras[era]
            real = ids >= 0
            carry[ids[real]] = row[real]
        out.append(carry.copy())
    return np.stack(out) if out else np.zeros((0, int(n_points)), np.float32)
