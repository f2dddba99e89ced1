"""Grid scheduling policy: the decision half of the engine/policy split
(the port's copy of ``parallel/policy.py``).

``parallel/grid.py`` is the grid EXECUTION ENGINE. This module owns the
scheduling decisions the engine consults but never makes itself:

* which execution width a grid runs at (:meth:`GridSchedulingPolicy.
  initial_width`) — the power-of-two bucket ladder
  (``parallel/compaction.py``) or the exact width when bucketing is off;
* when live lanes compact down the ladder
  (:meth:`GridSchedulingPolicy.compaction_plan`), at check windows;
* which lanes a wall-clock budget evicts and when the whole grid stops
  (:meth:`GridSchedulingPolicy.lane_evictions` /
  :meth:`GridSchedulingPolicy.grid_deadline_hit`).

Every method is pure host arithmetic on numbers the engine already holds.
:class:`PredictiveSchedulingPolicy` (widths and compactions priced by the
learned cost model of ``obs/costmodel.py``) needs that cost model, which
the port does not have yet: constructing it raises.

numpy only.
"""
from __future__ import annotations

import numpy as np

from redcliff_tpu_torch.parallel import compaction

__all__ = ["GridSchedulingPolicy", "PredictiveSchedulingPolicy"]


class GridSchedulingPolicy:
    """Bucket-ladder scheduling policy with check-window compaction.

    ``g_bucket``: draw execution widths from the power-of-two bucket ladder,
    padding with masked filler lanes (off: exact width). ``compaction``:
    gather surviving lanes down the ladder at check-window boundaries. The
    port's grid runs in one process on one device; the JAX policy's mesh
    and multi-process arguments wait for the mesh (ROADMAP queue 1, item
    15).
    """

    def __init__(self, g_bucket=True, compaction=True):
        self.g_bucket = bool(g_bucket)
        self.compaction = bool(compaction)

    @classmethod
    def from_train_config(cls, train_config):
        """The policy a train config's elastic-scheduling knobs select."""
        return cls(g_bucket=getattr(train_config, "g_bucket", True),
                   compaction=getattr(train_config, "compaction", True))

    # ------------------------------------------------------------------
    # width decisions
    # ------------------------------------------------------------------
    def initial_width(self, g_real):
        """Execution width for a fresh ``g_real``-point grid on one device:
        the bucket-ladder width (``g_bucket``), or the exact width."""
        return compaction.bucket_width(g_real) if self.g_bucket else g_real

    # ------------------------------------------------------------------
    # check-window compaction decision
    # ------------------------------------------------------------------
    def compaction_plan(self, active_host, orig_ids, retired_ids):
        """Plan a live-lane compaction for this check window, or None (the
        current width is already the right bucket, or compaction is
        disabled)."""
        if not self.compaction:
            return None
        return compaction.plan_compaction(active_host, orig_ids, retired_ids,
                                          1)

    # ------------------------------------------------------------------
    # wall-clock deadline decisions
    # ------------------------------------------------------------------
    @staticmethod
    def lane_evictions(lane_deadline, dl_done, elapsed):
        """Boolean mask of execution lanes whose per-lane budget expired
        this epoch (excluding already-evicted ones), or None when there is
        nothing to decide (no per-lane deadlines / no clock this epoch)."""
        if lane_deadline is None or elapsed is None:
            return None
        return np.logical_and(lane_deadline < elapsed,
                              np.logical_not(dl_done))

    @staticmethod
    def grid_deadline_hit(grid_deadline_s, elapsed):
        """Whether the whole-grid budget is spent as of ``elapsed``."""
        return bool(grid_deadline_s and elapsed is not None
                    and elapsed > grid_deadline_s)


class PredictiveSchedulingPolicy(GridSchedulingPolicy):
    """Widths and compaction points priced by the learned cost model: not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PredictiveSchedulingPolicy needs the learned cost model "
            "(obs/costmodel.py), which is not ported yet (ROADMAP queue 1, "
            "item 11); use GridSchedulingPolicy")
