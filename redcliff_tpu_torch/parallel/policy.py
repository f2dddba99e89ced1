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

import os

import numpy as np

from redcliff_tpu_torch.parallel import compaction

__all__ = ["GridSchedulingPolicy", "PredictiveSchedulingPolicy",
           "ENV_PREDICTIVE", "ENV_POLICY_MAX_WIDTH", "predictive_enabled"]

# the predictive-scheduling switch: "1" lets PredictiveSchedulingPolicy
# price widths and compactions from the learned cost model; off by default
# (an empty store gives the heuristic stream either way, but an accumulated
# store must never move a pinned decision stream uninvited)
ENV_PREDICTIVE = "REDCLIFF_PREDICTIVE"

# a ceiling on the predictive initial-width choice, for callers whose
# admission was priced at a specific width
ENV_POLICY_MAX_WIDTH = "REDCLIFF_POLICY_MAX_WIDTH"


def predictive_enabled(env=None):
    """Whether predictive scheduling is armed (``REDCLIFF_PREDICTIVE``)."""
    val = (env if env is not None
           else os.environ.get(ENV_PREDICTIVE, "0"))
    return str(val).strip().lower() not in ("", "0", "false", "off")


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
    def initial_width(self, g_real, n_devices=1):
        """Execution width for a fresh ``g_real``-point grid on one device:
        the bucket-ladder width (``g_bucket``), or the exact width."""
        return compaction.bucket_width(g_real) if self.g_bucket else g_real

    def ladder(self, n_lanes, n_devices=1, max_width=None):
        """The candidate bucket-ladder rungs for ``n_lanes`` lanes."""
        return compaction.ladder_widths(n_lanes, n_devices,
                                        max_width=max_width)

    # ------------------------------------------------------------------
    # check-window compaction decision
    # ------------------------------------------------------------------
    def compaction_plan(self, active_host, orig_ids, retired_ids,
                        epochs_remaining=None):
        """Plan a live-lane compaction for this check window, or None (the
        current width is already the right bucket, or compaction is
        disabled). ``epochs_remaining`` is the predictive subclass's
        pricing input; the heuristic ignores it."""
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
    """Cost-model-steered scheduling: widths and compaction points chosen
    by predicted wall clock (module docstring for the rules and the
    fallback contract).

    ``cost_model`` is a read-side :class:`~redcliff_tpu_torch.obs.costmodel
    .CostModel` (or None: the pure heuristic); ``shape_key`` / ``platform``
    / ``precision`` name this fit's cost buckets; ``epochs`` is the planned
    epoch budget (initial-width pricing); ``gather_ms`` is the charged host
    cost of one compaction. ``warm(width) -> bool``, when given, says
    whether moving to ``width`` needs no capture (the grid: its epoch
    engine holds that width's programs, or the fit's stream captures
    nothing); without it the store's compile evidence answers.

    Every consulted decision is stashed for the engine to log as a
    ``policy`` event; :meth:`take_decision` hands it over exactly once.
    """

    def __init__(self, g_bucket=True, compaction=True, cost_model=None,
                 shape_key=None, platform=None, precision="f32",
                 epochs=None, gather_ms=250.0, max_width=None, warm=None):
        super().__init__(g_bucket=g_bucket, compaction=compaction)
        self.cost_model = cost_model
        self.shape_key = shape_key
        self.platform = platform
        self.precision = precision
        self.epochs = int(epochs) if epochs else None
        self.gather_ms = float(gather_ms)
        self.max_width = int(max_width) if max_width else None
        self.warm = warm
        self._last_decision = None

    def take_decision(self):
        """The decision record of the LAST consulted width/compaction call,
        exactly once (None when nothing was decided since the last take)."""
        dec, self._last_decision = self._last_decision, None
        return dec

    # pricing primitives (None = no usable prior -> heuristic fallback)
    def _epoch_ms(self, width):
        if self.cost_model is None or not self.shape_key:
            return None
        return self.cost_model.predict_epoch_ms(
            self.shape_key, width, platform=self.platform,
            precision=self.precision)

    def _compile_ms(self, width):
        if self.cost_model is None or not self.shape_key:
            return None
        return self.cost_model.predict_compile_ms(
            self.shape_key, width, platform=self.platform,
            precision=self.precision)

    def _warm(self, width):
        """Whether moving to ``width`` pays no capture."""
        if self.warm is not None:
            return bool(self.warm(width))
        return bool(self.cost_model is not None and self.shape_key
                    and self.cost_model.compile_warm(
                        self.shape_key, width, platform=self.platform,
                        precision=self.precision))

    def _move_cost_ms(self, width):
        """Predicted cost of first-touching ``width``'s programs plus the
        compaction gather, or None (cold with no capture prior)."""
        if self._warm(width):
            return self.gather_ms
        cm = self._compile_ms(width)
        return None if cm is None else cm + self.gather_ms

    def initial_width(self, g_real, n_devices=1):
        """Cheapest-priced ladder rung for a fresh grid; the heuristic base
        rung whenever the base rung itself cannot be priced (fallback
        contract) or no rung beats it strictly."""
        base = super().initial_width(g_real, n_devices)
        self._last_decision = None
        if not self.g_bucket or self.cost_model is None \
                or not self.epochs or not self.shape_key:
            return base
        n_dev = int(n_devices or 1)
        cap = base * 4 if self.max_width is None \
            else min(base * 4, self.max_width)
        priced = {}
        for w in compaction.ladder_widths(g_real, n_dev, max_width=cap):
            em = self._epoch_ms(w)
            if em is None:
                continue
            compile_ms = 0.0 if self._warm(w) else self._compile_ms(w)
            if compile_ms is None:
                continue  # cold with no capture prior: unpriceable rung
            priced[w] = em * self.epochs + compile_ms
        dec = {"kind": "initial_width", "heuristic_width": base,
               "epochs": self.epochs}
        if base not in priced:
            self._last_decision = dict(dec, action="fallback",
                                       chosen_width=base, fallback=True)
            return base
        chosen = min(priced, key=lambda w: (priced[w], w))
        if not priced[chosen] < priced[base]:
            chosen = base  # strict improvement only: ties keep the ladder
        self._last_decision = dict(
            dec, action=("widen" if chosen != base else "keep"),
            chosen_width=chosen, fallback=False,
            total_ms=round(priced[chosen], 3),
            heuristic_ms=round(priced[base], 3),
            saving_ms=round(priced[base] - priced[chosen], 3))
        return chosen

    def compaction_plan(self, active_host, orig_ids, retired_ids,
                        epochs_remaining=None):
        """The heuristic plan, priced: compact only when the predicted
        saving over the surviving epochs exceeds the predicted capture +
        gather cost of moving; hold (return None) otherwise. Unpriceable
        inputs fall back bit-identically to the heuristic."""
        plan = super().compaction_plan(active_host, orig_ids, retired_ids)
        self._last_decision = None
        if plan is None:
            return None
        from_w = int(np.asarray(orig_ids).size)
        to_w = plan.new_width
        dec = {"kind": "compaction", "from_width": from_w, "to_width": to_w,
               "epochs_remaining": epochs_remaining}
        if self.cost_model is None:
            return plan  # pure heuristic policy instance: nothing to record
        cur = self._epoch_ms(from_w)
        new = self._epoch_ms(to_w)
        cost = self._move_cost_ms(to_w)
        if cur is None or new is None or cost is None \
                or epochs_remaining is None:
            self._last_decision = dict(dec, action="compact", fallback=True)
            return plan
        saving = (cur - new) * max(int(epochs_remaining), 0)
        dec.update(fallback=False, saving_ms=round(saving, 3),
                   compile_ms=round(cost - self.gather_ms, 3),
                   gather_ms=self.gather_ms)
        if saving > cost:
            self._last_decision = dict(dec, action="compact")
            return plan
        self._last_decision = dict(dec, action="hold")
        return None

    @staticmethod
    def compile_order(programs, cost_model=None, platform=None):
        """Order first-touch program descriptors so the longest predicted
        cold compile (capture) starts first and warm or unpriceable ones
        keep their given order after. ``programs``: dicts carrying either
        ``cold_compile_ms`` (0 = warm, > 0 = predicted, None =
        unpriceable), used as is, or ``shape_key`` / ``g_bucket`` /
        ``precision`` priced against ``cost_model``. Returns indices into
        ``programs``."""
        cold = []
        rest = []
        for i, p in enumerate(programs):
            if "cold_compile_ms" in p:
                ms = p["cold_compile_ms"]
                ms = (float(ms) if isinstance(ms, (int, float)) and ms > 0
                      else None)
            elif cost_model is not None and p.get("shape_key"):
                ms = None
                prec = p.get("precision") or "f32"
                if not cost_model.compile_warm(
                        p["shape_key"], p.get("g_bucket") or 0,
                        platform=platform, precision=prec):
                    ms = cost_model.predict_compile_ms(
                        p["shape_key"], p.get("g_bucket") or 0,
                        platform=platform, precision=prec)
            else:
                ms = None
            if ms is not None:
                cold.append((-float(ms), i))
            else:
                rest.append(i)
        return [i for _, i in sorted(cold)] + rest
