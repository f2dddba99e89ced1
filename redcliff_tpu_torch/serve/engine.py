"""Slot-table inference engine: O(1) cached-state advance per sample
(port of ``serve/engine.py``).

A slot table of ``capacity`` lanes, each owning the cached embedder state of
one subscriber stream: a device-resident ring buffer of that stream's last
``embed_lag`` samples. One tick moves the whole table: one host-to-device
copy of the tick's arrivals, a ring scatter, a ring-ordered gather, the
embedder on every lane, and the per-lane graph blend through the factor-mix
kernel (:func:`~redcliff_tpu_torch.ops.factor_mix.graph_mix`). The outputs
come back to the host in one copy, as numpy.

The port updates the ring state in place (the JAX engine rebuilds it each
tick): the engine owns its state tensors and nothing else holds them.

**Occupancy ladder.** The table's resident ``width`` rides the pow2 rungs
of :func:`~redcliff_tpu_torch.parallel.compaction.serve_rung` (the
service's ``ServeLadder`` decides); :meth:`resize` moves between rungs at
tick boundaries: grow zero-pads fresh rows (zero is the reset state),
shrink slices rows off the top. ``is_cold(width, depth)`` reports whether
a (width, fuse depth) pair has not been dispatched since load or the last
demotion — the ladder's pricing input, kept as in the JAX engine, where a
cold pair compiles a program; the port runs eagerly and compiles nothing.

**Tick fusion.** :meth:`step_fused` advances every lane through up to F
backlogged samples in one call: F single-tick advances in order on the
ring state, so element f equals the f-th sequential :meth:`step`.

**Mixed precision.** ``precision_mode="mixed"`` runs the embedder's
contractions on bf16-rounded operands with f32 sums
(``utils/precision.py``) and blends the graphs through the bf16 form of
the factor-mix kernel (:func:`~redcliff_tpu_torch.ops.factor_mix.
graph_mix_bf16`): the K static graphs are copied to bf16 once at load,
the f32 scores are rounded to bf16 inside the blend's one launch, and the
ring, the state and the outputs stay f32. :meth:`demote` is the poisoned-lane-storm
sentinel's lever: back to the f32 ops and the f32 graphs (kept since
load); the rings are f32 already, so only the ops change.

Isolation: ring scatter, gather and graph blend are row-independent along
the slot axis. Non-finite samples are detected on the device and never
written into a ring: the lane latches ``poisoned`` and the sample is
discarded. One exception is inherited from the JAX package on purpose: a
DGCNN embedder normalizes its input features with statistics over the
whole batch, which here is the slot table, so with a DGCNN embedder a
lane's scores depend on the other lanes' windows.

Graph readouts: the per-factor GC matrices of the fixed readout modes are
params-only, so :func:`obs.quality.make_summary_fn` computes them once at
load and each sample's graph is the blend of those K graphs by its scores.
"""
from __future__ import annotations

import numpy as np
import torch

from redcliff_tpu_torch.obs.costmodel import platform_label
from redcliff_tpu_torch.ops.factor_mix import graph_mix
from redcliff_tpu_torch.utils.precision import (check_precision_mode,
                                                matmul_precision_ctx,
                                                resolve_device,
                                                resolve_matmul_precision)

__all__ = ["StreamEngine"]

_STATE_DTYPES = {"window": torch.float32, "pos": torch.int32,
                 "filled": torch.int32, "poisoned": torch.bool}


class StreamEngine:
    """Elastic slot table over a fitted REDCLIFF-S model.

    ``step``/``step_fused`` are the hot paths: one call per tick, all
    resident lanes at once, at the current rung ``width <= capacity``.
    State lives on the device between ticks; ``export_state``/
    ``import_state`` round-trip it through numpy for the drain checkpoint
    (``import_state`` re-packs lanes across rung geometries given a
    ``slot_map``).
    """

    def __init__(self, model, params, capacity, precision_mode="f32",
                 device=None):
        from redcliff_tpu_torch.obs import quality as _quality

        cfg = model.config
        self.device = resolve_device(device)
        self.model = model
        self.capacity = int(capacity)
        self.num_chans = int(cfg.num_chans)
        self.num_factors = int(cfg.num_factors)
        self.window_len = int(cfg.embed_lag)
        self.params = params
        self.platform = platform_label(self.device)
        self.precision_mode = check_precision_mode(precision_mode)
        self.demoted = False
        self._matmul = resolve_matmul_precision(self.precision_mode)

        # static per-factor GC graphs, params-only for the fixed readout
        # modes readout_mode forces: one summary call at load covers every
        # future sample (the probe window only feeds the discarded entropy)
        probe = torch.zeros((1, int(cfg.max_lag), self.num_chans),
                            dtype=torch.float32, device=self.device)
        with torch.no_grad():
            summ = _quality.make_summary_fn(model)(params, probe)
        self.static_gc = summ["gc"].to(torch.float32).contiguous()
        # the mixed blend's operand, made once; the f32 graphs stay for
        # demotion
        self._static_gc_bf16 = (self.static_gc.to(torch.bfloat16)
                                if self._matmul else None)

        self.width = self.capacity
        self.state = self._zero_state(self.width)
        # (width, depth) pairs dispatched since load or the last demotion:
        # the ladder's cold-rung oracle
        self._programs = set()

    def _zero_state(self, width):
        L, C = self.window_len, self.num_chans
        shapes = {"window": (width, L, C), "pos": (width,),
                  "filled": (width,), "poisoned": (width,)}
        return {k: torch.zeros(shapes[k], dtype=_STATE_DTYPES[k],
                               device=self.device) for k in shapes}

    # ------------------------------------------------------------ the advance
    def _advance(self, samples, arrive):
        """One tick on the device: ``samples (W, C)``, ``arrive (W,)`` ->
        packed outputs ``(W, K + C*C + 3)`` (scores, graph, ready,
        poison_hit, poisoned). Updates ``self.state`` in place."""
        st = self.state
        window, pos = st["window"], st["pos"]
        filled, poisoned = st["filled"], st["poisoned"]
        L = self.window_len
        W = window.shape[0]
        lanes = torch.arange(W, device=self.device)

        finite = torch.isfinite(samples).all(dim=-1)
        poison_hit = arrive & ~finite & ~poisoned
        accept = arrive & finite & ~poisoned
        poisoned |= poison_hit

        # ring scatter: only accepted lanes write; a poison sample never
        # touches device state
        cur = window[lanes, pos.long()]
        window[lanes, pos.long()] = torch.where(accept[:, None], samples, cur)
        pos.copy_(torch.where(accept, (pos + 1) % L, pos))
        filled.copy_(torch.where(accept, torch.clamp(filled + 1, max=L),
                                 filled))
        ready = accept & (filled >= L)

        # ring-ordered gather (oldest -> newest): after writing at pos and
        # advancing, the oldest live sample sits at the new pos
        order = (pos.long()[:, None]
                 + torch.arange(L, device=self.device)[None, :]) % L
        win = torch.gather(window, 1,
                           order[:, :, None].expand(W, L, self.num_chans))

        with matmul_precision_ctx(self._matmul):
            weightings, _ = self.model._embed(self.params, win)  # (W, K)
        scores = torch.where(ready[:, None], weightings,
                             torch.zeros_like(weightings)).contiguous()
        if self._matmul:
            # the bf16 kernel form: the f32 scores rounded to bf16 in the
            # kernel, the bf16 graphs, f32 sums and output; one launch
            blend = graph_mix(scores, self._static_gc_bf16)
        else:
            blend = graph_mix(scores, self.static_gc)
        graph = torch.where(ready[:, None, None], blend,
                            torch.zeros_like(blend))
        flags = torch.stack([ready, poison_hit, poisoned], dim=1)
        return torch.cat([scores, graph.reshape(W, -1),
                          flags.to(torch.float32)], dim=1)

    def _unpack(self, packed):
        """Host view of packed outputs (leading axes kept)."""
        K, C = self.num_factors, self.num_chans
        lead = packed.shape[:-1]
        flags = packed[..., K + C * C:] != 0
        return {"scores": np.ascontiguousarray(packed[..., :K]),
                "graph": np.ascontiguousarray(
                    packed[..., K:K + C * C].reshape(lead + (C, C))),
                "ready": np.ascontiguousarray(flags[..., 0]),
                "poison_hit": np.ascontiguousarray(flags[..., 1]),
                "poisoned": np.ascontiguousarray(flags[..., 2])}

    def _to_device(self, samples, arrive):
        """One host-to-device copy: the arrival flag rides as the last
        column of the samples buffer."""
        samples = np.asarray(samples, dtype=np.float32)
        arrive = np.asarray(arrive, dtype=bool)
        host = np.empty(samples.shape[:-1] + (samples.shape[-1] + 1,),
                        dtype=np.float32)
        host[..., :-1] = samples
        host[..., -1] = arrive
        dev = torch.from_numpy(host).to(self.device)
        return dev[..., :-1], dev[..., -1] != 0

    def _check_width(self, n):
        if n != self.width:
            raise ValueError(f"tick batch has {n} lanes, table width is "
                             f"{self.width}")

    # ------------------------------------------------------------ dispatch
    def step(self, samples, arrive):
        """Advance every arriving lane one sample.

        ``samples``: ``(W, C)`` float32 (rows of non-arriving lanes are
        ignored); ``arrive``: ``(W,)`` bool, with ``W == self.width``.
        Returns host numpy arrays: ``scores (W, K)``, ``graph (W, C, C)``,
        ``ready (W,)`` (sample accepted AND ring full), ``poison_hit (W,)``
        (lane newly poisoned this tick), ``poisoned (W,)`` (latched).
        """
        self._check_width(len(samples))
        s, a = self._to_device(samples, arrive)
        self._programs.add((self.width, 1))
        with torch.no_grad():
            packed = self._advance(s, a)
        return self._unpack(packed.cpu().numpy())

    def step_fused(self, samples, arrive):
        """Advance every lane through up to F backlogged samples in one
        call: ``samples (W, F, C)``, ``arrive (W, F)``. Returns the dict of
        :meth:`step` with a leading F axis; element f equals what the f-th
        sequential :meth:`step` returns."""
        self._check_width(len(samples))
        s, a = self._to_device(samples, arrive)
        self._programs.add((self.width, int(s.shape[1])))
        with torch.no_grad():
            packed = torch.stack([self._advance(s[:, f], a[:, f])
                                  for f in range(s.shape[1])])
        return self._unpack(packed.cpu().numpy())

    def is_cold(self, width, depth=1):
        """True iff (width, depth) has not been dispatched since load or
        the last demotion — the ladder's pricing input."""
        return (int(width), int(depth)) not in self._programs

    # ------------------------------------------------------------ the table
    def resize(self, width):
        """Move the table to another width: grow zero-pads fresh rows (zero
        IS the reset state), shrink slices rows off the top, which the
        caller guarantees are free."""
        width = int(width)
        if width == self.width:
            return
        if not 1 <= width <= self.capacity:
            raise ValueError(f"width {width} outside [1, {self.capacity}]")
        if width < self.width:
            self.state = {k: v[:width].clone() for k, v in self.state.items()}
        else:
            pad = self._zero_state(width - self.width)
            self.state = {k: torch.cat([v, pad[k]], dim=0)
                          for k, v in self.state.items()}
        self.width = width

    def demote(self):
        """Mixed -> f32 (the poisoned-lane-storm sentinel's lever): every
        later dispatch runs the f32 ops on the f32 graphs. The rings are
        f32 already; returns True iff a demotion happened."""
        if self.precision_mode != "mixed" or self.demoted:
            return False
        self.demoted = True
        self._matmul = None
        self._programs = set()
        return True

    def reset_slot(self, slot):
        """Zero one lane's ring and flags (slot recycle). A slot at or
        beyond the resident width is already all-zero: no-op."""
        s = int(slot)
        if s >= self.width:
            return
        for v in self.state.values():
            v[s] = 0

    # ------------------------------------------------------------ durability
    def export_state(self):
        """Slot-table state as plain numpy (drain checkpoint payload)."""
        return {k: v.cpu().numpy().copy() for k, v in self.state.items()}

    def _state_from_host(self, host):
        return {k: torch.as_tensor(np.asarray(host[k]),
                                   dtype=_STATE_DTYPES[k],
                                   device=self.device).clone()
                for k in _STATE_DTYPES}

    def import_state(self, snap, slot_map=None):
        """Restore slot-table state from :meth:`export_state` output.

        Without ``slot_map`` the checkpoint must match the table's geometry
        exactly; a mismatch is refused with both geometries in the error.
        With ``slot_map`` (``{old_slot: new_slot}``) lanes are re-packed
        row by row; only the per-lane ``(L, C)`` ring shape must match and
        unmapped rows are zeroed."""
        want = {k: tuple(v.shape) for k, v in self.state.items()}
        got = {k: tuple(np.asarray(snap[k]).shape)
               for k in want if k in snap}
        if set(got) != set(want):
            raise ValueError(
                f"serve state geometry mismatch: checkpoint keys "
                f"{sorted(got)} vs engine keys {sorted(want)}")
        if slot_map is None:
            if want != got:
                raise ValueError(
                    f"serve state geometry mismatch: checkpoint {got} vs "
                    f"engine {want} — checkpoint table is "
                    f"{got['window'][0]}x{got['window'][1:]}, engine is "
                    f"{want['window'][0]}x{want['window'][1:]} (capacity or "
                    f"model changed across restart; resume with a slot_map "
                    f"to re-pack lanes)")
            self.state = self._state_from_host(snap)
            return
        lane_want, lane_got = want["window"][1:], got["window"][1:]
        if lane_got != lane_want:
            raise ValueError(
                f"serve state geometry mismatch: checkpoint {got} vs "
                f"engine {want} — per-lane ring {lane_got} vs {lane_want} "
                f"(model geometry changed; lanes cannot be re-packed)")
        old_w = got["window"][0]
        host = {k: np.zeros(want[k], dtype=np.asarray(snap[k]).dtype)
                for k in want}
        for old, new in slot_map.items():
            old, new = int(old), int(new)
            if not (0 <= old < old_w and 0 <= new < self.width):
                raise ValueError(
                    f"slot_map {old}->{new} outside checkpoint table "
                    f"[0, {old_w}) / engine table [0, {self.width})")
            for k in host:
                host[k][new] = np.asarray(snap[k])[old]
        self.state = self._state_from_host(host)
