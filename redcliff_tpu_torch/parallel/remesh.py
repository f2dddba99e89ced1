"""Elastic re-meshing: host-fault detection and degraded-mesh resume
planning (port of ``redcliff_tpu/parallel/remesh.py``).

- :class:`HostLostError` — the typed "part of the mesh is gone" failure.
  The grid engine raises it when a dispatch dies with a device-loss,
  collective-timeout or coordinator-loss signature
  (:func:`classify_device_error`), the watchdog's host-scoped staleness
  detector exits with its taxonomy code (``EXIT_HOST_LOST``, 21), and the
  ``host_drop`` fault point raises it directly.
- :func:`plan_resharding` / :func:`apply_reshard` — the lane re-sharding
  plan that lands a checkpoint's survivors on the largest viable mesh of
  the devices visible now, applied to the loaded host payload before any
  tensor exists on a device. Results keep their original point ids; the
  resume fingerprint is mesh-agnostic.
- :func:`visible_devices` / :func:`visible_mesh` — the devices this
  attempt may use: the distinct CUDA devices, or the caller's list (which
  may repeat an entry: one card simulating a larger mesh), capped by
  ``REDCLIFF_MESH_DEVICES`` (the knob the supervisor decrements on a
  ``host_lost`` exit: re-mesh-then-restart).
- :func:`mesh_shape` — {n_hosts, n_devices, device_kind}, stamped into the
  run ledger and every grid checkpoint.

The host halves are copies of the JAX module's, line for line:
``HostLostError``, the detection signature tuples and
:func:`classify_device_error` (``redcliff_tpu/parallel/remesh.py:
78-158``; its CUDA and NCCL routes below are the port's own),
:func:`width_fits`, :func:`choose_mesh_devices` and
:func:`plan_resharding` (``:223-311``) and :func:`apply_reshard`
(``:323-366``, walking its trees with the port's ``interop.tree_map``).
As in JAX, a single process simulates hosts as partitions of its mesh
(``REDCLIFF_SIM_HOSTS`` declares the partition count) and a host drop is
a typed exit plus a smaller ``REDCLIFF_MESH_DEVICES`` on the next attempt.

Differences from JAX's signatures: the JAX texts are XLA's and PJRT's, so
the copy adds the texts a CUDA device or an NCCL peer gives when it is
gone. They are tried only where JAX's signatures find nothing, so every
text JAX routes is routed as JAX routes it:

- an Xid-79 "GPU has fallen off the bus" and
  ``cudaErrorDevicesUnavailable`` are ``device_lost``;
- an NCCL communicator aborted because its "remote process exited" is
  ``collective_timeout``, the route JAX gives a peer that stopped
  taking part.

``CUDA error: unspecified launch failure`` stays None: a faulty kernel
raises it too, and re-meshing would hide the fault behind a smaller mesh.

numpy and the stdlib at module scope; torch is imported where a device is
named.
"""
from __future__ import annotations

import os

import numpy as np

from redcliff_tpu_torch.interop import tree_map
from redcliff_tpu_torch.parallel import compaction

__all__ = [
    "HostLostError",
    "classify_device_error",
    "mesh_shape",
    "visible_devices",
    "visible_mesh",
    "choose_mesh_devices",
    "plan_resharding",
    "apply_reshard",
    "width_fits",
    "ENV_MESH_DEVICES",
    "ENV_SIM_HOSTS",
]

# the degraded-mesh knob: the supervisor sets/decrements this on a host_lost
# exit; visible_devices() caps the device list to it on the next attempt
ENV_MESH_DEVICES = "REDCLIFF_MESH_DEVICES"
# single-process simulation: how many "hosts" partition the local device
# list; real multi-process runs ignore it (the owning rank is the truth)
ENV_SIM_HOSTS = "REDCLIFF_SIM_HOSTS"


class HostLostError(RuntimeError):
    """Part of the execution mesh is gone: a host stopped heartbeating, a
    collective timed out, or the backend reported a device/coordinator loss.

    This is a RESTARTABLE-after-re-mesh failure, not a crash: the durable
    checkpoint holds gathered host state, so the supervisor's answer is
    "shrink the mesh and resume" (taxonomy exit code
    :data:`~redcliff_tpu.runtime.watchdog.EXIT_HOST_LOST`), never a page.

    ``reason`` is the detection route (``host_drop`` / ``device_lost`` /
    ``collective_timeout`` / ``coordinator_loss`` / ``host_stale``);
    ``host`` is the lost host's index when the detector knows it."""

    def __init__(self, reason, host=None, detail=None):
        self.reason = reason
        self.host = host
        at = f" (host {host})" if host is not None else ""
        msg = f"mesh degraded: {reason}{at}"
        if detail:
            msg += f" — {detail}"
        msg += ("; resume from the durable checkpoint on the surviving "
                "devices (supervisor: re-mesh-then-restart)")
        super().__init__(msg)


# detection signatures for backend errors that mean "the mesh lost capacity",
# not "the math is wrong". Matched against lowercased str(exc); deliberately
# substring-based — XLA/PJRT error text varies by backend and version, and a
# false negative merely degrades to the old behavior (crash -> same-shape
# restart). A false POSITIVE is costlier (the supervisor irreversibly drops
# a host's worth of healthy devices), so the conjunctive branches require an
# explicit timeout word next to the collective/coordinator evidence — the
# looser "unavailable" (any gRPC UNAVAILABLE status) counts only for the
# coordinator, whose loss genuinely presents that way.
_DEVICE_LOST_SIGS = (
    "device lost", "device is lost", "lost device", "device disconnected",
    "device failure", "device removed", "device_lost",
)
_COORDINATOR_SIGS = (
    "coordinator", "distributed runtime service", "preemption notice",
)
_TIMEOUT_SIGS = ("timed out", "timeout", "deadline exceeded")
_COORD_TIMEOUT_SIGS = _TIMEOUT_SIGS + ("unavailable",)
_COLLECTIVE_SIGS = ("collective", "all-reduce", "allreduce", "all-gather",
                    "allgather", "psum", "nccl", "cross-host")
# the port's own: what CUDA and NCCL say when a card or a peer is gone
_CUDA_DEVICE_LOST_SIGS = ("fallen off the bus", "cudaerrordevicesunavailable")
_NCCL_ABORT_SIGS = ("communicator was aborted", "communicator aborted")
_PEER_EXIT_SIGS = ("remote process exited",)


def classify_device_error(exc):
    """Map a backend exception onto a host-loss detection route, or None.

    Returns ``"device_lost"`` (explicit device-loss signal),
    ``"collective_timeout"`` (a cross-device/host collective timed out — the
    signature of a peer that stopped participating), or
    ``"coordinator_loss"`` (the distributed coordinator went away). None
    means "not mesh-shaped": the caller re-raises and the failure stays in
    its original class."""
    if exc is None:
        return None
    text = f"{type(exc).__name__}: {exc}".lower()
    if any(s in text for s in _DEVICE_LOST_SIGS):
        return "device_lost"
    if any(s in text for s in _COORDINATOR_SIGS) \
            and any(s in text for s in _COORD_TIMEOUT_SIGS):
        return "coordinator_loss"
    if any(s in text for s in _COLLECTIVE_SIGS) \
            and any(s in text for s in _TIMEOUT_SIGS):
        return "collective_timeout"
    if any(s in text for s in _CUDA_DEVICE_LOST_SIGS):
        return "device_lost"
    if "nccl" in text and any(s in text for s in _NCCL_ABORT_SIGS) \
            and any(s in text for s in _PEER_EXIT_SIGS):
        return "collective_timeout"
    return None


def visible_devices(devices=None, env=ENV_MESH_DEVICES):
    """The device list this attempt may mesh over: ``devices`` when given
    (entries may repeat), else the distinct visible CUDA devices (in a
    process group, every rank's), capped by ``REDCLIFF_MESH_DEVICES``
    (unset or invalid = no cap).

    The cap takes the FIRST n devices, as in JAX: every attempt at the same
    cap meshes over the same devices (in the single-process simulation,
    "losing host h" = capping below h's partition)."""
    if devices is None:
        from redcliff_tpu_torch.parallel.mesh import grid_mesh

        devices = list(grid_mesh().devices)
    devices = list(devices)
    spec = os.environ.get(env, "").strip()
    if spec:
        try:
            n = int(spec)
        except ValueError:
            return devices
        if n >= 1:
            devices = devices[:n]
    return devices


def visible_mesh(axis_name="grid", devices=None, n_lanes=None):
    """1-D grid mesh over :func:`visible_devices` — what drivers build to
    honor the supervisor's re-mesh decisions. With ``n_lanes`` the mesh is
    trimmed to :func:`choose_mesh_devices`'s largest viable device count
    for that many lanes (the one auto-mesh recipe, shared by
    ``run_coefficient_grid(mesh="auto")``, the fault-injection child and
    the fleet batch driver)."""
    from redcliff_tpu_torch.parallel.mesh import grid_mesh

    if devices is None:
        full = grid_mesh()
        devs, ranks = visible_devices(full.devices), full.ranks
    else:
        devs, ranks = visible_devices(devices), None
    if n_lanes is not None:
        devs = devs[: choose_mesh_devices(len(devs), n_lanes)]
    mesh = grid_mesh(devices=devs, axis_name=axis_name)
    if ranks is not None:
        mesh = type(mesh)(mesh.devices, mesh.axis_names, ranks[:mesh.size])
    return mesh


def _device_kind(d):
    import torch

    d = torch.device(d)
    if d.type == "cuda":
        return torch.cuda.get_device_name(d)
    return d.type


def mesh_shape(mesh=None, devices=None, sim_hosts=None):
    """{n_hosts, n_devices, device_kind} for a mesh or device list — audit
    metadata for ``run_ledger.jsonl`` attempts and grid checkpoints (not
    the resume fingerprint: checkpoints stay mesh-agnostic).

    ``n_hosts`` counts distinct owning process ranks; in one process
    ``REDCLIFF_SIM_HOSTS`` (or ``sim_hosts``) overrides it with the
    declared partition count. ``device_kind`` is ``"cpu"`` or the card's
    name. Without a mesh or devices: the one default device of an
    unmeshed fit (cuda:0 when a card is visible)."""
    ranks = None
    if devices is None:
        if mesh is not None:
            devices, ranks = list(mesh.devices), list(mesh.ranks)
        else:
            import torch

            devices = [torch.device("cuda", 0) if torch.cuda.is_available()
                       else torch.device("cpu")]
    devices = list(devices)
    if ranks is None:
        ranks = [getattr(d, "process_index", 0) for d in devices]
    if sim_hosts is None:
        spec = os.environ.get(ENV_SIM_HOSTS, "").strip()
        if spec:
            try:
                sim_hosts = int(spec)
            except ValueError:
                sim_hosts = None
    n_hosts = len(set(ranks)) or 1
    if n_hosts == 1 and sim_hosts is not None and sim_hosts >= 1:
        # the simulated partition count applies ONLY when the devices are
        # genuinely single-process; on a real multi-process mesh the rank
        # spread is the truth
        n_hosts = min(int(sim_hosts), len(devices))
    kind = (getattr(devices[0], "device_kind", None)
            or _device_kind(devices[0])) if devices else None
    return {"n_hosts": int(n_hosts), "n_devices": len(devices),
            "device_kind": kind}


def width_fits(width, n_devices):
    """True when a ``width``-lane grid can shard over ``n_devices`` (the
    grid engine's sub-mesh rule: multiple OR divisor of the device count).
    The ONE place this invariant lives — the grid resume path and the
    planner both consult it, so they can never drift apart."""
    n_devices = int(n_devices or 1)
    if n_devices <= 1 or width <= 0:
        return True
    return width % n_devices == 0 or n_devices % width == 0


def choose_mesh_devices(n_visible, n_lanes):
    """The largest viable execution mesh for ``n_lanes`` lanes on
    ``n_visible`` surviving devices.

    Any device count is *runnable* (the bucket ladder pads the width to a
    multiple), so "viable" is decided by wall-clock: a dispatch takes as
    long as the lanes each device computes (width / devices). The planner
    compares the full survivor set against the largest power-of-two subset
    — e.g. 9 live lanes on 6 survivors bucket to width 18 (3 lanes/device),
    beating the 4-device pow2 sub-mesh's width 16 (4 lanes/device) — and
    picks the smaller per-device load, preferring MORE devices on a tie
    (the filler lanes a wider bucket adds burn joules, not seconds, and the
    compaction ladder reclaims them at the next check window)."""
    n_visible = max(int(n_visible), 1)
    n_lanes = max(int(n_lanes), 1)
    pow2 = 1 << (n_visible.bit_length() - 1)  # largest pow2 <= n_visible
    candidates = sorted({n_visible, pow2}, reverse=True)

    def load(n_dev):
        w = compaction.bucket_width(n_lanes, n_dev)
        # width < device count runs on a sub-mesh of `w` devices
        return w / (n_dev if w % n_dev == 0 else w)

    best = candidates[0]
    best_load = load(best)
    for cand in candidates[1:]:
        if load(cand) < best_load:
            best, best_load = cand, load(cand)
    return best


def plan_resharding(active, orig_ids, retired_ids, n_devices, compact=True):
    """Lane re-sharding plan for resuming a checkpoint onto an
    ``n_devices`` mesh, or None when the checkpointed width already fits.

    ``active``/``orig_ids`` are the checkpoint's host arrays (execution
    width; ``orig_ids`` -1 marks bucket filler), ``retired_ids`` the point
    ids whose results already live in the host-side retired store.

    With ``compact=True`` (the elastic-scheduler default) only LIVE lanes
    ride to the new mesh — frozen-but-unretired lanes (early-stopped,
    quarantined, deadline-evicted) retire their frozen results to the host
    store exactly like a check-window compaction would. With
    ``compact=False`` every real lane keeps its row (fixed-width
    semantics), re-bucketed only as far as mesh viability requires.

    Unlike :func:`~redcliff_tpu.parallel.compaction.plan_compaction`, the
    plan may GROW the width: a surviving device count that divides nothing
    smaller (say width 8 onto 6 devices) pads up the ladder with filler
    lanes rather than failing the resume."""
    active = np.asarray(active, bool)
    orig_ids = np.asarray(orig_ids, np.int32)
    real = orig_ids >= 0
    live_rows = np.flatnonzero(active & real).astype(np.int32)
    retire_rows = np.zeros((0,), np.int32)
    if compact and live_rows.size:
        keep_rows = live_rows
        retire_rows = compaction.unretired_frozen_rows(active, orig_ids,
                                                       retired_ids)
    else:
        # no live lanes (resume-to-finish) or compaction off: every real
        # lane keeps its row so the fixed-width semantics are preserved
        keep_rows = np.flatnonzero(real).astype(np.int32)
    if keep_rows.size == 0:
        return None  # nothing real on board; the fit's exit paths own this
    new_w = compaction.bucket_width(keep_rows.size, n_devices)
    if new_w == int(orig_ids.size) and width_fits(orig_ids.size, n_devices):
        return None
    # filler invariant (compaction.assemble_plan): prefer a live fill lane —
    # in the keep-all branches keep_rows[0] may be a quarantined lane
    # holding non-finite params
    fill_row = live_rows[0] if live_rows.size else keep_rows[0]
    return compaction.assemble_plan(orig_ids, keep_rows, active[keep_rows],
                                    fill_row, new_w, retire_rows)


# checkpoint payload keys holding per-lane state (leading axis = execution
# width) that a re-shard must gather through the plan's row selection.
# "active" is NOT here: the plan computes the new mask directly (a
# sel-gather would mark filler rows with the fill lane's liveness)
_LANE_STATE_KEYS = ("params", "optA_state", "optB_state", "best_params",
                    "accepted", "nstate", "best_crit", "best_epoch",
                    "failed_epoch", "failed_cause")


def apply_reshard(ckpt, retired, plan):
    """Apply a re-shard plan to a loaded checkpoint payload IN PLACE (host
    numpy gathers — no device array exists yet) and absorb the plan's
    retirements into ``retired``. Returns the number of live lanes migrated.

    ``ckpt`` is the grid checkpoint dict (host trees at the old execution
    width); ``retired`` the engine's {point_id: frozen results} store. The
    checkpoint's ``val_history`` rows are already expanded to the original
    point width, so they pass through untouched."""
    # retire frozen lanes' results BEFORE remapping: retire_rows index the
    # OLD width. Pre-sentinel checkpoints carry no failed_cause — backfill
    # exactly like the grid resume path does (every already-quarantined
    # lane was a validation quarantine by construction)
    failed_epoch = np.asarray(ckpt["failed_epoch"])
    fc = ckpt.get("failed_cause")
    if fc is None:
        from redcliff_tpu_torch.runtime import numerics

        fc = np.where(failed_epoch >= 0, numerics.CAUSE_NONFINITE_VAL,
                      0).astype(np.int32)
    failed_cause = np.asarray(fc)
    for i, row in enumerate(np.asarray(plan.retire_rows)):
        pid = int(plan.retire_ids[i])
        retired[pid] = {
            "best_params": tree_map(
                lambda l, _r=int(row): np.asarray(l[_r]),
                ckpt["best_params"]),
            "best_crit": float(np.asarray(ckpt["best_crit"])[row]),
            "best_epoch": int(np.asarray(ckpt["best_epoch"])[row]),
            "failed_epoch": int(failed_epoch[row]),
            "failed_cause": int(failed_cause[row]),
        }
    sel = np.asarray(plan.sel)
    for key in _LANE_STATE_KEYS:
        val = ckpt.get(key)
        if val is None:
            continue  # accepted/nstate may be absent (non-freeze fits,
        #             pre-sentinel checkpoints)
        ckpt[key] = tree_map(lambda l: np.asarray(l)[sel], val)
    ckpt["active"] = np.asarray(plan.active)
    ckpt["orig_ids"] = np.asarray(plan.orig_ids, np.int32)
    ckpt["retired"] = retired
    return int(np.asarray(plan.active).sum())
