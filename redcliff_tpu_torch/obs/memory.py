"""Analytical device-memory footprint and live watermarks (port of
``redcliff_tpu/obs/memory.py``).

Two independent signals, as in the JAX module:

* **Predicted** — :func:`grid_footprint` / :func:`trainer_footprint` /
  :func:`tree_bytes` compute the device bytes a fit pins from shapes only:
  per-lane parameter state, Adam moments, best/accepted copies, the
  device-resident dataset the epoch engine keeps, and the transient
  permuted epoch gather. JAX traces ``model.init`` with ``jax.eval_shape``;
  the port calls its own ``init`` on the ``meta`` device (no storage).
  :func:`footprint_by_bucket` prices each rung of the bucket ladder. The
  arithmetic is the JAX module's, so for the same model config, widths and
  datasets both packages give equal integers.

* **Measured** — :func:`poll_watermark` reads the caching allocator's
  counters (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` /
  ``.peak``) and the card's capacity (``torch.cuda.mem_get_info``): host
  calls, no kernel launch, no stream sync. The peak is process-wide, as
  JAX's ``memory_stats()`` is; nothing here resets it. On a CPU device
  nothing is reported: :func:`poll_watermark` returns None and
  :func:`check_headroom` an explicit ``fits=None``, as JAX does on its CPU
  backend. ``REDCLIFF_MEM_POLL=0`` disables polling (prediction is
  unaffected).

torch is imported inside functions only; nothing here synchronizes the
device.
"""
from __future__ import annotations

import os

__all__ = ["ENV_MEM_POLL", "polling_enabled", "tree_bytes", "param_bytes",
           "grid_footprint", "trainer_footprint", "footprint_by_bucket",
           "device_memory_stats", "poll_watermark", "check_headroom"]

ENV_MEM_POLL = "REDCLIFF_MEM_POLL"


def polling_enabled():
    """Whether live watermark polling is armed (default on)."""
    return os.environ.get(ENV_MEM_POLL, "1").strip().lower() not in (
        "0", "off", "false")


# ---------------------------------------------------------------------------
# analytical footprint (shapes only — no device work)
# ---------------------------------------------------------------------------
def _leaf_bytes(leaf):
    """Bytes of one array-like leaf from its shape/dtype metadata (torch
    tensors, meta tensors included, and numpy arrays); 0 for non-array
    leaves (ints, None, scalars inside optimizer states)."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return 0
    n = 1
    for d in shape:
        n *= int(d)
    itemsize = getattr(dtype, "itemsize", None)
    if itemsize is None:
        import numpy as np

        itemsize = np.dtype(dtype).itemsize
    return n * int(itemsize)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def tree_bytes(tree):
    """Total bytes of every array leaf in a (dict/list/tuple) tree, from
    metadata only."""
    return sum(_leaf_bytes(leaf) for leaf in _leaves(tree))


def param_bytes(model):
    """Per-point parameter bytes of ``model`` by optimizer group, from
    ``model.init`` on the ``meta`` device (shapes, no storage). Returns
    ``{"embedder", "factors", "other", "total"}`` (groups the model does
    not define are 0)."""
    import torch

    shapes = model.init(torch.Generator().manual_seed(0), device="meta")
    out = {"embedder": 0, "factors": 0, "other": 0}
    if isinstance(shapes, dict):
        for group, sub in shapes.items():
            g = group if group in ("embedder", "factors") else "other"
            out[g] += tree_bytes(sub)
    else:
        out["other"] = tree_bytes(shapes)
    out["total"] = out["embedder"] + out["factors"] + out["other"]
    return out


def grid_footprint(model, train_config, g_exec, train_ds=None, val_ds=None,
                   stream_mode=None, freeze=False):
    """Predicted device bytes of one grid fit at execution width
    ``g_exec``: ``params_bytes`` (the live (G, ...) grid), ``opt_bytes``
    (Adam's two moments per optimized group), ``best_bytes`` (the best copy,
    plus the Freeze-mode accepted tree when ``freeze``), ``dataset_bytes``
    (train + val kept device-resident; 0 for host streams) and
    ``epoch_gather_bytes`` (the epoch's gathered batches, bounded by the
    training set; 0 off the epoch path). ``per_lane_bytes`` is the
    lane-proportional slope; ``total_bytes = per_lane_bytes * g_exec +
    fixed``. ``stream_mode`` defaults to ``train_config.stream_mode``;
    ``freeze`` to whether the model's training mode runs Freeze."""
    from redcliff_tpu_torch.data import pipeline

    if stream_mode is None and train_config is not None:
        stream_mode = getattr(train_config, "stream_mode", None)
    if not freeze:
        mode = getattr(getattr(model, "config", None), "training_mode", "")
        freeze = "Freeze" in str(mode)
    pb = param_bytes(model)
    per_point = pb["total"]
    opt_per_point = 2 * (pb["embedder"] + pb["factors"])
    if opt_per_point == 0:
        opt_per_point = 2 * per_point  # single-group models optimize it all
    copies = 2 + (1 if freeze else 0)  # live + best (+ accepted)
    per_lane = per_point * copies + opt_per_point
    train_bytes = pipeline.dataset_device_bytes(train_ds) or 0
    val_bytes = pipeline.dataset_device_bytes(val_ds) or 0
    on_epoch_path = stream_mode in (None, "auto", "epoch")
    resident = on_epoch_path or bool(
        getattr(train_ds, "supports_device_batches", False))
    dataset_bytes = (train_bytes + val_bytes) if resident else 0
    gather_bytes = train_bytes if on_epoch_path else 0
    g_exec = int(g_exec)
    return {
        "g_bucket": g_exec,
        "params_bytes": per_point * g_exec,
        "opt_bytes": opt_per_point * g_exec,
        "best_bytes": per_point * (copies - 1) * g_exec,
        "per_lane_bytes": per_lane,
        "dataset_bytes": dataset_bytes,
        "epoch_gather_bytes": gather_bytes,
        "total_bytes": per_lane * g_exec + dataset_bytes + gather_bytes,
    }


def trainer_footprint(params, opt_states=(), extra_copies=2,
                      train_ds=None, val_ds=None):
    """Predicted device bytes of one per-point trainer fit from the
    parameter tree's metadata: live params + ``extra_copies`` full copies
    (best / accepted) + the given optimizer-state trees + the
    dataset arrays. The trainers pass Adam's moments as two trees shaped
    like the params (``torch.optim.Adam`` keeps ``exp_avg`` and
    ``exp_avg_sq`` on the device, its step counts on the host)."""
    from redcliff_tpu_torch.data import pipeline

    pb = tree_bytes(params)
    opt = sum(tree_bytes(s) for s in opt_states)
    ds_bytes = ((pipeline.dataset_device_bytes(train_ds) or 0)
                + (pipeline.dataset_device_bytes(val_ds) or 0))
    return {
        "params_bytes": pb * (1 + int(extra_copies)),
        "opt_bytes": opt,
        "dataset_bytes": ds_bytes,
        "total_bytes": pb * (1 + int(extra_copies)) + opt + ds_bytes,
    }


def footprint_by_bucket(model, train_config, g_real, n_devices=1,
                        max_width=None, train_ds=None, val_ds=None,
                        stream_mode=None, freeze=False):
    """Predicted footprint per bucket-ladder rung from the width ``g_real``
    requires up to ``max_width`` (default: 4 rungs). Returns
    ``[{..., "g_bucket", "total_bytes"}, ...]``."""
    from redcliff_tpu_torch.parallel import compaction

    return [grid_footprint(model, train_config, w, train_ds=train_ds,
                           val_ds=val_ds, stream_mode=stream_mode,
                           freeze=freeze)
            for w in compaction.ladder_widths(g_real, n_devices,
                                              max_width=max_width)]


# ---------------------------------------------------------------------------
# live watermark (host allocator counters — None where nothing reports)
# ---------------------------------------------------------------------------
def _cuda_devices(devices):
    """The CUDA devices among ``devices`` (default: every visible card)."""
    import torch

    if devices is None:
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            out.append(torch.device(
                "cuda", d.index if d.index is not None
                else torch.cuda.current_device()))
    return out


def device_memory_stats(device=None):
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}`` of one card
    from the caching allocator's counters and ``mem_get_info``, or None for
    a CPU device (or with no card). Host calls only."""
    import torch

    devs = _cuda_devices(None if device is None else [device])
    if not devs:
        return None
    dev = devs[0]
    stats = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}


def poll_watermark(devices=None):
    """Live/peak device bytes across ``devices`` (default: every visible
    card): ``{"bytes_in_use", "peak_bytes", "bytes_limit", "n_devices",
    "device_kind"}`` — per-device MAX for use/peak, MIN for the limit. None
    when no device reports (CPU devices)."""
    import torch

    in_use = peak = limit = None
    n = 0
    kind = None
    for d in _cuda_devices(devices):
        stats = device_memory_stats(d)
        n += 1
        kind = torch.cuda.get_device_name(d)
        u = stats["bytes_in_use"]
        p = stats["peak_bytes_in_use"]
        li = stats["bytes_limit"]
        in_use = u if in_use is None else max(in_use, u)
        peak = p if peak is None else max(peak, p)
        limit = li if limit is None else min(limit, li)
    if n == 0:
        return None
    return {"bytes_in_use": in_use, "peak_bytes": peak,
            "bytes_limit": limit, "n_devices": n, "device_kind": kind}


def check_headroom(predicted_bytes, devices=None, n_devices=None):
    """Does ``predicted_bytes`` fit the devices' memory? Returns ``{"fits",
    "bytes_limit", "budget_bytes", "headroom_bytes", "backend"}``:
    ``bytes_limit`` per device, ``budget_bytes`` the aggregate the verdict
    is judged against. ``fits`` is None (both limits None) on a CPU device,
    which reports no memory — never a guess. ``backend`` is "cuda" or
    "cpu"."""
    wm = poll_watermark(devices)
    if wm is None or wm.get("bytes_limit") is None:
        return {"fits": None, "bytes_limit": None, "budget_bytes": None,
                "headroom_bytes": None, "backend": "cpu"}
    scale = int(n_devices or wm["n_devices"] or 1)
    budget = wm["bytes_limit"] * scale
    return {"fits": bool(predicted_bytes <= budget),
            "bytes_limit": wm["bytes_limit"],
            "budget_bytes": budget,
            "headroom_bytes": int(budget - predicted_bytes),
            "backend": "cuda"}
