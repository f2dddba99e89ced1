"""Batch streams: epoch index plans, the stream-mode choice and host
prefetch (port of ``data/pipeline.py``).

* :func:`epoch_batch_plan` — one epoch's batch order as index arrays,
  consuming the shuffle rng exactly like ``ArrayDataset.batches``.
* :func:`choose_stream_mode`, :func:`dispatch_budget`,
  :func:`dataset_device_bytes` — the grid's stream modes, resolved as the
  JAX package resolves them (``data/pipeline.py:60-167``):

  ``"epoch"``
      The dataset stays device-resident (``ArrayDataset.device_arrays``);
      the epoch's shuffled batch order is copied into a device index
      buffer, and one replay of a CUDA graph runs every full batch's
      step, gathering each batch in the graph (plus one replay for the
      short remainder). JAX scans the epoch in one jit'd dispatch.
  ``"kscan"``
      One replay of a graph of ``scan_batches`` steps per full group of
      batches staged on the device (JAX: a ``lax.scan`` over k stacked
      batches).
  ``"per_batch"``
      One eager step per batch; host streams ride :func:`prefetch_batches`.

  All three run the same steps on the same batches in the same order
  (``parallel/epoch_engine.py`` holds the programs).
* :class:`PrefetchIterator` / :func:`prefetch_batches` — double-buffered
  background prefetch for batch sources that are not device-resident: a
  thread drains the source up to ``depth`` items ahead and applies ``put``
  (e.g. a host-to-device copy) there, so producing batch t+1 overlaps the
  consumer's compute on batch t. Each fill is a ring-only
  ``prefetch.fill`` span and counts into ``prefetch_items``; the
  consumer's waits on an empty queue count into ``prefetch_stall_ms``
  (``obs.counters``, folded into the grid's ``dispatch_stats``), and a
  wait over 1 ms is also a ``prefetch.stall`` span. The worker stamps the
  ``"prefetch"`` heartbeat of ``runtime/watchdog.py`` per item and while it
  waits on a full queue, carries the ``hang_point("prefetch")`` fault
  point, and retires the heartbeat when the stream ends or is closed.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np

from redcliff_tpu_torch.obs import spans as _spans
from redcliff_tpu_torch.runtime import faultinject as _faultinject
from redcliff_tpu_torch.runtime import watchdog as _watchdog

__all__ = ["epoch_batch_plan", "choose_stream_mode", "dataset_device_bytes",
           "dispatch_budget", "prefetch_batches", "PrefetchIterator",
           "DEFAULT_MAX_DEVICE_DATASET_BYTES", "STREAM_MODES"]

STREAM_MODES = ("auto", "epoch", "kscan", "per_batch")

# device-residency ceiling of the epoch stream, as in the JAX package:
# datasets beyond it stay host resident (prefetched)
DEFAULT_MAX_DEVICE_DATASET_BYTES = 2 << 30


def epoch_batch_plan(n, batch_size, rng=None):
    """One epoch's batch order: ``(full_idx, rem_idx)``. ``full_idx`` is
    ``(n // batch_size, batch_size)`` int32, ``rem_idx`` the trailing short
    batch (possibly empty). Consumes ``rng`` exactly like
    ``ArrayDataset.batches`` (one ``rng.shuffle`` of ``arange(n)``)."""
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    nb = n // batch_size
    full = idx[: nb * batch_size].astype(np.int32).reshape(nb, batch_size)
    rem = idx[nb * batch_size:].astype(np.int32)
    return full, rem


def dataset_device_bytes(ds):
    """Device footprint of keeping ``ds`` resident (X + Y), or None when
    the dataset exposes no dense arrays."""
    X = getattr(ds, "X", None)
    if X is None:
        return None
    total = int(np.asarray(X).nbytes)
    Y = getattr(ds, "Y", None)
    if Y is not None:
        total += int(np.asarray(Y).nbytes)
    return total


def _single_process():
    """Not inside a ``torch.distributed`` world of more than one process
    (the JAX package's ``jax.process_count() == 1``)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)


def choose_stream_mode(mode, train_ds, *, scan_batches=0, batch_size=1,
                       freeze_by_batch=False):
    """Resolve a configured stream mode ("auto" included) against what the
    dataset and the engine support: ``"epoch" | "kscan" | "per_batch"``.
    Multi-phase epochs are the caller's to step per batch.

    The epoch stream needs a device-batch dataset within
    ``DEFAULT_MAX_DEVICE_DATASET_BYTES``, one process, labels, at least
    one full batch and no per-batch freeze choreography. ``"auto"``
    degrades epoch -> kscan (``scan_batches > 1``) -> per_batch; a
    requested mode that is not eligible degrades the same way. An unknown
    mode raises ``ValueError``."""
    if mode not in STREAM_MODES:
        raise ValueError(
            f"unknown stream_mode {mode!r}; valid: {STREAM_MODES}")

    def epoch_ok():
        if freeze_by_batch:
            return False
        if not getattr(train_ds, "supports_device_batches", False):
            return False
        if getattr(train_ds, "Y", None) is None:
            return False
        try:
            if len(train_ds) < batch_size:
                return False
        except TypeError:
            return False
        nbytes = dataset_device_bytes(train_ds)
        if nbytes is None or nbytes > DEFAULT_MAX_DEVICE_DATASET_BYTES:
            return False
        return _single_process()

    def kscan_ok():
        return scan_batches and scan_batches > 1 and not freeze_by_batch

    if mode in ("auto", "epoch") and epoch_ok():
        return "epoch"
    if mode in ("auto", "epoch", "kscan") and kscan_ok():
        return "kscan"
    return "per_batch"


def dispatch_budget(num_full_batches, num_remainder_batches=0,
                    scan_batches=0, mode="per_batch"):
    """Train dispatches per single-phase epoch in a stream mode (a replay
    or an eager step each). ``num_remainder_batches`` counts the trailing
    short batches, which always take a step of their own."""
    if mode == "epoch":
        return (1 if num_full_batches else 0) + num_remainder_batches
    if mode == "kscan" and scan_batches and scan_batches > 1:
        k = scan_batches
        # full k-groups replay; the partial trailing group steps per batch
        return (num_full_batches // k
                + num_full_batches % k + num_remainder_batches)
    return num_full_batches + num_remainder_batches


class PrefetchIterator:
    """Order-preserving background prefetch of ``iterator``, ``depth``
    items ahead, applying ``put`` to every non-None element of each item in
    the worker thread. An error raised by the source (or ``put``) re-raises
    at the consumer's ``next()``. :meth:`close` (idempotent; also via
    ``with`` and at end of stream) unblocks and joins the worker.
    ``depth < 1`` is a passthrough with no thread.

    Liveness: the worker stamps the ``"prefetch"`` heartbeat per produced
    item and while it waits on a full queue (a worker blocked on a slow
    consumer is healthy; one wedged in the source or in ``put`` stops
    stamping and the watchdog escalates). The heartbeat retires when the
    stream ends or closes, so idle time between epochs never reads as a
    hang."""

    _END, _ERR = object(), object()

    def __init__(self, iterator, depth=2, put=None):
        self._closed = False
        if depth < 1:
            self._source = iter(iterator)
            self._thread = None
            return
        self._source = None
        self._q = queue.Queue(maxsize=depth)
        self._cancel = threading.Event()
        self._put = put
        self._iterator = iterator
        self._thread = threading.Thread(
            target=self._worker, name="batch-prefetch", daemon=True)
        self._thread.start()

    def _put_blocking(self, item):
        """Enqueue, waiting out a full queue unless cancelled (items, END
        and ERR alike: a dropped sentinel would strand the consumer)."""
        while not self._cancel.is_set():
            # a full queue means the CONSUMER is slow, not that this thread
            # is hung: keep the heartbeat alive
            _watchdog.stamp("prefetch")
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self._iterator:
                if self._cancel.is_set():
                    return
                _watchdog.stamp("prefetch")
                _faultinject.hang_point("prefetch")
                # the fill span covers the transform/copy half of producing
                # one batch; waiting on a full queue stays outside it
                with _spans.span("prefetch.fill", component="prefetch"):
                    if self._put is not None:
                        item = tuple(None if x is None else self._put(x)
                                     for x in item)
                _spans.COUNTERS.add("prefetch_items", 1)
                if not self._put_blocking(item):
                    return
            self._put_blocking(self._END)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            self._put_blocking((self._ERR, e))
        finally:
            # a cancelled worker retires its own heartbeat: its stamps
            # happen before this (same thread), so a late stamp can never
            # re-register the beat after the consumer retired it
            if self._cancel.is_set():
                _watchdog.retire("prefetch")

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._thread is None:
            return next(self._source)
        # consumer-side stall accounting: time blocked on an empty queue is
        # the pipeline's un-overlapped fill cost
        t_get0 = time.perf_counter()
        item = self._q.get()
        wait_ms = (time.perf_counter() - t_get0) * 1e3
        _spans.COUNTERS.add("prefetch_stall_ms", wait_ms)
        if wait_ms > 1.0:
            _spans.record_span("prefetch.stall", wait_ms,
                               component="prefetch")
        if item is self._END:
            self.close()
            raise StopIteration
        if isinstance(item, tuple) and len(item) == 2 \
                and item[0] is self._ERR:
            self.close()
            raise item[1]
        return item

    def close(self):
        """Unblock and join the worker, retire the heartbeat; buffered
        items are dropped."""
        if self._closed:
            return
        self._closed = True
        if self._thread is None:
            return
        self._cancel.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        _watchdog.retire("prefetch")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass


def prefetch_batches(iterator, depth=2, put=None):
    """A :class:`PrefetchIterator` over ``iterator``."""
    return PrefetchIterator(iterator, depth=depth, put=put)
