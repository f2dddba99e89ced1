"""Batch streams: epoch index plans and host prefetch (port of the part of
``data/pipeline.py`` the per-point trainer uses).

* :func:`epoch_batch_plan` — one epoch's batch order as index arrays,
  consuming the shuffle rng exactly like ``ArrayDataset.batches``.
* :class:`PrefetchIterator` / :func:`prefetch_batches` — double-buffered
  background prefetch for batch sources that are not device-resident: a
  thread drains the source up to ``depth`` items ahead and applies ``put``
  (e.g. a host-to-device copy) there, so producing batch t+1 overlaps the
  consumer's compute on batch t.

The JAX package's epoch-scan and k-batch-scan stream modes compile a whole
epoch into one XLA program; they are bit-identical to per-batch dispatch
there and have no counterpart in eager PyTorch, so the port streams per
batch.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["epoch_batch_plan", "prefetch_batches", "PrefetchIterator"]


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


class PrefetchIterator:
    """Order-preserving background prefetch of ``iterator``, ``depth``
    items ahead, applying ``put`` to every non-None element of each item in
    the worker thread. An error raised by the source (or ``put``) re-raises
    at the consumer's ``next()``. :meth:`close` (idempotent; also via
    ``with`` and at end of stream) unblocks and joins the worker.
    ``depth < 1`` is a passthrough with no thread."""

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
                if self._put is not None:
                    item = tuple(None if x is None else self._put(x)
                                 for x in item)
                if not self._put_blocking(item):
                    return
            self._put_blocking(self._END)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            self._put_blocking((self._ERR, e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._thread is None:
            return next(self._source)
        item = self._q.get()
        if item is self._END:
            self.close()
            raise StopIteration
        if isinstance(item, tuple) and len(item) == 2 \
                and item[0] is self._ERR:
            self.close()
            raise item[1]
        return item

    def close(self):
        """Unblock and join the worker; buffered items are dropped."""
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
