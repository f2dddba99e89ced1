"""Durable checkpoint files: atomic writes, generations, CRC, quarantine.

The port's copy of the file format of ``redcliff_tpu/runtime/checkpoint.py``,
so that artifacts and drain checkpoints are readable by either package::

    RTCK | u32 version | u32 crc32(payload) | u64 payload_len | payload

``payload`` is a pickle. A file failing any header/CRC/unpickle check raises
:class:`CheckpointCorruptError`; :func:`load_checkpoint` turns that into
quarantine-and-fall-back: the corrupt file is renamed to ``*.bad``, the
trailing ``*.prev`` generation is tried next, and only if both generations
are unusable does the caller see "no checkpoint". Legacy headerless pickles
are still readable.

Unpickling is restricted (:class:`PortUnpickler`): numpy arrays, a safe set
of builtins, and the model config classes (REDCLIFF-S, cMLP-FM, cLSTM-FM,
NAVAR, NAVAR-LSTM, DGCNN, DCSFA-NMF, DYNOTEARS and the DYNOTEARS solver
state). The JAX package's config classes (e.g.
``redcliff_tpu.models.redcliff.RedcliffSCMLPConfig``) are mapped to the
port's own, so a JAX-written ``final_best_model.bin`` loads without
importing JAX. Any other class raises :class:`ForbiddenClassError` naming
it; that error is not a corruption and is raised as is. The port's trainer
checkpoints (``train/redcliff_trainer.py``) hold only numpy arrays and
builtins — optimizer ``state_dict`` s converted to numpy, the shuffle rng's
state dict — so they pass this unpickler; a JAX-written trainer checkpoint
names optax classes and is refused.

Every write is a ring-only ``ckpt.write`` span (flight-recorder evidence:
the last writes and how long they took) and carries the JAX writer's
fault points (``runtime/faultinject.py``: ``slow_io``, ``io_error`` and
``hang_between_ckpt_replaces``), one environment lookup when unarmed.

:class:`AsyncCheckpointWriter` (the JAX class: ``submit`` / ``wait`` /
context manager, at most one write in flight) moves the pickle, CRC and
fsync off the training loop's thread. Its partner is
:func:`host_snapshot`: the trainers and the grid update their tensors in
place (the GL prox writes the live block, Adam its moments, the epoch
engine replays into fixed storage), so what a background write reads must
be a copy, never a live tensor. A CUDA leaf is copied with
``non_blocking=True`` into pinned host memory on the current stream and
one CUDA event is recorded after the copies; the writer thread waits on
that event before it reads them. Later kernels on the stream (and the
epoch engine's replays, which wait on it) run after the copies, so an
asynchronous checkpoint holds the same bytes as a synchronous one.

stdlib + numpy at import; torch only inside :func:`host_snapshot`.
"""
from __future__ import annotations

import errno as _errno
import importlib
import io
import os
import pickle
import struct
import threading
import time
import warnings
import zlib

import numpy as np

from redcliff_tpu_torch.obs import spans as _spans
from redcliff_tpu_torch.runtime import watchdog as _watchdog

__all__ = ["CheckpointCorruptError", "CheckpointWriteError",
           "ForbiddenClassError", "PortUnpickler", "write_checkpoint",
           "read_checkpoint", "load_checkpoint", "quarantine",
           "dataset_fingerprint", "AsyncCheckpointWriter", "host_snapshot",
           "FORMAT_VERSION"]

MAGIC = b"RTCK"
FORMAT_VERSION = 1
_HEADER = struct.Struct("<4sIIQ")  # magic, version, crc32, payload_len

# config class name -> the port module that defines it; the JAX package's
# module of the same relative path maps to the same class
_CONFIG_CLASSES = {
    "RedcliffSCMLPConfig": "redcliff_tpu_torch.models.redcliff",
    "CMLPFMConfig": "redcliff_tpu_torch.models.cmlp_fm",
    "CLSTMFMConfig": "redcliff_tpu_torch.models.clstm_fm",
    "NAVARConfig": "redcliff_tpu_torch.models.navar",
    "NAVARLSTMConfig": "redcliff_tpu_torch.models.navar",
    "DGCNNConfig": "redcliff_tpu_torch.models.dgcnn",
    "DcsfaNmfConfig": "redcliff_tpu_torch.models.dcsfa_nmf",
    "DynotearsConfig": "redcliff_tpu_torch.models.dynotears",
    "DynotearsState": "redcliff_tpu_torch.models.dynotears",
}
_SAFE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "range", "set", "slice", "str", "tuple",
})


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file exists but fails header/CRC/unpickle validation."""


class ForbiddenClassError(pickle.UnpicklingError):
    """A checkpoint names a class the port does not unpickle."""


class CheckpointWriteError(RuntimeError):
    """A checkpoint could not be written durably (ENOSPC/EIO/permission...).
    The tmp file has been removed and existing generations are intact."""

    def __init__(self, path, cause):
        self.path = path
        self.errno = getattr(cause, "errno", None)
        hint = (" — disk full" if self.errno == _errno.ENOSPC else
                " — I/O error" if self.errno == _errno.EIO else "")
        super().__init__(
            f"could not write checkpoint {path}{hint}: {cause}")


class PortUnpickler(pickle.Unpickler):
    """numpy, safe builtins and the model configs; nothing else."""

    def find_class(self, module, name):
        port = _CONFIG_CLASSES.get(name)
        if port is not None and module in (
                port, port.replace("redcliff_tpu_torch", "redcliff_tpu", 1)):
            return getattr(importlib.import_module(port), name)
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise ForbiddenClassError(
            f"checkpoint names {module}.{name}, which the port does not "
            f"unpickle (allowed: numpy, builtins, the model configs "
            f"{sorted(_CONFIG_CLASSES)})")


class Opaque:
    """What :class:`ReaderUnpickler` makes of a class the port does not
    unpickle: the pickled arguments and state, kept as data and never
    run."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.state = args, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class ReaderUnpickler(PortUnpickler):
    """:class:`PortUnpickler` for readers that want a checkpoint's plain
    fields (the obs report's ``dispatch_stats``): a class it would refuse
    becomes :class:`Opaque`, so a JAX-written grid checkpoint (optax
    state) reads without importing or running anything of it."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except ForbiddenClassError:
            return Opaque


def _loads(data, opaque=False):
    cls = ReaderUnpickler if opaque else PortUnpickler
    return cls(io.BytesIO(data)).load()


def write_checkpoint(path, obj):
    """Atomically write ``obj`` to ``path`` with header+CRC, keeping the
    previous file as ``path + '.prev'``. The tmp file is fsynced before
    promotion; OS-level failures map to :class:`CheckpointWriteError`."""
    t_span0 = time.perf_counter()
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    header = _HEADER.pack(MAGIC, FORMAT_VERSION,
                          zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    armed = os.environ.get("REDCLIFF_FAULT_INJECT")
    try:
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(payload)
            if armed:
                from redcliff_tpu_torch.runtime import faultinject

                faultinject.io_point("ckpt_write")
                faultinject.io_error_point("ckpt_write")
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            os.replace(path, path + ".prev")
            # crash window: the head is gone and the new generation not
            # yet promoted — readers fall back to .prev; fault injection
            # can hold it open
            if armed:
                from redcliff_tpu_torch.runtime import faultinject

                faultinject.ckpt_write_point("between_replaces", path=path)
        os.replace(tmp, path)
        _spans.record_span("ckpt.write",
                           (time.perf_counter() - t_span0) * 1e3,
                           component="ckpt", file=os.path.basename(path),
                           bytes=len(payload))
    except OSError as e:
        try:
            os.remove(tmp)
        except OSError:
            pass
        _spans.record_span("ckpt.write",
                           (time.perf_counter() - t_span0) * 1e3,
                           component="ckpt", file=os.path.basename(path),
                           error=type(e).__name__)
        raise CheckpointWriteError(path, e) from e


def read_checkpoint(path, opaque=False):
    """Read + verify one checkpoint file. Raises FileNotFoundError if absent,
    :class:`ForbiddenClassError` for a class the port does not unpickle
    (with ``opaque`` such a class is read as :class:`Opaque` instead),
    :class:`CheckpointCorruptError` on any other validation failure."""
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if head[:4] != MAGIC:
            # legacy headerless pickle: no CRC to check; unpickle IS the test
            try:
                return _loads(head + f.read(), opaque)
            except ForbiddenClassError:
                raise
            except Exception as e:
                raise CheckpointCorruptError(
                    f"{path}: neither a versioned checkpoint (bad magic "
                    f"{head[:4]!r}) nor a loadable legacy pickle ({e!r})")
        if len(head) < _HEADER.size:
            raise CheckpointCorruptError(
                f"{path}: truncated header ({len(head)} bytes)")
        _, version, crc, length = _HEADER.unpack(head)
        if version > FORMAT_VERSION:
            raise CheckpointCorruptError(
                f"{path}: format version {version} is newer than supported "
                f"({FORMAT_VERSION})")
        payload = f.read(length + 1)  # +1 detects trailing garbage
        if len(payload) != length:
            raise CheckpointCorruptError(
                f"{path}: payload length {len(payload)} != header {length} "
                f"(truncated or overwritten)")
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise CheckpointCorruptError(f"{path}: CRC mismatch")
        try:
            return _loads(payload, opaque)
        except ForbiddenClassError:
            raise
        except Exception as e:
            raise CheckpointCorruptError(
                f"{path}: CRC-valid payload failed to unpickle ({e!r})")


def quarantine(path, reason):
    """Move a corrupt checkpoint aside to ``path + '.bad'`` with a warning
    (never deleted: the bytes are evidence)."""
    bad = path + ".bad"
    try:
        os.replace(path, bad)
        action = f"quarantined to {bad}"
    except OSError as e:
        action = f"could not quarantine ({e})"
    warnings.warn(f"corrupt checkpoint {path}: {reason}; {action}",
                  RuntimeWarning, stacklevel=3)
    return bad


def load_checkpoint(path, allow_quarantine=True, opaque=False):
    """Load the newest usable generation of ``path`` (``path``, then
    ``path + '.prev'``). Returns ``(obj, source_path)`` or ``(None, None)``
    when no usable generation exists. A corrupt generation is moved to
    ``*.bad`` (when ``allow_quarantine``; a reader passes False and it is
    skipped with a warning); ``opaque`` as :func:`read_checkpoint`."""
    for cand in (path, path + ".prev"):
        try:
            return read_checkpoint(cand, opaque), cand
        except FileNotFoundError:
            continue
        except CheckpointCorruptError as e:
            if allow_quarantine:
                quarantine(cand, str(e))
            else:
                warnings.warn(f"corrupt checkpoint {cand}: {e} (skipped)",
                              RuntimeWarning, stacklevel=2)
    return None, None


def host_snapshot(tree):
    """A host copy of every tensor in ``tree`` (dicts, lists and tuples
    walked; other leaves kept), taken now, and a ``ready()`` that blocks
    until the copies have landed. Contiguous CUDA tensors are copied
    without blocking into pinned host memory on their device's current
    stream, followed by one recorded event that ``ready()`` synchronizes
    on (any other CUDA tensor is copied at once); CPU tensors are cloned
    at once. Hand ``ready`` and the snapshot to a background thread
    (:class:`AsyncCheckpointWriter`): the live tensors may change as soon
    as this returns."""
    import torch

    from redcliff_tpu_torch.interop import tree_map

    devices = set()

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.is_cuda:
            if not x.is_contiguous():
                return x.cpu()  # blocking, laid out as .cpu() lays it out
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            out.copy_(x, non_blocking=True)
            devices.add(x.device)
            return out
        return x.clone()

    snap = tree_map(copy, tree)
    events = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)

    def ready():
        for ev in events:
            ev.synchronize()
    return snap, ready


class AsyncCheckpointWriter:
    """Background durable-checkpoint writer: at most one write in flight
    (the port of the JAX class).

    ``submit(fn)`` first waits for any previous write (the completion
    barrier: generations stay ordered and two writes can never race on one
    path's tmp file), then runs ``fn`` — a closure around
    :func:`write_checkpoint` over a :func:`host_snapshot` — on a background
    thread and returns. The main thread's wait at the barrier counts into
    ``obs.counters["ckpt_barrier_stall_ms"]`` and is a ring-only
    ``ckpt.submit_barrier`` span; the background write is a
    ``ckpt.async_write`` span, stamps the ``"ckpt_writer"`` heartbeat while
    it runs, and carries the ``hang_in:ckpt_writer`` fault point.

    ``wait()`` joins the in-flight write and re-raises anything it threw:
    :class:`CheckpointWriteError` (disk full / EIO) comes back typed,
    anything else as a ``RuntimeError`` from it. As a context manager the
    barrier runs on every exit; a background failure re-raises on a clean
    exit and is warned (not masked) while another exception propagates.
    Crash safety is the synchronous path's: :func:`write_checkpoint` is
    atomic with a ``.prev`` generation.
    """

    def __init__(self):
        self._thread = None
        self._err = None

    @property
    def in_flight(self):
        return self._thread is not None and self._thread.is_alive()

    def submit(self, fn):
        # the submit barrier: how long the MAIN thread stalls waiting for
        # the previous background write
        t_bar0 = time.perf_counter()
        self.wait()
        stall_ms = (time.perf_counter() - t_bar0) * 1e3
        _spans.COUNTERS.add("ckpt_barrier_stall_ms", stall_ms)
        _spans.record_span("ckpt.submit_barrier", stall_ms, component="ckpt")

        def run():
            # the writer heartbeats while a write is in flight and retires
            # after, so idle gaps between saves never read as a hang; a
            # wedged write goes stale and the watchdog escalates
            _watchdog.stamp("ckpt_writer")
            try:
                if os.environ.get("REDCLIFF_FAULT_INJECT"):
                    from redcliff_tpu_torch.runtime import faultinject

                    faultinject.hang_point("ckpt_writer")
                with _spans.span("ckpt.async_write", component="ckpt"):
                    fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                self._err = e
            finally:
                _watchdog.retire("ckpt_writer")

        self._thread = threading.Thread(target=run, name="ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self):
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        err, self._err = self._err, None
        if err is not None:
            if isinstance(err, CheckpointWriteError):
                raise err
            raise RuntimeError("background checkpoint write failed") from err

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.wait()
        else:
            try:
                self.wait()
            except RuntimeError:
                warnings.warn(
                    "background checkpoint write failed while another "
                    "exception was propagating", RuntimeWarning)
        return False


def dataset_fingerprint(ds):
    """A cheap shape-level identity for a dataset: enough to catch "resumed
    against different data" (the rng state would replay a different batch
    stream) without hashing the arrays. Works with ArrayDataset-style
    objects (``.X``/``.Y``) and falls back to ``len`` for anything else."""
    X = getattr(ds, "X", None)
    if X is not None:
        Y = getattr(ds, "Y", None)
        return {"X_shape": tuple(int(s) for s in np.shape(X)),
                "Y_shape": (None if Y is None
                            else tuple(int(s) for s in np.shape(Y)))}
    try:
        return {"len": len(ds)}
    except TypeError:
        return {"type": type(ds).__name__}
