"""Bounded profiler capture windows (port of
``redcliff_tpu/obs/profiling.py``).

A *capture window* brackets exactly the epochs asked for with a
``torch.profiler.profile`` started at the first epoch's start and stopped
at the last epoch's end (JAX: ``jax.profiler.start_trace`` /
``stop_trace``):

* ``profile_window`` (both trainers' configs) / env ``REDCLIFF_PROFILE``
  take a spec — ``"epoch:3"`` captures epoch 3 only, ``"epoch:2-4"`` an
  inclusive range; unset/``off`` disables (the shared :data:`NOOP` window,
  one no-op method call per epoch boundary);
* the profiler records CPU activity, and CUDA activity when the fit runs
  on a card, so the trace names every kernel launched in the window (the
  factor mix's and the GL prox's too, inside CUDA-graph replays); on a
  CPU device it records CPU activity alone;
* the window writes one Chrome trace, ``<out_dir>/profile_epoch<a>-<b>
  .json``, under ``<run_dir>/profile`` by default or under
  ``profile_dir``, and announces it with a schema-registered ``profile``
  event naming the file;
* ``profile_dir`` alone is an alias for one bounded steady-state window
  (epoch 1, or epoch 0 on one-epoch fits); an explicit off
  (``profile_window="off"`` / ``REDCLIFF_PROFILE=0``) beats the alias;
* a fit that ends inside an open window (early stop, exception,
  preemption) still closes the capture: the window is a context manager
  scoped around the fit, and ``finish`` / ``__exit__`` stop a live
  capture and mark its event ``truncated``.

Windows open and close at epoch boundaries only, so the fit's numbers are
the same with profiling on or off. Stopping a capture waits for the
device to finish the window's work (the profiler flushes its records).
torch is imported inside the start/stop methods only.

The first CUDA-graph launch of a capture session loses the records of
its first kernels: on an H100 (torch 2.11, CUDA 12.8) the loss mostly
grows with every traced grid fit in the process, up to 362 kernels in one
fit, always at the head of the window's first replay
(``tools/trace_primer_probe.py --no-primer`` counts it), and
neither a host sleep nor larger CUPTI device buffers moved it. So a CUDA
capture opens with a *primer*: a captured graph of :data:`PRIMER_KERNELS`
one-element adds per card that holds memory in this process, replayed on
the card's current stream right after the profiler starts. The primer
takes the loss and runs ahead of the window's work in stream order, so
the window's own kernels are recorded whole; the trace opens with the
primer's adds (``vectorized_elementwise_kernel``), which touch only their
own tensor. Nothing here calls a device sync (the profiler waits
for the card when it stops).
"""
from __future__ import annotations

import os
import time

__all__ = ["ENV_PROFILE", "parse_window", "CaptureWindow", "NOOP",
           "window_for"]

ENV_PROFILE = "REDCLIFF_PROFILE"
# kernels in a capture's primer graph, several times the largest loss seen
PRIMER_KERNELS = 2048
# card index -> (primer graph, the tensor it adds to), captured once
_PRIMERS = {}


def parse_window(spec):
    """Parse a capture-window spec into ``(first_epoch, last_epoch)`` or
    None (disabled). Accepted: ``"epoch:N"``, ``"epoch:N-M"`` (inclusive),
    and off-values (None/empty/``0``/``off``). Raises ValueError on
    malformed specs — a typo'd knob must fail loudly, not silently profile
    nothing."""
    if spec is None:
        return None
    spec = str(spec).strip().lower()
    if spec in ("", "0", "off", "false", "none"):
        return None
    kind, sep, rest = spec.partition(":")
    if kind != "epoch" or not sep:
        raise ValueError(
            f"unrecognized profile window spec {spec!r} (expected "
            f"'epoch:N' or 'epoch:N-M')")
    first, sep, last = rest.partition("-")
    try:
        a = int(first)
        b = int(last) if sep else a
    except ValueError:
        raise ValueError(f"non-integer epoch in profile window {spec!r}")
    if a < 0 or b < a:
        raise ValueError(f"invalid epoch range in profile window {spec!r}")
    return (a, b)


class _NoopWindow:
    """The shared disabled window: every hook is a no-op."""

    __slots__ = ()
    enabled = False

    def on_epoch_start(self, epoch):
        pass

    def on_epoch_end(self, epoch, logger=None):
        pass

    def finish(self, logger=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoopWindow()


class CaptureWindow:
    """One bounded profiler capture: starts at ``first_epoch``'s start,
    stops at ``last_epoch``'s end (or at fit teardown, marked truncated).
    ``cuda`` adds CUDA activity to the capture. Engines call the two epoch
    hooks from their loop and scope the window around the fit; ``path`` is
    the written trace once the capture has stopped."""

    enabled = True

    def __init__(self, out_dir, first_epoch, last_epoch, spec=None,
                 cuda=False):
        # absolute: the announcing `profile` event is read post-mortem from
        # other working directories
        self.out_dir = os.path.abspath(str(out_dir))
        self.first_epoch = int(first_epoch)
        self.last_epoch = int(last_epoch)
        self.spec = spec or f"epoch:{first_epoch}-{last_epoch}"
        self.cuda = bool(cuda)
        self.path = None
        self._prof = None
        self._done = False
        self._t0 = None
        self._started_epoch = None
        self._last_seen_epoch = None
        self._logger = None

    def on_epoch_start(self, epoch):
        """Start the capture when ``epoch`` enters the window. A resume
        that lands past ``first_epoch`` but inside the window captures its
        remaining window epochs; a resume past the window never starts
        it."""
        if self._prof is not None or self._done:
            return
        if self.first_epoch <= epoch <= self.last_epoch:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            primers = []
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                primers = _primers(torch)
            os.makedirs(self.out_dir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            for i, graph in primers:
                with torch.cuda.device(i):
                    graph.replay()
            self._started_epoch = epoch
            self._t0 = time.perf_counter()

    def on_epoch_end(self, epoch, logger=None):
        """Stop the capture when ``epoch`` closes the window; remembers the
        newest logger so a teardown stop can still announce the trace."""
        if logger is not None:
            self._logger = logger
        if self._prof is not None:
            self._last_seen_epoch = epoch
            if epoch >= self.last_epoch:
                self._stop(last_epoch=epoch, logger=logger)

    def _stop(self, last_epoch, logger=None, truncated=False):
        prof, self._prof = self._prof, None
        self._done = True
        prof.stop()
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        self.path = os.path.join(
            self.out_dir,
            f"profile_epoch{self._started_epoch}-{last_epoch}.json")
        prof.export_chrome_trace(self.path)
        logger = logger or self._logger
        if logger is not None and getattr(logger, "active", False):
            logger.log("profile", path=self.path, spec=self.spec,
                       first_epoch=self._started_epoch,
                       last_epoch=last_epoch, dur_ms=round(dur_ms, 3),
                       truncated=truncated)

    def finish(self, logger=None):
        """Close an open capture early (truncated) — engines call this
        BEFORE closing their MetricLogger on exits that leave the loop
        early, so the announcing `profile` event still lands; the context
        manager's ``__exit__`` then has nothing left to do."""
        if self._prof is not None:
            last = (self._last_seen_epoch
                    if self._last_seen_epoch is not None
                    else self._started_epoch)
            self._stop(last_epoch=last, logger=logger, truncated=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # the fit ended inside the window without a finish() (an exception
        # escaping the loop): close the capture so the trace is written
        self.finish()
        return False


def _primers(torch):
    """``[(index, graph)]``: the primer of every card that holds memory in
    this process, each captured on its first use, before the profiler
    starts."""
    return [_primer(torch, i) for i in range(torch.cuda.device_count())
            if torch.cuda.memory_reserved(i)]


def _primer(torch, index):
    """``(index, graph)``: card ``index``'s primer, captured once."""
    if index not in _PRIMERS:
        with torch.cuda.device(index):
            x = torch.zeros(1, device=f"cuda:{index}")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                x.add_(1.0)  # the add's first launch, outside the capture
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: a fit's background threads (the checkpoint
            # writer) may touch the card while the primer is captured
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                for _ in range(PRIMER_KERNELS):
                    x.add_(1.0)
        _PRIMERS[index] = (graph, x)
    return index, _PRIMERS[index][0]


def window_for(config, run_dir=None, max_iter=None, device=None):
    """Resolve the capture window for one fit from (in precedence order)
    ``config.profile_window``, the ``REDCLIFF_PROFILE`` environment
    variable, and the ``config.profile_dir`` alias (one bounded
    steady-state window: epoch 1, or epoch 0 when the fit has a single
    epoch). An EXPLICIT off spec disables profiling even when
    ``profile_dir`` is set. Returns the shared :data:`NOOP` when profiling
    is off or there is no output location (neither ``profile_dir`` nor a
    run dir). ``device`` is the fit's device: CUDA activity is captured on
    a card."""
    profile_dir = getattr(config, "profile_dir", None)
    spec = getattr(config, "profile_window", None)
    if spec is None:
        spec = os.environ.get(ENV_PROFILE)
    if spec is not None:
        win = parse_window(spec)
        if win is None:
            return NOOP  # explicit off — do not fall through to the alias
    else:
        win = None
    if win is None:
        if not profile_dir:
            return NOOP
        # profile_dir alias: one bounded window at the first steady-state
        # epoch (epoch 0 carries the one-time work the window should skip)
        last = (max_iter - 1) if max_iter is not None else 1
        e = min(1, max(last, 0))
        win = (e, e)
        spec = f"epoch:{e}"
    out_dir = profile_dir or (os.path.join(run_dir, "profile")
                              if run_dir else None)
    if out_dir is None:
        return NOOP
    cuda = device is not None and getattr(device, "type", str(device)) \
        .startswith("cuda")
    return CaptureWindow(out_dir, win[0], win[1], spec=str(spec), cuda=cuda)
