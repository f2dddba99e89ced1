"""The grid's epoch engine: the JAX stream modes as CUDA-graph replays of
the grid step (port of the scanned dispatches of ``parallel/grid.py``:
``scan_step``, ``epoch_step`` and ``val_scan``,
``redcliff_tpu/parallel/grid.py:571-652``, and of the epoch loop's mode
branches, ``:1690-1830``).

A :class:`Program` is ``n`` consecutive steps of one phase at one width:
``n`` guarded, lane-gated grid steps (``RedcliffGridRunner._step``), or
``n`` validation batches summed in order from zero. Each step takes its
batch in the program, either gathered with ``index_select`` from the
device-resident dataset through a static ``(n, B)`` int64 index buffer
(the epoch modes: the epoch's plan, copied in from pinned host memory
before the run, as JAX's ``epoch_step`` takes a device index array), or
read from static ``(n, B, ...)`` buffers the batches are copied into (the
k-batch mode, as JAX's ``scan_step`` takes k stacked batches).

* On a CUDA device a program is captured once into a
  ``torch.cuda.CUDAGraph`` and then replayed: the ``n`` steps cost one
  launch from the host. The capture is preceded by one warm-up step on
  the capture stream (the lazy initialisations of cuBLAS and the kernel
  modules must not happen inside a capture) whose writes to the state are
  undone; its kernel launches ran on the device and are counted.
  There is no eager fallback: a program that cannot be captured raises.
  The capture is thread-local, so a prefetch thread may copy batches
  meanwhile.
* On the CPU the same body runs eagerly at every call. This is the
  program's plain version, as each kernel has its own, and the CPU tests
  drive it.

A program reads and writes fixed storage: the params, both Adam states
and the numerics counters are updated in place by the step, the lane gate
is read from the engine's ``active`` buffer, and the era's coefficients,
learning rates and thresholds are the runner's ``_ex_*`` tensors. Before
each run the program checks that every one of them is still the tensor it
was first run on (``data_ptr``) and raises if one has moved. Programs are
cached per compaction era, keyed by (kind, phase, steps, rows), and share
one graph memory pool within the era; :meth:`EpochEngine.new_era` drops
them (compaction gathers fresh leaves; a resume loads new ones).

Kernel launch counts (``factor_mix.launches``, ``gl_prox.launches``) keep
meaning executions on the device: a launch made while the stream is
capturing is recorded by the program, and each replay adds the program's
captured launches.

Every program run and eager step is a ring-only ``grid.dispatch`` span
(host enqueue time), and every capture counts into
``runtime/compileobs.py`` (the grid's ``compile`` events) and runs under
the watchdog's op-scoped ``compile`` heartbeat (``runtime/watchdog.py``),
which excuses the loop's own heartbeats while it lasts; the k-batch loop
stamps ``batch_loop`` per batch.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from redcliff_tpu_torch.data import pipeline
from redcliff_tpu_torch.interop import tree_leaves
from redcliff_tpu_torch.ops import factor_mix as _factor_mix
from redcliff_tpu_torch.ops import pallas_prox as _pallas_prox
from redcliff_tpu_torch.runtime import compileobs
from redcliff_tpu_torch.runtime import watchdog as _watchdog

__all__ = ["Program", "EpochEngine", "COUNTED"]

# the launch-counted kernel wrappers (their ``launches`` and ``captured``)
COUNTED = (_factor_mix.factor_mix, _pallas_prox.gl_prox)


class Program:
    """``steps`` steps of ``body(inputs, steps, state)`` on fixed storage.

    ``inputs`` is a dict of static tensors the body takes its batches from
    (:meth:`load` fills them), ``reads()`` the other tensors it reads (the
    dataset, the gate buffer, the era's coefficients), ``state`` the tuple
    of trees it reads and may write in place. On CUDA ``pool`` and
    ``stream`` are the era's graph memory pool and the capture stream."""

    def __init__(self, body, steps, inputs, reads, device, pool=None,
                 stream=None):
        self.body = body
        self.steps = steps
        self.inputs = inputs
        self._reads = reads
        self.device = device
        self.pool = pool
        self.stream = stream
        self.graph = None
        self.out = None
        self.pointers = None
        # (counted wrapper, launches) captured per replay
        self.tally = ()
        self.capture_ms = None

    def _leaves(self, state):
        return (tree_leaves(state) + list(self._reads())
                + list(self.inputs.values()))

    def load(self, **arrays):
        """Copy this run's batches into the static inputs: ``idx`` a numpy
        ``(steps, rows)`` index plan (through pinned host memory on CUDA:
        a fresh pinned block per call, which the host allocator keeps
        until its copy has run), or ``X``/``Y`` the ``steps`` staged
        batches."""
        for name, value in arrays.items():
            dst = self.inputs[name]
            if name == "idx":
                src = torch.from_numpy(np.ascontiguousarray(value,
                                                            dtype=np.int64))
                if self.device.type == "cuda":
                    src = src.pin_memory()
                dst.copy_(src, non_blocking=True)
            else:
                for i, batch in enumerate(value):
                    dst[i].copy_(batch)

    def run(self, state):
        """Run every step once: the eager body on the CPU, a replay of the
        captured graph on CUDA (captured at the first run). Raises when a
        tensor the program reads or writes is not the one it first ran
        on."""
        ptrs = [t.data_ptr() for t in self._leaves(state)]
        if self.pointers is None:
            self.pointers = ptrs
            if self.device.type == "cuda":
                self._capture(state)
        elif ptrs != self.pointers:
            raise RuntimeError(
                "a tensor the captured program reads or writes has moved "
                "since its capture (params, Adam state, numerics counters, "
                "gate, coefficients or dataset rebound within an era); "
                "update them in place or start a new era")
        if self.device.type != "cuda":
            return self.body(self.inputs, self.steps, state)
        self.graph.replay()
        for fn, n in self.tally:
            fn.launches += n
        return self.out

    def _capture(self, state):
        t0 = time.perf_counter()
        writes = tree_leaves(state)
        with torch.no_grad():
            saved = [t.clone() for t in writes]
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            # warm-up: one step, every kernel of the program once, outside
            # any capture; its writes are undone below
            self.body(self.inputs, 1, state)
        cur.wait_stream(self.stream)
        with torch.no_grad():
            for t, v in zip(writes, saved):
                t.copy_(v)
        del saved
        graph = torch.cuda.CUDAGraph()
        before = [fn.captured for fn in COUNTED]
        # "thread_local": a call that is unsafe in a capture still raises
        # when this thread makes it, while the prefetch thread of a dataset
        # with no device copy (the k-batch mode) goes on copying the next
        # batches on its own stream. A CUDA graph destroyed during the
        # capture (an earlier fit's program, freed when the collector finds
        # its reference cycle) invalidates it: collect first, and hold the
        # collector off until the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = self.body(self.inputs, self.steps, state)
        finally:
            if collecting:
                gc.enable()
        self.tally = tuple((fn, fn.captured - b)
                           for fn, b in zip(COUNTED, before))
        self.graph, self.out = graph, out
        self.capture_ms = (time.perf_counter() - t0) * 1e3


class EpochEngine:
    """The stream modes of one grid fit (``RedcliffGridRunner._fit``):
    ``"epoch"`` runs a single-phase epoch as one program over the full
    batches plus one over the short remainder, and validation as one
    program over the full validation batches plus one for the remainder;
    ``"kscan"`` runs one program per full group of ``scan_batches``
    batches, the partial trailing group and the remainder as eager steps
    in order; ``"per_batch"`` (and every multi-phase epoch) is the
    runner's eager loop. ``stats`` is the fit's ``dispatch_stats``."""

    def __init__(self, runner, mode, train_ds, val_ds, stats):
        self.runner = runner
        self.mode = mode
        self.device = runner.device
        self.stats = stats
        tc = runner.tc
        self.batch_size = tc.batch_size
        self.scan_batches = tc.scan_batches
        self.Xd = self.Yd = None
        if mode == "epoch":
            self.Xd, self.Yd = train_ds.device_arrays(self.device)
        # validation rides the epoch engine too (the JAX val_scan rule):
        # a fixed plan over a device-resident validation set with labels
        self.val_plan = None
        val_bytes = pipeline.dataset_device_bytes(val_ds)
        if (mode == "epoch"
                and getattr(val_ds, "supports_device_batches", False)
                and getattr(val_ds, "Y", None) is not None
                and len(val_ds) >= self.batch_size
                and val_bytes is not None
                and val_bytes <= pipeline.DEFAULT_MAX_DEVICE_DATASET_BYTES):
            self.vXd, self.vYd = val_ds.device_arrays(self.device)
            self.val_plan = pipeline.epoch_batch_plan(len(val_ds),
                                                      self.batch_size)
        self.stream = None
        if self.device.type == "cuda" and mode != "per_batch":
            # both kernels built and loaded before any capture
            _factor_mix.load_kernel()
            if runner._prox_pen == "GL":
                _pallas_prox.load_kernel()
            self.stream = torch.cuda.Stream(self.device)
        self.programs = {}
        self.active = None
        self.pool = None

    def new_era(self, width):
        """Drop the programs of the previous era (their leaves are gone)
        and make the gate buffer and the graph pool of this one."""
        self.programs = {}
        self.active = torch.zeros((width,), dtype=torch.bool,
                                  device=self.device)
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.stream is not None else None)

    def holds(self, width):
        """Whether running at ``width`` needs no capture: this engine
        captures nothing (the CPU, or the per-batch stream), or it already
        holds programs of this era at ``width``."""
        return self.stream is None or bool(
            self.programs and self.active is not None
            and int(self.active.shape[0]) == int(width))

    def _reads(self, *data):
        r = self.runner
        out = [t for t in data if t is not None] + [self.active]
        out += list(r._ex_coeffs.values()) + list(r._ex_lr64.values())
        if r._ex_prox_t is not None:
            out.append(r._ex_prox_t)
        return out

    def _dispatch(self, key, make, state, **batches):
        """Load ``batches`` into the program ``key`` = (kind, phase, steps,
        rows), made by ``make()`` at its first use in the era, run it once
        on ``state`` and count the dispatch; returns its outputs."""
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = make()
        fresh = prog.pointers is None
        kind, phase, steps, rows = key
        # a first run on the card captures: the op-scoped `compile`
        # heartbeat excuses the loop's own while it lasts
        scope = (_watchdog.op_scope(_watchdog.COMPILE_COMPONENT)
                 if fresh and self.stream is not None
                 else contextlib.nullcontext())
        with self.runner._dispatch_span(kind, cold=fresh), scope:
            prog.load(**batches)
            out = prog.run(state)
        self.stats["val_dispatches" if kind == "val"
                   else "train_dispatches"] += 1
        if fresh and prog.capture_ms is not None:
            compileobs.note_capture(prog.capture_ms)
            self.stats["graph_captures"] += 1
            self.stats["capture_ms"] += prog.capture_ms
            self.stats["programs"].append({
                "kind": kind, "phase": phase, "steps": steps, "rows": rows,
                "width": int(self.active.shape[0]),
                "capture_ms": prog.capture_ms,
                "launches_per_replay": {fn.__name__: n
                                        for fn, n in prog.tally}})
        return out

    # ------------------------------------------------------------- training
    def _train_body(self, phase):
        runner = self.runner

        def body(inputs, steps, state):
            params, optA, optB, nstate = state
            for i in range(steps):
                if "idx" in inputs:
                    sel = inputs["idx"][i]
                    X = self.Xd.index_select(0, sel)
                    Y = self.Yd.index_select(0, sel)
                else:
                    X, Y = inputs["X"][i], inputs["Y"][i]
                runner._step(phase, params, optA, optB, nstate, self.active,
                             X, Y)
        return body

    def _index_buffer(self, steps, rows):
        return {"idx": torch.zeros((steps, rows), dtype=torch.int64,
                                   device=self.device)}

    def _indexed(self, phase, plan, state):
        """One run of the ("train", phase, steps, rows) program over the
        ``(steps, rows)`` index plan ``plan``."""
        steps, rows = plan.shape
        self._dispatch(("train", phase, steps, rows), lambda: Program(
            self._train_body(phase), steps, self._index_buffer(steps, rows),
            lambda: self._reads(self.Xd, self.Yd), self.device,
            pool=self.pool, stream=self.stream), state, idx=plan)

    def _staged(self, phase, group, state):
        """One run of the k-batch program over the batches of ``group``,
        copied into its buffers."""
        k = len(group)
        X0, Y0 = group[0]

        def make():
            buffers = {name: torch.empty((k,) + tuple(t.shape),
                                         dtype=t.dtype, device=self.device)
                       for name, t in (("X", X0), ("Y", Y0))}
            return Program(self._train_body(phase), k, buffers,
                           self._reads, self.device, pool=self.pool,
                           stream=self.stream)
        self._dispatch(("kscan", phase, k, int(X0.shape[0])), make, state,
                       X=[x for x, _ in group], Y=[y for _, y in group])

    def _eager_step(self, phase, state, X, Y):
        with self.runner._dispatch_span("step"):
            self.runner._step(phase, *state, self.active, X, Y)
        self.stats["train_dispatches"] += 1

    def train_epoch(self, mode, phase, state, active, train_ds, rng):
        """One single-phase epoch of ``phase`` in ``mode`` ("epoch" or
        "kscan") on ``state = (params, optA, optB, nstate)``, in place,
        gated by ``active``. Consumes ``rng`` exactly as the per-batch
        loop does."""
        self.active.copy_(active)
        B = self.batch_size
        if mode == "epoch":
            full, rem = pipeline.epoch_batch_plan(len(train_ds), B, rng=rng)
            self._indexed(phase, full, state)
            if len(rem):
                self._indexed(phase, rem[None], state)
            return
        # kscan: full groups of k replay; a short or label-less batch first
        # flushes the partial group eagerly, in order
        k = self.scan_batches
        group = []
        for X, Y in self.runner._batches(train_ds, rng=rng):
            _watchdog.stamp("batch_loop")
            if Y is None or X.shape[0] != B:
                for Xg, Yg in group:
                    self._eager_step(phase, state, Xg, Yg)
                group = []
                self._eager_step(phase, state, X, Y)
                continue
            group.append((X, Y))
            if len(group) == k:
                self._staged(phase, group, state)
                group = []
        for Xg, Yg in group:
            self._eager_step(phase, state, Xg, Yg)
        _watchdog.retire("batch_loop")

    # ----------------------------------------------------------- validation
    def _val_body(self):
        runner = self.runner

        def body(inputs, steps, state):
            params, = state
            zero = torch.zeros(self.active.shape, device=self.device)
            combo_sum, forecast_sum, factor_sum = zero, zero, zero
            with torch.no_grad():
                for i in range(steps):
                    sel = inputs["idx"][i]
                    combo, fo, fa = runner._val(
                        params, runner._ex_loss_coeffs,
                        self.vXd.index_select(0, sel),
                        self.vYd.index_select(0, sel))
                    combo_sum = combo_sum + combo
                    forecast_sum = forecast_sum + fo
                    factor_sum = factor_sum + fa
            return combo_sum, forecast_sum, factor_sum
        return body

    def _val_program(self, plan, params):
        steps, rows = plan.shape
        out = self._dispatch(("val", "val", steps, rows), lambda: Program(
            self._val_body(), steps, self._index_buffer(steps, rows),
            lambda: self._reads(self.vXd, self.vYd), self.device,
            pool=self.pool, stream=self.stream), (params,), idx=plan)
        # the replayed graph owns its outputs: the next replay rewrites them
        return tuple(t.clone() for t in out)

    def validate(self, params, val_ds):
        """``(combo_sum, forecast_sum, factor_sum, n)`` over the validation
        set: per-batch sums from zero, in batch order, as ``(G,)``
        tensors, and the batch count."""
        runner = self.runner
        if self.val_plan is not None:
            full, rem = self.val_plan
            sums = self._val_program(full, params)
            n = len(full)
            if len(rem):
                # (0 + c_rem) is c_rem: the sums stay the per-batch ones
                sums = tuple(a + b for a, b in zip(
                    sums, self._val_program(rem[None], params)))
                n += 1
            return sums + (n,)
        zero = torch.zeros(self.active.shape, device=self.device)
        combo_sum, forecast_sum, factor_sum = zero, zero, zero
        n = 0
        with torch.no_grad():
            for X, Y in runner._batches(val_ds):
                with runner._dispatch_span("val"):
                    combo, fo, fa = runner._val(params,
                                                runner._ex_loss_coeffs, X, Y)
                self.stats["val_dispatches"] += 1
                combo_sum = combo_sum + combo
                forecast_sum = forecast_sum + fo
                factor_sum = factor_sum + fa
                n += 1
        return combo_sum, forecast_sum, factor_sum, n
