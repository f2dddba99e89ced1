"""The fused group-lasso proximal update (port of ``ops/pallas_prox.py``;
the file keeps its counterpart's name).

* :func:`gl_prox` — the functional dispatch, as in JAX: GL on a CUDA
  tensor launches the hand-written kernel in ``csrc/gl_prox.cu`` into a new
  tensor; GL on a CPU tensor takes the plain version
  (:func:`ops.prox.prox_update`); GSGL and H are plain on every device, as
  in the JAX package.
* :func:`gl_prox_` — the same update in place, which the training step
  uses: GL on a CUDA tensor launches the kernel with its output aliasing
  the input (one launch, no allocation, no copy); otherwise the plain
  result is written back with ``copy_``.
* :func:`gl_prox_lanes_` — the coefficient grid's form, in place on the
  stacked block ``(G, ..., H, C_in, L)`` with a per-lane threshold and a
  per-lane gate, both device tensors (:func:`lane_thresholds` makes the
  thresholds as the JAX grid does, a float32 product on the device). GL
  on a CUDA tensor is one launch of the same kernel for every lane, the
  gate read on the device; otherwise the plain lane version
  (:func:`gl_prox_lanes_reference`) is written back.
* :func:`prox_plan` — the kernel's launch plan (chunk of a slab staged in
  shared memory, TMA path or not, threads per block), a pure function of
  the shape, the alignment and, when ``ops/autotune.py`` holds a winner
  for the shape, its threads per block (read once per shape, when the plan
  cache is filled; never per launch).
* ``gl_prox.launches`` — a plain int, one per execution of the kernel on
  the device, from any form. A launch captured into a CUDA graph adds to
  ``gl_prox.captured`` instead, and each replay of the graph adds the
  launches it captured (``parallel/epoch_engine.py``).

There is no fallback: a CUDA tensor the kernel does not take (not float32,
not contiguous, rank < 3) raises. The kernel is built at first use into
``build/torch_kernels/redcliff_gl_prox/`` (``ops/cuda_build.py``);
importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading

import torch

from redcliff_tpu_torch.ops.cuda_build import build_library
from redcliff_tpu_torch.ops.prox import prox_update, prox_update_at, threshold

__all__ = ["gl_prox", "gl_prox_", "gl_prox_reference", "gl_prox_lanes_",
           "gl_prox_lanes_reference", "lane_thresholds", "load_kernel",
           "prox_plan", "launch_plan", "KERNEL_SOURCE"]

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "csrc", "gl_prox.cu")
# shared memory a block may take without opting in is 48 KB in all; less
# the kernel's 64 bytes of static shared memory (its mbarrier), it holds the
# staged chunk and two floats per group
_SMEM_FLOATS = (48 * 1024 - 64) // 4
# slabs are grid blocks, and in-slab indices are 32-bit
_MAX_LEAD = _MAX_INDEX = 2 ** 31 - 1

_lib = None
_fn = None
_fn_lanes = None
_raw_stream = None
_capturing = None
_lib_lock = threading.Lock()


def gl_prox_reference(W1, lam, lr):
    """Plain version of the GL prox."""
    return prox_update(W1, lam, lr, "GL")


def prox_plan(H, C, L, offset, threads=None):
    """``(chunk, bulk, threads)`` for a slab of ``H*C*L`` floats: the
    kernel stages
    ``chunk`` floats of a slab in shared memory at a time (the whole slab
    when it fits beside the ``2*C`` per-group floats in 48 KB, else chunks
    of the largest multiple of 4 that does); ``bulk`` is the TMA bulk copy
    and float4 path, taken when ``offset`` (the input's and output's
    addresses, or-ed, modulo 16) is 0 and the slab is a whole number of
    16-byte units, so every slab and chunk starts 16-byte aligned;
    ``threads`` gives the block one warp per group, 4 to 16 warps, unless
    a tuned plan's ``threads`` is given (a block with fewer warps than
    groups walks them in turn). Raises when the per-group floats alone
    leave no room (C_in > 6134) or a slab holds 2**31 floats or more."""
    S = H * C * L
    cap = (_SMEM_FLOATS - 2 * C) // 4 * 4
    if cap < 4:
        raise ValueError(f"gl_prox kernel takes C_in <= "
                         f"{(_SMEM_FLOATS - 4) // 2}, got {C}")
    if S > _MAX_INDEX:
        raise ValueError(f"gl_prox kernel takes slabs H*C_in*L below 2**31 "
                         f"floats, got {S}")
    if threads is None:
        threads = 32 * min(max(C, 4), 16)
    return min(S, cap), offset == 0 and S % 4 == 0, threads


class _ProxArgs(ctypes.Structure):
    """The launch's shape and plan: ``ProxArgs`` of csrc/gl_prox.cu, field
    for field. One per shape (cached), so a launch converts five or six
    ctypes arguments, not twelve or fourteen."""

    _fields_ = [("lead", ctypes.c_longlong), ("H", ctypes.c_int),
                ("C", ctypes.c_int), ("L", ctypes.c_int),
                ("chunk", ctypes.c_int), ("bulk", ctypes.c_int),
                ("threads", ctypes.c_int), ("device", ctypes.c_int),
                ("slabs_per_lane", ctypes.c_longlong)]


@functools.lru_cache(maxsize=256)
def _prox_args(lead, H, C, L, offset, device, slabs_per_lane=0):
    """``(_ProxArgs, its address)`` for one launch shape on ``device``;
    ``slabs_per_lane`` for the lane entry. The plan's threads are the
    autotuner's winner for the shape when it holds one."""
    from redcliff_tpu_torch.ops import autotune

    chunk, bulk, threads = prox_plan(
        H, C, L, offset, threads=autotune.plan_threads(
            *autotune.prox_key(lead, H, C, L, slabs_per_lane)))
    args = _ProxArgs(lead, H, C, L, chunk, int(bulk), threads, device,
                     slabs_per_lane)
    return args, ctypes.addressof(args)


def load_kernel():
    """Build (first call in a process; cached by content on disk) and bind
    the CUDA kernel. Returns the ctypes library."""
    global _lib, _fn, _fn_lanes, _raw_stream, _capturing
    with _lib_lock:
        if _lib is None:
            lib = build_library("redcliff_gl_prox", KERNEL_SOURCE)
            fn = lib.redcliff_gl_prox_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn_lanes = lib.redcliff_gl_prox_lanes_f32
            fn_lanes.argtypes = [ctypes.c_void_p] * 6
            fn_lanes.restype = ctypes.c_int
            # the current stream's cudaStream_t of a device, as an int
            _raw_stream = torch._C._cuda_getCurrentRawStream
            # whether the current stream is capturing a CUDA graph
            _capturing = torch._C._cuda_isCurrentStreamCapturing
            _fn, _fn_lanes, _lib = fn, fn_lanes, lib
        return _lib


def _check_block(W1):
    """Raise unless ``W1`` is a block the kernel takes: a contiguous
    float32 CUDA tensor of rank 3 or more."""
    if not (W1.is_cuda and W1.dtype is torch.float32 and W1.dim() >= 3
            and W1.is_contiguous()):
        if not W1.is_cuda:
            raise ValueError(f"gl_prox kernel needs a CUDA tensor, got "
                             f"{W1.device}")
        if W1.dtype != torch.float32:
            raise TypeError(f"gl_prox kernel takes float32, got {W1.dtype}")
        if W1.dim() < 3:
            raise ValueError(f"gl_prox wants a (..., H, C_in, L) block, got "
                             f"shape {tuple(W1.shape)}")
        raise ValueError("gl_prox kernel needs a contiguous block")


def _count():
    """One launch: an execution now, or a launch into the CUDA graph the
    current stream is capturing."""
    if _capturing():
        gl_prox.captured += 1
    else:
        gl_prox.launches += 1


def _launch(W1, lam, lr, out=None):
    """Run the kernel on a contiguous float32 CUDA block
    ``(lead..., H, C_in, L)`` into ``out`` (a new tensor when None; ``W1``
    itself for the in-place update). Returns ``out``."""
    _check_block(W1)
    if out is None:
        out = torch.empty_like(W1)
    numel = W1.numel()
    if numel == 0:
        return out
    *_, H, C, L = W1.shape
    lead = numel // (H * C * L)
    if lead > _MAX_LEAD:
        raise ValueError(f"gl_prox kernel takes at most {_MAX_LEAD} leading "
                         f"slabs, got {lead}")
    if _fn is None:
        load_kernel()
    w_ptr, out_ptr = W1.data_ptr(), out.data_ptr()
    dev = W1.get_device()
    args = _prox_args(lead, H, C, L, (w_ptr | out_ptr) % 16, dev)
    rc = _fn(w_ptr, out_ptr, args[1], threshold(lam, lr), _raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"gl_prox kernel launch failed: cudaError {rc}")
    _count()
    return out


def launch_plan(W1, lanes=False, out=None):
    """``(chunk, bulk, threads)`` of the cached plan a launch on the CUDA
    block ``W1`` takes: in place (``out`` None) or into ``out``; with
    ``lanes`` the lane form over ``W1 (G, ...)``."""
    _check_block(W1)
    *_, H, C, L = W1.shape
    lead = W1.numel() // (H * C * L)
    out_ptr = W1.data_ptr() if out is None else out.data_ptr()
    offset = (W1.data_ptr() % 16 if lanes
              else (W1.data_ptr() | out_ptr) % 16)
    args = _prox_args(lead, H, C, L, offset, W1.get_device(),
                      lead // W1.shape[0] if lanes else 0)[0]
    return args.chunk, bool(args.bulk), args.threads


def gl_prox(W1, lam, lr, penalty="GL"):
    """Proximal update of a first-layer block ``(..., H, C_in, L)`` into a
    new tensor: the CUDA kernel for GL on CUDA tensors, the plain version
    otherwise."""
    if penalty == "GL" and W1.is_cuda:
        return _launch(W1, lam, lr)
    return prox_update(W1, lam, lr, penalty)


gl_prox.launches = 0
gl_prox.captured = 0


def gl_prox_(W1, lam, lr, penalty="GL"):
    """:func:`gl_prox` in place on ``W1``; returns ``W1``. Call it under
    ``torch.no_grad()`` on a leaf that requires grad, as for any in-place
    update of a parameter. The kernel writes through the data pointer, so
    the tensor's version counter is bumped by hand: autograd then refuses a
    backward through a graph that saved the old values."""
    if penalty == "GL" and W1.is_cuda:
        _launch(W1, lam, lr, out=W1)
        torch.autograd.graph.increment_version(W1)
    else:
        W1.copy_(prox_update(W1, lam, lr, penalty))
    return W1


def lane_thresholds(lr, lam):
    """Per-lane thresholds ``lr * lam`` for the lane learning rates ``lr``
    (a ``(G,)`` tensor): the float32 product on ``lr``'s device, as the
    JAX grid computes ``lr * lam`` with a float32 ``lr`` under vmap (the
    per-point :func:`threshold` rounds a double product instead; the two
    can differ in the last bit)."""
    lr = lr.to(torch.float32)
    return lr * torch.tensor(lam, dtype=torch.float32, device=lr.device)


def _lane_view(x, W):
    """A ``(G,)`` per-lane tensor shaped to broadcast against ``W``."""
    return x.reshape((-1,) + (1,) * (W.dim() - 1))


def gl_prox_lanes_reference(W, t, gate, penalty="GL"):
    """Plain lane version: each lane of ``W (G, ..., H, C_in, L)`` takes
    the prox at its threshold ``t[g]`` where ``gate[g]``, and stays as it
    is elsewhere. Functional: returns a new tensor."""
    new = prox_update_at(W, _lane_view(t, W), penalty)
    return torch.where(_lane_view(gate, W), new, W)


def gl_prox_lanes_(W, t, gate, penalty="GL"):
    """:func:`gl_prox_lanes_reference` in place on ``W``; returns ``W``.
    ``t`` is the ``(G,)`` float32 thresholds (:func:`lane_thresholds`),
    ``gate`` the ``(G,)`` bool gate, both on ``W``'s device. GL on a CUDA
    tensor is one kernel launch for all lanes that reads ``t`` and
    ``gate`` on the device (no host sync); the version counter is bumped
    as in :func:`gl_prox_`. Call under ``torch.no_grad()``."""
    if penalty == "GL" and W.is_cuda:
        _launch_lanes(W, t, gate)
        torch.autograd.graph.increment_version(W)
    else:
        W.copy_(gl_prox_lanes_reference(W, t, gate, penalty))
    return W


def _launch_lanes(W, t, gate):
    """Run the kernel in place on the stacked block ``W (G, lead...,
    H, C_in, L)`` with per-lane thresholds ``t`` and gate ``gate``."""
    _check_block(W)
    if W.dim() < 4:
        raise ValueError(f"gl_prox_lanes_ wants a (G, ..., H, C_in, L) "
                         f"block, got shape {tuple(W.shape)}")
    G = W.shape[0]
    if not (t.is_cuda and gate.is_cuda and t.get_device() == W.get_device()
            and gate.get_device() == W.get_device()
            and t.dtype is torch.float32 and gate.dtype is torch.bool
            and t.shape == (G,) and gate.shape == (G,)
            and t.is_contiguous() and gate.is_contiguous()):
        raise ValueError(
            f"gl_prox_lanes_ wants (G,) = ({G},) float32 thresholds and a "
            f"bool gate, contiguous, on {W.device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} and {gate.dtype} "
            f"{tuple(gate.shape)} on {gate.device}")
    numel = W.numel()
    if numel == 0:
        return W
    *_, H, C, L = W.shape
    lead = numel // (H * C * L)
    if lead > _MAX_LEAD:
        raise ValueError(f"gl_prox kernel takes at most {_MAX_LEAD} leading "
                         f"slabs, got {lead}")
    if _fn_lanes is None:
        load_kernel()
    w_ptr = W.data_ptr()
    dev = W.get_device()
    args = _prox_args(lead, H, C, L, w_ptr % 16, dev, lead // G)
    rc = _fn_lanes(w_ptr, w_ptr, args[1], t.data_ptr(), gate.data_ptr(),
                   _raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"gl_prox kernel launch failed: cudaError {rc}")
    _count()
    return W
