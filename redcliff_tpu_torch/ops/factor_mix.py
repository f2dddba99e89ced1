"""Factor mix: embedder-weighted mixing of per-factor predictions
(port of ``ops/factor_mix.py``).

    combined[b, t, c] = sum_k weightings[b, k] * preds[k, b, t, c]

* :func:`factor_mix_reference` / :func:`graph_mix_reference` — the plain
  PyTorch versions (einsums). The CPU path and the tests use them; nothing
  on the card path does.
* :func:`factor_mix` / :func:`graph_mix` — on a CUDA tensor they launch the
  hand-written kernel in ``csrc/factor_mix.cu``; on a CPU tensor they call
  the plain version. There is no fallback: a CUDA tensor the kernel does not
  take raises.
* :func:`factor_mix_lanes` / :func:`factor_mix_lanes_reference` — the lane
  form for the coefficient grid, ``out[g, b] = sum_k w[g, b, k] p[g, k, b]``:
  one launch of the same kernel for all G lanes (its second grid dimension)
  on CUDA tensors, the plain einsum on CPU tensors.
* :class:`FactorMixFn` — the ``torch.autograd.Function`` around the kernel,
  mirroring the JAX custom VJP: forward is the kernel, backward is the two
  einsums of ``_mix_bwd`` (plain in the JAX package too). It has the
  ``setup_context`` form, so ``torch.func`` transforms take it, and a
  ``vmap`` rule that runs the lane form on the stacked operands (the JAX
  package gets the same from ``jax.vmap`` over ``pallas_call``, whose
  batching rule adds a grid axis). The wrappers take it when a gradient is
  wanted (grad mode on and an operand that requires grad) or the operands
  are ``torch.func`` tensors; otherwise they launch the kernel directly.
* :func:`mix_plan` — the kernel's launch plan (vector width, threads,
  blocks), a pure function of the shapes, strides, alignment and, when
  ``ops/autotune.py`` holds a winner for the shape, its threads per block
  (read once per shape, when the plan cache is filled; never per launch).
* ``factor_mix.launches`` — a plain int, one per execution of the kernel
  on the device, lane launches included. A launch made while the current
  stream is capturing a CUDA graph runs nothing yet: it adds to
  ``factor_mix.captured`` instead, and each replay of the graph adds the
  launches it captured (``parallel/epoch_engine.py``).

The launch path is kept short because at the main path's shapes the launch,
not the device work, is the cost (PERF.md): one pass of checks, no
``torch.cuda.device`` context (the C entry takes the device index and
switches only when it is not the current one), the raw stream handle, and a
ctypes function bound once with its ``argtypes`` and called with five
arguments (the shapes, strides and plan travel in one struct made once per
shape, since ctypes pays per argument). The serve blend passes its graphs
with ``stride_b = 0`` straight to the launch, without a view.

The kernel is built from the repository's source at first use into
``build/torch_kernels/redcliff_factor_mix/`` (``ops/cuda_build.py``), for
``sm_90a``. Its source has a plain C interface and includes no PyTorch
headers, so the build takes seconds. Importing this module builds and
imports nothing CUDA-specific.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading

import torch

from redcliff_tpu_torch.ops.cuda_build import build_library

__all__ = ["factor_mix", "factor_mix_reference", "factor_mix_lanes",
           "factor_mix_lanes_reference", "graph_mix", "graph_mix_reference",
           "FactorMixFn", "FactorMixLanesFn", "load_kernel", "mix_plan",
           "launch_plan", "KERNEL_SOURCE"]

_HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = os.path.join(_HERE, "csrc", "factor_mix.cu")
# the kernel indexes each lane's (B, M) output with 32-bit ints; lanes are
# the grid's second dimension
_MAX_DIM = 2 ** 31 - 1
_MAX_LANES = 65535
# blocks of 128 threads until the grid would cover every SM several times
_SMALL_BLOCK, _LARGE_BLOCK, _LARGE_FROM = 128, 256, 256 * 132 * 4

_F32 = torch.float32
_lib = None
_fn = None
_raw_stream = None
_capturing = None
_lib_lock = threading.Lock()


def factor_mix_reference(weightings, preds):
    """Plain version: ``einsum("bk,kbtc->btc")``."""
    return torch.einsum("bk,kbtc->btc", weightings, preds)


def graph_mix_reference(weightings, static_gc):
    """Plain serve-path blend: ``einsum("sk,kij->sij")``."""
    return torch.einsum("sk,kij->sij", weightings, static_gc)


def factor_mix_lanes_reference(weightings, preds):
    """Plain lane version: ``einsum("gbk,gkbtc->gbtc")``."""
    return torch.einsum("gbk,gkbtc->gbtc", weightings, preds)


def mix_plan(B, M, stride_k, stride_b, p_offset, stride_g=0, threads=None):
    """``(vec, threads, blocks)`` for the kernel: each thread computes
    ``vec`` consecutive outputs of a lane's linear (b, m) index; ``blocks``
    covers one lane (the lanes are the grid's second dimension).
    ``threads`` (a tuned plan's threads per block) replaces the default
    rule: 128, or 256 once the grid would cover every SM several times.

    ``p_offset`` is ``p.data_ptr() % 16``. ``vec`` is 4 when M and every
    element stride of p (``stride_g`` is its lane stride) are multiples of
    4 and p's base is 16-byte aligned (float4 loads and stores), 2 at
    multiples of 2 and 8 bytes (float2), else 1. The launch passes 0 as the
    stride of an axis of length 1, so such an axis (like the serve
    broadcast's stride 0) never breaks the alignment. The output is a fresh
    contiguous ``(G, B, M)`` tensor, so M % vec == 0 aligns its rows too."""
    vec = 1
    for v in (4, 2):
        if (M % v == 0 and p_offset % (4 * v) == 0 and stride_k % v == 0
                and stride_b % v == 0 and stride_g % v == 0):
            vec = v
            break
    n = B * (M // vec)
    if threads is None:
        threads = _LARGE_BLOCK if n >= _LARGE_FROM else _SMALL_BLOCK
    return vec, threads, -(-n // threads)


class _MixArgs(ctypes.Structure):
    """The launch's shapes, strides and plan: ``MixArgs`` of
    csrc/factor_mix.cu, field for field. One per shape (cached), so a
    launch converts five ctypes arguments, not sixteen."""

    _fields_ = [("B", ctypes.c_int), ("K", ctypes.c_int),
                ("M", ctypes.c_int), ("vec", ctypes.c_int),
                ("threads", ctypes.c_int), ("blocks", ctypes.c_int),
                ("device", ctypes.c_int), ("stride_k", ctypes.c_longlong),
                ("stride_b", ctypes.c_longlong), ("G", ctypes.c_int),
                ("stride_wg", ctypes.c_longlong),
                ("stride_pg", ctypes.c_longlong)]


@functools.lru_cache(maxsize=256)
def _mix_args(B, K, M, stride_k, stride_b, p_offset, device, G=1,
              stride_wg=0, stride_pg=0):
    """``(_MixArgs, its address)`` for one launch shape on ``device``;
    ``G`` lanes with lane strides ``stride_wg`` (w) and ``stride_pg`` (p),
    one lane with zero lane strides by default. The plan's threads are the
    autotuner's winner for the shape when it holds one."""
    from redcliff_tpu_torch.ops import autotune

    threads = autotune.plan_threads(*autotune.mix_key(B, K, M, G))
    args = _MixArgs(B, K, M, *mix_plan(B, M, stride_k, stride_b, p_offset,
                                       stride_pg, threads=threads),
                    device, stride_k, stride_b, G, stride_wg, stride_pg)
    return args, ctypes.addressof(args)


def load_kernel():
    """Build (first call in a process; cached by content on disk) and bind
    the CUDA kernel. Returns the ctypes library."""
    global _lib, _fn, _raw_stream, _capturing
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = build_library("redcliff_factor_mix", KERNEL_SOURCE)
        fn = lib.redcliff_factor_mix_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        # the current stream's cudaStream_t of a device, as an int
        _raw_stream = torch._C._cuda_getCurrentRawStream
        # whether the current stream is capturing a CUDA graph
        _capturing = torch._C._cuda_isCurrentStreamCapturing
        _fn, _lib = fn, lib
        return _lib


def _run(w, p, B, K, M, stride_k, stride_b, out_shape, G=1, stride_wg=0,
         stride_pg=0):
    """Launch on checked operands: lane g's ``w (B, K)`` contiguous at
    ``w + g*stride_wg``, its element (k, b, m) of p at
    ``p + g*stride_pg + k*stride_k + b*stride_b + m`` -> a new
    ``out_shape`` tensor holding the ``(G, B, M)`` result."""
    out = w.new_empty(out_shape)
    if B == 0 or M == 0 or G == 0:
        return out
    if _fn is None:
        load_kernel()
    # the stride of an axis of length 1 is never stepped
    if K == 1:
        stride_k = 0
    if B == 1:
        stride_b = 0
    if G == 1:
        stride_wg = stride_pg = 0
    p_ptr = p.data_ptr()
    dev = w.get_device()
    args = _mix_args(B, K, M, stride_k, stride_b, p_ptr % 16, dev, G,
                     stride_wg, stride_pg)
    rc = _fn(w.data_ptr(), p_ptr, out.data_ptr(), args[1], _raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"factor_mix kernel launch failed: cudaError {rc}")
    if _capturing():
        factor_mix.captured += 1
    else:
        factor_mix.launches += 1
    return out


def _operands_ok(w, a):
    """Both on one CUDA device, float32, ``w`` contiguous."""
    return (w.is_cuda and a.get_device() == w.get_device()
            and w.dtype is _F32 and a.dtype is _F32 and w.is_contiguous())


def _mix_layout(w, p):
    """``(B, K, M, stride_k, stride_b, out_shape)`` of ``w (B, K)`` and
    ``p (K, B, T, C)`` for the kernel, or None when the layout is not one
    it takes: the (T, C) block of p contiguous, any strides on K and B
    (including a stride-0 broadcast)."""
    if w.dim() != 2 or p.dim() != 4:
        return None
    K, B, T, C = p.shape
    sk, sb, st, sc = p.stride()
    M = T * C
    if (w.shape == (B, K) and (sc == 1 or C == 1) and (st == C or T == 1)
            and B * M <= _MAX_DIM):
        return B, K, M, sk, sb, (B, T, C)
    return None


def _lanes_layout(w, p):
    """``(B, K, M, stride_k, stride_b, out_shape, G, stride_wg, stride_pg)``
    of ``w (G, B, K)`` and ``p (G, K, B, T, C)`` for the kernel, or None
    when the layout is not one it takes: each lane's ``(B, K)`` block of w
    and the (T, C) block of p contiguous, any strides on G, K and B."""
    if w.dim() != 3 or p.dim() != 5:
        return None
    G, K, B, T, C = p.shape
    sg, sk, sb, st, sc = p.stride()
    swg, swb, swk = w.stride()
    M = T * C
    if (w.shape == (G, B, K) and (swk == 1 or K == 1)
            and (swb == K or B == 1) and (sc == 1 or C == 1)
            and (st == C or T == 1) and B * M <= _MAX_DIM
            and G <= _MAX_LANES):
        return B, K, M, sk, sb, (G, B, T, C), G, swg, sg
    return None


def _graph_layout(w, g):
    """The same for the serve blend, ``w (S, K)`` and ``g (K, C, C)`` with
    the (C, C) block contiguous: the graphs broadcast over S with
    ``stride_b = 0``."""
    if w.dim() != 2 or g.dim() != 3:
        return None
    K, C1, C2 = g.shape
    sk, s1, s2 = g.stride()
    S = w.shape[0]
    if (w.shape[1] == K and (s2 == 1 or C2 == 1) and (s1 == C2 or C1 == 1)
            and S * C1 * C2 <= _MAX_DIM):
        return S, K, C1 * C2, sk, 0, (S, C1, C2)
    return None


def _refuse(w, p, what):
    """Raise the error that says why the kernel does not take ``w``, ``p``
    (``what`` names the operands' expected layouts)."""
    if not (w.is_cuda and p.is_cuda and w.device == p.device):
        raise ValueError(f"factor_mix kernel needs both operands on one CUDA "
                         f"device, got {w.device} and {p.device}")
    if w.dtype != _F32 or p.dtype != _F32:
        raise TypeError(f"factor_mix kernel takes float32, got {w.dtype} "
                        f"and {p.dtype}")
    raise ValueError(f"factor_mix kernel wants {what} with w contiguous, the "
                     f"inner block of p contiguous and dimensions below "
                     f"2**31, got w {tuple(w.shape)} strides {w.stride()}, "
                     f"p {tuple(p.shape)} strides {p.stride()}")


def _launch(weightings, preds):
    """Run the kernel: ``weightings (B, K)``, ``preds (K, B, T, C)`` ->
    ``(B, T, C)`` (layout as :func:`_mix_layout`)."""
    w, p = weightings, preds
    args = _mix_layout(w, p) if _operands_ok(w, p) else None
    if args is None:
        _refuse(w, p, "w (B, K) and p (K, B, T, C)")
    return _run(w, p, *args)


def _launch_lanes(weightings, preds):
    """Run the kernel once for every lane: ``weightings (G, B, K)``,
    ``preds (G, K, B, T, C)`` -> ``(G, B, T, C)`` (layout as
    :func:`_lanes_layout`)."""
    w, p = weightings, preds
    args = _lanes_layout(w, p) if _operands_ok(w, p) else None
    if args is None:
        _refuse(w, p, f"w (G, B, K) and p (G, K, B, T, C) with G <= "
                      f"{_MAX_LANES}")
    return _run(w, p, *args)


def launch_plan(weightings, preds):
    """``(vec, threads, blocks)`` of the cached plan a launch on these CUDA
    operands takes: ``w (B, K)`` and ``p (K, B, T, C)``, or the lane form's
    ``w (G, B, K)`` and ``p (G, K, B, T, C)``."""
    w, p = weightings, preds
    lay = ((_lanes_layout if w.dim() == 3 else _mix_layout)(w, p)
           if _operands_ok(w, p) else None)
    if lay is None:
        _refuse(w, p, "the single or lane form's operands")
    B, K, M, stride_k, stride_b, _, *lanes = lay
    G, stride_wg, stride_pg = lanes or (1, 0, 0)
    # as _run passes them: the stride of an axis of length 1 is 0
    args = _mix_args(B, K, M, 0 if K == 1 else stride_k,
                     0 if B == 1 else stride_b, p.data_ptr() % 16,
                     w.get_device(), G, 0 if G == 1 else stride_wg,
                     0 if G == 1 else stride_pg)[0]
    return args.vec, args.threads, args.blocks


def _mix_bwd(weightings, preds, g):
    """The exact backward of the mix: d w[b,k] = sum_{t,c} g p;
    d p[k,b,t,c] = w[b,k] g[b,t,c]."""
    dw = torch.einsum("btc,kbtc->bk", g, preds)
    dp = torch.einsum("bk,btc->kbtc", weightings, g)
    return dw, dp


def _mix_lanes_bwd(weightings, preds, g):
    """:func:`_mix_bwd` for every lane."""
    dw = torch.einsum("gbtc,gkbtc->gbk", g, preds)
    dp = torch.einsum("gbk,gbtc->gkbtc", weightings, g)
    return dw, dp


def _lane_operand(x, bdim, size):
    """A ``torch.func.vmap`` operand with its lane axis first (a broadcast
    view when the operand has none)."""
    if bdim is None:
        return x.unsqueeze(0).expand((size,) + tuple(x.shape))
    return x.movedim(bdim, 0)


class FactorMixFn(torch.autograd.Function):
    """Kernel forward, plain-einsum backward (the JAX custom VJP); under
    ``torch.func.vmap`` the lane form of the kernel."""

    @staticmethod
    def forward(weightings, preds):
        if weightings.is_cuda or preds.is_cuda:
            return _launch(weightings, preds)
        return factor_mix_reference(weightings, preds)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        weightings, preds = ctx.saved_tensors
        return _mix_bwd(weightings, preds, g)

    @staticmethod
    def vmap(info, in_dims, weightings, preds):
        w = _lane_operand(weightings, in_dims[0], info.batch_size)
        p = _lane_operand(preds, in_dims[1], info.batch_size)
        if w.is_cuda and _lanes_layout(w, p) is None:
            w, p = w.contiguous(), p.contiguous()
        return factor_mix_lanes(w, p), 0


class FactorMixLanesFn(torch.autograd.Function):
    """The lane form with autograd: kernel forward, einsum backward."""

    @staticmethod
    def forward(weightings, preds):
        if weightings.is_cuda or preds.is_cuda:
            return _launch_lanes(weightings, preds)
        return factor_mix_lanes_reference(weightings, preds)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        weightings, preds = ctx.saved_tensors
        return _mix_lanes_bwd(weightings, preds, g)


def _wants_grad(a, b):
    return torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)


_is_transformed = torch._C._functorch.is_functorch_wrapped_tensor


def factor_mix(weightings, preds):
    """``weightings (B, K)``, ``preds (K, B, T, C)`` -> ``(B, T, C)``: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors. Under
    ``torch.func.vmap`` the lane form of the kernel runs once for all
    lanes."""
    if weightings.is_cuda or preds.is_cuda:
        if (_wants_grad(weightings, preds) or _is_transformed(weightings)
                or _is_transformed(preds)):
            return FactorMixFn.apply(weightings, preds)
        return _launch(weightings, preds)
    return factor_mix_reference(weightings, preds)


factor_mix.launches = 0
factor_mix.captured = 0


def factor_mix_lanes(weightings, preds):
    """``weightings (G, B, K)``, ``preds (G, K, B, T, C)`` ->
    ``(G, B, T, C)``: one launch of the CUDA kernel for every lane on CUDA
    tensors (counted in ``factor_mix.launches``), the plain lane version
    on CPU tensors."""
    if weightings.is_cuda or preds.is_cuda:
        if _wants_grad(weightings, preds):
            return FactorMixLanesFn.apply(weightings, preds)
        return _launch_lanes(weightings, preds)
    return factor_mix_lanes_reference(weightings, preds)


def graph_mix(weightings, static_gc):
    """Serve-path graph blend: ``weightings (S, K)`` x ``static_gc
    (K, C, C)`` -> ``(S, C, C)``. On CUDA the K graphs reach the kernel with
    ``stride_b = 0``; nothing of size (K, S, C, C) is made."""
    w, g = weightings, static_gc
    if not (w.is_cuda or g.is_cuda):
        return graph_mix_reference(w, g)
    if _wants_grad(w, g):
        K, S = g.shape[0], w.shape[0]
        return FactorMixFn.apply(
            w, g.contiguous()[:, None].expand((K, S) + tuple(g.shape[1:])))
    args = _graph_layout(w, g) if _operands_ok(w, g) else None
    if args is None:
        _refuse(w, g, "w (S, K) and static_gc (K, C, C)")
    return _run(w, g, *args)
