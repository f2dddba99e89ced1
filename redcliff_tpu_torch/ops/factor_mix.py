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
* :class:`FactorMixFn` — the ``torch.autograd.Function`` around the kernel,
  mirroring the JAX custom VJP: forward is the kernel, backward is the two
  einsums of ``_mix_bwd`` (plain in the JAX package too).
* ``factor_mix.launches`` — a plain int, one per kernel launch.

The kernel is built from the repository's source at first use into
``build/torch_kernels/redcliff_factor_mix/`` (``ops/cuda_build.py``), for
``sm_90a``. Its source has a plain C interface and includes no PyTorch
headers, so the build takes seconds; the wrapper binds it with ctypes and
checks the ``cudaError_t`` each launch returns. Importing this module builds
and imports nothing CUDA-specific.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from redcliff_tpu_torch.ops.cuda_build import build_library

__all__ = ["factor_mix", "factor_mix_reference", "graph_mix",
           "graph_mix_reference", "FactorMixFn", "load_kernel",
           "KERNEL_SOURCE"]

_HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = os.path.join(_HERE, "csrc", "factor_mix.cu")
# the kernel's launch geometry (csrc/factor_mix.cu): 8 rows of w staged in
# at most 48 KB of static-limit shared memory, 8-row tiles along gridDim.y
_TILE_B = 8
_MAX_K = (48 * 1024) // (4 * _TILE_B)
_MAX_B = 65535 * _TILE_B

_lib = None
_lib_lock = threading.Lock()


def factor_mix_reference(weightings, preds):
    """Plain version: ``einsum("bk,kbtc->btc")``."""
    return torch.einsum("bk,kbtc->btc", weightings, preds)


def graph_mix_reference(weightings, static_gc):
    """Plain serve-path blend: ``einsum("sk,kij->sij")``."""
    return torch.einsum("sk,kij->sij", weightings, static_gc)


def load_kernel():
    """Build (first call in a process; cached by content on disk) and bind
    the CUDA kernel. Returns the ctypes library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = build_library("redcliff_factor_mix", KERNEL_SOURCE)
        fn = lib.redcliff_factor_mix_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def _launch(weightings, preds):
    """Run the kernel: ``weightings (B, K)``, ``preds (K, B, T, C)`` with
    the (T, C) block contiguous (any strides on K and B, including a
    stride-0 broadcast) -> ``(B, T, C)``."""
    w, p = weightings, preds
    if not (w.is_cuda and p.is_cuda and w.device == p.device):
        raise ValueError(f"factor_mix kernel needs both operands on one CUDA "
                         f"device, got {w.device} and {p.device}")
    if w.dtype != torch.float32 or p.dtype != torch.float32:
        raise TypeError(f"factor_mix kernel takes float32, got {w.dtype} "
                        f"and {p.dtype}")
    if w.dim() != 2 or p.dim() != 4:
        raise ValueError(f"factor_mix wants w (B, K) and p (K, B, T, C), got "
                         f"{tuple(w.shape)} and {tuple(p.shape)}")
    K, B, T, C = p.shape
    if tuple(w.shape) != (B, K):
        raise ValueError(f"factor_mix shape mismatch: w {tuple(w.shape)} vs "
                         f"p {tuple(p.shape)}")
    if not w.is_contiguous():
        raise ValueError("factor_mix kernel needs a contiguous w")
    if (C > 1 and p.stride(3) != 1) or (T > 1 and p.stride(2) != C):
        raise ValueError(f"factor_mix kernel needs p's (T, C) block "
                         f"contiguous, got strides {p.stride()}")
    if K > _MAX_K or B > _MAX_B:
        raise ValueError(f"factor_mix kernel takes K <= {_MAX_K} and "
                         f"B <= {_MAX_B}, got K={K}, B={B}")
    M = T * C
    out = torch.empty((B, T, C), dtype=torch.float32, device=w.device)
    if B == 0 or M == 0:
        return out
    lib = _lib or load_kernel()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.redcliff_factor_mix_f32(
            w.data_ptr(), p.data_ptr(), out.data_ptr(), B, K, M,
            p.stride(0), p.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"factor_mix kernel launch failed: cudaError {rc}")
    factor_mix.launches += 1
    return out


def _mix_bwd(weightings, preds, g):
    """The exact backward of the mix: d w[b,k] = sum_{t,c} g p;
    d p[k,b,t,c] = w[b,k] g[b,t,c]."""
    dw = torch.einsum("btc,kbtc->bk", g, preds)
    dp = torch.einsum("bk,btc->kbtc", weightings, g)
    return dw, dp


class FactorMixFn(torch.autograd.Function):
    """Kernel forward, plain-einsum backward (the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, weightings, preds):
        ctx.save_for_backward(weightings, preds)
        return _launch(weightings, preds)

    @staticmethod
    def backward(ctx, g):
        weightings, preds = ctx.saved_tensors
        return _mix_bwd(weightings, preds, g)


def factor_mix(weightings, preds):
    """``weightings (B, K)``, ``preds (K, B, T, C)`` -> ``(B, T, C)``: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if weightings.is_cuda or preds.is_cuda:
        return FactorMixFn.apply(weightings, preds)
    return factor_mix_reference(weightings, preds)


factor_mix.launches = 0


def graph_mix(weightings, static_gc):
    """Serve-path graph blend: ``weightings (S, K)`` x ``static_gc
    (K, C, C)`` -> ``(S, C, C)``. On CUDA the K graphs reach the kernel as
    a stride-0 broadcast over S; nothing of size (K, S, C, C) is made."""
    if weightings.is_cuda or static_gc.is_cuda:
        K, S = static_gc.shape[0], weightings.shape[0]
        preds = static_gc.contiguous()[:, None].expand(
            (K, S) + tuple(static_gc.shape[1:]))
        return FactorMixFn.apply(weightings, preds)
    return graph_mix_reference(weightings, static_gc)
