"""The fused group-lasso proximal update (port of ``ops/pallas_prox.py``;
the file keeps its counterpart's name).

* :func:`gl_prox` — the dispatch every prox path calls. GL on a CUDA
  tensor launches the hand-written kernel in ``csrc/gl_prox.cu``; GL on a
  CPU tensor takes the plain version (:func:`ops.prox.prox_update`); GSGL
  and H are plain on every device, as in the JAX package. There is no
  fallback: a CUDA tensor the kernel does not take (not float32, not
  contiguous, rank < 3) raises.
* ``gl_prox.launches`` — a plain int, one per kernel launch.

The result is functional, as in JAX: the kernel writes a new tensor. (The
kernel itself may run in place; the wrapper does not ask it to.) The
kernel is built at first use into ``build/torch_kernels/redcliff_gl_prox/``
(``ops/cuda_build.py``); importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from redcliff_tpu_torch.ops.cuda_build import build_library
from redcliff_tpu_torch.ops.prox import prox_update, threshold

__all__ = ["gl_prox", "gl_prox_reference", "load_kernel", "KERNEL_SOURCE"]

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "csrc", "gl_prox.cu")

_lib = None
_lib_lock = threading.Lock()


def gl_prox_reference(W1, lam, lr):
    """Plain version of the GL prox."""
    return prox_update(W1, lam, lr, "GL")


def load_kernel():
    """Build (first call in a process; cached by content on disk) and bind
    the CUDA kernel. Returns the ctypes library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build_library("redcliff_gl_prox", KERNEL_SOURCE)
            fn = lib.redcliff_gl_prox_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _launch(W1, lam, lr):
    """Run the kernel on a contiguous float32 CUDA block
    ``(lead..., H, C_in, L)`` -> a new tensor of the same shape."""
    if not W1.is_cuda:
        raise ValueError(f"gl_prox kernel needs a CUDA tensor, got "
                         f"{W1.device}")
    if W1.dtype != torch.float32:
        raise TypeError(f"gl_prox kernel takes float32, got {W1.dtype}")
    if W1.dim() < 3:
        raise ValueError(f"gl_prox wants a (..., H, C_in, L) block, got "
                         f"shape {tuple(W1.shape)}")
    if not W1.is_contiguous():
        raise ValueError("gl_prox kernel needs a contiguous block")
    *lead, H, C, L = W1.shape
    G = C
    for d in lead:
        G *= d
    out = torch.empty_like(W1)
    if W1.numel() == 0:
        return out
    lib = _lib or load_kernel()
    with torch.cuda.device(W1.device):
        stream = torch.cuda.current_stream(W1.device).cuda_stream
        rc = lib.redcliff_gl_prox_f32(W1.data_ptr(), out.data_ptr(), G, H,
                                      C, L, threshold(lam, lr), stream)
    if rc != 0:
        raise RuntimeError(f"gl_prox kernel launch failed: cudaError {rc}")
    gl_prox.launches += 1
    return out


def gl_prox(W1, lam, lr, penalty="GL"):
    """Proximal update of a first-layer block ``(..., H, C_in, L)``: the
    CUDA kernel for GL on CUDA tensors, the plain version otherwise."""
    if penalty == "GL" and W1.is_cuda:
        return _launch(W1, lam, lr)
    return prox_update(W1, lam, lr, penalty)


gl_prox.launches = 0
