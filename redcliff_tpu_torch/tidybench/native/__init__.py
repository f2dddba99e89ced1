"""Native (C++) core for SELVAR: built on demand with g++, bound with ctypes.

Port of ``redcliff_tpu/tidybench/native/__init__.py``. The JAX package
builds ``libselvar.so`` next to its source; the port builds its copy of
``selvar.cpp`` into ``build/host_native/`` at the root of the checkout (as
the CUDA kernels go into ``build/torch_kernels/``), never beside the source.
Several processes may build at once (pytest workers): each build runs under
an exclusive lock on ``build/host_native/libselvar.lock``, writes a
temporary file and ``os.replace``s it into place, so no process loads half
a library. Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

__all__ = ["BUILD_DIR", "build_library", "load_native", "slvar_native",
           "gtcoef_native", "gtstat_native"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "selvar.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    _DIR))), "build", "host_native")
LIB_NAME = "libselvar.so"
_lock = threading.Lock()
_lib = None
_build_error = None


def build_library(build_dir=BUILD_DIR):
    """Compile ``selvar.cpp`` into ``<build_dir>/libselvar.so`` unless an
    up-to-date library is there, and return it loaded and bound. Raises
    ``OSError`` or ``subprocess.CalledProcessError`` when it cannot."""
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, LIB_NAME)
    with open(os.path.join(build_dir, "libselvar.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(lib_path) or (
                    os.path.getmtime(lib_path) < os.path.getmtime(_SRC)):
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                try:
                    subprocess.run(["g++", "-O2", "-fPIC", "-shared",
                                    "-std=c++14", _SRC, "-o", tmp],
                                   check=True, capture_output=True, text=True)
                    os.replace(tmp, lib_path)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return _bind(lib)


def _bind(lib):
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int)
    lib.selvar_slvar.restype = ctypes.c_int
    lib.selvar_slvar.argtypes = [ctypes.c_int, ctypes.c_int, dptr,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 dptr, iptr]
    lib.selvar_gtcoef.restype = ctypes.c_int
    lib.selvar_gtcoef.argtypes = [ctypes.c_int, ctypes.c_int, dptr,
                                  ctypes.c_int, ctypes.c_int, iptr,
                                  ctypes.c_int, ctypes.c_int, dptr]
    lib.selvar_gtrss.restype = ctypes.c_double
    lib.selvar_gtrss.argtypes = [ctypes.c_int, ctypes.c_int, dptr,
                                 ctypes.c_int, ctypes.c_int, iptr,
                                 ctypes.c_int]
    lib.selvar_gtstat.restype = ctypes.c_int
    lib.selvar_gtstat.argtypes = [ctypes.c_int, ctypes.c_int, dptr,
                                  ctypes.c_int, ctypes.c_int, iptr,
                                  ctypes.c_int, dptr, iptr]
    return lib


def load_native():
    """Return the bound ctypes library, building it if needed; None if the
    toolchain is unavailable (callers fall back to the numpy implementation)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            _lib = build_library()
        except (OSError, subprocess.CalledProcessError) as e:  # no g++ / bad build
            _build_error = e
        return _lib


def _as_c(X):
    return np.ascontiguousarray(X, dtype=np.float64)


def slvar_native(X, batchsize, maxlags, mxitr):
    """(scores, lags, info) via the C++ core, or None if it cannot be built."""
    lib = load_native()
    if lib is None:
        return None
    X = _as_c(X)
    T, N = X.shape
    B = np.zeros((N, N), dtype=np.float64)
    A = np.zeros((N, N), dtype=np.int32)
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int)
    info = lib.selvar_slvar(T, N, X.ctypes.data_as(dptr), int(batchsize),
                            int(maxlags), int(mxitr),
                            B.ctypes.data_as(dptr), A.ctypes.data_as(iptr))
    return B, A, info


def gtcoef_native(X, maxlags, batchsize, A, job="ABS", nrm=0):
    lib = load_native()
    if lib is None:
        return None
    X = _as_c(X)
    T, N = X.shape
    A = np.ascontiguousarray(A, dtype=np.int32)
    B = np.zeros((N, N), dtype=np.float64)
    jobcode = {"RAW": 0, "ABS": 1, "SQR": 2}[job]
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int)
    lib.selvar_gtcoef(T, N, X.ctypes.data_as(dptr), int(maxlags),
                      int(batchsize), A.ctypes.data_as(iptr), jobcode,
                      int(nrm), B.ctypes.data_as(dptr))
    return B


def gtstat_native(X, maxlags, batchsize, A, job="DF"):
    lib = load_native()
    if lib is None:
        return None
    X = _as_c(X)
    T, N = X.shape
    A = np.ascontiguousarray(A, dtype=np.int32)
    B = np.zeros((N, N), dtype=np.float64)
    DF = np.zeros((N, 2), dtype=np.int32)
    jobcode = {"DF": 0, "LR": 1, "FS": 2}[job]
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int)
    lib.selvar_gtstat(T, N, X.ctypes.data_as(dptr), int(maxlags),
                      int(batchsize), A.ctypes.data_as(iptr), jobcode,
                      B.ctypes.data_as(dptr), DF.ctypes.data_as(iptr))
    return B, DF
