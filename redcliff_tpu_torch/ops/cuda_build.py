"""Build and bind the port's hand-written CUDA kernels.

Each kernel source in ``csrc/`` has a plain C interface and includes no
PyTorch headers. :func:`build_library` compiles one source for ``sm_90a``
with ``torch.utils.cpp_extension.load`` (ninja; cached by content on disk)
into its own directory under ``build/torch_kernels/``, so several sources
can build at once, and loads the shared library with ctypes. Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import os

__all__ = ["BUILD_DIR", "CUDA_FLAGS", "build_library"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_kernels")
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]


def build_library(name, source):
    """Compile ``source`` into ``build/torch_kernels/<name>/`` and return
    the loaded ``ctypes.CDLL``."""
    from torch.utils.cpp_extension import load

    build_dir = os.path.join(BUILD_DIR, name)
    os.makedirs(build_dir, exist_ok=True)
    path = load(name=name, sources=[source], build_directory=build_dir,
                extra_cuda_cflags=CUDA_FLAGS, is_python_module=False)
    return ctypes.CDLL(path)
