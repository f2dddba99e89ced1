"""Device selection and the port's precision modes.

Counterpart of ``redcliff_tpu/utils/precision.py``. This is the one place
where the port's precision contract is set up:

* ``precision_mode="f32"`` must be real float32 on the card. PyTorch runs
  float32 matrix products in full float32 by default, but float32
  convolutions through cuDNN in TF32 (about three decimal digits). Both
  switches are turned off here, for matmul and cuDNN alike, the first time
  an entry point resolves a CUDA device.
* ``precision_mode="mixed"`` means what JAX's ``"bfloat16"`` matmul
  precision means: each contraction rounds its operands to bf16 and
  accumulates and returns float32, while state, reductions and outputs
  stay float32. The serve engine serves it (``serve/engine.py``);
  the trainers and the grid do not yet and raise (ROADMAP queue 1, item
  18), which is why :func:`check_precision_mode` takes ``serve``.

The models' contraction sites go through :func:`einsum` and
:func:`matmul`. Outside :func:`matmul_precision_ctx` they run the very op
they ran before (``torch.einsum`` / ``@``), so the f32 path's bytes do not
change; inside a ``"bfloat16"`` context their operands are rounded to bf16
first (exact products in float32, float32 sums). The context is
thread-local: a serve dispatch on one thread does not change a fit on
another.

Entry points run on ``cuda`` unless the caller asks for another device;
without CUDA and without an explicit device they raise instead of quietly
running on the CPU.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["PRECISION_MODES", "MIXED_MATMUL", "check_precision_mode",
           "resolve_matmul_precision", "precision_label",
           "matmul_precision_ctx", "einsum", "matmul", "resolve_device"]

PRECISION_MODES = ("f32", "mixed")
# what "mixed" means on the matmul axis: bf16 operands, f32 accumulation
# and outputs (JAX's "bfloat16" default_matmul_precision)
MIXED_MATMUL = "bfloat16"

_ctx = threading.local()


def check_precision_mode(mode, serve=False):
    """Validate a ``precision_mode`` value. ``"mixed"`` is served by the
    serve engine (``serve=True``); the trainers and the grid raise for it
    until mixed-precision training is ported."""
    if mode not in PRECISION_MODES:
        raise ValueError(
            f"precision_mode must be one of {PRECISION_MODES}, got {mode!r}")
    if mode == "mixed" and not serve:
        raise NotImplementedError(
            "precision_mode='mixed' is served by the serve engine only; "
            "mixed-precision training (its numerics-storm demotion and a "
            "backward for the bf16 factor mix) is not ported yet (ROADMAP "
            "queue 1, item 18)")
    return mode


def resolve_matmul_precision(precision_mode="f32", matmul_precision=None):
    """The effective matmul precision string for a config: the explicit
    ``matmul_precision`` wins when set; otherwise ``"mixed"`` resolves to
    :data:`MIXED_MATMUL` and ``"f32"`` to ``None`` (no context at all, so an
    ``"f32"`` run runs exactly the ops of a build without precision
    modes)."""
    if matmul_precision:
        return matmul_precision
    if precision_mode == "mixed":
        return MIXED_MATMUL
    return None


def precision_label(precision_mode="f32", matmul_precision=None):
    """Canonical label for the cost-model bucket key (obs/costmodel.py):
    ``"f32"`` when no precision context applies, ``"mixed"`` for bf16
    contractions, else the raw precision string — bf16 and f32 costs must
    never merge."""
    resolved = resolve_matmul_precision(precision_mode, matmul_precision)
    if resolved is None:
        return "f32"
    if resolved == MIXED_MATMUL:
        return "mixed"
    return str(resolved)


@contextlib.contextmanager
def _bf16_contractions():
    prev = getattr(_ctx, "bf16", False)
    _ctx.bf16 = True
    try:
        yield
    finally:
        _ctx.bf16 = prev


def matmul_precision_ctx(precision):
    """The counterpart of the JAX package's ``matmul_precision_ctx``:
    ``None`` is a no-op; inside :data:`MIXED_MATMUL`, :func:`einsum` and
    :func:`matmul` on this thread round their operands to bf16 (the
    previous setting comes back on exit). Other JAX precision strings have
    no port."""
    if not precision:
        return contextlib.nullcontext()
    if precision != MIXED_MATMUL:
        raise NotImplementedError(
            f"matmul precision {precision!r} has no port; the port serves "
            f"{MIXED_MATMUL!r} (precision_mode='mixed') and float32")
    return _bf16_contractions()


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def einsum(equation, *operands):
    """``torch.einsum``; under a bf16 context on bf16-rounded operands."""
    if getattr(_ctx, "bf16", False):
        return torch.einsum(equation, *(_bf16(o) for o in operands))
    return torch.einsum(equation, *operands)


def matmul(a, b):
    """``a @ b``; under a bf16 context on bf16-rounded operands."""
    if getattr(_ctx, "bf16", False):
        return _bf16(a) @ _bf16(b)
    return a @ b


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` if given, else
    ``cuda``. Raises when CUDA is asked for (explicitly or by default) and
    absent. Resolving a CUDA device turns TF32 off for matrix products and
    cuDNN convolutions: full float32 on the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
