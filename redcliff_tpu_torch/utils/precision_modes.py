"""The precision modes' names and labels, with no torch (a part of
``redcliff_tpu/utils/precision.py``'s counterpart, ``utils/precision.py``).

The fleet's control processes (the planner above all, ``fleet/planner.py``)
read :func:`precision_label` to key the cost model by precision, and a
control process loads no backend: so these names live here, in a module
that imports the standard library only, and ``utils/precision.py``
re-exports them for every other caller.
"""
from __future__ import annotations

__all__ = ["PRECISION_MODES", "MIXED_MATMUL", "check_precision_mode",
           "check_matmul_precision", "resolve_matmul_precision",
           "precision_label"]

PRECISION_MODES = ("f32", "mixed")
# what "mixed" means on the matmul axis: bf16 operands, f32 accumulation
# and outputs (JAX's "bfloat16" default_matmul_precision)
MIXED_MATMUL = "bfloat16"


def check_precision_mode(mode):
    """Validate a ``precision_mode`` value at config-construction time."""
    if mode not in PRECISION_MODES:
        raise ValueError(
            f"precision_mode must be one of {PRECISION_MODES}, got {mode!r}")
    return mode


def check_matmul_precision(precision):
    """Validate the expert ``matmul_precision`` knob at config time:
    ``None`` or :data:`MIXED_MATMUL`. JAX forwards any string to
    ``jax.default_matmul_precision``; the port has no other precision."""
    if precision is not None and precision != MIXED_MATMUL:
        raise ValueError(
            f"matmul_precision {precision!r} has no port; the port takes "
            f"None (float32) or {MIXED_MATMUL!r} (bf16 operands, float32 "
            f"sums: precision_mode='mixed')")
    return precision


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
