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
  stay float32. The serve engine, both trainers and the grid take it; the
  trainers and the grid demote a fit to f32 on a numerics storm
  (``train/redcliff_trainer.py``, ``train/trainer.py``,
  ``parallel/grid.py``).

The models' contraction sites go through :func:`einsum` and
:func:`matmul`. Outside :func:`matmul_precision_ctx` they run the very op
they ran before (``torch.einsum`` / ``@``), so the f32 path's bytes do not
change; inside a ``"bfloat16"`` context their operands are rounded to bf16
first (exact products in float32, float32 sums). The context is
thread-local: a serve dispatch on one thread does not change a fit on
another.

Under autograd a mixed contraction is one ``torch.autograd.Function``
(:class:`MixedEinsum`, :class:`MixedMatmul`) with JAX's transpose rule:
the gradient of each operand is the transposed contraction of the
bf16-rounded cotangent and the bf16-rounded other operand, accumulated and
returned in float32 (under ``jax.default_matmul_precision("bfloat16")``
the transpose of a ``dot_general`` is itself a bf16-precision
``dot_general``). A cast pair ``x.to(bfloat16).to(float32)`` under
autograd would instead round the gradient itself to bf16 on its way back
to the float32 parameter. The backward does not read the context (it may
run on autograd's device thread), and the Functions have the
``setup_context`` form, so ``torch.func`` transforms take them.

Entry points run on ``cuda`` unless the caller asks for another device;
without CUDA and without an explicit device they raise instead of quietly
running on the CPU.
"""
from __future__ import annotations

import contextlib
import functools
import string
import threading

import torch

# the names and labels of the precision modes live in a module without
# torch, so that the fleet's control processes can read them
from redcliff_tpu_torch.utils.precision_modes import (  # noqa: F401
    MIXED_MATMUL,
    PRECISION_MODES,
    check_matmul_precision,
    check_precision_mode,
    precision_label,
    resolve_matmul_precision,
)

__all__ = ["PRECISION_MODES", "MIXED_MATMUL", "check_precision_mode",
           "check_matmul_precision", "resolve_matmul_precision",
           "precision_label", "matmul_precision_ctx", "bf16_active",
           "bf16_round", "einsum", "matmul", "MixedEinsum", "MixedMatmul",
           "resolve_device"]

_ctx = threading.local()


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
    ``None`` is a no-op; inside :data:`MIXED_MATMUL`, :func:`einsum`,
    :func:`matmul` and the factor mix (``ops/factor_mix.py``) on this
    thread round their operands to bf16 (the previous setting comes back on
    exit). Other JAX precision strings have no port."""
    if not precision:
        return contextlib.nullcontext()
    check_matmul_precision(precision)
    return _bf16_contractions()


def bf16_active():
    """Whether this thread is inside a ``"bfloat16"`` context."""
    return getattr(_ctx, "bf16", False)


def bf16_round(x):
    """``x`` rounded to bf16 and widened back to float32 (exact)."""
    return x.to(torch.bfloat16).to(torch.float32)


_is_transformed = torch._C._functorch.is_functorch_wrapped_tensor


def needs_autograd(*operands):
    """Whether a contraction of ``operands`` is differentiated: grad mode
    on and an operand that requires grad or is a ``torch.func`` tensor."""
    return torch.is_grad_enabled() and any(
        o.requires_grad or _is_transformed(o) for o in operands)


@functools.lru_cache(maxsize=256)
def _einsum_vjp(equation, ndim_a, ndim_b):
    """The transposed equations of a two-operand ``equation`` at these
    operand ranks: ``(eq_da, only_a, eq_db, only_b)``, where ``eq_da``
    contracts the cotangent with b into a's indices that appear in b or the
    output, and ``only_a`` marks a's indices summed in a alone (their
    gradient is broadcast). The ellipsis is written out with free letters,
    right-aligned as einsum broadcasts it."""
    eq = equation.replace(" ", "")
    if "->" not in eq:
        raise ValueError(f"mixed einsum needs an explicit output: {equation}")
    lhs, out = eq.split("->")
    terms = lhs.split(",")
    if len(terms) != 2:
        raise ValueError(f"mixed einsum takes two operands: {equation}")
    ta, tb = terms
    free = [c for c in string.ascii_letters if c not in set(eq)]

    def ell_len(term, ndim):
        return ndim - (len(term) - 3) if "..." in term else 0

    ea, eb = ell_len(ta, ndim_a), ell_len(tb, ndim_b)
    ell = "".join(free[:max(ea, eb)])
    ta = ta.replace("...", ell[len(ell) - ea:])
    tb = tb.replace("...", ell[len(ell) - eb:])
    out = out.replace("...", ell)
    for term in (ta, tb, out):
        if len(set(term)) != len(term):
            raise ValueError(
                f"mixed einsum takes no repeated index within a term: "
                f"{equation}")

    def transposed(t_self, t_other):
        keep = "".join(c for c in t_self if c in t_other or c in out)
        only = tuple(c not in keep for c in t_self)
        return f"{out},{t_other}->{keep}", only

    eq_da, only_a = transposed(ta, tb)
    eq_db, only_b = transposed(tb, ta)
    return eq_da, only_a, eq_db, only_b


def _grad_to(x, only, shape):
    """A transposed contraction's result ``x`` brought to an operand's
    ``shape``: size-1 axes put back at the indices summed in that operand
    alone (then broadcast), and broadcast axes summed."""
    full = []
    it = iter(x.shape)
    for o in only:
        full.append(1 if o else next(it))
    x = x.reshape(full)
    return x.sum_to_size([1 if o else s for o, s in zip(only, shape)]
                         ).expand(shape)


class MixedEinsum(torch.autograd.Function):
    """A two-operand einsum on bf16-rounded operands with float32 sums and
    JAX's transpose rule as its backward (module docstring)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(equation, a, b):
        return torch.einsum(equation, bf16_round(a), bf16_round(b))

    @staticmethod
    def setup_context(ctx, inputs, output):
        equation, a, b = inputs
        ctx.equation = equation
        ctx.shapes = (tuple(a.shape), tuple(b.shape))
        ctx.save_for_backward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        sa, sb = ctx.shapes
        eq_da, only_a, eq_db, only_b = _einsum_vjp(ctx.equation, len(sa),
                                                   len(sb))
        g = bf16_round(g)
        da = db = None
        if ctx.needs_input_grad[1]:
            da = _grad_to(torch.einsum(eq_da, g, bf16_round(b)), only_a, sa)
        if ctx.needs_input_grad[2]:
            db = _grad_to(torch.einsum(eq_db, g, bf16_round(a)), only_b, sb)
        return None, da, db


class MixedMatmul(torch.autograd.Function):
    """``a @ b`` (both of rank 2 or more) on bf16-rounded operands with
    float32 sums, and JAX's transpose rule as its backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return bf16_round(a) @ bf16_round(b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b = inputs
        ctx.shapes = (tuple(a.shape), tuple(b.shape))
        ctx.save_for_backward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        sa, sb = ctx.shapes
        g = bf16_round(g)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = (g @ bf16_round(b).transpose(-1, -2)).sum_to_size(sa)
        if ctx.needs_input_grad[1]:
            db = (bf16_round(a).transpose(-1, -2) @ g).sum_to_size(sb)
        return da, db


def einsum(equation, *operands):
    """``torch.einsum``; under a bf16 context on bf16-rounded operands,
    through :class:`MixedEinsum` when it is differentiated."""
    if getattr(_ctx, "bf16", False):
        if needs_autograd(*operands):
            return MixedEinsum.apply(equation, *operands)
        return torch.einsum(equation, *(bf16_round(o) for o in operands))
    return torch.einsum(equation, *operands)


def matmul(a, b):
    """``a @ b``; under a bf16 context on bf16-rounded operands, through
    :class:`MixedMatmul` when it is differentiated."""
    if getattr(_ctx, "bf16", False):
        if needs_autograd(a, b):
            if a.dim() < 2 or b.dim() < 2:
                raise ValueError("a differentiated mixed matmul takes "
                                 "operands of rank 2 or more")
            return MixedMatmul.apply(a, b)
        return bf16_round(a) @ bf16_round(b)
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
