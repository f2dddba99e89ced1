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
* :func:`graph_mix_bf16` / :func:`graph_mix_bf16_reference` — the bf16
  form of the serve blend (the serve engine's mixed mode): f32 or bf16
  ``w (S, K)`` and bf16 graphs ``(K, C, C)``, each rounded to bf16 and
  widened to f32, summed in f32, f32 out. :func:`graph_mix` takes it when
  an operand is bf16. On CUDA operands it launches the same source and
  library, on CPU operands the plain version.
* :func:`factor_mix_bf16` / :func:`factor_mix_bf16_reference` and their
  lane twins :func:`factor_mix_lanes_bf16` /
  :func:`factor_mix_lanes_bf16_reference` — the bf16 training form: both
  operands rounded to bf16, f32 sums, f32 out. :func:`factor_mix` takes
  it inside a ``"bfloat16"`` matmul context (``utils/precision.py``,
  ``precision_mode="mixed"``), the mixed per-point fit and, through the
  ``vmap`` rule, the mixed grid. :class:`FactorMixBf16Fn` (and
  :class:`FactorMixLanesBf16Fn`) give it JAX's backward: ``_mix_bwd``'s
  two contractions, each on the bf16-rounded cotangent and the
  bf16-rounded other operand with f32 sums, as the transpose of a
  bf16-precision contraction is in JAX.
* The bf16 form's input forms: the kernel reads each operand as the
  caller holds it. f32 w and p go to ``redcliff_factor_mix_bf16_round``,
  which rounds both to bf16 in registers (the training form and its
  lanes); f32 w with bf16 p to ``redcliff_factor_mix_bf16_round_w`` (the
  serve blend against the bf16 graphs made at load); bf16 w and p to
  ``redcliff_factor_mix_bf16``. Each is one launch and gives bit for bit
  what casting the f32 operands to bf16 and launching the bf16 entry
  gives; other type pairs raise ``TypeError``. Every launch of a bf16
  entry, serve blend and training form alike, counts in
  ``graph_mix_bf16.launches``, and each input form has its own autotune
  key (``autotune.mix_key``).
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
  blocks), a pure function of the shapes, strides, alignment, p's
  element size (4 for f32 storage, 2 for bf16) and, when
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
from redcliff_tpu_torch.utils import precision as _prec

__all__ = ["factor_mix", "factor_mix_reference", "factor_mix_lanes",
           "factor_mix_lanes_reference", "graph_mix", "graph_mix_reference",
           "graph_mix_bf16", "graph_mix_bf16_reference", "factor_mix_bf16",
           "factor_mix_bf16_reference", "factor_mix_lanes_bf16",
           "factor_mix_lanes_bf16_reference", "FactorMixFn",
           "FactorMixLanesFn", "FactorMixBf16Fn", "FactorMixLanesBf16Fn",
           "load_kernel", "mix_plan", "launch_plan", "KERNEL_SOURCE"]

_HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = os.path.join(_HERE, "csrc", "factor_mix.cu")
# the kernel indexes each lane's (B, M) output with 32-bit ints; lanes are
# the grid's second dimension
_MAX_DIM = 2 ** 31 - 1
_MAX_LANES = 65535
# blocks of 128 threads until the grid would cover every SM several times
_SMALL_BLOCK, _LARGE_BLOCK, _LARGE_FROM = 128, 256, 256 * 132 * 4

_F32 = torch.float32
_BF16 = torch.bfloat16
_lib = None
_raw_stream = None
_capturing = None
_lib_lock = threading.Lock()


def factor_mix_reference(weightings, preds):
    """Plain version: ``einsum("bk,kbtc->btc")``."""
    return torch.einsum("bk,kbtc->btc", weightings, preds)


def graph_mix_reference(weightings, static_gc):
    """Plain serve-path blend: ``einsum("sk,kij->sij")``."""
    return torch.einsum("sk,kij->sij", weightings, static_gc)


def graph_mix_bf16_reference(weightings, static_gc):
    """Plain bf16 blend: the operands rounded to bf16 (a bf16 operand as it
    is) and widened to f32, ``einsum("sk,kij->sij")``, f32 out."""
    return torch.einsum("sk,kij->sij", _prec.bf16_round(weightings),
                        _prec.bf16_round(static_gc))


def factor_mix_lanes_reference(weightings, preds):
    """Plain lane version: ``einsum("gbk,gkbtc->gbtc")``."""
    return torch.einsum("gbk,gkbtc->gbtc", weightings, preds)


def factor_mix_bf16_reference(weightings, preds):
    """Plain bf16 training form: both operands rounded to bf16 and widened
    to f32, ``einsum("bk,kbtc->btc")``, f32 out."""
    return torch.einsum("bk,kbtc->btc", _prec.bf16_round(weightings),
                        _prec.bf16_round(preds))


def factor_mix_lanes_bf16_reference(weightings, preds):
    """Plain bf16 lane form: ``einsum("gbk,gkbtc->gbtc")`` on
    bf16-rounded operands, f32 out."""
    return torch.einsum("gbk,gkbtc->gbtc", _prec.bf16_round(weightings),
                        _prec.bf16_round(preds))


def mix_plan(B, M, stride_k, stride_b, p_offset, stride_g=0, threads=None,
             itemsize=4):
    """``(vec, threads, blocks)`` for the kernel: each thread computes
    ``vec`` consecutive outputs of a lane's linear (b, m) index; ``blocks``
    covers one lane (the lanes are the grid's second dimension).
    ``threads`` (a tuned plan's threads per block) replaces the default
    rule: 128, or 256 once the grid would cover every SM several times.

    ``p_offset`` is ``p.data_ptr() % 16`` and ``itemsize`` p's element size
    (4 for float32 storage, rounded or not, 2 for bf16). ``vec`` is 4 when
    M and every element stride of p (``stride_g`` is its lane stride) are
    multiples of 4 and p's base is aligned to ``4 * itemsize`` bytes
    (float4 loads, or four bf16 in one 8-byte load), 2 at multiples of 2
    and ``2 * itemsize`` bytes (float2, bf16x2), else 1. A bf16 row of 100
    values is 200 bytes: 8- but not 16-byte aligned, which is why the bf16
    form's widest load is 8 bytes. The launch passes 0 as the stride of an axis of length 1, so
    such an axis (like the serve broadcast's stride 0) never breaks the
    alignment. The output is a fresh contiguous float32 ``(G, B, M)``
    tensor, so M % vec == 0 aligns its rows to ``4 * vec`` bytes too."""
    vec = 1
    for v in (4, 2):
        if (M % v == 0 and p_offset % (itemsize * v) == 0
                and stride_k % v == 0 and stride_b % v == 0
                and stride_g % v == 0):
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


class _Form:
    """An input form of the kernel: the operand types it takes, its C
    entry (bound to ``fn`` when the library loads), p's element size (the
    plan's alignment unit) and ``key``, the form's name in
    ``autotune.mix_key`` (False for the f32 kernel, the bf16 form's input
    form otherwise)."""

    __slots__ = ("name", "w", "p", "entry", "itemsize", "key", "fn")

    def __init__(self, name, w, p, entry, itemsize, key):
        self.name, self.w, self.p, self.entry = name, w, p, entry
        self.itemsize, self.key, self.fn = itemsize, key, None


_FORM_F32 = _Form("f32", _F32, _F32, "redcliff_factor_mix_f32", 4, False)
_FORM_BF16 = _Form("bf16", _BF16, _BF16, "redcliff_factor_mix_bf16", 2,
                   True)
_FORM_ROUND = _Form("round", _F32, _F32, "redcliff_factor_mix_bf16_round",
                    4, "round")
_FORM_ROUND_W = _Form("round_w", _F32, _BF16,
                      "redcliff_factor_mix_bf16_round_w", 2, "round_w")
_FORMS = {f.name: f for f in (_FORM_F32, _FORM_BF16, _FORM_ROUND,
                              _FORM_ROUND_W)}
# the bf16 form's entry for each (w, p) type pair its callers hold
_BF16_FORMS = {(f.w, f.p): f for f in (_FORM_BF16, _FORM_ROUND,
                                       _FORM_ROUND_W)}


def _bf16_form(w, p):
    """The bf16 form's input form for ``w`` and ``p``'s types; a pair no
    entry takes gets the bf16 entry, whose type check then refuses it."""
    return _BF16_FORMS.get((w.dtype, p.dtype), _FORM_BF16)


@functools.lru_cache(maxsize=256)
def _mix_args(B, K, M, stride_k, stride_b, p_offset, device, G=1,
              stride_wg=0, stride_pg=0, form="f32"):
    """``(_MixArgs, its address)`` for one launch shape on ``device``;
    ``G`` lanes with lane strides ``stride_wg`` (w) and ``stride_pg`` (p),
    one lane with zero lane strides by default; ``form`` names the input
    form (``"f32"``, or the bf16 form's ``"bf16"``, ``"round"``,
    ``"round_w"``), whose p storage sets the plan's alignment. The plan's
    threads are the autotuner's winner for the shape (under the form's own
    key) when it holds one."""
    from redcliff_tpu_torch.ops import autotune

    f = _FORMS[form]
    threads = autotune.plan_threads(*autotune.mix_key(B, K, M, G,
                                                      bf16=f.key))
    args = _MixArgs(B, K, M, *mix_plan(B, M, stride_k, stride_b, p_offset,
                                       stride_pg, threads=threads,
                                       itemsize=f.itemsize),
                    device, stride_k, stride_b, G, stride_wg, stride_pg)
    return args, ctypes.addressof(args)


def load_kernel():
    """Build (first call in a process; cached by content on disk) and bind
    the CUDA kernel. Returns the ctypes library."""
    global _lib, _raw_stream, _capturing
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = build_library("redcliff_factor_mix", KERNEL_SOURCE)
        fns = {}
        for form in _FORMS.values():
            f = fns[form.name] = getattr(lib, form.entry)
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p]
            f.restype = ctypes.c_int
        # the current stream's cudaStream_t of a device, as an int
        _raw_stream = torch._C._cuda_getCurrentRawStream
        # whether the current stream is capturing a CUDA graph
        _capturing = torch._C._cuda_isCurrentStreamCapturing
        # bound last: _run takes a bound entry as the sign that all is set
        for form in _FORMS.values():
            form.fn = fns[form.name]
        _lib = lib
        return _lib


def _run(w, p, B, K, M, stride_k, stride_b, out_shape, G=1, stride_wg=0,
         stride_pg=0, form=_FORM_F32):
    """Launch on checked operands: lane g's ``w (B, K)`` contiguous at
    ``w + g*stride_wg``, its element (k, b, m) of p at
    ``p + g*stride_pg + k*stride_k + b*stride_b + m`` -> a new float32
    ``out_shape`` tensor holding the ``(G, B, M)`` result. ``form`` is the
    operands' input form; a bf16 one counts on ``graph_mix_bf16``, serve
    blend and training form alike."""
    out = w.new_empty(out_shape, dtype=_F32)
    if B == 0 or M == 0 or G == 0:
        return out
    fn = form.fn
    if fn is None:
        load_kernel()
        fn = form.fn
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
                     stride_wg, stride_pg, form.name)
    rc = fn(w.data_ptr(), p_ptr, out.data_ptr(), args[1], _raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"factor_mix kernel launch failed: cudaError {rc}")
    count = graph_mix_bf16 if form.key else factor_mix
    if _capturing():
        count.captured += 1
    else:
        count.launches += 1
    return out


def _operands_ok(w, a, form=_FORM_F32):
    """Both on one CUDA device, of the types ``form`` takes, ``w``
    contiguous."""
    return (w.is_cuda and a.get_device() == w.get_device()
            and w.dtype is form.w and a.dtype is form.p
            and w.is_contiguous())


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


def _refuse(w, p, what, form=_FORM_F32):
    """Raise the error that says why the kernel does not take ``w``, ``p``
    (``what`` names the operands' expected layouts, ``form`` the input
    form they were checked against)."""
    if not (w.is_cuda and p.is_cuda and w.device == p.device):
        raise ValueError(f"factor_mix kernel needs both operands on one CUDA "
                         f"device, got {w.device} and {p.device}")
    if w.dtype is not form.w or p.dtype is not form.p:
        takes = ("float32 w and p" if not form.key else
                 "bfloat16 w and p, float32 w and p, or float32 w with "
                 "bfloat16 p (its bf16 form)")
        raise TypeError(f"factor_mix kernel takes {takes}, got {w.dtype} "
                        f"and {p.dtype}")
    raise ValueError(f"factor_mix kernel wants {what} with w contiguous, the "
                     f"inner block of p contiguous and dimensions below "
                     f"2**31, got w {tuple(w.shape)} strides {w.stride()}, "
                     f"p {tuple(p.shape)} strides {p.stride()}")


def _launch(weightings, preds, form=_FORM_F32):
    """Run the kernel: ``weightings (B, K)``, ``preds (K, B, T, C)`` ->
    ``(B, T, C)`` (layout as :func:`_mix_layout`) on operands of the input
    form ``form``."""
    w, p = weightings, preds
    args = _mix_layout(w, p) if _operands_ok(w, p, form) else None
    if args is None:
        _refuse(w, p, "w (B, K) and p (K, B, T, C)", form)
    return _run(w, p, *args, form=form)


def _launch_lanes(weightings, preds, form=_FORM_F32, copy=False):
    """Run the kernel once for every lane: ``weightings (G, B, K)``,
    ``preds (G, K, B, T, C)`` -> ``(G, B, T, C)`` (layout as
    :func:`_lanes_layout`); ``form`` as :func:`_launch`. With ``copy``,
    operands in a layout the kernel does not take are made contiguous
    first (a ``vmap`` rule's operands); a launch in a layout it takes is
    checked once and copies nothing."""
    w, p = weightings, preds
    ok = _operands_ok(w, p, form)
    args = _lanes_layout(w, p) if ok else None
    if args is None and ok and copy:
        w, p = w.contiguous(), p.contiguous()
        args = _lanes_layout(w, p)
    if args is None:
        _refuse(w, p, f"w (G, B, K) and p (G, K, B, T, C) with G <= "
                      f"{_MAX_LANES}", form)
    return _run(w, p, *args, form=form)


def launch_plan(weightings, preds, bf16=False):
    """``(vec, threads, blocks)`` of the cached plan a launch on these CUDA
    operands takes: ``w (B, K)`` and ``p (K, B, T, C)``, or the lane form's
    ``w (G, B, K)`` and ``p (G, K, B, T, C)``; the f32 kernel on float32
    operands, the bf16 form's input form for their types when ``bf16`` or
    an operand is bfloat16."""
    w, p = weightings, preds
    form = (_bf16_form(w, p) if bf16 or _BF16 in (w.dtype, p.dtype)
            else _FORM_F32)
    lay = ((_lanes_layout if w.dim() == 3 else _mix_layout)(w, p)
           if _operands_ok(w, p, form) else None)
    if lay is None:
        _refuse(w, p, "the single or lane form's operands", form)
    B, K, M, stride_k, stride_b, _, *lanes = lay
    G, stride_wg, stride_pg = lanes or (1, 0, 0)
    # as _run passes them: the stride of an axis of length 1 is 0
    args = _mix_args(B, K, M, 0 if K == 1 else stride_k,
                     0 if B == 1 else stride_b, p.data_ptr() % 16,
                     w.get_device(), G, 0 if G == 1 else stride_wg,
                     0 if G == 1 else stride_pg, form.name)[0]
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


def _mix_bf16_bwd(weightings, preds, g, lanes=False):
    """JAX's backward of the mixed mix: :func:`_mix_bwd`'s contractions on
    the bf16-rounded cotangent and operands, f32 sums and out."""
    r = _prec.bf16_round
    return (_mix_lanes_bwd if lanes else _mix_bwd)(r(weightings), r(preds),
                                                   r(g))


class FactorMixBf16Fn(torch.autograd.Function):
    """The bf16 training form: one kernel launch on the operands as they
    are, the f32 ones rounded to bf16 in registers (the plain version on
    CPU tensors), JAX's bf16 backward; under ``torch.func.vmap`` the bf16
    lane form."""

    @staticmethod
    def forward(weightings, preds):
        if weightings.is_cuda or preds.is_cuda:
            return _launch(weightings, preds,
                           _bf16_form(weightings, preds))
        return factor_mix_bf16_reference(weightings, preds)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        weightings, preds = ctx.saved_tensors
        return _mix_bf16_bwd(weightings, preds, g)

    @staticmethod
    def vmap(info, in_dims, weightings, preds):
        w = _lane_operand(weightings, in_dims[0], info.batch_size)
        p = _lane_operand(preds, in_dims[1], info.batch_size)
        return factor_mix_lanes_bf16(w, p), 0


class FactorMixLanesBf16Fn(torch.autograd.Function):
    """The bf16 lane form with autograd: one kernel launch on the operands
    as they are (made contiguous only where the lane layout is not one the
    kernel takes), JAX's bf16 backward."""

    @staticmethod
    def forward(weightings, preds):
        if weightings.is_cuda or preds.is_cuda:
            return _launch_lanes(weightings, preds,
                                 _bf16_form(weightings, preds), copy=True)
        return factor_mix_lanes_bf16_reference(weightings, preds)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        weightings, preds = ctx.saved_tensors
        return _mix_bf16_bwd(weightings, preds, g, lanes=True)


def _wants_grad(a, b):
    return torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)


_is_transformed = torch._C._functorch.is_functorch_wrapped_tensor


def factor_mix(weightings, preds):
    """``weightings (B, K)``, ``preds (K, B, T, C)`` -> ``(B, T, C)``: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors. Under
    ``torch.func.vmap`` the lane form of the kernel runs once for all
    lanes. Inside a ``"bfloat16"`` matmul context the bf16 training form
    (:func:`factor_mix_bf16`)."""
    if _prec.bf16_active():
        return factor_mix_bf16(weightings, preds)
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


def factor_mix_bf16(weightings, preds):
    """The bf16 training form: ``weightings (B, K)``, ``preds (K, B, T,
    C)`` rounded to bf16 -> float32 ``(B, T, C)``, summed in f32 in K
    order. CUDA operands launch the kernel once as they are (f32 ones
    rounded in registers by ``redcliff_factor_mix_bf16_round``; counted in
    ``graph_mix_bf16.launches``), CPU operands take
    :func:`factor_mix_bf16_reference`. Differentiated (or under
    ``torch.func``) through :class:`FactorMixBf16Fn`."""
    w, p = weightings, preds
    if (_wants_grad(w, p) or _is_transformed(w) or _is_transformed(p)):
        return FactorMixBf16Fn.apply(w, p)
    if w.is_cuda or p.is_cuda:
        return _launch(w, p, _bf16_form(w, p))
    return factor_mix_bf16_reference(w, p)


def factor_mix_lanes_bf16(weightings, preds):
    """The bf16 lane form: ``weightings (G, B, K)``, ``preds (G, K, B, T,
    C)`` rounded to bf16 -> float32 ``(G, B, T, C)``, one launch for every
    lane on CUDA tensors, :func:`factor_mix_lanes_bf16_reference` on CPU
    tensors; through :class:`FactorMixLanesBf16Fn` when differentiated."""
    w, p = weightings, preds
    if _wants_grad(w, p):
        return FactorMixLanesBf16Fn.apply(w, p)
    return FactorMixLanesBf16Fn.forward(w, p)


def graph_mix(weightings, static_gc):
    """Serve-path graph blend: ``weightings (S, K)`` x ``static_gc
    (K, C, C)`` -> ``(S, C, C)``. On CUDA the K graphs reach the kernel with
    ``stride_b = 0``; nothing of size (K, S, C, C) is made. A bf16 operand
    takes the bf16 form (:func:`graph_mix_bf16`)."""
    w, g = weightings, static_gc
    if w.dtype is _BF16 or g.dtype is _BF16:
        return graph_mix_bf16(w, g)
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


def graph_mix_bf16(weightings, static_gc):
    """The bf16 form of the serve blend: float32 or bf16 ``weightings (S,
    K)`` x bf16 ``static_gc (K, C, C)`` -> float32 ``(S, C, C)``, f32
    weightings rounded to bf16, summed in f32 in K order. CUDA operands
    launch the kernel once (``redcliff_factor_mix_bf16_round_w`` for f32
    weightings, ``redcliff_factor_mix_bf16`` for bf16 ones; counted in
    ``graph_mix_bf16.launches``), CPU operands take
    :func:`graph_mix_bf16_reference`. Differentiated, it is the bf16
    training form on the graphs broadcast over S."""
    w, g = weightings, static_gc
    if not (w.is_cuda or g.is_cuda):
        return graph_mix_bf16_reference(w, g)
    if _wants_grad(w, g):
        K, S = g.shape[0], w.shape[0]
        return FactorMixBf16Fn.apply(
            w, g.contiguous()[:, None].expand((K, S) + tuple(g.shape[1:])))
    form = _bf16_form(w, g)
    args = _graph_layout(w, g) if _operands_ok(w, g, form) else None
    if args is None:
        _refuse(w, g, "w (S, K) and static_gc (K, C, C)", form)
    return _run(w, g, *args, form=form)


graph_mix_bf16.launches = 0
graph_mix_bf16.captured = 0
