"""The port's factor mix (redcliff_tpu_torch/ops/factor_mix.py) against the
JAX package's reference einsum and its Pallas kernel in interpret mode.

On the CPU the port's wrappers take the plain version; the CUDA kernel is
held against that plain version on the card (``gpu``-marked test here, and
chip_smoke.py). Inputs are made with numpy from a seed and handed to both
frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from redcliff_tpu.ops.factor_mix import factor_mix_pallas  # noqa: E402
from redcliff_tpu.ops.factor_mix import \
    factor_mix_reference as jax_factor_mix_reference  # noqa: E402
from redcliff_tpu.ops.factor_mix import graph_mix as jax_graph_mix  # noqa: E402
from redcliff_tpu.ops.factor_mix import \
    graph_mix_reference as jax_graph_mix_reference  # noqa: E402
from redcliff_tpu_torch.ops import factor_mix as FM  # noqa: E402

# f32 against f32, a different summation order over K: the ROADMAP bar
# (tests/test_precision_kernels.py:129)
RTOL, ATOL = 1e-5, 1e-6

MIX_SHAPES = ((17, 5, 1, 10), (32, 2, 2, 4), (3, 4, 1, 7))


def _mix_inputs(seed, B, K, T, C):
    rng = np.random.default_rng(seed)
    return (rng.random((B, K)).astype(np.float32),
            rng.normal(size=(K, B, T, C)).astype(np.float32))


@pytest.mark.parametrize("shape", MIX_SHAPES)
def test_factor_mix_plain_matches_jax_reference_and_pallas(shape):
    w, p = _mix_inputs(0, *shape)
    tw, tp = torch.from_numpy(w), torch.from_numpy(p)
    jw, jp = jnp.asarray(w), jnp.asarray(p)
    want_ref = np.asarray(jax_factor_mix_reference(jw, jp))
    want_pallas = np.asarray(factor_mix_pallas(jw, jp, block_b=8,
                                               interpret=True))
    for got in (FM.factor_mix(tw, tp), FM.factor_mix_reference(tw, tp)):
        assert tuple(got.shape) == want_ref.shape
        np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want_pallas, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("S,K,C", ((64, 5, 10), (3, 5, 10), (7, 2, 4)))
def test_graph_mix_plain_matches_jax(S, K, C):
    rng = np.random.default_rng(S + K + C)
    w = rng.random((S, K)).astype(np.float32)
    gc = rng.normal(size=(K, C, C)).astype(np.float32)
    jw, jg = jnp.asarray(w), jnp.asarray(gc)
    want_ref = np.asarray(jax_graph_mix_reference(jw, jg))
    want_pallas = np.asarray(jax_graph_mix(jw, jg, interpret=True))
    tw, tg = torch.from_numpy(w), torch.from_numpy(gc)
    for got in (FM.graph_mix(tw, tg), FM.graph_mix_reference(tw, tg)):
        np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want_pallas, rtol=RTOL,
                                   atol=ATOL)


def test_factor_mix_grads_match_jax_custom_vjp():
    """Grads of the port's plain path and the autograd Function's backward
    (the two einsums of the JAX ``_mix_bwd``) against ``jax.grad`` through
    the Pallas kernel's custom VJP, as tests/test_precision_kernels.py:104."""
    rng = np.random.default_rng(1)
    w = rng.random((6, 3)).astype(np.float32)
    p = rng.normal(size=(3, 6, 1, 4)).astype(np.float32)
    f_pl = lambda w, p: jnp.sum(jnp.sin(  # noqa: E731
        factor_mix_pallas(w, p, block_b=4, interpret=True)))
    jg_w, jg_p = jax.grad(f_pl, argnums=(0, 1))(jnp.asarray(w),
                                                jnp.asarray(p))

    tw = torch.tensor(w, requires_grad=True)
    tp = torch.tensor(p, requires_grad=True)
    torch.sin(FM.factor_mix(tw, tp)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg_w), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg_p), rtol=RTOL,
                               atol=ATOL)

    g = torch.cos(FM.factor_mix_reference(torch.from_numpy(w),
                                          torch.from_numpy(p)))
    dw, dp = FM._mix_bwd(torch.from_numpy(w), torch.from_numpy(p), g)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jg_w), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dp.numpy(), np.asarray(jg_p), rtol=RTOL,
                               atol=ATOL)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """CPU tensors take the plain version: no launch is counted, no kernel
    build is attempted, and the launch path itself refuses CPU tensors."""
    def no_build():
        raise AssertionError("CPU tensors must not build the kernel")

    monkeypatch.setattr(FM, "load_kernel", no_build)
    monkeypatch.setattr(FM, "_lib", None)
    before = FM.factor_mix.launches
    w, p = _mix_inputs(2, 4, 3, 1, 5)
    FM.factor_mix(torch.from_numpy(w), torch.from_numpy(p))
    FM.graph_mix(torch.from_numpy(w), torch.from_numpy(p[:, 0]))
    assert FM.factor_mix.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        FM._launch(torch.from_numpy(w), torch.from_numpy(p))


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version, forward and grads, at the
    serve-path shapes (runs where a card is present)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for B, K, T, C in ((64, 5, 1, 10), (64, 5, 2, 10), (17, 5, 1, 10)):
        w, p = _mix_inputs(3, B, K, T, C)
        tw = torch.tensor(w, device=dev, requires_grad=True)
        tp = torch.tensor(p, device=dev, requires_grad=True)
        got = FM.factor_mix(tw, tp)
        want = FM.factor_mix_reference(tw.detach(), tp.detach())
        torch.testing.assert_close(got.detach(), want, rtol=RTOL, atol=ATOL)
        got.sin().sum().backward()
        rw = tw.detach().clone().requires_grad_(True)
        rp = tp.detach().clone().requires_grad_(True)
        FM.factor_mix_reference(rw, rp).sin().sum().backward()
        torch.testing.assert_close(tw.grad, rw.grad, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(tp.grad, rp.grad, rtol=RTOL, atol=ATOL)
    gc = torch.randn((5, 10, 10), device=dev)
    for S in (64, 3):
        w = torch.rand((S, 5), device=dev)
        torch.testing.assert_close(FM.graph_mix(w, gc),
                                   FM.graph_mix_reference(w, gc),
                                   rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()


# ---------------------------------------------------------------- launch plan
@pytest.mark.parametrize("B,M,sk,sb,off,vec", [
    (64, 100, 100, 0, 0, 4),       # the serve tick: graphs broadcast over S
    (128, 10, 1280, 10, 0, 2),     # the training forward
    (1, 10, 10, 0, 0, 2),          # the load-time mix (B = 1: stride 0)
    (32, 7, 224, 7, 0, 1),         # an odd width
    (64, 100, 100, 0, 4, 1),       # p offset by one float
    (64, 100, 100, 0, 8, 2),       # offset by two floats: 8-byte aligned
    (64, 100, 102, 0, 0, 2),       # a K stride that is not a multiple of 4
    (64, 100, 100, 6402, 0, 2),    # a B stride that is not a multiple of 4
    (64, 100, 100, 6401, 0, 1),    # an odd B stride
])
def test_mix_plan_vector_width(B, M, sk, sb, off, vec):
    """float4 only at M % 4 == 0 with a 16-byte aligned base and strides,
    float2 at multiples of 2 and 8 bytes, scalar otherwise."""
    assert FM.mix_plan(B, M, sk, sb, off)[0] == vec


def test_mix_plan_never_float4_when_misaligned():
    """No offset that is not a multiple of 16 bytes, and no stride that is
    not a multiple of 4 floats, ever gets float4 (nor float2 below 8 bytes
    and 2 floats). A float32 tensor's address is a multiple of 4 bytes."""
    for off in range(0, 16, 4):
        for sk in (0, 40, 41, 42, 100):
            for sb in (0, 10, 20, 21, 100):
                for M in (4, 8, 10, 100):
                    vec = FM.mix_plan(64, M, sk, sb, off)[0]
                    assert M % vec == 0
                    assert off % (4 * vec) == 0
                    assert sk % vec == 0 and sb % vec == 0


@pytest.mark.parametrize("B,M", [(1, 10), (64, 100), (128, 10), (117, 10),
                                 (32, 7), (4096, 1000), (1, 1)])
def test_mix_plan_grid_covers_every_output(B, M):
    """threads * blocks covers the B * M / vec work items with less than one
    block to spare, in blocks of 128 or 256 threads."""
    vec, threads, blocks = FM.mix_plan(B, M, M, M, 0)
    n = B * M // vec
    assert threads in (128, 256)
    assert blocks * threads >= n > (blocks - 1) * threads


# ------------------------------------------------- the launch's layout, on CPU
def _emulate(w, p, B, K, M, stride_k, stride_b, out_shape):
    """The kernel's addressing on the CPU: element (k, b, m) of p at
    ``k*stride_k + b*stride_b + m`` from p's first element."""
    view = torch.as_strided(p, (K, B, M), (stride_k, stride_b, 1),
                            p.storage_offset())
    return torch.einsum("bk,kbm->bm", w, view).reshape(out_shape)


@pytest.mark.parametrize("S,K,C", ((64, 5, 10), (3, 5, 10), (7, 2, 4)))
def test_graph_mix_layout_without_expand_matches_jax(S, K, C):
    """What graph_mix hands the kernel — the graphs themselves with
    stride_b = 0, no expand view — computes the JAX blend."""
    rng = np.random.default_rng(S * K * C)
    w = rng.random((S, K)).astype(np.float32)
    gc = rng.normal(size=(K, C, C)).astype(np.float32)
    tw, tg = torch.from_numpy(w), torch.from_numpy(gc)
    args = FM._graph_layout(tw, tg)
    assert args[4] == 0 and args[5] == (S, C, C)
    want = np.asarray(jax_graph_mix_reference(jnp.asarray(w),
                                              jnp.asarray(gc)))
    np.testing.assert_allclose(_emulate(tw, tg, *args).numpy(), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", MIX_SHAPES)
def test_factor_mix_layout_matches_jax_on_views(shape):
    """The layout the kernel is handed for a contiguous p, a p offset by
    one float in its storage, and a p whose B axis is a strided slice
    computes the JAX mix."""
    w, p = _mix_inputs(4, *shape)
    want = np.asarray(jax_factor_mix_reference(jnp.asarray(w),
                                               jnp.asarray(p)))
    tw = torch.from_numpy(w)
    base = torch.from_numpy(p)
    flat = torch.zeros(base.numel() + 1)
    flat[1:] = base.reshape(-1)
    wide = torch.zeros((shape[1], 2 * shape[0]) + shape[2:])
    wide[:, ::2] = base
    for tp in (base, flat[1:].view(base.shape), wide[:, ::2]):
        assert torch.equal(tp, base)
        args = FM._mix_layout(tw, tp)
        assert args is not None
        np.testing.assert_allclose(_emulate(tw, tp, *args).numpy(), want,
                                   rtol=RTOL, atol=ATOL)
    # a p whose (T, C) block is not contiguous is refused
    assert FM._mix_layout(tw, base.transpose(2, 3)) is None or shape[2] == 1


@pytest.mark.parametrize("grad_mode", [True, False])
@pytest.mark.parametrize("requires", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_autograd_function_only_when_a_gradient_is_wanted(grad_mode,
                                                          requires):
    """The wrappers take FactorMixFn only with grad mode on and an operand
    that requires grad; the no-grad and grad-enabled CPU results agree."""
    w, p = _mix_inputs(5, 6, 3, 1, 4)
    tw = torch.tensor(w, requires_grad=requires[0])
    tp = torch.tensor(p, requires_grad=requires[1])
    with torch.set_grad_enabled(grad_mode):
        assert FM._wants_grad(tw, tp) == (grad_mode and any(requires))
        got = FM.factor_mix(tw, tp)
    with torch.no_grad():
        plain = FM.factor_mix(tw, tp)
    assert got.requires_grad == (grad_mode and any(requires))
    assert torch.equal(got.detach(), plain)


@pytest.mark.gpu
def test_misaligned_and_odd_width_launches_on_card():
    """On the card: p and the graphs offset by one float (the scalar path),
    M = 100, 10 and 7, K above the unrolled 16, against the plain
    version; an operand on another device raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")

    def offset(t):
        flat = torch.empty(t.numel() + 1, device=dev)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    for B, K, T, C in ((64, 5, 10, 10), (128, 5, 1, 10), (32, 5, 1, 7),
                       (8, 20, 1, 12)):
        w, p = _mix_inputs(6, B, K, T, C)
        tw = torch.tensor(w, device=dev)
        for tp in (torch.tensor(p, device=dev),
                   offset(torch.tensor(p, device=dev))):
            torch.testing.assert_close(FM.factor_mix(tw, tp),
                                       FM.factor_mix_reference(tw, tp),
                                       rtol=RTOL, atol=ATOL)
    gc = torch.randn((5, 10, 10), device=dev)
    w = torch.rand((64, 5), device=dev)
    torch.testing.assert_close(FM.graph_mix(w, offset(gc)),
                               FM.graph_mix_reference(w, gc),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="CUDA"):
        FM.graph_mix(w, gc.cpu())
    torch.cuda.synchronize()


# ------------------------------------------------------------ the lane form
LANE_SHAPES = ((4, 17, 5, 1, 10), (3, 6, 2, 2, 4), (2, 3, 4, 1, 7))


def _lane_inputs(seed, G, B, K, T, C):
    rng = np.random.default_rng(seed)
    return (rng.random((G, B, K)).astype(np.float32),
            rng.normal(size=(G, K, B, T, C)).astype(np.float32))


@pytest.mark.parametrize("shape", LANE_SHAPES)
def test_factor_mix_lanes_plain_matches_jax_vmap_of_pallas(shape):
    """The plain lane version, ``factor_mix_lanes`` on CPU tensors, and
    FactorMixFn under ``torch.func.vmap`` (its vmap rule) against
    ``jax.vmap`` of the Pallas kernel in interpret mode, as the JAX grid
    batches it."""
    w, p = _lane_inputs(7, *shape)
    want = np.asarray(jax.vmap(
        lambda a, b: factor_mix_pallas(a, b, block_b=8, interpret=True))(
            jnp.asarray(w), jnp.asarray(p)))
    tw, tp = torch.from_numpy(w), torch.from_numpy(p)
    before = FM.factor_mix.launches
    for got in (FM.factor_mix_lanes_reference(tw, tp),
                FM.factor_mix_lanes(tw, tp),
                torch.func.vmap(FM.FactorMixFn.apply)(tw, tp),
                torch.func.vmap(FM.factor_mix)(tw, tp)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert FM.factor_mix.launches == before


@pytest.mark.parametrize("shape", LANE_SHAPES)
def test_vmap_rule_grads_match_jax_vmap_of_custom_vjp(shape):
    """Per-lane gradients through the vmap rule (``torch.func.vmap`` of
    ``torch.func.grad``, the grid step's transform) and through the lane
    backward against ``jax.vmap`` of ``jax.grad`` through the Pallas
    kernel's custom VJP, for a loss weighting each output by a fixed
    random cotangent."""
    w, p = _lane_inputs(8, *shape)
    r = np.random.default_rng(18).normal(
        size=(shape[0], shape[1]) + shape[3:]).astype(np.float32)

    def f_pl(a, b, c):
        return jnp.sum(c * factor_mix_pallas(a, b, block_b=4,
                                             interpret=True))
    jg_w, jg_p = jax.vmap(jax.grad(f_pl, argnums=(0, 1)))(
        jnp.asarray(w), jnp.asarray(p), jnp.asarray(r))

    def f_t(a, b, c):
        return (c * FM.FactorMixFn.apply(a, b)).sum()
    tw, tp, tr = torch.from_numpy(w), torch.from_numpy(p), torch.from_numpy(r)
    gw, gp = torch.func.vmap(torch.func.grad(f_t, argnums=(0, 1)))(tw, tp,
                                                                   tr)
    dw, dp = FM._mix_lanes_bwd(tw, tp, tr)
    # ordinary autograd through a vmapped forward
    aw = tw.clone().requires_grad_(True)
    ap = tp.clone().requires_grad_(True)
    (tr * torch.func.vmap(FM.FactorMixFn.apply)(aw, ap)).sum().backward()
    for got_w, got_p in ((gw, gp), (dw, dp), (aw.grad, ap.grad)):
        np.testing.assert_allclose(got_w.numpy(), np.asarray(jg_w),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(jg_p),
                                   rtol=RTOL, atol=ATOL)


def _emulate_lanes(w, p, B, K, M, stride_k, stride_b, out_shape, G,
                   stride_wg, stride_pg):
    """The lane launch's addressing on the CPU: lane g's w at
    ``g*stride_wg``, its element (k, b, m) of p at
    ``g*stride_pg + k*stride_k + b*stride_b + m``."""
    wv = torch.as_strided(w, (G, B, K), (stride_wg, K, 1), w.storage_offset())
    pv = torch.as_strided(p, (G, K, B, M), (stride_pg, stride_k, stride_b, 1),
                          p.storage_offset())
    return torch.einsum("gbk,gkbm->gbm", wv, pv).reshape(out_shape)


@pytest.mark.parametrize("shape", LANE_SHAPES)
def test_lane_layout_matches_jax_on_views(shape):
    """The layout the lane launch is handed for contiguous operands, a p
    offset by one float, a p whose lane axis is a strided slice and a w
    broadcast over the lanes (lane stride 0, as the vmap rule passes an
    operand without a lane axis) computes the JAX mix per lane."""
    w, p = _lane_inputs(9, *shape)
    G = shape[0]
    tw, base = torch.from_numpy(w), torch.from_numpy(p)
    flat = torch.zeros(base.numel() + 1)
    flat[1:] = base.reshape(-1)
    wide = torch.zeros((2 * G,) + base.shape[1:])
    wide[::2] = base
    for tp in (base, flat[1:].view(base.shape), wide[::2]):
        args = FM._lanes_layout(tw, tp)
        assert args is not None and args[6] == G
        want = np.asarray(jax.vmap(
            lambda a, b: factor_mix_pallas(a, b, interpret=True))(
                jnp.asarray(w), jnp.asarray(tp.numpy())))
        np.testing.assert_allclose(_emulate_lanes(tw, tp, *args).numpy(),
                                   want, rtol=RTOL, atol=ATOL)
    w0 = tw[:1].expand(tw.shape)
    args = FM._lanes_layout(w0, base)
    assert args is not None and args[7] == 0
    np.testing.assert_allclose(
        _emulate_lanes(w0, base, *args).numpy(),
        FM.factor_mix_lanes_reference(w0, base).numpy(), rtol=RTOL,
        atol=ATOL)
    # a w whose (B, K) block is not contiguous is refused
    assert FM._lanes_layout(tw.transpose(1, 2).contiguous().transpose(
        1, 2), base) is None or shape[2] == 1


def test_mix_plan_lane_stride():
    """The lane stride of p joins the alignment rule: float4 only when it
    is a multiple of 4 floats too."""
    assert FM.mix_plan(128, 10, 1280, 10, 0, 6400)[0] == 2
    assert FM.mix_plan(64, 100, 100, 0, 0, 500)[0] == 4
    assert FM.mix_plan(64, 100, 100, 0, 0, 502)[0] == 2
    assert FM.mix_plan(64, 100, 100, 0, 0, 501)[0] == 1


def test_lane_launch_refuses_cpu_tensors(monkeypatch):
    def no_build():
        raise AssertionError("CPU tensors must not build the kernel")

    monkeypatch.setattr(FM, "load_kernel", no_build)
    w, p = _lane_inputs(2, 2, 4, 3, 1, 5)
    with pytest.raises(ValueError, match="CUDA"):
        FM._launch_lanes(torch.from_numpy(w), torch.from_numpy(p))


@pytest.mark.gpu
def test_lane_kernel_matches_plain_on_card():
    """The lane launch against the plain lane version on the card: the
    grid's training shape and its remainder batch, a p offset by one float,
    one launch per call for every lane, the vmap rule's gradients and
    ordinary autograd through a vmapped forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")

    def offset(t):
        flat = torch.empty(t.numel() + 1, device=dev)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    for G, B in ((27, 128), (27, 80), (3, 17)):
        w, p = _lane_inputs(10, G, B, 5, 1, 10)
        tw = torch.tensor(w, device=dev)
        for tp in (torch.tensor(p, device=dev),
                   offset(torch.tensor(p, device=dev))):
            before = FM.factor_mix.launches
            got = FM.factor_mix_lanes(tw, tp)
            assert FM.factor_mix.launches == before + 1
            torch.testing.assert_close(
                got, FM.factor_mix_lanes_reference(tw, tp), rtol=RTOL,
                atol=ATOL)
        tp = torch.tensor(p, device=dev)

        def f(a, b, mix):
            return torch.sin(mix(a, b)).sum()
        got = torch.func.vmap(torch.func.grad(
            lambda a, b: f(a, b, FM.FactorMixFn.apply), argnums=(0, 1)))(
                tw, tp)
        want = torch.func.vmap(torch.func.grad(
            lambda a, b: f(a, b, FM.factor_mix_reference), argnums=(0, 1)))(
                tw, tp)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        # ordinary autograd through a vmapped forward (FactorMixLanesFn),
        # with a fixed cotangent
        r = torch.randn(got[0].shape[:2] + (1, 10), device=dev)
        aw, ap = tw.clone().requires_grad_(True), tp.clone().requires_grad_(
            True)
        rw, rp = tw.clone().requires_grad_(True), tp.clone().requires_grad_(
            True)
        (r * torch.func.vmap(FM.FactorMixFn.apply)(aw, ap)).sum().backward()
        (r * FM.factor_mix_lanes_reference(rw, rp)).sum().backward()
        torch.testing.assert_close(aw.grad, rw.grad, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(ap.grad, rp.grad, rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()
