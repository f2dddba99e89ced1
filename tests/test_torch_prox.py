"""The port's proximal operators (redcliff_tpu_torch/ops/prox.py,
ops/pallas_prox.py) against the JAX package.

Inputs are made with numpy from a seed. The GL kernel is a CUDA kernel
with no CPU mode: here the wrapper runs its plain version (CPU tensors),
held against the JAX Pallas kernel in interpret mode; the ``gpu``-marked
test holds the kernel against the plain version on a card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.ops import prox as jprox  # noqa: E402
from redcliff_tpu.ops.pallas_prox import gl_prox_pallas  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.ops import pallas_prox as PX  # noqa: E402
from redcliff_tpu_torch.ops import prox as tprox  # noqa: E402

# f32 in both frameworks, a different summation order of the group norms:
# the bar of tests/test_precision_kernels.py:129
TOL = dict(rtol=1e-5, atol=1e-6)

# the off-tile shapes of tests/test_precision_kernels.py:117-121 and the
# training slice's first-layer block (K, C_out, H, C_in, L)
SHAPES = [(3, 7, 5, 7, 3), (1, 1, 3, 1, 1), (5, 12, 32, 12, 4),
          (5, 10, 25, 10, 4)]
# (lam, lr): small, large enough to zero groups, and zero
STEPS = [(0.013, 0.002), (50.0, 0.05), (0.0, 1e-3)]


def _w(shape, seed=2, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("lam,lr", STEPS)
@pytest.mark.parametrize("penalty", ["GL", "GSGL", "H"])
@pytest.mark.parametrize("shape", SHAPES[:3] + [(2, 6, 3, 5)])
def test_plain_prox_matches_jax(shape, penalty, lam, lr):
    W = _w(shape, scale=0.3)
    _close(tprox.prox_update(torch.from_numpy(W), lam, lr, penalty),
           jprox.prox_update(jnp.asarray(W), lam, lr, penalty))


def test_h_prox_nested_prefix_order():
    """H shrinks the nested lag prefixes [:1], [:2], ... in that order:
    the most-lagged value (index 0) is thresholded L times."""
    W = _w((2, 4, 3, 5), seed=5, scale=0.2)
    got = tprox.prox_update(torch.from_numpy(W), 0.5, 0.1, "H")
    _close(got, jprox.prox_update(jnp.asarray(W), 0.5, 0.1, "H"))
    # the order matters: the reversed order (longest prefix first) differs
    rev = torch.from_numpy(W)
    t = tprox.threshold(0.5, 0.1)
    for i in reversed(range(W.shape[-1])):
        pre = rev[..., : i + 1]
        n = torch.sqrt(torch.sum(pre * pre, dim=(-3, -1), keepdim=True))
        rev = torch.cat([tprox.soft_threshold_by_group_norm(pre, n, t),
                         rev[..., i + 1:]], dim=-1)
    assert not torch.allclose(got, rev, **TOL)


@pytest.mark.parametrize("penalty", ["GL", "GSGL", "H"])
def test_penalties_match_jax(penalty):
    W = _w((3, 4, 6, 4, 3), seed=3)
    got = tprox.group_lasso_penalty(torch.from_numpy(W), 0.7, penalty)
    want = jprox.group_lasso_penalty(jnp.asarray(W), 0.7, penalty)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    with pytest.raises(ValueError, match="unsupported"):
        tprox.group_lasso_penalty(torch.from_numpy(W), 0.7, "L1")
    with pytest.raises(ValueError, match="unsupported"):
        tprox.prox_update(torch.from_numpy(W), 0.7, 0.1, "L1")


def test_ridge_penalty_matches_jax():
    leaves = [_w((4, 5), seed=s) for s in (6, 7, 8)]
    got = tprox.ridge_penalty([torch.from_numpy(x) for x in leaves], 0.03)
    want = jprox.ridge_penalty([jnp.asarray(x) for x in leaves], 0.03)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("lam,lr", STEPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gl_prox_on_cpu_matches_jax_pallas_interpret(shape, lam, lr):
    """The wrapper's CPU path against the TPU kernel run in interpret mode,
    at the off-tile shapes and the slice's shape."""
    W = _w(shape, scale=0.05)
    before = PX.gl_prox.launches
    got = PX.gl_prox(torch.from_numpy(W), lam, lr)
    want = gl_prox_pallas(jnp.asarray(W), lam, lr, block_rows=7,
                          interpret=True)
    _close(got, want)
    assert PX.gl_prox.launches == before


def test_gl_prox_edge_groups_match_jax():
    """An all-zero group stays zero, a group exactly at the threshold goes
    to zero, and the groups around them are untouched by either."""
    W = _w((2, 3, 5, 3, 4), seed=9)
    lam, lr = 1.0, 0.25
    t = np.float32(lr * lam)
    W[0, 0, :, 1, :] = 0.0
    g = W[1, 2, :, 0, :].astype(np.float64)
    W[1, 2, :, 0, :] = (g * (float(t) / np.sqrt((g * g).sum()))).astype(
        np.float32)
    got = PX.gl_prox(torch.from_numpy(W), lam, lr)
    _close(got, gl_prox_pallas(jnp.asarray(W), lam, lr, interpret=True))
    assert float(got[0, 0, :, 1, :].abs().max()) == 0.0
    assert float(got[1, 2, :, 0, :].abs().max()) < 1e-6


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """GL on a CPU tensor takes the plain version: no build, no launch;
    the launch path itself refuses CPU tensors and other dtypes."""
    def no_build():
        raise AssertionError("CPU tensors must not build the kernel")

    monkeypatch.setattr(PX, "load_kernel", no_build)
    monkeypatch.setattr(PX, "_lib", None)
    before = PX.gl_prox.launches
    W = torch.from_numpy(_w((2, 3, 4, 3, 2)))
    for pen in ("GL", "GSGL", "H"):
        PX.gl_prox(W, 0.1, 0.1, pen)
    assert PX.gl_prox.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        PX._launch(W, 0.1, 0.1)


@pytest.mark.parametrize("lam,lr", STEPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gl_prox_inplace_on_cpu_matches_jax_pallas_interpret(shape, lam,
                                                              lr):
    """gl_prox_ on a CPU tensor writes the plain result into the tensor it
    was given, and that result is the TPU kernel's in interpret mode."""
    W = _w(shape, scale=0.05)
    Wt = torch.from_numpy(W.copy())
    ptr = Wt.data_ptr()
    before = PX.gl_prox.launches
    got = PX.gl_prox_(Wt, lam, lr)
    assert got is Wt and Wt.data_ptr() == ptr
    _close(Wt, gl_prox_pallas(jnp.asarray(W), lam, lr, block_rows=7,
                              interpret=True))
    assert PX.gl_prox.launches == before


def test_gl_prox_inplace_edge_groups_match_jax():
    """In place: an all-zero group stays zero, a group exactly at the
    threshold goes to zero, as in the TPU kernel."""
    W = _w((2, 3, 5, 3, 4), seed=9)
    lam, lr = 1.0, 0.25
    t = np.float32(lr * lam)
    W[0, 0, :, 1, :] = 0.0
    g = W[1, 2, :, 0, :].astype(np.float64)
    W[1, 2, :, 0, :] = (g * (float(t) / np.sqrt((g * g).sum()))).astype(
        np.float32)
    Wt = torch.from_numpy(W.copy())
    PX.gl_prox_(Wt, lam, lr)
    _close(Wt, gl_prox_pallas(jnp.asarray(W), lam, lr, interpret=True))
    assert float(Wt[0, 0, :, 1, :].abs().max()) == 0.0
    assert float(Wt[1, 2, :, 0, :].abs().max()) < 1e-6


@pytest.mark.parametrize("penalty", ["GL", "GSGL", "H"])
def test_gl_prox_inplace_equals_functional(penalty):
    """Every penalty: the in-place form leaves exactly the functional
    result in the tensor."""
    W = torch.from_numpy(_w((3, 4, 6, 4, 3), seed=4, scale=0.3))
    want = PX.gl_prox(W, 0.2, 0.1, penalty)
    got = W.clone()
    PX.gl_prox_(got, 0.2, 0.1, penalty)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,offset,chunk,bulk", [
    ((5, 10, 25, 10, 4), 0, 1000, True),    # the training block: 4,000 B
    ((5, 10, 25, 10, 4), 4, 1000, False),   # offset by one float
    ((5, 10, 25, 10, 4), 8, 1000, False),
    ((3, 7, 5, 7, 3), 0, 105, False),       # a slab of 420 B, not 16k
    ((1, 1, 3, 1, 1), 0, 3, False),
    ((5, 12, 32, 12, 4), 0, 1536, True),
    ((2, 3, 200, 10, 8), 0, 12252, True),   # 16,000 floats: two chunks
    ((2, 1, 3001, 1, 5), 0, 12268, False),  # 15,005 floats: two chunks
])
def test_prox_plan(shape, offset, chunk, bulk):
    """The whole slab is staged when it fits beside the per-group floats
    in 48 KB less the kernel's static 64 bytes, else chunks of a
    multiple of 4 floats; the TMA path only for
    a 16-byte aligned block whose slabs are whole 16-byte units."""
    *_, H, C, L = shape
    got_chunk, got_bulk, threads = PX.prox_plan(H, C, L, offset)
    assert (got_chunk, bool(got_bulk)) == (chunk, bulk)
    assert threads % 32 == 0 and 128 <= threads <= 512
    assert threads == 32 * C or not 4 <= C <= 16
    assert 4 * (got_chunk + 2 * C) <= 48 * 1024 - 64
    if got_chunk < H * C * L:
        assert got_chunk % 4 == 0


def test_prox_plan_refuses_what_shared_memory_cannot_hold():
    assert PX.prox_plan(1, 6134, 1, 0)[0] == 4
    with pytest.raises(ValueError, match="C_in"):
        PX.prox_plan(1, 6135, 1, 0)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        PX.prox_plan(2 ** 20, 16, 2 ** 7, 0)


def _model():
    cfg = jred.RedcliffSCMLPConfig(
        num_chans=4, gen_lag=3, gen_hidden=(5,), embed_lag=4,
        embed_hidden_sizes=(6,), num_factors=3, num_supervised_factors=2,
        factor_score_embedder_type="cEmbedder",
        primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
        training_mode="combined")
    jm = jred.RedcliffSCMLP(cfg)
    tm = tred.RedcliffSCMLP(
        tred.RedcliffSCMLPConfig(**dataclasses.asdict(cfg)))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, jp, tm, interop.params_from_jax(jp, "cpu")


@pytest.mark.parametrize("penalty", ["GL", "GSGL", "H"])
def test_apply_prox_changes_only_the_first_layer(penalty):
    """apply_prox rewrites factors[0]["w"] and nothing else, and matches
    the JAX model's apply_prox."""
    jm, jp, tm, tp = _model()
    out = tm.apply_prox(tp, lam=0.1, lr=0.5, penalty=penalty)
    want = jm.apply_prox(jax.tree.map(jnp.asarray, jp), lam=0.1, lr=0.5,
                         penalty=penalty)
    _close(out["factors"][0]["w"], want["factors"][0]["w"])
    assert not torch.equal(out["factors"][0]["w"], tp["factors"][0]["w"])
    torch.testing.assert_close(out["factors"][0]["b"],
                               tp["factors"][0]["b"], rtol=0, atol=0)
    rest_got = jax.tree.leaves(interop.params_to_jax(
        {"f": out["factors"][1:], "e": out["embedder"]}))
    rest_want = jax.tree.leaves({"f": jp["factors"][1:],
                                 "e": jp["embedder"]})
    for a, b in zip(rest_got, rest_want):
        np.testing.assert_array_equal(a, b)


def test_apply_prox_inplace_matches_apply_prox():
    """apply_prox_ rewrites the first-layer block in its own storage with
    the functional apply_prox's values, and touches no other leaf."""
    _, _, tm, tp = _model()
    want = tm.apply_prox(tp, lam=0.1, lr=0.5)
    w = tp["factors"][0]["w"]
    ptr = w.data_ptr()
    rest = [x.clone() for x in interop.tree_leaves(
        {"f": tp["factors"][1:], "b": tp["factors"][0]["b"],
         "e": tp["embedder"]})]
    with torch.no_grad():
        out = tm.apply_prox_(tp, lam=0.1, lr=0.5)
    assert out is tp and tp["factors"][0]["w"] is w
    assert w.data_ptr() == ptr
    assert torch.equal(w, want["factors"][0]["w"])
    after = interop.tree_leaves({"f": tp["factors"][1:],
                                 "b": tp["factors"][0]["b"],
                                 "e": tp["embedder"]})
    for a, b in zip(after, rest):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gl_prox_inplace_misaligned_and_chunked_on_card():
    """On the card: gl_prox_ with the output aliasing the input, on the
    TMA path, on a block offset by one float (scalar loads), and on slabs
    walked in chunks, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for shape in ((5, 10, 25, 10, 4), (3, 7, 5, 7, 3), (2, 3, 200, 10, 8),
                  (2, 1, 3001, 1, 5)):
        W = torch.from_numpy(_w(shape, scale=0.05)).to(dev)
        flat = torch.empty(W.numel() + 1, device=dev)
        for Wi in (W.clone(), flat[1:].view(shape).copy_(W)):
            want = PX.gl_prox_reference(Wi, 0.013, 0.002)
            ptr = Wi.data_ptr()
            before = PX.gl_prox.launches
            assert PX.gl_prox_(Wi, 0.013, 0.002) is Wi
            assert Wi.data_ptr() == ptr
            assert PX.gl_prox.launches == before + 1
            torch.testing.assert_close(Wi, want, **TOL)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gl_prox_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card: the slice's
    shape, the off-tile shapes, an all-zero and an at-threshold group;
    non-float32, non-contiguous and rank < 3 CUDA inputs raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for shape in SHAPES:
        for lam, lr in STEPS:
            W = torch.from_numpy(_w(shape, scale=0.05)).to(dev)
            before = PX.gl_prox.launches
            got = PX.gl_prox(W, lam, lr)
            torch.testing.assert_close(got, PX.gl_prox_reference(W, lam, lr),
                                       **TOL)
            assert PX.gl_prox.launches == before + 1
    W = torch.from_numpy(_w((2, 3, 5, 3, 4), seed=9)).to(dev)
    W[0, 0, :, 1, :] = 0.0
    t = tprox.threshold(1.0, 0.25)
    W[1, 2, :, 0, :] *= t / torch.sqrt(torch.sum(W[1, 2, :, 0, :] ** 2))
    got = PX.gl_prox(W, 1.0, 0.25)
    torch.testing.assert_close(got, PX.gl_prox_reference(W, 1.0, 0.25), **TOL)
    assert float(got[0, 0, :, 1, :].abs().max()) == 0.0
    with pytest.raises(TypeError):
        PX.gl_prox(W.double(), 1.0, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        PX.gl_prox(W.transpose(-1, -3), 1.0, 0.25)
    with pytest.raises(ValueError, match="block"):
        PX.gl_prox(W[0, 0, 0], 1.0, 0.25)


# ------------------------------------------------------------ the lane form
LANE_LRS = np.asarray([5e-4, 2e-3, 2e-4, 0.05], np.float32)


def test_lane_thresholds_are_the_float32_product():
    """Each lane's threshold is the float32 product of its float32 lr and
    lam, computed on the lr's device (the JAX grid's ``lr * lam`` under
    vmap), exactly."""
    for lam in (4.0, 0.013, 50.0, 0.1):
        got = PX.lane_thresholds(torch.from_numpy(LANE_LRS), lam).numpy()
        want = np.asarray(jax.vmap(lambda lr: lr * lam)(
            jnp.asarray(LANE_LRS)))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, LANE_LRS * np.float32(lam))


@pytest.mark.parametrize("lam", [4.0, 0.013, 50.0])
@pytest.mark.parametrize("shape", [(5, 10, 25, 10, 4), (3, 7, 5, 7, 3)])
def test_gl_prox_lanes_plain_matches_jax_vmap_of_pallas(shape, lam):
    """The plain lane version and ``gl_prox_lanes_`` on a CPU tensor (all
    lanes gated on) against the JAX kernel batched as the grid batches it:
    ``jax.vmap`` over the lanes with a per-lane lr, interpret mode."""
    W = np.stack([_w(shape, seed=20 + g, scale=0.05)
                  for g in range(len(LANE_LRS))])
    want = np.asarray(jax.vmap(
        lambda w, lr: gl_prox_pallas(w, lam, lr, block_rows=7,
                                     interpret=True))(
        jnp.asarray(W), jnp.asarray(LANE_LRS)))
    t = PX.lane_thresholds(torch.from_numpy(LANE_LRS), lam)
    gate = torch.ones(len(LANE_LRS), dtype=torch.bool)
    Wt = torch.from_numpy(W.copy())
    before = PX.gl_prox.launches
    _close(PX.gl_prox_lanes_reference(Wt, t, gate), want)
    ptr = Wt.data_ptr()
    assert PX.gl_prox_lanes_(Wt, t, gate) is Wt and Wt.data_ptr() == ptr
    _close(Wt, want)
    assert PX.gl_prox.launches == before


def test_gl_prox_lanes_gate_and_zero_groups():
    """A gated-off lane is left exactly as it was, zero groups included;
    a gated-on lane's zero group stays zero (no 0/0); the per-lane result
    equals the per-point prox at that lane's float32 threshold."""
    shape = (2, 3, 5, 3, 4)
    W = np.stack([_w(shape, seed=30 + g) for g in range(4)])
    W[1, 0, 0, :, 1, :] = 0.0
    W[2, 1, 2, :, 0, :] = 0.0
    lr = np.asarray([0.25, 0.1, 0.05, 0.2], np.float32)
    t = PX.lane_thresholds(torch.from_numpy(lr), 1.0)
    gate = torch.tensor([True, True, False, False])
    Wt = torch.from_numpy(W.copy())
    PX.gl_prox_lanes_(Wt, t, gate)
    assert torch.isfinite(Wt).all()
    for g in (2, 3):
        assert torch.equal(Wt[g], torch.from_numpy(W[g]))
    assert float(Wt[1, 0, 0, :, 1, :].abs().max()) == 0.0
    for g in (0, 1):
        want = gl_prox_pallas(jnp.asarray(W[g]), 1.0, jnp.float32(lr[g]),
                              interpret=True)
        _close(Wt[g], want)


@pytest.mark.parametrize("penalty", ["GSGL", "H"])
def test_prox_lanes_other_penalties_match_jax_vmap(penalty):
    """GSGL and H stay plain over lanes too, at the same float32
    thresholds as the JAX grid's vmapped prox."""
    W = np.stack([_w((3, 4, 6, 4, 3), seed=40 + g, scale=0.3)
                  for g in range(len(LANE_LRS))])
    lam = 2.0
    want = jax.vmap(lambda w, lr: jprox.prox_update(w, lam, lr, penalty))(
        jnp.asarray(W), jnp.asarray(LANE_LRS))
    Wt = torch.from_numpy(W.copy())
    PX.gl_prox_lanes_(Wt, PX.lane_thresholds(torch.from_numpy(LANE_LRS),
                                             lam),
                      torch.ones(len(LANE_LRS), dtype=torch.bool), penalty)
    _close(Wt, want)


def test_apply_prox_lanes_changes_only_the_first_layer():
    """The model's lane prox rewrites the stacked first-layer block in its
    own storage, lane by lane as the per-point apply_prox_, and touches no
    other leaf."""
    _, _, tm, tp = _model()
    G = 3
    stacked = interop.tree_map(lambda x: torch.stack([x * (1 + 0.1 * g)
                                                      for g in range(G)]),
                               tp)
    lr = torch.tensor([0.5, 0.2, 0.1])
    t = PX.lane_thresholds(lr, 0.1)
    gate = torch.tensor([True, False, True])
    w = stacked["factors"][0]["w"]
    ptr = w.data_ptr()
    w0 = w.clone()
    others = [x for x in interop.tree_leaves(stacked) if x is not w]
    before = [x.clone() for x in others]
    with torch.no_grad():
        out = tm.apply_prox_lanes_(stacked, t, gate)
    assert out is stacked and w.data_ptr() == ptr
    for g in range(G):
        want = w0[g] if not gate[g] else PX.prox_update_at(w0[g],
                                                           float(t[g]))
        assert torch.equal(w[g], want)
    for a, b in zip(others, before):
        assert torch.equal(a, b)


def test_lane_launch_refuses_what_the_kernel_does_not_take(monkeypatch):
    def no_build():
        raise AssertionError("CPU tensors must not build the kernel")

    monkeypatch.setattr(PX, "load_kernel", no_build)
    W = torch.from_numpy(_w((2, 2, 3, 4, 3, 2)))
    t = torch.ones(2)
    gate = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        PX._launch_lanes(W, t, gate)


@pytest.mark.gpu
def test_gl_prox_lanes_kernel_matches_plain_on_card():
    """On the card: the lane kernel in place at the grid's block with mixed
    gates (lanes off, a lane with a zero group), a block offset by one
    float, and slabs walked in chunks, against the plain lane version; one
    launch per call; thresholds and gate of the wrong kind raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    G = 27
    gen = torch.Generator().manual_seed(0)
    lr = torch.tensor([2e-4, 5e-4, 2e-3] * 9, device=dev)
    gate = (torch.rand(G, generator=gen) < 0.7).to(dev)
    gate[5] = True
    for shape in ((5, 10, 25, 10, 4), (3, 7, 5, 7, 3), (2, 3, 200, 10, 8)):
        for lam in (4.0, 50.0):
            t = PX.lane_thresholds(lr, lam)
            W = (0.05 * torch.randn((G,) + shape, generator=gen)).to(dev)
            W[5, 0, 0, :, 1, :] = 0.0
            flat = torch.empty(W.numel() + 1, device=dev)
            for Wi in (W.clone(), flat[1:].view(W.shape).copy_(W)):
                want = PX.gl_prox_lanes_reference(Wi, t, gate)
                before = PX.gl_prox.launches
                ptr = Wi.data_ptr()
                assert PX.gl_prox_lanes_(Wi, t, gate) is Wi
                assert Wi.data_ptr() == ptr
                assert PX.gl_prox.launches == before + 1
                torch.testing.assert_close(Wi, want, **TOL)
                assert float(Wi[5, 0, 0, :, 1, :].abs().max()) == 0.0
                off = ~gate.cpu()
                assert torch.equal(Wi[off.to(dev)], W[off.to(dev)])
    with pytest.raises(ValueError, match="bool gate"):
        PX.gl_prox_lanes_(W, t, gate.float())
    with pytest.raises(ValueError, match="bool gate"):
        PX.gl_prox_lanes_(W, t.cpu(), gate)
    torch.cuda.synchronize()
