"""The bf16 form of the port's factor mix (redcliff_tpu_torch/ops/
factor_mix.py) on the CPU: f32 operands, which the kernel rounds to bf16
in registers, give the bits that casting them to bf16 first gives; the
plain versions against the JAX package's Pallas kernel in interpret mode
on bf16-rounded operands; the rounding itself against JAX's
``astype(jnp.bfloat16)`` on crafted values; the launch plans, the refused
operand pairs and the autotune keys of each input form.

On the CPU the wrappers take the plain versions; the kernel is held
against them, and against the cast-then-bf16-kernel path, on the card
(tests/test_torch_mixed.py's ``gpu`` test and chip_smoke.py). Inputs are
made with numpy from a seed and handed to both frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from redcliff_tpu.ops.factor_mix import factor_mix_pallas  # noqa: E402
from redcliff_tpu.ops.factor_mix import graph_mix as jax_graph_mix  # noqa: E402
from redcliff_tpu_torch.ops import autotune  # noqa: E402
from redcliff_tpu_torch.ops import factor_mix as FM  # noqa: E402
from redcliff_tpu_torch.utils import precision as P  # noqa: E402

# f32 sums of the same bf16-exact products in another order over K: the
# ROADMAP bar (tests/test_precision_kernels.py:129)
RTOL, ATOL = 1e-5, 1e-6
BF16 = "bfloat16"

# f32 bit patterns that pin the rounding: ties to even down and up (both
# signs) and just off a tie; subnormals that vanish, stay exact, or tie
# down and up; the largest finite bf16, the next f32 above it, the last
# f32 that rounds down to it, the tie that goes to inf, the f32 maximum;
# +-inf, NaNs, +-0
CRAFTED_BITS = (
    0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000, 0x3F808001, 0x3F807FFF,
    0x00000001, 0x80000001, 0x00010000, 0x00018000, 0x00028000, 0x00400000,
    0x807FFFFF,
    0x7F7F0000, 0x7F7F0001, 0x7F7F7FFF, 0x7F7F8000, 0x7F7FFFFF, 0xFF7F0000,
    0xFF7F8000,
    0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001, 0x7F800001, 0x00000000,
    0x80000000)


def _crafted():
    return np.array(CRAFTED_BITS, dtype=np.uint32).view(np.float32)


def _inputs(seed, lead, B, K, T, C):
    rng = np.random.default_rng(seed)
    return (rng.random(lead + (B, K)).astype(np.float32),
            rng.normal(size=lead + (K, B, T, C)).astype(np.float32))


def _jax_round(x):
    return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)


def test_f32_operands_give_the_bits_of_precast_operands():
    """Each form on the f32 operands its caller holds equals, bit for bit,
    the same call on operands cast to bf16 first (the former path): the
    per-point form, the lanes, ``vmap(factor_mix)`` under the bf16 context
    and the serve blend with f32 weightings; no launch is counted."""
    before = FM.graph_mix_bf16.launches
    w, p = (torch.from_numpy(a) for a in _inputs(0, (3,), 17, 5, 1, 10))
    wb, pb = w.bfloat16(), p.bfloat16()
    lanes = FM.factor_mix_lanes_bf16(w, p)
    assert lanes.dtype == torch.float32
    assert torch.equal(lanes, FM.factor_mix_lanes_bf16(wb, pb))
    for g in range(3):
        assert torch.equal(FM.factor_mix_bf16(w[g], p[g]),
                           FM.factor_mix_bf16(wb[g], pb[g]))
        assert torch.equal(FM.factor_mix_bf16(w[g], p[g]), lanes[g])
    with P.matmul_precision_ctx(BF16):
        assert torch.equal(torch.func.vmap(FM.factor_mix)(w, p), lanes)
    rng = np.random.default_rng(1)
    scores = torch.from_numpy(rng.random((64, 5)).astype(np.float32))
    gb = torch.from_numpy(rng.normal(size=(5, 10, 10)).astype(
        np.float32)).bfloat16()
    blend = FM.graph_mix(scores, gb)
    assert blend.dtype == torch.float32 and blend.shape == (64, 10, 10)
    assert torch.equal(blend, FM.graph_mix(scores.bfloat16(), gb))
    assert torch.equal(FM.graph_mix_bf16(scores, gb), blend)
    assert FM.graph_mix_bf16.launches == before


@pytest.mark.parametrize("form", ("point", "lanes", "serve"))
def test_plain_versions_match_jax_pallas_on_rounded_operands(form):
    """The plain bf16 versions equal JAX's Pallas factor mix (interpret
    mode, as the JAX tests run it; ``jax.vmap`` for the lanes, JAX's
    ``graph_mix`` for the blend) on operands rounded with
    ``astype(jnp.bfloat16)``."""
    if form == "serve":
        rng = np.random.default_rng(2)
        w = rng.random((8, 5)).astype(np.float32)
        g = rng.normal(size=(5, 4, 4)).astype(np.float32)
        want = jax_graph_mix(_jax_round(w), _jax_round(g), interpret=True)
        got = FM.graph_mix_bf16_reference(torch.from_numpy(w),
                                          torch.from_numpy(g).bfloat16())
    else:
        lead = (3,) if form == "lanes" else ()
        w, p = _inputs(3, lead, 12, 4, 2, 3)

        def mix(a, b):
            return factor_mix_pallas(a, b, block_b=8, interpret=True)

        want = (jax.vmap(mix) if lead else mix)(_jax_round(w), _jax_round(p))
        ref = (FM.factor_mix_lanes_bf16_reference if lead
               else FM.factor_mix_bf16_reference)
        got = ref(torch.from_numpy(w), torch.from_numpy(p))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_bf16_round_matches_jax_astype_on_crafted_values():
    """``bf16_round`` (what the plain versions apply, and what the kernel's
    ``__float2bfloat16_rn`` must reproduce) equals JAX's
    ``astype(jnp.bfloat16)`` bit for bit on every crafted value but NaN:
    round to nearest even, subnormals kept, past the bf16 maximum to
    +-inf. A NaN stays NaN; its bits are each library's own (PyTorch's CPU
    cast gives 0xffff, XLA keeps the sign), and a NaN operand makes the
    kernel's f32 sum the card's one canonical NaN either way."""
    x = _crafted()
    got = P.bf16_round(torch.from_numpy(x.copy())).numpy()
    want = np.asarray(_jax_round(x))
    nan = np.isnan(x)
    assert nan.sum() == 3
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(np.isnan(want), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))
    # what the set pins: the tie at the bf16 maximum goes to inf, the one
    # below it does not; a subnormal tie rounds to even
    bits = dict(zip(CRAFTED_BITS, got.view(np.uint32).tolist()))
    assert bits[0x7F7F8000] == 0x7F800000 and bits[0x7F7F7FFF] == 0x7F7F0000
    assert bits[0x00018000] == bits[0x00028000] == 0x00020000
    assert bits[0x3F808000] == 0x3F800000 and bits[0x3F818000] == 0x3F820000


def test_plans_follow_the_storage_of_p():
    """The rounding entry plans loads by p's storage: an f32 p at the
    training shape (M = 10) takes float2, at M = 100 float4 when 16-byte
    aligned; the serve blend's bf16 p (rows of 200 bytes) takes 8-byte
    loads of four bf16. Each input form plans under its own key."""
    def vec(*args, **kw):
        return FM._mix_args(*args, **kw)[0].vec

    FM._mix_args.cache_clear()
    assert vec(128, 5, 10, 1280, 10, 0, 0, form="round") == 2
    assert vec(128, 5, 10, 1280, 10, 0, 0, 32, 640, 6400,
               form="round") == 2
    assert vec(128, 5, 10, 1280, 10, 4, 0, form="round") == 1
    assert vec(64, 5, 100, 100, 0, 0, 0, form="round") == 4
    assert vec(64, 5, 100, 100, 0, 8, 0, form="round") == 2
    assert vec(64, 5, 100, 100, 0, 8, 0, form="round_w") == 4
    assert vec(64, 5, 100, 100, 0, 8, 0, form="bf16") == 4
    assert vec(64, 5, 100, 100, 0, 4, 0, form="round_w") == 2
    args = FM._mix_args(64, 5, 100, 100, 0, 8, 0, form="round_w")[0]
    assert (args.threads, args.blocks) == (128, 13)
    # the C struct's fields, in order: MixArgs of csrc/factor_mix.cu
    assert [f for f, _ in FM._MixArgs._fields_] == [
        "B", "K", "M", "vec", "threads", "blocks", "device", "stride_k",
        "stride_b", "G", "stride_wg", "stride_pg"]


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it is on a CUDA device, so the wrappers'
    type check (which runs only for CUDA operands) can be reached here."""

    @property
    def is_cuda(self):
        return True


def _on_cuda(x):
    return torch.Tensor._make_subclass(_OnCuda, x)


def test_forms_by_operand_types_and_refused_pairs(monkeypatch):
    """Each type pair a caller holds picks its entry (f32 w and p: both
    rounded; f32 w with bf16 p: w rounded; bf16 w and p: widened); a pair
    no caller uses raises ``TypeError`` before any build or launch."""
    def no_build():
        raise AssertionError("a refused pair must not build the kernel")

    monkeypatch.setattr(FM, "load_kernel", no_build)
    f32 = torch.zeros((4, 2))
    b16 = f32.bfloat16()
    assert FM._bf16_form(f32, f32).entry == "redcliff_factor_mix_bf16_round"
    assert FM._bf16_form(f32, b16).entry == \
        "redcliff_factor_mix_bf16_round_w"
    assert FM._bf16_form(b16, b16).entry == "redcliff_factor_mix_bf16"
    w, g = torch.rand((4, 2)), torch.rand((2, 3, 3))
    p = torch.rand((2, 4, 1, 3))
    refused = (
        lambda: FM.graph_mix_bf16(_on_cuda(w.bfloat16()), _on_cuda(g)),
        lambda: FM.graph_mix(_on_cuda(w.bfloat16()), _on_cuda(g)),
        lambda: FM.factor_mix_bf16(_on_cuda(w.bfloat16()), _on_cuda(p)),
        lambda: FM.factor_mix_bf16(_on_cuda(w.double()),
                                   _on_cuda(p.double())),
        lambda: FM.factor_mix_lanes_bf16(_on_cuda(w[None].half()),
                                         _on_cuda(p[None].half())))
    for call in refused:
        with pytest.raises(TypeError, match="bfloat16"):
            call()


def test_autotune_keys_keep_forms_and_lanes_apart():
    """Every input form has its own key, and the lane form's key differs
    from the single form's (the bf16 key once ignored G)."""
    keys = {(bf16, G): autotune.mix_key(128, 5, 10, G, bf16=bf16)
            for bf16 in (False, True, "round", "round_w") for G in (1, 32)}
    assert len({k[0] for k in keys.values()}) == len(keys)
    assert keys[(True, 1)] == ("factor_mix_bf16", "k5m10", 128)
    assert keys[(True, 32)] == ("factor_mix_lanes_bf16", "k5m10b128", 32)
    assert keys[("round", 32)] == ("factor_mix_lanes_bf16_round",
                                   "k5m10b128", 32)
    assert keys[(False, 32)] == autotune.mix_key(128, 5, 10, G=32)
