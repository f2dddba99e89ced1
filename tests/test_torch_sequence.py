"""The port's ring-attention sequence parallelism
(redcliff_tpu_torch/parallel/sequence.py and ``seq_mesh`` in
models/ts_transformer.py) against the JAX package's on the CPU.

The JAX side runs on its virtual 8-device CPU mesh, the port on
``["cpu"] * n``. Ring attention is held to JAX's ring attention and to
dense attention, causal and not, at JAX's own bar (rtol 2e-5, atol 2e-6;
tests/test_sequence_parallel.py:35-104); the encoder with LayerNorm and
BatchNorm to JAX's ``seq_mesh`` encoder and the port's dense one at rtol
5e-5, atol 5e-6.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from redcliff_tpu.models import ts_transformer as JT  # noqa: E402
from redcliff_tpu.parallel import sequence as jseq  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.models import ts_transformer as TT  # noqa: E402
from redcliff_tpu_torch.parallel import sequence as tseq  # noqa: E402

RING = dict(rtol=2e-5, atol=2e-6)
ENCODER = dict(rtol=5e-5, atol=5e-6)


def _mesh(n):
    return tseq.seq_mesh(devices=["cpu"] * n)


def _dense(q, k, v, causal=False):
    T, D = q.shape[1], q.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    if causal:
        keep = torch.tril(torch.ones((T, T), dtype=torch.bool))
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    B, T, H, D = 2, 64, 4, 8
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax_and_dense(qkv, causal):
    q, k, v = (torch.from_numpy(a) for a in qkv)
    got = tseq.ring_attention(q, k, v, _mesh(8), causal=causal)
    want = jseq.ring_attention(*(jnp.asarray(a) for a in qkv),
                               jseq.seq_mesh(8), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING)
    np.testing.assert_allclose(got.numpy(),
                               _dense(q, k, v, causal).numpy(), **RING)
    # block form: one output block per mesh entry
    blocks = tseq.ring_attention(tseq.sequence_sharded(q, _mesh(8)),
                                 tseq.sequence_sharded(k, _mesh(8)),
                                 tseq.sequence_sharded(v, _mesh(8)),
                                 _mesh(8), causal=causal)
    assert len(blocks) == 8 and blocks[0].shape == (2, 8, 4, 8)
    np.testing.assert_array_equal(torch.cat(blocks, 1).numpy(), got.numpy())


def test_ring_attention_mesh_subset(qkv):
    q, k, v = (torch.from_numpy(a) for a in qkv)
    got = tseq.ring_attention(q, k, v, _mesh(4))
    want = jseq.ring_attention(*(jnp.asarray(a) for a in qkv),
                               jseq.seq_mesh(4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING)
    np.testing.assert_allclose(got.numpy(), _dense(q, k, v).numpy(), **RING)


def test_ring_attention_rejects_indivisible_T(qkv):
    q, k, v = (torch.from_numpy(a[:, :60]) for a in qkv)
    with pytest.raises(AssertionError, match="not divisible"):
        tseq.ring_attention(q, k, v, _mesh(8))
    with pytest.raises(AssertionError, match="not divisible"):
        tseq.sequence_sharded(q, _mesh(8))


@pytest.mark.parametrize("norm", ["LayerNorm", "BatchNorm"])
def test_sequence_parallel_encoder_matches_jax(norm):
    """The encoder under ``seq_mesh`` (ring attention, time-local layers
    per block, the BatchNorm's batch x time statistics summed over the
    blocks) against JAX's ``seq_mesh`` encoder and the port's dense one,
    from the JAX init."""
    kw = dict(feat_dim=3, max_len=64, d_model=16, n_heads=4, num_layers=2,
              dim_feedforward=32, norm=norm)
    jenc = JT.TSTransformerEncoder(JT.TSTransformerConfig(**kw))
    tenc = TT.TSTransformerEncoder(TT.TSTransformerConfig(**kw))
    jp = jenc.init(jax.random.PRNGKey(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    X = np.random.default_rng(1).normal(size=(2, 64, 3)).astype(np.float32)
    want = np.asarray(jenc.forward(jp, jnp.asarray(X),
                                   seq_mesh=jseq.seq_mesh(8)))
    got = tenc.forward(tp, torch.from_numpy(X), seq_mesh=_mesh(8))
    np.testing.assert_allclose(got.numpy(), want, **ENCODER)
    dense = tenc.forward(tp, torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **ENCODER)
    with pytest.raises(AssertionError, match="padding_masks"):
        tenc.forward(tp, torch.from_numpy(X),
                     padding_masks=torch.ones(2, 64), seq_mesh=_mesh(8))
