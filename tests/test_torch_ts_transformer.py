"""The port's time-series transformer (redcliff_tpu_torch/models/
ts_transformer.py) against the JAX package's, at a small width: 3 features,
windows of 6 steps padded to max_len 8, d_model 8 over 2 heads, 2 layers,
feed-forward 16, batch 4.

Weights come from the JAX init, carried across unchanged by ``interop``.
Over {LayerNorm, BatchNorm} × {fixed, learnable positions} × {no mask,
mask}: the encoder's embeddings and reconstruction, the classiregressor's
logits, both heads' losses, and every gradient, at the f32 bars
(rtol 1e-5, atol 1e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from redcliff_tpu.models import ts_transformer as J  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.models import ts_transformer as T  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
B, STEPS, FEAT, MAX_LEN = 4, 6, 3, 8
SMALL = dict(feat_dim=FEAT, max_len=MAX_LEN, d_model=8, n_heads=2,
             num_layers=2, dim_feedforward=16)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def _close_trees(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, STEPS, FEAT)).astype(np.float32)
    labels = rng.integers(0, 2, B)
    mask = np.ones((B, STEPS), dtype=bool)
    mask[1, 4:] = False
    mask[3, 2:] = False
    return X, labels, mask


def _pair(cls, seed=0, **cfg):
    """(JAX model, port model, JAX params as numpy, port params)."""
    jm = getattr(J, cls)(J.TSTransformerConfig(**SMALL, **cfg))
    tm = getattr(T, cls)(T.TSTransformerConfig(**SMALL, **cfg))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, tm, jp, interop.params_from_jax(jp, "cpu")


CASES = [(norm, pos, masked) for norm in ("LayerNorm", "BatchNorm")
         for pos in ("fixed", "learnable") for masked in (False, True)]


@pytest.mark.parametrize("norm,pos,masked", CASES)
def test_encoder_forward_loss_and_grads_match_jax(norm, pos, masked):
    X, _, mask = _data()
    jm, tm, jp, tp = _pair("TSTransformerEncoder", norm=norm,
                           pos_encoding=pos)
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    Xt = torch.from_numpy(X)
    np.testing.assert_allclose(
        T.ts_transformer_encode(tp, tm.config, Xt, tmask).numpy(),
        np.asarray(J.ts_transformer_encode(jp, jm.config, jnp.asarray(X),
                                           jmask)), **TOL)
    np.testing.assert_allclose(
        tm.forward(tp, Xt, tmask).numpy(),
        np.asarray(jm.forward(jp, jnp.asarray(X), jmask)), **TOL)

    (jloss, jaux), jgrad = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(X), padding_masks=jmask),
        has_aux=True)(jp)
    leaves = interop.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, taux = tm.loss(tp, Xt, padding_masks=tmask)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    assert sorted(taux) == sorted(jaux) == ["recon_loss"]
    by_id = {id(t): g for t, g in zip(leaves, grads)}
    _close_trees(interop.tree_map(lambda t: by_id[id(t)], tp), jgrad, **TOL)


@pytest.mark.parametrize("norm,pos,masked", CASES)
def test_classiregressor_forward_loss_and_grads_match_jax(norm, pos, masked):
    X, labels, mask = _data(1)
    jm, tm, jp, tp = _pair("TSTransformerEncoderClassiregressor", seed=1,
                           norm=norm, pos_encoding=pos, num_classes=2)
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    Xt = torch.from_numpy(X)
    np.testing.assert_allclose(
        tm.forward(tp, Xt, tmask).numpy(),
        np.asarray(jm.forward(jp, jnp.asarray(X), jmask)), **TOL)
    leaves = interop.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    # integer labels, then the same labels one-hot
    for jy, ty in ((jnp.asarray(labels), torch.from_numpy(labels)),
                   (jnp.eye(2)[labels], torch.eye(2)[labels])):
        (jloss, jaux), jgrad = jax.value_and_grad(
            lambda p: jm.loss(p, jnp.asarray(X), jy, padding_masks=jmask),
            has_aux=True)(jp)
        tloss, taux = tm.loss(tp, Xt, ty, padding_masks=tmask)
        grads = torch.autograd.grad(tloss, leaves)
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
        assert sorted(taux) == sorted(jaux) == ["class_loss"]
        by_id = {id(t): g for t, g in zip(leaves, grads)}
        _close_trees(interop.tree_map(lambda t: by_id[id(t)], tp), jgrad,
                     **TOL)


def test_relu_and_full_length_windows_match_jax():
    """relu in place of gelu, and windows at max_len (no head padding)."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(B, MAX_LEN, FEAT)).astype(np.float32)
    jm, tm, jp, tp = _pair("TSTransformerEncoderClassiregressor",
                           activation="relu", num_classes=3)
    np.testing.assert_allclose(
        tm.forward(tp, torch.from_numpy(X)).numpy(),
        np.asarray(jm.forward(jp, jnp.asarray(X))), **TOL)


@pytest.mark.parametrize("norm", ["LayerNorm", "BatchNorm"])
def test_adam_steps_match_optax(norm):
    """20 Adam steps of the classifier loss from the same params (the JAX
    test's rising/falling ramps): torch.optim.Adam in the port against
    optax.adam in JAX, the loss histories at the trainer bars."""
    import optax

    rng = np.random.default_rng(7)
    y = rng.integers(0, 2, size=16)
    ramp = np.linspace(-1, 1, MAX_LEN)
    X = (np.stack([np.stack([(1 - 2 * yi) * ramp] * FEAT, axis=1)
                   for yi in y]) + 0.1 * rng.normal(size=(16, MAX_LEN, FEAT))
         ).astype(np.float32)
    jm, tm, jp, tp = _pair("TSTransformerEncoderClassiregressor", seed=3,
                           norm=norm, num_classes=2)
    tx = optax.adam(1e-3)
    state = tx.init(jp)
    grad = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(X), jnp.asarray(y))[0]))
    jhist = []
    for _ in range(20):
        loss, g = grad(jp)
        updates, state = tx.update(g, state)
        jp = optax.apply_updates(jp, updates)
        jhist.append(float(loss))
    leaves = interop.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-3)
    thist = []
    for _ in range(20):
        loss, _ = tm.loss(tp, torch.from_numpy(X), torch.from_numpy(y))
        opt.zero_grad()
        loss.backward()
        opt.step()
        thist.append(loss.item())
    np.testing.assert_allclose(thist, jhist, rtol=1e-4, atol=1e-5)
    assert thist[-1] < thist[0]


def test_init_and_errors():
    """The port's init has the JAX init's keys, shapes and distributions'
    bounds; the sequence-parallel mode and a missing card raise."""
    for cls, extra in (("TSTransformerEncoder", {}),
                       ("TSTransformerEncoderClassiregressor",
                        {"num_classes": 2})):
        jm, tm, jp, _ = _pair(cls, pos_encoding="learnable", **extra)
        tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
        got, want = _flat(tp), _flat(jp)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == np.float32, k
            # uniform weights and biases within 1/sqrt(fan-in), as in JAX
            if k.endswith(("/w", "/wq", "/wk", "/wv", "/wo")):
                bound = 1.0 / np.sqrt(want[k].shape[0])
                assert np.abs(got[k]).max() <= bound, k
                if k.endswith("/w"):
                    assert np.abs(got[k[:-1] + "b"]).max() <= bound, k
    X = torch.zeros((B, STEPS, FEAT))
    enc = T.TSTransformerEncoder(T.TSTransformerConfig(**SMALL))
    params = enc.init(torch.Generator().manual_seed(0), device="cpu")
    # seq_mesh is ported (tests/test_torch_sequence.py): ring attention
    # over time blocks reproduces the dense encoder
    from redcliff_tpu_torch.parallel.sequence import seq_mesh

    Xr = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, STEPS, FEAT)).astype(np.float32))
    n = next(d for d in (4, 2, 1) if STEPS % d == 0)
    np.testing.assert_allclose(
        enc.forward(params, Xr, seq_mesh=seq_mesh(devices=["cpu"] * n)),
        enc.forward(params, Xr), rtol=5e-5, atol=5e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            enc.init(torch.Generator())


@pytest.mark.gpu
def test_forward_and_steps_on_card_match_cpu():
    """On the card (TF32 off): both heads' forwards and 5 Adam steps of the
    classifier loss, from the same params, against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from redcliff_tpu_torch.utils.precision import resolve_device

    resolve_device("cuda")
    X, labels, mask = _data(3)
    for norm in ("BatchNorm", "LayerNorm"):
        m = T.TSTransformerEncoderClassiregressor(T.TSTransformerConfig(
            **SMALL, norm=norm, num_classes=2))
        cpu = m.init(torch.Generator().manual_seed(0), device="cpu")
        card = interop.tree_map(lambda t: t.cuda(), cpu)
        for mk in (None, torch.from_numpy(mask)):
            np.testing.assert_allclose(
                m.forward(card, torch.from_numpy(X).cuda(),
                          None if mk is None else mk.cuda()).cpu().numpy(),
                m.forward(cpu, torch.from_numpy(X), mk).numpy(), **TOL)
        hist = {}
        for name, p, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
            leaves = interop.tree_leaves(p)
            for leaf in leaves:
                leaf.requires_grad_(True)
            opt = torch.optim.Adam(leaves, lr=1e-3)
            hist[name] = []
            for _ in range(5):
                loss, _ = m.loss(p, torch.from_numpy(X).to(dev),
                                 torch.from_numpy(labels).to(dev))
                opt.zero_grad()
                loss.backward()
                opt.step()
                hist[name].append(loss.item())
        np.testing.assert_allclose(hist["card"], hist["cpu"], rtol=1e-4,
                                   atol=1e-5)
