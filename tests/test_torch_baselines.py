"""The port's baseline model families (redcliff_tpu_torch/models/{clstm,
cmlp_fm,clstm_fm,navar,dgcnn}.py) and REDCLIFF-S with cLSTM factors
(models/redcliff.py) against the JAX package on the same weights.

Every weight is made by the JAX package's ``init`` and carried across with
``interop.params_from_jax``; every input is made with numpy from a seed, at
tiny widths.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from redcliff_tpu.models import clstm as jclstm  # noqa: E402
from redcliff_tpu.models import clstm_fm as jclstm_fm  # noqa: E402
from redcliff_tpu.models import cmlp_fm as jcmlp_fm  # noqa: E402
from redcliff_tpu.models import dgcnn as jdgcnn  # noqa: E402
from redcliff_tpu.models import navar as jnavar  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.models import clstm as tclstm  # noqa: E402
from redcliff_tpu_torch.models import clstm_fm as tclstm_fm  # noqa: E402
from redcliff_tpu_torch.models import cmlp_fm as tcmlp_fm  # noqa: E402
from redcliff_tpu_torch.models import dgcnn as tdgcnn  # noqa: E402
from redcliff_tpu_torch.models import navar as tnavar  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402

# forward, loss, grads and GC: f32 in both frameworks, another summation
# order — the ROADMAP bar; anything after a DGCNN embed at atol 1e-5
TOL = dict(rtol=1e-5, atol=1e-6)
TOL_DGCNN = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree (JAX sorts dict keys, the
    port keeps them as built, so trees are compared by path)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol)


def _close_trees(got, want, tol=TOL):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        _close(g[k], w[k], tol)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _labels(seed, n, k, t=1):
    y = np.eye(k, dtype=np.float32)[np.random.default_rng(seed).integers(
        0, k, n)]
    return np.repeat(y[:, :, None], t, axis=2)


def _grads(model, params, *args, **kw):
    """(loss, parts, grad tree) of the port model's loss."""
    live = interop.tree_map(lambda x: x.clone().requires_grad_(True),
                            params)
    loss, parts = model.loss(live, *args, **kw)
    leaves = interop.tree_leaves(live)
    g = torch.autograd.grad(loss, leaves)
    it = iter(g)
    return loss, parts, interop.tree_map(lambda _: next(it), live)


# ------------------------------------------------------------------- cLSTM
@pytest.mark.parametrize("lead", [(), (3,)])
def test_clstm_forward_gc_and_prox_match_jax(lead):
    """One cLSTM block, and K stacked ones on a shared and on a per-factor
    input (the JAX package vmaps; the port broadcasts leading axes)."""
    C, H = 4, 5
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    if lead:
        jp = jax.vmap(lambda k: jclstm.init_clstm_params(k, C, H))(keys)
    else:
        jp = jclstm.init_clstm_params(keys[0], C, H)
    tp = interop.params_from_jax(_np(jp))
    X = _x(1, 2, 6, C)
    if lead:
        jfwd = jax.vmap(lambda p: jclstm.clstm_forward(p, jnp.asarray(X)))
        jpreds, (jh, jc) = jfwd(jp)
    else:
        jpreds, (jh, jc) = jclstm.clstm_forward(jp, jnp.asarray(X))
    tpreds, (th, tc) = tclstm.clstm_forward(tp, torch.from_numpy(X))
    _close(tpreds, jpreds)
    _close(th, jh)
    _close(tc, jc)
    # a continued sequence from the carry
    X2 = _x(2, 2, 3, C)
    if lead:
        want = jax.vmap(lambda p, h, c: jclstm.clstm_forward(
            p, jnp.asarray(X2), (h, c))[0])(jp, jh, jc)
    else:
        want = jclstm.clstm_forward(jp, jnp.asarray(X2), (jh, jc))[0]
    _close(tclstm.clstm_forward(tp, torch.from_numpy(X2), (th, tc))[0], want)
    if lead:
        # a window per factor (the post-weighted rollout's inputs)
        Xk = _x(3, 3, 2, 4, C)
        want = jax.vmap(lambda p, x: jclstm.clstm_forward(p, x)[0])(
            jp, jnp.asarray(Xk))
        _close(tclstm.clstm_forward(tp, torch.from_numpy(Xk))[0], want)
    for threshold in (False, True):
        want = (jax.vmap(lambda p: jclstm.clstm_gc(p, threshold=threshold))(
            jp) if lead else jclstm.clstm_gc(jp, threshold=threshold))
        _close(tclstm.clstm_gc(tp, threshold=threshold), want)
    want = (jax.vmap(lambda p: jclstm.clstm_prox_update(p, 0.4, 0.5))(jp)
            if lead else jclstm.clstm_prox_update(jp, 0.4, 0.5))
    _close_trees(tclstm.clstm_prox_update(tp, 0.4, 0.5), _np(want))


def test_clstm_init_draws_the_jax_distributions():
    """The port's own init: the JAX tree's shapes, bounds U(±1/sqrt(H)) and
    the merged bias a sum of two such draws."""
    C, H = 4, 9
    jp = _np(jclstm.init_clstm_params(jax.random.PRNGKey(0), C, H))
    tp = tclstm.init_clstm_params(torch.Generator().manual_seed(0), C, H)
    fj, ft = _flat(jp), _flat(tp)
    assert {k: v.shape for k, v in fj.items()} == \
        {k: tuple(v.shape) for k, v in ft.items()}
    bound = 1.0 / np.sqrt(H)
    for k, v in ft.items():
        lim = 2 * bound if k == "/b" else bound
        assert float(v.abs().max()) <= lim and v.dtype == torch.float32


# ------------------------------------------------------- generic families
def _families():
    """name -> (JAX model, whether its loss takes labels)."""
    return {
        "cmlp_fm": (jcmlp_fm.CMLPFM(jcmlp_fm.CMLPFMConfig(
            num_chans=4, gen_lag=2, gen_hidden=(6,), input_length=3,
            num_sims=1, forecast_coeff=2.0, adj_l1_coeff=0.1)), False),
        "cmlp_fm_2sims": (jcmlp_fm.CMLPFM(jcmlp_fm.CMLPFMConfig(
            num_chans=4, gen_lag=2, gen_hidden=(6, 3), input_length=3,
            num_sims=2, adj_l1_coeff=0.1)), False),
        "clstm_fm": (jclstm_fm.CLSTMFM(jclstm_fm.CLSTMFMConfig(
            num_chans=4, gen_hidden=5, context=2, max_input_length=5,
            forecast_coeff=1.5, adj_l1_coeff=0.2)), False),
        "navar": (jnavar.NAVAR(jnavar.NAVARConfig(
            num_nodes=4, num_hidden=6, maxlags=3, hidden_layers=2,
            lambda1=0.1)), False),
        "navar_lstm": (jnavar.NAVARLSTM(jnavar.NAVARLSTMConfig(
            num_nodes=4, num_hidden=6, maxlags=3, hidden_layers=2,
            lambda1=0.1)), False),
        "dgcnn": (jdgcnn.DGCNNModel(jdgcnn.DGCNNConfig(
            num_channels=4, num_wavelets_per_chan=1, num_features_per_node=2,
            num_graph_conv_layers=2, num_hidden_nodes=5, num_classes=3)),
            True),
    }


_PORT_CLASSES = {
    "CMLPFM": (tcmlp_fm.CMLPFM, tcmlp_fm.CMLPFMConfig),
    "CLSTMFM": (tclstm_fm.CLSTMFM, tclstm_fm.CLSTMFMConfig),
    "NAVAR": (tnavar.NAVAR, tnavar.NAVARConfig),
    "NAVARLSTM": (tnavar.NAVARLSTM, tnavar.NAVARLSTMConfig),
    "DGCNNModel": (tdgcnn.DGCNNModel, tdgcnn.DGCNNConfig),
}


def _port_model(jm):
    cls, cfg_cls = _PORT_CLASSES[type(jm).__name__]
    return cls(cfg_cls(**dataclasses.asdict(jm.config)))


@pytest.mark.parametrize("family", list(_families()))
def test_baseline_family_matches_jax(family):
    """Forward, loss and its parts, grads of every leaf, GC (lagged and
    not, thresholded), the validation criteria and the normalization
    coefficients; the port's init draws the JAX tree's shapes."""
    jm, labels = _families()[family]
    tm = _port_model(jm)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = interop.params_from_jax(_np(jp))
    X = _x(2, 3, 8, 4)
    Y = _labels(3, 3, 3)
    jargs = (jnp.asarray(X), jnp.asarray(Y)) if labels else (jnp.asarray(X),)
    targs = (torch.from_numpy(X), torch.from_numpy(Y)) if labels \
        else (torch.from_numpy(X),)
    tol = TOL_DGCNN if family == "dgcnn" else TOL
    (jl, jparts), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, *jargs)
    tl, tparts, tg = _grads(tm, tp, *targs)
    _close(tl, jl, tol)
    assert sorted(tparts) == sorted(jparts)
    for k in jparts:
        _close(tparts[k], jparts[k], tol)
    _close_trees(tg, _np(jg), tol)

    if family.startswith("cmlp"):
        _close(tm.forward(tp, torch.from_numpy(X[:, :3])),
               jm.forward(jp, jnp.asarray(X[:, :3])))
    elif family == "clstm_fm":
        Xi, Xt = tclstm_fm.arrange_input(torch.from_numpy(X), 2)
        ji, jt = jclstm_fm.arrange_input(jnp.asarray(X), 2)
        _close(Xi, ji)
        _close(Xt, jt)
        _close(tm.forward(tp, Xi)[0], jm.forward(jp, ji)[0])
    elif family.startswith("navar"):
        Xw = X[:, :3] if family == "navar" else X
        _close(tm.forward(tp, torch.from_numpy(Xw))[1],
               jm.forward(jp, jnp.asarray(Xw))[1])
    else:
        Xn = np.transpose(X[:, :2], (0, 2, 1))
        _close(tm.forward(tp, torch.from_numpy(Xn)),
               jm.forward(jp, jnp.asarray(Xn)), tol)

    gkw, tkw = {}, {}
    if getattr(jm, "gc_requires_data", False):
        gkw, tkw = {"X": jnp.asarray(X)}, {"X": torch.from_numpy(X)}
        with pytest.raises(ValueError, match="require data"):
            tm.gc(tp)
    for ignore_lag in (True, False):
        for threshold in (False, True):
            got = tm.gc(tp, threshold=threshold, ignore_lag=ignore_lag,
                        **tkw)
            want = jm.gc(jp, threshold=threshold, ignore_lag=ignore_lag,
                         **gkw)
            assert len(got) == len(want) == 1
            _close(got[0], want[0])
    if hasattr(jm, "validation_criteria"):
        val = {k: float(v) for k, v in jparts.items()}
        _close(torch.as_tensor(tm.validation_criteria(tp, val)),
               jm.validation_criteria(jp, val))
    assert hasattr(tm, "normalization_coeffs") \
        == hasattr(jm, "normalization_coeffs")
    if hasattr(jm, "normalization_coeffs"):
        assert tm.normalization_coeffs() == jm.normalization_coeffs()
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _flat(fresh).items()} == \
        {k: v.shape for k, v in _flat(_np(jp)).items()}


@pytest.mark.parametrize("penalty", ["GL", "GSGL", "H"])
def test_cmlp_fm_prox_matches_jax(penalty):
    """The GISTA prox on the (C_out, H, C_in, L) block: functional and in
    place (what the trainer's step calls), on the CPU path of the GL
    kernel's wrapper."""
    jm, _ = _families()["cmlp_fm"]
    tm = _port_model(jm)
    jp = jm.init(jax.random.PRNGKey(4))
    tp = interop.params_from_jax(_np(jp))
    want = _np(jm.apply_prox(jp, 0.7, 0.3, penalty))
    _close_trees(tm.apply_prox(tp, 0.7, 0.3, penalty), want)
    live = interop.tree_map(lambda x: x.clone().requires_grad_(True), tp)
    w = live["factor"][0]["w"]
    with torch.no_grad():
        assert tm.apply_prox_(live, 0.7, 0.3, penalty) is live
    assert live["factor"][0]["w"] is w
    _close_trees(live, want)


def test_clstm_fm_prox_matches_jax_and_refuses_lagged_penalties():
    jm, _ = _families()["clstm_fm"]
    tm = _port_model(jm)
    jp = jm.init(jax.random.PRNGKey(5))
    tp = interop.params_from_jax(_np(jp))
    want = _np(jm.apply_prox(jp, 0.9, 0.5))
    _close_trees(tm.apply_prox(tp, 0.9, 0.5), want)
    with torch.no_grad():
        tm.apply_prox_(tp, 0.9, 0.5)
    _close_trees(tp, want)
    for penalty in ("GSGL", "H"):
        with pytest.raises(ValueError, match="only the 'GL'"):
            tm.apply_prox(tp, 0.9, 0.5, penalty)


@pytest.mark.parametrize("cls", [tnavar.NAVAR, tnavar.NAVARLSTM])
def test_navar_dropout_keep_rate_and_scaling(cls):
    """Dropout > 0 cannot match ``jax.random``: the keep rate and the
    1/keep scaling hold, draws come from the generator handed in, and
    ``rng=None`` is eval mode."""
    cfg_cls = tnavar.NAVARConfig if cls is tnavar.NAVAR \
        else tnavar.NAVARLSTMConfig
    m = cls(cfg_cls(num_nodes=3, num_hidden=8, maxlags=2, hidden_layers=2,
                    dropout=0.25))
    assert m.wants_rng and not cls(cfg_cls(3, 8, 2)).wants_rng
    h = torch.ones((400, 50))
    out = tnavar._dropout(h, 0.75, torch.Generator().manual_seed(0))
    vals = set(torch.unique(out).tolist())
    assert vals <= {0.0, float(torch.tensor(1.0) / 0.75)}
    keep = float((out != 0).float().mean())
    assert abs(keep - 0.75) < 0.01
    p = m.init(torch.Generator().manual_seed(1))
    X = torch.from_numpy(_x(6, 4, 7, 3))
    eval_loss = m.loss(p, X)[0]
    assert torch.equal(eval_loss, m.loss(p, X, rng=None)[0])
    a = m.loss(p, X, rng=torch.Generator().manual_seed(3))[0]
    b = m.loss(p, X, rng=torch.Generator().manual_seed(3))[0]
    assert torch.equal(a, b) and not torch.equal(a, eval_loss)


# ------------------------------------------------- REDCLIFF, cLSTM factors
def _redcliff_config(embedder, fpm):
    return dict(
        num_chans=4, gen_lag=3, gen_hidden=(5,), embed_lag=4,
        embed_hidden_sizes=(6,), num_factors=3, num_supervised_factors=3,
        forecast_coeff=2.0, factor_score_coeff=2.0, factor_cos_sim_coeff=0.1,
        factor_weight_l1_coeff=0.01, adj_l1_reg_coeff=0.05,
        factor_score_embedder_type=embedder, dgcnn_num_graph_conv_layers=2,
        dgcnn_num_hidden_nodes=6, forward_pass_mode=fpm, num_sims=2,
        factor_network_type="cLSTM",
        training_mode="pretrain_embedder_then_acclimate_factors_then_"
                      "combined",
        num_pretrain_epochs=1, num_acclimation_epochs=1)


@pytest.mark.parametrize("embedder", ["DGCNN", "cEmbedder"])
@pytest.mark.parametrize("fpm", tred.FORWARD_PASS_MODES)
def test_redcliff_clstm_factors_match_jax(embedder, fpm):
    """REDCLIFF-S with cLSTM factors: the forward (K folded into the
    recurrence), ``loss_for_phase`` and the grads of every leaf in every
    phase, the factor GC and a conditional GC mode; the prox is refused,
    the factors permute along K and the port's init has the JAX tree's
    shapes."""
    cfg = _redcliff_config(embedder, fpm)
    jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**cfg))
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**cfg))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = interop.params_from_jax(_np(jp))
    X = _x(1, 5, 6, 4)
    Y = _labels(2, 5, 3)
    tol = TOL_DGCNN if embedder == "DGCNN" else TOL
    jout = jm.forward(jp, jnp.asarray(X[:, :4]))
    tout = tm.forward(tp, torch.from_numpy(X[:, :4]))
    _close(tout[0], jout[0], tol)
    for got, want in zip(tout[1], jout[1]):
        _close(got, want, tol)
    for phase in ("embedder_pretrain", "factor_pretrain", "combined",
                  "post_train"):
        (jl, jparts), jg = jax.value_and_grad(
            lambda p: jm.loss_for_phase(p, jnp.asarray(X), jnp.asarray(Y),
                                        phase), has_aux=True)(jp)
        live = interop.tree_map(lambda x: x.clone().requires_grad_(True),
                                tp)
        tl, tparts = tm.loss_for_phase(live, torch.from_numpy(X),
                                       torch.from_numpy(Y), phase)
        _close(tl, jl, tol)
        for k in jparts:
            _close(tparts[k], jparts[k], tol)
        leaves = interop.tree_leaves(live)
        g = torch.autograd.grad(tl, leaves, allow_unused=True)
        it = iter(g)
        tg = interop.tree_map(
            lambda p: (lambda x: torch.zeros_like(p) if x is None else x)(
                next(it)), live)
        _close_trees(tg, _np(jg), tol)
    for ignore_lag in (True, False):
        _close(tm.factor_gc(tp, ignore_lag=ignore_lag),
               jm.factor_gc(jp, ignore_lag=ignore_lag))
        _close(tm.gc(tp, X=torch.from_numpy(X[:, :4]), ignore_lag=ignore_lag),
               jm.gc(jp, X=jnp.asarray(X[:, :4]), ignore_lag=ignore_lag),
               tol)
    with pytest.raises(ValueError, match="cMLP factor"):
        tm.apply_prox(tp, 1.0, 0.1)
    with pytest.raises(ValueError, match="cMLP factor"):
        with torch.no_grad():
            tm.apply_prox_(tp, 1.0, 0.1)
    _close_trees(tm.permute_factors(tp, [2, 0, 1]),
                 _np(jm.permute_factors(jp, [2, 0, 1])))
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _flat(fresh).items()} == \
        {k: v.shape for k, v in _flat(_np(jp)).items()}
