"""The port's DCSFA-NMF (redcliff_tpu_torch/models/dcsfa_nmf.py) against the
JAX package, at a small width: 4 nodes, F = 3 features per pair (48
``vanilla`` features), h = 16, 3 components of which 2 supervised, 64
samples, 2 encoder-pretrain epochs and 3 joint epochs.

Weights come from the JAX init, carried across by ``interop``; the data are
seeded numpy: non-negative features at unit mean made from 3 planted
components plus noise, with the two labels tied to the first two
components' scores (so the component ranking has no near-ties).

Bars: the host copies (NNDSVD, the Mann-Whitney AUC) bit for bit; the
device NMF (20 multiplicative updates, MSE and IS) rtol 1e-4 / atol 1e-5;
forward passes rtol 1e-5 / atol 1e-6, and each package's gradients within
that bar of the port's float64 gradient; three optimizer steps (AdamW,
Adam, SGD, with and without the encoder-pretrain mask) on the same
gradients within 1e-6 (relative and absolute); a whole fit's histories
rtol 1e-4, its AUCs, best epoch and component order exact, its params
rtol 1e-4 / atol 1e-5 but ``W_nmf`` at atol 1e-4: it starts as the
inverse softplus of the NMF components, w ~ log(h), which turns the NMF
bar's relative error of h into an absolute one of w.

One leaf is outside any bar in a fit with an Adam-family optimizer:
``enc1["b"]``, the bias in front of the encoder's BatchNorm. The batch mean
cancels it, so its gradient is zero in exact arithmetic, and what either
package computes is rounding noise (~1e-8); Adam divides the moments, so
each step moves the bias by up to about ``lr`` in a direction set by that
noise, and the BatchNorm running mean follows it. That bias and the
running mean, and the eval-mode outputs that read them (the recon
histories), are held in an AdamW fit to the bound that random walk allows;
an SGD fit, where the noise stays noise, holds every leaf and history at
the full bars.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.eval import cross_alg as jcross  # noqa: E402
from redcliff_tpu.eval import gc_estimates as jge  # noqa: E402
from redcliff_tpu.eval import model_io as jio  # noqa: E402
from redcliff_tpu.models import dcsfa_nmf as J  # noqa: E402
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu.train import orchestration as jorch  # noqa: E402
from redcliff_tpu.utils import config as jconfig  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data.shards import save_cv_split  # noqa: E402
from redcliff_tpu_torch.eval import cross_alg as tcross  # noqa: E402
from redcliff_tpu_torch.eval import gc_estimates as tge  # noqa: E402
from redcliff_tpu_torch.eval import model_io as tio  # noqa: E402
from redcliff_tpu_torch.models import dcsfa_nmf as T  # noqa: E402
from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint  # noqa: E402,E501
from redcliff_tpu_torch.train import driver as tdriver  # noqa: E402
from redcliff_tpu_torch.train import orchestration as torch_orch  # noqa: E402,E501
from redcliff_tpu_torch.utils import config as tconfig  # noqa: E402
from redcliff_tpu_torch.utils.precision import resolve_device  # noqa: E402

NODES, FEAT, N, KC, SUP, H = 4, 3, 64, 3, 2, 16
D = NODES * NODES * FEAT
FWD = dict(rtol=1e-5, atol=1e-6)
NMF = dict(rtol=1e-4, atol=1e-5)
HIST = dict(rtol=1e-4)
PARAMS = dict(rtol=1e-4, atol=1e-5)
# W_nmf starts as the inverse softplus of the NMF components, which the NMF
# bar holds relatively: w ~ log(h) turns a relative error of h into an
# absolute one of w
W_NMF = {"/W_nmf": dict(rtol=1e-4, atol=1e-4)}
FIT = dict(n_epochs=3, n_pre_epochs=2, nmf_max_iter=20, batch_size=16)
# an Adam step moves a parameter by at most about lr; the bias in front of
# the BatchNorm random-walks by at most that per step (module docstring)
LR = 1e-3


def _data(n=N, seed=0):
    """Non-negative features from planted components, labels tied to the
    first SUP components' scores."""
    rng = np.random.default_rng(seed)
    comps = rng.gamma(2.0, 0.5, size=(KC, D))
    scores = rng.gamma(2.0, 1.0, size=(n, KC))
    X = scores @ comps + 0.1 * rng.random((n, D))
    y = (scores[:, :SUP] > np.median(scores[:, :SUP], axis=0)).astype(
        np.float32)
    # unit scale, so the absolute bars mean what they say
    return (X / X.mean()).astype(np.float32), y


def _pair(layout="vanilla", seed=0, **cfg):
    """(JAX model, port model, JAX params, JAX state), init from the JAX
    package."""
    cfg = dict(dict(n_components=KC, n_sup_networks=SUP, h=H), **cfg)
    jm = J.FullDCSFAModel(num_nodes=NODES, num_high_level_node_features=FEAT,
                          gc_feature_layout=layout, **cfg)
    tm = T.FullDCSFAModel(num_nodes=NODES, num_high_level_node_features=FEAT,
                          gc_feature_layout=layout, **cfg)
    dim = jm.dim_in if layout == "vanilla" else D
    jp, js = jm.init(jax.random.PRNGKey(seed), dim)
    return jm, tm, jp, js


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return interop.params_from_jax(_np(tree))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _host(tree):
    return interop.tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x), tree)


def _close_trees(got, want, skip=(), per_leaf=None, **tol):
    """Leaf-by-leaf allclose of two trees (torch, jax or numpy leaves),
    keyed by path (``per_leaf`` overrides the bar of a path); returns both
    flattened."""
    got, want = _flat(_host(got)), _flat(_host(want))
    assert sorted(got) == sorted(want)
    for k in want:
        if k not in skip:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **(per_leaf or {}).get(k, tol))
    return got, want


def _copy_init(monkeypatch, jp, js):
    """The port's ``init`` returns the JAX init."""
    npj = _np((jp, js))

    def init(self, generator, dim_in, device="cpu"):
        return (interop.params_from_jax(npj[0], device),
                interop.params_from_jax(npj[1], device))
    monkeypatch.setattr(T.DcsfaNmf, "init", init)


# --------------------------------------------------------------- host copies

def test_host_copies_equal_jax():
    X, y = _data()
    for fill_mean in (False, True):
        for g, w in zip(T.nndsvd_init(X, KC, fill_mean=fill_mean),
                        J.nndsvd_init(X, KC, fill_mean=fill_mean)):
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(1)
    pos, neg = rng.integers(0, 5, 20), rng.integers(0, 5, 30)  # ties
    for a, b in ((pos, neg), (pos, []), (X[:, 0], X[:, 1])):
        assert T.mann_whitney_auc(a, b) == J.mann_whitney_auc(a, b)


@pytest.mark.parametrize("loss", ["MSE", "IS"])
def test_nmf_fit_matches_jax(loss):
    """20 multiplicative updates on the device (the CPU here)."""
    X, _ = _data()
    got = T.nmf_fit(X, KC, max_iter=20, loss=loss, device="cpu")
    want = J.nmf_fit(X, KC, max_iter=20, loss=loss)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), **NMF)


@pytest.mark.parametrize("fixed_corr", ["n/a", ("positive", "negative")])
def test_pretrain_nmf_orders_components_as_jax(fixed_corr):
    """The NMF pretrain's component order and selected AUCs exact, the
    inverse-softplus ``W_nmf`` within the NMF bar."""
    X, y = _data()
    jm, tm, jp, _ = _pair(fixed_corr=fixed_corr)
    jp2, jaucs = jm.pretrain_nmf(jp, X, y, nmf_max_iter=20)
    tp2, taucs = tm.pretrain_nmf(_t(jp), X, y, nmf_max_iter=20)
    assert taucs == jaucs
    # the JAX order, read back from its rows: row i is component order[i]
    _, comps = J.nmf_fit(X, KC, max_iter=20)
    jW = np.asarray(jax.nn.softplus(jp2["W_nmf"]))
    jorder = [int(np.argmin(np.abs(np.asarray(comps) + 1e-5 - r).sum(1)))
              for r in jW]
    assert tm.component_order == jorder
    assert sorted(jorder) == list(range(KC))
    np.testing.assert_allclose(tp2["W_nmf"].numpy(), np.asarray(jp2["W_nmf"]),
                               **NMF)


# ------------------------------------------------------------ forward passes

@pytest.mark.parametrize("deep", [True, False])
def test_encode_and_class_predictions_match_jax(deep):
    """``encode`` in training (batch statistics, biased variance; running
    statistics updated with the unbiased one) and in eval; the class
    predictions in the three intercept modes under each correlation
    constraint."""
    X, _ = _data()
    for n_int, corr in ((1, "n/a"), (2, ("positive", "negative"))):
        jm, tm, jp, js = _pair(use_deep_encoder=deep, n_intercepts=n_int,
                               fixed_corr=corr)
        tp, ts = _t(jp), _t(js)
        for train in (True, False):
            sj, nsj = jm.encode(jp, js, X, train)
            st, nst = tm.encode(tp, ts, torch.from_numpy(X), train)
            np.testing.assert_allclose(st.numpy(), np.asarray(sj), **FWD)
            _close_trees(nst, nsj, **FWD)
        mask = np.eye(n_int, dtype=np.float32)[np.arange(N) % n_int]
        for im, avg in ((None, False), (mask, False), (mask, True)):
            want = jm.class_predictions(jp, sj, im, avg_intercept=avg)
            got = tm.class_predictions(
                tp, st, None if im is None else torch.from_numpy(im),
                avg_intercept=avg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
        np.testing.assert_allclose(tm.get_phi(tp).numpy(),
                                   np.asarray(jm.get_phi(jp)), **FWD)


LOSS_CASES = [(sup, rec, fg) for sup in ("Residual", "All")
              for rec in ("MSE", "IS") for fg in (None, ((0, 16), (16, D)))]


@pytest.mark.parametrize("sup_recon_type,recon_loss,feature_groups",
                         LOSS_CASES)
def test_loss_and_gradients_match_jax(sup_recon_type, recon_loss,
                                      feature_groups):
    """``loss`` (recon and prediction terms, new BatchNorm state) and the
    gradient of every leaf, at the params every training step sees: the
    JAX init after the JAX NMF pretrain. The losses are held port against
    JAX; the gradients of each package against the port's float64
    gradient on the same inputs (the two float32 results each sit within
    the bar of it, so their difference may reach twice the bar: the
    BatchNorm backward cancels large terms)."""
    X, y = _data()
    jm, tm, jp, js = _pair(sup_recon_type=sup_recon_type,
                           recon_loss=recon_loss,
                           feature_groups=feature_groups,
                           sup_recon_weight=0.5, sup_weight=2.0)
    jp, _ = jm.pretrain_nmf(jp, X, y, nmf_max_iter=20)
    rng = np.random.default_rng(2)
    b = rng.choice(N, 16, replace=False)
    tmask = (rng.random((16, SUP)) < 0.8).astype(np.float32)
    pw = rng.random((16, 1)).astype(np.float32)
    batch = (X[b], y[b], tmask, pw, np.ones((16, 1), np.float32))
    for train in (True, False):
        def total(p):
            r, pr, st = jm.loss(p, js, batch, train)
            return r + pr, (r, pr, st)
        (_, (jr, jpr, jst)), jg = jax.value_and_grad(total, has_aux=True)(jp)
        grads = {}
        for dt in (torch.float32, torch.float64):
            live = T._live(interop.tree_map(lambda x: x.to(dt), _t(jp)))
            tr, tpr, tst = tm.loss(
                live, interop.tree_map(lambda x: x.to(dt), _t(js)),
                tuple(torch.from_numpy(a).to(dt) for a in batch), train)
            it = iter(torch.autograd.grad(tr + tpr,
                                          interop.tree_leaves(live)))
            grads[dt] = interop.tree_map(lambda _: next(it), live)
            if dt == torch.float32:
                np.testing.assert_allclose(tr.item(), float(jr), **FWD)
                np.testing.assert_allclose(tpr.item(), float(jpr), **FWD)
                _close_trees(tst, jst, **FWD)
        _close_trees(grads[torch.float32], grads[torch.float64], **FWD)
        _close_trees(jg, grads[torch.float64], **FWD)


# ---------------------------------------------------------------- optimizers

@pytest.mark.parametrize("optim_name", ["AdamW", "Adam", "SGD"])
@pytest.mark.parametrize("pretrain", [True, False])
def test_optimizer_steps_match_optax(optim_name, pretrain):
    """Three steps of the phase's optimizer on the same gradients (the JAX
    package's, taken at its own params each step): the encoder pretrain
    updates the encoder only and passes the masked leaves' raw gradient
    through (``optax.masked``: ``W_nmf += grad``); the joint fit updates
    every leaf."""
    import optax

    X, y = _data()
    jm, tm, jp, js = _pair(optim_name=optim_name, momentum=0.5, lr=1e-2)
    jp, _ = jm.pretrain_nmf(jp, X, y, nmf_max_iter=20)
    w0 = np.asarray(jp["W_nmf"])
    tx, _ = jm._build_step(pretrain=pretrain)
    jstate = tx.init(jp)
    live = T._live(_t(jp))
    phase = tm.make_phase(live, pretrain=pretrain)
    order = phase[1] + phase[2]
    ones = np.ones((16, 1), np.float32)
    for step in range(3):
        b = np.arange(16) + 16 * step
        batch = (X[b], y[b], np.ones((16, SUP), np.float32), ones, ones)

        def loss(p):
            r, pr, _ = jm.loss(p, js, batch, True)
            return r if pretrain else r + pr
        g = jax.grad(loss)(jp)
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        # the JAX gradient, leaf for leaf in the phase's order
        gt = _t(g)
        by_id = {id(t): gl for t, gl in zip(interop.tree_leaves(live),
                                             interop.tree_leaves(gt))}
        tm.apply_grads(phase, [by_id[id(p)] for p in order])
    _, want = _close_trees(live, jp, rtol=1e-6, atol=1e-6)
    # the masked W_nmf moved by its raw gradients in the pretrain
    assert np.abs(want["/W_nmf"] - w0).max() > 0


# ---------------------------------------------------------------- whole fit

@pytest.mark.parametrize("optim_name", ["SGD", "AdamW"])
def test_fit_matches_jax(optim_name, monkeypatch, tmp_path):
    """A whole fit (NMF pretrain, 2 encoder-pretrain epochs, 3 joint epochs
    with validation and best-model checkpointing) from the same init: the
    histories, AUCs, best epoch, component order and best params. Under
    AdamW the BatchNorm-cancelled bias and what reads it are held to the
    random-walk bound (module docstring)."""
    X, y = _data()
    Xv, yv = _data(32, seed=5)
    jm, tm, jp, js = _pair(optim_name=optim_name, lr=LR)
    _copy_init(monkeypatch, jp, js)
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    jfit = jm.fit(jax.random.PRNGKey(0), X, y, X_val=Xv, y_val=yv,
                  save_folder=str(tmp_path / "j"), **FIT)
    tfit = tm.fit(torch.Generator(), X, y, X_val=Xv, y_val=yv,
                  save_folder=str(tmp_path / "t"), device="cpu", **FIT)
    (jpar, jst, jh), (tpar, tst, th) = jfit, tfit
    assert sorted(th) == sorted(jh)
    adam = optim_name != "SGD"
    steps = FIT["n_pre_epochs"] * (N // FIT["batch_size"]) \
        + FIT["n_epochs"] * (N // FIT["batch_size"])
    for k in ("training", "recon", "val_recon"):
        if adam and k != "training":
            # eval-mode outputs read the walked bias: bounded, not equal
            # (3e-3 apart here)
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-2, err_msg=k)
        else:
            np.testing.assert_allclose(th[k], jh[k], err_msg=k, **HIST)
    for k in ("pred", "val_pred", "best_epoch", "best_val_aucs"):
        assert th[k] == jh[k], k
    assert th["best_epoch"] >= 0
    assert tm.fit_log["component_order"] == tm.component_order
    skip = ("/enc1/b", "/bn_mean") if adam else ()
    got, want = _close_trees(tpar, jpar, skip=skip, per_leaf=W_NMF,
                             **PARAMS)
    gs, ws = _close_trees(tst, jst, skip=skip, **PARAMS)
    if adam:
        walk = 2 * LR * steps
        assert np.abs(got["/enc1/b"] - want["/enc1/b"]).max() < walk
        assert np.abs(gs["/bn_mean"] - ws["/bn_mean"]).max() < walk
    log = read_checkpoint(str(tmp_path / "t" / T.FIT_LOG_NAME))
    assert log["joint_steps"] == FIT["n_epochs"] * (N // FIT["batch_size"])
    assert log["pre_steps"] == FIT["n_pre_epochs"] * (N // FIT["batch_size"])
    assert [e["epoch"] for e in log["epochs"]] == list(range(3))
    # each package's best-model artifact loads in the other
    for src in ("j", "t"):
        tmod, tp, ts = tio.load_model_for_eval(
            str(tmp_path / src), device="cpu")
        jmod, jp2, js2 = jio.load_model_for_eval(str(tmp_path / src))
        assert type(tmod).__name__ == type(jmod).__name__ == "FullDCSFAModel"
        assert dataclasses.asdict(tmod.config) \
            == dataclasses.asdict(jmod.config)
        for a in ("num_nodes", "num_high_level_node_features",
                  "gc_feature_layout"):
            assert getattr(tmod, a) == getattr(jmod, a)
        _close_trees(tp, jp2, rtol=0, atol=0)
        _close_trees(ts, js2, rtol=0, atol=0)
        for g, w in zip(tmod.transform(tp, ts, Xv),
                        jmod.transform(jp2, js2, Xv)):
            np.testing.assert_allclose(g, np.asarray(w), **FWD)


def test_fit_without_pretrain_and_linear_encoder(monkeypatch):
    """``pretrain=False`` with the linear encoder (no BatchNorm: every
    leaf and history at the full bars under AdamW), without validation."""
    X, y = _data()
    jm, tm, jp, js = _pair(use_deep_encoder=False, lr=LR)
    assert "enc2" not in jp and js == {}
    _copy_init(monkeypatch, jp, js)
    kw = dict(FIT, pretrain=False)
    jpar, jst, jh = jm.fit(jax.random.PRNGKey(0), X, y, **kw)
    tpar, tst, th = tm.fit(torch.Generator(), X, y, device="cpu", **kw)
    for k in ("training", "recon"):
        np.testing.assert_allclose(th[k], jh[k], err_msg=k, **HIST)
    assert th["pred"] == jh["pred"] and tst == {}
    _close_trees(tpar, jpar, per_leaf=W_NMF, **PARAMS)
    assert tm.fit_log["nmf_ms"] == 0.0 and tm.fit_log["pre_steps"] == 0


# ---------------------------------------------------------------- array task

DATA_SET = "d4IC_fold0"
T_WIN, NNF = 14, 12   # features from the first 12 steps: F = 3 below 250 Hz
# experiments/accuracy_parity_d4ic.py DCSFA_ARGS, cut to the tiny width
DCSFA_ARGS = {
    "batch_size": "16", "num_high_level_node_features": str(FEAT),
    "best_model_name": "dCSFA-NMF-best-model.pt",
    "num_node_features": str(NNF), "n_components": str(KC),
    "n_sup_networks": str(KC),
    "signal_format": "original flattened directed_spectrum vanilla",
    "h": str(H), "momentum": "0.5", "lr": "0.001", "recon_weight": "1.0",
    "sup_weight": "2.0", "sup_recon_weight": "1.0",
    "sup_smoothness_weight": "2.0", "n_epochs": "3", "n_pre_epochs": "2",
    "nmf_max_iter": "20",
}


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    """One fold of KC-state sparse VAR(1) recordings with one-hot state
    labels (n, KC, 1), and its data cached-args file."""
    base = tmp_path_factory.mktemp("fold")
    rng = np.random.default_rng(0)
    A = [(rng.random((NODES, NODES)) < 0.3)
         * rng.normal(0, 0.4, (NODES, NODES)) + 0.3 * np.eye(NODES)
         for _ in range(KC)]
    n = 72
    states = rng.integers(0, KC, n)
    X = np.zeros((n, T_WIN, NODES))
    for t in range(1, T_WIN):
        X[:, t] = np.einsum("nij,nj->ni", np.stack(A)[states],
                            X[:, t - 1]) + rng.normal(size=(n, NODES))
    Y = np.eye(KC, dtype=np.float32)[states][:, :, None]
    pairs = [[x.astype(np.float32), y] for x, y in zip(X, Y)]
    save_cv_split(pairs[:48], pairs[48:], 0, str(base / "data"))
    dargs = str(base / f"{DATA_SET}_data_cached_args.txt")
    graphs = [(a != 0).astype(float)[:, :, None] for a in A]
    with open(dargs, "w") as f:
        json.dump({"data_root_path": str(base / "data" / "fold_0"),
                   "num_channels": str(NODES),
                   **{f"net{k + 1}_adjacency_tensor":
                      tconfig.serialize_tensor_to_string(g)
                      for k, g in enumerate(graphs)}}, f)
    margs = str(base / "DCSFANMF_d4IC_cached_args.txt")
    with open(margs, "w") as f:
        json.dump(DCSFA_ARGS, f)
    return {"base": base, "dargs": dargs, "margs": margs}


def test_array_task_matches_jax(fold, tmp_path, monkeypatch):
    """Array task 1 of ``DCSFANMF`` through both packages'
    ``set_up_and_run_experiments`` from the same weights: the schema and
    factory agree, the run folders hold the same model artifact, the best
    params agree (the walked bias to its bound), each artifact loads in
    both packages, and the eval dispatch, GC and score estimates and the
    cross-algorithm scoring of the port equal the JAX package's on the JAX
    artifact."""
    base = {"model_type": "DCSFANMF",
            "model_cached_args_file": fold["margs"],
            "data_cached_args_file": fold["dargs"]}
    jargs = jconfig.read_in_data_args(jconfig.read_in_model_args(dict(base)))
    targs = tconfig.read_in_data_args(tconfig.read_in_model_args(dict(base)))
    assert sorted(targs) == sorted(jargs)
    for k, v in jargs.items():
        if k in ("true_GC_factors", "true_GC_tensor"):
            for a, b in zip(v, targs[k]):
                np.testing.assert_array_equal(b, a)
        else:
            assert targs[k] == v, k
    jm0 = jorch.create_model_instance(jargs)
    tm0 = torch_orch.create_model_instance(targs)
    assert type(tm0).__name__ == type(jm0).__name__ == "FullDCSFAModel"
    assert dataclasses.asdict(tm0.config) == dataclasses.asdict(jm0.config)
    assert tm0.gc_feature_layout == jm0.gc_feature_layout == "vanilla"
    assert tm0.dim_in == NODES * NODES * FEAT
    jp, js = jm0.init(jax.random.PRNGKey(0), tm0.dim_in)
    _copy_init(monkeypatch, jp, js)

    runs = {}
    for name, pkg, extra in (("jax", jdriver, {}),
                             ("port", tdriver, {"device": "cpu"})):
        root = tmp_path / name
        os.makedirs(root)
        assert pkg.set_up_and_run_experiments(
            {"save_root_path": str(root)}, [fold["margs"]], [fold["dargs"]],
            ["DCSFANMF"], [DATA_SET], task_id=1, **extra) == 1
        (run,) = os.listdir(root)
        runs[name] = root / run
    assert runs["jax"].name == runs["port"].name
    assert sorted(os.listdir(runs["port"])) == sorted(
        os.listdir(runs["jax"]) + [T.FIT_LOG_NAME])

    tm, tp, ts = tio.load_model_for_eval(str(runs["port"]), device="cpu")
    jm, jp2, js2 = jio.load_model_for_eval(str(runs["jax"]))
    tm2, tp2, ts2 = tio.load_model_for_eval(str(runs["jax"]), device="cpu")
    jm3, jp3, _ = jio.load_model_for_eval(str(runs["port"]))
    skip = ("/enc1/b", "/bn_mean")
    _close_trees(tp, jp2, skip=skip, rtol=1e-4, atol=1e-4)
    _close_trees(ts, js2, skip=skip, rtol=1e-4, atol=1e-4)
    _close_trees(tp, jp3, rtol=0, atol=0)

    # the eval layer on the JAX artifact
    _, jval = jorch.get_data_for_model_training(jargs)
    _, tval = torch_orch.get_data_for_model_training(targs, device="cpu")
    np.testing.assert_array_equal(tval.X_features, jval.X_features)
    jev = jorch.call_model_eval_method(jm, (jp2, js2), jargs, jval)
    tev = torch_orch.call_model_eval_method(tm2, (tp2, ts2), targs, tval)
    assert sorted(tev) == sorted(jev)
    np.testing.assert_allclose(tev["components"][:4], jev["components"][:4],
                               **FWD)
    assert [g[:2] for g in tev["gc_mse"]] == [w[:2] for w in jev["gc_mse"]]
    np.testing.assert_allclose([g[2] for g in tev["gc_mse"]],
                               [w[2] for w in jev["gc_mse"]], **FWD)
    got = tge.get_model_gc_estimates(tm2, tp2, "DCSFA", KC)
    want = jge.get_model_gc_estimates(jm, jp2, "DCSFA", KC)
    assert len(got) == len(want) == KC
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **FWD)
    xs = jval.X_features[:1]
    np.testing.assert_allclose(
        tge.get_model_gc_score_estimates(tm2, tp2, "DCSFA", KC, X=xs,
                                         state=ts2),
        jge.get_model_gc_score_estimates(jm, jp2, "DCSFA", KC, X=xs,
                                         state=js2), **FWD)
    truth = tconfig.load_true_gc_factors(fold["dargs"])
    got = _flat(tcross.evaluate_algorithm_on_fold(str(runs["jax"]), "DCSFA",
                                                  truth, device="cpu"))
    want = _flat(jcross.evaluate_algorithm_on_fold(str(runs["jax"]),
                                                   "DCSFA", truth))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].astype(float), v.astype(float),
                                   err_msg=k, **FWD)


# -------------------------------------------------------------------- card

@pytest.mark.gpu
@pytest.mark.parametrize("optim_name", ["SGD", "AdamW"])
def test_fit_on_card_matches_cpu(optim_name):
    """The whole fit of ``test_fit_matches_jax`` on the card against the
    port's CPU fit from the same init and batches (the weighted draws come
    from the host rng), at the same bars: histories, AUCs, best epoch and
    component order, params; under AdamW the walked bias and what reads it
    to the walk bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y = _data()
    Xv, yv = _data(32, seed=5)
    out = {}
    for dev in ("cpu", "cuda"):
        tm = T.FullDCSFAModel(num_nodes=NODES,
                              num_high_level_node_features=FEAT,
                              gc_feature_layout="vanilla", n_components=KC,
                              n_sup_networks=SUP, h=H, optim_name=optim_name,
                              lr=LR)
        p, s, h = tm.fit(torch.Generator().manual_seed(0), X, y, X_val=Xv,
                         y_val=yv, device=resolve_device(dev), **FIT)
        out[dev] = (p, s, h, tm.component_order)
    (pc, sc, hc, oc), (pg, sg, hg, og) = out["cpu"], out["cuda"]
    assert og == oc
    adam = optim_name != "SGD"
    for k in ("training", "recon", "val_recon"):
        np.testing.assert_allclose(
            hg[k], hc[k], err_msg=k,
            **(dict(rtol=1e-2) if adam and k != "training" else HIST))
    for k in ("pred", "val_pred", "best_epoch"):
        assert hg[k] == hc[k], k
    skip = ("/enc1/b", "/bn_mean") if adam else ()
    _close_trees(pg, pc, skip=skip, per_leaf=W_NMF, **PARAMS)
    _close_trees(sg, sc, skip=skip, **PARAMS)
