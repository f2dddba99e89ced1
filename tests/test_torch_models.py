"""The port's models (redcliff_tpu_torch/models, obs/quality.py, interop.py,
eval/model_io.py) against the JAX package on the same weights.

Every weight is made by the JAX package's ``init`` and carried across with
``interop.params_from_jax``; every input is made with numpy from a seed.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from redcliff_tpu.models import cmlp as jcmlp  # noqa: E402
from redcliff_tpu.models import dgcnn as jdgcnn  # noqa: E402
from redcliff_tpu.models import embedders as jemb  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.obs import quality as jquality  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.models import cmlp as tcmlp  # noqa: E402
from redcliff_tpu_torch.models import dgcnn as tdgcnn  # noqa: E402
from redcliff_tpu_torch.models import embedders as temb  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.obs import quality as tquality  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# forward, GC and graphs: f32 in both frameworks, different summation
# order — the ROADMAP bar (tests/test_precision_kernels.py:129)
TOL = dict(rtol=1e-5, atol=1e-6)
# anything downstream of a DGCNN embed: sigmoid(10 x) magnifies input
# differences by up to 2.5x
TOL_DGCNN = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return interop.params_from_jax(_np(tree), "cpu")


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol)


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------- cMLP
def test_cmlp_forward_gc_and_mlp_match_jax():
    C, lag, hidden = 5, 3, (6, 4)
    jp = jcmlp.init_cmlp_params(jax.random.PRNGKey(0), C, lag, hidden)
    tp = _port(jp)
    X = _x(1, 3, 7, C)
    _close(tcmlp.lagged_windows(torch.from_numpy(X), lag),
           jcmlp.lagged_windows(jnp.asarray(X), lag))
    _close(tcmlp.cmlp_forward(tp, torch.from_numpy(X)),
           jcmlp.cmlp_forward(jp, jnp.asarray(X)))
    for ignore_lag in (True, False):
        for threshold in (False, True):
            _close(tcmlp.cmlp_gc(tp, threshold=threshold,
                                 ignore_lag=ignore_lag),
                   jcmlp.cmlp_gc(jp, threshold=threshold,
                                 ignore_lag=ignore_lag))
    jm = jcmlp.init_mlp_params(jax.random.PRNGKey(2), C, lag, hidden)
    _close(tcmlp.mlp_forward(_port(jm), torch.from_numpy(X)),
           jcmlp.mlp_forward(jm, jnp.asarray(X)))
    # the init draws from the same distributions at the same shapes
    ours = tcmlp.init_cmlp_params(torch.Generator().manual_seed(0), C, lag,
                                  hidden)
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in ours] \
        == [{k: v.shape for k, v in layer.items()} for layer in jp]
    bound = np.sqrt(6.0 / (C * lag + hidden[0] * lag))
    assert float(ours[0]["w"].abs().max()) <= bound


def test_cmlp_wavelet_readouts_match_jax():
    ns, chans, lag = 8, 2, 2
    jp = jcmlp.init_cmlp_params(jax.random.PRNGKey(3), ns, lag, (4,))
    tp = _port(jp)
    jmask = jcmlp.build_wavelet_ranking_mask(ns, 4)
    tmask = tcmlp.build_wavelet_ranking_mask(ns, 4)
    _close(tmask, jmask)
    for ignore_lag in (True, False):
        kw = dict(ignore_lag=ignore_lag, rank_wavelets=True, num_chans=chans,
                  combine_wavelet_representations=True)
        _close(tcmlp.cmlp_gc(tp, wavelet_mask=tmask, **kw),
               jcmlp.cmlp_gc(jp, wavelet_mask=jmask, **kw))
    for shape in ((ns, ns), (ns, ns, 3)):
        G = _x(4, *shape)
        _close(tcmlp.condense_wavelet_gc(torch.from_numpy(G), chans),
               jcmlp.condense_wavelet_gc(jnp.asarray(G), chans))


# ---------------------------------------------------------------- DGCNN
def test_dgcnn_forward_and_gc_match_jax():
    cfg = jdgcnn.DGCNNConfig(num_channels=3, num_wavelets_per_chan=2,
                             num_features_per_node=5,
                             num_graph_conv_layers=3, num_hidden_nodes=7,
                             num_classes=4)
    tcfg = tdgcnn.DGCNNConfig(**dataclasses.asdict(cfg))
    jp = jdgcnn.init_dgcnn_params(jax.random.PRNGKey(5), cfg)
    # non-trivial scale/shift so the learned normalization is exercised
    jp["bn_scale"] = jnp.asarray(1.0 + _x(6, 5))
    jp["bn_shift"] = jnp.asarray(_x(7, 5))
    tp = _port(jp)
    X = 3.0 + 2.0 * _x(8, 4, 6, 5)
    _close(tdgcnn.dgcnn_forward(tp, torch.from_numpy(X)),
           jdgcnn.dgcnn_forward(jp, jnp.asarray(X)), TOL_DGCNN)
    for combine in (False, True):
        for threshold in (False, True):
            _close(tdgcnn.dgcnn_gc(tp, tcfg, threshold=threshold,
                                   combine_node_feature_edges=combine),
                   jdgcnn.dgcnn_gc(jp, cfg, threshold=threshold,
                                   combine_node_feature_edges=combine))
    ours = tdgcnn.init_dgcnn_params(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.map(lambda a: a.shape, _np(jp)) == jax.tree.map(
        lambda a: a.shape, interop.params_to_jax(ours))


# ---------------------------------------------------------------- embedders
_EMBED_KW = dict(num_chans=3, embed_lag=5, num_factors=4,
                 use_sigmoid_restriction=True, sigmoid_eccentricity_coeff=10.0,
                 dgcnn_args={"num_features_per_node": 5,
                             "num_graph_conv_layers": 2,
                             "num_hidden_nodes": 6})


@pytest.mark.parametrize("kind,sup,wavelet_level", [
    ("Vanilla_Embedder", 0, None),      # VanillaSingleObjective
    ("Vanilla_Embedder", 2, None),      # VanillaMultiObjective
    ("cEmbedder", 2, None),
    ("cEmbedder", 2, 3),                # wavelet ranking + condensing
    ("DGCNN", 2, None),
    ("DGCNN", 2, 1),
])
def test_embedders_match_jax(kind, sup, wavelet_level):
    ns = 3 * (wavelet_level + 1) if wavelet_level is not None else 3
    kw = dict(_EMBED_KW, num_series=ns, embed_hidden_sizes=[8],
              num_supervised_factors=sup, wavelet_level=wavelet_level)
    if kind == "DGCNN":
        kw["dgcnn_args"] = dict(kw["dgcnn_args"])
    je = jemb.build_embedder(kind, **kw)
    te = temb.build_embedder(kind, **kw)
    assert type(te).__name__ == type(je).__name__
    jp = je.init(jax.random.PRNGKey(9))
    tp = _port(jp)
    tol = TOL_DGCNN if kind == "DGCNN" else TOL
    X = _x(10, 6, 5, ns)
    if kind == "DGCNN":
        X = np.transpose(X, (0, 2, 1)).copy()  # node-major
    for final in (True, False):
        tw, tl = te.apply(tp, torch.from_numpy(X), use_final_activation=final)
        jw, jl = je.apply(jp, jnp.asarray(X), use_final_activation=final)
        _close(tw, jw, tol)
        assert (tl is None) == (jl is None)
        if jl is not None:
            _close(tl, jl, tol)
    if kind == "cEmbedder":
        for ignore_lag in (True, False):
            gkw = dict(ignore_lag=ignore_lag,
                       rank_wavelets=wavelet_level is not None,
                       combine_wavelet_representations=True)
            _close(te.gc(tp, **gkw), je.gc(jp, **gkw))
    if kind == "DGCNN":
        for combine in (False, True):
            _close(te.gc(tp, combine_node_feature_edges=combine),
                   je.gc(jp, combine_node_feature_edges=combine))


# ---------------------------------------------------------------- REDCLIFF-S
def _config(embedder, forward_mode, **over):
    kw = dict(num_chans=4, gen_lag=2, gen_hidden=(6,), embed_lag=4,
              embed_hidden_sizes=(8,), num_factors=3,
              num_supervised_factors=2,
              factor_score_embedder_type=embedder,
              dgcnn_num_graph_conv_layers=2, dgcnn_num_hidden_nodes=8,
              primary_gc_est_mode="fixed_factor_exclusive",
              forward_pass_mode=forward_mode, num_sims=2,
              training_mode="combined")
    kw.update(over)
    return jred.RedcliffSCMLPConfig(**kw)


def _pair(jcfg, seed=0):
    jm = jred.RedcliffSCMLP(jcfg)
    tm = tred.RedcliffSCMLP(
        tred.RedcliffSCMLPConfig(**dataclasses.asdict(jcfg)))
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, tm, _port(jp)


@pytest.mark.parametrize("forward_mode", tred.FORWARD_PASS_MODES)
@pytest.mark.parametrize("embedder",
                         ["Vanilla_Embedder", "cEmbedder", "DGCNN"])
def test_redcliff_forward_and_every_gc_mode_match_jax(embedder,
                                                      forward_mode):
    jm, jp, tm, tp = _pair(_config(embedder, forward_mode))
    tol = TOL_DGCNN if embedder == "DGCNN" else TOL
    X = _x(11, 5, jm.config.max_lag, 4)
    tX, jX = torch.from_numpy(X), jnp.asarray(X)

    t_sims, t_fp, t_w, t_lab = tm.forward(tp, tX)
    j_sims, j_fp, j_w, j_lab = jm.forward(jp, jX)
    _close(t_sims, j_sims, tol)
    for group_t, group_j in ((t_fp, j_fp), (t_w, j_w), (t_lab, j_lab)):
        assert len(group_t) == len(group_j)
        for a, b in zip(group_t, group_j):
            _close(a, b, tol)
    # fixed weightings bypass the embedder in both frameworks
    fixed = _x(12, 5, 3)
    _close(tm.forward(tp, tX, torch.from_numpy(fixed))[0],
           jm.forward(jp, jX, jnp.asarray(fixed))[0], tol)

    compared = 0
    for mode in tred.GC_EST_MODES:
        for ignore_lag in (True, False):
            try:
                want = jm.gc(jp, mode, X=jX, ignore_lag=ignore_lag)
            except ValueError:
                # modes this embedder cannot read out refuse in both
                with pytest.raises(ValueError):
                    tm.gc(tp, mode, X=tX, ignore_lag=ignore_lag)
                continue
            _close(tm.gc(tp, mode, X=tX, ignore_lag=ignore_lag), want, tol)
            compared += 1
    _close(tm.gc(tp, "fixed_factor_exclusive", threshold=True),
           jm.gc(jp, "fixed_factor_exclusive", threshold=True))
    want_modes = {"Vanilla_Embedder": 2, "cEmbedder": 9, "DGCNN": 6}
    assert compared == 2 * want_modes[embedder]


@pytest.mark.parametrize("embedder,mode", [
    ("Vanilla_Embedder", "fixed_factor_exclusive"),
    ("cEmbedder", "fixed_factor_fixed_embedder"),
    ("DGCNN", "conditional_factor_fixed_embedder"),
])
def test_summary_fn_matches_jax(embedder, mode):
    jm, jp, tm, tp = _pair(_config(embedder,
                                   tred.FORWARD_PASS_MODES[0],
                                   primary_gc_est_mode=mode), seed=4)
    assert tquality.readout_mode(tm.config) == jquality.readout_mode(
        jm.config)
    X = _x(13, 6, jm.config.max_lag, 4)
    got = tquality.make_summary_fn(tm)(tp, torch.from_numpy(X))
    want = jquality.make_summary_fn(jm)(jp, jnp.asarray(X))
    for key in ("gc", "col_norms", "edge_energy", "sparsity", "topk_val"):
        _close(got[key], want[key])
    _close(got["entropy"], want["entropy"],
           TOL_DGCNN if embedder == "DGCNN" else TOL)
    np.testing.assert_array_equal(got["topk_idx"].numpy(),
                                  np.asarray(want["topk_idx"]))


def test_topk_ties_break_toward_smaller_index():
    """lax.top_k's tie order, which torch.topk does not promise."""
    flat = np.array([1.0, 3.0, 2.0, 3.0, 2.0, 3.0, 0.5], dtype=np.float32)
    _, want = jax.lax.top_k(jnp.asarray(flat), 5)
    _, got = tquality._topk_stable(torch.from_numpy(flat), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_config_validation_and_unported_parts_raise():
    with pytest.raises(ValueError, match="requires"):
        tred.RedcliffSCMLPConfig(**dict(
            dataclasses.asdict(_config("Vanilla_Embedder",
                                       tred.FORWARD_PASS_MODES[0])),
            primary_gc_est_mode="raw_embedder"))
    with pytest.raises(ValueError, match="training_mode"):
        tred.RedcliffSCMLPConfig(**dict(
            dataclasses.asdict(_config("DGCNN",
                                       tred.FORWARD_PASS_MODES[0])),
            training_mode="nope"))
    with pytest.raises(ValueError, match="factor_network_type"):
        tred.RedcliffSCMLPConfig(**dict(
            dataclasses.asdict(_config("DGCNN", tred.FORWARD_PASS_MODES[0])),
            factor_network_type="DGCNN"))
    cfg = tred.RedcliffSCMLPConfig(**dict(
        dataclasses.asdict(_config("DGCNN", tred.FORWARD_PASS_MODES[0])),
        factor_network_type="cLSTM"))
    model = tred.RedcliffSCMLP(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    # a cLSTM factor has no lagged first-layer block: the prox is refused,
    # as in the JAX package
    with pytest.raises(ValueError, match="cMLP factor"):
        model.apply_prox(params, 1.0, 0.1)
    # mixed precision is ported everywhere: an unknown mode still raises
    from redcliff_tpu_torch.utils.precision import check_precision_mode
    assert check_precision_mode("mixed") == "mixed"
    with pytest.raises(ValueError, match="precision_mode"):
        check_precision_mode("fp8")


# ---------------------------------------------------------------- interop
@pytest.mark.parametrize("embedder",
                         ["Vanilla_Embedder", "cEmbedder", "DGCNN"])
def test_params_round_trip_byte_equal(embedder):
    jm = jred.RedcliffSCMLP(_config(embedder, tred.FORWARD_PASS_MODES[0]))
    tree = _np(jm.init(jax.random.PRNGKey(1)))
    back = interop.params_to_jax(interop.params_from_jax(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


_CHILD = r"""
import importlib, json, pkgutil, sys
import numpy as np
import redcliff_tpu_torch
names = [m.name for m in pkgutil.walk_packages(redcliff_tpu_torch.__path__,
                                               "redcliff_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from redcliff_tpu_torch.eval.model_io import load_model_for_eval
from redcliff_tpu_torch.interop import params_to_jax
model, params = load_model_for_eval(sys.argv[1], device="cpu")
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "redcliff_tpu" or m.startswith("redcliff_tpu."))
flat = {}
def walk(t, pre):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, pre + "/" + str(k))
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            walk(v, pre + "/" + str(i))
    else:
        flat[pre] = t
walk(params_to_jax(params), "")
np.savez(sys.argv[2], **flat)
print(json.dumps({"leaked": leaked, "modules": names,
                  "config": type(model.config).__module__}))
"""


def test_jax_artifact_loads_without_jax(tmp_path):
    """A JAX-written artifact loads in a process that imports every port
    module and never imports jax or the JAX package."""
    from redcliff_tpu.train.trainer import save_model

    jm = jred.RedcliffSCMLP(_config("DGCNN", tred.FORWARD_PASS_MODES[0]))
    jp = jm.init(jax.random.PRNGKey(2))
    save_model(str(tmp_path), jm, jp)
    out = tmp_path / "params.npz"
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp_path), str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert info["leaked"] == []
    assert info["config"] == "redcliff_tpu_torch.models.redcliff"
    assert "redcliff_tpu_torch.serve.service" in info["modules"]
    got = np.load(out)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np(jp)):
        key = "".join("/" + str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path)
        want[key] = leaf
    assert sorted(got.files) == sorted(want)
    for key, leaf in want.items():
        assert got[key].dtype == leaf.dtype
        assert got[key].tobytes() == leaf.tobytes(), key
    from redcliff_tpu_torch.train.trainer import load_model
    payload = load_model(str(tmp_path))
    assert payload["model_class"] == "RedcliffSCMLP"
    assert isinstance(payload["config"], tred.RedcliffSCMLPConfig)


def test_forbidden_class_is_refused(tmp_path):
    import pickle

    from redcliff_tpu_torch.runtime import checkpoint as ck

    path = str(tmp_path / "evil.bin")
    ck.write_checkpoint(path, {"x": np.zeros(2, np.float32)})
    assert ck.read_checkpoint(path)["x"].dtype == np.float32
    with open(path, "wb") as f:
        pickle.dump({"f": os.system}, f)
    with pytest.raises(ck.ForbiddenClassError, match="system"):
        ck.read_checkpoint(path)
