"""The port's evaluation layer (redcliff_tpu_torch/eval/*, the GC readout
``gc_as_lists``) against the JAX package on the CPU.

Every model is made by the JAX package's ``init`` (ROADMAP "parity by
copied weights") and written as an artifact by the JAX package; both
packages read the same artifact. Data and true graphs are made with numpy
from a seed. The model is tiny: 4 channels, 2 factors, gen_hidden (4,),
embed_lag 4, a DGCNN embedder of one graph-conv layer of 8 nodes or a
cEmbedder, read out under ``conditional_factor_fixed_embedder`` and
``fixed_factor_exclusive``. The host-only statistics are in
``tests/test_torch_eval_stats.py``.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.eval import cross_alg as jcross  # noqa: E402
from redcliff_tpu.eval import dynamic_readout as jdyn  # noqa: E402
from redcliff_tpu.eval import factor_scoring as jfs  # noqa: E402
from redcliff_tpu.eval import gc_estimates as jge  # noqa: E402
from redcliff_tpu.eval import grid_selection as jgs  # noqa: E402
from redcliff_tpu.eval import system_level as jsys  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.obs import quality as jquality  # noqa: E402
from redcliff_tpu.runtime import checkpoint as jckpt  # noqa: E402
from redcliff_tpu.train.trainer import save_model  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data import datasets as tds  # noqa: E402
from redcliff_tpu_torch.data.shards import save_cv_split  # noqa: E402
from redcliff_tpu_torch.eval import cross_alg as tcross  # noqa: E402
from redcliff_tpu_torch.eval import dynamic_readout as tdyn  # noqa: E402
from redcliff_tpu_torch.eval import factor_scoring as tfs  # noqa: E402
from redcliff_tpu_torch.eval import gc_estimates as tge  # noqa: E402
from redcliff_tpu_torch.eval import grid_selection as tgs  # noqa: E402
from redcliff_tpu_torch.eval import model_io as tio  # noqa: E402
from redcliff_tpu_torch.eval import system_level as tsys  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.obs import quality as tquality  # noqa: E402
from redcliff_tpu_torch.ops import factor_mix as FM  # noqa: E402
from redcliff_tpu_torch.train import redcliff_trainer as ttr  # noqa: E402
from redcliff_tpu_torch.utils.config import serialize_tensor_to_string  # noqa: E402,E501
from redcliff_tpu_torch.utils.precision import resolve_device  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALG = "REDCLIFF_S_CMLP"
C, K, L, EMBED_LAG = 4, 2, 2, 4

# GC readouts: f32 in both frameworks, another summation order (the
# ROADMAP bar, tests/test_precision_kernels.py:129); anything downstream
# of the DGCNN embed: sigmoid(10 x) magnifies input differences
TOL = dict(rtol=1e-5, atol=1e-6)
TOL_DGCNN = dict(rtol=1e-5, atol=1e-5)

EMBEDDERS = ("DGCNN", "cEmbedder")
MODES = ("conditional_factor_fixed_embedder", "fixed_factor_exclusive")
CASES = [(e, m) for e in EMBEDDERS for m in MODES]


def _config(embedder, mode):
    return jred.RedcliffSCMLPConfig(
        num_chans=C, gen_lag=L, gen_hidden=(4,), embed_lag=EMBED_LAG,
        embed_hidden_sizes=(8,), num_factors=K, num_supervised_factors=K,
        factor_score_embedder_type=embedder, dgcnn_num_graph_conv_layers=1,
        dgcnn_num_hidden_nodes=8, primary_gc_est_mode=mode,
        forward_pass_mode="apply_factor_weights_after_sim_completion",
        num_sims=1, training_mode="combined")


def _pair(embedder, mode, seed=0):
    """(JAX model, JAX numpy params, port model, port params)."""
    jcfg = _config(embedder, mode)
    jm = jred.RedcliffSCMLP(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm = tred.RedcliffSCMLP(
        tred.RedcliffSCMLPConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, interop.params_from_jax(jp, "cpu")


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _true_graphs(seed=3):
    """K binary (C, C, L) graphs, each with an edge and a non-edge."""
    rng = np.random.default_rng(seed)
    g = (rng.random((K, C, C, L)) < 0.35).astype(np.float64)
    g[:, 0, 1, 0], g[:, 1, 0, 0] = 1.0, 0.0
    return list(g)


def _switching_samples(n, T, seed, switch=6):
    """``n`` recordings (x (T, C), y (K, T)) of a VAR(L) whose state (one of
    K coefficient sets) switches every ``switch`` steps, one-hot labels."""
    rng = np.random.default_rng(seed)
    A = (rng.random((K, L, C, C)) < 0.4) * rng.normal(0.0, 0.3,
                                                        (K, L, C, C))
    A[:, 0] += 0.3 * np.eye(C)
    burn = 8
    out = []
    for _ in range(n):
        states = np.repeat(rng.integers(0, K, -(-T // switch)), switch)[:T]
        x = rng.normal(size=(burn + T, C))
        for t in range(L, burn + T):
            s = states[max(t - burn, 0)]
            x[t] += sum(A[s, l] @ x[t - 1 - l] for l in range(L))
        y = np.eye(K, dtype=np.float32)[states].T
        out.append((x[burn:].astype(np.float32), y))
    return out


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want)
    assert np.shape(got) == want.shape, (np.shape(got), want.shape)
    np.testing.assert_allclose(got, want, **tol)


def _same_tree(got, want, tol=None, only=None, path=""):
    """Equal structure; floats exactly equal, or within ``tol`` (at the
    paths holding ``only``, when given); None where the other has it."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], tol, only, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same_tree(a, b, tol, only, f"{path}/{i}")
    elif want is None or isinstance(want, str):
        assert got == want, (path, got, want)
    elif tol is None or (only is not None and only not in path):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, err_msg=path, **tol)


def _legacy_artifact(run_dir, jm, jp):
    """A headerless pickle of the artifact payload, as
    experiments/d4ic_grid_search.py writes one per grid point."""
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "final_best_model.bin"), "wb") as f:
        pickle.dump({"model_class": "RedcliffSCMLP", "config": jm.config,
                     "params": jp}, f)
    return str(run_dir)


# ------------------------------------------------------------- GC readouts
@pytest.mark.parametrize("embedder,mode", CASES)
def test_gc_as_lists_matches_jax(embedder, mode):
    """The host view of every readout the eval layer takes: the forced
    ``fixed_factor_exclusive``, the primary mode on windows, and the
    conditional factor readout of the dynamic eval, lagged and not."""
    jm, jp, tm, tp = _pair(embedder, mode)
    X = _x(1, 5, jm.config.max_lag, C)
    for gmode in ("fixed_factor_exclusive", mode,
                  "conditional_factor_exclusive"):
        for ignore_lag in (False, True):
            kw = dict(threshold=False, ignore_lag=ignore_lag,
                      combine_wavelet_representations=True,
                      rank_wavelets=False)
            want = jm.gc_as_lists(jp, gc_est_mode=gmode, X=X, **kw)
            got = tm.gc_as_lists(tp, gc_est_mode=gmode,
                                 X=torch.from_numpy(X), **kw)
            tol = TOL_DGCNN if ("conditional" in gmode
                                and embedder == "DGCNN") else TOL
            assert len(got) == len(want)
            for gs, ws in zip(got, want):
                assert len(gs) == len(ws)
                for g, w in zip(gs, ws):
                    assert isinstance(g, np.ndarray)
                    _close(g, w, tol)


@pytest.mark.parametrize("embedder,mode", CASES)
def test_gc_estimates_summaries_and_scores_match_jax(embedder, mode):
    jm, jp, tm, tp = _pair(embedder, mode, seed=1)
    want = jge.get_model_gc_estimates(jm, jp, ALG, K)
    got = tge.get_model_gc_estimates(tm, tp, ALG, K)
    assert len(got) == len(want) == K
    for g, w in zip(got, want):
        _close(g, w, TOL)
    for g, w in zip(tge.get_model_gc_summary_matrices(tm, tp, ALG, K),
                    jge.get_model_gc_summary_matrices(jm, jp, ALG, K)):
        assert g.dtype == np.float32 and g.shape == (C, C)
        _close(g, w, TOL)
    X = _x(2, 1, jm.config.max_lag, C)
    _close(tge.get_model_gc_score_estimates(tm, tp, ALG, K, X=X),
           jge.get_model_gc_score_estimates(jm, jp, ALG, K, X=X),
           TOL_DGCNN if embedder == "DGCNN" else TOL)
    est = [_x(3, C, C, L), _x(4, C, C, L)]
    for g, w in zip(
            tge.get_combined_gc_representations_across_factors(
                est, _true_graphs()),
            jge.get_combined_gc_representations_across_factors(
                est, _true_graphs())):
        np.testing.assert_array_equal(g, w)


def test_other_families_raise_citing_the_roadmap():
    """The DCSFA-NMF and DYNOTEARS readouts (which raised until their
    models were ported) equal the JAX package's on the same weights and
    solver state; an unknown family still raises."""
    from redcliff_tpu.models import dcsfa_nmf as jdc
    from redcliff_tpu.models import dynotears as jdy
    from redcliff_tpu_torch.models import dcsfa_nmf as tdc
    from redcliff_tpu_torch.models import dynotears as tdy

    kw = dict(num_nodes=C, num_high_level_node_features=2,
              gc_feature_layout="dirspec", n_components=K,
              n_sup_networks=K, h=8)
    jm, tm = jdc.FullDCSFAModel(**kw), tdc.FullDCSFAModel(**kw)
    jp, js = jm.init(jax.random.PRNGKey(5), jm.dim_in)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp))
    ts = interop.params_from_jax(jax.tree.map(np.asarray, js))
    got = tge.get_model_gc_estimates(tm, tp, "DCSFA", K)
    want = jge.get_model_gc_estimates(jm, jp, "DCSFA", K)
    assert len(got) == len(want) == K
    for g, w in zip(got, want):
        _close(g, np.asarray(w), TOL)
    x = np.abs(_x(6, 1, jm.dim_in))
    _close(tge.get_model_gc_score_estimates(tm, tp, "DCSFA", K, X=x,
                                            state=ts),
           jge.get_model_gc_score_estimates(jm, jp, "DCSFA", K, X=x,
                                            state=js), TOL)
    a = _x(7, C, C)
    for mt in ("DYNOTEARS_Vanilla", "DYNOTEARS_Stochastic"):
        jd, td = jdy.DynotearsVanillaModel(), tdy.DynotearsVanillaModel()
        jd.a_est, td.a_est = a, a.copy()
        for g, w in zip(tge.get_model_gc_estimates(td, None, mt, K),
                        jge.get_model_gc_estimates(jd, None, mt, K)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            tge.get_model_gc_score_estimates(td, None, mt, K),
            jge.get_model_gc_score_estimates(jd, None, mt, K))
    _, _, tm, tp = _pair(*CASES[0])
    for fn in (tge.get_model_gc_estimates, tge.get_model_gc_score_estimates):
        with pytest.raises(NotImplementedError, match="unrecognized"):
            fn(tm, tp, "MYSTERY", K)


@pytest.mark.parametrize("embedder,mode", CASES)
def test_quality_summary_equals_gc_summary_matrices(embedder, mode):
    """The golden parity of tests/test_quality.py, within the port: the
    live summary's per-factor lag-summed matrices and column norms equal
    the offline summary matrices within 1e-6, with identical top-k edge
    sets."""
    _, _, tm, tp = _pair(embedder, mode, seed=2)
    Xw = torch.from_numpy(_x(5, 8, tm.config.max_lag, C))
    live = tquality.make_summary_fn(tm, k=6)(tp, Xw)
    offline = tge.get_model_gc_summary_matrices(tm, tp, "REDCLIFF", K)
    np.testing.assert_allclose(live["gc"].numpy(), np.stack(offline),
                               atol=1e-6)
    np.testing.assert_allclose(
        live["col_norms"].numpy(),
        np.stack([np.linalg.norm(m, axis=0) for m in offline]), atol=1e-6)
    combined = np.sum(offline, axis=0)
    assert ({int(i) for i in live["topk_idx"]}
            == {int(i) for i in jquality.topk_indices_np(combined, 6)})


# ------------------------------------------------------ cross-algorithm eval
@pytest.mark.parametrize("embedder,mode", CASES)
def test_evaluate_algorithm_on_fold_matches_jax(tmp_path, embedder, mode):
    """The optimal-F1 battery of one grid point's artifact, written as
    experiments/d4ic_grid_search.py writes it: F1s, AUCs and their
    summaries equal, thresholds (GC values) at the readout bar."""
    jm, jp, _, _ = _pair(embedder, mode, seed=3)
    run_dir = _legacy_artifact(tmp_path / "grid_point0", jm, jp)
    want = jcross.evaluate_algorithm_on_fold(run_dir, ALG, _true_graphs())
    got = tcross.evaluate_algorithm_on_fold(run_dir, ALG, _true_graphs(),
                                            device="cpu")
    _same_tree(got, want, TOL, only="decision_threshold")


def test_cross_algorithm_comparison_matches_jax(tmp_path):
    """Two folds of one dataset through run_cross_algorithm_comparison:
    the same summaries, and the same pickles on disk."""
    truth = {}
    root = tmp_path / "REDCLIFF_S_CMLP_models"
    for fold in range(2):
        jm, jp, _, _ = _pair("DGCNN", MODES[0], seed=10 + fold)
        save_model(str(root / f"d4IC_fold{fold}_run"), jm, jp)
        truth[fold] = _true_graphs(seed=20 + fold)
    want = jcross.run_cross_algorithm_comparison(
        [str(root)], {"d4IC": truth}, str(tmp_path / "jax"), 2)
    got = tcross.run_cross_algorithm_comparison(
        [str(root)], {"d4IC": truth}, str(tmp_path / "port"), 2,
        device="cpu")
    _same_tree(got, want, TOL, only="decision_threshold")
    with open(tmp_path / "port" / "full_comparrisson_summary.pkl",
              "rb") as f:
        _same_tree(pickle.load(f), want, TOL, only="decision_threshold")
    assert os.path.isfile(tmp_path / "port" / "cv_d4IC" /
                          "results_summary.pkl")


def test_best_model_name_reads_a_legacy_pickle(tmp_path):
    jm, jp, _, _ = _pair("cEmbedder", MODES[1], seed=4)
    run_dir = tmp_path / "run"
    _legacy_artifact(run_dir, jm, jp)
    os.replace(run_dir / "final_best_model.bin", run_dir / "point.pkl")
    model, params = tio.load_model_for_eval(str(run_dir), device="cpu",
                                            best_model_name="point.pkl")
    assert model.config.num_factors == K
    for a, b in zip(jax.tree.leaves(interop.params_to_jax(params)),
                    jax.tree.leaves(jp)):
        assert a.tobytes() == b.tobytes()
    # unnamed, the lone pickle is found as the JAX package finds it
    # (ROADMAP queue 3 item 11); a second loose pickle is ambiguous
    _, params = tio.load_model_for_eval(str(run_dir), device="cpu")
    for a, b in zip(jax.tree.leaves(interop.params_to_jax(params)),
                    jax.tree.leaves(jp)):
        assert a.tobytes() == b.tobytes()
    os.link(run_dir / "point.pkl", run_dir / "other.pkl")
    with pytest.raises(FileNotFoundError):
        tio.load_model_for_eval(str(run_dir), device="cpu")


# --------------------------------------------------------- dynamic readouts
@pytest.mark.parametrize("embedder,history,label_align", [
    ("DGCNN", None, "last"), ("cEmbedder", None, "last"),
    ("DGCNN", 6, "majority"), ("cEmbedder", 6, "center")])
def test_dynamic_readouts_match_jax(tmp_path, embedder, history,
                                    label_align):
    """State tracking and conditional-graph tracking over seeded switching
    recordings: the embedder's window (and, with history 6, windows trimmed
    to it around the label anchor)."""
    jm, jp, _, _ = _pair(embedder, MODES[0], seed=5)
    save_model(str(tmp_path), jm, jp)
    samples = _switching_samples(3, 24, seed=6)
    kw = dict(history=history, label_align=label_align)
    want = jdyn.evaluate_dynamic_readouts_on_fold(
        str(tmp_path), ALG, _true_graphs(), samples, K, **kw)
    got = tdyn.evaluate_dynamic_readouts_on_fold(
        str(tmp_path), ALG, _true_graphs(), samples, K, device="cpu", **kw)
    assert all(len(v) for v in want.values())
    _same_tree(got, want, TOL_DGCNN)


@pytest.mark.parametrize("embedder", EMBEDDERS)
def test_conditional_history_is_one_graph_mix(embedder, monkeypatch):
    """The factor sum of the conditional readout equals the JAX einsum
    summed over factors, and goes through graph_mix (the factor-mix kernel
    on the card) once, with the embedder's weightings and the (K, C, C)
    factor graphs, contiguous."""
    jm, jp, tm, tp = _pair(embedder, MODES[0], seed=6)
    windows = _x(7, 20, EMBED_LAG, C)
    calls = []
    real = FM.graph_mix

    def spy(w, g):
        calls.append((tuple(w.shape), tuple(g.shape), w.is_contiguous(),
                      g.is_contiguous()))
        return real(w, g)

    monkeypatch.setattr(tdyn, "graph_mix", spy)
    got = tdyn._redcliff_conditional_history(tm, tp,
                                             torch.from_numpy(windows))
    want = jdyn._redcliff_conditional_history(jm, jp, windows)
    _close(got, want, TOL_DGCNN if embedder == "DGCNN" else TOL)
    assert calls == [((20, K), (K, C, C), True, True)]


def test_graph_mix_takes_the_readout_shape():
    """The layout and launch plan of the card's readout launch at the
    smoke's shape: 240 windows, 5 factors, 10 channels (M = 100), the
    graphs broadcast over the windows."""
    w = torch.rand(240, 5)
    g = torch.rand(5, 10, 10)
    S, Kk, M, sk, sb, out = FM._graph_layout(w, g)
    assert (S, Kk, M, sk, sb, out) == (240, 5, 100, 100, 0, (240, 10, 10))
    vec, threads, blocks = FM.mix_plan(S, M, sk, sb, 0)
    assert vec == 4 and threads * blocks * vec >= S * M
    assert threads * (blocks - 1) * vec < S * M


@pytest.mark.parametrize("embedder", EMBEDDERS)
def test_factor_scoring_matches_jax(embedder, tmp_path):
    jm, jp, tm, tp = _pair(embedder, MODES[0], seed=7)
    samples = _switching_samples(4, 20, seed=8, switch=20)
    ds = types.SimpleNamespace(X=[x for x, _ in samples],
                               Y=[y for _, y in samples])
    args = (K, 20 - EMBED_LAG, EMBED_LAG)
    want = jfs.average_factor_scoring_by_state(jm, jp, ds, *args)
    got = tfs.average_factor_scoring_by_state(tm, tp, ds, *args)
    assert sum(s["count"] for s in want.values()) == 4
    _same_tree(got, want, TOL_DGCNN if embedder == "DGCNN" else TOL)
    summary = tfs.evaluate_avg_factor_scoring_across_recordings(
        tm, tp, ds, *args, save_root_path=str(tmp_path / "scores"))
    _same_tree(summary, got)


# ------------------------------------------------------------- system level
def test_fold_system_level_matches_jax():
    """The similarity battery on both views, with every option the
    drivers pass (host only: the same numpy inputs)."""
    est = [np.abs(_x(30 + k, C, C, L)).astype(np.float64) for k in range(K)]
    truth = _true_graphs()
    for opts in ({}, {"sort_unsupervised_ests": True,
                      "exclude_self_connections": True},
                 {"evaluate_identity_baseline": True},
                 {"average_estimated_graphs_together": True}):
        t = truth[:1] if opts.get("average_estimated_graphs_together") \
            else truth
        _same_tree(tsys.evaluate_fold_system_level(est, t, **opts),
                   jsys.evaluate_fold_system_level(est, t, **opts))


def test_system_level_gs_and_cv_match_jax(tmp_path):
    """Both drivers over a root of two runs from JAX-written artifacts and
    a data cached-args file with the true graphs."""
    root = tmp_path / "runs"
    for fold, emb in enumerate(EMBEDDERS):
        jm, jp, _, _ = _pair(emb, MODES[fold], seed=40 + fold)
        save_model(str(root / f"toy_fold{fold}"), jm, jp)
    truth = _true_graphs()
    args = []
    for fold in range(2):
        p = tmp_path / f"toy_fold{fold}_cached_args.txt"
        with open(p, "w") as f:
            json.dump({"data_root_path": "unused", "num_channels": str(C),
                       **{f"net{k + 1}_adjacency_tensor":
                          serialize_tensor_to_string(g)
                          for k, g in enumerate(truth)}}, f)
        args.append(str(p))
    want = jsys.evaluate_system_level_gs(ALG, str(root), truth,
                                         str(tmp_path / "jgs"))
    got = tsys.evaluate_system_level_gs(ALG, str(root), truth,
                                        str(tmp_path / "tgs"), device="cpu")
    _same_tree(got, want, TOL)
    want = jsys.evaluate_system_level_cv(ALG, str(root), ["toy"], args,
                                         str(tmp_path / "jcv"))
    got = tsys.evaluate_system_level_cv(ALG, str(root), ["toy"], args,
                                        str(tmp_path / "tcv"), device="cpu")
    _same_tree(got, want, TOL)


# ---------------------------------------------------------- grid selection
def _meta(rng, epochs, dict_layout):
    """A training-meta dict in the trackers' layout (per-factor lists of
    per-epoch values), seeded histories."""
    per = lambda: [list(rng.random(epochs)) for _ in range(K)]  # noqa: E731
    cos = {f"factor_{k}": list(rng.random(epochs)) for k in range(K)}
    return {"avg_forecasting_loss": list(rng.random(epochs)),
            "avg_factor_loss": list(rng.random(epochs)),
            "avg_fw_l1_penalty": list(rng.random(epochs)),
            "roc_auc_histories": {0.0: per()},
            "roc_auc_OffDiag_histories": {0.0: per()},
            "gc_factor_l1_loss_histories": per(),
            "gc_factor_cosine_sim_histories": cos if dict_layout
            else list(cos.values())}


def test_select_best_models_matches_jax(tmp_path):
    """Three run dirs, one fitted by the port's trainer, two with metas
    written by the JAX package (both history layouts), and one incomplete
    run: the same ranking, best run and best epoch under every criterion
    in both packages."""
    root = tmp_path / "grid"
    jm, jp, tm, _ = _pair("cEmbedder", MODES[1], seed=8)
    cfg = dataclasses.replace(tm.config, training_mode=(
        "pretrain_embedder_then_combined"), num_pretrain_epochs=1)
    samples = _switching_samples(12, 12, seed=9, switch=12)
    X = np.stack([x for x, _ in samples])[:, :jm.config.max_lag + 1]
    Y = np.stack([y[:, :1] for _, y in samples])
    ttr.RedcliffTrainer(tred.RedcliffSCMLP(cfg), ttr.RedcliffTrainConfig(
        batch_size=4, max_iter=3, check_every=1, lookback=5),
        device="cpu").fit(jp, tds.ArrayDataset(X[:8], Y[:8]),
                          tds.ArrayDataset(X[8:], Y[8:]),
                          true_GC=_true_graphs(), save_dir=str(root / "a"))
    rng = np.random.default_rng(10)
    name = "training_meta_data_and_hyper_parameters.pkl"
    for run, meta in (("b", _meta(rng, 3, True)), ("c", _meta(rng, 4, False)),
                      ("d", {"avg_forecasting_loss": [1.0]})):
        os.makedirs(root / run)
        jckpt.write_checkpoint(str(root / run / name), meta)
    criteria = ("forecasting_loss", "factor_loss", "gc_cosine_sim_history",
                "roc_auc", "roc_auc_OffDiag", "gc_l1_history",
                "forecasting_loss_and_factor_loss_and_gc_cosine_sim_history")
    want = jgs.select_best_models(str(root), criteria)
    got = tgs.select_best_models(str(root), criteria)
    assert got == want
    assert {r[0] for r in got["factor_loss"]["ranking"]} == {"a", "b", "c"}
    _same_tree(tgs.load_grid_summaries(str(root)),
               jgs.load_grid_summaries(str(root)))


# ---------------------------------------------------------------- devices
def _entry_points(tmp_path):
    """Each eval entry point that loads a model, called with no device,
    on inputs that reach the load."""
    jm, jp, _, _ = _pair("DGCNN", MODES[0], seed=11)
    alg_root = tmp_path / "REDCLIFF_S_CMLP_models"
    run = alg_root / "data_fold0_run"
    save_model(str(run), jm, jp)
    samples = _switching_samples(1, 12, seed=12)
    save_cv_split([list(s) for s in samples], [list(s) for s in samples], 0,
                  str(tmp_path / "data"))
    data_args = tmp_path / "data" / "fold_0" / "data_fold0_cached_args.txt"
    with open(data_args, "w") as f:
        json.dump({"data_root_path": "unused", "num_channels": str(C),
                   **{f"net{k + 1}_adjacency_tensor":
                      serialize_tensor_to_string(g)
                      for k, g in enumerate(_true_graphs())}}, f)
    truth = _true_graphs()
    out = str(tmp_path / "out")
    return {
        "evaluate_algorithm_on_fold": lambda: tcross.evaluate_algorithm_on_fold(
            str(run), ALG, truth),
        "run_cross_algorithm_comparison":
            lambda: tcross.run_cross_algorithm_comparison(
                [str(alg_root)], {"data": {0: truth}}, out, 1),
        "evaluate_dynamic_readouts_on_fold":
            lambda: tdyn.evaluate_dynamic_readouts_on_fold(
                str(run), ALG, truth, samples, K),
        "run_dynamic_readout_evaluation":
            lambda: tdyn.run_dynamic_readout_evaluation(
                {ALG: str(alg_root)}, {0: str(data_args)}, {0: truth}, 1, K,
                out),
        "evaluate_system_level_cv": lambda: tsys.evaluate_system_level_cv(
            ALG, str(alg_root), ["data"], [str(data_args)], out),
        "evaluate_system_level_gs": lambda: tsys.evaluate_system_level_gs(
            ALG, str(alg_root), truth, out),
    }


@pytest.mark.parametrize("entry", [
    "evaluate_algorithm_on_fold", "run_cross_algorithm_comparison",
    "evaluate_dynamic_readouts_on_fold", "run_dynamic_readout_evaluation",
    "evaluate_system_level_cv", "evaluate_system_level_gs"])
def test_entry_points_ask_for_cuda_by_default(tmp_path, monkeypatch, entry):
    """Without a device they resolve ``cuda`` and raise when there is no
    card; nothing goes on on the CPU. The host-only entry points run."""
    fns = _entry_points(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fns[entry]()
    assert tgs.select_best_models(str(tmp_path)) == {
        c: {"ranking": [], "best_run": None, "best_epoch": None}
        for c in ("forecasting_loss", "factor_loss", "gc_cosine_sim_history",
                  "forecasting_loss_and_factor_loss_and_gc_cosine_sim_history")}


def test_eval_imports_and_runs_with_jax_blocked(tmp_path):
    """``redcliff_tpu_torch.eval``, the grid's epoch engine
    (``parallel/epoch_engine.py``), the DCSFA-NMF / DYNOTEARS modules
    (features, models, loader, dispatch), the Table-2 discovery stack
    (tidybench, PCMCI, supervised discovery), the analysis layer, plotting
    and the time-series transformer import and run, and the eval scores a
    JAX-written artifact, in a process where importing jax fails; no module
    of the JAX package is loaded."""
    jm, jp, _, _ = _pair("DGCNN", MODES[0], seed=13)
    save_model(str(tmp_path / "run"), jm, jp)
    code = f"""
import sys
sys.modules["jax"] = None
import numpy as np
import redcliff_tpu_torch.eval as E
import redcliff_tpu_torch.parallel.epoch_engine as EE
assert EE.EpochEngine and EE.Program
# the DCSFA-NMF / DYNOTEARS slice: features, models, loader, dispatch
import redcliff_tpu_torch.data.shards as SH
import redcliff_tpu_torch.models.dcsfa_nmf as DC
import redcliff_tpu_torch.models.dynotears as DY
import redcliff_tpu_torch.train.orchestration as OR
import redcliff_tpu_torch.utils.directed_spectrum as DS
import redcliff_tpu_torch.utils.time_series as TS
w = np.random.default_rng(1).normal(size=(2, 24, 3)).astype(np.float32)
feats = SH.apply_signal_format(w, "directed_spectrum vanilla", 16, {{
    "fs": 1000, "min_freq": 0.0, "max_freq": 250.0,
    "directed_spectrum": True, "csd_params": {{"nperseg": 8,
                                              "noverlap": 4}}}})
assert feats.shape[0] == 2 and DC.nmf_fit(
    feats, 2, max_iter=2, device="cpu")[1].shape == (2, feats.shape[1])
assert DY.dynotears_solve(w[0, :-1], w[0, 1:], max_iter=2).a_mat.shape \
    == (3, 3)
assert OR.create_model_instance and DS.get_directed_spectrum and TS.swt
# the Table-2 discovery stack, the analysis layer, plotting and the
# time-series transformer: every module imports, one discovery flow, one
# analysis table and one transformer forward run
import torch
import redcliff_tpu_torch.models as M
import redcliff_tpu_torch.tidybench as TB
import redcliff_tpu_torch.tidybench.native as NAT
import redcliff_tpu_torch.eval.analysis as AN
import redcliff_tpu_torch.eval.supervised_discovery as SD
import redcliff_tpu_torch.models.pcmci as PC
import redcliff_tpu_torch.models.ts_transformer as TST
import redcliff_tpu_torch.utils.plotting as PL
assert TB.slarac and TB.qrbs and TB.lasar and NAT.build_library and PC.rpcmci
assert SD.run_d4ic_regime_pcmci_experiment and PL.plot_heatmap and M.CMLPFM
rng = np.random.default_rng(4)
samples = [(rng.normal(size=(40, 3)), np.repeat(np.eye(2)[i % 2][:, None],
                                                40, 1)) for i in range(4)]
truth = [np.eye(3)[:, ::-1, None], np.eye(3)[::-1, :, None]]
res = E.run_supervised_discovery_evaluation(
    samples, truth, algorithms=("slarac", "selvar", "PCMCI"))
assert sorted(res) == ["PCMCI", "selvar", "slarac"]
vals = {{"cv": {{AN.OFFDIAG_PARADIGM: {{"A": {{
    "f1_vals_across_factors": [0.5, 0.7]}}}}}}}}
table = E.summarize_ablations({{"full": vals, "v": vals}}, "full")
assert table["v"]["full_minus_variant_mean"] == 0.0
cfg = TST.TSTransformerConfig(feat_dim=3, max_len=8, d_model=8, n_heads=2,
                              num_layers=1, dim_feedforward=8, num_classes=2)
clf = TST.TSTransformerEncoderClassiregressor(cfg)
logits = clf.forward(clf.init(torch.Generator().manual_seed(0), "cpu"),
                     torch.zeros((2, 8, 3)))
assert logits.shape == (2, 2)
graphs = list((np.random.default_rng(3).random(({K}, {C}, {C}, {L}))
               < 0.35).astype(float))
stats = E.evaluate_algorithm_on_fold({str(tmp_path / "run")!r}, "{ALG}",
                                     graphs, device="cpu")
assert "factor_0" in stats
leaked = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith("jax.")) and sys.modules[m]
                or m == "redcliff_tpu" or m.startswith("redcliff_tpu."))
print("LEAKED", leaked)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout


@pytest.mark.gpu
def test_conditional_history_on_card_matches_cpu():
    """The dynamic readout's conditional history on the card (the
    factor-mix kernel through graph_mix) against the port's CPU path, at
    the readout's shape of the smoke's width (240 windows, 5 factors,
    10 channels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg = tred.RedcliffSCMLPConfig(
        num_chans=10, gen_lag=4, gen_hidden=(25,), embed_lag=16,
        embed_hidden_sizes=(0,), num_factors=5, num_supervised_factors=5,
        factor_score_embedder_type="DGCNN", dgcnn_num_graph_conv_layers=3,
        dgcnn_num_hidden_nodes=100, num_sims=1, training_mode="combined")
    model = tred.RedcliffSCMLP(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    windows = torch.from_numpy(_x(14, 240, 16, 10))
    want = tdyn._redcliff_conditional_history(model, params, windows)
    dev = resolve_device("cuda")  # full float32 on the card
    before = FM.factor_mix.launches
    got = tdyn._redcliff_conditional_history(
        model, interop.tree_map(lambda t: t.to(dev), params),
        windows.to(dev))
    assert FM.factor_mix.launches == before + 1
    # downstream of the DGCNN embed on two devices
    np.testing.assert_allclose(got, want, **TOL_DGCNN)
