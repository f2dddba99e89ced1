"""The port's host-only evaluation pieces (redcliff_tpu_torch/eval/{stats,
causal_distances,edge_dynamics,summaries}.py, the true-graph reader of
eval/cross_alg.py and the eval halves of
utils/{metrics,misc,config}.py) against the JAX package's, on the same
numpy inputs made from a seed: exact equality (the same numpy code).
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from redcliff_tpu.eval import causal_distances as jcd  # noqa: E402
from redcliff_tpu.eval import cross_alg as jcross  # noqa: E402
from redcliff_tpu.eval import edge_dynamics as jed  # noqa: E402
from redcliff_tpu.eval import stats as jst  # noqa: E402
from redcliff_tpu.eval import summaries as jsum  # noqa: E402
from redcliff_tpu.utils import config as jconfig  # noqa: E402
from redcliff_tpu.utils import metrics as jmet  # noqa: E402
from redcliff_tpu.utils import misc as jmisc  # noqa: E402
from redcliff_tpu_torch.eval import causal_distances as tcd  # noqa: E402
from redcliff_tpu_torch.eval import cross_alg as tcross  # noqa: E402
from redcliff_tpu_torch.eval import edge_dynamics as ted  # noqa: E402
from redcliff_tpu_torch.eval import stats as tst  # noqa: E402
from redcliff_tpu_torch.eval import summaries as tsum  # noqa: E402
from redcliff_tpu_torch.utils import config as tconfig  # noqa: E402
from redcliff_tpu_torch.utils import metrics as tmet  # noqa: E402
from redcliff_tpu_torch.utils import misc as tmisc  # noqa: E402


def _same(got, want, path=""):
    """Equal structure and exactly equal values (NaN where the other has
    NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}/{i}")
    elif want is None or isinstance(want, str):
        assert got == want, (path, got, want)
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


def _dag(rng, n, p=0.4):
    """A random DAG: strictly upper-triangular under a random order."""
    A = np.triu(rng.random((n, n)) < p, k=1).astype(float)
    perm = rng.permutation(n)
    return A[np.ix_(perm, perm)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("direction", ["from row to column",
                                       "from column to row"])
def test_causal_distances_match_jax(seed, direction):
    rng = np.random.default_rng(seed)
    true_A, guess_A = _dag(rng, 6), _dag(rng, 6)
    for name in ("shd", "parent_aid", "ancestor_aid", "oset_aid"):
        assert getattr(tcd, name)(true_A, guess_A, direction) == \
            getattr(jcd, name)(true_A, guess_A, direction)
    cyclic = true_A.copy()
    cyclic[0, 1] = cyclic[1, 0] = 1.0
    for mod in (tcd, jcd):
        with pytest.raises(ValueError, match="cycle"):
            mod.parent_aid(cyclic, guess_A, direction)


def _graph_pair(seed, n=5):
    rng = np.random.default_rng(seed)
    est = rng.random((n, n))
    true = (rng.random((n, n)) < 0.4).astype(float)
    true[0, 1], true[1, 0] = 1.0, 0.0
    return est, true


@pytest.mark.parametrize("fn", [
    "compute_optimal_f1_stats", "compute_fixed_f1_stats",
    "compute_key_stats", "compute_graph_comparison_stats",
    "three_view_optimal_f1_stats"])
def test_stats_battery_matches_jax(fn):
    for seed in range(3):
        est, true = _graph_pair(seed)
        _same(getattr(tst, fn)(est, true), getattr(jst, fn)(est, true))
    # the gating: homogeneous estimates and labels score nothing
    assert tst.compute_optimal_f1_stats(np.ones((3, 3)), true[:3, :3]) == {}
    assert tst.compute_key_stats(est, np.zeros_like(est)) == {}
    vals = [0.1, None, 0.7, 0.4]
    _same(tst.summarize_values(vals), jst.summarize_values(vals))
    _same(tst.summarize_values([None]), jst.summarize_values([None]))


def _histories(seed, T=30, C=4):
    rng = np.random.default_rng(seed)
    true = np.repeat((rng.random((3, C, C)) < 0.5).astype(float), T // 3,
                     axis=0) * rng.random((T, C, C))
    est = true + 0.3 * rng.random((T, C, C))
    return est, true


@pytest.mark.parametrize("windows", [(1,), (1, 5, 10)])
@pytest.mark.parametrize("bug", [False, True])
def test_evaluate_dynamic_graph_estimates_matches_jax(windows, bug):
    est, true = _histories(4)
    kw = dict(smoothing_window_sizes=windows, match_reference_bug=bug)
    _same(ted.evaluate_dynamic_graph_estimates(est, true, **kw),
          jed.evaluate_dynamic_graph_estimates(est, true, **kw))
    for paradigm in ("PearsonCorrelation", "SpearmanCorrelation"):
        _same(ted.compute_edge_rank_performance_v1_stats(paradigm, est,
                                                         true, 2),
              jed.compute_edge_rank_performance_v1_stats(paradigm, est,
                                                         true, 2))
    for mod in (ted, jed):  # the edge-lock family is Pearson only
        with pytest.raises(NotImplementedError):
            mod.evaluate_dynamic_graph_estimates(
                est, true, stat_paradigm="SpearmanCorrelation")
    h1, h2 = est[:, 0, 1], true[:, 0, 1]
    for fn in ("compute_key_covariance_stats_betw_two_score_histories",):
        _same(getattr(ted, fn)(h1, h2, match_reference_bug=bug),
              getattr(jed, fn)(h1, h2, match_reference_bug=bug))
    for fn in ("compute_key_spearman_correlation_stats_betw_two_score_histories",
               "compute_key_correlation_stats_betw_two_score_histories",
               "compute_key_stats_betw_two_gc_score_vecs"):
        _same(getattr(ted, fn)(h1, h2), getattr(jed, fn)(h1, h2))


def test_metrics_and_misc_match_jax():
    rng = np.random.default_rng(5)
    A, B = rng.random((5, 5)), rng.random((5, 5))
    labels = (rng.random(25) < 0.4).astype(int)
    scores = rng.random(25)
    for fn, args in (
            ("precision_recall_curve", (labels, scores)),
            ("compute_optimal_f1", (labels, scores)),
            ("compute_f1", (labels, scores, 0.5)),
            ("confusion_counts", (labels, scores, 0.5)),
            ("compute_sensitivity", (labels, scores, 0.5)),
            ("compute_specificity", (labels, scores, 0.5)),
            ("compute_positive_likelihood_ratio", (labels, scores, 0.3)),
            ("compute_negative_likelihood_ratio", (labels, scores, 0.3)),
            ("compute_mse", (A, B)),
            ("compute_cosine_similarity", (A, B)),
            ("get_f1_score", (A - 0.5, B - 0.5))):
        _same(getattr(tmet, fn)(*args), getattr(jmet, fn)(*args), fn)
    for fn, args in (
            ("normalize_array", (A,)),
            ("mask_diag_elements", (A,))):
        _same(getattr(tmisc, fn)(*args), getattr(jmisc, fn)(*args), fn)


def test_true_graph_readers_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    graphs = [(rng.random((4, 4, 3)) < 0.4).astype(float) for _ in range(3)]
    path = tmp_path / "toy_fold0_cached_args.txt"
    with open(path, "w") as f:
        json.dump({"data_root_path": "unused", "num_channels": "4",
                   **{f"net{k + 1}_adjacency_tensor":
                      tconfig.serialize_tensor_to_string(g)
                      for k, g in enumerate(graphs)}}, f)
    got = tconfig.load_true_gc_factors(str(path))
    _same(got, jconfig.load_true_gc_factors(str(path)))
    _same(got, graphs)
    _same(tcross.read_in_true_causal_graphs_for_all_datasets(
              ["toy", "toy"], [str(path)] * 2),
          jcross.read_in_true_causal_graphs_for_all_datasets(
              ["toy", "toy"], [str(path)] * 2))
    for model_type in ("REDCLIFF_S_CMLP", "DGCNN", ""):
        for factors in (False, True):
            args = {"model_type": model_type,
                    "data_cached_args_file": str(path)}
            kw = dict(read_in_gc_factors_for_eval=factors)
            _same(tconfig.read_in_data_args(dict(args), **kw),
                  jconfig.read_in_data_args(dict(args), **kw))


def test_summaries_match_jax(tmp_path):
    """The headline off-diagonal F1 table of a comparison summary, and the
    CSV report (no figure: the port has no plotting module yet)."""
    rng = np.random.default_rng(7)
    par = jsum.OFFDIAG_PARADIGM
    full = {d: {par: {a: {f"f1_{s}_across_factors": float(rng.random())
                          for s in ("mean", "median", "mean_std_err")}
                      for a in ("REDCLIFF_S_CMLP", "DGCNN")}}
            for d in ("d4IC", "synSys")}
    _same(tsum.summarize_off_diag_f1(full), jsum.summarize_off_diag_f1(full))
    _same(tsum.write_cross_experiment_report(full, str(tmp_path / "t")),
          jsum.write_cross_experiment_report(full, str(tmp_path / "j"),
                                             plot=False))
    name = f"{par}__f1_mean_across_factors.csv"
    assert (tmp_path / "t" / name).read_text() == \
        (tmp_path / "j" / name).read_text()
