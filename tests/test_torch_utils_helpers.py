"""The public helpers of ``utils/{config,metrics,misc}.py`` that no module
of either package calls, copied into the port as host numpy code: each
against the JAX package's function on seeded numpy inputs, bit for bit
(``np.testing.assert_array_equal`` on the float values), and the data
reader's ``include_gc_views_for_eval=True`` views on a curated fold's
cached-args file.
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from redcliff_tpu.data import curation as jcuration  # noqa: E402
from redcliff_tpu.utils import config as jconfig  # noqa: E402
from redcliff_tpu.utils import metrics as jmetrics  # noqa: E402
from redcliff_tpu.utils import misc as jmisc  # noqa: E402
from redcliff_tpu_torch.utils import config as tconfig  # noqa: E402
from redcliff_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from redcliff_tpu_torch.utils import misc as tmisc  # noqa: E402


@pytest.fixture(autouse=True)
def _restore_global_rngs():
    """Curation runs the graph factory, which seeds ``random`` and
    ``np.random`` globally: leave both as they were."""
    import random

    py_state, np_state = random.getstate(), np.random.get_state()
    yield
    random.setstate(py_state)
    np.random.set_state(np_state)


def _same(got, want):
    """Equal structure, equal values: arrays bit for bit, floats equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want)
        np.testing.assert_array_equal(got, want)


def _graphs(rng, n=4, shape=(6, 6, 2)):
    return [rng.uniform(0.05, 1.0, size=shape) for _ in range(n)]


# (module, name, inputs(rng) -> list of (args, kwargs))
CASES = {
    "pairwise_cosine_similarities": ("metrics", lambda r: [
        ((_graphs(r),), {}), ((_graphs(r),), {"include_diag": False}),
        ((_graphs(r, 3, (5, 5)),), {"include_diag": False}),
        ((_graphs(r, 1),), {})]),
    "l1_norm_difference": ("metrics", lambda r: [
        ((r.normal(size=(6, 6, 2)), r.normal(size=(6, 6, 2))), {}),
        ((r.normal(size=(4, 4)), np.zeros((4, 4))), {})]),
    "dagness_penalty": ("metrics", lambda r: [
        ((r.normal(size=(6, 6)),), {}), ((r.normal(size=(5, 5, 1)),), {})]),
    "apply_top_k_filter_to_edges": ("misc", lambda r: [
        ((r.normal(size=(6, 6)),), {"k": 5}),
        ((r.normal(size=(3, 3)),), {"k": 20}),
        ((r.normal(size=(3, 3)),), {})]),
    "place_on_zero_to_one_scale": ("misc", lambda r: [
        ((list(r.normal(size=7)),), {}),
        ((r.uniform(size=5),), {})]),
    "get_avg_cosine_similarity_between_combos": ("misc", lambda r: [
        ((_graphs(r),), {}), ((_graphs(r, 2, (5, 5)),), {})]),
    "get_topk_graph_mask": ("misc", lambda r: [
        ((r.uniform(size=(6, 6, 2)), 4), {}),
        ((r.uniform(size=(6, 6)), 7), {"for_no_lag": False})]),
    "get_preds_from_masked_normalized_matrix": ("misc", lambda r: [
        ((r.uniform(size=(6, 6)), 2.0, 0.5), {}),
        ((r.uniform(size=(4, 4, 2)).astype(np.float32), 1.0, 0.25), {})]),
    "flatten_gc_with_lags": ("misc", lambda r: [
        ((r.normal(size=(6, 6, 3)),), {}),
        ((r.normal(size=(4, 5, 2)).astype(np.float32),), {})]),
    "unflatten_gc_with_lags": ("misc", lambda r: [
        ((r.normal(size=(6, 18)),), {}),
        ((r.normal(size=(4, 8)).astype(np.float32),), {})]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_helper_is_bitwise_the_jax_one(name):
    module, make = CASES[name]
    port = getattr({"metrics": tmetrics, "misc": tmisc}[module], name)
    jax_fn = getattr({"metrics": jmetrics, "misc": jmisc}[module], name)
    assert name in {"metrics": tmetrics, "misc": tmisc}[module].__all__
    for args, kwargs in make(np.random.default_rng(sorted(CASES).index(
            name))):
        _same(port(*args, **kwargs), jax_fn(*args, **kwargs))


def test_flatten_round_trip_matches_jax():
    rng = np.random.default_rng(11)
    GC = rng.normal(size=(5, 5, 3))
    flat = tmisc.flatten_gc_with_lags(GC)
    np.testing.assert_array_equal(tmisc.unflatten_gc_with_lags(flat), GC)
    np.testing.assert_array_equal(flat, jmisc.flatten_gc_with_lags(GC))


@pytest.fixture(scope="module")
def fold_args(tmp_path_factory):
    """A curated 6-node, 3-state fold's data cached-args file."""
    import random

    py_state, np_state = random.getstate(), np.random.get_state()
    try:
        fold_dir, _ = jcuration.curate_synthetic_fold(
            str(tmp_path_factory.mktemp("fold")), fold_id=0, num_nodes=6,
            num_lags=2, num_factors=3, num_supervised_factors=3,
            num_edges_per_graph=2, num_samples_in_train_set=8,
            num_samples_in_val_set=4, sample_recording_len=100,
            burnin_period=50, label_type_setting="OneHot",
            noise_type="gaussian", noise_level=1.0, folder_name="synSys6_2_3")
    finally:
        random.setstate(py_state)
        np.random.set_state(np_state)
    return os.path.join(fold_dir, "data_fold0_cached_args.txt")


def test_fill_gc_views_is_bitwise_the_jax_one():
    rng = np.random.default_rng(3)
    lagged = {0: rng.normal(size=(4, 4, 2)), 2: rng.normal(size=(4, 4, 2)),
              5: rng.normal(size=(4, 4, 2))}
    _same(tconfig._fill_gc_views({"keep": 1}, dict(lagged)),
          jconfig._fill_gc_views({"keep": 1}, dict(lagged)))
    _same(tconfig._fill_gc_views({}, {}), jconfig._fill_gc_views({}, {}))


def test_read_in_data_adjacency_matrices_is_bitwise_the_jax_one(fold_args):
    got = tconfig.read_in_data_adjacency_matrices({}, fold_args)
    _same(got, jconfig.read_in_data_adjacency_matrices({}, fold_args))
    assert sum(t is not None for t in got[
        "true_lagged_GC_tensor_factors"]) == 3


@pytest.mark.parametrize("model_type", ["REDCLIFF_S_CMLP", "DGCNN", ""])
@pytest.mark.parametrize("factors", [False, True])
def test_read_in_data_args_with_gc_views_matches_jax(fold_args, model_type,
                                                     factors):
    """``read_in_data_args(include_gc_views_for_eval=True)`` (and the
    JAX signature's keyword order) equals JAX's on the fold's file."""
    base = {"model_type": model_type, "data_cached_args_file": fold_args}
    kw = dict(include_gc_views_for_eval=True,
              read_in_gc_factors_for_eval=factors)
    got = tconfig.read_in_data_args(dict(base), **kw)
    _same(got, jconfig.read_in_data_args(dict(base), **kw))
    assert got["true_nontemporal_GC_tensor"].shape == (6, 6)
    # positionally, as the JAX signature orders them
    _same(tconfig.read_in_data_args(dict(base), True, factors),
          jconfig.read_in_data_args(dict(base), True, factors))
    with open(fold_args) as f:
        assert got["num_channels"] == int(json.load(f)["num_channels"])
