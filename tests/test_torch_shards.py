"""The port's streaming ``ShardedBatchDataset`` (redcliff_tpu_torch/data/
shards.py) against the JAX package's (redcliff_tpu/data/shards.py:85-306)
on the same shard files: the streaming statistics, per-sample and per-file
quarantine records, unshuffled and numpy-shuffled batches, torn files at
construction and mid-stream, and the ``host_id`` / ``n_hosts`` slices, all
bit for bit; its heartbeat and span; and the port's fits on it — the
per-point trainer on one training shard equals the ArrayDataset fit of the
same statistics bitwise (the same batch order), and the grid routes it
through the prefetched per-batch path.
"""
import os
import pickle
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu.data import shards as jshards  # noqa: E402
from redcliff_tpu_torch.data import shards as tshards  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset  # noqa: E402
from redcliff_tpu_torch.interop import tree_leaves  # noqa: E402
from redcliff_tpu_torch.obs import flight  # noqa: E402
from redcliff_tpu_torch.runtime import watchdog  # noqa: E402

import test_torch_train as TT  # noqa: E402


def _write_shards(root, sizes=(13, 11, 8, 5), T=6, C=3, seed=0, bad=()):
    """Shard files of ``sizes`` samples (x (T, C), y (2,)); ``bad`` lists
    (shard, sample) positions made non-finite."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i, n in enumerate(sizes):
        pairs = [[rng.normal(size=(T, C)).astype(np.float32),
                  rng.uniform(size=(2,)).astype(np.float32)]
                 for _ in range(n)]
        for s, j in bad:
            if s == i:
                pairs[j][0][1, 0] = np.inf if j % 2 else np.nan
        with open(os.path.join(root, f"subset_{i}.pkl"), "wb") as f:
            pickle.dump(pairs, f)
    return str(root)


def _both(split, **kw):
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        j = jshards.ShardedBatchDataset(split, **kw)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        t = tshards.ShardedBatchDataset(split, **kw)
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    return j, t


def _assert_same(j, t):
    assert len(t) == len(j) and t.files == j.files
    assert (t.num_timesteps, t.num_channels) == (j.num_timesteps,
                                                 j.num_channels)
    assert t.quarantined_samples == j.quarantined_samples
    assert t.quarantined_files == j.quarantined_files
    assert (t.stats is None) == (j.stats is None)
    if j.stats is not None:
        for a, b in zip(t.stats, j.stats):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert t.supports_device_batches is j.supports_device_batches is False


def _batches_equal(j, t, bs, seed=None, drop=False):
    jb = list(j.batches(bs, rng=None if seed is None
                        else np.random.default_rng(seed),
                        drop_remainder=drop))
    tb = list(t.batches(bs, rng=None if seed is None
                        else np.random.default_rng(seed),
                        drop_remainder=drop))
    assert len(tb) == len(jb) == t.num_batches(bs, drop) \
        == j.num_batches(bs, drop)
    for (tX, tY), (jX, jY) in zip(tb, jb):
        assert tX.dtype == jX.dtype and np.array_equal(tX, jX)
        assert np.array_equal(tY, jY)
    return tb


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("seed", [None, 0, 5])
def test_stats_and_batches_match_jax(tmp_path, normalize, seed):
    split = _write_shards(tmp_path / "s", bad=((0, 3), (2, 1), (2, 6)))
    j, t = _both(split, normalize=normalize)
    _assert_same(j, t)
    assert t.quarantined_samples == 3
    for bs in (4, 7, 64):
        for drop in (False, True):
            _batches_equal(j, t, bs, seed, drop)


def test_unshuffled_stream_is_the_concatenated_shards(tmp_path):
    split = _write_shards(tmp_path / "s")
    t = tshards.ShardedBatchDataset(split)
    X, Y = tshards.samples_to_arrays(tshards.load_shard_samples(split))
    got = np.concatenate([b[0] for b in t.batches(5)])
    assert np.array_equal(got, (X - t.stats[0]) / t.stats[1])
    assert np.array_equal(np.concatenate([b[1] for b in t.batches(5)]), Y)


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_host_slices_match_jax(tmp_path, n_hosts):
    split = _write_shards(tmp_path / "s", sizes=(9, 4, 7, 6, 5),
                          bad=((3, 2),))
    seen = []
    for h in range(n_hosts):
        j, t = _both(split, host_id=h, n_hosts=n_hosts)
        _assert_same(j, t)
        _batches_equal(j, t, 4, seed=h)
        assert t._hb == f"host{h}:shard_loader"
        seen += t.files
    # every shard owned by exactly one host
    assert sorted(seen) == sorted(os.listdir(split))


def test_torn_files_quarantine_matches_jax(tmp_path):
    split = _write_shards(tmp_path / "s", sizes=(8, 8, 8))
    with open(os.path.join(split, "subset_0.pkl"), "wb") as f:
        f.write(b"\x80\x04 not a pickle")
    j, t = _both(split)
    _assert_same(j, t)
    assert list(t.quarantined_files) == ["subset_0.pkl"]
    # torn after construction: quarantined mid-stream, the stream goes on
    torn = os.path.join(split, "subset_2.pkl")
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 2)
    with pytest.warns(RuntimeWarning, match="torn shard"):
        tb = list(t.batches(4))
    with pytest.warns(RuntimeWarning, match="torn shard"):
        jb = list(j.batches(4))
    assert t.quarantined_files == j.quarantined_files
    assert sum(len(b[0]) for b in tb) == sum(len(b[0]) for b in jb) == 8
    # every shard torn: a loud failure in both
    with open(os.path.join(split, "subset_1.pkl"), "wb") as f:
        f.write(b"junk")
    for mod in (jshards, tshards):
        with pytest.raises(ValueError, match="torn"):
            with pytest.warns(RuntimeWarning):
                mod.ShardedBatchDataset(split)


def test_construction_errors_match_jax(tmp_path):
    split = _write_shards(tmp_path / "s", sizes=(4, 4))
    os.makedirs(tmp_path / "empty")
    for kw, exc in (({}, FileNotFoundError),
                    ({"host_id": 0}, ValueError),
                    ({"host_id": 3, "n_hosts": 2}, ValueError),
                    ({"host_id": 2, "n_hosts": 3}, FileNotFoundError)):
        where = str(tmp_path / "empty") if not kw else split
        for mod in (jshards, tshards):
            with pytest.raises(exc):
                mod.ShardedBatchDataset(where, **kw)


def test_heartbeat_span_and_fault_points(tmp_path, monkeypatch):
    """Each shard read stamps the loader's heartbeat (retired when the
    stream ends) and records a ring-only ``shard.load`` span; ``slow_io``
    rides the reads."""
    split = _write_shards(tmp_path / "s", sizes=(4, 4, 4))
    reg = watchdog.REGISTRY
    before = reg.counts().get("shard_loader", 0)
    flight.clear()
    t = tshards.ShardedBatchDataset(split)
    assert reg.counts()["shard_loader"] == before + 3
    assert "shard_loader" not in reg.ages()
    it = t.batches(2)
    next(it)
    assert "shard_loader" in reg.ages()
    list(it)
    assert "shard_loader" not in reg.ages()
    spans = [r for r in flight.snapshot()["shard_loader"]
             if r["name"] == "shard.load"]
    assert [s["attrs"]["file"] for s in spans] == [
        "subset_0.pkl", "subset_1.pkl", "subset_2.pkl"] * 2
    monkeypatch.setenv("REDCLIFF_FAULT_INJECT", "slow_io:1")
    assert sum(len(b[0]) for b in t.batches(5)) == 12


def _slice_shards(tmp_path, X, Y, n_train, val_shards):
    """The slice's data as one training shard and ``val_shards``
    validation shards."""
    tr, va = tmp_path / "train", tmp_path / "val"
    os.makedirs(tr)
    os.makedirs(va)
    with open(tr / "subset_0.pkl", "wb") as f:
        pickle.dump([[x, y] for x, y in zip(X[:n_train], Y[:n_train])], f)
    for i, rows in enumerate(np.array_split(np.arange(n_train, len(X)),
                                            val_shards)):
        with open(va / f"subset_{i}.pkl", "wb") as f:
            pickle.dump([[X[j], Y[j]] for j in rows], f)
    return (tshards.ShardedBatchDataset(str(tr)),
            tshards.ShardedBatchDataset(str(va)))


def test_per_point_fit_on_shards_equals_array_fit(tmp_path):
    """One training shard gives the ArrayDataset's batch order (the shard
    order has one entry, and ``permutation`` draws as ``shuffle``): with the
    same statistics the two fits end bitwise equal, and every core
    heartbeat of a streamed fit stamps."""
    _, tm, jp = TT._slice_models()
    X, Y = TT._slice_data()
    sh_tr, sh_va = _slice_shards(tmp_path, X, Y, 64, 3)
    arr_tr = ArrayDataset(X[:64], Y[:64], stats=sh_tr.stats)
    arr_va = ArrayDataset(X[64:], Y[64:], stats=sh_va.stats)
    kw = dict(max_iter=3, batch_size=16, check_every=1, prox_penalty="GL",
              prox_lam=0.5)
    watchdog.REGISTRY.clear()
    res = {}
    for name, (tr, va) in (("shards", (sh_tr, sh_va)),
                           ("array", (arr_tr, arr_va))):
        res[name] = TT.ttr.RedcliffTrainer(
            tm, TT.ttr.RedcliffTrainConfig(**kw), device="cpu").fit(
            jp, tr, va, save_dir=str(tmp_path / name))
        if name == "shards":
            beats = watchdog.REGISTRY.counts()
    for c in watchdog.CORE_COMPONENTS:
        if c != "epoch_engine":
            assert beats.get(c, 0) > 0, (c, beats)
    assert beats["epoch_engine"] == 3
    a, b = res["shards"], res["array"]
    assert a.histories["avg_combo_loss"] == b.histories["avg_combo_loss"]
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_grid_streams_shards_through_the_per_batch_path(tmp_path):
    """The grid routes a host-only dataset through the per-batch path
    behind the prefetcher, and trains to finite losses."""
    import test_torch_grid as G

    _, tm = G._models()
    X, Y = G._data(48)
    sh_tr, sh_va = _slice_shards(tmp_path, X, Y, 32, 2)
    runner = G.tgrid.RedcliffGridRunner(
        tm, G.ttr.RedcliffTrainConfig(max_iter=2, batch_size=16),
        G.tgrid.GridSpec([{"gen_lr": 1e-3}, {"gen_lr": 2e-3}]),
        device="cpu")
    res = runner.fit(0, sh_tr, sh_va)
    st = runner.dispatch_stats
    assert st["mode"] == "per_batch" and st["prefetch_items"] > 0
    assert np.isfinite(res.val_history).all()
