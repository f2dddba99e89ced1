"""The port's background checkpoint writer (redcliff_tpu_torch/runtime/
checkpoint.py ``AsyncCheckpointWriter`` and ``host_snapshot``) against the
JAX package's writer (redcliff_tpu/runtime/checkpoint.py:211-306), and its
use in both trainers and the grid.

The writer keeps the JAX semantics: ``submit`` hands the write to a thread
after a completion barrier, ``wait`` joins it and re-raises a background
failure (``CheckpointWriteError`` typed, anything else as a
``RuntimeError``), the context manager re-raises on a clean exit and warns
while another exception propagates. A snapshot is a copy: the trainers and
the grid update their tensors in place. Fits with ``async_checkpointing``
on equal the fits with it off bit for bit, and so do their checkpoint files
after ``read_checkpoint``; a grid resumed from an asynchronous checkpoint
equals the uninterrupted fit.
"""
import os
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu.runtime import checkpoint as jck  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset  # noqa: E402
from redcliff_tpu_torch.interop import tree_leaves  # noqa: E402
from redcliff_tpu_torch.obs import flight, spans  # noqa: E402
from redcliff_tpu_torch.runtime import checkpoint as tck  # noqa: E402
from redcliff_tpu_torch.runtime import faultinject as fi  # noqa: E402
from redcliff_tpu_torch.runtime import watchdog  # noqa: E402

import test_torch_train as TT  # noqa: E402
import test_torch_trainer as GT  # noqa: E402

TRAINER_FILES = ("final_best_model.bin",
                 "training_meta_data_and_hyper_parameters.pkl",
                 "trainer_checkpoint.pkl")


def _tree_equal(a, b):
    """Read-back checkpoints equal: arrays bitwise (NaN equal), dict keys in
    order, everything else by ``==``."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_tree_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if hasattr(a, "__dataclass_fields__"):
        return type(a) is type(b) and vars(a) == vars(b)
    return a == b


# --------------------------------------------------------------- the writer
def _writer_story(mod, tmp_path, tag):
    """The JAX writer tests' operations, with every observation."""
    seen = []
    path = str(tmp_path / f"{tag}.pkl")
    done = []

    def slow():
        time.sleep(0.2)
        mod.write_checkpoint(path, {"x": 1})
        done.append(True)

    w = mod.AsyncCheckpointWriter()
    t0 = time.monotonic()
    w.submit(slow)
    seen.append((time.monotonic() - t0 < 0.15, bool(done), w.in_flight))
    w.wait()
    seen.append((bool(done), mod.read_checkpoint(path), w.in_flight))
    order = []
    w.submit(lambda: (time.sleep(0.1), order.append(1)))
    w.submit(lambda: order.append(2))  # waits for the first
    w.wait()
    seen.append(order)

    def disk_full():
        raise mod.CheckpointWriteError(path, OSError(28, "No space left"))

    def bug():
        raise KeyError("bug")

    for fn in (disk_full, bug):
        w.submit(fn)
        try:
            w.wait()
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            seen.append((type(e).__name__, str(e).replace(tag, "")))
        w.wait()  # the error is reported once
    # the context manager: a clean exit re-raises, an exceptional one warns
    # and lets the original propagate
    try:
        with mod.AsyncCheckpointWriter() as cw:
            cw.submit(bug)
    except RuntimeError as e:
        seen.append(("clean exit", type(e.__cause__).__name__))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            with mod.AsyncCheckpointWriter() as cw:
                cw.submit(bug)
                raise ValueError("the fit's own error")
        except ValueError as e:
            seen.append(("exceptional exit", str(e)))
    seen.append([str(c.message) for c in caught])
    return seen


def test_writer_semantics_match_jax(tmp_path):
    assert _writer_story(tck, tmp_path, "port") == \
        _writer_story(jck, tmp_path, "jax")


def test_writer_spans_counter_heartbeat_and_hang_point(tmp_path,
                                                       monkeypatch):
    """The barrier's wait counts into ``ckpt_barrier_stall_ms`` and is a
    ``ckpt.submit_barrier`` span; the write is a ``ckpt.async_write`` span,
    stamps ``ckpt_writer`` while it runs (retired after) and carries the
    ``hang_in:ckpt_writer`` fault point."""
    flight.clear()
    before = spans.COUNTERS.snapshot()
    beats0 = watchdog.REGISTRY.counts().get("ckpt_writer", 0)
    monkeypatch.setenv("REDCLIFF_FAULT_INJECT", "hang_in:ckpt_writer:0.2")
    monkeypatch.delenv("REDCLIFF_FAULT_MARKER", raising=False)
    w = tck.AsyncCheckpointWriter()
    live = []
    w.submit(lambda: live.append("ckpt_writer" in
                                 watchdog.REGISTRY.ages()))
    t0 = time.monotonic()
    w.submit(lambda: None)   # the barrier waits out the wedged write
    stall = time.monotonic() - t0
    w.wait()
    assert stall >= 0.15 and live == [True]
    assert "ckpt_writer" not in watchdog.REGISTRY.ages()
    assert watchdog.REGISTRY.counts()["ckpt_writer"] == beats0 + 2
    delta = spans.COUNTERS.delta(before)
    assert delta["ckpt_barrier_stall_ms"] >= 150.0
    names = [r["name"] for r in flight.snapshot()["ckpt"]]
    assert names.count("ckpt.submit_barrier") == 2
    assert names.count("ckpt.async_write") == 2


def test_host_snapshot_is_a_copy():
    live = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "opt": [{"step": torch.tensor(3.0), "lr": 0.1}, (1, "a")],
            "rows": [torch.ones(2)], "n": 4, "arr": np.ones(2)}
    snap, ready = tck.host_snapshot(live)
    with torch.no_grad():
        live["w"].add_(100.0)
        live["opt"][0]["step"].add_(1.0)
        live["rows"][0].zero_()
    ready()
    assert torch.equal(snap["w"], torch.arange(6.0).reshape(2, 3))
    assert float(snap["opt"][0]["step"]) == 3.0
    assert torch.equal(snap["rows"][0], torch.ones(2))
    assert snap["opt"][0]["lr"] == 0.1 and snap["opt"][1] == (1, "a")
    assert snap["n"] == 4 and snap["arr"] is live["arr"]


# --------------------------------------------------------------- the fits
def _read_all(d, names):
    return {n: tck.read_checkpoint(os.path.join(d, n)) for n in names}


def test_redcliff_trainer_async_equals_sync(tmp_path):
    _, tm, jp = TT._slice_models()
    X, Y = TT._slice_data()
    out = {}
    for flag in (True, False):
        d = tmp_path / str(flag)
        res = TT.ttr.RedcliffTrainer(tm, TT._slice_train_config(
            TT.ttr, 0.5, async_checkpointing=flag), device="cpu").fit(
            jp, ArrayDataset(X[:64], Y[:64]), ArrayDataset(X[64:], Y[64:]),
            save_dir=str(d))
        out[flag] = (res, _read_all(d, TRAINER_FILES))
    (a, ack), (s, sck) = out[True], out[False]
    assert a.histories["avg_combo_loss"] == s.histories["avg_combo_loss"]
    for x, y in zip(tree_leaves(a.params), tree_leaves(s.params)):
        assert torch.equal(x, y)
    # the epochs' wall ms differ run to run; every other byte is equal
    for log in (ack["trainer_checkpoint.pkl"]["epoch_log"],
                sck["trainer_checkpoint.pkl"]["epoch_log"]):
        for e in log:
            e.pop("ms")
    assert all(_tree_equal(ack[n], sck[n]) for n in TRAINER_FILES)


def test_generic_trainer_async_equals_sync(tmp_path):
    _, tm, jp = GT._models("cmlp_fm_gista")
    out = {}
    for flag in (True, False):
        d = tmp_path / str(flag)
        res = GT._fit(GT.ttr, GT.tds, tm, jp, "cmlp_fm_gista", save_dir=d,
                      device="cpu", async_checkpointing=flag)
        out[flag] = (res, _read_all(d, TRAINER_FILES))
    (a, ack), (s, sck) = out[True], out[False]
    assert a.histories == s.histories
    for x, y in zip(tree_leaves(a.params), tree_leaves(s.params)):
        assert torch.equal(x, y)
    for log in (ack["trainer_checkpoint.pkl"]["epoch_log"],
                sck["trainer_checkpoint.pkl"]["epoch_log"]):
        for e in log:
            e.pop("ms")
    assert all(_tree_equal(ack[n], sck[n]) for n in TRAINER_FILES)


def _grid(tmp_path, name, max_iter=None, **knobs):
    runner, X, Y = fi._tiny_runner(4, device="cpu")
    for k, v in knobs.items():
        setattr(runner.tc, k, v)
    ds = ArrayDataset(X, Y)
    ck = str(tmp_path / name)
    res = runner.fit(2, ds, ds, max_iter=max_iter, checkpoint_dir=ck,
                     checkpoint_every=1)
    return runner, res, tck.read_checkpoint(
        os.path.join(ck, runner.CHECKPOINT_NAME))


def _results_equal(a, b):
    return (all(np.array_equal(x, y, equal_nan=True) for x, y in zip(
        tree_leaves(a.best_params), tree_leaves(b.best_params)))
        and np.array_equal(a.val_history, b.val_history, equal_nan=True)
        and np.array_equal(a.best_criteria, b.best_criteria)
        and np.array_equal(a.best_epoch, b.best_epoch)
        and np.array_equal(a.active, b.active) and a.failures == b.failures)


def test_grid_async_equals_sync_and_resumes(tmp_path):
    arun, ares, ack = _grid(tmp_path, "async")
    srun, sres, sck = _grid(tmp_path, "sync", async_checkpointing=False)
    assert arun.tc.async_checkpointing and not srun.tc.async_checkpointing
    assert _results_equal(ares, sres) and _tree_equal(ack, sck)
    assert arun.dispatch_stats["ckpt_saves"] == 4
    assert arun.dispatch_stats["ckpt_bytes"] == os.path.getsize(
        tmp_path / "async" / arun.CHECKPOINT_NAME)
    # stopped after 2 epochs (asynchronously written), resumed to 4
    _grid(tmp_path, "resumed", max_iter=2)
    rrun, rres, rck = _grid(tmp_path, "resumed")
    assert rrun.dispatch_stats["resumed_from_epoch"] == 1
    assert _results_equal(rres, ares) and _tree_equal(rck, ack)


@pytest.mark.parametrize("flag", [True, False])
def test_write_failure_surfaces_typed(tmp_path, monkeypatch, flag):
    """An injected disk-full during a save surfaces from the fit as the
    typed ``CheckpointWriteError``, asynchronously written or not."""
    monkeypatch.setenv("REDCLIFF_FAULT_INJECT", "io_error:ckpt_write")
    monkeypatch.delenv("REDCLIFF_FAULT_MARKER", raising=False)
    with pytest.raises(tck.CheckpointWriteError, match="disk full"):
        _grid(tmp_path, str(flag), max_iter=2, async_checkpointing=flag)


def test_async_write_overlaps_the_next_epoch(tmp_path, monkeypatch):
    """With a slowed durable write the loop's stall per save is the
    snapshot's hand-off, the synchronous fit's the whole write; no thread
    outlives the fit."""
    real = tck.write_checkpoint

    def slow(path, obj):
        time.sleep(0.3)
        real(path, obj)
    monkeypatch.setattr(tck, "write_checkpoint", slow)
    stall = {}
    for flag in (True, False):
        runner, _, _ = _grid(tmp_path, str(flag), max_iter=2,
                             async_checkpointing=flag)
        st = runner.dispatch_stats
        stall[flag] = st["ckpt_stall_ms"] / st["ckpt_saves"]
    assert stall[False] >= 270.0 and stall[True] < 150.0, stall
    assert not [t for t in threading.enumerate() if t.name == "ckpt-writer"]
