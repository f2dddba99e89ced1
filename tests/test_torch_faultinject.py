"""The port's fault-injection harness (redcliff_tpu_torch/runtime/
faultinject.py, and the fault points of runtime/checkpoint.py, both
trainers and the grid) on the CPU.

The numerical step points hold their contract in the port: a fit with
``nan_batch:K`` ends bit-identical to one with ``skip_update:K`` (the
guard's skip is the reference semantics), through the per-point trainer,
the generic trainer and the per-batch grid. The port skips the steps JAX
skips under the same spec (tests/test_torch_obs.py::
test_redcliff_trainer_events_match_jax holds the ``anomaly`` records).
A fault kind whose fault point is not ported raises; a corrupt checkpoint
is quarantined and the fit falls back to ``.prev`` or restarts; the child
fit, SIGKILLed after its epoch-1 checkpoint and resumed, equals the
uninterrupted fit bit for bit.
"""
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu_torch.interop import tree_leaves  # noqa: E402
from redcliff_tpu_torch.obs import flight  # noqa: E402
from redcliff_tpu_torch.runtime import checkpoint as ck  # noqa: E402
from redcliff_tpu_torch.runtime import faultinject as fi  # noqa: E402

import test_torch_grid as G  # noqa: E402
import test_torch_train as TT  # noqa: E402
import test_torch_trainer as GT  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = "grid_checkpoint.pkl"


def _per_point():
    _, tm, jp = TT._slice_models()
    X, Y = TT._slice_data()
    tc = TT.ttr.RedcliffTrainConfig(max_iter=3, batch_size=16,
                                    check_every=1, prox_penalty="GL",
                                    prox_lam=0.5)
    res = TT.ttr.RedcliffTrainer(tm, tc, device="cpu").fit(
        jp, TT.tds.ArrayDataset(X[:64], Y[:64]),
        TT.tds.ArrayDataset(X[64:], Y[64:]))
    return tree_leaves(res.params), res.histories["avg_combo_loss"], \
        res.numerics["skipped"]


def _generic():
    _, tm, jp = GT._models("cmlp_fm_gista")
    res = GT._fit(GT.ttr, GT.tds, tm, jp, "cmlp_fm_gista", device="cpu")
    return tree_leaves(res.params), res.histories["avg_combo_loss"], \
        res.numerics["skipped"]


def _grid():
    _, tm = G._models()
    X, Y = G._data()
    runner = G.tgrid.RedcliffGridRunner(
        tm, G.ttr.RedcliffTrainConfig(**dict(G.KNOBS,
                                             stream_mode="per_batch")),
        G.tgrid.GridSpec(points=G.POINTS[:3]), device="cpu")
    res = runner.fit(0, G.TDataset(X, Y), G.TDataset(X, Y))
    return (tree_leaves(res.best_params), res.val_history.tolist(),
            int(np.sum(res.numerics["skipped"])))


@pytest.mark.parametrize("path", ["per_point", "generic", "grid"])
def test_nan_batch_equals_skip_update(monkeypatch, path):
    fit = {"per_point": _per_point, "generic": _generic, "grid": _grid}[path]
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    monkeypatch.setenv(fi.ENV_SPEC, "nan_batch:2")
    nan_leaves, nan_hist, nan_skipped = fit()
    monkeypatch.setenv(fi.ENV_SPEC, "skip_update:2")
    skip_leaves, skip_hist, skip_skipped = fit()
    monkeypatch.delenv(fi.ENV_SPEC)
    clean_leaves, _, clean_skipped = fit()
    for a, b in zip(nan_leaves, skip_leaves):
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    assert nan_hist == skip_hist
    # the guard caught the poisoned step (every lane, on the grid); the
    # skip made none; without a fault the fit differs
    assert nan_skipped > 0 and skip_skipped == clean_skipped == 0
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(nan_leaves, clean_leaves))


@pytest.mark.parametrize("kind", fi.UNPORTED_FAULTS)
def test_unported_fault_points_raise(monkeypatch, kind):
    monkeypatch.setenv(fi.ENV_SPEC, f"nan_batch:1,{kind}:1")
    with pytest.raises(NotImplementedError, match=kind):
        fi.skip_update(0)
    with pytest.raises(NotImplementedError, match="item 1[25]"):
        fi.poison_batch(torch.zeros(2), 1)


def test_step_points_and_probes(monkeypatch):
    X = torch.ones(3, 2, dtype=torch.float64)
    assert fi.poison_batch(X, 0) is X and not fi.armed()
    monkeypatch.setenv(fi.ENV_SPEC, "nan_batch:1-2,grad_blowup:4,"
                                    "skip_update:7")
    assert fi.armed() and fi.poison_batch(X, 0) is X
    bad = fi.poison_batch(X, 2)
    assert bad.dtype == torch.float32 and torch.isnan(bad).all()
    assert torch.equal(fi.poison_batch(X, 4),
                       torch.full((3, 2), 1e30, dtype=torch.float32))
    assert [fi.skip_update(s) for s in (6, 7, 8)] == [False, True, False]
    probe = fi.flaky(2)
    assert [probe()[0] for _ in range(3)] == [False, False, True]
    assert probe.calls() == 3
    with pytest.raises(ValueError):
        fi.flaky(1, exc=ValueError("x"))()


def test_checkpoint_io_faults_and_marker(tmp_path, monkeypatch):
    """``io_error`` fails a checkpoint write cleanly (typed error, no tmp
    left, the old generation intact, a ``ckpt.write`` span with the
    error), once per marker file; ``marker_after_epoch`` writes the
    marker at its epoch's end."""
    path = str(tmp_path / "c.pkl")
    ck.write_checkpoint(path, {"gen": 1})
    marker = str(tmp_path / "marker")
    monkeypatch.setenv(fi.ENV_MARKER, marker)
    monkeypatch.setenv(fi.ENV_SPEC, "io_error:ckpt_write:EIO,slow_io:1")
    flight.clear()
    with pytest.raises(ck.CheckpointWriteError, match="I/O error"):
        ck.write_checkpoint(path, {"gen": 2})
    assert sorted(os.listdir(tmp_path)) == ["c.pkl", "marker.ioerr_ckpt_write"]
    assert ck.read_checkpoint(path) == {"gen": 1}
    span, = flight.snapshot()["ckpt"]
    assert span["name"] == "ckpt.write" and span["attrs"]["error"] == \
        "OSError"
    ck.write_checkpoint(path, {"gen": 2})  # the guard file: fires once
    assert ck.read_checkpoint(path) == {"gen": 2}
    assert flight.snapshot()["ckpt"][-1]["attrs"]["bytes"] > 0
    monkeypatch.setenv(fi.ENV_SPEC, "marker_after_epoch:3")
    fi.crash_point("epoch_end", epoch=2)
    assert not os.path.exists(marker)
    fi.crash_point("epoch_end", epoch=3)
    with open(marker) as f:
        assert f.read() == "3"


@pytest.mark.parametrize("mode", ["truncate", "flip_payload"])
def test_corrupt_checkpoint_quarantined_with_prev_fallback(tmp_path,
                                                           monkeypatch, mode):
    """A corrupt head is quarantined to ``*.bad`` and the fit resumes from
    ``.prev``; with no usable ``.prev`` it restarts and equals a fresh
    fit."""
    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    fresh = fi.tiny_grid_fit(None, max_iter=2, device="cpu")
    d = str(tmp_path / "ck")
    fi.tiny_grid_fit(d, max_iter=2, device="cpu")
    head = os.path.join(d, CKPT)
    fi.corrupt_checkpoint(head, mode)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        obj, src = ck.load_checkpoint(head)
    assert src == head + ".prev" and obj["epoch"] == 0
    assert os.path.exists(head + ".bad")
    os.replace(head + ".bad", head)
    os.remove(head + ".prev")
    with pytest.warns(RuntimeWarning, match="quarantined"):
        restarted = fi.tiny_grid_fit(d, max_iter=2, device="cpu")
    assert os.path.exists(head + ".bad")
    np.testing.assert_array_equal(restarted.val_history, fresh.val_history)


def _child(ckdir, *extra, fault=None):
    env = dict(os.environ, PYTHONPATH=REPO, REDCLIFF_QUALITY="0")
    env.pop(fi.ENV_SPEC, None)
    env.pop(fi.ENV_MARKER, None)
    if fault:
        env[fi.ENV_SPEC] = fault
    return subprocess.run(
        [sys.executable, "-m", "redcliff_tpu_torch.runtime.faultinject",
         "--checkpoint-dir", str(ckdir), "--device", "cpu", "--max-iter",
         "4"] + list(extra), cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)


def test_child_sigkilled_after_checkpoint_resumes_bit_identical(tmp_path):
    """The child fit on ``--device cpu``, SIGKILLed right after its epoch-1
    checkpoint and resumed, equals the uninterrupted fit bit for bit;
    the metrics log of the resumed attempt names its source."""
    killed = _child(tmp_path / "ck", fault="sigkill_after_checkpoint:1")
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    assert ck.read_checkpoint(str(tmp_path / "ck" / CKPT))["epoch"] == 1
    resumed = _child(tmp_path / "ck", "--result", str(tmp_path / "r.pkl"))
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    full = _child(tmp_path / "full", "--result", str(tmp_path / "f.pkl"))
    assert full.returncode == 0, full.stderr[-2000:]
    with open(tmp_path / "r.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "f.pkl", "rb") as f:
        want = pickle.load(f)
    for k in ("val_history", "best_criteria", "best_epoch", "active"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["failures"] == want["failures"]
    for a, b in zip(got["best_params_leaves"], want["best_params_leaves"]):
        np.testing.assert_array_equal(a, b)
    from redcliff_tpu_torch.obs.logging import read_jsonl

    starts = read_jsonl(str(tmp_path / "ck"), event="fit_start")
    assert [s["resumed_from_epoch"] for s in starts] == [None, 1]
    assert starts[1]["resumed_from"].endswith(CKPT)
