"""The port's elastic re-meshing (redcliff_tpu_torch/parallel/remesh.py, the
grid's degraded-mesh resume and the host faults of runtime/faultinject.py)
against the JAX package's, on the CPU.

* the host copies (``classify_device_error``, ``choose_mesh_devices``,
  ``width_fits``, ``plan_resharding``, ``apply_reshard``) equal the JAX
  module's bit for bit on the inputs of tests/test_remesh.py:45-134,
  279-307, and so does the seeded host-fault schedule;
* what the classifier makes of the errors torch and NCCL actually raise
  (recorded here; the signatures stay JAX's);
* a grid checkpointed on 8 simulated devices and resumed on 6 re-shards to
  width 12 and ends bit for bit where an uninterrupted run on 6 does
  (tests/test_remesh.py:571-624);
* the supervised acceptance of tests/test_remesh.py:650-686 through the
  port's child on 8 CPU entries (``--sim-devices 8``): host 3 of 4 drops
  at epoch 1, exit 21, the supervisor re-meshes 8 -> 6, the restart
  re-shards and finishes with the uninterrupted degraded run's results;
* the injected device and coordinator losses map onto ``HostLostError``
  (tests/test_remesh.py:515-560).
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu.parallel import remesh as jrm  # noqa: E402
from redcliff_tpu.runtime import faultinject as jfi  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset  # noqa: E402
from redcliff_tpu_torch.obs.logging import read_jsonl  # noqa: E402
from redcliff_tpu_torch.parallel import remesh as trm  # noqa: E402
from redcliff_tpu_torch.runtime import checkpoint as rck  # noqa: E402
from redcliff_tpu_torch.runtime import faultinject as tfi  # noqa: E402
from redcliff_tpu_torch.runtime.watchdog import EXIT_HOST_LOST  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = [sys.executable, "-m", "redcliff_tpu_torch.runtime.faultinject"]


def _plan_tuple(p):
    if p is None:
        return None
    return (int(p.new_width), p.orig_ids.tolist(), p.active.tolist(),
            np.asarray(p.sel).tolist(), np.asarray(p.retire_rows).tolist(),
            [int(i) for i in p.retire_ids])


# ------------------------------------------------------------ host copies
ERRORS = [
    RuntimeError("INTERNAL: device lost: local device vanished"),
    RuntimeError("PJRT error: device disconnected"),
    RuntimeError("DEADLINE_EXCEEDED: coordinator heartbeat timed out"),
    RuntimeError("distributed runtime service unavailable"),
    RuntimeError("collective all-reduce timed out after 60s"),
    RuntimeError("NCCL operation timeout"),
    ValueError("shapes (3, 4) and (4, 5) do not match"),
    RuntimeError("loss went non-finite at step 7"),
    None,
]


def test_classify_and_choose_equal_jax():
    for e in ERRORS:
        assert trm.classify_device_error(e) == jrm.classify_device_error(e)
    for n_vis in range(1, 17):
        for n_lanes in range(1, 40):
            assert trm.choose_mesh_devices(n_vis, n_lanes) \
                == jrm.choose_mesh_devices(n_vis, n_lanes)
    for w in range(0, 33):
        for n in range(0, 17):
            assert trm.width_fits(w, n) == jrm.width_fits(w, n)
    for name in ("_DEVICE_LOST_SIGS", "_COORDINATOR_SIGS", "_TIMEOUT_SIGS",
                 "_COORD_TIMEOUT_SIGS", "_COLLECTIVE_SIGS",
                 "_LANE_STATE_KEYS", "ENV_MESH_DEVICES", "ENV_SIM_HOSTS"):
        assert getattr(trm, name) == getattr(jrm, name), name


def test_plan_resharding_equals_jax():
    ids = np.arange(8, dtype=np.int32)
    some = np.array([1, 0, 1, 0, 0, 1, 0, 0], bool)
    cases = [(np.ones(8, bool), ids, [], n, True) for n in (1, 4, 6, 8)]
    cases += [(some, ids, [7], 4, True), (some, ids, [], 6, False),
              (np.zeros(8, bool), ids, [], 6, True),
              (np.array([0, 1, 0, 0, 0, 0, 0, 0], bool), ids, [], 6, False),
              (np.zeros(2, bool), np.full(2, -1, np.int32), [], 4, True)]
    rng = np.random.default_rng(0)
    for _ in range(40):
        w = int(rng.choice([4, 8, 12, 16]))
        act = rng.random(w) < 0.6
        orig = np.where(np.arange(w) < w - 2, np.arange(w), -1).astype(
            np.int32)
        cases.append((act, orig, [], int(rng.integers(1, 9)),
                      bool(rng.random() < 0.5)))
    for active, orig, retired, n, compact in cases:
        assert _plan_tuple(trm.plan_resharding(
            active, orig, retired, n, compact=compact)) == _plan_tuple(
            jrm.plan_resharding(active, orig, retired, n, compact=compact))


def _ckpt():
    return {
        "params": np.arange(4.0).reshape(4, 1),
        "optA_state": np.arange(4.0), "optB_state": np.arange(4.0),
        "best_params": {"w": np.arange(8.0).reshape(4, 2)},
        "best_crit": np.array([1.0, 2.0, 3.0, 4.0]),
        "best_epoch": np.array([0, 1, 2, 3]),
        "active": np.array([True, False, True, True]), "accepted": None,
        "failed_epoch": np.array([-1, 1, -1, -1]),
        "orig_ids": np.arange(4, dtype=np.int32),
    }


def test_apply_reshard_equals_jax():
    """The pre-sentinel checkpoint of tests/test_remesh.py:279-307 (no
    failed_cause: backfilled) through both packages' apply_reshard."""
    out = []
    for mod in (trm, jrm):
        ck, retired = _ckpt(), {}
        plan = mod.plan_resharding(ck["active"], ck["orig_ids"],
                                   retired.keys(), 6)
        migrated = mod.apply_reshard(ck, retired, plan)
        out.append((migrated, ck, retired))
    (tm, tck, tret), (jm, jck, jret) = out
    assert tm == jm == 3
    assert sorted(tret) == sorted(jret) == [1]
    for k in ("best_crit", "best_epoch", "failed_epoch", "failed_cause"):
        assert tret[1][k] == jret[1][k], k
    np.testing.assert_array_equal(tret[1]["best_params"]["w"],
                                  jret[1]["best_params"]["w"])
    for k in ("params", "optA_state", "optB_state", "best_crit",
              "best_epoch", "failed_epoch", "active", "orig_ids"):
        np.testing.assert_array_equal(tck[k], jck[k])
    np.testing.assert_array_equal(tck["best_params"]["w"],
                                  jck["best_params"]["w"])


def test_visible_devices_and_mesh_shape(monkeypatch):
    monkeypatch.delenv(trm.ENV_MESH_DEVICES, raising=False)
    monkeypatch.delenv(trm.ENV_SIM_HOSTS, raising=False)
    pool = ["cpu"] * 8
    assert len(trm.visible_devices(pool)) == 8
    monkeypatch.setenv(trm.ENV_MESH_DEVICES, "6")
    assert len(trm.visible_devices(pool)) == 6
    monkeypatch.setenv(trm.ENV_MESH_DEVICES, "not-a-number")
    assert len(trm.visible_devices(pool)) == 8
    monkeypatch.setenv(trm.ENV_MESH_DEVICES, "6")
    monkeypatch.setenv(trm.ENV_SIM_HOSTS, "3")
    assert trm.mesh_shape(trm.visible_mesh(devices=pool)) \
        == {"n_hosts": 3, "n_devices": 6, "device_kind": "cpu"}
    # 9 lanes on 6 survivors: all 6 (width 18) beat the 4-subset
    assert trm.visible_mesh(devices=pool, n_lanes=9).size == 6

    class _Dev:
        def __init__(self, pi):
            self.process_index = pi
            self.device_kind = "gpu"

    monkeypatch.setenv(trm.ENV_SIM_HOSTS, "4")
    real = [_Dev(0), _Dev(0), _Dev(1), _Dev(1)]
    assert trm.mesh_shape(devices=real)["n_hosts"] == 2
    assert trm.mesh_shape(devices=[_Dev(0)] * 4)["n_hosts"] == 4


@pytest.mark.parametrize("seed", range(12))
def test_host_fault_schedule_equals_jax(seed):
    assert tfi.random_host_fault_schedule(seed) \
        == jfi.random_host_fault_schedule(seed)


# what torch and NCCL raise when a card or a peer is gone, the route the
# port gives each and the route the JAX signatures give it; None falls back
# to the same-shape restart
TORCH_ERRORS = [
    ("[Rank 0] Watchdog caught collective operation timeout: WorkNCCL("
     "SeqNum=7, OpType=ALLREDUCE, NumelIn=1, NumelOut=1, Timeout(ms)="
     "600000) ran for 600013 milliseconds before timing out.",
     "collective_timeout", "collective_timeout"),
    ("NCCL communicator was aborted on rank 1. Original reason for "
     "failure was: NCCL error: remote process exited or there was a "
     "network error", "collective_timeout", None),
    ("CUDA error: unspecified launch failure\nCUDA kernel errors might be "
     "asynchronously reported at some other API call", None, None),
    ("CUDA error: CUDA-capable device(s) is/are busy or unavailable "
     "(cudaErrorDevicesUnavailable)", "device_lost", None),
    ("NVRM: Xid (PCI:0000:18:00): 79, pid=1234, GPU has fallen off the "
     "bus.", "device_lost", None),
    ("CUDA error: an illegal memory access was encountered", None, None),
]


@pytest.mark.parametrize("text,route,jax_route", TORCH_ERRORS)
def test_classify_torch_device_errors(text, route, jax_route):
    """The texts torch raises: an NCCL watchdog timeout is a collective
    timeout in both packages. The port alone routes an unavailable device
    and an Xid-79 "fallen off the bus" to ``device_lost`` and an NCCL
    communicator aborted by a peer's exit to ``collective_timeout``; a
    launch failure stays None (a faulty kernel raises it too)."""
    err = RuntimeError(text)
    assert trm.classify_device_error(err) == route
    assert jrm.classify_device_error(err) == jax_route


@pytest.mark.parametrize("err", ERRORS + [
    RuntimeError(text) for text, route, jax_route in TORCH_ERRORS
    if jax_route is not None])
def test_classify_jax_routed_texts_as_jax_does(err):
    """Every text the JAX signatures route (``redcliff_tpu/parallel/
    remesh.py:126``), and every text of theirs that routes nowhere, maps in
    the port as it maps in JAX: the port's own routes add to JAX's only
    texts JAX leaves at None."""
    assert trm.classify_device_error(err) == jrm.classify_device_error(err)


# ------------------------------------------------- degraded-mesh resume
@pytest.fixture(scope="module")
def degraded_reference(tmp_path_factory):
    """The uninterrupted run at the degraded width: G=8 on the 6-device
    survivor mesh (width 12) for all 3 epochs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(trm.ENV_MESH_DEVICES, "6")
        mp.delenv("REDCLIFF_FAULT_INJECT", raising=False)
        res = tfi.tiny_grid_fit(
            str(tmp_path_factory.mktemp("degraded_ref")), max_iter=3,
            grid_size=8, use_mesh=True, device="cpu", sim_devices=8)
    return tfi._result_blob(res)


def _assert_blob_equal(got, want):
    for k in ("val_history", "best_criteria", "best_epoch", "active"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["failures"] == want["failures"]
    for a, b in zip(got["best_params_leaves"], want["best_params_leaves"]):
        np.testing.assert_array_equal(a, b)


def test_degraded_mesh_resume_reshards_and_matches(tmp_path, monkeypatch,
                                                   degraded_reference):
    monkeypatch.delenv("REDCLIFF_FAULT_INJECT", raising=False)
    monkeypatch.delenv(trm.ENV_MESH_DEVICES, raising=False)
    ck = str(tmp_path / "ck")
    runner, X, Y = tfi._tiny_runner(3, grid_size=8, use_mesh=True,
                                    device="cpu", sim_devices=8)
    assert runner.mesh.size == 8
    ds = ArrayDataset(X, Y)
    runner.fit(2, ds, ds, max_iter=2, checkpoint_dir=ck, checkpoint_every=1)
    ckpt = rck.read_checkpoint(os.path.join(ck, "grid_checkpoint.pkl"))
    assert ckpt["mesh"] == {"n_hosts": 1, "n_devices": 8,
                            "device_kind": "cpu"}
    monkeypatch.setenv(trm.ENV_MESH_DEVICES, "6")
    runner2, _, _ = tfi._tiny_runner(3, grid_size=8, use_mesh=True,
                                     device="cpu", sim_devices=8)
    assert runner2.mesh.size == 6
    res = runner2.fit(2, ds, ds, checkpoint_dir=ck, checkpoint_every=1,
                      log_dir=ck)
    stats = runner2.dispatch_stats
    assert stats["remeshes"] == 1 and stats["grid_width"] == 12
    assert (stats["remesh"]["from_width"], stats["remesh"]["to_width"],
            stats["remesh"]["lanes_migrated"]) == (8, 12, 8)
    assert stats["remesh"]["plan_ms"] >= 0
    rem = read_jsonl(ck, event="remesh")
    assert len(rem) == 1
    assert (rem[0]["from_devices"], rem[0]["to_devices"],
            rem[0]["lanes_retired"]) == (8, 6, [])
    ckpt2 = rck.read_checkpoint(os.path.join(ck, "grid_checkpoint.pkl"))
    assert ckpt2["mesh"]["n_devices"] == 6 and len(ckpt2["orig_ids"]) == 12
    _assert_blob_equal(tfi._result_blob(res), degraded_reference)


def test_host_drop_supervised_remesh_acceptance(tmp_path,
                                                degraded_reference):
    """Host 3 of a 4-host x 2-device simulated mesh dies at the end of
    epoch 1: the port's child exits host_lost, the supervisor re-meshes
    8 -> 6, and the restart re-shards 8 -> 12 and finishes bit for bit as
    the uninterrupted degraded run."""
    ck = tmp_path / "ck"
    res_path = tmp_path / "res.pkl"
    env = dict(os.environ, PYTHONPATH=REPO,
               REDCLIFF_FAULT_MARKER=str(tmp_path / "fault.marker"),
               REDCLIFF_FAULT_INJECT="host_drop:3:1")
    env.pop(trm.ENV_MESH_DEVICES, None)
    env.pop("REDCLIFF_WATCHDOG", None)
    ledger = str(tmp_path / "run_ledger.jsonl")
    cmd = [sys.executable, "-m", "redcliff_tpu_torch.supervise",
           "--ledger", ledger, "--max-restarts", "3",
           "--base-delay-s", "0.05", "--mesh-devices", "8", "--n-hosts", "4",
           "--device-kind", "cpu", "--"] + CHILD + [
        "--checkpoint-dir", str(ck), "--mesh", "--sim-devices", "8",
        "--device", "cpu", "--grid-size", "8", "--max-iter", "3",
        "--result", str(res_path)]
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads(line) for line in open(ledger)]
    attempts = [r for r in recs if r["event"] == "attempt"]
    assert attempts[0]["rc"] == EXIT_HOST_LOST
    assert attempts[0]["classification"] == "host_lost"
    assert attempts[0]["action"] == "remesh_restart"
    assert attempts[0]["mesh"] == {"n_hosts": 4, "n_devices": 8,
                                   "device_kind": "cpu"}
    assert attempts[-1]["classification"] == "clean"
    assert attempts[-1]["mesh"] == {"n_hosts": 3, "n_devices": 6,
                                    "device_kind": "cpu"}
    assert [(r["from_devices"], r["to_devices"]) for r in recs
            if r["event"] == "remesh"] == [(8, 6)]
    rem = read_jsonl(str(ck), event="remesh")
    assert rem and (rem[0]["from_width"], rem[0]["to_width"],
                    rem[0]["lanes_migrated"]) == (8, 12, 8)
    with open(res_path, "rb") as f:
        _assert_blob_equal(pickle.load(f), degraded_reference)


def test_injected_device_and_coordinator_loss_map_to_typed_error(
        tmp_path, monkeypatch):
    monkeypatch.delenv("REDCLIFF_FAULT_MARKER", raising=False)
    cases = [("device_lost:0", "device_lost", None),
             ("coordinator_loss:0", "coordinator_loss", None),
             ("host_drop:2:0", "host_drop", 2)]
    for spec, reason, host in cases:
        monkeypatch.setenv("REDCLIFF_FAULT_INJECT", spec)
        with pytest.raises(trm.HostLostError) as ei:
            tfi.tiny_grid_fit(str(tmp_path / reason), max_iter=1,
                              device="cpu")
        assert ei.value.reason == reason
        assert ei.value.host == host
