"""The port's multi-process runtime (redcliff_tpu_torch/parallel/
distributed.py) over loopback gloo, on the CPU.

Two worker processes (tests/torch_multihost_worker.py), each owning 2 CPU
mesh entries, join one process group: the global mesh spans both, each
process materializes only its own shards, and an all-gather gives every
process the whole grid. The 2-process grid fit (the port's counterpart of
tests/test_multihost.py) is ``slow``, as JAX's is: two processes each pay
their start-up and the fit's collectives on one CPU.
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu_torch.parallel import distributed as tdist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, leg, timeout):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(pid), "2", str(tmp_path),
         leg], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"worker {pid}: OK" in out


def test_single_process_primitives(monkeypatch):
    """Without a coordinator the runtime is one process: no process
    group, the whole grid local."""
    for name in ("REDCLIFF_COORDINATOR", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.initialize_distributed() is False
    assert not tdist.is_distributed()
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)
    assert tdist.process_local_slice(8) == (0, 8)
    assert tdist.process_local_slice(8, process_id=1, num_processes=4) \
        == (2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tdist.process_local_slice(7, process_id=0, num_processes=2)
    from redcliff_tpu_torch.parallel.mesh import grid_mesh

    mesh = grid_mesh(devices=["cpu"] * 4)
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    arr = tdist.put_along_mesh(x, mesh)
    assert sorted(arr.shards) == [0, 1, 2, 3]
    np.testing.assert_array_equal(tdist.gather_to_host(arr), x)
    np.testing.assert_array_equal(
        tdist.gather_to_host({"a": torch.ones(2)})["a"], np.ones(2))


def test_two_process_primitives_over_loopback_gloo(tmp_path):
    """process_local_slice, the global mesh and a put_along_mesh /
    gather_to_host round trip in two processes of 2 CPU entries each."""
    _run_workers(tmp_path, "primitives", timeout=120)


@pytest.mark.slow
def test_two_process_grid_over_loopback_gloo(tmp_path):
    """The grid over the 4-entry mesh spanning both processes: every
    process sees the whole result, and it is bit for bit the same fit on
    4 CPU entries in one process."""
    _run_workers(tmp_path, "grid", timeout=600)
    with open(tmp_path / "result_0.pkl", "rb") as f:
        r0 = pickle.load(f)
    with open(tmp_path / "result_1.pkl", "rb") as f:
        r1 = pickle.load(f)
    for k in ("val_history", "best_criteria", "best_leaf"):
        np.testing.assert_array_equal(r0[k], r1[k])
    code = (
        "import sys, pickle; sys.argv = ['w', '0', '0', '1', %r];"
        "sys.path.insert(0, %r);"
        "import torch_multihost_worker as w;"
        "from redcliff_tpu_torch.parallel.mesh import grid_mesh;"
        "w.OUTDIR = %r; w.PID = 'one';"
        "w.grid(grid_mesh(devices=['cpu'] * 4))"
        % (str(tmp_path), os.path.dirname(WORKER), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / "result_one.pkl", "rb") as f:
        one = pickle.load(f)
    for k in ("val_history", "best_criteria", "best_leaf"):
        np.testing.assert_array_equal(r0[k], one[k])
