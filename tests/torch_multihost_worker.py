"""Worker process for the port's 2-process tests over loopback gloo.

Each worker owns 2 CPU mesh entries; ``initialize_distributed`` joins the
workers into a 4-entry global mesh spanning both processes (the port's
counterpart of tests/multihost_worker.py). Run by tests/test_torch_
distributed.py as:

    python tests/torch_multihost_worker.py <port> <process_id> \
        <num_processes> <outdir> <leg>

``leg`` is ``primitives`` (process_local_slice and a put_along_mesh /
gather_to_host round trip) or ``grid`` (the primitives, then a grid fit
over the global mesh, written to ``<outdir>/result_<pid>.pkl``).
"""
import os
import pickle
import sys

PORT, PID, NPROC, OUTDIR = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4])
LEG = sys.argv[5] if len(sys.argv) > 5 else "primitives"
LOCAL_DEVICES = 2
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from redcliff_tpu_torch.parallel.distributed import (  # noqa: E402
    gather_to_host, initialize_distributed, is_distributed,
    process_local_slice, put_along_mesh)
from redcliff_tpu_torch.parallel.mesh import grid_mesh  # noqa: E402


def primitives():
    assert initialize_distributed(f"127.0.0.1:{PORT}", NPROC, PID,
                                  devices=["cpu"] * LOCAL_DEVICES)
    assert is_distributed()
    # idempotent
    assert initialize_distributed(f"127.0.0.1:{PORT}", NPROC, PID)
    G = NPROC * LOCAL_DEVICES
    lo, hi = process_local_slice(G)
    assert (lo, hi) == (PID * LOCAL_DEVICES, (PID + 1) * LOCAL_DEVICES)
    mesh = grid_mesh()  # spans both processes
    assert mesh.size == G, mesh
    assert mesh.ranks == tuple(r for r in range(NPROC)
                               for _ in range(LOCAL_DEVICES))
    assert mesh.local_indices() == list(range(lo, hi))
    x = np.arange(G * 3, dtype=np.float32).reshape(G, 3)
    probe = put_along_mesh(x, mesh)
    # only this process's shards materialize
    assert sorted(probe.shards) == list(range(lo, hi))
    np.testing.assert_array_equal(gather_to_host(probe), x)
    return mesh


def grid(mesh):
    from redcliff_tpu_torch.data.datasets import ArrayDataset
    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)
    from redcliff_tpu_torch.parallel.grid import (GridSpec,
                                                  RedcliffGridRunner)
    from redcliff_tpu_torch.train.redcliff_trainer import (
        RedcliffTrainConfig)

    model = RedcliffSCMLP(RedcliffSCMLPConfig(
        num_chans=4, gen_lag=2, gen_hidden=(8,), embed_lag=4,
        embed_hidden_sizes=(8,), num_factors=2, num_supervised_factors=2,
        factor_weight_l1_coeff=0.01, adj_l1_reg_coeff=0.001,
        factor_cos_sim_coeff=0.01,
        factor_score_embedder_type="Vanilla_Embedder",
        primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
        training_mode="combined"))
    cfg = model.config
    rng = np.random.default_rng(0)  # the same data in every process
    T = cfg.max_lag + cfg.num_sims
    X = rng.normal(size=(64, T, cfg.num_chans)).astype(np.float32)
    Y = rng.uniform(size=(64, 3, 1)).astype(np.float32)
    ds = ArrayDataset(X, Y)
    G = mesh.size
    spec = GridSpec(points=[{"gen_lr": 1e-3 * (i + 1)} for i in range(G)])
    tc = RedcliffTrainConfig(max_iter=2, batch_size=32)
    res = RedcliffGridRunner(model, tc, spec, mesh=mesh).fit(0, ds, ds)
    assert res.val_history.shape == (2, G)
    assert np.all(np.isfinite(res.val_history))
    from redcliff_tpu_torch.interop import tree_leaves

    with open(os.path.join(OUTDIR, f"result_{PID}.pkl"), "wb") as f:
        pickle.dump({"val_history": res.val_history,
                     "best_criteria": res.best_criteria,
                     "best_leaf": np.asarray(tree_leaves(
                         res.best_params)[0])}, f)


def main():
    mesh = primitives()
    if LEG == "grid":
        grid(mesh)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {PID}: OK", flush=True)


if __name__ == "__main__":
    main()
