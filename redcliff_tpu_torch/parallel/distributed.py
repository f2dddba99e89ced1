"""Multi-process bootstrap and mesh-spanning array utilities (port of
``redcliff_tpu/parallel/distributed.py``, on ``torch.distributed``).

The reference scales past one machine only through SLURM job arrays. The
JAX package joins processes into one program with ``jax.distributed``; the
port does the same with a ``torch.distributed`` process group:

1. every process calls :func:`initialize_distributed` first. The
   coordinator and the process numbers come from the arguments or the
   environment (``REDCLIFF_COORDINATOR`` / ``REDCLIFF_NUM_PROCESSES`` /
   ``REDCLIFF_PROCESS_ID``, then SLURM's ``SLURM_NTASKS`` /
   ``SLURM_PROCID``). The backend is NCCL when this process's mesh devices
   are CUDA (``torch.cuda.set_device`` first) and gloo for ``"cpu"``
   entries. The processes exchange their device lists once, so every
   process knows the global mesh: the ranks' local devices in rank order;
2. build the mesh with ``grid_mesh()`` (``parallel/mesh.py``), which spans
   every rank after initialization;
3. place grid-axis arrays with :func:`put_along_mesh`: each process
   materializes only the shards it owns;
4. every process runs the same grid program on its own shards; replicated
   inputs (the batches) are identical on every process;
5. read back with :func:`gather_to_host`, an all-gather, so every process
   sees the whole grid and makes the same decisions.

torch, numpy and the stdlib only; ``torch.distributed`` is touched only
once a coordinator is configured.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = [
    "initialize_distributed",
    "is_distributed",
    "process_index",
    "process_count",
    "global_devices",
    "put_along_mesh",
    "gather_to_host",
    "process_local_slice",
    "ShardedArray",
    "shutdown_distributed",
    "joined",
]

_initialized = False
# (devices, ranks) of the whole process group, exchanged at initialization
_GLOBAL = None


def _from_env(explicit, *names, cast=str):
    if explicit is not None:
        return explicit
    for name in names:
        val = os.environ.get(name)
        if val is not None:
            return cast(val)
    return None


def _local_devices(devices, local_device_ids):
    if devices is not None:
        return [torch.device(d) for d in devices]
    if local_device_ids is not None:
        return [torch.device("cuda", int(i)) for i in local_device_ids]
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    raise RuntimeError(
        "initialize_distributed: no CUDA device is visible and no devices "
        "were given; pass devices=['cpu', ...] for a gloo process group")


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None,
                           devices=None):
    """Join this process to the process group (idempotent). Returns True
    once joined, False without a coordinator (a single-process run).

    ``coordinator_address`` is ``host:port`` (``tcp://`` is added);
    ``devices`` are this process's mesh entries (default: ``cuda:i`` for
    ``local_device_ids``, else every visible CUDA device)."""
    global _initialized, _GLOBAL
    if _initialized:
        return True
    coordinator_address = _from_env(coordinator_address,
                                    "REDCLIFF_COORDINATOR")
    if coordinator_address is None:
        return False  # single-process run
    num_processes = _from_env(num_processes, "REDCLIFF_NUM_PROCESSES",
                              "SLURM_NTASKS", cast=int)
    process_id = _from_env(process_id, "REDCLIFF_PROCESS_ID", "SLURM_PROCID",
                           cast=int)
    local = _local_devices(devices, local_device_ids)
    cuda = all(d.type == "cuda" for d in local)
    if not cuda and any(d.type == "cuda" for d in local):
        raise ValueError("a process's mesh devices are all CUDA (NCCL) or "
                         "all CPU (gloo)")
    if cuda:
        torch.cuda.set_device(local[0])
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    import torch.distributed as dist

    dist.init_process_group("nccl" if cuda else "gloo", init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))
    table = [None] * int(num_processes)
    dist.all_gather_object(table, [str(d) for d in local])
    devs, ranks = [], []
    for r, names in enumerate(table):
        devs += [torch.device(n) for n in names]
        ranks += [r] * len(names)
    _GLOBAL = (devs, ranks)
    _initialized = True
    return True


def shutdown_distributed():
    """Leave the process group (the inverse of
    :func:`initialize_distributed`; a no-op outside one)."""
    global _initialized, _GLOBAL
    if not _initialized:
        return
    import torch.distributed as dist

    dist.destroy_process_group()
    _initialized = False
    _GLOBAL = None


def joined():
    """True once this process has joined a process group (of any size)."""
    return _initialized


def is_distributed():
    """True inside a process group of more than one process."""
    return _initialized and process_count() > 1


def process_index():
    if not _initialized:
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def process_count():
    if not _initialized:
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def global_devices():
    """``(devices, ranks)``: every rank's mesh entries in rank order."""
    if _GLOBAL is None:
        raise RuntimeError("global_devices() needs initialize_distributed()")
    return list(_GLOBAL[0]), list(_GLOBAL[1])


class ShardedArray:
    """A grid-axis array laid over a mesh: ``shape`` is the global shape,
    ``shards`` this process's ``{mesh index: tensor}``."""

    def __init__(self, shape, shards, mesh):
        self.shape = tuple(shape)
        self.shards = dict(shards)
        self.mesh = mesh


def put_along_mesh(x, mesh, axis_name="grid"):
    """Split ``x`` (host-replicated, leading axis = grid) over ``mesh``:
    each process materializes only the shards it owns, each a fresh tensor
    on its device."""
    from redcliff_tpu_torch.parallel.mesh import lane_bounds

    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x
    bounds = lane_bounds(int(t.shape[0]), mesh.size)
    shards = {i: t[bounds[i][0]:bounds[i][1]].to(mesh.devices[i], copy=True)
              for i in mesh.local_indices()}
    return ShardedArray(t.shape, shards, mesh)


def _gather_leaf(x):
    if isinstance(x, ShardedArray):
        mine = {i: s.detach().cpu().numpy() for i, s in x.shards.items()}
        if process_count() > 1:
            import torch.distributed as dist

            parts = [None] * process_count()
            dist.all_gather_object(parts, mine)
            mine = {i: a for p in parts for i, a in p.items()}
        return np.concatenate([mine[i] for i in sorted(mine)])
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gather_to_host(tree):
    """Full numpy values on every process: a :class:`ShardedArray` gathers
    its shards from every rank (a collective: every process calls it),
    tensors are copied to the host."""
    from redcliff_tpu_torch.interop import tree_map

    return tree_map(_gather_leaf, tree)


def process_local_slice(total, process_id=None, num_processes=None):
    """The contiguous ``[start, stop)`` block of grid points this process
    feeds when staging host-partitioned inputs."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    if total % n != 0:
        raise ValueError(f"grid size {total} not divisible by {n} processes")
    per = total // n
    return pid * per, (pid + 1) * per
