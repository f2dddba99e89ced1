"""Device-mesh helpers for grid and factor parallelism (port of
``redcliff_tpu/parallel/mesh.py``).

The JAX package shards the grid's lane axis over a 1-D ``jax.sharding.Mesh``
and lets XLA partition the vmapped step. The port's mesh is the same 1-D
object written out: a tuple of ``torch.device`` entries and one axis name.
A lane shard is the contiguous block ``P("grid")`` gives — shard ``i`` of an
``n``-device mesh holds lanes ``[i*w/n, (i+1)*w/n)`` of a width-``w`` grid
on ``devices[i]`` — and each shard launches the kernels itself, on its own
device and stream.

A mesh may name the same device more than once when the caller asks for it
(``devices=["cpu"] * 8`` in the tests, ``[cuda:0] * 4`` on one card): the
shards are then distinct tensors on one device, run one after another. This
is the port's counterpart of JAX's forced host device count
(``--xla_force_host_platform_device_count``), with which the JAX package
tests its mesh on one CPU. By default a mesh covers the distinct visible
CUDA devices; without CUDA and without ``devices`` there is no mesh to
build, and :func:`grid_mesh` raises rather than quietly meshing the CPU.

In a process group (``parallel/distributed.py``) every entry also names the
rank that owns it: the global mesh is the ranks' local meshes in rank
order, and a process materializes only its own shards.

torch and the stdlib only.
"""
from __future__ import annotations

import torch

from redcliff_tpu_torch.interop import tree_map

__all__ = ["DeviceMesh", "Mesh", "grid_mesh", "shard_leading_axis",
           "replicated", "shard_factor_axis", "unshard_factor_axis",
           "FactorShards", "factor_slices", "lane_bounds", "canonical"]


def canonical(device):
    """``device`` as a mesh names it: a CUDA device without an index is
    the current one (``cuda`` -> ``cuda:0``)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceMesh:
    """A 1-D device mesh: ``devices`` (a tuple of ``torch.device``, an
    entry may repeat), ``axis_names`` (one name) and ``size``. ``ranks``
    names the process that owns each entry (all this process's outside a
    process group)."""

    def __init__(self, devices, axis_names=("grid",), ranks=None):
        self.devices = tuple(canonical(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 1:
            raise ValueError(f"the port's mesh is 1-D; got axis names "
                             f"{self.axis_names}")
        if ranks is None:
            from redcliff_tpu_torch.parallel import distributed

            ranks = (distributed.process_index(),) * len(self.devices)
        self.ranks = tuple(int(r) for r in ranks)
        if len(self.ranks) != len(self.devices):
            raise ValueError("one owning rank per mesh entry")

    @property
    def size(self):
        return len(self.devices)

    def local_indices(self):
        """The mesh entries this process owns, in mesh order."""
        from redcliff_tpu_torch.parallel import distributed

        me = distributed.process_index()
        return [i for i, r in enumerate(self.ranks) if r == me]

    def sub(self, n):
        """The sub-mesh over the first ``n`` entries."""
        return DeviceMesh(self.devices[:n], self.axis_names, self.ranks[:n])

    def __repr__(self):
        return (f"DeviceMesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")


Mesh = DeviceMesh


def _visible_cuda():
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def grid_mesh(n_devices=None, axis_name="grid", devices=None):
    """1-D mesh over the distinct visible CUDA devices ``cuda:0 ..
    cuda:{n-1}`` (or the first ``n_devices``), or over ``devices`` when the
    caller names them; an entry may repeat (one card simulating a larger
    mesh, as JAX's forced CPU device count does). In a process group
    without ``devices`` the mesh spans every rank's devices (as
    ``jax.devices()`` is global once joined). Raises without CUDA and
    without ``devices``."""
    ranks = None
    if devices is None:
        from redcliff_tpu_torch.parallel import distributed

        if distributed.joined():
            devs, ranks = distributed.global_devices()
        else:
            devs = _visible_cuda()
        if not devs:
            raise RuntimeError(
                "grid_mesh: no CUDA device is visible and no devices were "
                "given; pass devices=[...] (e.g. ['cpu'] * n) to build a "
                "mesh on the CPU")
    else:
        devs = list(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
        ranks = ranks[:n_devices] if ranks is not None else None
    return DeviceMesh(devs, (axis_name,), ranks)


def lane_bounds(width, n):
    """The ``(lo, hi)`` lane block of each of ``n`` shards of a
    ``width``-lane axis (``P(axis)``: contiguous, equal blocks)."""
    if width % n:
        raise ValueError(f"width {width} does not divide over {n} devices")
    per = width // n
    return [(i * per, (i + 1) * per) for i in range(n)]


def shard_leading_axis(mesh, axis_name="grid"):
    """The placement of a tensor split along axis 0 over ``mesh``: a
    function taking a tensor to the list of this process's shards, each a
    fresh contiguous tensor on its device."""
    def place(x):
        bounds = lane_bounds(int(x.shape[0]), mesh.size)
        return [x[lo:hi].to(mesh.devices[i], copy=True)
                for i, (lo, hi) in enumerate(bounds)
                if i in set(mesh.local_indices())]
    return place


def replicated(mesh):
    """The placement of a replicated tensor: one copy per distinct device
    of this process's shards (a function, as :func:`shard_leading_axis`)."""
    def place(x):
        out = {}
        for i in mesh.local_indices():
            d = mesh.devices[i]
            if str(d) not in out:
                out[str(d)] = x.to(d)
        return list(out.values())
    return place


class FactorShards(list):
    """The K factor networks split over a factor mesh: one factor tree per
    mesh entry, each with a ``(K/n, ...)`` leading axis on its device, in
    mesh order. A list, so tree maps, optimizers and checkpoints walk it as
    any other subtree; the model recognizes it and runs each block's
    factors on the block's device (``models/redcliff.py``)."""


def factor_slices(shards):
    """The ``(lo, hi)`` K range of every block of a :class:`FactorShards`."""
    from redcliff_tpu_torch.interop import tree_leaves

    out, lo = [], 0
    for tree in shards:
        k = int(tree_leaves(tree)[0].shape[0])
        out.append((lo, lo + k))
        lo += k
    return out


def shard_factor_axis(params, mesh, axis_name=None):
    """Expert-style factor parallelism: the K factor networks are a dense
    MoE, so their stacked leaves (leading K axis on every
    ``params["factors"]`` leaf) split over the mesh like experts — factor
    k's leaves on ``devices[k // (K/n)]`` — while the embedder stays on
    ``devices[0]``. Returns a params tree whose ``"factors"`` is a
    :class:`FactorShards`. K must be divisible by the mesh size; the
    assertion keeps JAX's text."""
    del axis_name  # a 1-D mesh has one axis, whatever its name
    factors = params["factors"]
    if isinstance(factors, FactorShards):
        factors = unshard_factor_axis(params, mesh.devices[0])["factors"]
    from redcliff_tpu_torch.interop import tree_leaves

    K = int(tree_leaves(factors)[0].shape[0])
    n = mesh.size
    assert K % n == 0, (
        f"num_factors {K} must divide by the factor mesh size {n}")
    per = K // n
    blocks = FactorShards(
        tree_map(lambda x, _i=i: x[_i * per:(_i + 1) * per].to(
            mesh.devices[_i], copy=True).contiguous(), factors)
        for i in range(n))
    out = dict(params)
    out["factors"] = blocks
    for key, sub in params.items():
        if key != "factors":
            out[key] = tree_map(lambda x: x.to(mesh.devices[0]), sub)
    return out


def unshard_factor_axis(params, device=None):
    """The inverse of :func:`shard_factor_axis`: the factor blocks joined
    along K on ``device`` (default: the first block's), the tree the
    unsharded model takes. A tree without factor blocks passes through."""
    factors = params["factors"]
    if not isinstance(factors, FactorShards):
        return params
    from redcliff_tpu_torch.interop import tree_leaves

    if device is None:
        device = tree_leaves(factors[0])[0].device
    joined = tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]),
                      *factors)
    return dict(params, factors=joined)
