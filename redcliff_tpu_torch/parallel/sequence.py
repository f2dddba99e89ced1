"""Sequence parallelism: ring attention over a device mesh (port of
``redcliff_tpu/parallel/sequence.py``).

The JAX module shards the time axis over a mesh and runs ring attention
(Liu et al., arXiv:2310.01889) under ``shard_map``:

* every device holds one contiguous block of Q/K/V along time;
* the K/V blocks rotate around the ring, device ``i`` to ``i + 1``, so
  per-device memory stays O(T / n) instead of O(T);
* each device folds every visiting K/V block into an online softmax
  (running max and normaliser, the ``-1e30`` mask, causal masking on
  GLOBAL positions: a block's offset is tracked through the rotation).

The port runs the same recurrence in plain PyTorch, as the JAX version is
plain ``jnp`` (no Pallas kernel): block ``i`` lives on ``mesh.devices[i]``
and its folds run there. Within one process a rotation moves each block to
the next entry's device (nothing moves when two entries name one card); in
a process group a block whose neighbour belongs to another rank goes there
through ``torch.distributed.batch_isend_irecv``. As in JAX the last
visiting block is folded without issuing its (unused) rotation.

torch and the stdlib only.
"""
from __future__ import annotations

import math

import torch

__all__ = ["ring_attention", "seq_mesh", "sequence_sharded",
           "sequence_gathered"]

_NEG = -1e30  # softmax mask value; avoids -inf NaNs for fully-masked rows


def seq_mesh(n_devices=None, axis_name="seq", devices=None):
    """1-D mesh over the sequence axis (grid_mesh with a "seq" axis)."""
    from redcliff_tpu_torch.parallel.mesh import grid_mesh

    return grid_mesh(n_devices, axis_name=axis_name, devices=devices)


def _check_blocks(T, n):
    assert T % n == 0, (
        f"sequence length {T} not divisible by mesh size {n}")


def sequence_sharded(x, mesh, axis_name="seq", time_axis=1):
    """``x`` split along ``time_axis`` into one contiguous block per mesh
    entry, block ``i`` on ``mesh.devices[i]``: the list of this process's
    blocks (every block outside a process group)."""
    del axis_name
    T = x.shape[time_axis]
    _check_blocks(T, mesh.size)
    per = T // mesh.size
    return [x.narrow(time_axis, i * per, per).to(mesh.devices[i])
            for i in mesh.local_indices()]


def sequence_gathered(blocks, mesh, device=None, time_axis=1):
    """The inverse of :func:`sequence_sharded` within one process: the
    blocks joined along ``time_axis`` on ``device`` (default: the first
    block's)."""
    del mesh
    device = blocks[0].device if device is None else device
    return torch.cat([b.to(device) for b in blocks], dim=time_axis)


def _rotate(blocks, mesh, local):
    """One ring step: entry ``i``'s block moves to entry ``i + 1``. Returns
    the blocks this process holds afterwards, in ``local`` order."""
    n = mesh.size
    pos = {i: j for j, i in enumerate(local)}
    out = [None] * len(local)
    ops = []
    import torch.distributed as dist

    me = dist.get_rank() if dist.is_initialized() else 0
    for j, i in enumerate(local):
        src = (i - 1) % n
        if src in pos:
            out[j] = blocks[pos[src]].to(mesh.devices[i])
        else:
            buf = torch.empty_like(blocks[j])
            ops.append(dist.P2POp(dist.irecv, buf, mesh.ranks[src],
                                  tag=i))
            out[j] = buf
        dst = (i + 1) % n
        if mesh.ranks[dst] != me:
            ops.append(dist.P2POp(dist.isend, blocks[j].contiguous(),
                                  mesh.ranks[dst], tag=dst))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _fold(q, k_cur, v_cur, m, l, o, scale, causal, q_pos, src, T_loc):
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_cur) * scale
    if causal:
        k_pos = src * T_loc + torch.arange(T_loc, device=q.device)
        keep = k_pos[None, None, None, :] <= q_pos[None, None, :, None]
        logits = torch.where(keep, logits,
                             torch.full_like(logits, _NEG))
    m_cur = logits.amax(dim=-1)
    m_new = torch.maximum(m, m_cur)
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_cur)
    return m_new, l_new, o_new


def ring_attention(q, k, v, mesh, axis_name="seq", causal=False, scale=None):
    """Exact multi-head attention with the time axis sharded over ``mesh``.

    ``q, k, v``: (B, T, H, D) tensors, T divisible by the mesh size (this
    call splits them and returns a (B, T, H, D) tensor on ``q``'s device),
    or lists of this process's time blocks as :func:`sequence_sharded`
    gives them (returns the output blocks, each on its device). ``causal``
    masks future keys by global position; ``scale`` defaults to
    1/sqrt(D)."""
    n = mesh.size
    local = mesh.local_indices()
    whole = isinstance(q, torch.Tensor)
    if whole:
        T = q.shape[1]
        _check_blocks(T, n)
        out_dev = q.device
        q, k, v = (sequence_sharded(t, mesh, axis_name) for t in (q, k, v))
    else:
        T = q[0].shape[1] * n
    D = q[0].shape[3]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    T_loc = T // n
    state = []
    for j, i in enumerate(local):
        B, _, H, _ = q[j].shape
        dev, dt = q[j].device, q[j].dtype
        state.append([torch.full((B, H, T_loc), _NEG, dtype=dt, device=dev),
                      torch.zeros((B, H, T_loc), dtype=dt, device=dev),
                      torch.zeros((B, H, T_loc, D), dtype=dt, device=dev)])
    q_pos = [i * T_loc + torch.arange(T_loc, device=q[j].device)
             for j, i in enumerate(local)]
    k_cur, v_cur = list(k), list(v)
    for step in range(n):
        # after `step` rotations entry i holds the block of entry i - step
        for j, i in enumerate(local):
            src = (i - step) % n
            state[j] = list(_fold(q[j], k_cur[j], v_cur[j], *state[j],
                                  scale, causal, q_pos[j], src, T_loc))
        if step < n - 1:  # the last block's rotation is never issued
            k_cur = _rotate(k_cur, mesh, local)
            v_cur = _rotate(v_cur, mesh, local)
    out = []
    for m, l, o in state:
        o = o / torch.clamp_min(l, 1e-30)[..., None]  # (B, H, T_loc, D)
        out.append(o.permute(0, 2, 1, 3))
    if whole:
        return sequence_gathered(out, mesh, out_dev)
    return out
