"""Fault-injection harness: kill fits mid-run, corrupt checkpoints, poison
steps, flake probes (port of ``redcliff_tpu/runtime/faultinject.py``).

Fault points are env-gated (``REDCLIFF_FAULT_INJECT``), so the hooks in the
training loops cost one environment lookup when unarmed. Grammar: a
comma-separated list of ``name:arg``, as in JAX:

- ``sigkill_after_checkpoint:N`` — SIGKILL this process right after the
  grid's checkpoint for epoch N is written;
- ``marker_after_epoch:N`` — write the file named by
  ``REDCLIFF_FAULT_MARKER`` at the end of the grid's epoch N;
- ``hang_between_ckpt_replaces:S`` — inside the durable writer's crash
  window (head renamed to ``.prev``, new generation not yet promoted)
  write the marker file once and sleep S seconds;
- ``hang_in:COMPONENT[:S]`` — wedge the named component (sleep S
  seconds, default 3600) at its :func:`hang_point`, next to its watchdog
  heartbeat, once per marker file: ``prefetch``, ``shard_loader`` and
  ``ckpt_writer`` (the liveness watchdog, ``runtime/watchdog.py``, must
  notice);
- ``slow_io:MS`` — sleep MS milliseconds at every IO fault point
  (checkpoint writes, shard reads);
- ``io_error:KIND[:ERRNO]`` — raise an injected ``OSError`` (default
  ``ENOSPC``) at the named IO site (``ckpt_write``), once per marker file
  when ``REDCLIFF_FAULT_MARKER`` is set;
- numerical step points, consumed through :func:`poison_batch` /
  :func:`skip_update`, which the trainers call with a global step index
  (one step ``"5"`` or an inclusive range ``"5-8"``): ``nan_batch:SPEC``
  replaces the batch with NaNs, ``grad_blowup:SPEC`` scales it by 1e30,
  ``skip_update:SPEC`` skips the update entirely — the reference
  semantics of the numerics guard's skip: a fit with ``nan_batch:K`` ends
  bit-identical to one with ``skip_update:K``.

The fleet fault point, as in JAX: ``fleet_poison`` arms the ``__chaos__``
poison sentinels in fleet grid points (:func:`fleet_poison_armed`): the
batch driver (``fleet/run_batch.py``) detonates them (SIGKILL / exit N /
hang, ``fleet/chaos.py``) before the fit. Unarmed, it strips them and fits
the healthy points.

The host faults, as in JAX (``redcliff_tpu/runtime/faultinject.py:
181-211``), fire at the grid's ``epoch_end`` (default epoch 1, after that
epoch's checkpoint), once per marker file: ``host_drop:H[:E]`` raises
``parallel.remesh.HostLostError`` for host H, ``device_lost[:E]`` and
``coordinator_loss[:E]`` raise the backend-shaped errors that the grid
maps onto it (``remesh.classify_device_error``);
:func:`random_host_fault_schedule` composes a seeded one. The JAX
module's ``random_fault_schedule`` has no caller here and is not copied.

The child fit (``python -m redcliff_tpu_torch.runtime.faultinject``) is
one small deterministic port grid fit, identical in-process and as a
subprocess, so killed, resumed and uninterrupted legs compare bit for bit;
with ``--sharded`` it streams its data from on-disk shards
(:func:`tiny_sharded_fit`), so every heartbeat of the watchdog beats. It
runs on ``--device`` (``cuda`` unless given) and exits with the
watchdog taxonomy's codes (``runtime/watchdog.py``): 17 after a
preemption's final checkpoint, 20 after a grid deadline's, 21 when part
of its mesh is lost (``HostLostError``), and 19 when an armed watchdog
(``REDCLIFF_WATCHDOG``) hard-exits a hang. ``--grid-size`` and ``--mesh``
are JAX's: more points, sharded over the largest viable mesh of the
visible devices (``remesh.visible_mesh``, so the supervisor's
``REDCLIFF_MESH_DEVICES`` cap applies). ``--sim-devices N`` is the port's
own: the visible devices are N entries of ``--device``, the counterpart
of the forced host device count the JAX child inherits from
``XLA_FLAGS`` (one card, or the CPU, simulating an N-device mesh).
"""
from __future__ import annotations

import argparse
import errno as _errno
import os
import pickle
import random
import signal
import sys

from redcliff_tpu_torch.runtime.watchdog import (EXIT_DEADLINE,
                                                 EXIT_HOST_LOST,
                                                 EXIT_PREEMPTED)

__all__ = ["armed", "fleet_poison_armed", "crash_point",
           "ckpt_write_point", "poison_batch", "skip_update", "hang_point",
           "io_point", "io_error_point", "corrupt_checkpoint", "flaky",
           "tiny_grid_fit", "tiny_sharded_fit",
           "random_host_fault_schedule", "HOST_FAULT_KINDS",
           "EXIT_PREEMPTED", "EXIT_DEADLINE", "EXIT_HOST_LOST"]

ENV_SPEC = "REDCLIFF_FAULT_INJECT"
ENV_MARKER = "REDCLIFF_FAULT_MARKER"
# the host-fault grammar (all once per marker; all raise out of epoch_end)
HOST_FAULT_KINDS = ("host_drop", "device_lost", "coordinator_loss")


def _active_faults():
    spec = os.environ.get(ENV_SPEC)
    if not spec:
        return ()
    out = []
    for part in spec.split(","):
        name, _, arg = part.strip().partition(":")
        if name:
            out.append((name, arg))
    return tuple(out)


def armed():
    """True when ANY fault is armed."""
    return bool(os.environ.get(ENV_SPEC))


def fleet_poison_armed():
    """True when the fleet chaos grammar's ``fleet_poison`` fault is armed:
    the fleet batch driver then ACTS on ``__chaos__`` poison sentinels in
    grid points (fleet/chaos.py) instead of only stripping them."""
    return any(name == "fleet_poison" for name, _ in _active_faults())


def ckpt_write_point(stage, path=None):
    """Hook inside ``runtime.checkpoint.write_checkpoint``'s crash window
    (head renamed to ``.prev``, new generation not yet promoted):
    ``hang_between_ckpt_replaces:SECONDS`` writes the marker file (once)
    and sleeps, holding the window open so a parent can SIGKILL this
    process mid-write."""
    for name, arg in _active_faults():
        if (name == "hang_between_ckpt_replaces"
                and stage == "between_replaces"):
            marker = os.environ.get(ENV_MARKER)
            if marker and not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write(path or "")
                import time

                time.sleep(float(arg) if arg else 30.0)


def crash_point(stage, epoch=None):
    """Hook called by the grid's loop at named stages; inert unless a fault
    matching (stage, epoch) is armed."""
    for name, arg in _active_faults():
        if (name == "sigkill_after_checkpoint" and stage == "checkpoint_saved"
                and epoch == int(arg)):
            os.kill(os.getpid(), signal.SIGKILL)
        if (name == "marker_after_epoch" and stage == "epoch_end"
                and epoch == int(arg)):
            marker = os.environ.get(ENV_MARKER)
            if marker and not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write(str(epoch))
        if name in HOST_FAULT_KINDS and stage == "epoch_end":
            _host_fault(name, arg, epoch)


def _host_fault(name, arg, epoch):
    """Raise the armed host fault when its epoch matches (default: the end
    of epoch 1, after that epoch's checkpoint, so durable state exists as
    it would at a real host loss). Once per marker file: the re-meshed
    restart runs clean."""
    if name == "host_drop":
        host_s, _, ep_s = arg.partition(":")
        host = int(host_s) if host_s else 0
    else:
        host, ep_s = None, arg
    if epoch != (int(ep_s) if ep_s else 1) or not _once_guard(f".{name}"):
        return
    if name == "host_drop":
        from redcliff_tpu_torch.parallel.remesh import HostLostError

        raise HostLostError("host_drop", host=host,
                            detail=f"injected at epoch {epoch}")
    if name == "device_lost":
        # a backend-shaped device-loss text: the grid maps it through
        # remesh.classify_device_error to "device_lost"
        raise RuntimeError(
            f"INTERNAL: device lost: local device vanished mid-dispatch "
            f"(injected host fault, epoch {epoch})")
    raise RuntimeError(
        f"DEADLINE_EXCEEDED: coordinator heartbeat timed out; distributed "
        f"runtime service unavailable (injected host fault, epoch {epoch})")


def random_host_fault_schedule(seed, max_epoch=1, n_hosts=4):
    """One seeded host-fault schedule: a host drop, device loss or
    coordinator loss at a random epoch, sometimes with degraded-storage
    latency. Deterministic in ``seed`` (the JAX module's draws)."""
    r = random.Random(seed)
    kind = r.choice(HOST_FAULT_KINDS)
    ep = r.randint(0, max_epoch)
    if kind == "host_drop":
        fault = f"host_drop:{r.randrange(max(n_hosts, 1))}:{ep}"
    else:
        fault = f"{kind}:{ep}"
    faults = [fault]
    if r.random() < 0.5:
        faults.append(f"slow_io:{r.randint(1, 20)}")
    return ",".join(faults)


def _step_match(spec, step):
    """``"5"`` matches step 5; ``"5-8"`` matches steps 5..8 inclusive."""
    lo, sep, hi = spec.partition("-")
    if sep:
        return int(lo) <= step <= int(hi)
    return step == int(lo)


def poison_batch(X, step):
    """Numerical fault point: the trainers pass every training batch (a
    tensor on the fit's device) through this with their global step index.
    Inert (returns ``X``, one environment lookup) unless a ``nan_batch`` /
    ``grad_blowup`` fault matches ``step``; then a float32 batch of NaNs,
    or ``X`` scaled by 1e30, on ``X``'s device."""
    faults = _active_faults()
    if not faults:
        return X
    import torch

    for name, arg in faults:
        if name == "nan_batch" and _step_match(arg, step):
            return torch.full_like(X, float("nan"), dtype=torch.float32)
        if name == "grad_blowup" and _step_match(arg, step):
            # 1e30 overflows the squared-error loss/grads to inf in f32
            return X.to(torch.float32) * 1e30
    return X


def skip_update(step):
    """True when a ``skip_update`` fault matches ``step``: the trainer
    skips the parameter update entirely (batch drawn, rng advanced)."""
    for name, arg in _active_faults():
        if name == "skip_update" and _step_match(arg, step):
            return True
    return False


def _once_guard(suffix):
    """True when this fault may fire: with ``REDCLIFF_FAULT_MARKER`` set the
    fault fires once per marker (a ``<marker><suffix>`` guard file is
    written); without a marker it fires every time."""
    marker = os.environ.get(ENV_MARKER)
    if not marker:
        return True
    guard = marker + suffix
    if os.path.exists(guard):
        return False
    with open(guard, "w") as f:
        f.write(suffix)
    return True


def hang_point(component):
    """Liveness fault point: wedge ``component`` (sleep) when a matching
    ``hang_in:component:S`` fault is armed. Placed next to the component's
    heartbeat stamp, so the stamp stops and the watchdog must notice."""
    for name, arg in _active_faults():
        if name != "hang_in":
            continue
        comp, _, secs = arg.partition(":")
        if comp != component or not _once_guard(f".hang_{component}"):
            continue
        import time

        time.sleep(float(secs) if secs else 3600.0)


def io_point(kind):
    """Latency fault point: ``slow_io:MS`` sleeps MS milliseconds at every
    IO site (``kind`` is informational — degraded storage is global)."""
    for name, arg in _active_faults():
        if name == "slow_io":
            import time

            time.sleep((float(arg) if arg else 10.0) / 1e3)


def io_error_point(kind):
    """Disk-failure fault point: ``io_error:KIND[:ERRNO]`` raises an
    injected ``OSError`` (default ENOSPC) at the named IO site, once per
    marker file."""
    for name, arg in _active_faults():
        if name != "io_error":
            continue
        k, _, en = arg.partition(":")
        if k != kind or not _once_guard(f".ioerr_{kind}"):
            continue
        code = getattr(_errno, en, _errno.ENOSPC) if en else _errno.ENOSPC
        raise OSError(code, f"{os.strerror(code)} (injected at {kind})")


def corrupt_checkpoint(path, mode="truncate"):
    """Damage a checkpoint file in a controlled way: ``truncate`` cuts it to
    half its length (torn write / full disk); ``flip_payload`` inverts a
    byte past the header (silent media corruption the CRC must catch);
    ``zero_header`` wipes the magic+version header."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if mode == "truncate":
            f.truncate(max(size // 2, 1))
        elif mode == "flip_payload":
            off = min(40, size - 1)
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
        elif mode == "zero_header":
            f.write(b"\0" * min(8, size))
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")


def flaky(n_failures, value=True, exc=None):
    """A probe-shaped callable that fails ``n_failures`` times then succeeds:
    returns ``(False, 'injected failure k')`` (or raises ``exc``) while
    failing, then ``(value, 'ok')``."""
    state = {"calls": 0}

    def probe(_attempt=None):
        state["calls"] += 1
        if state["calls"] <= n_failures:
            if exc is not None:
                raise exc
            return False, f"injected failure {state['calls']}"
        return value, "ok"

    probe.calls = lambda: state["calls"]
    return probe


# ---------------------------------------------------------------------------
# the child fit: one small deterministic grid fit, identical whether run
# in-process or as a subprocess
# ---------------------------------------------------------------------------
def _tiny_runner(max_iter, bad_point=False, fit_deadline_s=None,
                 grid_deadline_s=None, device=None, grid_size=2,
                 use_mesh=False, sim_devices=None):
    """The harness's small grid runner (the JAX harness's model, points and
    train config) and its deterministic data arrays. ``grid_size`` > 2
    gives the JAX harness's larger grid; ``use_mesh`` shards it over the
    largest viable mesh of the visible devices — ``sim_devices`` entries of
    ``device`` when given (one device simulating a mesh), else the visible
    cards — capped by ``REDCLIFF_MESH_DEVICES``."""
    import numpy as np

    from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                    RedcliffSCMLPConfig)
    from redcliff_tpu_torch.parallel.grid import GridSpec, RedcliffGridRunner
    from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig

    model = RedcliffSCMLP(RedcliffSCMLPConfig(
        num_chans=4, gen_lag=2, gen_hidden=(8,), embed_lag=4,
        embed_hidden_sizes=(8,), num_factors=2, num_supervised_factors=2,
        factor_weight_l1_coeff=0.01, adj_l1_reg_coeff=0.001,
        factor_cos_sim_coeff=0.01,
        factor_score_embedder_type="Vanilla_Embedder",
        primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
        training_mode="combined"))
    # 1e20: Adam bounds the step to ~lr, so the poison lr must push params
    # past sqrt(f32 max) for the squared error to overflow within an epoch
    if grid_size == 2:
        points = [{"gen_lr": 1e-3},
                  ({"gen_lr": 1e20, "embed_lr": 1e20} if bad_point
                   else {"gen_lr": 3e-3})]
    else:
        points = [{"gen_lr": 1e-3 * (1 + 0.5 * i)} for i in range(grid_size)]
        if bad_point:
            points[-1] = {"gen_lr": 1e20, "embed_lr": 1e20}
    tc = RedcliffTrainConfig(max_iter=max_iter, batch_size=16, check_every=1,
                             seed=0)
    spec = GridSpec(points=points, fit_deadline_s=fit_deadline_s,
                    grid_deadline_s=grid_deadline_s)
    mesh = None
    if use_mesh:
        from redcliff_tpu_torch.parallel import remesh

        devices = ([device or "cuda"] * int(sim_devices)
                   if sim_devices else None)
        mesh = remesh.visible_mesh(devices=devices, n_lanes=len(points))
        device = None
    runner = RedcliffGridRunner(model, tc, spec, mesh=mesh, device=device)
    cfg = model.config
    rng = np.random.default_rng(0)
    T = cfg.max_lag + cfg.num_sims
    X = rng.normal(size=(48, T, cfg.num_chans)).astype(np.float32)
    Y = rng.uniform(size=(48, 3, 1)).astype(np.float32)
    return runner, X, Y


def tiny_grid_fit(checkpoint_dir, max_iter=4, checkpoint_every=1,
                  bad_point=False, fit_deadline_s=None, grid_deadline_s=None,
                  device=None, grid_size=2, use_mesh=False, sim_devices=None):
    """Run the harness's small grid fit (seed 2, as the JAX harness's key)
    and return its GridResult; ``checkpoint_dir`` is also the fit's log
    dir. ``bad_point`` gives the last point an absurd learning rate that
    drives it non-finite within an epoch; ``grid_size`` / ``use_mesh`` /
    ``sim_devices``: see :func:`_tiny_runner` (the mesh-sharded child of
    the host-fault tests). Two calls with the same arguments give
    bit-identical results on the same device."""
    from redcliff_tpu_torch.data.datasets import ArrayDataset

    runner, X, Y = _tiny_runner(max_iter, bad_point=bad_point,
                                fit_deadline_s=fit_deadline_s,
                                grid_deadline_s=grid_deadline_s,
                                device=device, grid_size=grid_size,
                                use_mesh=use_mesh, sim_devices=sim_devices)
    ds = ArrayDataset(X, Y)
    return runner.fit(2, ds, ds, checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every,
                      log_dir=checkpoint_dir)


def tiny_sharded_fit(checkpoint_dir, max_iter=4, checkpoint_every=1,
                     fit_deadline_s=None, grid_deadline_s=None, device=None):
    """The supervised-run child: the same small grid fit, streamed from
    on-disk shards so the host path runs every watchdog-stamped component
    — the per-batch loop, the prefetcher, the shard loader and the async
    checkpoint writer. The shards are written deterministically under
    ``<checkpoint_dir>/shards`` (idempotent, so a restarted attempt reuses
    them) and the fit is bit-identical across restarts."""
    from redcliff_tpu_torch.data.shards import ShardedBatchDataset
    from redcliff_tpu_torch.runtime import watchdog

    runner, X, Y = _tiny_runner(max_iter, fit_deadline_s=fit_deadline_s,
                                grid_deadline_s=grid_deadline_s,
                                device=device)
    split = os.path.join(checkpoint_dir, "shards", "train")
    if not os.path.isdir(split):
        os.makedirs(split)
        half = len(X) // 2
        for i, sl in enumerate((slice(0, half), slice(half, None))):
            with open(os.path.join(split, f"subset_{i}.pkl"), "wb") as f:
                pickle.dump([[x, y] for x, y in zip(X[sl], Y[sl])], f)
    # the construction-time stats pass reads every shard: a read wedged
    # there would hang before the fit's own watchdog exists
    with watchdog.maybe_start():
        train = ShardedBatchDataset(split)
        val = ShardedBatchDataset(split)
    return runner.fit(2, train, val, checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every,
                      log_dir=checkpoint_dir)


def _result_blob(result):
    import numpy as np

    from redcliff_tpu_torch.interop import tree_leaves

    return {
        "val_history": np.asarray(result.val_history),
        "best_criteria": np.asarray(result.best_criteria),
        "best_epoch": np.asarray(result.best_epoch),
        "active": np.asarray(result.active),
        "failures": result.failures,
        "best_params_leaves": [np.asarray(leaf) for leaf
                               in tree_leaves(result.best_params)],
    }


def _parse_deadlines(spec):
    """``"inf,0.05"`` -> per-lane deadline list; ``"30"`` -> scalar."""
    if spec is None:
        return None
    parts = [float(p) for p in spec.split(",")]
    return parts[0] if len(parts) == 1 else parts


def _child_main(argv):
    ap = argparse.ArgumentParser(
        prog="python -m redcliff_tpu_torch.runtime.faultinject",
        description="One small deterministic port grid fit, for fault "
                    "tests (kill, resume, compare).")
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--max-iter", type=int, default=4)
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--bad-point", action="store_true")
    ap.add_argument("--sharded", action="store_true",
                    help="stream the data from on-disk shards (runs the "
                         "prefetch and shard-loader heartbeats)")
    ap.add_argument("--grid-size", type=int, default=2,
                    help="number of grid points (2 = the small fit; larger "
                         "= the mesh-shaped host-fault child)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the grid over the largest viable mesh of the "
                         "visible devices (REDCLIFF_MESH_DEVICES-capped: the "
                         "supervisor's re-mesh decisions apply)")
    ap.add_argument("--sim-devices", type=int, default=None,
                    help="with --mesh: the visible devices are this many "
                         "entries of --device (one device simulating a "
                         "mesh)")
    ap.add_argument("--fit-deadline-s", default=None,
                    help="per-lane wall-clock budget(s), comma separated")
    ap.add_argument("--grid-deadline-s", type=float, default=None)
    ap.add_argument("--result", default=None,
                    help="write the finished fit's result blob here")
    ap.add_argument("--device", default="cuda",
                    help="the fit's device (default cuda)")
    args = ap.parse_args(argv)

    from redcliff_tpu_torch.parallel.remesh import HostLostError
    from redcliff_tpu_torch.runtime.preempt import DeadlineExceeded, Preempted

    kw = dict(max_iter=args.max_iter,
              checkpoint_every=args.checkpoint_every,
              fit_deadline_s=_parse_deadlines(args.fit_deadline_s),
              grid_deadline_s=args.grid_deadline_s, device=args.device)
    try:
        if args.sharded:
            result = tiny_sharded_fit(args.checkpoint_dir, **kw)
        else:
            result = tiny_grid_fit(args.checkpoint_dir,
                                   bad_point=args.bad_point,
                                   grid_size=args.grid_size,
                                   use_mesh=args.mesh,
                                   sim_devices=args.sim_devices, **kw)
    except HostLostError as e:
        # part of the mesh is gone: the durable checkpoint holds gathered
        # host state, so the supervisor's answer is a smaller
        # REDCLIFF_MESH_DEVICES and a restart
        print(f"faultinject child: {e}", file=sys.stderr)
        raise SystemExit(EXIT_HOST_LOST)
    except Preempted as e:
        print(f"faultinject child: {e}", file=sys.stderr)
        import json

        with open(os.path.join(args.checkpoint_dir, "preempted.json"),
                  "w") as f:
            json.dump({"signum": e.signum, "epoch": e.epoch}, f)
        raise SystemExit(EXIT_PREEMPTED)
    except DeadlineExceeded as e:
        print(f"faultinject child: {e}", file=sys.stderr)
        raise SystemExit(EXIT_DEADLINE)
    if args.result:
        with open(args.result, "wb") as f:
            pickle.dump(_result_blob(result), f)


if __name__ == "__main__":
    _child_main(sys.argv[1:])
