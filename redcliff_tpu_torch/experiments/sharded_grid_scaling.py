"""Port twin of ``experiments/sharded_grid_scaling.py``: steps/s of one
grid step with its grid axis sharded over 1, 2, 4 and 8 mesh entries.

The JAX script times a G-point grid step of the ``combined`` phase
(``RedcliffGridRunner._steps["combined"]``, G = 16 points, batch 32, the
D4IC headline model) on a virtual CPU mesh of 1/2/4/8 devices, one child
process per count (XLA fixes the host device count at backend init), and
asserts that the sharded program's output is the same on every mesh size.

The port's mesh is a list of devices (``parallel/mesh.py grid_mesh(
devices=...)``), so the twin runs every count in one process: the mesh is
``[device] * n`` (n = 1 runs without a mesh, as the JAX child does), each
count gets a fresh ``RedcliffGridRunner`` (:func:`build_runner`), the
inputs are the JAX child's numpy draws (:func:`make_inputs`), and each
step is every shard's ``_step("combined", ...)`` on its lanes, as the
fit's per-batch loop runs it (:func:`step_shards`: the ``_Shard`` views,
``_split`` / ``_gather``). One warm step is untimed, then ``--steps``
timed steps (:func:`timed_steps`); the clock is read after
``torch.cuda.synchronize()`` on the card. The fingerprint is the mean
|``factors[0].w``| over all lanes (:func:`fingerprint`), held to the JAX
script's bar across the counts (:func:`summarize`).

On one card the mesh is SIMULATED: n shards take turns on the same
device, so the rows measure sharding overhead, not speedup (the JSON's
``note`` says so and names the device). No point sets ``prox_penalty``,
so the GL prox does not run, as in the JAX child. It writes
``<workdir>/SHARDED_GRID_SCALING.json`` (never into ``experiments/``),
imports only ``redcliff_tpu_torch`` and runs on ``cuda`` unless
``main(argv, device=...)`` says otherwise.

Run:  python -m redcliff_tpu_torch.experiments.sharded_grid_scaling
      [workdir] [--grid 16] [--steps 8] [--batch 32]
"""
import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from redcliff_tpu_torch.interop import tree_map
from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                RedcliffSCMLPConfig)
from redcliff_tpu_torch.parallel import epoch_engine as _engines
from redcliff_tpu_torch.parallel.grid import GridSpec, RedcliffGridRunner
from redcliff_tpu_torch.parallel.mesh import grid_mesh
from redcliff_tpu_torch.runtime.numerics import init_numerics_state
from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig
from redcliff_tpu_torch.utils.precision import resolve_device

# the JAX child's model (the D4IC headline widths)
MODEL_CONFIG = dict(
    num_chans=10, gen_lag=4, gen_hidden=(32,), embed_lag=16,
    embed_hidden_sizes=(0,), num_factors=5, num_supervised_factors=5,
    factor_score_coeff=2.0, factor_cos_sim_coeff=0.05,
    factor_weight_l1_coeff=0.01, adj_l1_reg_coeff=0.001,
    factor_score_embedder_type="DGCNN", dgcnn_num_graph_conv_layers=3,
    dgcnn_num_hidden_nodes=100,
    primary_gc_est_mode="conditional_factor_fixed_embedder",
    num_sims=2, training_mode="combined")
DEVICE_COUNTS = (1, 2, 4, 8)
DEFAULT_WORKDIR = os.path.join("build", "study", "sharded_grid_scaling")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default=DEFAULT_WORKDIR)
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    return ap.parse_args(argv)


def grid_points(G):
    """The JAX child's G points: four gen_lr values by two ADJ_L1s."""
    return [{"gen_lr": 1e-3 * (1 + (i % 4)),
             "adj_l1_reg_coeff": 1e-3 * (i % 2)} for i in range(G)]


def build_runner(n_dev, G, B, device):
    """A fresh runner of the G points at batch ``B``, sharded over
    ``[device] * n_dev`` (no mesh for one entry)."""
    model = RedcliffSCMLP(RedcliffSCMLPConfig(**MODEL_CONFIG))
    mesh = grid_mesh(devices=[device] * n_dev) if n_dev > 1 else None
    return RedcliffGridRunner(model, RedcliffTrainConfig(batch_size=B),
                              GridSpec(points=grid_points(G)), mesh=mesh,
                              device=None if mesh is not None else device)


def make_inputs(cfg, B, device):
    """The JAX child's batch: ``X`` (B, max_lag + num_sims, C) normal and
    ``Y`` (B, S, 1) uniform, from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    T = cfg.max_lag + cfg.num_sims
    X = rng.normal(size=(B, T, cfg.num_chans)).astype(np.float32)
    Y = rng.uniform(size=(B, cfg.num_supervised_factors, 1)).astype(
        np.float32)
    return torch.from_numpy(X).to(device), torch.from_numpy(Y).to(device)


def initial_state(runner, init=None):
    """The execution-width state ``(params, embedder Adam, factor Adam,
    numerics counters, active lanes)`` on the runner's device: ``init`` (a
    real-width ``(params, optA, optB)`` of tensors on any device) or
    ``runner.init_grid(0)``."""
    state = init if init is not None else runner.init_grid(0)
    params, optA, optB = runner.pad_to_width(
        tree_map(lambda x: x.to(runner.device), state))
    width = int(runner._orig_ids0.size)
    nstate = init_numerics_state(lanes=width, device=runner.device)
    active = torch.as_tensor(runner._orig_ids0 >= 0, device=runner.device)
    return params, optA, optB, nstate, active


def split_state(runner, state):
    """The state as each shard's ``(params, optA, optB, nstate, active)``
    on its mesh entry (the one shard of an unmeshed runner is the state)."""
    params, optA, optB, nstate, active = state
    parts = [runner._split(t) for t in (params, optA, optB, nstate)]
    return [(*(p[j] for p in parts), a)
            for j, a in enumerate(runner._split_vec(active))]


def step_shards(runner, shards, X, Y, stats):
    """One ``combined`` step of every shard's lanes, in mesh order, each
    shard's kernel executions counted in ``stats["launches_by_shard"]``."""
    for sh, (P, A, B, N, act) in zip(runner._shards, shards):
        _engines.counted(stats, sh.index, lambda: sh._step(
            "combined", P, A, B, N, act, *_engines._on(sh.device, X, Y)))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_steps(runner, shards, X, Y, steps, stats):
    """One untimed warm step, then ``steps`` timed steps. Returns the
    seconds of the timed steps."""
    step_shards(runner, shards, X, Y, stats)
    _sync(runner.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        step_shards(runner, shards, X, Y, stats)
    _sync(runner.device)
    return time.perf_counter() - t0


def fingerprint(runner, shards):
    """Mean |factors[0].w| over every lane, gathered from the shards."""
    params = runner._gather([s[0] for s in shards])
    return float(torch.mean(torch.abs(params["factors"][0]["w"])))


def measure(n_dev, G, B, steps, device):
    """One device count's row (the JAX child's keys) and its kernel
    executions by shard."""
    runner = build_runner(n_dev, G, B, device)
    X, Y = make_inputs(runner.model.config, B, runner.device)
    shards = split_state(runner, initial_state(runner))
    stats = {}
    dt = timed_steps(runner, shards, X, Y, steps, stats)
    row = {"n_devices": n_dev, "step_s": dt / steps,
           "steps_per_s": steps / dt, "fingerprint": fingerprint(runner,
                                                                 shards)}
    return row, stats.get("launches_by_shard", {})


def device_label(device):
    """The device the simulated mesh's entries name: the card's name and
    power limit as ``nvidia-smi`` gives them, or ``cpu``."""
    if torch.device(device).type != "cuda":
        return "CPU device (cpu)"
    name = torch.cuda.get_device_name(torch.device(device))
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        limit = res.stdout.strip().splitlines()[0].split(",")[-1].strip()
        return f"{name} ({limit})"
    except (OSError, subprocess.SubprocessError, IndexError):
        return name


def summarize(rows, args, label):
    """The JSON the JAX script writes, after its bar: the fingerprints of
    every count within 1e-5 of the largest."""
    fps = [r["fingerprint"] for r in rows]
    spread = max(fps) - min(fps)
    if not spread < 1e-5 * max(abs(f) for f in fps):
        raise AssertionError(fps)
    base = rows[0]["step_s"]
    return {
        "config": {"grid_points": args.grid, "batch_size": args.batch,
                   "steps": args.steps,
                   "note": f"simulated mesh: n shards on one {label}; "
                           f"measures sharding overhead, not speedup"},
        "rows": [{**r, "step_time_vs_1dev": round(r["step_s"] / base, 3)}
                 for r in rows],
        "output_fingerprint_spread": spread,
    }


def main(argv=None, device=None, records=None):
    """Time the step at each of :data:`DEVICE_COUNTS` on ``device``
    (``cuda`` unless given: raises without CUDA). Returns the JSON it
    writes. ``records``, a dict, receives each count's kernel executions
    by shard (``records["launches_by_shard"][n]``)."""
    args = parse_args(argv)
    device = resolve_device(device)
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    rows, launches = [], {}
    for n_dev in DEVICE_COUNTS:
        t0 = time.time()
        row, launches[n_dev] = measure(n_dev, args.grid, args.batch,
                                       args.steps, device)
        row["wall_s"] = round(time.time() - t0, 1)
        rows.append(row)
        print(f"[scaling] {n_dev} devices: {row['steps_per_s']:.2f} steps/s "
              f"(step {row['step_s']*1e3:.1f} ms)", flush=True)
    if records is not None:
        records.update(launches_by_shard=launches)
    out = summarize(rows, args, device_label(device))
    dest = os.path.join(workdir, "SHARDED_GRID_SCALING.json")
    with open(dest, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[done] wrote {dest}", flush=True)
    return out


if __name__ == "__main__":
    main()
