"""The sharded-grid scaling curve in the port: the twin
``redcliff_tpu_torch/experiments/sharded_grid_scaling.py`` of the JAX
package's ``experiments/sharded_grid_scaling.py``.

The JAX script is read with ``ast``, never imported: its child program's
model, grid points, inputs and printed row, its device counts, its
fingerprint bar and the key set of its JSON are held to the twin's. At a
tiny width (the child's model with narrow DGCNN and factors, G = 4, B =
8) the twin's sharded step on ``["cpu"] * n``, n in {1, 2, 4}, from one
JAX grid init (``interop.grid_state_from_jax``) matches JAX's
``runner._steps["combined"]`` on ``grid_mesh(n)`` (the conftest's virtual
8-device CPU mesh) over 2 steps at the grid bars of
tests/test_torch_grid.py, and the port's fingerprints are bitwise equal
across n (its params are not: with the DGCNN embedder the vmapped GEMMs
round by lane count on the CPU as on the card, ~1e-7 here). A ``gpu``
case holds the card's sharded step to its unsharded one at those bars.
"""
import ast
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.parallel import grid as jgrid  # noqa: E402
from redcliff_tpu.parallel import mesh as jmesh  # noqa: E402
from redcliff_tpu.runtime.numerics import init_numerics_state as jnumerics  # noqa: E402,E501
from redcliff_tpu.train import redcliff_trainer as jtr  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.experiments import sharded_grid_scaling as SG  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "experiments", "sharded_grid_scaling.py")

# the grid bars (ROADMAP "Tolerances", tests/test_torch_grid.py)
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)

# the child's model at a tiny width; 4 points, batch 8, 2 steps
TINY_MODEL = dict(gen_hidden=(4,), dgcnn_num_graph_conv_layers=1,
                  dgcnn_num_hidden_nodes=8)
G, B, STEPS = 4, 8, 2


def _tree():
    return ast.parse(open(SCRIPT).read())


def _def(name):
    return next(n for n in _tree().body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _child(g=16, b=32, steps=8):
    """The JAX child program's source as the script formats it."""
    src = next(n.value.value for n in _tree().body
               if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "CHILD")
    return ast.parse(src.format(repo=REPO, G=g, B=b, STEPS=steps))


def _call(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == name)


def test_child_model_points_inputs_and_counts_are_transcribed():
    child = _child()
    cfg = _call(child, "RedcliffSCMLPConfig")
    assert SG.MODEL_CONFIG == {k.arg: ast.literal_eval(k.value)
                               for k in cfg.keywords}
    spec = _call(child, "GridSpec")
    for g in (4, 16):
        want = eval(compile(ast.Expression(spec.keywords[0].value), SCRIPT,
                            "eval"), {"G": g})
        assert SG.grid_points(g) == want
    loop = next(n for n in ast.walk(_def("main")) if isinstance(n, ast.For))
    assert SG.DEVICE_COUNTS == ast.literal_eval(loop.iter)
    args = SG.parse_args([])
    for flag, value in (("--grid", args.grid), ("--steps", args.steps),
                        ("--batch", args.batch)):
        call = next(n for n in ast.walk(_def("main"))
                    if isinstance(n, ast.Call) and n.args
                    and getattr(n.args[0], "value", None) == flag)
        assert value == next(ast.literal_eval(k.value)
                             for k in call.keywords if k.arg == "default")
    assert (args.grid, args.steps, args.batch) == (16, 8, 32)
    # the inputs: the child's draws from default_rng(0)
    cfg = SG.RedcliffSCMLPConfig(**SG.MODEL_CONFIG)
    X, Y = SG.make_inputs(cfg, 32, "cpu")
    rng = np.random.default_rng(0)
    T = cfg.max_lag + cfg.num_sims
    np.testing.assert_array_equal(
        X.numpy(), rng.normal(size=(32, T, 10)).astype(np.float32))
    np.testing.assert_array_equal(
        Y.numpy(), rng.uniform(size=(32, 5, 1)).astype(np.float32))


def _jax_row_keys():
    child = _child()
    dumps = next(n for n in ast.walk(child) if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", None) == "dumps")
    return {k.value for k in dumps.args[0].keys}


def _jax_summary(rows):
    """The JAX ``main``'s statements from the fingerprint bar to ``out``,
    exec'd on ``rows``."""
    body = _def("main").body
    start = next(i for i, s in enumerate(body) if isinstance(s, ast.Assign)
                 and getattr(s.targets[0], "id", None) == "fps")
    end = next(i for i, s in enumerate(body) if isinstance(s, ast.Assign)
               and getattr(s.targets[0], "id", None) == "out")
    ns = {"rows": rows, "args": SG.parse_args([])}
    exec(compile(ast.Module(body=body[start:end + 1], type_ignores=[]),
                 SCRIPT, "exec"), ns)
    return ns["out"]


@pytest.mark.parametrize("fps", [(0.25, 0.25, 0.25, 0.25),
                                 (0.25, 0.25 + 2e-6, 0.25, 0.25),
                                 (0.25, 0.25 + 3e-6, 0.25, 0.25)])
def test_summary_and_bar_match_the_jax_scripts(fps):
    """The JSON of crafted rows, and the fingerprint bar (inside at a
    spread of 2e-6 on 0.25, outside at 3e-6), as the JAX ``main``'s."""
    rows = [{"n_devices": n, "step_s": 0.1 * (1 + i), "steps_per_s": 1.0,
             "fingerprint": fp, "wall_s": 1.0}
            for i, (n, fp) in enumerate(zip(SG.DEVICE_COUNTS, fps))]
    args = SG.parse_args([])
    try:
        want = _jax_summary([dict(r) for r in rows])
    except AssertionError:
        with pytest.raises(AssertionError):
            SG.summarize(rows, args, "CPU device (cpu)")
        assert fps[1] - fps[0] > 2.5e-6
        return
    got = SG.summarize(rows, args, "CPU device (cpu)")
    assert set(got) == set(want)
    assert set(got["config"]) == set(want["config"])
    assert got["rows"] == want["rows"]
    assert got["output_fingerprint_spread"] == want[
        "output_fingerprint_spread"]
    assert got["config"]["note"] == (
        "simulated mesh: n shards on one CPU device (cpu); measures "
        "sharding overhead, not speedup")


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's combined step, 2 steps (the child's warm step and one more)
    at each mesh size from the one grid init; the init as numpy."""
    cfg = dict(SG.MODEL_CONFIG, **TINY_MODEL)
    out, init = {}, None
    for n in (1, 2, 4):
        model = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**cfg))
        mesh = jmesh.grid_mesh(n) if n > 1 else None
        runner = jgrid.RedcliffGridRunner(
            model, jtr.RedcliffTrainConfig(batch_size=B),
            jgrid.GridSpec(points=SG.grid_points(G)), mesh=mesh)
        X, Y = (jax.device_put(t.numpy()) for t in SG.make_inputs(
            SG.RedcliffSCMLPConfig(**cfg), B, "cpu"))
        state = runner.init_grid(jax.random.PRNGKey(0))
        if init is None:
            init = jax.tree.map(np.array, state)
        p, a, b = state
        ns = jnumerics(lanes=G)
        active = jax.numpy.ones((G,), dtype=bool)
        step = runner._steps["combined"]
        for _ in range(STEPS):
            p, a, b, ns, _ = step(p, a, b, ns, runner.coeffs, active, X, Y)
        out[n] = jax.tree.map(np.array, p)
    return init, out


def _port_steps(n, init, monkeypatch, device="cpu"):
    """The twin's stages on ``[device] * n``: the runner, the inputs, the
    state from ``init``, one warm and one timed step. Returns the gathered
    params, the fingerprint and the launches by shard."""
    monkeypatch.setattr(SG, "MODEL_CONFIG", dict(SG.MODEL_CONFIG,
                                                 **TINY_MODEL))
    runner = SG.build_runner(n, G, B, torch.device(device))
    X, Y = SG.make_inputs(runner.model.config, B, runner.device)
    shards = SG.split_state(runner, SG.initial_state(runner, init))
    stats = {}
    SG.timed_steps(runner, shards, X, Y, STEPS - 1, stats)
    params = runner._gather([s[0] for s in shards])
    return params, SG.fingerprint(runner, shards), stats


def test_sharded_steps_match_jax_mesh_steps(jax_steps, monkeypatch):
    """From one JAX init, the port's step on 1, 2 and 4 CPU entries
    against JAX's on ``grid_mesh`` of the same size, at the grid bars; the
    port's params across n at those bars and its fingerprints bitwise
    equal; JAX's fingerprint expression on its params at the bars."""
    init, jout = jax_steps
    fps, first = [], None
    for n in (1, 2, 4):
        state = interop.grid_state_from_jax(*init)
        params, fp, stats = _port_steps(n, state, monkeypatch)
        assert sorted(stats["launches_by_shard"]) == [str(i)
                                                      for i in range(n)]
        leaves = [np.asarray(x) for x in interop.tree_leaves(params)]
        for a, b in zip(jax.tree.leaves(jout[n]), leaves):
            np.testing.assert_allclose(b, a, **PARAMS)
        want = float(jax.numpy.mean(jax.numpy.abs(
            jout[n]["factors"][0]["w"])))
        np.testing.assert_allclose(fp, want, **HIST)
        # the DGCNN embedder's vmapped GEMMs round by lane count on the
        # CPU too (params within ~1e-7 of one entry's): the bar, not bits
        if first is None:
            first = leaves
        for a, b in zip(first, leaves):
            np.testing.assert_allclose(b, a, **PARAMS)
        fps.append(fp)
    assert fps[0] == fps[1] == fps[2]


def test_main_writes_the_jax_scripts_keys_into_its_work_dir(tmp_path,
                                                           monkeypatch):
    """``main`` on the CPU at the tiny width: every row has the JAX
    child's keys plus ``wall_s`` and ``step_time_vs_1dev``, the JSON the
    JAX script's keys, written under the work dir only; the fingerprints
    bitwise equal across the four counts."""
    monkeypatch.setattr(SG, "MODEL_CONFIG", dict(SG.MODEL_CONFIG,
                                                 **TINY_MODEL))
    wd = str(tmp_path / "sgs")
    records = {}
    out = SG.main([wd, "--grid", str(G), "--batch", str(B), "--steps", "1"],
                  device="cpu", records=records)
    with open(os.path.join(wd, "SHARDED_GRID_SCALING.json")) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    rows = [{**r, "fingerprint": 0.5} for r in out["rows"]]
    want = _jax_summary([{k: r[k] for k in r
                          if k != "step_time_vs_1dev"} for r in rows])
    assert set(out) == set(want)
    assert set(out["config"]) == set(want["config"])
    for row in out["rows"]:
        assert set(row) == _jax_row_keys() | {"wall_s",
                                              "step_time_vs_1dev"}
    assert [r["n_devices"] for r in out["rows"]] == list(SG.DEVICE_COUNTS)
    assert len({r["fingerprint"] for r in out["rows"]}) == 1
    assert out["output_fingerprint_spread"] == 0.0
    assert sorted(records["launches_by_shard"]) == list(SG.DEVICE_COUNTS)
    assert os.listdir(str(tmp_path)) == ["sgs"]


def test_main_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SG.main([str(tmp_path / "sgs")])
    assert not os.path.exists(str(tmp_path / "sgs"))


@pytest.mark.gpu
def test_sharded_steps_on_card_match_unsharded(monkeypatch):
    """On the card: the twin's step on ``["cuda"] * 2`` against one entry
    from the same init, at the grid bars, the fingerprints within the JAX
    script's bar; each shard launches the lane mix once per simulated
    step of each of its 2 steps, and no GL prox."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the factor-mix kernel runs on it")
    monkeypatch.setattr(SG, "MODEL_CONFIG", dict(SG.MODEL_CONFIG,
                                                 **TINY_MODEL))
    runner = SG.build_runner(1, G, B, torch.device("cpu"))
    init = tuple(interop.tree_map(lambda x: x.numpy(), t)
                 for t in runner.init_grid(0))
    got = {}
    for n in (1, 2):
        state = tuple(interop.tree_map(torch.from_numpy, t) for t in init)
        got[n] = _port_steps(n, state, monkeypatch, device="cuda")
    for a, b in zip(interop.tree_leaves(got[1][0]),
                    interop.tree_leaves(got[2][0])):
        np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                   **PARAMS)
    fps = [got[1][1], got[2][1]]
    assert max(fps) - min(fps) < 1e-5 * max(abs(f) for f in fps)
    sims = SG.MODEL_CONFIG["num_sims"]
    for n in (1, 2):
        by = got[n][2]["launches_by_shard"]
        assert [by[str(i)]["factor_mix"] for i in range(n)] == \
            [sims * STEPS] * n
        assert all(by[str(i)]["gl_prox"] == 0 for i in range(n))


def test_twins_import_without_jax():
    """Both of this slice's twins import in a process where importing jax
    fails, and load nothing of the JAX package."""
    import subprocess
    import sys

    code = """
import sys
sys.modules["jax"] = None
import redcliff_tpu_torch.experiments.highband_readout_sweep
import redcliff_tpu_torch.experiments.sharded_grid_scaling
import redcliff_tpu_torch.utils.config, redcliff_tpu_torch.utils.misc
leaked = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith("jax.")) and sys.modules[m]
                or m == "redcliff_tpu" or m.startswith("redcliff_tpu."))
print("LEAKED", leaked)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout
