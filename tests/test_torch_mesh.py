"""The port's device mesh (redcliff_tpu_torch/parallel/mesh.py and the mesh
path of parallel/grid.py and train/redcliff_trainer.py) against the JAX
package's on the CPU.

The JAX side runs on its virtual 8-device CPU mesh (tests/conftest.py
forces the host device count); the port on ``["cpu"] * n``: a mesh that
names one device n times, each shard a distinct set of tensors. At the
width of tests/test_parallel_grid.py:_model (C=4, gen_hidden 8, K=2,
Vanilla embedder), n=64, 3 epochs, the GL prox on:

* the 8-point grid on 8 shards against the JAX grid on ``grid_mesh(8)``
  from the JAX grid's stacked init (``interop.grid_state_from_jax``), at
  the grid bars of tests/test_torch_grid.py; decisions exact;
* the sharded port grid bit for bit equal to the unsharded port grid, in
  every stream mode, through a compaction that re-splits the survivors;
* G=3 padded to width 4 on a 4-device sub-mesh, and JAX's divisibility
  error with ``g_bucket=False``;
* the factor-sharded fit (K=8 over 8 entries) against the JAX
  factor-sharded fit and the port's unsharded fit at JAX's bar (rtol
  2e-4, atol 1e-5), and its resume.

The card's legs (a) and (c) are in tests/test_torch_mesh_gpu.py (no JAX
there).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.parallel import grid as jgrid  # noqa: E402
from redcliff_tpu.parallel import mesh as jmesh  # noqa: E402
from redcliff_tpu.train import redcliff_trainer as jtr  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset as TDataset  # noqa: E402,E501
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.parallel import grid as tgrid  # noqa: E402
from redcliff_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from redcliff_tpu_torch.train import redcliff_trainer as ttr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the grid bars (ROADMAP "Tolerances"); the factor mesh's, JAX's own
# (tests/test_parallel_grid.py:473-491): another sum order than the K loop
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)
FACTOR = dict(rtol=2e-4, atol=1e-5)

POISON = {"gen_lr": 1e20, "factor_cos_sim_coeff": 0.1}
POINTS8 = [{"gen_lr": 1e-3 * (1 + 0.5 * i)} for i in range(7)] + [POISON]
KNOBS = dict(max_iter=3, batch_size=32, seed=7, lookback=1, check_every=1,
             prox_penalty="GL", prox_lam=0.5)


def _model_kw(K=2):
    return dict(num_chans=4, gen_lag=2, gen_hidden=(8,), embed_lag=4,
                embed_hidden_sizes=(8,), num_factors=K,
                num_supervised_factors=2, factor_weight_l1_coeff=0.01,
                adj_l1_reg_coeff=0.001, factor_cos_sim_coeff=0.01,
                factor_score_embedder_type="Vanilla_Embedder",
                primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
                training_mode="combined")


def _data(n=64):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 5, 4)).astype(np.float32)
    Y = rng.uniform(size=(n, 3, 1)).astype(np.float32)
    return X, Y


def _cpu_mesh(n, axis_name="grid"):
    return tmesh.grid_mesh(devices=["cpu"] * n, axis_name=axis_name)


def _leaves(tree):
    return [np.asarray(x) for x in interop.tree_leaves(tree)]


def _assert_same(a, b):
    """Two port GridResults bit for bit (NaN lanes equal to NaN)."""
    np.testing.assert_array_equal(a.val_history, b.val_history)
    np.testing.assert_array_equal(a.best_criteria, b.best_criteria)
    np.testing.assert_array_equal(a.best_epoch, b.best_epoch)
    np.testing.assert_array_equal(a.active, b.active)
    assert a.failures == b.failures
    for x, y in zip(_leaves(a.best_params), _leaves(b.best_params)):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------- the 8-point grid on 8 shards
@pytest.fixture(scope="module")
def grid8(tmp_path_factory):
    """The JAX grid on its 8-device mesh and the port's on 8 CPU entries,
    from the JAX grid's stacked init (exact width, compaction off, per
    batch, as tests/test_torch_grid.py compares them)."""
    kw = _model_kw()
    jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**kw))
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**kw))
    X, Y = _data()
    jtc = jtr.RedcliffTrainConfig(**KNOBS, compaction=False,
                                  stream_mode="per_batch")
    jrun = jgrid.RedcliffGridRunner(jm, jtc, jgrid.GridSpec(POINTS8),
                                    mesh=jmesh.grid_mesh(8))
    init = jrun.init_grid(jax.random.PRNGKey(5))
    state = jax.tree.map(np.asarray, init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REDCLIFF_QUALITY", "0")
        jres = jrun.fit(jax.random.PRNGKey(5), JDataset(X, Y),
                        JDataset(X, Y), init_params=init)
    ttc = ttr.RedcliffTrainConfig(**KNOBS, compaction=False,
                                  stream_mode="per_batch")
    trun = tgrid.RedcliffGridRunner(tm, ttc, tgrid.GridSpec(POINTS8),
                                    mesh=_cpu_mesh(8))
    tres = trun.fit(None, TDataset(X, Y), TDataset(X, Y),
                    init_params=interop.grid_state_from_jax(*state))
    return jres, tres, trun


def test_sharded_grid_matches_jax_mesh_grid(grid8):
    jres, tres, trun = grid8
    assert trun.mesh.size == 8 and len(trun._shards) == 8
    np.testing.assert_array_equal(tres.best_epoch, jres.best_epoch)
    np.testing.assert_array_equal(tres.active, jres.active)
    assert tres.failures == jres.failures
    assert [f["point"] for f in tres.failures] == [7]
    np.testing.assert_allclose(tres.val_history[:, :7],
                               jres.val_history[:, :7], **HIST)
    np.testing.assert_allclose(tres.best_criteria, jres.best_criteria,
                               **HIST)
    for a, b in zip(jax.tree.leaves(jres.best_params),
                    _leaves(tres.best_params)):
        np.testing.assert_allclose(b[:7], np.asarray(a)[:7], **PARAMS)
    # the mesh's shape is the audit record of fit_start and checkpoints
    assert tres.dispatch_stats["grid_width"] == 8
    assert tres.dispatch_stats["remeshes"] == 0


@pytest.mark.parametrize("mode", ["per_batch", "epoch", "kscan"])
def test_sharded_grid_bitwise_equals_unsharded(mode):
    """Within the port the shards run the unsharded grid's arithmetic on
    fewer lanes: bit for bit on the CPU, through the poisoned lanes'
    quarantine and the compaction that gathers the 3 survivors,
    takes their rows and re-splits them (width 8 -> 4: a 4-entry sub-mesh
    of the 8-entry mesh, one lane per entry of the 4-entry mesh)."""
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**_model_kw()))
    X, Y = _data()
    # G=6 (3 of them poisoned): width 8 with 2 filler lanes
    points = POINTS8[:3] + [POISON] * 3
    tc = ttr.RedcliffTrainConfig(**{**KNOBS, "lookback": 1},
                                 stream_mode=mode, scan_batches=2)
    init = tgrid.RedcliffGridRunner(tm, tc, tgrid.GridSpec(points),
                                    device="cpu").init_grid(11)
    runs = {}
    for name, mesh in (("one", None), ("mesh8", _cpu_mesh(8)),
                       ("mesh4", _cpu_mesh(4))):
        runner = tgrid.RedcliffGridRunner(
            tm, tc, tgrid.GridSpec(points), mesh=mesh,
            device=None if mesh else "cpu")
        runs[name] = runner.fit(None, TDataset(X, Y), TDataset(X, Y),
                                init_params=init)
    assert runs["one"].dispatch_stats["compactions"] >= 1
    assert runs["mesh8"].dispatch_stats["compactions"] \
        == runs["one"].dispatch_stats["compactions"]
    _assert_same(runs["mesh8"], runs["one"])
    _assert_same(runs["mesh4"], runs["one"])


def test_submesh_padding_and_divisibility(monkeypatch):
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**_model_kw()))
    spec = tgrid.GridSpec([{} for _ in range(3)])
    with pytest.raises(ValueError, match="multiple of the mesh"):
        tgrid.RedcliffGridRunner(tm, ttr.RedcliffTrainConfig(g_bucket=False),
                                 spec, mesh=_cpu_mesh(8))
    # default: G=3 pads to a width-4 bucket on a 4-device sub-mesh
    runner = tgrid.RedcliffGridRunner(tm, ttr.RedcliffTrainConfig(), spec,
                                      mesh=_cpu_mesh(8))
    assert runner._g_exec0 == 4
    assert runner.mesh.size == 4
    assert [(s.lo, s.hi) for s in runner._shards] == [(0, 1), (1, 2),
                                                      (2, 3), (3, 4)]
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        tgrid.RedcliffGridRunner(tm, ttr.RedcliffTrainConfig(), spec,
                                 mesh=_cpu_mesh(2), device="cuda")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tgrid.RedcliffGridRunner(tm, ttr.RedcliffTrainConfig(), spec,
                                 mesh=object(), device="cpu")
    # the JAX mesh's shapes
    m = _cpu_mesh(8, "seq")
    assert (m.size, m.axis_names, m.sub(2).size) == (8, ("seq",), 2)
    assert tmesh.lane_bounds(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    # no card and no devices: no mesh, never a quiet CPU one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.grid_mesh()


# ---------------------------------------------------------- factor mesh
@pytest.fixture(scope="module")
def factor_fits():
    kw = _model_kw(K=8)
    jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**kw))
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**kw))
    X, Y = _data(32)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
    knobs = dict(max_iter=2, batch_size=16, seed=3, prox_penalty="GL",
                 prox_lam=0.1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REDCLIFF_QUALITY", "0")
        jsh = jtr.RedcliffTrainer(jm, jtr.RedcliffTrainConfig(**knobs)).fit(
            init, JDataset(X, Y), JDataset(X, Y),
            factor_mesh=jmesh.grid_mesh(8, "factor"))
    tc = ttr.RedcliffTrainConfig(**knobs)
    plain = ttr.RedcliffTrainer(tm, tc, device="cpu").fit(
        init, TDataset(X, Y), TDataset(X, Y))
    trainer = ttr.RedcliffTrainer(tm, tc, device="cpu")
    sharded = trainer.fit(init, TDataset(X, Y), TDataset(X, Y),
                          factor_mesh=_cpu_mesh(8, "factor"))
    return jsh, plain, sharded, trainer


def test_factor_mesh_matches_jax_and_unsharded(factor_fits):
    jsh, plain, sharded, trainer = factor_fits
    assert trainer.factor_placement == ["cpu"] * 8
    for a, b in zip(_leaves(interop.params_to_jax(plain.params)),
                    _leaves(interop.params_to_jax(sharded.params))):
        np.testing.assert_allclose(b, a, **FACTOR)
    for a, b in zip(jax.tree.leaves(jsh.params),
                    _leaves(interop.params_to_jax(sharded.params))):
        np.testing.assert_allclose(b, np.asarray(a), **FACTOR)
    np.testing.assert_allclose(sharded.histories["avg_combo_loss"],
                               jsh.histories["avg_combo_loss"], **FACTOR)
    # divisibility is validated, with JAX's text
    bad = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**_model_kw(K=3)))
    with pytest.raises(AssertionError, match="must divide"):
        ttr.RedcliffTrainer(bad, ttr.RedcliffTrainConfig(),
                            device="cpu").fit(None, None, None,
                                              factor_mesh=_cpu_mesh(8))


def test_factor_mesh_survives_resume(tmp_path):
    """A factor-sharded fit stopped after 2 epochs and resumed to 4
    re-places params, best and accepted params and both Adam states on
    the mesh, and ends bit for bit where an uninterrupted sharded fit
    does (the checkpoint holds the joined trees)."""
    kw = _model_kw(K=8)
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**kw))
    X, Y = _data(32)
    init = tm.init(torch.Generator().manual_seed(8), "cpu")
    mesh = _cpu_mesh(8)
    knobs = dict(batch_size=16, check_every=1, prox_penalty="GL",
                 prox_lam=0.1)
    run = str(tmp_path / "fac_run")
    ttr.RedcliffTrainer(tm, ttr.RedcliffTrainConfig(max_iter=2, **knobs),
                        device="cpu").fit(init, TDataset(X, Y),
                                          TDataset(X, Y), save_dir=run,
                                          factor_mesh=mesh)
    trainer = ttr.RedcliffTrainer(
        tm, ttr.RedcliffTrainConfig(max_iter=4, **knobs), device="cpu")
    res = trainer.fit(init, TDataset(X, Y), TDataset(X, Y), save_dir=run,
                      resume=True, factor_mesh=mesh)
    assert len(res.histories["avg_combo_loss"]) == 4
    assert trainer.factor_placement == ["cpu"] * 8
    whole = ttr.RedcliffTrainer(
        tm, ttr.RedcliffTrainConfig(max_iter=4, **knobs), device="cpu").fit(
        init, TDataset(X, Y), TDataset(X, Y),
        save_dir=str(tmp_path / "whole"), factor_mesh=mesh)
    np.testing.assert_array_equal(res.histories["avg_combo_loss"],
                                  whole.histories["avg_combo_loss"])
    for a, b in zip(_leaves(res.params), _leaves(whole.params)):
        np.testing.assert_array_equal(a, b)


def test_mesh_modules_import_without_jax():
    """The four mesh modules import (and a mesh, a ring attention and a
    host plan run) with jax and the JAX package blocked."""
    code = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "redcliff_tpu.")) \
                or name == "redcliff_tpu":
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import numpy as np, torch
from redcliff_tpu_torch.parallel import mesh, remesh, distributed, sequence
m = mesh.grid_mesh(devices=["cpu"] * 2, axis_name="seq")
q = torch.randn(1, 4, 2, 3)
out = sequence.ring_attention(q, q, q, m)
assert out.shape == q.shape
assert remesh.plan_resharding(np.ones(8, bool), np.arange(8, dtype=np.int32),
                              [], 6).new_width == 12
assert not distributed.is_distributed()
assert not [k for k in sys.modules if k == "jax" or k.startswith("jax.")
            or k == "redcliff_tpu" or k.startswith("redcliff_tpu.")]
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]
