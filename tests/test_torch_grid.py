"""The port's coefficient grid (redcliff_tpu_torch/parallel/grid.py and
train/driver.py:run_coefficient_grid) against the JAX package's grid and
the port's own per-point trainer.

At the width of tests/test_parallel_grid.py:_model (C=4, gen_hidden 8,
K=2, Vanilla embedder), G=4, 3 epochs, n=64, with the GL prox on. The two
grids start from the same stacked state: the JAX grid's init carried into
the port by ``interop.grid_state_from_jax`` (or one point's params
replicated by ``init_point_params``). The JAX grid runs at exact width with
compaction off, streaming per batch, as the port does. Two JAX grid fits
in all (module fixtures), each shared by the tests of its case.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from redcliff_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.parallel import grid as jgrid  # noqa: E402
from redcliff_tpu.runtime import numerics as jnum  # noqa: E402
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu.train import redcliff_trainer as jtr  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset as TDataset  # noqa: E402,E501
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.parallel import grid as tgrid  # noqa: E402
from redcliff_tpu_torch.runtime import numerics as tnum  # noqa: E402
from redcliff_tpu_torch.train import driver as tdriver  # noqa: E402
from redcliff_tpu_torch.train import freeze as tfreeze  # noqa: E402
from redcliff_tpu_torch.train import redcliff_trainer as ttr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# multi-epoch trajectories through the loss, two Adams and the prox in
# both frameworks (ROADMAP tolerances); decisions exact
HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)

FREEZE_MODE = "pretrain_embedder_then_post_train_factor_withL1FreezeByBatch"
# a lane poisoned by a learning rate that overflows its first update: the
# guard skips its later steps and the lane is quarantined
POISON = {"gen_lr": 1e20, "factor_cos_sim_coeff": 0.1}
POINTS = [{"gen_lr": 1e-3},
          {"gen_lr": 5e-3, "stopping_criteria_cosSim_coeff": 0.5},
          {"adj_l1_reg_coeff": 0.01, "embed_lr": 2e-3},
          POISON]
KNOBS = dict(max_iter=3, batch_size=32, seed=7, lookback=1, check_every=1,
             prox_penalty="GL", prox_lam=0.5)


def _model_kw(mode="combined"):
    kw = dict(num_chans=4, gen_lag=2, gen_hidden=(8,), embed_lag=4,
              embed_hidden_sizes=(8,), num_factors=2,
              num_supervised_factors=2, factor_weight_l1_coeff=0.01,
              adj_l1_reg_coeff=0.001, factor_cos_sim_coeff=0.01,
              factor_score_embedder_type="Vanilla_Embedder",
              primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
              training_mode=mode)
    if "pretrain" in mode:
        kw["num_pretrain_epochs"] = 1
    return kw


def _models(mode="combined"):
    kw = _model_kw(mode)
    return (jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**kw)),
            tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**kw)))


def _data(n=64):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 5, 4)).astype(np.float32)
    Y = rng.uniform(size=(n, 3, 1)).astype(np.float32)
    return X, Y


def _jax_tc(**over):
    return jtr.RedcliffTrainConfig(**{**KNOBS, **over}, compaction=False,
                                   stream_mode="per_batch")


def _assert_results_match(jres, tres, healthy):
    np.testing.assert_array_equal(tres.best_epoch, jres.best_epoch)
    np.testing.assert_array_equal(tres.active, jres.active)
    assert tres.failures == jres.failures
    np.testing.assert_allclose(tres.val_history, jres.val_history, **HIST)
    np.testing.assert_allclose(tres.best_criteria, jres.best_criteria,
                               **HIST)
    for a, b in zip(jax.tree.leaves(jres.best_params),
                    jax.tree.leaves(tres.best_params)):
        np.testing.assert_allclose(b[healthy], np.asarray(a)[healthy],
                                   **PARAMS)


# --------------------------------------------- case 1: combined, one poisoned
@pytest.fixture(scope="module")
def combined_pair(tmp_path_factory):
    """Both packages' ``run_coefficient_grid`` from one point's params
    replicated over the lanes (the SLURM-array init), one lane poisoned."""
    jm, tm = _models()
    X, Y = _data()
    p0 = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    jdir = tmp_path_factory.mktemp("jax_grid")
    tdir = tmp_path_factory.mktemp("port_grid")
    with pytest.MonkeyPatch.context() as mp:
        # the JAX grid's quality telemetry changes no result, only compiles
        mp.setenv("REDCLIFF_QUALITY", "0")
        jres = jdriver.run_coefficient_grid(
            jm, _jax_tc(), POINTS, JDataset(X, Y), JDataset(X, Y),
            key=jax.random.PRNGKey(3), init_point_params=p0,
            run_dir=str(jdir))
    tres = tdriver.run_coefficient_grid(
        tm, ttr.RedcliffTrainConfig(**KNOBS), POINTS, TDataset(X, Y),
        TDataset(X, Y), init_point_params=p0, run_dir=str(tdir),
        device="cpu")
    return jres, tres, jdir, tdir


def test_port_grid_matches_jax_grid_combined(combined_pair):
    jres, tres, _, _ = combined_pair
    assert tres.val_history.shape == (KNOBS["max_iter"], len(POINTS))
    _assert_results_match(jres, tres, healthy=[0, 1, 2])
    assert tres.coeffs.keys() == jres.coeffs.keys()
    for k, v in jres.coeffs.items():
        np.testing.assert_array_equal(tres.coeffs[k], np.asarray(v))


def test_port_grid_quarantines_the_poisoned_lane_as_jax(combined_pair):
    """Same lane, epoch and cause in ``failures`` and ``failures.json``;
    the siblings train on."""
    jres, tres, jdir, tdir = combined_pair
    assert [f["point"] for f in tres.failures] == [3]
    assert tres.failures[0]["cause"] == "nonfinite_grad"
    assert tres.failures == jres.failures
    assert not tres.active[3] and tres.active[:3].all()
    assert np.isfinite(tres.val_history[:, :3]).all()
    with open(os.path.join(jdir, "failures.json")) as f:
        jfile = json.load(f)
    with open(os.path.join(tdir, "failures.json")) as f:
        tfile = json.load(f)
    assert tfile == jfile


# ------------------------------------------------------ case 2: a Freeze mode
@pytest.fixture(scope="module")
def freeze_pair():
    """The runners from the JAX grid's per-lane init (stacked params and
    fresh Adam states) carried into the port."""
    jm, tm = _models(FREEZE_MODE)
    X, Y = _data()
    points = POINTS[:3] + [{"gen_lr": 2e-3, "embed_lr": 5e-4}]
    runner = jgrid.RedcliffGridRunner(jm, _jax_tc(),
                                      jgrid.GridSpec(points=points))
    init = runner.init_grid(jax.random.PRNGKey(11))
    state = jax.tree.map(np.asarray, init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REDCLIFF_QUALITY", "0")
        jres = runner.fit(jax.random.PRNGKey(11), JDataset(X, Y),
                          JDataset(X, Y), init_params=init)
    tres = tgrid.RedcliffGridRunner(
        tm, ttr.RedcliffTrainConfig(**KNOBS), tgrid.GridSpec(points=points),
        device="cpu").fit(None, TDataset(X, Y), TDataset(X, Y),
                          init_params=interop.grid_state_from_jax(*state))
    return jres, tres


def test_port_grid_matches_jax_grid_freeze(freeze_pair):
    jres, tres = freeze_pair
    _assert_results_match(jres, tres, healthy=[0, 1, 2, 3])
    assert tres.failures == []


# ------------------------------------------- lanes against the port's trainer
def test_grid_lane_matches_port_per_point_trainer():
    """Lane g of the port grid equals the port's RedcliffTrainer fit of
    point g from the same weights and batches: best epoch, best criteria
    and best params (the JAX package's
    test_grid_selection_criteria_matches_trainer, in the port)."""
    _, tm = _models()
    X, Y = _data()
    points = [{"gen_lr": 1e-3, "stopping_criteria_cosSim_coeff": 0.5},
              {"gen_lr": 5e-3, "stopping_criteria_forecast_coeff": 2.0,
               "stopping_criteria_factor_coeff": 0.5},
              {"embed_lr": 3e-3, "gen_weight_decay": 1e-3}]
    tc = ttr.RedcliffTrainConfig(max_iter=4, batch_size=32, seed=7,
                                 prox_penalty="GL", prox_lam=0.5)
    p0 = tm.init(torch.Generator().manual_seed(5))
    res = tdriver.run_coefficient_grid(tm, tc, points, TDataset(X, Y),
                                       TDataset(X, Y), init_point_params=p0,
                                       device="cpu")
    for g, point in enumerate(points):
        tc_g = dataclasses.replace(tc, **point)
        out = ttr.RedcliffTrainer(tm, tc_g, device="cpu").fit(
            p0, TDataset(X, Y), TDataset(X, Y))
        assert int(res.best_epoch[g]) == out.best_it
        np.testing.assert_allclose(res.best_criteria[g], out.best_loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(res.val_history[:, g],
                                   out.histories["avg_combo_loss"],
                                   rtol=1e-5, atol=1e-6)
        for a, b in zip(interop.tree_leaves(res.best_params),
                        interop.tree_leaves(interop.params_to_jax(
                            out.params))):
            np.testing.assert_allclose(a[g], b, rtol=1e-5, atol=1e-6)


def test_stacked_adam_matches_torch_optim_adam_per_lane():
    """The grid's gated Adam step against ``torch.optim.Adam`` on each lane
    (coupled weight decay, eps, bias correction with per-lane step
    counts): a gated-off lane keeps its params, moments and count."""
    _, tm = _models()
    runner = tgrid.RedcliffGridRunner(
        tm, ttr.RedcliffTrainConfig(gen_eps=1e-4),
        tgrid.GridSpec(points=[{"gen_lr": 1e-3, "gen_weight_decay": 1e-2},
                               {"gen_lr": 3e-2},
                               {"gen_lr": 2e-3, "gen_weight_decay": 1e-4}]),
        device="cpu")
    rng = np.random.default_rng(4)
    params = [torch.from_numpy(rng.normal(size=(3, 5, 4)).astype(
        np.float32)), torch.from_numpy(rng.normal(size=(3, 2)).astype(
            np.float32))]
    state = runner._adam_state(params)
    refs = []
    for g in range(3):
        leaves = [p[g].clone().requires_grad_(True) for p in params]
        refs.append((leaves, torch.optim.Adam(
            leaves, lr=runner.spec.points[g]["gen_lr"], eps=1e-4,
            weight_decay=runner.spec.points[g].get("gen_weight_decay",
                                                   0.0))))
    gates = [[True, True, True], [True, False, True], [False, True, True],
             [True, True, False]]
    for gate in gates:
        grads = [torch.from_numpy(rng.normal(size=p.shape).astype(
            np.float32)) for p in params]
        before = [p.clone() for p in params]
        with torch.no_grad():
            runner._adam_(params, grads, state, runner._lr64["gen_lr"],
                          runner.coeffs["gen_weight_decay"], 1e-4,
                          torch.tensor(gate))
        for g, (leaves, opt) in enumerate(refs):
            if not gate[g]:
                for p, b in zip(params, before):
                    assert torch.equal(p[g], b[g])
                continue
            for leaf, gr in zip(leaves, grads):
                leaf.grad = gr[g].clone()
            opt.step()
            for p, leaf in zip(params, leaves):
                assert torch.equal(p[g], leaf.detach())
    steps = [sum(gate[g] for gate in gates) for g in range(3)]
    assert state["step"].tolist() == steps
    for g, (leaves, opt) in enumerate(refs):
        for i, leaf in enumerate(leaves):
            assert torch.equal(state["exp_avg"][i][g],
                               opt.state[leaf]["exp_avg"])
            assert torch.equal(state["exp_avg_sq"][i][g],
                               opt.state[leaf]["exp_avg_sq"])


def test_lane_numerics_counters_match_jax():
    """The per-lane device guard counters against the JAX package's
    ``update_numerics_state(..., count=active)`` over a fault sequence."""
    G = 4
    jstate = jnum.init_numerics_state(lanes=G)
    tstate = tnum.init_numerics_state(lanes=G)
    steps = [([1, 1, 0, 1], [1.0, 2.0, np.nan, 3.0], [1, 1, 1, 0]),
             ([1, 0, 0, 1], [0.5, np.inf, np.nan, 4.0], [1, 1, 1, 1]),
             ([1, 1, 1, 0], [2.5, 1.0, 7.0, 2.0], [0, 1, 1, 1])]
    for ok, gn, count in steps:
        ok = np.asarray(ok, bool)
        gn = np.asarray(gn, np.float32)
        count = np.asarray(count, bool)
        jstate = jnum.update_numerics_state(jstate, jnp.asarray(ok),
                                            jnp.asarray(gn),
                                            count=jnp.asarray(count))
        tstate = tnum.update_numerics_state(
            tstate, torch.from_numpy(ok), torch.from_numpy(gn),
            count=torch.from_numpy(count))
    for k, v in jstate.items():
        np.testing.assert_array_equal(tstate[k].numpy(), np.asarray(v), k)


def test_freeze_over_lanes_equals_per_lane_freeze():
    _, tm = _models(FREEZE_MODE)
    cand = [tm.init(torch.Generator().manual_seed(i)) for i in range(3)]
    acc = [tm.init(torch.Generator().manual_seed(10 + i)) for i in range(3)]
    stack = lambda ts: interop.tree_map(lambda *x: torch.stack(x), *ts)  # noqa
    c, a = tfreeze.apply_freeze_lanes(tm, FREEZE_MODE, stack(cand),
                                      stack(acc))
    for g in range(3):
        cg, ag = tfreeze.apply_freeze(tm, FREEZE_MODE, cand[g], acc[g])
        for x, y in zip(interop.tree_leaves(c), interop.tree_leaves(cg)):
            assert torch.equal(x[g], y)
        for x, y in zip(interop.tree_leaves(a), interop.tree_leaves(ag)):
            assert torch.equal(x[g], y)


# ------------------------------------------------------ spec, init, helpers
@pytest.mark.parametrize("kwargs", [
    dict(points=[{"gen_lr": 1e-3}, {"lr": 1.0}]),
    dict(points=[{}, {}], lane_seeds=[1]),
    dict(points=[{}], grid_deadline_s=0.0),
    dict(points=[{}, {}], fit_deadline_s=[1.0]),
    dict(points=[{}, {}], fit_deadline_s=[1.0, -2.0]),
])
def test_grid_spec_validation_matches_jax(kwargs):
    with pytest.raises(ValueError) as jerr:
        jgrid.GridSpec(**kwargs)
    with pytest.raises(ValueError) as terr:
        tgrid.GridSpec(**kwargs)
    assert str(terr.value) == str(jerr.value)


def test_grid_spec_stacked_and_group_order_match_jax():
    cfgs = [
        {"gen_hidden": (16,), "embed_lag": 4},
        {"gen_hidden": (8,), "embed_lag": 4},
        {"gen_hidden": (16,), "embed_lag": 8},
        {"gen_hidden": (8,), "embed_lag": 4, "lr": 9.0},
        {"gen_hidden": (16,), "embed_lag": 4},
        {"embed_lag": 4},
    ]
    for keys in (["gen_hidden", "embed_lag"], ["gen_hidden"]):
        want = jgrid.group_configs_by_shape(cfgs, keys)
        got = tgrid.group_configs_by_shape(cfgs, keys)
        assert list(got.items()) == list(want.items())
    jm, tm = _models()
    for points in (POINTS, [{"factor_cos_sim_coeff": 0.0,
                             "adj_l1_reg_coeff": 0.0}]):
        jspec, tspec = jgrid.GridSpec(points), tgrid.GridSpec(points)
        tc = ttr.RedcliffTrainConfig(**KNOBS)
        for k, v in jspec.stacked(jm.config, _jax_tc()).items():
            np.testing.assert_array_equal(
                tspec.stacked(tm.config, tc)[k], np.asarray(v))
        assert tspec.needs_gc(tm.config) == jspec.needs_gc(jm.config)
        assert tspec.needs_gc_lagged(tm.config) \
            == jspec.needs_gc_lagged(jm.config)


def test_init_grid_lane_seeds_are_composition_independent():
    """With lane seeds a point inits identically in any grid; without them
    the grid draws position-dependent lanes; init_grid_from replicates one
    point."""
    _, tm = _models()
    pts = [{"gen_lr": 1e-3}, {"gen_lr": 2e-3}, {"gen_lr": 3e-3}]
    a = tgrid.RedcliffGridRunner(
        tm, ttr.RedcliffTrainConfig(),
        tgrid.GridSpec(pts, lane_seeds=[11, 22, 33]), device="cpu")
    b = tgrid.RedcliffGridRunner(
        tm, ttr.RedcliffTrainConfig(),
        tgrid.GridSpec(pts[::-1][:2], lane_seeds=[33, 22]), device="cpu")
    pa, _, _ = a.init_grid(5)
    pb, _, _ = b.init_grid(5)
    for x, y in zip(interop.tree_leaves(pa), interop.tree_leaves(pb)):
        assert torch.equal(x[2], y[0]) and torch.equal(x[1], y[1])
        assert not torch.equal(x[0], x[1])
    plain = tgrid.RedcliffGridRunner(tm, ttr.RedcliffTrainConfig(),
                                     tgrid.GridSpec(pts), device="cpu")
    p1, optA, optB = plain.init_grid(5)
    p2, _, _ = plain.init_grid(5)
    for x, y in zip(interop.tree_leaves(p1), interop.tree_leaves(p2)):
        assert torch.equal(x, y) and not torch.equal(x[0], x[1])
    assert optA["step"].tolist() == [0, 0, 0]
    p0 = tm.init(torch.Generator().manual_seed(1))
    rep, _, optB = plain.init_grid_from(interop.params_to_jax(p0))
    for x, y in zip(interop.tree_leaves(rep), interop.tree_leaves(p0)):
        assert x.shape == (3,) + tuple(y.shape)
        assert all(torch.equal(x[g], y) for g in range(3))
    assert all(float(m.abs().max()) == 0.0
               for m in interop.tree_leaves(optB["exp_avg"]))


def test_driver_helpers_match_jax():
    args = {"model_type": "REDCLIFF_S_CMLP", "data_set_name": "d4IC_fold0",
            "num_factors": 5, "num_channels": 10,
            "coeff_dict": {"FORECAST_COEFF": 10.0, "FACTOR_SCORE_COEFF": 100,
                           "FACTOR_COS_SIM_COEFF": 1.0,
                           "FACTOR_WEIGHT_L1_COEFF": 0.001,
                           "ADJ_L1_REG_COEFF": 1.0}}
    assert tdriver.run_folder_name(args) == jdriver.run_folder_name(args)
    want = jdriver.rescale_dataset_dependent_coefficients(
        json.loads(json.dumps(args)))
    got = tdriver.rescale_dataset_dependent_coefficients(
        json.loads(json.dumps(args)))
    assert got == want
    assert tdriver.run_folder_name(got) == jdriver.run_folder_name(want)


def test_what_is_not_ported_raises(tmp_path, monkeypatch):
    """Mesh, mixed precision and a default CUDA device without a card
    raise; nothing is quietly ignored. The telemetry knobs (``log_dir``,
    ``true_gc``) and the predictive policy work."""
    from redcliff_tpu_torch.obs.logging import read_jsonl
    from redcliff_tpu_torch.parallel import policy as tpolicy

    monkeypatch.setenv("REDCLIFF_QUALITY", "1")
    _, tm = _models()
    X, Y = _data(32)
    ds = TDataset(X, Y)
    tc = ttr.RedcliffTrainConfig(max_iter=1, batch_size=16)
    spec = tgrid.GridSpec([{}, {}])
    runner = tgrid.RedcliffGridRunner(tm, tc, spec, device="cpu")
    runner.fit(0, ds, ds, log_dir=str(tmp_path),
               true_gc=[np.eye(4)] * tm.config.num_factors)
    q, = read_jsonl(str(tmp_path), event="quality")
    assert q["lanes"] == [0, 1] and len(q["auroc"]) == 2
    with pytest.raises(NotImplementedError):
        tgrid.RedcliffGridRunner(tm, tc, spec, mesh=object(), device="cpu")
    # the predictive policy is ported: without a cost model it is the
    # heuristic and records no decision
    pred = tpolicy.PredictiveSchedulingPolicy()
    assert pred.initial_width(27) == tpolicy.GridSchedulingPolicy() \
        .initial_width(27) and pred.take_decision() is None
    with pytest.raises(NotImplementedError):
        tgrid.GridSpec([{}], precision_mode="mixed")
    with pytest.raises(NotImplementedError):
        tdriver.run_coefficient_grid(tm, tc, [{}, {}], ds, ds,
                                     device="cpu", mesh="auto")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tgrid.RedcliffGridRunner(tm, tc, spec)


def test_port_grid_loads_no_jax(tmp_path):
    """Importing and running the port's grid driver loads no jax and no
    module of the JAX package."""
    code = f"""
import sys
import numpy as np
import torch
from redcliff_tpu_torch.data.datasets import ArrayDataset
from redcliff_tpu_torch.models.redcliff import (RedcliffSCMLP,
                                                RedcliffSCMLPConfig)
from redcliff_tpu_torch.train.driver import run_coefficient_grid
from redcliff_tpu_torch.train.redcliff_trainer import RedcliffTrainConfig
model = RedcliffSCMLP(RedcliffSCMLPConfig(**{_model_kw()!r}))
rng = np.random.default_rng(0)
X = rng.normal(size=(48, 5, 4)).astype(np.float32)
Y = rng.uniform(size=(48, 3, 1)).astype(np.float32)
res = run_coefficient_grid(
    model, RedcliffTrainConfig(max_iter=2, batch_size=16, prox_penalty="GL",
                               prox_lam=0.5),
    [{{"gen_lr": 1e-3}}, {{"gen_lr": 1e20}}], ArrayDataset(X[:32], Y[:32]),
    ArrayDataset(X[32:], Y[32:]), key=0, run_dir={str(tmp_path)!r},
    device="cpu")
assert [f["point"] for f in res.failures] == [1]
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "redcliff_tpu" or m.startswith("redcliff_tpu."))
print("LEAKED", leaked)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout
    assert os.path.exists(tmp_path / "failures.json")


def test_cosine_stopping_term_matches_jax_grid():
    """The grid's cosine stopping term equals the JAX grid's on the same
    lanes and window. Pins a JAX package finding the port keeps: with a
    DGCNN embedder and a readout that adds the embedder graph, the
    per-point trainer's tracker reads the GC with
    ``combine_wavelet_representations=True`` (|A| for the DGCNN adjacency)
    and the grid without it (signed A), so the two cosine terms differ."""
    kw = dict(_model_kw(), factor_score_embedder_type="DGCNN",
              primary_gc_est_mode="conditional_factor_fixed_embedder",
              num_factors=3, num_supervised_factors=3,
              dgcnn_num_hidden_nodes=8)
    jm = jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**kw))
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**kw))
    points = [{"gen_lr": 1e-3}, {"gen_lr": 2e-3}]
    jrun = jgrid.RedcliffGridRunner(jm, _jax_tc(), jgrid.GridSpec(points))
    jparams = jrun.init_grid(jax.random.PRNGKey(2))[0]
    trun = tgrid.RedcliffGridRunner(tm, ttr.RedcliffTrainConfig(**KNOBS),
                                    tgrid.GridSpec(points), device="cpu")
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    X = np.random.default_rng(3).normal(size=(16, 4, 4)).astype(np.float32)
    want = np.asarray(jrun._cos(jparams, jnp.asarray(X)))
    got = trun._cos(tparams, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the per-point tracker's term on lane 0: the embedder graph as |A|
    from redcliff_tpu_torch.train.tracking import GCProgressTracker
    lane0 = interop.tree_map(lambda x: x[0], tparams)
    tracker = GCProgressTracker(num_supervised_factors=3, num_chans=4,
                                num_factors=3)
    trainer = ttr.RedcliffTrainer(tm, ttr.RedcliffTrainConfig(),
                                  device="cpu")
    trainer._epoch_gc_tracking(lane0, TDataset(
        np.concatenate([X, X[:, :1]], axis=1), normalize=False), tracker)
    assert abs(tracker.latest_mean_supervised_cosine() - got[0]) > 1e-3
