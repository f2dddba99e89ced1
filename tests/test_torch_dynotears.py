"""The port's DYNOTEARS (redcliff_tpu_torch/models/dynotears.py, a host
numpy/scipy copy of the JAX package's) against the JAX package, and its
array tasks through both packages' drivers.

The solver and both wrappers run the same numpy/scipy code on the same
windows, so graphs, solver state, validation histories and the eval
layer's numbers are held bit for bit; each package loads the other's
artifacts. ``DYNOTEARS_Vanilla`` takes the published cached-args
(``experiments/accuracy_parity_synsys.py``); ``DYNOTEARS_Stochastic`` the
reference's schema of that family, cut to two data passes.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu.data.datasets import ArrayDataset as JArrayDataset  # noqa: E402,E501
from redcliff_tpu.eval import cross_alg as jcross  # noqa: E402
from redcliff_tpu.eval import gc_estimates as jge  # noqa: E402
from redcliff_tpu.eval import model_io as jio  # noqa: E402
from redcliff_tpu.models import dynotears as jdyn  # noqa: E402
from redcliff_tpu.train import driver as jdriver  # noqa: E402
from redcliff_tpu.train import orchestration as jorch  # noqa: E402
from redcliff_tpu.utils import config as jconfig  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset  # noqa: E402
from redcliff_tpu_torch.data.shards import save_cv_split  # noqa: E402
from redcliff_tpu_torch.eval import cross_alg as tcross  # noqa: E402
from redcliff_tpu_torch.eval import gc_estimates as tge  # noqa: E402
from redcliff_tpu_torch.eval import model_io as tio  # noqa: E402
from redcliff_tpu_torch.models import dynotears as tdyn  # noqa: E402
from redcliff_tpu_torch.train import driver as tdriver  # noqa: E402
from redcliff_tpu_torch.train import orchestration as torch_orch  # noqa: E402,E501
from redcliff_tpu_torch.utils import config as tconfig  # noqa: E402

C, K, T = 4, 3, 12
DATA_SET = "d4IC_fold0"
# experiments/accuracy_parity_synsys.py DYNOTEARS_ARGS (the reference's
# DYNOTEARS_Vanilla d4IC cached-args)
VANILLA_ARGS = {
    "lambda_w": "0.9", "lambda_a": "0.1", "max_iter": "100",
    "h_tol": "0.00000001", "w_threshold": "0.0", "tabu_edges": "None",
    "tabu_parent_nodes": "None", "tabu_child_nodes": "None",
    "lag_size": "1", "signal_format": "original",
}
# the Stochastic schema (utils/config.py), two data passes
STOCHASTIC_ARGS = dict(
    VANILLA_ARGS, max_iter="20", batch_size="8", grad_step="1.0",
    wa_est="None", rho="1.0", alpha="0.0", h_value="inf", h_new="inf",
    max_data_iter="2", iter_start="0", num_iters_prior_to_stop="10",
    reuse_rho="1", reuse_alpha="1", reuse_h_val="0", reuse_h_new="0",
    check_every="1")
ARGS = {"DYNOTEARS_Vanilla": VANILLA_ARGS,
        "DYNOTEARS_Stochastic": STOCHASTIC_ARGS}


def _recordings(n, seed, d=C, t=T):
    rng = np.random.default_rng(seed)
    A = np.zeros((d, d))
    A[0, 1], A[2, 3] = 0.85, 0.8
    X = np.zeros((n, t, d))
    X[:, 0] = rng.normal(size=(n, d))
    for s in range(1, t):
        X[:, s] = X[:, s - 1] @ (A + 0.3 * np.eye(d)) \
            + 0.3 * rng.normal(size=(n, d))
    return X.astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _state_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          err_msg=f.name)


def test_solver_and_free_functions_equal_jax():
    """``dynotears_solve`` cold and warm-started, tabu edges, the objective
    and the acyclicity constraint: the same numbers, bit for bit."""
    X = _recordings(1, 0, t=80)[0].astype(np.float64)
    x_in, x_lag = X[:-1], X[1:]
    kw = dict(lambda_w=0.1, lambda_a=0.1, max_iter=30,
              tabu_edges=[(1, 0, 1)], tabu_parent_nodes=[3])
    rj = jdyn.dynotears_solve(x_in, x_lag, **kw)
    rt = tdyn.dynotears_solve(x_in, x_lag, **kw)
    np.testing.assert_array_equal(rt.w_mat, rj.w_mat)
    np.testing.assert_array_equal(rt.a_mat, rj.a_mat)
    _state_equal(rj.state, rt.state)
    warm_j = jdyn.dynotears_solve(x_in, x_lag, state=rj.state, max_iter=5)
    warm_t = tdyn.dynotears_solve(x_in, x_lag, state=rt.state, max_iter=5)
    np.testing.assert_array_equal(warm_t.a_mat, warm_j.a_mat)
    _state_equal(warm_j.state, warm_t.state)
    wa = rt.state.wa_est
    for g, w in zip(tdyn.reshape_wa(wa, C, 1), jdyn.reshape_wa(wa, C, 1)):
        np.testing.assert_array_equal(g, w)
    assert tdyn.dynotears_h_constraint(wa, C, 1) \
        == jdyn.dynotears_h_constraint(wa, C, 1)
    assert tdyn.dynotears_objective(x_in, x_lag, wa, 2.0, 0.5, C, 1, 0.1,
                                    0.2, len(x_in)) \
        == jdyn.dynotears_objective(x_in, x_lag, wa, 2.0, 0.5, C, 1, 0.1,
                                    0.2, len(x_in))


def test_models_fit_and_gc_equal_jax(tmp_path):
    """Both wrappers on the same recordings: Vanilla's averaged graph,
    Stochastic's warm-started refits (validation history, best state,
    ``gc()``), and their artifacts, which each package loads from the
    other."""
    recs = _recordings(6, 3, t=40)
    cfg = dict(max_iter=10, reuse_rho=True, reuse_alpha=True)
    jv = jdyn.DynotearsVanillaModel(jdyn.DynotearsConfig(**cfg))
    tv = tdyn.DynotearsVanillaModel(tdyn.DynotearsConfig(**cfg))
    np.testing.assert_array_equal(
        tv.fit(recs, save_dir=str(tmp_path / "tv")),
        jv.fit(recs, save_dir=str(tmp_path / "jv")))
    np.testing.assert_array_equal(tv.gc(), jv.gc())
    js = jdyn.DynotearsModel(jdyn.DynotearsConfig(**cfg))
    ts = tdyn.DynotearsModel(tdyn.DynotearsConfig(**cfg))
    jbest, jhist = js.fit(JArrayDataset(recs), JArrayDataset(recs),
                          save_dir=str(tmp_path / "js"), max_data_iter=2,
                          batch_size=4)
    tbest, thist = ts.fit(ArrayDataset(recs), ArrayDataset(recs),
                          save_dir=str(tmp_path / "ts"), max_data_iter=2,
                          batch_size=4)
    assert tbest == jbest and thist == jhist
    np.testing.assert_array_equal(ts.gc(), js.gc())
    _state_equal(js.state, ts.state)
    for name, jm in (("v", jv), ("s", js)):
        for src in ("t", "j"):
            run = str(tmp_path / f"{src}{name}")
            tm, tp = tio.load_model_for_eval(run)  # host: no device needed
            jm2, jp = jio.load_model_for_eval(run)
            assert tp is None and jp is None
            assert type(tm).__name__ == type(jm).__name__ \
                == type(jm2).__name__
            assert dataclasses.asdict(tm.config) \
                == dataclasses.asdict(jm.config)
            np.testing.assert_array_equal(tm.gc(), jm.gc())
            np.testing.assert_array_equal(jm2.gc(), jm.gc())


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    """One fold of K-state recordings with one-hot state labels, and its
    data cached-args file."""
    base = tmp_path_factory.mktemp("fold")
    rng = np.random.default_rng(0)
    X = _recordings(30, 1)
    states = rng.integers(0, K, len(X))
    Y = np.eye(K, dtype=np.float32)[states][:, :, None]
    pairs = [[x, y] for x, y in zip(X, Y)]
    save_cv_split(pairs[:20], pairs[20:], 0, str(base / "data"))
    graphs = [(rng.random((C, C)) < 0.4).astype(float)[:, :, None]
              for _ in range(K)]
    dargs = str(base / f"{DATA_SET}_data_cached_args.txt")
    with open(dargs, "w") as f:
        json.dump({"data_root_path": str(base / "data" / "fold_0"),
                   "num_channels": str(C),
                   **{f"net{k + 1}_adjacency_tensor":
                      tconfig.serialize_tensor_to_string(g)
                      for k, g in enumerate(graphs)}}, f)
    return {"base": base, "dargs": dargs, "X": X}


def _model_args(path, model_type):
    fname = os.path.join(path, f"{model_type}_d4IC_cached_args.txt")
    with open(fname, "w") as f:
        json.dump(ARGS[model_type], f)
    return fname


@pytest.mark.parametrize("model_type", list(ARGS))
def test_array_task_matches_jax(model_type, fold, tmp_path):
    """Array task 1 of each DYNOTEARS family through both packages'
    ``set_up_and_run_experiments`` (the port's asked for the CPU, though
    the family runs on the host anyway): the schema and the factory agree,
    the run folders and graphs are equal, each artifact loads in both
    packages, and the eval dispatch, GC and score estimates and the
    cross-algorithm scoring equal the JAX package's."""
    margs = _model_args(tmp_path, model_type)
    base = {"model_type": model_type, "model_cached_args_file": margs,
            "data_cached_args_file": fold["dargs"]}
    jargs = jconfig.read_in_data_args(jconfig.read_in_model_args(dict(base)))
    targs = tconfig.read_in_data_args(tconfig.read_in_model_args(dict(base)))
    assert sorted(targs) == sorted(jargs)
    for k, v in jargs.items():
        if k in ("true_GC_factors", "true_GC_tensor"):
            for a, b in zip(v, targs[k]):
                np.testing.assert_array_equal(b, a)
        else:
            assert targs[k] == v, k
    jm0 = jorch.create_model_instance(jargs)
    tm0 = torch_orch.create_model_instance(targs)
    assert type(tm0).__name__ == type(jm0).__name__
    assert dataclasses.asdict(tm0.config) == dataclasses.asdict(jm0.config)

    runs = {}
    for name, pkg, extra in (("jax", jdriver, {}),
                             ("port", tdriver, {"device": "cpu"})):
        root = tmp_path / name
        os.makedirs(root)
        assert pkg.set_up_and_run_experiments(
            {"save_root_path": str(root)}, [margs], [fold["dargs"]],
            [model_type], [DATA_SET], task_id=1, **extra) == 1
        (run,) = os.listdir(root)
        runs[name] = root / run
    assert runs["jax"].name == runs["port"].name
    assert sorted(os.listdir(runs["jax"])) == sorted(os.listdir(runs["port"]))

    alg = model_type
    tm, tp = tio.load_model_for_eval(str(runs["port"]), device="cpu")
    jm, jp = jio.load_model_for_eval(str(runs["jax"]))
    tm2, _ = tio.load_model_for_eval(str(runs["jax"]), device="cpu")
    jm2, _ = jio.load_model_for_eval(str(runs["port"]))
    for m in (tm2, jm2, jm):
        np.testing.assert_array_equal(m.gc(), tm.gc())
    _, jval = jorch.get_data_for_model_training(jargs)
    _, tval = torch_orch.get_data_for_model_training(targs, device="cpu")
    assert not tval._dev  # DYNOTEARS reads host windows only
    assert torch_orch.call_model_eval_method(tm2, None, targs, tval) \
        == jorch.call_model_eval_method(jm, None, jargs, jval)
    got = tge.get_model_gc_estimates(tm2, None, alg, K)
    want = jge.get_model_gc_estimates(jm, None, alg, K)
    assert len(got) == len(want) == K
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tge.get_model_gc_score_estimates(tm2, None, alg, K),
        jge.get_model_gc_score_estimates(jm, None, alg, K))
    truth = tconfig.load_true_gc_factors(fold["dargs"])
    got = tcross.evaluate_algorithm_on_fold(str(runs["port"]), alg, truth,
                                            device="cpu")
    want = jcross.evaluate_algorithm_on_fold(str(runs["jax"]), alg, truth)
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].astype(float), v.astype(float),
                                      err_msg=k)
