"""The one-init, published-depth parity harness: one array task (or one
coefficient grid) of a study twin run by the JAX package and by the port
from the same JAX init, and by the JAX package again from that init moved
one ulp up and one down.

A helper module of the tests (it imports both packages, as
``tests/torch_multihost_worker.py`` does), built out of
``tests/test_torch_accuracy_flow.py``'s ``_fit_at_depth``:

- :func:`run_task` curates a fold through the twin's own stage (the JAX
  package's fold bit for bit), writes the JAX script's model args and runs
  the array task in one package: in JAX with its ``init`` patched to
  record the tree it draws, or to hand out a recorded tree (moved by
  ``ulp``); in the port with its ``init`` patched to
  ``interop.params_from_jax`` of that tree. It returns the task's record
  as ``tools/task_history.py`` writes it: per epoch the validation
  losses and the early-stopping criterion, the best and stop epochs, the
  wall, and the GC estimate's off-diagonal optimal F1 and ROC-AUC.
- :func:`run_grid_lanes` runs ``run_coefficient_grid`` in one package on a
  fold's arrays, every lane from one point init (a JAX init, or that init
  moved by ``ulp``), and returns each lane's histories and decisions.
- :func:`parting_epoch` (``tools/task_history.py``'s) is the first epoch
  at which two histories differ beyond the trainer bars.
- :func:`verdict` applies item 13's rule: the port is faithful on a task
  when it follows JAX for as long as JAX follows itself under a one-ulp
  move of its init.
- :func:`epoch_bisect` is the bisect of a task where the port parts
  first: every run traced step by step to the end of the parting epoch,
  and each step of that epoch and the one before it taken again from
  JAX's own state by JAX, by the port in float32 and by the port in
  float64, under a stated rule for a faulty step (above
  :data:`FAULT_DECADE`).
"""
import contextlib
import importlib.util
import os
import time

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "task_history", os.path.join(REPO, "tools", "task_history.py"))
TH = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TH)

parting_epoch = TH.parting_epoch
prepare = TH.prepare
HIST = TH.HIST

# the model class each model type trains, by package: only its ``init``
# is patched (REDCLIFF-S's own init calls its embedder's)
_CLASSES = (("REDCLIFF", "redcliff", "RedcliffSCMLP"),
            ("DGCNN", "dgcnn", "DGCNNModel"),
            ("LSTM", "clstm_fm", "CLSTMFM"),
            ("MLP", "cmlp_fm", "CMLPFM"),
            ("DCSFA", "dcsfa_nmf", "DcsfaNmf"))


def model_classes(model_type):
    """``(JAX class, port class)`` of the model ``model_type`` trains."""
    import importlib

    for tag, mod, name in _CLASSES:
        if tag in model_type.upper():
            return tuple(getattr(importlib.import_module(
                f"{pkg}.models.{mod}"), name)
                for pkg in ("redcliff_tpu", "redcliff_tpu_torch"))
    raise KeyError(model_type)


def move_ulp(tree, ulp):
    """``tree`` with every floating leaf moved ``ulp`` units in the last
    place (toward +inf for ``ulp`` > 0, -inf for ``ulp`` < 0); other leaves
    as they are."""
    if not ulp:
        return tree

    def move(x):
        if not np.issubdtype(np.asarray(x).dtype, np.floating):
            return x
        for _ in range(abs(ulp)):
            x = np.nextafter(x, np.sign(ulp) * np.inf, dtype=x.dtype)
        return x
    return jax.tree.map(move, tree)


def patch_inits(monkeypatch, model_type, init=None, ulp=0):
    """Through ``monkeypatch``, the JAX class's ``init`` records the tree it
    draws (without ``init``) or hands out ``init`` moved by ``ulp``; the
    port class's ``init`` hands out that tree as torch tensors on the
    device it is asked for. Returns ``{"init": the tree}``, filled once
    drawn."""
    from redcliff_tpu_torch import interop

    jcls, tcls = model_classes(model_type)
    recorded = {} if init is None else {"init": init}
    jinit = jcls.init

    def given():
        return move_ulp(recorded["init"], ulp)

    def jax_init(self, *a, **kw):
        if init is not None:
            return jax.tree.map(jax.numpy.asarray, given())
        out = jinit(self, *a, **kw)
        recorded["init"] = jax.tree.map(np.asarray, out)
        return out

    def port_init(self, generator, *a, device="cpu"):
        # (generator, device) or DCSFA's (generator, dim_in, device)
        if "init" not in recorded:
            raise ValueError("the port runs from a JAX init: pass init=")
        return interop.params_from_jax(given(), a[-1] if a else device)

    monkeypatch.setattr(jcls, "init", jax_init)
    monkeypatch.setattr(tcls, "init", port_init)
    return recorded


@contextlib.contextmanager
def patched_inits(model_type, init=None, ulp=0):
    """:func:`patch_inits` within the block; yields its record."""
    with pytest.MonkeyPatch.context() as mp:
        yield patch_inits(mp, model_type, init=init, ulp=ulp)


def _jax_task(prep, workdir):
    from redcliff_tpu.eval.cross_alg import evaluate_algorithm_on_fold
    from redcliff_tpu.obs.logging import read_jsonl
    from redcliff_tpu.runtime.checkpoint import read_checkpoint
    from redcliff_tpu.train import driver

    root = os.path.join(workdir, "runs")
    os.makedirs(root, exist_ok=True)
    t0 = time.time()
    driver.set_up_and_run_experiments(
        {"save_root_path": root}, [prep["margs_file"]],
        [prep["dargs_file"]], [prep["model_type"]],
        [TH.data_set_name(prep["dargs_file"])], task_id=1)
    wall = time.time() - t0
    (run,) = os.listdir(root)
    run_dir = os.path.join(root, run)
    out = TH.read_history(run_dir, read_checkpoint, read_jsonl)
    out.update(wall_s=wall, run_dir=run_dir, device="cpu", seed=0,
               **TH.scores(evaluate_algorithm_on_fold(
                   run_dir, prep["eval_alias"], prep["true_gc"])))
    return out


def run_task(study, system, fold, alg, package, workdir, init=None, ulp=0,
             overrides=None, prep=None):
    """One array task of ``study`` in ``package`` ("jax" or "port", on the
    CPU). Without ``init`` JAX draws its own (recorded); the port needs
    ``init``, a JAX init. ``ulp`` moves every float leaf of ``init``.
    ``prep`` is an earlier :func:`prepare` of the same fold and args
    (curation is the slow part); else the fold is curated under
    ``workdir``. Returns the task's record, with the init it ran from
    under "init"."""
    if prep is None:
        prep = prepare(study, system, fold, alg, workdir, overrides=overrides)
    run_dir = os.path.join(workdir, f"{package}{ulp:+d}" if ulp
                           else package)
    with patched_inits(prep["model_type"], init=init, ulp=ulp) as rec:
        if package == "jax":
            out = _jax_task(prep, run_dir)
        else:
            out = TH.run_port_task(prep, run_dir, seed=0, device="cpu")
    out.update(package=package, ulp=ulp, study=study, system=system,
               fold=fold, alg=alg, init=rec["init"])
    return out


def verdict(jax_run, port_run, moved):
    """Item 13's rule on one task: ``p_J`` the earliest parting of a
    one-ulp JAX run from the JAX run, ``p`` the port's parting from it.
    Faithful when ``p`` is None or ``p >= p_J``; where neither parts by
    the stop, the best and stop epochs must also be equal."""
    pj = [parting_epoch(m, jax_run) for m in moved]
    p_j = None if all(p is None for p in pj) else min(
        p for p in pj if p is not None)
    p = parting_epoch(port_run, jax_run)
    faithful = p is None or (p_j is not None and p >= p_j)
    if p is None and p_j is None:
        faithful = (port_run["best_it"] == jax_run["best_it"]
                    and port_run["stop_epoch"] == jax_run["stop_epoch"])
    return {"p_J": p_j, "p_J_by_ulp": pj, "p_port": p,
            "faithful": bool(faithful)}


def l_leg(study, system, fold, alg, workdir, overrides=None, ulps=(1, -1)):
    """The L leg of a task: JAX from its own init, the port from it, JAX
    from it moved by each of ``ulps`` (one ulp up and down: the rule's
    null), all on one curated fold. Returns ``{"jax", "port", "jax+1",
    "jax-1", ..., "verdict"}``, the verdict over every moved run."""
    prep = prepare(study, system, fold, alg, workdir, overrides=overrides)
    j = run_task(study, system, fold, alg, "jax", workdir, prep=prep)
    t = run_task(study, system, fold, alg, "port", workdir, init=j["init"],
                 prep=prep)
    out = {"jax": j, "port": t}
    for u in ulps:
        out[f"jax{u:+d}"] = run_task(study, system, fold, alg, "jax",
                                     workdir, init=j["init"], ulp=u,
                                     prep=prep)
    out["verdict"] = verdict(j, t, [out[f"jax{u:+d}"] for u in ulps])
    return out


def port_init_tree(prep, seed=0):
    """The port's own init of ``prep``'s model (the array task's: a CPU
    generator seeded with ``seed``) as a numpy tree, for JAX to start
    from."""
    import torch

    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.train import driver, orchestration as orch
    from redcliff_tpu_torch.utils import config

    mt = prep["model_type"]
    args = {"model_type": mt, "model_cached_args_file": prep["margs_file"],
            "data_set_name": TH.data_set_name(prep["dargs_file"]),
            "data_cached_args_file": prep["dargs_file"]}
    # the driver's reading of the cached args
    config.read_in_model_args(args)
    config.read_in_data_args(args)
    if "coeff_dict" in args and "REDCLIFF" in mt:
        driver.rescale_dataset_dependent_coefficients(args)
    model = orch.create_model_instance(
        args, employ_version_with_smoothing_loss="Smooth" in mt)
    return interop.params_to_jax(model.init(
        torch.Generator().manual_seed(seed), "cpu"))


def summary(leg):
    """The numbers PERF.md records of an L leg, JSON-ready."""
    keep = ("best_it", "stop_epoch", "f1", "roc_auc", "wall_s")
    return {"verdict": leg["verdict"],
            **{name: {k: leg[name][k] for k in keep}
               for name in leg if name.startswith(("jax", "port"))}}


# ------------------------------------------------------------ grid lanes
def grid_setup(package, base, model_type, margs, dargs_file, fold=0):
    """The selection setup of ``d4ic_grid_search.py`` (the twin's
    ``selection_setup``, or the JAX script's steps on the same files) on
    the fold's arrays: ``(args_dict, model, train_ds, val_ds, train
    config)``."""
    from redcliff_tpu_torch.experiments import d4ic_grid_search as TG

    os.makedirs(base, exist_ok=True)
    if package == "port":
        return TG.selection_setup(base, model_type, margs, dargs_file,
                                  device="cpu", fold=fold)
    import json

    from redcliff_tpu.train import driver as jdriver
    from redcliff_tpu.train import orchestration as jorch
    from redcliff_tpu.train import redcliff_trainer as jtr
    from redcliff_tpu.utils import config as jconfig

    margs_file = os.path.join(base, f"{model_type}_gs_cached_args.txt")
    with open(margs_file, "w") as f:
        json.dump(margs, f)
    args_dict = {"save_root_path": os.path.join(base, "jax_runs"),
                 "model_type": model_type,
                 "model_cached_args_file": margs_file,
                 "data_set_name": f"data_fold{fold}",
                 "data_cached_args_file": dargs_file}
    jconfig.read_in_model_args(args_dict)
    jconfig.read_in_data_args(args_dict)
    jdriver.rescale_dataset_dependent_coefficients(args_dict)
    model = jorch.create_model_instance(
        args_dict, employ_version_with_smoothing_loss="Smooth" in model_type)
    train_ds, val_ds = jorch.get_data_for_model_training(args_dict,
                                                         grid_search=False)
    tc = jtr.RedcliffTrainConfig(
        embed_lr=args_dict["embed_lr"], embed_eps=args_dict["embed_eps"],
        embed_weight_decay=args_dict["embed_weight_decay"],
        gen_lr=args_dict["gen_lr"], gen_eps=args_dict["gen_eps"],
        gen_weight_decay=args_dict["gen_weight_decay"],
        max_iter=args_dict["max_iter"], lookback=args_dict["lookback"],
        check_every=args_dict["check_every"],
        batch_size=args_dict["batch_size"],
        stopping_criteria_forecast_coeff=args_dict[
            "stopping_criteria_forecast_coeff"],
        stopping_criteria_factor_coeff=args_dict[
            "stopping_criteria_factor_coeff"],
        stopping_criteria_cosSim_coeff=args_dict[
            "stopping_criteria_cosSim_coeff"])
    return args_dict, model, train_ds, val_ds, tc


def run_grid_lanes(package, base, model_type, margs, dargs_file, points,
                   fold=0, init=None, ulp=0, max_iter=None):
    """``run_coefficient_grid`` in ``package`` on the fold's arrays, every
    lane from one point init: JAX's ``model.init(PRNGKey(0))`` (the
    array task's key) without ``init``, else ``init`` moved by ``ulp``
    (the port needs ``init``). The engine points are given in the
    grid's own coefficients (the twins' ``engine_points`` /
    ``rescaled_adj``). Returns ``{"val_history" (epochs, G),
    "best_criteria", "best_epoch", "active", "failures", "lanes": [per
    lane {"val": [...], "best_it"}], "wall_s", "init", "result"}``."""
    _, model, train_ds, val_ds, tc = grid_setup(
        package, base, model_type, margs, dargs_file, fold=fold)
    if init is None:
        if package != "jax":
            raise ValueError("the port runs from a JAX init: pass init=")
        init = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    start = move_ulp(init, ulp)
    t0 = time.time()
    if package == "jax":
        from redcliff_tpu.train import driver as jdriver

        res = jdriver.run_coefficient_grid(
            model, tc, points, train_ds, val_ds, key=jax.random.PRNGKey(0),
            max_iter=max_iter, init_point_params=start)
    else:
        from redcliff_tpu_torch import interop
        from redcliff_tpu_torch.train import driver as tdriver

        res = tdriver.run_coefficient_grid(
            model, tc, points, train_ds, val_ds, key=0, max_iter=max_iter,
            init_point_params=interop.params_from_jax(start, "cpu"),
            device="cpu")
    wall = time.time() - t0
    hist = np.asarray(res.val_history, dtype=np.float64)
    # a retired lane's column carries its last value forward, so one lane
    # that stops before the other parts from it there
    lanes = [{"val": [TH._num(v) for v in hist[:, g]],
              "best_it": int(np.asarray(res.best_epoch)[g])}
             for g in range(hist.shape[1])]
    return {"val_history": hist,
            "best_criteria": np.asarray(res.best_criteria, np.float64),
            "best_epoch": np.asarray(res.best_epoch),
            "active": np.asarray(res.active), "failures": res.failures,
            "lanes": lanes, "wall_s": wall, "init": init, "result": res}


def grid_l_leg(base, model_type, margs, dargs_file, points, init, fold=0,
               max_iter=None):
    """The L leg of a grid: JAX and the port from ``init``, JAX from it
    moved one ulp up and down, on one fold's arrays (each package's grid
    setup under its own dir of ``base``). Returns ``{"jax", "port",
    "jax+1", "jax-1", "verdicts": [per lane, as :func:`verdict`]}``."""
    runs = {}
    for name, package, ulp in (("jax", "jax", 0), ("port", "port", 0),
                               ("jax+1", "jax", 1), ("jax-1", "jax", -1)):
        runs[name] = run_grid_lanes(
            package, os.path.join(base, name), model_type, margs,
            dargs_file, points, fold=fold, init=init, ulp=ulp,
            max_iter=max_iter)
    verdicts = []
    for g in range(len(points)):
        lane = {name: {"criteria": [], "val": {"val": r["lanes"][g]["val"]},
                       "best_it": r["lanes"][g]["best_it"],
                       "stop_epoch": len(r["lanes"][g]["val"]) - 1}
                for name, r in runs.items()}
        verdicts.append(verdict(lane["jax"], lane["port"],
                                [lane["jax+1"], lane["jax-1"]]))
    runs["verdicts"] = verdicts
    return runs


# ------------------------------------------------- one step, against f64
def _loss(model, params, X, Y, phase):
    if phase is not None:
        return model.loss_for_phase(params, X, Y, phase)
    if "DGCNN" in type(model).__name__:
        return model.loss(params, X, Y)
    return model.loss(params, X)


def _sorted_leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _cast(tree, dtype):
    """Every floating leaf of a numpy tree in ``dtype``."""
    return jax.tree.map(
        lambda x: np.asarray(x, dtype)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x),
        tree)


def _tensor(x, dtype):
    import torch

    if x is None:
        return None
    x = np.asarray(x)
    return torch.from_numpy(np.array(
        x, dtype if np.issubdtype(x.dtype, np.floating) else x.dtype))


def _grad_errors(jmodel, tmodel, params, X, Y, phase):
    """One batch's loss and gradients at ``params`` in JAX float32, the
    port float32 and the port float64: ``{"loss": (jax32, port32, f64),
    "leaves": [(|jax32 - f64|, |port32 - f64|) over max |f64|, per
    gradient leaf]}``, and JAX's gradient tree (numpy) under
    "jax_grad"."""
    import torch

    from redcliff_tpu_torch import interop

    def jloss(p):
        return _loss(jmodel, p, jax.numpy.asarray(X),
                     None if Y is None else jax.numpy.asarray(Y), phase)[0]
    jval, jgrad = jax.value_and_grad(jloss)(
        jax.tree.map(jax.numpy.asarray, _cast(params, np.float32)))
    port = {}
    for dt in (np.float32, np.float64):
        tree = interop.params_from_jax(_cast(params, dt))
        leaves = _sorted_leaves(tree)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = _loss(tmodel, tree, _tensor(X, dt), _tensor(Y, dt), phase)[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        port[dt] = (float(loss.detach()), [
            np.zeros(leaf.shape) if g is None
            else g.detach().numpy().astype(np.float64)
            for g, leaf in zip(grads, leaves)])
    errs = []
    for jg, g32, g64 in zip(jax.tree.leaves(jgrad), port[np.float32][1],
                            port[np.float64][1]):
        scale = max(float(np.abs(g64).max()), 1e-30)
        errs.append((float(np.abs(np.asarray(jg, np.float64) - g64).max()
                           / scale),
                     float(np.abs(g32 - g64).max() / scale)))
    return {"loss": (float(jval), port[np.float32][0], port[np.float64][0]),
            "leaves": errs, "jax_grad": jax.tree.map(np.asarray, jgrad)}


# ------------------------------------------------ inside the parting epoch
# A step is faulty when, from JAX's own state and batch, (a) JAX's float32
# loss or a gradient leaf lies farther from the port's float64 one than
# ten times the port's float32 one does (and than ten unit roundoffs): a
# fault changes the function the port computes, so it shows between JAX
# and the port's float64 whatever the precision, while rounding shows in
# both float32 results alike (two orderings of the same float32 sums err
# by the same order, each ~sqrt(n) unit roundoffs; a decade between them
# is not rounding); or (b) given JAX's gradient and state, the port's
# optimizer lands farther from Adam in float64 (computed here from JAX's
# hyperparameters) than ten times JAX's optimizer does (and than ten
# ulps of the new value), on some leaf: the same decade, with a reference
# independent of both packages (JAX's optax rounds its bias corrections
# in float32, the port's torch in float64). The whole step's update is
# reported beside them, not judged: Adam divides each element by its own
# scale, so an element whose gradient nearly cancels carries its
# rounding into the update at full size, in either package.
FAULT_DECADE = 10.0
UNIT_ROUNDOFF = 2.0 ** -24


def _trainer_classes(model_type):
    """``(JAX trainer class, port trainer class)`` of ``model_type``'s
    fit."""
    import importlib

    mod, name = (("redcliff_trainer", "RedcliffTrainer")
                 if "REDCLIFF" in model_type.upper() else ("trainer", "Trainer"))
    return tuple(getattr(importlib.import_module(f"{pkg}.train.{mod}"), name)
                 for pkg in ("redcliff_tpu", "redcliff_tpu_torch"))


def dither_ulp(x, rng):
    """A floating array with each element moved one ulp, up or down at
    random (``rng``, a numpy ``Generator``); other arrays as they are."""
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        return x
    return np.where(rng.random(x.shape) < 0.5,
                    np.nextafter(x, np.inf, dtype=x.dtype),
                    np.nextafter(x, -np.inf, dtype=x.dtype))


def patch_step_trace(monkeypatch, model_type, package, epochs=(),
                     dither=None):
    """Through ``monkeypatch``, ``package``'s trainer records each step it
    takes: its epoch (counted by the trainer's ``validate``), phase and
    loss; at the first step of an epoch the params it starts from; at each
    step of ``epochs`` its batch and, in JAX, every input of the step
    program (params, optimizer states, batch, counters). With ``dither``
    (a seed; JAX only) each step's new params are moved one ulp, up or
    down element by element at random: the per-step null. Returns the
    record ``{"steps": [...], "trainer", "programs": {phase: JAX
    step}}``."""
    from redcliff_tpu_torch import interop

    redcliff = "REDCLIFF" in model_type.upper()
    cls = _trainer_classes(model_type)[package != "jax"]
    rec = {"steps": [], "epoch": 0, "programs": {}}
    validate = cls.validate
    signs = None if dither is None else np.random.default_rng(dither)

    def counted(self, *a, **kw):
        rec["epoch"] += 1
        return validate(self, *a, **kw)

    def entry(phase, params):
        e = rec["epoch"]
        out = {"epoch": e, "phase": phase}
        if not rec["steps"] or rec["steps"][-1]["epoch"] != e:
            out["params"] = params()
        rec["steps"].append(out)
        return out

    def traced_program(program, phase):
        rec["programs"][phase] = program

        def step(*args):
            out = entry(phase, lambda: jax.tree.map(np.asarray, args[0]))
            if out["epoch"] in epochs:
                out["args"] = jax.tree.map(np.asarray, args)
            result = program(*args)
            out["loss"] = float(result[3 if redcliff else 2])
            if signs is not None:
                result = (jax.tree.map(
                    lambda x: jax.numpy.asarray(dither_ulp(x, signs)),
                    result[0]),) + tuple(result[1:])
            return result
        return step

    if package == "jax":
        build = cls._build_steps

        def traced_build(self):
            build(self)
            rec["trainer"] = self
            if redcliff:
                for phase, program in list(self._steps.items()):
                    self._steps[phase] = traced_program(program, phase)
            else:
                self._train_step = traced_program(self._train_step, None)
        monkeypatch.setattr(cls, "_build_steps", traced_build)
    else:
        train_step = cls.train_step

        def traced_step(self, live, *a):
            # RedcliffTrainer: (optA, optB, X, Y, phase, nstate); Trainer:
            # (opt, X, Y, rng, nstate)
            rec["trainer"] = self
            X, Y = a[2:4] if redcliff else a[1:3]
            out = entry(a[4] if redcliff else None,
                        lambda: interop.params_to_jax(live))
            if out["epoch"] in epochs:
                out["X"] = X.detach().cpu().numpy()
            result = train_step(self, live, *a)
            out["loss"] = float(result[0].detach())
            return result
        monkeypatch.setattr(cls, "train_step", traced_step)
    monkeypatch.setattr(cls, "validate", counted)
    return rec


def _adam_moments(opt_state):
    """``(count, mu, nu)`` of the one optax ``ScaleByAdamState`` in
    ``opt_state`` (a numpy tree)."""
    import optax

    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    (adam,) = [x for x in jax.tree.leaves(opt_state, is_leaf=is_adam)
               if is_adam(x)]
    return int(adam.count), adam.mu, adam.nu


def _port_optimizers(trainer, live, args, dtype):
    """The port ``trainer``'s optimizers over ``live`` with the Adam
    moments and step counts of the JAX step inputs ``args``: ``{"embedder",
    "factors"}`` (REDCLIFF-S) or ``{"all"}``, each ``(optimizer, its
    subtree of live)``."""
    import torch

    from redcliff_tpu_torch import interop

    if hasattr(trainer, "make_optimizers"):
        optA, optB = trainer.make_optimizers(live)
        opts = {"embedder": (optA, live["embedder"], args[1]),
                "factors": (optB, live["factors"], args[2])}
    else:
        opts = {"all": (trainer.make_optimizer(live), live, args[1])}
    for opt, sub, state in opts.values():
        count, mu, nu = _adam_moments(state)
        for p, m, v in zip(interop.tree_leaves(sub), interop.tree_leaves(
                interop.params_from_jax(_cast(mu, dtype))),
                interop.tree_leaves(interop.params_from_jax(
                    _cast(nu, dtype)))):
            opt.state[p] = {"step": torch.tensor(float(count)),
                            "exp_avg": m, "exp_avg_sq": v}
    return {k: v[:2] for k, v in opts.items()}


def _live(params, dtype):
    from redcliff_tpu_torch import interop

    live = interop.params_from_jax(_cast(params, dtype))
    for leaf in interop.tree_leaves(live):
        leaf.requires_grad_(True)
    return live


def port_step_from_jax(trainer, args, phase, dtype):
    """One step of the port's ``trainer`` from the inputs ``args`` of a JAX
    step program (params, optimizer states, batch; numpy) in ``dtype``:
    its Adam moments and step counts are JAX's. Returns ``(loss, the
    params it leaves as a numpy tree)``."""
    from redcliff_tpu_torch import interop
    from redcliff_tpu_torch.runtime import numerics

    live = _live(args[0], dtype)
    opts = _port_optimizers(trainer, live, args, dtype)
    nstate = numerics.init_numerics_state()
    if "all" in opts:
        X, Y = (_tensor(x, dtype) for x in args[2:4])
        loss = trainer.train_step(live, opts["all"][0], X, Y, None, nstate)[0]
    else:
        X, Y = (_tensor(x, dtype) for x in args[3:5])
        loss = trainer.train_step(live, opts["embedder"][0],
                                  opts["factors"][0], X, Y, phase, nstate)[0]
    return float(loss.detach()), interop.params_to_jax(live)


# the parts of REDCLIFF-S's params each phase's step updates
_PHASE_PARTS = {"embedder_pretrain": ("embedder",),
                "factor_pretrain": ("factors",), "post_train": ("factors",),
                "combined": ("embedder", "factors")}


def _adam64(state, grad, params, lr, eps, wd):
    """Adam's new params in float64 (torch.optim.Adam's and
    ``_torch_style_adam``'s math: decay added to the gradient, betas 0.9
    and 0.999) from an optax state, a gradient and the params (numpy
    trees); the tree of ``params``."""
    b1, b2 = 0.9, 0.999
    count, mu, nu = _adam_moments(state)
    t = count + 1

    def new(m, v, g, p):
        m, v, g, p = (np.asarray(x, np.float64) for x in (m, v, g, p))
        g = g + wd * p
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        return p - lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t))
                                                + eps)
    return jax.tree.map(new, mu, nu, grad, params)


def _adam_hyper(jtrainer, part):
    """``(lr, eps, weight decay)`` of JAX's optimizer over ``part``."""
    c = jtrainer.config
    if part == "all":
        return c.learning_rate, 1e-8, 0.0
    pre = "embed" if part == "embedder" else "gen"
    return (getattr(c, f"{pre}_lr"), getattr(c, f"{pre}_eps"),
            getattr(c, f"{pre}_weight_decay"))


def optimizer_check(jtrainer, ttrainer, args, phase, jgrad):
    """JAX's optimizer and the port's from one state (the JAX step inputs
    ``args``) and one gradient (``jgrad``, JAX's float32), each against
    Adam in float64: per leaf ``(|new_jax - new64|, |new_port - new64|,
    ulp of new64)``, each its largest entry over the largest ``|new64 -
    old|``."""
    import optax
    import torch

    from redcliff_tpu_torch import interop

    asj = lambda t: jax.tree.map(jax.numpy.asarray, t)  # noqa: E731
    params = args[0]
    live = _live(params, np.float32)
    opts = _port_optimizers(ttrainer, live, args, np.float32)
    if "all" in opts:
        parts = {"all": (jtrainer.optimizer, args[1])}
        order = ("all",)
    else:
        parts = {"embedder": (jtrainer.optA, args[1]),
                 "factors": (jtrainer.optB, args[2])}
        order = _PHASE_PARTS[phase]
    jnext = ref = params
    for k in order:
        opt, state = parts[k]
        sub = params if k == "all" else params[k]
        grad = jgrad if k == "all" else jgrad[k]
        upd, _ = opt.update(asj(grad), asj(state), asj(sub))
        new = jax.tree.map(np.asarray, optax.apply_updates(asj(sub), upd))
        new64 = _adam64(state, grad, sub, *_adam_hyper(jtrainer, k))
        if k == "all":
            jnext, ref = new, new64
        else:
            jnext, ref = dict(jnext, **{k: new}), dict(ref, **{k: new64})
        topt, tsub = opts[k]
        with torch.no_grad():
            for p, g in zip(interop.tree_leaves(tsub), interop.tree_leaves(
                    interop.params_from_jax(_cast(grad, np.float32)))):
                p.grad = g
        topt.step()
    tnext = interop.params_to_jax(live)
    out = []
    for j, t, r, p in zip(jax.tree.leaves(jnext), _sorted_leaves(tnext),
                          jax.tree.leaves(ref), jax.tree.leaves(params)):
        r = np.asarray(r, np.float64)
        scale = max(float(np.abs(r - np.asarray(p, np.float64)).max()),
                    1e-30)
        out.append(tuple(float(x) / scale for x in (
            np.abs(np.asarray(j, np.float64) - r).max(),
            np.abs(np.asarray(t, np.float64) - r).max(),
            np.spacing(np.abs(r).astype(np.float32)).max())))
    return out


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 .max() / max(float(np.abs(np.asarray(b, np.float64)).max()),
                              1e-30))


def _flagged(e_jax, e_port):
    """The rule's (a) on one term."""
    return e_jax > FAULT_DECADE * max(e_port, UNIT_ROUNDOFF)


def step_in_epoch(jtrainer, ttrainer, program, args, phase):
    """One step of a traced JAX epoch from JAX's own state: the JAX step
    program again, and the port's step from the same params, Adam
    moments and batch in float32 and float64. Returns the loss
    ``(jax32, port32, f64)``; per gradient leaf and per updated leaf
    ``(|jax32 - f64|, |port32 - f64|)`` over the f64 gradient's largest
    entry or over the f64 update's (with the updated leaf's float32 floor,
    half an ulp of its largest entry, over the same); per leaf the
    optimizer check (:func:`optimizer_check`); and whether the step is
    faulty (the rule above :data:`FAULT_DECADE`), with the terms that are:
    "loss", "grad<i>", "opt<i>"."""
    jout = program(*jax.tree.map(
        lambda x: None if x is None else jax.numpy.asarray(x), args))
    jnext = jax.tree.map(np.asarray, jout[0])
    redcliff = hasattr(ttrainer, "make_optimizers")
    jloss = float(jout[3 if redcliff else 2])
    p32, next32 = port_step_from_jax(ttrainer, args, phase, np.float32)
    p64, next64 = port_step_from_jax(ttrainer, args, phase, np.float64)
    X, Y = args[3:5] if redcliff else args[2:4]
    g = _grad_errors(jtrainer.model, ttrainer.model, args[0], np.asarray(X),
                     None if Y is None else np.asarray(Y), phase)
    update = []
    for j, t32, t64, p in zip(_sorted_leaves(jnext), _sorted_leaves(next32),
                              _sorted_leaves(next64),
                              jax.tree.leaves(args[0])):
        moved = np.asarray(t64, np.float64) - np.asarray(p, np.float64)
        scale = max(float(np.abs(moved).max()), 1e-30)
        update.append((float(np.abs(np.asarray(j, np.float64) - t64).max()
                             / scale),
                       float(np.abs(np.asarray(t32, np.float64) - t64).max()
                             / scale),
                       UNIT_ROUNDOFF * float(np.abs(t64).max()) / scale))
    opt = optimizer_check(jtrainer, ttrainer, args, phase, g["jax_grad"])
    terms = [("loss", abs(jloss - p64) / abs(p64), abs(p32 - p64) / abs(p64))]
    terms += [(f"grad{i}", e_j, e_p) for i, (e_j, e_p) in enumerate(
        g["leaves"])]
    faulty = [name for name, e_j, e_p in terms if _flagged(e_j, e_p)]
    faulty += [f"opt{i}" for i, (e_j, e_p, ulp) in enumerate(opt)
               if e_p > FAULT_DECADE * max(e_j, ulp)]
    return {"loss": (jloss, p32, p64), "grad": g["leaves"], "update": update,
            "optimizer": opt, "faulty": bool(faulty), "faulty_terms": faulty}


def kink_check(jmodel, tmodel, args, phase, terms):
    """A flagged step's gradient terms ``terms`` ("grad<i>") at its params
    moved one ulp up and one down, and JAX's jitted gradient against its
    eager one at the params themselves: where JAX's float32 gradient jumps
    by the flagged size within one ulp and disagrees with itself between
    two compilations, the params sit on a non-differentiable point (a
    ReLU or a max whose argument rounds to its kink), a tie of rounding
    rather than a different function. Returns ``{"moved": {ulp: the terms
    still flagged}, "jit_vs_eager": largest |jit - eager| over the
    gradient's largest entry, "tie": no term flagged at either move}``."""
    # a REDCLIFF-S step program takes (params, optA, optB, X, Y, ...), the
    # generic one (params, opt, X, Y, ...)
    X, Y = args[3:5] if phase is not None else args[2:4]
    X, Y = np.asarray(X), None if Y is None else np.asarray(Y)
    moved = {}
    for u in (1, -1):
        g = _grad_errors(jmodel, tmodel, move_ulp(args[0], u), X, Y, phase)
        moved[u] = [t for t in terms if _flagged(*g["leaves"][int(t[4:])])]

    def jloss(p):
        return _loss(jmodel, p, jax.numpy.asarray(X),
                     None if Y is None else jax.numpy.asarray(Y), phase)[0]
    p32 = jax.tree.map(jax.numpy.asarray, _cast(args[0], np.float32))
    eager, jit = jax.grad(jloss)(p32), jax.jit(jax.grad(jloss))(p32)
    scale = max(float(np.abs(np.asarray(x)).max())
                for x in jax.tree.leaves(eager))
    diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(jax.tree.leaves(eager), jax.tree.leaves(jit)))
    return {"moved": moved, "jit_vs_eager": diff / max(scale, 1e-30),
            "tie": not any(moved.values())}


def _first_step_parting(steps, ref):
    """The first step whose loss differs from ``ref``'s beyond the trainer
    bars, as ``(step, epoch)``, or None."""
    for i, (a, b) in enumerate(zip(steps, ref)):
        if not TH._close(a["loss"], b["loss"], HIST["rtol"], HIST["atol"]):
            return i, b["epoch"]
    return None


def _params_at(steps, epoch):
    (first,) = [s["params"] for s in steps
                if s["epoch"] == epoch and "params" in s]
    return first


def epoch_bisect(study, system, fold, alg, workdir, epoch, ulps=(1, -1),
                 overrides=None, keep_traces=False):
    """The bisect inside the parting epoch ``epoch`` (the port's parting
    from JAX on one task): JAX, the port and JAX's ``ulps`` moves from one
    JAX init, each trained to the end of ``epoch`` (``max_iter`` cut to
    ``epoch + 1``), every step traced. Returns the histories' verdict;
    the first step whose loss parts from JAX's in the port and in each
    move; how far each run's params lie from JAX's (per leaf, over its
    largest entry) entering ``epoch - 1`` and ``epoch``; whether the port
    saw JAX's batches; and each step of those two epochs from JAX's own
    state (:func:`step_in_epoch`; a step flagged on its gradient also
    :func:`kink_check`), with the counts of faulty steps and of those that
    are ties at a kink; with ``keep_traces``, each run's trace
    (:func:`patch_step_trace`) under "traces". ``workdir`` must be new: a
    run dir that holds a finished run resumes it instead of training."""
    traced = (epoch - 1, epoch)
    prep = prepare(study, system, fold, alg, workdir,
                   overrides=dict(overrides or {}, max_iter=str(epoch + 1)))
    runs, init = {}, None
    for name, package, ulp in (("jax", "jax", 0), ("port", "port", 0),
                               *((f"jax{u:+d}", "jax", u) for u in ulps)):
        with pytest.MonkeyPatch.context() as mp:
            rec = patch_step_trace(mp, prep["model_type"], package,
                                   traced if name in ("jax", "port") else ())
            run = run_task(study, system, fold, alg, package,
                           os.path.join(workdir, name), init=init, ulp=ulp,
                           prep=prep)
        init = run["init"]
        runs[name] = (run, rec)
    j, jrec = runs["jax"]
    t, trec = runs["port"]
    moved = [runs[f"jax{u:+d}"][0] for u in ulps]
    out = {"epoch": epoch, "verdict": verdict(j, t, moved),
           "steps_per_epoch": sum(s["epoch"] == 0 for s in jrec["steps"]),
           "first_step_parting": {}, "params_gap": {}}
    for name, (run, rec) in runs.items():
        if name == "jax":
            continue
        out["first_step_parting"][name] = _first_step_parting(
            rec["steps"], jrec["steps"])
        out["params_gap"][name] = {
            str(e): [_rel(a, b) for a, b in zip(
                jax.tree.leaves(_params_at(rec["steps"], e)),
                jax.tree.leaves(_params_at(jrec["steps"], e)))]
            for e in traced}
    jsteps = [s for s in jrec["steps"] if s["epoch"] in traced]
    tsteps = [s for s in trec["steps"] if s["epoch"] in traced]
    xi = 3 if "REDCLIFF" in prep["model_type"].upper() else 2
    out["same_batches"] = len(jsteps) == len(tsteps) and all(
        np.array_equal(a["args"][xi], b["X"]) for a, b in zip(jsteps, tsteps))
    out["steps"] = []
    for s in jsteps:
        r = step_in_epoch(jrec["trainer"], trec["trainer"],
                          jrec["programs"][s["phase"]], s["args"], s["phase"])
        r.update(epoch=s["epoch"], phase=str(s["phase"]))
        grads = [t for t in r["faulty_terms"] if t.startswith("grad")]
        if grads:
            r["kink"] = kink_check(jrec["trainer"].model,
                                   trec["trainer"].model, s["args"],
                                   s["phase"], grads)
        out["steps"].append(r)
    out["faulty_steps"] = sum(r["faulty"] for r in out["steps"])
    # flagged on gradient terms alone, each cleared one ulp either way
    out["tie_steps"] = sum(
        r.get("kink", {}).get("tie", False)
        and all(t.startswith("grad") for t in r["faulty_terms"])
        for r in out["steps"])
    out["worst"] = {
        "loss": max(abs(r["loss"][0] - r["loss"][2])
                    / max(abs(r["loss"][1] - r["loss"][2]),
                          UNIT_ROUNDOFF * abs(r["loss"][2]))
                    for r in out["steps"]),
        "grad": max(e_j / max(e_p, UNIT_ROUNDOFF)
                    for r in out["steps"] for e_j, e_p in r["grad"]),
        "optimizer": max(e_p / max(e_j, ulp) for r in out["steps"]
                         for e_j, e_p, ulp in r["optimizer"]),
        "update": max(e_j / max(e_p, floor)
                      for r in out["steps"] for e_j, e_p, floor in r["update"])}
    out["runs"] = {name: _record(run) for name, (run, _) in runs.items()}
    if keep_traces:
        out["traces"] = {name: rec for name, (_, rec) in runs.items()}
    return out


# ------------------------------------------------------------ command line
def _record(run):
    """A run's record without its init tree, JSON-ready."""
    return {k: v for k, v in run.items() if k not in ("init", "result")}


def _leg_record(leg):
    out = {"summary": summary(leg),
           **{k: _record(v) for k, v in leg.items() if k != "verdict"}}
    if "jax+1" in leg and "jax-1" in leg:
        out["verdict_one_ulp"] = verdict(leg["jax"], leg["port"],
                                         [leg["jax+1"], leg["jax-1"]])
    return out


def _grid_record(run, points):
    crit = run["best_criteria"]
    return {"best_criteria": crit.tolist(),
            "best_epoch": run["best_epoch"].tolist(),
            "active": run["active"].tolist(), "failures": run["failures"],
            "epochs": int(run["val_history"].shape[0]),
            "val_history": run["val_history"].tolist(),
            "wall_s": run["wall_s"],
            "selected": points[int(np.argmin(crit))]}


def _spearman(a, b):
    """The science check's rank correlation (0.0 for a constant vector)."""
    from redcliff_tpu_torch.experiments.grid_science_parity import spearman

    return spearman(np.asarray(a, np.float64), np.asarray(b, np.float64))


def science_fold(workdir):
    """ROADMAP queue 3 item 26 on fold 0 of 6-2-2: the per-point leg's four
    array tasks and the four-lane grid, each in JAX, in the port and in JAX
    moved one ulp each way, all from the array task's JAX init; per run
    set, each leg's winner, whether they agree and the rank correlation
    of the per-point best criteria with the lanes'."""
    from redcliff_tpu_torch.experiments import grid_science_parity as GSP

    system, fold = "6-2-2", 0
    names = ("jax", "port", "jax+1", "jax-1")
    prep0 = prepare("science", system, fold, "point0", workdir)
    tasks, init = [], None
    for i in range(len(GSP._grid_points())):
        pwd = os.path.join(workdir, f"point{i}")
        # the fold curated once: each point writes its own model args
        prep = dict(prep0, margs_file=_write_margs(pwd, i, system))
        runs = {"jax": run_task("science", system, fold, f"point{i}", "jax",
                                pwd, init=init, prep=prep)}
        init = runs["jax"]["init"]
        runs["port"] = run_task("science", system, fold, f"point{i}",
                                "port", pwd, init=init, prep=prep)
        for u in (1, -1):
            runs[f"jax{u:+d}"] = run_task("science", system, fold,
                                          f"point{i}", "jax", pwd,
                                          init=init, ulp=u, prep=prep)
        tasks.append(runs)
    points = [{"gen_lr": p["gen_lr"], "adj_l1_reg_coeff": GSP.rescaled_adj(
        p["ADJ_L1_REG_COEFF"], int(system.split("-")[2]),
        int(system.split("-")[0]))} for p in GSP._grid_points()]
    grid = grid_l_leg(os.path.join(workdir, "grid"), GSP.MODEL_TYPE,
                      GSP.base_model_args(system, False),
                      prep0["dargs_file"], points, init, fold=fold)
    out = {"points": GSP._grid_points(),
           "task_verdicts": [verdict(t["jax"], t["port"],
                                     [t["jax+1"], t["jax-1"]])
                             for t in tasks],
           "lane_verdicts": grid["verdicts"], "by_run": {}}
    for name in names:
        pp = [t[name]["criteria"][t[name]["best_it"]] for t in tasks]
        lanes = grid[name]["best_criteria"]
        out["by_run"][name] = {
            "per_point_best_criteria": [TH._value(v) for v in pp],
            "per_point_best_stop": [(t[name]["best_it"],
                                     t[name]["stop_epoch"]) for t in tasks],
            "per_point_f1": [t[name]["f1"] for t in tasks],
            "grid": _grid_record(grid[name], out["points"]),
            "per_point_winner": int(np.argmin([TH._value(v) for v in pp])),
            "grid_winner": int(np.argmin(lanes)),
            "spearman": _spearman([TH._value(v) for v in pp], lanes)}
        r = out["by_run"][name]
        r["same_winner"] = r["per_point_winner"] == r["grid_winner"]
    out["tasks"] = [{k: _record(v) for k, v in t.items()} for t in tasks]
    return out


def _write_margs(pwd, i, system):
    import json

    os.makedirs(pwd, exist_ok=True)
    model_type, margs, _ = TH.STUDIES["science"][2](system, f"point{i}",
                                                   False)
    path = os.path.join(pwd, f"{model_type}_cached_args.txt")
    with open(path, "w") as f:
        json.dump(margs, f)
    return path


def selection_grid(workdir, max_iter=None):
    """ROADMAP queue 3 item 24: the D4IC selection grid stage (the 27
    published points, ``--arch bscgs1``) on HSNR fold 0, in JAX, the
    port and JAX moved one ulp each way from JAX's ``model.init(PRNGKey
    (0))``: each run's criteria, its selected point, the rank of JAX's
    pick and the rank correlation with JAX's criteria."""
    from redcliff_tpu_torch.experiments import d4ic_grid_search as DGS

    fold = 0
    prep = prepare("d4ic", "HSNR", fold, "REDCLIFF_S_CMLP", workdir)
    model_type, margs = DGS.arch_args("bscgs1", smoke=False)
    raw = DGS.raw_points(*DGS.search_axes(False))
    args, model, *_ = grid_setup("jax", os.path.join(workdir, "setup"),
                                 model_type, margs, prep["dargs_file"],
                                 fold=fold)
    points = DGS.engine_points(raw, args["num_factors"],
                               args["num_channels"])
    init = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    grid = grid_l_leg(os.path.join(workdir, "grid"), model_type, margs,
                      prep["dargs_file"], points, init, fold=fold,
                      max_iter=max_iter)
    ref = grid["jax"]["best_criteria"]
    out = {"points": raw, "lane_verdicts": grid["verdicts"], "by_run": {}}
    for name in ("jax", "port", "jax+1", "jax-1"):
        crit = grid[name]["best_criteria"]
        r = out["by_run"][name] = _grid_record(grid[name], raw)
        r["spearman_vs_jax"] = _spearman(crit, ref)
        r["rank_of_jax_pick"] = int(
            np.argsort(np.argsort(crit))[int(np.argmin(ref))]) + 1
    return out


def step_null(study, system, fold, alg, workdir, epochs, seeds=(1, 2)):
    """The per-step null of a task: JAX from its own init, and JAX from it
    with every step's new params moved one ulp at random (one run per seed
    of ``seeds``), each cut to ``epochs`` epochs. Returns each dithered
    run's parting from JAX (``{seed: epoch or None}``) and the runs'
    records. ``workdir`` must be new."""
    prep = prepare(study, system, fold, alg, workdir,
                   overrides={"max_iter": str(epochs)})
    j = run_task(study, system, fold, alg, "jax", os.path.join(workdir, "jax"),
                 prep=prep)
    out = {"parting": {}, "runs": {"jax": _record(j)}}
    for seed in seeds:
        with pytest.MonkeyPatch.context() as mp:
            patch_step_trace(mp, prep["model_type"], "jax", dither=seed)
            d = run_task(study, system, fold, alg, "jax",
                         os.path.join(workdir, f"dither{seed}"),
                         init=j["init"], prep=prep)
        out["parting"][str(seed)] = parting_epoch(d, j)
        out["runs"][f"dither{seed}"] = _record(d)
    return out


def port_init_runs(study, system, alg, folds, workdir):
    """JAX and the port from the port's own seeded init (the array task's
    seed 0), per fold: the init a card study of the port starts from."""
    out = {}
    for fold in folds:
        wd = os.path.join(workdir, f"fold{fold}")
        prep = prepare(study, system, fold, alg, wd)
        own = port_init_tree(prep)
        j = run_task(study, system, fold, alg, "jax", wd, init=own,
                     prep=prep)
        t = run_task(study, system, fold, alg, "port", wd, init=own,
                     prep=prep)
        out[str(fold)] = {"jax": _record(j), "port": _record(t),
                          "parting": parting_epoch(t, j)}
    return out


def main(argv=None):
    """``python tests/torch_depth_parity.py <command> ... --out OUT.json``:
    ``leg STUDY SYSTEM FOLD ALG [--ulps 1,-1] [--set K=V]``,
    ``science-fold``, ``selection-grid [--max-iter N]``, ``epoch-bisect
    STUDY SYSTEM FOLD ALG --epoch P``, ``step-null STUDY SYSTEM FOLD ALG
    --epoch E`` (E epochs), ``port-init STUDY SYSTEM ALG --folds 0,1,2``.
    Each writes its JSON to ``--out`` (work files beside it, under
    ``<out>_work``) and prints its verdicts."""
    import argparse
    import json

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=["leg", "science-fold",
                                        "selection-grid", "epoch-bisect",
                                        "step-null", "port-init"])
    ap.add_argument("args", nargs="*")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ulps", default="1,-1")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--folds", default="0")
    ap.add_argument("--max-iter", type=int)
    ap.add_argument("--epoch", type=int)
    # the port's CPU reductions depend on the thread count: the legs of
    # PERF.md ran with 3
    ap.add_argument("--threads", type=int, default=3)
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)
    wd = os.path.splitext(os.path.abspath(a.out))[0] + "_work"
    t0 = time.time()
    if a.command == "leg":
        study, system, fold, alg = a.args
        leg = l_leg(study, system, int(fold), alg, wd,
                    overrides=dict(kv.split("=", 1) for kv in a.set) or None,
                    ulps=tuple(int(u) for u in a.ulps.split(",")))
        out = _leg_record(leg)
        shown = {"verdict": leg["verdict"],
                 "verdict_one_ulp": out.get("verdict_one_ulp"),
                 **summary(leg)}
    elif a.command == "science-fold":
        out = science_fold(wd)
        shown = {k: out[k] for k in ("task_verdicts", "lane_verdicts")}
        shown["by_run"] = {n: {k: r[k] for k in (
            "per_point_winner", "grid_winner", "same_winner", "spearman")}
            for n, r in out["by_run"].items()}
    elif a.command == "selection-grid":
        out = selection_grid(wd, max_iter=a.max_iter)
        shown = {n: {k: r[k] for k in ("selected", "epochs",
                                       "spearman_vs_jax",
                                       "rank_of_jax_pick", "wall_s")}
                 for n, r in out["by_run"].items()}
    elif a.command == "step-null":
        study, system, fold, alg = a.args
        out = step_null(study, system, int(fold), alg, wd, a.epoch)
        shown = out["parting"]
    elif a.command == "epoch-bisect":
        study, system, fold, alg = a.args
        out = epoch_bisect(study, system, int(fold), alg, wd, a.epoch)
        shown = {k: out[k] for k in ("verdict", "first_step_parting",
                                     "same_batches", "faulty_steps",
                                     "tie_steps", "worst",
                                     "steps_per_epoch")}
    else:
        study, system, alg = a.args
        out = port_init_runs(study, system, alg,
                             [int(f) for f in a.folds.split(",")], wd)
        shown = {f: {"jax": (r["jax"]["best_it"], r["jax"]["stop_epoch"]),
                     "port": (r["port"]["best_it"], r["port"]["stop_epoch"]),
                     "parting": r["parting"]} for f, r in out.items()}
    out["wall_s"] = time.time() - t0
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(shown, default=str), flush=True)
    return out


if __name__ == "__main__":
    main()
