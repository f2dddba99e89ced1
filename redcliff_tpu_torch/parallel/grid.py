"""Coefficient-grid engine: G REDCLIFF-S points trained as one batched
program (port of the core of ``parallel/grid.py``).

The reference fits a coefficient grid as one process per point (SLURM
arrays). The JAX package vmaps the per-point training step over a stacked
parameter/coefficient axis instead; the port does the same with
``torch.func``: each step is ``vmap(grad_and_value(loss_for_phase))`` over
the lanes with the batch shared, followed by two stacked Adams with
``torch.optim.Adam`` semantics per lane (per-lane learning rate, coupled
weight decay, eps and bias correction with per-lane step counts) and the
GL prox for every lane at once (``models/redcliff.py apply_prox_lanes_``).
On the card the factor mix and the prox are hand-written CUDA kernels,
each launched once per call for all G lanes.

Per lane, as the JAX grid: a lane gate ``active & isfinite(loss) &
isfinite(grad norm)`` applied with ``torch.where`` (a gated lane keeps its
params and its Adam state; nothing is read on the host per step), device
counters of the numerics guard, validation as ordered per-batch sums from
zero, the supervised cosine stopping term, per-lane stopping criteria,
``select_best``, the lookback early stop, the non-finite quarantine
(causes ``nonfinite_grad`` / ``nonfinite_val``), Freeze accept/revert over
lanes, and the Hungarian factor alignment after pretraining.

The port runs the JAX path at exact width with the bucket ladder and
compaction off, and streams per batch (the JAX "per_batch" stream mode,
bit-identical there to its epoch and k-batch scans). Not ported yet
(ROADMAP queue 1): checkpoint/resume, lane and grid deadlines, the bucket
ladder, compaction and scheduling policies, ``on_lane_retire``, the scan
stream modes, mixed precision, telemetry (metrics log, quality monitor),
and the device mesh. Asking for any of them raises
``NotImplementedError``.

Entry points run on ``cuda`` unless the caller passes ``device=``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from redcliff_tpu_torch.data import pipeline
from redcliff_tpu_torch.interop import params_to_jax, tree_leaves, tree_map
from redcliff_tpu_torch.models.redcliff import phase_schedule
from redcliff_tpu_torch.ops.pallas_prox import lane_thresholds
from redcliff_tpu_torch.runtime import numerics
from redcliff_tpu_torch.train.freeze import apply_freeze_lanes
from redcliff_tpu_torch.utils.misc import factor_alignment_order
from redcliff_tpu_torch.utils.precision import (check_precision_mode,
                                                resolve_device)

__all__ = ["GridSpec", "GridResult", "RedcliffGridRunner",
           "group_configs_by_shape", "COEFF_AXES", "OPT_AXES", "STOP_AXES"]

COEFF_AXES = (
    "forecast_coeff", "factor_score_coeff", "factor_cos_sim_coeff",
    "factor_weight_l1_coeff", "adj_l1_reg_coeff",
    "factor_weight_smoothing_penalty_coeff",
)
OPT_AXES = ("embed_lr", "gen_lr", "embed_weight_decay", "gen_weight_decay")
# per-point stopping-criteria coefficients; fall back to the train config
STOP_AXES = ("stopping_criteria_forecast_coeff",
             "stopping_criteria_factor_coeff",
             "stopping_criteria_cosSim_coeff")

_BETA1, _BETA2 = 0.9, 0.999


def _not_ported(what, where):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                              f"{where})")


@dataclass
class GridSpec:
    """G hyperparameter points sharing one model shape. Each entry of
    ``points`` maps coefficient/optimizer/stopping axis names (COEFF_AXES +
    OPT_AXES + STOP_AXES) to floats; unspecified axes fall back to the
    model config / train config values.

    ``lane_seeds`` (one int per point) makes per-lane initialization
    composition-independent: lane i's init depends on ``(seed,
    lane_seeds[i])`` only, never on its position in the grid.
    ``fit_deadline_s`` and ``grid_deadline_s`` are validated as in the JAX
    package; the runner does not honour them yet and raises."""

    points: Sequence[dict]
    fit_deadline_s: Any = None   # scalar | per-point sequence | None
    grid_deadline_s: float | None = None
    lane_seeds: Sequence[int] | None = None
    # None inherits RedcliffTrainConfig.precision_mode; "mixed" raises
    precision_mode: str | None = None

    def __post_init__(self):
        if self.precision_mode is not None:
            check_precision_mode(self.precision_mode)
        valid = set(COEFF_AXES) | set(OPT_AXES) | set(STOP_AXES)
        for i, p in enumerate(self.points):
            unknown = set(p) - valid
            if unknown:
                raise ValueError(
                    f"grid point {i} has unknown hyperparameter axes "
                    f"{sorted(unknown)}; valid axes: {sorted(valid)}")
        if self.lane_seeds is not None \
                and len(self.lane_seeds) != len(self.points):
            raise ValueError(
                f"lane_seeds has {len(self.lane_seeds)} entries for "
                f"{len(self.points)} grid points")
        if self.grid_deadline_s is not None and self.grid_deadline_s <= 0:
            raise ValueError("grid_deadline_s must be positive")
        if self.fit_deadline_s is not None:
            lanes = self.lane_deadlines()
            if len(lanes) != len(self.points):
                raise ValueError(
                    f"fit_deadline_s has {len(lanes)} entries for "
                    f"{len(self.points)} grid points")
            if (lanes <= 0).any():
                raise ValueError("fit_deadline_s entries must be positive")

    def lane_deadlines(self):
        """Per-lane wall-clock budgets as a float array ((G,), inf = no
        budget), or None when no per-fit deadline is configured."""
        if self.fit_deadline_s is None:
            return None
        if np.ndim(self.fit_deadline_s) == 0:
            return np.full((len(self.points),), float(self.fit_deadline_s))
        return np.asarray([float(d) for d in self.fit_deadline_s])

    def stacked(self, base_cfg, train_cfg):
        """Every axis as a ``(G,)`` float32 numpy array."""
        out = {}
        for name in COEFF_AXES:
            out[name] = np.asarray(
                [p.get(name, getattr(base_cfg, name)) for p in self.points],
                dtype=np.float32)
        for name in OPT_AXES + STOP_AXES:
            out[name] = np.asarray(
                [p.get(name, getattr(train_cfg, name)) for p in self.points],
                dtype=np.float32)
        return out

    def needs_gc(self, base_cfg):
        return any(p.get("factor_cos_sim_coeff",
                         base_cfg.factor_cos_sim_coeff) > 0
                   for p in self.points)

    def needs_gc_lagged(self, base_cfg):
        return any(p.get("adj_l1_reg_coeff", base_cfg.adj_l1_reg_coeff) > 0
                   for p in self.points)


@dataclass
class GridResult:
    best_params: Any          # numpy tree with leading G axis
    best_criteria: np.ndarray  # (G,)
    best_epoch: np.ndarray     # (G,)
    val_history: np.ndarray    # (epochs, G) validation combo loss
    coeffs: dict
    active: np.ndarray = None  # (G,) bool; False = point early-stopped
    # quarantined grid points, one {"point", "epoch", "cause", "hparams"}
    # record each, cause in {"nonfinite_grad", "nonfinite_val"}:
    # ``nonfinite_grad`` — the lane's numerics guard skipped steps in the
    # failing epoch (max_consecutive_skips in a row, or a non-finite
    # validation loss after skipped steps); ``nonfinite_val`` — validation
    # loss went non-finite with finite steps. Both freeze the lane while
    # the rest of the grid keeps training
    failures: list = field(default_factory=list)
    # the port's additions, as RedcliffFitResult carries them: per epoch run
    # {"epoch", "phases", "ms"} (host wall ms, read after the epoch's early
    # exit check), and the numerics guard's per-lane counters at the end of
    # the fit ({"skipped": [...], ...})
    epochs: list = field(default_factory=list)
    numerics: dict | None = None


def group_configs_by_shape(config_dicts, shape_keys):
    """Partition config dicts into shape-compatible groups (one grid each).
    Returns {shape_tuple: [indices]}: groups in first-appearance order of
    their shape, ascending indices within a group, a missing key grouped
    under None."""
    groups = {}
    for i, cd in enumerate(config_dicts):
        key = tuple(cd.get(k) for k in shape_keys)
        groups.setdefault(key, []).append(i)
    return groups


def _lane_seed(seed, lane_seed):
    """A generator seed from the grid's seed and one lane's own seed."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, int(lane_seed) % 2 ** 64])
    return int(ss.generate_state(1, np.uint64)[0] % 2 ** 63)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _lanes(x, like):
    """A ``(G,)`` per-lane tensor shaped to broadcast against ``like``."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def _where(mask, new, old):
    """Per-lane select over two trees: ``new`` where ``mask``."""
    return tree_map(lambda a, b: torch.where(_lanes(mask, a), a, b), new, old)


def _clone(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


class RedcliffGridRunner:
    """Trains G REDCLIFF-S configurations at once (see the module
    docstring)."""

    def __init__(self, model, train_config, spec: GridSpec, mesh=None,
                 policy=None, device=None):
        if mesh is not None:
            _not_ported("a device mesh for the grid", "item 15, multi-GPU")
        if policy is not None:
            _not_ported("grid scheduling policies (bucket ladder, "
                        "compaction, deadline eviction)", "item 9")
        if spec.fit_deadline_s is not None \
                or spec.grid_deadline_s is not None:
            _not_ported("lane and grid deadlines", "item 9")
        if spec.precision_mode is not None:
            check_precision_mode(spec.precision_mode)
        if len(spec.points) == 0:
            raise ValueError("a grid needs at least one point")
        self.model = model
        self.tc = train_config
        self.spec = spec
        self.device = resolve_device(device)
        self._g_real = len(spec.points)
        tc, cfg = train_config, model.config
        self.result_coeffs = spec.stacked(cfg, tc)
        self.coeffs = {k: torch.from_numpy(v).to(self.device)
                       for k, v in self.result_coeffs.items()}
        self._loss_coeffs = {k: self.coeffs[k] for k in COEFF_AXES}
        # Adam's learning rates as torch.optim.Adam holds them (Python
        # floats): the step size lr / (1 - beta1**step) is rounded once
        self._lr64 = {name: torch.tensor(
            [float(p.get(name, getattr(tc, name))) for p in spec.points],
            dtype=torch.float64, device=self.device)
            for name in ("embed_lr", "gen_lr")}
        self._need_gc = spec.needs_gc(cfg)
        self._need_gc_lagged = spec.needs_gc_lagged(cfg)
        self._guard = tc.numerics is not None and tc.numerics.enabled
        self._numerics_k = (tc.numerics.max_consecutive_skips
                            if self._guard else 0)
        self._prox_pen = tc.prox_penalty
        # the per-lane GL thresholds, a float32 product on the device as
        # the JAX grid forms lr * lam under vmap
        self._prox_t = (lane_thresholds(self.coeffs["gen_lr"], tc.prox_lam)
                        if self._prox_pen is not None else None)
        mode = cfg.training_mode
        self._freeze = "Freeze" in mode
        self._freeze_by_batch = "FreezeByBatch" in mode
        self._build()

    # ------------------------------------------------------------------ init
    def _adam_state(self, tree):
        return {"step": torch.zeros((self._g_real,), dtype=torch.int64,
                                    device=self.device),
                "exp_avg": tree_map(torch.zeros_like, tree),
                "exp_avg_sq": tree_map(torch.zeros_like, tree)}

    def _opt_states(self, params):
        """Per-lane Adam state over a stacked params tree: ``(embedder
        Adam, factor Adam)``, each ``{"step": (G,), "exp_avg": tree,
        "exp_avg_sq": tree}``."""
        return (self._adam_state(params["embedder"]),
                self._adam_state(params["factors"]))

    def init_grid(self, seed=0):
        """G independently drawn parameter sets stacked on axis 0, with
        fresh Adam states. With ``spec.lane_seeds`` lane i draws from a
        generator seeded by ``(seed, lane_seeds[i])`` only, so a point
        inits identically whatever grid it is in; without them, from the
        i-th child of ``seed`` (position-dependent, as JAX's
        ``split(key, G)``)."""
        G = self._g_real
        if self.spec.lane_seeds is not None:
            seeds = [_lane_seed(seed, s) for s in self.spec.lane_seeds]
        else:
            seeds = [int(c.generate_state(1, np.uint64)[0] % 2 ** 63)
                     for c in np.random.SeedSequence(int(seed)).spawn(G)]
        params = _stack([self.model.init(torch.Generator().manual_seed(s),
                                         self.device) for s in seeds])
        return (params,) + self._opt_states(params)

    def init_grid_from(self, point_params):
        """Replicate ONE parameter set (numpy or torch tree) across the
        grid axis — the SLURM-array pattern's initialization, where every
        per-point process seeds identically."""
        G = self._g_real

        def rep(x):
            t = x.detach() if isinstance(x, torch.Tensor) \
                else torch.from_numpy(np.array(x))
            t = t.to(self.device)
            return torch.stack([t] * G)
        params = tree_map(rep, point_params)
        return (params,) + self._opt_states(params)

    # ----------------------------------------------------------------- build
    def _build(self):
        model = self.model
        cfg = model.config
        need_gc, need_gc_lagged = self._need_gc, self._need_gc_lagged

        def make_grad(phase):
            def loss_fn(params, coeffs, X, Y):
                return model.loss_for_phase(
                    params, X, Y, phase, coeffs=coeffs, need_gc=need_gc,
                    need_gc_lagged=need_gc_lagged)
            return torch.func.vmap(
                torch.func.grad_and_value(loss_fn, has_aux=True),
                in_dims=(0, 0, None, None))

        self._grads = {phase: make_grad(phase) for phase in (
            "embedder_pretrain", "factor_pretrain", "combined",
            "post_train")}

        def point_val(params, coeffs, X, Y):
            combo, parts = model.loss_for_phase(
                params, X, Y, "combined", coeffs=coeffs, need_gc=need_gc,
                need_gc_lagged=need_gc_lagged)
            # coefficient-normalized stopping-criteria terms (the
            # reference divides each val part by its loss coefficient)
            fc, fsc = coeffs["forecast_coeff"], coeffs["factor_score_coeff"]
            fo = parts["forecasting_loss"] / torch.where(
                fc > 0, fc, torch.ones_like(fc))
            fa = parts["factor_loss"] / torch.where(
                fsc > 0, fsc, torch.ones_like(fsc))
            return combo, fo, fa

        self._val = torch.func.vmap(point_val, in_dims=(0, 0, None, None))

        # supervised pairwise-cosine stopping term: mean cosine between
        # max-normalized lag-summed supervised GC estimates on the first
        # validation batch
        S = cfg.num_supervised_factors

        def point_cos(params, X):
            est = model.gc(params, cfg.primary_gc_est_mode, X=X,
                           threshold=False, ignore_lag=True)[..., 0]
            s_eff = min(S, est.shape[1])
            if s_eff < 2:
                return torch.zeros((), dtype=est.dtype, device=est.device)
            sup = est[:, :s_eff]
            m = torch.amax(sup, dim=(-2, -1), keepdim=True)
            # positive-max guard: all-non-positive estimates pass through
            sup = sup / torch.where(m > 0, m, torch.ones_like(m))
            flat = sup.reshape(sup.shape[0], s_eff, -1)
            norms = torch.clamp_min(torch.linalg.norm(flat, dim=-1), 1e-8)
            sims = (torch.einsum("nik,njk->nij", flat, flat)
                    / (norms[:, :, None] * norms[:, None, :]))
            iu = torch.triu_indices(s_eff, s_eff, offset=1)
            return torch.mean(sims[:, iu[0], iu[1]])

        self._cos = (torch.func.vmap(point_cos, in_dims=(0, None))
                     if S > 1 else None)

    # ------------------------------------------------------------------ step
    def _adam_(self, params, grads, state, lr64, wd, eps, gate):
        """One gated Adam step over the stacked leaves of ``params``, in
        place, with torch.optim.Adam's arithmetic per lane. Lanes outside
        ``gate`` keep their params, moments and step count."""
        step = state["step"] + 1
        bc1 = 1.0 - torch.pow(_BETA1, step.double())
        bc2 = 1.0 - torch.pow(_BETA2, step.double())
        step_size = (lr64 / bc1).float()
        bc2_sqrt = torch.sqrt(bc2).float()

        def update(p, g, m, v):
            g = g + _lanes(wd, p) * p
            m_new = torch.lerp(m, g, 1 - _BETA1)
            v_new = (v * _BETA2).addcmul_(g, g, value=1 - _BETA2)
            denom = torch.sqrt(v_new) / _lanes(bc2_sqrt, p) + eps
            p_new = p - (_lanes(step_size, p) * m_new) / denom
            keep = _lanes(gate, p)
            p.copy_(torch.where(keep, p_new, p))
            m.copy_(torch.where(keep, m_new, m))
            v.copy_(torch.where(keep, v_new, v))

        tree_map(update, params, grads, state["exp_avg"],
                 state["exp_avg_sq"])
        state["step"] = torch.where(gate, step, state["step"])

    def _step(self, phase, params, optA, optB, nstate, active, X, Y):
        """One guarded, lane-gated step of ``phase`` for every lane, in
        place on ``params`` and the Adam states. Returns the new numerics
        state and the per-lane loss."""
        c = self.coeffs
        grads, (combo, _) = self._grads[phase](params, self._loss_coeffs, X,
                                               Y)
        combo = combo.detach()
        if self._guard:
            gnorm = numerics.lane_global_norm(grads)
            ok = torch.isfinite(combo) & torch.isfinite(gnorm)
            nstate = numerics.update_numerics_state(nstate, ok, gnorm,
                                                    count=active)
            gate = active & ok
        else:
            gate = active
        tc = self.tc
        with torch.no_grad():
            if phase in ("embedder_pretrain", "combined"):
                self._adam_(params["embedder"], grads["embedder"], optA,
                            self._lr64["embed_lr"], c["embed_weight_decay"],
                            tc.embed_eps, gate)
            if phase in ("factor_pretrain", "post_train", "combined"):
                self._adam_(params["factors"], grads["factors"], optB,
                            self._lr64["gen_lr"], c["gen_weight_decay"],
                            tc.gen_eps, gate)
                if self._prox_pen is not None:
                    # GISTA prox after the factor step; the gate leaves
                    # frozen/guarded lanes untouched (a prox of an
                    # unchanged iterate would still shrink it)
                    self.model.apply_prox_lanes_(params, self._prox_t, gate,
                                                 self._prox_pen)
        return nstate, combo

    def _select_best(self, best_params, best_crit, best_epoch, params, crit,
                     epoch):
        better = crit < best_crit
        return (_where(better, params, best_params),
                torch.where(better, crit, best_crit),
                torch.where(better, torch.full_like(best_epoch, epoch),
                            best_epoch))

    def phase_for_epoch(self, epoch):
        return phase_schedule(self.model.config, epoch)

    def _batches(self, ds, rng=None):
        """(X, Y) tensors on the runner's device: gathered from the
        dataset's device-resident copy when it has one, else prefetched."""
        bs = self.tc.batch_size
        if getattr(ds, "supports_device_batches", False):
            return ds.batches(bs, rng=rng, device=self.device)

        def put(x):
            return torch.as_tensor(x).to(self.device)
        return pipeline.prefetch_batches(ds.batches(bs, rng=rng),
                                         depth=self.tc.prefetch_batches,
                                         put=put)

    def _align_all_points(self, params, train_ds):
        """Per-lane Hungarian alignment of factors to supervised labels at
        the pretrain->train transition: one vmapped forward gives every
        lane's first factor weightings, each lane's permutation is solved
        on the host and applied as a per-lane gather along the factor
        axis (in place)."""
        cfg = self.model.config
        tc = self.tc
        fw = torch.func.vmap(lambda p, X: self.model.forward(p, X)[2][0],
                             in_dims=(0, None))
        preds, labels = [], []
        with torch.no_grad():
            for b, (X, Y) in enumerate(self._batches(train_ds)):
                if b >= tc.max_factor_prior_batches:
                    break
                preds.append(fw(params, X[:, : cfg.max_lag, :]).cpu()
                             .numpy())
                Y = Y.cpu().numpy()
                if Y.ndim == 3:
                    col = cfg.max_lag if Y.shape[2] > cfg.max_lag else 0
                    labels.append(Y[:, :, col])
                else:
                    labels.append(Y)
        preds = np.concatenate(preds, axis=1)  # (G, N, K)
        lab = np.vstack(labels)
        K = cfg.num_factors
        orders = np.stack([np.asarray(factor_alignment_order(
            preds[g], lab, K,
            unsupervised_start_index=tc.unsupervised_start_index))
            for g in range(preds.shape[0])])
        idx = torch.as_tensor(orders, dtype=torch.long, device=self.device)
        with torch.no_grad():
            for leaf in tree_leaves(params["factors"]):
                ix = idx.reshape(idx.shape + (1,) * (leaf.dim() - 2))
                leaf.copy_(torch.gather(leaf, 1, ix.expand(leaf.shape)))
        return params

    # ------------------------------------------------------------------- fit
    def fit(self, key=None, train_ds=None, val_ds=None, max_iter=None,
            log_dir=None, init_params=None, copy_init=True,
            checkpoint_dir=None, checkpoint_every=None, true_gc=None,
            on_lane_retire=None) -> GridResult:
        """Fit every lane; returns a :class:`GridResult` indexed by point.

        ``key``: the int seed of :meth:`init_grid` (the JAX package takes
        a PRNG key; ``None`` means ``train_config.seed``), unused when
        ``init_params`` (a stacked ``(params, embedder Adam, factor
        Adam)`` tuple from :meth:`init_grid`, :meth:`init_grid_from` or
        ``interop.grid_state_from_jax``) is given; that state is copied
        unless ``copy_init=False`` hands it over (the fit updates it in
        place). ``log_dir``, ``checkpoint_dir``/``checkpoint_every``,
        ``true_gc`` and ``on_lane_retire`` are not ported yet and raise."""
        if log_dir is not None or true_gc is not None:
            _not_ported("grid telemetry (metrics log, quality monitor)",
                        "item 11")
        if checkpoint_dir is not None or checkpoint_every is not None:
            _not_ported("grid checkpoint and resume", "item 9")
        if on_lane_retire is not None:
            _not_ported("on_lane_retire (lane retirement by compaction)",
                        "item 9")
        if train_ds is None or val_ds is None:
            raise TypeError("fit needs train_ds and val_ds")
        tc = self.tc
        if init_params is not None:
            def own(x):
                x = torch.as_tensor(x).to(self.device)
                return x.detach().clone() if copy_init else x
            params, optA, optB = tree_map(own, tuple(init_params))
        else:
            params, optA, optB = self.init_grid(
                tc.seed if key is None else key)
        return self._fit(params, optA, optB, train_ds, val_ds,
                         tc.max_iter if max_iter is None else max_iter)

    def _fit(self, params, optA, optB, train_ds, val_ds, max_iter):
        tc = self.tc
        cfg = self.model.config
        dev = self.device
        G = self._g_real
        rng = np.random.default_rng(tc.seed)
        stop_after = tc.lookback * tc.check_every
        c = self.coeffs
        best_crit = torch.full((G,), float("inf"), device=dev)
        best_epoch = torch.zeros((G,), dtype=torch.int32, device=dev)
        best_params = _clone(params)
        accepted = _clone(params) if self._freeze else None
        active = torch.ones((G,), dtype=torch.bool, device=dev)
        failed_epoch = torch.full((G,), -1, dtype=torch.int32, device=dev)
        failed_cause = torch.zeros((G,), dtype=torch.int32, device=dev)
        nstate = numerics.init_numerics_state(lanes=G, device=dev)
        val_history = []
        aligned = False
        past_at = cfg.num_pretrain_epochs + cfg.num_acclimation_epochs
        # the cosine window: the first validation batch's slice, once
        cos_Xw = None
        if self._cos is not None:
            first = next(iter(self._batches(val_ds)), None)
            if first is not None:
                cos_Xw = first[0][: tc.max_samples_for_gc_tracking,
                                  : cfg.max_lag, :]
        epochs = []
        for it in range(max_iter):
            t_epoch0 = time.perf_counter()
            if (not aligned and "pretrain_factor" in cfg.training_mode
                    and it == cfg.num_pretrain_epochs
                    and cfg.num_supervised_factors > 0):
                params = self._align_all_points(params, train_ds)
                aligned = True
            phases = self.phase_for_epoch(it)
            # per-epoch skip baseline for quarantine-cause attribution
            epoch_skip_base = nstate["skipped"].clone()
            for X, Y in self._batches(train_ds, rng=rng):
                for phase in phases:
                    nstate, _ = self._step(phase, params, optA, optB, nstate,
                                           active, X, Y)
                if self._freeze_by_batch:
                    params, accepted = self._freeze_step(params, accepted)
            # validation: ordered per-batch sums from zero
            combo_sum = torch.zeros((G,), device=dev)
            forecast_sum = torch.zeros((G,), device=dev)
            factor_sum = torch.zeros((G,), device=dev)
            n = 0
            with torch.no_grad():
                for X, Y in self._batches(val_ds):
                    combo, fo, fa = self._val(params, self._loss_coeffs, X, Y)
                    combo_sum = combo_sum + combo
                    forecast_sum = forecast_sum + fo
                    factor_sum = factor_sum + fa
                    n += 1
            if n == 0:
                raise ValueError(
                    "validation dataset yielded no batches — increase "
                    "val_fraction or dataset size")
            val_now = combo_sum / n
            val_history.append(val_now)
            # quarantine: a non-finite validation loss, or a guard streak of
            # max_consecutive_skips; the cause is nonfinite_grad when this
            # epoch skipped steps, else nonfinite_val
            bad = ~torch.isfinite(val_now)
            if self._guard:
                bad = bad | (nstate["consecutive"] >= self._numerics_k)
                grad_implicated = (nstate["skipped"] - epoch_skip_base) > 0
            else:
                grad_implicated = torch.zeros_like(active)
            newly_failed = active & bad
            failed_epoch = torch.where(newly_failed,
                                       torch.full_like(failed_epoch, it),
                                       failed_epoch)
            failed_cause = torch.where(
                newly_failed,
                torch.where(grad_implicated,
                            torch.full_like(failed_cause,
                                            numerics.CAUSE_NONFINITE_GRAD),
                            torch.full_like(failed_cause,
                                            numerics.CAUSE_NONFINITE_VAL)),
                failed_cause)
            active = active & ~bad
            if it >= past_at:
                # per-point stopping criteria: stopping coefficients x
                # coefficient-normalized val means, plus the supervised
                # pairwise-cosine term
                crit = c["stopping_criteria_forecast_coeff"] \
                    * (forecast_sum / n)
                if cfg.num_supervised_factors >= 1:
                    crit = crit + c["stopping_criteria_factor_coeff"] \
                        * (factor_sum / n)
                if self._cos is not None:
                    with torch.no_grad():
                        crit = crit + c["stopping_criteria_cosSim_coeff"] \
                            * self._cos(params, cos_Xw)
                if self._freeze:
                    if not self._freeze_by_batch:
                        params, accepted = self._freeze_step(params, accepted)
                    _, best_crit, best_epoch = self._select_best(
                        best_params, best_crit, best_epoch, params, crit, it)
                    best_params = _clone(accepted)
                else:
                    best_params, best_crit, best_epoch = self._select_best(
                        best_params, best_crit, best_epoch, params, crit, it)
                # lookback early stop: no improvement for
                # lookback*check_every epochs freezes the lane
                active = active & ((it - best_epoch) < stop_after)
            else:
                # pretrain/acclimation epochs track the live params as best
                # for healthy lanes; a quarantined lane keeps its last
                # finite snapshot
                best_params = _where(active, params, best_params)
                best_epoch = torch.where(active,
                                         torch.full_like(best_epoch, it),
                                         best_epoch)
            # the one host read of the loop, on the check cadence: the
            # global early exit once every lane has stopped
            stop = (it % tc.check_every == 0 and it >= past_at
                    and not bool(active.any()))
            epochs.append({"epoch": it, "phases": list(phases),
                           "ms": (time.perf_counter() - t_epoch0) * 1e3})
            if stop:
                break

        final_failed = failed_epoch.cpu().numpy()
        final_cause = failed_cause.cpu().numpy()
        failures = [{"point": int(g), "epoch": int(e),
                     "cause": numerics.QUARANTINE_CAUSES.get(
                         int(cc), "nonfinite_val"),
                     "hparams": dict(self.spec.points[g])}
                    for g, (e, cc) in enumerate(zip(final_failed,
                                                    final_cause))
                    if e >= 0]
        history = (torch.stack(val_history).cpu().numpy() if val_history
                   else np.zeros((0, G), np.float32))
        return GridResult(
            best_params=params_to_jax(best_params),
            best_criteria=best_crit.cpu().numpy(),
            best_epoch=best_epoch.cpu().numpy(),
            val_history=history,
            coeffs=dict(self.result_coeffs),
            active=active.cpu().numpy(),
            failures=failures, epochs=epochs,
            numerics={k: v.cpu().tolist() for k, v in nstate.items()})

    def _freeze_step(self, params, accepted):
        """One Freeze accept/revert round over every lane: the merged
        candidates go back into the live params (in place); returns
        ``(params, new accepted)``."""
        with torch.no_grad():
            candidate, accepted = apply_freeze_lanes(
                self.model, self.model.config.training_mode, params,
                accepted)
            tree_map(lambda dst, src: dst.copy_(src), params, candidate)
        return params, accepted
