"""DYNOTEARS — dynamic-Bayesian-network structure learning (the port's copy
of ``redcliff_tpu/models/dynotears.py``; numpy/scipy on the host).

* solver: augmented-Lagrangian dual ascent over (W, A) with the NOTEARS
  acyclicity penalty h(W) = tr(exp(W∘W)) − d and scipy L-BFGS-B inner
  solves on the non-negative (plus, minus) split parameterization (the
  reference's vendored causalnex solver);
* :class:`DynotearsModel` (``DYNOTEARS_Stochastic``): per-sample refits over
  minibatch streams with warm-started (wa, ρ, α, h) state, early-stopped on
  the mean validation objective;
* :class:`DynotearsVanillaModel` (``DYNOTEARS_Vanilla``): one-shot fit that
  averages per-sample lagged matrices.

This family does no device work in either package: a small-matrix solver
(d ≤ tens) belongs on the host. It runs on the host whatever ``device`` the
array-task driver passes. The code is the JAX package's, line for line, so
both packages fit the same graphs bit for bit and read each other's
artifacts.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import scipy.linalg as slin
import scipy.optimize as sopt

from redcliff_tpu_torch.runtime.checkpoint import write_checkpoint

__all__ = [
    "reshape_wa", "dynotears_h_constraint", "dynotears_objective",
    "dynotears_solve", "DynotearsState", "DynotearsModel",
    "DynotearsVanillaModel",
]


def reshape_wa(wa_vec, d_vars, p_orders):
    """(plus, minus)-split vector → (W [d,d], A [p·d, d]).

    Layout matches the reference's `_reshape_wa` (ref causalnex_dynotears.py:301):
    first 2·d² entries are W⁺ rows then W⁻ rows; the rest alternates per lag
    block A⁺ / A⁻.
    """
    wa = np.asarray(wa_vec).reshape(2 * (p_orders + 1) * d_vars, d_vars)
    w_mat = wa[:d_vars] - wa[d_vars : 2 * d_vars]
    rest = wa[2 * d_vars :].reshape(2 * p_orders, d_vars * d_vars)
    a_mat = (rest[0::2] - rest[1::2]).reshape(p_orders * d_vars, d_vars)
    return w_mat, a_mat


def dynotears_h_constraint(wa_vec, d_vars, p_orders):
    """NOTEARS acyclicity value of the intra-slice W: tr(exp(W∘W)) − d."""
    w_mat, _ = reshape_wa(wa_vec, d_vars, p_orders)
    return float(np.trace(slin.expm(w_mat * w_mat)) - d_vars)


def dynotears_objective(X, Xlags, wa_vec, rho, alpha, d_vars, p_orders,
                        lambda_a, lambda_w, n):
    """Penalized least-squares score (ref causalnex_dynotears.py:527-552):
    ½/n‖X(I−W) − Xlags·A‖² + ½ρh² + αh + λ‖·‖₁ (the L1 is the plain sum of the
    non-negative split vector)."""
    w_mat, a_mat = reshape_wa(wa_vec, d_vars, p_orders)
    resid = X @ (np.eye(d_vars) - w_mat) - Xlags @ a_mat
    loss = 0.5 / n * float(np.sum(resid * resid))
    h = dynotears_h_constraint(wa_vec, d_vars, p_orders)
    wa_vec = np.asarray(wa_vec)
    l1 = lambda_w * wa_vec[: 2 * d_vars**2].sum() + \
        lambda_a * wa_vec[2 * d_vars**2 :].sum()
    return loss + 0.5 * rho * h * h + alpha * h + l1


def _grad_split(M_w, M_a, lambda_w, lambda_a, d_vars, p_orders):
    """Map gradients w.r.t. (W, A) onto the (plus, minus) split layout:
    ∂/∂plus = g + λ, ∂/∂minus = −g + λ."""
    gw = np.concatenate([M_w, -M_w], axis=0).ravel() + lambda_w
    ga = M_a.reshape(p_orders, d_vars * d_vars)
    ga = np.hstack([ga, -ga]).ravel() + lambda_a
    return np.concatenate([gw, ga])


@dataclass
class DynotearsState:
    """Warm-startable solver state threaded across minibatch refits
    (the reference passed these through `from_numpy_dynamic` keyword args)."""
    wa_est: Optional[np.ndarray] = None
    rho: float = 1.0
    alpha: float = 0.0
    h_value: float = np.inf
    h_new: float = np.inf
    wa_new: Optional[np.ndarray] = None


@dataclass
class DynotearsResult:
    w_mat: np.ndarray
    a_mat: np.ndarray
    state: DynotearsState
    n: int
    d_vars: int
    p_orders: int


def _bounds(d_vars, p_orders, tabu_edges, tabu_parent_nodes, tabu_child_nodes):
    """Box constraints: all split entries ≥ 0; banned entries pinned to 0
    (self-loops in W always; tabu edges/parents/children per lag)."""
    tabu_edges = set(tabu_edges or [])
    parents = set(tabu_parent_nodes or [])
    children = set(tabu_child_nodes or [])

    def banned(lag, i, j):
        return (lag == 0 and i == j) or (lag, i, j) in tabu_edges \
            or i in parents or j in children

    bnds = [(0, 0) if banned(0, i, j) else (0, None)
            for i in range(d_vars) for j in range(d_vars)] * 2
    for k in range(1, p_orders + 1):
        bnds.extend([(0, 0) if banned(k, i, j) else (0, None)
                     for i in range(d_vars) for j in range(d_vars)] * 2)
    return bnds


def dynotears_solve(X, Xlags, lambda_w=0.1, lambda_a=0.1, max_iter=100,
                    h_tol=1e-8, w_threshold=0.0, tabu_edges=None,
                    tabu_parent_nodes=None, tabu_child_nodes=None,
                    grad_step=1.0, state: Optional[DynotearsState] = None):
    """Augmented-Lagrangian DYNOTEARS fit of one (X, Xlags) pair.

    Equivalent of ref `from_numpy_dynamic`/`_learn_dynamic_structure`
    (causalnex_dynotears.py:162-510): inner L-BFGS-B solves over the
    non-negative split vector, ρ×10 escalation while h fails to shrink 4×,
    dual update α += ρh, exit at h ≤ h_tol. ``state`` warm-starts
    (wa, ρ, α, h) exactly like the reference's threaded keyword args.
    """
    X = np.asarray(X, dtype=np.float64)
    Xlags = np.asarray(Xlags, dtype=np.float64)
    if X.size == 0 or Xlags.size == 0:
        raise ValueError("input data must be non-empty")
    if X.shape[0] != Xlags.shape[0]:
        raise ValueError("X and Xlags must have the same number of rows")
    if Xlags.shape[1] % X.shape[1] != 0:
        raise ValueError("Xlags columns must be a multiple of X columns")
    n, d_vars = X.shape
    p_orders = Xlags.shape[1] // d_vars
    bnds = _bounds(d_vars, p_orders, tabu_edges, tabu_parent_nodes,
                   tabu_child_nodes)

    st = state or DynotearsState()
    wa_est = (np.zeros(2 * (p_orders + 1) * d_vars**2)
              if st.wa_est is None else np.array(st.wa_est, dtype=np.float64))
    # the reference resets h_new to a copy of h_value on every call that
    # threads warm-start state (causalnex_dynotears.py:478-492)
    rho, alpha = st.rho, st.alpha
    h_value = st.h_value
    h_new = h_value
    # pre-seeded so a trivially-satisfied inner loop (h_value == 0) still has
    # an iterate to adopt (ref inits wa_new to zeros / a copy of wa_est)
    wa_new = (np.zeros_like(wa_est) if st.wa_new is None else wa_est.copy())

    eye = np.eye(d_vars)
    XtX = X.T @ X
    XltX = Xlags.T @ X
    XtXl = X.T @ Xlags
    XltXl = Xlags.T @ Xlags

    def func(wa_vec):
        return dynotears_objective(X, Xlags, wa_vec, rho, alpha, d_vars,
                                   p_orders, lambda_a, lambda_w, n)

    def grad(wa_vec):
        w_mat, a_mat = reshape_wa(wa_vec, d_vars, p_orders)
        e_mat = slin.expm(w_mat * w_mat)
        # ∂W of ½/n‖X(I−W) − Xl·A‖² = −1/n·Xᵀ(X(I−W) − Xl·A); likewise for A
        loss_grad_w = -1.0 / n * (XtX @ (eye - w_mat) - XtXl @ a_mat)
        obj_grad_w = loss_grad_w + \
            (rho * (np.trace(e_mat) - d_vars) + alpha) * e_mat.T * w_mat * 2
        loss_grad_a = -1.0 / n * (XltX @ (eye - w_mat) - XltXl @ a_mat)
        return grad_step * _grad_split(obj_grad_w, loss_grad_a, lambda_w,
                                       lambda_a, d_vars, p_orders)

    for n_iter in range(max_iter):
        while rho < 1e20 and (h_new > 0.25 * h_value or h_new == np.inf):
            res = sopt.minimize(func, wa_est, method="L-BFGS-B", jac=grad,
                                bounds=bnds)
            wa_new = res.x
            h_new = dynotears_h_constraint(wa_new, d_vars, p_orders)
            if h_new > 0.25 * h_value:
                rho *= 10
        wa_est = wa_new
        h_value = h_new
        alpha += rho * h_value
        if h_value <= h_tol:
            break

    w_mat, a_mat = reshape_wa(wa_est, d_vars, p_orders)
    w_mat = np.where(np.abs(w_mat) < w_threshold, 0.0, w_mat)
    a_mat = np.where(np.abs(a_mat) < w_threshold, 0.0, a_mat)
    out_state = DynotearsState(wa_est=wa_est, rho=rho, alpha=alpha,
                               h_value=h_value, h_new=h_new, wa_new=wa_new)
    return DynotearsResult(w_mat=w_mat, a_mat=a_mat, state=out_state,
                           n=n, d_vars=d_vars, p_orders=p_orders)


# --------------------------------------------------------------- model wrappers

@dataclass
class DynotearsConfig:
    """Shared hyperparameters of both wrappers (ref models/dynotears.py:15-35,
    dynotears_vanilla.py:15-25)."""
    lambda_w: float = 0.1
    lambda_a: float = 0.1
    max_iter: int = 100
    h_tol: float = 1e-8
    w_threshold: float = 0.0
    grad_step: float = 1.0
    lag_size: int = 1
    tabu_edges: Optional[list] = None
    tabu_parent_nodes: Optional[list] = None
    tabu_child_nodes: Optional[list] = None
    # which pieces of solver state are carried across per-sample refits
    # (ref models/dynotears.py fit() reuse_* flags; wa_est always carries)
    reuse_rho: bool = False
    reuse_alpha: bool = False
    reuse_h_val: bool = False
    reuse_h_new: bool = False
    reuse_wa_new: bool = False


def _split_windows(X, lag_size):
    """One recording (T, C) → the reference's (X_in, Xlags) pair: the first
    T−lag rows regressed against the rows lag steps later
    (ref models/dynotears.py:85-87 — note the reference feeds the *later*
    values as the 'lagged' design; kept as-is for parity)."""
    return X[: -lag_size], X[lag_size:]


class DynotearsModel:
    """Stochastic DYNOTEARS: per-sample warm-started refits over minibatch
    epochs with early stopping on mean validation objective
    (ref models/dynotears.py:14-168)."""

    def __init__(self, config: DynotearsConfig = None, **kw):
        self.config = config or DynotearsConfig(**kw)
        self.state = DynotearsState()
        self.d_vars = None
        self.p_orders = None
        self.n = None

    # -- GC readout: the lagged weight matrix (ref models/dynotears.py:37-42)
    def gc(self):
        assert self.d_vars is not None, "fit the model before reading GC"
        _, a_mat = reshape_wa(self.state.wa_est, self.d_vars, self.p_orders)
        return a_mat

    GC = gc

    def _fit_one(self, x_in, x_lag):
        cfg = self.config
        res = dynotears_solve(
            x_in, x_lag, lambda_w=cfg.lambda_w, lambda_a=cfg.lambda_a,
            max_iter=cfg.max_iter, h_tol=cfg.h_tol,
            w_threshold=cfg.w_threshold, tabu_edges=cfg.tabu_edges,
            tabu_parent_nodes=cfg.tabu_parent_nodes,
            tabu_child_nodes=cfg.tabu_child_nodes, grad_step=cfg.grad_step,
            state=self.state)
        self.d_vars, self.p_orders, self.n = res.d_vars, res.p_orders, res.n
        new = DynotearsState(wa_est=res.state.wa_est,
                             rho=res.state.rho if cfg.reuse_rho else self.state.rho,
                             alpha=res.state.alpha if cfg.reuse_alpha else self.state.alpha,
                             h_value=res.state.h_value if cfg.reuse_h_val else self.state.h_value,
                             h_new=res.state.h_new if cfg.reuse_h_new else self.state.h_new,
                             wa_new=res.state.wa_new if cfg.reuse_wa_new else self.state.wa_new)
        self.state = new

    def _mean_objective(self, ds, batch_size):
        cfg = self.config
        total, count = 0.0, 0
        for X, _ in ds.batches(batch_size):
            for b in range(X.shape[0]):
                x_in, x_lag = _split_windows(np.asarray(X[b], np.float64),
                                             cfg.lag_size)
                total += dynotears_objective(
                    x_in, x_lag, self.state.wa_est, self.state.rho,
                    self.state.alpha, self.d_vars, self.p_orders,
                    cfg.lambda_a, cfg.lambda_w, self.n)
                count += 1
        return total / max(count, 1)

    def save_checkpoint(self, save_dir, it, val_history, best_loss, best_it,
                        state=None, shape=None):
        """Persist the best-so-far solver state (the reference checkpoints its
        best_model deepcopy, not the current iterate)."""
        os.makedirs(save_dir, exist_ok=True)
        state = state if state is not None else self.state
        d_vars, p_orders, n = shape or (self.d_vars, self.p_orders, self.n)
        # durable checkpoint writes (atomic + CRC + .prev), like the trainers
        write_checkpoint(os.path.join(save_dir, "final_best_model.bin"),
                         {"model_class": type(self).__name__,
                          "config": self.config, "state": state,
                          "d_vars": d_vars, "p_orders": p_orders,
                          "n": n})
        write_checkpoint(
            os.path.join(save_dir,
                         "training_meta_data_and_hyper_parameters.pkl"),
            {"epoch": it, "val_avg_loss_history": val_history,
             "best_loss": best_loss, "best_it": best_it})

    def fit(self, train_ds, val_ds, save_dir=None, max_data_iter=10,
            batch_size=32, num_iters_prior_to_stop=10, check_every=5,
            verbose=False):
        """Epochs of per-sample refits; early stop when the mean validation
        objective has not improved for ``num_iters_prior_to_stop`` epochs."""
        cfg = self.config
        val_history = []
        best_loss, best_it, best_state = np.inf, None, None
        best_shape = None
        for it in range(max_data_iter):
            for X, _ in train_ds.batches(batch_size):
                for b in range(X.shape[0]):
                    x_in, x_lag = _split_windows(np.asarray(X[b], np.float64),
                                                 cfg.lag_size)
                    self._fit_one(x_in, x_lag)
            cur = self._mean_objective(val_ds, batch_size)
            val_history.append(cur)
            if verbose:
                print(f"DynotearsModel.fit: epoch {it} val={cur:.6f}",
                      flush=True)
            if cur < best_loss:
                best_loss, best_it = cur, it
                best_state = DynotearsState(**vars(self.state))
                best_shape = (self.d_vars, self.p_orders, self.n)
            elif best_it is not None and \
                    (it - best_it) == num_iters_prior_to_stop:
                break
            elif best_it is None and it + 1 >= num_iters_prior_to_stop:
                # validation objective never became finite (NaN data or a
                # diverged fit): stop instead of crashing on best_it - None
                break
            if save_dir is not None and it % check_every == 0:
                self.save_checkpoint(save_dir, it, val_history, best_loss,
                                     best_it, state=best_state,
                                     shape=best_shape)
        if best_state is not None:
            self.state = best_state
            self.d_vars, self.p_orders, self.n = best_shape
        if save_dir is not None:
            self.save_checkpoint(save_dir, len(val_history) - 1, val_history,
                                 best_loss, best_it)
        return best_loss, val_history


class DynotearsVanillaModel:
    """One-shot DYNOTEARS: independent cold-start fits per sample, summed
    lagged matrices scaled by 1/num_nodes (ref models/dynotears_vanilla.py:40-71
    — the reference divides by the node count rather than the sample count;
    kept, as it only rescales the scores)."""

    def __init__(self, config: DynotearsConfig = None, **kw):
        self.config = config or DynotearsConfig(**kw)
        self.a_est = None

    def gc(self):
        return self.a_est

    GC = gc

    def fit(self, X_train, save_dir=None, max_samples=None):
        """X_train: (num_samples, T, C) array of recordings."""
        cfg = self.config
        X_train = np.asarray(X_train, dtype=np.float64)
        num_samples, _, num_nodes = X_train.shape
        if max_samples is not None:
            num_samples = min(num_samples, max_samples)
        # _split_windows always yields a single-lag design, so every per-sample
        # a_mat is (num_nodes, num_nodes) regardless of lag_size
        acc = np.zeros((num_nodes, num_nodes))
        for s in range(num_samples):
            x_in, x_lag = _split_windows(X_train[s], cfg.lag_size)
            res = dynotears_solve(
                x_in, x_lag, lambda_w=cfg.lambda_w, lambda_a=cfg.lambda_a,
                max_iter=cfg.max_iter, h_tol=cfg.h_tol,
                w_threshold=cfg.w_threshold, tabu_edges=cfg.tabu_edges,
                tabu_parent_nodes=cfg.tabu_parent_nodes,
                tabu_child_nodes=cfg.tabu_child_nodes, state=None)
            acc = acc + res.a_mat
        self.a_est = acc / (1.0 * num_nodes)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            write_checkpoint(os.path.join(save_dir, "final_best_model.bin"),
                             {"model_class": type(self).__name__,
                              "config": self.config, "a_est": self.a_est})
        return self.a_est
