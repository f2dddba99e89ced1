"""Numerics sentinel: the non-finite step guard and the host-side
divergence policy (port of ``runtime/numerics.py``).

* :func:`guarded_update` applies a step's update only when the loss and
  the global gradient norm are both finite; a poisoned step is skipped —
  params and optimizer state untouched, ``optimizer.step()`` never called
  (Adam would move its moments in place) — and the counters (total and
  consecutive skips, grad-norm running statistics) advance. The JAX
  package decides inside the compiled step with ``lax.cond``; eager
  PyTorch needs the verdict on the host, so the guard makes ONE host read
  per step (the loss and the norm in one transfer).
* The coefficient grid keeps the counters per lane on the device
  (``init_numerics_state(lanes=G)``, ``update_numerics_state(..., count=
  active)``, :func:`lane_global_norm`), as the JAX grid does: its step
  gates each lane with ``torch.where`` and never reads the verdict on the
  host.
* :class:`NumericsPolicy` is the declarative knob set, as in JAX.
* :class:`DivergenceMonitor` snapshots the last known-good state each
  healthy epoch and, on K consecutive skips or a validation-criteria
  blow-up, rolls the fit back to it with every optimizer's learning rate
  (``param_groups[i]["lr"]`` of a ``state_dict``) backed off; with no good
  snapshot or the rollback budget spent it aborts with a recorded cause.

A state tree here is nested dicts/lists/tuples of tensors, numbers and
optimizer ``state_dict`` s. The per-point counters live on the host as
numpy scalars, the grad-norm sums in float32 as the JAX package keeps them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from redcliff_tpu_torch.interop import tree_leaves, tree_map

__all__ = [
    "NumericsPolicy", "NumericsAction", "DivergenceMonitor",
    "init_numerics_state", "update_numerics_state", "guarded_update",
    "global_norm", "lane_global_norm", "numerics_summary",
    "reset_consecutive", "CAUSE_NONFINITE_GRAD", "CAUSE_NONFINITE_VAL",
    "CAUSE_DEADLINE", "QUARANTINE_CAUSES",
    "scale_learning_rate", "current_learning_rates", "to_host", "to_torch",
]


# quarantine cause codes of the grid's per-lane failures (GridResult.failures
# records). The deadline cause belongs to lane deadlines, not yet ported.
CAUSE_NONFINITE_GRAD = 1
CAUSE_NONFINITE_VAL = 2
CAUSE_DEADLINE = 3
QUARANTINE_CAUSES = {CAUSE_NONFINITE_GRAD: "nonfinite_grad",
                     CAUSE_NONFINITE_VAL: "nonfinite_val",
                     CAUSE_DEADLINE: "deadline"}


@dataclass(frozen=True)
class NumericsPolicy:
    """Numerical-fault policy (the JAX package's fields and defaults).
    The proximal step keeps the configured learning rate across backoffs:
    the backoff applies to the gradient step only."""

    enabled: bool = True
    max_consecutive_skips: int = 3
    divergence_factor: float = 10.0
    divergence_atol: float = 1e-2
    lr_backoff: float = 0.5
    max_rollbacks: int = 3
    max_nonfinite_epochs: int = 3


@dataclass(frozen=True)
class NumericsAction:
    """Verdict of :meth:`DivergenceMonitor.check` for one epoch."""

    kind: str          # "ok" | "rollback" | "abort"
    cause: str | None = None


# ---------------------------------------------------------------------------
# the step guard and its counters
# ---------------------------------------------------------------------------
def init_numerics_state(lanes=None, device="cpu"):
    """Fresh sentinel counters: host scalars, or with ``lanes=G`` one
    ``(G,)`` tensor per field on ``device`` (the grid's layout)."""
    if lanes is not None:
        z = lambda: torch.zeros((int(lanes),), dtype=torch.int32,  # noqa
                                device=device)
        f = lambda: torch.zeros((int(lanes),), dtype=torch.float32,  # noqa
                                device=device)
        return {"skipped": z(), "consecutive": z(), "checked": z(),
                "grad_norm_last": f(), "grad_norm_sum": f(),
                "grad_norm_sq_sum": f(), "grad_norm_max": f()}
    z = np.float32(0.0)
    return {"skipped": 0, "consecutive": 0, "checked": 0,
            "grad_norm_last": z, "grad_norm_sum": z,
            "grad_norm_sq_sum": z, "grad_norm_max": z}


def global_norm(tree):
    """Global L2 norm over every tensor of a gradient tree (f32
    accumulate), as a 0-d tensor on the leaves' device. A non-finite leaf
    makes the norm non-finite."""
    leaves = tree_leaves(tree)
    # leaves on several devices (a factor-sharded fit) sum on the first's
    home = leaves[0].device
    total = sum(torch.sum(torch.square(g.float())).to(home) for g in leaves)
    return torch.sqrt(total)


def lane_global_norm(tree):
    """Per-lane global L2 norm of a gradient tree whose leaves carry a
    leading lane axis: ``(G,)`` float32 on the leaves' device."""
    total = sum(torch.sum(torch.square(g.float()).reshape(g.shape[0], -1),
                          dim=1)
                for g in tree_leaves(tree))
    return torch.sqrt(total)


def _update_lanes(state, ok, grad_norm, count):
    """The device half of :func:`update_numerics_state` (the JAX
    package's, op for op): ``ok``, ``grad_norm`` and ``count`` are ``(G,)``
    tensors; lanes outside ``count`` neither count skips nor reset their
    streak, and the norm statistics cover the applied steps only."""
    count = torch.ones_like(ok) if count is None else count.to(torch.bool)
    counted_skip = count & ~ok
    finite_norm = torch.where(torch.isfinite(grad_norm), grad_norm,
                              torch.zeros_like(grad_norm))
    seen = count & ok
    seen_norm = torch.where(seen, finite_norm, torch.zeros_like(finite_norm))
    return {
        "skipped": state["skipped"] + counted_skip.to(torch.int32),
        "consecutive": torch.where(
            count, torch.where(ok, torch.zeros_like(state["consecutive"]),
                               state["consecutive"] + 1),
            state["consecutive"]),
        "checked": state["checked"] + count.to(torch.int32),
        "grad_norm_last": torch.where(count, grad_norm,
                                      state["grad_norm_last"]),
        "grad_norm_sum": state["grad_norm_sum"] + seen_norm,
        "grad_norm_sq_sum": state["grad_norm_sq_sum"]
        + torch.square(seen_norm),
        "grad_norm_max": torch.maximum(state["grad_norm_max"], seen_norm),
    }


def update_numerics_state(state, ok, grad_norm, count=None):
    """Advance the counters for one guarded step. Host counters: ``ok`` a
    bool and ``grad_norm`` the host value of the step's global norm (may
    be inf/NaN). Lane counters (tensors of :func:`init_numerics_state`
    with ``lanes``): ``ok`` and ``grad_norm`` ``(G,)`` tensors and
    ``count`` the lanes that trained this step (the grid's active mask),
    all on the device."""
    if isinstance(ok, torch.Tensor):
        return _update_lanes(state, ok, grad_norm, count)
    gn = np.float32(grad_norm)
    finite = np.float32(gn if math.isfinite(float(gn)) else 0.0)
    seen = np.float32(finite if ok else 0.0)
    return {
        "skipped": state["skipped"] + (0 if ok else 1),
        "consecutive": 0 if ok else state["consecutive"] + 1,
        "checked": state["checked"] + 1,
        "grad_norm_last": gn,
        "grad_norm_sum": np.float32(state["grad_norm_sum"] + seen),
        "grad_norm_sq_sum": np.float32(state["grad_norm_sq_sum"]
                                       + np.square(seen)),
        "grad_norm_max": np.float32(max(state["grad_norm_max"], seen)),
    }


def reset_consecutive(state):
    """Zero the consecutive-skip streak (after a rollback consumed it)."""
    return dict(state, consecutive=0)


def guarded_update(grads, loss, apply_fn, numerics_state):
    """Call ``apply_fn()`` (the step's in-place optimizer/prox update) only
    when ``loss`` and the global norm of ``grads`` are finite. One host
    read per call. Returns ``(new_numerics_state, ok)``."""
    gnorm = global_norm(grads)
    loss_h, gnorm_h = torch.stack(
        [loss.detach().float().reshape(()), gnorm]).tolist()
    ok = math.isfinite(loss_h) and math.isfinite(gnorm_h)
    if ok:
        apply_fn()
    return update_numerics_state(numerics_state, ok, gnorm_h), ok


def numerics_summary(numerics_state):
    """The counters as plain Python numbers (scalars for a trainer's state,
    lists for the grid's per-lane state), with grad-norm mean and std over
    the applied steps."""
    host = {k: np.asarray(v) for k, v in numerics_state.items()}
    checked = np.maximum(host["checked"] - host["skipped"], 1)
    mean = host["grad_norm_sum"] / checked
    var = np.maximum(host["grad_norm_sq_sum"] / checked - mean ** 2, 0.0)

    def py(v):
        v = np.asarray(v)
        return v.item() if v.ndim == 0 else v.tolist()

    return {
        "skipped": py(host["skipped"]),
        "consecutive": py(host["consecutive"]),
        "checked": py(host["checked"]),
        "grad_norm_last": py(host["grad_norm_last"].astype(np.float64)),
        "grad_norm_mean": py(np.asarray(mean).astype(np.float64)),
        "grad_norm_std": py(np.sqrt(var).astype(np.float64)),
        "grad_norm_max": py(host["grad_norm_max"].astype(np.float64)),
    }


# ---------------------------------------------------------------------------
# host half: trees, learning-rate backoff, rollback/abort policy
# ---------------------------------------------------------------------------
def to_host(tree):
    """Every tensor of a state tree -> an owned numpy copy."""
    return tree_map(lambda x: x.detach().cpu().clone().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)


def to_torch(tree, device="cpu"):
    """Every numpy array of a state tree -> a tensor on ``device``."""
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(device)
                    if isinstance(x, np.ndarray) else x, tree)


def _is_opt_state(tree):
    return isinstance(tree, dict) and "param_groups" in tree \
        and "state" in tree


def scale_learning_rate(tree, factor):
    """Multiply the ``lr`` of every param group of every optimizer
    ``state_dict`` found in ``tree`` by ``factor``; everything else passes
    through unchanged."""
    if _is_opt_state(tree):
        return dict(tree, param_groups=[dict(g, lr=g["lr"] * factor)
                                        for g in tree["param_groups"]])
    if isinstance(tree, dict):
        return {k: scale_learning_rate(v, factor) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(scale_learning_rate(v, factor) for v in tree)
    return tree


def current_learning_rates(tree):
    """Every param group's ``lr`` in the optimizer ``state_dict`` s of
    ``tree``, as floats."""
    if _is_opt_state(tree):
        return [float(g["lr"]) for g in tree["param_groups"]]
    out = []
    if isinstance(tree, dict):
        for v in tree.values():
            out.extend(current_learning_rates(v))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out.extend(current_learning_rates(v))
    return out


class DivergenceMonitor:
    """Host-side divergence policy for one fit (the JAX package's rules).

    Call :meth:`check` once per epoch with :func:`numerics_summary` and the
    validation criteria; on ``ok`` call :meth:`note_good` with the live
    state tree; on ``rollback`` take :meth:`rollback`'s restored tree (its
    learning rates already backed off, compounding across restores of one
    snapshot); on ``abort`` stop the fit with ``action.cause``.
    """

    def __init__(self, policy: NumericsPolicy):
        self.policy = policy
        self.rollbacks = 0
        self.lr_scale = 1.0
        self.best = math.inf
        self.snapshot_epoch = None
        self._snapshot = None
        self._snapshot_rollbacks = 0
        self._nonfinite_epochs = 0

    def note_good(self, epoch, state_tree):
        """Record a host copy of ``state_tree`` as the rollback target."""
        self._snapshot = to_host(state_tree)
        self.snapshot_epoch = epoch
        self._snapshot_rollbacks = self.rollbacks

    def rollback(self):
        """The last known-good tree (CPU tensors) with learning rates
        backed off, consuming one unit of the rollback budget."""
        if self._snapshot is None:
            raise RuntimeError("rollback without a snapshot")
        self.rollbacks += 1
        self.lr_scale *= self.policy.lr_backoff
        self._nonfinite_epochs = 0
        factor = self.policy.lr_backoff ** (self.rollbacks
                                            - self._snapshot_rollbacks)
        return scale_learning_rate(to_torch(self._snapshot), factor)

    def _diverge_action(self, cause):
        if self._snapshot is None \
                or self.rollbacks >= self.policy.max_rollbacks:
            return NumericsAction("abort", cause)
        return NumericsAction("rollback", cause)

    def check(self, epoch, numerics, criteria) -> NumericsAction:
        """``numerics`` is :func:`numerics_summary` output; ``criteria``
        this epoch's validation criteria, or None before it is defined."""
        del epoch
        if numerics is not None and (
                numerics["consecutive"] >= self.policy.max_consecutive_skips):
            return self._diverge_action("nonfinite_grad")
        if criteria is None:
            return NumericsAction("ok")
        crit = float(criteria)
        if not math.isfinite(crit):
            if math.isfinite(self.best):
                return self._diverge_action("nonfinite_val")
            self._nonfinite_epochs += 1
            if self._nonfinite_epochs >= self.policy.max_nonfinite_epochs:
                return NumericsAction("abort", "all_nonfinite_validation")
            return NumericsAction("ok")
        self._nonfinite_epochs = 0
        if math.isfinite(self.best):
            f = self.policy.divergence_factor
            threshold = self.best + f * max(abs(self.best),
                                            self.policy.divergence_atol)
            if crit > threshold:
                return self._diverge_action("divergence")
        self.best = min(self.best, crit)
        return NumericsAction("ok")
