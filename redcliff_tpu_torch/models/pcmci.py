"""PCMCI causal discovery with linear partial-correlation tests.

Copy of ``redcliff_tpu/models/pcmci.py`` for the PyTorch port (host
numpy/scipy; equal to the JAX package's bit for bit, imports nothing of
it).

Native replacement for the external ``tigramite`` dependency the reference
uses for its Table-2 supervised-discovery comparisons (PCMCI / R-PCMCI with
the ParCorr test, imported at
the reference's evaluate/eval_algsT_by_expSynSys12112_forF1RocAucCausalDistStats.py:13-40;
the R-PCMCI usage there masks recording windows by regime and runs per-regime
discovery).

Implements the two-phase PCMCI algorithm of Runge et al. (Science Advances
2019): a per-target PC1 condition-selection phase over lagged candidates,
then the momentary-conditional-independence (MCI) phase conditioning on both
the target's and the source's selected parents.  The conditional-independence
primitive is ParCorr — partial correlation via OLS residualization with a
two-sided t-test.

Data enters as one (T, N) recording or a list of recordings (lagged samples
never span recording boundaries, which is how the reference feeds its
windowed datasets).
"""
from __future__ import annotations

import numpy as np
from scipy import stats

__all__ = ["parcorr_test", "pcmci", "pcmci_val_graph", "rpcmci_by_regime",
           "rpcmci"]


def parcorr_test(x, y, Z=None):
    """Partial correlation of x and y given the columns of Z.

    Returns (r, p_value): Pearson correlation of the OLS residuals of x and y
    on [1, Z], with the two-sided t-test p-value at n - 2 - dim(Z) degrees of
    freedom (tigramite ParCorr semantics)."""
    x = np.asarray(x, dtype=np.float64).ravel()
    y = np.asarray(y, dtype=np.float64).ravel()
    n = len(x)
    dim_z = 0
    if Z is not None and np.size(Z) > 0:
        Z = np.asarray(Z, dtype=np.float64)
        Z = Z.reshape(n, -1)
        dim_z = Z.shape[1]
        design = np.column_stack([np.ones(n), Z])
        x = x - design @ np.linalg.lstsq(design, x, rcond=None)[0]
        y = y - design @ np.linalg.lstsq(design, y, rcond=None)[0]
    else:
        x = x - x.mean()
        y = y - y.mean()
    denom = np.sqrt(np.sum(x * x) * np.sum(y * y))
    if denom <= 0:
        return 0.0, 1.0
    r = float(np.clip(np.sum(x * y) / denom, -0.9999999, 0.9999999))
    df = n - 2 - dim_z
    if df <= 0:
        return r, 1.0
    t = r * np.sqrt(df / (1.0 - r * r))
    p = 2.0 * stats.t.sf(abs(t), df)
    return r, float(p)


def _lagged_samples(recordings, tau_max):
    """Stack (X_t, {X_{t-tau}}) rows from each recording without crossing
    boundaries.  Returns (present (M, N), lagged (M, N, tau_max))."""
    present, lagged = [], []
    for rec in recordings:
        rec = np.asarray(rec, dtype=np.float64)
        T = rec.shape[0]
        if T <= tau_max:
            continue
        present.append(rec[tau_max:])
        lagged.append(np.stack([rec[tau_max - tau : T - tau]
                                for tau in range(1, tau_max + 1)], axis=2))
    if not present:
        raise ValueError("no recording longer than tau_max")
    return np.concatenate(present), np.concatenate(lagged)


def _cand_series(lagged, i, tau):
    return lagged[:, i, tau - 1]


def pcmci(data, tau_max=1, pc_alpha=0.2, alpha_level=0.05,
          max_conds_dim=None, max_combinations=1):
    """Run PCMCI over lagged links (tau in 1..tau_max).

    Args:
      data: (T, N) array or list of (T_k, N) recordings.
      pc_alpha: removal threshold in the condition-selection phase.
      alpha_level: significance level defining the returned parent sets.
      max_conds_dim: cap on condition-set size in phase 1.
      max_combinations: number of strongest-condition subsets tried per size
        (1 = tigramite's default behavior of testing the top conditions).

    Returns dict with "val_matrix" and "p_matrix" of shape
    (N, N, tau_max + 1) — entry [i, j, tau] is the MCI statistic/p-value for
    X_i(t-tau) -> X_j(t) (tau = 0 slice kept zero/one for tigramite shape
    parity) — and "parents": {j: [(i, tau), ...] sorted by strength}.
    """
    if isinstance(data, np.ndarray) and data.ndim == 2:
        recordings = [data]
    else:
        recordings = list(data)
    N = np.asarray(recordings[0]).shape[1]
    present, lagged = _lagged_samples(recordings, tau_max)
    # phase 2 conditions on source parents shifted by tau, reaching lags up
    # to 2*tau_max; build the extended window when the data allows it
    try:
        present_ext, lagged_ext = _lagged_samples(recordings, 2 * tau_max)
        ext_tau_max = 2 * tau_max
    except ValueError:
        present_ext, lagged_ext = present, lagged
        ext_tau_max = tau_max

    candidates = [(i, tau) for i in range(N) for tau in range(1, tau_max + 1)]
    if max_conds_dim is None:
        max_conds_dim = len(candidates) - 1

    # ---- phase 1: PC1 condition selection per target -----------------------
    parents = {}
    for j in range(N):
        remaining = []
        strength = {}
        # the initialization pass doubles as the p_dim=0 (unconditional)
        # removal round
        for c in candidates:
            r, p = parcorr_test(present[:, j], _cand_series(lagged, *c))
            if p <= pc_alpha:
                remaining.append(c)
                strength[c] = abs(r)
        p_dim = 1
        while p_dim <= max_conds_dim and p_dim < len(remaining):
            removed_any = False
            # strongest-first ordering stabilizes the selection; one sort
            # per round, candidates iterate over a snapshot of it
            ordering = sorted(remaining, key=lambda c: -strength[c])
            for cand in ordering:
                if cand not in remaining:
                    continue
                others = [c for c in ordering
                          if c != cand and c in remaining]
                if len(others) < p_dim:
                    continue
                for start in range(max_combinations):
                    conds = others[start : start + p_dim]
                    if len(conds) < p_dim:
                        break
                    Z = np.column_stack(
                        [_cand_series(lagged, *c) for c in conds]) \
                        if conds else None
                    r, p = parcorr_test(present[:, j],
                                        _cand_series(lagged, *cand), Z)
                    strength[cand] = min(strength[cand], abs(r))
                    if p > pc_alpha:
                        remaining.remove(cand)
                        removed_any = True
                        break
            p_dim += 1
            if not removed_any and p_dim > 1:
                break
        parents[j] = sorted(remaining, key=lambda c: -strength[c])

    # ---- phase 2: MCI ------------------------------------------------------
    val = np.zeros((N, N, tau_max + 1))
    pmat = np.ones((N, N, tau_max + 1))
    for j in range(N):
        for (i, tau) in candidates:
            conds = [c for c in parents[j] if c != (i, tau)]
            # source parents shifted by tau (momentary conditioning); the
            # extended lag window makes lags up to 2*tau_max addressable
            for (k, ktau) in parents[i]:
                if ktau + tau <= ext_tau_max:
                    shifted = (k, ktau + tau)
                    if shifted not in conds and shifted != (i, tau):
                        conds.append(shifted)
            Z = np.column_stack(
                [_cand_series(lagged_ext, *c) for c in conds]) \
                if conds else None
            r, p = parcorr_test(present_ext[:, j],
                                _cand_series(lagged_ext, i, tau), Z)
            val[i, j, tau] = r
            pmat[i, j, tau] = p

    sig_parents = {
        j: sorted([(i, tau) for (i, tau) in candidates
                   if pmat[i, j, tau] <= alpha_level],
                  key=lambda c: -abs(val[c[0], j, c[1]]))
        for j in range(N)
    }
    return {"val_matrix": val, "p_matrix": pmat, "parents": sig_parents}


def pcmci_val_graph(result, alpha_level=0.05, ignore_lag=True):
    """Collapse a pcmci() result into a scored adjacency: entry (i, j) is the
    max |MCI value| over significant lags of X_i -> X_j (the graph the
    supervised-discovery scoring consumes)."""
    val = np.abs(result["val_matrix"]).copy()
    val[result["p_matrix"] > alpha_level] = 0.0
    if ignore_lag:
        return val[:, :, 1:].max(axis=2)
    return val[:, :, 1:]


def _ridge_var_fit(feats, targs, lam):
    """Ridge-regularized linear VAR solve: feats (M, F), targs (M, N)."""
    F = feats.shape[1]
    A = feats.T @ feats + lam * np.eye(F)
    return np.linalg.solve(A, feats.T @ targs)  # (F, N)


def _var_design(rec, tau_max):
    """Per-recording lagged design matrix (T-tau, N*tau + 1) with intercept
    and its targets (T-tau, N)."""
    rec = np.asarray(rec, dtype=np.float64)
    T, N = rec.shape
    if T <= tau_max:
        return None, None
    cols = [rec[tau_max - tau : T - tau] for tau in range(1, tau_max + 1)]
    feats = np.concatenate(cols + [np.ones((T - tau_max, 1))], axis=1)
    return feats, rec[tau_max:]


def _viterbi_assign(errors, switching_penalty):
    """Min-cost per-step regime path: errors (T, K); transition cost
    ``switching_penalty`` per regime change."""
    T, K = errors.shape
    cost = errors[0].copy()
    back = np.zeros((T, K), dtype=int)
    for t in range(1, T):
        stay = cost
        best_prev = stay.min()
        trans = np.minimum(stay, best_prev + switching_penalty)
        back[t] = np.where(stay <= best_prev + switching_penalty,
                           np.arange(K), stay.argmin())
        cost = trans + errors[t]
    path = np.zeros(T, dtype=int)
    path[-1] = int(cost.argmin())
    for t in range(T - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    return path


def rpcmci(recordings, num_regimes, tau_max=1, assign_per="recording",
           n_iter=20, n_inits=3, switching_penalty=0.0, ridge_lam=1e-2,
           seed=0, pc_alpha=0.2, alpha_level=0.05):
    """Unsupervised regime-PCMCI: jointly learn a regime assignment and
    per-regime causal graphs from unlabeled recordings — the capability of
    tigramite's RPCMCI (Saggioro et al. 2020, "Reconstructing regime-dependent
    causal relationships from observational time series"; external Table-2
    dep in SURVEY §2.5 / ref evaluate notebook cell 71), implemented natively.

    Annealed alternating optimization: (a) fit one ridge-VAR error model per
    regime on its assigned samples; (b) reassign each unit to the regime
    whose model predicts it best — a whole recording when
    ``assign_per="recording"`` (the D4IC structure: one dominant network per
    window), or per time step via a min-cost path with ``switching_penalty``
    per regime change when ``assign_per="timestep"``. The best of ``n_inits``
    random initializations (lowest total prediction error) wins, then PCMCI
    runs per learned regime.

    Returns {"assignment", "results": {regime: pcmci result | None},
    "error": float}. ``assignment`` is (num_recordings,) int for recording
    mode (-1 marks recordings shorter than tau_max, which are excluded), or
    a list of per-recording (T - tau_max,) int paths for timestep mode (None
    for excluded recordings). Learned regime indices are arbitrary — align
    to ground truth with utils.metrics Hungarian matching before scoring.
    """
    recordings = [np.asarray(r, dtype=np.float64) for r in recordings]
    all_designs = [_var_design(rec, tau_max) for rec in recordings]
    # recordings too short for the lag structure are excluded; `keep` maps
    # filtered-design positions back to recording indices
    keep = [i for i, (f, _) in enumerate(all_designs) if f is not None]
    designs = [all_designs[i] for i in keep]
    if not designs:
        raise ValueError("no recording longer than tau_max")
    rng = np.random.default_rng(seed)
    R = len(designs)
    K = num_regimes

    def errors_for(W, feats, targs):
        resid = feats @ W - targs
        return (resid ** 2).sum(axis=1)  # per-step error

    best = None
    for _ in range(max(n_inits, 1)):
        if assign_per == "recording":
            assign = rng.integers(0, K, size=R)
        else:
            # contiguous-chunk random init: per-timestep random labels make
            # every regime fit the same average model (no identifiability);
            # chunks give the initial fits distinct temporal support
            assign = []
            for _, targs in designs:
                T_r = len(targs)
                chunk = max(T_r // (4 * K), tau_max + 1)
                labels = np.repeat(rng.integers(0, K, size=T_r // chunk + 1),
                                   chunk)[:T_r]
                assign.append(labels)
        for _ in range(n_iter):
            # (a) per-regime ridge-VAR fit over assigned rows
            Ws = []
            for k in range(K):
                rows_f, rows_t = [], []
                for r, (feats, targs) in enumerate(designs):
                    sel = (np.full(len(targs), assign[r] == k)
                           if assign_per == "recording" else assign[r] == k)
                    if np.any(sel):
                        rows_f.append(feats[sel])
                        rows_t.append(targs[sel])
                if rows_f:
                    Ws.append(_ridge_var_fit(np.concatenate(rows_f),
                                             np.concatenate(rows_t),
                                             ridge_lam))
                else:
                    Ws.append(None)  # empty regime: keep it empty
            # (b) reassignment
            new_assign = [] if assign_per == "timestep" else np.zeros(R, int)
            total = 0.0
            for r, (feats, targs) in enumerate(designs):
                errs = np.stack(
                    [errors_for(W, feats, targs) if W is not None
                     else np.full(len(targs), np.inf) for W in Ws], axis=1)
                if assign_per == "recording":
                    rec_err = errs.sum(axis=0)
                    new_assign[r] = int(rec_err.argmin())
                    total += rec_err[new_assign[r]]
                else:
                    # scale-free switching cost: `switching_penalty` is
                    # measured in average per-step errors, so the same value
                    # works across signal scales/noise levels
                    finite = errs.min(axis=1)
                    pen = switching_penalty * float(
                        finite[np.isfinite(finite)].mean())
                    path = _viterbi_assign(errs, pen)
                    new_assign.append(path)
                    total += errs[np.arange(len(path)), path].sum()
            if assign_per == "recording":
                converged = np.array_equal(new_assign, assign)
            else:
                converged = all(np.array_equal(a, b)
                                for a, b in zip(new_assign, assign))
            assign = new_assign
            if converged:
                break
        if best is None or total < best[0]:
            best = (total, assign)

    total, assign = best
    # final per-regime discovery on the learned segmentation
    if assign_per == "recording":
        results = rpcmci_by_regime([recordings[i] for i in keep], assign, K,
                                   tau_max=tau_max, pc_alpha=pc_alpha,
                                   alpha_level=alpha_level)
        full_assign = np.full(len(recordings), -1, dtype=int)
        full_assign[keep] = assign
        return {"assignment": full_assign, "results": results,
                "error": float(total)}

    results = {}
    for k in range(K):
        regs = []
        for d, i in enumerate(keep):
            rec = recordings[i]
            path = assign[d]
            start = None
            for t in range(len(path) + 1):
                active = t < len(path) and path[t] == k
                if active and start is None:
                    start = t
                elif not active and start is not None:
                    if t - start > tau_max:
                        # include the lag context before the segment
                        regs.append(rec[start : t + tau_max])
                    start = None
        results[k] = (pcmci(regs, tau_max=tau_max, pc_alpha=pc_alpha,
                            alpha_level=alpha_level) if regs else None)
    full_paths = [None] * len(recordings)
    for d, i in enumerate(keep):
        full_paths[i] = assign[d]
    return {"assignment": full_paths, "results": results,
            "error": float(total)}


def rpcmci_by_regime(recordings, regime_labels, num_regimes, tau_max=1,
                     pc_alpha=0.2, alpha_level=0.05):
    """Regime-resolved PCMCI: split recordings by their regime label and run
    discovery per regime (the reference's R-PCMCI data prep masks windows by
    regime, eval_algsT...py:45+).  Returns {regime: pcmci result}."""
    regime_labels = np.asarray(regime_labels).astype(int)
    assert len(regime_labels) == len(recordings)
    out = {}
    for regime in range(num_regimes):
        regs = [rec for rec, lab in zip(recordings, regime_labels)
                if lab == regime]
        if not regs:
            out[regime] = None
            continue
        out[regime] = pcmci(regs, tau_max=tau_max, pc_alpha=pc_alpha,
                            alpha_level=alpha_level)
    return out
