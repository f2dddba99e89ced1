"""SLARAC — Subsampled Linear Auto-Regression Absolute Coefficients.

Copy of ``redcliff_tpu/tidybench/slarac.py`` for the PyTorch port (host
numpy; equal to the JAX package's bit for bit, imports nothing of it).

Behavioral equivalent of the reference's tidybench/slarac.py:14-100: fit a lagged
linear VAR by least squares on the full series and on bootstrap subsamples, each
time with a randomly drawn effective lag; average the absolute coefficients and
aggregate over lags into an N×N score matrix where entry (i, j) scores the link
X_i → X_j.

This implementation is deterministic given an explicit ``rng`` (the reference
used global ``np.random``) and solves all regressions through one vectorized
normal-equations path.
"""
from __future__ import annotations

import numpy as np

from redcliff_tpu_torch.tidybench.utils import common_pre_post_processing

__all__ = ["slarac", "INV_GOLDEN_RATIO"]

INV_GOLDEN_RATIO = 2.0 / (1.0 + np.sqrt(5.0))
_DEFAULT_FRACTIONS = tuple(INV_GOLDEN_RATIO ** (1.0 / k) for k in (1, 2, 3, 6))


def _lagged_design(data, maxlags):
    """Return targets Y (T−L, N) and design Z (T−L, 1+L·N): intercept column,
    then the lag-1 block, lag-2 block, … lag-L block."""
    T, N = data.shape
    rows = T - maxlags
    blocks = [np.ones((rows, 1))]
    for k in range(1, maxlags + 1):
        blocks.append(data[maxlags - k : T - k])
    return data[maxlags:], np.concatenate(blocks, axis=1)


def _var_abs_coeffs(Y, Z, N, maxlags, rng, bootstrap_rows=None,
                    missing_values=None):
    """One (optionally bootstrapped) VAR fit → (N, 1+L·N) coefficient matrix.

    Matches the reference's quirks deliberately: a feasibility heuristic caps
    the lag when the sample is short, a random *effective* lag ≤ max(maxlags,
    feasible) is drawn per fit, and only the first ``1 + efflag·N`` design
    columns enter the regression (the rest of the coefficient row stays 0).
    Rows containing the ``missing_values`` sentinel in either target or design
    are dropped after subsampling, as in the reference.
    """
    if bootstrap_rows is not None:
        idx = rng.integers(0, Y.shape[0], size=bootstrap_rows)
        Y, Z = Y[idx], Z[idx]
    if missing_values is not None:
        if isinstance(missing_values, float) and np.isnan(missing_values):
            bad = np.any(np.isnan(Y), axis=1) | np.any(np.isnan(Z), axis=1)
        else:
            bad = (np.any(Y == missing_values, axis=1)
                   | np.any(Z == missing_values, axis=1))
        Y, Z = Y[~bad], Z[~bad]
    rows, cols = Z.shape[0], Z.shape[1]
    feasible = maxlags
    if rows / cols < INV_GOLDEN_RATIO:
        feasible = int(np.floor((rows / INV_GOLDEN_RATIO - 1) / N))
    efflag = int(rng.integers(1, max(maxlags, feasible) + 1))
    cut = efflag * N + 1
    Zc = Z[:, :cut]
    B = np.zeros((N, Z.shape[1]))
    coef, *_ = np.linalg.lstsq(Zc.T @ Zc, Zc.T @ Y, rcond=None)
    B[:, :cut] = coef.T
    return B


@common_pre_post_processing
def slarac(data, maxlags=1, n_subsamples=200, subsample_sizes=_DEFAULT_FRACTIONS,
           missing_values=None, aggregate_lags=None, rng=None):
    """Score lagged links of a linear VAR via subsampled absolute coefficients.

    Parameters mirror the reference; ``missing_values`` marks a sentinel whose
    rows are excluded from each fit; ``aggregate_lags`` maps the
    (N_to, maxlags, N_from) lag-resolved score stack to N×N (default: max over
    lags, transposed so (i, j) reads X_i → X_j). ``rng`` is a numpy Generator
    (or seed) for the subsample draws.
    """
    data = np.asarray(data, dtype=np.float64)
    rng = np.random.default_rng(rng)
    if aggregate_lags is None:
        aggregate_lags = lambda x: x.max(axis=1).T  # noqa: E731
    T, N = data.shape
    Y, Z = _lagged_design(data, maxlags)

    scores = np.abs(_var_abs_coeffs(Y, Z, N, maxlags, rng,
                                    missing_values=missing_values))
    fractions = rng.choice(np.asarray(subsample_sizes), size=n_subsamples)
    for frac in fractions:
        rows = int(np.round(frac * T))
        scores += np.abs(_var_abs_coeffs(Y, Z, N, maxlags, rng,
                                         bootstrap_rows=rows,
                                         missing_values=missing_values))

    scores = scores[:, 1:] / (n_subsamples + 1)  # drop intercepts, average
    return aggregate_lags(scores.reshape(N, maxlags, N))
