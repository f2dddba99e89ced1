"""LASAR — LASso Auto-Regression with subsample-averaged debiased refits.

Copy of ``redcliff_tpu/tidybench/lasar.py`` for the PyTorch port (host
numpy; equal to the JAX package's bit for bit, imports nothing of it).

Behavioral equivalent of the reference's tidybench/lasar.py:16-98: for the full
series and many bootstrap subsamples, run a per-target, per-lag-block
cross-validated lasso (LARS path) to select parents, then refit ordinary least
squares on the selected columns to debias; average the absolute refit
coefficients over subsamples and aggregate over lags.

Kept deliberately: the reference selects only variables with *positive* lasso
coefficients (``coef_ > 0``) and fits lag blocks sequentially against the
running residual — both are part of the published algorithm's behavior.
"""
from __future__ import annotations

import numpy as np

from redcliff_tpu_torch.tidybench.slarac import _DEFAULT_FRACTIONS
from redcliff_tpu_torch.tidybench.utils import common_pre_post_processing

__all__ = ["lasar"]


def _lasso_var_coeffs(data, maxlags, cv, rng, bootstrap_rows=None):
    from sklearn.linear_model import LassoLarsCV

    T, N = data.shape
    Y = data[maxlags:]
    Z = np.concatenate([data[maxlags - k : T - k] for k in range(1, maxlags + 1)],
                       axis=1)
    if bootstrap_rows is not None:
        idx = rng.integers(0, Y.shape[0], size=bootstrap_rows)
        Y, Z = Y[idx], Z[idx]

    scores = np.zeros((N, N * maxlags))
    selector = LassoLarsCV(cv=cv, n_jobs=1)
    for j in range(N):
        target = Y[:, j].copy()
        selected = np.zeros(N * maxlags, dtype=bool)
        for lag in range(maxlags):
            sl = slice(N * lag, N * (lag + 1))
            selector.fit(Z[:, sl], target)
            selected[sl] = selector.coef_ > 0
            target -= selector.predict(Z[:, sl])
        ZZ = Z[:, selected]
        if ZZ.shape[1]:
            beta, *_ = np.linalg.lstsq(ZZ.T @ ZZ, ZZ.T @ Y[:, j], rcond=None)
            scores[j, selected] = beta
    return scores


@common_pre_post_processing
def lasar(data, maxlags=1, n_subsamples=100, subsample_sizes=_DEFAULT_FRACTIONS,
          cv=5, aggregate_lags=None, rng=None):
    """Score lagged links via subsample-averaged lasso-selected OLS refits.

    ``aggregate_lags`` maps (N_to, maxlags, N_from) → N×N (default max over
    lags, transposed so (i, j) reads X_i → X_j); ``rng`` seeds the subsampling.
    """
    data = np.asarray(data, dtype=np.float64)
    rng = np.random.default_rng(rng)
    if aggregate_lags is None:
        aggregate_lags = lambda x: x.max(axis=1).T  # noqa: E731
    T, N = data.shape

    scores = np.abs(_lasso_var_coeffs(data, maxlags, cv, rng))
    fractions = rng.choice(np.asarray(subsample_sizes), size=n_subsamples)
    for frac in fractions:
        rows = int(np.round(frac * T))
        scores += np.abs(
            _lasso_var_coeffs(data, maxlags, cv, rng, bootstrap_rows=rows))
    scores /= n_subsamples + 1
    return aggregate_lags(scores.reshape(N, maxlags, N))
