"""QRBS — Quantiles of Ridge-regressed Bootstrap Samples.

Copy of ``redcliff_tpu/tidybench/qrbs.py`` for the PyTorch port (host
numpy; equal to the JAX package's bit for bit, imports nothing of it).

Behavioral equivalent of the reference's tidybench/qrbs.py:14-63: regress the
first difference of the series on the stacked lagged values with ridge
regression over many bootstrap samples, aggregate |coefficients| over lags, and
take a per-link quantile across the bootstrap distribution. The returned matrix
has the parents of variable j in column j (scores are transposed at the end).

The ridge solve (with intercept, matching sklearn's default) is done in closed
form for all N targets at once.
"""
from __future__ import annotations

import numpy as np

from redcliff_tpu_torch.tidybench.utils import common_pre_post_processing

__all__ = ["qrbs"]


def _ridge_fit_coefs(X, y, alpha):
    """Intercept-bearing ridge: center, solve (XᵀX+αI)β = Xᵀy → (targets, feats)."""
    Xc = X - X.mean(axis=0)
    yc = y - y.mean(axis=0)
    G = Xc.T @ Xc
    G[np.diag_indices_from(G)] += alpha
    beta = np.linalg.solve(G, Xc.T @ yc)
    return beta.T


@common_pre_post_processing
def qrbs(data, lags=1, alpha=0.005, q=0.75, n_resamples=600, rng=None):
    """Bootstrap-ridge scoring of lagged links.

    ``q`` picks the quantile of the per-link |coefficient| bootstrap
    distribution (1 = max effect, 0.5 = median). ``rng`` is a numpy Generator
    (or seed) for the bootstrap draws.
    """
    data = np.asarray(data, dtype=np.float64)
    rng = np.random.default_rng(rng)
    T, N = data.shape

    # Target: one-step difference; design: lag blocks ordered t−1, t−2, … t−lags.
    y = np.diff(data, axis=0)[lags - 1 :]
    X = np.concatenate([data[lags - d : T - d] for d in range(1, lags + 1)], axis=1)

    k = int(np.floor(T * 0.7))
    per_boot = np.empty((n_resamples, N, N))
    for b in range(n_resamples):
        idx = rng.integers(0, X.shape[0], size=k)
        coefs = _ridge_fit_coefs(X[idx], y[idx], alpha)  # (N, lags·N)
        per_boot[b] = np.abs(coefs.reshape(N, lags, N)).sum(axis=1)

    scores = np.quantile(per_boot, q, axis=0)
    return scores.T  # parents of j in column j
