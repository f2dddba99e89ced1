"""Directed spectrum via Wilson spectral factorization (the port's copy of
``redcliff_tpu/utils/directed_spectrum.py``; numpy/scipy on the host).

Given multi-channel windows, computes the pairwise directed power spectrum
ds[w, f, i, j] = directed power i -> j (G.T. Wilson, "The Factorization of
Matricial Spectral Densities", SIAM J. Appl. Math. 23(4), 1972).

All windows, and for the pairwise mode all channel pairs folded into the
window axis, iterate together as one batched linear-algebra program, with
converged windows frozen by a mask. It stays on the host in
float64/complex128: this is one-shot dataset preprocessing and the iteration
is numerically touchy below f64. The code is the JAX package's, line for
line, so both packages compute the same features bit for bit.
"""
from __future__ import annotations

from itertools import combinations
from warnings import warn

import numpy as np
from scipy.fft import fft, ifft
from scipy.signal import csd

__all__ = ["get_directed_spectrum", "wilson_factorize"]

DEFAULT_CSD_PARAMS = {
    "detrend": "constant",
    "window": "hann",
    "nperseg": 512,
    "noverlap": 256,
    "nfft": None,
}


def _hermitian(M):
    return M.conj().swapaxes(-1, -2)


def _plus_operator(g):
    """Causal (non-negative-lag) part of a frequency-domain array g
    (..., F, N, N), plus the zero-lag time-domain component
    (ref directed_spectrum.py:288-322)."""
    gamma = ifft(g, axis=-3).real.astype(g.dtype)
    F = gamma.shape[-3]
    half = F // 2
    gamma[..., 0, :, :] *= 0.5
    if F % 2 == 0:
        gamma[..., half, :, :] *= 0.5
    gamma[..., half + 1:, :, :] = 0
    return fft(gamma, axis=-3), gamma[..., 0, :, :]


def _max_rel_change(x, x0):
    """Per-window max relative |x - x0| / |x| with tiny entries clamped to 1
    (ref directed_spectrum.py:325-348)."""
    diff = np.abs(x - x0)
    ref = np.abs(x)
    eps = np.finfo(ref.dtype).eps
    ref[ref <= 2 * eps] = 1.0
    return (diff / ref).reshape(x.shape[0], -1).max(axis=1)


def wilson_factorize(cpsd, max_iter=1000, tol=1e-6, eps_multiplier=100):
    """Factorize two-sided CPSD matrices into minimum-phase transfer matrices H
    and innovation covariances Sigma, batched over windows.

    cpsd: (W, F, N, N) complex. Returns (H (W, F, N, N), Sigma (W, N, N)) with
    cpsd ~= H @ Sigma @ H^* at every frequency.
    """
    cpsd = np.asarray(cpsd, dtype=np.complex128)
    cond = np.linalg.cond(cpsd)
    if np.any(cond > 1 / np.finfo(cpsd.dtype).eps):
        warn("CPSD matrix is singular!")
        this_eps = np.spacing(np.abs(cpsd)).max()
        cpsd = cpsd + np.eye(cpsd.shape[-1]) * this_eps * eps_multiplier

    # init: psi = chol(zero-lag autocovariance)^H tiled over frequency
    gamma0 = ifft(cpsd, axis=1)[:, 0]
    gamma0 = np.real(gamma0 + _hermitian(gamma0)) / 2.0
    A0 = _hermitian(np.linalg.cholesky(gamma0)).astype(np.complex128)
    psi = np.repeat(A0[:, None], cpsd.shape[1], axis=1)
    L = np.linalg.cholesky(cpsd)

    W = cpsd.shape[0]
    I = np.eye(cpsd.shape[-1])
    active = np.ones(W, dtype=bool)
    for _ in range(max_iter):
        # g = psi \ cpsd / psi^* + I, computed from the Cholesky factor
        pic = np.linalg.solve(psi, L)
        g = pic @ _hermitian(pic) + I
        gplus, g0 = _plus_operator(g)
        # S makes g0 + S upper triangular with S + S^H = 0
        S = -np.tril(g0, -1)
        S = S - _hermitian(S)
        psi_new = psi @ (gplus + S[:, None])
        A0_new = A0 @ (g0 + S)
        psi_delta = _max_rel_change(psi_new, psi)
        a0_delta = _max_rel_change(A0_new, A0)
        # freeze converged windows so extra iterations don't perturb them
        m = active[:, None, None, None]
        psi = np.where(m, psi_new, psi)
        A0 = np.where(m[:, 0], A0_new, A0)
        active = active & ((psi_delta >= tol) | (a0_delta >= tol))
        if not active.any():
            break
    else:
        if active.any():
            warn("Wilson factorization failed to converge.", stacklevel=2)

    H = np.linalg.solve(A0[:, None].swapaxes(-1, -2), psi.swapaxes(-1, -2))
    H = H.swapaxes(-1, -2)  # H = psi @ inv(A0)
    Sigma = np.real(A0 @ A0.swapaxes(-1, -2))
    return H, Sigma


def _pair_ds(H, Sigma):
    """Directed power for 2x2 factorizations: returns (ds01, ds10), each
    (W, F) — the power channel 0 receives from 1 and vice versa
    (ref directed_spectrum.py:222-260 specialized to singleton groups)."""
    H01 = H[..., 0, 1]
    H10 = H[..., 1, 0]
    s00, s01 = Sigma[:, 0, 0], Sigma[:, 0, 1]
    s10, s11 = Sigma[:, 1, 0], Sigma[:, 1, 1]
    # conditional innovation covariances
    sig1_0 = s11 - s10 * s01 / s00
    sig0_1 = s00 - s01 * s10 / s11
    ds10 = np.real(H01 * sig1_0[:, None] * H01.conj())
    ds01 = np.real(H10 * sig0_1[:, None] * H10.conj())
    return ds01, ds10


def get_directed_spectrum(X, fs, pairwise=True, max_iter=1000, tol=1e-6,
                          csd_params=None):
    """Directed spectrum of multi-channel windows (ref
    directed_spectrum.py:48-144).

    X: (C, T) or (W, C, T). Returns (f (F',), ds (W, F', C, C)) one-sided, with
    ds[w, f, i, j] the directed power i -> j.
    """
    X = np.asarray(X)
    if X.ndim == 2:
        X = X[None]
    assert X.ndim == 3, f"len({X.shape}) != 3"
    W, C, _ = X.shape
    params = dict(DEFAULT_CSD_PARAMS, **(csd_params or {}))

    f, cpsd = csd(X[:, np.newaxis], X[:, :, np.newaxis], fs=fs,
                  return_onesided=False, **params)  # (F,), (W, C, C, F)
    cpsd = np.moveaxis(cpsd, 3, 1)  # (W, F, C, C)
    F = cpsd.shape[1]

    pairs = list(combinations(range(C), 2))
    ds = np.zeros((W, F, C, C), dtype=np.float64)
    if pairs:
        if pairwise:
            # fold (window, pair) into one batch of 2x2 factorizations
            sub = np.stack(
                [cpsd[:, :, np.ix_([i, j], [i, j])[0], np.ix_([i, j], [i, j])[1]]
                 for (i, j) in pairs], axis=1)  # (W, P, F, 2, 2)
            sub = sub.reshape(W * len(pairs), F, 2, 2)
            H, Sigma = wilson_factorize(sub, max_iter, tol)
            ds01, ds10 = _pair_ds(H, Sigma)
            ds01 = ds01.reshape(W, len(pairs), F)
            ds10 = ds10.reshape(W, len(pairs), F)
            for p, (i, j) in enumerate(pairs):
                ds[:, :, i, j] = ds01[:, p]
                ds[:, :, j, i] = ds10[:, p]
        else:
            H, Sigma = wilson_factorize(cpsd, max_iter, tol)
            for (i, j) in pairs:
                subH = H[:, :, np.ix_([i, j], [i, j])[0], np.ix_([i, j], [i, j])[1]]
                subS = Sigma[:, np.ix_([i, j], [i, j])[0], np.ix_([i, j], [i, j])[1]]
                ds01, ds10 = _pair_ds(subH, subS)
                ds[:, :, i, j] = ds01
                ds[:, :, j, i] = ds10

    # fold to a one-sided spectrum (ref :135-142)
    nyquist = F // 2
    ds = ds[:, : nyquist + 1]
    ds[:, 1:nyquist] *= 2
    if F % 2 != 0:
        ds[:, nyquist] *= 2
    f = np.abs(f[: nyquist + 1])
    return f, ds
