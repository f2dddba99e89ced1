"""SELVAR — Selective auto-regressive model (hill-climbed structure + lags).

Copy of ``redcliff_tpu/tidybench/selvar.py`` for the PyTorch port (host
numpy; equal to the JAX package's bit for bit, imports nothing of it).

Equivalent of the reference's tidybench/selvar.py:20-60 and its Fortran core
selvarF.f (SLVAR/GTPRSS/GTCOEF/GTRSS/GTSTAT). The compute core here is C++
(native/selvar.cpp, built on demand and bound with ctypes); a numpy
implementation of the identical algorithm serves as fallback and as the parity
oracle in the tests.

Algorithm: for each target variable j, hill-climb over per-source lag
assignments A[i, j] ∈ {0..maxlags} (0 = no edge), scored by the leave-one-out
PRESS statistic Σ_t (e_t / (1 − h_t))² accumulated over batches of consecutive
time points; report batch-averaged absolute OLS coefficients of the selected
model as edge scores.

Deliberate divergence from the Fortran: its DORGQR call formed only the first
NV rows of Q yet read all BS workspace rows as leverages (selvarF.f:193-204),
so most rows' h_t were Householder remnants; both backends here compute the
true PRESS leverage h_t = d_tᵀ(DᵀD)⁻¹d_t for every row, which can select
different structures on borderline candidates (in favor of the correct
statistic).
"""
from __future__ import annotations

import numpy as np

from redcliff_tpu_torch.tidybench import native
from redcliff_tpu_torch.tidybench.utils import common_pre_post_processing

__all__ = ["selvar", "slvar", "gtcoef", "gtstat"]


# ---------------------------------------------------------------- numpy core

def _clamp_ml(ml, T):
    return 1 if (ml >= T or ml < 1) else ml


def _clamp_bs(bs_box, T, ml):
    """The Fortran clamps the caller's batch size in place on every scoring
    call, so the clamp persists as the adaptive max-lag grows; ``bs_box`` is a
    one-element list emulating that in-out argument."""
    if bs_box[0] < 0:
        bs_box[0] = (T - ml) // (-bs_box[0])
    if bs_box[0] == 0:  # documented-but-unhandled case in the Fortran
        bs_box[0] = T - ml
    if bs_box[0] > T - ml:
        bs_box[0] = T - ml
    return bs_box[0]


def _design(X, j, ml, bs, batch, src, lags):
    base = ml + batch * bs
    t0 = base + np.arange(bs)
    D = np.ones((bs, 1 + len(src)))
    for s, (i, l) in enumerate(zip(src, lags)):
        D[:, 1 + s] = X[t0 - l, i]
    return D, X[t0, j]


def _press_np(X, ml, bs_box, A, j):
    T, N = X.shape
    ml = _clamp_ml(ml, T)
    bs = _clamp_bs(bs_box, T, ml)
    src = [i for i in range(N) if A[i, j] > 0]
    lags = [A[i, j] for i in src]
    p = 1 + len(src)
    if p > bs:
        return -1.0
    nf = (T - ml) // bs
    if nf < 1:
        return -1.0
    score = 0.0
    for k in range(nf):
        D, y = _design(X, j, ml, bs, k, src, lags)
        G = D.T @ D
        try:
            L = np.linalg.cholesky(G)
        except np.linalg.LinAlgError:
            return -1.0
        beta = np.linalg.solve(L.T, np.linalg.solve(L, D.T @ y))
        resid = y - D @ beta
        Z = np.linalg.solve(L, D.T)          # (p, bs); h_t = ‖Z[:, t]‖²
        h = np.einsum("pt,pt->t", Z, Z)
        score += float(np.sum((resid / (1.0 - h)) ** 2))
    return score


def _gtcoef_np(X, ml, bs, A, job="ABS", nrm=0):
    T, N = X.shape
    # a lag larger than ml would index before the series start; raise ml from
    # the lag matrix (the reference's GTCOEF read out of bounds here)
    ml = max(ml, int(np.max(A)) if np.size(A) else 0)
    ml = _clamp_ml(ml, T)
    bs_box = [bs]
    bs = _clamp_bs(bs_box, T, ml)
    nf = (T - ml) // bs
    B = np.zeros((N, N))
    V = np.zeros(N)
    for j in range(N):
        src = [i for i in range(N) if A[i, j] > 0]
        lags = [A[i, j] for i in src]
        for k in range(nf):
            D, y = _design(X, j, ml, bs, k, src, lags)
            try:
                beta = np.linalg.solve(D.T @ D, D.T @ y)
            except np.linalg.LinAlgError:
                continue
            V[j] += float(np.sum((y - D @ beta) ** 2)) / (bs * nf)
            for s, i in enumerate(src):
                c = beta[1 + s]
                v = abs(c) if job == "ABS" else c * c if job == "SQR" else c
                B[i, j] += v / nf
    if nrm > 0:
        with np.errstate(divide="ignore", invalid="ignore"):
            B = B / np.sqrt(B**2 + V[None, :] / V[:, None])
    return B


def _gtrss_np(X, ml, bs, A, j):
    T, N = X.shape
    # guard for direct callers (no-op when the caller already raised ml, as
    # the gtstat frontend does before computing its nf/bs normalization)
    ml = max(ml, int(np.max(A)) if np.size(A) else 0)
    ml = _clamp_ml(ml, T)
    bs_box = [bs]
    bs = _clamp_bs(bs_box, T, ml)
    nf = (T - ml) // bs
    src = [i for i in range(N) if A[i, j] > 0]
    lags = [A[i, j] for i in src]
    score = 0.0
    for k in range(nf):
        D, y = _design(X, j, ml, bs, k, src, lags)
        try:
            beta = np.linalg.solve(D.T @ D, D.T @ y)
        except np.linalg.LinAlgError:
            continue
        score += float(np.sum((y - D @ beta) ** 2))
    return score / (nf * bs)


def _slvar_np(X, bs, ml, mxitr):
    T, N = X.shape
    adaptive = ml < 1
    ml = _clamp_ml(ml, T)
    bs_box = [bs]
    _clamp_bs(bs_box, T, ml)
    A = np.zeros((N, N), dtype=np.int32)
    itr = 0
    if mxitr != 0:
        for j in range(N):
            itr = 0
            if adaptive:
                ml = 1
            scr = _press_np(X, ml, bs_box, A, j)
            improved = True
            while improved and (mxitr < 0 or itr < mxitr):
                itr += 1
                improved = False
                best, ibst, kbst = scr, -1, 0
                for K in range(ml + 1):
                    for i in range(N):
                        cur = A[i, j]
                        if K == cur:
                            continue
                        A[i, j] = K
                        s = _press_np(X, ml, bs_box, A, j)
                        A[i, j] = cur
                        if s >= 0.0 and s < best:
                            best, ibst, kbst = s, i, K
                if ibst >= 0:
                    A[ibst, j] = kbst
                    scr = best
                    improved = True
                if adaptive:
                    ml = min(ml + 1, T // 2)
    B = _gtcoef_np(X, ml, bs_box[0], A, job="ABS", nrm=0)
    return B, A, itr


# ------------------------------------------------------------------- frontend

def slvar(data, batchsize=-1, maxlags=-1, mxitr=-1, backend="auto"):
    """Run the full SELVAR search. Returns (scores, lags, info).

    backend: "auto" (native C++ with numpy fallback), "native", or "numpy".
    """
    X = np.ascontiguousarray(data, dtype=np.float64)
    if backend in ("auto", "native"):
        out = native.slvar_native(X, batchsize, maxlags, mxitr)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native SELVAR library could not be built")
    return _slvar_np(X, batchsize, maxlags, mxitr)


def gtcoef(data, A, maxlags=-1, batchsize=-1, job="ABS", nrm=0, backend="auto"):
    """Batch-averaged (abs/squared/raw) coefficients for a fixed lag matrix.
    ``maxlags < 1`` infers the lag ceiling from ``A`` (as ``gtstat`` does)."""
    X = np.ascontiguousarray(data, dtype=np.float64)
    if maxlags < 1:
        maxlags = max(int(np.max(A)) if np.size(A) else 1, 1)
    if backend in ("auto", "native"):
        out = native.gtcoef_native(X, maxlags, batchsize, A, job=job, nrm=nrm)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native SELVAR library could not be built")
    return _gtcoef_np(X, maxlags, batchsize, np.asarray(A), job=job, nrm=nrm)


def gtstat(data, A, maxlags=-1, batchsize=-1, job="DF", backend="auto"):
    """Per-edge statistics for a fixed lag matrix: "DF" (delta-RSS), "LR"
    (log likelihood ratio), or "FS" (F statistic). Returns (stats, df)."""
    X = np.ascontiguousarray(data, dtype=np.float64)
    A = np.asarray(A, dtype=np.int32)
    if backend in ("auto", "native"):
        out = native.gtstat_native(X, maxlags, batchsize, A, job=job)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native SELVAR library could not be built")
    T, N = X.shape
    # one consistent lag ceiling for the whole statistic: at least every lag
    # in A (a smaller explicit maxlags would index before the series start)
    ml = max(maxlags, int(A.max()) if A.size else 0)
    ml = _clamp_ml(ml, T)
    bs_box = [batchsize]
    bs = _clamp_bs(bs_box, T, ml)
    nf = (T - ml) // bs
    B = np.zeros((N, N))
    DF = np.zeros((N, 2), dtype=np.int32)
    for j in range(N):
        full = _gtrss_np(X, ml, bs, A, j)
        for i in range(N):
            if A[i, j] <= 0:
                continue
            DF[j, 0] += nf
            saved = A[i, j]
            A[i, j] = 0
            reduced = _gtrss_np(X, ml, bs, A, j)
            A[i, j] = saved
            if job == "FS":
                B[i, j] = (reduced - full) / full
            elif job == "LR":
                B[i, j] = (np.log(reduced) - np.log(full)) * nf * bs
            else:
                B[i, j] = reduced - full
        DF[j, 1] = DF[j, 0] - nf
    if job == "FS":
        for j in range(N):
            DF[j, 1] = bs * nf - DF[j, 0]
            DF[j, 0] = nf
            B[:, j] *= DF[j, 1]
    return B, DF


@common_pre_post_processing
def selvar(data, maxlags=1, batchsize=-1, mxitr=-1, trace=0, backend="auto"):
    """SELVAR edge scores: (i, j) scores the link X_i → X_j.

    maxlags < 0 enables the adaptive per-target lag search; batchsize < 0 sets
    the batch to the maximum available span; mxitr < 0 runs the hill climb to
    convergence. ``trace`` is accepted for signature parity and ignored.
    """
    scores, _, _ = slvar(data, batchsize=batchsize, maxlags=maxlags,
                         mxitr=mxitr, backend=backend)
    return scores
