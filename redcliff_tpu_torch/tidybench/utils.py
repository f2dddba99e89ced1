"""Shared pre/post-processing for the tidybench score-based algorithms.

Copy of ``redcliff_tpu/tidybench/utils.py`` for the PyTorch port (host
numpy; equal to the JAX package's bit for bit, imports nothing of it).

Equivalent of the reference's tidybench/utils.py:4-61 (`common_pre_post_processing`
decorator): optional z-scoring of the input data, and optional standardise /
[0,1]-rescale / edge-prior (divide-by-mean) transforms of the returned scores.
Implemented as an explicit wrapper so the processing order is visible in one place.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["common_pre_post_processing", "standardise"]


def standardise(X, axis=0):
    """Z-score ``X`` along ``axis`` (``axis=None`` → over all entries)."""
    X = np.asarray(X, dtype=np.float64)
    mu = X.mean(axis=axis, keepdims=axis is not None)
    sd = X.std(axis=axis, keepdims=axis is not None)
    return (X - mu) / sd


def common_pre_post_processing(func_raw):
    """Decorator adding the tidybench-standard data/score transforms.

    Keyword switches (all default False), applied in this order:
      pre_normalise       — z-score the data columns before the algorithm runs
      post_standardise    — z-score the scores over all entries
      post_zeroonescaling — rescale scores to [0, 1]
      post_edgeprior      — divide scores by their mean

    If the wrapped algorithm returns a tuple, only its first element (the score
    matrix) is transformed.
    """

    @functools.wraps(func_raw)
    def wrapped(data, *args, **kwargs):
        pre_normalise = kwargs.pop("pre_normalise", False)
        post_standardise = kwargs.pop("post_standardise", False)
        post_zeroonescaling = kwargs.pop("post_zeroonescaling", False)
        post_edgeprior = kwargs.pop("post_edgeprior", False)

        if pre_normalise:
            data = standardise(np.array(data, dtype=np.float64, copy=True))

        out = func_raw(data, *args, **kwargs)
        is_tuple = isinstance(out, tuple) and len(out) > 1
        scores = out[0] if is_tuple else out

        if post_standardise:
            scores = standardise(scores, axis=None)
        if post_zeroonescaling:
            lo, hi = scores.min(), scores.max()
            scores = (scores - lo) / (hi - lo)
        if post_edgeprior:
            scores = scores / scores.mean()

        if is_tuple:
            return (scores,) + tuple(out[1:])
        return scores

    return wrapped
