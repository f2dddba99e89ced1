"""Signal-processing primitives: wavelets, spectral features, filters,
outliers (the port's copy of ``redcliff_tpu/utils/time_series.py``; numpy
and scipy on the host).

* Stationary wavelet decomposition (:func:`swt` / :func:`iswt`): an
  undecimated "a trous" filter bank with orthonormal Daubechies filters
  scaled by 1/sqrt(2) per level, a tight frame, so the adjoint
  reconstruction is exact.
* The triangular (un)squeeze of symmetric channel-pair axes.
* :func:`make_high_level_signal_features`: cross-power-spectral-density and
  directed-spectrum features of a window, the DCSFA-NMF input features. They
  stay on the host in float64: one-shot dataset preprocessing, and Wilson
  factorization is numerically touchy below f64.
* Outlier marking, band/low-pass filters and the window-draw helpers (which
  take an explicit numpy Generator).

The code is the JAX package's, line for line (its directed spectrum import
points to the port's copy), so both packages compute the same features bit
for bit.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import butter, csd, iirnotch, lfilter

from redcliff_tpu_torch.utils.directed_spectrum import get_directed_spectrum

__all__ = [
    "wavelet_filters",
    "swt",
    "iswt",
    "perform_wavelet_decomposition",
    "construct_signal_approx_from_wavelet_coeffs",
    "unsqueeze_triangular_array",
    "squeeze_triangular_array",
    "make_high_level_signal_features",
    "filter_signal",
    "filter_signal_via_bandpass",
    "filter_signal_via_lowpass",
    "mark_outliers",
    "draw_timesteps_to_sample_from",
    "draw_timesteps_to_sample_from_using_label_reference",
    "DEFAULT_MAD_THRESHOLD",
    "LOW_PASS_CUTOFF",
    "LOWCUT",
    "HIGHCUT",
]

# ------------------------------------------------------------------ wavelets

# Daubechies scaling (reconstruction lowpass) filters, standard published
# coefficients; "haar" is an alias of db1.
_DB_SCALING = {
    "db1": [0.7071067811865476, 0.7071067811865476],
    "db2": [0.48296291314469025, 0.8365163037378079,
            0.22414386804185735, -0.12940952255092145],
    "db3": [0.3326705529509569, 0.8068915093133388, 0.4598775021193313,
            -0.13501102001039084, -0.08544127388224149, 0.035226291882100656],
    "db4": [0.23037781330885523, 0.7148465705525415, 0.6308807679295904,
            -0.02798376941698385, -0.18703481171888114, 0.030841381835986965,
            0.032883011666982945, -0.010597401784997278],
}


def wavelet_filters(wavelet_type):
    """(dec_lo, dec_hi) analysis filter pair for a Daubechies wavelet."""
    name = "db1" if wavelet_type in ("haar", "Haar") else wavelet_type
    if name not in _DB_SCALING:
        raise NotImplementedError(
            f"wavelet {wavelet_type!r} not available (have "
            f"{sorted(_DB_SCALING) + ['haar']})")
    rec_lo = np.asarray(_DB_SCALING[name], dtype=np.float64)
    dec_lo = rec_lo[::-1]
    dec_hi = rec_lo * np.array([(-1.0) ** k for k in range(len(rec_lo))])
    return dec_lo, dec_hi


def _dilated_correlate(x, filt, dilation):
    """Circular correlation of x (..., T) with a 2^j-dilated filter."""
    T = x.shape[-1]
    idx = (np.arange(T)[:, None] + dilation * np.arange(len(filt))[None, :]) % T
    return np.einsum("...tk,k->...t", x[..., idx], filt)


def _dilated_correlate_adjoint(x, filt, dilation):
    """Adjoint of _dilated_correlate (circular convolution with the filter)."""
    T = x.shape[-1]
    idx = (np.arange(T)[:, None] - dilation * np.arange(len(filt))[None, :]) % T
    return np.einsum("...tk,k->...t", x[..., idx], filt)


def swt(x, wavelet_type="db1", level=1):
    """Undecimated (stationary) wavelet transform, tight-frame normalized.

    x: (..., T) with T divisible by 2**level. Returns [cA_level, cD_level, ...,
    cD_1] — the pywt ``trim_approx=True`` band order the reference consumes
    (ref time_series.py:20-22). Filters carry a 1/sqrt(2) per-level scale
    (pywt's ``norm=True``), making the frame tight:
    ||x||^2 == ||cA||^2 + sum ||cD_j||^2.
    """
    dec_lo, dec_hi = wavelet_filters(wavelet_type)
    s = 1.0 / np.sqrt(2.0)
    a = np.asarray(x, dtype=np.float64)
    if a.shape[-1] % (2 ** level) != 0:
        raise ValueError(
            f"signal length {a.shape[-1]} must be divisible by 2**level "
            f"({2 ** level})")
    details = []
    for j in range(level):
        d = _dilated_correlate(a, dec_hi * s, 2 ** j)
        a = _dilated_correlate(a, dec_lo * s, 2 ** j)
        details.append(d)
    return [a] + details[::-1]


def iswt(bands, wavelet_type="db1"):
    """Exact inverse of swt via the tight-frame adjoint: at each level
    a_j = H^T a_{j+1} + G^T d_{j+1}."""
    dec_lo, dec_hi = wavelet_filters(wavelet_type)
    s = 1.0 / np.sqrt(2.0)
    level = len(bands) - 1
    a = np.asarray(bands[0], dtype=np.float64)
    for j in range(level - 1, -1, -1):
        d = bands[level - j]  # cD_{j+1} sits at index level-j in trim order
        a = (_dilated_correlate_adjoint(a, dec_lo * s, 2 ** j)
             + _dilated_correlate_adjoint(d, dec_hi * s, 2 ** j))
    return a


def perform_wavelet_decomposition(orig_sig, wavelet_type, level,
                                  decomposition_type="swt"):
    """(1, T, C) -> (1, T, C*(level+1)): channel c's bands occupy columns
    [c*(level+1), (c+1)*(level+1)) in [cA, cD_level, ..., cD_1] order
    (ref time_series.py:10-26)."""
    assert orig_sig.ndim == 3 and orig_sig.shape[0] == 1
    if decomposition_type != "swt":
        raise NotImplementedError(
            f"decomposition_type {decomposition_type!r}: only 'swt' is "
            "supported (the reference's 'wavedec' branch is broken as "
            "published, ref time_series.py:17-18)")
    sig = orig_sig[0].T  # (C, T)
    bands = swt(sig, wavelet_type, level)  # list of (C, T)
    stacked = np.stack(bands, axis=1)  # (C, level+1, T)
    out = stacked.reshape(sig.shape[0] * (level + 1), sig.shape[1])
    return out.T[None]


def construct_signal_approx_from_wavelet_coeffs(coeffs, level,
                                                wavelet_coeff_type="additive"):
    """Sum each channel's bands back into a signal approximation
    (ref time_series.py:29-43). coeffs: (1, T, C*(level+1)) -> (T, C)."""
    assert coeffs.ndim == 3 and coeffs.shape[0] == 1
    if wavelet_coeff_type != "additive":
        raise NotImplementedError(wavelet_coeff_type)
    T, CW = coeffs.shape[1], coeffs.shape[2]
    C = CW // (level + 1)
    return coeffs[0].reshape(T, C, level + 1).sum(axis=2)


# ------------------------------------------------- triangular (un)packing

def _tri_indices(n):
    """Condensed-triangular index map: entry (i, j<=i) lives at i(i+1)/2 + j."""
    rows, cols = np.tril_indices(n)
    flat = (rows * (rows + 1)) // 2 + cols
    return rows, cols, flat


def unsqueeze_triangular_array(arr, dim=0):
    """Condensed triangular axis -> symmetric (n, n) axes
    (ref time_series.py:53-84)."""
    m = arr.shape[dim]
    n = int(round((-1 + np.sqrt(1 + 8 * m)) / 2))
    assert (n * (n + 1)) // 2 == m, f"{(n * (n + 1)) // 2} != {m}"
    arr = np.swapaxes(arr, dim, -1)
    rows, cols, flat = _tri_indices(n)
    new_arr = np.zeros(arr.shape[:-1] + (n, n), dtype=arr.dtype)
    new_arr[..., rows, cols] = arr[..., flat]
    new_arr[..., cols, rows] = arr[..., flat]
    dim_list = list(range(new_arr.ndim - 2)) + [dim]
    dim_list = dim_list[:dim] + [-2, -1] + dim_list[dim + 1:]
    return np.transpose(new_arr, dim_list)


def squeeze_triangular_array(arr, dims=(0, 1)):
    """Symmetric (n, n) axes -> condensed triangular axis; inverse of
    unsqueeze_triangular_array (ref time_series.py:87-118)."""
    assert len(dims) == 2 and dims[1] == dims[0] + 1
    assert arr.shape[dims[0]] == arr.shape[dims[1]]
    n = arr.shape[dims[0]]
    dim_list = list(range(arr.ndim))
    dim_list = dim_list[: dims[0]] + dim_list[dims[1] + 1:] + list(dims)
    arr = np.transpose(arr, dim_list)
    rows, cols, flat = _tri_indices(n)
    new_arr = np.zeros(arr.shape[:-2] + ((n * (n + 1)) // 2,), dtype=arr.dtype)
    new_arr[..., flat] = arr[..., rows, cols]
    dim_list = list(range(new_arr.ndim))
    dim_list = dim_list[: dims[0]] + [-1] + dim_list[dims[0]: -1]
    return np.transpose(new_arr, dim_list)


# ------------------------------------------------------- spectral features

DEFAULT_CSD_PARAMS = {
    "detrend": "constant",
    "window": "hann",
    "nperseg": 512,
    "noverlap": 256,
    "nfft": None,
}


def make_high_level_signal_features(
    X,
    fs=1000,
    min_freq=0.0,
    max_freq=55.0,
    directed_spectrum=False,
    csd_params=None,
    rng=None,
):
    """Cross-power-spectral-density (and optionally directed-spectrum) features
    from a waveform — the DCSFA input features (ref time_series.py:121-211).

    X: (T, C). Returns {'power': (1, C*(C+1)//2, F), 'freq': (F,)
    [, 'dir_spec': (1, C, C, F)]}. NaN-bearing windows are replaced by noise for
    the transform and re-NaN'd after, as in the reference (ref :177-190).
    """
    params = dict(DEFAULT_CSD_PARAMS, **(csd_params or {}))
    n = X.shape[1]
    assert n >= 1, f"{n} < 1"
    X = np.expand_dims(X.T, axis=0).astype(np.float64)  # (1, C, T)

    nan_mask = np.sum(np.isnan(X), axis=(1, 2)) != 0
    if nan_mask.any():
        rng = rng or np.random.default_rng()
        X[nan_mask] = rng.standard_normal(X[nan_mask].shape)
    f, cpsd = csd(X[:, :, np.newaxis], X[:, np.newaxis], fs=fs, **params)
    i1, i2 = np.searchsorted(f, [min_freq, max_freq])
    f = f[i1:i2]
    cpsd = np.abs(cpsd[..., i1:i2])
    cpsd = squeeze_triangular_array(cpsd, dims=(1, 2))
    cpsd = cpsd * f  # scale power features by frequency (ref :189)
    cpsd[nan_mask] = np.nan

    res = {"power": cpsd, "freq": f}

    if directed_spectrum:
        f_temp, dir_spec = get_directed_spectrum(X, fs, csd_params=params)
        f_temp = f_temp[i1:i2]
        assert np.allclose(f, f_temp), f"Frequencies don't match:\n{f}\n{f_temp}"
        dir_spec = dir_spec[:, i1:i2] * f_temp.reshape(1, -1, 1, 1)
        dir_spec = np.moveaxis(dir_spec, 1, -1)  # (1, C, C, F)
        dir_spec[nan_mask] = np.nan
        res["dir_spec"] = dir_spec
    return res


# ------------------------------------------------------------- LFP filters

DEFAULT_MAD_THRESHOLD = 15.0
LOW_PASS_CUTOFF = 35.0
LOWCUT = 30.0
HIGHCUT = 55.0
Q = 2.0
ORDER = 3


def _apply_notch_filters(x, fs, q):
    """Remove 60 Hz electrical noise and harmonics (ref time_series.py:294-298)."""
    for i, freq in enumerate(range(60, int(fs / 2), 60)):
        b, a = iirnotch(freq, (i + 1) * q, fs)
        x = lfilter(b, a, x)
    return x


def filter_signal_via_bandpass(x, fs, lowcut=LOWCUT, highcut=HIGHCUT, q=Q,
                               order=ORDER, apply_notch_filters=True):
    """Butterworth bandpass + optional notch filters, NaN-transparent
    (ref time_series.py:263-301)."""
    assert x.ndim == 1 and lowcut < highcut
    x = np.array(x, dtype=np.float64, copy=True)
    nan_mask = np.isnan(x)
    x[nan_mask] = 0.0
    nyq = 0.5 * fs
    b, a = butter(order, [lowcut / nyq, highcut / nyq], btype="band")
    x = lfilter(b, a, x)
    if apply_notch_filters:
        x = _apply_notch_filters(x, fs, q)
    x[nan_mask] = np.nan
    return x


def filter_signal_via_lowpass(x, fs, cutoff=LOW_PASS_CUTOFF, q=Q, order=ORDER,
                              apply_notch_filters=True):
    """Butterworth lowpass + optional notch filters (ref time_series.py:303-338)."""
    assert x.ndim == 1
    x = np.array(x, dtype=np.float64, copy=True)
    nan_mask = np.isnan(x)
    x[nan_mask] = 0.0
    b, a = butter(order, cutoff / (0.5 * fs), btype="lowpass")
    x = lfilter(b, a, x)
    if apply_notch_filters:
        x = _apply_notch_filters(x, fs, q)
    x[nan_mask] = np.nan
    return x


def filter_signal(x, fs, cutoff=LOW_PASS_CUTOFF, lowcut=LOWCUT, highcut=HIGHCUT,
                  q=Q, order=ORDER, apply_notch_filters=True,
                  filter_type="bandpass"):
    if filter_type == "bandpass":
        return filter_signal_via_bandpass(
            x, fs, lowcut=lowcut, highcut=highcut, q=q, order=order,
            apply_notch_filters=apply_notch_filters)
    if filter_type == "lowpass":
        return filter_signal_via_lowpass(
            x, fs, cutoff=cutoff, q=q, order=order,
            apply_notch_filters=apply_notch_filters)
    raise NotImplementedError(filter_type)


def mark_outliers(lfps, fs, cutoff=LOW_PASS_CUTOFF, lowcut=LOWCUT,
                  highcut=HIGHCUT, mad_threshold=DEFAULT_MAD_THRESHOLD,
                  filter_type="bandpass"):
    """NaN-mask samples whose filtered magnitude exceeds mad_threshold median
    absolute deviations (ref time_series.py:351-390). lfps: dict of 1-D traces
    (modified copies returned) or a single 1-D array."""
    assert mad_threshold > 0.0, "mad_threshold must be positive!"
    single = not isinstance(lfps, dict)
    traces = {"_": lfps} if single else lfps
    out = {}
    for roi, sig in traces.items():
        trace = filter_signal(np.copy(sig), fs, cutoff=cutoff, lowcut=lowcut,
                              highcut=highcut, apply_notch_filters=False,
                              filter_type=filter_type)
        trace = np.abs(trace - np.median(trace))
        thresh = mad_threshold * np.median(trace)
        marked = np.array(sig, dtype=np.float64, copy=True)
        marked[trace > thresh] = np.nan
        out[roi] = marked
    return out["_"] if single else out


# ------------------------------------------------------------ window draws

def _window_hits_nan(start, window_size, nan_locations):
    nan_locations = np.asarray(nan_locations)
    if nan_locations.size == 0:
        return False
    # sorted-array range check (nan locations come from flatnonzero, sorted)
    lo = np.searchsorted(nan_locations, start, side="left")
    return lo < nan_locations.size and nan_locations[lo] <= start + window_size


def draw_timesteps_to_sample_from(interval_start, interval_stop, window_size,
                                  num_samples, nan_locations, max_num_draws=10,
                                  rng=None):
    """Draw non-NaN-overlapping window starts inside an interval; failed draws
    are retried up to max_num_draws then dropped (ref time_series.py:393-407)."""
    rng = rng or np.random.default_rng()
    lo, hi = interval_start, interval_stop - window_size
    starts = list(rng.choice(np.arange(lo, hi), size=num_samples, replace=False))
    for i in range(len(starts) - 1, -1, -1):
        if _window_hits_nan(starts[i], window_size, nan_locations):
            starts[i] = None
            for _ in range(max_num_draws):
                cand = int(rng.integers(lo, hi))
                if cand not in starts and not _window_hits_nan(
                        cand, window_size, nan_locations):
                    starts[i] = cand
                    break
            if starts[i] is None:
                starts.pop(i)
    return [int(s) for s in starts]


def draw_timesteps_to_sample_from_using_label_reference(
        labels, window_size, num_samples, nan_locations, max_num_draws=10,
        rng=None):
    """Like draw_timesteps_to_sample_from, additionally requiring the binary
    label trace to be active across the whole window (ref time_series.py:411-425)."""
    rng = rng or np.random.default_rng()
    labels = np.asarray(labels)
    hi = len(labels) - window_size

    def ok(start, others=()):
        return (start not in others
                and not _window_hits_nan(start, window_size, nan_locations)
                and labels[start: start + window_size].sum() == window_size)

    starts = list(rng.choice(np.arange(hi), size=num_samples, replace=False))
    for i in range(len(starts) - 1, -1, -1):
        if not ok(starts[i]):
            starts[i] = None
            for _ in range(max_num_draws):
                cand = int(rng.integers(0, hi))
                if ok(cand, starts):
                    starts[i] = cand
                    break
            if starts[i] is None:
                starts.pop(i)
    return [int(s) for s in starts]
