"""The port's feature layer (redcliff_tpu_torch/utils/{directed_spectrum,
time_series,misc}.py and the feature formats of data/shards.py) against
the JAX package.

These are host numpy/scipy copies of the JAX modules, so every output is
held bit for bit (``assert_array_equal``, which counts NaNs in the same
places as equal): the directed spectrum and the CSD power features of
every signal format, a NaN window among them, the stationary wavelet
transform and its inverse, the triangular (un)squeeze, the
directed-spectrum feature (un)flattening, and the fold loader's
``wavelet_decomp`` and feature branches.
"""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu.data import shards as jshards  # noqa: E402
from redcliff_tpu.utils import directed_spectrum as jds  # noqa: E402
from redcliff_tpu.utils import misc as jmisc  # noqa: E402
from redcliff_tpu.utils import time_series as jts  # noqa: E402
from redcliff_tpu_torch.data import shards as tshards  # noqa: E402
from redcliff_tpu_torch.utils import directed_spectrum as tds  # noqa: E402
from redcliff_tpu_torch.utils import misc as tmisc  # noqa: E402
from redcliff_tpu_torch.utils import time_series as tts  # noqa: E402

C, T, NNF = 4, 24, 16

# the DCSFA cached-args' directed-spectrum parameters
# (utils/config.py DCSFA schema), at num_node_features = NNF
DIRSPEC = {"fs": 1000, "min_freq": 0.0, "max_freq": 250.0,
           "directed_spectrum": True,
           "csd_params": {"detrend": "constant", "window": "hann",
                          "nperseg": NNF // 2, "noverlap": NNF // 4,
                          "nfft": None}}
FORMATS = ["original", "wavelet_decomp", "flattened", "directed_spectrum",
           "directed_spectrum vanilla",
           "original flattened directed_spectrum vanilla"]


def _windows(n=6, seed=0, nan_window=None):
    rng = np.random.default_rng(seed)
    X = np.zeros((n, T, C))
    A = 0.4 * rng.normal(size=(C, C)) / np.sqrt(C)
    for t in range(1, T):
        X[:, t] = X[:, t - 1] @ A.T + rng.normal(size=(n, C))
    X = X.astype(np.float32)
    if nan_window is not None:
        X[nan_window, 3, 1] = np.nan
    return X


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


@pytest.mark.parametrize("signal_format", FORMATS)
def test_signal_formats_equal_jax(signal_format):
    """Every feature format of ``apply_signal_format`` on the same windows,
    one of them NaN-bearing: the same array, bit for bit."""
    X = _windows(nan_window=2)
    kw = dict(max_num_features_per_series=NNF, dirspec_params=DIRSPEC)
    want = _quiet(jshards.apply_signal_format, X, signal_format, **kw)
    got = _quiet(tshards.apply_signal_format, X, signal_format, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if "directed_spectrum" in signal_format:
        F = want.shape[1] // (C * C if "vanilla" in signal_format
                              else C * (2 * C - 1))
        assert F > 0 and want.shape == (len(X), want.shape[1])
        assert np.isnan(got[2]).all() and np.isfinite(got[[0, 1, 3]]).all()


def test_power_features_raise_in_both():
    X = _windows()
    for pkg in (jshards, tshards):
        with pytest.raises(NotImplementedError, match="power_features"):
            pkg.apply_signal_format(X, "power_features")
        with pytest.raises(ValueError, match="unknown signal_format"):
            pkg.apply_signal_format(X, "mystery")


@pytest.mark.parametrize("pairwise", [True, False])
def test_directed_spectrum_and_high_level_features_equal_jax(pairwise):
    """The directed spectrum (pairwise and full factorization) and the
    high-level features (power, frequencies, directed spectrum)."""
    X = _windows(n=3, seed=1).transpose(0, 2, 1).astype(np.float64)
    params = dict(DIRSPEC["csd_params"])
    want = _quiet(jds.get_directed_spectrum, X, 1000, pairwise=pairwise,
                  csd_params=params)
    got = _quiet(tds.get_directed_spectrum, X, 1000, pairwise=pairwise,
                 csd_params=params)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    x = _windows(n=1, seed=2)[0]
    want = _quiet(jts.make_high_level_signal_features, x, fs=1000,
                  max_freq=250.0, directed_spectrum=True, csd_params=params)
    got = _quiet(tts.make_high_level_signal_features, x, fs=1000,
                 max_freq=250.0, directed_spectrum=True, csd_params=params)
    assert sorted(got) == sorted(want) == ["dir_spec", "freq", "power"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_single_segment_windows_warn_singular_as_in_jax():
    """One Welch segment per window (nperseg = the window length, the
    published d4IC DCSFA setting) makes every CPSD matrix rank one: both
    packages warn and regularize alike."""
    x = _windows(n=1, seed=3)[0, :NNF]
    params = dict(DIRSPEC["csd_params"], nperseg=NNF, noverlap=NNF // 2)
    out = {}
    for name, mod in (("jax", jts), ("port", tts)):
        with pytest.warns(UserWarning, match="CPSD matrix is singular"):
            out[name] = mod.make_high_level_signal_features(
                x, fs=1000, max_freq=250.0, directed_spectrum=True,
                csd_params=params)
    np.testing.assert_array_equal(out["port"]["dir_spec"],
                                  out["jax"]["dir_spec"])
    # frequencies k * 1000 / 16 below max_freq 250: 0, 62.5, 125, 187.5
    assert out["port"]["dir_spec"].shape == (1, C, C, 4)


@pytest.mark.parametrize("wavelet", ["db1", "db2", "db4"])
def test_swt_iswt_and_decomposition_equal_jax(wavelet):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 32))
    bands_j = jts.swt(x, wavelet, level=3)
    bands_t = tts.swt(x, wavelet, level=3)
    assert len(bands_t) == len(bands_j) == 4
    for g, w in zip(bands_t, bands_j):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tts.iswt(bands_t, wavelet),
                                  jts.iswt(bands_j, wavelet))
    X = _windows(n=4, seed=5)
    np.testing.assert_array_equal(
        tshards.decompose_windows(X, 2, wavelet),
        jshards.decompose_windows(X, 2, wavelet))


def test_triangular_and_dirspec_flattening_equal_jax():
    rng = np.random.default_rng(6)
    sym = rng.normal(size=(5, 5, 3))
    sym = sym + sym.transpose(1, 0, 2)
    sq = tts.squeeze_triangular_array(sym, dims=(0, 1))
    np.testing.assert_array_equal(sq, jts.squeeze_triangular_array(
        sym, dims=(0, 1)))
    np.testing.assert_array_equal(tts.unsqueeze_triangular_array(sq, 0),
                                  jts.unsqueeze_triangular_array(sq, 0))
    ds = rng.normal(size=(C, C, 3))
    flat = tmisc.flatten_directed_spectrum_features(ds)
    np.testing.assert_array_equal(
        flat, jmisc.flatten_directed_spectrum_features(ds))
    for acc in (False, True):
        np.testing.assert_array_equal(
            tmisc.unflatten_directed_spectrum_features(flat, acc),
            jmisc.unflatten_directed_spectrum_features(flat, acc))
    np.testing.assert_array_equal(
        tmisc.unflatten_directed_spectrum_features(flat), ds)


@pytest.mark.parametrize("signal_format,wavelet_level",
                         [("wavelet_decomp", 2),
                          ("original flattened directed_spectrum vanilla",
                           None),
                          ("directed_spectrum", None)])
def test_fold_loader_feature_branches_equal_jax(tmp_path, signal_format,
                                                wavelet_level):
    """``load_normalized_split_datasets`` with a feature format: the same
    windows and ``X_features`` as the JAX loader; with ``device`` the
    features are placed there as ``device_features``."""
    X = _windows(n=10, seed=7)
    pairs = [[x, np.eye(2, dtype=np.float32)[i % 2][:, None]]
             for i, x in enumerate(X)]
    tshards.save_cv_split(pairs[:6], pairs[6:], 0, str(tmp_path))
    root = os.path.join(str(tmp_path), "fold_0")
    kw = dict(signal_format=signal_format, max_num_features_per_series=NNF,
              dirspec_params=DIRSPEC, wavelet_level=wavelet_level,
              grid_search=False)
    want = _quiet(jshards.load_normalized_split_datasets, root, **kw)
    got = _quiet(tshards.load_normalized_split_datasets, root,
                 device="cpu", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.X, w.X)
        np.testing.assert_array_equal(g.Y, w.Y)
        np.testing.assert_array_equal(g.X_features, w.X_features)
        if wavelet_level:  # the windows are the features
            assert g.X_features is g.X and not hasattr(g, "device_features")
        else:
            np.testing.assert_array_equal(g.device_features.numpy(),
                                          w.X_features)
