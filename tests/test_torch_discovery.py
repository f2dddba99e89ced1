"""The port's Table-2 discovery stack against the JAX package's: tidybench
(redcliff_tpu_torch/tidybench/: SLARAC, QRBS, LASAR, SELVAR with its native
C++ core and numpy twin), PCMCI and R-PCMCI (models/pcmci.py) and the
supervised-discovery evaluation (eval/supervised_discovery.py).

All of it is host code, copied: on the cases of tests/test_tidybench.py,
tests/test_selvar_golden.py, tests/test_rpcmci.py,
tests/test_supervised_discovery.py and the PCMCI half of
tests/test_pcmci_transformer.py, every score, lag, p-value, regime
assignment and statistic equals the JAX package's bit for bit. SELVAR is
held under both backends; the port's native library (built with g++ into
``build/host_native/``) equals the numpy twin at the golden tests' bars.
LASAR needs scikit-learn and skips inside its test without it.
"""
import importlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu.eval import supervised_discovery as JSD  # noqa: E402
from redcliff_tpu.models import pcmci as JP  # noqa: E402
import redcliff_tpu.tidybench as JTB  # noqa: E402
from redcliff_tpu_torch.eval import supervised_discovery as TSD  # noqa: E402
from redcliff_tpu_torch.models import pcmci as TP  # noqa: E402
from redcliff_tpu_torch.tidybench import native as TNAT  # noqa: E402
import redcliff_tpu_torch.tidybench as TTB  # noqa: E402

# the packages export the ``selvar`` function under the module's name
JSEL = importlib.import_module("redcliff_tpu.tidybench.selvar")
TSEL = importlib.import_module("redcliff_tpu_torch.tidybench.selvar")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_selvar_golden.py's bars between the two SELVAR backends
BACKENDS = dict(rtol=1e-8, atol=1e-10)


def same(got, want, path=""):
    """Equal bit for bit, recursively (NaN equals NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got, key=str) == sorted(
            want, key=str), path
        for k in want:
            same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype,
                                                           w.dtype)
        assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), path


def _var1(T=400, N=4, seed=0):
    """tests/test_tidybench.py's VAR(1) with a known sparse structure."""
    rng = np.random.default_rng(seed)
    A = np.zeros((N, N))
    A[0, 1], A[1, 2], A[3, 0] = 0.8, 0.7, 0.75
    for i in range(N):
        A[i, i] = 0.4
    X = np.zeros((T, N))
    X[0] = rng.normal(size=N)
    for t in range(1, T):
        X[t] = X[t - 1] @ A + 0.3 * rng.normal(size=N)
    return X


def _frozen_system():
    """tests/test_selvar_golden.py's 4-node VAR(2)."""
    rng = np.random.default_rng(1234)
    T, N = 120, 4
    X = np.zeros((T, N))
    eps = rng.normal(0, 0.3, (T, N))
    for t in range(2, T):
        X[t, 0] = 0.5 * X[t - 1, 0] + eps[t, 0]
        X[t, 1] = 0.8 * X[t - 1, 0] + 0.2 * X[t - 1, 1] + eps[t, 1]
        X[t, 2] = 0.5 * X[t - 1, 1] + 0.3 * X[t - 2, 2] + eps[t, 2]
        X[t, 3] = -0.7 * X[t - 2, 2] + 0.2 * X[t - 1, 3] + eps[t, 3]
    return X


def _long_lag_system():
    """tests/test_tidybench.py's adaptive long-lag regression system."""
    rng = np.random.default_rng(5)
    T, N = 80, 3
    X = np.zeros((T, N))
    X[:6] = rng.normal(size=(6, N))
    for t in range(6, T):
        X[t, 1] = 0.5 * X[t - 1, 1] + 0.3 * rng.normal()
        X[t, 2] = 0.5 * X[t - 1, 2] + 0.3 * rng.normal()
        X[t, 0] = 0.9 * X[t - 6, 1] + 0.2 * rng.normal()
    return X


@pytest.fixture(scope="module")
def var_data():
    return _var1()


@pytest.fixture(scope="module")
def native_lib():
    """The port's SELVAR library, built into build/host_native/, and the
    JAX package's, built beside its source (its own tests skip when it
    cannot be built, and so do these)."""
    lib = TNAT.load_native()
    if lib is None or importlib.import_module(
            "redcliff_tpu.tidybench.native").load_native() is None:
        pytest.skip("native toolchain unavailable")
    return lib


# ------------------------------------------------------------- tidybench

def test_exports_match_jax():
    assert TTB.__all__ == JTB.__all__


@pytest.mark.parametrize("kw", [
    dict(maxlags=2, n_subsamples=40, rng=0),
    dict(maxlags=1, n_subsamples=10, rng=0),
    dict(maxlags=1, n_subsamples=10, rng=0, post_zeroonescaling=True),
    dict(maxlags=1, n_subsamples=10, rng=0, post_edgeprior=True),
    dict(maxlags=1, n_subsamples=10, rng=0, post_standardise=True,
         pre_normalise=True),
    dict(maxlags=2, n_subsamples=5, rng=3, missing_values=0.0),
])
def test_slarac_equals_jax(var_data, kw):
    same(TTB.slarac(var_data, **kw), JTB.slarac(var_data, **kw))


@pytest.mark.parametrize("kw", [dict(lags=2, n_resamples=60, rng=0),
                                dict(lags=1, n_resamples=20, rng=1, q=0.5,
                                     post_standardise=True)])
def test_qrbs_equals_jax(var_data, kw):
    same(TTB.qrbs(var_data, **kw), JTB.qrbs(var_data, **kw))


def test_lasar_equals_jax(var_data):
    try:
        import sklearn  # noqa: F401
    except ImportError:
        pytest.skip("LASAR needs scikit-learn")
    kw = dict(maxlags=1, n_subsamples=3, cv=3, rng=0)
    same(TTB.lasar(var_data, **kw), JTB.lasar(var_data, **kw))


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("ml,bs,mxitr", [(1, -1, -1), (2, -2, -1),
                                         (-1, -1, 3)])
def test_slvar_equals_jax(var_data, backend, ml, bs, mxitr, request):
    if backend == "native":
        request.getfixturevalue("native_lib")
    X = var_data[:120]
    got = TSEL.slvar(X, batchsize=bs, maxlags=ml, mxitr=mxitr,
                     backend=backend)
    same(got, JSEL.slvar(X, batchsize=bs, maxlags=ml, mxitr=mxitr,
                         backend=backend))
    # and the two backends at the golden bars
    Bp, Ap, _ = TSEL._slvar_np(np.asarray(X, dtype=np.float64), bs, ml,
                               mxitr)
    np.testing.assert_array_equal(got[1], Ap)
    np.testing.assert_allclose(got[0], Bp, **BACKENDS)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_selvar_golden_system_equals_jax(backend, request):
    """The frozen VAR(2) of the golden tests: the hill climb, GTCOEF in
    every job, GTSTAT in every job, the PRESS statistic and the adaptive
    long-lag case, port against JAX under each backend."""
    if backend == "native":
        request.getfixturevalue("native_lib")
    X = _frozen_system()
    got = TSEL.slvar(X, batchsize=-1, maxlags=2, mxitr=-1, backend=backend)
    same(got, JSEL.slvar(X, batchsize=-1, maxlags=2, mxitr=-1,
                         backend=backend))
    A = got[1]
    for job in ("ABS", "SQR", "RAW"):
        for nrm in (0, 1):
            same(TSEL.gtcoef(X, A, maxlags=2, batchsize=-2, job=job,
                             nrm=nrm, backend=backend),
                 JSEL.gtcoef(X, A, maxlags=2, batchsize=-2, job=job,
                             nrm=nrm, backend=backend))
    for job in ("DF", "LR", "FS"):
        same(TSEL.gtstat(X, A, maxlags=2, job=job, backend=backend),
             JSEL.gtstat(X, A, maxlags=2, job=job, backend=backend))
    same(TTB.selvar(X, maxlags=2, backend=backend, post_standardise=True),
         JTB.selvar(X, maxlags=2, backend=backend, post_standardise=True))
    Y = _long_lag_system()
    same(TSEL.slvar(Y, batchsize=-1, maxlags=-1, mxitr=-1, backend=backend),
         JSEL.slvar(Y, batchsize=-1, maxlags=-1, mxitr=-1, backend=backend))
    A = np.zeros((3, 3), dtype=np.int32)
    A[1, 0] = 6
    same(TSEL.gtcoef(Y, A, backend=backend),
         JSEL.gtcoef(Y, A, backend=backend))


def test_press_equals_jax():
    X = _frozen_system()
    A = np.zeros((4, 4), dtype=np.int32)
    A[0, 1], A[1, 2], A[2, 3] = 1, 1, 2
    for j in range(4):
        same(TSEL._press_np(X, 2, [X.shape[0] - 2], A, j),
             JSEL._press_np(X, 2, [X.shape[0] - 2], A, j))


def test_native_backends_agree_at_golden_bars(native_lib, var_data):
    """The port's C++ core against its numpy twin: GTCOEF and GTSTAT on a
    random lag matrix (tests/test_tidybench.py's cases)."""
    X = var_data[:100]
    A = np.random.default_rng(1).integers(0, 3, size=(4, 4)).astype(
        np.int32)
    for job in ("ABS", "SQR", "RAW"):
        np.testing.assert_allclose(
            TSEL.gtcoef(X, A, maxlags=2, batchsize=-2, job=job,
                        backend="native"),
            TSEL._gtcoef_np(np.asarray(X, dtype=np.float64), 2, -2, A,
                            job=job), **BACKENDS)
    for job in ("DF", "LR", "FS"):
        Bn, DFn = TSEL.gtstat(X, A, maxlags=2, job=job, backend="native")
        Bp, DFp = TSEL.gtstat(X, A, maxlags=2, job=job, backend="numpy")
        np.testing.assert_allclose(Bn, Bp, **BACKENDS)
        np.testing.assert_array_equal(DFn, DFp)


def test_backend_semantics_without_a_library(monkeypatch, var_data):
    """``"native"`` raises when the library cannot be built (JAX
    selvar.py:185-193); ``"auto"`` falls back to the numpy core."""
    monkeypatch.setattr(TNAT, "load_native", lambda: None)
    X = var_data[:60]
    with pytest.raises(RuntimeError, match="could not be built"):
        TSEL.slvar(X, maxlags=1, backend="native")
    with pytest.raises(RuntimeError, match="could not be built"):
        TSEL.gtcoef(X, np.eye(4, dtype=np.int32), backend="native")
    with pytest.raises(RuntimeError, match="could not be built"):
        TSEL.gtstat(X, np.eye(4, dtype=np.int32), backend="native")
    same(TSEL.slvar(X, maxlags=1, backend="auto"),
         JSEL.slvar(X, maxlags=1, backend="numpy"))


def test_native_library_builds_into_build_dir_not_the_source_tree():
    assert TNAT.BUILD_DIR == os.path.join(REPO, "build", "host_native")
    src_dir = os.path.dirname(TNAT.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_two_processes_build_and_load_at_once(tmp_path):
    """Two processes build the library into one empty directory at the same
    time: both load a whole library and run SELVAR through it, and no
    temporary file is left."""
    code = """
import sys
import numpy as np
from redcliff_tpu_torch.tidybench import native
lib = native.build_library(sys.argv[1])
native._lib = lib
X = np.random.default_rng(0).normal(size=(60, 3))
B, A, info = native.slvar_native(X, -1, 1, -1)
print("OK", A.sum(), float(np.abs(B).sum()))
"""
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ,
                                                  PYTHONPATH=REPO))
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = [out.strip() for out, _ in outs]
    assert lines[0].startswith("OK") and lines[0] == lines[1]
    assert sorted(os.listdir(tmp_path)) == ["libselvar.lock", "libselvar.so"]


# ------------------------------------------------------------------ PCMCI

def _var_system(rng, T=800, noise=0.3):
    """tests/test_pcmci_transformer.py's 3-variable VAR(1)."""
    X = np.zeros((T, 3))
    for t in range(1, T):
        X[t, 0] = 0.5 * X[t - 1, 0] + rng.normal(scale=noise)
        X[t, 1] = 0.5 * X[t - 1, 1] + 0.6 * X[t - 1, 0] \
            + rng.normal(scale=noise)
        X[t, 2] = 0.5 * X[t - 1, 2] + 0.6 * X[t - 1, 1] \
            + rng.normal(scale=noise)
    return X


def test_parcorr_equals_jax():
    rng = np.random.default_rng(1)
    z = rng.normal(size=500)
    x = z + 0.3 * rng.normal(size=500)
    y = z + 0.3 * rng.normal(size=500)
    for args in ((x, y), (x, y, z), (x, y, np.stack([z, x * 0], 1)),
                 (x[:3], y[:3], np.stack([z[:3], z[:3]], 1)),
                 (np.zeros(5), y[:5])):
        same(TP.parcorr_test(*args), JP.parcorr_test(*args))


@pytest.mark.parametrize("case", ["single", "recordings", "shapes"])
def test_pcmci_equals_jax(case):
    if case == "single":
        data = _var_system(np.random.default_rng(3))
        kw = dict(tau_max=2, pc_alpha=0.2, alpha_level=0.01)
    elif case == "recordings":
        rng = np.random.default_rng(4)
        data = [_var_system(rng, T=150) for _ in range(5)]
        kw = dict(tau_max=1, alpha_level=0.01)
    else:
        data = np.random.default_rng(5).normal(size=(100, 4))
        kw = dict(tau_max=3, max_conds_dim=2, max_combinations=2)
    got, want = TP.pcmci(data, **kw), JP.pcmci(data, **kw)
    same(got, want)
    for ignore_lag in (True, False):
        same(TP.pcmci_val_graph(got, 0.01, ignore_lag),
             JP.pcmci_val_graph(want, 0.01, ignore_lag))


def _regime_recording(rng, driver):
    X = np.zeros((300, 3))
    for t in range(1, 300):
        for c in range(3):
            X[t, c] = 0.4 * X[t - 1, c] + rng.normal(scale=0.3)
        X[t, (driver + 1) % 3] += 0.7 * X[t - 1, driver]
    return X


def test_rpcmci_by_regime_equals_jax():
    rng = np.random.default_rng(6)
    recs = [_regime_recording(rng, d) for d in (0, 0, 1, 1)]
    kw = dict(num_regimes=3, tau_max=1, alpha_level=0.01)
    same(TP.rpcmci_by_regime(recs, [0, 0, 1, 1], **kw),
         JP.rpcmci_by_regime(recs, [0, 0, 1, 1], **kw))


def _var_recording(A, T, rng, noise=0.1):
    x = np.zeros((T, A.shape[0]))
    x[0] = rng.normal(size=A.shape[0])
    for t in range(1, T):
        x[t] = A @ x[t - 1] + noise * rng.normal(size=A.shape[0])
    return x


@pytest.fixture(scope="module")
def two_regime_recordings():
    """tests/test_rpcmci.py's recordings: x0 -> x1 or x1 -> x0."""
    A0 = np.array([[0.5, 0.0, 0.0], [0.8, 0.3, 0.0], [0.0, 0.0, 0.4]])
    A1 = np.array([[0.3, 0.8, 0.0], [0.0, 0.5, 0.0], [0.0, 0.0, 0.4]])
    rng = np.random.default_rng(0)
    return [_var_recording(A0 if i % 2 == 0 else A1, 80, rng)
            for i in range(16)]


@pytest.mark.parametrize("mode", ["recording", "short", "timestep",
                                  "switch"])
def test_rpcmci_equals_jax(two_regime_recordings, mode):
    """The regime assignment, per-regime results and total error of the
    unsupervised R-PCMCI, in both assignment modes."""
    recs, kw = two_regime_recordings, dict(num_regimes=2, tau_max=1, seed=0)
    if mode == "short":
        rng = np.random.default_rng(9)
        recs = [rng.normal(size=(1, 3))] + recs[:8] + [rng.normal(
            size=(1, 3))]
    elif mode == "timestep":
        recs = recs[:6]
        kw.update(assign_per="timestep", switching_penalty=10.0)
    elif mode == "switch":
        rng = np.random.default_rng(1)
        A0 = np.array([[0.5, 0.0], [0.9, 0.3]])
        A1 = np.array([[0.3, 0.9], [0.0, 0.5]])
        recs = [np.concatenate([_var_recording(A0, 150, rng),
                                _var_recording(A1, 150, rng)])]
        kw.update(assign_per="timestep", switching_penalty=5.0)
    same(TP.rpcmci(recs, **kw), JP.rpcmci(recs, **kw))


# ----------------------------------------------------- supervised discovery

@pytest.fixture
def seeded_default_rng(monkeypatch):
    """The flow calls SLARAC, QRBS and LASAR without an ``rng``, so each
    draws from fresh OS entropy in both packages; seed every such
    generator at 0 so the two packages draw the same numbers."""
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: default_rng(
                            0 if seed is None else seed))


def _two_regime_samples(rng, num_windows=8, T=120, noise=0.25):
    """tests/test_supervised_discovery.py's windows: regime 0 drives
    0 -> 1, regime 1 drives 1 -> 2."""
    samples = []
    for w in range(num_windows):
        regime = w % 2
        X = np.zeros((T, 3))
        for t in range(1, T):
            for c in range(3):
                X[t, c] = 0.4 * X[t - 1, c] + rng.normal(scale=noise)
            if regime == 0:
                X[t, 1] += 0.7 * X[t - 1, 0]
            else:
                X[t, 2] += 0.7 * X[t - 1, 1]
        y = np.zeros((2, T))
        y[regime, :] = 1.0
        samples.append((X, y))
    return samples


def _true_graphs():
    g0 = np.zeros((3, 3, 1))
    g0[1, 0, 0] = 1.0
    g1 = np.zeros((3, 3, 1))
    g1[2, 1, 0] = 1.0
    return [g0, g1]


def test_exports_and_data_preparation_match_jax():
    assert TSD.__all__ == JSD.__all__
    assert TSD.SUPPORTED_ALGORITHMS == JSD.SUPPORTED_ALGORITHMS
    samples = _two_regime_samples(np.random.default_rng(0), 4, 50)
    same(TSD.prepare_data_for_modeling(samples),
         JSD.prepare_data_for_modeling(samples))
    A = np.arange(18, dtype=float).reshape(3, 3, 2)
    for transpose in (False, True):
        same(TSD.standardized_off_diagonal_predictions(A, transpose),
             JSD.standardized_off_diagonal_predictions(A, transpose))


@pytest.mark.parametrize("alg", ["slarac", "qrbs", "lasar", "selvar",
                                 "PCMCI"])
def test_run_discovery_algorithm_equals_jax(alg, seeded_default_rng,
                                            request):
    if alg == "lasar":
        pytest.importorskip("sklearn", reason="LASAR needs scikit-learn")
    if alg == "selvar":  # "auto" in both packages: the native cores
        request.getfixturevalue("native_lib")
    samples = _two_regime_samples(np.random.default_rng(1), 4, 60)
    same(TSD.run_discovery_algorithm(samples, alg),
         JSD.run_discovery_algorithm(samples, alg))
    if alg == "PCMCI":
        same(TSD.run_discovery_algorithm(samples, alg, maxlags=1,
                                         pcmci_kwargs={"pc_alpha": 0.1}),
             JSD.run_discovery_algorithm(samples, alg, maxlags=1,
                                         pcmci_kwargs={"pc_alpha": 0.1}))


def test_score_discovery_predictions_equals_jax():
    rng = np.random.default_rng(2)
    truths = [np.asarray(g.sum(axis=2) > 0, dtype=int)
              for g in _true_graphs()]
    preds = [g.T + 0.01 * rng.uniform(size=(3, 3)) for g in truths]
    for transpose in (True, False):
        same(TSD.score_discovery_predictions(preds, truths, transpose),
             JSD.score_discovery_predictions(preds, truths, transpose))


@pytest.mark.parametrize("core", ["native", "numpy"])
def test_supervised_evaluation_equals_jax(tmp_path, core, request,
                                          monkeypatch, seeded_default_rng):
    """The Table-2 flow end to end; SELVAR's ``"auto"`` on the native core
    in both packages, then on the numpy core in both (no library), gives
    equal results, and the pickles are equal."""
    if core == "native":
        request.getfixturevalue("native_lib")
    else:
        for mod in (TNAT, importlib.import_module(
                "redcliff_tpu.tidybench.native")):
            monkeypatch.setattr(mod, "slvar_native", lambda *a, **kw: None)
    samples = _two_regime_samples(np.random.default_rng(3), 6, 100)
    algs = ("slarac", "qrbs", "selvar", "PCMCI")
    got = TSD.run_supervised_discovery_evaluation(
        samples, _true_graphs(), algorithms=algs,
        save_path=str(tmp_path / "t"))
    want = JSD.run_supervised_discovery_evaluation(
        samples, _true_graphs(), algorithms=algs,
        save_path=str(tmp_path / "j"))
    same(got, want)
    name = "supervised_discovery_summary.pkl"
    with open(tmp_path / "t" / name, "rb") as f:
        same(pickle.load(f), want)
    # an explicit maxlags (announced for PCMCI) in both
    same(TSD.run_supervised_discovery_evaluation(
            samples, _true_graphs(), algorithms=("selvar", "PCMCI"),
            maxlags=1),
         JSD.run_supervised_discovery_evaluation(
            samples, _true_graphs(), algorithms=("selvar", "PCMCI"),
            maxlags=1))


@pytest.fixture(scope="module")
def d4ic_like_samples():
    """tests/test_rpcmci.py's D4IC-like windows and their truths."""
    A0 = np.array([[0.5, 0.0, 0.0], [0.8, 0.3, 0.0], [0.0, 0.2, 0.4]])
    A1 = np.array([[0.3, 0.8, 0.0], [0.0, 0.5, 0.0], [0.6, 0.0, 0.4]])
    rng = np.random.default_rng(2)
    samples = []
    for i in range(16):
        k = i % 2
        x = _var_recording(A0 if k == 0 else A1, 60, rng)
        y = np.zeros((2, 60))
        y[k] = 1.0
        samples.append((x.astype(np.float32), y.astype(np.float32)))
    truths = [(np.abs(A) * (1 - np.eye(3)) > 0.1).astype(float)
              for A in (A0, A1)]
    return samples, truths


@pytest.mark.parametrize("regime_source,pred_source", [
    ("oracle", "graph"), ("oracle", "val_matrix"), ("learned", "graph")])
def test_d4ic_regime_experiment_equals_jax(d4ic_like_samples, regime_source,
                                           pred_source):
    samples, truths = d4ic_like_samples
    kw = dict(regime_source=regime_source, pred_source=pred_source,
              transpose=True, tau_max=2)
    same(TSD.run_d4ic_regime_pcmci_experiment(samples, truths, **kw),
         JSD.run_d4ic_regime_pcmci_experiment(samples, truths, **kw))


def test_unsupported_names_raise_as_in_jax(d4ic_like_samples):
    samples, truths = d4ic_like_samples
    for mod in (TSD, JSD):
        with pytest.raises(ValueError, match="unsupported algorithm"):
            mod.run_discovery_algorithm(samples[:2], "granger")
        with pytest.raises(ValueError, match="unsupported pred_source"):
            mod.run_d4ic_regime_pcmci_experiment(samples[:4], truths,
                                                 pred_source="raw")
        with pytest.raises(ValueError, match="unsupported regime_source"):
            mod.run_d4ic_regime_pcmci_experiment(samples[:4], truths,
                                                 regime_source="guess")
