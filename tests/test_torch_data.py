"""The port's data layer (redcliff_tpu_torch/data/{synthetic,curation,
dream4,lfp}.py, utils/{metrics,misc}.py helpers, data/__init__.py) against
the JAX package's.

Host code is a copy and is held bit for bit: the graph factory, the numpy
generator, a curated fold, the DREAM4 and LFP curation on small files the
tests write themselves (the cases of tests/test_data_layer.py). The device
generator's body is fed the JAX package's own draws, regenerated from the
same keys in JAX's split order, and held to ``generate_synthetic_batch``
per recording at ``max|dx| <= 1e-5 * max|x_jax|`` (a 2-lag recurrence over
burnin + T steps in float32, in another summation order) with Oracle labels
within 1e-6; its own draws come from a ``torch.Generator`` and are held to
JAX in distribution only. The graph factory seeds Python ``random`` and
``np.random`` process-wide, in both packages: each test here restores both
states afterwards.
"""
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as scio

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu import data as jdata  # noqa: E402
from redcliff_tpu.data import curation as jcur  # noqa: E402
from redcliff_tpu.data import dream4 as jd4  # noqa: E402
from redcliff_tpu.data import lfp as jlfp  # noqa: E402
from redcliff_tpu.data import synthetic as JS  # noqa: E402
from redcliff_tpu.utils import metrics as jmetrics  # noqa: E402
from redcliff_tpu.utils import misc as jmisc  # noqa: E402
from redcliff_tpu_torch.data import curation as tcur  # noqa: E402
from redcliff_tpu_torch.data import dream4 as td4  # noqa: E402
from redcliff_tpu_torch.data import lfp as tlfp  # noqa: E402
from redcliff_tpu_torch.data import synthetic as TS  # noqa: E402
from redcliff_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from redcliff_tpu_torch.utils import misc as tmisc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the device body against generate_synthetic_batch: per recording, relative
# to the recording's largest JAX amplitude; labels absolute
BODY_REL = 1e-5
LABEL_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _restore_global_rngs():
    """The graph factory seeds ``random`` and ``np.random`` globally (the
    reference's semantics); leave both as they were."""
    py_state, np_state = random.getstate(), np.random.get_state()
    yield
    random.setstate(py_state)
    np.random.set_state(np_state)


def _factory(mod, **kw):
    p = mod.reference_curation_params(kw.pop("num_nodes"))
    return p, mod.generate_lagged_adjacency_graphs_for_factor_model(
        num_nodes=len(p["base_freqs"]), num_lags=2,
        off_diag_edge_strengths=p["off_diag_edge_strengths"],
        diag_receiving_node_forgetting_coeffs=
            p["diag_receiving_node_forgetting_coeffs"],
        diag_sending_node_forgetting_coeffs=
            p["diag_sending_node_forgetting_coeffs"], **kw)


FACTORY_CASES = {
    "orthogonal_auto_edges": dict(num_nodes=6, num_factors=2,
                                  make_factors_orthogonal=True,
                                  make_factors_singular_components=False),
    "orthogonal_2_edges": dict(num_nodes=6, num_factors=2,
                               make_factors_orthogonal=True,
                               make_factors_singular_components=False,
                               num_edges_per_graph=2),
    "not_orthogonal_13_edges": dict(num_nodes=10, num_factors=1,
                                    make_factors_orthogonal=False,
                                    make_factors_singular_components=False,
                                    num_edges_per_graph=13),
    "singular_nonlinear_3_factors": dict(
        num_nodes=5, num_factors=3, make_factors_orthogonal=False,
        make_factors_singular_components=True, num_edges_per_graph=6,
        nonlinear_act_codes_per_factor=[(1, 2), None, (2, 0)]),
}


@pytest.mark.parametrize("seed", [0, 7, 333])
@pytest.mark.parametrize("case", sorted(FACTORY_CASES))
def test_graph_factory_bit_identical(case, seed):
    _, (jg, ja, ji) = _factory(JS, rand_seed=seed, **FACTORY_CASES[case])
    j_after = (random.random(), np.random.random())
    _, (tg, ta, ti) = _factory(TS, rand_seed=seed, **FACTORY_CASES[case])
    t_after = (random.random(), np.random.random())
    assert ji == ti and j_after == t_after
    for a, b in zip(jg + ja, tg + ta):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_graph_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        A = (rng.random((7, 7)) < 0.2).astype(float)
        for add in (True, False):
            assert (tmetrics.get_number_of_connected_components(A, add)
                    == jmetrics.get_number_of_connected_components(A, add))
    data = [rng.normal(size=(3, 2)) for _ in range(23)]
    labels = [np.array([i % 2, 1 - i % 2]) for i in range(23)]
    jf = jmisc.make_kfolds_cv_splits(data, labels, num_folds=5)
    tf = tmisc.make_kfolds_cv_splits(data, labels, num_folds=5)
    assert jf.keys() == tf.keys()
    for k in jf:
        for split in ("train", "validation"):
            assert len(jf[k][split]) == len(tf[k][split])
            for (jx, jy), (tx, ty) in zip(jf[k][split], tf[k][split]):
                assert jx is tx and jy is ty


def _system(mod, num_factors=3, seed=3, nonlinear=False):
    p, (graphs, acts, _) = _factory(
        mod, num_nodes=4, num_factors=num_factors,
        make_factors_orthogonal=False,
        make_factors_singular_components=False, rand_seed=seed,
        nonlinear_act_codes_per_factor=(
            [(1, 2)] * num_factors if nonlinear else None))
    return p, graphs, acts


GEN_CASES = {
    "oracle_white": dict(label_type="Oracle", noise_type="white",
                         num_labeled_sys_states=3),
    "onehot_gaussian": dict(label_type="OneHot", noise_type="gaussian",
                            num_labeled_sys_states=3, noise_amp=1.0),
    "pooled_oracle_white": dict(label_type="Oracle", noise_type="white",
                                num_labeled_sys_states=1),
    "pooled_onehot_gaussian_nonlinear": dict(
        label_type="OneHot", noise_type="gaussian", num_labeled_sys_states=2,
        nonlinear=True),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_host_generator_bit_identical(case):
    kw = dict(GEN_CASES[case])
    nonlinear = kw.pop("nonlinear", False)
    p, graphs, acts = _system(TS, nonlinear=nonlinear)
    common = dict(base_freqs=p["base_freqs"], noise_mu=p["noise_mu"],
                  noise_var=p["noise_var"],
                  innovation_amp=0.5 * p["innovation_amp"], num_samples=5,
                  recording_length=30, burnin_period=7, **kw)
    jX, jY = JS.generate_synthetic_data_np(np.random.default_rng(11),
                                           graphs, acts, **common)
    tX, tY = TS.generate_synthetic_data_np(np.random.default_rng(11),
                                           graphs, acts, **common)
    assert jX.dtype == tX.dtype == np.float32 and jY.dtype == tY.dtype
    assert np.array_equal(jX, tX) and np.array_equal(jY, tY)
    jr = JS.rollout_np(graphs[0], acts[0], p["base_freqs"], p["noise_mu"],
                       p["noise_var"], p["innovation_amp"], 40, 10,
                       np.random.default_rng(2))
    tr = TS.rollout_np(graphs[0], acts[0], p["base_freqs"], p["noise_mu"],
                       p["noise_var"], p["innovation_amp"], 40, 10,
                       np.random.default_rng(2))
    assert np.array_equal(jr, tr)


def _read_tree(root):
    """Every file under ``root``: cached-args text as text, shards
    unpickled."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".pkl"):
                with open(path, "rb") as f:
                    out[rel] = pickle.load(f)
            else:
                with open(path) as f:
                    out[rel] = f.read()
    return out


def test_curated_fold_equals_jax(tmp_path):
    """The same save root for both packages, one after the other: the
    cached-args text (with the fold path and the stringified graphs) and
    every shard's [x, y] pairs equal JAX's."""
    kw = dict(fold_id=1, num_nodes=6, num_factors=2,
              num_supervised_factors=2, num_edges_per_graph=2,
              num_samples_in_train_set=12, num_samples_in_val_set=5,
              sample_recording_len=20, burnin_period=10,
              label_type_setting="OneHot", noise_type="gaussian",
              noise_level=1.0, num_samples_per_file=5)
    root = str(tmp_path / "data")
    jdir, jgraphs = jcur.curate_synthetic_fold(root, **kw)
    jtree = _read_tree(root)
    import shutil
    shutil.rmtree(root)
    tdir, tgraphs = tcur.curate_synthetic_fold(root, **kw)
    ttree = _read_tree(root)
    assert jdir == tdir and jtree.keys() == ttree.keys()
    assert sum("subset_" in k for k in ttree) == 3 + 1
    for k, v in jtree.items():
        if isinstance(v, str):
            assert v == ttree[k], k
        else:
            assert len(v) == len(ttree[k])
            for (jx, jy), (tx, ty) in zip(v, ttree[k]):
                assert np.array_equal(jx, tx) and np.array_equal(jy, ty)
    for a, b in zip(jgraphs, tgraphs):
        assert np.array_equal(a, b)
    assert tcur.experiment_folder_name(2, 2, 6, 2, "Linear", "OneHot",
                                       "gaussian", 1.0) == \
        jcur.experiment_folder_name(2, 2, 6, 2, "Linear", "OneHot",
                                    "gaussian", 1.0)


def _jax_unit_draws(key, N, S, T, burnin, D, noise_type):
    """The unit variates ``generate_synthetic_dataset(key, ...)`` draws,
    regenerated in its split order (dataset :224, batch :159, rollout
    :118-126, ramps :170-171, measurement :191-197), laid out as
    ``draw_synthetic_noise`` lays out its own."""
    x0, n1, steps, ramps, meas = [], [], [], [], []
    for k in jax.random.split(key, N):
        keys = jax.random.split(k, S + 2)
        row = [[], [], [], []]
        for i in range(S):
            k0, k1, kseq = jax.random.split(keys[i], 3)
            row[0].append(np.asarray(jax.random.uniform(k0, (D,))))
            row[1].append(np.asarray(jax.random.normal(k1, (D,))))
            row[2].append(np.asarray(
                jax.random.normal(kseq, (T + burnin, D))))
            row[3].append(np.asarray(jax.random.uniform(
                jax.random.fold_in(keys[i], 1), (2,))))
        x0.append(row[0])
        n1.append(row[1])
        steps.append(row[2])
        ramps.append(row[3])
        draw = (jax.random.uniform if noise_type == "white"
                else jax.random.normal)
        meas.append(np.asarray(draw(keys[-1], (T, D))))
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return {"x0": as_t(x0), "innov1": as_t(n1),
            "steps": as_t(np.transpose(np.asarray(steps), (2, 0, 1, 3))),
            "ramps": as_t(ramps), "meas": as_t(meas)}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_device_body_on_jax_draws_matches_jax(case):
    kw = dict(GEN_CASES[case])
    nonlinear = kw.pop("nonlinear", False)
    p, graphs, acts = _system(TS, nonlinear=nonlinear)
    N, T, burnin = 6, 30, 12
    amp = 0.5 * p["innovation_amp"]
    key = jax.random.PRNGKey(5)
    jX, jY = JS.generate_synthetic_dataset(
        key, graphs, acts, p["base_freqs"], p["noise_mu"], p["noise_var"],
        amp, num_samples=N, recording_length=T, burnin_period=burnin, **kw)
    draws = _jax_unit_draws(key, N, len(graphs), T, burnin, 4,
                            kw["noise_type"])
    M1, M2, codes, base = TS.stack_systems(graphs, acts, p["base_freqs"],
                                           p["noise_mu"], p["noise_var"], amp)
    tX, tY = TS.synthetic_batch_body(M1, M2, codes, base, draws, T, burnin,
                                     **kw)
    tX, tY = tX.numpy(), tY.numpy()
    assert tX.shape == jX.shape and tY.shape == jY.shape
    assert tX.dtype == jX.dtype == np.float32 and tY.dtype == np.float32
    for n in range(N):
        err = np.abs(tX[n] - jX[n]).max()
        assert err <= BODY_REL * np.abs(jX[n]).max(), (n, err)
    if kw["label_type"] == "Oracle":
        np.testing.assert_allclose(tY, jY, rtol=0, atol=LABEL_ATOL)
    else:
        # a one-hot label may flip only where the two largest pooled ramps
        # lie within the label bar of each other: count and exclude those
        oracle = dict(kw, label_type="Oracle")
        _, tO = TS.synthetic_batch_body(M1, M2, codes, base, draws, T,
                                        burnin, **oracle)
        top2 = np.sort(tO.numpy(), axis=1)[:, -2:, :]
        ties = (top2[:, 1] - top2[:, 0]) <= LABEL_ATOL
        assert ties.sum() <= 1
        np.testing.assert_array_equal(
            np.moveaxis(tY, 1, 2)[~ties], np.moveaxis(jY, 1, 2)[~ties])


def test_device_generator_own_draws_in_distribution():
    """The port's own draws (a torch.Generator) against the JAX dataset of
    the same size: the same shapes and dtypes, reproducible per seed, and
    the same distribution (per-channel mean and spread, label means)."""
    p, graphs, acts = _system(TS, num_factors=2, nonlinear=False)
    common = dict(base_freqs=p["base_freqs"], noise_mu=p["noise_mu"],
                  noise_var=p["noise_var"],
                  innovation_amp=0.5 * p["innovation_amp"], num_samples=256,
                  recording_length=40, burnin_period=10,
                  num_labeled_sys_states=2, label_type="Oracle",
                  noise_type="gaussian")
    jX, jY = JS.generate_synthetic_dataset(jax.random.PRNGKey(3), graphs,
                                           acts, **common)
    tX, tY = TS.generate_synthetic_dataset(
        torch.Generator().manual_seed(3), graphs, acts, device="cpu",
        **common)
    tX2, _ = TS.generate_synthetic_dataset(
        torch.Generator().manual_seed(3), graphs, acts, device="cpu",
        **common)
    assert tX.shape == jX.shape and tY.shape == jY.shape
    assert tX.dtype == np.float32 and tY.dtype == np.float32
    assert np.array_equal(tX, tX2) and np.isfinite(tX).all()
    # recordings are independent, steps within one are not: the standard
    # error of a channel's mean comes from the per-recording means
    jm, tm = jX.mean(axis=1), tX.mean(axis=1)
    se = np.sqrt((jm.var(axis=0) + tm.var(axis=0)) / len(jm))
    assert np.all(np.abs(jm.mean(axis=0) - tm.mean(axis=0)) < 4 * se)
    jstd, tstd = jX.std(axis=(0, 1)), tX.std(axis=(0, 1))
    assert np.all(np.abs(tstd / jstd - 1.0) < 0.15)
    assert abs(jY.mean() - tY.mean()) < 0.05
    assert 0.0 <= tY.min() and tY.max() <= 1.0 + 1e-6


def test_device_generator_raises_without_cuda_by_default(monkeypatch):
    p, graphs, acts = _system(TS, num_factors=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.generate_synthetic_dataset(
            torch.Generator(), graphs, acts, p["base_freqs"], p["noise_mu"],
            p["noise_var"], p["innovation_amp"], 2, 10, 5, 1)


@pytest.mark.gpu
def test_device_body_on_card_matches_cpu():
    """The body on the card against the CPU on the same draws (made on the
    card, copied to the CPU), at one D4IC network's size and the synSys
    OneHot gaussian case at a reduced count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for nodes, factors, n, T, label, noise in (
            (10, 1, 150, 48, "Oracle", "gaussian"),
            (6, 2, 256, 100, "OneHot", "gaussian")):
        p, (graphs, acts, _) = _factory(
            TS, num_nodes=nodes, num_factors=factors,
            make_factors_orthogonal=factors > 1,
            make_factors_singular_components=False, rand_seed=1)
        gen = torch.Generator(device="cuda").manual_seed(0)
        draws = TS.draw_synthetic_noise(gen, n, factors, T, 50, nodes,
                                        noise_type=noise, device="cuda")
        outs = {}
        for dev in ("cuda", "cpu"):
            M1, M2, codes, base = TS.stack_systems(
                graphs, acts, p["base_freqs"], p["noise_mu"], p["noise_var"],
                p["innovation_amp"], device=dev)
            d = {k: v.to(dev) for k, v in draws.items()}
            X, Y = TS.synthetic_batch_body(M1, M2, codes, base, d, T, 50,
                                           factors, label_type=label,
                                           noise_type=noise, noise_amp=1.0)
            outs[dev] = (X.cpu().numpy(), Y.cpu().numpy())
        (gX, gY), (cX, cY) = outs["cuda"], outs["cpu"]
        for i in range(n):
            assert np.abs(gX[i] - cX[i]).max() <= BODY_REL * np.abs(
                cX[i]).max()
        if label == "Oracle":
            np.testing.assert_allclose(gY, cY, rtol=0, atol=LABEL_ATOL)
        else:
            assert np.mean(gY != cY) < 1e-3


# ----------------------------------------------------------- DREAM4

def _write_dream4_tsv(path, num_recordings=5, num_channels=10, rng=None):
    rng = rng or np.random.default_rng(0)
    lines = ["\t".join(['"Time"'] + [f'"G{i+1}"' for i in range(num_channels)])]
    for _ in range(num_recordings):
        rec = rng.uniform(size=(21, num_channels))
        for t in range(21):
            lines.append("\t".join([str(t * 50)]
                                   + [f"{v:.6f}" for v in rec[t]]))
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _build_network_dirs(root, num_nets=3):
    rng = np.random.default_rng(1)
    for n in range(num_nets):
        d = os.path.join(root, f"insilico_size10_{n+1}")
        os.makedirs(d)
        _write_dream4_tsv(os.path.join(
            d, f"insilico_size10_{n+1}_timeseries.tsv"), rng=rng)
    return root


def _assert_trees_equal(a_root, b_root):
    a, b = _read_tree(a_root), _read_tree(b_root)
    assert a.keys() == b.keys() and a

    def eq(x, y):
        if isinstance(x, np.ndarray):
            return (isinstance(y, np.ndarray) and x.dtype == y.dtype
                    and np.array_equal(x, y))
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(eq, x, y))
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(eq(x[k], y[k]) for k in x)
        return x == y

    for k in a:
        assert eq(a[k], b[k]), k


@pytest.mark.parametrize("perspective", [False, True])
def test_parse_dream4_equals_jax(tmp_path, perspective):
    p = str(tmp_path / "insilico_size10_1_timeseries.tsv")
    _write_dream4_tsv(p)
    jts, jl, jm = jd4.parse_dream4_timeseries(p, perspective)
    tts, tl, tm = td4.parse_dream4_timeseries(p, perspective)
    assert jm == tm and len(jts) == len(tts) == 5 * (1 + perspective)
    for a, b, c, d in zip(jts, tts, jl, tl):
        assert np.array_equal(a, b) and np.array_equal(c, d)


def test_dream4_datasets_and_d4ic_fold_equal_jax(tmp_path):
    """The individual, superpositional and combo curation write the same
    shards in both packages; the D4IC fold at each SNR tier too."""
    tsv = str(tmp_path / "ts.tsv")
    _write_dream4_tsv(tsv)
    orig = _build_network_dirs(str(tmp_path / "orig"))
    for name, mod in (("j", jd4), ("t", td4)):
        ind = str(tmp_path / name / "size10_ind")
        os.makedirs(ind)
        mod.make_dream4_individual_dataset(tsv, ind, state_label_setting=True)
        pre = str(tmp_path / name / "size10_pre")
        os.makedirs(pre)
        mod.make_dream4_single_dominant_superpositional_dataset(
            orig, pre, state_label_setting=False, dominant_net_coeff=1.0,
            background_net_coeff=0.0)
        for tier in sorted(mod.D4IC_SNR_TIERS):
            mod.make_d4ic_fold(pre, str(tmp_path / name / f"d4ic_{tier}"),
                               fold_id=1, num_factors=3, snr_tier=tier)
    assert td4.D4IC_SNR_TIERS == jd4.D4IC_SNR_TIERS
    _assert_trees_equal(str(tmp_path / "j"), str(tmp_path / "t"))


# ----------------------------------------------------------- LFP

def _write_lfp_mat(path, channels, T, rng, spike_at=None):
    data = {}
    for c in channels:
        sig = rng.normal(0.0, 1.0, size=T)
        if spike_at is not None:
            sig[spike_at] = 500.0
        data[c] = sig.reshape(1, -1)
    scio.savemat(path, data)


def test_lfp_matrix_keys_and_windows_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    chans = ["Amy_01", "Cortex_01", "Hipp_01"]
    _write_lfp_mat(str(tmp_path / "m1_d1_LFP.mat"), chans, 4000, rng,
                   spike_at=1234)
    _write_lfp_mat(str(tmp_path / "m2_d1_LFP.mat"), chans + ["Extra"], 4000,
                   rng)
    files = ["m1_d1_LFP.mat", "m2_d1_LFP.mat"]
    keys = jlfp.determine_keys_of_interest(files, str(tmp_path))
    assert tlfp.determine_keys_of_interest(files, str(tmp_path)) == keys
    for filter_type in ("lowpass", "bandpass"):
        jm = jlfp.load_lfp_data_matrix(str(tmp_path), files[0], keys, 3,
                                       filter_type=filter_type)
        tm = tlfp.load_lfp_data_matrix(str(tmp_path), files[0], keys, 3,
                                       filter_type=filter_type)
        assert np.array_equal(jm, tm, equal_nan=True)
        assert np.isnan(tm).any()
    epochs = [(0, 2000, [1.0, 0.0]), (2000, 4000, [0.0, 1.0])]
    jw = jlfp.extract_epoch_windows(jm, epochs, 500, 3, 10,
                                    rng=np.random.default_rng(0))
    tw = tlfp.extract_epoch_windows(tm, epochs, 500, 3, 10,
                                    rng=np.random.default_rng(0))
    assert jw.keys() == tw.keys() and sum(map(len, tw.values())) > 0
    for k in jw:
        for (a, la), (b, lb) in zip(jw[k], tw[k]):
            assert np.array_equal(a, b) and np.array_equal(la, lb)


def test_tst_and_socpref_preprocessing_equal_jax(tmp_path):
    rng = np.random.default_rng(9)
    for name in ("MouseA_2020_01_01_run01", "MouseB_2020_01_01_run01"):
        os.makedirs(tmp_path / "tst_lfp", exist_ok=True)
        os.makedirs(tmp_path / "tst_lab", exist_ok=True)
        _write_lfp_mat(str(tmp_path / "tst_lfp" / f"{name}_LFP.mat"),
                       ["Amy_01", "Cortex_01"], 400 * 1000, rng)
        scio.savemat(str(tmp_path / "tst_lab" / f"{name}_TIME.mat"),
                     {"INT_TIME": np.array([[305, 40, 350, 40]])})
    os.makedirs(tmp_path / "sp_lfp")
    os.makedirs(tmp_path / "sp_lab")
    T, name = 20000, "MouseC_2020_02_02_run01"
    ramp = np.arange(T, dtype=float)
    scio.savemat(str(tmp_path / "sp_lfp" / f"{name}_LFP.mat"),
                 {"Amy_01": ramp.reshape(1, -1),
                  "Ctx_01": np.sin(ramp / 7.0).reshape(1, -1)})
    s_class, o_class = np.zeros(T), np.zeros(T)
    s_class[6000:9000] = 1.0
    o_class[11000:14000] = 1.0
    scio.savemat(str(tmp_path / "sp_lab" / f"{name}_Class.mat"),
                 {"StartTime": np.array([[5]]),
                  "S_Class": s_class.reshape(1, -1),
                  "O_Class": o_class.reshape(1, -1)})
    for tag, mod in (("j", jlfp), ("t", tlfp)):
        mod.preprocess_tst_raw_lfps_for_windowed_training(
            str(tmp_path / "tst_lfp"), str(tmp_path / "tst_lab"),
            str(tmp_path / tag / "tst"), post_processing_sample_freq=100,
            num_processed_samples=18, sample_temp_window_size=1000,
            max_num_samps_per_preprocessed_file=2,
            rng=np.random.default_rng(0))
        mod.preprocess_socpref_raw_lfps_for_windowed_training(
            str(tmp_path / "sp_lfp"), str(tmp_path / "sp_lab"),
            str(tmp_path / tag / "sp"), post_processing_sample_freq=100,
            num_processed_samples=8, sample_temp_window_size=500,
            rng=np.random.default_rng(0), recording_duration_sec=15)
    _assert_trees_equal(str(tmp_path / "j"), str(tmp_path / "t"))


# ----------------------------------------------------------- exports

def test_data_and_train_exports_resolve_with_jax_blocked():
    """Every name the JAX ``data``, ``train``, ``eval`` and ``tidybench``
    packages export resolves in the port (``ShardedBatchDataset`` since the
    production-runtime slice), and the port's ``models`` exports resolve, in
    a process where importing jax fails; nothing of the JAX package loads,
    nothing CUDA is initialised and no matplotlib is imported."""
    from redcliff_tpu import eval as jeval
    from redcliff_tpu import tidybench as jtidy
    from redcliff_tpu import train as jtrain

    data_names = sorted(jdata.__all__)
    code = f"""
import sys
sys.modules["jax"] = None
import torch
import redcliff_tpu_torch.data as D
import redcliff_tpu_torch.eval as E
import redcliff_tpu_torch.models as M
import redcliff_tpu_torch.tidybench as TB
import redcliff_tpu_torch.train as T
import redcliff_tpu_torch.runtime as R
from redcliff_tpu_torch.ops import autotune
from redcliff_tpu_torch.parallel import policy
assert R.AsyncCheckpointWriter and policy.PredictiveSchedulingPolicy
assert autotune.tune_for_model and D.ShardedBatchDataset
missing = [n for n in {data_names!r} if not hasattr(D, n)]
missing += [n for n in {sorted(jtrain.__all__)!r} if not hasattr(T, n)]
missing += [n for n in {sorted(jeval.__all__)!r} if not hasattr(E, n)]
missing += [n for n in {sorted(jtidy.__all__)!r} if not hasattr(TB, n)]
missing += [n for n in M.__all__ if not hasattr(M, n)]
assert not missing, missing
assert sorted(D.__all__) == {data_names!r}
assert sorted(T.__all__) == {sorted(jtrain.__all__)!r}
assert TB.__all__ == {jtidy.__all__!r}
assert "matplotlib" not in sys.modules
assert not torch.cuda.is_initialized()
leaked = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith("jax.")) and sys.modules[m]
                or m == "redcliff_tpu" or m.startswith("redcliff_tpu."))
print("LEAKED", leaked)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout
