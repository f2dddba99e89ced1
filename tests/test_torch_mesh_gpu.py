"""The chip smoke's mesh legs (a) and (c) at a small width, on one card
named four and five times (``gpu``: skipped without a card). No JAX here:
the card's runs are held to the port's unsharded fits on the card, at the
grid bars (ROADMAP "Tolerances") and at JAX's factor-mesh bar (rtol 2e-4,
atol 1e-5, tests/test_parallel_grid.py:473-491).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data.datasets import ArrayDataset as TDataset  # noqa: E402,E501
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.ops import factor_mix as FM  # noqa: E402
from redcliff_tpu_torch.ops import pallas_prox as PX  # noqa: E402
from redcliff_tpu_torch.parallel import grid as tgrid  # noqa: E402
from redcliff_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from redcliff_tpu_torch.train import redcliff_trainer as ttr  # noqa: E402

HIST = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-4)
FACTOR = dict(rtol=2e-4, atol=1e-5)
POINTS8 = [{"gen_lr": 1e-3 * (1 + 0.5 * i)} for i in range(8)]
KNOBS = dict(max_iter=3, batch_size=32, seed=7, lookback=1, check_every=1,
             prox_penalty="GL", prox_lam=0.5)


def _model_kw(K=2):
    return dict(num_chans=4, gen_lag=2, gen_hidden=(8,), embed_lag=4,
                embed_hidden_sizes=(8,), num_factors=K,
                num_supervised_factors=2, factor_weight_l1_coeff=0.01,
                adj_l1_reg_coeff=0.001, factor_cos_sim_coeff=0.01,
                factor_score_embedder_type="Vanilla_Embedder",
                primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
                training_mode="combined")


def _data(n=64):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 5, 4)).astype(np.float32)
    Y = rng.uniform(size=(n, 3, 1)).astype(np.float32)
    return X, Y


def _leaves(tree):
    return [np.asarray(x) for x in interop.tree_leaves(tree)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _counts():
    return FM.factor_mix.launches, PX.gl_prox.launches


@pytest.mark.gpu
def test_sharded_grid_on_one_card_named_four_times():
    """Leg (a) at a small width: the grid on [cuda:0] * 4 (epoch engine,
    one program per shard) against the unsharded grid on the card, at the
    grid bars; both kernels launched on every shard."""
    _card()
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**_model_kw()))
    X, Y = _data(256)
    tc = ttr.RedcliffTrainConfig(**{**KNOBS, "batch_size": 64},
                                 compaction=False)
    points = POINTS8
    init = tgrid.RedcliffGridRunner(tm, tc, tgrid.GridSpec(points),
                                    device="cuda").init_grid(3)
    plain = tgrid.RedcliffGridRunner(
        tm, tc, tgrid.GridSpec(points), device="cuda").fit(
        None, TDataset(X, Y), TDataset(X, Y), init_params=init)
    runner = tgrid.RedcliffGridRunner(
        tm, tc, tgrid.GridSpec(points),
        mesh=tmesh.grid_mesh(devices=["cuda:0"] * 4))
    m0, p0 = _counts()
    res = runner.fit(None, TDataset(X, Y), TDataset(X, Y),
                     init_params=init)
    m1, p1 = _counts()
    assert m1 > m0 and p1 > p0
    by_shard = res.dispatch_stats["launches_by_shard"]
    assert sorted(by_shard) == ["0", "1", "2", "3"]
    assert all(by["factor_mix"] > 0 and by["gl_prox"] > 0
               for by in by_shard.values()), by_shard
    widths = {p["width"] for p in res.dispatch_stats["programs"]}
    assert widths == {2}, widths
    np.testing.assert_array_equal(res.best_epoch, plain.best_epoch)
    np.testing.assert_array_equal(res.active, plain.active)
    np.testing.assert_allclose(res.val_history, plain.val_history, **HIST)
    for a, b in zip(_leaves(res.best_params), _leaves(plain.best_params)):
        np.testing.assert_allclose(a, b, **PARAMS)


@pytest.mark.gpu
def test_factor_mesh_on_one_card_named_five_times():
    """Leg (c) at a small width: K=5 over [cuda:0] * 5 (the factor mix at
    K=1 per shard) against the unsharded fit on the card."""
    _card()
    tm = tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**_model_kw(K=5)))
    X, Y = _data(64)
    tc = ttr.RedcliffTrainConfig(max_iter=2, batch_size=16, seed=3,
                                 prox_penalty="GL", prox_lam=0.1)
    init = tm.init(torch.Generator().manual_seed(7), "cuda")
    plain = ttr.RedcliffTrainer(tm, tc, device="cuda").fit(
        init, TDataset(X, Y), TDataset(X, Y))
    for by in tred.FACTOR_BLOCK_LAUNCHES.values():
        by.clear()
    m0, p0 = _counts()
    sharded = ttr.RedcliffTrainer(tm, tc, device="cuda:0").fit(
        init, TDataset(X, Y), TDataset(X, Y),
        factor_mesh=tmesh.grid_mesh(devices=["cuda:0"] * 5))
    m1, p1 = _counts()
    assert m1 > m0 and p1 > p0
    for kernel, by in tred.FACTOR_BLOCK_LAUNCHES.items():
        assert sorted(by) == [0, 1, 2, 3, 4] and min(by.values()) > 0, \
            (kernel, by)
    for a, b in zip(_leaves(interop.params_to_jax(plain.params)),
                    _leaves(interop.params_to_jax(sharded.params))):
        np.testing.assert_allclose(b, a, **FACTOR)
