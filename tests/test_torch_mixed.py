"""Mixed precision on the port's training path against the JAX package:
the mixed contraction's gradient rule, the bf16 training form of the
factor mix (and its lane form under ``torch.func.vmap``), the numerics
storm's demotion to f32 in ``RedcliffTrainer``, the generic ``Trainer``
and the grid, the f32 path's bit identity, and the cost model's
steady-state-only fold (capture epochs left out).

XLA:CPU ignores the bf16 matmul precision, so the JAX fits here are f32;
the port's mixed fits round their contraction operands to bf16 on the CPU
too. Histories before a demotion are held to JAX's at the bf16 bars of
tests/test_torch_serve_elastic.py; decisions (the demotion epoch, the
lanes, the skip counters, the events' fields) are held exactly.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from redcliff_tpu.data import datasets as jds  # noqa: E402
from redcliff_tpu.models import cmlp_fm as jcmlp_fm  # noqa: E402
from redcliff_tpu.models import redcliff as jred  # noqa: E402
from redcliff_tpu.obs import read_jsonl as jread  # noqa: E402
from redcliff_tpu.parallel import grid as jgrid  # noqa: E402
from redcliff_tpu.train import redcliff_trainer as jrtr  # noqa: E402
from redcliff_tpu.train import trainer as jtr  # noqa: E402
from redcliff_tpu_torch import interop  # noqa: E402
from redcliff_tpu_torch.data import datasets as tds  # noqa: E402
from redcliff_tpu_torch.models import cmlp_fm as tcmlp_fm  # noqa: E402
from redcliff_tpu_torch.models import redcliff as tred  # noqa: E402
from redcliff_tpu_torch.obs import read_jsonl as tread  # noqa: E402
from redcliff_tpu_torch.obs import schema  # noqa: E402
from redcliff_tpu_torch.ops import factor_mix as FM  # noqa: E402
from redcliff_tpu_torch.parallel import epoch_engine  # noqa: E402
from redcliff_tpu_torch.parallel import grid as tgrid  # noqa: E402
from redcliff_tpu_torch.train import redcliff_trainer as trtr  # noqa: E402
from redcliff_tpu_torch.train import trainer as ttr  # noqa: E402
from redcliff_tpu_torch.utils import precision as P  # noqa: E402

# mixed against f32 (tests/test_torch_serve_elastic.py)
MIXED_TOL = dict(rtol=2e-2, atol=1e-3)
# an f32 sum of bf16-exact products against the same rule in float64
RULE_TOL = dict(rtol=1e-5, atol=1e-5)
_IDENTITY = ("wall_time", "seq", "pid", "host", "trace")
BF16 = "bfloat16"

MODEL_KW = dict(
    num_chans=4, gen_lag=2, gen_hidden=(8,), embed_lag=4,
    embed_hidden_sizes=(8,), num_factors=2, num_supervised_factors=2,
    factor_weight_l1_coeff=0.01, adj_l1_reg_coeff=0.001,
    factor_cos_sim_coeff=0.01,
    factor_score_embedder_type="Vanilla_Embedder",
    primary_gc_est_mode="fixed_factor_exclusive", num_sims=1,
    training_mode="combined")
POINTS = [{"gen_lr": 1e-3}, {"gen_lr": 3e-3}]


def _models():
    return (jred.RedcliffSCMLP(jred.RedcliffSCMLPConfig(**MODEL_KW)),
            tred.RedcliffSCMLP(tred.RedcliffSCMLPConfig(**MODEL_KW)))


def _data(n=48):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 6, 4)).astype(np.float32)
    Y = rng.uniform(size=(n, 3, 1)).astype(np.float32)
    return X, Y


def _tc(mod, **kw):
    kw.setdefault("max_iter", 3)
    return mod.RedcliffTrainConfig(batch_size=16, check_every=1,
                                   stream_mode="per_batch", **kw)


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in _IDENTITY}


def _precision_events(records):
    return [_strip(r) for r in records if r["event"] == "precision"]


def _r64(t):
    return t.detach().to(torch.bfloat16).double()


def _rule(equation, a, b, g):
    """The JAX transpose rule in float64: the einsum's gradient at the
    bf16-rounded operands, against the bf16-rounded cotangent."""
    a64 = _r64(a).requires_grad_(True)
    b64 = _r64(b).requires_grad_(True)
    out = torch.einsum(equation, a64, b64)
    return torch.autograd.grad(out, (a64, b64), _r64(g))


# ------------------------------------------------------ the gradient rule
# the contraction sites' equations (cMLP factors with their K axis
# broadcast, the GC outer products and weightings, cLSTM, NAVAR, DGCNN)
EINSUMS = {
    "cmlp_layer0": ("...btcl,...ohcl->...btoh", (5, 3, 4, 2),
                    (2, 4, 6, 4, 2)),
    "cmlp_layer1": ("...btoh,...ogh->...btog", (2, 5, 3, 4, 6),
                    (2, 4, 1, 6)),
    "gc_product": ("kal,kbl->abl", (3, 4, 2), (3, 4, 2)),
    "gc_weighting": ("bk,kacl->bkacl", (5, 3), (3, 4, 4, 2)),
    "clstm_recurrent": ("...bsh,...sgh->...bsg", (2, 5, 4, 3),
                        (2, 4, 12, 3)),
    "navar_first": ("bln,nhl->bnh", (5, 3, 4), (4, 6, 3)),
    "dgcnn_conv": ("bnf,fh->bnh", (5, 4, 3), (3, 6)),
}


@pytest.mark.parametrize("site", sorted(EINSUMS))
def test_mixed_einsum_gradient_is_the_transpose_rule(site):
    """Under the bf16 context a differentiated contraction's operand
    gradients are the transposed contractions on the bf16-rounded
    cotangent and other operand with f32 sums (held against the rule in
    float64), so they are f32 values, not bf16-rounded ones, as a cast
    pair under autograd would make them."""
    eq, sa, sb = EINSUMS[site]
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(sa, generator=gen).requires_grad_(True)
    b = torch.randn(sb, generator=gen).requires_grad_(True)
    with P.matmul_precision_ctx(BF16):
        out = P.einsum(eq, a, b)
    # the forward is the no-grad path's, bit for bit
    with torch.no_grad(), P.matmul_precision_ctx(BF16):
        assert torch.equal(out.detach(), P.einsum(eq, a, b))
    g = torch.randn(out.shape, generator=gen)
    da, db = torch.autograd.grad(out, (a, b), g)
    want_a, want_b = _rule(eq, a, b, g)
    torch.testing.assert_close(da.double(), want_a, **RULE_TOL)
    torch.testing.assert_close(db.double(), want_b, **RULE_TOL)
    for d in (da, db):
        assert d.dtype == torch.float32
        assert not torch.equal(d, d.bfloat16().float())
    # a cast pair under autograd rounds the gradient itself
    a2 = a.detach().requires_grad_(True)
    pair = torch.einsum(eq, a2.to(torch.bfloat16).to(torch.float32),
                        P.bf16_round(b.detach()))
    dpair, = torch.autograd.grad(pair, (a2,), g)
    assert torch.equal(dpair, dpair.bfloat16().float())
    # outside the context the site runs torch.einsum itself
    assert torch.equal(P.einsum(eq, a, b), torch.einsum(eq, a, b))


def test_mixed_matmul_rule_and_torch_func():
    """The matmul site's rule (with a broadcast batch), and both Functions
    under ``torch.func.vmap(torch.func.grad)`` as the grid runs them: each
    lane's gradient equals that lane alone."""
    gen = torch.Generator().manual_seed(1)
    a = torch.randn((3, 5, 4), generator=gen).requires_grad_(True)
    b = torch.randn((4, 6), generator=gen).requires_grad_(True)
    with P.matmul_precision_ctx(BF16):
        out = P.matmul(a, b)
    g = torch.randn(out.shape, generator=gen)
    da, db = torch.autograd.grad(out, (a, b), g)
    want_a, want_b = _rule("zij,jk->zik", a, b, g)
    torch.testing.assert_close(da.double(), want_a, **RULE_TOL)
    torch.testing.assert_close(db.double(), want_b, **RULE_TOL)
    assert torch.equal(P.matmul(a, b), a @ b)

    def loss(w, x):
        with P.matmul_precision_ctx(BF16):
            h = P.einsum("bi,hi->bh", x, w)
            return (P.matmul(h, w) ** 2).sum()

    ws = torch.randn((3, 6, 4), generator=gen)
    x = torch.randn((5, 4), generator=gen)
    lanes = torch.func.vmap(torch.func.grad(loss), in_dims=(0, None))(ws, x)
    for i in range(3):
        assert torch.equal(lanes[i], torch.func.grad(loss)(ws[i], x))
    with pytest.raises(ValueError, match="'tf32'"):
        P.matmul_precision_ctx("tf32")
    with pytest.raises(ValueError, match="'highest'"):
        P.check_matmul_precision("highest")


# ------------------------------------------- the bf16 factor-mix training form
def test_bf16_factor_mix_training_form_and_lanes():
    """The factor mix under the bf16 context takes its bf16 training form:
    the plain version, :class:`FactorMixBf16Fn` and its ``vmap`` rule onto
    the lane form equal ``factor_mix_lanes_reference`` on bf16-rounded
    operands, and the backward is JAX's ``_mix_bwd`` on the bf16-rounded
    cotangent and operands (the rule in float64)."""
    gen = torch.Generator().manual_seed(2)
    G, B, K, T, C = 3, 6, 4, 2, 5
    w = torch.rand((G, B, K), generator=gen)
    p = torch.randn((G, K, B, T, C), generator=gen)
    want = FM.factor_mix_lanes_reference(P.bf16_round(w), P.bf16_round(p))
    assert torch.equal(FM.factor_mix_lanes_bf16_reference(w, p), want)
    assert torch.equal(FM.factor_mix_lanes_bf16(w, p), want)
    for g in range(G):
        assert torch.equal(FM.factor_mix_bf16(w[g], p[g]), want[g])
        assert torch.equal(FM.factor_mix_bf16_reference(w[g], p[g]),
                           want[g])
    with P.matmul_precision_ctx(BF16):
        lanes = torch.func.vmap(FM.factor_mix)(w, p)
    assert torch.equal(lanes, want)
    # outside the context: the f32 mix, untouched
    assert torch.equal(FM.factor_mix(w[0], p[0]),
                       FM.factor_mix_reference(w[0], p[0]))

    cot = torch.randn(want.shape, generator=gen)

    def loss(wl, pl, cl):
        with P.matmul_precision_ctx(BF16):
            return (FM.factor_mix(wl, pl) * cl).sum()

    dw, dp = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(w, p,
                                                                     cot)
    for g in range(G):
        ww = w[g].clone().requires_grad_(True)
        pp = p[g].clone().requires_grad_(True)
        with P.matmul_precision_ctx(BF16):
            out = FM.factor_mix(ww, pp)
        gw, gp = torch.autograd.grad(out, (ww, pp), cot[g])
        assert torch.equal(gw, dw[g]) and torch.equal(gp, dp[g])
        rw, rp = _rule("bk,kbtc->btc", w[g], p[g], cot[g])
        torch.testing.assert_close(gw.double(), rw, **RULE_TOL)
        torch.testing.assert_close(gp.double(), rp, **RULE_TOL)
        assert not torch.equal(gw, gw.bfloat16().float())
    # the lane Function's own backward (no vmap)
    wl = w.clone().requires_grad_(True)
    pl = p.clone().requires_grad_(True)
    gwl, gpl = torch.autograd.grad(FM.factor_mix_lanes_bf16(wl, pl),
                                   (wl, pl), cot)
    assert torch.equal(gwl, dw) and torch.equal(gpl, dp)


def _one_kernel_a_call(fn, n=20):
    """Whether each of ``n`` calls of ``fn`` runs one device kernel on the
    card, the factor mix's (``torch.profiler``, CUDA activity only; a cast
    or a copy is a kernel of its own, and the profiler may drop an event
    of the window, hence the rounded mean)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return (round(len(names) / n) == 1
            and all("factor_mix_kernel" in x for x in names))


@pytest.mark.gpu
def test_bf16_training_form_on_the_card():
    """On the card the bf16 training form launches the hand-written kernel
    (one count in ``graph_mix_bf16.launches`` per call), forward and
    lanes, at the per-point (B=128 K=5 M=10) and lane (G=32) shapes,
    against the plain version; the backward against the rule. On the f32
    operands the caller holds, each forward (single, lanes, lanes under
    ``vmap``) is one device kernel that gives bit for bit what casting
    both operands to bf16 and launching the bf16 entry gives, and a lane
    operand with strides the kernel takes is not copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    for G in (None, 32):
        lead = () if G is None else (G,)
        w = torch.rand(lead + (128, 5), generator=gen).to(dev)
        p = torch.randn(lead + (5, 128, 1, 10), generator=gen).to(dev)
        w.requires_grad_(True)
        p.requires_grad_(True)
        before = FM.graph_mix_bf16.launches
        with P.matmul_precision_ctx(BF16):
            out = (FM.factor_mix(w, p) if G is None
                   else torch.func.vmap(FM.factor_mix)(w, p))
        assert FM.graph_mix_bf16.launches == before + 1
        ref = (FM.factor_mix_bf16_reference if G is None
               else FM.factor_mix_lanes_bf16_reference)
        torch.testing.assert_close(out, ref(w.detach(), p.detach()),
                                   rtol=1e-5, atol=1e-6)
        cot = torch.randn(out.shape, generator=gen).to(dev)
        gw, gp = torch.autograd.grad(out, (w, p), cot)
        eq = "bk,kbtc->btc" if G is None else "gbk,gkbtc->gbtc"
        rw, rp = _rule(eq, w.cpu(), p.cpu(), cot.cpu())
        torch.testing.assert_close(gw.cpu().double(), rw, **RULE_TOL)
        torch.testing.assert_close(gp.cpu().double(), rp, **RULE_TOL)

        wd, pd = w.detach(), p.detach()
        direct = FM.factor_mix_bf16 if G is None else FM.factor_mix_lanes_bf16
        precast = direct(wd.bfloat16(), pd.bfloat16())
        assert torch.equal(out.detach(), precast)

        def mixed():
            with P.matmul_precision_ctx(BF16):
                return (FM.factor_mix(wd, pd) if G is None
                        else torch.func.vmap(FM.factor_mix)(wd, pd))

        for call in (mixed, lambda: direct(wd, pd)):
            assert torch.equal(call(), precast)
            assert _one_kernel_a_call(call)
    # lane operands in strided layouts the kernel takes: p a slice of a
    # wider buffer (lane stride 6*B*M), and under vmap p's lanes on its
    # second axis; each is still one kernel, no copy
    w = torch.rand((32, 128, 5), generator=gen).to(dev)
    wide = torch.randn((32, 6, 128, 1, 10), generator=gen).to(dev)
    p = wide[:, :5]
    assert not p.is_contiguous() and FM._lanes_layout(w, p) is not None
    want = FM.factor_mix_lanes_bf16(w.bfloat16(),
                                    p.contiguous().bfloat16())
    pk = p.transpose(0, 1).contiguous()

    def vmapped():
        with P.matmul_precision_ctx(BF16):
            return torch.func.vmap(FM.factor_mix, in_dims=(0, 1))(w, pk)

    for call in (lambda: FM.factor_mix_lanes_bf16(w, p), vmapped):
        assert torch.equal(call(), want)
        assert _one_kernel_a_call(call)


# -------------------------------------------------------------- demotion
def test_trainer_mixed_demotes_like_jax_and_f32_resume_bit_identical(
        tmp_path, monkeypatch):
    """A nan_batch storm over epoch 1 (non-finite grads -> skips ->
    rollback): the mixed trainer demotes at the JAX epoch with the JAX
    event's fields, the checkpoint records it, and continuing the fit is
    bitwise the same whether the resuming config says "mixed" (honouring
    the demotion, ``resume_demoted``) or "f32"."""
    jm, tm = _models()
    X, Y = _data()
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    monkeypatch.setenv("REDCLIFF_FAULT_INJECT", "nan_batch:3-5")
    jt = jrtr.RedcliffTrainer(jm, _tc(jrtr, precision_mode="mixed"))
    jres = jt.fit(params, jds.ArrayDataset(X, Y), jds.ArrayDataset(X, Y),
                  save_dir=str(tmp_path / "jax"))
    tt = trtr.RedcliffTrainer(tm, _tc(trtr, precision_mode="mixed"),
                              device="cpu")
    tres = tt.fit(params, tds.ArrayDataset(X, Y), tds.ArrayDataset(X, Y),
                  save_dir=str(tmp_path / "run"))
    monkeypatch.delenv("REDCLIFF_FAULT_INJECT")
    assert jt._demoted and tt._demoted
    recs = tread(str(tmp_path / "run"))
    assert not schema.validate_records(recs)
    assert any(r["event"] == "anomaly" for r in recs)
    tp = _precision_events(recs)
    jp = _precision_events(jread(str(tmp_path / "jax")))
    assert len(tp) == len(jp) == 1
    assert sorted(tp[0]) == sorted(jp[0])
    for k in ("event", "kind", "epoch", "cause", "mode_from", "mode_to",
              "rollbacks", "skipped", "consecutive", "checked",
              "grad_norm_last"):
        assert tp[0][k] == jp[0][k], k
    for k in ("grad_norm_mean", "grad_norm_std", "grad_norm_max"):
        np.testing.assert_allclose(tp[0][k], jp[0][k], **MIXED_TOL)
    assert tp[0]["kind"] == "demote" and tp[0]["epoch"] == 1
    # the epoch before the demotion ran bf16 contractions: JAX's (f32 on
    # XLA:CPU) within the bf16 bars
    for k in ("avg_combo_loss", "avg_forecasting_loss"):
        np.testing.assert_allclose(tres.histories[k][0],
                                   jres.histories[k][0], **MIXED_TOL)
    ck = trtr.durable_ckpt.read_checkpoint(
        str(tmp_path / "run" / "trainer_checkpoint.pkl"))
    assert ck["precision_demoted"] is True

    runs = {}
    for mode in ("mixed", "f32"):
        d = tmp_path / f"resume_{mode}"
        shutil.copytree(tmp_path / "run", d)
        tr = trtr.RedcliffTrainer(tm, _tc(trtr, max_iter=6,
                                          precision_mode=mode),
                                  device="cpu")
        runs[mode] = (tr, tr.fit(params, tds.ArrayDataset(X, Y),
                                 tds.ArrayDataset(X, Y), save_dir=str(d)))
    assert runs["mixed"][0]._demoted and not runs["f32"][0]._demoted
    kinds = [r["kind"] for r in tread(str(tmp_path / "resume_mixed"))
             if r["event"] == "precision"]
    assert kinds == ["demote", "resume_demoted"]
    for a, b in zip(interop.tree_leaves(runs["mixed"][1].params),
                    interop.tree_leaves(runs["f32"][1].params)):
        assert torch.equal(a, b)


def test_grid_mixed_demotes_like_jax_and_resume_stays_f32(tmp_path,
                                                          monkeypatch):
    """A skip storm on every lane in epoch 0 demotes the mixed grid at the
    JAX epoch, for the JAX lanes, with the JAX event; the lanes get an f32
    epoch instead of quarantine (``failures == []``); a resume under the
    same mixed config comes up demoted; a resume under another
    ``precision_mode`` is refused by the fingerprint."""
    jm, tm = _models()
    X, Y = _data()
    monkeypatch.setenv("REDCLIFF_FAULT_INJECT", "nan_batch:0-2")
    jr = jgrid.RedcliffGridRunner(jm, _tc(jrtr, max_iter=5,
                                          precision_mode="mixed"),
                                  jgrid.GridSpec(points=POINTS))
    jres = jr.fit(jax.random.PRNGKey(0), jds.ArrayDataset(X, Y),
                  jds.ArrayDataset(X, Y), max_iter=3,
                  log_dir=str(tmp_path / "jlog"),
                  checkpoint_dir=str(tmp_path / "jck"), checkpoint_every=1)
    state = interop.grid_state_from_jax(
        *jr.init_grid(jax.random.PRNGKey(0)))
    tr = tgrid.RedcliffGridRunner(tm, _tc(trtr, max_iter=5,
                                          precision_mode="mixed"),
                                  tgrid.GridSpec(points=POINTS),
                                  device="cpu")
    ck = str(tmp_path / "ck")
    tres = tr.fit(0, tds.ArrayDataset(X, Y), tds.ArrayDataset(X, Y),
                  max_iter=3, log_dir=str(tmp_path / "log1"),
                  checkpoint_dir=ck, checkpoint_every=1, init_params=state)
    monkeypatch.delenv("REDCLIFF_FAULT_INJECT")
    assert jr._demoted and tr._demoted
    assert tres.failures == jres.failures == []
    recs = tread(str(tmp_path / "log1"))
    assert not schema.validate_records(recs)
    tp = _precision_events(recs)
    jp = _precision_events(jread(str(tmp_path / "jlog")))
    assert tp == jp
    assert tp[0]["kind"] == "demote" and tp[0]["cause"] == "precision_cliff"
    # epoch 0 ran bf16 contractions in the port: JAX's within the bars;
    # the eras and the bf16 launches of each (none on the CPU)
    np.testing.assert_allclose(tres.val_history[0],
                               np.asarray(jres.val_history)[0], **MIXED_TOL)
    eras = tres.dispatch_stats["precision_eras"]
    assert [(e["precision"], e["from_epoch"]) for e in eras] == \
        [("mixed", 0), ("f32", 1)]
    assert set(tres.dispatch_stats["cost_eras"]) <= {"mixed", "f32"}

    tr2 = tgrid.RedcliffGridRunner(tm, _tc(trtr, max_iter=5,
                                           precision_mode="mixed"),
                                   tgrid.GridSpec(points=POINTS),
                                   device="cpu")
    tr2.fit(0, tds.ArrayDataset(X, Y), tds.ArrayDataset(X, Y),
            log_dir=str(tmp_path / "log2"), checkpoint_dir=ck,
            checkpoint_every=1)
    assert tr2._demoted
    kinds = [r["kind"] for r in tread(str(tmp_path / "log2"))
             if r["event"] == "precision"]
    assert kinds == ["resume_demoted"]
    tr3 = tgrid.RedcliffGridRunner(tm, _tc(trtr, max_iter=5),
                                   tgrid.GridSpec(points=POINTS),
                                   device="cpu")
    with pytest.raises(ValueError, match="precision_mode"):
        tr3.fit(0, tds.ArrayDataset(X, Y), tds.ArrayDataset(X, Y),
                checkpoint_dir=ck)


def test_generic_trainer_mixed_demotes_like_jax(tmp_path, monkeypatch):
    """The cMLP-FM GISTA fit of the generic ``Trainer`` under "mixed": a
    storm over epoch 1 demotes it at the JAX epoch with the JAX event's
    fields; the checkpoint records it and a resume stays f32."""
    cfg = dict(num_chans=4, gen_lag=2, gen_hidden=(6,), input_length=3,
               adj_l1_coeff=0.1)
    jm = jcmlp_fm.CMLPFM(jcmlp_fm.CMLPFMConfig(**cfg))
    tm = tcmlp_fm.CMLPFM(tcmlp_fm.CMLPFMConfig(**cfg))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(96, 8, 4)).astype(np.float32)

    def cfg_of(mod, **over):
        kw = dict(learning_rate=1e-2, max_iter=3, lookback=1,
                  check_every=1, batch_size=16, seed=3, prox_penalty="GL",
                  prox_lam=0.2, precision_mode="mixed")
        kw.update(over)
        return mod.TrainConfig(**kw)

    monkeypatch.setenv("REDCLIFF_FAULT_INJECT", "nan_batch:4-7")
    jt = jtr.Trainer(jm, cfg_of(jtr))
    jt.fit(params, jds.ArrayDataset(X[:64]), jds.ArrayDataset(X[64:]),
           save_dir=str(tmp_path / "jax"))
    tt = ttr.Trainer(tm, cfg_of(ttr), device="cpu")
    tt.fit(params, tds.ArrayDataset(X[:64]), tds.ArrayDataset(X[64:]),
           save_dir=str(tmp_path / "port"))
    monkeypatch.delenv("REDCLIFF_FAULT_INJECT")
    assert jt._demoted and tt._demoted
    recs = tread(str(tmp_path / "port"))
    assert not schema.validate_records(recs)
    tp = _precision_events(recs)
    jp = _precision_events(jread(str(tmp_path / "jax")))
    assert len(tp) == len(jp) == 1 and sorted(tp[0]) == sorted(jp[0])
    for k in ("kind", "epoch", "cause", "rollbacks", "skipped",
              "consecutive", "checked"):
        assert tp[0][k] == jp[0][k], k
    ck = ttr.durable_ckpt.read_checkpoint(
        str(tmp_path / "port" / "trainer_checkpoint.pkl"))
    assert ck["precision_demoted"] is True
    t2 = ttr.Trainer(tm, cfg_of(ttr, max_iter=4), device="cpu")
    t2.fit(params, tds.ArrayDataset(X[:64]), tds.ArrayDataset(X[64:]),
           save_dir=str(tmp_path / "port"))
    assert t2._demoted and t2._precision is None


# ------------------------------------------------------------ f32 identity
def test_f32_fits_are_bitwise_the_default():
    """``precision_mode="f32"`` runs no precision context at all: the grid
    and the trainer are bitwise a fit that never named the mode."""
    _, tm = _models()
    X, Y = _data()
    params = jax.tree.map(np.asarray,
                          _models()[0].init(jax.random.PRNGKey(1)))
    res = []
    for kw in ({}, {"precision_mode": "f32"}):
        runner = tgrid.RedcliffGridRunner(tm, _tc(trtr, **kw),
                                          tgrid.GridSpec(points=POINTS),
                                          device="cpu")
        res.append(runner.fit(0, tds.ArrayDataset(X, Y),
                              tds.ArrayDataset(X, Y)))
    np.testing.assert_array_equal(res[0].val_history, res[1].val_history)
    for a, b in zip(interop.tree_leaves(res[0].best_params),
                    interop.tree_leaves(res[1].best_params)):
        np.testing.assert_array_equal(a, b)
    fits = [trtr.RedcliffTrainer(tm, _tc(trtr, **kw), device="cpu").fit(
        params, tds.ArrayDataset(X, Y), tds.ArrayDataset(X, Y))
        for kw in ({}, {"precision_mode": "f32"})]
    for a, b in zip(interop.tree_leaves(fits[0].params),
                    interop.tree_leaves(fits[1].params)):
        assert torch.equal(a, b)


# --------------------------------------------- cost model: steady state only
def test_capture_epochs_stay_out_of_the_cost_rows(tmp_path, monkeypatch):
    """An epoch in which the epoch engine captured a CUDA graph (simulated
    here: the CPU captures nothing) is left out of ``epochs_by_width`` /
    ``epoch_ms_by_width``, of the ``cost_model`` scoring and of the store
    fold; ``first_epoch_ms_by_width`` keeps the width's first epoch, as
    JAX keeps it. Without captures every epoch folds, as in JAX."""
    _, tm = _models()
    X, Y = _data()
    real = epoch_engine.EpochEngine.train_epoch
    calls = []

    def capturing(self, *a, **kw):
        calls.append(1)
        if len(calls) == 2:
            self.stats["graph_captures"] += 1
        return real(self, *a, **kw)

    def fit(log):
        # an empty store of each fit's own: scored against its own epochs
        monkeypatch.setenv("REDCLIFF_COST_MODEL_DIR",
                           str(tmp_path / log / "store"))
        runner = tgrid.RedcliffGridRunner(
            tm, trtr.RedcliffTrainConfig(batch_size=16, check_every=1,
                                         max_iter=5, stream_mode="epoch"),
            tgrid.GridSpec(points=POINTS), device="cpu")
        res = runner.fit(0, tds.ArrayDataset(X, Y), tds.ArrayDataset(X, Y),
                         log_dir=str(tmp_path / log))
        scored = [r["epoch"] for r in tread(str(tmp_path / log))
                  if r["event"] == "cost_model"]
        return res, res.dispatch_stats, scored

    res, st, scored = fit("plain")
    assert st["epochs_by_width"] == {"2": 5}
    assert st["first_epoch_ms_by_width"]["2"] == res.epochs[0]["ms"]
    # each check window scores the epochs it resolved: the one before it
    assert scored == [2, 3]
    monkeypatch.setattr(epoch_engine.EpochEngine, "train_epoch", capturing)
    res, st, scored = fit("captured")
    assert st["graph_captures"] == 1
    assert st["epochs_by_width"] == {"2": 4}
    np.testing.assert_allclose(
        st["epoch_ms_by_width"]["2"],
        sum(e["ms"] for e in res.epochs if e["epoch"] != 1))
    assert st["first_epoch_ms_by_width"]["2"] == res.epochs[0]["ms"]
    assert st["cost_eras"]["f32"]["epochs_by_width"] == {"2": 4}
    assert scored == [3]
