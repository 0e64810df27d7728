"""The port's training slice against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``repro`` and
``repro_torch``: the token pipeline, AdamW, the attention and SSD
backwards, the loss and every parameter's gradient of SMOKE zamba2-1.2b and
h2o-danube-1.8b at f32 (remat on and off), one train step from a carried
state, microbatching, learning, restart supervision and the CLI.  One torch
thread, SMOKE shapes.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.data import TokenPipelineConfig as JTokenPipelineConfig  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.state import init_train_state as jinit_train_state  # noqa: E402
from repro.train.trainer import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, latest_step  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_reference, model_config_from_reference,
    train_state_from_reference,
)
from repro_torch.data import (  # noqa: E402
    PrefetchLoader, SkipAheadLoader, TokenPipelineConfig, TokenStream,
)
from repro_torch.kernels import flash_attention as attn_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build, transformer  # noqa: E402
from repro_torch.models.layers import tree_items, tree_map  # noqa: E402
from repro_torch.sharding.partition import local_tree  # noqa: E402
from repro_torch.runtime.supervisor import (  # noqa: E402
    FaultInjector, WorkerFailure, run_with_restarts,
)
from repro_torch.train import (  # noqa: E402
    AdamWConfig, adamw_init, adamw_update, init_train_state, lr_at,
    make_eval_step, make_train_step,
)
from repro_torch.train.optim import global_norm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    """max |got - want| / max |want| (want all zero: the absolute max)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(arch, *, remat=False, seed=0):
    """One SMOKE config in both packages at f32 compute, the reference's
    parameters and the port's copy of them."""
    jcfg = jget_smoke(arch).replace(compute_dtype="float32", remat=remat)
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jcfg, jm, jp, cfg, build(cfg, device="cpu"), \
        lm_params_from_reference(cfg, _np(jp))


def _batch(vocab, B, S, seed=1):
    tok = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    tok = tok.astype(np.int32)
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


# --- the token pipeline --------------------------------------------------------


@pytest.mark.parametrize("seed,step,shard,n_shards", [
    (0, 0, 0, 1), (0, 7, 1, 2), (3, 1000, 3, 4), (11, 2, 0, 4)])
def test_token_stream_batches_bit_equal(seed, step, shard, n_shards):
    kw = dict(vocab=512, seq_len=40, global_batch=8, seed=seed,
              n_shards=n_shards, shard=shard)
    got = TokenStream(TokenPipelineConfig(**kw)).batch_at(step)
    want = JTokenStream(JTokenPipelineConfig(**kw)).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_and_skip_ahead_loaders():
    """The prefetch thread yields ``batch_at`` from its start step; a
    producer stalled past the timeout is skipped, and the cadence holds."""
    s = TokenStream(TokenPipelineConfig(vocab=64, seq_len=16,
                                        global_batch=2, seed=5))
    loader = PrefetchLoader(s, start_step=3)
    try:
        for want in (3, 4, 5):
            step, batch = loader.get()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          s.batch_at(want)["tokens"])
    finally:
        loader.close()
    skip = SkipAheadLoader(s, timeout_s=0.25,
                           delay_fn=lambda step: 1.0 if step == 1 else 0.0)
    assert [skip.get()[0] for _ in range(3)] == [0, 2, 3]
    assert skip.skipped == [1]


# --- AdamW ------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 3, 10, 57, 110, 500])
def test_lr_at_matches_reference(step):
    for cfg in (AdamWConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=110),
                AdamWConfig(peak_lr=1.0, warmup_steps=0, decay_steps=1,
                            floor_ratio=0.5)):
        jcfg = joptim.AdamWConfig(**dataclasses.asdict(cfg))
        got = float(lr_at(torch.tensor(step, dtype=torch.int32), cfg))
        want = float(joptim.lr_at(jnp.int32(step), jcfg))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("clip_norm", [1e9, 0.5])
def test_adamw_update_matches_reference(rng, clip_norm):
    """One update from nonzero moments at step 4, clip off and on: params,
    moments, grad_norm and lr within 1e-6 relative."""
    shapes = {"a": {"w": (5, 7), "b": (7,)}, "c": (3, 2, 4)}
    mk = lambda scale: jax.tree.map(  # noqa: E731
        lambda s: (scale * rng.normal(size=s)).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    p, g, m = mk(1.0), mk(0.3), mk(0.1)
    v = jax.tree.map(np.abs, mk(0.01))
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=20,
                      clip_norm=clip_norm)
    jcfg = joptim.AdamWConfig(**dataclasses.asdict(cfg))
    jp, jo, jmet = joptim.adamw_update(g, {"m": m, "v": v}, p, jnp.int32(4),
                                       jcfg)
    tp, to, tmet = adamw_update(
        tree_map(_t, g), {"m": tree_map(_t, m), "v": tree_map(_t, v)},
        tree_map(_t, p), torch.tensor(4, dtype=torch.int32), cfg)
    for k in ("grad_norm", "lr"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-6)
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for (path, a), (_, b) in zip(tree_items(got), tree_items(_np(want))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-9,
                                       err_msg=str(path))


def test_grad_clip_and_global_norm():
    p = {"w": torch.ones(2)}
    g = {"w": torch.full((2,), 100.0)}
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, decay_steps=10)
    _, _, metrics = adamw_update(g, adamw_init(p), p,
                                 torch.tensor(0, dtype=torch.int32), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(
        np.sqrt(2 * 100.0 ** 2), rel=1e-6)
    assert float(global_norm({"a": torch.tensor([3.0]),
                              "b": torch.tensor([[4.0]])})) == 5.0


# --- the attention backward (the card's backward is this plain code) -------------

ATTN_CASES = [  # B, Hq, Hkv, Lq, Lkv, D, causal, window, q_offset
    (1, 2, 2, 37, 37, 16, True, None, 0),
    (2, 4, 2, 50, 50, 8, True, 17, 0),
    (1, 4, 1, 20, 45, 16, True, None, 25),
    (1, 2, 2, 24, 40, 8, False, 9, 6),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_backward_matches_reference(rng, case):
    """The blockwise backward (block 16: several blocks and a padded tail)
    against ``jax.vjp`` of the reference's ``_attention_blockwise`` and of
    the dense ``attention``; the card's path (lse from the plain pass,
    out from a forward) against the dense vjp.  f32, 1e-5 of max|g|."""
    B, Hq, Hkv, Lq, Lkv, D, causal, window, off = case
    q = rng.normal(size=(B, Hq, Lq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Hkv, Lkv, D)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, Hq, Lq, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=off)

    def jvjp(fn):
        out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]

    _, want_b = jvjp(lambda a, b, c: jref._attention_blockwise(
        a, b, c, causal, window, off, 16))
    out_d, want_d = jvjp(lambda a, b, c: jref.attention(a, b, c, **kw))

    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = ref.attention_blockwise(*leaves, block=16, **kw)
    got = torch.autograd.grad(out, leaves, _t(do))
    lse = ref.attention_lse(_t(q), _t(k), block=16, **kw)
    card = ref.attention_blockwise_backward(_t(q), _t(k), _t(v), _t(out_d),
                                            lse, _t(do), **kw)
    _, jlse = jref._abw_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, window, off, 16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6,
                               atol=1e-5)
    for g, c, wb, wd in zip(got, card, want_b, want_d):
        assert _rel(g.numpy(), wb) <= 1e-5
        assert _rel(g.numpy(), wd) <= 1e-5
        assert _rel(c.numpy(), wd) <= 1e-5


def test_attention_lse_empty_rows_are_inf():
    """A row with no unmasked key (window 1 and q_offset past every key's
    position + 1) has lse = +inf, so the backward's p is 0 there."""
    q = torch.randn(1, 1, 3, 8)
    k = torch.randn(1, 1, 4, 8)
    lse = ref.attention_lse(q, k, causal=True, window=1, q_offset=10)
    assert torch.isinf(lse).all() and (lse > 0).all()


# --- the SSD backward ------------------------------------------------------------


def _ssd_inputs(rng, b, L, H, P, G, N, dt_lo=0.01, dt_hi=0.1):
    x = (0.1 * rng.normal(size=(b, L, H, P))).astype(np.float32)
    dt = rng.uniform(dt_lo, dt_hi, (b, L, H)).astype(np.float32)
    A = (-rng.uniform(0.5, 1.5, (H,))).astype(np.float32)
    B, C = (rng.normal(size=(b, L, G, N)).astype(np.float32)
            for _ in range(2))
    return x, dt, A, B, C


@pytest.mark.parametrize("L,G,chunk", [(1, 1, 128), (40, 2, 16),
                                       (130, 1, 128), (97, 2, 32)])
def test_ssd_backward_matches_reference(rng, L, G, chunk):
    """``ops.ssd_grads`` (the card's SSD backward, run here on the CPU)
    against ``jax.vjp`` of the reference's ``ssd_scan_chunked`` at the
    same chunk, dy and dstate random: 1e-5 of max|g| for every input."""
    ins = _ssd_inputs(rng, 2, L, 4, 8, G, 8)
    y, h = jref.ssd_scan_chunked(*ins, chunk=chunk)
    dy = rng.normal(size=y.shape).astype(np.float32)
    dh = rng.normal(size=h.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jref.ssd_scan_chunked(*a, chunk=chunk),
                     *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ops.ssd_grads([_t(a) for a in ins], _t(dy), _t(dh), chunk=chunk)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-5
    # dstate None counts as zeros
    got0 = ops.ssd_grads([_t(a) for a in ins], _t(dy), None, chunk=chunk)
    want0 = vjp((jnp.asarray(dy), jnp.zeros_like(jnp.asarray(dh))))
    for g, w in zip(got0, want0):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-5


def test_ssd_chunked_gradient_finite_where_reference_overflows(rng):
    """dt = softplus(N(0, 1)) over a 128-step chunk sums past 88, where the
    reference's masked ``exp`` overflows and its chunked gradient of dt and
    A is NaN (ROADMAP.md §3).  The port masks the decay before its ``exp``:
    the same decay matrix bit for bit as masking after it, y and the state
    within 1e-5 of the reference's, and a finite gradient within 1e-4 of
    max|g| of ``jax.vjp`` of the sequential oracle."""
    x, _, A, B, C = _ssd_inputs(rng, 1, 128, 4, 8, 1, 8)
    dt = np.asarray(jax.nn.softplus(rng.normal(size=(1, 128, 4)))
                    ).astype(np.float32)
    A = -np.ones(4, np.float32)
    ins = (x, dt, A, B, C)
    assert float(dt.sum(axis=1).max()) > 88.0
    y, h = jref.ssd_scan_chunked(*ins)
    dy = rng.normal(size=y.shape).astype(np.float32)
    dh = np.zeros(h.shape, np.float32)
    cot = (jnp.asarray(dy), jnp.asarray(dh))
    _, vjp_c = jax.vjp(jref.ssd_scan_chunked, *map(jnp.asarray, ins))
    ref_c = vjp_c(cot)
    assert not np.isfinite(np.asarray(ref_c[1])).all()
    _, vjp_s = jax.vjp(jref.ssd_scan, *map(jnp.asarray, ins))
    want = vjp_s(cot)
    cum = torch.cumsum(_t(dt * A), dim=1)[0]               # (L, H)
    diff = (cum[:, None] - cum[None, :]).permute(2, 0, 1)  # (H, L, L)
    tril = torch.ones(128, 128, dtype=torch.bool).tril()
    after = torch.where(tril, torch.exp(diff), 0.0)
    assert torch.isinf(torch.exp(diff)).any()
    assert torch.equal(torch.exp(diff.masked_fill(~tril, float("-inf"))),
                       after)
    yt, ht = ref.ssd_scan_chunked(*map(_t, ins))
    assert _rel(yt.numpy(), np.asarray(y)) <= 1e-5
    assert _rel(ht.numpy(), np.asarray(h)) <= 1e-5
    got = ops.ssd_grads([_t(a) for a in ins], _t(dy), None)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-4


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """The raw kernels write through pointers and have no backward: with
    grad mode on and an input requiring grad they raise before touching
    any card; under no_grad they get as far as the device check."""
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = v = torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        attn_mod.flash_attention(q, k, v)
    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    dt, A = torch.rand(1, 8, 2), -torch.rand(2)
    Bm = C = torch.randn(1, 8, 1, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_mod.ssd_scan(x, dt, A, Bm, C)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            attn_mod.flash_attention(q, k, v)
        with pytest.raises(ValueError, match="CUDA"):
            ssd_mod.ssd_scan(x, dt, A, Bm, C)


# --- the loss and every gradient --------------------------------------------------

# S = 80 takes the chunked SSD form (L > 64) in both packages
LOSS_CASES = [("zamba2-1.2b", 80), ("h2o-danube-1.8b", 40)]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch,S", LOSS_CASES)
def test_loss_and_grads_match_reference(arch, S, remat):
    """``transformer.loss_fn`` and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's: loss within 1e-5 relative,
    each leaf within 1e-4 of its max|g| (f32; the sums run in other
    orders, and the SSD's gradient of dt passes through exp)."""
    jcfg, _, jp, cfg, m, params = _pair(arch, remat=remat)
    batch = _batch(cfg.vocab, 2, S)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(p, b, jcfg), has_aux=True))(
            jp, batch)
    flat = []

    def leaf(t):
        flat.append(t.requires_grad_())
        return t

    loss, aux = m.loss(tree_map(leaf, params), _tb(batch))
    grads = torch.autograd.grad(loss, flat)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert float(aux["ce"]) == pytest.approx(float(jaux["ce"]), rel=1e-5)
    assert float(aux["moe_aux"]) == 0.0
    it = iter(grads)
    got = tree_map(lambda _: next(it), params)
    for (path, g), (_, w) in zip(tree_items(got), tree_items(_np(jg))):
        assert np.isfinite(w).all(), path
        assert _rel(g.numpy(), w) <= 1e-4, path


def test_forward_and_eval_step_match_reference():
    jcfg, jm, jp, cfg, m, params = _pair("zamba2-1.2b")
    batch = _batch(cfg.vocab, 2, 24)
    want = np.asarray(jm.forward(jp, batch))
    got = m.forward(params, _tb(batch))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    ev = make_eval_step(m)(params, _tb(batch))
    assert not ev["loss"].requires_grad
    assert float(ev["loss"]) == pytest.approx(
        float(jm.loss(jp, batch)[0]), rel=1e-5)


# --- the train step --------------------------------------------------------------

OPT = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)


@pytest.mark.parametrize("arch,S,remat,n_micro", [
    ("zamba2-1.2b", 80, False, 1), ("zamba2-1.2b", 80, True, 2),
    ("h2o-danube-1.8b", 40, False, 2), ("h2o-danube-1.8b", 40, True, 1)])
def test_train_step_matches_reference(arch, S, remat, n_micro):
    """The reference takes step 0 -> 1; its state crosses over
    (``convert.train_state_from_reference``) and both take step 1 -> 2 on
    the same batch, with ``n_micro`` microbatches.  loss, grad_norm and lr within 1e-5 relative; the
    moments within 1e-4 of their max; every parameter within 2 lr of the
    reference's (an update is lr times a ratio of the moments, so an
    element whose gradient sits at rounding level may move the other way)
    and at most 1% of the elements past 1e-6 (on these inputs: 1 of
    224,380 for zamba2, at 1.45e-6; none for h2o-danube)."""
    jcfg, jm, jp, cfg, m, _ = _pair(arch, remat=remat)
    jstep = jax.jit(jmake_train_step(jm, joptim.AdamWConfig(**OPT),
                                     n_micro=n_micro))
    b0, b1 = _batch(cfg.vocab, 2, S, seed=1), _batch(cfg.vocab, 2, S, seed=2)
    jstate, _ = jstep(jinit_train_state(jp), b0)
    state = train_state_from_reference(cfg, _np(jstate))
    assert int(state.step) == 1
    jstate2, jmet = jstep(jstate, b1)
    state2, met = make_train_step(m, AdamWConfig(**OPT), n_micro=n_micro)(
        state, _tb(b1))
    assert int(state2.step) == 2
    for k in ("loss", "grad_norm", "lr", "ce"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5), k
    j2 = _np(jstate2)
    beyond = total = 0
    for (path, p), (_, w), (_, mo), (_, wm) in zip(
            tree_items(state2.params), tree_items(j2.params),
            tree_items(state2.opt["m"]), tree_items(j2.opt["m"])):
        assert _rel(mo.numpy(), wm) <= 1e-4, path
        d = np.abs(p.numpy() - w)
        assert d.max() <= 2 * OPT["peak_lr"], path
        beyond += int((d > 1e-6).sum())
        total += d.size
    for (path, v), (_, wv) in zip(tree_items(state2.opt["v"]),
                                  tree_items(j2.opt["v"])):
        assert _rel(v.numpy(), wv) <= 1e-4, path
    assert beyond <= 0.01 * total, (beyond, total)


def test_train_state_from_reference_checks_the_tree():
    """The reference's state crosses over with its tree checked; one with
    compression residuals (``err``) crosses with them, f32, equal to the
    reference's leaf for leaf."""
    jcfg, jm, jp, cfg, m, _ = _pair("h2o-danube-1.8b")
    js = _np(jinit_train_state(jp))
    st = train_state_from_reference(cfg, js)
    assert st.step.dtype == torch.int32 and st.err is None
    bad = js._replace(opt={"m": js.opt["m"], "v": {"embed": {}}})
    with pytest.raises(ValueError, match="parameter trees differ"):
        train_state_from_reference(cfg, bad)
    jc = _np(jinit_train_state(jp, compression=True))
    jc = jc._replace(err=jax.tree.map(
        lambda p: (np.asarray(p) * 0.5).astype(np.float32), jc.params))
    st = train_state_from_reference(cfg, jc)
    got, want = list(tree_items(st.err)), list(tree_items(jc.err))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, e), (_, w) in zip(got, want):
        assert e.dtype == torch.float32, path
        np.testing.assert_array_equal(e.numpy(), w, err_msg=str(path))


def test_microbatching_equivalent():
    """n_micro=2 equals n_micro=1 up to the sums' order (the reference's
    ``test_microbatching_equivalent``, on h2o-danube-1.8b SMOKE): the loss
    within 1e-5, grad_norm within 1e-4, ``final_norm`` within rtol 1e-4 /
    atol 1e-6 as there; every other element within 2 lr (a first AdamW
    update is +-lr, so a gradient at rounding level may flip it), and at
    most 1% of all elements past 1e-6."""
    cfg = get_smoke("h2o-danube-1.8b")
    m = build(cfg, device="cpu")
    params = m.init_master(torch.Generator().manual_seed(0))
    batch = _tb(_batch(cfg.vocab, 4, 16))
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    s1, m1 = make_train_step(m, opt, n_micro=1)(init_train_state(params),
                                                batch)
    s2, m2 = make_train_step(m, opt, n_micro=2)(init_train_state(params),
                                                batch)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-4)
    np.testing.assert_allclose(s1.params["final_norm"]["w"].numpy(),
                               s2.params["final_norm"]["w"].numpy(),
                               rtol=1e-4, atol=1e-6)
    beyond = total = 0
    for (path, a), (_, b) in zip(tree_items(s1.params),
                                 tree_items(s2.params)):
        d = (a - b).abs()
        assert float(d.max()) <= 2 * opt.peak_lr, path
        beyond += int((d > 1e-6).sum())
        total += d.numel()
    assert beyond <= 0.01 * total, (beyond, total)
    with pytest.raises(ValueError, match="n_micro"):
        make_train_step(m, opt, n_micro=3)(init_train_state(params), batch)


def test_training_learns():
    """h2o-danube-1.8b SMOKE memorizes a fixed batch: the loss falls below
    0.3 of the first in 25 steps (``tests/test_train.py``)."""
    cfg = get_smoke("h2o-danube-1.8b")
    m = build(cfg, device="cpu")
    state = init_train_state(m.init_master(torch.Generator().manual_seed(0)))
    step = make_train_step(m, AdamWConfig(peak_lr=1e-2, warmup_steps=5,
                                          decay_steps=100))
    batch = _tb(_batch(cfg.vocab, 4, 32, seed=0))
    first = None
    for _ in range(25):
        state, metrics = step(state, batch)
        first = first or float(metrics["loss"])
    assert float(metrics["loss"]) < 0.3 * first


def test_init_master_keeps_the_param_dtype():
    cfg = get_smoke("zamba2-1.2b").replace(compute_dtype="bfloat16")
    m = build(cfg, device="cpu")
    master = m.init_master(torch.Generator().manual_seed(0))
    served = m.init(torch.Generator().manual_seed(0))
    for (path, a), (_, b) in zip(tree_items(master), tree_items(served)):
        assert a.dtype == torch.float32 and b.dtype == torch.bfloat16, path
        assert torch.equal(a.to(torch.bfloat16), b), path


def test_remat_step_equals_plain_step():
    """remat recomputes each superblock in the backward: the same step to
    the bit on the CPU (zamba2 SMOKE)."""
    out = []
    for remat in (False, True):
        cfg = get_smoke("zamba2-1.2b").replace(remat=remat)
        m = build(cfg, device="cpu")
        state = init_train_state(
            m.init_master(torch.Generator().manual_seed(0)))
        out.append(make_train_step(m, AdamWConfig(**OPT))(
            state, _tb(_batch(cfg.vocab, 2, 24))))
    (s0, m0), (s1, m1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    for (path, a), (_, b) in zip(tree_items(s0.params),
                                 tree_items(s1.params)):
        assert torch.equal(a, b), path


# --- restarts and the CLI -------------------------------------------------------


def _small_run():
    cfg = get_smoke("h2o-danube-1.8b")
    m = build(cfg, device="cpu")
    state = init_train_state(m.init_master(torch.Generator().manual_seed(0)))
    step_fn = make_train_step(m, AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                             decay_steps=50))
    stream = TokenStream(TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                             global_batch=4, seed=3))

    def drive(state, step):
        return step_fn(state, _tb(stream.batch_at(step)))[0]

    return state, drive


def test_run_with_restarts_ends_bit_equal(tmp_path):
    """Failures at steps 4 and 9 roll back to the checkpoints of steps 3
    and 9; the final state equals an uninterrupted run's bit for bit."""
    state0, drive = _small_run()
    want = state0
    for s in range(12):
        want = drive(want, s)
    inj = FaultInjector(fail_at_steps=(4, 9))

    def faulty(state, step):
        inj.check(step)
        return drive(state, step)

    final, stats = run_with_restarts(
        init_state=state0, step_fn=faulty, n_steps=12,
        ckpt=CheckpointManager(str(tmp_path), keep=3), ckpt_every=3)
    assert stats == {"restarts": 2, "completed_steps": 12,
                     "resumed_from": [3, 9]}
    assert int(final.step) == 12
    for tree_a, tree_b in ((final.params, want.params),
                           (final.opt, want.opt)):
        for (path, a), (_, b) in zip(tree_items(tree_a), tree_items(tree_b)):
            assert torch.equal(a, b), path


def test_run_with_restarts_budget_exceeded(tmp_path):
    state0, _ = _small_run()

    def always_fail(state, step):
        raise WorkerFailure("node gone")

    with pytest.raises(WorkerFailure):
        run_with_restarts(init_state=state0, step_fn=always_fail, n_steps=5,
                          ckpt=CheckpointManager(str(tmp_path), keep=2),
                          max_restarts=2)


def _cli(*args):
    return ["--device", "cpu", "--arch", "zamba2-1.2b", "--preset", "smoke",
            "--log-every", "1", *map(str, args)]


def _assert_placed_on_the_host_mesh(state):
    """Every leaf a DTensor on a (1, 1) ("data", "model") CPU mesh with
    the placements ``train_state_shardings`` gives there."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.store import _flatten_with_paths
    from repro_torch.sharding.partition import AbstractMesh
    from repro_torch.train import train_state_shardings

    model = build(get_smoke("zamba2-1.2b"), device="cpu")
    _, shardings = train_state_shardings(
        model, AbstractMesh((1, 1), ("data", "model")))
    got = _flatten_with_paths(state)
    want = _flatten_with_paths(shardings)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, t), (_, sharding) in zip(got, want):
        assert isinstance(t, DTensor)
        assert t.device_mesh.mesh_dim_names == ("data", "model")
        assert tuple(t.device_mesh.shape) == (1, 1)
        assert t.device_mesh.device_type == "cpu"
        assert t.placements == sharding.placements


def test_cli_resumes_where_an_uninterrupted_run_goes(tmp_path):
    """5 steps with a checkpoint at 3; the step-5 checkpoint removed, a
    ``--resume`` runs steps 4 and 5 from step 3: the same losses and the
    same final state, bit for bit, as the uninterrupted run.  Both runs
    return their state placed on the (1, 1) host mesh by
    ``train_state_shardings``."""
    ck = tmp_path / "ck"
    state_a, hist_a = train_cli.main(_cli("--steps", 5, "--ckpt", ck,
                                          "--ckpt-every", 3))
    assert [h["step"] for h in hist_a] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(h["loss"]) for h in hist_a)
    assert latest_step(str(ck)) == 5
    shutil.rmtree(ck / "step_00000005")
    state_b, hist_b = train_cli.main(_cli("--steps", 5, "--ckpt", ck,
                                          "--ckpt-every", 3, "--resume"))
    assert [h["step"] for h in hist_b] == [4, 5]
    assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist_a[3:]]
    assert int(state_b.step) == 5 and latest_step(str(ck)) == 5
    for state in (state_a, state_b):
        _assert_placed_on_the_host_mesh(state)
    for (path, a), (_, b) in zip(tree_items(local_tree(state_a.params)),
                                 tree_items(local_tree(state_b.params))):
        assert torch.equal(a, b), path
    assert not any(d.endswith(".tmp") for d in os.listdir(ck))


def test_cli_module_runs_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --arch zamba2-1.2b
    --preset smoke --steps 3``, then ``--steps 5 --resume`` from its
    checkpoint."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    ck = str(tmp_path / "ck")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--arch", "zamba2-1.2b", "--preset", "smoke",
            "--log-every", "1", "--ckpt", ck]
    first = subprocess.run(base + ["--steps", "3"], env=env,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "step     3" in first.stdout and latest_step(ck) == 3
    second = subprocess.run(base + ["--steps", "5", "--resume"], env=env,
                            capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 3" in second.stdout
    assert "step     5" in second.stdout and "step     3" not in second.stdout
    assert latest_step(ck) == 5


def test_cli_and_build_raise_without_a_card():
    """The entry points run on the card unless told otherwise: with no card
    they raise instead of training on the CPU, ``--compress-pod`` too; a
    compression state builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--preset", "smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(get_smoke("zamba2-1.2b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--preset", "smoke", "--steps", "1",
                        "--compress-pod"])
    st = init_train_state({"w": torch.zeros(2, dtype=torch.bfloat16)},
                          compression=True)
    assert st.err["w"].dtype == torch.float32
    assert torch.equal(st.err["w"], torch.zeros(2))


def test_cli_presets():
    assert train_cli.preset_config("zamba2-1.2b", "smoke") == \
        get_smoke("zamba2-1.2b")
    c = train_cli.preset_config("h2o-danube-1.8b", "100m")
    assert (c.d_model, c.vocab, c.remat) == (512, 8192, False)
    # both CLIs default to the reference's arch
    assert train_cli.parse_args([]).arch == "yi-9b"
    assert serve_cli.parse_args([]).arch == "yi-9b"


def test_loss_mask_and_ce_chunks():
    """A loss mask keeps only its rows' tokens; the CE chunk count is the
    largest divisor of S at most 8, as the reference's."""
    assert [transformer._ce_chunks(s) for s in (1, 7, 12, 80, 97)] == \
        [jtransformer._ce_chunks(s) for s in (1, 7, 12, 80, 97)]
    jcfg, jm, jp, cfg, m, params = _pair("h2o-danube-1.8b")
    batch = _batch(cfg.vocab, 2, 12)
    batch["loss_mask"] = np.array([[1.0] * 12, [0.0] * 12], np.float32)
    want = float(jtransformer.loss_fn(jp, batch, jcfg)[0])
    assert float(m.loss(params, _tb(batch))[0]) == pytest.approx(want,
                                                                 rel=1e-5)
