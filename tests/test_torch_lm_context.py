"""The port's cross-attention families against the JAX package.

llama-3.2-vision-11b (an adapter from patch embeddings, a cross layer
every ``cross_every``) and whisper-large-v3 (layer norm, the sinusoidal
encoder, an encoder-decoder) at their SMOKE sizes on the CPU, with the
configs' shape matrix and the model inputs of every arch.  Each test
builds a config in both packages, carries the reference's parameters
across with ``convert.lm_params_from_reference`` and feeds both the same
numpy inputs, made from a seed.  SMOKE initialises the layer norms' ``w``
to ones and ``b`` to zeros, the adapter's ``b`` and the GELU MLP's ``bi``
and ``bo`` to zeros, which would hide a missing or misplaced term: each
test first draws them at random (:func:`_perturb`).  Tolerances are
stated per test.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.configs import shapes_for as jshapes_for  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.state import init_train_state as jinit_train_state  # noqa: E402
from repro.train.trainer import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCHS, PORTED, SHAPES, ShapeSpec, get, get_smoke, shapes_for,
)
from repro_torch.convert import (  # noqa: E402
    lm_params_from_reference, model_config_from_reference,
    train_state_from_reference,
)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build, layers, transformer  # noqa: E402
from repro_torch.models.model_zoo import (  # noqa: E402
    batch_axes, input_specs, materialize_inputs,
)
from repro_torch.models.transformer import pattern_for  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.train import AdamWConfig, make_train_step  # noqa: E402

CONTEXT_ARCHS = ("llama-3.2-vision-11b", "whisper-large-v3")
# reference ``param_count`` at full size
FULL_PARAMS = {"llama-3.2-vision-11b": 9_780_404_224,
               "whisper-large-v3": 1_535_219_200}


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
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _perturb(tree, seed):
    """A numpy parameter tree whose constant-initialised leaves are drawn
    from a seeded generator: every norm's ``w`` U(0.5, 1.5) and ``b``
    N(0, 0.5), the adapter's ``b`` and the MLP biases ``bi`` / ``bo``
    N(0, 0.5)."""
    rng = np.random.default_rng(seed)

    def walk(node, parent):
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v, k)
            elif parent in ("norm", "final_norm", "mlp_norm") and k == "w":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
            elif (parent in ("norm", "final_norm", "mlp_norm", "adapter")
                  and k == "b") or k in ("bi", "bo"):
                out[k] = rng.normal(0.0, 0.5, v.shape).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(_np(tree), None)


def _spec_params(jspec, seed=0):
    """A reference spec tree drawn, perturbed, and the port's copy."""
    jp = _perturb(jlayers.materialize(jax.random.PRNGKey(seed), jspec), seed)
    return jax.tree.map(jnp.asarray, jp), jax.tree.map(_t, jp)


def _cfgs(arch, compute_dtype="float32", **kw):
    jcfg = jget_smoke(arch).replace(compute_dtype=compute_dtype, **kw)
    return jcfg, model_config_from_reference(dataclasses.asdict(jcfg))


def _pair(arch, compute_dtype="float32", seed=0, **kw):
    """Both packages' model of one SMOKE config, the reference's perturbed
    parameters (numpy) and the port's copy of them on the CPU."""
    jcfg, cfg = _cfgs(arch, compute_dtype, **kw)
    jm = jbuild(jcfg)
    jp = _perturb(jm.init(jax.random.PRNGKey(seed)), seed + 1)
    m = build(cfg, device="cpu")
    return jcfg, jm, jp, cfg, m, lm_params_from_reference(cfg, jp)


def _context(cfg, B, seed):
    """The context input of ``cfg``'s family: ``image_embeds`` (B,
    n_img_tokens, d_vision) or ``frames`` (B, n_frames, d_model), f32
    N(0, 1) from a seeded generator."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"image_embeds": rng.normal(
            size=(B, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32)}
    return {"frames": rng.normal(
        size=(B, cfg.n_frames, cfg.d_model)).astype(np.float32)}


def _tb(batch, dtype=None):
    out = {}
    for k, v in batch.items():
        t = _t(v)
        out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return out


def _jb(batch, dtype=None):
    return {k: jnp.asarray(v, dtype) if dtype is not None
            and np.issubdtype(v.dtype, np.floating) else jnp.asarray(v)
            for k, v in batch.items()}


_jencode = jax.jit(jtransformer.encode, static_argnames=("cfg",))
_jcross = jax.jit(jattn.cross_attention, static_argnames=("cfg",))
_jproject = jax.jit(jattn.project_context, static_argnames=("cfg",))
_jdecode_cross = jax.jit(jattn.decode_cross_attention,
                         static_argnames=("cfg",))


# --- configs and the shape matrix -----------------------------------------------


@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_context_configs_round_trip_and_count_as_the_reference(arch):
    """CONFIG and SMOKE cross from the reference field for field, take the
    reference's pattern, and count its parameters (9,780,404,224 and
    1,535,219,200 at full size); every arch is ported."""
    assert set(PORTED) == set(ARCHS) and len(PORTED) == 10
    for jcfg, cfg in ((jget(arch), get(arch)),
                      (jget_smoke(arch), get_smoke(arch))):
        assert model_config_from_reference(dataclasses.asdict(jcfg)) == cfg
        assert pattern_for(cfg) == jtransformer.pattern_for(jcfg)
        assert build(cfg, device="cpu").param_count() == \
            jbuild(jcfg).param_count()
    assert build(get(arch), device="cpu").param_count() == FULL_PARAMS[arch]
    cfg = get(arch)
    if cfg.family == "vlm":
        assert pattern_for(cfg) == (("attn", "mlp") * 4 + ("cross", "mlp"),
                                    8, (), 0)
        with pytest.raises(AssertionError):
            pattern_for(cfg.replace(n_layers=2))
    else:
        assert pattern_for(cfg) == (("attn", "cross", "mlp"), 32, (), 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_for_and_the_shape_matrix_equal_the_reference(arch):
    """``SHAPES`` field for field, and ``shapes_for`` of each arch's CONFIG
    and SMOKE equal the reference's."""
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for jcfg, cfg in ((jget(arch), get(arch)),
                      (jget_smoke(arch), get_smoke(arch))):
        assert shapes_for(cfg) == jshapes_for(jcfg)


# --- layers ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches(rng, dtype):
    """``layer_norm`` with random w and b over rows with a large mean (the
    population variance, not torch's unbiased default, is what the
    reference takes): f32 within 1e-5; bf16 within one bf16 ulp of the
    output's largest magnitude.  ``apply_norm(kind="layer")`` is the same
    function, and ``norm_spec`` gives the reference's leaves."""
    d = 64
    x = (rng.normal(size=(3, 5, d)) * 2.0 + 3.0).astype(np.float32)
    w = rng.uniform(0.5, 1.5, d).astype(np.float32)
    b = rng.normal(0.0, 0.5, d).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = layers.layer_norm(_t(x).to(tdt), _t(w), _t(b))
    assert got.dtype == tdt
    want = np.asarray(jlayers.layer_norm(jnp.asarray(x, dtype),
                                         jnp.asarray(w), jnp.asarray(b)),
                      np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp
    spec = layers.norm_spec(d, "layer")
    jspec = jlayers.norm_spec(d, "layer")
    assert sorted(spec) == sorted(jspec) == ["b", "w"]
    assert (spec["w"].init, spec["b"].init) == ("ones", "zeros")
    same = layers.apply_norm({"w": _t(w), "b": _t(b)}, _t(x).to(tdt),
                             "layer")
    assert torch.equal(same.float(), torch.from_numpy(got))


@pytest.mark.parametrize("n,d", [(1500, 1280), (12, 64), (7, 2), (5, 9)])
def test_sinusoidal_positions_equal_bit_for_bit(n, d):
    """The table of each (n, d), whisper's full size included, equals the
    reference's bit for bit (d = 2 takes ``max(half - 1, 1)``; an odd d
    drops the last column, as the reference does)."""
    got = layers.sinusoidal_positions(n, d)
    want = jlayers.sinusoidal_positions(n, d)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert np.array_equal(got, want)


# --- cross-attention -----------------------------------------------------------


@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_cross_attention_matches(rng, arch):
    """``project_context`` of a context stream (T = 9 positions, past no
    tile) and ``cross_attention`` of 6 queries against it, GQA 4/2 (the
    VLM) or MHA 4/4 (whisper), at f32: within 1e-5."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _spec_params(jattn.cross_attn_spec(jcfg), seed=3)
    assert sorted(tp) == ["wk", "wo", "wq", "wv"]
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    c = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    jk, jv = _jproject(jp, jnp.asarray(c), jcfg)
    k, v = attn.project_context(tp, _t(c), cfg)
    assert k.shape == (2, 9, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(_jcross(jp, jnp.asarray(x), jk, jv, jcfg))
    got = attn.cross_attention(tp, _t(x), k, v, cfg)
    assert got.shape == (2, 6, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_decode_cross_attention_matches(rng, arch):
    """One query a request against the context's keys and values in the
    cache layout (B, Hkv, T, hd), unmasked: f32 within 1e-5; and, as the
    decode path of a cross layer, equal to ``cross_attention`` of the same
    query within 1e-5."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _spec_params(jattn.cross_attn_spec(jcfg), seed=4)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    c = rng.normal(size=(3, 11, cfg.d_model)).astype(np.float32)
    k, v = attn.project_context(tp, _t(c), cfg)
    kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    want = np.asarray(_jdecode_cross(jp, jnp.asarray(x), jcfg,
                                     jnp.asarray(kc.numpy()),
                                     jnp.asarray(vc.numpy())))
    got = attn.decode_cross_attention(tp, _t(x), cfg, kc, vc)
    assert got.shape == (3, 1, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    full = attn.cross_attention(tp, _t(x), k, v, cfg)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)


# --- the encoder --------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_encode_matches(remat):
    """whisper SMOKE's encoder (frames + the sinusoidal table, 2 blocks of
    non-causal self-attention without RoPE and the GELU MLP, the final
    layer norm) at f32 with random norms and biases: within 1e-5 of
    max|y|; with ``remat`` the same values, with and without autograd
    recording."""
    jcfg, jm, jp, cfg, m, p = _pair("whisper-large-v3", seed=5,
                                    remat=remat)
    frames = _context(cfg, 2, 6)["frames"]
    want = np.asarray(_jencode(jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(frames), jcfg))
    got = transformer.encode(p, _t(frames), cfg)
    assert got.shape == (2, cfg.n_frames, cfg.d_model)
    assert _rel(got.numpy(), want) <= 1e-5
    rec = transformer.encode(
        layers.tree_map(lambda t: t.clone().requires_grad_(), p),
        _t(frames), cfg)
    assert rec.requires_grad
    assert torch.equal(rec.detach(), got)


# --- whole models ---------------------------------------------------------------


@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_forward_logits_match(arch):
    """Teacher-forced logits of 10 tokens with the context at f32: within
    1e-5 of max|logit|."""
    jcfg, jm, jp, cfg, m, p = _pair(arch, seed=7)
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (2, 10))
    batch = {"tokens": tok.astype(np.int32), **_context(cfg, 2, 9)}
    want = np.asarray(jax.jit(jm.forward)(jax.tree.map(jnp.asarray, jp),
                                          _jb(batch)))
    got = m.forward(p, _tb(batch))
    assert got.dtype == torch.float32 and got.shape == (2, 10, cfg.vocab)
    assert _rel(got.numpy(), want) <= 1e-5


def _prefill_decode(jcfg, jm, jp, cfg, m, p, dtype, seed):
    """Both packages: a prefill of 7 tokens with the context, then 4
    decode steps.  Returns the (port, reference) logits of each call and
    both caches."""
    B = 2
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, 11)).astype(np.int32)
    ctx = _context(cfg, B, seed + 1)
    jpre, jdec = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jpj, p = jax.tree.map(jnp.asarray, jp), m.load(p)
    jc, c = jm.init_cache(B, 16), m.init_cache(B, 16)
    jl, jc = jpre(jpj, {"tokens": jnp.asarray(toks[:, :7]),
                        **_jb(ctx, dtype)}, jc)
    lg, c = m.prefill(p, {"tokens": _t(toks[:, :7]),
                          **_tb(ctx, cfg.cdtype)}, c)
    outs = [(lg, jl)]
    for t in range(7, 11):
        pos = np.full((B,), t, np.int32)
        jl, jc = jdec(jpj, jnp.asarray(toks[:, t]), jc, jnp.asarray(pos))
        lg, c = m.decode_step(p, _t(toks[:, t]), c, _t(pos))
        outs.append((lg, jl))
    return outs, c, _np(jc)


@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_prefill_and_decode_logits_and_caches_match_at_f32(arch):
    """A prefill of 7 tokens fills the self-attention caches and each cross
    layer's context keys and values (written in place into the
    (B, Hkv, T, hd) entry of ``cache_spec``), then 4 decode steps read
    them: logits within 1e-4 of max|logit|, every cache leaf within 1e-4
    relative."""
    jcfg, jm, jp, cfg, m, p = _pair(arch, seed=10)
    outs, c, jc = _prefill_decode(jcfg, jm, jp, cfg, m, p, None, 11)
    for lg, jl in outs:
        assert lg.dtype == torch.float32
        tau = 1e-4 * float(np.abs(np.asarray(jl)).max())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=tau)
    n_ctx = cfg.n_img_tokens if cfg.family == "vlm" else cfg.n_frames
    crosses = 0
    for path, leaf in layers.tree_items(c):
        want = jc
        for k in path:
            want = want[k]
        assert leaf.shape == want.shape, path
        assert _rel(leaf.numpy(), want) <= 1e-4, path
        if path[-1] in ("ck", "cv"):
            crosses += 1
            assert leaf.shape[-2:] == (n_ctx, cfg.hd)
            assert float(leaf.abs().max()) > 0, path
    assert crosses == 2


@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_bf16_prefill_and_decode_within_the_reference_bound(arch):
    """bf16 compute: the two frameworks round bf16 at other places, so the
    logits agree within the 5e-2 of tests/test_models.py."""
    jcfg, jm, jp, cfg, m, p = _pair(arch, "bfloat16", seed=12)
    outs, c, _ = _prefill_decode(jcfg, jm, jp, cfg, m, p, jnp.bfloat16, 13)
    assert c["blocks"][[k for k in c["blocks"] if "cross" in k][0]][
        "ck"].dtype == torch.bfloat16
    errs = [float(np.abs(lg.numpy() - np.asarray(jl)).max())
            for lg, jl in outs]
    assert all(np.isfinite(lg.numpy()).all() for lg, _ in outs)
    assert max(errs) < 5e-2, errs


# the leaves these families add, whose gradients must not be zero
CONTEXT_LEAVES = {
    "llama-3.2-vision-11b": (("adapter", "w"), ("adapter", "b"),
                             ("blocks", "2_cross", "attn", "wq"),
                             ("blocks", "2_cross", "attn", "wk"),
                             ("blocks", "2_cross", "attn", "wv"),
                             ("blocks", "2_cross", "attn", "wo")),
    "whisper-large-v3": (("encoder", "blocks", "0_attn", "attn", "wq"),
                         ("encoder", "blocks", "1_mlp", "mlp", "bi"),
                         ("encoder", "final_norm", "b"),
                         ("blocks", "1_cross", "attn", "wk"),
                         ("blocks", "1_cross", "norm", "b"),
                         ("final_norm", "b")),
}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    """``loss_fn`` and every parameter's gradient at f32 against
    ``jax.value_and_grad`` of the reference's, with remat on (each
    superblock and encoder block under ``torch.utils.checkpoint``, the
    context stream an argument of each) and off: loss within 1e-5
    relative, each leaf within 1e-4 of its max|g|; the adapter, the
    encoder, the cross projections and the layer norms' ``b`` among
    them, each nonzero."""
    jcfg, jm, jp, cfg, m, params = _pair(arch, seed=14, remat=remat)
    tok = np.random.default_rng(15).integers(0, cfg.vocab, (2, 13))
    batch = {"tokens": tok[:, :-1].astype(np.int32),
             "targets": tok[:, 1:].astype(np.int32), **_context(cfg, 2, 16)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(p, b, jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, jp), _jb(batch))
    flat = []

    def leaf(t):
        flat.append(t.requires_grad_())
        return t

    loss, aux = m.loss(layers.tree_map(leaf, params), _tb(batch))
    grads = torch.autograd.grad(loss, flat)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert float(aux["ce"].detach()) == pytest.approx(float(jaux["ce"]),
                                                      rel=1e-5)
    it = iter(grads)
    got = dict(layers.tree_items(layers.tree_map(lambda _: next(it),
                                                 params)))
    want = dict(layers.tree_items(_np(jg)))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert np.isfinite(w).all() and np.abs(w).max() > 0, path
        assert _rel(g.numpy(), w) <= 1e-4, path
    for path in CONTEXT_LEAVES[arch]:
        assert float(got[path].abs().max()) > 0, path


OPT = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)


@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_train_step_matches_reference(arch):
    """The reference takes step 0 -> 1 on a batch with its context; its
    state crosses over (``convert.train_state_from_reference`` takes the
    adapter and encoder trees as they are) and both take step 1 -> 2 on
    a second batch: loss, grad_norm, lr and ce within 1e-5 relative, the
    moments within 1e-4 of their max, every parameter within 2 lr of the
    reference's and at most 1% of the elements past 1e-6 (as
    tests/test_torch_train.py holds the other families)."""
    jcfg, jm, jp, cfg, m, _ = _pair(arch, seed=17)
    jstep = jax.jit(jmake_train_step(jm, joptim.AdamWConfig(**OPT)))

    def batch(seed):
        tok = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 13))
        return {"tokens": tok[:, :-1].astype(np.int32),
                "targets": tok[:, 1:].astype(np.int32),
                **_context(cfg, 2, seed + 1)}

    b0, b1 = batch(18), batch(20)
    jstate, _ = jstep(jinit_train_state(jax.tree.map(jnp.asarray, jp)),
                      _jb(b0))
    state = train_state_from_reference(cfg, _np(jstate))
    jstate2, jmet = jstep(jstate, _jb(b1))
    state2, met = make_train_step(m, AdamWConfig(**OPT))(state, _tb(b1))
    assert int(state2.step) == 2
    for k in ("loss", "grad_norm", "lr", "ce"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5), k
    j2 = _np(jstate2)
    beyond = total = 0
    for (path, p), (_, w), (_, mo), (_, wm), (_, v), (_, wv) in zip(
            layers.tree_items(state2.params), layers.tree_items(j2.params),
            layers.tree_items(state2.opt["m"]), layers.tree_items(j2.opt["m"]),
            layers.tree_items(state2.opt["v"]),
            layers.tree_items(j2.opt["v"])):
        assert _rel(mo.numpy(), wm) <= 1e-4, path
        assert _rel(v.numpy(), wv) <= 1e-4, path
        d = np.abs(p.numpy() - w)
        assert d.max() <= 2 * OPT["peak_lr"], path
        beyond += int((d > 1e-6).sum())
        total += d.size
    assert beyond <= 0.01 * total, (beyond, total)


# --- inputs of a workload shape -------------------------------------------------

_DTYPE_NAMES = {torch.int32: "int32", torch.float32: "float32",
                torch.bfloat16: "bfloat16"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_materialize_inputs_and_batch_axes(arch, kind):
    """For each assigned shape of ``kind``: ``input_specs`` of the full
    config equals the reference's in keys, shapes and dtypes, and
    ``batch_axes`` equals the reference's.  ``materialize_inputs`` at
    SMOKE size (24 positions, 2 rows) draws each spec's shape and dtype:
    tokens in [0, vocab), ``pos`` in [0, seq_len), the context 0.02 N(0, 1)
    in the compute dtype, the same draws from the same seed."""
    cfg, jcfg = get(arch), jget(arch)
    for name, shp in SHAPES.items():
        if shp.kind != kind:
            continue
        got = input_specs(cfg, shp)
        want = jzoo.input_specs(jcfg, JSHAPES[name])
        assert got.keys() == want.keys(), name
        for k, (s, dt) in got.items():
            assert tuple(s) == tuple(want[k].shape), (name, k)
            assert _DTYPE_NAMES[dt] == str(want[k].dtype), (name, k)
    assert batch_axes(cfg, kind) == jzoo.batch_axes(jcfg, kind)
    scfg = get_smoke(arch)
    shape = ShapeSpec("smoke", 24, 2, kind)
    specs = input_specs(scfg, shape)
    jsmoke = jzoo.input_specs(jget_smoke(arch), JShapeSpec("smoke", 24, 2,
                                                           kind))
    assert specs.keys() == jsmoke.keys()
    draw = materialize_inputs(torch.Generator().manual_seed(0), scfg, shape)
    again = materialize_inputs(torch.Generator().manual_seed(0), scfg, shape)
    assert list(draw) == sorted(specs)
    for k, (s, dt) in specs.items():
        t = draw[k]
        assert tuple(t.shape) == tuple(s) and t.dtype == dt, k
        assert torch.equal(t, again[k]), k
        if dt.is_floating_point:
            assert dt == scfg.cdtype
            sd = float(t.float().std())
            assert 0.015 < sd < 0.025, (k, sd)
        else:
            hi = scfg.vocab if k in ("tokens", "targets", "token") else 24
            assert int(t.min()) >= 0 and int(t.max()) < hi, k
    if kind == "train":
        m = build(scfg, device="cpu")
        out = m.forward(m.init(torch.Generator().manual_seed(0)), draw)
        assert out.shape == (2, 24, scfg.vocab)
        assert bool(torch.isfinite(out).all())


# --- refusals ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_engine_and_clis_refuse_the_context_families(arch):
    """The engine's requests carry tokens only, as the reference's do, so
    ``Engine`` refuses a vlm or encdec model, and so do the serving and
    training CLIs (the token pipeline makes no context)."""
    m = build(get_smoke(arch), device="cpu")
    with pytest.raises(NotImplementedError, match="context stream"):
        Engine(m, device="cpu")
    with pytest.raises(NotImplementedError, match="context stream"):
        serve_cli.main(["--arch", arch, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="tokens only"):
        train_cli.main(["--arch", arch, "--steps", "1", "--device", "cpu"])


# --- the card check's coverage, on the CPU -----------------------------------------


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("arch", CONTEXT_ARCHS)
def test_card_check_takes_every_attention_form_a_served_prefill_launches(
        arch, monkeypatch):
    """``chip_smoke.served_attention_rows`` holds the kernel to its plain
    version on the served prefills' own q, k and v: it must record one
    call of every form a prefill of each batch launches (the VLM's self
    and cross layers, whisper's encoder, self and cross layers), at the
    served shapes (batch, n - 1 query rows, the context's length), and
    the recorded tensors must be the ones the model attends over."""
    cs = _chip_smoke()
    cfg = get_smoke(arch)
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    lengths = (9, 20)
    batches = [cs.context_inputs(cfg, gen, n, 4) for n in lengths]
    oracle = []

    def row(q, k, v, causal, use):
        oracle.append((use, causal, q, k, v))
        return {"use": use, "B": q.shape[0], "L": q.shape[2],
                "Lkv": k.shape[2], "causal": causal}

    monkeypatch.setattr(cs, "attention_row", row)
    monkeypatch.setattr(cs, "SERVE_MAX_LEN", 64)
    rows = cs.served_attention_rows(m, params, batches)
    T = cfg.n_img_tokens if cfg.family == "vlm" else cfg.n_frames
    want = [("self", n - 1, n - 1, True) for n in lengths]
    want += [("cross", n - 1, T, False) for n in lengths]
    if cfg.family == "encdec":
        want.append(("encoder", T, T, False))
    got = [(r["use"], r["L"], r["Lkv"], r["causal"]) for r in rows]
    assert sorted(got) == sorted(want)
    assert all(r["B"] == 4 for r in rows)
    for use, causal, q, k, v in oracle:
        assert q.shape[1] == cfg.n_heads and k.shape[1] == cfg.n_kv_heads
        assert bool(torch.isfinite(q).all() and torch.isfinite(v).all())


def test_logit_gaps_and_the_anchor_verdict():
    """The card checks' logit comparison (``chip_smoke.logit_gaps``) counts
    rows, not calls, and the CPU anchor's verdict needs equal tokens, the
    expected rows and every logit within 1e-4 of the largest |logit|."""
    cs = _chip_smoke()
    want = torch.tensor([[1.0, 3.0, -2.0], [0.5, -4.0, 2.0]])
    got = want + torch.tensor([[0.0, 0.0, 3e-4], [0.0, 0.0, -2.0]])
    g = cs.logit_gaps([(want, got), (want[0], want[0])])
    assert g["compared"] == 3 and g["top1_agree"] == 2
    assert g["max_abs_err"] == pytest.approx(2.0)
    assert g["max_abs_logit"] == 4.0
    assert g["max_rel_l2"] == pytest.approx(
        2.0 / float(want[1].norm()), rel=1e-6)
    ok = cs.anchor_verdict([[1, 2]], [[1, 2]], [(want[0], want[0] + 2e-4)],
                           1)
    assert ok["ok"] and ok["tokens_equal"] and ok["decode_logits_compared"] == 1
    assert not cs.anchor_verdict([[1, 2]], [[1, 2]],
                                 [(want[0], want[0] + 5e-4)], 1)["ok"]
    assert not cs.anchor_verdict([[1, 2]], [[1, 3]],
                                 [(want[0], want[0])], 1)["ok"]
    assert not cs.anchor_verdict([[1, 2]], [[1, 2]],
                                 [(want[0], want[0])], 2)["ok"]
