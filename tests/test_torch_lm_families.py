"""The port's remaining dense families and Mamba-1 against the JAX package.

yi-9b (GQA), granite-34b (MQA and the GELU MLP with biases), qwen1.5-32b
(qkv biases) and falcon-mamba-7b (the chunked selective scan) at their
SMOKE sizes on the CPU.  Each test builds a config in both packages,
carries the reference's parameters across with
``convert.lm_params_from_reference`` and feeds both the same numpy inputs,
made from a seed.  SMOKE initialises some leaves to constants (the biases
and ``dt_b`` to zeros, ``A_log`` to zeros so that every decay is the same,
``D`` to ones), which would hide a missing term: each test first sets
them to seeded random values (:func:`_perturb`).  Tolerances are stated
per test.  The package exports of ``repro_torch.kernels`` and the entry
points (``launch/serve.py``, ``launch/train.py``) run here too.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels as jkernels  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
import repro_torch.kernels as kernels  # noqa: E402
from repro_torch.configs import ARCHS, PORTED, get  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_reference, model_config_from_reference,
)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build, layers, ssm  # noqa: E402
from repro_torch.models.transformer import pattern_for  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

NEW_ARCHS = ("yi-9b", "granite-34b", "qwen1.5-32b", "falcon-mamba-7b")
# the leaves SMOKE initialises to constants
CONSTANT_LEAVES = ("bq", "bk", "bv", "bi", "bo", "dt_b", "A_log", "D")


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
    """A numpy parameter tree with every leaf of ``CONSTANT_LEAVES`` drawn
    from a seeded generator: biases N(0, 0.5), ``dt_b`` N(-1, 0.5),
    ``A_log`` U(-1, 1.5) (decays from exp(-1/e) to exp(-4.5) a unit of
    dt), ``D`` U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name == "A_log":
            return rng.uniform(-1.0, 1.5, shape)
        if name == "D":
            return rng.uniform(0.5, 1.5, shape)
        if name == "dt_b":
            return rng.normal(-1.0, 0.5, shape)
        return rng.normal(0.0, 0.5, shape)

    def walk(node):
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in CONSTANT_LEAVES:
                out[k] = draw(k, v.shape).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(_np(tree))


def _spec_params(jspec, seed=0):
    """A reference spec tree drawn, perturbed, and the port's copy."""
    jp = _perturb(jlayers.materialize(jax.random.PRNGKey(seed), jspec), seed)
    return jax.tree.map(jnp.asarray, jp), jax.tree.map(_t, jp)


class _Jitted:
    """The reference model's prefill and decode step under ``jax.jit``."""

    def __init__(self, jm):
        self.init_cache = jm.init_cache
        self.prefill = jax.jit(jm.prefill)
        self.decode_step = jax.jit(jm.decode_step)


def _pair(arch, compute_dtype="float32", seed=0):
    """Both packages' model of one SMOKE config, the reference's perturbed
    parameters (numpy) and the port's copy in its compute dtype."""
    jcfg = jget_smoke(arch).replace(compute_dtype=compute_dtype)
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    jm = jbuild(jcfg)
    jp = _perturb(jm.init(jax.random.PRNGKey(seed)), seed + 1)
    m = build(cfg, device="cpu")
    return jcfg, jm, jp, cfg, m, lm_params_from_reference(cfg, jp)


_jprefill_attention = jax.jit(jattn.prefill_attention,
                              static_argnames=("cfg",))
_jdecode_attention = jax.jit(jattn.decode_attention,
                             static_argnames=("cfg", "ring"))
_jmamba1_forward = jax.jit(jssm.mamba1_forward, static_argnames=("cfg",))


# --- configs ---------------------------------------------------------------------


def test_ported_archs_and_the_mamba1_config_round_trip():
    """``PORTED`` holds every arch of the reference (these four, danube,
    zamba2, the two MoE archs of tests/test_torch_lm_moe.py and the two
    cross-attention archs of tests/test_torch_lm_context.py);
    falcon-mamba-7b's ``SSMConfig`` (``kind="mamba1"``, ``dt_rank``,
    ``chunk``) crosses from the reference field for field, and each
    family takes its pattern."""
    assert set(PORTED) == set(ARCHS) == {
        "h2o-danube-1.8b", "zamba2-1.2b", *NEW_ARCHS,
        "llama4-scout-17b-a16e", "moonshot-v1-16b-a3b",
        "llama-3.2-vision-11b", "whisper-large-v3"}
    cfg = model_config_from_reference(
        dataclasses.asdict(jget("falcon-mamba-7b")))
    assert cfg == get("falcon-mamba-7b")
    assert (cfg.ssm.kind, cfg.ssm.dt_rank, cfg.ssm.chunk) == ("mamba1", 256,
                                                             64)
    assert pattern_for(cfg) == (("mamba1",), 64, (), 0)
    for arch in NEW_ARCHS[:3]:
        assert pattern_for(get(arch)) == (("attn", "mlp"), get(arch).n_layers,
                                          (), 0)


# --- layers and attention -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_with_biases_matches(rng, dtype):
    """granite's two-matrix MLP, gelu(x Wi + bi) (tanh form) Wo + bo, with
    random biases.  f32: 1e-5; bf16: within one bf16 ulp of the output's
    largest magnitude (the two frameworks round the bf16 intermediates at
    other places)."""
    jp, tp = _spec_params(jlayers.mlp_spec(64, 128, "gelu"), seed=2)
    assert sorted(tp) == ["bi", "bo", "wi", "wo"]
    assert float(tp["bi"].abs().max()) > 0 and float(tp["bo"].abs().max()) > 0
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    got = layers.apply_mlp(tp, _t(x).to(getattr(torch, dtype)), "gelu")
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(jlayers.apply_mlp(jp, jnp.asarray(x, dtype), "gelu"),
                      np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "granite-34b", "yi-9b"])
def test_biased_and_mqa_attention_prefill_and_decode_match(rng, arch):
    """qwen SMOKE (qkv biases, 4/4 heads), granite (MQA, 4/1) and yi (GQA,
    4/2): a prefill of 12 tokens fills the linear cache, then 8 decode
    steps, each of the 4 query heads grouped over the kv heads.  Outputs
    and caches at f32 agree to 1e-5, as
    test_torch_lm_models.py::test_prefill_and_decode_attention_match."""
    jcfg = jget_smoke(arch).replace(compute_dtype="float32")
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    jp, tp = _spec_params(jattn.self_attn_spec(jcfg), seed=3)
    assert ("bq" in tp) == cfg.qkv_bias
    B, S, T = 2, 12, 8
    x = rng.normal(size=(B, S + T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jc = jattn.init_cache(jcfg, B, S + T)
    c = attn.init_cache(cfg, B, S + T)
    assert c["k"].shape[1] == cfg.n_kv_heads
    jy, jc = _jprefill_attention(jp, jnp.asarray(x[:, :S]), jcfg, jc,
                                 positions=jnp.asarray(pos))
    y, c = attn.prefill_attention(tp, _t(x[:, :S]), cfg, c,
                                  positions=_t(pos))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for t in range(S, S + T):
        p = np.full((B,), t, np.int32)
        jy, jc = _jdecode_attention(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                    jc, pos=jnp.asarray(p), ring=False)
        y, c = attn.decode_attention(tp, _t(x[:, t:t + 1]), cfg, c,
                                     pos=_t(p))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-5, atol=1e-5)


# --- Mamba-1 ------------------------------------------------------------------------


def _mamba1_setup(rng, L, seed=4):
    jcfg = jget_smoke("falcon-mamba-7b").replace(compute_dtype="float32")
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    jp, tp = _spec_params(jssm.mamba1_spec(jcfg), seed=seed)
    x = rng.normal(size=(2, L, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, x


def test_mamba1_forward_matches_across_chunks_with_padding(rng):
    """37 tokens at SMOKE's chunk of 16: two whole chunks and one padded
    with dt = 0.  y, the conv state and the final SSM state within 1e-5
    relative (f32; the prefix combine's order differs from XLA's)."""
    jcfg, cfg, jp, tp, x = _mamba1_setup(rng, 37)
    assert cfg.ssm.chunk == 16 and 37 % 16
    assert len(np.unique(np.asarray(jp["A_log"]))) > 1
    jy, js = _jmamba1_forward(jp, jnp.asarray(x), jcfg)
    y, s = ssm.mamba1_forward(tp, _t(x), cfg)
    assert _rel(y.numpy(), np.asarray(jy)) <= 1e-5
    for k in ("conv", "ssm"):
        assert s[k].shape == np.asarray(js[k]).shape
        assert _rel(s[k].numpy(), np.asarray(js[k])) <= 1e-5, k


def test_mamba1_padding_leaves_the_state_unchanged(rng):
    """The scan alone: a padded tail (dt = 0) carries the state through, so
    37 tokens give the state that the same 37 give at a chunk of 37."""
    B, L, Din, N = 2, 37, 6, 4
    u, Bt, Ct = (_t(rng.normal(size=s).astype(np.float32))
                 for s in ((B, L, Din), (B, L, N), (B, L, N)))
    dt = _t(rng.uniform(0.01, 0.5, (B, L, Din)).astype(np.float32))
    A = -_t(rng.uniform(0.5, 2.0, (Din, N)).astype(np.float32))
    h0 = _t(rng.normal(size=(B, Din, N)).astype(np.float32))
    y16, h16 = ssm._mamba1_scan(u, dt, A, Bt, Ct, h0, 16)
    y37, h37 = ssm._mamba1_scan(u, dt, A, Bt, Ct, h0, 37)
    assert _rel(h16.numpy(), h37.numpy()) <= 1e-5
    assert _rel(y16.numpy(), y37.numpy()) <= 1e-5


def test_mamba1_split_prefill_then_decode_equals_one_shot(rng):
    """A prefill split at 21 (not a chunk boundary), a second segment of
    16 tokens from the carried state, then 3 decode steps
    (``mamba1_decode``) carrying {"conv", "ssm"}: the outputs and the
    final state equal the one-shot forward of the 40 tokens within 1e-5
    relative, and the reference's one-shot forward too."""
    jcfg, cfg, jp, tp, x = _mamba1_setup(rng, 40, seed=5)
    y_full, s_full = ssm.mamba1_forward(tp, _t(x), cfg)
    y1, s = ssm.mamba1_forward(tp, _t(x[:, :21]), cfg)
    y2, s = ssm.mamba1_forward(tp, _t(x[:, 21:37]), cfg, state=s)
    ys = [y1, y2]
    for t in range(37, 40):
        y, s = ssm.mamba1_decode(tp, _t(x[:, t:t + 1]), cfg, s)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    assert _rel(y.numpy(), y_full.numpy()) <= 1e-5
    for k in ("conv", "ssm"):
        assert _rel(s[k].numpy(), s_full[k].numpy()) <= 1e-5, k
    jy, js = _jmamba1_forward(jp, jnp.asarray(x), jcfg)
    assert _rel(y.numpy(), np.asarray(jy)) <= 1e-5
    assert _rel(s["ssm"].numpy(), np.asarray(js["ssm"])) <= 1e-5


# --- whole models ---------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_perturbed_prefill_and_decode_logits_match_at_f32(rng, arch):
    """SMOKE with random biases, ``A_log``, ``dt_b`` and ``D``: a prefill
    of 21 tokens (falcon: past a chunk of 16), then 4 decode steps; logits
    within 1e-4 of the largest logit, caches (SSM states included) within
    1e-4 relative."""
    jcfg, jm, jp, cfg, m, p = _pair(arch)
    jm, jpj, p = _Jitted(jm), jax.tree.map(jnp.asarray, jp), m.load(p)
    B, S = 2, 21
    toks = rng.integers(0, cfg.vocab, (B, S + 4)).astype(np.int32)
    jc, c = jm.init_cache(B, 32), m.init_cache(B, 32)
    jl, jc = jm.prefill(jpj, {"tokens": jnp.asarray(toks[:, :S])}, jc)
    lg, c = m.prefill(p, {"tokens": _t(toks[:, :S])}, c)
    outs = [(lg, jl)]
    for t in range(S, S + 4):
        pos = np.full((B,), t, np.int32)
        jl, jc = jm.decode_step(jpj, jnp.asarray(toks[:, t]), jc,
                                jnp.asarray(pos))
        lg, c = m.decode_step(p, _t(toks[:, t]), c, _t(pos))
        outs.append((lg, jl))
    for lg, jl in outs:
        tau = 1e-4 * float(np.abs(np.asarray(jl)).max())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=tau)
    want = _np(jc)
    for path, leaf in layers.tree_items(c):
        w = want
        for k in path:
            w = w[k]
        assert leaf.shape == w.shape, path
        assert _rel(leaf.float().numpy(), w) <= 1e-4, path


# S = 40 takes falcon's scan over two whole chunks of 16 and a padded one
LOSS_CASES = [("yi-9b", 24), ("granite-34b", 24), ("qwen1.5-32b", 24),
              ("falcon-mamba-7b", 40)]


@pytest.mark.parametrize("arch,S", LOSS_CASES)
def test_loss_and_grads_match_reference(arch, S):
    """``loss_fn`` and every parameter's gradient at f32 against
    ``jax.value_and_grad`` of the reference's, perturbed leaves included:
    loss within 1e-5 relative, each leaf within 1e-4 of its max|g|."""
    jcfg, jm, jp, cfg, m, params = _pair(arch, seed=6)
    tok = np.random.default_rng(7).integers(0, cfg.vocab, (2, S + 1))
    batch = {"tokens": tok[:, :-1].astype(np.int32),
             "targets": tok[:, 1:].astype(np.int32)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(p, b, jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, jp), batch)
    flat = []

    def leaf(t):
        flat.append(t.requires_grad_())
        return t

    loss, aux = m.loss(layers.tree_map(leaf, params),
                       {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert float(aux["ce"].detach()) == pytest.approx(float(jaux["ce"]), rel=1e-5)
    it = iter(grads)
    got = layers.tree_map(lambda _: next(it), params)
    for (path, g), (_, w) in zip(layers.tree_items(got),
                                 layers.tree_items(_np(jg))):
        assert np.isfinite(w).all() and np.abs(w).max() > 0, path
        assert _rel(g.numpy(), w) <= 1e-4, path


PROMPTS = ([5, 9, 2, 7, 1, 3], [11, 4], [8, 8, 3, 200, 17, 6, 6, 9, 1, 2],
           [3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8])


def _serve(engine_cls, request_cls, model, params, **kw):
    eng = engine_cls(model, params, n_slots=2, max_len=32, **kw)
    reqs = [request_cls(uid=i, prompt=list(p), max_new_tokens=4 + i)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [list(map(int, r.output)) for r in reqs], eng


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_serves_the_reference_tokens(arch):
    """Five greedy requests through 2 slots at f32 (falcon prefills at
    exact length, the dense archs at a bucket): the same tokens as the
    reference's Engine, in as many steps."""
    jcfg, jm, jp, cfg, m, p = _pair(arch, seed=8)
    want, jeng = _serve(JEngine, JRequest, jm, jax.tree.map(jnp.asarray, jp))
    got, eng = _serve(Engine, Request, m, p, device="cpu")
    assert got == want
    assert eng.steps == jeng.steps and eng.active == 0


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_and_train_clis_run_each_new_arch(capsys, arch):
    """``launch/serve.py`` and ``launch/train.py`` take each new arch on the
    CPU (SMOKE config, seed-0 weights)."""
    serve_cli.main(["--arch", arch, "--requests", "2", "--slots", "2",
                    "--max-new", "3", "--max-len", "32", "--device", "cpu"])
    assert "generated 6 tokens" in capsys.readouterr().out
    state, hist = train_cli.main(["--arch", arch, "--steps", "2", "--seq",
                                  "24", "--global-batch", "2", "--log-every",
                                  "1", "--device", "cpu"])
    assert int(state.step) == 2 and len(hist) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)


# --- package exports ----------------------------------------------------------------


def test_kernels_package_exports_the_reference_entry_points(rng):
    """``repro_torch.kernels`` exports ``ops``, ``ref`` and the entry points
    that ``repro.kernels`` exports (``resolve_impl`` / ``set_default_impl``
    aside: the device picks), and ``fused_detect``.  Each entry point,
    called, is ``ops``' (the plain version on a CPU tensor); as a module
    it still holds its kernel's wrapper."""
    want = {n for n in dir(jkernels) if not n.startswith("_")
            and callable(getattr(jkernels, n))} - {"resolve_impl",
                                                    "set_default_impl"}
    assert want == {"conv2d_gemm", "flash_attention", "hough_vote",
                    "ssd_scan", "tiled_matmul"}
    for name in want | {"fused_detect"}:
        entry = getattr(kernels, name)
        assert callable(entry) and isinstance(entry, types.ModuleType), name
        assert entry.__name__ == f"repro_torch.kernels.{name}"
    assert kernels.ops.__name__ == "repro_torch.kernels.ops"
    assert kernels.ref.__name__ == "repro_torch.kernels.ref"
    q, k, v = (_t(rng.normal(size=(1, 4, 9, 16)).astype(np.float32))
               for _ in range(3))
    assert torch.equal(kernels.flash_attention(q, k, v, causal=True),
                       kernels.ops.flash_attention(q, k, v, causal=True))
    assert kernels.flash_attention.MAX_HEAD_DIM == 128
    a = _t(rng.normal(size=(5, 7)).astype(np.float32))
    b = _t(rng.normal(size=(7, 3)).astype(np.float32))
    assert torch.equal(kernels.tiled_matmul(a, b),
                       kernels.ops.tiled_matmul(a, b))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.flash_attention.flash_attention(q, k, v)


# --- drawing the weights ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_draws_a_stacked_leaf_one_layer_at_a_time(dtype):
    """``materialize`` draws a stacked leaf (first axis ``layers``) one
    layer slice at a time in f32, scaled by the stack's fan-in and cast
    into its slice, so drawing a full model holds one layer's f32 values
    beside the weights (granite-34b's 88 layers on one card); an unstacked
    leaf is one draw of its whole shape."""
    spec = {"blocks": layers.stack({"w": layers.P((6, 5), ("embed", "mlp"))},
                                   3),
            "head": layers.P((4, 2), ("embed", "vocab"))}
    got = layers.materialize(torch.Generator().manual_seed(0), spec,
                             dtype=dtype)
    g = torch.Generator().manual_seed(0)
    want_w = torch.stack([torch.randn((6, 5), generator=g) * 6 ** -0.5
                          for _ in range(3)])
    want_head = torch.randn((4, 2), generator=g) * 4 ** -0.5
    assert got["blocks"]["w"].dtype == dtype
    assert torch.equal(got["blocks"]["w"], want_w.to(dtype))
    assert torch.equal(got["head"], want_head.to(dtype))
