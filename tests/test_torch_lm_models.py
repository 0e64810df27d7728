"""The port's LM modules against the JAX package, on shared parameters.

Each test builds a SMOKE config in both packages, carries the reference's
parameters across with ``convert.lm_params_from_reference`` and feeds both
the same numpy inputs.  At f32 compute the two agree to float rounding
(stated per test); at bf16 within the reference's own prefill-vs-forward
bound (tests/test_models.py, 5e-2).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import ARCHS, PORTED, get, get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_reference, model_config_from_reference,
)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build, layers, ssm  # noqa: E402
from repro_torch.models.transformer import pattern_for  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402


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


class _Jitted:
    """The reference model's prefill and decode step under ``jax.jit``."""

    def __init__(self, jm):
        self.init_cache = jm.init_cache
        self.prefill = jax.jit(jm.prefill)
        self.decode_step = jax.jit(jm.decode_step)


def _pair(arch, compute_dtype="float32", seed=0):
    """Both packages' model of one SMOKE config, and one set of params."""
    jcfg = jget_smoke(arch).replace(compute_dtype=compute_dtype)
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    m = build(cfg, device="cpu")
    return (_Jitted(jm), jp, m,
            m.load(lm_params_from_reference(cfg, _np(jp))), cfg)


_jprefill_attention = jax.jit(jattn.prefill_attention,
                              static_argnames=("cfg",))
_jdecode_attention = jax.jit(jattn.decode_attention,
                             static_argnames=("cfg", "ring"))
_jmamba2_forward = jax.jit(jssm.mamba2_forward, static_argnames=("cfg",))


def _spec_params(jspec, seed=0):
    jp = jlayers.materialize(jax.random.PRNGKey(seed), jspec)
    return jp, jax.tree.map(_t, _np(jp))


# --- configs and parameters ----------------------------------------------------


@pytest.mark.parametrize("arch", PORTED)
def test_configs_convert_and_count_as_the_reference(arch):
    for jcfg, cfg in ((jget(arch), get(arch)),
                      (jget_smoke(arch), get_smoke(arch))):
        assert model_config_from_reference(dataclasses.asdict(jcfg)) == cfg
        assert build(cfg, device="cpu").param_count() == \
            jbuild(jcfg).param_count()
    assert get(arch).cdtype == torch.bfloat16
    assert get(arch).pdtype == torch.float32


def test_reference_hybrid_tail_runs_tail_squared_layers():
    """The reference stacks its tail pattern of ``tail`` layers ``tail``
    times, so zamba2-1.2b's 38 configured layers run as 6 x 6 + 2 x 2 = 40
    Mamba-2 layers (SMOKE's tail of one hides it).  The port follows the
    reference, so the parameter trees, and the SSD launches a prefill,
    match it."""
    ab = jbuild(jget("zamba2-1.2b")).abstract_params()
    assert sorted(ab["tail"]) == ["0_mamba2", "1_mamba2"]
    assert ab["tail"]["0_mamba2"]["ssm"]["in_proj"].shape[0] == 2
    pattern, n_super, tail, n_tail = pattern_for(get("zamba2-1.2b"))
    assert (n_super, len(pattern), n_tail, len(tail)) == (6, 6, 2, 2)
    assert n_super * len(pattern) + n_tail * len(tail) == 40
    pattern, n_super, tail, n_tail = pattern_for(get_smoke("zamba2-1.2b"))
    assert n_super * len(pattern) + n_tail * len(tail) == 5


def test_unported_archs_raise_and_name_the_queue():
    for arch in set(ARCHS) - set(PORTED):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get(arch)
    with pytest.raises(KeyError):
        get("no-such-arch")


def test_params_from_reference_check_the_tree():
    jcfg = jget_smoke("zamba2-1.2b")
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))

    def tree():
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            jbuild(jcfg).abstract_params())

    p = lm_params_from_reference(cfg, tree())
    # stacked layers stay stacked: layer i is a view of row i
    assert p["blocks"]["0_mamba2"]["ssm"]["in_proj"].shape[0] == 2
    bad = tree()
    del bad["shared"]["mlp_norm"]
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_reference(cfg, bad)
    bad = tree()
    bad["final_norm"]["w"] = bad["final_norm"]["w"][:-1]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_reference(cfg, bad)


def test_init_draws_from_the_generator_in_the_compute_dtype():
    cfg = get_smoke("zamba2-1.2b")
    m = build(cfg, device="cpu")
    a = m.init(torch.Generator().manual_seed(3))
    b = m.init(torch.Generator().manual_seed(3))
    items = list(layers.tree_items(a))
    assert len(items) == len(list(layers.tree_items(m.param_specs)))
    for (path, x), (_, y) in zip(items, layers.tree_items(b)):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y), path
    assert m.load(a)["embed"]["table"] is a["embed"]["table"]   # no copy


def test_device_rule_build_and_engine():
    """Without ``device=`` both run on the card; on a host without one
    they raise rather than fall back to the CPU."""
    cfg = get_smoke("zamba2-1.2b")
    if torch.cuda.is_available():
        assert build(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    m = build(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(m, n_slots=1, max_len=8)


# --- primitive layers -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_mlp_match(rng, dtype):
    """f32: 1e-6 relative (the same ops); bf16: the rounding order is the
    reference's, so values agree to one bf16 ulp (2^-7 relative)."""
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = _t(x).to(getattr(torch, dtype))
    got = layers.rms_norm(tx, _t(w), 1e-5).float().numpy()
    want = np.asarray(jlayers.rms_norm(jx, jnp.asarray(w), 1e-5), np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    pos = np.array([[0, 3, 7, 100, 2047]] * 2, np.int32)
    got = layers.apply_rope(tx, _t(pos), 10000.0).float().numpy()
    want = np.asarray(jlayers.apply_rope(jx, jnp.asarray(pos), 10000.0),
                      np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 4)
    jp, tp = _spec_params(jlayers.mlp_spec(16, 32))
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    got = layers.apply_mlp(tp, _t(h)).numpy()
    want = np.asarray(jlayers.apply_mlp(jp, jnp.asarray(h)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_logits_are_f32_from_bf16_operands(rng):
    """``preferred_element_type=f32``: the logits of bf16 activations are
    f32, equal to the reference's within f32 summation order."""
    jp, tp = _spec_params(jlayers.embed_spec(40, 16, tie=False))
    tp = layers.tree_map(lambda t: t.to(torch.bfloat16), tp)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    got = layers.logits_out(tp, _t(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    want = jlayers.logits_out(jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                           jp), jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    tok = np.array([[1, 39, 7]], np.int32)
    np.testing.assert_array_equal(
        layers.embed_tokens(tp, _t(tok), torch.float32).numpy(),
        np.asarray(jlayers.embed_tokens(jp, jnp.asarray(tok), jnp.bfloat16)
                   .astype(jnp.float32)))


# --- attention --------------------------------------------------------------------


@pytest.mark.parametrize("ring", [False, True])
def test_prefill_and_decode_attention_match(rng, ring):
    """h2o SMOKE (GQA 4/2, window 16): prefill fills the linear cache, then
    decode runs past the window in the linear or the ring layout.  Outputs
    and caches at f32 agree to 1e-5."""
    cfg = get_smoke("h2o-danube-1.8b").replace(compute_dtype="float32")
    jcfg = jget_smoke("h2o-danube-1.8b").replace(compute_dtype="float32")
    jp, tp = _spec_params(jattn.self_attn_spec(jcfg))
    B, S, T = 2, 12, 8
    x = rng.normal(size=(B, S + T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jc = jattn.init_cache(jcfg, B, S + T)
    c = attn.init_cache(cfg, B, S + T)
    jy, jc = _jprefill_attention(jp, jnp.asarray(x[:, :S]), jcfg, jc,
                                 positions=jnp.asarray(pos))
    y, c = attn.prefill_attention(tp, _t(x[:, :S]), cfg, c,
                                  positions=_t(pos))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-5, atol=1e-5)
    if ring:   # the ring holds the last `window` positions
        W = cfg.window
        jc = jattn.init_cache(jcfg, B, S + T, ring=True)
        c = attn.init_cache(cfg, B, S + T, ring=True)
        assert c["k"].shape[2] == W
        start = 0
    else:
        start = S
    for t in range(start, S + T):
        p = np.full((B,), t, np.int32)
        jy, jc = _jdecode_attention(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                    jc, pos=jnp.asarray(p), ring=ring)
        y, c = attn.decode_attention(tp, _t(x[:, t:t + 1]), cfg, c,
                                     pos=_t(p), ring=ring)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(c["v"].numpy(), np.asarray(jc["v"]),
                               rtol=1e-5, atol=1e-5)


def test_cache_write_clamps_as_dynamic_update_slice(rng):
    """A write that would run past the cache is moved back to fit."""
    cache = torch.zeros(2, 1, 6, 2)
    new = _t(rng.normal(size=(2, 1, 3, 2)).astype(np.float32))
    attn._write_at(cache, new, torch.tensor([1, 5]))
    want = jattn._write_at(jnp.zeros((2, 1, 6, 2)), jnp.asarray(new.numpy()),
                           jnp.asarray([1, 5]))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want))


# --- Mamba-2 ----------------------------------------------------------------------


def test_mamba2_forward_and_step_match(rng):
    """zamba2 SMOKE's Mamba-2 block (G = 2): the SSD prefill at L = 9 with
    no state, then 3 recurrent steps from its state; outputs and states at
    f32 agree to 1e-5."""
    jcfg = jget_smoke("zamba2-1.2b").replace(compute_dtype="float32")
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    jp, tp = _spec_params(jssm.mamba2_spec(jcfg), seed=4)
    x = (rng.normal(size=(2, 12, cfg.d_model))).astype(np.float32)
    jy, js = _jmamba2_forward(jp, jnp.asarray(x[:, :9]), jcfg)
    y, s = ssm.mamba2_forward(tp, _t(x[:, :9]), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5, atol=1e-5)
    for t in range(9, 12):
        jy, js = _jmamba2_forward(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                     state=js)
        y, s = ssm.mamba2_forward(tp, _t(x[:, t:t + 1]), cfg, state=s)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(s["ssm"].numpy(), np.asarray(js["ssm"]),
                               rtol=1e-5, atol=1e-5)


def test_mamba2_long_prefill_takes_the_chunked_scan(rng):
    """At L = 80 (> 64) both packages take the chunked scan at 128 through
    the seam, not the config's chunk of 16."""
    jcfg = jget_smoke("zamba2-1.2b").replace(compute_dtype="float32")
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    assert cfg.ssm.chunk == 16
    jp, tp = _spec_params(jssm.mamba2_spec(jcfg), seed=5)
    x = rng.normal(size=(1, 80, cfg.d_model)).astype(np.float32)
    jy, js = _jmamba2_forward(jp, jnp.asarray(x), jcfg)
    y, s = ssm.mamba2_forward(tp, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s["ssm"].numpy(), np.asarray(js["ssm"]),
                               rtol=1e-5, atol=2e-6)


# --- whole models -----------------------------------------------------------------


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_logits_match_at_f32(rng, arch):
    """SMOKE prefill of 7 tokens, then 4 decode steps: logits within 1e-4
    of the largest logit (f32, summation order), caches too.  The vlm and
    encdec families get the same context in both packages (their
    ``image_embeds`` or ``frames``, N(0, 1) from the test's generator)."""
    jm, jp, m, p, cfg = _pair(arch)
    B = 2
    toks = rng.integers(0, cfg.vocab, (B, 11)).astype(np.int32)
    ctx = {}
    if cfg.family == "vlm":
        ctx["image_embeds"] = rng.normal(
            size=(B, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32)
    if cfg.family == "encdec":
        ctx["frames"] = rng.normal(
            size=(B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    jc, c = jm.init_cache(B, 16), m.init_cache(B, 16)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :7]),
                             **{k: jnp.asarray(v) for k, v in ctx.items()}},
                        jc)
    lg, c = m.prefill(p, {"tokens": _t(toks[:, :7]),
                          **{k: _t(v) for k, v in ctx.items()}}, c)
    outs = [(lg, jl)]
    for t in range(7, 11):
        pos = np.full((B,), t, np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t]), jc,
                                jnp.asarray(pos))
        lg, c = m.decode_step(p, _t(toks[:, t]), c, _t(pos))
        outs.append((lg, jl))
    for lg, jl in outs:
        assert lg.dtype == torch.float32
        tau = 1e-4 * float(np.abs(np.asarray(jl)).max())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=tau)
    for path, leaf in layers.tree_items(c):
        want = _np(jc)
        for k in path:
            want = want[k]
        np.testing.assert_allclose(leaf.float().numpy(), want, rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


def test_zamba2_bf16_prefill_decode_within_the_reference_bound(rng):
    """bf16 compute: the two frameworks round bf16 at other places, so the
    logits agree within the 5e-2 of tests/test_models.py."""
    jm, jp, m, p, cfg = _pair("zamba2-1.2b", "bfloat16", seed=1)
    assert p["blocks"]["0_mamba2"]["ssm"]["A_log"].dtype == torch.bfloat16
    B = 2
    toks = rng.integers(0, cfg.vocab, (B, 12)).astype(np.int32)
    jc, c = jm.init_cache(B, 16), m.init_cache(B, 16)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, jc)
    lg, c = m.prefill(p, {"tokens": _t(toks[:, :8])}, c)
    errs = [float(np.abs(lg.numpy() - np.asarray(jl)).max())]
    for t in range(8, 12):
        pos = np.full((B,), t, np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t]), jc,
                                jnp.asarray(pos))
        lg, c = m.decode_step(p, _t(toks[:, t]), c, _t(pos))
        errs.append(float(np.abs(lg.numpy() - np.asarray(jl)).max()))
    assert max(errs) < 5e-2, errs
