"""The port's MoE family against the JAX package.

``models/moe.py`` (routing, the capacity, the sort dispatch served on the
card, the one-hot dispatch of record, the load-balance loss) and the two
MoE archs, llama4-scout-17b-a16e (16 experts, top-1) and
moonshot-v1-16b-a3b (64, top-6), at their SMOKE sizes on the CPU with one
torch thread.  Each comparison builds a config in both packages, carries
the reference's parameters across (``convert.lm_params_from_reference``)
and feeds both the same numpy inputs, made from a seed.  Tolerances are
stated per test.  The capacity counts every token of a call, so a case
with dropped assignments and one with fewer assignments than experts are
both held, and so is the reference's decode quirk: an idle slot's stale
token routes and takes capacity ahead of an active one.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.configs import MoEConfig, get, get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_reference, model_config_from_reference,
)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build, layers, moe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import pattern_for  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

MOE_ARCHS = ("llama4-scout-17b-a16e", "moonshot-v1-16b-a3b")


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


def _cfgs(arch, compute_dtype="float32", **moe_kw):
    """The SMOKE config in both packages, MoE fields replaced by
    ``moe_kw``."""
    jcfg = jget_smoke(arch).replace(compute_dtype=compute_dtype)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
    return jcfg, model_config_from_reference(dataclasses.asdict(jcfg))


def _moe_params(jcfg, seed=0):
    """One MoE layer's parameters drawn by the reference, and the port's
    copy."""
    jp = _np(jlayers.materialize(jax.random.PRNGKey(seed),
                                 jmoe.moe_spec(jcfg)))
    return jax.tree.map(jnp.asarray, jp), jax.tree.map(_t, jp)


def _reference_drops(jp, x, jcfg) -> int:
    """Assignments the reference's routing drops for ``x`` (B, S, D)."""
    m = jcfg.moe
    x2d = jnp.asarray(x).reshape(-1, x.shape[-1])
    _, _, top_e = jmoe._route(jp, x2d, m)
    flat_e = np.asarray(top_e).reshape(-1)
    seen = np.zeros(m.n_experts, np.int64)
    pos = np.empty_like(flat_e)
    for i, e in enumerate(flat_e):
        pos[i] = seen[e]
        seen[e] += 1
    return int((pos >= jmoe._capacity(x2d.shape[0], m)).sum())


def _pair(arch, seed=0, **moe_kw):
    """Both packages' f32 model of one SMOKE config, the reference's
    parameters (as jnp arrays) and the port's copy."""
    jcfg, cfg = _cfgs(arch, **moe_kw)
    jm = jbuild(jcfg)
    jp = _np(jm.init(jax.random.PRNGKey(seed)))
    m = build(cfg, device="cpu")
    return (jcfg, jm, jax.tree.map(jnp.asarray, jp), cfg, m,
            m.load(lm_params_from_reference(cfg, jp)))


# --- configs --------------------------------------------------------------------


# (total, active) parameters of the reference's Model, to 10 M
COUNTS = {"llama4-scout-17b-a16e": (101.73e9, 11.13e9),
          "moonshot-v1-16b-a3b": (28.06e9, 3.97e9)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_round_trip_and_count_as_the_reference(arch):
    """Both configs cross from the reference with their ``MoEConfig``
    (CONFIG and SMOKE), take the ``("attn", "moe")`` pattern, and count
    the reference's parameters and active parameters."""
    for jcfg, cfg in ((jget(arch), get(arch)),
                      (jget_smoke(arch), get_smoke(arch))):
        got = model_config_from_reference(dataclasses.asdict(jcfg))
        assert got == cfg and isinstance(cfg.moe, MoEConfig)
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
        assert pattern_for(cfg) == (("attn", "moe"), cfg.n_layers, (), 0)
        m, jm = build(cfg, device="cpu"), jbuild(jcfg)
        assert m.param_count() == jm.param_count()
        assert m.active_param_count() == jm.active_param_count()
    total, active = COUNTS[arch]
    m = build(get(arch), device="cpu")
    assert m.param_count() == pytest.approx(total, abs=5e6)
    assert m.active_param_count() == pytest.approx(active, abs=5e6)
    assert build(get("yi-9b"), device="cpu").active_param_count() == \
        jbuild(jget("yi-9b")).param_count()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_vlm_and_encdec_still_raise_and_name_the_queue(arch):
    """The name is from when these two archs were not ported and ``get``
    raised.  They are now: each config (CONFIG and SMOKE) crosses from the
    reference and takes the reference's pattern, which at full size is
    whisper's ("attn", "cross", "mlp") x 32 and the VLM's four self layers
    and one cross layer x 8."""
    want = {"whisper-large-v3": (("attn", "cross", "mlp"), 32, (), 0),
            "llama-3.2-vision-11b": (("attn", "mlp") * 4 + ("cross", "mlp"),
                                     8, (), 0)}
    for jcfg, cfg in ((jget(arch), get(arch)),
                      (jget_smoke(arch), get_smoke(arch))):
        assert model_config_from_reference(dataclasses.asdict(jcfg)) == cfg
        assert pattern_for(cfg) == jtransformer.pattern_for(jcfg)
    assert pattern_for(get(arch)) == want[arch]


# --- the module's functions -------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_the_reference(rng, arch):
    """Router probabilities and renormalised top-k weights within 1e-6,
    the chosen experts equal and in the same (descending) order."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg, seed=1)
    x = rng.normal(size=(40, cfg.d_model)).astype(np.float32)
    jprobs, jw, je = jmoe._route(jp, jnp.asarray(x), jcfg.moe)
    probs, w, e = moe._route(tp, _t(x), cfg.moe)
    assert probs.dtype == w.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_capacity_equals_the_reference_at_every_token_count():
    """``_capacity`` over T = 1-1024 for each config's ``MoEConfig``, at
    the published factor and lifted to ``n_experts`` (C = k T)."""
    for arch in MOE_ARCHS:
        for jm in (jget(arch).moe, jget_smoke(arch).moe):
            m = MoEConfig(**dataclasses.asdict(jm))
            lifted = dataclasses.replace(m, capacity_factor=float(
                m.n_experts))
            for T in range(1, 1025):
                assert moe._capacity(T, m) == jmoe._capacity(T, jm), (arch, T)
                assert moe._capacity(T, lifted) == m.top_k * T
    # llama4's 4 decode slots: one slot an expert
    assert moe._capacity(4, get("llama4-scout-17b-a16e").moe) == 1
    assert moe._capacity(4, get("moonshot-v1-16b-a3b").moe) == 6


# (B, S): 2 x 24 tokens drop assignments at SMOKE's capacity; 1 x 3 gives
# fewer assignments than experts (llama4 SMOKE 3 x 1 < 4, moonshot 3 x 2 < 8)
DISPATCH_CASES = {"drops": (2, 24), "sparse": (1, 3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
@pytest.mark.parametrize("strategy", ["moe_sort", "moe_onehot"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dispatch_matches_the_reference(rng, arch, strategy, case, dtype):
    """Both dispatches against the reference's on the same parameters and
    input: the output within 1e-5 of max|y| at f32 and 1e-2 at bf16 (the
    two frameworks round the bf16 products at other places), the aux loss
    within 1e-5.  The "drops" case drops assignments in the reference's
    routing; the "sparse" case has fewer assignments than experts (at
    llama4's C = 1 it may drop too).  The
    tokens share a component, as a residual stream's do, so the router
    favours some experts."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp, tp = _moe_params(jcfg, seed=2)
    B, S = DISPATCH_CASES[case]
    x = (rng.normal(size=(B, S, cfg.d_model))
         + rng.normal(size=(1, 1, cfg.d_model))).astype(np.float32)
    drops = _reference_drops(jp, x, jcfg)
    if case == "drops":
        assert drops > 0
    else:
        assert B * S * cfg.moe.top_k < cfg.moe.n_experts
    jy, jaux = getattr(jmoe, strategy)(jp, jnp.asarray(x, dtype), jcfg)
    y, aux = getattr(moe, strategy)(tp, _t(x).to(cfg.cdtype), cfg)
    assert y.dtype == cfg.cdtype and aux.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _rel(y.float().numpy(), np.asarray(jy, np.float32)) <= tol
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sort_dispatch_equals_onehot(arch):
    """The port's ``moe_sort`` against its own ``moe_onehot``, as
    tests/test_models.py::test_moe_sort_matches_onehot holds the
    reference's: 0.1-scaled input of 2 x 16 tokens, within 2e-3, aux
    within 1e-5 relative."""
    jcfg, cfg = _cfgs(arch)
    _, tp = _moe_params(jcfg, seed=0)
    x = 0.1 * _t(np.random.default_rng(1).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    y1, a1 = moe.moe_sort(tp, x, cfg)
    y2, a2 = moe.moe_onehot(tp, x, cfg)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-3, atol=2e-3)
    assert float(a1) == pytest.approx(float(a2), rel=1e-5)
    assert moe.apply_moe(tp, x, cfg, strategy="ep")[0].equal(y1)
    assert moe.apply_moe(tp, x, cfg, strategy="onehot")[0].equal(y2)


def test_an_idle_slot_ahead_takes_the_capacity_in_both_packages(rng):
    """The reference decodes every slot, idle or not
    (``repro/serve/engine.py``), and a decode step's capacity counts all
    of them: at llama4's 4 slots an expert holds C = 1.  A stale token in
    slot 0 routed to the same expert as slot 1's token takes the slot, and
    slot 1's assignment drops (output 0, the residual passes).  With slot
    0 routed elsewhere slot 1 keeps its expert.  Both packages agree on
    both inputs within 1e-5 of max|y| (f32)."""
    jcfg, cfg = _cfgs("llama4-scout-17b-a16e")
    jp, tp = _moe_params(jcfg, seed=3)
    assert moe._capacity(4, cfg.moe) == 1
    rows = rng.normal(size=(64, cfg.d_model)).astype(np.float32)
    _, _, top_e = moe._route(tp, _t(rows), cfg.moe)
    e = top_e[:, 0].numpy()
    active = rows[0]
    other = rows[int(np.flatnonzero(e != e[0])[0])]
    outs = {}
    for name, ahead in (("same_expert", rows[int(np.flatnonzero(
            e == e[0])[1])]), ("other_expert", other)):
        # slot 0 idle (stale), slot 1 active, slots 2-3 idle far away
        x = np.stack([ahead, active, other, other])[:, None, :]
        jy, _ = jmoe.moe_sort(jp, jnp.asarray(x), jcfg)
        y, _ = moe.moe_sort(tp, _t(x), cfg)
        assert _rel(y.numpy(), np.asarray(jy)) <= 1e-5, name
        outs[name] = y.numpy()[1, 0]
    assert not outs["same_expert"].any()
    assert np.abs(outs["other_expert"]).max() > 0
    solo, _ = moe.moe_sort(tp, _t(active[None, None, :]), cfg)
    np.testing.assert_allclose(outs["other_expert"], solo.numpy()[0, 0],
                               rtol=1e-6, atol=1e-7)


# --- whole models -----------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match_the_reference(rng, arch):
    """Teacher-forced logits of 2 x 20 tokens (published capacity, f32)
    within 1e-4 of the largest logit; ``moe_aux`` (the sum over layers)
    within 1e-5 relative and nonzero."""
    jcfg, jm, jp, cfg, m, p = _pair(arch, seed=4)
    toks = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    jl, jaux = jax.jit(lambda p, t: jtransformer.forward(
        p, {"tokens": t}, jcfg))(jp, jnp.asarray(toks))
    lg, aux = transformer.forward(p, {"tokens": _t(toks)}, cfg)
    tau = 1e-4 * float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0, atol=tau)
    assert float(aux["moe_aux"]) > 0
    assert float(aux["moe_aux"]) == pytest.approx(float(jaux["moe_aux"]),
                                                  rel=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_then_decode_equals_forward_at_lifted_capacity(rng, arch):
    """As tests/test_models.py::test_prefill_decode_matches_forward holds
    the reference, with the capacity lifted (factor ``n_experts``: C = k T,
    so no path drops): a prefill of 8 tokens then 4 decode steps give the
    teacher-forced logits of 12 within 1e-4 of the largest (f32), and the
    reference's decode logits within the same."""
    n_exp = get_smoke(arch).moe.n_experts
    jcfg, jm, jp, cfg, m, p = _pair(arch, seed=5,
                                    capacity_factor=float(n_exp))
    B, S = 2, 12
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    full, _ = transformer.forward(p, {"tokens": _t(toks)}, cfg)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jc, c = jm.init_cache(B, 16), m.init_cache(B, 16)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, jc)
    lg, c = m.prefill(p, {"tokens": _t(toks[:, :8])}, c)
    pairs = [(lg, jl, full[:, 7])]
    for t in range(8, S):
        pos = np.full((B,), t, np.int32)
        jl, jc = jdecode(jp, jnp.asarray(toks[:, t]), jc, jnp.asarray(pos))
        lg, c = m.decode_step(p, _t(toks[:, t]), c, _t(pos))
        pairs.append((lg, jl, full[:, t]))
    for lg, jl, want in pairs:
        tau = 1e-4 * float(want.abs().max())
        np.testing.assert_allclose(lg.numpy(), want.numpy(), rtol=0,
                                   atol=tau)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=tau)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_the_reference(arch, remat):
    """``loss_fn`` (ce + 0.01 moe_aux) at f32 against
    ``jax.value_and_grad`` of the reference's on 2 x 24 tokens, with and
    without the port's remat (the aux loss leaves each checkpointed
    superblock through the pass's list): loss, ``ce`` and a nonzero
    ``moe_aux`` within 1e-5 relative; every leaf's gradient within 1e-4 of
    its max|g|, the router's and every expert's included."""
    jcfg, jm, jp, cfg, m, _ = _pair(arch, seed=6)
    cfg = cfg.replace(remat=remat)
    m = build(cfg, device="cpu")
    params = lm_params_from_reference(cfg, _np(jp))
    tok = np.random.default_rng(7).integers(0, cfg.vocab, (2, 25))
    batch = {"tokens": tok[:, :-1].astype(np.int32),
             "targets": tok[:, 1:].astype(np.int32)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(p, b, jcfg), has_aux=True))(
            jp, batch)
    flat = []

    def leaf(t):
        flat.append(t.requires_grad_())
        return t

    loss, aux = m.loss(layers.tree_map(leaf, params),
                       {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat)
    assert float(aux["moe_aux"].detach()) > 0
    for got, want in ((loss, jl), (aux["ce"], jaux["ce"]),
                      (aux["moe_aux"], jaux["moe_aux"])):
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    it = iter(grads)
    got = layers.tree_map(lambda _: next(it), params)
    for (path, g), (_, w) in zip(layers.tree_items(got),
                                 layers.tree_items(_np(jg))):
        assert np.isfinite(w).all() and np.abs(w).max() > 0, path
        assert _rel(g.numpy(), w) <= 1e-4, path


PROMPTS = ([5, 9, 2, 7, 1, 3], [11, 4], [8, 8, 3, 200, 17, 6, 6, 9, 1, 2],
           [3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8])
MAX_NEW = (7, 2, 6, 3, 5)


class _IdleCounter:
    """The port's model, counting decode steps that ran an idle slot
    beside an active one."""

    def __init__(self, m):
        self.m, self.engine, self.steps_with_idle = m, None, 0

    def __getattr__(self, name):
        return getattr(self.m, name)

    def decode_step(self, *a, **kw):
        slots = self.engine.slots
        if any(s is None for s in slots) and any(slots):
            self.steps_with_idle += 1
        return self.m.decode_step(*a, **kw)


def _serve(engine_cls, request_cls, model, params, **kw):
    eng = engine_cls(model, params, n_slots=3, max_len=32, **kw)
    reqs = [request_cls(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    for r in reqs:
        eng.submit(r)
    if isinstance(model, _IdleCounter):
        model.engine = eng
    eng.run()
    assert all(r.done for r in reqs)
    return [list(map(int, r.output)) for r in reqs], eng


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_serves_the_reference_tokens(arch):
    """Five greedy requests of 2-7 new tokens through 3 slots at f32 and
    the published capacity, each prefill at a bucket (pads count in its
    capacity): the reference Engine's tokens, in as many steps; requests
    finish at other steps, so idle slots route beside active ones."""
    jcfg, jm, jp, cfg, m, p = _pair(arch, seed=8)
    want, jeng = _serve(JEngine, JRequest, jm, jp)
    probe = _IdleCounter(m)
    got, eng = _serve(Engine, Request, probe, p, device="cpu")
    assert got == want
    assert eng.steps == jeng.steps and eng.active == 0
    assert probe.steps_with_idle > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_and_train_clis_run_each_moe_arch(capsys, arch):
    """``launch/serve.py`` and ``launch/train.py`` take each MoE arch on
    the CPU (SMOKE config, seed-0 weights)."""
    serve_cli.main(["--arch", arch, "--requests", "2", "--slots", "2",
                    "--max-new", "3", "--max-len", "32", "--device", "cpu"])
    assert "generated 6 tokens" in capsys.readouterr().out
    state, hist = train_cli.main(["--arch", arch, "--steps", "2", "--seq",
                                  "24", "--global-batch", "2", "--log-every",
                                  "1", "--device", "cpu"])
    assert int(state.step) == 2 and len(hist) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)
