"""The port's serving engine against the JAX package's, on shared params.

At f32 compute the two engines serve the same greedy tokens; the port's
versions of tests/test_serve.py's engine and sampling tests run beside.
``jax.random`` and ``torch.Generator`` draw differently from one seed, so
every cross-package comparison here is greedy.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_reference, model_config_from_reference,
)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.serve import Engine, Request, sample  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch):
    jcfg = jget_smoke(arch).replace(compute_dtype="float32")
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(cfg, device="cpu")
    p = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jp))
    return jm, jp, m, p


@pytest.fixture(scope="module")
def zamba():
    return _pair("zamba2-1.2b")


# Mixed prompt lengths (3 distinct, so the reference compiles 3 exact
# prefills), more requests than slots, one of them stopped by an EOS.
PROMPTS = ([5, 9, 2, 7, 1, 3], [11, 4], [8, 8, 3, 200, 17, 6, 6, 9, 1, 2],
           [3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8])


def _serve(engine_cls, request_cls, model, params, eos=None, **kw):
    eng = engine_cls(model, params, n_slots=2, max_len=32, **kw)
    reqs = [request_cls(uid=i, prompt=list(p), max_new_tokens=4 + i,
                        eos_id=eos if i == 2 else None)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [list(map(int, r.output)) for r in reqs], eng


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "h2o-danube-1.8b"])
def test_engine_serves_the_reference_tokens(zamba, arch):
    """Five greedy requests through 2 slots: equal tokens at f32 compute,
    and request 2 stops at its EOS (a token it emits, found first)."""
    jm, jp, m, p = zamba if arch == "zamba2-1.2b" else _pair(arch)
    want, _ = _serve(JEngine, JRequest, jm, jp)
    eos = want[2][1]
    want, jeng = _serve(JEngine, JRequest, jm, jp, eos=eos)
    got, eng = _serve(Engine, Request, m, p, eos=eos, device="cpu")
    assert got == want
    assert got[2][-1] == eos and len(got[2]) < 4 + 2
    assert eng.steps == jeng.steps and eng.active == 0 and not eng.queue


def test_engine_readmitted_slot_carries_no_state(zamba):
    """The slot a finished request leaves is prefilled whole (attention
    cache, conv and SSM state): a request served after another in one slot
    gets the tokens it gets alone."""
    _, _, m, p = zamba
    alone, _ = _serve(Engine, Request, m, p, device="cpu")
    eng = Engine(m, p, n_slots=1, max_len=32, device="cpu")
    first = Request(uid=0, prompt=list(PROMPTS[2]), max_new_tokens=5)
    second = Request(uid=1, prompt=list(PROMPTS[0]), max_new_tokens=4)
    eng.submit(first)
    eng.submit(second)
    eng.run()
    assert second.output == alone[0]


def test_engine_matches_manual_decode(zamba):
    """Engine greedy continuation == manual per-token decode (logit-exact),
    the port's form of tests/test_serve.py's test."""
    _, _, m, p = zamba
    prompt = [3, 7, 11, 2, 9]
    eng = Engine(m, p, n_slots=2, max_len=32, prefill_buckets=(4, 8),
                 device="cpu")
    req = Request(uid=0, prompt=list(prompt), max_new_tokens=6)
    eng.submit(req)
    eng.run()

    params = m.load(p)
    cache = m.init_cache(1, 32)
    out = []
    for t in range(len(prompt) + 5):
        tok = prompt[t] if t < len(prompt) else out[-1]
        lg, cache = m.decode_step(params, torch.tensor([tok]), cache,
                                  torch.tensor([t]))
        if t >= len(prompt) - 1:
            out.append(int(torch.argmax(lg[0])))
    assert req.output == out


def test_engine_continuous_batching(zamba):
    """More requests than slots: all finish, slots reused, different lengths."""
    _, _, m, p = zamba
    eng = Engine(m, p, n_slots=2, max_len=64, prefill_buckets=(4, 8, 16),
                 device="cpu")
    reqs = [Request(uid=i, prompt=list(range(1, 3 + i)), max_new_tokens=3 + i)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    for i, r in enumerate(reqs):
        assert len(r.output) == 3 + i
    assert eng.active == 0 and not eng.queue


def test_sampling_greedy_and_topk(rng):
    logits = torch.from_numpy(rng.normal(size=(3, 50)).astype(np.float32))
    g = sample(torch.Generator().manual_seed(0), logits, temperature=0.0)
    assert g.dtype == torch.int32
    np.testing.assert_array_equal(g.numpy(), np.argmax(logits.numpy(), -1))
    top5 = np.argsort(logits.numpy(), axis=-1)[:, -5:]
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        t = sample(gen, logits, temperature=0.7, top_k=5)
        for i in range(3):
            assert int(t[i]) in top5[i]
    a = sample(torch.Generator().manual_seed(7), logits, temperature=1.0)
    b = sample(torch.Generator().manual_seed(7), logits, temperature=1.0)
    assert torch.equal(a, b)


def test_engine_samples_from_its_seeded_generator(zamba):
    _, _, m, p = zamba

    def run(seed):
        eng = Engine(m, p, n_slots=2, max_len=32, seed=seed, device="cpu")
        reqs = [Request(uid=i, prompt=[1, 2, 3 + i], max_new_tokens=6,
                        temperature=1.5) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.output for r in reqs]

    assert run(3) == run(3)


def test_engine_samples_every_slot_at_slot_zeros_temperature(zamba):
    """The reference's ``Engine.step`` quirk, which the port keeps: one
    sample call for every slot at slot 0's temperature
    (repro/serve/engine.py:132-134, repro_torch/serve/engine.py:134-136),
    and an empty slot 0 counts as 0.0, so every slot is greedy.  Neither
    engine is edited; both are held to the same greedy tokens."""
    jm, jp, m, p = zamba
    a, b = [5, 9, 2, 7], [11, 4, 8]
    engines = ((Engine, Request, m, p, {"device": "cpu"}),
               (JEngine, JRequest, jm, jp, {}))

    def serve(engine, request, model, params, kw, reqs):
        eng = engine(model, params, n_slots=2, max_len=32, **kw)
        rs = [request(uid=i, prompt=list(pr), max_new_tokens=n,
                      temperature=t) for i, (pr, n, t) in enumerate(reqs)]
        for r in rs:
            eng.submit(r)
        eng.run()
        return [list(map(int, r.output)) for r in rs]

    greedy_b = serve(*engines[0], [(b, 6, 0.0)])[0]
    assert serve(*engines[1], [(b, 6, 0.0)])[0] == greedy_b
    for eng in engines:
        # slot 0 greedy for one token, then empty: slot 1 asks for 1e4 and
        # gets greedy tokens throughout
        assert serve(*eng, [(a, 1, 0.0), (b, 6, 1e4)])[1] == greedy_b
        # slot 0 at 1e4: slot 1 asks for greedy and is sampled at 1e4
        assert serve(*eng, [(a, 6, 1e4), (b, 6, 0.0)])[1] != greedy_b

def test_launch_serve_runs_on_the_cpu(capsys):
    serve_cli.main(["--arch", "zamba2-1.2b", "--requests", "3", "--slots",
                    "2", "--max-new", "3", "--max-len", "32", "--device",
                    "cpu"])
    out = capsys.readouterr().out
    assert "generated 9 tokens" in out and "device=cpu" in out
    with pytest.raises(NotImplementedError):
        serve_cli.main(["--arch", "whisper-large-v3", "--device", "cpu"])
    assert get_smoke("zamba2-1.2b").family == "hybrid"
