"""The attention kernel in the forms the cross-attention families launch it
in, on the card: non-causal self-attention (whisper's encoder), queries
against a longer context (a cross layer: Lq != Lkv), and a context whose
last kv tile is ragged (1500 = 23 x 64 + 28), each against the plain
version; and SMOKE llama-3.2-vision-11b and whisper-large-v3 prefill and
decode on the card against the port's own CPU run.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_context.py

This file imports nothing of the JAX package.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as attn_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402


@pytest.fixture
def card():
    """The card, with the plain versions' products in full f32; skips
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the attention kernel has no CPU "
                    "mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _bf16_rule(got, want, v):
    """Every element within one bf16 ulp of the larger magnitude plus 1e-5
    of max|v| (``chip_smoke.bf16_rule``)."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((g - w).abs() <= ulp + 1e-5 * float(v.float().abs().max()))
                .all())


CASES = [  # B, Hq, Hkv, Lq, Lkv, D, causal: the families' forms, cut in B
    (1, 20, 20, 1500, 1500, 64, False),   # whisper's encoder, ragged kv
    (2, 20, 20, 127, 1500, 64, False),    # whisper's cross layer
    (1, 32, 8, 128, 1600, 128, False),    # the VLM's cross layer
    (2, 32, 8, 999, 1600, 128, False),    # ragged q against the patches
    (1, 32, 8, 256, 256, 128, True),      # the VLM's self layer, GQA 32/8
    (1, 4, 2, 5, 77, 128, False),         # fewer queries than a tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CASES)
def test_kernel_non_causal_and_cross_length_forms(card, case, dtype):
    """bf16 (the tensor-core kernel) within the bf16 rule of the plain
    version; f32 (the FMA kernel) within 1e-5 (rtol and atol, as
    tests/test_torch_cuda.py holds it); ``ops`` launches the same
    kernel."""
    B, Hq, Hkv, Lq, Lkv, D, causal = case
    g = torch.Generator(card).manual_seed(Lq * 7 + Lkv)
    q = torch.randn(B, Hq, Lq, D, generator=g, device=card).to(dtype)
    k, v = (torch.randn(B, Hkv, Lkv, D, generator=g, device=card).to(dtype)
            for _ in range(2))
    got = attn_mod.flash_attention(q, k, v, causal=causal)
    want = ref.attention(q, k, v, causal=causal)
    assert got.shape == (B, Hq, Lq, D) and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    if dtype == torch.bfloat16:
        assert _bf16_rule(got, want, v)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal), got)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3"])
def test_smoke_prefill_and_decode_on_the_card_equal_the_cpu(card, arch):
    """SMOKE at f32 from the same parameters and context: a prefill of 9
    tokens (the kernel's cross and encoder launches on the card), then 4
    decode steps; logits within 1e-4 of max|logit|, the cross caches
    within 1e-5 relative."""
    cfg = get_smoke(arch).replace(compute_dtype="float32")
    m, mc = build(cfg, device=card), build(cfg, device="cpu")
    p = m.init(torch.Generator(card).manual_seed(0))
    pc = tree_map(lambda t: t.cpu(), p)
    g = torch.Generator(card).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 13), generator=g, device=card,
                         dtype=torch.int32)
    ctx = ({"image_embeds": torch.randn(2, cfg.n_img_tokens, cfg.d_vision,
                                        generator=g, device=card)}
           if cfg.family == "vlm" else
           {"frames": torch.randn(2, cfg.n_frames, cfg.d_model, generator=g,
                                  device=card)})
    c, cc = m.init_cache(2, 16), mc.init_cache(2, 16)
    ops.reset_launch_counts()
    lg, _ = m.prefill(p, {"tokens": toks[:, :9], **ctx}, c)
    assert ops.launch_counts()["flash_attention"] > 0
    lgc, _ = mc.prefill(pc, {"tokens": toks[:, :9].cpu(),
                             **{k: t.cpu() for k, t in ctx.items()}}, cc)
    outs = [(lg, lgc)]
    for t in range(9, 13):
        pos = torch.full((2,), t, dtype=torch.int32)
        lg, _ = m.decode_step(p, toks[:, t], c, pos.to(card))
        lgc, _ = mc.decode_step(pc, toks[:, t].cpu(), cc, pos)
        outs.append((lg, lgc))
    for lg, lgc in outs:
        tau = 1e-4 * float(lgc.abs().max())
        assert float((lg.cpu() - lgc).abs().max()) <= tau
    key = next(k for k in c["blocks"] if "cross" in k)
    for leaf in ("ck", "cv"):
        got, want = c["blocks"][key][leaf].cpu(), cc["blocks"][key][leaf]
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
