"""The training slice on the card: the two LM kernels' gradients (through
the autograd Functions of ``kernels.ops``) against the plain versions'
autograd on the same card, and a SMOKE zamba2-1.2b train step on the card
against the port's own CPU step.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

This file imports nothing of the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as attn_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.layers import tree_items, tree_map  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig, init_train_state, make_train_step,
)


@pytest.fixture
def card():
    """The card, with the plain versions' products in full f32; skips
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the LM kernels have no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _grads(fn, inputs, cot):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    if isinstance(out, tuple):
        return out, torch.autograd.grad(out, leaves, cot)
    return out, torch.autograd.grad(out, leaves, cot[0])


ATTN_CASES = [  # B, Hq, Hkv, L, D, causal, window
    (2, 8, 8, 200, 64, True, None),
    (1, 8, 2, 333, 64, True, 64),
    (2, 4, 1, 128, 32, True, None),
    (1, 4, 4, 97, 64, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_gradients_match_the_plain_version(card, case, dtype):
    """``ops.flash_attention`` (the kernel forward, the plain blockwise
    backward) against autograd of ``ref.attention`` on the same card.  f32:
    within 1e-4 of max|g|.  bf16: within 1e-2 of max|g| (both round an f32
    gradient to bf16 once; the backward reads the kernel's bf16 output,
    within a bf16 ulp of the plain one, in its row sums)."""
    B, Hq, Hkv, L, D, causal, window = case
    dt = getattr(torch, dtype)
    g = torch.Generator(card).manual_seed(0)
    q = torch.randn(B, Hq, L, D, generator=g, device=card).to(dt)
    k, v = (torch.randn(B, Hkv, L, D, generator=g, device=card).to(dt)
            for _ in range(2))
    do = torch.randn(B, Hq, L, D, generator=g, device=card).to(dt)
    kw = dict(causal=causal, window=window)
    ops.reset_launch_counts()
    out, got = _grads(lambda a, b, c: ops.flash_attention(a, b, c, **kw),
                      (q, k, v), (do,))
    assert ops.launch_counts()["flash_attention"] == 1
    want_out, want = _grads(lambda a, b, c: ref.attention(a, b, c, **kw),
                            (q, k, v), (do,))
    tol = 1e-4 if dt == torch.float32 else 1e-2
    for a, w in zip(got, want):
        assert a.dtype == w.dtype == dt
        assert torch.isfinite(a).all()
        assert _rel(a, w) <= tol
    assert _rel(out, want_out) <= (1e-5 if dt == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L", [128, 512, 999])
def test_ssd_gradients_match_the_plain_version(card, L, G):
    """``ops.ssd_scan`` (the kernel forward, the chunked form recomputed for
    the backward) against autograd of ``ref.ssd_scan_chunked`` on the same
    card: y within 1e-4 of max|y| (the kernel's 3xTF32 products), every
    gradient within 1e-5 of its max|g| (the same plain ops)."""
    H, P, N = 8, 64, 64
    g = torch.Generator(card).manual_seed(L + G)
    x = 0.1 * torch.randn(2, L, H, P, generator=g, device=card)
    dt = torch.nn.functional.softplus(
        torch.randn(2, L, H, generator=g, device=card))
    A = -torch.rand(H, generator=g, device=card) - 0.5
    Bm, C = (torch.randn(2, L, G, N, generator=g, device=card)
             for _ in range(2))
    dy = torch.randn(2, L, H, P, generator=g, device=card)
    dh = torch.randn(2, H, N, P, generator=g, device=card)
    ops.reset_launch_counts()
    (y, h), got = _grads(lambda *a: ops.ssd_scan(*a), (x, dt, A, Bm, C),
                         (dy, dh))
    assert ops.launch_counts()["ssd_scan"] == 1
    (yw, hw), want = _grads(lambda *a: ref.ssd_scan_chunked(*a),
                            (x, dt, A, Bm, C), (dy, dh))
    assert _rel(y, yw) <= 1e-4 and _rel(h, hw) <= 1e-4
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel(a, w) <= 1e-5


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_the_card(card):
    q = torch.randn(1, 2, 16, 64, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        attn_mod.flash_attention(q, q.detach(), q.detach())
    x = torch.randn(1, 16, 2, 8, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_mod.ssd_scan(x, torch.rand(1, 16, 2, device=card),
                         -torch.rand(2, device=card),
                         torch.randn(1, 16, 1, 8, device=card),
                         torch.randn(1, 16, 1, 8, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_smoke_train_step_on_the_card_equals_the_cpu(card, remat):
    """SMOKE zamba2-1.2b at f32, one step from the same parameters and
    batch: loss within 1e-5 relative, grad_norm within 1e-4, every
    parameter within 2 lr (a first AdamW update is +-lr) with at most 1%
    of the elements past 1e-6.  With remat each superblock's forward runs
    twice, so the kernels launch twice as often."""
    cfg = get_smoke("zamba2-1.2b").replace(compute_dtype="float32",
                                           remat=remat)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    params = build(cfg, device="cpu").init_master(
        torch.Generator().manual_seed(0))
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (2, 97))
    batch = {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
             "targets": torch.from_numpy(tok[:, 1:].astype(np.int32))}
    out = {}
    for dev in ("cpu", card):
        m = build(cfg, device=dev)
        state = init_train_state(tree_map(lambda t: t.to(dev), params))
        ops.reset_launch_counts()
        out[str(dev)] = make_train_step(m, opt)(
            state, {k: v.to(dev) for k, v in batch.items()})
        counts = ops.launch_counts()
    (s_cpu, m_cpu), (s_card, m_card) = out["cpu"], out[str(card)]
    n_super = cfg.n_layers // cfg.share_every
    n_mamba = n_super * cfg.share_every + (cfg.n_layers % cfg.share_every) ** 2
    twice = 2 if remat else 1
    assert counts["flash_attention"] == twice * n_super
    assert counts["ssd_scan"] == twice * n_mamba
    assert float(m_card["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                  rel=1e-5)
    assert float(m_card["grad_norm"]) == pytest.approx(
        float(m_cpu["grad_norm"]), rel=1e-4)
    beyond = total = 0
    for (path, a), (_, b) in zip(tree_items(s_card.params),
                                 tree_items(s_cpu.params)):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2 * opt.peak_lr, path
        beyond += int((d > 1e-6).sum())
        total += d.numel()
    assert beyond <= 0.01 * total, (beyond, total)
