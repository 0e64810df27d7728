"""The port's LM kernel seams against the JAX package, on shared numpy inputs.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
in interpret mode and the ``ref.py`` oracles.  The port's side is what a
CPU tensor takes through ``kernels.ops``: the plain PyTorch versions, with
the reference's host dispatch (dense attention up to a kv length of 2048,
blockwise above; sequential SSD up to L = 64, chunked above).  The hand
kernels themselves are tested on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as attn_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(rng, B, Hq, Hkv, Lq, Lkv, D):
    return (rng.normal(size=(B, Hq, Lq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Lkv, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Lkv, D)).astype(np.float32))


def _ssd_inputs(rng, B, L, H, P, N, G):
    return ((rng.normal(size=(B, L, H, P)) * 0.1).astype(np.float32),
            rng.uniform(0.01, 0.1, (B, L, H)).astype(np.float32),
            -rng.uniform(0.5, 1.5, (H,)).astype(np.float32),
            rng.normal(size=(B, L, G, N)).astype(np.float32),
            rng.normal(size=(B, L, G, N)).astype(np.float32))


# --- attention -------------------------------------------------------------


@pytest.mark.parametrize("gqa", [1, 2, 4])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_attention_plain_matches_pallas_interpret(rng, gqa, causal, window):
    """The reference's kernel sweep at L = 72.  Against the Pallas body
    (online softmax over 16-blocks): 2e-3, the reference's own tolerance
    for that comparison; against its dense oracle, the same algorithm in
    f32 summed in another order: 1e-5."""
    q, k, v = _qkv(rng, 2, 4, 4 // gqa, 72, 72, 16)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window).numpy()
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, interpret=True, bq=16, bk=16)
    dense = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, np.asarray(dense), rtol=1e-5, atol=1e-5)


def test_attention_plain_decode_offset(rng):
    """One query at the end of a 96-long kv timeline (q_offset = Lkv - 1)."""
    q, k, v = _qkv(rng, 2, 4, 4, 1, 96, 16)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              q_offset=95).numpy()
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, q_offset=95, interpret=True, bq=8, bk=32)
    dense = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, q_offset=95)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, np.asarray(dense), rtol=1e-5, atol=1e-5)


def test_attention_plain_fully_masked_rows_give_zero(rng):
    """Rows that see no key (window 1, non-causal, Lkv < Lq) are 0 in the
    port, the reference's oracle and its Pallas body."""
    q, k, v = _qkv(rng, 1, 2, 2, 24, 16, 8)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                              window=1).numpy()
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=False, window=1, interpret=True, bq=8, bk=8)
    assert np.all(got[:, :, 16:] == 0.0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        got, np.asarray(jref.attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=False,
                                       window=1)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lkv,window", [(2049, None), (2100, 300)])
def test_attention_seam_takes_blockwise_past_2048(rng, lkv, window):
    """Past a kv length of 2048 both packages take the blockwise form on
    the CPU: the port equals the reference's seam (1e-5, the same blocks
    in f32) and the port's own dense oracle (1e-4, other sums)."""
    q, k, v = _qkv(rng, 1, 4, 2, 8, lkv, 16)
    off = lkv - 8
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, q_offset=off)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                q_offset=off, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    dense = ref.attention(_t(q), _t(k), _t(v), causal=True, window=window,
                          q_offset=off)
    np.testing.assert_allclose(got.numpy(), dense.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_attention_blockwise_plain_matches_reference(rng):
    """The blockwise forward at a small block (16) with GQA and a window
    of 17, against the reference's blockwise and dense oracles."""
    q, k, v = _qkv(rng, 2, 4, 2, 50, 50, 16)
    got = ref.attention_blockwise(_t(q), _t(k), _t(v), causal=True,
                                  window=17, block=16).numpy()
    want = jref.attention_blockwise(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, window=17,
                                    block=16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, ref.attention(_t(q), _t(k), _t(v), causal=True,
                           window=17).numpy(), rtol=1e-4, atol=1e-4)


def test_attention_plain_bf16_output(rng):
    """bf16 operands: f32 arithmetic, one rounding to bf16 at the end, as
    the reference's oracle (within one bf16 ulp of it)."""
    q, k, v = _qkv(rng, 1, 4, 4, 20, 20, 16)
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(qb, kb, vb, causal=True)
    assert got.dtype == torch.bfloat16
    want = jref.attention(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                            for a in (qb, kb, vb)), causal=True)
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)


# --- the bf16 kernel's arithmetic, on the CPU ---------------------------------

NEG_INF = -1e30


def _split_bf16(p):
    """p -> (p_hi, p_lo), both bf16 values held in f32: p_hi = bf16(p),
    p_lo = bf16(p - p_hi) (the difference is exact in f32)."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def _tensor_core_attention(q, k, v, *, causal, window=None, q_offset=0,
                           split=True, bk=64):
    """The rounding of the bf16 kernel (csrc/flash_attention.cu, its
    mma.sync form), step for step in torch: bf16 operands (their products
    exact in f32), f32 scores scaled after the product, the online
    softmax over 64-key tiles with -1e30 for a masked score and p = 0
    there, PV as P_hi V + P_lo V (``split=False``: p rounded once to
    bf16), l the f32 sum of the unsplit p, one division by l and one
    rounding to bf16.  Only the order of the f32 sums differs from the
    tensor cores'."""
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    scale = torch.tensor(1.0 / (D ** 0.5), dtype=torch.float32)
    q_pos = q_offset + torch.arange(Lq)[:, None]
    m = torch.full((B, Hq, Lq, 1), NEG_INF)
    l = torch.zeros((B, Hq, Lq, 1))
    acc = torch.zeros((B, Hq, Lq, D))
    for j0 in range(0, Lkv, bk):
        kv_pos = torch.arange(j0, min(j0 + bk, Lkv))[None, :]
        ok = torch.ones((Lq, kv_pos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= q_pos >= kv_pos
        if window is not None:
            ok &= q_pos - kv_pos < window
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, j0:j0 + bk]) * scale
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        vt = vf[:, :, j0:j0 + bk]
        if split:
            hi, lo = _split_bf16(p)
            acc = corr * acc + hi @ vt + lo @ vt
        else:
            acc = corr * acc + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).to(torch.bfloat16)


def _beyond_bf16_check(got, want, v):
    """Elements past the bf16 rule of the card's checks (chip_smoke.py,
    tests/test_torch_cuda.py): one bf16 ulp at the larger magnitude plus
    1e-5 of max|v|."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
    return int(((g - w).abs() > ulp + 1e-5 * float(v.float().abs().max()))
               .sum())


def _bf16_qkv(rng, B, Hq, Hkv, Lq, Lkv, D, q_scale=1.0):
    q, k, v = _qkv(rng, B, Hq, Hkv, Lq, Lkv, D)
    return tuple(_t(a).to(torch.bfloat16) for a in (q * q_scale, k, v))


@pytest.mark.parametrize("shape,causal,window,q_offset,q_scale", [
    ((1, 4, 4, 72, 72, 64), True, None, 0, 1.0),      # two kv tiles
    ((1, 4, 1, 37, 37, 8), True, None, 0, 1.0),       # MQA, ragged, D = 8
    ((2, 4, 2, 70, 150, 80), True, 24, 80, 1.0),      # GQA, window, offset
    ((1, 2, 2, 24, 16, 8), False, 1, 0, 1.0),         # fully masked rows
    ((1, 4, 4, 130, 130, 64), True, None, 0, 4.0),    # q x 4
    ((1, 2, 2, 3, 200, 80), True, None, 197, 4.0),    # q x 4 at the end
])
def test_tensor_core_arithmetic_meets_the_bf16_check(rng, shape, causal,
                                                     window, q_offset,
                                                     q_scale):
    """The bf16 kernel's rounding (bf16 operands, split p) against the
    JAX package's Pallas body (interpret mode, bf16 in and out) and the
    port's dense oracle, under the card's rule: one bf16 ulp + 1e-5 of
    max|v|, with no element past it."""
    B, Hq, Hkv, Lq, Lkv, D = shape
    q, k, v = _bf16_qkv(rng, B, Hq, Hkv, Lq, Lkv, D, q_scale)
    got = _tensor_core_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    jq, jk, jv = (jnp.asarray(a.float().numpy(), jnp.bfloat16)
                  for a in (q, k, v))
    want = jflash(jq, jk, jv, causal=causal, window=window,
                  q_offset=q_offset, interpret=True, bq=64, bk=64)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert _beyond_bf16_check(got, want, v) == 0
    dense = ref.attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    assert _beyond_bf16_check(got, dense, v) == 0
    if Lkv < Lq:
        assert torch.all(got[:, :, Lkv:] == 0)


@pytest.mark.parametrize("L", [127, 513])
def test_one_bf16_rounding_of_p_breaks_the_check(rng, L):
    """Why p is split: rounded once to bf16 for PV, the same inputs put
    elements past the rule that the split form meets."""
    q, k, v = _bf16_qkv(rng, 1, 4, 4, L, L, 64, 4.0)
    dense = ref.attention(q, k, v, causal=True)
    once = _tensor_core_attention(q, k, v, causal=True, split=False)
    split = _tensor_core_attention(q, k, v, causal=True)
    assert _beyond_bf16_check(once, dense, v) > 0
    assert _beyond_bf16_check(split, dense, v) == 0


def test_p_split_error_is_within_2_to_the_minus_17(rng):
    """|p - p_hi - p_lo| <= 2^-17 p over seeded p in [0, 1], uniform and
    spread over 80 binades (exp of -U(0, 80)), as the kernel's p are: for
    p in [2^e, 2^(e+1)), |p - p_hi| <= 2^(e-8), and p_lo's own rounding
    is at most 2^(e-17).  The bound is reached: 2^-18 p is not a bound.
    So after the division by l the PV error is at most 2^-17 max|v|
    (7.6e-6), under the bf16 check's 1e-5 of max|v|."""
    p = np.concatenate([rng.uniform(0.0, 1.0, 100_000),
                        np.exp(-rng.uniform(0.0, 80.0, 100_000)), [0.0, 1.0]])
    p = torch.from_numpy(p.astype(np.float32))
    hi, lo = _split_bf16(p)
    err = (p.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -17 * p.double()).all())
    assert bool((err > 2.0 ** -18 * p.double()).any())
    assert bool((hi == p.to(torch.bfloat16).float()).all())


# --- SSD ----------------------------------------------------------------------


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_plain_matches_pallas_interpret(rng, G, chunk):
    """The reference's sweep at L = 80.  The port's chunked form against
    the Pallas body at the same chunk: 1e-5 (the same products, summed in
    another order); both against the sequential oracle: 2e-3, the
    reference's tolerance for chunked vs sequential."""
    x, dt, A, Bm, C = _ssd_inputs(rng, 2, 80, 4, 16, 8, G)
    y, h = ref.ssd_scan_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(C),
                                chunk=chunk)
    ya, sa = jssd(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                  jnp.asarray(Bm), jnp.asarray(C), chunk=chunk,
                  interpret=True)
    yb, sb = jref.ssd_scan(x, dt, A, Bm, C)
    np.testing.assert_allclose(y.numpy(), np.asarray(ya), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(sa), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(yb), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(sb), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("L", [1, 37, 64, 65, 200])
def test_ssd_seam_matches_reference_dispatch(rng, L):
    """Through the seams: sequential up to L = 64, chunked at 128 above,
    in both packages (1e-5: the same form, summed in another order)."""
    x, dt, A, Bm, C = _ssd_inputs(rng, 1, L, 4, 8, 8, 2)
    y, h = ops.ssd_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(C))
    yj, hj = jops.ssd_scan(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                           jnp.asarray(Bm), jnp.asarray(C), impl="xla")
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-5,
                               atol=1e-5)
    ys, hs = ref.ssd_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(C))
    np.testing.assert_allclose(y.numpy(), ys.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(h.numpy(), hs.numpy(), rtol=2e-3, atol=2e-3)


def test_ssd_chunked_plain_ragged_tail_is_identity(rng):
    """A ragged last chunk (L = 100 at chunk 32) equals the sequential
    oracle, state included (the reference's own check, 2e-3)."""
    x, dt, A, Bm, C = _ssd_inputs(rng, 2, 100, 4, 16, 8, 2)
    yc, hc = ref.ssd_scan_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(C),
                                  chunk=32)
    ys, hs = jref.ssd_scan(x, dt, A, Bm, C)
    np.testing.assert_allclose(yc.numpy(), np.asarray(ys), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(hc.numpy(), np.asarray(hs), rtol=2e-3,
                               atol=2e-3)


# --- the seams on the CPU -------------------------------------------------------


def test_cpu_lm_seams_launch_no_kernel(rng):
    ops.reset_launch_counts()
    q, k, v = _qkv(rng, 1, 2, 2, 8, 8, 8)
    ops.flash_attention(_t(q), _t(k), _t(v))
    ops.ssd_scan(*(_t(a) for a in _ssd_inputs(rng, 1, 70, 2, 4, 4, 1)))
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["ssd_scan"] == 0


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """The wrappers launch or raise: a CPU tensor never reaches a plain
    version through them."""
    q, k, v = (_t(a) for a in _qkv(rng, 1, 2, 2, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        attn_mod.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_mod.ssd_scan(*(_t(a) for a in _ssd_inputs(rng, 1, 8, 2, 4, 4, 1)))
    assert attn_mod.plain is ref.attention
    assert ssd_mod.plain is ref.ssd_scan_chunked


def test_ssd_smem_formula_fits_the_serving_shapes():
    """zamba2's chunk of 128 at N = P = 64: the output pass (c) takes 80 KB
    of shared memory, two blocks an SM, and the chunk pass (a) 73.5 KB,
    three; both inside the card's 227 KB.  N = P = 256 does not fit."""
    p = ssd_mod.plan(1, 999, 64, 1, 64, 64, 128)
    assert ssd_mod.smem_bytes(128, 64, 64) == p["smem_output"] == 81920
    assert p["smem_chunk"] == 75264 and 3 * p["smem_chunk"] <= 228 * 1024
    assert ssd_mod.smem_bytes(128, 64, 64) <= ssd_mod.MAX_SMEM_BYTES
    assert ssd_mod.smem_bytes(128, 256, 256) > ssd_mod.MAX_SMEM_BYTES


@pytest.mark.parametrize("L", [96, 127, 199, 254, 383, 512, 776, 999])
def test_ssd_plan_fills_the_card_and_shares_cb_per_group(L):
    """At every serving prefill length, batch 1, zamba2's widths: the
    output pass alone has at least the H100's 132 SMs' worth of blocks,
    and C B^T takes one block and one Q x Q scratch per (batch, group,
    chunk), not per head."""
    Q = min(128, L)
    nc, QP = -(-L // Q), -(-Q // 32) * 32
    p = ssd_mod.plan(1, L, 64, 1, 64, 64, Q)
    assert p["blocks_output"] >= 132
    assert p["blocks_chunk"] == (1 + 64) * nc           # G + H blocks a chunk
    assert p["cb_floats"] == 1 * nc * QP * QP           # G = 1, not H = 64
    assert ssd_mod.PASSES == 3


# --- the SSD kernel's passes and its 3xTF32 products, on the CPU ----------------


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the bits: the f32 magnitude rounded to 10
    mantissa bits, to nearest with ties away from zero (half of the 13
    dropped bits' unit added to the magnitude, then those bits cleared)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """The kernel's product: each operand split as hi = tf32(a), lo =
    tf32(a - hi), and lo.hi' + hi.lo' + hi.hi' summed in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    """One TF32 product: the rounding 3xTF32 exists to avoid."""
    return _tf32(a) @ _tf32(b)


def _ssd_passes(x, dt, A, B, C, *, chunk, mm=torch.matmul):
    """The SSD kernel's decomposition (csrc/ssd_scan.cu), in torch, with
    its products through ``mm``: (a) each chunk's cum = cumsum(dt * A),
    S_c = (B o exp(cum_last - cum) dt)^T . x, and C B^T once per group;
    (b) the carry h_c = exp(cum_last[c-1]) h_{c-1} + S_{c-1}; (c) y = ((C
    B^T) o tril(exp(cum_i - cum_j)) o dt_j) . x + (C o exp(cum)) . h_c.
    The ragged tail is padded with zero steps.  Returns (y, state, C B^T of
    shape (b, n_chunks, G, Q, Q))."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, L)
    nc = -(-L // Q)

    def chunks(t):
        t = torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2)
                                    + (0, nc * Q - L))
        return t.reshape(b, nc, Q, *t.shape[2:])

    xc, dtc, Bc, Cc = chunks(x), chunks(dt), chunks(B), chunks(C)
    xq = xc.permute(0, 1, 3, 2, 4)                         # (b, nc, H, Q, P)
    cum = torch.cumsum(dtc * A, dim=2).permute(0, 1, 3, 2)  # (b, nc, H, Q)
    last = cum[..., -1:]
    w = torch.exp(last - cum) * dtc.permute(0, 1, 3, 2)
    Bh = Bc.repeat_interleave(rep, dim=3).permute(0, 1, 3, 4, 2)
    S = mm(Bh * w[:, :, :, None, :], xq)                   # (b, nc, H, N, P)
    cb = mm(Cc.permute(0, 1, 3, 2, 4), Bc.permute(0, 1, 3, 4, 2))
    h = torch.zeros((b, H, N, P))
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(last[:, c])[..., None] * h + S[:, c]
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    decay = torch.where(tril, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        0.0)
    M = (cb.repeat_interleave(rep, dim=2) * decay
         * dtc.permute(0, 1, 3, 2)[..., None, :])
    Ce = (Cc.repeat_interleave(rep, dim=3).permute(0, 1, 3, 2, 4)
          * torch.exp(cum)[..., None])
    y = mm(M, xq) + mm(Ce, torch.stack(h_in, dim=1))       # (b, nc, H, Q, P)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * Q, H, P)[:, :L]
    return y, h, cb


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("chunk", [13, 16, 32, 128])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L", [1, 80, 100, 300])
def test_ssd_pass_model_matches_chunked_and_pallas(rng, L, G, chunk):
    """The kernel's decomposition, with f32 products, against the port's
    chunked form and the Pallas body (interpret mode) at the same chunk:
    1e-5 (the same products, grouped and summed in another order), C B^T
    of one shape per group."""
    x, dt, A, Bm, C = _ssd_inputs(rng, 2, L, 4, 16, 8, G)
    y, h, cb = _ssd_passes(_t(x), _t(dt), _t(A), _t(Bm), _t(C), chunk=chunk)
    Q = min(chunk, L)
    assert cb.shape == (2, -(-L // Q), G, Q, Q)
    yc, hc = ref.ssd_scan_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(C),
                                  chunk=chunk)
    np.testing.assert_allclose(y.numpy(), yc.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), hc.numpy(), rtol=1e-5, atol=1e-5)
    ya, sa = jssd(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                  jnp.asarray(Bm), jnp.asarray(C), chunk=chunk,
                  interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ya), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(sa), rtol=1e-5,
                               atol=1e-5)


def test_tf32_emulation_rounds_as_cvt_rna(rng):
    """Round to nearest on the 10-bit mantissa, ties away from zero, the
    carry into the exponent kept; hi + lo is x to 2^-21 |x| (the rest is
    lo's own rounding), lo at most 2^-11 |x|."""
    e = 2.0 ** -11
    f = torch.tensor([1 + e, -(1 + e), 1 + e - 2 ** -23, 1 + e + 2 ** -23,
                      2 - 2 ** -23, 1.5, 0.0, -3 * 2 ** -100],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2 * e, -(1 + 2 * e), 1.0, 1 + 2 * e, 2.0, 1.5,
                         0.0, -3 * 2 ** -100], dtype=torch.float32)
    assert torch.equal(_tf32(f), want)
    x = torch.from_numpy((rng.normal(size=100_000)
                          * np.exp2(rng.integers(-40, 40, 100_000)))
                         .astype(np.float32))
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((x - hi).abs() <= e * x.abs()).all())
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -21 * x.double().abs()).all())


def test_3xtf32_products_meet_the_contract_with_margin(rng):
    """zamba2's N = P = 64 with 4 heads, L = 300 (three chunks of 128, a
    ragged tail): the 3xTF32 products stay within 1e-5 relative of the
    chunked plain version, a tenth of the card's 1e-4 check."""
    x, dt, A, Bm, C = (_t(a) for a in _ssd_inputs(rng, 1, 300, 4, 64, 64, 1))
    y, h, _ = _ssd_passes(x, dt, A, Bm, C, chunk=128, mm=_mm_3xtf32)
    yc, hc = ref.ssd_scan_chunked(x, dt, A, Bm, C, chunk=128)
    assert max(_rel(y, yc), _rel(h, hc)) <= 1e-5


def test_single_tf32_breaks_the_contract_on_one_dominant_term():
    """Why three products: with one term in every output, built from
    values just under a TF32 rounding tie (1 + 2^-11 - 2^-23 rounds to 1,
    an error of 4.9e-4), single TF32 products miss the 1e-4 relative check
    by more than ten times; 3xTF32 meets it with margin."""
    v = 1 + 2.0 ** -11 - 2.0 ** -23
    b, L, H, P, N = 1, 6, 1, 8, 8
    x = torch.zeros((b, L, H, P))
    x[0, 0, 0] = v
    dt = torch.ones((b, L, H))
    A = torch.full((H,), -0.5)
    Bm = torch.zeros((b, L, 1, N))
    Bm[0, 0, 0, 0] = v
    C = torch.zeros((b, L, 1, N))
    C[0, :, 0, 0] = v
    yc, hc = ref.ssd_scan_chunked(x, dt, A, Bm, C, chunk=128)
    y1, h1, _ = _ssd_passes(x, dt, A, Bm, C, chunk=128, mm=_mm_tf32)
    assert max(_rel(y1, yc), _rel(h1, hc)) > 1e-3
    y3, h3, _ = _ssd_passes(x, dt, A, Bm, C, chunk=128, mm=_mm_3xtf32)
    assert max(_rel(y3, yc), _rel(h3, hc)) <= 1e-5
