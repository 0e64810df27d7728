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
    """zamba2's chunk of 128 at N = P = 64 needs ~184 KB, inside the
    card's 227 KB; a chunk of 128 at N = P = 128 does not fit."""
    assert ssd_mod.smem_bytes(128, 64, 64) <= ssd_mod.MAX_SMEM_BYTES
    assert ssd_mod.smem_bytes(128, 64, 64) > 160_000
    assert ssd_mod.smem_bytes(128, 128, 128) > ssd_mod.MAX_SMEM_BYTES
