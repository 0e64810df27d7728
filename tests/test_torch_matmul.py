"""The int8 matmul kernel's launch rule and lane maps, on the CPU.

``kernels.tiled_matmul.plan`` is the rule by which the C entry picks the
int8 form (tile for M > 16, decode with K split into slices for M <= 16);
the card holds the C entry's own choice to it (tests/test_torch_cuda.py).
The kernel's data movement (swizzled shared-memory tiles, ``ldmatrix``
and ``ldmatrix.trans`` lane maps, the ``__byte_perm`` that packs four k of
one column, the m16n8k32 fragments and the interleaved store) is modelled
here in numpy from PTX's fragment definitions and must give ``x @ y``
exactly; the kernel itself runs only on the card.  The wrapper's refusals
are checked without a card.  This file imports nothing of the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import tiled_matmul as mm_mod  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the launch rule ---------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4, 16, 17, 128, 129, 999])
def test_plan_takes_the_decode_form_up_to_16_rows(m):
    p = mm_mod.plan(m, 8384, 2048)
    assert p.form == ("decode" if m <= mm_mod.DECODE_ROWS else "tile")
    if p.form == "tile":
        assert (p.k_slice, p.slices) == (2048, 1)


@pytest.mark.parametrize("n", [1, 7, 130, 2048, 8384, 32000])
@pytest.mark.parametrize("k", [0, 1, 31, 32, 33, 129, 2048, 4096, 8192,
                               131071])
@pytest.mark.parametrize("m", [4, 999])
def test_plan_slices_cover_k_once(m, k, n):
    """The slices [s * k_slice, min((s + 1) * k_slice, K)) cover [0, K)
    once each, none empty (for K > 0), and every slice but the last is a
    multiple of the mma's k of 32; the decode grid stays near its target
    of 528 blocks unless K runs out of 64-deep steps."""
    p = mm_mod.plan(m, n, k)
    bounds = [(s * p.k_slice, min((s + 1) * p.k_slice, k))
              for s in range(p.slices)]
    covered = np.zeros(k, np.int64)
    for lo, hi in bounds:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert p.slices >= 1
    if k:
        assert all(hi > lo for lo, hi in bounds)
    assert all((hi - lo) % 32 == 0 for lo, hi in bounds[:-1])
    if p.form == "decode":
        assert p.k_slice % 64 == 0
        strips = -(-n // 128)
        blocks = strips * p.slices
        steps = -(-k // 64)
        assert blocks <= max(strips, 528 + 2 * strips)
        if k:
            assert blocks >= min(strips * steps, 528) // 2 or p.slices == steps


# --- the wrapper's refusals, unchanged ----------------------------------------


def _refusal_cases():
    a = torch.zeros((4, 8), dtype=torch.int8)
    b = torch.zeros((8, 3), dtype=torch.int8)
    return {
        "cpu_int8": (a, b, {}, ValueError, "CUDA"),
        "cpu_float": (a.float(), b.float(), {}, ValueError, "CUDA"),
        "mixed_int8_f32": (a, b.float(), {}, TypeError, "share"),
        "mixed_bf16_f16": (a.bfloat16(), b.half(), {}, TypeError, "share"),
        "int32_operands": (a.int(), b.int(), {}, TypeError, "share"),
        "int8_to_f32": (a, b, {"out_dtype": torch.float32}, TypeError,
                        "do not give"),
        "int8_to_bf16": (a, b, {"out_dtype": torch.bfloat16}, TypeError,
                         "do not give"),
        "int8_to_int8": (a, b, {"out_dtype": torch.int8}, TypeError,
                         "do not give"),
        "f32_to_int32": (a.float(), b.float(), {"out_dtype": torch.int32},
                         TypeError, "do not give"),
        "not_contiguous": (a, b.T.contiguous().T, {}, ValueError,
                           "contiguous"),
        "k_mismatch": (a, a, {}, ValueError, r"\(M, K\)"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_kernel_refuses_before_any_launch(case):
    x, y, kw, err, match = _refusal_cases()[case]
    ops.reset_launch_counts()
    with pytest.raises(err, match=match):
        mm_mod.tiled_matmul(x, y, **kw)
    assert ops.launch_counts()["tiled_matmul"] == 0


# --- the kernel's lane maps, modelled ------------------------------------------

_BK, _BN = 64, 128


def _a_off(m, kb):
    return m * _BK + ((((kb >> 4) ^ (m >> 1)) & 3) << 4) + (kb & 15)


def _b_off(k, nb):
    return k * _BN + (((nb >> 4) ^ (((k >> 1) & 6) | (k & 1))) << 4) + (nb & 15)


def _ldsm(smem, addrs, trans):
    """ldmatrix.x4 (b16): lanes 8j..8j+7 give matrix j's row addresses;
    returns regs[lane][j] as 4 bytes.  Plain: lane l gets row l / 4, bytes
    4 (l % 4)..+3.  Trans: the b16 at column l / 4 of rows 2 (l % 4) and
    2 (l % 4) + 1.  Each matrix's 8 rows must fall in 8 distinct 16-byte
    bank groups (the swizzle's purpose: no bank conflict)."""
    for j in range(4):
        assert len({(a >> 4) & 7 for a in addrs[8 * j:8 * j + 8]}) == 8
    regs = np.zeros((32, 4, 4), np.uint8)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for j in range(4):
            rows = addrs[8 * j:8 * j + 8]
            if trans:
                lo = rows[2 * q] + 2 * g
                hi = rows[2 * q + 1] + 2 * g
                regs[lane, j] = np.concatenate([smem[lo:lo + 2],
                                                smem[hi:hi + 2]])
            else:
                at = rows[g] + 4 * q
                regs[lane, j] = smem[at:at + 4]
    return regs


def _byte_perm(a, b, sel):
    both = np.concatenate([a, b])
    return np.array([both[(sel >> (4 * i)) & 7] for i in range(4)], np.uint8)


def _mma(acc, a, b0, b1):
    """m16n8k32 s8: lane (g, q) holds A rows g (a0, a2) and g + 8 (a1, a3)
    at k 4q..4q+3 (a0, a1) and 16 + 4q.. (a2, a3); B column g at k 4q..
    (b0) and 16 + 4q.. (b1); C rows g, g + 8 at columns 2q, 2q + 1."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        s8 = [r.view(np.int8).astype(np.int64) for r in a[lane]]
        A[g, 4 * q:4 * q + 4], A[g + 8, 4 * q:4 * q + 4] = s8[0], s8[1]
        A[g, 16 + 4 * q:20 + 4 * q] = s8[2]
        A[g + 8, 16 + 4 * q:20 + 4 * q] = s8[3]
        B[4 * q:4 * q + 4, g] = b0[lane].view(np.int8)
        B[16 + 4 * q:20 + 4 * q, g] = b1[lane].view(np.int8)
    C = A @ B
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        acc[lane] += [C[g, 2 * q], C[g, 2 * q + 1], C[g + 8, 2 * q],
                      C[g + 8, 2 * q + 1]]


def _model_block(x, y, out, bm, wm, wn, m0, n0, kbeg, kend):
    """One block of mma_kernel, one stage at a time, adding into out."""
    M, K = x.shape
    N = y.shape[1]
    tm, tn = bm // wm, _BN // wn
    xb, yb = x.view(np.uint8), y.view(np.uint8)
    acc = {}
    for k0 in range(kbeg, kend, _BK):
        sa = np.zeros(bm * _BK, np.uint8)
        sb = np.zeros(_BK * _BN, np.uint8)
        for m in range(bm):
            for kb in range(_BK):
                if m0 + m < M and k0 + kb < kend:
                    sa[_a_off(m, kb)] = xb[m0 + m, k0 + kb]
        for k in range(_BK):
            for nb in range(_BN):
                if k0 + k < kend and n0 + nb < N:
                    sb[_b_off(k, nb)] = yb[k0 + k, n0 + nb]
        assert len({_a_off(m, kb) for m in range(bm) for kb in range(_BK)}
                   ) == bm * _BK
        for warp in range(wm * wn):
            wm0, wn0 = (warp // wn) * tm, (warp % wn) * tn
            for s in range(_BK // 32):
                a = [_ldsm(sa, [_a_off(wm0 + 16 * i + (ln & 7) + (ln & 8),
                                       32 * s + ((ln >> 4) << 4))
                                for ln in range(32)], trans=False)
                     for i in range(tm // 16)]
                for j in range(tn // 16):
                    bk = [((ln & 7) >> 1) * 4 + (ln & 1)
                          + ((ln >> 3) & 1) * 2 + (ln >> 4) * 16
                          for ln in range(32)]
                    r = _ldsm(sb, [_b_off(32 * s + bk[ln], wn0 + 16 * j)
                                   for ln in range(32)], trans=True)
                    e0 = [_byte_perm(r[ln, 0], r[ln, 1], 0x6420) for ln in range(32)]
                    e1 = [_byte_perm(r[ln, 2], r[ln, 3], 0x6420) for ln in range(32)]
                    o0 = [_byte_perm(r[ln, 0], r[ln, 1], 0x7531) for ln in range(32)]
                    o1 = [_byte_perm(r[ln, 2], r[ln, 3], 0x7531) for ln in range(32)]
                    for i in range(tm // 16):
                        for p, (b0, b1) in enumerate(((e0, e1), (o0, o1))):
                            c = acc.setdefault((warp, i, j, p),
                                               np.zeros((32, 4), np.int64))
                            _mma(c, a[i], b0, b1)
    for (warp, i, j, p), c in acc.items():
        if p:
            continue
        wm0, wn0 = (warp // wn) * tm, (warp % wn) * tn
        odd = acc[(warp, i, j, 1)]
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            for h in range(2):
                gm = m0 + wm0 + 16 * i + g + 8 * h
                gn = n0 + wn0 + 16 * j + 4 * q
                v = [c[lane, 2 * h], odd[lane, 2 * h], c[lane, 2 * h + 1],
                     odd[lane, 2 * h + 1]]
                for e in range(4):
                    if gm < M and gn + e < N:
                        out[gm, gn + e] += v[e]


@pytest.mark.parametrize("m,k,n", [(4, 200, 130), (20, 64, 128)])
def test_lane_maps_model_the_product(rng, m, k, n):
    """The kernel's index algebra, run in numpy on seeded int8 in
    [-128, 127]: the decode form's K slices (each block adding into zeros)
    and the tile form's row tiles give ``x @ y`` exactly, as the plain
    version does, and every ldmatrix reads without bank conflicts."""
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    y = rng.integers(-128, 128, (k, n)).astype(np.int8)
    p = mm_mod.plan(m, n, k)
    out = np.zeros((m, n), np.int64)
    for n0 in range(0, n, _BN):
        if p.form == "decode":
            for s in range(p.slices):
                _model_block(x, y, out, 16, 1, 4, 0, n0, s * p.k_slice,
                             min(k, (s + 1) * p.k_slice))
        else:
            for m0 in range(0, m, 128):
                _model_block(x, y, out, 128, 2, 4, m0, n0, 0, k)
    want = ref.tiled_matmul(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(out, want.numpy().astype(np.int64))
