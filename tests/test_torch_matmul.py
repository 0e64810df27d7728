"""The matmul kernel's launch rule, lane maps and shared-memory layouts,
on the CPU.

``kernels.tiled_matmul.plan`` is the rule by which the C entry picks the
int8 form (tile for M > 16, decode with K split into slices for M <= 16);
the card holds the C entry's own choice to it (tests/test_torch_cuda.py).
The kernel's data movement (swizzled shared-memory tiles, ``ldmatrix``
and ``ldmatrix.trans`` lane maps, the ``__byte_perm`` that packs four k of
one column, the m16n8k32 fragments and the interleaved store) is modelled
here in numpy from PTX's fragment definitions and must give ``x @ y``
exactly; the kernel itself runs only on the card.  The bf16 / f16 kernel's
layout is modelled the same way: its 128-byte-swizzled cp.async addresses,
the ``wgmma`` descriptors that read them (K-major A, MN-major B), the
m64n64 accumulator fragments of its two halves and its fresh chains of
``F16_CHAIN_K`` k promoted into a compensated f32 sum, against PTX's
canonical layouts (as CUTLASS's GMMA descriptors spell them).  The
wrapper's refusals are checked without a card.  This file imports nothing
of the JAX package.
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


# --- the bf16 / f16 kernel's layout and descriptors, modelled ----------------

_WG_BM, _WG_BN = mm_mod.F16_TILE
_WG_BK, _WG_STAGES = 64, 5
_WG_A_BYTES = _WG_BM * _WG_BK * 2
_WG_STAGE = _WG_A_BYTES + _WG_BK * _WG_BN * 2
_WG_RING = 1024      # a 1024-aligned ring start (the kernel aligns it so)


def _wg_a_off(m, k):
    """wg::a_off: x's tile, K-major, row m 128 bytes, 16-byte chunk c of
    row m kept at chunk c ^ (m % 8)."""
    return m * 128 + ((((k >> 3) ^ m) & 7) << 4) + ((k & 7) << 1)


def _wg_b_off(k, n):
    """wg::b_off: y's tile, MN-major, 64-column atoms of BK rows, 16-byte
    chunk c of row k kept at chunk c ^ (k % 8)."""
    return ((n >> 6) * (_WG_BK * 128) + k * 128
            + (((((n >> 3) & 7) ^ k) & 7) << 4) + ((n & 7) << 1))


def _wg_desc(addr, lbo, sbo):
    """wg::desc: start >> 4 (bits 0-13), LBO >> 4 (16-29), SBO >> 4
    (32-45), 128-byte swizzle (layout type 1, bits 62-63)."""
    return (((addr >> 4) & 0x3FFF) | (((lbo >> 4) & 0x3FFF) << 16)
            | (((sbo >> 4) & 0x3FFF) << 32) | (1 << 62))


def _desc_fields(desc):
    assert desc >> 62 == 1 and (desc >> 49) & 7 == 0    # B128, base offset 0
    return ((desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4,
            ((desc >> 32) & 0x3FFF) << 4)


def _swizzle128(addr):
    """The 128-byte swizzle: address bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _wgmma_read_a(smem, desc):
    """A (64 x 16) as wgmma reads a K-major 128-byte-swizzled operand:
    element (m, k) at start + (m // 8) SBO + (m % 8) 128 + 2 k, swizzled;
    LBO is unused."""
    start, _, sbo = _desc_fields(desc)
    m, k = np.arange(64)[:, None], np.arange(16)[None, :]
    return smem[_swizzle128(start + (m // 8) * sbo + (m % 8) * 128 + 2 * k)
                // 2]


def _wgmma_read_b(smem, desc, n_cols=64):
    """B (16 x N) as wgmma reads an MN-major (transposed) 128-byte-swizzled
    operand: element (k, n) at start + (n // 64) LBO + (k // 8) SBO +
    (k % 8) 128 + 2 (n % 64), swizzled."""
    start, lbo, sbo = _desc_fields(desc)
    k, n = np.arange(16)[:, None], np.arange(n_cols)[None, :]
    return smem[_swizzle128(start + (n // 64) * lbo + (k // 8) * sbo
                            + (k % 8) * 128 + 2 * (n % 64)) // 2]


def _fragment_coords(n_cols=64):
    """The m64nN f32 accumulator as CUTLASS lays it out (thread t = t0 +
    4 t1 + 32 t2, value v = v0 + 2 v1 + 4 v2 -> row t1 + 16 t2 + 8 v1,
    column 2 t0 + v0 + 8 v2): (rows, cols) of shape (128, N / 2)."""
    t, v = np.arange(128)[:, None], np.arange(n_cols // 2)[None, :]
    t0, t1, t2 = t % 4, (t // 4) % 8, t // 32
    v0, v1, v2 = v % 2, (v // 2) % 2, v // 4
    return t1 + 16 * t2 + 8 * v1, 2 * t0 + v0 + 8 * v2


def _epilogue_coords():
    """The kernel's epilogue over its 64 sums a thread (half a's 32
    registers, then half b's): warp w = t / 32, lane l; sum[4c + 2h + e] at
    row 16 w + l / 4 + 8 h, column 8 c + 2 (l % 4) + e."""
    t, j = np.arange(128)[:, None], np.arange(64)[None, :]
    w, lane = t // 32, t % 32
    c, h, e = j // 4, (j // 2) % 2, j % 2
    return 16 * w + lane // 4 + 8 * h, 8 * c + 2 * (lane % 4) + e


def _kahan_add(s, c, a):
    """The kernel's promotion in f32: s += a rounded to nearest, the lost
    bits kept (negated) in c."""
    d = (a - c).astype(np.float32)
    t = (s + d).astype(np.float32)
    return t, ((t - s).astype(np.float32) - d).astype(np.float32)


def _wg_model_block(x, y, out, m0, n0, chain_k):
    """One block of wg::mma_kernel, one stage at a time: the tiles written
    as the loads write them (16-byte chunks where K or N is a multiple of
    8, else element by element; zeros past M, N, K), each warpgroup's four
    k16 products a stage read through its descriptors for each 64-column
    half, a fresh chain (scale-d 0) every ``chain_k`` k whose sum is added
    into the running f32 sum with Kahan compensation, the sum less its
    compensation stored by the epilogue's map."""
    M, K = x.shape
    N = y.shape[1]
    nk = -(-K // _WG_BK)
    steps = chain_k // 16
    smem = np.full((_WG_RING + _WG_STAGES * _WG_STAGE) // 2, np.nan)
    rows, cols = _fragment_coords(64)
    erows, ecols = _epilogue_coords()
    mm, kk = np.meshgrid(np.arange(_WG_BM), np.arange(_WG_BK), indexing="ij")
    bk, bn = np.meshgrid(np.arange(_WG_BK), np.arange(_WG_BN), indexing="ij")
    sums = [np.zeros((64, _WG_BN), np.float32) for _ in range(2)]
    comps = [np.zeros((64, _WG_BN), np.float32) for _ in range(2)]
    acc = [[None, None], [None, None]]      # [warpgroup][half]
    for kt in range(nk):
        base = _WG_RING + (kt % _WG_STAGES) * _WG_STAGE
        k0 = kt * _WG_BK
        ina = (m0 + mm < M) & (k0 + kk < K)
        a = np.where(ina, x[np.minimum(m0 + mm, M - 1),
                            np.minimum(k0 + kk, K - 1)], 0.0)
        smem[(base + _wg_a_off(mm, kk)) // 2] = a
        inb = (k0 + bk < K) & (n0 + bn < N)
        b = np.where(inb, y[np.minimum(k0 + bk, K - 1),
                            np.minimum(n0 + bn, N - 1)], 0.0)
        smem[(base + _WG_A_BYTES + _wg_b_off(bk, bn)) // 2] = b
        for g in range(2):
            for s in range(_WG_BK // 16):
                da = _wg_desc(base + g * 64 * 128 + 32 * s, 16, 1024)
                A = _wgmma_read_a(smem, da)
                step = 4 * kt + s
                for h in range(2):
                    db = _wg_desc(base + _WG_A_BYTES + h * _WG_BK * 128
                                  + 2048 * s, _WG_BK * 128, 1024)
                    B = _wgmma_read_b(smem, db, 64)
                    assert not np.isnan(A).any() and not np.isnan(B).any()
                    d = A @ B
                    ch = acc[g][h] = (d if step % steps == 0
                                      else acc[g][h] + d)
                    if step % steps == steps - 1 or step == 4 * nk - 1:
                        cs = slice(64 * h, 64 * h + 64)
                        sums[g][:, cs], comps[g][:, cs] = _kahan_add(
                            sums[g][:, cs], comps[g][:, cs],
                            ch.astype(np.float32))
    for g in range(2):
        total = (sums[g] - comps[g]).astype(np.float32)
        frag = np.concatenate([total[rows, cols],          # half a
                               total[rows, 64 + cols]], 1)  # half b
        gm, gn = m0 + 64 * g + erows, n0 + ecols
        ok = (gm < M) & (gn < N)
        out[gm[ok], gn[ok]] = frag[ok]


def test_wgmma_tile_layouts_are_swizzled_chunks():
    """Each tile's layout is a bijection onto its bytes; every 16-byte
    cp.async chunk (8 consecutive k of a row of x, 8 consecutive n of a
    row of y) lands on one aligned 16-byte chunk; the 8 rows of a
    swizzle atom put a given logical chunk on 8 distinct chunks (its bank
    groups), and the layouts are the swizzle of the unswizzled row-major
    atoms that the descriptors name."""
    m, k = np.meshgrid(np.arange(_WG_BM), np.arange(_WG_BK), indexing="ij")
    a = _wg_a_off(m, k)
    assert sorted(a.ravel() // 2) == list(range(_WG_BM * _WG_BK))
    assert (a[:, ::8] % 16 == 0).all()
    assert (a.reshape(_WG_BM, 8, 8) - a[:, ::8, None] == 2 * np.arange(8)
            ).all()
    assert (a == _swizzle128((m // 8) * 1024 + (m % 8) * 128 + 2 * k)).all()
    for c in range(8):
        assert len({int(v) >> 4 & 7 for v in a[:8, 8 * c]}) == 8
    kb, n = np.meshgrid(np.arange(_WG_BK), np.arange(_WG_BN), indexing="ij")
    b = _wg_b_off(kb, n)
    assert sorted(b.ravel() // 2) == list(range(_WG_BK * _WG_BN))
    assert (b.reshape(_WG_BK, 16, 8) - b[:, ::8, None] == 2 * np.arange(8)
            ).all()
    assert (b == _swizzle128((n // 64) * _WG_BK * 128 + (kb // 8) * 1024
                             + (kb % 8) * 128 + 2 * (n % 64))).all()
    for c in range(16):
        assert len({int(v) >> 4 & 7 for v in b[:8, 8 * c]}) == 8


def test_wgmma_descriptors_and_fragments():
    """The descriptors pack start, LBO and SBO in 16-byte units at their
    bit fields; every A / B descriptor of a stage names a 1024-aligned
    swizzle atom's row (its start within the first 128 bytes for A, at a
    16-row boundary of a 64-column atom for B); the epilogue's map of the
    accumulator registers is the PTX m64n64 fragment layout of each half,
    a bijection onto 64 x 128."""
    d = _wg_desc(0x1_2340, 16, 1024)
    assert _desc_fields(d) == (0x1_2340, 16, 1024)
    assert d & 0x3FFF == 0x1234 and (d >> 16) & 0x3FFF == 1
    assert (d >> 32) & 0x3FFF == 64 and d >> 62 == 1
    for stage in range(_WG_STAGES):
        base = _WG_RING + stage * _WG_STAGE
        assert base % 1024 == 0 and (base + _WG_A_BYTES) % 1024 == 0
        assert base + _WG_STAGE < 2 ** 18      # the 14-bit start field
        for g in range(2):
            for s in range(4):
                start = base + g * 64 * 128 + 32 * s
                assert (start - base) % 1024 < 128 and start % 16 == 0
                assert (base + _WG_A_BYTES + 2048 * s) % 1024 == 0
    rows, cols = _fragment_coords(64)
    erows, ecols = _epilogue_coords()
    np.testing.assert_array_equal(np.concatenate([rows, rows], 1), erows)
    np.testing.assert_array_equal(np.concatenate([cols, 64 + cols], 1),
                                  ecols)
    assert len({(int(r), int(c)) for r, c in zip(erows.ravel(),
                                                   ecols.ravel())}) == 64 * 128


@pytest.mark.parametrize("m,k,n", [(5, 40, 130), (130, 72, 200),
                                   (64, 13, 8), (1, 136, 264),
                                   (129, 200, 64)])
def test_wgmma_layout_models_the_product(rng, m, k, n):
    """The bf16 / f16 kernel's index algebra, run in numpy on small
    integer values (exact in any order): its tiles written at the
    swizzled addresses, read back through its descriptors as PTX's
    canonical layouts define them, multiplied in k16 steps, each a fresh
    chain of ``F16_CHAIN_K`` k promoted into a compensated f32 sum, and
    stored by its fragment map give ``x @ y`` at ragged M, N and K (on
    and off the 16-byte load path), as the plain version does."""
    x = rng.integers(-3, 4, (m, k)).astype(np.float64)
    y = rng.integers(-3, 4, (k, n)).astype(np.float64)
    out = np.full((m, n), np.nan)
    for m0 in range(0, m, _WG_BM):
        for n0 in range(0, n, _WG_BN):
            _wg_model_block(x, y, out, m0, n0, mm_mod.F16_CHAIN_K)
    want = ref.tiled_matmul(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(y).bfloat16(),
                            out_dtype=torch.float32)
    np.testing.assert_array_equal(out, want.numpy().astype(np.float64))


@pytest.mark.parametrize("k", [64, 2048, 8192])
def test_wgmma_promotion_leaves_the_error_to_the_chains(rng, k):
    """The promotion's own share of the error: chains of ``F16_CHAIN_K``
    k summed exactly and rounded once to f32 (the best a chain can do),
    then added as the kernel adds them (Kahan, f32), err against the exact
    product by at most 2^-23 of |x| @ |y| beyond each chain's rounding,
    at any K; a plain f32 add of the same chains errs more at K = 8192.
    So what the contract can see is the tensor cores' own chain error
    (PERF.md)."""
    m, n = 2, 64
    x = rng.normal(size=(m, k)).astype(np.float32).astype(np.float64)
    y = rng.normal(size=(k, n)).astype(np.float32).astype(np.float64)
    c = mm_mod.F16_CHAIN_K
    chains = np.stack([x[:, i:i + c] @ y[i:i + c] for i in range(0, k, c)])
    c32 = chains.astype(np.float32)
    s = np.zeros((m, n), np.float32)
    comp = np.zeros_like(s)
    plain = np.zeros_like(s)
    for ch in c32:
        s, comp = _kahan_add(s, comp, ch)
        plain = (plain + ch).astype(np.float32)
    got = (s - comp).astype(np.float32).astype(np.float64)
    exact = x @ y
    scale = np.abs(x) @ np.abs(y)
    chain_round = np.abs(c32.astype(np.float64) - chains).sum(0)
    assert (np.abs(got - exact) <= chain_round + 2.0 ** -23 * scale).all()
    if k == 8192:
        assert (np.abs(plain - exact) / scale).max() > (
            np.abs(got - exact) / scale).max()
