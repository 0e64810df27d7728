"""The vote kernel's design on the CPU (``kernels/csrc/hough_vote.cu``).

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Here: its launch plan as the wrapper picks it, pinned at
the main paths' shapes; a torch model of its schedule (with no counts,
the gather of each frame's rows of nonzero weight in an order the
atomics choose; which block and lane casts each (row, theta) vote, which
rows a round stages, which thread stores or flushes each bin), held to
the plain version and the JAX package's oracle at ragged shapes; and the
wrapper's refusals, which it makes before it touches a card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import hough_vote as vote_mod  # noqa: E402


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


def _inputs(rng, N, P, T, n_rho, C=3, edge_frac=0.4):
    xy = rng.uniform(0, 40, (N, P, C)).astype(np.float32)
    if C == 3:
        xy[..., 2] = 1.0
    w = (rng.uniform(size=(N, P)) < edge_frac).astype(np.float32)
    trig = rng.uniform(-1, 1, (C, T)).astype(np.float32)
    if C == 3:
        trig[2] = n_rho / 2.5
    return _t(xy), _t(w), _t(trig)


def _flat(t):
    """The 1-D storage under ``t``, as the kernel addresses it."""
    st = t.untyped_storage()
    return torch.empty(0, dtype=t.dtype).set_(
        st, 0, (st.nbytes() // t.element_size(),), (1,))


def _kernel_model(xy, w, trig, n_rho, counts, plan):
    """The kernel's schedule in torch, block by block and lane by lane.

    Returns the output as the blocks leave it (stores, or adds of nonzero
    bins into zeros), the votes cast per (frame, row, theta), the stores
    or adds each bin received, and the owners each bin has (blocks whose
    tile covers it)."""
    THREADS, ROUND = plan["threads"], vote_mod.STAGE_ROWS
    N, P = w.shape
    C, T = trig.shape
    bt, S, RB = plan["bt"], plan["splits"], plan["rho_ranges"]
    R, TB = plan["R"], plan["theta_blocks"]
    xyf, wf = _flat(xy), _flat(w)
    xy_fs = xy.stride(0) if xy.ndim == 3 else 0
    rho_all = ref.rho_product(xy, trig).expand(N, P, T)
    out = torch.zeros((N, n_rho, T), dtype=torch.float64)
    writes = torch.zeros((N, n_rho, T), dtype=torch.int64)
    owners = torch.zeros((N, n_rho, T), dtype=torch.int64)
    cast = torch.zeros((N, P, T), dtype=torch.int64)
    tid = torch.arange(THREADS)
    k, slot, slots = tid % bt, tid // bt, THREADS // bt
    gpw = 32 // bt if 32 % bt == 0 else 1
    step = slots // gpw
    vector = bt % 4 == 0 and T % 4 == 0
    assert plan["blocks"] == N * S * RB * TB
    tiles = {}
    for b in range(plan["blocks"]):
        tb, rest = b % TB, b // TB
        rb, rest = rest % RB, rest // RB
        s, n = rest % S, rest // S
        t0, r0 = tb * bt, rb * R
        nt, nr = min(bt, T - t0), max(0, min(R, n_rho - r0))
        voter = (slot < slots) & (k < nt)
        limit = P if counts is None else max(0, min(int(counts[n]), P))
        share = -(-limit // S)
        lo = min(s * share, limit)
        hi = min(lo + share, limit)
        hist = torch.zeros(R * bt, dtype=torch.float64)
        tiles[b] = hist
        for base in range(lo, hi, ROUND):
            # thread t fetches rows base + j * THREADS + t; the kept ones
            # are staged warp by warp, then by j, then by lane
            p = torch.arange(base, min(base + ROUND, hi))
            j, t = (p - base) // THREADS, (p - base) % THREADS
            wv = wf[w.storage_offset() + n * w.stride(0) + p]
            q = xy.storage_offset() + n * xy_fs + p * C
            assert torch.equal(xyf[q], xy[..., 0].expand(N, P)[n, p])
            keep = wv != 0
            order = torch.argsort((t // 32) * 64 + j * 32 + t % 32)
            staged = p[order][keep[order]]
            # staged row i goes to every voter lane of one slot: where bt
            # divides a warp, the warp's gpw slots take gpw segments of Q
            # rows (Q odd), slot (p % step) * gpw + seg taking row
            # seg * Q + p
            i = torch.arange(len(staged))
            Q = -(-len(staged) // gpw) | 1
            seg, pos = i // max(Q, 1), i % max(Q, 1)
            owner = (pos % step) * gpw + seg
            hit = voter[None, :] & (slot[None, :] == owner[:, None])
            rows, lanes = hit.nonzero(as_tuple=True)
            pr, kk = staged[rows], k[lanes]
            ok = (binv := torch.floor(rho_all[n, pr, t0 + kk])) >= 0
            ok &= binv < n_rho
            jj = binv.to(torch.int64) - r0
            ok &= (jj >= 0) & (jj < nr)
            cast.index_put_((torch.full_like(pr[ok], n), pr[ok],
                             t0 + kk[ok]), torch.ones_like(pr[ok]),
                            accumulate=True)
            hist.index_add_(0, (jj * bt + kk)[ok],
                            wf[w.storage_offset() + n * w.stride(0)
                               + pr[ok]].double())
    for b in range(plan["blocks"]):
        tb, rest = b % TB, b // TB
        rb, n = rest % RB, rest // RB // S
        t0, r0 = tb * bt, rb * R
        nt, nr = min(bt, T - t0), max(0, min(R, n_rho - r0))
        # the tile out: thread t takes column c = t % cols and rows
        # t // cols + m * per; a float4 column is 4 thetas
        cols = nt // 4 if S == 1 and vector else nt
        if nr == 0:
            continue
        hist = tiles[b]
        per = THREADS // cols
        t = torch.arange(per * cols)
        r = (t // cols)[:, None] + per * torch.arange(-(-nr // per))[None]
        c = (t % cols)[:, None].expand_as(r)
        r, c = r[r < nr], c[r < nr]
        if cols != nt:
            r = r.repeat_interleave(4)
            c = (4 * c[:, None] + torch.arange(4)[None]).reshape(-1)
        v = hist[r * bt + c]
        idx = (torch.full_like(r, n), r0 + r, t0 + c)
        owners.index_put_(idx, torch.ones_like(r), accumulate=True)
        if S > 1:
            nz = v != 0
            idx = tuple(i[nz] for i in idx)
            v = v[nz]
            out.index_put_(idx, v, accumulate=True)
        else:
            out[idx] = v
        writes.index_put_(idx, torch.ones_like(idx[0]), accumulate=True)
    return out, cast, writes, owners


def _gather_model(xy, w, gen):
    """The gather of a call with no counts, in torch: thread t of a block
    reads rows ``first + j * GATHER_THREADS``; each warp's kept rows of
    one step (nonzero weight) take the next places of their frame by one
    atomic, in lane order, the warps' steps landing in an order of their
    own (``gen``).  Returns the scratch's (N, P, C) rows and (N, P)
    weights, NaN past each count (the kernel leaves them unwritten), the
    counts, and each scratch row's source row (-1 past the count)."""
    N, P = w.shape
    C = xy.shape[-1]
    xyb = xy.expand(N, P, C) if xy.ndim == 2 else xy
    GT, GR = vote_mod.GATHER_THREADS, vote_mod.GATHER_ROWS
    chunks = -(-P // (GT * GR))
    gxy = torch.full((N, P, C), float("nan"))
    gw = torch.full((N, P), float("nan"))
    src = torch.full((N, P), -1, dtype=torch.int64)
    counts = torch.zeros(N, dtype=torch.int32)
    read = torch.zeros((N, P), dtype=torch.int64)
    lanes = torch.arange(32)
    steps = [c * GR * GT + j * GT + warp * 32 + lanes
             for c in range(chunks) for warp in range(GT // 32)
             for j in range(GR)]
    for n in range(N):
        for i in torch.randperm(len(steps), generator=gen).tolist():
            p = steps[i][steps[i] < P]
            read[n, p] += 1
            kept = p[w[n, p] != 0]
            q = int(counts[n]) + torch.arange(len(kept))
            gxy[n, q], gw[n, q], src[n, q] = xyb[n, kept], w[n, kept], kept
            counts[n] += len(kept)
    assert (read == 1).all()
    return gxy, gw, counts, src


def _counted(w, counts):
    if counts is None:
        return w
    rows = torch.arange(w.shape[-1])[None] < counts[:, None].clamp(min=0)
    return torch.where(rows, w, 0.0)


@pytest.mark.parametrize("case", [
    # T not a multiple of bt; counts 0, 1 and P in one batch
    dict(N=3, P=700, T=45, n_rho=150, counts=[0, 1, 700], jax=True),
    # counts below the split; a split of ragged rows
    dict(N=3, P=700, T=45, n_rho=150, counts=[3, 0, 613], splits=5,
         jax=True),
    # rho ranges past shared memory's reach, forced at a small n_rho
    dict(N=2, P=600, T=13, n_rho=150, counts=[600, 411], bt=3,
         rho_ranges=7),
    # float4 stores (bt, T multiples of 4); two rounds of staged rows
    dict(N=1, P=1200, T=40, n_rho=90, counts=[1100]),
    # the shared raster, no counts, split over P; C = 2
    dict(N=2, P=900, T=20, n_rho=60, counts=None, splits=3, shared=True),
    dict(N=2, P=500, T=16, n_rho=64, counts=[500, 250], C=2, bt=16),
    # frames strided as compaction's slices are
    dict(N=3, P=300, T=24, n_rho=80, counts="compact"),
    # bt 2 with a wide warp (16 slots); a split of one frame
    dict(N=2, P=700, T=20, n_rho=70, counts=[700, 300], bt=2),
    dict(N=1, P=1500, T=36, n_rho=70, counts=[1400], splits=2),
    # the dense raster's plan: two gather blocks a frame, splits
    dict(N=2, P=3000, T=40, n_rho=50, counts=None, shared=True),
    # gathered per-frame rows: every row kept in one frame, none in the
    # other; C = 2; rho ranges
    dict(N=2, P=2100, T=9, n_rho=40, counts=None, C=2, rows="all_none",
         rho_ranges=3),
])
def test_vote_schedule_casts_each_vote_once_and_stores_each_bin_once(
        rng, case):
    """Every (row, theta) vote inside a frame's count with a nonzero weight
    and a bin in [0, n_rho) is cast by exactly one lane of one block, no
    other vote is (with no counts: each row is read once by the gather
    and each kept row voted once from its scratch place, in any order);
    with one split every bin is stored exactly once (zeros included), with
    S splits every bin has one owner a split and receives only nonzero
    adds; the output is the plain version's and the JAX oracle's (at one
    shape: its compile dominates), bit for bit (0/1 weights)."""
    case = dict(case)
    oracle = case.pop("jax", False)
    N, P, T, n_rho = case.pop("N"), case.pop("P"), case.pop("T"), \
        case.pop("n_rho")
    counts, C = case.pop("counts"), case.pop("C", 3)
    xy, w, trig = _inputs(rng, N, P, T, n_rho, C=C)
    if case.pop("shared", False):
        xy = xy[0].contiguous()
    if case.pop("rows", None) == "all_none":
        w[0], w[1] = 1.0, 0.0
    if counts == "compact":
        cxy, cw, cnt = ops.compact_edges(xy, w, max_edges=P)
        assert cxy.stride(0) == (P + 1) * C and cw.stride(0) == P + 1
        xy, w, counts = cxy, cw, cnt
    elif counts is not None:
        counts = torch.tensor(counts, dtype=torch.int32)
    plan = vote_mod.launch_plan(N, P, T, n_rho, **case)
    if counts is None:
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 31)))
        gxy, gw, gcnt, src = _gather_model(xy, w, gen)
        assert torch.equal(gcnt, (w != 0).sum(dim=1, dtype=torch.int32))
        out, gcast, writes, owners = _kernel_model(gxy, gw, trig, n_rho,
                                                   gcnt, plan)
        cast = torch.zeros_like(gcast)
        for n in range(N):
            m = int(gcnt[n])
            assert not gcast[n, m:].any()
            cast[n].index_add_(0, src[n, :m], gcast[n, :m])
    else:
        out, cast, writes, owners = _kernel_model(xy, w, trig, n_rho, counts,
                                                  plan)
    wc = _counted(w, counts)
    binv = torch.floor(ref.rho_product(xy, trig)).expand(N, P, T)
    due = (wc[..., None] != 0) & (binv >= 0) & (binv < n_rho)
    assert torch.equal(cast, due.to(torch.int64))
    S = plan["splits"]
    assert (owners == S).all()
    if S == 1:
        assert (writes == 1).all()
    else:
        assert (writes <= S).all() and (writes[out == 0] == 0).all()
    want = ref.hough_vote(xy, wc, trig, n_rho=n_rho)
    assert torch.equal(out.float(), want)
    if not oracle:
        return
    joracle = np.asarray(jref.hough_vote(
        jnp.asarray(xy.contiguous().numpy()), jnp.asarray(wc.numpy()),
        jnp.asarray(trig.numpy()), n_rho=n_rho))
    np.testing.assert_array_equal(out.float().numpy(), joracle)


def test_launch_plan_pins_the_main_path_shapes():
    """n_rho 2938 at 720x1280, 801 at 240x320; 132 SMs; 16 warps a block
    (16 KB of staged rows); the gather's blocks of 2048 rows."""
    plan = vote_mod.launch_plan
    keys = ("bt", "splits", "rho_ranges", "theta_blocks", "blocks",
            "threads", "smem_bytes", "zeroed", "gather_blocks")

    def pick(p):
        return tuple(p[k] for k in keys)

    stage = 1024 * 16 + 16 * 4
    # the batch (staged or fused): 8 frames x 12 blocks of 16 thetas, one
    # pass, one block an SM (a 188 KB tile)
    assert pick(plan(8, 57600, 180, 2938)) == (
        16, 1, 1, 12, 96, 512, 2938 * 16 * 4 + stage, False, 8 * 29)
    # one full-sweep frame: 45 blocks of 4 thetas, rows split in two
    assert pick(plan(1, 57600, 180, 2938)) == (
        4, 2, 1, 45, 90, 512, 2938 * 4 * 4 + stage, True, 29)
    # one band frame (T 40): 40 blocks of one theta, rows split in two
    assert pick(plan(1, 57600, 40, 2938)) == (
        1, 2, 1, 40, 80, 512, 2940 * 4 + stage, True, 29)
    # the dense shared raster (no counts), 8 frames of 720x1280: the batch's
    # vote over the gathered rows, after 450 gather blocks a frame (18
    # thetas would fit shared memory; the widest power of two is 16)
    assert pick(plan(8, 720 * 1280, 180, 2938)) == (
        16, 1, 1, 12, 96, 512, 2938 * 16 * 4 + stage, False, 8 * 450)
    # 4 frames of 240x320: 16 thetas a block, rows split in two
    assert pick(plan(4, 76800, 180, 801)) == (
        16, 2, 1, 12, 96, 512, 801 * 16 * 4 + stage, True, 4 * 38)
    assert plan(8, 57600, 180, 2938)["smem_bytes"] <= vote_mod.MAX_SMEM


@pytest.mark.parametrize("n_rho", [1, 7, 2938, 7007, 56056, 56057, 60000,
                                   150000, 1_000_001])
@pytest.mark.parametrize("T", [1, 3, 40, 180, 181])
def test_launch_plan_fits_shared_memory_at_any_n_rho(n_rho, T):
    """Every n_rho runs on the kernel: the tile fits a block's shared
    memory, bt is a power of two from 1 to 16, and the rho ranges cover
    [0, n_rho) with none empty."""
    p = vote_mod.launch_plan(3, 1000, T, n_rho)
    assert p["smem_bytes"] <= vote_mod.MAX_SMEM
    assert 1 <= p["bt"] <= min(vote_mod.TILE_THETAS, T)
    assert p["bt"] & (p["bt"] - 1) == 0
    assert p["R"] * p["rho_ranges"] >= n_rho > p["R"] * (p["rho_ranges"] - 1)
    assert p["theta_blocks"] == math.ceil(T / p["bt"])


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card, to reach the wrapper's
    later refusals without one."""

    @property
    def is_cuda(self):
        return True


def _good():
    xy = torch.zeros((2, 6, 3))
    return xy, torch.zeros((2, 6)), torch.zeros((3, 5)), None


@pytest.mark.parametrize("change,match", [
    # the CPU tensor is refused first, whatever else is wrong
    ("cpu", "CUDA"),
    ("four_columns", "shapes"),
    ("trig_rows", "shapes"),
    ("rows", "shapes"),
    ("frames", "one frame per weight row"),
    ("xy_f64", "xy must be f32"),
    ("weights_strided", "weights must be f32"),
    ("xy_unpacked", "xy rows must be packed"),
    ("trig_transposed", "contiguous f32"),
    ("counts_int64", "counts must be contiguous int32"),
    ("counts_shape", "counts must be contiguous int32"),
])
def test_vote_wrapper_refuses_before_touching_the_card(monkeypatch, change,
                                                       match):
    """The wrapper's refusals, in their order, and none of them loads the
    kernel's library."""
    def no_card():
        pytest.fail("the vote library was loaded")

    monkeypatch.setattr(vote_mod, "_lib", no_card)
    libs = dict(_build._libs)
    xy, w, trig, counts = _good()
    if change == "four_columns":
        xy, trig = torch.zeros((2, 6, 4)), torch.zeros((4, 5))
    elif change == "trig_rows":
        trig = torch.zeros((2, 5))
    elif change == "rows":
        xy = torch.zeros((2, 7, 3))
    elif change == "frames":
        xy = torch.zeros((3, 6, 3))
    elif change == "xy_f64":
        xy = xy.double()
    elif change == "weights_strided":
        w = torch.zeros((2, 12))[:, ::2]
    elif change == "xy_unpacked":
        xy = torch.zeros((2, 6, 4))[..., :3]
    elif change == "trig_transposed":
        trig = torch.zeros((5, 3)).t()
    elif change == "counts_int64":
        counts = torch.zeros(2, dtype=torch.int64)
    elif change == "counts_shape":
        counts = torch.zeros(3, dtype=torch.int32)
    if change != "cpu":
        xy, w, trig = (t.as_subclass(_OnCard) for t in (xy, w, trig))
    with pytest.raises(ValueError, match=match):
        vote_mod.hough_vote(xy, w, trig, n_rho=10, counts=counts)
    assert _build._libs == libs
