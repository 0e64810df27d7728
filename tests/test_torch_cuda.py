"""The port's hand CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and needs an NVIDIA GPU with ``nvcc``;
on a host without one they skip (the kernels have no CPU mode).  On the
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports nothing of the JAX package, so it runs where JAX is not
installed.
"""

import ctypes
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_lines import PLATFORMS  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CannyConfig, HoughConfig, LineDetector, PipelineConfig, TrackingPipeline,
    full_corridors,
)
from repro_torch.core.canny import gradient_masks  # noqa: E402
from repro_torch.core.hough import (  # noqa: E402
    _device_raster, hough_trig, rho_bins,
)
from repro_torch.data import (  # noqa: E402
    make_drive_cycle, scenario_batch, scenario_names,
)
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import conv2d_gemm as conv_mod  # noqa: E402
from repro_torch.kernels import flash_attention as attn_mod  # noqa: E402
from repro_torch.kernels import fused_detect as fused_mod  # noqa: E402
from repro_torch.kernels import hough_vote as vote_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels import tiled_matmul as mm_mod  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def card():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the hand kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _vote_inputs(rng, n_pix, n_theta, n_rho, edge_frac=0.3, batch=None):
    xy = rng.uniform(0, 40, (n_pix, 3)).astype(np.float32)
    xy[:, 2] = 1.0
    shape = (batch, n_pix) if batch else (n_pix,)
    w = (rng.uniform(size=shape) > 1 - edge_frac).astype(np.float32)
    trig = rng.uniform(-1, 1, (3, n_theta)).astype(np.float32)
    trig[2] = n_rho / 2.5
    return xy, w, trig


# the conv masks of the detector's tiers (core.canny.gradient_masks):
# name -> (CannyConfig fields, which of the config's mask sets)
_MASK_SETS = {"gauss": ({}, 0), "sobel": ({}, 1), "fused": ({"fused": True}, 0)}
_TIER = {"float32": {}, "float16": {"grad_dtype": "f16"},
         "int32": {"integer": True}, "int8": {"grad_dtype": "int8"}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int32", "int8", "float16"])
@pytest.mark.parametrize("hw,masks", [((3, 37, 52), (1, 5, 5)),
                                      ((2, 45, 70), (2, 3, 3)),
                                      ((1, 21, 19), (3, 7, 7)),
                                      # the main paths' shapes and mask sets
                                      ((8, 720, 1280), "gauss"),
                                      ((8, 720, 1280), "sobel"),
                                      ((1, 720, 1280), "fused"),
                                      ((720, 1280), "gauss"),
                                      ((720, 1280), "sobel")])
def test_conv_kernel_matches_plain_on_card(card, rng, dtype, hw, masks):
    if dtype in ("int32", "int8"):
        img = rng.integers(-128 if dtype == "int8" else 0, 127, hw)
        m = rng.integers(-16, 16, masks) if isinstance(masks, tuple) else None
    else:
        img = rng.normal(size=hw)
        m = rng.normal(size=masks) if isinstance(masks, tuple) else None
    if m is None:
        fields, which = _MASK_SETS[masks]
        m = gradient_masks(CannyConfig(**fields, **_TIER[dtype]))[which]
    m = m.astype(np.int32) if dtype in ("int32", "int8") else m
    img, m = _t(img.astype(dtype)), _t(m.astype(np.float32 if dtype ==
                                                "float16" else m.dtype))
    if dtype == "float16":
        m = m.half()
    before = conv_mod.launches
    got = conv_mod.conv2d_gemm(img.to(card), m.to(card)).cpu()
    torch.cuda.synchronize()
    assert conv_mod.launches == before + 1
    want = ref.conv2d_gemm(img, m)
    if dtype in ("int32", "int8"):
        assert torch.equal(got, want)
    else:
        # f16 accumulates in f16: a few ulps of the largest partial sum
        tol = 1e-4 if dtype == "float32" else 0.06
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.int32,
                                   torch.int8])
def test_conv_unrolled_and_generic_instances_agree_on_card(card, rng, dtype):
    """Each unrolled instance (mask side 3, 5, 7) gives the generic
    instance's bits on the same inputs, at ragged shapes and the main
    path's, with rows by 16-byte copies and element by element; the C
    entry refuses an instance the masks do not fit."""
    acc = conv_mod.acc_dtype(dtype)
    for shape in ((3, 45, 70), (1, 21, 19), (2, 37, 52), (8, 720, 1280)):
        for mshape in ((1, 5, 5), (2, 3, 3), (3, 7, 7)):
            if dtype.is_floating_point:
                x = _t(rng.normal(size=shape)).to(dtype)
                m = _t(rng.normal(size=mshape)).to(acc)
            else:
                x = _t(rng.integers(-128, 128 if dtype == torch.int8 else 256,
                                    shape)).to(dtype)
                m = _t(rng.integers(-16, 16, mshape)).to(acc)
            x, m = x.to(card), m.to(card)
            k = conv_mod.instance(*mshape[1:])
            assert k == mshape[1]
            assert torch.equal(conv_mod.launch(x, m, k),
                               conv_mod.launch(x, m, 0))
    x = torch.zeros((1, 8, 8), dtype=dtype, device=card)
    with pytest.raises(RuntimeError, match="conv2d kernel launch"):
        conv_mod.launch(x, torch.zeros((1, 5, 5), dtype=acc, device=card), 3)


@pytest.mark.cuda
def test_conv_plan_matches_the_source_on_card(card):
    """The wrapper's launch plan is the C entry's (instance, tile, threads,
    grid, shared memory, 16-byte rows) at the main path's shapes and
    ragged ones, in every type and for the generic instance."""
    lib = conv_mod._lib()
    for dtype in (torch.float32, torch.float16, torch.int32, torch.int8):
        in_b, acc_b = conv_mod._BYTES[dtype]
        for n, h, w in ((8, 720, 1280), (1, 720, 1280), (3, 21, 19),
                        (2, 45, 70), (1, 1, 1)):
            for mshape in ((1, 5, 5), (2, 3, 3), (3, 7, 7), (2, 4, 6),
                           (4, 15, 15), (1024, 1, 1)):
                out = (ctypes.c_longlong * 9)()
                lib.conv2d_plan(in_b, acc_b, n, h, w, *mshape, out)
                plan = conv_mod.launch_plan(dtype, n, h, w, *mshape)
                assert list(out) == [
                    plan["instance"], *plan["tile"], plan["threads"],
                    *plan["grid"], plan["smem_bytes"],
                    int(plan["vector_rows"])]


def _main_vote_inputs(rng, n_frames, density=0.02):
    """The main paths' vote operands at 720x1280: the raster's edge pixels
    (seeded, ``density`` of them) compacted into the cap buffer with their
    device-held counts, the real trig table and rho bins."""
    H, W = 720, 1280
    cap = ops.default_max_edges(H * W)
    w = _t((rng.uniform(size=(n_frames, H * W)) < density).astype(np.float32))
    cxy, cw, cnt = ops.compact_edges(_device_raster(H, W, torch.device("cpu")),
                                     w, max_edges=cap)
    trig = _t(hough_trig(H, W, HoughConfig()))
    return cxy, cw, cnt, trig, rho_bins(H, W, HoughConfig())


def _vote_on_cpu(xy, w, trig, n_rho, cnt=None):
    """The plain version on the CPU over each frame's counted rows."""
    if cnt is not None:
        m = int(cnt.max()) if cnt.numel() else 0
        rows = torch.arange(w.shape[-1]) < cnt.reshape(-1, 1)
        w = torch.where(rows.reshape(w.shape), w, 0.0)[..., :max(m, 1)]
        xy = xy[..., :max(m, 1), :]
    return ref.hough_vote(xy, w, trig, n_rho=n_rho)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "shared_xy", "per_frame_xy",
    # the main paths' shapes: the batch, a full-sweep frame (T 180), a
    # fused tracking frame's band (T 40), the dense shared raster (no
    # counts: gathered first) at 240x320 and at the deployment's 720x1280
    "main_batch", "main_frame_t180", "main_band_t40", "dense_4x240x320",
    "dense_8x720x1280",
    # forced plans on the same inputs: splits, rho ranges, counts 0 and P
    "split_equals_single_pass", "rho_ranges", "counts_0_and_p",
    # no counts: every row of one frame gathered, none of the other
    "dense_every_row_and_none",
    # rows whose rho is NaN, infinite or past 2^31 cast no vote
    "nan_and_far_rows"])
def test_vote_kernel_bit_exact_on_card(card, rng, case):
    """0/1 weights: the kernel gives the plain version's bits (on the
    CPU) at every plan; each forced plan gives the default plan's."""
    vote = vote_mod.hough_vote
    if case in ("shared_xy", "per_frame_xy"):
        xy, w, trig = _vote_inputs(rng, 500, 180, 150, edge_frac=0.2, batch=3)
        if case == "per_frame_xy":
            xy = np.stack([xy, xy[::-1].copy(), np.roll(xy, 7, axis=0)])
        want = ref.hough_vote(_t(xy), _t(w), _t(trig), n_rho=150)
        got = ops.hough_vote(_t(xy).to(card), _t(w).to(card),
                             _t(trig).to(card), n_rho=150).cpu()
        assert torch.equal(got, want)
        cmp = ops.hough_vote(_t(xy).to(card), _t(w).to(card),
                             _t(trig).to(card), n_rho=150, compact=True,
                             max_edges=128).cpu()
        assert torch.equal(cmp, ref.hough_vote_compact(
            _t(xy), _t(w), _t(trig), n_rho=150, max_edges=128))
        return
    if case.startswith(("main", "dense")):
        if case == "dense_every_row_and_none":
            xy, w, trig = _vote_inputs(rng, 2100, 45, 150, batch=2)
            xy, w, trig = _t(xy), _t(w), _t(trig)
            w[0], w[1] = 1.0, 0.0
            n_rho, cnt = 150, None
        elif case.startswith("dense"):
            hs, ws, n, frac = ((240, 320, 4, 0.05)
                               if case == "dense_4x240x320"
                               else (720, 1280, 8, 0.002))
            w = _t((rng.uniform(size=(n, hs * ws)) < frac)
                   .astype(np.float32))
            xy = _device_raster(hs, ws, torch.device("cpu"))
            trig = _t(hough_trig(hs, ws, HoughConfig()))
            n_rho, cnt = rho_bins(hs, ws, HoughConfig()), None
        else:
            xy, w, cnt, trig, n_rho = _main_vote_inputs(
                rng, 8 if case == "main_batch" else 1)
            if case != "main_batch":
                xy, w, cnt = xy[0], w[0], cnt[0]
            if case == "main_band_t40":
                trig = trig[:, (np.arange(40) + 150) % 180].contiguous()
        got = vote(xy.to(card), w.to(card), trig.to(card), n_rho=n_rho,
                   counts=None if cnt is None else cnt.to(card)).cpu()
        if cnt is None:
            # the plain version over each frame's rows of nonzero weight
            # (the others add zeros), padded with rows of weight 0
            keep = [torch.nonzero(f).flatten() for f in w]
            m = max(1, max(len(k) for k in keep))
            xyb = xy.expand(w.shape[0], *xy.shape) if xy.ndim == 2 else xy
            xy = torch.zeros((w.shape[0], m, xy.shape[-1]))
            wk = torch.zeros((w.shape[0], m))
            for i, k in enumerate(keep):
                xy[i, :len(k)], wk[i, :len(k)] = xyb[i, k], w[i, k]
            w = wk
        want = _vote_on_cpu(xy, w, trig, n_rho, cnt)
        assert torch.equal(got, want)
        return
    if case == "nan_and_far_rows":
        xy, w, trig = _vote_inputs(rng, 600, 45, 150, edge_frac=0.5, batch=2)
        xy = np.stack([xy, xy.copy()])
        xy[0, ::7, 0] = np.nan
        xy[0, 1::7, 1] = np.inf
        xy[1, ::5, 0] = 3e9
        xy[1, 1::5, 1] = -3e9
        xy, w, trig = _t(xy), _t(w), _t(trig)
        got = vote(xy.to(card), w.to(card), trig.to(card), n_rho=150).cpu()
        assert torch.equal(got, ref.hough_vote(xy, w, trig, n_rho=150))
        return
    # forced plans through the wrapper's launch
    n_rho = 150
    xy, w, trig = _vote_inputs(rng, 700, 45, n_rho, edge_frac=0.3, batch=3)
    xy, w, trig = _t(xy), _t(w), _t(trig)
    cnt = {"counts_0_and_p": torch.tensor([0, 700, 3], dtype=torch.int32),
           "rho_ranges": torch.tensor([650, 1, 700], dtype=torch.int32)}.get(
        case, torch.tensor([700, 513, 2], dtype=torch.int32))
    want = _vote_on_cpu(xy, w, trig, n_rho, cnt)
    dev = [t.to(card) for t in (xy, w, trig)]
    forced = {"split_equals_single_pass": [
                  dict(splits=1), dict(splits=1, bt=16), dict(splits=2),
                  dict(splits=5), dict(splits=64)],
              "rho_ranges": [dict(rho_ranges=r, bt=bt) for r in (1, 2, 7)
                             for bt in (1, 3, 8)],
              "counts_0_and_p": [dict(), dict(splits=3), dict(bt=4),
                                 dict(splits=1, bt=2)]}[case]
    for kw in forced:
        plan = vote_mod.launch_plan(3, 700, 45, n_rho, **kw)
        got = vote_mod.launch(*dev[:3], n_rho, cnt.to(card), plan).cpu()
        assert torch.equal(got, want), kw


@pytest.mark.cuda
def test_vote_kernel_past_one_theta_of_shared_memory(card, rng):
    """An n_rho whose tile does not fit shared memory at one theta: the
    plan cuts rho into ranges, and the kernel gives the plain version's
    bits."""
    n_rho, T = 60000, 12
    plan = vote_mod.launch_plan(2, 900, T, n_rho)
    assert (plan["bt"], plan["rho_ranges"]) == (1, 2)
    xy = rng.uniform(0, 30000, (2, 900, 3)).astype(np.float32)
    xy[..., 2] = 1.0
    w = (rng.uniform(size=(2, 900)) > 0.5).astype(np.float32)
    trig = rng.uniform(-1, 1, (3, T)).astype(np.float32)
    trig[2] = 30000.0
    xy, w, trig = _t(xy), _t(w), _t(trig)
    got = vote_mod.hough_vote(xy.to(card), w.to(card), trig.to(card),
                              n_rho=n_rho).cpu()
    want = ref.hough_vote(xy, w, trig, n_rho=n_rho)
    assert want.sum() > 0 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("weights", ["normal", "late_fraction"])
def test_vote_kernel_real_weights_on_card(card, rng, splits, weights):
    """Any f32 weight (negative, fractional, large; or +-1 for two staged
    rounds and then a fraction, which turns a counting tile into f32): the
    sums run in another order than the plain version's, so each bin is
    held to the bound of two recursive sums of its k addends in any order,
    2 (k - 1) 2^-24 sum|w|, plus one ulp of that sum."""
    xy, w, trig = _vote_inputs(rng, 1500, 90, 120, edge_frac=0.7, batch=2)
    if weights == "normal":
        w = w * rng.normal(scale=50.0, size=w.shape).astype(np.float32)
    else:
        w = w * rng.choice([-1.0, 1.0], size=w.shape).astype(np.float32)
        w[:, 1100:1110] = 0.25
    xy, w, trig = _t(xy), _t(w), _t(trig)
    plan = vote_mod.launch_plan(2, 1500, 90, 120, splits=splits)
    got = vote_mod.launch(xy.to(card), w.to(card), trig.to(card), 120, None,
                          plan).cpu().double()
    want = ref.hough_vote(xy, w, trig, n_rho=120).double()
    k = ref.hough_vote(xy, (w != 0).float(), trig, n_rho=120).double()
    mass = ref.hough_vote(xy, w.abs(), trig, n_rho=120).double()
    tol = (2.0 * (k - 1).clamp(min=0) * 2.0 ** -24 + 2.0 ** -23) * mass
    assert ((got - want).abs() <= tol).all()


@pytest.mark.cuda
def test_vote_plan_matches_the_source_on_card(card):
    """The wrapper's launch plan is the C entry's (blocks, threads, shared
    bytes, R, theta blocks, gather blocks), at the main paths' shapes and
    ragged ones; the C entry refuses a plan its kernel does not take."""
    lib = vote_mod._lib()
    for N, P, T, n_rho in ((8, 57600, 180, 2938), (1, 57600, 180, 2938),
                           (1, 57600, 40, 2938), (4, 76800, 180, 801),
                           (8, 921600, 180, 2938),
                           (3, 700, 45, 150), (2, 900, 12, 60000),
                           (1, 1, 1, 1), (5, 10, 181, 70001)):
        for kw in ({}, {"splits": 3}, {"bt": 1}, {"bt": 32, "rho_ranges": 9},
                   {"bt": 16}):
            plan = vote_mod.launch_plan(N, P, T, n_rho, **kw)
            out = (ctypes.c_longlong * 6)()
            rc = lib.hough_vote_plan(N, P, T, n_rho, plan["bt"],
                                     plan["splits"], plan["rho_ranges"], out)
            fits = (plan["smem_bytes"] <= vote_mod.MAX_SMEM
                    and plan["rho_ranges"] <= n_rho)
            assert (rc == 0) == fits, (N, T, n_rho, kw)
            if fits:
                assert list(out) == [plan["blocks"], plan["threads"],
                                     plan["smem_bytes"], plan["R"],
                                     plan["theta_blocks"],
                                     plan["gather_blocks"]]
    out = (ctypes.c_longlong * 6)()
    assert lib.hough_vote_plan(1, 9, 8, 100, 33, 1, 1, out) != 0
    assert lib.hough_vote_plan(1, 9, 8, 100, 8, 0, 1, out) != 0
    assert lib.hough_vote_plan(1, 9, 8, 100, 8, 1, 101, out) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("platform", ["boom", "boom+gemmini", "rocket"])
def test_detector_on_card_equals_cpu(card, platform):
    """On the card (hand kernels; the stencil baseline for "rocket"), one
    frame and a padded batch give the CPU run's edges and peaks."""
    imgs, _ = scenario_batch(list(scenario_names()), 240, 320, seed=0)
    cfg = dataclasses.replace(PLATFORMS[platform], hough=HoughConfig(
        compact=True, max_edges="auto"))
    on_card = LineDetector(cfg)
    on_cpu = LineDetector(cfg, device="cpu")
    for x in (imgs[0], imgs[:5]):
        got, want = on_card.detect(x), on_cpu.detect(x)
        assert torch.equal(got.edges.cpu(), want.edges)
        assert torch.equal(got.peaks.cpu(), want.peaks)
        assert torch.equal(got.valid.cpu(), want.valid)


def _fused_cases(x, cfg):
    """(corridors, max_edges) of the fused kernel's card tests on frames
    ``x``: none, the full fan, a narrow corridor with a small buffer; on
    the 300x250 frames (3 compaction chunks a frame, 128 rows each) also a
    buffer 10 rows past the first chunk's edges of the frame with the
    fewest there, so that it cuts that frame inside its second chunk."""
    cases = [(None, 4096), (full_corridors(3), 4096),
             (np.array([[0.6, 0.8, 5.0, 40.0]], np.float32), 64)]
    if tuple(x.shape[1:]) == (300, 250):
        rows = fused_mod.CHUNK_WORDS // -(-250 // 32)
        w = ref.fused_weights(x, cfg=cfg, edge_threshold=250.0)
        first = int((w.reshape(-1, 300, 250)[:, :rows] > 0).sum((1, 2)).min())
        cases.append((None, first + 10))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    CannyConfig(), CannyConfig(integer=True), CannyConfig(fused=True),
    CannyConfig(variant="paper"), CannyConfig(hysteresis_iters=30, border=0),
], ids=["full", "integer", "fused-masks", "paper", "wide-halo"])
@pytest.mark.parametrize("shape", [(3, 45, 70), (1, 21, 19), (2, 120, 160),
                                   (2, 130, 200), (2, 300, 250)])
def test_fused_kernel_bit_exact_on_card(card, rng, cfg, shape):
    """The kernel equals its plain version on a CPU copy and the card's
    staged Canny -> threshold -> corridor -> compaction, bit for bit:
    frames smaller than a tile, H and W not multiples of the tile's
    (130x200: four tiles and 2 rows down, one and 72 columns across, W
    not whole keep words either), frames of several compaction chunks
    (300x250: 3 a frame) with ``max_edges`` cutting a frame inside a
    chunk, overflow, corridors, every config."""
    if shape[1] == 120:
        x = _t(scenario_batch(["converging", "rain"], 120, 160)[0])
    else:
        x = _t(rng.uniform(0, 255, shape).astype(np.float32))
    for cor, max_edges in _fused_cases(x, cfg):
        c = None if cor is None else _t(cor)
        before = fused_mod.launches
        got = fused_mod.fused_detect(x.to(card), None if c is None
                                     else c.to(card), cfg=cfg,
                                     edge_threshold=250.0,
                                     max_edges=max_edges)
        torch.cuda.synchronize()
        assert fused_mod.launches == before + 1
        want = ref.fused_detect(x, cfg=cfg, edge_threshold=250.0,
                                max_edges=max_edges, corridors=c)
        w = ref.fused_weights(x.to(card), cfg=cfg, edge_threshold=250.0,
                              corridors=None if c is None else c.to(card))
        staged = ops.compact_edges(_device_raster(*shape[1:], card), w,
                                   max_edges=max_edges)
        for a, b, s in zip(got, want, staged):
            assert torch.equal(a.cpu(), b)
            assert torch.equal(a, s)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [-1.0, 0.0, 128.0, 255.0, 256.0])
def test_fused_kernel_edge_threshold_on_card(card, rng, threshold):
    """The weight is ``(edge ? 255 : 0) >= edge_threshold`` compared in
    f32: a threshold at or below zero keeps every pixel (inside the
    corridors), one above 255 keeps none."""
    x = _t(rng.uniform(0, 255, (2, 45, 70)).astype(np.float32))
    for cor in (None, np.array([[0.6, 0.8, 5.0, 40.0]], np.float32)):
        c = None if cor is None else _t(cor)
        got = fused_mod.fused_detect(x.to(card), None if c is None
                                     else c.to(card), cfg=CannyConfig(),
                                     edge_threshold=threshold,
                                     max_edges=4096)
        want = ref.fused_detect(x, cfg=CannyConfig(),
                                edge_threshold=threshold, max_edges=4096,
                                corridors=c)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        if threshold <= 0 and cor is None:
            assert (got[2] == 45 * 70).all()
        if threshold > 255:
            assert (got[2] == 0).all()


@pytest.mark.cuda
def test_fused_kernel_smem_formula_matches_the_source(card):
    """The wrapper's shared-memory check uses the kernel's own formula, and
    its launch plan (tile, shared memory, blocks a frame, hysteresis
    launches, the long-hysteresis threshold, the compaction's chunks,
    blocks and flag words) is the C entry's, at the main-path shapes and
    ragged ones."""
    lib = fused_mod._lib()
    for iters in (0, 1, 8, 30, 45, 46, 47, 60):
        for paper in (False, True):
            for fused in (False, True):
                assert lib.fused_detect_smem_bytes(iters, paper, fused) == (
                    fused_mod.smem_bytes(iters, paper, fused))
                cfg = CannyConfig(hysteresis_iters=iters, fused=fused,
                                  variant="paper" if paper else "full")
                for n, h, w, max_edges in ((8, 720, 1280, 57600),
                                           (1, 720, 1280, 57600),
                                           (3, 21, 19, 64),
                                           (2, 300, 250, 0)):
                    out = (ctypes.c_longlong * 9)()
                    lib.fused_detect_plan(iters, paper, fused, n, h, w,
                                          max_edges, out)
                    plan = fused_mod.launch_plan(cfg, n, h, w, max_edges)
                    first = plan["planes_from_passes"]
                    assert list(out) == [
                        *plan["tile"], plan["smem_bytes"],
                        plan["tile_blocks_a_frame"],
                        plan["hysteresis_launches"],
                        -1 if first is None else first,
                        plan["chunks_a_frame"], plan["compact_blocks"],
                        plan["flag_words"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    CannyConfig(grad_dtype="f16"), CannyConfig(grad_dtype="f16", fused=True),
    CannyConfig(grad_dtype="int8"), CannyConfig(grad_dtype="int8", fused=True),
    CannyConfig(grad_dtype="int8", variant="paper"),
], ids=["f16", "f16-fused", "int8", "int8-fused", "int8-paper"])
@pytest.mark.parametrize("shape", [(3, 45, 70), (1, 21, 19), (2, 120, 160),
                                   (2, 130, 200), (2, 300, 250)])
def test_fused_kernel_gradient_tiers_bit_exact_on_card(card, rng, cfg, shape):
    """The f16 and int8 tiers equal the card's staged path bit for bit
    (the conv kernel's f16 chains; the int8 scales from the pre-pass), and
    int8 also the plain version on a CPU copy (integer convs are exact in
    any order).  Frames include a dark one, so each keeps its own scale;
    the shapes and ``max_edges`` are those of
    :func:`test_fused_kernel_bit_exact_on_card`, ragged against the tile
    and the compaction's chunks."""
    if shape[1] == 120:
        x = _t(scenario_batch(["converging", "night"], 120, 160)[0])
    else:
        x = _t(rng.uniform(0, 255, shape).astype(np.float32))
    x[0] *= 0.25
    for cor, max_edges in _fused_cases(x, cfg):
        c = None if cor is None else _t(cor)
        before = fused_mod.launches
        got = fused_mod.fused_detect(x.to(card), None if c is None
                                     else c.to(card), cfg=cfg,
                                     edge_threshold=250.0,
                                     max_edges=max_edges)
        torch.cuda.synchronize()
        assert fused_mod.launches == before + 1
        w = ref.fused_weights(x.to(card), cfg=cfg, edge_threshold=250.0,
                              corridors=None if c is None else c.to(card))
        staged = ops.compact_edges(_device_raster(*shape[1:], card), w,
                                   max_edges=max_edges)
        for a, s in zip(got, staged):
            assert torch.equal(a, s)
        if cfg.grad_dtype == "int8":
            want = ref.fused_detect(x, cfg=cfg, edge_threshold=250.0,
                                    max_edges=max_edges, corridors=c)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)


def _serpentine(H, W, lo=30.0, hi=120.0, seed=0, noise=True):
    """A frame whose weak edges form one long serpentine chain from a
    strong end, bare or under sub-grey noise: hysteresis walks it a pixel
    a pass."""
    img = np.zeros((H, W), np.float32)
    for i, y in enumerate(range(5, H - 5, 6)):
        img[y:y + 3, 5:W - 5] = lo
        x = W - 8 if i % 2 == 0 else 5
        if y + 6 < H - 5:
            img[y:y + 9, x:x + 3] = lo
    img[5:8, 5:9] = hi
    if not noise:
        return img
    return img + np.random.default_rng(seed).uniform(0, 1, (H, W)).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [45, 60, 100])
@pytest.mark.parametrize("cfg", [
    CannyConfig(), CannyConfig(integer=True), CannyConfig(fused=True),
    CannyConfig(integer=True, fused=True), CannyConfig(grad_dtype="f16"),
    CannyConfig(grad_dtype="int8"),
], ids=["f32", "integer", "fused-masks", "integer-fused", "f16", "int8"])
def test_fused_kernel_long_hysteresis_bit_exact_on_card(card, rng, cfg,
                                                        iters):
    """At 45, 60 and 100 passes (past the tile's shared memory) the kernel
    is one launch,
    bit-exact with the plain version on the card and the card's staged
    path, on scenario frames and a serpentine chain that needs the passes,
    under noise and bare; the CPU's plain version too, for the integer and
    int8 tiers."""
    cfg = dataclasses.replace(cfg, hysteresis_iters=iters)
    frames = scenario_batch(["converging", "night"], 120, 160)[0]
    x = _t(np.concatenate([frames, _serpentine(120, 160)[None],
                           _serpentine(120, 160, noise=False)[None],
                           rng.uniform(0, 255, (1, 120, 160))
                           .astype(np.float32)]))
    cor = _t(np.array([[0.6, 0.8, 5.0, 140.0]], np.float32))
    counts = None
    for c, max_edges in ((None, 8192), (cor, 256)):
        c_dev = None if c is None else c.to(card)
        before = fused_mod.launches
        got = fused_mod.fused_detect(x.to(card), c_dev, cfg=cfg,
                                     edge_threshold=250.0,
                                     max_edges=max_edges)
        torch.cuda.synchronize()
        assert fused_mod.launches == before + 1
        plain = ref.fused_detect(x.to(card), cfg=cfg, edge_threshold=250.0,
                                 max_edges=max_edges, corridors=c_dev)
        w = ref.fused_weights(x.to(card), cfg=cfg, edge_threshold=250.0,
                              corridors=c_dev)
        staged = ops.compact_edges(_device_raster(120, 160, card), w,
                                   max_edges=max_edges)
        for a, p, st in zip(got, plain, staged):
            assert torch.equal(a, p) and torch.equal(a, st)
        counts = got[2] if counts is None else counts
        if cfg.integer or cfg.grad_dtype == "int8":
            want = ref.fused_detect(x, cfg=cfg, edge_threshold=250.0,
                                    max_edges=max_edges, corridors=c)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
    # the serpentine frames' chains need the passes: 15 fewer keep fewer
    fewer = fused_mod.fused_detect(
        x.to(card), cfg=dataclasses.replace(cfg, hysteresis_iters=iters - 15),
        edge_threshold=250.0, max_edges=8192)
    assert (fewer[2][2:4] < counts[2:4]).all()


def _float_contract(x, y):
    """One launch of the kernel on float operands, held to the float
    contract: its f32 sums (the f32 output, or out_dtype=f32 for bf16 and
    f16) within twice the plain f32 product's own error against a float64
    product, relative to |x| @ |y|; an output in the operands' type is its
    f32 sum rounded once to nearest even."""
    before = mm_mod.launches
    got = mm_mod.tiled_matmul(x, y)
    torch.cuda.synchronize()
    assert mm_mod.launches == before + 1
    want = ref.tiled_matmul(x, y)
    assert got.dtype == want.dtype == x.dtype
    k32 = mm_mod.tiled_matmul(x, y, out_dtype=torch.float32)
    p32 = ref.tiled_matmul(x, y, out_dtype=torch.float32)
    x64, y64 = x.double(), y.double()
    exact = x64 @ y64
    scale = (x64.abs() @ y64.abs()).clamp_min(1e-300)
    err_k = float(((k32.double() - exact).abs() / scale).max())
    err_p = float(((p32.double() - exact).abs() / scale).max())
    assert err_k <= 2.0 * err_p + 1e-12, (err_k, err_p)
    assert torch.equal(got, k32.to(x.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m,k,n", [(33, 129, 65), (100, 70, 50), (4, 1, 7),
                                   (4, 300, 130), (64, 64, 64)])
def test_matmul_kernel_matches_plain_on_card(card, rng, dtype, m, k, n):
    """int8 bit-exact with the plain version (and the CPU's).  Floats: the
    kernel's f32 sums within twice the plain f32 product's own error
    against a float64 product, relative to |x| @ |y|; a bf16 or f16 output
    is its f32 sum rounded once to nearest even."""
    if dtype == "int8":
        x = _t(rng.integers(-128, 128, (m, k)).astype(np.int8))
        y = _t(rng.integers(-128, 128, (k, n)).astype(np.int8))
    else:
        x = _t(rng.normal(size=(m, k)).astype(np.float32)).to(
            getattr(torch, dtype))
        y = _t(rng.normal(size=(k, n)).astype(np.float32)).to(
            getattr(torch, dtype))
    x, y = x.to(card), y.to(card)
    if dtype != "int8":
        _float_contract(x, y)
        return
    before = mm_mod.launches
    got = mm_mod.tiled_matmul(x, y)
    torch.cuda.synchronize()
    assert mm_mod.launches == before + 1
    want = ref.tiled_matmul(x, y)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), ref.tiled_matmul(x.cpu(), y.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [130, 272])
@pytest.mark.parametrize("k", [0, 1, 31, 32, 33, 129, 2048, 8192])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 128, 129])
def test_matmul_int8_forms_match_plain_on_card(card, rng, m, k, n):
    """Both int8 forms (decode for M <= 16, tile above), with K and N on
    and off the 16-byte load path, K = 0 (zeros) and a ragged last column
    strip: one
    launch, bit-exact with the plain version on the card and the CPU, in
    the form and K split that ``plan`` names."""
    x = _t(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(card)
    y = _t(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(card)
    before = mm_mod.launches
    got = mm_mod.tiled_matmul(x, y)
    torch.cuda.synchronize()
    assert mm_mod.launches == before + 1
    assert torch.equal(got, ref.tiled_matmul(x, y))
    assert torch.equal(got.cpu(), ref.tiled_matmul(x.cpu(), y.cpu()))
    attrs = mm_mod.int8_kernel_attributes(m, n, k)
    assert (attrs["form"], attrs["k_slice"], attrs["slices"]) == tuple(
        mm_mod.plan(m, n, k))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [131056, 131071])
@pytest.mark.parametrize("m", [4, 33])
@pytest.mark.parametrize("vx,vy", [(-128, -128), (127, -128)])
def test_matmul_int8_extremes_on_card(card, m, k, vx, vy):
    """The largest sums the int32 accumulator takes: K = 131071 (and the
    16-byte path's 131056) of -128 x -128 or 127 x -128, a few columns."""
    for n in (5, 16):
        x = torch.full((m, k), vx, dtype=torch.int8, device=card)
        y = torch.full((k, n), vy, dtype=torch.int8, device=card)
        got = mm_mod.tiled_matmul(x, y)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.tiled_matmul(x, y))
        assert int(got[0, 0]) == k * vx * vy


@pytest.mark.cuda
def test_matmul_int8_decode_form_on_card(card, rng):
    """A decode step's GEMM (M = 4, K = 8192, N = 2048): the decode form,
    one launch (its zeroing memset is not one), the CPU's result."""
    x = _t(rng.integers(-128, 128, (4, 8192)).astype(np.int8))
    y = _t(rng.integers(-128, 128, (8192, 2048)).astype(np.int8))
    assert mm_mod.plan(4, 2048, 8192).form == "decode"
    ops.reset_launch_counts()
    got = mm_mod.tiled_matmul(x.to(card), y.to(card))
    torch.cuda.synchronize()
    assert ops.launch_counts()["tiled_matmul"] == 1
    assert torch.equal(got.cpu(), ref.tiled_matmul(x, y))


@pytest.mark.cuda
def test_matmul_int8_attributes_follow_plan(card):
    """The C entry's own choice of form and K split, reported by its
    attribute query, is ``plan``'s at the serving GEMMs and edge shapes."""
    for m in (1, 4, 16, 17, 999):
        for k, n in ((2048, 8384), (4096, 2048), (8192, 2048),
                     (2048, 32000), (0, 7), (1, 1), (131071, 5)):
            a = mm_mod.int8_kernel_attributes(m, n, k)
            p = mm_mod.plan(m, n, k)
            assert (a["form"], a["k_slice"], a["slices"]) == tuple(p)
            assert a["registers_per_thread"] > 0 and a["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [130, 272])
@pytest.mark.parametrize("k", [0, 1, 31, 32, 33, 129, 2048, 8192])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 128, 129])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_matmul_f16_sweep_meets_the_float_contract_on_card(card, rng, dtype,
                                                           m, k, n):
    """The bf16 / f16 tensor-core kernel over the int8 sweep's shapes (K
    and N on and off the 16-byte load path, K = 0, a ragged last column
    tile, M across one and two warpgroups and two row tiles, K up to
    8192): the float contract at each."""
    dt = getattr(torch, dtype)
    x = _t(rng.normal(size=(m, k)).astype(np.float32)).to(card, dt)
    y = _t(rng.normal(size=(k, n)).astype(np.float32)).to(card, dt)
    _float_contract(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [999, 4])
@pytest.mark.parametrize("k,n", [(2048, 8384), (4096, 2048), (8192, 2048),
                                 (2048, 32000)],
                         ids=["in_proj", "out_proj", "wo", "head"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_matmul_f16_serving_gemms_meet_the_float_contract_on_card(
        card, rng, dtype, k, n, m):
    """zamba2-1.2b's full-width GEMMs at a 999-token prefill and a 4-slot
    decode step, activations and weights seeded normals (the weights
    scaled by 0.02): the float contract."""
    dt = getattr(torch, dtype)
    x = _t(rng.normal(size=(m, k)).astype(np.float32)).to(card, dt)
    y = _t((rng.normal(size=(k, n)) * 0.02).astype(np.float32)).to(card, dt)
    _float_contract(x, y)


@pytest.mark.cuda
def test_matmul_f16_attributes_follow_the_launch(card):
    """The bf16 / f16 attribute query reports the launch's own tile, chain,
    grid and resources: ``F16_TILE`` tiles of 256 threads, chains of
    ``F16_CHAIN_K`` k at every K, one block of ceil(M / 128) x ceil(N /
    128) a tile, at zamba2's in_proj 8 x 66 = 528 blocks, and at least one
    block an SM."""
    for m, n, k in ((999, 8384, 2048), (4, 8384, 2048), (4, 130, 1),
                    (129, 272, 8192), (999, 32000, 2048), (1, 1, 0)):
        a = mm_mod.f16_kernel_attributes(m, n, k)
        assert a["tile"] == list(mm_mod.F16_TILE)
        assert a["chain_k"] == mm_mod.F16_CHAIN_K
        assert a["grid_blocks"] == -(-m // 128) * -(-n // 128)
        assert a["threads_per_block"] == 256
        assert a["registers_per_thread"] > 0 and a["blocks_per_sm"] >= 1
        assert a["smem_bytes_per_block"] <= 232448
    assert mm_mod.f16_kernel_attributes(999, 8384, 2048)["grid_blocks"] == 528


@pytest.mark.cuda
def test_quantized_matmul_on_card_equals_cpu(card, rng):
    from repro_torch.core import quantized_matmul

    x = _t(rng.normal(size=(99, 640)).astype(np.float32))
    y = _t((rng.normal(size=(640, 200)) * 0.02).astype(np.float32))
    ops.reset_launch_counts()
    got = quantized_matmul(x.to(card), y.to(card))
    torch.cuda.synchronize()
    assert ops.launch_counts()["tiled_matmul"] == 1
    assert torch.equal(got.cpu(), quantized_matmul(x, y))


@pytest.mark.cuda
def test_fused_tracking_on_card_equals_cpu(card):
    cyc = make_drive_cycle("straight", 12, 120, 160, seed=0)
    cfg = PipelineConfig(hough=HoughConfig(compact=True, max_edges="auto"))
    runs = []
    for device in (None, "cpu"):
        tp = TrackingPipeline(cfg, height=120, width=160, theta_band=40,
                              fused_corridors=8, device=device)
        runs.append([tp.process(f.scene.image) for f in cyc])
        runs[-1].append(tp.fused_frames)
    assert runs[0][-1] == runs[1][-1] > 0
    for a, b in zip(runs[0][:-1], runs[1][:-1]):
        assert torch.equal(a.result.peaks.cpu(), b.result.peaks)
        assert a.gated == b.gated and a.tracks == b.tracks


# --- the LM kernels ------------------------------------------------------------


def _bf16_ulp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the larger magnitude of each pair."""
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _bf16_attention_tol(got, want, v):
    """Both round an f32 value once to bf16, so they are one bf16 ulp apart
    at most, plus the f32 values' own difference: the f32 comparison's
    1e-5 of max|v| (summation order), which matters only where the
    output cancels to near 0 and its ulp is tiny."""
    g, w = got.float(), want.float()
    return g, w, _bf16_ulp(g, w) + 1e-5 * float(v.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window,q_offset", [
    ((1, 4, 4, 37, 37, 64), True, None, 0),       # ragged L, one tile
    ((2, 8, 2, 100, 100, 80), True, 24, 0),       # GQA 4, window, D = 80
    ((1, 4, 1, 130, 130, 16), False, None, 0),    # MQA, non-causal
    ((1, 4, 2, 3, 200, 64), True, None, 197),     # q_offset at the end
    ((1, 2, 2, 24, 16, 8), False, 1, 0),          # fully masked rows
    ((1, 2, 2, 70, 300, 128), True, 64, 230),     # D = 128, window, offset
])
def test_attention_kernel_matches_plain_on_card(card, rng, dtype, shape,
                                                causal, window, q_offset):
    """f32: 1e-5 of the plain version on the card (online vs dense sums);
    bf16: within one bf16 ulp of it (both round an f32 value once)."""
    B, Hq, Hkv, Lq, Lkv, D = shape
    dt = getattr(torch, dtype)
    q = _t(rng.normal(size=(B, Hq, Lq, D)).astype(np.float32)).to(card, dt)
    k = _t(rng.normal(size=(B, Hkv, Lkv, D)).astype(np.float32)).to(card, dt)
    v = _t(rng.normal(size=(B, Hkv, Lkv, D)).astype(np.float32)).to(card, dt)
    before = attn_mod.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert attn_mod.launches == before + 1 and got.dtype == dt
    want = ref.attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        g, w, tol = _bf16_attention_tol(got, want, v)
        excess = float(((g - w).abs() - tol).max())
        assert excess <= 0.0, excess


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,q_offset,q_scale", [
    ((1, 2, 2, 40, 40, 8), True, None, 0, 1.0),       # D = 8, padded to 16
    ((1, 4, 4, 130, 130, 64), True, None, 0, 4.0),    # q x 4: |s| up to ~20
    ((1, 4, 2, 100, 100, 80), True, 24, 0, 4.0),      # q x 4, GQA, D = 80
    ((1, 32, 32, 1000, 1000, 64), True, None, 0, 1.0),  # a serving prefill
    ((1, 2, 1, 50, 90, 20), False, None, 0, 1.0),     # D % 8 != 0
])
def test_attention_bf16_tensor_core_cases_on_card(card, rng, shape, causal,
                                                  window, q_offset, q_scale):
    """The bf16 kernel's tensor-core form (mma.sync, p split into two bf16
    halves for PV) at the shapes that stress it, under the bf16 rule of
    test_attention_kernel_matches_plain_on_card."""
    B, Hq, Hkv, Lq, Lkv, D = shape
    q = _t(rng.normal(size=(B, Hq, Lq, D)).astype(np.float32) * q_scale)
    k = _t(rng.normal(size=(B, Hkv, Lkv, D)).astype(np.float32))
    v = _t(rng.normal(size=(B, Hkv, Lkv, D)).astype(np.float32))
    q, k, v = (x.to(card, torch.bfloat16) for x in (q, k, v))
    assert attn_mod.FORM[torch.bfloat16] == "mma.sync bf16, split p"
    before = attn_mod.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert attn_mod.launches == before + 1 and got.dtype == torch.bfloat16
    want = ref.attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)
    g, w, tol = _bf16_attention_tol(got, want, v)
    excess = float(((g - w).abs() - tol).max())
    assert excess <= 0.0, excess


@pytest.mark.cuda
def test_attention_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 2, 8, 16), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        attn_mod.flash_attention(q.transpose(2, 3).contiguous()
                                 .transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros((1, 2, 8, 160), device=card)
        attn_mod.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="dtype"):
        attn_mod.flash_attention(q, q.half(), q.half())
    with pytest.raises(ValueError, match="pair"):
        attn_mod.flash_attention(q, torch.zeros((1, 3, 8, 16), device=card),
                                 torch.zeros((1, 3, 8, 16), device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,H,P,N,G,chunk", [
    (1, 96, 64, 64, 64, 1, 128),     # zamba2's widths, the shortest prefill
    (1, 97, 64, 64, 64, 1, 128),     # zamba2's heads, one ragged chunk
    (1, 300, 64, 64, 64, 1, 128),    # three chunks, ragged tail
    (1, 999, 64, 64, 64, 1, 128),    # the longest prefill: 8 chunks
    (2, 80, 4, 16, 8, 2, 16),        # the reference's sweep, G = 2
    (2, 80, 4, 16, 8, 1, 32),
    (1, 1, 4, 16, 8, 2, 128),        # L = 1
    (1, 45, 6, 12, 20, 3, 13),       # odd chunk, rounded up in the kernel
])
def test_ssd_kernel_matches_plain_on_card(card, rng, b, L, H, P, N, G, chunk):
    """1e-4 relative to the chunked plain version at the same chunk, and
    2e-3 to the sequential oracle (tests/test_kernels.py's tolerance)."""
    x = _t((rng.normal(size=(b, L, H, P)) * 0.1).astype(np.float32)).to(card)
    dt = _t(rng.uniform(0.01, 0.1, (b, L, H)).astype(np.float32)).to(card)
    A = _t(-rng.uniform(0.5, 1.5, (H,)).astype(np.float32)).to(card)
    Bm = _t(rng.normal(size=(b, L, G, N)).astype(np.float32)).to(card)
    C = _t(rng.normal(size=(b, L, G, N)).astype(np.float32)).to(card)
    before = ssd_mod.launches
    y, h = ops.ssd_scan(x, dt, A, Bm, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.launches == before + 1
    yc, hc = ref.ssd_scan_chunked(x, dt, A, Bm, C, chunk=chunk)
    torch.testing.assert_close(y, yc, rtol=1e-4, atol=1e-4 * float(
        yc.abs().max()))
    torch.testing.assert_close(h, hc, rtol=1e-4, atol=1e-4 * float(
        hc.abs().max()))
    ys, hs = ref.ssd_scan(x, dt, A, Bm, C)
    torch.testing.assert_close(y, ys, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(h, hs, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_ssd_kernel_smem_formula_matches_the_source(card):
    """The wrapper's plan (shared memory of passes (a) and (c), blocks of
    each pass, scratch floats) equals the C entry's, at the serving shapes
    and the odd ones; a non-f32 input is refused before any launch."""
    lib = ssd_mod._lib()
    for b, L, H, G, N, P, Q in ((1, 999, 64, 1, 64, 64, 128),
                                (1, 96, 64, 1, 64, 64, 96),
                                (2, 80, 4, 2, 16, 32, 16),
                                (1, 45, 6, 3, 20, 12, 13),
                                (1, 1, 4, 2, 8, 16, 1)):
        want = ssd_mod.plan(b, L, H, G, N, P, Q)
        got = {k: lib.ssd_scan_plan(i, b, L, H, G, N, P, Q)
               for i, k in enumerate(ssd_mod._PLAN_KEYS)}
        assert got == want
    with pytest.raises(TypeError, match="f32"):
        z = torch.zeros((1, 4, 2, 8), device=card)
        ssd_mod.ssd_scan(z.half(), z[..., 0], z[0, 0, :, 0], z, z)


@pytest.mark.cuda
def test_ssd_kernel_one_call_is_one_launch_of_its_passes(card, rng,
                                                        tmp_path):
    """One call counts one launch, and the profiler sees ``PASSES`` device
    kernels named ``ssd_scan_*``, one of each pass."""
    from torch.profiler import ProfilerActivity, profile

    b, L, H, P, N, G = 1, 300, 8, 16, 16, 1
    x = _t((rng.normal(size=(b, L, H, P)) * 0.1).astype(np.float32)).to(card)
    dt = _t(rng.uniform(0.01, 0.1, (b, L, H)).astype(np.float32)).to(card)
    A = _t(-rng.uniform(0.5, 1.5, (H,)).astype(np.float32)).to(card)
    Bm = _t(rng.normal(size=(b, L, G, N)).astype(np.float32)).to(card)
    ssd_mod.ssd_scan(x, dt, A, Bm, Bm)            # build and warm up
    torch.cuda.synchronize()
    # The profiler can drop device records (a trace's first ones, more the
    # longer the process has run; now and then others) while it keeps the
    # host's launch records.  Spin kernels open and close the call, and a
    # trace in which a launch of the call has no device record is taken
    # again.
    for primer in (64, 256, 1024, 4096):
        before = ssd_mod.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(primer):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            ssd_mod.ssd_scan(x, dt, A, Bm, Bm)
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        assert ssd_mod.launches == before + 1
        trace = tmp_path / "ssd.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        acts = [e for e in events if e.get("cat") == "kernel"]
        recorded = {e["args"].get("correlation") for e in acts}
        calls = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                        and e["name"].startswith("cudaLaunchKernel")),
                       key=lambda e: e["ts"])[primer:-1]
        if calls and all(e["args"].get("correlation") in recorded
                         for e in calls):
            break
    names = [e["name"] for e in acts if "ssd_scan" in e["name"]]
    assert len(names) == ssd_mod.PASSES
    for part in ("chunk", "carry", "output"):
        assert sum(f"ssd_scan_{part}_kernel" in n for n in names) == 1


@pytest.mark.cuda
def test_zamba2_smoke_on_card_matches_cpu(card, rng):
    """zamba2 SMOKE at f32 compute: prefill and decode logits on the card
    within 1e-4 of the largest CPU logit; each prefill launches one
    attention kernel a superblock and one SSD kernel a Mamba-2 layer, a
    decode step neither."""
    cfg = get_smoke("zamba2-1.2b").replace(compute_dtype="float32")
    cpu = build(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = build(cfg)
    pg = gpu.load(params)
    toks = _t(rng.integers(0, cfg.vocab, (2, 20)).astype(np.int64))
    cc, cg = cpu.init_cache(2, 32), gpu.init_cache(2, 32)
    ops.reset_launch_counts()
    lg, cg = gpu.prefill(pg, {"tokens": toks[:, :16].to(card)}, cg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 2
    assert ops.launch_counts()["ssd_scan"] == 5
    lc, cc = cpu.prefill(params, {"tokens": toks[:, :16]}, cc)
    pairs = [(lg, lc)]
    ops.reset_launch_counts()
    for t in range(16, 20):
        pos = torch.full((2,), t)
        lg, cg = gpu.decode_step(pg, toks[:, t].to(card), cg, pos.to(card))
        lc, cc = cpu.decode_step(params, toks[:, t], cc, pos)
        pairs.append((lg, lc))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["ssd_scan"] == 0
    for lg, lc in pairs:
        tau = 1e-4 * float(lc.abs().max())
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=tau)


@pytest.mark.cuda
def test_engine_on_card_serves_every_request(card):
    cfg = get_smoke("zamba2-1.2b")
    eng = Engine(build(cfg), n_slots=2, max_len=48, seed=1)
    reqs = [Request(uid=i, prompt=list(range(1, 4 + 3 * i)),
                    max_new_tokens=5) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and len(r.output) == 5 for r in reqs)
