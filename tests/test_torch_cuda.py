"""The port's hand CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and needs an NVIDIA GPU with ``nvcc``;
on a host without one they skip (the kernels have no CPU mode).  On the
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports nothing of the JAX package, so it runs where JAX is not
installed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_lines import PLATFORMS  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CannyConfig, HoughConfig, LineDetector, PipelineConfig, TrackingPipeline,
    full_corridors,
)
from repro_torch.core.hough import _device_raster  # noqa: E402
from repro_torch.data import (  # noqa: E402
    make_drive_cycle, scenario_batch, scenario_names,
)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import conv2d_gemm as conv_mod  # noqa: E402
from repro_torch.kernels import fused_detect as fused_mod  # noqa: E402


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int32", "int8", "float16"])
@pytest.mark.parametrize("hw,masks", [((3, 37, 52), (1, 5, 5)),
                                      ((2, 45, 70), (2, 3, 3)),
                                      ((1, 21, 19), (3, 7, 7))])
def test_conv_kernel_matches_plain_on_card(card, rng, dtype, hw, masks):
    if dtype in ("int32", "int8"):
        img = rng.integers(-128 if dtype == "int8" else 0, 127, hw)
        m = rng.integers(-16, 16, masks).astype(np.int32)
    else:
        img = rng.normal(size=hw)
        m = rng.normal(size=masks)
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
@pytest.mark.parametrize("per_frame", [False, True])
def test_vote_kernel_bit_exact_on_card(card, rng, per_frame):
    xy, w, trig = _vote_inputs(rng, 500, 180, 150, edge_frac=0.2, batch=3)
    if per_frame:
        xy = np.stack([xy, xy[::-1].copy(), np.roll(xy, 7, axis=0)])
    want = ref.hough_vote(_t(xy), _t(w), _t(trig), n_rho=150)
    got = ops.hough_vote(_t(xy).to(card), _t(w).to(card), _t(trig).to(card),
                         n_rho=150).cpu()
    assert torch.equal(got, want)
    cmp = ops.hough_vote(_t(xy).to(card), _t(w).to(card), _t(trig).to(card),
                         n_rho=150, compact=True, max_edges=128).cpu()
    assert torch.equal(cmp, ref.hough_vote_compact(
        _t(xy), _t(w), _t(trig), n_rho=150, max_edges=128))


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


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    CannyConfig(), CannyConfig(integer=True), CannyConfig(fused=True),
    CannyConfig(variant="paper"), CannyConfig(hysteresis_iters=30, border=0),
], ids=["full", "integer", "fused-masks", "paper", "wide-halo"])
@pytest.mark.parametrize("shape", [(3, 45, 70), (1, 21, 19), (2, 120, 160)])
def test_fused_kernel_bit_exact_on_card(card, rng, cfg, shape):
    """The kernel equals its plain version on a CPU copy and the card's
    staged Canny -> threshold -> corridor -> compaction, bit for bit:
    frames smaller than a tile, overflow, corridors, every config."""
    if shape[1] == 120:
        x = _t(scenario_batch(["converging", "rain"], 120, 160)[0])
    else:
        x = _t(rng.uniform(0, 255, shape).astype(np.float32))
    for cor, max_edges in ((None, 4096), (full_corridors(3), 4096),
                           (np.array([[0.6, 0.8, 5.0, 40.0]], np.float32),
                            64)):
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
    """The wrapper's shared-memory check uses the kernel's own formula."""
    lib = fused_mod._lib()
    for iters in (0, 1, 8, 30, 60):
        for paper in (False, True):
            for fused in (False, True):
                assert lib.fused_detect_smem_bytes(iters, paper, fused) == (
                    fused_mod.smem_bytes(iters, paper, fused))


@pytest.mark.cuda
def test_fused_kernel_refuses_low_precision_tiers_on_card(card):
    for cfg in (CannyConfig(grad_dtype="f16"), CannyConfig(grad_dtype="int8")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ops.fused_detect(torch.zeros((2, 40, 50), device=card), cfg=cfg,
                             edge_threshold=250.0, max_edges=64)


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
