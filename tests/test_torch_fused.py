"""The port's fused hot path against the JAX package, on shared numpy frames.

Kernel A's plain version (``fused_detect``, ``fused_weights``,
``compact_raster``), the fused transforms (``fused_hough``,
``fused_hough_tiered``) and the fused plan, each bit-exact with the JAX
package: its ``xla`` oracle and, for kernel A at 96x128, the Pallas body in
interpret mode.  Plus the kernel wrapper's refusals, which it makes before
it touches a device.  The kernel itself runs on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import CannyConfig as JCanny  # noqa: E402
from repro.core import HoughConfig as JHough  # noqa: E402
from repro.core import LineDetector as JLineDetector  # noqa: E402
from repro.core import PipelineConfig as JPipeline  # noqa: E402
from repro.core import hough as jhough  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.convert import pipeline_config_from_reference  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CannyConfig, HoughConfig, LineDetector, PipelineConfig, canny,
    full_corridors, fused_hough, fused_hough_tiered, hough_transform,
    hough_transform_tiered,
)
from repro_torch.core.plan import DetectionPlan  # noqa: E402
from repro_torch.data import scenario_batch  # noqa: E402
from repro_torch.kernels import fused_detect as fused_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

H, W = 120, 160
FAMILIES = ("converging", "straight", "rain", "night")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    imgs, truths = scenario_batch(FAMILIES, H, W, seed=0)
    return imgs, truths


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _real_corridors(truths, n=8, half=25.0):
    """Tracker-style rows around the first frame's planted lanes, padded to
    ``n`` by repeating the first row (the tracker's static count is 8)."""
    rows = [[math.cos(th), math.sin(th), rho - half, rho + half]
            for rho, th in truths[0]]
    rows += [rows[0]] * (n - len(rows))
    return np.asarray(rows, np.float32)


def _corridor_cases(truths):
    return {"none": None, "real": _real_corridors(truths),
            "full": full_corridors(4)}


def _jcanny(cfg: CannyConfig) -> JCanny:
    return JCanny(**{**dataclasses.asdict(cfg), "impl": None})


def _assert_same(got, want):
    cxy, cw, counts = got
    np.testing.assert_array_equal(cxy.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(
        counts.numpy(), np.minimum((np.asarray(want[1]) > 0).sum(-1),
                                   cw.shape[-1]))


# --- kernel A's plain version ----------------------------------------------


@pytest.mark.parametrize("corridors", ["none", "real", "full"])
@pytest.mark.parametrize("batch", [False, True])
def test_fused_detect_plain_bit_exact_with_reference(frames, corridors,
                                                     batch):
    imgs, truths = frames
    cor = _corridor_cases(truths)[corridors]
    x = imgs if batch else imgs[1]
    got = ops.fused_detect(_t(x), None if cor is None else _t(cor),
                           cfg=CannyConfig(), edge_threshold=250.0,
                           max_edges=1200)
    want = jref.fused_detect(jnp.asarray(x), cfg=JCanny(),
                             edge_threshold=250.0, max_edges=1200,
                             corridors=None if cor is None
                             else jnp.asarray(cor))
    _assert_same(got, want)
    assert got[1].sum() > 0
    if corridors == "real":  # the corridors cut edges away
        full = ops.fused_detect(_t(x), None, cfg=CannyConfig(),
                                edge_threshold=250.0, max_edges=1200)
        assert (got[2] < full[2]).any()


@pytest.mark.parametrize("cfg", [
    CannyConfig(integer=True), CannyConfig(fused=True),
    CannyConfig(variant="paper"), CannyConfig(hysteresis_iters=2, border=0),
    CannyConfig(grad_dtype="f16"), CannyConfig(grad_dtype="int8"),
], ids=["integer", "fused-masks", "paper", "iters2-border0", "f16", "int8"])
def test_fused_detect_plain_configs(frames, cfg):
    """Every Canny configuration of kernel A's contract, against the
    reference's oracle (the kernel's own tiers run on the card in
    tests/test_torch_cuda.py)."""
    imgs, truths = frames
    cor = _real_corridors(truths)
    got = ops.fused_detect(_t(imgs), _t(cor), cfg=cfg, edge_threshold=250.0,
                           max_edges=1500)
    want = jref.fused_detect(jnp.asarray(imgs), cfg=_jcanny(cfg),
                             edge_threshold=250.0, max_edges=1500,
                             corridors=jnp.asarray(cor))
    _assert_same(got, want)


@pytest.mark.parametrize("threshold", [0.0, 128.0])
def test_fused_detect_plain_overflow_and_threshold(frames, threshold):
    """max_edges=16 drops the same trailing edges; a threshold at or below
    zero keeps every pixel (inside the corridors)."""
    imgs, truths = frames
    cor = _real_corridors(truths)
    for c in (None, cor):
        got = ops.fused_detect(_t(imgs[:2]), None if c is None else _t(c),
                               cfg=CannyConfig(), edge_threshold=threshold,
                               max_edges=16)
        want = jref.fused_detect(jnp.asarray(imgs[:2]), cfg=JCanny(),
                                 edge_threshold=threshold, max_edges=16,
                                 corridors=None if c is None
                                 else jnp.asarray(c))
        _assert_same(got, want)
        assert (got[2] == 16).all()


def test_fused_detect_plain_matches_pallas_interpret():
    """At 96x128 the plain version equals the reference's Pallas body run
    in interpret mode, with and without corridors."""
    imgs, truths = scenario_batch(["converging"], 96, 128, seed=2)
    cor = np.array([[1.0, 0.0, 30.0, 100.0]], np.float32)
    for c in (None, cor):
        want = jops.fused_detect(jnp.asarray(imgs[0]),
                                 None if c is None else jnp.asarray(c),
                                 cfg=JCanny(), edge_threshold=250.0,
                                 max_edges=128, impl="interpret")
        got = ops.fused_detect(_t(imgs[0]), None if c is None else _t(c),
                               cfg=CannyConfig(), edge_threshold=250.0,
                               max_edges=128)
        _assert_same(got, want)


@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 1.0])
def test_compact_raster_matches_reference(rng, density):
    hw = (24, 32)
    w = (rng.random((3, hw[0] * hw[1])) < density).astype(np.float32)
    for max_edges in (8, 64, 1024):
        for x in (w[0], w):
            want = jref.compact_raster(jnp.asarray(x), width=hw[1],
                                       max_edges=max_edges)
            got = ops.compact_raster(_t(x), width=hw[1], max_edges=max_edges)
            _assert_same(got, want)
            # and the generic row compaction gives the same buffer
            jj, ii = np.meshgrid(np.arange(hw[1]), np.arange(hw[0]))
            xy = np.stack([jj.ravel(), ii.ravel(), np.ones(jj.size)],
                          1).astype(np.float32)
            rows = ops.compact_edges(_t(xy), _t(x), max_edges=max_edges)
            for a, b in zip(got, rows):
                np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fused_weights_matches_reference(frames):
    imgs, truths = frames
    cor = _real_corridors(truths)
    for c in (None, cor):
        want = jops.fused_weights(jnp.asarray(imgs), None if c is None
                                  else jnp.asarray(c), cfg=JCanny(),
                                  edge_threshold=250.0)
        got = ops.fused_weights(_t(imgs), None if c is None else _t(c),
                                cfg=CannyConfig(), edge_threshold=250.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the fused transforms ----------------------------------------------------


def test_fused_hough_bit_exact_with_reference_and_staged(frames):
    imgs, truths = frames
    cfg = HoughConfig(compact=True, max_edges=1200, corridors=8)
    jcfg = JHough(compact=True, max_edges=1200, corridors=8, impl="xla")
    for c in (_real_corridors(truths), full_corridors(8)):
        got = fused_hough(_t(imgs), CannyConfig(), cfg, corridors=_t(c))
        want = jhough.fused_hough(jnp.asarray(imgs), JCanny(), jcfg,
                                  corridors=jnp.asarray(c))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # at full coverage the fused votes are the staged votes
    staged = hough_transform(canny(_t(imgs)), dataclasses.replace(
        cfg, corridors=None))
    np.testing.assert_array_equal(got.numpy(), staged.numpy())


@pytest.mark.parametrize("case", ["frame", "batch", "band", "overflow",
                                  "real"])
def test_fused_tiered_bit_exact_with_reference(frames, case):
    """The cap buffer with device counts equals the reference's exact-count
    tier selector: one frame and a batch under all-pass corridors, a gated
    band, the cap tier overflowing (tiers (16, 32)), real corridors; and at
    full coverage, the staged tiered transform."""
    imgs, truths = frames
    n_cor, tiers, band = 4, None, None
    cors = full_corridors(4)
    x = imgs if case != "frame" else imgs[2]
    if case == "band":
        band = (np.arange(40) + 50).astype(np.int32)
    if case == "overflow":
        tiers = (16, 32)
    if case == "real":
        n_cor, cors = 8, _real_corridors(truths)
    cfg = HoughConfig(compact=True, max_edges="auto", corridors=n_cor,
                      theta_band=None if band is None else len(band))
    jcfg = JHough(**{**dataclasses.asdict(cfg), "impl": "xla"})
    got = fused_hough_tiered(_t(x), CannyConfig(), cfg, tiers,
                             None if band is None else _t(band), _t(cors))
    want = jhough.fused_hough_tiered(
        jnp.asarray(x), JCanny(), jcfg, tiers,
        None if band is None else jnp.asarray(band), jnp.asarray(cors))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case != "real":
        staged = hough_transform_tiered(
            canny(_t(x)), dataclasses.replace(cfg, corridors=None), tiers,
            None if band is None else _t(band))
        np.testing.assert_array_equal(got.numpy(), staged.numpy())


def test_fused_hough_rejects_auto_and_mismatched_corridors(frames):
    img = _t(frames[0][0])
    with pytest.raises(ValueError, match="auto"):
        fused_hough(img, CannyConfig(),
                    HoughConfig(compact=True, max_edges="auto"))
    cfg = HoughConfig(compact=True, max_edges=256, corridors=2)
    with pytest.raises(ValueError, match="corridors"):
        fused_hough(img, CannyConfig(), cfg)
    with pytest.raises(ValueError, match="corridors"):
        fused_hough(img, CannyConfig(), cfg, corridors=_t(full_corridors(3)))
    with pytest.raises(ValueError, match="theta_band"):
        fused_hough(img, CannyConfig(), dataclasses.replace(
            cfg, corridors=None), theta_bins=_t(np.arange(4)))


# --- the fused plan ------------------------------------------------------------


def test_fused_detector_matches_reference_and_staged(frames):
    """``LineDetector(fused=True)`` equals the JAX fused detector and the
    port's own staged detector: peaks, validity, and lines to 1e-3 px; the
    edge map is a zero placeholder."""
    imgs, _ = frames
    jcfg = JPipeline(hough=JHough(compact=True, max_edges="auto"), fused=True)
    cfg = pipeline_config_from_reference(dataclasses.asdict(jcfg))
    assert cfg.fused
    got = LineDetector(cfg, device="cpu").detect_batch(imgs)
    want = JLineDetector(jcfg).detect_batch(jnp.asarray(imgs))
    staged = LineDetector(dataclasses.replace(cfg, fused=False),
                          device="cpu").detect_batch(imgs)
    for other in (np.asarray(want.peaks), staged.peaks.numpy()):
        np.testing.assert_array_equal(got.peaks.numpy(), other)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.lines.numpy(), np.asarray(want.lines),
                               rtol=0, atol=1e-3)
    assert got.edges.shape == imgs.shape and not got.edges.any()
    assert got.valid.any()


def test_fused_plan_rules(frames):
    imgs, truths = frames
    auto = HoughConfig(compact=True, max_edges="auto")
    with pytest.raises(ValueError, match="compact"):
        DetectionPlan.build(PipelineConfig(fused=True), H, W)
    with pytest.raises(ValueError, match="compact"):
        DetectionPlan.build(PipelineConfig(), H, W).with_fused(2)
    plan = DetectionPlan.build(PipelineConfig(hough=auto), H, W, batch=4)
    fused = plan.with_theta_band(40).with_fused(8)
    assert fused.with_fused(8) is fused
    assert fused.cfg.fused and fused.cfg.hough.corridors == 8
    bins = (np.arange(40) + 60).astype(np.int32)
    cors = _real_corridors(truths)
    with pytest.raises(ValueError, match="fused"):
        plan.with_theta_band(40).run(_t(imgs), bins, cors)
    # the batch pads to its bucket and each frame equals its single run
    res = fused.run(_t(imgs[:3]), bins, cors)
    one = DetectionPlan.build(PipelineConfig(hough=auto), H, W
                              ).with_theta_band(40).with_fused(8)
    for i in range(3):
        np.testing.assert_array_equal(
            one.run(_t(imgs[i]), bins, cors).peaks.numpy(),
            res.peaks[i].numpy())


# --- the kernel wrapper's rules (no device touched) -----------------------------


@pytest.mark.parametrize("cfg", [
    CannyConfig(grad_dtype="f16"), CannyConfig(grad_dtype="int8"),
    CannyConfig(grad_dtype="int8", fused=True),
    CannyConfig(hysteresis_iters=60),
], ids=["f16", "int8", "int8-fused", "halo-too-large"])
def test_kernel_refuses_configs_before_touching_the_card(cfg):
    """The kernel takes every gradient tier, each within the shared memory
    a block may use; it refuses only a hysteresis halo whose tile does not
    fit, before it touches a device."""
    img = torch.zeros((2, 40, 50))
    need = fused_mod.smem_bytes(cfg.hysteresis_iters, cfg.variant == "paper",
                                cfg.fused)
    if cfg.hysteresis_iters <= 8:
        fused_mod.check_config(cfg)          # admitted
        assert need <= fused_mod.MAX_SMEM
        assert fused_mod.tier(cfg) == {"f16": 2, "int8": 3}[cfg.grad_dtype]
        with pytest.raises(ValueError, match="CUDA"):
            fused_mod.fused_detect(img, cfg=cfg, edge_threshold=250.0,
                                   max_edges=64)
        return
    assert need > fused_mod.MAX_SMEM
    with pytest.raises(NotImplementedError):
        fused_mod.fused_detect(img, cfg=cfg, edge_threshold=250.0,
                               max_edges=64)
    with pytest.raises(NotImplementedError):
        fused_mod.check_config(cfg)


def test_kernel_refuses_cpu_tensor_and_sizes_its_tile():
    with pytest.raises(ValueError, match="CUDA"):
        fused_mod.fused_detect(torch.zeros((40, 50)), cfg=CannyConfig(),
                               edge_threshold=250.0, max_edges=64)
    # the default tile (8 hysteresis passes) stays in the 48 KB static
    # limit; the largest halo that fits is what the check admits
    assert fused_mod.smem_bytes(8, False, False) == 40656
    assert fused_mod.smem_bytes(8, False, False) <= 48 * 1024
    fits = [i for i in range(80)
            if fused_mod.smem_bytes(i, False, False) <= fused_mod.MAX_SMEM]
    assert fits == list(range(fits[-1] + 1)) and 30 < fits[-1] < 60
    fused_mod.check_config(CannyConfig(hysteresis_iters=fits[-1]))
    assert fused_mod.smem_bytes(8, True, True) < fused_mod.smem_bytes(
        8, False, True)


def test_cpu_fused_path_launches_no_kernel(frames):
    imgs, _ = frames
    ops.reset_launch_counts()
    fused_hough(_t(imgs[:2]), CannyConfig(),
                HoughConfig(compact=True, max_edges=512))
    assert ops.launch_counts() == {"conv2d_gemm": 0, "fused_detect": 0,
                                   "hough_vote": 0, "flash_attention": 0,
                                   "ssd_scan": 0, "tiled_matmul": 0}
