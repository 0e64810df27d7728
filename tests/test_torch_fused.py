"""The port's fused hot path against the JAX package, on shared numpy frames.

Kernel A's plain version (``fused_detect``, ``fused_weights``,
``compact_raster``), the fused transforms (``fused_hough``,
``fused_hough_tiered``) and the fused plan, each bit-exact with the JAX
package: its ``xla`` oracle and, for kernel A at 96x128, the Pallas body in
interpret mode.  Plus the kernel wrapper's refusals, which it makes before
it touches a device, and a numpy model of the kernel's long-hysteresis
schedule (passes through device memory where the tile does not fit shared
memory) with the plain version at 60 and 100 passes.  The kernel itself
runs on the card in tests/test_torch_cuda.py and chip_smoke.py.
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
    """The kernel takes every gradient tier and any hysteresis: a halo
    whose tile does not fit the shared memory a block may use is admitted
    and runs its passes through device memory.  A CPU tensor is refused,
    and so is a config no path takes, before any launch."""
    img = torch.zeros((2, 40, 50))
    need = fused_mod.smem_bytes(cfg.hysteresis_iters, cfg.variant == "paper",
                                cfg.fused)
    fused_mod.check_config(cfg)          # admitted
    assert fused_mod.tier(cfg) == {"f32": 0, "f16": 2,
                                   "int8": 3}[cfg.grad_dtype]
    assert (need <= fused_mod.MAX_SMEM) == (cfg.hysteresis_iters <= 8)
    assert bool(fused_mod.hysteresis_schedule(cfg)) == (
        need > fused_mod.MAX_SMEM)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fused_mod.fused_detect(img, cfg=cfg, edge_threshold=250.0,
                               max_edges=64)
    with pytest.raises(ValueError, match="grad_dtype"):
        fused_mod.fused_detect(img, cfg=dataclasses.replace(
            cfg, grad_dtype="bf16"), edge_threshold=250.0, max_edges=64)
    with pytest.raises(ValueError, match="grad_dtype"):
        fused_mod.check_config(dataclasses.replace(cfg, grad_dtype="bf16"))
    assert ops.launch_counts()["fused_detect"] == 0


def test_kernel_refuses_cpu_tensor_and_sizes_its_tile():
    with pytest.raises(ValueError, match="CUDA"):
        fused_mod.fused_detect(torch.zeros((40, 50)), cfg=CannyConfig(),
                               edge_threshold=250.0, max_edges=64)
    # the default tile (8 hysteresis passes) leaves room for two blocks
    # an SM (228 KB, 1 KB of it each block's own; two blocks of 16 warps
    # are what the registers allow); every halo that fits keeps the tile,
    # a longer one is admitted and goes through device memory
    assert fused_mod.smem_bytes(8, False, False) == 72144
    assert 2 * (fused_mod.smem_bytes(8, False, False) + 1024) <= 228 * 1024
    fits = [i for i in range(80)
            if fused_mod.smem_bytes(i, False, False) <= fused_mod.MAX_SMEM]
    assert fits == list(range(fits[-1] + 1)) and 30 < fits[-1] < 60
    fused_mod.check_config(CannyConfig(hysteresis_iters=fits[-1]))
    assert fused_mod.hysteresis_schedule(
        CannyConfig(hysteresis_iters=fits[-1])) == []
    fused_mod.check_config(CannyConfig(hysteresis_iters=fits[-1] + 1))
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


# --- a hysteresis longer than the tile's shared memory -----------------------


def _jacobi(strong, weak, passes):
    """``passes`` whole-frame hysteresis passes, as ``core.canny`` runs
    them: strong |= weak & dilate3(strong), zeros outside the frame."""
    H, W = strong.shape
    for _ in range(passes):
        p = np.pad(strong, 1)
        dil = np.zeros_like(strong)
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                dil |= p[dy:dy + H, dx:dx + W]
        strong = strong | (weak & dil)
    return strong


def _long_hysteresis_model(state, schedule, tile, halo):
    """The long-hysteresis path in numpy: ``state`` (H, W) of the tile
    kernel's bits at halo 0 (1 strong, 2 weak); one launch for each pass
    count of ``schedule``, each ``tile`` square core read with a ``halo``
    (zeros outside the frame) and its passes run as hysteresis_kernel runs
    them (pass k over the window of radius p - k - 1 around the core), the
    core written to the other plane; returns the last plane's strong
    bits."""
    H, W = state.shape
    src = state.astype(np.uint8)
    side = tile + 2 * halo
    for p in schedule:
        assert 1 <= p <= halo
        dst = np.zeros_like(src)
        for y0 in range(0, H, tile):
            for x0 in range(0, W, tile):
                win = np.zeros((side, side), np.uint8)
                ya, yb = max(y0 - halo, 0), min(y0 + tile + halo, H)
                xa, xb = max(x0 - halo, 0), min(x0 + tile + halo, W)
                win[ya - (y0 - halo):yb - (y0 - halo),
                    xa - (x0 - halo):xb - (x0 - halo)] = src[ya:yb, xa:xb]
                cur = win
                for k in range(p):
                    lo = halo - p + k + 1
                    nxt = np.full_like(cur, 255)    # never read unwritten
                    nb = np.stack([cur[lo - 1 + dy:side - lo + 1 - 2 + dy,
                                       lo - 1 + dx:side - lo + 1 - 2 + dx]
                                   for dy in range(3) for dx in range(3)])
                    assert (nb != 255).all()
                    c = cur[lo:side - lo, lo:side - lo]
                    nxt[lo:side - lo, lo:side - lo] = np.where(
                        (c == 2) & (nb & 1).any(0), 3, c)
                    cur = nxt
                core = cur[halo:halo + tile, halo:halo + tile]
                h, w = min(tile, H - y0), min(tile, W - x0)
                dst[y0:y0 + h, x0:x0 + w] = core[:h, :w]
        src = dst
    return (src & 1).astype(bool)


def _schedule(iters, halo):
    return [min(halo, iters - d) for d in range(0, iters, halo)]


@pytest.mark.parametrize("iters", [0, 1, 45, 60, 100])
def test_long_hysteresis_schedule_equals_whole_frame_passes(iters):
    """The long-hysteresis path's schedule (the tile kernel at halo 0, then
    ceil(iters / h) launches of at most h passes, each over cores read with
    a halo of h), modelled in numpy at a small tile and halo and at the
    kernel's own (64, 16), equals ``iters`` whole-frame passes on a
    serpentine weak path that needs every pass.  The kernel takes that
    path exactly where its tile does not fit shared memory."""
    H, W = 21, 26
    rng = np.random.default_rng(iters)
    weak = np.zeros((H, W), bool)
    for i, y in enumerate(range(1, H, 4)):          # a serpentine path
        weak[y, 1:W - 1] = True
        x = W - 2 if i % 2 == 0 else 1
        weak[y:min(y + 5, H), x] = True
    weak |= rng.random((H, W)) < 0.05
    strong = np.zeros((H, W), bool)
    strong[1, 1] = True
    strong |= (rng.random((H, W)) < 0.004) & ~weak
    weak &= ~strong
    state = strong.astype(np.uint8) | (weak.astype(np.uint8) << 1)
    want = _jacobi(strong, weak, iters)
    for tile, halo in ((8, 3), (64, fused_mod.HYST_HALO)):
        got = _long_hysteresis_model(state, _schedule(iters, halo), tile,
                                     halo)
        np.testing.assert_array_equal(got, want)
    if iters >= 45:     # the path needs the passes: fewer change the edges
        assert (want != _jacobi(strong, weak, iters - 10)).any()
    cfg = CannyConfig(hysteresis_iters=iters)
    assert fused_mod.hysteresis_schedule(cfg) == (
        _schedule(iters, fused_mod.HYST_HALO) if iters > 41 else [])
    assert fused_mod.hysteresis_schedule(
        dataclasses.replace(cfg, variant="paper")) == []
    assert fused_mod.hysteresis_schedule(
        dataclasses.replace(cfg, fused=True)) == (
        _schedule(iters, fused_mod.HYST_HALO) if iters > 41 else [])


def _snake_frames(lo=30.0, hi=120.0, noise=True):
    """Two 40x50 frames of a serpentine stripe of low contrast with one
    bright end (and its mirror): a weak edge chain that hysteresis walks
    one pixel a pass, so 45, 60 and 100 passes give different edges.
    ``noise`` adds seeded noise below one grey level, which breaks the
    exact gradient ties of the flat plateaus: the two packages' f32 convs
    sum in different orders and resolve those ties differently."""
    H, W = 40, 50
    img = np.zeros((H, W), np.float32)
    for i, y in enumerate(range(5, H - 5, 6)):
        img[y:y + 3, 5:W - 5] = lo
        x = W - 8 if i % 2 == 0 else 5
        if y + 6 < H - 5:
            img[y:y + 9, x:x + 3] = lo
    img[5:8, 5:9] = hi
    img = np.stack([img, img[::-1, ::-1]])
    if not noise:
        return img
    return img + np.random.default_rng(0).uniform(0, 1, img.shape).astype(
        np.float32)


@pytest.mark.parametrize("iters", [60, 100])
@pytest.mark.parametrize("cfg", [
    CannyConfig(), CannyConfig(integer=True), CannyConfig(grad_dtype="int8"),
], ids=["f32", "integer", "int8"])
def test_fused_detect_plain_long_hysteresis_matches_reference(iters, cfg):
    """At 60 and 100 hysteresis passes (past the tile's shared memory on
    the card) the port's plain ``fused_detect`` equals the JAX package's
    Pallas body in interpret mode and its staged oracle, and the port's
    own staged Canny -> threshold -> compaction, in the f32, integer and
    int8 tiers; the passes matter (45 give fewer edges).  The integer and
    int8 tiers, whose conv sums are exact, take the bare plateau frames;
    f32 takes them under sub-grey noise (see :func:`_snake_frames`)."""
    cfg = dataclasses.replace(cfg, hysteresis_iters=iters)
    imgs = _snake_frames(noise=cfg.grad_dtype == "f32" and not cfg.integer)
    assert fused_mod.hysteresis_schedule(cfg)     # the planes path on the card
    got = ops.fused_detect(_t(imgs), None, cfg=cfg, edge_threshold=250.0,
                           max_edges=512)
    for i in range(2):
        want = jops.fused_detect(jnp.asarray(imgs[i]), None,
                                 cfg=_jcanny(cfg), edge_threshold=250.0,
                                 max_edges=512, impl="interpret")
        _assert_same(tuple(t[i] for t in got), want)
    want = jref.fused_detect(jnp.asarray(imgs), cfg=_jcanny(cfg),
                             edge_threshold=250.0, max_edges=512)
    _assert_same(got, want)
    edges = canny(_t(imgs), cfg).reshape(2, -1)
    staged = ops.compact_raster((edges >= 250).float(), width=imgs.shape[2],
                                max_edges=512)
    for a, b in zip(got, staged):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    fewer = ops.fused_detect(_t(imgs), None, cfg=dataclasses.replace(
        cfg, hysteresis_iters=45), edge_threshold=250.0, max_edges=512)
    assert (fewer[2] < got[2]).all()


# --- the tile kernel's bit-packed hysteresis ----------------------------------


def _pack_rows(bits):
    """(h, w) bools -> (h, ceil(w / 32)) uint32 words, bit b of word k the
    pixel 32 k + b: the layout of the tile kernel's bit planes."""
    h, w = bits.shape
    nw = -(-w // 32)
    padded = np.zeros((h, nw * 32), bool)
    padded[:, :w] = bits
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return (padded.reshape(h, nw, 32) * weights).sum(-1, dtype=np.uint32)


def _unpack_rows(words, w):
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :w].astype(bool)


def _dilate_words(s):
    """dilate3x3 of a bit plane, word by word as the kernel's dilate_row:
    shifts by one bit with the carry from the neighbouring word, ORed over
    three rows, zeros beyond the plane."""
    zero = np.zeros((s.shape[0], 1), np.uint32)
    lo = np.concatenate([zero, s[:, :-1]], 1)   # the word to the left
    hi = np.concatenate([s[:, 1:], zero], 1)    # the word to the right
    row = s | (s << 1) | (lo >> 31) | (s >> 1) | (hi << 31)
    pad = np.zeros((1, s.shape[1]), np.uint32)
    up = np.concatenate([pad, row[:-1]])
    down = np.concatenate([row[1:], pad])
    return row | up | down


def _windows(frame, tile_h, tile_w, r):
    """Each tile's window of ``frame`` with radius ``r``, zeros outside the
    frame: ``(y0, x0, window)`` for every tile."""
    H, W = frame.shape
    p = np.zeros((H + 2 * r + tile_h, W + 2 * r + tile_w), frame.dtype)
    p[r:r + H, r:r + W] = frame
    for y0 in range(0, H, tile_h):
        for x0 in range(0, W, tile_w):
            yield y0, x0, p[y0:y0 + tile_h + 2 * r, x0:x0 + tile_w + 2 * r]


def _bit_tile_hysteresis(strong, weak, passes, tile_h, tile_w):
    """The tile kernel's hysteresis in numpy: each tile's window (radius
    ``passes``, zeros outside the frame) packed into words, ``passes``
    Jacobi passes ``S |= Wk & dilate3x3(S)`` over the whole window with
    zeros beyond it, the tile's bits kept."""
    H, W = strong.shape
    r = passes
    out = np.zeros((H, W), bool)
    wins = zip(_windows(strong, tile_h, tile_w, r),
               _windows(weak, tile_h, tile_w, r))
    for (y0, x0, s_win), (_, _, w_win) in wins:
        s, wk = _pack_rows(s_win), _pack_rows(w_win)
        for _ in range(passes):
            s = s | (wk & _dilate_words(s))
        tile = _unpack_rows(s, tile_w + 2 * r)[r:r + tile_h, r:r + tile_w]
        h, w = min(tile_h, H - y0), min(tile_w, W - x0)
        out[y0:y0 + h, x0:x0 + w] = tile[:h, :w]
    return out


def _byte_tile_hysteresis(strong, weak, passes, tile_h, tile_w):
    """The byte form the kernel had before: one byte a pixel (1 strong,
    2 weak), pass k updating the window of radius passes - k - 1 from the
    previous pass's values."""
    H, W = strong.shape
    r = passes
    state = strong.astype(np.uint8) | (weak & ~strong).astype(np.uint8) << 1
    out = np.zeros((H, W), bool)
    for y0, x0, win in _windows(state, tile_h, tile_w, r):
        cur = win.copy()
        hs, ws = cur.shape
        for k in range(passes):
            lo = k + 1
            nxt = cur.copy()
            core = cur[lo:hs - lo, lo:ws - lo]
            nb = np.zeros_like(core, bool)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    nb |= (cur[lo + dy:hs - lo + dy, lo + dx:ws - lo + dx]
                           & 1).astype(bool)
            nxt[lo:hs - lo, lo:ws - lo] = np.where((core == 2) & nb, 3, core)
            cur = nxt
        h, w = min(tile_h, H - y0), min(tile_w, W - x0)
        out[y0:y0 + h, x0:x0 + w] = (cur[r:r + h, r:r + w] & 1).astype(bool)
    return out


def _serpentine_bits(H, W, seed):
    """Weak pixels on a serpentine path (it needs every pass) and seeded
    noise; a few strong seeds, one at the path's start."""
    rng = np.random.default_rng(seed)
    weak = np.zeros((H, W), bool)
    for i, y in enumerate(range(1, H, 4)):
        weak[y, 1:W - 1] = True
        x = W - 2 if i % 2 == 0 else 1
        weak[y:min(y + 5, H), x] = True
    weak |= rng.random((H, W)) < 0.08
    strong = np.zeros((H, W), bool)
    strong[1, 1] = True
    strong |= rng.random((H, W)) < 0.005
    return strong, weak & ~strong


@pytest.mark.parametrize("shape", [(37, 75), (70, 141)],
                         ids=["37x75", "70x141"])
@pytest.mark.parametrize("passes", [0, 1, 8, 30])
def test_bit_hysteresis_equals_jacobi_and_byte_form(passes, shape):
    """The tile kernel's bit-packed hysteresis (word shifts with carries,
    three rows ORed, zeros beyond the window) equals ``passes`` whole-frame
    Jacobi passes and the byte form it replaced, at the kernel's own tile
    and at a 32x8 one, on frames whose tiles and windows cross word
    boundaries and the frame's edges; so does the paper variant's single
    dilation (its weak bits include the strong ones)."""
    H, W = shape
    strong, weak = _serpentine_bits(H, W, seed=passes)
    want = _jacobi(strong, weak, passes)
    for tile_h, tile_w in ((fused_mod.TILE_H, fused_mod.TILE_W), (8, 32)):
        got = _bit_tile_hysteresis(strong, weak, passes, tile_h, tile_w)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            _byte_tile_hysteresis(strong, weak, passes, tile_h, tile_w), want)
    edge = strong | weak
    np.testing.assert_array_equal(
        _bit_tile_hysteresis(strong, edge, 1, 8, 32),
        _jacobi(strong, edge, 1))
    if passes >= 8:     # the passes matter: fewer give other edges
        assert (want != _jacobi(strong, weak, passes - 4)).any()


def test_bit_words_shift_with_carries():
    """dilate_row's carries: a pixel at a word's last bit reaches the next
    word's first, one at a word's first bit the last of the word before;
    nothing wraps round a row, and the bits past the window's width never
    enter S (their weak bits are zero)."""
    bits = np.zeros((3, 70), bool)
    bits[1, 0] = bits[1, 31] = bits[1, 64] = bits[1, 69] = True
    got = _unpack_rows(_dilate_words(_pack_rows(bits)), 70)
    want = np.zeros_like(bits)
    for x in (0, 31, 64, 69):
        want[:, max(x - 1, 0):x + 2] = True
    np.testing.assert_array_equal(got, want)
    s = _pack_rows(bits)
    s = s | (_pack_rows(np.ones_like(bits)) & _dilate_words(s))
    assert not _unpack_rows(s, 96)[:, 70:].any()


# --- the single-pass look-back compaction -------------------------------------


def _lookback_compaction(keep, width, max_edges, chunk_words, rng):
    """The compaction kernel in numpy: ``keep`` (N, H, nseg) uint32 keep
    words cut into chunks of ``chunk_words`` in raster order, frame by
    frame, one ticket each.  Every chunk publishes its popcount (AGG); then
    the chunks resolve in a random order, each adding its frame's earlier
    chunks' published values back to the first PREFIX (a frame's first
    chunk has its prefix at once) and scattering its pixels from that
    rank; the frame's last chunk writes the count, and the rows from it to
    ``max_edges`` are cleared."""
    N, H, nseg = keep.shape
    S = H * nseg
    cpf = -(-S // chunk_words)
    words = keep.reshape(N, S)
    cxy = np.full((N, max_edges, 3), np.nan, np.float32)   # unwritten
    cw = np.full((N, max_edges), np.nan, np.float32)
    counts = np.full(N, -1, np.int32)
    flags = []
    for t in range(N * cpf):
        n, j = divmod(t, cpf)
        chunk = words[n, j * chunk_words:(j + 1) * chunk_words]
        agg = int(sum(int(w).bit_count() for w in chunk))
        flags.append(["PREFIX" if j == 0 else "AGG", agg])
    for t in rng.permutation(N * cpf):
        n, j = divmod(int(t), cpf)
        excl, k = 0, int(t) - 1
        while j > 0:
            status, value = flags[k]
            excl += value
            if status == "PREFIX":
                break
            k -= 1
        agg = flags[t][1]
        flags[t] = ["PREFIX", excl + agg]
        g0 = j * chunk_words
        chunk = words[n, g0:g0 + chunk_words]
        bits = (chunk[:, None] >> np.arange(32, dtype=np.uint32)) & 1
        g, b = np.nonzero(bits)                  # raster order in the chunk
        slot = excl + np.arange(g.size)
        ok = slot < max_edges
        y, s = np.divmod(g0 + g[ok], nseg)
        cxy[n, slot[ok]] = np.stack([s * 32 + b[ok], y, np.ones_like(y)],
                                    1).astype(np.float32)
        cw[n, slot[ok]] = 1.0
        if j == cpf - 1:
            counts[n] = min(excl + agg, max_edges)
    for n in range(N):     # the clearing blocks
        cxy[n, counts[n]:] = 0.0
        cw[n, counts[n]:] = 0.0
    return cxy, cw, counts


def _keep_words(weights, width):
    """(N, H, W) 0/1 weights -> (N, H, ceil(W / 32)) keep words."""
    N, Hh, Ww = weights.shape
    nseg = -(-width // 32)
    padded = np.zeros((N, Hh, nseg * 32), bool)
    padded[..., :Ww] = weights > 0
    return _pack_rows(padded.reshape(N * Hh, -1)).reshape(N, Hh, nseg)


@pytest.mark.parametrize("case", [
    "chunk_splits_rows", "max_edges_mid_chunk", "empty_frame", "overflow",
    "kernel_chunk",
])
def test_lookback_compaction_matches_compact_raster(case):
    """The look-back compaction, chunks resolved in random orders, equals
    ``compact_raster`` (the plain version): chunks that end inside a row
    (5 words over rows of 3 segments), ``max_edges`` landing inside a
    chunk, a frame with no edge beside two with edges, a frame with more
    edges than ``max_edges``, and the kernel's own chunk (4 chunks a
    frame)."""
    rng = np.random.default_rng(22)
    shape, density, max_edges, chunk = {
        "chunk_splits_rows": ((3, 9, 70), 0.3, 4096, 5),
        "max_edges_mid_chunk": ((2, 12, 70), 0.4, 37, 4),
        "empty_frame": ((3, 10, 70), 0.2, 512, 7),
        "overflow": ((2, 20, 100), 0.9, 300, 6),
        "kernel_chunk": ((2, 90, 1300), 0.02, 2048, fused_mod.CHUNK_WORDS),
    }[case]
    N, Hh, Ww = shape
    weights = (rng.random(shape) < density).astype(np.float32)
    if case == "empty_frame":
        weights[1] = 0.0
    keep = _keep_words(weights, Ww)
    S = Hh * keep.shape[2]
    if case == "chunk_splits_rows":
        assert S % chunk and chunk % keep.shape[2]
    if case == "kernel_chunk":
        assert -(-S // chunk) == 4
    want = ops.compact_raster(_t(weights.reshape(N, -1)), width=Ww,
                              max_edges=max_edges)
    edges = weights.reshape(N, -1).sum(-1)
    if case == "max_edges_mid_chunk":
        # the cut falls inside a chunk of every frame
        assert ((edges > max_edges)).all()
    if case == "overflow":
        assert (edges > max_edges).all()
    for order in range(3):
        got = _lookback_compaction(keep, Ww, max_edges, chunk,
                                   np.random.default_rng(order))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy())


# --- the launch plan ------------------------------------------------------------


def test_launch_plan_pins_the_main_path_shapes():
    """The wrapper's mirror of the C entry's launch plan at the two
    main-path shapes: a 720x1280 batch of 8 and one tracking frame, at the
    default config: 128x32 tiles, 230 blocks a frame (10 of them only 16
    rows deep), 72144 bytes of shared memory, no hysteresis launch; the
    compaction's 29 chunks a frame and 29 clearing blocks a frame of the
    57600-row buffer.  The long-hysteresis threshold: 42 passes with
    either mask set, none for the paper variant."""
    cap = ops.default_max_edges(720 * 1280)
    assert cap == 57600
    batch = fused_mod.launch_plan(CannyConfig(), 8, 720, 1280, cap)
    assert batch == {
        "tile": (32, 128), "smem_bytes": 72144, "tile_blocks_a_frame": 230,
        "hysteresis_launches": 0, "planes_from_passes": 42,
        "chunks_a_frame": 29, "compact_blocks": 8 * 29 + 8 * 29,
        "flag_words": 8 * 29 + 1}
    frame = fused_mod.launch_plan(CannyConfig(), 1, 720, 1280, cap)
    assert frame == {**batch, "compact_blocks": 29 + 29, "flag_words": 30}
    for kw, first in (({}, 42), ({"fused": True}, 42),
                      ({"integer": True}, 42), ({"grad_dtype": "int8"}, 42)):
        at = fused_mod.launch_plan(CannyConfig(hysteresis_iters=first, **kw),
                                   8, 720, 1280, cap)
        below = fused_mod.launch_plan(
            CannyConfig(hysteresis_iters=first - 1, **kw), 8, 720, 1280, cap)
        assert at["planes_from_passes"] == below["planes_from_passes"] == first
        assert below["hysteresis_launches"] == 0
        assert below["smem_bytes"] <= fused_mod.MAX_SMEM
        assert at["hysteresis_launches"] == 3      # 16 + 16 + 10
        assert at["smem_bytes"] == fused_mod.smem_bytes(0, False,
                                                        kw.get("fused", False))
    paper = fused_mod.launch_plan(CannyConfig(variant="paper",
                                              hysteresis_iters=100),
                                  8, 720, 1280, cap)
    assert paper["planes_from_passes"] is None
    assert paper["hysteresis_launches"] == 0
    # a frame smaller than a tile, and W not a multiple of 32
    tiny = fused_mod.launch_plan(CannyConfig(), 3, 21, 19, 64)
    assert (tiny["tile_blocks_a_frame"], tiny["chunks_a_frame"],
            tiny["compact_blocks"], tiny["flag_words"]) == (1, 1, 6, 4)
