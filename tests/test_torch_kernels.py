"""The port's kernel modules against the JAX package, on shared numpy inputs.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
in interpret mode at tiny shapes, and the ``ref.py`` oracles.  The port's
side is the plain PyTorch version each kernel wrapper takes for a CPU
tensor.  The hand kernels themselves are tested on the card by
tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.conv2d_gemm import conv2d_gemm as jconv  # noqa: E402
from repro.kernels.hough_vote import hough_vote as jvote  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import conv2d_gemm as conv_mod  # noqa: E402
from repro_torch.kernels.tiles import acc_dtype, cdiv, round_up  # noqa: E402


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


def test_acc_dtype_rule_and_sizing():
    assert acc_dtype(torch.int32) == torch.int32
    assert acc_dtype(torch.int8) == torch.int32
    assert acc_dtype(torch.uint8) == torch.int32
    assert acc_dtype(torch.float16) == torch.float16
    assert acc_dtype(torch.float32) == torch.float32
    assert acc_dtype(torch.bfloat16) == torch.float32
    assert (round_up(37, 8), cdiv(37, 8), round_up(40, 8)) == (40, 5, 40)


# --- conv ------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(16, 24), (37, 52), (64, 64)])
@pytest.mark.parametrize("masks", [(1, 3, 3), (3, 5, 5), (3, 7, 7)])
def test_conv_plain_matches_pallas_interpret(rng, hw, masks):
    """The shape and mask sweep of the reference's own kernel tests: f32 at
    rtol = atol = 1e-4 (the sums run in another order)."""
    img = rng.normal(size=hw).astype(np.float32)
    m = rng.normal(size=masks).astype(np.float32)
    want = jconv(jnp.asarray(img), jnp.asarray(m), interpret=True, bh=8)
    got = ops.conv2d_gemm(_t(img), _t(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["int32", "int8"])
def test_conv_plain_int_exact(rng, dtype):
    lo, hi = (0, 255) if dtype == "int32" else (-128, 127)
    img = rng.integers(lo, hi, (40, 56)).astype(dtype)
    m = rng.integers(-16, 16, (3, 5, 5)).astype(np.int32)
    want = jconv(jnp.asarray(img), jnp.asarray(m), interpret=True, bh=8)
    got = ops.conv2d_gemm(_t(img), _t(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv_plain_batch_equals_per_frame(rng):
    imgs = rng.normal(size=(3, 21, 37)).astype(np.float32)
    m = rng.normal(size=(3, 5, 5)).astype(np.float32)
    got = ops.conv2d_gemm(_t(imgs), _t(m))
    assert got.shape == (3, 3, 21, 37)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(), ops.conv2d_gemm(_t(imgs[i]), _t(m)).numpy()
        )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.conv2d_gemm(jnp.asarray(imgs),
                                                 jnp.asarray(m))),
        rtol=1e-4, atol=1e-4,
    )


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_conv_stencil_matches_reference(rng, dtype):
    img = (rng.integers(0, 255, (2, 19, 23)) if dtype == "int32"
           else rng.normal(size=(2, 19, 23))).astype(dtype)
    m = rng.integers(-8, 8, (2, 3, 3)).astype(dtype)
    want = np.asarray(jref.conv2d_stencil(jnp.asarray(img), jnp.asarray(m)))
    got = ops.conv2d_stencil(_t(img), _t(m)).numpy()
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv_kernel_refuses_cpu_tensor(rng):
    img = _t(rng.normal(size=(8, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        conv_mod.conv2d_gemm(img, _t(np.ones((1, 3, 3), np.float32)))


# --- vote ------------------------------------------------------------------


def _vote_inputs(rng, n_pix, n_theta, n_rho, edge_frac=0.3, batch=None):
    xy = rng.uniform(0, 40, (n_pix, 3)).astype(np.float32)
    xy[:, 2] = 1.0
    shape = (batch, n_pix) if batch else (n_pix,)
    w = (rng.uniform(size=shape) > 1 - edge_frac).astype(np.float32)
    trig = rng.uniform(-1, 1, (3, n_theta)).astype(np.float32)
    trig[2] = n_rho / 2.5
    return xy, w, trig


@pytest.mark.parametrize("per_frame", [False, True])
def test_vote_plain_bit_exact_with_pallas_and_ref(rng, per_frame):
    """0/1 weights: the port's vote equals the Pallas kernel (interpret)
    and the oracle bit for bit, with shared and per-frame coordinates."""
    xy, w, trig = _vote_inputs(rng, 200, 90, 150, batch=3)
    if per_frame:
        xy = np.stack([xy, xy[::-1].copy(), np.roll(xy, 5, axis=0)])
    want = jvote(jnp.asarray(xy), jnp.asarray(w), jnp.asarray(trig),
                 n_rho=150, interpret=True, br=32, bp=64, bt=32)
    got = ops.hough_vote(_t(xy), _t(w), _t(trig), n_rho=150)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jref.hough_vote(jnp.asarray(xy), jnp.asarray(w),
                                   jnp.asarray(trig), n_rho=150)),
    )


def test_rho_product_keeps_xla_rounding_at_deploy_resolution():
    """The plain rho product differs from XLA's dot in no value on the full
    720x1280 raster x 180 thetas (a floor() turns any difference into a
    moved vote)."""
    from repro.core.hough import HoughConfig as JHC
    from repro.core.hough import hough_trig as jtrig
    from repro_torch.core.hough import _device_raster

    H, W = 720, 1280
    trig = jtrig(H, W, JHC())
    xy = _device_raster(H, W, torch.device("cpu"))
    want = np.asarray(jnp.asarray(xy.numpy()) @ jnp.asarray(trig))
    got = ref.rho_product(xy, _t(trig))
    assert int((got.numpy() != want).sum()) == 0
    # and why the order matters: the unfused (x*c + y*s) + d, each op
    # rounded on its own, differs in 7623128 values and moves 1046 bins
    tt = _t(trig)
    differ = moved = 0
    for rows, fused in zip(torch.chunk(xy, 8), torch.chunk(got, 8)):
        unfused = (rows[:, 0:1] * tt[0] + rows[:, 1:2] * tt[1]) + tt[2]
        differ += int((unfused != fused).sum())
        moved += int((torch.floor(unfused) != torch.floor(fused)).sum())
    assert (differ, moved) == (7623128, 1046)


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("max_edges", [16, 64, 250])
def test_compaction_bit_exact_with_reference(rng, batch, max_edges):
    """cumsum + scatter compaction == the reference's stable-argsort oracle,
    overflow drops included; the port's own argsort oracle agrees too."""
    xy, w, _ = _vote_inputs(rng, 200, 8, 60, edge_frac=0.4, batch=batch)
    jxy, jw = jref.compact_edges(jnp.asarray(xy), jnp.asarray(w),
                                 max_edges=max_edges)
    cxy, cw, counts = ops.compact_edges(_t(xy), _t(w), max_edges=max_edges)
    rows = min(max_edges, 200)  # the oracle keeps min(P, max_edges) rows
    np.testing.assert_array_equal(cxy.numpy()[..., :rows, :], np.asarray(jxy))
    np.testing.assert_array_equal(cw.numpy()[..., :rows], np.asarray(jw))
    np.testing.assert_array_equal(
        counts.numpy(), np.minimum((w > 0).sum(-1), max_edges)
    )
    assert counts.dtype == torch.int32
    oxy, ow = ref.compact_edges(_t(xy), _t(w), max_edges=max_edges)
    np.testing.assert_array_equal(oxy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(ow.numpy(), np.asarray(jw))


def test_compaction_overflow_keeps_first_rows(rng):
    xy, _, _ = _vote_inputs(rng, 100, 8, 60)
    cxy, cw, counts = ops.compact_edges(_t(xy), torch.ones(100), max_edges=16)
    np.testing.assert_array_equal(cxy.numpy(), xy[:16])
    np.testing.assert_array_equal(cw.numpy(), np.ones(16, np.float32))
    assert int(counts) == 16


def test_compacted_vote_equals_reference(rng):
    xy, w, trig = _vote_inputs(rng, 400, 45, 80, edge_frac=0.1, batch=2)
    want = jref.hough_vote_compact(jnp.asarray(xy), jnp.asarray(w),
                                   jnp.asarray(trig), n_rho=80, max_edges=64)
    got = ops.hough_vote(_t(xy), _t(w), _t(trig), n_rho=80, compact=True,
                         max_edges=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.hough_vote_compact(_t(xy), _t(w), _t(trig), n_rho=80,
                               max_edges=64).numpy(),
        np.asarray(want),
    )


@pytest.mark.parametrize("bins", [[3, 4, 5, 6], [0, 10, 10, 44], list(range(45))])
def test_gated_vote_matches_reference(rng, bins):
    xy, w, trig = _vote_inputs(rng, 300, 45, 80, batch=2)
    tb = np.array(bins, np.int32)
    want = np.asarray(jref.hough_vote_gated(
        jnp.asarray(xy), jnp.asarray(w), jnp.asarray(trig), jnp.asarray(tb),
        n_rho=80))
    got = ops.hough_vote(_t(xy), _t(w), _t(trig), n_rho=80,
                         theta_bins=_t(tb))
    np.testing.assert_array_equal(got.numpy(), want)
    band = ops.hough_vote(_t(xy), _t(w), _t(trig), n_rho=80,
                          theta_bins=_t(tb), scatter_back=False)
    np.testing.assert_array_equal(band.numpy(), want[..., tb])
    np.testing.assert_array_equal(
        ref.hough_vote_gated(_t(xy), _t(w), _t(trig), _t(tb),
                             n_rho=80).numpy(), want)


def test_vote_rejects_unresolved_auto(rng):
    xy, w, trig = _vote_inputs(rng, 50, 8, 30)
    with pytest.raises(TypeError, match="auto"):
        ops.hough_vote(_t(xy), _t(w), _t(trig), n_rho=30, compact=True,
                       max_edges="auto")


def test_grad_hits_and_corridor_keep_match_reference(rng):
    img = rng.uniform(0, 255, (2, 40, 56)).astype(np.float32)
    cor = np.array([[math.cos(0.5), math.sin(0.5), 5.0, 20.0],
                    [1.0, 0.0, 30.0, 40.0]], np.float32)
    for corridors in (None, cor):
        want = jref.grad_hits(jnp.asarray(img), stride=2, thresh=30.0,
                              corridors=None if corridors is None
                              else jnp.asarray(corridors), widen=4.0)
        got = ops.grad_hits(_t(img), stride=2, thresh=30.0,
                            corridors=None if corridors is None
                            else _t(corridors), widen=4.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xy = rng.uniform(0, 50, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ref.corridor_keep(_t(xy), _t(cor)).numpy(),
        np.asarray(jref.corridor_keep(jnp.asarray(xy), jnp.asarray(cor))),
    )


def test_corridor_product_rounds_as_the_reference():
    """The corridor product is two rounded products and one rounded add,
    as the reference's dot rounds it at the tracker's corridor count (8)
    on a full raster.  Constructed: a pixel whose ``fma(y, s, x*c)`` (what
    ``torch.matmul`` computes on the CPU) lies one ulp below that, with the
    corridor's lower bound at the reference's value: the reference and the
    port keep the pixel, the matmul form drops it."""
    H, W = 120, 160
    jj, ii = np.meshgrid(np.arange(W), np.arange(H))
    xy = np.stack([jj.ravel(), ii.ravel()], 1).astype(np.float32)
    th = np.random.default_rng(5).uniform(0.0, math.pi, 8)
    cor = np.stack([np.cos(th), np.sin(th), np.full(8, -1e6),
                    np.full(8, -1e6)], 1).astype(np.float32)
    rho_ref = np.asarray(jnp.asarray(xy) @ jnp.asarray(cor[:, :2]).T)
    rho_mm = (_t(xy) @ _t(cor[:, :2]).T).numpy()
    p, c = np.argwhere(rho_mm < rho_ref)[0]
    # the pixel's products: the reference rounds each, then adds
    x, y = xy[p]
    assert rho_ref[p, c] == np.float32(x * cor[c, 0]) + np.float32(y * cor[c, 1])
    cor[c, 2:] = rho_ref[p, c], rho_ref[p, c] + 10.0
    want = np.asarray(jref.corridor_keep(jnp.asarray(xy), jnp.asarray(cor)))
    got = ref.corridor_keep(_t(xy), _t(cor)).numpy()
    assert want[p] and got[p]
    np.testing.assert_array_equal(got, want)
    old = ((rho_mm >= cor[:, 2]) & (rho_mm <= cor[:, 3])).any(-1)
    assert not old[p]


def test_reference_corridor_rounding_depends_on_the_corridor_count():
    """The reference's own corridor product rounds by shape: on the
    720x1280 raster its dot equals the two-product form at 4 and 8
    corridors and ``torch.matmul``'s ``fma(y, s, x*c)`` at 1, 2 and 16.
    The port takes the two-product form of the tracker's 8 corridors."""
    H, W = 720, 1280
    jj, ii = np.meshgrid(np.arange(W), np.arange(H))
    xy = np.stack([jj.ravel(), ii.ravel()], 1).astype(np.float32)
    got = {}
    for C in (1, 2, 4, 8, 16):
        th = np.random.default_rng(5).uniform(0.0, math.pi, C)
        cs = _t(np.stack([np.cos(th), np.sin(th)], 1).astype(np.float32))
        want = np.asarray(jnp.asarray(xy) @ jnp.asarray(cs.numpy()).T)
        t = _t(xy)
        two_products = (t[:, 0:1] * cs[:, 0] + t[:, 1:2] * cs[:, 1]).numpy()
        fma = (t @ cs.T).numpy()
        got[C] = (int((want != two_products).sum()), int((want != fma).sum()))
    assert got == {1: (253160, 0), 2: (499993, 0), 4: (0, 948101),
                   8: (0, 1409840), 16: (2655189, 0)}


def test_cpu_dispatch_launches_no_kernel(rng):
    ops.reset_launch_counts()
    xy, w, trig = _vote_inputs(rng, 64, 8, 30, batch=2)
    ops.hough_vote(_t(xy), _t(w), _t(trig), n_rho=30, compact=True)
    ops.conv2d_gemm(_t(rng.normal(size=(9, 9)).astype(np.float32)),
                    torch.ones(1, 3, 3))
    assert ops.launch_counts() == {"conv2d_gemm": 0, "fused_detect": 0,
                                   "hough_vote": 0, "flash_attention": 0,
                                   "ssd_scan": 0, "tiled_matmul": 0}
