"""The conv kernel's design on the CPU (``kernels/csrc/conv2d.cu``).

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Here: its launch plan as the wrapper mirrors it, pinned
at the main path's shapes; a torch model of its schedule (which thread
computes which outputs, from which window cells, in which tap order),
held to the JAX package's oracle at ragged shapes; and the wrapper's
refusals, which it makes before it touches a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import conv2d_gemm as conv_mod  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32, F16, I32, I8 = torch.float32, torch.float16, torch.int32, torch.int8


def test_launch_plan_pins_the_main_path_shapes():
    """At 720x1280: 128x16 tiles of 128 threads, 10 x 45 blocks a frame;
    the Gauss, Sobel and fused masks take their unrolled instances; the
    window's pad is a 16-byte copy (4 f32 / int32, 8 f16, 16 int8
    elements), so each row of 1280 goes by 16-byte copies."""
    plan = conv_mod.launch_plan
    gauss = plan(F32, 8, 720, 1280, 1, 5, 5)
    assert gauss == {"instance": 5, "tile": (16, 128), "threads": 128,
                     "grid": (10, 45, 8), "smem_bytes": 112 + 20 * 136 * 4,
                     "vector_rows": True}
    sobel = plan(F32, 8, 720, 1280, 2, 3, 3)
    assert (sobel["instance"], sobel["smem_bytes"]) == (3, 80 + 18 * 136 * 4)
    fused = plan(F32, 8, 720, 1280, 3, 7, 7)
    assert (fused["instance"], fused["smem_bytes"]) == (7, 592 + 22 * 136 * 4)
    assert plan(I32, 8, 720, 1280, 1, 5, 5) == gauss
    assert plan(F16, 8, 720, 1280, 1, 5, 5)["smem_bytes"] == 64 + 20 * 144 * 2
    assert plan(I8, 8, 720, 1280, 2, 3, 3)["smem_bytes"] == 80 + 18 * 160
    frame = plan(F32, 1, 720, 1280, 2, 3, 3)
    assert frame["grid"] == (10, 45, 1) and frame["instance"] == 3
    # every other shape takes the generic instance
    for kh, kw in ((1, 1), (3, 5), (2, 2), (9, 9), (15, 15), (4, 6)):
        assert plan(F32, 1, 8, 8, 1, kh, kw)["instance"] == 0
    assert [conv_mod.pad(0, b) for b in (4, 2, 1)] == [8, 8, 16]


@pytest.mark.parametrize("dtype", [F32, F16, I32, I8])
def test_launch_plan_fits_default_shared_memory(dtype):
    """The largest masks the wrapper takes (15x15, 1024 taps) fit the 48 KB
    a block gets without raising its limit, in every instance; rows whose
    byte width is not a multiple of 16 go element by element."""
    for m, kh, kw in ((4, 15, 15), (1024, 1, 1), (20, 7, 7), (113, 3, 3)):
        assert m * kh * kw <= conv_mod.MAX_MASK_TAPS
        assert conv_mod.launch_plan(dtype, 1, 64, 64, m, kh, kw)[
            "smem_bytes"] <= 48 * 1024
    in_b = torch.empty((), dtype=dtype).element_size()
    for w in (19, 52, 70, 1280):
        assert conv_mod.launch_plan(dtype, 1, 4, w, 1, 3, 3)[
            "vector_rows"] == (w * in_b % 16 == 0)


def _window(img, n, y0, x0, rows, pitch, ph, pad, vector, in_b):
    """A block's window as the kernel fills it: row r, column c holds pixel
    (y0 - ph + r, x0 - pad + c), zero outside the frame, by 16-byte copies
    (a copy lies wholly inside the frame or outside) or by elements."""
    _, H, W = img.shape
    ys = y0 - ph + torch.arange(rows)[:, None]
    xs = x0 - pad + torch.arange(pitch)[None, :]
    inside = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    if vector:
        e = 16 // in_b
        starts = x0 - pad + (torch.arange(pitch) // e) * e  # each copy's start
        chunk_in = (ys >= 0) & (ys < H) & (starts >= 0) & (starts < W)
        assert torch.equal(chunk_in, inside)
    win = torch.zeros((rows, pitch), dtype=img.dtype)
    win[inside] = img[n, ys.clamp(0, H - 1), xs.clamp(0, W - 1)][inside]
    return win


def _kernel_model(img, masks, dtype):
    """The kernel's schedule run in torch (float64 or int64 sums): for each
    block, its window; each thread's column and strips, one mask at a time;
    every input row of a strip read once, each output's taps added in turn.
    Returns the (N, M, H, W) output, how often each output was stored, and
    asserts on the way that every chain takes its taps in the reference's
    order (dy-major, dx-minor) and has all of them when stored."""
    N, H, W = img.shape
    M, kh, kw = masks.shape
    in_b = torch.empty((), dtype=dtype).element_size()
    plan = conv_mod.launch_plan(dtype, N, H, W, M, kh, kw)
    th, tw = plan["tile"]
    threads, strip = plan["threads"], conv_mod.STRIP
    pad = conv_mod.pad(plan["instance"], in_b)
    pitch, rows = 2 * pad + tw, th + kh - 1
    ph, pw = kh // 2, kw // 2
    gx, gy, gz = plan["grid"]
    out = torch.zeros((N, M, H, W), dtype=img.dtype)
    stores = torch.zeros((N, M, H, W), dtype=torch.int64)
    tid = torch.arange(threads)
    col = tid % tw
    for n in range(gz):
        for by in range(gy):
            for bx in range(gx):
                y0, x0 = by * th, bx * tw
                win = _window(img, n, y0, x0, rows, pitch, ph, pad,
                              plan["vector_rows"], in_b)
                x = x0 + col
                for m in range(M):
                    for s0 in range(0, th // strip, threads // tw):
                        s = tid // tw + s0
                        r0 = s * strip
                        left = H - (y0 + r0)
                        live = (x < W) & (left > 0)
                        acc = torch.zeros((threads, strip), dtype=img.dtype)
                        step = torch.zeros((threads, strip), dtype=torch.int64)
                        for k in range(strip + kh - 1):
                            for dx in range(kw):
                                v = win[r0 + k, pad - pw + col + dx]
                                for j in range(strip):
                                    dy = k - j
                                    if 0 <= dy < kh:
                                        assert (step[live, j] == dy * kw + dx).all()
                                        acc[:, j] += masks[m, dy, dx] * v
                                        step[:, j] += 1
                        for j in range(strip):
                            keep = live & (j < left)
                            assert (step[keep, j] == kh * kw).all()
                            yy, xx = y0 + r0[keep] + j, x[keep]
                            out[n, m, yy, xx] = acc[keep, j]
                            stores[n, m].index_put_(
                                (yy, xx), torch.ones_like(yy), accumulate=True)
    return out, stores


@pytest.mark.parametrize("shape,mshape,dtype", [
    ((1, 21, 19), (3, 7, 7), F32),     # a frame narrower than a tile
    ((3, 45, 70), (2, 3, 3), I32),
    ((3, 37, 52), (1, 5, 5), F32),
    ((2, 23, 150), (2, 4, 6), I8),     # the generic instance, two tiles wide
    ((1, 40, 256), (1, 5, 5), F16),    # rows by 16-byte copies
])
def test_strip_schedule_covers_each_output_once_in_tap_order(
        rng, shape, mshape, dtype):
    """Every output is stored exactly once, its chain has every tap in the
    reference's order, and the outputs are the JAX oracle's (float: within
    1e-4, the oracle sums in another order; integer: exact)."""
    if dtype.is_floating_point:
        img = rng.normal(size=shape)
        m = rng.normal(size=mshape)
        work = torch.float64
    else:
        img = rng.integers(-128 if dtype == I8 else 0, 127, shape)
        m = rng.integers(-16, 16, mshape)
        work = torch.int64
    out, stores = _kernel_model(torch.from_numpy(img).to(work),
                                torch.from_numpy(m).to(work), dtype)
    assert (stores == 1).all()
    jdt = np.float32 if dtype.is_floating_point else np.int32
    want = np.asarray(jref.conv2d_gemm(jnp.asarray(img.astype(jdt)),
                                       jnp.asarray(m.astype(jdt))))
    if dtype.is_floating_point:
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(out.numpy(), want)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card, to reach the wrapper's
    later refusals without one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("image,masks,error,match", [
    # the CPU tensor is refused first, whatever else is wrong
    (np.zeros((2, 2, 4, 4), np.float64), np.ones((3, 3)), ValueError, "CUDA"),
    (np.zeros((4, 4), np.float32), np.ones((1, 3, 3)), ValueError, "CUDA"),
    (np.zeros((4, 4), np.float64), np.ones((1, 3, 3)), TypeError,
     "unsupported image dtype"),
    (np.zeros((2, 2, 4, 4), np.float64), np.ones((1, 3, 3)), TypeError,
     "unsupported image dtype"),
    (np.zeros((2, 2, 4, 4), np.float32), np.ones((1, 3, 3)), ValueError,
     "contiguous"),
    ("transposed", np.ones((1, 3, 3)), ValueError, "contiguous"),
    (np.zeros((4, 4), np.int8), np.ones((3, 3)), ValueError,
     r"masks must be \(M, kh, kw\)"),
    (np.zeros((4, 4), np.int8), np.ones((1, 16, 3)), ValueError, "exceed"),
    (np.zeros((4, 4), np.float16), np.ones((5, 15, 15)), ValueError,
     "1024 taps"),
])
def test_conv_wrapper_refuses_before_touching_the_card(
        monkeypatch, image, masks, error, match):
    """The wrapper's refusals, in their order, and none of them loads the
    kernel's library."""
    def no_card():
        pytest.fail("the conv library was loaded")

    monkeypatch.setattr(conv_mod, "_lib", no_card)
    libs = dict(_build._libs)
    m = torch.from_numpy(np.asarray(masks))
    if isinstance(image, str):
        x = torch.zeros((1, 5, 4)).transpose(1, 2).as_subclass(_OnCard)
    else:
        x = torch.from_numpy(image)
        if match != "CUDA":
            x = x.as_subclass(_OnCard)
    with pytest.raises(error, match=match):
        conv_mod.conv2d_gemm(x, m)
    assert _build._libs == libs
