"""Canny edge detection with conv stages on the card (``repro/core/canny.py``).

The stencil stages (5x5 Gauss, then the Sobel pair, or the fused 7x7 set)
go through ``kernels.ops.conv2d_gemm``: the hand conv kernel for a CUDA
tensor, its plain version for a CPU tensor.  The control-heavy stages
(magnitude, direction, non-max suppression, hysteresis) are element-wise
torch ops on whichever device holds the frame.

Variants and arithmetic modes match the reference: ``paper`` (Algorithm 1,
one hysteresis pass) or ``full`` (direction-aware NMS, iterative
hysteresis); float or the paper's integer rewrite; the ``fused`` 7x7 masks;
and the f32 / f16 / int8 gradient tiers.  Every stage takes ``(..., H, W)``,
so a batch flows through as one conv launch per stage.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# The classic integer-friendly 5x5 Gaussian (sums to 159) and Sobel masks.
GAUSS_5x5 = np.array(
    [
        [2, 4, 5, 4, 2],
        [4, 9, 12, 9, 4],
        [5, 12, 15, 12, 5],
        [4, 9, 12, 9, 4],
        [2, 4, 5, 4, 2],
    ],
    np.float32,
)
GAUSS_NORM = 159.0
SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y = SOBEL_X.T.copy()

# tan(22.5 deg) and tan(67.5 deg) as integer ratios (the paper's int
# rewrite: direction tests become cross-multiplications, no arctan).
TAN_22_NUM, TAN_22_DEN = 53, 128
TAN_67_NUM, TAN_67_DEN = 309, 128


def _pad_to(mask: np.ndarray, k: int) -> np.ndarray:
    p = (k - mask.shape[0]) // 2
    return np.pad(mask, ((p, p), (p, p)))


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Full 2-D convolution of two masks ((a*b)*img == a*(b*img))."""
    ka, kb = a.shape[0], b.shape[0]
    out = np.zeros((ka + kb - 1, ka + kb - 1), np.float32)
    for i in range(ka):
        for j in range(ka):
            out[i : i + kb, j : j + kb] += a[i, j] * b
    return out


@functools.cache
def fused_masks() -> np.ndarray:
    """(3, 7, 7): [gauss(padded), gauss(*)sobel_x, gauss(*)sobel_y]."""
    g = GAUSS_5x5 / GAUSS_NORM
    return np.stack(
        [_pad_to(g, 7), _compose(g, SOBEL_X), _compose(g, SOBEL_Y)]
    ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class CannyConfig:
    low: float = 40.0          # weak-edge threshold (on 0..255 magnitudes)
    high: float = 90.0         # strong-edge threshold
    variant: str = "full"      # "full" | "paper"
    integer: bool = False      # paper Section 4.4 float->int rewrite
    fused: bool = False        # single-pass 7x7 masks
    hysteresis_iters: int = 8
    border: int = 4            # suppress zero-padding artifacts at the rim
    # None: the conv kernel (plain version on the CPU); "stencil": the
    # paper's no-accelerator baseline, on whichever device holds the frame.
    impl: str | None = None
    grad_dtype: str = "f32"    # "f32" | "f16" | "int8"

    def __post_init__(self):
        if self.impl not in (None, "stencil"):
            raise ValueError(
                f"CannyConfig.impl must be None or 'stencil', got {self.impl!r}"
            )


@functools.cache
def gradient_masks(cfg: CannyConfig) -> tuple[np.ndarray, ...]:
    """The conv-mask constants ``_gradients`` needs for ``cfg``, in order."""
    if cfg.integer or cfg.grad_dtype == "int8":
        if cfg.fused:
            return (np.round(fused_masks() * GAUSS_NORM).astype(np.int32),)
        return (
            GAUSS_5x5.astype(np.int32)[None],
            np.stack([SOBEL_X, SOBEL_Y]).astype(np.int32),
        )
    dt = np.float16 if cfg.grad_dtype == "f16" else np.float32
    if cfg.fused:
        return (fused_masks().astype(dt),)
    return (
        (GAUSS_5x5 / GAUSS_NORM)[None].astype(dt),
        np.stack([SOBEL_X, SOBEL_Y]).astype(dt),
    )


@functools.cache
def device_masks(cfg: CannyConfig, device: torch.device
                 ) -> tuple[torch.Tensor, ...]:
    """``gradient_masks(cfg)`` as tensors on ``device``, uploaded once, so
    a warm detector copies nothing from the host."""
    return tuple(torch.from_numpy(m).to(device) for m in gradient_masks(cfg))


def _conv(image: torch.Tensor, masks: torch.Tensor, cfg: CannyConfig):
    image = image.contiguous()
    if cfg.impl == "stencil":
        return ops.conv2d_stencil(image, masks)
    return ops.conv2d_gemm(image, masks)


def _gradients(image: torch.Tensor, cfg: CannyConfig):
    """Stages 1-2: noise reduction + intensity gradient.

    ``gx``/``gy`` come back as f32 (int32 for the integer rewrite) whatever
    the accumulation tier, so the threshold compare is full precision.
    """
    if cfg.grad_dtype not in ("f32", "f16", "int8"):
        raise ValueError(f"unknown grad_dtype {cfg.grad_dtype!r}")
    if cfg.integer and cfg.grad_dtype != "f32":
        raise ValueError(
            "grad_dtype tiers apply to the float pipeline; the integer "
            "rewrite (integer=True) is its own arithmetic mode"
        )
    masks = device_masks(cfg, image.device)
    norm = int(GAUSS_NORM)

    if cfg.integer:
        img = image.to(torch.int32)
        if cfg.fused:
            out = _conv(img, masks[0], cfg)
            # torch's // floors like jnp's (C's / would truncate negatives)
            return (out[..., 0, :, :] // norm, out[..., 1, :, :] // norm,
                    out[..., 2, :, :] // norm)
        nr = _conv(img, masks[0], cfg)[..., 0, :, :] // norm
        gxy = _conv(nr, masks[1], cfg)
        return nr, gxy[..., 0, :, :], gxy[..., 1, :, :]

    if cfg.grad_dtype == "int8":
        from .quantize import quantize_frames

        q = quantize_frames(image)
        if cfg.fused:
            out = _conv(q.values, masks[0], cfg)
            s = q.scale / GAUSS_NORM
            return tuple(
                out[..., k, :, :].to(torch.float32) * s for k in range(3)
            )
        nr_q = _conv(q.values, masks[0], cfg)[..., 0, :, :]
        nr = nr_q.to(torch.float32) * (q.scale / GAUSS_NORM)
        q2 = quantize_frames(nr)
        gxy = _conv(q2.values, masks[1], cfg)
        return (nr, gxy[..., 0, :, :].to(torch.float32) * q2.scale,
                gxy[..., 1, :, :].to(torch.float32) * q2.scale)

    if cfg.grad_dtype == "f16":
        img = image.to(torch.float16)
        if cfg.fused:
            out = _conv(img, masks[0], cfg)
            return tuple(out[..., k, :, :].to(torch.float32) for k in range(3))
        nr16 = _conv(img, masks[0], cfg)[..., 0, :, :]
        gxy = _conv(nr16, masks[1], cfg)
        return (nr16.to(torch.float32), gxy[..., 0, :, :].to(torch.float32),
                gxy[..., 1, :, :].to(torch.float32))

    img = image.to(torch.float32)
    if cfg.fused:
        out = _conv(img, masks[0], cfg)
        return out[..., 0, :, :], out[..., 1, :, :], out[..., 2, :, :]
    nr = _conv(img, masks[0], cfg)[..., 0, :, :]
    gxy = _conv(nr, masks[1], cfg)
    return nr, gxy[..., 0, :, :], gxy[..., 1, :, :]


def _magnitude_direction(gx, gy, integer: bool):
    """Stage 2b: |G| and the direction bin in {0, 45, 90, 135}.

    The float form keeps IEEE ``/`` and ``sqrt`` (no fast math): a bin at
    a tan threshold would flip otherwise.
    """
    ax, ay = gx.abs(), gy.abs()
    if integer:
        mag = ax + ay  # L1 magnitude: no sqrt in the int pipeline
        d0 = TAN_22_DEN * ay < TAN_22_NUM * ax
        d90 = TAN_67_DEN * ay >= TAN_67_NUM * ax
    else:
        mag = torch.sqrt(gx * gx + gy * gy)
        t = ay / ax.clamp_min(1e-9)
        d0 = t < (TAN_22_NUM / TAN_22_DEN)
        d90 = t >= (TAN_67_NUM / TAN_67_DEN)
    diag = ~(d0 | d90)
    same_sign = (gx >= 0) == (gy >= 0)
    # bins: 0 => E-W neighbour pair, 1 => NE-SW, 2 => N-S, 3 => NW-SE
    dirs = torch.where(
        d0, 0, torch.where(d90, 2, torch.where(same_sign & diag, 1, 3))
    ).to(torch.int32)
    return mag, dirs


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Zero-padded spatial shift over the trailing (H, W) axes."""
    H, W = x.shape[-2:]
    pad = F.pad(x, (1, 1, 1, 1))
    return pad[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]


def _nms(mag: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Direction-aware non-max suppression (full variant, stage 3)."""
    pairs = [((0, 1), (0, -1)), ((-1, 1), (1, -1)),
             ((1, 0), (-1, 0)), ((1, 1), (-1, -1))]
    keep = torch.zeros_like(mag, dtype=torch.bool)
    for b, (p, q) in enumerate(pairs):
        keep = keep | ((dirs == b) & (mag >= _shift(mag, *p))
                       & (mag >= _shift(mag, *q)))
    return torch.where(keep, mag, torch.zeros_like(mag))


def _dilate3(x: torch.Tensor) -> torch.Tensor:
    # F.pad takes no bool: shift as uint8, OR as bool
    x8 = x.to(torch.uint8)
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = out | _shift(x8, dy, dx).bool()
    return out


def _clear_border(x: torch.Tensor, b: int) -> torch.Tensor:
    if b <= 0:
        return x
    H, W = x.shape[-2:]
    yy = torch.arange(H, device=x.device)[:, None]
    xx = torch.arange(W, device=x.device)[None, :]
    inside = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    return torch.where(inside, x, torch.zeros_like(x))


def canny(image: torch.Tensor, cfg: CannyConfig = CannyConfig()
          ) -> torch.Tensor:
    """Edge map (..., H, W) uint8 in {0, 255} (the paper's ``image_out``)."""
    _, gx, gy = _gradients(image, cfg)
    mag, dirs = _magnitude_direction(gx, gy, cfg.integer)
    mag = _clear_border(mag, cfg.border)

    if cfg.variant == "paper":
        # Algorithm 1 stages 3-5: pure thresholds, one hysteresis pass.
        edge = mag >= cfg.low
        strong = edge & (mag >= cfg.high)
        out = strong | (edge & _dilate3(strong))
    else:
        sup = _nms(mag, dirs)
        strong = sup >= cfg.high
        weak = (sup >= cfg.low) & ~strong
        for _ in range(cfg.hysteresis_iters):
            strong = strong | (weak & _dilate3(strong))
        out = strong
    return out.to(torch.uint8) * 255


def estimate_edge_count_device(image: torch.Tensor,
                               cfg: CannyConfig = CannyConfig(), *,
                               stride: int = 2, margin: float = 2.5,
                               corridors: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Downsampled-gradient upper bound on the Canny edge count (int32
    scalar on the frame's device; a batch gives its max frame)."""
    # low/2, floored at 20: weaker contrast never survives the double
    # threshold, and 20 sits well above asphalt-texture differences.
    thresh = max(cfg.low / 2.0, 20.0)
    hits = ops.grad_hits(image, stride=stride, thresh=thresh,
                         corridors=corridors, widen=2.0 * stride)
    worst = hits.max().to(torch.float32)
    return torch.floor(worst * stride * margin).to(torch.int32) + 64


def estimate_edge_count(image: torch.Tensor, cfg: CannyConfig = CannyConfig(),
                        *, stride: int = 2, margin: float = 2.5) -> int:
    """Host readback of :func:`estimate_edge_count_device` (one sync)."""
    return int(estimate_edge_count_device(image, cfg, stride=stride,
                                          margin=margin))
