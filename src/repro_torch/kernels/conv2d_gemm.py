"""The conv kernel's wrapper (``csrc/conv2d.cu``) and its plain version.

Replaces the TPU kernel ``repro/kernels/conv2d_gemm.py::conv2d_gemm``.  The
card form is a direct stencil: a block stages its window by ``cp.async``
and each thread runs 8-row register strips, unrolled for square masks of
side 3, 5 and 7 and generic for any other shape (:func:`launch_plan`
mirrors the C entry's plan); the source note in ``csrc/conv2d.cu`` says
why and what bounds it.  ``plain`` is the im2col + einsum version from
``ref.py``, which the CPU runs and the card uses only to check the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import conv2d_gemm as plain  # noqa: F401  (the kernel's plain version)
from .tiles import acc_dtype, cdiv, round_up

#: Launches of the kernel since the last reset (``ops.reset_launch_counts``).
launches = 0

MAX_K = 15          # largest mask side the shared halo tile is sized for
MAX_MASK_TAPS = 1024
# The kernel's constants (TILE_H, TILE_W, THREADS, STRIP, MAX_HALO in the .cu)
TILE_H, TILE_W = 16, 128
THREADS = 128
STRIP = 8           # output rows a thread computes per strip
MAX_HALO = 7        # the generic instance's window pad: MAX_K // 2
UNROLLED = (3, 5, 7)  # square mask sides with an unrolled instance

_ENTRY = {
    torch.float32: "conv2d_f32",
    torch.float16: "conv2d_f16",
    torch.int32: "conv2d_i32",
    torch.int8: "conv2d_i8",
}
#: bytes of an input element and of an accumulator, by image dtype
_BYTES = {torch.float32: (4, 4), torch.float16: (2, 2), torch.int32: (4, 4),
          torch.int8: (1, 4)}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv2d")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    lib.conv2d_plan.argtypes = [_I] * 8 + [_P]
    lib.conv2d_plan.restype = None
    return lib


def instance(kh: int, kw: int) -> int:
    """The kernel instance a mask shape takes: its side where the masks are
    square with an unrolled instance, else 0 (the generic one)."""
    return kh if kh == kw and kh in UNROLLED else 0


def pad(k: int, in_bytes: int) -> int:
    """The window's pad on each side, in input elements: the instance's half
    side (``MAX_HALO`` for the generic one) rounded up to a 16-byte copy."""
    e = 16 // in_bytes
    return -(-(k // 2 if k else MAX_HALO) // e) * e


def launch_plan(dtype: torch.dtype, N: int, H: int, W: int, M: int, kh: int,
                kw: int) -> dict:
    """The C entry's launch plan of a call (``conv2d_plan`` in the .cu):
    the instance, the tile, the grid (one block a tile), the block's shared
    memory (the masks, 16-byte aligned, then ``TILE_H + kh - 1`` window
    rows of ``2 * pad + TILE_W`` input elements), and whether rows go by
    16-byte copies."""
    in_b, acc_b = _BYTES[dtype]
    k = instance(kh, kw)
    pitch = 2 * pad(k, in_b) + TILE_W
    return {
        "instance": k, "tile": (TILE_H, TILE_W), "threads": THREADS,
        "grid": (cdiv(W, TILE_W), cdiv(H, TILE_H), N),
        "smem_bytes": (round_up(acc_b * M * kh * kw, 16)
                       + in_b * (TILE_H + kh - 1) * pitch),
        "vector_rows": W * in_b % 16 == 0,
    }


def conv2d_gemm(image: torch.Tensor, masks: torch.Tensor, *,
                out_dtype=None) -> torch.Tensor:
    """Launch the conv kernel: (N, H, W) or (H, W) -> (N, M, H, W) / (M, H, W).

    ``image`` is a contiguous CUDA tensor of f32, f16, int32 or int8;
    ``masks`` (M, kh, kw) lies on the same card and is cast to the
    accumulator type (``tiles.acc_dtype``).  Raises on anything else.
    """
    if not image.is_cuda:
        raise ValueError("the conv kernel takes a CUDA tensor; the CPU uses "
                         "kernels.ref.conv2d_gemm")
    if image.dtype not in _ENTRY:
        raise TypeError(f"conv kernel: unsupported image dtype {image.dtype}")
    if image.ndim not in (2, 3) or not image.is_contiguous():
        raise ValueError(f"conv kernel: needs a contiguous (N, H, W) or "
                         f"(H, W) image, got shape {tuple(image.shape)}")
    if masks.ndim != 3 or masks.device != image.device:
        raise ValueError("conv kernel: masks must be (M, kh, kw) on the "
                         "image's device")
    n_masks, kh, kw = masks.shape
    if max(kh, kw) > MAX_K or n_masks * kh * kw > MAX_MASK_TAPS:
        raise ValueError(f"conv kernel: masks {tuple(masks.shape)} exceed "
                         f"{MAX_K}x{MAX_K} or {MAX_MASK_TAPS} taps")
    squeeze = image.ndim == 2
    img = image[None] if squeeze else image
    acc = acc_dtype(image.dtype)
    out = launch(img, masks.to(acc).contiguous(), instance(kh, kw))
    if out_dtype is None:
        out_dtype = acc if acc == torch.int32 else image.dtype
    out = out.to(out_dtype)
    return out[0] if squeeze else out


def launch(img: torch.Tensor, masks: torch.Tensor, k: int) -> torch.Tensor:
    """One launch of instance ``k`` (:func:`instance`, or 0: the generic
    instance, which takes any shape) on a checked (N, H, W) image and
    (M, kh, kw) masks in its accumulator type: the (N, M, H, W) output."""
    global launches
    N, H, W = img.shape
    n_masks, kh, kw = masks.shape
    out = torch.empty((N, n_masks, H, W), dtype=masks.dtype, device=img.device)
    if out.numel():
        lib = _lib()
        rc = getattr(lib, _ENTRY[img.dtype])(
            img.data_ptr(), masks.data_ptr(), out.data_ptr(), N, H, W,
            n_masks, kh, kw, k,
            torch.cuda.current_stream(img.device).cuda_stream,
        )
        _build.check(lib, rc, "conv2d kernel launch")
        launches += 1
    return out
