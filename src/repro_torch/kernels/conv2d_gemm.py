"""The conv kernel's wrapper (``csrc/conv2d.cu``) and its plain version.

Replaces the TPU kernel ``repro/kernels/conv2d_gemm.py::conv2d_gemm``.  The
card form is a direct stencil with a shared-memory halo tile; the source
note in ``csrc/conv2d.cu`` says why and what bounds it.  ``plain`` is the
im2col + einsum version from ``ref.py``, which the CPU runs and the card
uses only to check the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import conv2d_gemm as plain  # noqa: F401  (the kernel's plain version)
from .tiles import acc_dtype

#: Launches of the kernel since the last reset (``ops.reset_launch_counts``).
launches = 0

MAX_K = 15          # largest mask side the shared halo tile is sized for
MAX_MASK_TAPS = 1024

_ENTRY = {
    torch.float32: "conv2d_f32",
    torch.float16: "conv2d_f16",
    torch.int32: "conv2d_i32",
    torch.int8: "conv2d_i8",
}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv2d")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def conv2d_gemm(image: torch.Tensor, masks: torch.Tensor, *,
                out_dtype=None) -> torch.Tensor:
    """Launch the conv kernel: (N, H, W) or (H, W) -> (N, M, H, W) / (M, H, W).

    ``image`` is a contiguous CUDA tensor of f32, f16, int32 or int8;
    ``masks`` (M, kh, kw) lies on the same card and is cast to the
    accumulator type (``tiles.acc_dtype``).  Raises on anything else.
    """
    global launches
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
    N, H, W = img.shape
    acc = acc_dtype(image.dtype)
    m = masks.to(acc).contiguous()
    out = torch.empty((N, n_masks, H, W), dtype=acc, device=image.device)
    if out.numel():
        lib = _lib()
        rc = getattr(lib, _ENTRY[image.dtype])(
            img.data_ptr(), m.data_ptr(), out.data_ptr(), N, H, W, n_masks,
            kh, kw, torch.cuda.current_stream(image.device).cuda_stream,
        )
        _build.check(lib, rc, "conv2d kernel launch")
        launches += 1
    if out_dtype is None:
        out_dtype = acc if acc == torch.int32 else image.dtype
    out = out.to(out_dtype)
    return out[0] if squeeze else out
