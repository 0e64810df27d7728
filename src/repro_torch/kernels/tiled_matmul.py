"""The matmul kernel's wrapper (``csrc/tiled_matmul.cu``) and its plain
version.

Replaces the TPU kernel ``repro/kernels/tiled_matmul.py::tiled_matmul``,
the paper's Gemmini ``tiled_matmul_auto``: int8 x int8 accumulated exactly
in int32 (the float -> int rewrite's GEMM, under
``core.quantize.quantized_matmul``), and f32 / bf16 / f16 accumulated in
f32.  The card form is one block per 64x64 output tile with K staged
through shared memory; the source note in ``csrc/tiled_matmul.cu`` says
why and what bounds it.  ``plain`` is ``ref.tiled_matmul``, which the CPU
runs and the card uses only to check the kernel.  The reference's tile
knobs (``bm``, ``bn``, ``bk``) have no counterpart: the tile is the
kernel's own.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import tiled_matmul as plain  # noqa: F401  (the kernel's plain version)

#: Launches of the kernel since the last reset (``ops.reset_launch_counts``).
launches = 0

# the C entry's type codes
_IN = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
_OUT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 4}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("tiled_matmul")
    lib.tiled_matmul.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.tiled_matmul.restype = _I
    return lib


def tiled_matmul(x: torch.Tensor, y: torch.Tensor, *, out_dtype=None
                 ) -> torch.Tensor:
    """Launch the kernel: ``x @ y`` for contiguous (M, K) and (K, N) CUDA
    tensors of one type.

    int8 operands give int32 (the only output they take), exact for
    K < 131072; f32, bf16 and f16 operands accumulate in f32 and give
    ``out_dtype`` (default ``x.dtype``) in f32, bf16 or f16.  Raises on a
    CPU tensor, mixed or other types, and anything else it does not take.
    """
    global launches
    if x.dtype != y.dtype or x.dtype not in _IN:
        raise TypeError(f"matmul kernel: operands must share one of "
                        f"{sorted(str(t) for t in _IN)}, got {x.dtype} and "
                        f"{y.dtype}")
    integer = x.dtype == torch.int8
    if out_dtype is None:
        out_dtype = torch.int32 if integer else x.dtype
    if (out_dtype == torch.int32) != integer or out_dtype not in _OUT:
        raise TypeError(f"matmul kernel: {x.dtype} operands do not give "
                        f"{out_dtype}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul kernel: needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul kernel: operands must be contiguous")
    if not (x.is_cuda and y.is_cuda) or x.device != y.device:
        raise ValueError("the matmul kernel takes two CUDA tensors on one "
                         "card; the CPU uses kernels.ref.tiled_matmul")
    (M, K), N = x.shape, y.shape[1]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError("matmul kernel: a dimension exceeds int32")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M and N:
        lib = _lib()
        rc = lib.tiled_matmul(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), _IN[x.dtype],
            _OUT[out_dtype], M, N, K,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, rc, "tiled_matmul kernel launch")
        launches += 1
    return out
