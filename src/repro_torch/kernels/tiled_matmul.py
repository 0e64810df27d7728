"""The matmul kernel's wrapper (``csrc/tiled_matmul.cu``) and its plain
version.

Replaces the TPU kernel ``repro/kernels/tiled_matmul.py::tiled_matmul``,
the paper's Gemmini ``tiled_matmul_auto``: int8 x int8 accumulated exactly
in int32 (the float -> int rewrite's GEMM, under
``core.quantize.quantized_matmul``), and f32 / bf16 / f16 accumulated in
f32.  int8 runs on the tensor cores (``mma.sync`` m16n8k32, cp.async
tiles) in one of two forms that the C entry picks by M (:func:`plan`):
a 128x128 tile a block for M > 16, and for M <= 16 (a decode step) a
16-row strip a block with K split into slices whose int32 partials are
added into a zeroed output.  bf16 and f16 run on the tensor cores too
(``wgmma`` m64n64k16 from 128-byte-swizzled shared memory, a 128x128 tile
a block), each k16 product's f32 sum (``F16_CHAIN_K``) added into a
running f32 sum with compensation; f32 runs on the FMA pipe, one block per 64x64
tile.  The source note in ``csrc/tiled_matmul.cu`` says why and
what bounds each.  ``plain`` is ``ref.tiled_matmul``, which the CPU runs
and the card uses only to check the kernel.  The reference's tile knobs
(``bm``, ``bn``, ``bk``) have no counterpart: the tile is the kernel's
own.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .ref import tiled_matmul as plain  # noqa: F401  (the kernel's plain version)

#: Launches of the kernel since the last reset (``ops.reset_launch_counts``).
launches = 0

# the C entry's type codes
_IN = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
_OUT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 4}
_P, _I = ctypes.c_void_p, ctypes.c_int

# the int8 forms' constants (csrc/tiled_matmul.cu, namespace i8)
DECODE_ROWS = 16        # M up to this takes the decode form
_BN, _BK = 128, 64      # output columns a block; k bytes a pipeline stage
_DECODE_BLOCKS = 528    # the decode grid's target: 4 blocks x 132 SMs

# the bf16 / f16 form's constants (csrc/tiled_matmul.cu, namespace wg)
F16_TILE = (128, 128)   # output rows and columns a block
F16_CHAIN_K = 16        # k a tensor-core chain sums before its compensated add


class Plan(NamedTuple):
    """The int8 launch for (M, N, K): ``form`` "tile" or "decode", and the
    K slices ``[s * k_slice, min((s + 1) * k_slice, K))`` for s < ``slices``
    that the blocks of one column strip share."""
    form: str
    k_slice: int
    slices: int


def plan(M: int, N: int, K: int) -> Plan:
    """The int8 kernel's form and K split, the rule of the C entry's
    ``i8::plan`` (held to it on the card): M > 16 takes the tile form over
    all of K; M <= 16 the decode form, with slices of a multiple of 64 that
    bring (column strips x slices) to about 528 blocks."""
    if M > DECODE_ROWS:
        return Plan("tile", K, 1)
    strips = max(1, -(-N // _BN))
    steps = -(-K // _BK)
    want = max(1, min(steps, -(-_DECODE_BLOCKS // strips)))
    k_slice = max(1, -(-steps // want)) * _BK
    return Plan("decode", k_slice, max(1, -(-K // k_slice)))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("tiled_matmul")
    lib.tiled_matmul.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.tiled_matmul.restype = _I
    for name in ("tiled_matmul_i8_attributes", "tiled_matmul_f16_attributes"):
        getattr(lib, name).argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        getattr(lib, name).restype = _I
    return lib


def int8_kernel_attributes(M: int, N: int, K: int) -> dict:
    """The int8 launch the C entry makes for (M, N, K), as it reports it:
    its form and K split, blocks, threads, registers a thread, dynamic
    shared memory a block and the blocks one SM holds (the CUDA occupancy
    query).  Needs the card; launches nothing."""
    lib = _lib()
    info = (_I * 8)()
    _build.check(lib, lib.tiled_matmul_i8_attributes(M, N, K, info),
                 "tiled_matmul attribute query")
    form, k_slice, slices, blocks, threads, regs, smem, per_sm = info
    return {"form": ("tile", "decode")[form], "k_slice": k_slice,
            "slices": slices, "grid_blocks": blocks,
            "threads_per_block": threads, "registers_per_thread": regs,
            "smem_bytes_per_block": smem, "blocks_per_sm": per_sm}


def f16_kernel_attributes(M: int, N: int, K: int) -> dict:
    """The bf16 / f16 launch the C entry makes for (M, N, K), as it
    reports it: tile, chain k (``F16_CHAIN_K`` for every K), blocks,
    threads, registers a thread, dynamic shared memory a block and the
    blocks one SM holds.  Needs the card; launches nothing."""
    lib = _lib()
    info = (_I * 8)()
    _build.check(lib, lib.tiled_matmul_f16_attributes(M, N, K, info),
                 "tiled_matmul attribute query")
    bm, bn, chain, blocks, threads, regs, smem, per_sm = info
    return {"tile": [bm, bn], "chain_k": chain, "grid_blocks": blocks,
            "threads_per_block": threads, "registers_per_thread": regs,
            "smem_bytes_per_block": smem, "blocks_per_sm": per_sm}


def tiled_matmul(x: torch.Tensor, y: torch.Tensor, *, out_dtype=None
                 ) -> torch.Tensor:
    """Launch the kernel: ``x @ y`` for contiguous (M, K) and (K, N) CUDA
    tensors of one type.

    int8 operands give int32 (the only output they take), exact for
    K < 131072, on the tensor cores in the form :func:`plan` names (the
    decode form zeroes the output on the stream before its one kernel);
    f32, bf16 and f16 operands accumulate in f32 (bf16 and f16 on the
    tensor cores) and give ``out_dtype`` (default ``x.dtype``) in f32,
    bf16 or f16.  Raises on a CPU tensor, mixed or other types, and
    anything else it does not take.
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
