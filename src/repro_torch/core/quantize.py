"""Float -> integer rewrites, paper Section 4.4 (``repro/core/quantize.py``).

The same machinery serves three places in the port:

  * the low-precision gradient tier of the detector
    (``CannyConfig(grad_dtype="int8")`` -> :func:`quantize_frames`);
  * int8 GEMM operands for the matmul kernel (:func:`quantized_matmul`,
    int8 x int8 -> int32 through ``ops.tiled_matmul``);
  * weight-only int8 serving (:func:`quantize_weights_int8`).

Every function follows the reference's operation order, so the port's
integers and scales equal the JAX package's bit for bit on the CPU, and
the card's equal the CPU's: ``scale = max(amax, 1e-12) / qmax``, then
``round(x / scale)`` half to even, clip, cast.  A division by a constant
divides by a tensor on the operand's device (:func:`_div`), because a CUDA
tensor divided by a Python number is multiplied by the number's
reciprocal instead, two roundings where the CPU makes one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import tree_map

_INT = {8: torch.int8, 16: torch.int16, 32: torch.int32}
_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)


class Quantized(NamedTuple):
    values: torch.Tensor   # int8 (or int16/int32 for wider modes)
    scale: torch.Tensor    # f32 scalar (per tensor) or keepdims (per axis)


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` rounded once on either device (see the module note)."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def quantize(x: torch.Tensor, *, bits: int = 8, axis=None) -> Quantized:
    """Symmetric linear quantization; ``axis=None`` is one scale for the
    tensor, an int or tuple of ints one scale per slice (keepdims, so it
    broadcasts back).  The cast saturates as XLA's does: at 32 bits the
    clip bound ``qmax`` rounds up to 2^31 in f32, which torch's own cast
    would wrap to -2^31."""
    qmax = 2 ** (bits - 1) - 1
    dtype = _INT[bits]
    amax = (x.abs().amax() if axis is None
            else x.abs().amax(dim=axis, keepdim=True))
    scale = _div(amax.clamp_min(1e-12), qmax)
    q = torch.round(x / scale).clamp(-qmax - 1, qmax)
    if bits == 32:
        q = q.to(torch.int64).clamp_(-qmax - 1, qmax)
    return Quantized(q.to(dtype), scale.to(torch.float32))


def dequantize(q: Quantized) -> torch.Tensor:
    return q.values.to(torch.float32) * q.scale


def quantize_frames(images: torch.Tensor, *, bits: int = 8) -> Quantized:
    """Per-frame symmetric quantization of an ``(..., H, W)`` frame stack.

    One scale per frame (kept as (..., 1, 1) so it broadcasts back over the
    frame): a dark frame batched with a bright one keeps its own range.
    """
    return quantize(images.to(torch.float32), bits=bits, axis=(-2, -1))


def quantize_weights_int8(params, *, compute_dtype=torch.bfloat16):
    """Weight-only int8 quantization of a parameter tree (serving).

    Every floating leaf becomes int8 values and an f32 scale per output
    column: the reduction runs over every axis but the last, so a stacked
    (L, D, F) leaf has one scale per column shared by its L layers, as the
    reference's ``tuple(range(ndim - 1))`` gives; a 1-D leaf has one scale.
    Integer leaves pass through with scale ``ones(())``.  Returns
    ``({"q": int8 tree, "s": scale tree}, dequant)``, where
    ``dequant(q, s)`` gives compute-dtype weights back.
    """
    def q_leaf(p):
        if not p.is_floating_point():
            return p, torch.ones((), dtype=torch.float32, device=p.device)
        axis = tuple(range(p.ndim - 1)) if p.ndim > 1 else None
        qq = quantize(p.to(torch.float32), axis=axis)
        return qq.values, qq.scale

    pairs = tree_map(q_leaf, params)     # a (values, scale) tuple a leaf
    q_tree = tree_map(lambda t: t[0], pairs)
    s_tree = tree_map(lambda t: t[1], pairs)

    def dequant(qtree, stree):
        def d_leaf(q, s):
            # as the reference: every signed-integer leaf, a passed-through
            # one too, comes back as compute_dtype
            if q.dtype not in _SIGNED:
                return q
            return (q.to(torch.float32) * s).to(compute_dtype)
        return tree_map(d_leaf, qtree, stree)

    return {"q": q_tree, "s": s_tree}, dequant


def quantized_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32 ``x @ y`` through the int8 path (Gemmini-style): both operands
    quantized per tensor, an int8 GEMM with int32 accumulation (the matmul
    kernel on the card), then ``acc * (sx * sy)``."""
    qx, qy = quantize(x), quantize(y)
    acc = ops.tiled_matmul(qx.values, qy.values)
    return acc.to(torch.float32) * (qx.scale * qy.scale)
