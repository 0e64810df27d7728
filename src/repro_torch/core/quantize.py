"""Float -> integer rewrite for the int8 gradient tier (``repro/core/quantize.py``).

Only the per-frame entry point the detector needs
(``CannyConfig(grad_dtype="int8")``) is ported here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Quantized(NamedTuple):
    values: torch.Tensor   # int8
    scale: torch.Tensor    # f32, one per frame, broadcastable over (H, W)


def quantize_frames(images: torch.Tensor, *, bits: int = 8) -> Quantized:
    """Per-frame symmetric quantization of an ``(..., H, W)`` frame stack.

    One scale per frame (kept as (..., 1, 1) so it broadcasts back over the
    frame): a dark frame batched with a bright one keeps its own range.
    Rounds half to even, as ``jnp.round`` does.
    """
    qmax = 2 ** (bits - 1) - 1
    x = images.to(torch.float32)
    amax = x.abs().amax(dim=(-2, -1), keepdim=True)
    scale = amax.clamp_min(1e-12) / qmax
    dtype = {8: torch.int8, 16: torch.int16, 32: torch.int32}[bits]
    q = torch.round(x / scale).clamp(-qmax - 1, qmax).to(dtype)
    return Quantized(q, scale)
