"""Shared sizing helpers for the kernels package (``repro/kernels/tiles.py``)."""

from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype rule shared by the conv kernel and its plain version.

    Integer inputs accumulate in int32 (the paper's integer pipeline); f16
    inputs accumulate in f16 (the low-precision gradient tier, where the
    whole point is cheap accumulation); everything else in f32.
    """
    if not dtype.is_floating_point and not dtype.is_complex and dtype != torch.bool:
        return torch.int32
    if dtype == torch.float16:
        return torch.float16
    return torch.float32


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return -(-x // m) * m


def cdiv(x: int, m: int) -> int:
    """Ceiling division (grid sizing: ``cdiv(dim, block)`` blocks)."""
    return -(-x // m)
