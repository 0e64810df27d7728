"""The vote kernel's wrapper (``csrc/hough_vote.cu``), edge compaction, and
the plain vote.

Replaces the TPU kernel ``repro/kernels/hough_vote.py::hough_vote`` and its
``compact_edges`` pre-pass.  Compaction was jnp outside any ``pallas_call``
in the reference, so here it is torch ops that run on either device; it
also returns each frame's edge count as a device tensor, which the vote
kernel reads to skip the empty rows of the buffer without a host sync.
``plain`` is the vote from ``ref.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import hough_vote as plain  # noqa: F401  (the kernel's plain version)

#: Launches of the kernel since the last reset (``ops.reset_launch_counts``).
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("hough_vote")
    lib.hough_vote_f32.argtypes = [_P, _L, _P, _L, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _P]
    lib.hough_vote_f32.restype = _I
    return lib


def compact_edges(xy: torch.Tensor, weights: torch.Tensor, *,
                  max_edges: int):
    """Compact edge pixels (weight > 0) to the front of a static buffer.

    ``xy`` is (P, C) shared or (N, P, C) per frame; ``weights`` (P,) or
    (N, P).  Returns ``(cxy, cw, counts)``: (..., max_edges, C) and
    (..., max_edges) in raster order with zero rows past the edge count,
    and the per-frame count of rows kept, int32 on the weights' device.
    Edges beyond ``max_edges`` are dropped: their scatter lands in a spare
    row ``max_edges`` that is sliced off (the reference's ``mode="drop"``).
    """
    squeeze = weights.ndim == 1
    w = weights[None] if squeeze else weights
    N, P = w.shape
    C = xy.shape[-1]
    xyb = xy.expand(N, P, C) if xy.ndim == 2 else xy
    mask = w > 0
    pos = torch.cumsum(mask, dim=-1) - 1
    pos = torch.where(mask & (pos < max_edges), pos, max_edges)
    cw = torch.zeros((N, max_edges + 1), dtype=w.dtype, device=w.device)
    cw.scatter_(1, pos, w)
    cxy = torch.zeros((N, max_edges + 1, C), dtype=xy.dtype, device=w.device)
    cxy.scatter_(1, pos[..., None].expand(N, P, C), xyb)
    counts = mask.sum(dim=-1, dtype=torch.int32).clamp_(max=max_edges)
    cxy, cw = cxy[:, :max_edges], cw[:, :max_edges]
    if squeeze:
        return cxy[0], cw[0], counts[0]
    return cxy, cw, counts


def _rows(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32 or t.stride(-1) != 1:
        raise ValueError(f"vote kernel: {name} must be f32 with contiguous "
                         f"rows, got {t.dtype} strides {t.stride()}")


def hough_vote(xy: torch.Tensor, weights: torch.Tensor, trig: torch.Tensor,
               *, n_rho: int, counts: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Launch the vote kernel: (n_rho, T) or (N, n_rho, T) f32 votes.

    ``xy`` (P, C) shared or (N, P, C) per frame, C in {2, 3}; ``weights``
    (P,) or (N, P); ``trig`` (C, T); all f32 CUDA tensors with contiguous
    rows (frames may be strided, as compaction's slices are).  ``counts``
    (N,) int32 limits each frame to its first rows.  Raises on anything
    else.
    """
    global launches
    if not weights.is_cuda:
        raise ValueError("the vote kernel takes CUDA tensors; the CPU uses "
                         "kernels.ref.hough_vote")
    squeeze = weights.ndim == 1
    w = weights[None] if squeeze else weights
    if squeeze:
        if xy.ndim == 3:
            xy = xy[0]
        if counts is not None:
            counts = counts.reshape(1)
    N, P = w.shape
    C = xy.shape[-1]
    T = trig.shape[-1]
    if xy.shape[-2] != P or C not in (2, 3) or trig.shape != (C, T):
        raise ValueError(f"vote kernel: shapes xy {tuple(xy.shape)}, weights "
                         f"{tuple(weights.shape)}, trig {tuple(trig.shape)}")
    if xy.ndim == 3 and xy.shape[0] != N:
        raise ValueError("vote kernel: per-frame xy needs one frame per "
                         "weight row")
    for t in (xy, trig, counts):
        if t is not None and t.device != weights.device:
            raise ValueError("vote kernel: all operands on one card")
    _rows(xy, "xy")
    _rows(w, "weights")
    if xy.stride(-2) != C or not trig.is_contiguous() or trig.dtype != torch.float32:
        raise ValueError("vote kernel: xy rows must be packed and trig a "
                         "contiguous f32 (C, T)")
    if counts is not None and (counts.dtype != torch.int32
                               or counts.shape != (N,)
                               or not counts.is_contiguous()):
        raise ValueError("vote kernel: counts must be contiguous int32 (N,)")
    out = torch.zeros((N, n_rho, T), dtype=torch.float32, device=w.device)
    if N and P and T:
        lib = _lib()
        rc = lib.hough_vote_f32(
            xy.data_ptr(), xy.stride(0) if xy.ndim == 3 else 0,
            w.data_ptr(), w.stride(0),
            None if counts is None else counts.data_ptr(),
            trig.data_ptr(), out.data_ptr(), N, P, C, T, n_rho,
            torch.cuda.current_stream(w.device).cuda_stream,
        )
        _build.check(lib, rc, "hough_vote kernel launch")
        launches += 1
    return out[0] if squeeze else out
