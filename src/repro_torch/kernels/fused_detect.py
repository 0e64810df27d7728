"""The fused detection kernel's wrapper (``csrc/fused_detect.cu``) and its
plain version.

Replaces the TPU kernel ``repro/kernels/fused_detect.py::fused_detect``
(kernel A of the fused hot path): frames in, the compacted and
corridor-filtered edge list out, with no edge map in device memory.  The
card form tiles the frame with a halo and compacts in raster order across
tiles; the source note in ``csrc/fused_detect.cu`` says why and what bounds
it.  ``plain`` is ``ref.fused_detect``, which the CPU runs and the card uses
only to check the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import fused_detect as plain  # noqa: F401  (the kernel's plain version)

#: Launches of the kernel since the last reset (``ops.reset_launch_counts``).
launches = 0

TILE = 32
MAX_SMEM = 232448   # shared memory one block may use on Hopper

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_detect")
    lib.fused_detect.argtypes = [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P,
                                 _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I,
                                 _P]
    lib.fused_detect.restype = _I
    lib.fused_detect_smem_bytes.argtypes = [_I, _I, _I]
    lib.fused_detect_smem_bytes.restype = ctypes.c_size_t
    return lib


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def smem_bytes(iters: int, paper: bool, fused: bool) -> int:
    """Shared memory of one tile's block: the formula of ``smem_bytes`` in
    ``csrc/fused_detect.cu`` (masks, image, Gauss output, magnitude,
    direction, two strong/weak bit planes, each window ``32 + 2 r`` wide)."""
    iters = max(iters, 0)
    r_s = 1 if paper else iters
    r_m = 1 if paper else iters + 1
    sm, ss = TILE + 2 * r_m, TILE + 2 * r_s
    si, sn = TILE + 2 * (r_m + 3), TILE + 2 * (r_m + 1)
    b = _align16(4 * (3 * 49 if fused else 25 + 2 * 9)) + _align16(4 * si * si)
    if not fused:
        b += _align16(4 * sn * sn)
    b += _align16(4 * sm * sm)
    if not paper:
        b += _align16(sm * sm)
    return b + 2 * _align16(ss * ss)


def check_config(cfg) -> None:
    """Raise on a ``CannyConfig`` the kernel does not take, before any work
    on the card: the f16 and int8 gradient tiers, and a hysteresis halo
    whose tile does not fit shared memory.  The plain version covers them
    on the CPU."""
    if cfg.grad_dtype != "f32":
        raise NotImplementedError(
            f"the fused_detect kernel has no grad_dtype={cfg.grad_dtype!r} "
            "tier on the card (the int8 tier needs a frame-wide quantization "
            "scale before any tile starts); see ROADMAP.md")
    need = smem_bytes(cfg.hysteresis_iters, cfg.variant == "paper", cfg.fused)
    if need > MAX_SMEM:
        raise NotImplementedError(
            f"the fused_detect kernel's tile for hysteresis_iters="
            f"{cfg.hysteresis_iters} needs {need} bytes of shared memory, "
            f"more than the {MAX_SMEM} a block may use")


def fused_detect(image: torch.Tensor, corridors: torch.Tensor | None = None,
                 *, cfg, edge_threshold: float, max_edges: int):
    """Launch the kernel: (N, H, W) or (H, W) frames -> ``(cxy, cw, counts)``.

    ``cxy`` (..., max_edges, 3) f32 rows ``(x, y, 1)`` and ``cw``
    (..., max_edges) f32 weights in raster order, zero past each frame's
    count; ``counts`` (...) int32 the rows kept, ``min(edges, max_edges)``.
    ``corridors`` is an optional (C, 4) f32 tensor on the same card, shared
    by the batch.  Raises on a config the kernel does not take
    (:func:`check_config`), on a CPU tensor, and on anything else.
    """
    global launches
    check_config(cfg)
    if not image.is_cuda:
        raise ValueError("the fused_detect kernel takes a CUDA tensor; the "
                         "CPU uses kernels.ref.fused_detect")
    if image.ndim not in (2, 3):
        raise ValueError(f"fused_detect kernel: needs (N, H, W) or (H, W) "
                         f"frames, got shape {tuple(image.shape)}")
    if corridors is not None and (corridors.device != image.device
                                  or corridors.ndim != 2
                                  or corridors.shape[1] != 4
                                  or corridors.shape[0] == 0):
        raise ValueError("fused_detect kernel: corridors must be (C, 4), "
                         "C >= 1, on the frames' device")
    from repro_torch.core.canny import device_masks  # function-level: cycle

    squeeze = image.ndim == 2
    img = (image[None] if squeeze else image).to(torch.float32).contiguous()
    N, H, W = img.shape
    masks = device_masks(cfg, image.device)
    m1 = None if cfg.fused else masks[1].data_ptr()
    cor = None
    if corridors is not None:
        cor = corridors.to(torch.float32).contiguous()
    nseg = -(-W // TILE)
    dev = image.device
    bits = torch.empty((N, H, nseg), dtype=torch.int32, device=dev)
    offsets = torch.empty((N, H, nseg), dtype=torch.int32, device=dev)
    cxy = torch.empty((N, max_edges, 3), dtype=torch.float32, device=dev)
    cw = torch.empty((N, max_edges), dtype=torch.float32, device=dev)
    counts = torch.empty((N,), dtype=torch.int32, device=dev)
    if N and H and W:
        lib = _lib()
        rc = lib.fused_detect(
            img.data_ptr(), masks[0].data_ptr(), m1, int(cfg.integer),
            int(cfg.fused), int(cfg.variant == "paper"),
            None if cor is None else cor.data_ptr(),
            0 if cor is None else cor.shape[0],
            bits.data_ptr(), offsets.data_ptr(), cxy.data_ptr(),
            cw.data_ptr(), counts.data_ptr(), N, H, W, max_edges,
            cfg.low, cfg.high, edge_threshold, cfg.border,
            cfg.hysteresis_iters, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, rc, "fused_detect kernel launch")
        launches += 1
    else:
        cxy.zero_()
        cw.zero_()
        counts.zero_()
    if squeeze:
        return cxy[0], cw[0], counts[0]
    return cxy, cw, counts
