"""The fused detection kernel's wrapper (``csrc/fused_detect.cu``) and its
plain version.

Replaces the TPU kernel ``repro/kernels/fused_detect.py::fused_detect``
(kernel A of the fused hot path): frames in, the compacted and
corridor-filtered edge list out, with no edge map in device memory.  The
card form tiles the frame with a halo (128x32 output tiles) and compacts
in raster order across tiles in one look-back launch
(:func:`launch_plan`); a hysteresis whose tile window does not fit shared
memory runs its passes through two planes in device memory instead
(:func:`hysteresis_schedule`).  The source note in ``csrc/fused_detect.cu``
says why and what bounds it.  ``plain`` is ``ref.fused_detect``, which the
CPU runs and the card uses only to check the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import fused_detect as plain  # noqa: F401  (the kernel's plain version)

#: Launches of the kernel since the last reset (``ops.reset_launch_counts``).
launches = 0

SEG = 32            # pixels a keep word
TILE_W, TILE_H = 128, 32  # the tile kernel's output tile (TILE_W/TILE_H in the .cu)
MAX_SMEM = 232448   # shared memory one block may use on Hopper
HYST_HALO = 16      # the most passes one hysteresis launch runs (HYST_HALO in the .cu)
CHUNK_WORDS = 1024      # keep words a compaction chunk (4 a thread)
ZERO_ROWS = 2048        # rows a clearing block zeroes

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("fused_detect"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries' argument types on a loaded library of
    ``csrc/fused_detect.cu``."""
    lib.fused_detect.argtypes = [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P,
                                 _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                 _F, _F, _I, _I, _P]
    lib.fused_detect.restype = _I
    lib.fused_detect_smem_bytes.argtypes = [_I, _I, _I]
    lib.fused_detect_smem_bytes.restype = ctypes.c_size_t
    lib.fused_detect_plan.argtypes = [_I, _I, _I, _I, _I, _I, _I, _P]
    lib.fused_detect_plan.restype = None
    return lib


@functools.lru_cache(maxsize=64)
def _c_plan(iters: int, paper: bool, fused: bool, N: int, H: int, W: int,
            max_edges: int) -> tuple[int, ...]:
    """The C entry's launch plan of a call (``fused_detect_plan``): the
    nine numbers :func:`launch_plan` mirrors.  The wrapper sizes its
    scratch from it."""
    out = (ctypes.c_longlong * 9)()
    _lib().fused_detect_plan(iters, int(paper), int(fused), N, H, W,
                             max_edges, out)
    return tuple(out)


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def smem_bytes(iters: int, paper: bool, fused: bool) -> int:
    """Shared memory of one tile's block: the formula of ``smem_bytes`` in
    ``csrc/fused_detect.cu``, each window ``TILE + 2 r`` on a side: the
    image, the Gauss output (with the fused masks, the magnitude), the
    direction bytes; the magnitude and the bit planes reuse the first two
    once they are dead."""
    iters = max(iters, 0)
    r_s = 1 if paper else iters
    r_m = 1 if paper else iters + 1

    def area(r):
        return (TILE_H + 2 * r) * (TILE_W + 2 * r)

    return (_align16(4 * area(r_m + 3))
            + _align16(4 * area(r_m if fused else r_m + 1))
            + (0 if paper else _align16(area(r_m))))


def hysteresis_schedule(cfg) -> list[int]:
    """The passes of each hysteresis launch the kernel makes for a
    ``CannyConfig``: none where its tile's window fits shared memory
    (:func:`smem_bytes`, the C entry's rule; the passes then run inside
    the tile kernel), else ``hysteresis_iters`` in launches of at most 16
    passes through two planes in device memory."""
    iters = max(cfg.hysteresis_iters, 0)
    if smem_bytes(iters, cfg.variant == "paper", cfg.fused) <= MAX_SMEM:
        return []
    return [min(HYST_HALO, iters - d) for d in range(0, iters, HYST_HALO)]


def _chunks_a_frame(H: int, W: int) -> int:
    """The compaction's chunks of CHUNK_WORDS keep words in a frame."""
    return -(-(H * -(-W // SEG)) // CHUNK_WORDS)


def launch_plan(cfg, N: int, H: int, W: int, max_edges: int) -> dict:
    """The launches of one call for a ``CannyConfig`` on (N, H, W) frames,
    as ``fused_detect_plan`` in ``csrc/fused_detect.cu`` gives them: the
    tile, its shared memory (at 0 passes where the hysteresis goes through
    device memory), tile blocks a frame, hysteresis launches, the fewest
    passes that go through device memory (None for the paper variant, whose
    window does not grow), and the compaction's chunks a frame, blocks and
    flag words (a flag a chunk, then the ticket)."""
    paper, fused = cfg.variant == "paper", cfg.fused
    iters = max(cfg.hysteresis_iters, 0)
    schedule = hysteresis_schedule(cfg)
    first = None if paper else next(
        i for i in range(1000) if smem_bytes(i, False, fused) > MAX_SMEM)
    cpf = _chunks_a_frame(H, W)
    return {
        "tile": (TILE_H, TILE_W),
        "smem_bytes": smem_bytes(0 if schedule else iters, paper, fused),
        "tile_blocks_a_frame": -(-H // TILE_H) * -(-W // TILE_W),
        "hysteresis_launches": len(schedule),
        "planes_from_passes": first,
        "chunks_a_frame": cpf,
        "compact_blocks": N * cpf + N * -(-max_edges // ZERO_ROWS),
        "flag_words": N * cpf + 1,
    }


# the C entry's tier codes: f32, the integer rewrite, f16, int8
_TIERS = {"f32": 0, "f16": 2, "int8": 3}


def tier(cfg) -> int:
    """The kernel's arithmetic tier for a ``CannyConfig``; raises as
    ``core.canny`` does on a config no path takes."""
    if cfg.grad_dtype not in _TIERS:
        raise ValueError(f"unknown grad_dtype {cfg.grad_dtype!r}")
    if cfg.integer:
        if cfg.grad_dtype != "f32":
            raise ValueError(
                "grad_dtype tiers apply to the float pipeline; the integer "
                "rewrite (integer=True) is its own arithmetic mode")
        return 1
    return _TIERS[cfg.grad_dtype]


def check_config(cfg) -> None:
    """Raise on a ``CannyConfig`` no path takes, before any work on the
    card.  Every gradient tier (f32, f16, int8), the integer rewrite and
    any ``hysteresis_iters`` run: a hysteresis whose tile does not fit
    shared memory goes through device memory (:func:`hysteresis_schedule`).
    """
    tier(cfg)


def fused_detect(image: torch.Tensor, corridors: torch.Tensor | None = None,
                 *, cfg, edge_threshold: float, max_edges: int):
    """Launch the kernel: (N, H, W) or (H, W) frames -> ``(cxy, cw, counts)``.

    ``cxy`` (..., max_edges, 3) f32 rows ``(x, y, 1)`` and ``cw``
    (..., max_edges) f32 weights in raster order, zero past each frame's
    count; ``counts`` (...) int32 the rows kept, ``min(edges, max_edges)``.
    ``corridors`` is an optional (C, 4) f32 tensor on the same card, shared
    by the batch.  Raises on a config the kernel does not take
    (:func:`check_config`), on a CPU tensor, and on anything else.  Scratch
    allocated here, as the C entry's plan sizes it: the keep words, the
    compaction's flags and ticket, and for a hysteresis that goes through
    device memory two (N, H, W) byte planes.
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
    from repro_torch.core.canny import gradient_masks  # function-level: cycle

    squeeze = image.ndim == 2
    img = (image[None] if squeeze else image).to(torch.float32).contiguous()
    N, H, W = img.shape
    # the masks in host memory: each launch takes them by value
    masks = gradient_masks(cfg)
    m1 = None if cfg.fused else masks[1].ctypes.data
    cor = None
    if corridors is not None:
        cor = corridors.to(torch.float32).contiguous()
    dev = image.device
    cxy = torch.empty((N, max_edges, 3), dtype=torch.float32, device=dev)
    cw = torch.empty((N, max_edges), dtype=torch.float32, device=dev)
    counts = torch.empty((N,), dtype=torch.int32, device=dev)
    if N and H and W:
        lib = _lib()
        paper = cfg.variant == "paper"
        plan = _c_plan(cfg.hysteresis_iters, paper, cfg.fused, N, H, W,
                       max_edges)
        bits = torch.empty((N, H, -(-W // SEG)), dtype=torch.int32,
                           device=dev)
        # the compaction's chunk flags and its ticket, cleared by the C entry
        flags = torch.empty((plan[8],), dtype=torch.int64, device=dev)
        code = tier(cfg)
        # the int8 tier's per-frame maxima (max|image|, max|Gauss conv|)
        maxima = (torch.empty((2, N), dtype=torch.int32, device=dev)
                  if code == _TIERS["int8"] else None)
        # the long-hysteresis path's two planes, only where it is taken
        planes = (torch.empty((2, N, H, W), dtype=torch.uint8, device=dev)
                  if plan[4] else None)
        rc = lib.fused_detect(
            img.data_ptr(), masks[0].ctypes.data, m1, code,
            int(cfg.fused), int(paper),
            None if cor is None else cor.data_ptr(),
            0 if cor is None else cor.shape[0],
            bits.data_ptr(), flags.data_ptr(),
            None if maxima is None else maxima[0].data_ptr(),
            None if maxima is None else maxima[1].data_ptr(),
            None if planes is None else planes[0].data_ptr(),
            None if planes is None else planes[1].data_ptr(), cxy.data_ptr(),
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
