"""Public kernel entry points of the port, dispatched on the tensor's device.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand kernel (``csrc/``) or raises.  There is no switch and no
environment variable that sends a CUDA tensor to the plain version: the
only plain path the card runs on the detector's main path is the paper's
no-accelerator baseline, ``conv2d_stencil``, and only when a config names
it (``CannyConfig(impl="stencil")``).

Each kernel module keeps a plain integer count of its launches; read them
with :func:`launch_counts` and zero them with :func:`reset_launch_counts`.
``fused_weights`` and ``compact_raster`` (jnp outside any ``pallas_call``
in the reference) are torch ops on either device.
"""

from __future__ import annotations

import torch

from . import conv2d_gemm as _conv
from . import fused_detect as _fused
from . import hough_vote as _vote
from . import ref
from .hough_vote import compact_edges  # noqa: F401  (re-exported)


def _on_card(t: torch.Tensor) -> bool:
    """True: launch the kernel (a CUDA tensor); False: the plain version."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def launch_counts() -> dict[str, int]:
    return {"conv2d_gemm": _conv.launches, "fused_detect": _fused.launches,
            "hough_vote": _vote.launches}


def reset_launch_counts() -> None:
    _conv.launches = 0
    _fused.launches = 0
    _vote.launches = 0


def conv2d_gemm(image: torch.Tensor, masks: torch.Tensor, *,
                out_dtype=None) -> torch.Tensor:
    """Same-padded multi-mask correlation, (..., H, W) -> (..., M, H, W)."""
    if _on_card(image):
        return _conv.conv2d_gemm(image, masks, out_dtype=out_dtype)
    return ref.conv2d_gemm(image, masks, out_dtype=out_dtype)


def conv2d_stencil(image: torch.Tensor, masks: torch.Tensor, *,
                   out_dtype=None) -> torch.Tensor:
    """The paper's scalar baseline (per-tap shift-multiply-add) on any device."""
    return ref.conv2d_stencil(image, masks, out_dtype=out_dtype)


def default_max_edges(n_pix: int) -> int:
    """Hand-tuned edge-compaction buffer default: 1/16 of the pixel count.

    The single source of the compaction cap: ``core.hough.max_edge_tiers``
    tops out here, so "auto" never allocates a larger buffer.
    """
    return max(256, n_pix // 16)


def grad_hits(image, *, stride, thresh, corridors=None, widen=0.0):
    """Downsampled-gradient hit count (the edge-count estimator's reduction);
    element-wise and a reduction, so torch ops on either device."""
    return ref.grad_hits(image, stride=stride, thresh=thresh,
                         corridors=corridors, widen=widen)


def fused_weights(image, corridors=None, *, cfg, edge_threshold):
    """Thresholded, corridor-filtered flat edge weights (pre-compaction):
    the port's Canny and element-wise torch ops, on either device."""
    return ref.fused_weights(image, cfg=cfg, edge_threshold=edge_threshold,
                             corridors=corridors)


def compact_raster(weights, *, width, max_edges):
    """Raster-layout compaction (flat indices scattered, ``(x, y, 1)``
    rebuilt): torch ops on either device; ``(cxy, cw, counts)``."""
    return ref.compact_raster(weights, width=width, max_edges=max_edges)


def fused_detect(image, corridors=None, *, cfg, edge_threshold, max_edges):
    """Fused Canny -> corridor filter -> raster compaction (kernel A of the
    fused hot path): frames in, ``(cxy, cw, counts)`` out, with no edge map
    in device memory on the card.  Feed the result to
    ``hough_vote(..., counts=counts)`` (kernel B)."""
    if _on_card(image):
        return _fused.fused_detect(image, corridors, cfg=cfg,
                                   edge_threshold=edge_threshold,
                                   max_edges=max_edges)
    return ref.fused_detect(image, cfg=cfg, edge_threshold=edge_threshold,
                            max_edges=max_edges, corridors=corridors)


def hough_vote(xy, weights, trig, *, n_rho: int, compact: bool = False,
               max_edges=None, theta_bins=None, scatter_back: bool = True,
               counts=None):
    """Hough voting with optional edge compaction and theta gating.

    The semantics of ``repro.kernels.ops.hough_vote``.  ``compact=True``
    first compacts the edge pixels into ``max_edges`` rows (default 1/16
    of the pixel count); the kernel then reads each frame's edge count
    from device memory and skips the rows past it.  ``counts`` gives those
    counts for a buffer that is compacted already (``fused_detect``'s);
    the rows past them hold zero weights, so they only save the kernel
    work.  ``theta_bins`` (an int vector on the weights' device) votes
    over only those trig columns; ``scatter_back=True`` puts the band back
    into a full-width accumulator with zeros outside it, ``False`` returns
    the (..., n_rho, band) votes.
    """
    if compact:
        if counts is not None:
            raise ValueError("counts belong to a buffer that is compacted "
                             "already; pass compact=False with them")
        if isinstance(max_edges, str):
            raise TypeError(
                "max_edges='auto' is a core-layer knob; resolve it to an int "
                "before kernel dispatch (repro_torch.core.hough."
                "resolve_max_edges / auto_max_edges)."
            )
        if max_edges is None:
            max_edges = default_max_edges(weights.shape[-1])
        xy, weights, counts = compact_edges(xy, weights, max_edges=max_edges)
    n_theta_full = trig.shape[1]
    if theta_bins is not None:
        theta_bins = theta_bins.to(torch.int64)
        trig = trig[:, theta_bins]
    if _on_card(weights):
        votes = _vote.hough_vote(xy, weights, trig, n_rho=n_rho,
                                 counts=counts)
    else:
        votes = ref.hough_vote(xy, weights, trig, n_rho=n_rho)
    if theta_bins is not None and scatter_back:
        full = torch.zeros(votes.shape[:-1] + (n_theta_full,),
                           dtype=votes.dtype, device=votes.device)
        votes = full.index_copy_(-1, theta_bins, votes)
    return votes
