"""Public kernel entry points of the port, dispatched on the tensor's device.

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand kernel (``csrc/``) or raises.  There is no switch and no
environment variable that sends a CUDA tensor to the plain version: the
only plain path the card runs on the detector's main path is the paper's
no-accelerator baseline, ``conv2d_stencil``, and only when a config names
it (``CannyConfig(impl="stencil")``).

Each kernel module keeps a plain integer count of its launches; read them
with :func:`launch_counts` and zero them with :func:`reset_launch_counts`.
"""

from __future__ import annotations

import torch

from . import conv2d_gemm as _conv
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
    return {"conv2d_gemm": _conv.launches, "hough_vote": _vote.launches}


def reset_launch_counts() -> None:
    _conv.launches = 0
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


def hough_vote(xy, weights, trig, *, n_rho: int, compact: bool = False,
               max_edges=None, theta_bins=None, scatter_back: bool = True):
    """Hough voting with optional edge compaction and theta gating.

    The semantics of ``repro.kernels.ops.hough_vote``.  ``compact=True``
    first compacts the edge pixels into ``max_edges`` rows (default 1/16
    of the pixel count); the kernel then reads each frame's edge count
    from device memory and skips the rows past it.  ``theta_bins`` (an
    int vector on the weights' device) votes over only those trig columns;
    ``scatter_back=True`` puts the band back into a full-width accumulator
    with zeros outside it, ``False`` returns the (..., n_rho, band) votes.
    """
    counts = None
    if compact:
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
