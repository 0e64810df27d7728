"""Plain PyTorch versions of the detection kernels (``repro/kernels/ref.py``).

These are the semantics of record for the hand kernels in ``csrc/``: the
CPU runs them (``ops`` dispatches a CPU tensor here), and ``chip_smoke.py``
and the tests hold each kernel against them on the card.  Each one repeats
the reference's arithmetic, not its speed.

Run on the card, the matmul-based versions need TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``), or rho bins move.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .tiles import acc_dtype as _acc_dtype


def _same_pad(image: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    return F.pad(image, (kw // 2, kw // 2, kh // 2, kh // 2))


def conv2d_gemm(image: torch.Tensor, masks: torch.Tensor, *,
                out_dtype=None) -> torch.Tensor:
    """Same-padded 2D correlation; (..., H, W) -> (..., n_masks, H, W).

    The im2col + contraction form of the reference.  Integer inputs
    contract by a broadcast multiply-sum instead of ``einsum``: cuBLAS has
    no int32 product, and integer sums are exact in any order.
    """
    H, W = image.shape[-2:]
    n_masks, kh, kw = masks.shape
    integer = not image.dtype.is_floating_point
    acc = _acc_dtype(image.dtype)
    if out_dtype is None:
        out_dtype = torch.int32 if integer else image.dtype
    padded = _same_pad(image, kh, kw)
    # im2col: (..., H, W, kh*kw) patch tensor, then one contraction.
    patches = torch.stack(
        [
            padded[..., dy : dy + H, dx : dx + W]
            for dy in range(kh)
            for dx in range(kw)
        ],
        dim=-1,
    ).to(acc)
    flat = masks.reshape(n_masks, kh * kw).to(acc)
    if integer:
        out = (patches.unsqueeze(-4) * flat[:, None, None, :]).sum(
            -1, dtype=acc
        )
    else:
        out = torch.einsum("...hwk,mk->...mhw", patches, flat)
    return out.to(out_dtype)


def conv2d_stencil(image: torch.Tensor, masks: torch.Tensor, *,
                   out_dtype=None) -> torch.Tensor:
    """Scalar-core formulation: per-tap shift-multiply-accumulate, no GEMM.

    The paper's *baseline* execution (the "rocket" platform), kept as a
    measurable path; it runs only when ``CannyConfig(impl="stencil")``
    names it.
    """
    H, W = image.shape[-2:]
    n_masks, kh, kw = masks.shape
    integer = not image.dtype.is_floating_point
    acc = _acc_dtype(image.dtype)
    if out_dtype is None:
        out_dtype = torch.int32 if integer else image.dtype
    padded = _same_pad(image, kh, kw).to(acc)
    m_acc = masks.to(acc)
    outs = []
    for m in range(n_masks):
        o = torch.zeros(image.shape, dtype=acc, device=image.device)
        for dy in range(kh):
            for dx in range(kw):
                o = o + m_acc[m, dy, dx] * padded[..., dy : dy + H, dx : dx + W]
        outs.append(o)
    return torch.stack(outs, dim=-3).to(out_dtype)


def grad_hits(image: torch.Tensor, *, stride: int, thresh: float,
              corridors: torch.Tensor | None = None, widen: float = 0.0
              ) -> torch.Tensor:
    """Downsampled finite-difference gradient hit count (per frame).

    The reduction behind the ``max_edges`` estimator
    (``core.canny.estimate_edge_count_device``): subsample by ``stride``,
    take |dx|/|dy| differences, count coarse pixels whose stronger
    difference clears ``thresh``; ``corridors``/``widen`` drop hits outside
    every widened rho window.  (..., H, W) -> (...) int32.
    """
    img = image.to(torch.float32)
    sub = img[..., ::stride, ::stride]
    gx = (sub[..., :, 1:] - sub[..., :, :-1]).abs()[..., :-1, :]
    gy = (sub[..., 1:, :] - sub[..., :-1, :]).abs()[..., :, :-1]
    hit = torch.maximum(gx, gy) >= thresh
    if corridors is not None:
        Hs, Ws = hit.shape[-2:]
        yy = torch.arange(Hs, dtype=torch.float32, device=img.device)[:, None] * stride
        xx = torch.arange(Ws, dtype=torch.float32, device=img.device)[None, :] * stride
        cor = corridors.to(torch.float32)
        rho = (
            xx[None] * cor[:, 0, None, None]
            + yy[None] * cor[:, 1, None, None]
        )
        keep = (
            (rho >= (cor[:, 2, None, None] - widen))
            & (rho <= (cor[:, 3, None, None] + widen))
        ).any(dim=0)
        hit = hit & keep
    return hit.sum(dim=(-2, -1), dtype=torch.int32)


def rho_product(xy: torch.Tensor, trig: torch.Tensor) -> torch.Tensor:
    """``xy @ trig`` in f32: (..., P, C) x (C, T) -> (..., P, T).

    ``torch.matmul`` on the CPU rounds as XLA's dot does,
    ``fadd(fma(y, sin, x * cos), diag)``: on the 720x1280 raster x 180
    thetas no value differs, where a plain ``(x*c + y*s) + d`` moves
    1046 rho bins.  The vote kernel spells the same nesting out.
    """
    return torch.matmul(xy.to(torch.float32), trig.to(torch.float32))


def hough_vote(xy: torch.Tensor, weights: torch.Tensor, trig: torch.Tensor,
               *, n_rho: int) -> torch.Tensor:
    """Scatter-add vote (the paper's Algorithm 2, vectorized).

    ``weights`` is (P,) or (N, P); ``xy`` is shared (P, C) or per-frame
    (N, P, C).  Returns (n_rho, T) or (N, n_rho, T) f32.
    """
    rho = rho_product(xy, trig)
    idx = torch.floor(rho).to(torch.int64)
    n_theta = trig.shape[1]
    lead = weights.shape[:-1]
    idx = idx.expand(lead + idx.shape[-2:])
    inside = (idx >= 0) & (idx < n_rho)
    w = torch.where(inside, weights.to(torch.float32)[..., None], 0.0)
    flat = idx.clamp(0, n_rho - 1) * n_theta + torch.arange(
        n_theta, device=idx.device
    )
    if lead:
        frame = torch.arange(lead.numel(), device=idx.device).reshape(
            lead + (1, 1)
        )
        flat = flat + frame * (n_rho * n_theta)
    votes = torch.zeros(lead + (n_rho, n_theta), dtype=torch.float32,
                        device=weights.device)
    votes.view(-1).index_put_((flat.reshape(-1),), w.reshape(-1),
                              accumulate=True)
    return votes


def compact_edges(xy: torch.Tensor, weights: torch.Tensor, *,
                  max_edges: int):
    """Edge compaction as a stable partition of edge pixels to the front.

    The reference's oracle form (a stable argsort), independent of the
    prefix-sum scatter in ``kernels/hough_vote.py``: rows past the edge
    count are zero and edges beyond ``max_edges`` are dropped.  As in the
    reference, the output has ``min(P, max_edges)`` rows.
    """
    mask = weights > 0
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)[
        ..., :max_edges
    ]
    keep = torch.gather(mask, -1, order)
    if xy.ndim == weights.ndim:  # shared coordinates, per-frame weights
        xy = xy.expand(weights.shape[:-1] + xy.shape)
    cxy = torch.take_along_dim(xy, order[..., None], dim=-2)
    cxy = torch.where(keep[..., None], cxy, torch.zeros_like(cxy))
    cw = torch.gather(weights, -1, order)
    cw = torch.where(keep, cw, torch.zeros_like(cw))
    return cxy, cw


def hough_vote_compact(xy, weights, trig, *, n_rho: int, max_edges: int):
    """Compacted vote: compact edges, then vote over ``max_edges`` rows."""
    cxy, cw = compact_edges(xy, weights, max_edges=max_edges)
    return hough_vote(cxy, cw, trig, n_rho=n_rho)


def hough_vote_gated(xy, weights, trig, theta_bins, *, n_rho: int):
    """Theta-gated vote: the full sweep with every column outside the gate
    zeroed (independent of the gather/scatter form in ``ops``)."""
    full = hough_vote(xy, weights, trig, n_rho=n_rho)
    mask = torch.zeros(trig.shape[1], dtype=torch.bool, device=full.device)
    mask[theta_bins.to(torch.int64)] = True
    return torch.where(mask, full, torch.zeros_like(full))


def corridor_keep(xy: torch.Tensor, corridors: torch.Tensor) -> torch.Tensor:
    """Which pixels fall inside at least one rho corridor.

    ``corridors`` is (C, 4) rows ``[cos, sin, rho_lo, rho_hi]`` in signed,
    unshifted rho; ``xy`` is (..., P, >=2) with columns (x, y, ...).
    Returns (..., P) bool.

    ``rho = x*c + y*s`` is two rounded products and one rounded add, as
    the reference's K=2 dot rounds on the CPU; ``torch.matmul`` would
    compute ``fma(y, s, x*c)`` there, one ulp off for about a quarter of
    the raster, and move pixels that lie on a corridor bound.
    """
    cor = corridors.to(torch.float32)
    xyf = xy[..., :2].to(torch.float32)
    rho = xyf[..., 0:1] * cor[:, 0] + xyf[..., 1:2] * cor[:, 1]
    return ((rho >= cor[:, 2]) & (rho <= cor[:, 3])).any(dim=-1)


def fused_weights(image: torch.Tensor, *, cfg, edge_threshold: float,
                  corridors: torch.Tensor | None = None) -> torch.Tensor:
    """Flat edge weights of the fused hot path before compaction.

    The whole Canny front end (``impl`` ignored, as the reference pins it),
    the staged path's edge threshold, and a zero weight for every pixel
    outside all ``corridors``.  Returns (..., H*W) f32.
    """
    from repro_torch.core.canny import canny  # function-level: cycle

    edges = canny(image, dataclasses.replace(cfg, impl=None))
    H, W = edges.shape[-2:]
    w = (edges.reshape(edges.shape[:-2] + (H * W,)) >= edge_threshold).to(
        torch.float32)
    if corridors is not None:
        ii, jj = torch.meshgrid(torch.arange(H, device=w.device),
                                torch.arange(W, device=w.device),
                                indexing="ij")
        xy = torch.stack([jj.reshape(-1), ii.reshape(-1)], dim=1).to(
            torch.float32)
        w = w * corridor_keep(xy, corridors).to(torch.float32)
    return w


def compact_raster(weights: torch.Tensor, *, width: int, max_edges: int):
    """Raster-layout compaction: scatter flat pixel indices, then rebuild
    ``(idx % width, idx // width, 1)``.

    ``weights`` is (P,) or (N, P).  Returns ``(cxy, cw, counts)``:
    (..., max_edges, 3) and (..., max_edges) f32 in raster order, zero past
    each frame's count, and the per-frame count of rows kept, int32 on the
    weights' device.  Edges beyond ``max_edges`` land in a spare row
    ``max_edges`` that is sliced off (the reference's ``mode="drop"``).
    """
    squeeze = weights.ndim == 1
    w = weights[None] if squeeze else weights
    N, P = w.shape
    dev = w.device
    mask = w > 0
    pos = torch.cumsum(mask, dim=-1) - 1
    pos = torch.where(mask & (pos < max_edges), pos, max_edges)
    idx = torch.zeros((N, max_edges + 1), dtype=torch.int64, device=dev)
    idx.scatter_(1, pos, torch.arange(P, device=dev).expand(N, P))
    idx = idx[:, :max_edges]
    counts = mask.sum(dim=-1, dtype=torch.int32).clamp_(max=max_edges)
    slot = torch.arange(max_edges, device=dev)[None, :] < counts[:, None]
    cw = torch.where(slot, torch.gather(w, 1, idx), 0.0)
    cxy = torch.stack([(idx % width).to(torch.float32),
                       (idx // width).to(torch.float32),
                       torch.ones_like(idx, dtype=torch.float32)], dim=-1)
    cxy = torch.where(slot[..., None], cxy, 0.0)
    if squeeze:
        return cxy[0], cw[0], counts[0]
    return cxy, cw, counts


def fused_detect(image: torch.Tensor, *, cfg, edge_threshold: float,
                 max_edges: int, corridors: torch.Tensor | None = None):
    """The fused hot path's front end: Canny -> threshold -> corridor filter
    -> raster compaction.  (H, W) or (N, H, W) frames -> ``(cxy, cw,
    counts)`` as :func:`compact_raster` returns them."""
    w = fused_weights(image, cfg=cfg, edge_threshold=edge_threshold,
                      corridors=corridors)
    return compact_raster(w, width=image.shape[-1], max_edges=max_edges)
