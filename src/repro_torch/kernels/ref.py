"""Plain PyTorch versions of the kernels (``repro/kernels/ref.py``).

These are the semantics of record for the hand kernels in ``csrc/``: the
CPU runs them (``ops`` dispatches a CPU tensor here), and ``chip_smoke.py``
and the tests hold each kernel against them on the card.  Each one repeats
the reference's arithmetic, not its speed.  The detection half comes
first; the LM half (attention with its blockwise backward, and the
Mamba-2 SSD scan) is at the end.

Run on the card, the matmul-based versions need TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``), or rho bins move and
attention and SSD sums lose their f32 precision.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .tiles import acc_dtype as _acc_dtype


def tiled_matmul(x: torch.Tensor, y: torch.Tensor, *, out_dtype=None
                 ) -> torch.Tensor:
    """``x @ y`` for (M, K) @ (K, N): integers accumulate exactly (int32
    out by default), floats in f32 (``x.dtype`` out by default).

    The operands are upcast first.  On the CPU ``torch.mm`` of two int8
    tensors returns int8 and wraps, so integers go through int64 there; the
    card has no integer ``mm``, so they go through float64, which is exact
    while every partial sum stays below 2^53 (int8 up to K = 2^38).  The
    int64 -> int32 cast wraps as the reference's int32 accumulator does.
    """
    integer = not x.dtype.is_floating_point
    if out_dtype is None:
        out_dtype = torch.int32 if integer else x.dtype
    if integer:
        wide = torch.float64 if x.is_cuda else torch.int64
        acc = torch.mm(x.to(wide), y.to(wide)).to(torch.int64)
        return acc.to(out_dtype)
    return torch.mm(x.to(torch.float32), y.to(torch.float32)).to(out_dtype)


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


# --- the LM half ---------------------------------------------------------


def _attention_mask(q_pos, kv_pos, kv_len, causal, window):
    mask = kv_pos[None, :] < kv_len
    if causal:
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
    if window is not None:
        mask = mask & ((q_pos[:, None] - kv_pos[None, :]) < window)
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0) -> torch.Tensor:
    """Dense softmax attention oracle (GQA by repeating kv heads).

    q (B, Hq, Lq, D); k, v (B, Hkv, Lkv, D), Hq % Hkv == 0.  Scores and
    softmax in f32; masks in global positions ``q_offset + i``; a row with
    no unmasked key gives 0.  Returns q's dtype.
    """
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / (D ** 0.5)
    dev = q.device
    q_pos = q_offset + torch.arange(Lq, device=dev)
    kv_pos = torch.arange(Lkv, device=dev)
    mask = _attention_mask(q_pos, kv_pos, Lkv, causal, window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)      # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def _abw_fwd_impl(q, k, v, causal, window, q_offset, block):
    """Online softmax over kv blocks: ``(out, lse)``, the reference's
    ``_abw_fwd_impl``.  ``v=None`` skips the output and returns ``(None,
    lse)``.  ``lse`` (B, Hq, Lq, 1) f32 is ``m + log l``, +inf on a row
    with no unmasked key, so that ``exp(s - lse)`` is 0 there."""
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    pad = (-Lkv) % block
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = None if v is None else F.pad(v, (0, 0, 0, pad))
    n_blocks = k.shape[2] // block
    dev = q.device
    qf = q.to(torch.float32)
    q_pos = q_offset + torch.arange(Lq, device=dev)
    acc = torch.zeros((B, Hq, Lq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Hq, Lq, 1), float("-inf"), device=dev)
    l = torch.zeros((B, Hq, Lq, 1), dtype=torch.float32, device=dev)
    for j in range(n_blocks):
        sl = slice(j * block, (j + 1) * block)
        kb = k[:, :, sl].repeat_interleave(rep, dim=1).to(torch.float32)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        kv_pos = j * block + torch.arange(block, device=dev)
        mask = _attention_mask(q_pos, kv_pos, Lkv, causal, window)
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe), 0.0)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = corr * l + p.sum(dim=-1, keepdim=True)
        if v is not None:
            vb = v[:, :, sl].repeat_interleave(rep, dim=1).to(torch.float32)
            acc = corr * acc + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    empty = l == 0.0
    lse = torch.where(empty, float("inf"),
                      torch.where(torch.isinf(m), 0.0, m)
                      + torch.log(torch.where(empty, 1.0, l)))
    if v is None:
        return None, lse
    return (acc / torch.where(empty, 1.0, l)).to(q.dtype), lse


def attention_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  window: int | None = None, q_offset: int = 0,
                  block: int = 512) -> torch.Tensor:
    """The log-sum-exp of each query row's scaled, masked scores, (B, Hq,
    Lq, 1) f32 (+inf on a row with no unmasked key): the statistic the
    attention backward needs beside the output, computed over kv blocks as
    :func:`attention_blockwise` computes it, without v."""
    return _abw_fwd_impl(q, k, None, causal, window, q_offset, block)[1]


def attention_blockwise_backward(q, k, v, out, lse, do, *, causal=True,
                                 window=None, q_offset=0, block=512):
    """The reference's flash-style backward (``_abw_bwd``): each block's p
    recomputed from (q, k, lse), ``delta = rowsum(do * out)``, GQA folded
    by summing the query heads that share a kv head.  Returns (dq, dk, dv)
    in the dtypes of q, k and v."""
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    pad = (-Lkv) % block
    kp, vp = k, v
    if pad:
        kp = F.pad(k, (0, 0, 0, pad))
        vp = F.pad(v, (0, 0, 0, pad))
    n_blocks = kp.shape[2] // block
    dev = q.device
    qf = q.to(torch.float32)
    dof = do.to(torch.float32)
    q_pos = q_offset + torch.arange(Lq, device=dev)
    delta = (dof * out.to(torch.float32)).sum(dim=-1, keepdim=True)
    dq = torch.zeros((B, Hq, Lq, D), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j in range(n_blocks):
        sl = slice(j * block, (j + 1) * block)
        kb = kp[:, :, sl].repeat_interleave(rep, dim=1).to(torch.float32)
        vb = vp[:, :, sl].repeat_interleave(rep, dim=1).to(torch.float32)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        kv_pos = j * block + torch.arange(block, device=dev)
        mask = _attention_mask(q_pos, kv_pos, Lkv, causal, window)
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.where(mask, torch.exp(s - lse), 0.0)
        dv_j = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vb)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dk_j = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
        dks.append(dk_j.reshape(B, Hkv, rep, block, D).sum(dim=2))
        dvs.append(dv_j.reshape(B, Hkv, rep, block, D).sum(dim=2))
    dk = torch.cat(dks, dim=2)[:, :, :Lkv]
    dv = torch.cat(dvs, dim=2)[:, :, :Lkv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BlockwiseAttention(torch.autograd.Function):
    """:func:`attention_blockwise` with the reference's ``custom_vjp``: the
    forward keeps (q, k, v, out, lse), the backward recomputes each
    block's p (:func:`attention_blockwise_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block):
        out, lse = _abw_fwd_impl(q, k, v, causal, window, q_offset, block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, q_offset, block)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, block = ctx.masks
        dq, dk, dv = attention_blockwise_backward(
            q, k, v, out, lse, do, causal=causal, window=window,
            q_offset=q_offset, block=block)
        return dq, dk, dv, None, None, None, None


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0, block: int = 512) -> torch.Tensor:
    """Online-softmax attention as a loop over kv blocks.

    The same function as :func:`attention` with O(Lq * block) memory: the
    reference's ``attention_blockwise``, which its CPU dispatch takes above
    a kv length of 2048, with its flash-style backward (the residuals are
    q, k, v, out and lse; each block's p is recomputed).
    """
    return _BlockwiseAttention.apply(q, k, v, causal, window, q_offset,
                                     block)


def ssd_scan_chunked(x, dt, A, B, C, *, chunk: int = 128):
    """Chunked SSD: the segment-sum matmul form of the Mamba-2 kernel, one
    chunk of ``min(chunk, L)`` steps at a time with the state carried.

    x (b, L, H, P), dt (b, L, H), A (H,), B/C (b, L, G, N).  Returns y in
    x's dtype and the final state (b, H, N, P) f32.  The ragged tail is
    padded with identity steps (zero x-contribution, zero log-decay).

    The decay between two steps is masked above the diagonal before its
    ``exp`` (the reference masks after it): the values are the same, and
    the gradient stays finite where a chunk's summed decay passes ~88 and
    the masked ``exp`` overflows, which makes the reference's gradient NaN
    (ROADMAP.md §3).
    """
    batch, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, L)
    pad = (-L) % Q
    xdt = (x * dt[..., None]).to(torch.float32)           # (b, L, H, P)
    ldec = (dt * A[None, None, :]).to(torch.float32)      # (b, L, H)
    Bf, Cf = B.to(torch.float32), C.to(torch.float32)
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        ldec = F.pad(ldec, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
    nc = (L + pad) // Q
    dev = x.device
    tril = torch.arange(Q, device=dev)[:, None] >= torch.arange(
        Q, device=dev)[None, :]
    h = torch.zeros((batch, H, N, P), dtype=torch.float32, device=dev)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xc, lc = xdt[:, sl], ldec[:, sl]
        Bh = Bf[:, sl].repeat_interleave(rep, dim=2)       # (b, Q, H, N)
        Ch = Cf[:, sl].repeat_interleave(rep, dim=2)
        cum = torch.cumsum(lc, dim=1)                      # (b, Q, H)
        cb = torch.einsum("bqhn,bkhn->bhqk", Ch, Bh)
        diff = (cum[:, :, None] - cum[:, None, :]).permute(0, 3, 1, 2)
        seg = torch.exp(diff.masked_fill(~tril, float("-inf")))  # (b,H,Q,Q)
        y = torch.einsum("bhqk,bkhp->bqhp", cb * seg, xc)
        y = y + torch.einsum("bqhn,bhnp->bqhp", Ch, h) * torch.exp(
            cum)[..., None]
        wB = Bh * torch.exp(cum[:, -1:, :] - cum)[..., None]
        h = torch.exp(cum[:, -1])[..., None, None] * h + torch.einsum(
            "bqhn,bqhp->bhnp", wB, xc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    return y.to(x.dtype), h


def ssd_scan(x, dt, A, B, C):
    """Sequential selective-scan oracle:
    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t . h_t``.

    Shapes as :func:`ssd_scan_chunked`; returns (y in x's dtype, final
    state f32).
    """
    batch, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2).to(torch.float32)
    Ch = C.repeat_interleave(rep, dim=2).to(torch.float32)
    xf = x.to(torch.float32)
    dtf = dt.to(torch.float32)
    h = torch.zeros((batch, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(dtf[:, t] * A[None, :])              # (b, H)
        u = torch.einsum("bh,bhn,bhp->bhnp", dtf[:, t], Bh[:, t], xf[:, t])
        h = a[..., None, None] * h + u
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1)                              # (b, L, H, P)
    return y.to(x.dtype), h
