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

The LM seams, ``flash_attention`` and ``ssd_scan``, keep the reference's
CPU dispatch (``repro/kernels/ops.py``) so that both packages take the same
arithmetic on the host: dense attention up to a kv length of 2048 and the
blockwise form above; the sequential SSD oracle up to L = 64 and the
chunked form (``chunk``, default 128) above.  On the card each kernel runs
inside a ``torch.autograd.Function`` whose backward is plain PyTorch, as
the reference's gradients are jnp: the blockwise attention backward and
the chunked SSD form recomputed.  A backward launches no kernel; under
``torch.utils.checkpoint`` the recomputed forward launches the kernels a
second time.  The kernel wrappers themselves refuse an input that
requires grad.

The package exports these entry points under their own names, as
``repro.kernels`` does: ``repro_torch.kernels.flash_attention`` (and the
other five) is the kernel's module, and calling it calls the function of
that name here (``kernels/__init__.py``).  Callers in the port use ``ops``.

``tiled_matmul`` (under ``core.quantize.quantized_matmul``) drops the
reference's ``impl`` and ``bm``/``bn``/``bk`` knobs, as ``HoughConfig``
dropped ``impl``: the device picks the path and the kernel its tile.
"""

from __future__ import annotations

import torch

from . import conv2d_gemm as _conv
from . import flash_attention as _attn
from . import fused_detect as _fused
from . import hough_vote as _vote
from . import ref
from . import ssd_scan as _ssd
from . import tiled_matmul as _mm
from .hough_vote import compact_edges  # noqa: F401  (re-exported)


def _on_card(t: torch.Tensor) -> bool:
    """True: launch the kernel (a CUDA tensor); False: the plain version."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


_KERNEL_MODULES = {"conv2d_gemm": _conv, "fused_detect": _fused,
                   "hough_vote": _vote, "flash_attention": _attn,
                   "ssd_scan": _ssd, "tiled_matmul": _mm}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0


def tiled_matmul(x: torch.Tensor, y: torch.Tensor, *,
                 out_dtype=None) -> torch.Tensor:
    """(M, K) @ (K, N): int8 x int8 -> int32 exact, floats accumulated in
    f32 -> ``out_dtype`` (default ``x.dtype``)."""
    if _on_card(x):
        return _mm.tiled_matmul(x, y, out_dtype=out_dtype)
    return ref.tiled_matmul(x, y, out_dtype=out_dtype)


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


# Above this kv length the CPU takes the blockwise form (the same function,
# O(Lq * block) memory), as the reference's host dispatch does.
_DENSE_MAX_KV = 2048


class _AttentionFn(torch.autograd.Function):
    """The attention kernel with a gradient.  Forward: the kernel as it is;
    backward: the reference's blockwise backward in plain PyTorch on the
    same device (the reference has no Pallas backward), its lse from the
    plain pass ``ref.attention_lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out = _attn.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.masks = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        causal, window, q_offset = ctx.masks
        lse = ref.attention_lse(q, k, causal=causal, window=window,
                                q_offset=q_offset)
        dq, dk, dv = ref.attention_blockwise_backward(
            q, k, v, out, lse, do, causal=causal, window=window,
            q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0):
    """Attention over (B, Hq, Lq, D) queries and (B, Hkv, Lkv, D) keys and
    values: causal and window masks in global positions ``q_offset + i``,
    GQA for Hq % Hkv == 0; out in q's dtype."""
    if _on_card(q):
        return _AttentionFn.apply(q, k, v, causal, window, q_offset)
    if k.shape[2] > _DENSE_MAX_KV:
        return ref.attention_blockwise(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    return ref.attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


# Above this sequence length the CPU takes the chunked SSD form instead of
# the L-step sequential oracle, as the reference's host dispatch does.
_SSD_SEQ_MAX = 64


def ssd_grads(inputs, dy, dstate, *, chunk: int = 128,
              needs=(True,) * 5):
    """The SSD scan's gradient: ``ref.ssd_scan_chunked`` recomputed at
    ``chunk`` on detached copies of ``inputs`` (x, dt, A, B, C), then
    differentiated against (dy, dstate); ``dstate=None`` counts as zeros.
    One gradient per input, None where ``needs`` says it needs none."""
    leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
    wanted = [t for t in leaves if t.requires_grad]
    with torch.enable_grad():
        y, state = ref.ssd_scan_chunked(*leaves, chunk=chunk)
        if dstate is None:
            dstate = torch.zeros_like(state)
        got = iter(torch.autograd.grad((y, state), wanted, (dy, dstate),
                                       allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in leaves)


class _SSDFn(torch.autograd.Function):
    """The SSD kernel with a gradient.  Forward: the kernel as it is;
    backward: :func:`ssd_grads`, the plain chunked form recomputed and
    differentiated on the same device (the reference's gradient is autodiff
    of its jnp forms; it has no Pallas backward)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, state = _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        return (*ssd_grads(ctx.saved_tensors, dy, dstate, chunk=ctx.chunk,
                           needs=ctx.needs_input_grad[:5]), None)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """Mamba-2 SSD scan: x (b, L, H, P), dt (b, L, H), A (H,), B/C
    (b, L, G, N) -> (y (b, L, H, P), final state (b, H, N, P) f32)."""
    if _on_card(x):
        return _SSDFn.apply(x, dt, A, B, C, chunk)
    if x.shape[1] > _SSD_SEQ_MAX:
        return ref.ssd_scan_chunked(x, dt, A, B, C, chunk=chunk)
    return ref.ssd_scan(x, dt, A, B, C)
