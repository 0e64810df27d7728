"""Mamba-2 blocks (``repro/models/ssm.py``, the Mamba-2 half).

Prefill runs the SSD scan through ``kernels.ops.ssd_scan`` (the hand
kernel on the card, the plain versions on the CPU); decode is the O(1)
recurrent step.  As in the reference, the scan is called without
``cfg.ssm.chunk``, so it always takes the default chunk of 128.  Mamba-1
waits in the module queue (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .layers import P, rms_norm


def mamba2_spec(cfg) -> Any:
    s = cfg.ssm
    D, Din = cfg.d_model, s.d_inner
    G, N, H = s.n_groups, s.d_state, s.n_heads
    conv_dim = Din + 2 * G * N
    return {
        "in_proj": P((D, 2 * Din + 2 * G * N + H), ("embed", "inner")),
        "conv_w": P((s.d_conv, conv_dim), ("conv_k", "inner"), scale=0.5),
        "conv_b": P((conv_dim,), ("inner",), init="zeros"),
        "A_log": P((H,), ("inner_heads",), init="zeros"),
        "dt_b": P((H,), ("inner_heads",), init="zeros"),
        "D": P((H,), ("inner_heads",), init="ones"),
        "norm_w": P((Din,), ("inner",), init="ones"),
        "out_proj": P((Din, D), ("inner", "embed")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0), written out (torch's softplus
    switches to the identity above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, b, *, state=None):
    """Depthwise causal conv along L, then SiLU.  x: (B, L, C), w: (K, C).

    ``state``: (B, K-1, C) trailing context of the previous segment.
    Returns (y, new_state); the taps are summed in the reference's order.
    """
    B, L, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    ctx = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros((B, L, C), dtype=x.dtype, device=x.device)
    for i in range(K):
        y = y + ctx[:, i:i + L] * w[i].to(x.dtype)
    new_state = ctx[:, -(K - 1):] if K > 1 else state
    return F.silu(y + b.to(x.dtype)), new_state


def mamba2_forward(params, x, cfg, *, state=None):
    """x: (B, L, D) -> (y, new_state); the SSD scan without a state, the
    recurrent step (L == 1) with one."""
    s = cfg.ssm
    B, L, D = x.shape
    G, N, H, Ph = s.n_groups, s.d_state, s.n_heads, s.head_dim
    Din = s.d_inner

    zxbcdt = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xbc, dt_raw = torch.split(zxbcdt, [Din, Din + 2 * G * N, H], dim=-1)

    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 state=conv_state)
    xi, Bt, Ct = torch.split(xbc, [Din, G * N, G * N], dim=-1)

    dt = _softplus(dt_raw.to(torch.float32)
                   + params["dt_b"].to(torch.float32))       # (B, L, H)
    A = -torch.exp(params["A_log"].to(torch.float32))         # (H,)

    xh = xi.reshape(B, L, H, Ph)
    Bg = Bt.reshape(B, L, G, N)
    Cg = Ct.reshape(B, L, G, N)

    if state is None:
        y, hL = ops.ssd_scan(xh.to(torch.float32), dt, A,
                             Bg.to(torch.float32), Cg.to(torch.float32))
    else:
        y, hL = _mamba2_step(xh, dt, A, Bg, Cg, state["ssm"])
    y = y.to(x.dtype) + (params["D"].to(x.dtype)[:, None]
                         * xh.to(x.dtype)).to(x.dtype)
    y = y.reshape(B, L, Din) * F.silu(z)
    y = rms_norm(y, params["norm_w"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"].to(x.dtype))
    return out, {"conv": new_conv, "ssm": hL}


def _mamba2_step(xh, dt, A, Bg, Cg, h):
    """Single-step (L == 1) recurrence: h <- exp(dt A) h + dt B x."""
    B, L, H, Ph = xh.shape
    G = Bg.shape[2]
    rep = H // G
    dt0 = dt[:, 0].to(torch.float32)                          # (B, H)
    a = torch.exp(dt0 * A[None, :])                           # (B, H)
    Bh = Bg[:, 0].repeat_interleave(rep, dim=1).to(torch.float32)  # (B,H,N)
    Ch = Cg[:, 0].repeat_interleave(rep, dim=1).to(torch.float32)
    u = torch.einsum("bh,bhn,bhp->bhnp", dt0, Bh,
                     xh[:, 0].to(torch.float32))
    h = a[..., None, None] * h + u                            # (B, H, N, P)
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)[:, None]         # (B, 1, H, P)
    return y, h


def mamba2_state_spec(cfg, batch: int) -> dict:
    """``{"conv": (shape, dtype), "ssm": (shape, dtype)}`` of one layer."""
    s = cfg.ssm
    conv_dim = s.d_inner + 2 * s.n_groups * s.d_state
    return {
        "conv": ((batch, s.d_conv - 1, conv_dim), cfg.cdtype),
        "ssm": ((batch, s.n_heads, s.d_state, s.head_dim), torch.float32),
    }
