"""State-space blocks (``repro/models/ssm.py``): Mamba-1 (the selective
scan) and Mamba-2 (SSD).

Mamba-2's prefill runs the SSD scan through ``kernels.ops.ssd_scan`` (the
hand kernel on the card, the plain versions on the CPU); as in the
reference, the scan is called without ``cfg.ssm.chunk``, so it always
takes the default chunk of 128.  Mamba-1's decay varies per (channel,
state) pair, so it has no such rewrite: the reference runs it in plain JAX
as a chunked associative scan (log-depth inside each chunk of
``cfg.ssm.chunk``, a sequential carry across chunks), and so does the
port, in plain PyTorch (:func:`_mamba1_scan`).  Decode is the O(1)
recurrent step for both.
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


def mamba1_spec(cfg) -> Any:
    s = cfg.ssm
    D, Din, N, R = cfg.d_model, s.d_inner, s.d_state, s.dt_rank
    return {
        "in_proj": P((D, 2 * Din), ("embed", "inner")),
        "conv_w": P((s.d_conv, Din), ("conv_k", "inner"), scale=0.5),
        "conv_b": P((Din,), ("inner",), init="zeros"),
        "x_proj": P((Din, R + 2 * N), ("inner", "dt_rank")),
        "dt_w": P((R, Din), ("dt_rank", "inner")),
        "dt_b": P((Din,), ("inner",), init="zeros"),
        "A_log": P((Din, N), ("inner", "state"), init="zeros"),
        "D": P((Din,), ("inner",), init="ones"),
        "out_proj": P((Din, D), ("inner", "embed")),
    }


def _prefix_combine(a, b):
    """Inclusive prefix of the pairs (a, b) along dim 1 under the scan's
    combine (a1, b1) . (a2, b2) = (a1 a2, b2 + a2 b1), by doubling
    (Hillis-Steele): log2(Q) rounds, each over the whole chunk."""
    Q = a.shape[1]
    s = 1
    while s < Q:
        b = torch.cat([b[:, :s], b[:, s:] + a[:, s:] * b[:, :-s]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def _mamba1_scan(u, dt, A, Bt, Ct, h0, chunk: int):
    """Chunked associative selective scan, f32.

    u, dt: (B, L, Din); A: (Din, N); Bt, Ct: (B, L, N); h0: (B, Din, N).
    Returns y (B, L, Din) and the final state hL (B, Din, N).  L is padded
    with dt = 0 to whole chunks of ``min(chunk, L)``: a padded step has
    decay 1 and input 0, so it leaves the carried state as it is.
    """
    B, L, Din = u.shape
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        u, dt, Bt, Ct = (F.pad(t, (0, 0, 0, pad)) for t in (u, dt, Bt, Ct))
    h, ys = h0, []
    for c0 in range(0, L + pad, Q):
        sl = slice(c0, c0 + Q)
        dtc = dt[:, sl]
        a = torch.exp(dtc[..., None] * A)                   # (B, Q, Din, N)
        x_in = (dtc * u[:, sl])[..., None] * Bt[:, sl, None, :]
        a_cum, s = _prefix_combine(a, x_in)
        h_all = s + a_cum * h[:, None]
        ys.append(torch.einsum("bqn,bqdn->bqd", Ct[:, sl], h_all))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1)[:, :L], h


def mamba1_forward(params, x, cfg, *, state=None):
    """x: (B, L, D) -> (y, new_state).  ``state`` = {"conv", "ssm"} carries
    a previous segment's (decode, or a prefill in parts); without it the
    scan starts from zeros."""
    s = cfg.ssm
    B, L, D = x.shape
    f32 = torch.float32
    xz = torch.matmul(x, params["in_proj"].to(x.dtype))
    xi, z = torch.chunk(xz, 2, dim=-1)                      # (B, L, Din)

    conv_state = None if state is None else state["conv"]
    xi, new_conv = _causal_conv(xi, params["conv_w"], params["conv_b"],
                                state=conv_state)

    proj = torch.matmul(xi.to(f32), params["x_proj"].to(f32))
    dt_lr, Bt, Ct = torch.split(proj, [s.dt_rank, s.d_state, s.d_state],
                                dim=-1)
    dt = _softplus(torch.matmul(dt_lr, params["dt_w"].to(f32))
                   + params["dt_b"].to(f32))
    A = -torch.exp(params["A_log"].to(f32))

    h0 = (torch.zeros((B, s.d_inner, s.d_state), dtype=f32, device=x.device)
          if state is None else state["ssm"])
    y, hL = _mamba1_scan(xi.to(f32), dt, A, Bt, Ct, h0, s.chunk)
    y = y + params["D"].to(f32) * xi.to(f32)
    y = y.to(x.dtype) * F.silu(z)
    out = torch.matmul(y, params["out_proj"].to(x.dtype))
    return out, {"conv": new_conv, "ssm": hL}


def mamba1_decode(params, x, cfg, state):
    """One token a request, x (B, 1, D): the O(1) step from ``state``."""
    return mamba1_forward(params, x, cfg, state=state)


def mamba1_state_spec(cfg, batch: int) -> tuple[dict, dict]:
    """(``{"conv": meta, "ssm": meta}``, their logical axes) of one
    layer."""
    s = cfg.ssm
    return (
        {"conv": torch.empty((batch, s.d_conv - 1, s.d_inner),
                             dtype=cfg.cdtype, device="meta"),
         "ssm": torch.empty((batch, s.d_inner, s.d_state),
                            dtype=torch.float32, device="meta")},
        {"conv": ("batch", "conv_k", "inner"),
         "ssm": ("batch", "inner", "state")},
    )


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


def mamba2_state_spec(cfg, batch: int) -> tuple[dict, dict]:
    """(``{"conv": meta, "ssm": meta}``, their logical axes) of one
    layer."""
    s = cfg.ssm
    conv_dim = s.d_inner + 2 * s.n_groups * s.d_state
    return (
        {"conv": torch.empty((batch, s.d_conv - 1, conv_dim),
                             dtype=cfg.cdtype, device="meta"),
         "ssm": torch.empty((batch, s.n_heads, s.d_state, s.head_dim),
                            dtype=torch.float32, device="meta")},
        {"conv": ("batch", "conv_k", "inner"),
         "ssm": ("batch", "inner_heads", "state", None)},
    )
