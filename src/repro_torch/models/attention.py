"""Self- and cross-attention for training, prefill and decode
(``repro/models/attention.py``).

Training (:func:`self_attention`, no cache), prefill and cross-attention
over a whole prompt (:func:`cross_attention`: queries from x, keys and
values projected from a context stream, no mask) go through
``kernels.ops.flash_attention`` (the hand kernel on the card, with a plain
backward; the plain oracle on the CPU).  Decode is one query a request: a
dense product against the cache, in the cache's storage dtype with f32
results (:func:`decode_cross_attention` reads the context's keys and
values, unmasked); self-attention's cache takes two layouts:

  * linear cache  (max_len slots, write at ``pos``)      — full attention
  * ring cache    (window slots, write at ``pos % W``)   — sliding window

The kv heads are shared by groups of query heads (GQA; MQA at one kv
head; MHA), and ``cfg.qkv_bias`` adds biases to the three projections.
Positions are per request, as the serving engine batches requests at
different depths.  Unlike the reference, which returns new caches, the
cache writes here are in place: the engine's cache is one set of tensors
that every step updates, so a decode step never copies it.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.sharding import constrain

from .layers import P, apply_rope, matmul_f32

# the logical axes of the (B, H, L, hd) queries and outputs, and of the
# (B, Hkv, L, hd) keys and values, as the kernel takes them
ATTN_AXES = ("batch", "heads", "attn_seq", "head_dim")
KV_AXES = ("batch", "kv_heads", None, "head_dim")


# --- parameter specs -----------------------------------------------------

def self_attn_spec(cfg) -> Any:
    hd = cfg.hd
    spec = {
        "wq": P((cfg.d_model, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": P((cfg.d_model, cfg.n_kv_heads, hd),
                ("embed", "kv_heads", "head_dim")),
        "wv": P((cfg.d_model, cfg.n_kv_heads, hd),
                ("embed", "kv_heads", "head_dim")),
        "wo": P((cfg.n_heads, hd, cfg.d_model), ("heads", "head_dim", "embed"),
                fan_in_dims=(0, 1)),
    }
    if cfg.qkv_bias:
        spec["bq"] = P((cfg.n_heads, hd), ("heads", "head_dim"), init="zeros")
        spec["bk"] = P((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"),
                       init="zeros")
        spec["bv"] = P((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"),
                       init="zeros")
    return spec


def cross_attn_spec(cfg, d_ctx: Optional[int] = None) -> Any:
    """Cross-attention: queries from x, keys/values from a context stream
    of width ``d_ctx`` (default ``d_model``)."""
    hd = cfg.hd
    d_ctx = d_ctx or cfg.d_model
    return {
        "wq": P((cfg.d_model, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": P((d_ctx, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d_ctx, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((cfg.n_heads, hd, cfg.d_model), ("heads", "head_dim", "embed"),
                fan_in_dims=(0, 1)),
    }


# --- projections -----------------------------------------------------------
# The qkv biases (qwen) are added after the projection, in x's dtype.

def _proj_q(params, x):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    return q


def _proj_kv(params, x):
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if "bk" in params:
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return k, v


def _proj_out(params, attn, x_dtype):
    return torch.einsum("bshk,hkd->bsd", attn, params["wo"].to(x_dtype))


# --- KV caches ---------------------------------------------------------------

def cache_spec(cfg, batch: int, max_len: int, *, ring: bool = False
               ) -> tuple[dict, dict]:
    """(``{"k": meta, "v": meta}``, their logical axes) of one attention
    layer's cache; ``ring=True`` allocates ``window`` slots."""
    slots = cfg.window if (ring and cfg.window) else max_len
    kv = (batch, cfg.n_kv_heads, slots, cfg.hd)
    axes = ("batch", "kv_heads", "cache_seq", "head_dim")
    return ({k: torch.empty(kv, dtype=cfg.cdtype, device="meta")
             for k in ("k", "v")}, {"k": axes, "v": axes})


def init_cache(cfg, batch: int, max_len: int, *, ring: bool = False,
               device=None) -> dict:
    spec, _ = cache_spec(cfg, batch, max_len, ring=ring)
    return {k: torch.zeros(m.shape, dtype=m.dtype, device=device)
            for k, m in spec.items()}


def _write_at(cache_kv: torch.Tensor, new: torch.Tensor,
              slot: torch.Tensor) -> None:
    """Write (B, Hkv, S, hd) into the (B, Hkv, L, hd) cache in place, request
    b at slots ``slot[b] .. slot[b] + S - 1``.  A start past ``L - S`` is
    clamped to it, as ``lax.dynamic_update_slice`` clamps."""
    B, _, L, _ = cache_kv.shape
    S = new.shape[2]
    start = slot.to(torch.int64).clamp(0, L - S)
    idx = start[:, None] + torch.arange(S, device=cache_kv.device)
    rows = torch.arange(B, device=cache_kv.device)[:, None]
    cache_kv[rows, :, idx] = new.transpose(1, 2).to(cache_kv.dtype)


# --- training, prefill and decode ------------------------------------------------

def self_attention(params, x, cfg, *, positions=None, causal: bool = True,
                   rope: bool = True):
    """Full-sequence attention with no cache (the train path and whisper's
    encoder): x (B, S, D) -> (B, S, D), RoPE at ``positions`` (default
    ``0 .. S-1``) unless ``rope`` is False, the window from
    ``cfg.window``."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q = _proj_q(params, x)
    k, v = _proj_kv(params, x)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # heads carry TP when they divide, else the sequence does (the
    # "attn_seq" rule): head_dim never shards here
    qt = constrain(q.transpose(1, 2), ATTN_AXES)
    kt = constrain(k.transpose(1, 2), KV_AXES)
    vt = constrain(v.transpose(1, 2), KV_AXES)
    out = ops.flash_attention(qt.contiguous(), kt.contiguous(),
                              vt.contiguous(), causal=causal,
                              window=cfg.window)
    out = constrain(out, ATTN_AXES)
    return _proj_out(params, out.transpose(1, 2), x.dtype)


def cross_attention(params, x, ctx_k, ctx_v, cfg):
    """x (B, S, D) against the context's keys and values (B, T, Hkv, hd)
    (:func:`project_context`): no mask, no window -> (B, S, D)."""
    q = _proj_q(params, x)
    out = ops.flash_attention(
        q.transpose(1, 2).contiguous(), ctx_k.transpose(1, 2).contiguous(),
        ctx_v.transpose(1, 2).contiguous(), causal=False, window=None)
    return _proj_out(params, out.transpose(1, 2), x.dtype)


def project_context(params, ctx, cfg):
    """The cross-attention keys and values (B, T, Hkv, hd) of a context
    stream (B, T, d_ctx)."""
    return _proj_kv(params, ctx)


def prefill_attention(params, x, cfg, cache, *, positions) -> tuple:
    """Causal attention over the whole prompt that also fills the cache
    from each request's first position (linear layout).

    x (B, S, D), positions (B, S).  Returns (out, cache).
    """
    q = _proj_q(params, x)
    k, v = _proj_kv(params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kt = k.transpose(1, 2)          # (B, Hkv, S, hd)
    vt = v.transpose(1, 2)
    slots = positions[:, 0]         # requests start at their first position
    _write_at(cache["k"], kt, slots)
    _write_at(cache["v"], vt, slots)
    qt = constrain(q.transpose(1, 2), ATTN_AXES)
    out = ops.flash_attention(
        qt.contiguous(), constrain(kt, KV_AXES).contiguous(),
        constrain(vt, KV_AXES).contiguous(), causal=True, window=cfg.window)
    out = constrain(out, ATTN_AXES)
    return _proj_out(params, out.transpose(1, 2), x.dtype), cache


def _attend_cached(params, q, kc, vc, cfg, x_dtype, mask=None):
    """One query a request, q (B, 1, H, hd), against keys and values in the
    cache layout (B, Hkv, L, hd): products of the cache-dtype operands with
    f32 results, the keys where ``mask`` (B, L) is False at -inf, the
    softmax in f32 and p cast to the cache dtype before the second product;
    then the output projection -> (B, 1, D)."""
    B = q.shape[0]
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q[:, 0].to(kc.dtype).reshape(B, cfg.n_kv_heads, rep, cfg.hd)
    s = matmul_f32(qg, kc.transpose(-1, -2)) / (cfg.hd ** 0.5)  # (B,G,r,L)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(vc.dtype)
    out = matmul_f32(p, vc)                           # (B, Hkv, rep, hd)
    out = out.reshape(B, 1, cfg.n_heads, cfg.hd).to(x_dtype)
    return _proj_out(params, out, x_dtype)


def decode_attention(params, x, cfg, cache, *, pos, ring: bool = False
                     ) -> tuple:
    """One-token decode: x (B, 1, D), per-request positions pos (B,).

    The scores and the output are products of the cache-dtype operands
    with f32 results (the reference's ``preferred_element_type``; see
    ``layers.matmul_f32``), the softmax in f32 and p cast to the cache
    dtype before the second product, as the reference does.
    """
    B = x.shape[0]
    L = cache["k"].shape[2]
    q = _proj_q(params, x)                            # (B, 1, H, hd)
    k_new, v_new = _proj_kv(params, x)                # (B, 1, Hkv, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)

    slot = (pos % L) if ring else pos
    _write_at(cache["k"], k_new.transpose(1, 2), slot)
    _write_at(cache["v"], v_new.transpose(1, 2), slot)

    idx = torch.arange(L, device=x.device)
    p_ = pos.to(torch.int64)[:, None]
    if ring:
        # slot s holds absolute position pos - ((pos - s) mod L), if >= 0
        kv_pos = p_ - torch.remainder(p_ - idx[None, :], L)
    else:
        kv_pos = idx[None, :].expand(B, L)
    mask = (kv_pos >= 0) & (kv_pos <= p_)
    if cfg.window is not None:
        mask &= (p_ - kv_pos) < cfg.window
    return _attend_cached(params, q, cache["k"], cache["v"], cfg, x.dtype,
                          mask), cache


def decode_cross_attention(params, x, cfg, ctx_k, ctx_v):
    """One-token cross-attention: x (B, 1, D) against the context's keys
    and values in the cache layout (B, Hkv, T, hd), with no mask and no
    cache write; ``decode_attention``'s arithmetic (cache-dtype operands,
    f32 results, the softmax in f32, p cast to the cache dtype)."""
    return _attend_cached(params, _proj_q(params, x), ctx_k, ctx_v, cfg,
                          x.dtype)
