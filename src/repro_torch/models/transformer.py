"""The stacked decoder for serving (``repro/models/transformer.py``).

A model is a *pattern* of sub-blocks repeated ``n_super`` times.  The
reference runs the repeats as one ``lax.scan`` over stacked parameters;
here a Python loop takes layer ``i`` as the view ``leaf[i]`` of the same
stacked leaves.  Sub-block kinds:

  attn     pre-norm self-attention (+RoPE, causal, optional sliding window,
           optional qkv biases; GQA, MQA or MHA)
  mlp      pre-norm MLP (SwiGLU, or GELU with biases)
  moe      pre-norm mixture-of-experts FFN (``moe.py``)
  cross    pre-norm cross-attention against a context stream (vlm, encdec)
  mamba1   pre-norm Mamba-1 block (the chunked selective scan)
  mamba2   pre-norm Mamba-2 block
  (zamba2's shared attention block is one set of parameters, applied after
   every superblock with a cache entry of its own per application)

Patterns: dense ``("attn", "mlp") x n_layers``; moe ``("attn", "moe") x
n_layers``; vlm ``("attn", "mlp") x (cross_every - 1) + ("cross", "mlp")``
x ``n_layers / cross_every``; encdec ``("attn", "cross", "mlp") x
n_layers`` plus an encoder stack (:func:`encode`); ssm ``("mamba1",) x
n_layers``; hybrid ``("mamba2",) x share_every [+ shared block] x
n_super`` plus a tail without the shared block.  The context stream of a
cross layer is the adapted image embeddings (vlm) or the encoder's
states (encdec), made once a pass by :func:`_context_stream`.  Three
modes share the sub-block code: train (the whole sequence, no cache:
``forward_hidden``, ``forward``, ``loss_fn``), prefill (the whole prompt,
fills the caches from the request offsets, and each cross layer's
context keys and values) and decode (one token per request at
per-request positions; a cross layer reads its cached context).  Every
pass takes the reference's ``moe_strategy`` (``moe.apply_moe``); each MoE
sub-block appends its load-balance loss to the pass's ``moe_aux`` list,
which ``forward_hidden`` sums and prefill and decode drop.  Caches are
updated in place.  In training each stacked leaf is unbound once a call,
and with ``cfg.remat`` each superblock and each encoder block runs under
``torch.utils.checkpoint`` (recomputed in the backward), as the reference
remats each scan step.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import constrain

from . import attention as attn
from . import layers
from . import moe as moe_lib
from . import ssm as ssm_lib


# --- patterns ------------------------------------------------------------

def pattern_for(cfg) -> tuple[tuple[str, ...], int, tuple[str, ...], int]:
    """(pattern, n_super, tail_pattern, n_tail)."""
    fam = cfg.family
    if fam == "dense":
        return ("attn", "mlp"), cfg.n_layers, (), 0
    if fam == "moe":
        return ("attn", "moe"), cfg.n_layers, (), 0
    if fam == "vlm":
        k = cfg.cross_every
        assert cfg.n_layers % k == 0, (cfg.n_layers, k)
        pat = ("attn", "mlp") * (k - 1) + ("cross", "mlp")
        return pat, cfg.n_layers // k, (), 0
    if fam == "encdec":
        return ("attn", "cross", "mlp"), cfg.n_layers, (), 0
    if fam == "ssm":
        return (cfg.ssm.kind,), cfg.n_layers, (), 0
    if fam == "hybrid":
        k = cfg.share_every
        n_super, tail = divmod(cfg.n_layers, k)
        return ("mamba2",) * k, n_super, ("mamba2",) * tail, tail
    raise ValueError(f"unknown family {fam!r}")


def _block_spec(cfg, kind: str) -> Any:
    d = cfg.d_model
    if kind == "attn":
        return {"norm": layers.norm_spec(d, cfg.norm),
                "attn": attn.self_attn_spec(cfg)}
    if kind == "mlp":
        return {"norm": layers.norm_spec(d, cfg.norm),
                "mlp": layers.mlp_spec(d, cfg.d_ff, cfg.act)}
    if kind == "moe":
        return {"norm": layers.norm_spec(d, cfg.norm),
                "moe": moe_lib.moe_spec(cfg)}
    if kind == "cross":
        return {"norm": layers.norm_spec(d, cfg.norm),
                "attn": attn.cross_attn_spec(cfg)}
    if kind == "mamba1":
        return {"norm": layers.norm_spec(d, cfg.norm),
                "ssm": ssm_lib.mamba1_spec(cfg)}
    if kind == "mamba2":
        return {"norm": layers.norm_spec(d, cfg.norm),
                "ssm": ssm_lib.mamba2_spec(cfg)}
    raise ValueError(f"unknown sub-block {kind!r}")


def _shared_attn_cfg(cfg):
    """Zamba2 shared block: its own head geometry on the same d_model."""
    return cfg.replace(
        n_heads=cfg.shared_attn_heads, n_kv_heads=cfg.shared_attn_heads,
        head_dim=cfg.d_model // cfg.shared_attn_heads, window=None,
        qkv_bias=False,
    )


def param_specs(cfg) -> Any:
    pattern, n_super, tail, n_tail = pattern_for(cfg)
    spec: dict = {
        "embed": layers.embed_spec(cfg.vocab, cfg.d_model,
                                   tie=cfg.tie_embeddings),
        "final_norm": layers.norm_spec(cfg.d_model, cfg.norm),
        "blocks": layers.stack(
            {f"{i}_{k}": _block_spec(cfg, k) for i, k in enumerate(pattern)},
            n_super,
        ),
    }
    if n_tail:
        spec["tail"] = layers.stack(
            {f"{i}_{k}": _block_spec(cfg, k) for i, k in enumerate(tail)},
            n_tail,
        )
    if cfg.family == "hybrid":
        sc = _shared_attn_cfg(cfg)
        spec["shared"] = {
            "norm": layers.norm_spec(cfg.d_model, cfg.norm),
            "attn": attn.self_attn_spec(sc),
            "mlp_norm": layers.norm_spec(cfg.d_model, cfg.norm),
            "mlp": layers.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act),
        }
    if cfg.family == "vlm":
        spec["adapter"] = {
            "w": layers.P((cfg.d_vision, cfg.d_model), ("embed", "embed")),
            "b": layers.P((cfg.d_model,), ("embed",), init="zeros"),
        }
    if cfg.family == "encdec":
        spec["encoder"] = {
            "blocks": layers.stack(
                {"0_attn": _block_spec(cfg, "attn"),
                 "1_mlp": _block_spec(cfg, "mlp")},
                cfg.encoder_layers,
            ),
            "final_norm": layers.norm_spec(cfg.d_model, cfg.norm),
        }
    return spec


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree: a view of every leaf, no copy."""
    return layers.tree_map(lambda t: t[i], tree)


# --- sub-block application ---------------------------------------------------

def _apply_block(kind: str, bp, x, cfg, ctx, cache):
    """One sub-block; its cache entry (views) is updated in place.  In the
    train mode there is no cache (``cache`` is None)."""
    h = layers.apply_norm(bp["norm"], x, cfg.norm, cfg.norm_eps)
    train = ctx["mode"] == "train"
    if kind == "attn":
        if train:
            y = attn.self_attention(bp["attn"], h, cfg,
                                    positions=ctx["positions"], causal=True)
        elif ctx["mode"] == "prefill":
            y, _ = attn.prefill_attention(bp["attn"], h, cfg, cache,
                                          positions=ctx["positions"])
        else:
            y, _ = attn.decode_attention(bp["attn"], h, cfg, cache,
                                         pos=ctx["pos"], ring=ctx["ring"])
        return x + y
    if kind == "mlp":
        return x + layers.apply_mlp(bp["mlp"], h, cfg.act)
    if kind == "moe":
        y, aux = moe_lib.apply_moe(bp["moe"], h, cfg,
                                   strategy=ctx["moe_strategy"])
        ctx["moe_aux"].append(aux)
        return x + y
    if kind == "cross":
        if ctx["mode"] == "decode":
            return x + attn.decode_cross_attention(bp["attn"], h, cfg,
                                                   cache["ck"], cache["cv"])
        ck, cv = attn.project_context(bp["attn"], ctx["ctx_stream"], cfg)
        if not train:
            # the cache layout (B, Hkv, T, hd), as cache_spec gives it; the
            # reference replaces the entry, the port's caches are written
            # in place
            cache["ck"].copy_(ck.transpose(1, 2))
            cache["cv"].copy_(cv.transpose(1, 2))
        return x + attn.cross_attention(bp["attn"], h, ck, cv, cfg)
    if kind in ("mamba1", "mamba2"):
        fwd = (ssm_lib.mamba1_forward if kind == "mamba1"
               else ssm_lib.mamba2_forward)
        state = cache if ctx["mode"] == "decode" else None
        y, new_state = fwd(bp["ssm"], h, cfg, state=state)
        if not train:
            cache["conv"].copy_(new_state["conv"])
            cache["ssm"].copy_(new_state["ssm"])
        return x + y
    raise ValueError(f"unknown sub-block {kind!r}")


def _apply_shared_attn(sp, x, cfg, ctx, cache):
    """Zamba2 tied transformer block (attention + MLP), own cache entry."""
    sc = _shared_attn_cfg(cfg)
    h = layers.apply_norm(sp["norm"], x, cfg.norm, cfg.norm_eps)
    if ctx["mode"] == "train":
        y = attn.self_attention(sp["attn"], h, sc,
                                positions=ctx["positions"], causal=True)
    elif ctx["mode"] == "prefill":
        y, _ = attn.prefill_attention(sp["attn"], h, sc, cache,
                                      positions=ctx["positions"])
    else:
        y, _ = attn.decode_attention(sp["attn"], h, sc, cache,
                                     pos=ctx["pos"], ring=False)
    x = x + y
    h = layers.apply_norm(sp["mlp_norm"], x, cfg.norm, cfg.norm_eps)
    return x + layers.apply_mlp(sp["mlp"], h, cfg.act)


def _run_stack(cfg, x, stacked_params, stacked_cache, ctx, pattern, n,
               shared_params=None):
    """The superblocks in order; layer i reads and writes row i of every
    stacked cache leaf."""
    for i in range(n):
        bp = _layer(stacked_params, i)
        for j, kind in enumerate(pattern):
            key = f"{j}_{kind}"
            ce = (_layer(stacked_cache[key], i)
                  if key in stacked_cache else None)
            x = _apply_block(kind, bp[key], x, cfg, ctx, ce)
        if shared_params is not None:
            x = _apply_shared_attn(shared_params, x, cfg, ctx,
                                   _layer(stacked_cache["shared"], i))
    return x


def _unstack(tree: Any, n: int) -> list:
    """The ``n`` layers of a stacked tree, every leaf unbound once: the
    backward of ``unbind`` is one ``stack``, where indexing each layer
    (:func:`_layer`) would add a zero-filled gradient of the whole stacked
    leaf a layer."""
    rows = layers.tree_map(lambda t: t.unbind(0), tree)
    return [layers.tree_map(lambda r: r[i], rows) for i in range(n)]


def _train_stack(cfg, x, stacked_params, ctx, pattern, n,
                 shared_params=None):
    """The superblocks of one stack in the train mode, each under
    ``torch.utils.checkpoint`` when ``cfg.remat`` is set: only its inputs
    are kept (x, the layer's parameters and the context stream, passed as
    an argument so that the recompute reads the same tensor), and its
    forward runs again in the backward."""
    def superblock(x, bp, ctx_stream):
        c = {**ctx, "ctx_stream": ctx_stream}
        for j, kind in enumerate(pattern):
            x = _apply_block(kind, bp[f"{j}_{kind}"], x, cfg, c, None)
        if shared_params is not None:
            x = _apply_shared_attn(shared_params, x, cfg, c, None)
        return x

    for bp in _unstack(stacked_params, n):
        if cfg.remat:
            x = checkpoint(superblock, x, bp, ctx["ctx_stream"],
                           use_reentrant=False)
        else:
            x = superblock(x, bp, ctx["ctx_stream"])
    return x


# --- caches ---------------------------------------------------------------------

def cache_spec(cfg, batch: int, max_len: int, *, ring: bool = False
               ) -> tuple[dict, dict]:
    """(``meta`` tree, logical-axes tree) of the decode cache, in the
    reference's layout: each entry stacked over the layers of its stack
    (axis ``layers``); the tail has no shared entry."""
    pattern, n_super, tail, n_tail = pattern_for(cfg)

    n_ctx = cfg.n_img_tokens if cfg.family == "vlm" else cfg.n_frames

    def entry(kind):
        if kind == "attn":
            return attn.cache_spec(cfg, batch, max_len, ring=ring)
        if kind == "cross":     # the context's keys and values
            kv = (batch, cfg.n_kv_heads, n_ctx, cfg.hd)
            axes = ("batch", "kv_heads", "img_seq", "head_dim")
            return ({k: torch.empty(kv, dtype=cfg.cdtype, device="meta")
                     for k in ("ck", "cv")}, {"ck": axes, "cv": axes})
        if kind == "mamba1":
            return ssm_lib.mamba1_state_spec(cfg, batch)
        if kind == "mamba2":
            return ssm_lib.mamba2_state_spec(cfg, batch)
        return None

    def build(pat, n, shared):
        spec, axes = {}, {}
        for i, kind in enumerate(pat):
            e = entry(kind)
            if e is not None:
                spec[f"{i}_{kind}"], axes[f"{i}_{kind}"] = e
        if shared:
            spec["shared"], axes["shared"] = attn.cache_spec(
                _shared_attn_cfg(cfg), batch, max_len, ring=False)
        return (layers.tree_map(lambda m: m.new_empty((n,) + m.shape), spec),
                layers.tree_map(lambda a: ("layers",) + a, axes))

    hybrid = cfg.family == "hybrid"
    spec, axes = {}, {}
    spec["blocks"], axes["blocks"] = build(pattern, n_super, hybrid)
    if n_tail:
        spec["tail"], axes["tail"] = build(tail, n_tail, False)
    return spec, axes


def init_cache(cfg, batch: int, max_len: int, *, ring: bool = False,
               device=None) -> dict:
    spec, _ = cache_spec(cfg, batch, max_len, ring=ring)
    return layers.tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                                  device=device), spec)


# --- the encoder (whisper) and the context stream ------------------------------

def encode(params, frames, cfg):
    """Audio frames (B, T, d_model) -> encoder states (B, T, d_model) in
    the compute dtype: the frames plus the sinusoidal table, then the
    encoder blocks (pre-norm non-causal self-attention without RoPE, then
    the MLP), then the final norm.  The frontend is a stub: the inputs
    are precomputed frame embeddings.  With ``cfg.remat`` each block runs
    under ``torch.utils.checkpoint`` (the reference's remat policy is a
    memory choice; the values are the same)."""
    B, T, D = frames.shape
    x = frames.to(cfg.cdtype) + torch.from_numpy(
        layers.sinusoidal_positions(T, D)).to(frames.device,
                                               cfg.cdtype)[None]
    positions = torch.arange(T, device=frames.device).expand(B, T)
    enc = params["encoder"]

    def block(x, bp):
        h = layers.apply_norm(bp["0_attn"]["norm"], x, cfg.norm,
                              cfg.norm_eps)
        x = x + attn.self_attention(bp["0_attn"]["attn"], h, cfg,
                                    positions=positions, causal=False,
                                    rope=False)
        h = layers.apply_norm(bp["1_mlp"]["norm"], x, cfg.norm, cfg.norm_eps)
        return x + layers.apply_mlp(bp["1_mlp"]["mlp"], h, cfg.act)

    for bp in _unstack(enc["blocks"], cfg.encoder_layers):
        if cfg.remat:
            x = checkpoint(block, x, bp, use_reentrant=False)
        else:
            x = block(x, bp)
    return layers.apply_norm(enc["final_norm"], x, cfg.norm, cfg.norm_eps)


def _context_stream(params, cfg, batch_inputs):
    """The cross-attention context: the adapted image embeddings (vlm) or
    the encoder's states (encdec); None for the other families."""
    if cfg.family == "vlm":
        img = batch_inputs["image_embeds"].to(cfg.cdtype)
        a = params["adapter"]
        return torch.einsum("btd,de->bte", img,
                            a["w"].to(cfg.cdtype)) + a["b"].to(cfg.cdtype)
    if cfg.family == "encdec":
        return encode(params, batch_inputs["frames"], cfg)
    return None


# --- top-level passes -----------------------------------------------------------

def cast_params(params, cfg):
    """The compute-dtype view of the parameters.  The reference casts on
    every call.  For serving the port casts once, when the model is built
    or loaded (``Model.load``), so here ``.to`` finds each leaf in the
    compute dtype already and returns it as it is, with no copy; in
    training the leaves are the f32 master and ``.to`` is the
    differentiable cast, made on every call as the reference makes it."""
    return layers.tree_map(
        lambda p: p.to(cfg.cdtype) if p.is_floating_point() else p, params)


def _stacks(params, cache, cfg, x, ctx):
    pattern, n_super, tail, n_tail = pattern_for(cfg)
    x = _run_stack(cfg, x, params["blocks"], cache["blocks"], ctx, pattern,
                   n_super, params.get("shared"))
    if n_tail:
        x = _run_stack(cfg, x, params["tail"], cache["tail"], ctx, tail,
                       n_tail)
    return layers.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)


def _make_ctx(mode, moe_strategy, **kw) -> dict:
    return {"mode": mode, "moe_strategy": moe_strategy, "moe_aux": [], **kw}


def prefill(params, batch_inputs, cfg, cache, *, positions=None,
            moe_strategy="ep"):
    """Fill the caches for a batch of prompts; returns (last logits f32
    (B, vocab), cache)."""
    params = cast_params(params, cfg)
    tokens = batch_inputs["tokens"]
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = layers.embed_tokens(params["embed"], tokens, cfg.cdtype)
    x = constrain(x, ("batch", "seq", "embed_act"))
    ctx = _make_ctx("prefill", moe_strategy, positions=positions,
                    ctx_stream=_context_stream(params, cfg, batch_inputs))
    x = _stacks(params, cache, cfg, x, ctx)
    logits = layers.logits_out(params["embed"], x[:, -1:])
    return logits[:, 0], cache


def decode_step(params, token, cfg, cache, pos, *, ring: bool = False,
                moe_strategy="ep"):
    """One token per request.  token: (B,), pos: (B,).  Returns (logits f32
    (B, vocab), cache)."""
    params = cast_params(params, cfg)
    x = layers.embed_tokens(params["embed"], token[:, None], cfg.cdtype)
    x = constrain(x, ("batch", None, None))
    ctx = _make_ctx("decode", moe_strategy, pos=pos, ring=ring)
    x = _stacks(params, cache, cfg, x, ctx)
    logits = layers.logits_out(params["embed"], x)
    return logits[:, 0], cache


def forward_hidden(params, batch_inputs, cfg, *, moe_strategy="ep"):
    """Final hidden states (B, S, D) before the unembedding, and the aux
    metrics: ``moe_aux``, the sum over the MoE layers of each layer's
    load-balance loss (0 for a family without experts)."""
    params = cast_params(params, cfg)
    tokens = batch_inputs["tokens"]
    B, S = tokens.shape
    pattern, n_super, tail, n_tail = pattern_for(cfg)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = layers.embed_tokens(params["embed"], tokens, cfg.cdtype)
    x = constrain(x, ("batch", "seq", "embed_act"))
    ctx = _make_ctx("train", moe_strategy, positions=positions,
                    ctx_stream=_context_stream(params, cfg, batch_inputs))
    x = _train_stack(cfg, x, params["blocks"], ctx, pattern, n_super,
                     params.get("shared"))
    if n_tail:
        x = _train_stack(cfg, x, params["tail"], ctx, tail, n_tail)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    x = constrain(x, ("batch", "seq", "embed_act"))
    aux = (torch.stack(ctx["moe_aux"]).sum() if ctx["moe_aux"] else
           torch.zeros((), dtype=torch.float32, device=x.device))
    return x, {"moe_aux": aux}


def forward(params, batch_inputs, cfg, *, moe_strategy="ep"):
    """Teacher-forced logits (B, S, vocab f32) and the aux metrics."""
    x, aux = forward_hidden(params, batch_inputs, cfg,
                            moe_strategy=moe_strategy)
    return layers.logits_out(params["embed"], x), aux


# --- loss -------------------------------------------------------------------------

def _ce_chunks(S: int, target: int = 8) -> int:
    """Largest divisor of S that is <= target (keeps seq chunks exact)."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def loss_fn(params, batch, cfg, *, moe_strategy="ep", aux_coef: float = 0.01,
            ce_chunks: int = 8):
    """Next-token cross-entropy, computed in ``_ce_chunks`` sequence chunks
    (the unembedding is the largest activation of a step), masked by
    ``batch["loss_mask"]`` when given.  Returns (loss + aux_coef * moe_aux,
    {"ce", "moe_aux"})."""
    x, aux = forward_hidden(params, batch, cfg, moe_strategy=moe_strategy)
    targets = batch["targets"]
    B, S = targets.shape
    mask = batch.get("loss_mask")
    mask = (torch.ones((B, S), dtype=torch.float32, device=x.device)
            if mask is None else mask.to(torch.float32))
    nc = _ce_chunks(S, ce_chunks)
    Q = S // nc
    total_nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        logits = layers.logits_out(params["embed"], x[:, sl])
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[:, sl, None].to(torch.int64))[..., 0]
        total_nll = total_nll + (nll * mask[:, sl]).sum()
    loss = total_nll / mask.sum().clamp_min(1.0)
    return loss + aux_coef * aux["moe_aux"], {"ce": loss,
                                               "moe_aux": aux["moe_aux"]}
