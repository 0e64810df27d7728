"""Parameter specs and primitive layers shared by the ported architectures
(``repro/models/layers.py``).

A model is a nested dict of tensors plus plain functions, with the
reference's layout: the layers of a stack are stacked along a leading
axis, and layer ``i`` is the view ``t[i]`` of each leaf.  ``P`` describes a
parameter (shape, logical axes, init law); :func:`materialize` draws a
spec tree from an explicit ``torch.Generator``.  The draws are the port's
own: the same seed gives other values than ``jax.random``, so tests carry
the reference's parameters across with ``convert.lm_params_from_reference``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import torch_dtype


# --- parameter descriptors and trees -------------------------------------

@dataclasses.dataclass(frozen=True)
class P:
    """Declarative parameter: shape + logical axes + init law."""

    shape: tuple
    axes: tuple                  # logical axis names, len == len(shape)
    init: str = "normal"         # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev; default 1/sqrt(fan_in) for normal
    dtype: str = "float32"
    fan_in_dims: tuple = (0,)    # which dims count as fan-in for default scale

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, P)


def tree_items(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs of a nested dict, keys sorted at every level (the
    order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf over nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _leaf_init(gen: torch.Generator, p: P,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One leaf drawn from ``gen`` on its device, in ``dtype`` if given and
    the leaf is floating, else in the spec's dtype.  A stacked leaf (first
    axis ``layers``) is drawn one layer at a time in f32 and cast into its
    slice, so that drawing holds one layer's f32 values, never the whole
    stack's."""
    dtype = dtype if dtype is not None and torch_dtype(
        p.dtype).is_floating_point else torch_dtype(p.dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=gen.device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=gen.device)
    if p.init == "embed":
        scale = p.scale if p.scale is not None else 0.02
    else:  # normal with 1/sqrt(fan_in)
        fan_in = math.prod(p.shape[d] for d in p.fan_in_dims) or 1
        scale = p.scale if p.scale is not None else fan_in ** -0.5
    stacked = p.axes[:1] == ("layers",)
    out = torch.empty(p.shape, dtype=dtype, device=gen.device)
    for t in (out if stacked else (out,)):
        t.copy_(torch.randn(t.shape, generator=gen, dtype=torch.float32,
                            device=gen.device).mul_(scale))
    return out


def materialize(gen: torch.Generator, specs: Any, *, device=None,
                dtype: Optional[torch.dtype] = None) -> Any:
    """Draw a P-tree leaf by leaf (sorted-key order) from ``gen``, on the
    generator's device, casting floating leaves to ``dtype`` if given as
    they are drawn, then move each leaf to ``device`` before the next draw
    (so a full model never holds two copies)."""
    out: dict = {}
    for path, spec in tree_items(specs):
        t = _leaf_init(gen, spec, dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.to(device) if device is not None else t
    return out


def abstract(specs: Any) -> Any:
    """Shape-and-dtype stand-ins of a P-tree: ``meta`` tensors, no memory."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=torch_dtype(p.dtype),
                                          device="meta"), specs)


def axes_tree(specs: Any) -> Any:
    """Logical-axes tree of a P-tree (leaves are tuples; feed to the
    sharding rules)."""
    return tree_map(lambda p: p.axes, specs)


def stack(specs: Any, n: int, axis_name: str = "layers") -> Any:
    """Prepend a stacked-layer dim to every P in the tree."""
    def bump(p: P) -> P:
        return dataclasses.replace(
            p, shape=(n,) + p.shape, axes=(axis_name,) + p.axes,
            fan_in_dims=tuple(d + 1 for d in p.fan_in_dims))
    return tree_map(bump, specs)


def param_count(specs: Any) -> int:
    return int(sum(math.prod(p.shape) for _, p in tree_items(specs)))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result, as the reference's dots with
    ``preferred_element_type=f32`` give it from bf16 operands.

    The operands are upcast and multiplied in f32: a product of two bf16
    (or f16) values is exact in f32, so this is the f32-accumulated
    product, summed in the library's order.  A plain bf16 ``matmul`` would
    round the result to bf16.
    """
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


# --- primitive layers ----------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """In f32, cast back to x's dtype, then times ``w`` in x's dtype (the
    reference's rounding order)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The mean and the population variance (``jnp.var``'s, not torch's
    unbiased default) in f32, ``rsqrt(var + eps)``, cast back to x's
    dtype, then ``* w + b`` in x's dtype (the reference's rounding
    order)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * w.to(dt) + b.to(dt)


def norm_spec(d: int, kind: str = "rms") -> Any:
    if kind == "rms":
        return {"w": P((d,), ("norm",), init="ones")}
    return {"w": P((d,), ("norm",), init="ones"),
            "b": P((d,), ("norm",), init="zeros")}


def apply_norm(params: Any, x: torch.Tensor, kind: str = "rms",
               eps: float = 1e-5) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, params["w"], eps)
    return layer_norm(x, params["w"], params["b"], eps)


# --- rotary embeddings ---------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, f32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate (..., L, heads, head_dim) by per-position angles, in f32, then
    cast to x's dtype.  positions: (..., L) int absolute positions."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., L, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., L, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """Whisper's fixed sinusoidal table (n, d) f32: frequencies in f64 over
    ``max(half - 1, 1)`` steps, ``[sin, cos]``, then cast."""
    half = d // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    t = np.arange(n)[:, None] * freq[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


# --- MLP -----------------------------------------------------------------

def mlp_spec(d_model: int, d_ff: int, act: str = "silu") -> Any:
    if act == "silu":   # SwiGLU: gate + up + down
        return {
            "wi_gate": P((d_model, d_ff), ("embed", "mlp")),
            "wi_up": P((d_model, d_ff), ("embed", "mlp")),
            "wo": P((d_ff, d_model), ("mlp", "embed")),
        }
    if act != "gelu":
        raise ValueError(f"unknown act {act!r}")
    return {   # plain two-matrix MLP with biases (granite-34b, whisper)
        "wi": P((d_model, d_ff), ("embed", "mlp")),
        "bi": P((d_ff,), ("mlp",), init="zeros"),
        "wo": P((d_ff, d_model), ("mlp", "embed")),
        "bo": P((d_model,), ("embed",), init="zeros"),
    }


def apply_mlp(params: Any, x: torch.Tensor, act: str = "silu"
              ) -> torch.Tensor:
    """In x's dtype, in the reference's order.  SwiGLU: silu(x Wg) *
    (x Wu), then Wo.  GELU: gelu(x Wi + bi) with the tanh approximation
    (``jax.nn.gelu(approximate=True)``), then Wo, then + bo."""
    dt = x.dtype
    if act == "silu":
        g = torch.matmul(x, params["wi_gate"].to(dt))
        u = torch.matmul(x, params["wi_up"].to(dt))
        return torch.matmul(F.silu(g) * u, params["wo"].to(dt))
    h = torch.matmul(x, params["wi"].to(dt))
    h = F.gelu(h + params["bi"].to(dt), approximate="tanh")
    return torch.matmul(h, params["wo"].to(dt)) + params["bo"].to(dt)


# --- embeddings / logits -------------------------------------------------

def embed_spec(vocab: int, d_model: int, tie: bool = True) -> Any:
    spec = {"table": P((vocab, d_model), ("vocab", "embed"), init="embed")}
    if not tie:
        spec["unembed"] = P((d_model, vocab), ("embed", "vocab"),
                            init="embed")
    return spec


def embed_tokens(params: Any, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["table"][tokens.to(torch.int64)].to(dtype)


def logits_out(params: Any, x: torch.Tensor) -> torch.Tensor:
    """Final projection in x's dtype with an f32 result (:func:`matmul_f32`)."""
    if "unembed" in params:
        return matmul_f32(x, params["unembed"].to(x.dtype))
    return matmul_f32(x, params["table"].to(x.dtype).T)      # tied
