"""Public model API (``repro/models/model_zoo.py``): ``build(cfg, device=)``
gives a ``Model`` with ``init``, ``init_master``, ``abstract_params``,
``param_axes``, ``param_count``, ``active_param_count``, ``forward``,
``loss``, ``cache_spec``, ``init_cache``, ``prefill`` and
``decode_step``; ``input_specs``, ``materialize_inputs``
and ``batch_axes`` describe and draw a workload shape's inputs (the
modality frontends are stubs: whisper takes precomputed frame embeddings,
the vision arch precomputed patch embeddings).

A ``Model`` runs on one device, the card unless the caller names the CPU
(``repro_torch.device``).  Its serving parameters are a nested dict of
tensors in the compute dtype on that device: ``init`` draws them from a
``torch.Generator`` and ``load`` takes the reference's (or any) f32
parameters across, each cast once.  Training keeps the parameters in the
param dtype (the f32 master, ``init_master``); ``forward`` and ``loss``
cast them on every call, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.partition import local_tree

from . import layers, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    param_specs: Any                    # P-tree
    device: torch.device

    # ---- parameters -------------------------------------------------
    def init(self, generator: torch.Generator) -> Any:
        """Parameters drawn from ``generator`` (on its device, in the
        param dtype), moved to the model's device and cast to the compute
        dtype leaf by leaf."""
        return layers.materialize(generator, self.param_specs,
                                  device=self.device, dtype=self.cfg.cdtype)

    def init_master(self, generator: torch.Generator) -> Any:
        """Parameters drawn from ``generator`` as :meth:`init` draws them,
        kept in the param dtype (the f32 master that training updates)."""
        return layers.materialize(generator, self.param_specs,
                                  device=self.device)

    def load(self, params: Any) -> Any:
        """``params`` on the model's device in the compute dtype: the one
        cast the port makes (leaves already there are kept, not copied)."""
        return transformer.cast_params(
            layers.tree_map(lambda t: t.to(self.device), params), self.cfg)

    def abstract_params(self) -> Any:
        """The parameters' shapes and dtypes as ``meta`` tensors (no
        memory)."""
        return layers.abstract(self.param_specs)

    def param_axes(self) -> Any:
        """The parameters' logical axes (feed to ``repro_torch.sharding``)."""
        return layers.axes_tree(self.param_specs)

    def param_count(self) -> int:
        return layers.param_count(self.param_specs)

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: ``top_k`` of the
        ``n_experts`` experts a layer)."""
        total = self.param_count()
        cfg = self.cfg
        if cfg.moe is None:
            return total
        m = cfg.moe
        expert_p = 3 * cfg.d_model * m.d_ff * m.n_experts * cfg.n_layers
        return total - expert_p + expert_p * m.top_k // m.n_experts

    # ---- compute ----------------------------------------------------
    def forward(self, params, batch) -> torch.Tensor:
        """Teacher-forced logits (B, S, vocab) f32."""
        return transformer.forward(params, batch, self.cfg)[0]

    def loss(self, params, batch):
        """(loss, {"ce", "moe_aux"}) of ``transformer.loss_fn``."""
        return transformer.loss_fn(params, batch, self.cfg)

    # prefill and decode take plain or placed trees
    # (``sharding.partition.distribute_tree`` on a one-device mesh) and
    # run on their local tensors; the caches are written in place, so a
    # placed cache comes back as it was given, holding the new entries.
    def prefill(self, params, batch, cache, *, positions=None):
        logits, _ = transformer.prefill(
            local_tree(params), local_tree(batch), self.cfg,
            local_tree(cache), positions=local_tree(positions))
        return logits, cache

    def decode_step(self, params, token, cache, pos, *, ring: bool = False):
        logits, _ = transformer.decode_step(
            local_tree(params), local_tree(token), self.cfg,
            local_tree(cache), local_tree(pos), ring=ring)
        return logits, cache

    # ---- caches -----------------------------------------------------
    def cache_spec(self, batch: int, max_len: int, *, ring: bool = False):
        """(``meta`` tree, logical-axes tree) of the decode cache that
        :meth:`init_cache` allocates."""
        return transformer.cache_spec(self.cfg, batch, max_len, ring=ring)

    def init_cache(self, batch: int, max_len: int, *, ring: bool = False):
        return transformer.init_cache(self.cfg, batch, max_len, ring=ring,
                                      device=self.device)


def build(cfg, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (the card when None; raises on a
    host without one)."""
    return Model(cfg=cfg, param_specs=transformer.param_specs(cfg),
                 device=resolve_device(device))


# --- inputs of a workload shape -------------------------------------------------

def batch_axes(cfg, kind: str) -> Any:
    """Logical axes of each batch input (the reference's sharding rules'
    names, kept as plain data)."""
    if kind == "decode":
        return {"token": ("batch",), "pos": ("batch",)}
    axes = {"tokens": ("batch", "seq")}
    if kind == "train":
        axes["targets"] = ("batch", "seq")
    if cfg.family == "vlm":
        axes["image_embeds"] = ("batch", "img_seq", None)
    if cfg.family == "encdec":
        axes["frames"] = ("batch", "frames", None)
    return axes


def input_specs(cfg, shape) -> dict:
    """``(shape, dtype)`` of each input of one workload shape
    (``configs.ShapeSpec``), as ``transformer.cache_spec`` gives them:

    * train:   {tokens, targets [, image_embeds | frames]}
    * prefill: {tokens [, image_embeds | frames]}
    * decode:  {token, pos}  (the cache's come from ``cache_spec``)
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": ((B,), torch.int32), "pos": ((B,), torch.int32)}
    out = {"tokens": ((B, S), torch.int32)}
    if shape.kind == "train":
        out["targets"] = ((B, S), torch.int32)
    if cfg.family == "vlm":
        out["image_embeds"] = ((B, cfg.n_img_tokens, cfg.d_vision),
                               cfg.cdtype)
    if cfg.family == "encdec":
        out["frames"] = ((B, cfg.n_frames, cfg.d_model), cfg.cdtype)
    return out


def materialize_inputs(generator: torch.Generator, cfg, shape) -> dict:
    """Random inputs matching :func:`input_specs`, drawn from ``generator``
    on its device in sorted-key order: integers in [0, vocab) for
    ``tokens``, ``targets`` and ``token`` and in [0, seq_len) otherwise
    (``pos``); floats ``0.02 * N(0, 1)`` cast to their dtype.  The draws
    are the port's own, not ``jax.random``'s."""
    out = {}
    for k, (shp, dt) in sorted(input_specs(cfg, shape).items()):
        if dt.is_floating_point:
            out[k] = (0.02 * torch.randn(shp, generator=generator,
                                         device=generator.device)).to(dt)
        else:
            hi = (cfg.vocab if k in ("tokens", "targets", "token")
                  else shape.seq_len)
            out[k] = torch.randint(0, hi, shp, generator=generator,
                                   dtype=dt, device=generator.device)
    return out
