"""Public model API (``repro/models/model_zoo.py``): ``build(cfg, device=)``
gives a ``Model`` with ``init``, ``init_master``, ``param_count``,
``active_param_count``, ``forward``, ``loss``, ``init_cache``,
``prefill`` and ``decode_step``.

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

    def prefill(self, params, batch, cache, *, positions=None):
        return transformer.prefill(params, batch, self.cfg, cache,
                                   positions=positions)

    def decode_step(self, params, token, cache, pos, *, ring: bool = False):
        return transformer.decode_step(params, token, self.cfg, cache, pos,
                                       ring=ring)

    # ---- caches -----------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, ring: bool = False):
        return transformer.init_cache(self.cfg, batch, max_len, ring=ring,
                                      device=self.device)


def build(cfg, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (the card when None; raises on a
    host without one)."""
    return Model(cfg=cfg, param_specs=transformer.param_specs(cfg),
                 device=resolve_device(device))
