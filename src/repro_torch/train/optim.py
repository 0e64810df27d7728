"""AdamW with warmup + cosine schedule and global-norm clipping
(``repro/train/optim.py``), on tensors.

The moments are trees shaped like the parameters.  Everything a step
reads stays on the device: the step is a device tensor, the learning
rate, the clip scale and the bias corrections are computed there, and
nothing is read back to the host.  A division by a constant divides by a
tensor on the operand's device (:func:`_div`): a CUDA tensor divided by a
Python number is multiplied by its reciprocal, two roundings where the
CPU makes one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.layers import tree_items, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    floor_ratio: float = 0.1       # final lr = floor_ratio * peak
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _const(c: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), c, dtype=torch.float32, device=like.device)


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` rounded once on either device."""
    return t / _const(c, t)


def lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (a device tensor), f32 on its device."""
    step = step.to(torch.float32)
    warm = _div(cfg.peak_lr * step, max(cfg.warmup_steps, 1))
    t = _div(step - cfg.warmup_steps,
             max(cfg.decay_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.peak_lr * (
        cfg.floor_ratio
        + (1 - cfg.floor_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any) -> dict:
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32."""
    total = None
    for _, leaf in tree_items(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(grads: Any, opt_state: dict, params: Any,
                 step: torch.Tensor, cfg: AdamWConfig):
    """One AdamW step, clipped to ``cfg.clip_norm`` by the global norm.
    Returns (new_params, new_opt_state, {"grad_norm", "lr"}); the inputs
    are left as they are."""
    gnorm = global_norm(grads)
    scale = torch.minimum(
        _const(1.0, gnorm),
        _const(cfg.clip_norm, gnorm) / torch.maximum(gnorm,
                                                     _const(1e-12, gnorm)))
    t = step.to(torch.float32) + 1.0
    lr = lr_at(step, cfg)
    c1 = 1.0 - torch.pow(_const(cfg.b1, t), t)
    c2 = 1.0 - torch.pow(_const(cfg.b2, t), t)

    def upd(p, g, m, v):
        gf = (g * scale).to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        new_p = p - lr * (
            (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            + cfg.weight_decay * p)
        return new_p.to(p.dtype), m, v

    new = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_p, new_m, new_v = (tree_map(lambda n, i=i: n[i], new)
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}
