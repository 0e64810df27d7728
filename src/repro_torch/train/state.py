"""TrainState: parameters, optimizer moments and step, with sharding specs
(``repro/train/state.py``).  ``distribute_tree(state, shardings)`` places
a state on a one-device mesh (``jax.device_put``), with no copy."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.layers import tree_items
from repro_torch.sharding import AxisRules, DEFAULT_RULES, shardings_for_tree
from repro_torch.sharding.partition import distribute_tree  # noqa: F401

from .optim import adamw_init


class TrainState(NamedTuple):
    step: torch.Tensor         # () int32, on the parameters' device
    params: Any
    opt: Any                   # {"m": ..., "v": ...} like params
    err: Optional[Any] = None  # int8-compression error feedback: not ported


def init_train_state(params: Any, *, compression: bool = False
                     ) -> TrainState:
    """Step 0 with zero moments, on the device of the parameters."""
    if compression:
        raise NotImplementedError(
            "int8 error-feedback compression (train/compression.py) is not "
            "ported: it needs a multi-pod mesh and waits with sharding/ in "
            "ROADMAP.md §1 item 7")
    device = next(leaf for _, leaf in tree_items(params)).device
    return TrainState(torch.zeros((), dtype=torch.int32, device=device),
                      params, adamw_init(params), None)


def train_state_specs(model, *, compression: bool = False):
    """(abstract TrainState of ``meta`` tensors, axes TrainState-shaped
    tree)."""
    if compression:
        raise NotImplementedError(
            "the int8 error-feedback state (train/compression.py) is not "
            "ported: it waits with the collectives slice in ROADMAP.md §1 "
            "item 7")
    p_abs = model.abstract_params()
    p_axes = model.param_axes()
    abs_state = TrainState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        params=p_abs,
        opt={"m": p_abs, "v": p_abs},
        err=None,
    )
    axes_state = TrainState(
        step=(),
        params=p_axes,
        opt={"m": p_axes, "v": p_axes},
        err=None,
    )
    return abs_state, axes_state


def train_state_shardings(model, mesh, rules: AxisRules = DEFAULT_RULES, *,
                          compression: bool = False):
    """(abstract TrainState, its NamedSharding tree) on ``mesh``."""
    abs_state, axes_state = train_state_specs(model, compression=compression)
    shardings = shardings_for_tree(axes_state, abs_state, mesh, rules)
    return abs_state, shardings
