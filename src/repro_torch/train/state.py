"""TrainState: parameters, optimizer moments and step, with sharding specs
(``repro/train/state.py``).  ``distribute_tree(state, shardings)`` places
a state on a one-device mesh (``jax.device_put``), with no copy."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.layers import tree_items, tree_map
from repro_torch.sharding import AxisRules, DEFAULT_RULES, shardings_for_tree
from repro_torch.sharding.partition import distribute_tree  # noqa: F401

from .optim import adamw_init


class TrainState(NamedTuple):
    step: torch.Tensor         # () int32, on the parameters' device
    params: Any
    opt: Any                   # {"m": ..., "v": ...} like params
    err: Optional[Any] = None  # int8-compression error feedback (or None)


def init_train_state(params: Any, *, compression: bool = False
                     ) -> TrainState:
    """Step 0 with zero moments, on the device of the parameters; with
    ``compression``, zero f32 residuals (``err``) like the parameters,
    whatever their dtype."""
    device = next(leaf for _, leaf in tree_items(params)).device
    err = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params) if compression else None)
    return TrainState(torch.zeros((), dtype=torch.int32, device=device),
                      params, adamw_init(params), err)


def train_state_specs(model, *, compression: bool = False):
    """(abstract TrainState of ``meta`` tensors, axes TrainState-shaped
    tree).  ``err`` takes the parameters' specs, as the reference's does:
    the parameters' dtype, which is ``init_train_state``'s f32 under the
    configs' default ``param_dtype``."""
    p_abs = model.abstract_params()
    p_axes = model.param_axes()
    abs_state = TrainState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        params=p_abs,
        opt={"m": p_abs, "v": p_abs},
        err=p_abs if compression else None,
    )
    axes_state = TrainState(
        step=(),
        params=p_axes,
        opt={"m": p_axes, "v": p_axes},
        err=p_axes if compression else None,
    )
    return abs_state, axes_state


def train_state_shardings(model, mesh, rules: AxisRules = DEFAULT_RULES, *,
                          compression: bool = False):
    """(abstract TrainState, its NamedSharding tree) on ``mesh``."""
    abs_state, axes_state = train_state_specs(model, compression=compression)
    shardings = shardings_for_tree(axes_state, abs_state, mesh, rules)
    return abs_state, shardings
