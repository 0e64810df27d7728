"""TrainState: parameters, optimizer moments and step
(``repro/train/state.py``, without the sharding specs, which wait with
``sharding/``: ROADMAP.md §1 item 7)."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.layers import tree_items

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
