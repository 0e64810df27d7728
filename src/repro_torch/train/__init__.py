"""Training (``repro/train``): AdamW, the train state and the step
builders, on tensors.  The int8 error-feedback compression of the
cross-pod gradient reduction (``compression.py``) needs a multi-pod mesh
and waits with the collectives slice (ROADMAP.md §1 item 7)."""

from .optim import AdamWConfig, adamw_init, adamw_update, lr_at  # noqa: F401
from .state import (  # noqa: F401
    TrainState, distribute_tree, init_train_state, train_state_shardings,
    train_state_specs,
)
from .trainer import make_eval_step, make_train_step  # noqa: F401
