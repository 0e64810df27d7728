"""Training (``repro/train``): AdamW, the train state and the step
builders, on tensors.  The int8 error-feedback compression of the
cross-pod gradient reduction (``compression.py``) needs a multi-pod mesh
and waits with ``sharding/`` (ROADMAP.md §1 item 7)."""

from .optim import AdamWConfig, adamw_init, adamw_update, lr_at  # noqa: F401
from .state import TrainState, init_train_state  # noqa: F401
from .trainer import make_eval_step, make_train_step  # noqa: F401
