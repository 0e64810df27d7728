"""Training (``repro/train``): AdamW, the train state and the step
builders, on tensors, and the int8 error-feedback compression of the
cross-pod gradient reduction (``compression.py``), which all-gathers over
a ``ProcessGroup``.  The pod-compressed step that uses it,
``trainer.make_train_step_pod_compressed``, is not exported here, as in
the reference."""

from .optim import AdamWConfig, adamw_init, adamw_update, lr_at  # noqa: F401
from .state import (  # noqa: F401
    TrainState, distribute_tree, init_train_state, train_state_shardings,
    train_state_specs,
)
from .trainer import make_eval_step, make_train_step  # noqa: F401
from .compression import (  # noqa: F401
    CompressionState,
    compress_decompress,
    compressed_allreduce,
    compressed_allreduce_tree,
    init_compression,
)
