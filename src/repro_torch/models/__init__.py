"""The LM stack's models in PyTorch: zamba2 (hybrid Mamba-2 + shared
attention) and the dense family, for training (forward and loss) and
serving (prefill and decode)."""

from .model_zoo import Model, build  # noqa: F401
