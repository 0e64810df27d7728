"""The LM stack's models in PyTorch: the dense family (danube, yi, granite,
qwen), the MoE family (llama4-scout, moonshot), the pure Mamba-1 ssm
family (falcon-mamba) and zamba2 (hybrid Mamba-2 + shared attention), for
training (forward and loss) and serving (prefill and decode)."""

from .model_zoo import Model, build  # noqa: F401
