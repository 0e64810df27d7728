"""The LM stack's models in PyTorch: the dense family (danube, yi, granite,
qwen), the MoE family (llama4-scout, moonshot), the pure Mamba-1 ssm
family (falcon-mamba), zamba2 (hybrid Mamba-2 + shared attention), the
VLM (llama-3.2-vision, cross-attention to patch embeddings) and the
encoder-decoder (whisper), for training (forward and loss) and serving
(prefill and decode)."""

from .model_zoo import Model, build  # noqa: F401
