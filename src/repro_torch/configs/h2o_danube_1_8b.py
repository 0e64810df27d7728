"""h2o-danube-1.8b [dense]: 24L, d_model=2560, 32H (GQA kv=8), d_ff=6912,
vocab=32000.  [arXiv:2401.16818; hf]

Llama + Mistral mix with sliding-window attention (window=4096): the ring
KV cache is O(window) at any position.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    window=4096,              # Mistral-style SWA
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    window=16, remat=False,
)
