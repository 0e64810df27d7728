"""granite-34b [dense]: 88L, d_model=6144, 48H (MQA kv=1), d_ff=24576,
vocab=49152.  [arXiv:2405.04324; hf]

Code model with multi-query attention (one kv head for 48 query heads)
and the GPT-BigCode two-matrix GELU MLP with biases.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,             # MQA
    d_ff=24576,
    vocab=49152,
    act="gelu",               # GPT-BigCode 2-matrix MLP (34B total; SwiGLU
                              # would be 47B — vendor uses plain GELU)
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=256,
    remat=False,
)
