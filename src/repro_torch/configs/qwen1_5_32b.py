"""qwen1.5-32b [dense]: 64L, d_model=5120, 40H (kv=40, full MHA),
d_ff=27392, vocab=152064.  [hf:Qwen/Qwen1.5-0.5B; hf]

QKV bias per the Qwen lineage.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    remat=False,
)
