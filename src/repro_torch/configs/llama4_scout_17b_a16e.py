"""llama4-scout-17b-a16e [moe]: 48L, d_model=5120, 40H (GQA kv=8),
expert d_ff=8192, vocab=202048, MoE 16 experts top-1.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Divergences (DESIGN.md §7): assignment spec wins over vendor quirks — every
layer is MoE (vendor interleaves dense layers), no shared expert, RoPE on
all layers (vendor uses NoPE on some).  16 experts on a 16-way model axis =
exactly 1 expert per chip (the cleanest EP case).
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,                # == expert d_ff (informational for dense path)
    vocab=202048,
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192),
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    moe=MoEConfig(n_experts=4, top_k=1, d_ff=128), remat=False,
)
