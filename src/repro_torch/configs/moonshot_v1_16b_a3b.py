"""moonshot-v1-16b-a3b [moe]: 48L, d_model=2048, 16H (kv=16, full MHA),
expert d_ff=1408, vocab=163840, MoE 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]

Divergences (DESIGN.md §7): assignment spec wins — no shared experts
(vendor has 2), no dense first layer, and the assigned 48L (vendor has 27,
so totals land at ~28B rather than 16B; active ~4B).  64 experts on a
16-way model axis = 4 experts per chip; with top-6 routing this is the most
collective-hungry MoE cell in the matrix (a natural hillclimb candidate).
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408),
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=64), remat=False,
)
