"""zamba2-1.2b [hybrid]: 38L, d_model=2048, 32H (kv=32, shared attn block),
d_ff=8192, vocab=32000, ssm_state=64.  [arXiv:2411.15242; hf]

Mamba-2 backbone with one *weight-tied* transformer block (attention + MLP)
applied after every 6th Mamba block: 38 layers = 6 superblocks of 6 + a
2-layer tail without the shared block.  The shared block's parameters are
one set; its KV caches are one per application.  As in the reference, the
tied block is applied directly (the vendor's concatenation with the
original embedding and its LoRA adapters are left out).
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,                # shared attn block geometry
    n_kv_heads=32,
    d_ff=8192,                 # shared block MLP
    vocab=32000,
    share_every=6,
    shared_attn_heads=32,
    ssm=SSMConfig(
        kind="mamba2", d_state=64, d_inner=4096, d_conv=4,
        n_heads=64, head_dim=64, n_groups=1, chunk=128,
    ),
)

SMOKE = CONFIG.replace(
    n_layers=5, share_every=2, d_model=64, n_heads=4, n_kv_heads=4,
    shared_attn_heads=4, d_ff=128, vocab=256,
    ssm=SSMConfig(kind="mamba2", d_state=16, d_inner=128, d_conv=4,
                  n_heads=4, head_dim=32, n_groups=2, chunk=16),
    remat=False,
)
