"""llama-3.2-vision-11b [vlm]: 40L, d_model=4096, 32H (GQA kv=8),
d_ff=14336, vocab=128256.  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

40 layers = 8 superblocks of (4 self-attn layers + 1 cross-attn layer) —
the vendor's 8 interleaved cross-attention layers.  The vision tower is a
stub: ``input_specs`` supplies precomputed (B, 1600, 1280) patch
embeddings; a learned adapter projects 1280 -> 4096.  The vendor emits
1601 patch tokens (CLS + 40x40); the config takes 1600 for tile alignment.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    cross_every=5,            # 1 cross layer per 5 -> 8 cross layers
    n_img_tokens=1600,
    d_vision=1280,
)

SMOKE = CONFIG.replace(
    n_layers=4, cross_every=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, n_img_tokens=8, d_vision=32, remat=False,
)
