"""whisper-large-v3 [audio]: 32L enc + 32L dec, d_model=1280, 20H, d_ff=5120,
vocab=51866.  [arXiv:2212.04356; unverified]

Encoder-decoder; the conv audio frontend is a stub: ``input_specs``
supplies precomputed (B, 1500, 1280) frame embeddings.  Divergences from
the vendor's model, as in the reference's config:
  * "32L" is 32 encoder + 32 decoder layers (whisper-large-v3's topology).
  * decoder positions use RoPE instead of the vendor's learned table (the
    decode shapes reach 32k positions, far past the 448-entry table); the
    encoder keeps its sinusoidal embedding.
  * GQA kv=20 == full MHA (kv == heads).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    n_frames=1500,
    norm="layer",
    act="gelu",
    tie_embeddings=True,      # whisper ties decoder embed/unembed
)

SMOKE = CONFIG.replace(
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, n_frames=12, remat=False,
)
