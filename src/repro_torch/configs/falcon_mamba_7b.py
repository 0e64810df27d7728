"""falcon-mamba-7b [ssm]: 64L, d_model=4096 (attention-free), d_ff=0,
vocab=65024, ssm_state=16.  [arXiv:2410.05355; unverified]

Pure Mamba-1.  The selective scan's decay varies per (channel, state)
pair, so it has no SSD/GEMM rewrite: it runs as a chunked associative
scan (log-depth inside chunks of ``ssm.chunk``, a sequential carry across
them) in plain PyTorch, as the reference runs it in plain JAX.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(
        kind="mamba1", d_state=16, d_inner=8192, d_conv=4,
        dt_rank=256, chunk=64,
    ),
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, vocab=256,
    ssm=SSMConfig(kind="mamba1", d_state=8, d_inner=128, d_conv=4,
                  dt_rank=8, chunk=16),
    remat=False,
)
