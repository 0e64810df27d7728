"""Model configurations of the LM stack (``repro/configs/base.py``).

The same frozen dataclasses as the reference, with dtypes kept as names
(``"bfloat16"``, ``"float32"``) and resolved to torch dtypes by
``ModelConfig.cdtype`` / ``pdtype``.  The port has every architecture
of the reference (``PORTED == ARCHS``): the dense decoders
``h2o-danube-1.8b`` (sliding-window GQA), ``yi-9b`` (GQA),
``granite-34b`` (MQA, GELU MLP) and ``qwen1.5-32b`` (qkv biases), the
MoE decoders ``llama4-scout-17b-a16e`` (16 experts, top-1) and
``moonshot-v1-16b-a3b`` (64 experts, top-6), the hybrid ``zamba2-1.2b``
(Mamba-2 + shared attention), the pure Mamba-1 ``falcon-mamba-7b``, the
VLM ``llama-3.2-vision-11b`` (cross-attention to adapted patch
embeddings) and the encoder-decoder ``whisper-large-v3`` (layer norm,
a sinusoidal encoder).  ``SHAPES`` and ``shapes_for`` are the reference's
assigned workload shapes.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden dim
    capacity_factor: float = 1.25
    router_scale: float = 1.0     # optional logit scaling


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str                     # "mamba1" | "mamba2"
    d_state: int
    d_inner: int
    d_conv: int = 4
    n_heads: int = 0              # mamba2: d_inner // head_dim
    head_dim: int = 64            # mamba2 P
    n_groups: int = 1             # mamba2 B/C groups
    chunk: int = 128              # SSD / chunked-scan length
    dt_rank: int = 0              # mamba1 dt low-rank


_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name of the reference's configs."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    window: Optional[int] = None          # sliding-window attention
    rope_theta: float = 10000.0
    norm: str = "rms"                     # rms | layer
    norm_eps: float = 1e-5
    act: str = "silu"                     # silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # vlm
    cross_every: int = 0
    n_img_tokens: int = 0
    d_vision: int = 0
    # encoder-decoder
    encoder_layers: int = 0
    n_frames: int = 0
    # hybrid (zamba2)
    share_every: int = 0                  # shared attn block cadence
    shared_attn_heads: int = 0
    # numerics / training
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --- assigned shape matrix ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Every architecture id of the reference; the port has them all.
ARCHS = (
    "whisper-large-v3",
    "llama-3.2-vision-11b",
    "h2o-danube-1.8b",
    "yi-9b",
    "granite-34b",
    "qwen1.5-32b",
    "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b",
    "zamba2-1.2b",
    "falcon-mamba-7b",
)

_MODULES = {
    "whisper-large-v3": "whisper_large_v3",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "yi-9b": "yi_9b",
    "granite-34b": "granite_34b",
    "qwen1.5-32b": "qwen1_5_32b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

PORTED = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def shapes_for(cfg: ModelConfig) -> list[str]:
    """Which assigned shapes run for this arch.

    long_500k needs sub-quadratic attention: it runs for the ssm and
    hybrid archs and the sliding-window dense archs, and is skipped for
    the full-attention archs.  Every arch has a decoder, so the decode
    shapes always apply.
    """
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid") or cfg.window is not None:
        out.append("long_500k")
    return out
