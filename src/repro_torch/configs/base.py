"""Model configurations of the LM stack (``repro/configs/base.py``).

The same frozen dataclasses as the reference, with dtypes kept as names
(``"bfloat16"``, ``"float32"``) and resolved to torch dtypes by
``ModelConfig.cdtype`` / ``pdtype``.  The port serves and trains the
architectures whose modules it has (``PORTED``): the dense decoders
``h2o-danube-1.8b`` (sliding-window GQA), ``yi-9b`` (GQA),
``granite-34b`` (MQA, GELU MLP) and ``qwen1.5-32b`` (qkv biases), the
MoE decoders ``llama4-scout-17b-a16e`` (16 experts, top-1) and
``moonshot-v1-16b-a3b`` (64 experts, top-6), the hybrid ``zamba2-1.2b``
(Mamba-2 + shared attention) and the pure Mamba-1 ``falcon-mamba-7b``.
Any other known architecture (VLM, enc-dec) raises
``NotImplementedError``.
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


# Every architecture id of the reference, and the ones the port has.
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
    if name in _MODULES:
        return importlib.import_module(
            f"repro_torch.configs.{_MODULES[name]}")
    if name in ARCHS:
        raise NotImplementedError(
            f"{name!r} is not ported yet: the port serves and trains "
            f"{PORTED}; the other families (VLM and enc-dec) "
            "wait in ROADMAP.md §1, the module queue")
    raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
