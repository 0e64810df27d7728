"""The attention kernel's wrapper (``csrc/flash_attention.cu``) and its
plain versions.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``:
blocked online-softmax attention with causal and sliding-window masks in
global positions (``q_offset``), GQA folded into the kv index, and the
tiles past the causal/window frontier skipped.  bf16 runs on the tensor
cores (``mma.sync``, with p split into two bf16 halves for PV), f32 and
f16 on the f32 FMA units (``FORM``).  ``plain`` is the dense oracle from
``ref.py``; ``ops.flash_attention`` sends a CPU tensor there (or to
``ref.attention_blockwise`` above a kv length of 2048).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import attention as plain  # noqa: F401  (the kernel's plain version)

#: Launches of the kernel since the last reset (``ops.reset_launch_counts``).
launches = 0

MAX_HEAD_DIM = 128

_ENTRY = {
    torch.float32: "flash_attention_f32",
    torch.bfloat16: "flash_attention_bf16",
    torch.float16: "flash_attention_f16",
}
#: The kernel each dtype's entry runs (csrc/flash_attention.cu's header).
FORM = {
    torch.float32: "f32 FMA",
    torch.bfloat16: "mma.sync bf16, split p",
    torch.float16: "f32 FMA",
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P] + [_I] * 9 + [_F, _P]
        fn.restype = _I
    lib.flash_attention_bf16_attributes.argtypes = [
        _I] + [ctypes.POINTER(_I)] * 3
    lib.flash_attention_bf16_attributes.restype = _I
    return lib


def bf16_kernel_attributes(head_dim: int) -> dict:
    """The bf16 tensor-core kernel at ``head_dim``: registers a thread,
    dynamic shared memory a block, and the blocks one SM holds (the CUDA
    occupancy query).  Needs the card; launches nothing."""
    if not 0 < head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"attention kernel: head dim {head_dim} not in "
                         f"1..{MAX_HEAD_DIM}")
    lib = _lib()
    out = [ctypes.c_int() for _ in range(3)]
    rc = lib.flash_attention_bf16_attributes(head_dim,
                                             *(ctypes.byref(x) for x in out))
    _build.check(lib, rc, "flash_attention attribute query")
    regs, smem, blocks = (x.value for x in out)
    return {"registers_per_thread": regs, "smem_bytes_per_block": smem,
            "blocks_per_sm": blocks, "threads_per_block": 128}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Launch the attention kernel: (B, Hq, Lq, D) out, in q's dtype.

    q (B, Hq, Lq, D); k, v (B, Hkv, Lkv, D) with Hq % Hkv == 0 and
    D <= 128; all contiguous CUDA tensors of one dtype (f32, bf16 or
    f16) on one card.  ``window`` counts keys with ``q_pos - kv_pos <
    window``; ``q_offset`` is the global position of query row 0.  Ragged
    Lq and Lkv are masked in the kernel.  Raises on anything else, and,
    before touching the card, on an input that requires grad while grad
    mode is on: the output would carry no gradient.
    """
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the attention kernel writes its output through a raw pointer and "
            "has no backward: call it through kernels.ops.flash_attention, "
            "whose autograd Function gives the gradient, or under no_grad")
    if not q.is_cuda:
        raise ValueError("the attention kernel takes CUDA tensors; the CPU "
                         "uses kernels.ref.attention")
    if q.dtype not in _ENTRY:
        raise TypeError(f"attention kernel: unsupported dtype {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, Lq, D = q.shape
    Bk, Hkv, Lkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"attention kernel: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair (Hq % Hkv == 0)")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"attention kernel: head dim {D} not in "
                         f"1..{MAX_HEAD_DIM}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"attention kernel: {name} must match q's "
                             "dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"attention kernel: {name} must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"attention kernel: window {window} must be > 0")
    if q_offset < 0:
        raise ValueError(f"attention kernel: q_offset {q_offset} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Lkv == 0:
        return out.zero_()
    lib = _lib()
    rc = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, Lq, Lkv, D, int(causal),
        0 if window is None else int(window), int(q_offset),
        1.0 / (D ** 0.5), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_attention kernel launch")
    launches += 1
    return out
