"""The SSD scan kernel's wrapper (``csrc/ssd_scan.cu``) and its plain
versions.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``: the
Mamba-2 chunked scan (the State Space Duality form), one (batch, head) a
block, the (N, P) state carried across chunks in shared memory.  Like the
reference's wrapper, this one forms ``xdt = x * dt`` and the log-decay
``ldec = dt * A`` before the launch.  ``plain`` is the chunked form from
``ref.py``; ``ops.ssd_scan`` sends a CPU tensor to the sequential oracle
at L <= 64 and to the chunked form above.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import ssd_scan_chunked as plain  # noqa: F401  (plain version)

#: Launches of the kernel since the last reset (``ops.reset_launch_counts``).
launches = 0

MAX_CHUNK = 128
MAX_SMEM_BYTES = 232448      # an H100 block's shared memory, opted in

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_f32.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    lib.ssd_scan_f32.restype = _I
    lib.ssd_scan_smem_bytes.argtypes = [_I, _I, _I]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Shared memory a block takes: the arrays ``ssd_scan.cu`` lays out
    (B^T, xdt, state, C, the decay-masked C B^T, three vectors), the chunk
    rounded up to a multiple of 4."""
    QP = (Q + 3) // 4 * 4
    return 4 * (N * (QP + 4) + QP * P + N * P + QP * (N + 1)
                + QP * (QP + 1) + 3 * QP)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """Launch the SSD kernel: ``(y, state)``.

    x (b, L, H, P), dt (b, L, H), A (H,), B and C (b, L, G, N), all f32
    CUDA tensors on one card, H % G == 0, N and P multiples of 4.  The
    chunk is ``min(chunk, L)`` steps, at most 128.  Returns y (b, L, H, P)
    f32 and the final state (b, H, N, P) f32.  Raises on anything else.
    """
    global launches
    if not x.is_cuda:
        raise ValueError("the SSD kernel takes CUDA tensors; the CPU uses "
                         "kernels.ref.ssd_scan / ssd_scan_chunked")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.dtype != torch.float32:
            raise TypeError(f"SSD kernel: {name} must be f32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"SSD kernel: {name} is not on x's card")
    if x.ndim != 4 or B.ndim != 4:
        raise ValueError(f"SSD kernel: x {tuple(x.shape)}, B {tuple(B.shape)}")
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (dt.shape != (b, L, H) or A.shape != (H,) or B.shape != (b, L, G, N)
            or C.shape != B.shape):
        raise ValueError(f"SSD kernel: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if G == 0 or H % G or N % 4 or P % 4 or not N or not P:
        raise ValueError(f"SSD kernel: needs H % G == 0 and N, P multiples "
                         f"of 4 (H={H}, G={G}, N={N}, P={P})")
    if chunk < 1:
        raise ValueError(f"SSD kernel: chunk {chunk} < 1")
    Q = min(chunk, L)
    if Q > MAX_CHUNK or smem_bytes(Q, N, P) > MAX_SMEM_BYTES:
        raise ValueError(f"SSD kernel: chunk {Q} with N={N}, P={P} needs "
                         f"{smem_bytes(Q, N, P)} bytes of shared memory "
                         f"(chunk <= {MAX_CHUNK}, <= {MAX_SMEM_BYTES} bytes)")
    y = torch.empty((b, L, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((b, H, N, P), dtype=torch.float32, device=x.device)
    if b == 0 or L == 0 or H == 0:
        return y, state.zero_()
    xdt = (x * dt[..., None]).contiguous()
    ldec = (dt * A[None, None, :]).contiguous()
    Bc, Cc = B.contiguous(), C.contiguous()
    lib = _lib()
    rc = lib.ssd_scan_f32(
        xdt.data_ptr(), ldec.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, L, H, G, N, P, Q,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "ssd_scan kernel launch")
    launches += 1
    return y, state
