"""The SSD scan kernel's wrapper (``csrc/ssd_scan.cu``) and its plain
versions.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``: the
Mamba-2 chunked scan (the State Space Duality form).  One call issues
``PASSES`` device kernels: (a) each chunk's log-decay prefix and state
contribution, and C B^T once per group and chunk; (b) the state carried
across the chunks; (c) each chunk's output, 32 rows a block.  The
products run on the tensor cores as 3xTF32 (``FORM``).  The reference's
wrapper forms ``xdt = x * dt`` and the log-decay ``ldec = dt * A`` before
its kernel; here the kernels form them from x, dt and A as they load a
chunk (ldec with the same one rounding), so a call launches nothing else.
The wrapper allocates the passes' scratch.  ``plain`` is the chunked form
from ``ref.py``; ``ops.ssd_scan`` sends a CPU tensor to the sequential
oracle at L <= 64 and to the chunked form above.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import ssd_scan_chunked as plain  # noqa: F401  (plain version)

#: Launches of the kernel since the last reset (``ops.reset_launch_counts``);
#: one a call, which issues ``PASSES`` device kernels.
launches = 0

#: Device kernels a call issues, in order: ``ssd_scan_chunk_kernel``,
#: ``ssd_scan_carry_kernel``, ``ssd_scan_output_kernel``.
PASSES = 3
#: How the kernels compute their products.
FORM = "3xTF32 mma.sync m16n8k8"

MAX_CHUNK = 128
MAX_SMEM_BYTES = 232448      # an H100 block's shared memory, opted in
ROWS_A_BLOCK = 32            # rows of a chunk an output block takes
CARRY_THREADS = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_PLAN_KEYS = ("smem_chunk", "smem_output", "blocks_chunk", "blocks_carry",
              "blocks_output", "cum_floats", "state_floats", "cb_floats")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_f32.argtypes = [_P] * 10 + [_I] * 7 + [_P]
    lib.ssd_scan_f32.restype = _I
    lib.ssd_scan_plan.argtypes = [_I] * 8
    lib.ssd_scan_plan.restype = ctypes.c_longlong
    return lib


def _up(a: int, m: int) -> int:
    return -(-a // m) * m


def plan(b: int, L: int, H: int, G: int, N: int, P: int, Q: int) -> dict:
    """What a call at these sizes takes, as ``ssd_scan.cu``'s
    ``ssd_scan_plan`` computes it: shared-memory bytes of passes (a) and
    (c), blocks of each pass, and floats of the scratch arrays (cum, the
    chunk states, C B^T).  The chunk is padded to 32 rows, N to 16 and P
    to 64."""
    QP, NP, PP = _up(Q, ROWS_A_BLOCK), _up(N, 16), _up(P, 64)
    nc = -(-L // Q) if Q else 0
    return {
        "smem_chunk": 4 * max(QP * (NP + 8) + QP * (PP + 8) + 3 * QP,
                              2 * QP * (NP + 4)),
        "smem_output": 4 * (ROWS_A_BLOCK * (QP + 4) + ROWS_A_BLOCK * (NP + 4)
                            + QP * (PP + 8) + NP * (PP + 8) + 2 * QP),
        "blocks_chunk": b * (G + H) * nc,
        "blocks_carry": -(-(b * H * N * P) // CARRY_THREADS),
        "blocks_output": b * H * nc * (QP // ROWS_A_BLOCK),
        "cum_floats": b * H * nc * QP,
        "state_floats": b * H * nc * N * P,
        "cb_floats": b * G * nc * QP * QP,
    }


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Shared memory of the hungrier of the two passes that take any."""
    p = plan(1, Q, 1, 1, N, P, Q)
    return max(p["smem_chunk"], p["smem_output"])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the kernels copy
    rows as float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """Launch the SSD kernel: ``(y, state)``.

    x (b, L, H, P), dt (b, L, H), A (H,), B and C (b, L, G, N), all f32
    CUDA tensors on one card, H % G == 0, N and P multiples of 4.  The
    chunk is ``min(chunk, L)`` steps, at most 128.  Returns y (b, L, H, P)
    f32 and the final state (b, H, N, P) f32.  Raises on anything else, and,
    before touching the card, on an input that requires grad while grad
    mode is on: the outputs would carry no gradient.
    """
    global launches
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise RuntimeError(
            "the SSD kernel writes its outputs through raw pointers and has "
            "no backward: call it through kernels.ops.ssd_scan, whose "
            "autograd Function gives the gradient, or under no_grad")
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
    xc, Bc, Cc = _aligned(x), _aligned(B), _aligned(C)
    dtc, Ac = dt.contiguous(), A.contiguous()
    p = plan(b, L, H, G, N, P, Q)
    cum, hbuf, cb = (torch.empty(p[k], dtype=torch.float32, device=x.device)
                     for k in ("cum_floats", "state_floats", "cb_floats"))
    lib = _lib()
    rc = lib.ssd_scan_f32(
        xc.data_ptr(), dtc.data_ptr(), Ac.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), y.data_ptr(), state.data_ptr(), cum.data_ptr(), hbuf.data_ptr(),
        cb.data_ptr(), b, L, H, G, N, P, Q,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "ssd_scan kernel launch")
    launches += 1
    return y, state
