"""Phase profiling (``repro/core/profiling.py``, the paper's Tables 1-3).

Named phases timed on the host clock, each ending in a CUDA synchronize
when its result lies on the card (the counterpart of JAX's
``block_until_ready``), plus the analytic per-stage cost model.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from typing import Callable

import torch


def _wait(obj) -> None:
    """Block until every CUDA tensor in ``obj`` (nested tuples) is ready."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            _wait(item)


@dataclasses.dataclass
class PhaseStat:
    total_us: float = 0.0
    calls: int = 0

    @property
    def mean_us(self) -> float:
        return self.total_us / max(self.calls, 1)


class PhaseProfiler:
    """Accumulates wall time per named phase across repeats."""

    def __init__(self) -> None:
        self.phases: "OrderedDict[str, PhaseStat]" = OrderedDict()

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        result_holder = []
        try:
            yield result_holder
        finally:
            if result_holder:
                _wait(result_holder[-1])
            elapsed = (time.perf_counter() - start) * 1e6
            stat = self.phases.setdefault(name, PhaseStat())
            stat.total_us += elapsed
            stat.calls += 1

    def timeit(self, name: str, fn: Callable, *args, repeats: int = 1, **kw):
        out = None
        for _ in range(repeats):
            with self.phase(name) as holder:
                out = fn(*args, **kw)
                holder.append(out)
        return out

    def table(self) -> list[tuple[str, float, float]]:
        """[(phase, mean_us, pct_over_total)] — the paper's table shape."""
        total = sum(s.mean_us for s in self.phases.values())
        return [
            (name, s.mean_us, 100.0 * s.mean_us / total if total else 0.0)
            for name, s in self.phases.items()
        ]

    def report(self) -> str:
        rows = self.table()
        width = max((len(n) for n, _, _ in rows), default=10)
        lines = [f"{'phase':<{width}}  {'time(us)':>12}  {'% over total':>12}"]
        for name, us, pct in rows:
            lines.append(f"{name:<{width}}  {us:>12.1f}  {pct:>11.2f}%")
        total = sum(us for _, us, _ in rows)
        lines.append(f"{'total':<{width}}  {total:>12.1f}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class StageCost:
    name: str
    flops: float           # useful arithmetic
    bytes_moved: float     # device-memory traffic with perfect on-chip reuse
    matmul_fraction: float  # share of flops expressible as GEMMs

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_moved, 1.0)


def line_detection_costs(H: int, W: int, *, n_theta: int = 180,
                         kh: int = 5, fused: bool = False) -> list[StageCost]:
    """Analytic costs of the paper's stages for an HxW frame."""
    px = H * W
    k2 = (7 * 7) if fused else (kh * kh)
    conv_passes = 1 if fused else 2
    conv_flops = 2.0 * px * k2 * 3  # 3 masks
    conv_bytes = conv_passes * px * 4 * 2
    n_rho = int(2 * (H * H + W * W) ** 0.5) + 1
    return [
        StageCost("canny_conv_gemm", conv_flops, conv_bytes, 1.0),
        StageCost("canny_elementwise", 12.0 * px, px * 4 * 4, 0.0),
        StageCost("hough_rho_gemm", 2.0 * px * n_theta * 3, px * 4 * 2, 1.0),
        StageCost("hough_votes", 2.0 * px * n_theta, n_rho * n_theta * 4, 0.0),
        StageCost("get_coordinates", 10.0 * n_rho * n_theta,
                  n_rho * n_theta * 4, 0.0),
    ]
