"""End-to-end line detection pipeline (``repro/core/pipeline.py``).

The paper's three phases: (1) image load, (2) line detection (Canny ->
Hough -> get-coordinates), (3) an optional render.  A ``LineDetector``
decides nothing per call: each ``(height, width, batch-bucket)`` workload
resolves once into a ``DetectionPlan`` (``core/plan.py``) that later calls
reuse.  It runs on the card unless built with ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Iterator

import numpy as np
import torch

from .canny import canny, estimate_edge_count
from .hough import hough_transform, resolved_auto_config
from .lines import get_lines, render_lines
from .plan import (  # noqa: F401  (re-exported API)
    DetectionPlan, DetectionResult, LUMA_WEIGHTS, PipelineConfig, PlanCache,
    batch_bucket, load_frame,
)
from .profiling import PhaseProfiler


@contextlib.contextmanager
def _no_sync(device: torch.device):
    """On the card, make any host-device synchronization an error."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class LineDetector:
    """The paper's application: a thin facade over ``core/plan.py``."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(), *,
                 device=None):
        self.cfg = cfg
        self._plans = PlanCache(cfg, device=device)
        self.device = self._plans.device

    def _on_device(self, x) -> torch.Tensor:
        """Host arrays go through the plan cache's one explicit copy; a
        tensor must already lie on the detector's device."""
        if not isinstance(x, torch.Tensor):
            return self._plans.put(x)
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, detector on "
                             f"{self.device}; move it explicitly")
        return x

    # --- phase 1: image load ------------------------------------------
    def load(self, raw) -> torch.Tensor:
        """uint8 frame (possibly RGB (H, W, 3)) -> grayscale on the device;
        grayscale inputs keep their dtype (the integer pipeline keeps exact
        uint8 values)."""
        img = self._on_device(raw)
        if img.ndim == 3:  # luma conversion
            wr, wg, wb = LUMA_WEIGHTS
            img = img.to(torch.float32)
            img = wr * img[..., 0] + wg * img[..., 1] + wb * img[..., 2]
        return img

    # --- plan access ---------------------------------------------------
    def plan_for(self, height: int, width: int, *,
                 batch: int | None = None) -> DetectionPlan:
        """The resolve-once execution plan for a workload shape."""
        return self._plans.plan_for(height, width, batch=batch)

    def resolve_config(self, image=None) -> PipelineConfig:
        """Pin ``max_edges="auto"`` from the downsampled-gradient estimate
        of a concrete frame or batch (one host readback).  The detect paths
        do not need this; it reports the buffer a workload would get."""
        h = self.cfg.hough
        if h.max_edges != "auto":
            return self.cfg
        if h.compact:
            if image is None:
                raise ValueError(
                    "max_edges='auto' needs a concrete input frame to size "
                    "the compaction buffer (it is a static shape)."
                )
            image = self._on_device(image)
            H, W = image.shape[-2:]
            n_est = estimate_edge_count(image, self.cfg.canny)
        else:  # dense path: the knob is inert
            H = W = n_est = 0
        return dataclasses.replace(
            self.cfg, hough=resolved_auto_config(h, n_est, H, W)
        )

    # --- phase 2: line detection --------------------------------------
    def detect(self, image) -> DetectionResult:
        """Detect lines in one frame (H, W), or a batch (N, H, W)."""
        image = self._on_device(image)
        if image.ndim == 3:
            return self.detect_batch(image)
        H, W = image.shape[-2:]
        return self.plan_for(H, W).run(image)

    def detect_batch(self, images) -> DetectionResult:
        """Detect lines in a stack of frames (N, H, W): one conv launch per
        Canny stage and one vote launch for the whole batch, padded to the
        plan's power-of-two bucket and sliced back."""
        images = self._on_device(images)
        if images.ndim != 3:
            raise ValueError(f"detect_batch takes (N, H, W), got "
                             f"{tuple(images.shape)}")
        N, H, W = images.shape
        return self.plan_for(H, W, batch=batch_bucket(N)).run(images)

    def detect_stream(self, frames: Iterable, *, batch_size: int = 1
                      ) -> Iterator[DetectionResult]:
        """Pinned, double-buffered streaming detection over a frame iterator.

        One plan from the first frame's resolution and the ``batch_size``
        bucket serves every chunk (a short final one pads).  Chunks are
        staged on the host and shipped with one pinned, non-blocking copy
        each; after the first chunk warms the device constants, the
        dispatch runs under ``torch.cuda.set_sync_debug_mode("error")``,
        so any host round trip is an error rather than a stall.  While the
        card computes batch k the host stages batch k+1.  Yields one
        per-frame DetectionResult per input frame, in order.
        """
        plan: DetectionPlan | None = None
        warmed = False

        def dispatch(chunk):
            nonlocal plan, warmed
            arr = np.stack([load_frame(f) for f in chunk])
            n, H, W = arr.shape
            if plan is None:
                plan = self.plan_for(H, W, batch=batch_bucket(batch_size))
            if n < plan.batch:  # pad on the host: one transfer either way
                arr = np.concatenate(
                    [arr, np.zeros((plan.batch - n, H, W), arr.dtype)]
                )
            if not warmed:  # the first chunk uploads the constants
                warmed = True
                return plan.run(self._plans.put(arr)), n
            with _no_sync(self.device):
                return plan.run(self._plans.put(arr)), n

        def split(res, n):
            for i in range(n):
                yield DetectionResult(
                    res.lines[i], res.valid[i], res.peaks[i], res.edges[i],
                    None if res.rendered is None else res.rendered[i],
                )

        in_flight = None
        buf = []
        for frame in frames:
            buf.append(frame)
            if len(buf) == batch_size:
                res = dispatch(buf)
                buf = []
                if in_flight is not None:
                    yield from split(*in_flight)
                in_flight = res
        if buf:
            res = dispatch(buf)
            if in_flight is not None:
                yield from split(*in_flight)
            in_flight = res
        if in_flight is not None:
            yield from split(*in_flight)

    # --- full pipeline with paper-style phase profiling ----------------
    def detect_profiled(self, raw, profiler: PhaseProfiler | None = None,
                        repeats: int = 1
                        ) -> tuple[DetectionResult, PhaseProfiler]:
        prof = profiler or PhaseProfiler()
        result = None
        for _ in range(repeats):
            image = prof.timeit("image_load", self.load, raw)
            result = prof.timeit("line_detection", self.detect, image)
            if self.cfg.render_output:
                prof.timeit(
                    "image_generation",
                    lambda: render_lines(image.to(torch.uint8), result.lines,
                                         result.valid),
                )
        return result, prof

    def detect_stage_profiled(self, image, repeats: int = 1
                              ) -> PhaseProfiler:
        """Paper Table 3: the Canny vs Hough vs get-coordinates split, for a
        frame (H, W) or a batch (N, H, W)."""
        prof = PhaseProfiler()
        image = self._on_device(image)
        H, W = image.shape[-2:]
        cfg = self.resolve_config(image)

        def lines_of(votes):
            return get_lines(votes, height=H, width=W, cfg=cfg.lines)

        edges = canny(image, cfg.canny)  # warm-up: builds kernels, constants
        lines_of(hough_transform(edges, cfg.hough))
        for _ in range(repeats):
            edges = prof.timeit("canny", canny, image, cfg.canny)
            votes = prof.timeit("hough", hough_transform, edges, cfg.hough)
            prof.timeit("get_coordinates", lines_of, votes)
        return prof
