"""Resolve-once execution plans for the line detector (``repro/core/plan.py``).

A frozen :class:`DetectionPlan` is built once per ``(height, width,
batch-bucket)`` and pins everything static: the resolved
:class:`PipelineConfig`, the batch padding bucket, and for
``max_edges="auto"`` the static tier set.  ``run`` pads, runs the staged
or the fused detector, and slices; once warm it makes no host round trip
on the card (``LineDetector.detect_stream`` checks this under
``torch.cuda.set_sync_debug_mode("error")``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.partition import local_tree

from .canny import CannyConfig, canny
from .hough import (
    HoughConfig, fused_hough, fused_hough_tiered, hough_transform,
    hough_transform_tiered, max_edge_tiers,
)
from .lines import LinesConfig, get_lines, render_lines


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    canny: CannyConfig = CannyConfig()
    hough: HoughConfig = HoughConfig()
    lines: LinesConfig = LinesConfig()
    render_output: bool = False   # the paper's elision: off by default
    # The fused hot path (kernels/fused_detect.py): Canny -> corridor filter
    # -> compaction -> vote with no edge map in device memory.  Needs
    # ``hough.compact=True``; the result's ``edges`` is a zero placeholder.
    fused: bool = False


class DetectionResult(NamedTuple):
    # Per-frame shapes; every field gains a leading N axis in a batch.
    lines: torch.Tensor      # (K, 4) endpoints
    valid: torch.Tensor      # (K,) mask
    peaks: torch.Tensor      # (K, 2) (rho, theta)
    edges: torch.Tensor      # (H, W) uint8 Canny output
    rendered: torch.Tensor | None


# BT.601 luma weights, shared by the host (load_frame) and device
# (LineDetector.load) grayscale conversions.
LUMA_WEIGHTS = (0.299, 0.587, 0.114)


def load_frame(raw) -> np.ndarray:
    """Host-side phase 1: uint8 frame (possibly RGB) -> grayscale f32."""
    img = np.asarray(raw)
    if img.ndim == 3:  # luma conversion
        wr, wg, wb = LUMA_WEIGHTS
        img = img.astype(np.float32)
        img = wr * img[..., 0] + wg * img[..., 1] + wb * img[..., 2]
    return np.asarray(img, np.float32)


def downsample2x(img: np.ndarray) -> np.ndarray:
    """Host-side 2x2 mean-pool of a grayscale f32 frame (edge-replicated to
    even dimensions first, so the last row/column is never dropped)."""
    img = np.asarray(img, np.float32)
    H, W = img.shape
    if H % 2:
        img = np.concatenate([img, img[-1:, :]], axis=0)
    if W % 2:
        img = np.concatenate([img, img[:, -1:]], axis=1)
    return (0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                    + img[0::2, 1::2] + img[1::2, 1::2])
            ).astype(np.float32)


def downshift_frame(raw, shape: tuple[int, int]) -> tuple[np.ndarray, int]:
    """Grayscale-load ``raw`` and halve it until it fits ``shape``; returns
    ``(image, factor)`` with ``factor`` the power-of-two divisor applied."""
    img = load_frame(raw)
    factor = 1
    while img.shape[0] > shape[0] or img.shape[1] > shape[1]:
        img = downsample2x(img)
        factor *= 2
    return img, factor


def _detect(cfg: PipelineConfig, image: torch.Tensor,
            theta_bins: torch.Tensor | None = None,
            corridors: torch.Tensor | None = None, *,
            tiers: tuple[int, ...] | None = None) -> DetectionResult:
    """The detection body: Canny -> Hough vote -> get_lines, staged or fused.

    With ``tiers=None``, ``cfg`` is fully resolved; with a tier tuple (the
    ``max_edges="auto"`` plan path) compaction writes into the cap tier
    ``tiers[-1]`` and the vote skips each frame's rows past its device-held
    edge count.  ``theta_bins`` (iff ``cfg.hough.theta_band``) is the
    prediction gate; the votes stay in band space through ``get_lines``.
    ``corridors`` (iff ``cfg.hough.corridors``; fused plans only) is the
    (C, 4) rho-window set that filters edge pixels.
    """
    H, W = image.shape[-2:]
    if cfg.fused:
        # no edge map exists on this path: the fused kernel emits the
        # compacted edge list straight from the frames
        edges = torch.zeros(image.shape, dtype=torch.uint8,
                            device=image.device)
        if tiers is None:
            votes = fused_hough(image, cfg.canny, cfg.hough, theta_bins,
                                corridors, scatter=False)
        else:
            votes = fused_hough_tiered(image, cfg.canny, cfg.hough, tiers,
                                       theta_bins, corridors, scatter=False)
    else:
        if corridors is not None:
            raise ValueError(
                "corridors is a fused-path argument; this plan is staged "
                "(PipelineConfig.fused=False)"
            )
        edges = canny(image, cfg.canny)
        if tiers is None:
            votes = hough_transform(edges, cfg.hough, theta_bins,
                                    scatter=False)
        else:
            votes = hough_transform_tiered(edges, cfg.hough, tiers,
                                           theta_bins, scatter=False)
    lines, valid, peaks = get_lines(
        votes, height=H, width=W, cfg=cfg.lines, theta_bins=theta_bins
    )
    rendered = None
    if cfg.render_output:
        rendered = render_lines(image.to(torch.uint8), lines, valid)
    return DetectionResult(lines, valid, peaks, edges, rendered)


def batch_bucket(n: int) -> int:
    """Round a batch size up to the next power of two."""
    if n <= 1:
        return 1
    b = 1
    while b < n:
        b *= 2
    return b


def resolve_static(cfg: PipelineConfig, height: int, width: int
                   ) -> tuple[PipelineConfig, tuple[int, ...] | None]:
    """Resolve every shape-static knob of ``cfg`` for one resolution:
    ``(resolved_cfg, tiers)``, ``tiers`` set iff the config asks for the
    device-side autotune (``compact=True, max_edges="auto"``)."""
    h = cfg.hough
    if h.max_edges != "auto":
        return cfg, None
    if not h.compact:  # knob inert on the dense path
        return dataclasses.replace(
            cfg, hough=dataclasses.replace(h, max_edges=None)
        ), None
    return cfg, max_edge_tiers(height, width)


@dataclasses.dataclass(frozen=True)
class DetectionPlan:
    """A frozen "how to run" record for one ``(H, W, batch)`` workload.

    ``tiers`` keeps the reference's signature; the port reads only its cap,
    ``tiers[-1]`` (see ``core/hough.py``).
    """
    cfg: PipelineConfig           # resolved: "auto" only with tiers set
    height: int
    width: int
    batch: int | None             # padded batch bucket; None = single frame
    tiers: tuple[int, ...] | None  # static autotune tiers (iff "auto")

    @classmethod
    def build(cls, cfg: PipelineConfig, height: int, width: int, *,
              batch: int | None = None) -> "DetectionPlan":
        if cfg.fused and not cfg.hough.compact:
            raise ValueError(
                "PipelineConfig.fused requires hough.compact=True: the "
                "fused kernel's output IS the compacted edge list."
            )
        resolved, tiers = resolve_static(cfg, height, width)
        return cls(resolved, height, width, batch, tiers)

    def with_render(self, render: bool) -> "DetectionPlan":
        """The same plan with the render phase bound on or off."""
        if self.cfg.render_output == render:
            return self
        return dataclasses.replace(
            self, cfg=dataclasses.replace(self.cfg, render_output=render)
        )

    def with_theta_band(self, band: int | None) -> "DetectionPlan":
        """The same plan with the gated vote bound to a static band width
        (``None`` = full sweep); the bin values are passed to ``run``."""
        if self.cfg.hough.theta_band == band:
            return self
        return dataclasses.replace(
            self, cfg=dataclasses.replace(
                self.cfg,
                hough=dataclasses.replace(self.cfg.hough, theta_band=band),
            )
        )

    def with_fused(self, corridors: int | None = None) -> "DetectionPlan":
        """The fused-hot-path twin of this plan, with the corridor filter
        bound to a static corridor count (``None`` = no filter); the
        windows are passed to ``run``.  Requires ``hough.compact=True``."""
        cfg = dataclasses.replace(
            self.cfg, fused=True,
            hough=dataclasses.replace(self.cfg.hough, corridors=corridors),
        )
        if cfg == self.cfg:
            return self
        if not cfg.hough.compact:
            raise ValueError(
                "with_fused requires hough.compact=True: the fused "
                "kernel's output IS the compacted edge list."
            )
        return dataclasses.replace(self, cfg=cfg)

    def run(self, images: torch.Tensor, theta_bins=None, corridors=None
            ) -> DetectionResult:
        """Detect on a frame (H, W) or a batch (N <= bucket, H, W).

        A short batch pads with zero frames (every stage is
        frame-independent) and the result is sliced back.  ``theta_bins``
        (iff the config sets ``theta_band``) and ``corridors`` (iff it sets
        ``hough.corridors``; shipped as f32) are shared by the batch.  A
        slot-sharded batch (``sharding.partition.shard_slots`` on a
        one-device replica mesh) runs on its local tensor.
        """
        images = local_tree(images)
        if theta_bins is not None:
            theta_bins = torch.as_tensor(theta_bins, device=images.device)
        if corridors is not None:
            corridors = torch.as_tensor(corridors, dtype=torch.float32,
                                        device=images.device)
        if images.shape[-2:] != (self.height, self.width):
            raise ValueError(f"images {tuple(images.shape)} do not fit the "
                             f"plan's {self.height}x{self.width}")
        if self.batch is None:
            return _detect(self.cfg, images, theta_bins, corridors,
                           tiers=self.tiers)
        n = images.shape[0]
        if images.ndim != 3 or n > self.batch:
            raise ValueError(f"images {tuple(images.shape)} do not fit the "
                             f"plan's batch bucket {self.batch}")
        if n < self.batch:
            images = torch.cat([
                images,
                images.new_zeros((self.batch - n, self.height, self.width)),
            ])
        res = _detect(self.cfg, images, theta_bins, corridors,
                      tiers=self.tiers)
        if n == self.batch:
            return res
        return DetectionResult(
            res.lines[:n], res.valid[:n], res.peaks[:n], res.edges[:n],
            None if res.rendered is None else res.rendered[:n],
        )

    __call__ = run


class PlanCache:
    """Per-detector memo of plans keyed by ``(H, W, batch-bucket)``, pinned
    to one device (the card unless ``device="cpu"``)."""

    def __init__(self, cfg: PipelineConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._plans: dict[tuple[int, int, int | None], DetectionPlan] = {}

    def put(self, x) -> torch.Tensor:
        """Ship a host batch to this cache's device: on the card, one pinned,
        non-blocking copy (the one transfer per dispatch)."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def plan_for(self, height: int, width: int, *,
                 batch: int | None = None) -> DetectionPlan:
        key = (height, width, batch)
        plan = self._plans.get(key)
        if plan is None:
            plan = DetectionPlan.build(self.cfg, height, width, batch=batch)
            self._plans[key] = plan
        return plan

    def __len__(self) -> int:
        return len(self._plans)
