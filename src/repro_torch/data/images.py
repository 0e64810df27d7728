"""Synthetic road-scene frames (the paper's camera input, offline).

No image assets ship offline, so the line-detection pipeline is exercised on
procedurally generated road scenes: a textured ground plane, two converging
lane lines with known analytic (rho, theta), optional dashes and noise.
Because ground truth is known exactly, tests can assert that the detector
recovers the planted lines — a stronger check than the paper's visual
comparison (Fig. 4).

This module keeps the seed workload (``synthetic_road``); the full family
registry — curved, night, glare, rain, occlusion, multi-lane, ... — lives in
``data/scenarios.py``, which builds on these primitives.  A numpy copy of
``repro/data/images.py``: the port imports nothing of the reference.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class RoadScene:
    image: np.ndarray            # (H, W) uint8 grayscale
    lines_rho_theta: np.ndarray  # (n_lines, 2) planted (rho, theta)


def _draw_line(img: np.ndarray, rho: float, theta: float,
               intensity: int, width: float) -> None:
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W]
    # distance from pixel to the line x cos(t) + y sin(t) = rho
    dist = np.abs(xx * math.cos(theta) + yy * math.sin(theta) - rho)
    img[dist <= width] = intensity


def synthetic_road(height: int = 240, width: int = 320, *, seed: int = 0,
                   noise: float = 4.0, n_lines: int = 2,
                   dashed: bool = False) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = np.full((height, width), 90, np.float32)  # asphalt
    img += rng.normal(0.0, noise, img.shape)  # texture

    planted = []
    # converging lane markings: theta measured per the paper's convention
    # rho = x cos(theta) + y sin(theta), theta in [0, pi)
    base = [(0.35, 55.0), (0.65, 125.0)][: max(n_lines, 0)]
    extra = [(0.5, 90.0), (0.15, 70.0)]
    for k in range(n_lines):
        fx, deg = (base + extra)[k]
        theta = math.radians(deg + rng.uniform(-4, 4))
        x_anchor = fx * width
        y_anchor = 0.75 * height
        rho = x_anchor * math.cos(theta) + y_anchor * math.sin(theta)
        _draw_line(img, rho, theta, 235, 1.6)
        planted.append((rho, theta))

    if dashed:  # punch gaps to emulate dashed center lines
        mask = (np.arange(height)[:, None] // 12) % 2 == 0
        img = np.where(mask & (img > 200), 90.0, img)

    img = np.clip(img, 0, 255).astype(np.uint8)
    return RoadScene(img, np.array(planted, np.float32))


def frame_stream(n_frames: int, height: int = 240, width: int = 320,
                 seed: int = 0):
    """Generator of frames with slowly drifting lanes (video analogue)."""
    for t in range(n_frames):
        yield synthetic_road(height, width, seed=seed + t)
