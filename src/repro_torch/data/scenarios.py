"""Scenario engine: a registry of procedural road-scene families.

The paper validates on a single clean frame (Fig. 4); the ROADMAP north-star
asks for "as many scenarios as you can imagine".  This module grows
``data/images.py`` into a registry of road-scene *families*, each a
procedural generator with analytic ground truth — every planted stroke's
(rho, theta) normal form is known exactly, so ``core/metrics.py`` can score
detections quantitatively (precision/recall/F1, localization error) instead
of eyeballing an output image.

Families cover the conditions AV accelerator surveys judge deployments on
(straight/converging/dashed lanes, curved polylines, night contrast, glare,
rain, occlusion, perspective multi-lane).  Each family is registered with an
empirically tuned ``f1_floor`` — the regression bar ``tests/test_scenarios.py``
and ``benchmarks/scenario_suite.py`` hold every future performance change to.

Registry API:

  * ``scenario_names()``                  — all registered family names,
  * ``get_family(name)``                  — the ``ScenarioFamily`` record,
  * ``make_scenario(name, h, w, seed)``   — one ``RoadScene`` with truth,
  * ``scenario_batch(names, ...)``        — heterogeneous (N, H, W) stacks,
  * ``scenario_stream(name, n, ...)``     — drifting-seed frame generator
    (``name="mixed"`` rotates through every family — the heterogeneous
    stream ``LineDetector.detect_stream`` is exercised on).

A numpy copy of ``repro/data/scenarios.py`` up to ``scenario_stream``, so
the port makes the same frames from the same seeds without importing the
reference; the drive cycles come with the tracking slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Sequence

import numpy as np

from .images import RoadScene, synthetic_road

# ---------------------------------------------------------------------------
# drawing primitives (all ground truth is derived, never fitted)
# ---------------------------------------------------------------------------


def segment_rho_theta(x0: float, y0: float, x1: float, y1: float
                      ) -> tuple[float, float]:
    """Normal form (rho, theta) of the infinite line through a segment.

    Matches the detector's convention ``x cos(theta) + y sin(theta) = rho``
    with theta canonicalized into [0, pi) (rho flips sign with theta+pi).
    """
    dx, dy = x1 - x0, y1 - y0
    theta = math.atan2(dx, -dy)  # normal direction of (dx, dy)
    rho = x0 * math.cos(theta) + y0 * math.sin(theta)
    if theta < 0.0:
        theta += math.pi
        rho = -rho
    if theta >= math.pi:
        theta -= math.pi
        rho = -rho
    return rho, theta


def _asphalt(height: int, width: int, rng: np.random.Generator, *,
             level: float = 90.0, noise: float = 4.0) -> np.ndarray:
    img = np.full((height, width), level, np.float32)
    img += rng.normal(0.0, noise, img.shape).astype(np.float32)
    return img


def _draw_segment(img: np.ndarray, p0: tuple[float, float],
                  p1: tuple[float, float], intensity: float,
                  width: float = 1.6) -> None:
    """Paint pixels within ``width`` of the segment p0-p1 (clamped ends)."""
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    dx, dy = p1[0] - p0[0], p1[1] - p0[1]
    norm2 = dx * dx + dy * dy + 1e-9
    t = np.clip(((xx - p0[0]) * dx + (yy - p0[1]) * dy) / norm2, 0.0, 1.0)
    dist = np.hypot(xx - (p0[0] + t * dx), yy - (p0[1] + t * dy))
    img[dist <= width] = intensity


def _plant_segment(img: np.ndarray, planted: list, p0, p1,
                   intensity: float, width: float = 1.6) -> None:
    _draw_segment(img, p0, p1, intensity, width)
    planted.append(segment_rho_theta(*p0, *p1))


def _finish(img: np.ndarray, planted: Sequence[tuple[float, float]]
            ) -> RoadScene:
    out = np.clip(img, 0, 255).astype(np.uint8)
    truth = np.array(planted, np.float32).reshape(-1, 2)
    return RoadScene(out, truth)


def _upward_direction(theta_deg: float) -> tuple[float, float]:
    """Unit direction along a line with normal angle ``theta_deg``,
    oriented to travel toward the top of the frame (dy <= 0)."""
    theta = math.radians(theta_deg)
    dx, dy = math.sin(theta), -math.cos(theta)
    if dy > 0:
        dx, dy = -dx, -dy
    return dx, dy


def _walk_up(p0: tuple[float, float], theta_deg: float, y_stop: float
             ) -> tuple[float, float]:
    """Endpoint of the stroke from ``p0`` along the ``theta_deg`` line's
    upward direction, stopping at height ``y_stop``."""
    dx, dy = _upward_direction(theta_deg)
    span = (p0[1] - y_stop) / max(-dy, 1e-6)
    return p0[0] + span * dx, p0[1] + span * dy


def _lane_endpoints(height: int, width: int, x_bottom_frac: float,
                    theta_deg: float, *, y_top_frac: float = 0.05,
                    y_bottom_frac: float = 0.98):
    """Endpoints of a lane stroke with a prescribed normal angle, anchored
    at ``x_bottom_frac * width`` on the bottom edge."""
    p0 = (x_bottom_frac * width, y_bottom_frac * height)
    return p0, _walk_up(p0, theta_deg, y_top_frac * height)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioFamily:
    name: str
    make: Callable[..., RoadScene]   # (height, width, seed) -> RoadScene
    f1_floor: float                  # regression bar for the quality harness
    description: str


_REGISTRY: dict[str, ScenarioFamily] = {}


def _register(name: str, f1_floor: float, description: str):
    def deco(fn):
        _REGISTRY[name] = ScenarioFamily(name, fn, f1_floor, description)
        return fn
    return deco


def scenario_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_family(name: str) -> ScenarioFamily:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def make_scenario(name: str, height: int = 240, width: int = 320, *,
                  seed: int = 0) -> RoadScene:
    return get_family(name).make(height, width, seed=seed)


# --- families --------------------------------------------------------------


@_register("straight", 0.9,
           "two near-vertical lane strokes, highway straightaway")
def _straight(height: int, width: int, *, seed: int = 0) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = _asphalt(height, width, rng)
    planted: list = []
    for fx, deg in ((0.30, 8.0), (0.70, 172.0)):
        p0, p1 = _lane_endpoints(
            height, width, fx + rng.uniform(-0.02, 0.02),
            deg + rng.uniform(-2.0, 2.0),
        )
        _plant_segment(img, planted, p0, p1, 235.0)
    return _finish(img, planted)


@_register("converging", 0.85,
           "the seed workload: two converging lane lines (images.py)")
def _converging(height: int, width: int, *, seed: int = 0) -> RoadScene:
    return synthetic_road(height, width, seed=seed)


@_register("dashed", 0.85, "converging lanes with dashed center markings")
def _dashed(height: int, width: int, *, seed: int = 0) -> RoadScene:
    return synthetic_road(height, width, seed=seed, dashed=True)


@_register("curved", 0.7,
           "gentle curve as a 2-segment polyline per lane, truth per segment")
def _curved(height: int, width: int, *, seed: int = 0) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = _asphalt(height, width, rng)
    planted: list = []
    # a bend whose curvature eases toward the horizon: each lane is two
    # segments, the upper one rotated ~8 degrees toward vertical, so both
    # polylines converge without crossing and every segment keeps a sharp
    # Hough peak (near-vertical strokes concentrate votes).
    for fx, deg, bend in ((0.30, 22.0, -12.0), (0.70, 158.0, 12.0)):
        deg += rng.uniform(-2.0, 2.0)
        p0 = (fx * width, 0.98 * height)
        pm = _walk_up(p0, deg, 0.50 * height)
        _plant_segment(img, planted, p0, pm, 235.0)
        _plant_segment(
            img, planted, pm, _walk_up(pm, deg + bend, 0.10 * height), 235.0
        )
    return _finish(img, planted)


@_register("night", 0.85,
           "low-contrast night scene: dim markings on dark asphalt")
def _night(height: int, width: int, *, seed: int = 0) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = _asphalt(height, width, rng, level=42.0, noise=5.0)
    planted: list = []
    for fx, deg in ((0.35, 35.0), (0.65, 145.0)):
        p0, p1 = _lane_endpoints(
            height, width, fx, deg + rng.uniform(-3.0, 3.0),
            y_bottom_frac=0.9, y_top_frac=0.1,
        )
        _plant_segment(img, planted, p0, p1, 130.0)
    return _finish(img, planted)


@_register("glare", 0.75,
           "oncoming-headlight glare: bright soft blobs over the lanes")
def _glare(height: int, width: int, *, seed: int = 0) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = _asphalt(height, width, rng)
    planted: list = []
    for fx, deg in ((0.35, 35.0), (0.65, 145.0)):
        p0, p1 = _lane_endpoints(height, width, fx,
                                 deg + rng.uniform(-3.0, 3.0))
        _plant_segment(img, planted, p0, p1, 235.0)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for _ in range(3):
        cx = rng.uniform(0.15, 0.85) * width
        cy = rng.uniform(0.05, 0.4) * height
        r = rng.uniform(0.03, 0.07) * min(height, width)
        blob = 165.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                              / (2.0 * r * r))
        img = np.minimum(img + blob, 255.0)
    return _finish(img, planted)


@_register("rain", 0.85,
           "rain/sensor speckle: salt-and-pepper noise over the lanes")
def _rain(height: int, width: int, *, seed: int = 0) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = _asphalt(height, width, rng)
    planted: list = []
    for fx, deg in ((0.35, 35.0), (0.65, 145.0)):
        p0, p1 = _lane_endpoints(height, width, fx,
                                 deg + rng.uniform(-3.0, 3.0))
        _plant_segment(img, planted, p0, p1, 235.0)
    speck = rng.uniform(size=img.shape)
    img[speck < 0.004] = 255.0
    img[speck > 0.996] = 0.0
    return _finish(img, planted)


@_register("occlusion", 0.85,
           "partial occlusion: a vehicle-sized patch blanks one lane's midsection")
def _occlusion(height: int, width: int, *, seed: int = 0) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = _asphalt(height, width, rng)
    planted: list = []
    for fx, deg in ((0.35, 35.0), (0.65, 145.0)):
        p0, p1 = _lane_endpoints(height, width, fx,
                                 deg + rng.uniform(-3.0, 3.0))
        _plant_segment(img, planted, p0, p1, 235.0)
    # occluder painted AFTER the lanes erases their midsections; its own
    # edges are short enough to stay under the relative peak threshold.
    x0 = int(rng.uniform(0.3, 0.45) * width)
    y0 = int(rng.uniform(0.35, 0.5) * height)
    w = int(0.18 * width)
    h = int(0.14 * height)
    img[y0:y0 + h, x0:x0 + w] = 108.0 + rng.normal(
        0.0, 3.0, (min(h, height - y0), min(w, width - x0))
    ).astype(np.float32)
    return _finish(img, planted)


@_register("multilane", 0.85,
           "perspective 4-lane: strokes converging on a vanishing point")
def _multilane(height: int, width: int, *, seed: int = 0) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = _asphalt(height, width, rng)
    planted: list = []
    vx = (0.5 + rng.uniform(-0.03, 0.03)) * width
    vy = 0.04 * height
    for fx in (0.18, 0.40, 0.60, 0.82):
        x0 = fx * width
        y0 = 0.98 * height
        # draw from the bottom edge toward (not into) the vanishing point
        t = (0.32 * height - y0) / (vy - y0)
        p1 = (x0 + t * (vx - x0), y0 + t * (vy - y0))
        _plant_segment(img, planted, (x0, y0), p1, 235.0)
    return _finish(img, planted)


@_register("fog", 0.85,
           "atmospheric haze: contrast decays exponentially toward the horizon")
def _fog(height: int, width: int, *, seed: int = 0) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = _asphalt(height, width, rng)
    planted: list = []
    for fx, deg in ((0.35, 30.0), (0.65, 150.0)):
        p0, p1 = _lane_endpoints(
            height, width, fx, deg + rng.uniform(-3.0, 3.0),
            y_top_frac=0.12,
        )
        _plant_segment(img, planted, p0, p1, 235.0)
    # Koschmieder scattering: I = I0*t + A*(1-t) with transmission
    # t = exp(-beta * depth); rows near the top of the frame are far away,
    # so their contrast collapses toward the airlight A.  beta is drawn so
    # the worst seed still leaves the upper lane ends ~25 gray levels
    # above the hazed asphalt — visible, but a real low-contrast regime.
    airlight = 190.0
    beta = rng.uniform(1.1, 1.5)
    depth = np.linspace(1.0, 0.0, height, dtype=np.float32)[:, None]
    t = np.exp(-beta * depth)
    img = img * t + airlight * (1.0 - t)
    return _finish(img, planted)


@_register("lens_distortion", 0.85,
           "mild barrel distortion: straight markings bow toward the rim")
def _lens_distortion(height: int, width: int, *, seed: int = 0) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = _asphalt(height, width, rng)
    planted: list = []
    for fx, deg in ((0.32, 25.0), (0.68, 155.0)):
        p0, p1 = _lane_endpoints(height, width, fx,
                                 deg + rng.uniform(-2.0, 2.0))
        _plant_segment(img, planted, p0, p1, 235.0)
    # Barrel remap (inverse mapping, nearest-neighbour): the sampled source
    # radius grows as r*(1 + k1*(r/rmax)^2), bowing straight strokes by at
    # most ~k1*rmax pixels at the rim.  k1 is small enough that the
    # dominant Hough peak of each bowed stroke stays within the harness's
    # (4 px, 3 deg) matching tolerance of the undistorted ground truth —
    # the family measures robustness to mild uncorrected optics, not a
    # fisheye rectifier.
    k1 = rng.uniform(0.010, 0.018)
    cy, cx = (height - 1) / 2.0, (width - 1) / 2.0
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    dx, dy = xx - cx, yy - cy
    r = np.hypot(dx, dy)
    rmax = math.hypot(cx, cy)
    scale = 1.0 + k1 * (r / rmax) ** 2
    sx = np.clip(np.rint(cx + dx * scale), 0, width - 1).astype(np.int32)
    sy = np.clip(np.rint(cy + dy * scale), 0, height - 1).astype(np.int32)
    img = img[sy, sx]
    return _finish(img, planted)


@_register("empty", 0.99, "no markings at all: false-positive control")
def _empty(height: int, width: int, *, seed: int = 0) -> RoadScene:
    rng = np.random.default_rng(seed)
    img = _asphalt(height, width, rng)
    return _finish(img, [])


# ---------------------------------------------------------------------------
# batch / stream assembly (heterogeneous inputs for the fast paths)
# ---------------------------------------------------------------------------


def scenario_batch(names: Sequence[str], height: int = 240, width: int = 320,
                   *, seed: int = 0) -> tuple[np.ndarray, list[np.ndarray]]:
    """Stack a heterogeneous batch: (N, H, W) f32 images + per-frame truth.

    ``names`` may repeat (e.g. 8 frames of one family) or mix families —
    the stack is what ``LineDetector.detect_batch`` consumes directly.
    """
    scenes = [
        make_scenario(n, height, width, seed=seed + i)
        for i, n in enumerate(names)
    ]
    imgs = np.stack([s.image for s in scenes]).astype(np.float32)
    return imgs, [s.lines_rho_theta for s in scenes]


def scenario_stream(name: str, n_frames: int, height: int = 240,
                    width: int = 320, *, seed: int = 0
                    ) -> Iterator[RoadScene]:
    """Drifting-seed frame generator; ``name="mixed"`` rotates families."""
    if name == "mixed":
        fams = scenario_names()
        for t in range(n_frames):
            yield make_scenario(fams[t % len(fams)], height, width,
                                seed=seed + t)
    else:
        for t in range(n_frames):
            yield make_scenario(name, height, width, seed=seed + t)
