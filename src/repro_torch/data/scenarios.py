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

Drive cycles (``make_drive_cycle``, ``standard_drive_cycle``) carry one
base scene through rigid ego-motion, frame by frame, with the exact
(rho, theta) truth of every frame: the tracker's workload.

A numpy copy of ``repro/data/scenarios.py`` up to ``standard_drive_cycle``,
so the port makes the same frames from the same seeds without importing the
reference; the closed-loop cycle comes with the control module.
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


# ---------------------------------------------------------------------------
# drive cycles: temporal sequences with analytic (rho, theta) trajectories
# ---------------------------------------------------------------------------

#: Families whose per-frame detection is noisy enough that the temporal
#: layer must beat it (tracked F1 >= per-frame F1 on their drive cycles).
NOISY_FAMILIES: tuple[str, ...] = ("rain", "night", "glare")


@dataclasses.dataclass(frozen=True)
class DriveCycleFrame:
    """One frame of a drive cycle: a valid RoadScene plus its provenance."""
    scene: RoadScene          # warped image + exactly transformed truth
    t: int                    # frame index within the cycle
    dropout: bool             # camera blackout: lanes exist, signal doesn't
    noise_burst: bool         # extra speckle burst on top of the family
    dx_px: float              # ego lateral translation applied this frame
    yaw_deg: float            # ego rotation applied this frame
    dy_px: float = 0.0        # ego longitudinal translation (surge/bob)


@dataclasses.dataclass(frozen=True)
class DriveCycle:
    """A drive-cycle sequence over one scenario family.

    Frame-to-frame continuity comes from rigid ego-motion over a single
    base scene: every frame is the SAME world (same asphalt texture, same
    planted strokes) seen through a camera that sways, yaws through a
    curvature ramp, and executes a lane change — so the per-frame
    ``lines_rho_theta`` is an exact analytic trajectory, not a re-rolled
    random scene.  Dropout frames keep their trajectory truth (the lanes
    are still there; the camera failed) and carry ``dropout=True`` so the
    harness knows the detector *should* see nothing while a tracker
    *should* coast.
    """
    family: str
    frames: tuple[DriveCycleFrame, ...]

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self) -> Iterator[DriveCycleFrame]:
        return iter(self.frames)

    def images(self) -> list[np.ndarray]:
        return [f.scene.image for f in self.frames]

    def truths(self) -> list[np.ndarray]:
        return [f.scene.lines_rho_theta for f in self.frames]


def _smoothstep(u: np.ndarray | float) -> np.ndarray | float:
    u = np.clip(u, 0.0, 1.0)
    return u * u * (3.0 - 2.0 * u)


def transform_rho_theta(rho: float, theta: float, *, yaw_rad: float,
                        dx: float, dy: float, cx: float, cy: float
                        ) -> tuple[float, float]:
    """Exact (rho, theta) image of a line under the rigid ego-motion
    ``q = R_yaw (p - c) + c + (dx, dy)`` (rotation about the frame center,
    then translation), canonicalized to theta in [0, pi).

    Derivation: the mapped line's normal rotates with the frame
    (theta' = theta + yaw) and its offset picks up the center swing plus
    the translation's projection on the new normal:
    ``rho' = rho - c.n + c.n' + t.n'``.
    """
    tp = theta + yaw_rad
    n = (math.cos(theta), math.sin(theta))
    np_ = (math.cos(tp), math.sin(tp))
    rp = (rho - (cx * n[0] + cy * n[1])
          + (cx * np_[0] + cy * np_[1]) + dx * np_[0] + dy * np_[1])
    # Canonicalize with a true modulo, not a single +-pi correction: the
    # closed-loop harness accumulates yaw without bound, so tp can land
    # any number of wraps outside [0, pi).  Each pi-wrap flips the normal,
    # so rho's sign flips once per wrap parity.
    k = math.floor(tp / math.pi)
    tp -= k * math.pi
    if tp >= math.pi:       # guard the floor's float edge
        tp -= math.pi
        k += 1
    if k % 2:
        rp = -rp
    return rp, tp


def _warp_rigid(img: np.ndarray, *, yaw_rad: float, dx: float, dy: float,
                fill: float) -> np.ndarray:
    """Nearest-neighbour inverse warp of the forward map in
    ``transform_rho_theta``; samples leaving the base frame read ``fill``
    (the family's asphalt level, so the revealed border stays textureless
    and under the Canny thresholds)."""
    H, W = img.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    qx, qy = xx - cx - dx, yy - cy - dy
    c, s = math.cos(yaw_rad), math.sin(yaw_rad)
    sx = np.rint(c * qx + s * qy + cx).astype(np.int64)
    sy = np.rint(-s * qx + c * qy + cy).astype(np.int64)
    inside = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    out = np.full((H, W), np.uint8(np.clip(round(fill), 0, 255)))
    out[inside] = img[sy[inside], sx[inside]]
    return out


def make_drive_cycle(family: str, n_frames: int, height: int = 240,
                     width: int = 320, *, seed: int = 0,
                     sway_px: float = 5.0, sway_period: float = 32.0,
                     surge_px: float = 0.0, surge_period: float = 24.0,
                     yaw_amp_deg: float = 2.5,
                     lane_change_at: int | None = None,
                     lane_change_px: float | None = None,
                     lane_change_len: int = 12,
                     dropout_frames: Sequence[int] = (),
                     noise_burst_frames: Sequence[int] = (),
                     burst_frac: float = 0.012) -> DriveCycle:
    """Parameterized ego-motion over one scenario family.

    The base scene is generated ONCE (``make_scenario(family, seed)``) and
    every frame applies a rigid camera motion to it — sinusoidal lateral
    sway (``sway_px``/``sway_period``), sinusoidal longitudinal surge/bob
    (``surge_px``/``surge_period``, the ``dy`` leg of the rigid motion),
    a curvature ramp that yaws up to
    ``yaw_amp_deg`` mid-cycle and back (half-sine), and an optional
    s-curve lane change of ``lane_change_px`` (default 12% of the width)
    over ``lane_change_len`` frames centered at ``lane_change_at``.  The
    per-frame (rho, theta) ground truth is the exact analytic image of the
    planted lines under the same transform (``transform_rho_theta``), so
    trajectory-recovery assertions carry no fitting slack beyond the
    warp's nearest-neighbour rasterization.

    ``dropout_frames`` replace the listed frames with near-black sensor
    blackout (truth retained, ``dropout=True``); ``noise_burst_frames``
    overlay an extra salt-and-pepper burst.  Both draw from rngs seeded by
    ``(seed, t)`` — the whole cycle is bit-reproducible.
    """
    base = make_scenario(family, height, width, seed=seed)
    cy, cx = (height - 1) / 2.0, (width - 1) / 2.0
    fill = float(np.median(base.image))
    if lane_change_px is None:
        lane_change_px = 0.12 * width
    dropout_set = set(int(t) for t in dropout_frames)
    burst_set = set(int(t) for t in noise_burst_frames)
    span = max(n_frames - 1, 1)

    frames: list[DriveCycleFrame] = []
    for t in range(n_frames):
        dx = sway_px * math.sin(2.0 * math.pi * t / sway_period)
        dy = surge_px * math.sin(2.0 * math.pi * t / surge_period)
        if lane_change_at is not None:
            u = (t - (lane_change_at - lane_change_len / 2.0)) / max(
                lane_change_len, 1
            )
            dx += lane_change_px * float(_smoothstep(u))
        yaw = math.radians(yaw_amp_deg) * math.sin(math.pi * t / span)

        truth = np.array(
            [
                transform_rho_theta(float(r), float(th), yaw_rad=yaw,
                                    dx=dx, dy=dy, cx=cx, cy=cy)
                for r, th in base.lines_rho_theta
            ],
            np.float32,
        ).reshape(-1, 2)

        if t in dropout_set:
            rng = np.random.default_rng([seed, 7_000_000 + t])
            img = np.clip(
                rng.normal(10.0, 3.0, (height, width)), 0, 255
            ).astype(np.uint8)
        else:
            img = _warp_rigid(base.image, yaw_rad=yaw, dx=dx, dy=dy,
                              fill=fill)
            if t in burst_set:
                rng = np.random.default_rng([seed, 9_000_000 + t])
                speck = rng.uniform(size=img.shape)
                img = img.copy()
                img[speck < burst_frac] = 255
                img[speck > 1.0 - burst_frac] = 0

        frames.append(DriveCycleFrame(
            scene=RoadScene(img, truth), t=t,
            dropout=t in dropout_set, noise_burst=t in burst_set,
            dx_px=dx, yaw_deg=math.degrees(yaw), dy_px=dy,
        ))
    return DriveCycle(family, tuple(frames))


def standard_drive_cycle(family: str, n_frames: int = 48,
                         height: int = 240, width: int = 320, *,
                         seed: int = 0) -> DriveCycle:
    """The canonical cycle the test harness, the tracking benchmark, and
    the CI F1 gate all share: sway + curvature ramp + a mid-cycle lane
    change, with a 3-frame dropout and a 4-frame noise burst added on the
    noisy families (``NOISY_FAMILIES``) — the regime where the temporal
    layer must beat per-frame detection."""
    noisy = family in NOISY_FAMILIES
    third = n_frames // 3
    return make_drive_cycle(
        family, n_frames, height, width, seed=seed,
        lane_change_at=n_frames // 2,
        # a lane change is seconds of driving: stretch it with the cycle
        # so its peak pixel velocity stays trackable at any length
        lane_change_len=max(12, n_frames // 2),
        dropout_frames=tuple(range(third, third + 3)) if noisy else (),
        noise_burst_frames=(
            tuple(range(2 * third, 2 * third + 4)) if noisy else ()
        ),
    )
