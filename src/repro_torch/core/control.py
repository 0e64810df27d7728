"""Waypoint extraction and a pure-pursuit lateral controller
(``repro/core/control.py``, copied as numpy).

This is the consumer the detector has been optimized *for*: detected
image lines (raw Hough peaks or smoothed ``LaneTracker`` tracks) become
metric ground-plane lane boundaries (``core.geometry``), the paired
boundaries become a centerline with waypoints, and a pure-pursuit law
turns the lookahead waypoint into a steering command.  The f1tenth
pipeline the ROADMAP names (detection -> centroid/waypoints -> lane
following), grown onto this repo's tracked, deadline-scheduled stack.

Frame conventions (see ``core.geometry``): vehicle/ground frame X right
(+m), Y forward (+m); a positive curvature command turns RIGHT (toward
+X).  The controller reports its *perceived* state alongside the
command — ``cross_track_m`` (vehicle offset right of the lane center)
and ``heading_rad`` (vehicle yaw right of the lane direction) — which
the closed-loop harness checks against the plant's true state.

Fallback ladder (mirrors the service's degradation ladder):

  * both boundaries visible -> centerline = their midpoint   ("pair")
  * one boundary           -> offset by half a lane width    ("left"/"right")
  * nothing usable         -> hold the last command, decayed ("hold"),
                              a zero command once the hold budget is
                              spent or there is no history    ("none")

Everything is host-side numpy/math — control runs per frame on scalars,
never inside a kernel.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np

from .geometry import CameraConfig, CameraGeometry

__all__ = [
    "ControlConfig", "SteeringCommand", "Waypoints", "LateralController",
    "extract_waypoints", "ground_boundaries",
]


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Pure-pursuit + lane-model knobs.

    Defaults are tuned to the synthetic road families under
    ``geometry.DEFAULT_CAMERA``: the "straight" family's boundaries sit
    ~1 m apart on the ground (a narrow test track), visible from ~1.8 m
    (image bottom) to the horizon.
    """
    lookahead_m: float = 2.5        # pure-pursuit target distance
    wheelbase_m: float = 0.33       # steer angle = atan(wheelbase * kappa)
    lane_width_m: float = 1.0       # assumed width for single-boundary mode
    near_m: float = 2.0             # waypoint band start (>= image bottom)
    far_m: float = 6.0              # waypoint band end
    n_waypoints: int = 5
    max_heading_deg: float = 50.0   # lane-like filter: ground heading off Y
    max_curvature: float = 2.0      # command clamp, 1/m
    hold_decay: float = 0.7         # per-frame decay of a held command
    hold_frames: int = 12           # frames a stale command may be held


class Waypoints(NamedTuple):
    """Sampled centerline in the vehicle ground frame."""
    points: np.ndarray      # (n, 2) columns (X right, Y forward), meters
    source: str             # "pair" | "left" | "right" | "none"
    offset_m: float         # centerline lateral offset at Y=0 (= a)
    slope: float            # centerline dX/dY (= b)

    @property
    def found(self) -> bool:
        return self.source != "none"


class SteeringCommand(NamedTuple):
    """One frame's lateral command plus the perceived state behind it."""
    curvature: float        # 1/m, positive turns right (+X)
    steer_rad: float        # atan(wheelbase * curvature)
    cross_track_m: float    # perceived vehicle offset right of lane center
    heading_rad: float      # perceived vehicle yaw right of lane direction
    source: str             # "pair"|"left"|"right"|"hold"|"none"
    age: int                # 0 = fresh observation; k = held for k frames
    t: float                # controller clock at emission

    @property
    def fresh(self) -> bool:
        return self.age == 0 and self.source != "none"


def ground_boundaries(peaks: np.ndarray,
                      valid: Optional[Sequence[bool]],
                      geometry: CameraGeometry,
                      cfg: ControlConfig) -> list[tuple[float, float]]:
    """Detected image peaks -> lane-like ground lines.

    Maps every valid peak through the bird's-eye homography and keeps
    the ones running roughly along the vehicle's forward axis: a ground
    line ``X cos(t) + Y sin(t) = r`` heads within ``max_heading_deg`` of
    the Y axis iff ``|cos(t)| >= cos(max_heading_deg)`` (its normal is
    mostly lateral).  Cross-traffic, stop lines, and horizon artifacts
    fail the filter."""
    lines = geometry.lines_to_ground(np.asarray(peaks), valid)
    min_c = math.cos(math.radians(cfg.max_heading_deg))
    return [(float(r), float(t)) for r, t in lines
            if abs(math.cos(t)) >= min_c]


def _offset_slope(rho_g: float, theta_g: float) -> tuple[float, float]:
    """A lane-like ground line as ``X(Y) = a + b Y`` (valid because the
    lane filter guarantees cos(theta_g) is bounded away from zero)."""
    c, s = math.cos(theta_g), math.sin(theta_g)
    return rho_g / c, -s / c


def _centerline(ab: list[tuple[float, float]], cfg: ControlConfig, *,
                ref: tuple[float, float] = (0.0, 0.0),
                deltas: Optional[dict] = None
                ) -> Optional[tuple[float, float, str]]:
    """Fit the centerline ``X(Y) = a + b Y`` from boundary models ``ab``.

    Boundaries split left/right of the *reference* centerline (``ref``,
    the previous frame's fit — under a big yaw both boundaries can sit
    on the same side of X=0, so splitting around the predicted center is
    what stays stable); the innermost of each side forms the pair.  A
    single visible boundary is offset by the remembered boundary->center
    delta from the last full pair (``deltas``; the road's boundaries
    need not be parallel, so a fixed half-width + the boundary's own
    slope would bias both offset and heading), falling back to the
    ``lane_width_m`` prior when there is no pair history."""
    if not ab:
        return None
    near = cfg.near_m
    ref_near = ref[0] + ref[1] * near
    x_near = [a + b * near for a, b in ab]
    left = [i for i, x in enumerate(x_near) if x < ref_near]
    right = [i for i, x in enumerate(x_near) if x >= ref_near]
    if left and right:
        li = max(left, key=lambda i: x_near[i])     # innermost left
        ri = min(right, key=lambda i: x_near[i])    # innermost right
        a = (ab[li][0] + ab[ri][0]) / 2.0
        b = (ab[li][1] + ab[ri][1]) / 2.0
        if deltas is not None:
            deltas["left"] = (a - ab[li][0], b - ab[li][1])
            deltas["right"] = (a - ab[ri][0], b - ab[ri][1])
        return a, b, "pair"
    if left:
        li = max(left, key=lambda i: x_near[i])
        d = (deltas or {}).get("left")
        if d is None:
            d = (cfg.lane_width_m / 2.0, 0.0)
        return ab[li][0] + d[0], ab[li][1] + d[1], "left"
    ri = min(right, key=lambda i: x_near[i])
    d = (deltas or {}).get("right")
    if d is None:
        d = (-cfg.lane_width_m / 2.0, 0.0)
    return ab[ri][0] + d[0], ab[ri][1] + d[1], "right"


def _sample(a: float, b: float, cfg: ControlConfig) -> np.ndarray:
    ys = np.linspace(cfg.near_m, cfg.far_m, cfg.n_waypoints)
    return np.stack([a + b * ys, ys], axis=1)


def extract_waypoints(peaks: np.ndarray,
                      valid: Optional[Sequence[bool]],
                      geometry: CameraGeometry,
                      cfg: ControlConfig = ControlConfig()) -> Waypoints:
    """Centerline waypoints from one frame's detections, stateless: the
    pair/single-boundary ladder with the vehicle axis as the split
    reference and the half-lane-width prior for singles.  The
    :class:`LateralController` runs the same fit with cross-frame memory
    (previous centerline as the split reference, remembered
    boundary->center deltas); this function is the one-shot form for
    tests and ad-hoc callers."""
    bounds = ground_boundaries(peaks, valid, geometry, cfg)
    fit = _centerline([_offset_slope(r, t) for r, t in bounds], cfg)
    if fit is None:
        return Waypoints(np.zeros((0, 2)), "none", 0.0, 0.0)
    a, b, source = fit
    return Waypoints(_sample(a, b, cfg), source, float(a), float(b))


class LateralController:
    """Pure-pursuit lane following on an injectable clock.

    ``command(peaks, valid)`` ingests one frame's detections (raw peaks,
    or tracks via ``tracks_as_peaks`` — anything in image (rho, theta)
    form), extracts the centerline, and steers at the lookahead point
    ``(X_L, L)``: ``kappa = 2 X_L / (X_L^2 + L^2)``, the circle through
    the vehicle tangent to its heading.  With the centerline model
    ``X(Y) = a + b Y`` this is a PD law in disguise — ``a`` is the
    (negated) cross-track error and ``b L`` contributes the heading
    damping — which is why the closed loop converges without a separate
    rate term.

    ``hold()`` is the no-answer path (dropout, shed request, refused
    frame): re-emit the last command decayed by ``hold_decay``, up to
    ``hold_frames`` consecutive frames, then command straight.  The
    decay chain composes: k held frames scale the last fresh curvature
    by ``hold_decay^k``, so a blackout eases the vehicle straight
    instead of freezing it into a circle.

    Cross-frame lane memory: the controller keeps the last fitted
    centerline (the left/right split reference — stable under yaw, when
    both boundaries can sit on one side of the vehicle axis) and the
    last full pair's boundary->center deltas (so a single visible
    boundary reconstructs the centerline the pair would have given,
    instead of leaning on the half-width prior).  ``reset()`` drops the
    memory at a stream boundary.
    """

    def __init__(self, geometry: Optional[CameraGeometry] = None,
                 cfg: ControlConfig = ControlConfig(), *,
                 clock: Callable[[], float] = time.perf_counter):
        self.geometry = geometry if geometry is not None \
            else CameraGeometry(CameraConfig())
        self.cfg = cfg
        self.clock = clock
        self.last: Optional[SteeringCommand] = None
        self.waypoints: Optional[Waypoints] = None
        self._ref = (0.0, 0.0)          # last centerline (a, b)
        self._deltas: dict = {}         # boundary->center deltas
        self.fresh_commands = 0
        self.held_commands = 0

    def reset(self) -> None:
        self.last = None
        self.waypoints = None
        self._ref = (0.0, 0.0)
        self._deltas = {}

    # --- command paths ---------------------------------------------------
    def command(self, peaks, valid: Optional[Sequence[bool]] = None
                ) -> SteeringCommand:
        """Steer from one frame's detections (falls back to ``hold()``
        when nothing lane-like is visible)."""
        peaks = _as_peaks(peaks)
        bounds = ground_boundaries(peaks, valid, self.geometry, self.cfg)
        fit = _centerline([_offset_slope(r, t) for r, t in bounds],
                          self.cfg, ref=self._ref, deltas=self._deltas)
        if fit is None:
            return self.hold()
        a, b, source = fit
        self._ref = (a, b)
        cfg = self.cfg
        L = cfg.lookahead_m
        x_l = a + b * L
        kappa = 2.0 * x_l / (x_l * x_l + L * L)
        kappa = max(-cfg.max_curvature, min(cfg.max_curvature, kappa))
        cmd = SteeringCommand(
            curvature=kappa,
            steer_rad=math.atan(cfg.wheelbase_m * kappa),
            cross_track_m=-a,
            heading_rad=-math.atan(b),
            source=source, age=0, t=self.clock(),
        )
        self.waypoints = Waypoints(_sample(a, b, cfg), source,
                                   float(a), float(b))
        self.last = cmd
        self.fresh_commands += 1
        return cmd

    def hold(self) -> SteeringCommand:
        """The no-observation fallback: decay and re-emit the last
        command, or command straight once the budget is spent."""
        cfg = self.cfg
        prev = self.last
        if prev is not None and prev.age < cfg.hold_frames \
                and prev.source != "none":
            kappa = prev.curvature * cfg.hold_decay
            cmd = SteeringCommand(
                curvature=kappa,
                steer_rad=math.atan(cfg.wheelbase_m * kappa),
                cross_track_m=prev.cross_track_m,
                heading_rad=prev.heading_rad,
                source="hold", age=prev.age + 1, t=self.clock(),
            )
        else:
            cmd = SteeringCommand(0.0, 0.0, 0.0, 0.0, "none",
                                  (prev.age + 1) if prev is not None else 0,
                                  self.clock())
        self.last = cmd
        self.held_commands += 1
        return cmd


def _as_peaks(obs) -> np.ndarray:
    """Accept detector peaks ((K, 2) array) or tracker ``Track`` objects
    (anything with .rho/.theta) without importing the tracking module."""
    if isinstance(obs, np.ndarray):
        return obs.reshape(-1, 2)
    seq = list(obs)
    if seq and hasattr(seq[0], "rho"):
        return np.array([[t.rho, t.theta] for t in seq],
                        float).reshape(-1, 2)
    return np.asarray(seq, float).reshape(-1, 2)
