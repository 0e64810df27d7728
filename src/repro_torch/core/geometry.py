"""Bird's-eye (inverse-perspective) geometry: image-plane lines to
metric ground-plane lane boundaries under a fixed camera model
(``repro/core/geometry.py``, copied as numpy).

The detector emits lines as Hough ``(rho, theta)`` pairs in *image*
coordinates (``x*cos(theta) + y*sin(theta) = rho``, x right, y DOWN,
theta in [0, pi)).  Steering needs those lines on the *ground plane* in
meters, in the vehicle frame (X right, Y forward).  For a pinhole camera
at height ``h`` above a flat ground plane, pitched down by ``phi``, the
image-to-ground map is a homography — and a homography maps lines to
lines, so a detected boundary converts to a metric ground line in closed
form, no per-pixel warp and no sampling.

Camera model (the repro's fixed rig):

  * optical center at height ``h`` over the ground origin,
  * pitched DOWN by ``phi`` from horizontal (so the road fills the lower
    image), no roll, no yaw,
  * focal length ``f`` in pixels, principal point ``(cx, cy)``.

A ground point ``(X, Y)`` (meters; X right, Y forward) sits at camera
coordinates ``(X, h*?, ...)`` — carrying the pitch through gives the
projection

    u - cx = f * X / (Y cos(phi) - ... )

compactly expressed by the 3x3 homography ``G`` below mapping ground
homogeneous coords to image homogeneous coords, with ``M = G^{-1}``
mapping image pixels to ground meters.  Rows above the horizon
``v_h = cy - f tan(phi)`` have no ground intersection (the denominator
changes sign); callers filter on :meth:`CameraGeometry.horizon_v`.

Lines transform contravariantly: an image line with homogeneous coeffs
``l = (cos t, sin t, -r)`` maps to the ground line ``l_g = M^T l``
(so that ``l_g . (X, Y, 1) = l . (u, v, 1) = 0``), renormalized back to
``(rho, theta)`` canonical form.  The round trip (image -> ground ->
image) is exact to float precision.

Everything here is plain numpy/math on scalars: geometry runs on the
host control path, never inside a kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "CameraConfig", "CameraGeometry", "canonical_rho_theta",
    "DEFAULT_CAMERA",
]


def canonical_rho_theta(rho: float, theta: float) -> tuple[float, float]:
    """Canonicalize a line's normal form to theta in [0, pi), flipping
    rho's sign once per pi-wrap (the ``(rho, theta) ~ (-rho, theta+pi)``
    quotient every (rho, theta) consumer in this repo assumes)."""
    k = math.floor(theta / math.pi)
    theta = theta - k * math.pi
    if theta >= math.pi:        # guard the floor's float edge
        theta -= math.pi
        k += 1
    if k % 2:
        rho = -rho
    return rho, theta


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """The fixed rig: pinhole at ``height_m`` over flat ground, pitched
    down ``pitch_deg``, focal ``focal_px``, principal point defaulting
    to the image center.  Defaults are a roof-mounted wide-ish camera
    framing 2-10 m of road ahead at the harness's 240x320."""
    height_m: float = 1.6
    pitch_deg: float = 18.0
    focal_px: float = 280.0
    image_h: int = 240
    image_w: int = 320
    cx: Optional[float] = None      # principal point (None -> center)
    cy: Optional[float] = None

    @property
    def principal(self) -> tuple[float, float]:
        cx = (self.image_w - 1) / 2.0 if self.cx is None else self.cx
        cy = (self.image_h - 1) / 2.0 if self.cy is None else self.cy
        return cx, cy

    def for_image(self, height: int, width: int) -> "CameraConfig":
        """The same physical rig behind a rescaled sensor: focal length
        and principal point scale with resolution, the mounting (height,
        pitch) does not.  This is how the service reuses one camera model
        across resolution buckets."""
        if (height, width) == (self.image_h, self.image_w):
            return self
        sy = height / self.image_h
        sx = width / self.image_w
        cx, cy = self.principal
        return dataclasses.replace(
            self, image_h=height, image_w=width,
            focal_px=self.focal_px * (sx + sy) / 2.0,
            cx=cx * sx, cy=cy * sy,
        )


DEFAULT_CAMERA = CameraConfig()


class CameraGeometry:
    """Closed-form image <-> ground maps for one :class:`CameraConfig`.

    Builds the 3x3 ground->image homography ``G`` once; points and lines
    convert by 3-vector products.  Ground frame: X right (+m), Y forward
    (+m), origin on the ground directly under the camera.
    """

    def __init__(self, cfg: CameraConfig = DEFAULT_CAMERA):
        self.cfg = cfg
        phi = math.radians(cfg.pitch_deg)
        f, h = cfg.focal_px, cfg.height_m
        cx, cy = cfg.principal
        sp, cp = math.sin(phi), math.cos(phi)
        # Camera frame: x right, y down, z optical axis.  Pitch-down by
        # phi maps ground (X, Y) at height -h (camera at +h) to camera
        # coords (X, h*cp - Y*sp, Y*cp + h*sp); projecting with focal f
        # and principal point (cx, cy) gives image homogeneous coords
        # G @ (X, Y, 1):
        self.G = np.array([
            [f,   cx * cp,            cx * sp * h],
            [0.0, cy * cp - f * sp,   (f * cp + cy * sp) * h],
            [0.0, cp,                 sp * h],
        ], float)
        self.M = np.linalg.inv(self.G)          # image -> ground
        self._sp, self._cp, self._f, self._h = sp, cp, f, h
        self._cx, self._cy = cx, cy

    # --- horizon ---------------------------------------------------------
    @property
    def horizon_v(self) -> float:
        """Image row of the ground plane's vanishing line: pixels at or
        above it (v <= horizon) never intersect the ground ahead."""
        return self._cy - self._f * self._sp / self._cp

    # --- points ----------------------------------------------------------
    def pixel_to_ground(self, u: float, v: float) -> tuple[float, float]:
        """Ground (X, Y) in meters under pixel (u, v).  Pixels at/above
        the horizon raise ValueError — they see sky, not road."""
        p = self.M @ (float(u), float(v), 1.0)
        if p[2] <= 1e-12:
            raise ValueError(
                f"pixel (u={u}, v={v}) is at/above the horizon "
                f"v_h={self.horizon_v:.2f}: no ground intersection"
            )
        return float(p[0] / p[2]), float(p[1] / p[2])

    def ground_to_pixel(self, X: float, Y: float) -> tuple[float, float]:
        """Image (u, v) of ground point (X, Y) meters (Y > 0 required:
        the camera faces forward)."""
        q = self.G @ (float(X), float(Y), 1.0)
        if q[2] <= 1e-12:
            raise ValueError(f"ground point (X={X}, Y={Y}) is behind "
                             "or at the camera plane")
        return float(q[0] / q[2]), float(q[1] / q[2])

    # --- lines -----------------------------------------------------------
    def line_to_ground(self, rho: float, theta: float
                       ) -> tuple[float, float]:
        """Map an image-plane Hough line (rho, theta) to its ground-plane
        normal form (rho_g [m], theta_g in [0, pi)).

        An image line ``l = (cos t, sin t, -r)`` (``l . (u, v, 1) = 0``)
        pulls back through the ground->image homography to
        ``l_g = G^T l`` — points satisfy ``l_g . (X, Y, 1) = l . G(X,Y,1)
        = 0``.  Degenerate only if the image line is the horizon itself
        (its ground image is the line at infinity): ValueError.
        """
        l = (math.cos(theta), math.sin(theta), -float(rho))
        a = self.G[0, 0] * l[0] + self.G[1, 0] * l[1] + self.G[2, 0] * l[2]
        b = self.G[0, 1] * l[0] + self.G[1, 1] * l[1] + self.G[2, 1] * l[2]
        c = self.G[0, 2] * l[0] + self.G[1, 2] * l[1] + self.G[2, 2] * l[2]
        n = math.hypot(a, b)
        if n < 1e-9:
            raise ValueError(
                f"image line (rho={rho}, theta={theta}) is the horizon: "
                "no finite ground line"
            )
        return canonical_rho_theta(-c / n, math.atan2(b, a))

    def line_to_image(self, rho_g: float, theta_g: float
                      ) -> tuple[float, float]:
        """Inverse of :meth:`line_to_ground`: ground normal form back to
        the image-plane (rho, theta)."""
        l_g = (math.cos(theta_g), math.sin(theta_g), -float(rho_g))
        a = self.M[0, 0] * l_g[0] + self.M[1, 0] * l_g[1] \
            + self.M[2, 0] * l_g[2]
        b = self.M[0, 1] * l_g[0] + self.M[1, 1] * l_g[1] \
            + self.M[2, 1] * l_g[2]
        c = self.M[0, 2] * l_g[0] + self.M[1, 2] * l_g[1] \
            + self.M[2, 2] * l_g[2]
        n = math.hypot(a, b)
        if n < 1e-9:
            raise ValueError(
                f"ground line (rho={rho_g}, theta={theta_g}) maps to the "
                "image's line at infinity"
            )
        return canonical_rho_theta(-c / n, math.atan2(b, a))

    def lines_to_ground(self, peaks: np.ndarray,
                        valid: Optional[Sequence[bool]] = None
                        ) -> np.ndarray:
        """Vector form over a (K, 2) peak array (+ optional mask): the
        (M, 2) ground lines of the valid, non-horizon peaks."""
        peaks = np.asarray(peaks, float).reshape(-1, 2)
        if valid is None:
            valid = np.ones(peaks.shape[0], bool)
        out = []
        for (r, t), ok in zip(peaks, np.asarray(valid, bool)):
            if not ok:
                continue
            try:
                out.append(self.line_to_ground(float(r), float(t)))
            except ValueError:
                continue
        return np.array(out, float).reshape(-1, 2)
