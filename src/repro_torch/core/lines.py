"""Get-lines-coordinates (``repro/core/lines.py``, paper Algorithm 3).

Local-maximum search over the vote accumulator, then each (rho, theta)
peak becomes the endpoints of a segment.  Static shapes: exactly
``max_lines`` rows plus a validity mask.

Vote counts are integers, so equal scores are common; the top-k keeps the
reference's order among them (``jax.lax.top_k`` gives the lower index
first), which ``torch.topk`` does not promise, so it is a stable
descending sort.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LinesConfig:
    threshold: float = 80.0   # min votes for a peak (paper's threshold)
    # If set, the threshold is max(floor, rel * max(votes)), the floor
    # being min_votes or min_votes_frac * image diagonal.
    threshold_rel: float | None = 0.5
    min_votes: float | None = None
    min_votes_frac: float = 0.09
    neighborhood: int = 7     # local-max window
    max_lines: int = 16       # static K
    rho_res: float = 1.0
    n_theta: int = 180


def _maxpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max over the trailing two axes, -inf outside ("SAME")."""
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + x.shape[-2:])
    lo, hi = (k - 1) // 2, k // 2
    x4 = F.pad(x4, (lo, hi, lo, hi), value=-math.inf)
    return F.max_pool2d(x4, k, stride=1).reshape(lead + x.shape[-2:])


def get_lines(votes: torch.Tensor, *, height: int, width: int,
              cfg: LinesConfig = LinesConfig(),
              theta_bins: torch.Tensor | None = None):
    """Returns (lines (..., K, 4) f32 [x1, y1, x2, y2], valid (..., K) bool,
    peaks (..., K, 2) f32 [rho, theta_rad]).

    ``votes`` is (n_rho, n_theta) or (N, n_rho, n_theta).  With
    ``theta_bins`` (B,), ``votes`` is a band accumulator whose column k is
    global theta bin ``theta_bins[k]``.
    """
    n_rho, n_theta = votes.shape[-2:]
    diag = math.hypot(height, width)

    if cfg.threshold_rel is not None:
        floor = (cfg.min_votes if cfg.min_votes is not None
                 else cfg.min_votes_frac * diag)
        thresh = (
            cfg.threshold_rel * votes.amax(dim=(-2, -1), keepdim=True)
        ).clamp_min(floor)
    else:
        thresh = cfg.threshold
    is_peak = (votes >= thresh) & (votes >= _maxpool(votes, cfg.neighborhood))
    score = torch.where(is_peak, votes, -1.0).reshape(
        votes.shape[:-2] + (n_rho * n_theta,)
    )
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top, idx = top[..., : cfg.max_lines], idx[..., : cfg.max_lines]
    valid = top > 0

    rho_idx = idx // n_theta
    theta_idx = idx % n_theta
    if theta_bins is not None:
        theta_idx = theta_bins.to(torch.int64)[theta_idx]
        theta_scale = math.pi / cfg.n_theta  # bins index the FULL sweep
    else:
        theta_scale = math.pi / n_theta
    rho = rho_idx.to(torch.float32) * cfg.rho_res - diag
    theta = theta_idx.to(torch.float32) * theta_scale

    lines = peak_segments(rho, theta, half=float(max(height, width)))
    peaks = torch.stack([rho, theta], dim=-1)
    return lines, valid, peaks


def peak_segments(rho: torch.Tensor, theta: torch.Tensor, *, half: float
                  ) -> torch.Tensor:
    """(..., 4) endpoints [x1, y1, x2, y2] of normal-form lines: +-``half``
    along the line from the foot of the perpendicular."""
    rho = torch.as_tensor(rho, dtype=torch.float32)
    theta = torch.as_tensor(theta, dtype=torch.float32)
    c, s = torch.cos(theta), torch.sin(theta)
    x0, y0 = c * rho, s * rho
    return torch.stack(
        [x0 - half * s, y0 + half * c, x0 + half * s, y0 - half * c], dim=-1
    )


def render_lines(image: torch.Tensor, lines: torch.Tensor,
                 valid: torch.Tensor, *, thickness: float = 1.5
                 ) -> torch.Tensor:
    """Paper phase 3: paint every valid line red over a gray frame.

    (..., H, W) image, (..., K, 4) lines, (..., K) valid ->
    (..., H, W, 3) uint8.
    """
    H, W = image.shape[-2:]
    dev = image.device
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    x1, y1 = lines[..., 0], lines[..., 1]
    x2, y2 = lines[..., 2], lines[..., 3]
    dx, dy = x2 - x1, y2 - y1
    norm = torch.sqrt(dx * dx + dy * dy) + 1e-9
    dist = (
        dy[..., None, None] * (xx - x1[..., None, None])
        - dx[..., None, None] * (yy - y1[..., None, None])
    ).abs() / norm[..., None, None]
    hit = ((dist <= thickness) & valid[..., None, None]).any(dim=-3)
    out = torch.stack([image, image, image], dim=-1).to(torch.uint8)
    # built on the device: a host constant would be a blocking copy
    red = (torch.arange(3, device=dev) == 0).to(torch.uint8) * 255
    return torch.where(hit[..., None], red, out)
