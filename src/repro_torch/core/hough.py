"""Hough transform in GEMM + histogram form (``repro/core/hough.py``).

``rho = x cos(theta) + y sin(theta)`` for every edge pixel and angle,
shifted by the image diagonal and binned at ``rho_res`` through one
homogeneous ``(x, y, 1) @ trig`` product, then a weighted histogram: the
vote kernel (``kernels/csrc/hough_vote.cu``) on the card, its plain version
on the CPU.  ``HoughConfig(compact=True)`` compacts the edge pixels first.

:func:`hough_paper_loop` is the paper's Algorithm 2, serial: a Python
loop over the pixels with a vectorised theta sweep, the measured baseline
of the platform comparison (``configs.paper_lines.PLATFORMS["rocket"]``).

``max_edges="auto"`` sizes the compaction buffer from the workload.  The
reference's tiered dispatch (``lax.switch`` over a static set of buffer
sizes, picked by the on-device edge count) has no sync-free counterpart in
eager PyTorch, so :func:`hough_transform_tiered` compacts into the cap
tier and lets the vote kernel read each frame's exact edge count from
device memory and skip the rows past it.  That is bit-exact with the
tiered reference: the count is exact, so only the cap tier can drop edges,
and it drops the same trailing ones.

The fused hot path (:func:`fused_hough`, :func:`fused_hough_tiered`) goes
from frames straight to votes: the ``fused_detect`` kernel runs Canny, the
edge threshold, the tracker's rho-corridor filter and raster compaction,
and the vote kernel reads its rows.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class HoughConfig:
    n_theta: int = 180          # 1-degree bins, theta in [0, 180)
    rho_res: float = 1.0        # rho bin width (pixels)
    edge_threshold: float = 250.0  # paper: image[i*width+j] >= 250
    # Edge compaction: vote over at most ``max_edges`` compacted edge pixels
    # (None: 1/16 of the pixel count; "auto": sized from the edge count).
    compact: bool = False
    max_edges: int | str | None = None
    # Prediction-gated voting: a static band width; the bin values come
    # with each call (the tracker slides the gate per frame).
    theta_band: int | None = None
    # Rho-corridor edge pre-filter of the fused path: a static corridor
    # count; the (corridors, 4) windows ``[cos, sin, rho_lo, rho_hi]`` come
    # with each call (``tracking.LaneTracker.corridors``).  None = no filter.
    corridors: int | None = None


# Corridor windows wider than any image diagonal: (-INF, INF) passes all.
CORRIDOR_INF = 1e9


def full_corridors(n: int = 1) -> np.ndarray:
    """(n, 4) corridor rows that pass every pixel."""
    row = np.array([1.0, 0.0, -CORRIDOR_INF, CORRIDOR_INF], np.float32)
    return np.tile(row, (n, 1))


def rho_bins(height: int, width: int, cfg: HoughConfig) -> int:
    diag = math.hypot(height, width)
    return int(2.0 * diag / cfg.rho_res) + 1


def hough_trig(height: int, width: int, cfg: HoughConfig) -> np.ndarray:
    """(3, n_theta) homogeneous trig table: rows ``cos/rho_res``,
    ``sin/rho_res`` and the ``+diag`` shift, so ``floor(xy @ trig)`` is the
    rho bin index.  numpy, identical to the reference's table."""
    diag = math.hypot(height, width)
    theta = np.arange(cfg.n_theta, dtype=np.float32) * (math.pi / cfg.n_theta)
    return np.stack(
        [
            np.cos(theta) / cfg.rho_res,
            np.sin(theta) / cfg.rho_res,
            np.full_like(theta, diag / cfg.rho_res),
        ]
    ).astype(np.float32)


@functools.cache
def _device_trig(height: int, width: int, cfg: HoughConfig,
                 device: torch.device) -> torch.Tensor:
    return torch.from_numpy(hough_trig(height, width, cfg)).to(device)


@functools.cache
def _device_raster(height: int, width: int, device: torch.device
                   ) -> torch.Tensor:
    """(H*W, 3) f32 homogeneous raster coordinates ``(col, row, 1)``."""
    jj, ii = np.meshgrid(np.arange(width), np.arange(height))
    xy = np.stack([jj.ravel(), ii.ravel(), np.ones(height * width)], axis=1)
    return torch.from_numpy(xy.astype(np.float32)).to(device)


def max_edge_tiers(height: int, width: int, *, base: int = 512
                   ) -> tuple[int, ...]:
    """Geometric compaction-buffer sizes ``base, 2*base, ...`` capped at
    (and always including) ``ops.default_max_edges``."""
    cap = ops.default_max_edges(height * width)
    tiers = []
    t = base
    while t < cap:
        tiers.append(t)
        t *= 2
    tiers.append(cap)
    return tuple(tiers)


def auto_max_edges(n_edges: int, height: int, width: int, *,
                   base: int = 512) -> int:
    """The smallest tier that holds ``n_edges``, capped at the default."""
    tiers = max_edge_tiers(height, width, base=base)
    for t in tiers:
        if int(n_edges) <= t:
            return t
    return tiers[-1]


def resolved_auto_config(cfg: HoughConfig, n_edges: int, height: int,
                         width: int) -> HoughConfig:
    """Shared tail of ``max_edges="auto"`` resolution: inert (None) on the
    dense path, the bucketed buffer on the compacted one."""
    if not cfg.compact:
        return dataclasses.replace(cfg, max_edges=None)
    return dataclasses.replace(
        cfg, max_edges=auto_max_edges(n_edges, height, width)
    )


def resolve_max_edges(edges: torch.Tensor, cfg: HoughConfig) -> HoughConfig:
    """Resolve ``max_edges="auto"`` against a concrete edge map (one host
    readback of the max per-frame count)."""
    if cfg.max_edges != "auto":
        return cfg
    H, W = edges.shape[-2:]
    if not cfg.compact:
        return resolved_auto_config(cfg, 0, H, W)
    counts = (edges >= cfg.edge_threshold).sum(dim=(-2, -1))
    return resolved_auto_config(cfg, int(counts.max()), H, W)


def hough_transform(edges: torch.Tensor, cfg: HoughConfig = HoughConfig(),
                    theta_bins: torch.Tensor | None = None, *,
                    scatter: bool = True) -> torch.Tensor:
    """Vote accumulator (..., n_rho, n_theta) from an edge map (..., H, W);
    resolves ``max_edges="auto"`` from the concrete edge map first."""
    if cfg.max_edges == "auto":
        cfg = resolve_max_edges(edges, cfg)
    return _hough_transform(edges, cfg, theta_bins, scatter=scatter)


def hough_transform_tiered(edges: torch.Tensor, cfg: HoughConfig,
                           tiers: tuple[int, ...] | None = None,
                           theta_bins: torch.Tensor | None = None, *,
                           scatter: bool = True) -> torch.Tensor:
    """``max_edges="auto"`` with no host sync: compact into the cap tier;
    the vote kernel skips each frame's rows past its device-held count.

    Bit-exact with the reference's ``lax.switch`` over ``tiers``: every
    tier below the cap drops nothing, and the cap drops the same trailing
    edges either way.
    """
    if not cfg.compact:
        return _hough_transform(
            edges, dataclasses.replace(cfg, max_edges=None), theta_bins,
            scatter=scatter,
        )
    H, W = edges.shape[-2:]
    if tiers is None:
        tiers = max_edge_tiers(H, W)
    return _hough_transform(
        edges, dataclasses.replace(cfg, max_edges=int(tiers[-1])),
        theta_bins, scatter=scatter,
    )


def _hough_transform(edges: torch.Tensor, cfg: HoughConfig = HoughConfig(),
                     theta_bins: torch.Tensor | None = None, *,
                     scatter: bool = True) -> torch.Tensor:
    """Vote accumulator from an edge map; ``cfg.max_edges`` is resolved.

    rho = col*cos(theta) + row*sin(theta), shifted by +diag and binned at
    ``cfg.rho_res`` through the homogeneous third coordinate.  A batch
    (N, H, W) shares one raster coordinate table and votes as one launch.
    """
    _check_band(theta_bins, cfg)
    H, W = edges.shape[-2:]
    n_rho = rho_bins(H, W, cfg)
    trig = _device_trig(H, W, cfg, edges.device)
    xy = _device_raster(H, W, edges.device)
    flat = edges.reshape(edges.shape[:-2] + (H * W,))
    weights = (flat >= cfg.edge_threshold).to(torch.float32)
    return ops.hough_vote(
        xy, weights, trig, n_rho=n_rho, compact=cfg.compact,
        max_edges=cfg.max_edges, theta_bins=theta_bins, scatter_back=scatter,
    )


def _check_band(theta_bins, cfg: HoughConfig) -> None:
    if (theta_bins is None) != (cfg.theta_band is None):
        raise ValueError(
            "HoughConfig.theta_band and the theta_bins argument come as a "
            f"pair (got theta_band={cfg.theta_band!r}, "
            f"theta_bins={'set' if theta_bins is not None else None!r})."
        )
    if theta_bins is not None and tuple(theta_bins.shape) != (cfg.theta_band,):
        raise ValueError(
            f"theta_bins must have the plan's static band shape "
            f"({cfg.theta_band},); got {tuple(theta_bins.shape)}."
        )


def _check_corridors(corridors, cfg: HoughConfig) -> None:
    if (corridors is None) != (cfg.corridors is None):
        raise ValueError(
            "HoughConfig.corridors and the corridors argument come as a "
            f"pair (got corridors={cfg.corridors!r}, argument="
            f"{'set' if corridors is not None else None!r})."
        )
    if corridors is not None and tuple(corridors.shape) != (cfg.corridors, 4):
        raise ValueError(
            f"corridors must have the plan's static shape "
            f"({cfg.corridors}, 4); got {tuple(corridors.shape)}."
        )


def fused_hough(image: torch.Tensor, canny_cfg, cfg: HoughConfig,
                theta_bins: torch.Tensor | None = None,
                corridors: torch.Tensor | None = None, *,
                scatter: bool = True) -> torch.Tensor:
    """The fused hot path: frames -> votes with no edge map in between.

    Kernel A (``ops.fused_detect``) runs Canny, the edge threshold, the
    corridor filter and raster compaction; kernel B is the vote over the
    compacted rows, which skips each frame's rows past its device-held
    count.  Bit-exact with ``canny`` + ``hough_transform`` at full corridor
    and band coverage whenever the edges fit the buffer.  ``cfg.max_edges``
    is a resolved int or None (the dense default); ``"auto"`` exists only
    in tiered form (:func:`fused_hough_tiered`).
    """
    if cfg.max_edges == "auto":
        raise ValueError(
            "fused_hough cannot resolve max_edges='auto' (there is no "
            "edge map to count); use fused_hough_tiered."
        )
    _check_band(theta_bins, cfg)
    _check_corridors(corridors, cfg)
    H, W = image.shape[-2:]
    max_edges = cfg.max_edges
    if max_edges is None:
        max_edges = ops.default_max_edges(H * W)
    cxy, cw, counts = ops.fused_detect(
        image, corridors, cfg=canny_cfg, edge_threshold=cfg.edge_threshold,
        max_edges=max_edges,
    )
    return ops.hough_vote(
        cxy, cw, _device_trig(H, W, cfg, image.device),
        n_rho=rho_bins(H, W, cfg), counts=counts, theta_bins=theta_bins,
        scatter_back=scatter,
    )


def fused_hough_tiered(image: torch.Tensor, canny_cfg, cfg: HoughConfig,
                       tiers: tuple[int, ...] | None = None,
                       theta_bins: torch.Tensor | None = None,
                       corridors: torch.Tensor | None = None, *,
                       scatter: bool = True) -> torch.Tensor:
    """``max_edges="auto"`` on the fused path with no host sync: kernel A
    compacts into the cap tier ``tiers[-1]`` and the vote skips each
    frame's rows past its device-held count.

    Bit-exact with the reference's exact-count selector
    (``_fused_hough_tiered_exact``): the count is exact, so every tier
    below the cap drops nothing, and the cap drops the same trailing
    edges.  The reference's other selector, for its Pallas kernel, sizes
    the buffer from the pre-Canny gradient estimate because a Pallas
    output shape is fixed before launch; here the cap buffer and the
    device count make any estimate unnecessary, so it has no counterpart.
    """
    if not cfg.compact:
        return fused_hough(image, canny_cfg,
                           dataclasses.replace(cfg, max_edges=None),
                           theta_bins, corridors, scatter=scatter)
    H, W = image.shape[-2:]
    if tiers is None:
        tiers = max_edge_tiers(H, W)
    return fused_hough(image, canny_cfg,
                       dataclasses.replace(cfg, max_edges=int(tiers[-1])),
                       theta_bins, corridors, scatter=scatter)


@functools.cache
def _device_cos_sin(n_theta: int, device: torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (n_theta,) f32 ``cos`` and ``sin`` of the theta bins, taken on
    the host in numpy as :func:`hough_trig` takes them: torch's and XLA's
    ``cos`` / ``sin`` differ from numpy's in the last ulp."""
    theta = np.arange(n_theta, dtype=np.float32) * (math.pi / n_theta)
    return (torch.from_numpy(np.cos(theta)).to(device),
            torch.from_numpy(np.sin(theta)).to(device))


def hough_paper_loop(edges: torch.Tensor, cfg: HoughConfig = HoughConfig()
                     ) -> torch.Tensor:
    """Paper Algorithm 2, serial: for each pixel, for each theta,
    ``accumulators[rho_bin, theta] += (pixel >= edge_threshold)``.

    One Python iteration a pixel, each a handful of element-wise torch ops
    over the theta sweep on the device of ``edges``: the scalar core's
    loop, the baseline the platform comparison measures, so no kernel
    stands in for it.  The arithmetic is the reference's, each operation
    rounded in f32: ``rho = j*cos + i*sin + diag``, then
    ``floor(rho / rho_res)``, the division by a device tensor so that it
    rounds once on the card too; the vote is the reference's scatter-add
    (``acc.at[idx, arange(n_theta)].add(w)``), one ``scatter_add_`` into
    row ``idx[t]`` of each column ``t``.  The reference's XLA build contracts
    ``j*cos + i*sin`` into one fused multiply-add and takes XLA's ``cos`` /
    ``sin``, so a rho within an ulp of a bin edge can land one bin over:
    the votes' total is the same.  (H, W) -> (n_rho, n_theta) f32.
    """
    H, W = edges.shape
    dev = edges.device
    n_rho = rho_bins(H, W, cfg)
    diag = math.hypot(H, W)
    cos_t, sin_t = _device_cos_sin(cfg.n_theta, dev)
    rho_res = torch.full((), cfg.rho_res, dtype=torch.float32, device=dev)
    flat = edges.reshape(-1).to(torch.float32)
    acc = torch.zeros((n_rho, cfg.n_theta), dtype=torch.float32, device=dev)
    for p in range(H * W):
        i, j = divmod(p, W)
        rho = j * cos_t + i * sin_t + diag
        idx = torch.floor(rho / rho_res).to(torch.int64)
        w = torch.where(flat[p] >= cfg.edge_threshold, 1.0, 0.0)
        acc.scatter_add_(0, idx[None], w.expand(1, cfg.n_theta))
    return acc
