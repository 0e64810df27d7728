"""Detection-quality metrics: (rho, theta) matching, precision/recall/F1.

The paper judges detection by visual comparison (Fig. 4).  This module makes
quality a number: detected Hough peaks are matched one-to-one against the
scenario engine's analytic ground truth under a (rho, theta) tolerance, and
the match is scored as precision / recall / F1 plus mean localization error.
``tests/test_scenarios.py`` and ``benchmarks/scenario_suite.py`` hold every
scenario family — and every future performance change — to these numbers.

Matching is Hungarian-style: admissible (detection, truth) pairs — those
within ``max(|drho|/tol_rho, |dtheta|/tol_theta) <= 1`` — form a bipartite
graph, and a maximum-cardinality one-to-one matching is found with Kuhn's
augmenting-path algorithm (edges tried lowest-cost-first, so ties resolve
to the nearest pair).  Maximum cardinality matters: two parallel truths
within ~2x tolerance of each other must not cost a true positive to a
greedy first-come assignment.  Line identity is wrap-aware: ``(rho,
theta)`` and ``(-rho, theta +- pi)`` name the same line, so near-vertical
lanes match across the theta seam.

Everything here is host-side numpy — metrics score concrete detector output,
they are never traced.  A copy of ``repro/core/metrics.py``: the port
imports nothing of the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

#: Default tolerances: one detector bin of slack on each axis (rho_res=1px
#: accumulators quantize rho; 1-degree theta bins), scaled by the stroke
#: width the scenario engine plants.
TOL_RHO_PX = 4.0
TOL_THETA_DEG = 3.0


def rho_theta_residual(det: tuple[float, float], truth: tuple[float, float]
                       ) -> tuple[float, float]:
    """Wrap-aware (|drho| px, |dtheta| rad) between two normal-form lines."""
    rd, td = float(det[0]), float(det[1])
    rt, tt = float(truth[0]), float(truth[1])
    best = (float("inf"), float("inf"))
    for r, t in ((rd, td), (-rd, td + math.pi), (-rd, td - math.pi)):
        cand = (abs(r - rt), abs(t - tt))
        if cand[1] < best[1] or (cand[1] == best[1] and cand[0] < best[0]):
            best = cand
    return best


@dataclasses.dataclass(frozen=True)
class DetectionScore:
    tp: int
    fp: int
    fn: int
    precision: float
    recall: float
    f1: float
    mean_rho_err: float        # px, over matched pairs (nan if none)
    mean_theta_err_deg: float  # degrees, over matched pairs (nan if none)
    # Unmatched detections that still fall within tolerance of a *matched*
    # truth line.  A painted stroke has two raster sides, so a Hough
    # detector legitimately yields doublet peaks a few rho bins apart;
    # these score as duplicates, not false positives (an empty scene still
    # counts every spurious peak as a true FP — nothing to duplicate).
    dup: int = 0

    @property
    def perfect(self) -> bool:
        return self.fp == 0 and self.fn == 0


def match_peaks(detected: np.ndarray, truth: np.ndarray, *,
                tol_rho: float = TOL_RHO_PX,
                tol_theta_deg: float = TOL_THETA_DEG
                ) -> list[tuple[int, int, float, float]]:
    """One-to-one matching of detected peaks to ground-truth lines.

    Args:
      detected: (K, 2) array of (rho, theta_rad) detections.
      truth:    (M, 2) array of planted (rho, theta_rad).

    Returns a list of (det_idx, truth_idx, |drho|, |dtheta_deg|) pairs of
    a maximum-cardinality one-to-one matching over the admissible pairs
    (Kuhn's augmenting paths; candidate edges tried lowest-cost-first).
    """
    detected = np.asarray(detected, np.float64).reshape(-1, 2)
    truth = np.asarray(truth, np.float64).reshape(-1, 2)
    tol_theta = math.radians(tol_theta_deg)
    # admissible edges per detection, nearest truth first
    edges: list[list[tuple[float, int, float, float]]] = []
    for d in detected:
        adm = []
        for j, t in enumerate(truth):
            drho, dth = rho_theta_residual(tuple(d), tuple(t))
            if drho <= tol_rho and dth <= tol_theta:
                cost = max(drho / max(tol_rho, 1e-9),
                           dth / max(tol_theta, 1e-9))
                adm.append((cost, j, drho, dth))
        adm.sort()
        edges.append(adm)

    owner: dict[int, int] = {}  # truth_idx -> det_idx

    def try_assign(i: int, seen: set[int]) -> bool:
        for _, j, _, _ in edges[i]:
            if j in seen:
                continue
            seen.add(j)
            if j not in owner or try_assign(owner[j], seen):
                owner[j] = i
                return True
        return False

    # seed detections in ascending best-cost order so equal-cardinality
    # matchings prefer the nearer pairs
    order = sorted(range(len(edges)),
                   key=lambda i: edges[i][0][0] if edges[i] else math.inf)
    for i in order:
        if edges[i]:
            try_assign(i, set())

    matches = []
    for j, i in sorted(owner.items(), key=lambda kv: kv[1]):
        drho, dth = next(
            (r, t) for _, jj, r, t in edges[i] if jj == j
        )
        matches.append((i, j, drho, math.degrees(dth)))
    return matches


def score_frame(peaks: np.ndarray, valid: np.ndarray, truth: np.ndarray, *,
                tol_rho: float = TOL_RHO_PX,
                tol_theta_deg: float = TOL_THETA_DEG) -> DetectionScore:
    """Score one frame's detector output against its planted lines.

    ``peaks``/``valid`` are the (K, 2)/(K,) fields of a DetectionResult
    (only rows with ``valid`` count as detections); ``truth`` is the
    scenario's (M, 2) ``lines_rho_theta``.
    """
    peaks = np.asarray(peaks, np.float64).reshape(-1, 2)
    valid = np.asarray(valid, bool).reshape(-1)
    det = peaks[valid]
    truth = np.asarray(truth, np.float64).reshape(-1, 2)
    matches = match_peaks(det, truth, tol_rho=tol_rho,
                          tol_theta_deg=tol_theta_deg)
    tp = len(matches)
    matched_d = {m[0] for m in matches}
    matched_t = truth[[m[1] for m in matches]] if matches else truth[:0]
    tol_theta = math.radians(tol_theta_deg)
    dup = sum(
        1
        for i in range(det.shape[0])
        if i not in matched_d and any(
            (lambda r: r[0] <= tol_rho and r[1] <= tol_theta)(
                rho_theta_residual(tuple(det[i]), tuple(t))
            )
            for t in matched_t
        )
    )
    fp = det.shape[0] - tp - dup
    fn = truth.shape[0] - tp
    precision = tp / (tp + fp) if (tp + fp) else 1.0
    recall = tp / truth.shape[0] if truth.shape[0] else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) else 0.0)
    rho_errs = [m[2] for m in matches]
    th_errs = [m[3] for m in matches]
    return DetectionScore(
        tp=tp, fp=fp, fn=fn, precision=precision, recall=recall, f1=f1,
        mean_rho_err=float(np.mean(rho_errs)) if rho_errs else float("nan"),
        mean_theta_err_deg=(
            float(np.mean(th_errs)) if th_errs else float("nan")
        ),
        dup=dup,
    )


def score_batch(peaks: np.ndarray, valid: np.ndarray,
                truths: Sequence[np.ndarray], *,
                tol_rho: float = TOL_RHO_PX,
                tol_theta_deg: float = TOL_THETA_DEG
                ) -> list[DetectionScore]:
    """Score a batched DetectionResult: peaks (N, K, 2), valid (N, K),
    truths a per-frame sequence of (M_i, 2) arrays."""
    peaks = np.asarray(peaks)
    valid = np.asarray(valid)
    assert peaks.ndim == 3 and len(truths) == peaks.shape[0], (
        peaks.shape, len(truths),
    )
    return [
        score_frame(peaks[i], valid[i], truths[i], tol_rho=tol_rho,
                    tol_theta_deg=tol_theta_deg)
        for i in range(peaks.shape[0])
    ]


def aggregate_scores(scores: Sequence[DetectionScore]) -> dict:
    """Micro-averaged precision/recall/F1 + mean localization error."""
    tp = sum(s.tp for s in scores)
    fp = sum(s.fp for s in scores)
    fn = sum(s.fn for s in scores)
    precision = tp / (tp + fp) if (tp + fp) else 1.0
    recall = tp / (tp + fn) if (tp + fn) else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) else 0.0)
    rho = [s.mean_rho_err for s in scores if not math.isnan(s.mean_rho_err)]
    th = [s.mean_theta_err_deg for s in scores
          if not math.isnan(s.mean_theta_err_deg)]
    return {
        "tp": tp, "fp": fp, "fn": fn,
        "dup": sum(s.dup for s in scores),
        "precision": precision, "recall": recall, "f1": f1,
        "mean_rho_err": float(np.mean(rho)) if rho else float("nan"),
        "mean_theta_err_deg": float(np.mean(th)) if th else float("nan"),
    }
