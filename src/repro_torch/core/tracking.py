"""Temporal lane tracking and the prediction-gated, fused detection loop
(``repro/core/tracking.py``).

  * :class:`LaneTracker` -- one constant-velocity alpha-beta filter per lane
    in (rho, theta) normal form: wrap-aware identity ((rho, theta) and
    (-rho, theta +- pi) name one line), gated one-to-one association
    (``core.metrics.match_peaks``), and a birth -> confirm -> coast -> kill
    lifecycle.  :meth:`LaneTracker.gate_bins` gives the next frame's theta
    gate and :meth:`LaneTracker.corridors` its rho corridors.
  * :class:`TrackingPipeline` -- the per-session frame loop: detect (fused,
    gated or full sweep) -> update the tracker -> report smoothed tracks.

The tracker is host code, a numpy copy of the reference's: deterministic,
no clock and no RNG.  The detection it drives runs on the card unless the
pipeline is built with ``device="cpu"``; each frame ships with one copy,
and its peaks and validity come back to the host for the tracker.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np

from .metrics import match_peaks
from .plan import DetectionResult, PipelineConfig, PlanCache, load_frame


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Knobs of the per-lane alpha-beta filter and its lifecycle.

    The gates are deliberately wider than the quality harness's matching
    tolerance (4 px / 3 deg): association must hold a track through the
    frame-to-frame motion *plus* detector quantization, while scoring only
    judges the final smoothed state.
    """
    gate_rho: float = 14.0        # association gate (px)
    gate_theta_deg: float = 9.0   # association gate (degrees)
    alpha: float = 0.5            # position gain (per-frame dt = 1)
    beta: float = 0.2             # velocity gain
    confirm_hits: int = 2         # detections before a track is confirmed
    max_misses: int = 3           # coasted frames before a kill
    coast_hits: int = 6           # hits before a coasting track is REPORTED
    # Velocity decay per coasted frame: an unobserved lane's velocity is
    # stale (ego sway turns around in a few frames), so an undamped
    # constant-velocity coast overshoots exactly when the vehicle is
    # reversing its drift.  Decaying toward "hold position" keeps a
    # blackout-length coast close to the lane (a lane change continues
    # under a blackout, so full damping would undershoot as badly as no
    # damping overshoots a sway turnaround).
    coast_damping: float = 0.85
    # Full-sweep frames after a confirmed track dies.  The gate only
    # sweeps confirmed tracks' windows, so without a rescan a lane whose
    # track was lost (e.g. killed during a blackout) would be permanently
    # invisible while a surviving track keeps the gate engaged — the
    # classic gated-tracking lock-out.  Long enough to rebirth + confirm
    # a replacement (confirm_hits) with margin.
    rescan_frames: int = 5
    # Warm-start coast eligibility: a session that has been *grounded* —
    # step() matched at least one detection — this many frames EVER may
    # coast on any confirmed track, even one whose own ``hits`` count is
    # still short of ``coast_hits``.  Under overload shed pressure (or on
    # noisy families where detections flicker between a stroke's raster
    # sides) tracks churn faster than any single one can accumulate
    # ``coast_hits`` matched detections, so the strictly per-track bar
    # starves the ladder's coast rung exactly when it is needed; the
    # session-level bar says "this camera has proven it sees lanes",
    # which is the evidence the per-track bar was a proxy for.  The miss
    # budget (``misses + steps <= max_misses``) still applies per track,
    # so a warm-started coast can never outlive a real blackout.
    warm_frames: int = 10
    band_half_deg: float = 8.0    # per-track half-width of the Hough gate
    # Per-track half-width (px) of the fused path's rho corridor: the
    # window around a predicted lane inside which edge pixels may vote
    # (``corridors()``).  Sized to cover the association gate
    # (``gate_rho``) plus the worst-case rho drift of a real edge pixel
    # under the prediction's theta error (~s*sin(dtheta): a pixel ~200 px
    # along the lane under a ~1.7 deg error moves ~6 px in rho) with
    # slack — a lane's edge pixels must stay in-corridor whenever the
    # association gate would still claim the lane.
    corridor_half_px: float = 25.0
    # Pre-association doublet merge: a painted stroke has two raster
    # sides, so the detector legitimately yields peak pairs a few rho bins
    # apart (what metrics.DetectionScore counts as ``dup``).  Tracking
    # each side separately breeds twin tracks whose coasts drift apart;
    # merging the sides to their wrap-aware mean — the stroke centerline,
    # which is exactly where truth is planted — gives one track per lane.
    # The tolerance also folds noise-burst satellite peaks riding next to
    # a lane into its cluster, so a burst cannot capture the track while
    # the true detection births a twin (an ID switch + a lingering false
    # coast).  Real lanes sit far apart in every family, and clusters are
    # linked against their first member, so the tolerance bounds total
    # cluster spread.  0 disables the merge.
    merge_rho: float = 8.0
    merge_theta_deg: float = 2.5


@dataclasses.dataclass
class Track:
    """One lane's filter state (canonical form: theta in [0, pi))."""
    track_id: int
    rho: float
    theta: float
    drho: float = 0.0
    dtheta: float = 0.0
    hits: int = 1                 # total matched detections
    misses: int = 0               # consecutive missed frames (coasting)
    age: int = 1                  # frames since birth
    confirmed: bool = False

    @property
    def coasting(self) -> bool:
        return self.misses > 0

    @property
    def peak(self) -> tuple[float, float]:
        return (self.rho, self.theta)


def wrap_canonical(rho: float, theta: float) -> tuple[float, float]:
    """Fold (rho, theta) into the canonical theta in [0, pi) sheet
    (rho flips sign with each half-turn)."""
    while theta >= math.pi:
        theta -= math.pi
        rho = -rho
    while theta < 0.0:
        theta += math.pi
        rho = -rho
    return rho, theta


def signed_residual(det: tuple[float, float], ref: tuple[float, float]
                    ) -> tuple[float, float]:
    """Signed, wrap-aware (drho, dtheta) of a detection about a reference.

    The signed twin of ``core.metrics.rho_theta_residual`` (same candidate
    set, same theta-first tie-break, so the filter's innovation and the
    harness's score agree on which wrap sheet a detection lives on): picks
    the representation of ``det`` among (rho, theta) / (-rho, theta +- pi)
    nearest the reference in theta and returns the *signed* differences
    the alpha-beta update integrates.
    """
    rd, td = float(det[0]), float(det[1])
    rr, rt = float(ref[0]), float(ref[1])
    best: Optional[tuple[float, float]] = None
    for r, t in ((rd, td), (-rd, td + math.pi), (-rd, td - math.pi)):
        cand = (r - rr, t - rt)
        if (best is None or abs(cand[1]) < abs(best[1])
                or (abs(cand[1]) == abs(best[1])
                    and abs(cand[0]) < abs(best[0]))):
            best = cand
    return best


def merge_peaks(peaks: np.ndarray, *, tol_rho: float, tol_theta_deg: float
                ) -> np.ndarray:
    """Cluster near-identical detections into their wrap-aware means.

    Single-linkage against each cluster's first member, in input order
    (deterministic); members are folded onto the representative's wrap
    sheet via ``signed_residual`` before averaging, so a doublet
    straddling the theta seam still collapses to one line.  Returns the
    (K', 2) cluster means, canonicalized.
    """
    peaks = np.asarray(peaks, np.float64).reshape(-1, 2)
    tol_theta = math.radians(tol_theta_deg)
    reps: list[tuple[float, float]] = []      # cluster representatives
    residuals: list[list[tuple[float, float]]] = []
    for det in peaks:
        for rep, res in zip(reps, residuals):
            drho, dtheta = signed_residual(tuple(det), rep)
            if abs(drho) <= tol_rho and abs(dtheta) <= tol_theta:
                res.append((drho, dtheta))
                break
        else:
            reps.append((float(det[0]), float(det[1])))
            residuals.append([(0.0, 0.0)])
    out = [
        wrap_canonical(rep[0] + float(np.mean([r[0] for r in res])),
                       rep[1] + float(np.mean([r[1] for r in res])))
        for rep, res in zip(reps, residuals)
    ]
    return np.asarray(out, np.float64).reshape(-1, 2)


class LaneTracker:
    """Constant-velocity alpha-beta tracking of lane lines in (rho, theta).

    ``step(peaks, valid)`` advances one frame: predict every track by its
    velocity, associate detections one-to-one inside the gate
    (``core.metrics.match_peaks`` — maximum-cardinality, nearest-first, so
    two close lanes never steal each other's detection), update matched
    tracks, coast the unmatched ones, birth tentative tracks from leftover
    detections, and kill anything past ``max_misses``.  It returns the
    frame's *reported* tracks: every track matched this frame plus every
    mature (``hits >= coast_hits``) confirmed track coasting through a
    miss — i.e. the temporal layer's
    answer to "which lanes are in front of the vehicle right now", which
    is what the drive-cycle harness scores as "tracked F1".
    """

    def __init__(self, cfg: TrackerConfig = TrackerConfig()):
        self.cfg = cfg
        self._tracks: list[Track] = []
        self._next_id = 0
        self.frame = 0
        self._rescan = 0          # full-sweep frames still owed (see cfg)
        # frames where step() matched >= 1 detection to a track — the
        # session-level "has this camera ever seen lanes" evidence the
        # warm-start coast rule reads (cfg.warm_frames)
        self.grounded_frames = 0

    # --- introspection --------------------------------------------------
    @property
    def tracks(self) -> list[Track]:
        """Live tracks (snapshot copies — internal state stays private)."""
        return [dataclasses.replace(t) for t in self._tracks]

    @property
    def confirmed_tracks(self) -> list[Track]:
        return [dataclasses.replace(t)
                for t in self._tracks if t.confirmed]

    # --- the filter -----------------------------------------------------
    def _predict(self) -> None:
        for t in self._tracks:
            t.rho += t.drho
            t.theta += t.dtheta
            self._canonicalize(t)
            t.age += 1

    @staticmethod
    def _canonicalize(t: Track) -> None:
        # folding theta by +-pi negates rho — and therefore the rho
        # velocity: the motion is continuous on the covering space, so the
        # canonical-sheet representative flips drho with rho (dtheta is a
        # rotation rate, unchanged).
        while t.theta >= math.pi:
            t.theta -= math.pi
            t.rho, t.drho = -t.rho, -t.drho
        while t.theta < 0.0:
            t.theta += math.pi
            t.rho, t.drho = -t.rho, -t.drho

    def step(self, peaks, valid=None, *, scale: float = 1.0) -> list[Track]:
        """Advance one frame on the detector's (K, 2)/(K,) peak output.

        ``valid=None`` treats every row of ``peaks`` as a detection.
        ``scale`` is the resolution divisor the detections were computed
        at (1 = native): a frame served downshifted by ``factor`` carries
        rho quantization error ~``factor`` times the native bin, so the
        rho association gate (and the doublet-merge tolerance) widen by
        it — otherwise an upscaled coarse detection lands just outside
        the native gate, the true track coasts, and a twin is born at
        the quantized position (the track-churn path that starves the
        coast rung across resolution downshifts).  Theta is
        scale-invariant, so the theta gate does not widen.
        Returns the reported tracks for this frame (see class docstring).
        """
        peaks = np.asarray(peaks, np.float64).reshape(-1, 2)
        if valid is not None:
            peaks = peaks[np.asarray(valid, bool).reshape(-1)]
        cfg = self.cfg
        scale = max(1.0, float(scale))
        # consume one owed rescan frame BEFORE any kill below can open a
        # new window: a kill at this frame must leave the full
        # rescan_frames budget for the frames after it
        if self._rescan > 0:
            self._rescan -= 1
        if cfg.merge_rho > 0.0 and peaks.shape[0] > 1:
            peaks = merge_peaks(peaks, tol_rho=cfg.merge_rho * scale,
                                tol_theta_deg=cfg.merge_theta_deg)

        self._predict()
        predicted = np.array([[t.rho, t.theta] for t in self._tracks],
                             np.float64).reshape(-1, 2)
        matches = match_peaks(
            peaks, predicted,
            tol_rho=cfg.gate_rho * scale,
            tol_theta_deg=cfg.gate_theta_deg,
        )
        matched_det = {m[0] for m in matches}
        matched_trk = {m[1] for m in matches}
        if matches:
            self.grounded_frames += 1

        for det_i, trk_i, _, _ in matches:
            t = self._tracks[trk_i]
            drho, dtheta = signed_residual(
                tuple(peaks[det_i]), (t.rho, t.theta)
            )
            t.rho += cfg.alpha * drho
            t.theta += cfg.alpha * dtheta
            t.drho += cfg.beta * drho
            t.dtheta += cfg.beta * dtheta
            self._canonicalize(t)
            t.hits += 1
            t.misses = 0
            if t.hits >= cfg.confirm_hits:
                t.confirmed = True

        for i, t in enumerate(self._tracks):
            if i not in matched_trk:
                t.misses += 1   # state already holds the prediction: coast
                t.drho *= cfg.coast_damping
                t.dtheta *= cfg.coast_damping

        # kill: confirmed tracks coast through max_misses frames; a
        # tentative track was never corroborated, so one miss kills it.
        # Losing a *confirmed* track opens the rescan window — the next
        # rescan_frames sweeps run ungated so the lane (which may well
        # still be there) can be re-acquired.
        survivors = []
        for t in self._tracks:
            if t.misses <= (cfg.max_misses if t.confirmed else 0):
                survivors.append(t)
            elif t.confirmed:
                self._rescan = cfg.rescan_frames
        self._tracks = survivors

        for i in range(peaks.shape[0]):
            if i in matched_det:
                continue
            rho, theta = wrap_canonical(float(peaks[i, 0]),
                                        float(peaks[i, 1]))
            self._tracks.append(Track(self._next_id, rho, theta))
            self._next_id += 1

        self.frame += 1
        # report: everything matched this frame, plus coasting tracks that
        # EARNED the right to be predicted forward (>= coast_hits matched
        # detections).  A barely-confirmed spur — e.g. a transient doublet
        # side-peak that flickered twice — may keep coasting internally
        # for re-association, but reporting its drifting prediction would
        # trade the harness's false positives for the dropout coverage the
        # coast exists for.
        return [
            dataclasses.replace(t) for t in self._tracks
            if t.misses == 0
            or (t.confirmed and t.hits >= cfg.coast_hits)
        ]

    # --- coast-only prediction (degraded serving) -----------------------
    def coastable_tracks(self, steps: int = 1) -> list[Track]:
        """Tracks *eligible* to answer a frame from prediction alone.

        The degradation ladder's coast rung (``serve/detection.py``)
        answers an overloaded frame from the session tracker without
        running detection at all — but only a track that has EARNED the
        coast may back such an answer, by the same rules ``step`` applies
        to real missed frames: confirmed, mature, and still inside its
        miss budget after ``steps`` more unobserved frames
        (``misses + steps <= max_misses``).  A service can therefore
        never coast a session further than the tracker itself would have
        survived a real dropout — the coast budget and the blackout
        budget are one number.

        Maturity is per-track (``hits >= coast_hits``), with a
        session-level warm-start *fallback*: when no track meets the
        strict bar but the tracker has been grounded ``warm_frames``
        frames *ever* (not consecutively), the confirmed tracks qualify
        anyway — under shed pressure or detection churn no single track
        may survive long enough to accumulate ``coast_hits``, while the
        session as a whole has long since proven it sees lanes (see
        ``TrackerConfig.warm_frames``).  Fallback, not widening: a
        session with mature tracks answers from exactly those (immature
        twins never dilute a good coast), so the warm start only engages
        where the strict bar would have starved the rung entirely.
        """
        cfg = self.cfg
        strict = [
            t for t in self._tracks
            if t.confirmed and t.hits >= cfg.coast_hits
            and t.misses + steps <= cfg.max_misses
        ]
        if strict or self.grounded_frames < cfg.warm_frames:
            return strict
        return [
            t for t in self._tracks
            if t.confirmed and t.misses + steps <= cfg.max_misses
        ]

    def can_coast(self, steps: int = 1) -> bool:
        """True iff at least one track may answer ``steps`` frames ahead."""
        return bool(self.coastable_tracks(steps))

    def predict_tracks(self, steps: int = 1) -> list[Track]:
        """``steps``-ahead predicted state of the coast-eligible tracks,
        WITHOUT mutating the tracker.

        Applies exactly the per-frame coast update ``step`` would: state
        advances by the (decaying) velocity and the velocity damps by
        ``coast_damping`` each unobserved frame — so a coast-only answer
        for frame t+k is bit-identical to what the tracker would have
        reported had it actually coasted through k missed frames.  The
        tracker itself does NOT advance: the real frame may still arrive
        (late, after the deadline) or the next frame may be served for
        real, and session stream-order must survive either outcome.
        Returns [] when nothing is eligible (see ``coastable_tracks``).
        """
        cfg = self.cfg
        out = []
        for t in self.coastable_tracks(steps):
            p = dataclasses.replace(t)
            for _ in range(max(1, int(steps))):
                p.rho += p.drho
                p.theta += p.dtheta
                p.drho *= cfg.coast_damping
                p.dtheta *= cfg.coast_damping
                p.misses += 1
                p.age += 1
            self._canonicalize(p)
            out.append(p)
        return out

    # --- the prediction gate --------------------------------------------
    def gate_bins(self, n_theta: int = 180, *,
                  band: Optional[int] = None) -> Optional[np.ndarray]:
        """Theta bins the *next* frame's Hough sweep should vote over.

        The union of ``+- band_half_deg`` windows (mod n_theta — the gate
        follows a lane across the theta seam) around EVERY live track's
        one-frame-ahead predicted theta — tentative tracks included: a
        newly-born lane must be swept so it can confirm (or, if it was a
        ghost, miss and die) under the gate, otherwise a lane acquired one
        frame after its neighbor would be locked out forever.  Returns
        None — "run the full sweep" — whenever the tracker is not
        *healthy*: no confirmed track (cold start, total loss), any
        confirmed track coasting (its detection is missing — a gate would
        search only where we already failed to look), an open rescan
        window after a track death (a lost lane must be re-acquirable:
        the gate only covers surviving tracks, so without the rescan a
        dead track's lane would stay invisible forever), or a window
        union overflowing the static ``band`` length.  Otherwise a sorted
        (band,) int32 vector, padded by repeating the first bin
        (duplicate gate bins are idempotent in the vote scatter).
        """
        conf = [t for t in self._tracks if t.confirmed]
        if not conf or self._rescan > 0:
            return None
        if any(t.misses > 0 for t in conf):
            return None
        bin_deg = 180.0 / n_theta
        half = max(1, int(math.ceil(self.cfg.band_half_deg / bin_deg)))
        bins: set[int] = set()
        for t in self._tracks:
            pred_theta = t.theta + t.dtheta
            center = int(round(pred_theta / (math.pi / n_theta)))
            for d in range(-half, half + 1):
                bins.add((center + d) % n_theta)
        out = sorted(bins)
        if band is not None:
            if len(out) > band:
                return None
            out = out + [out[0]] * (band - len(out))
        return np.asarray(out, np.int32)

    # --- the rho corridors (fused hot path) -----------------------------
    def corridors(self, max_corridors: Optional[int] = None, *,
                  half_px: Optional[float] = None) -> Optional[np.ndarray]:
        """Rho windows the *next* frame's fused kernel may keep edges in.

        The spatial twin of :meth:`gate_bins`: one ``[cos, sin, rho_lo,
        rho_hi]`` row per live track (tentative included — a newborn lane's
        edge pixels must survive the filter so it can confirm or die) at
        the one-frame-ahead prediction, with half-width
        ``TrackerConfig.corridor_half_px`` (overridable via ``half_px``).
        Health rules are *identical* to the theta gate — None ("keep every
        pixel: run the staged full sweep") on cold start, any confirmed
        track coasting, an open rescan window, or (with ``max_corridors``
        set) window overflow — so a pipeline that consults both gates
        degrades them together.  With ``max_corridors`` the result is
        padded to the plan's static (max_corridors, 4) shape by repeating
        the first row (the kernel's any-corridor OR is idempotent);
        ``max_corridors=None`` returns the raw unpadded rows for callers
        that union across sessions first (``serve/detection.py``).
        """
        conf = [t for t in self._tracks if t.confirmed]
        if not conf or self._rescan > 0:
            return None
        if any(t.misses > 0 for t in conf):
            return None
        half = float(self.cfg.corridor_half_px
                     if half_px is None else half_px)
        rows = []
        for t in self._tracks:
            rho_p = t.rho + t.drho
            th_p = t.theta + t.dtheta
            rows.append([math.cos(th_p), math.sin(th_p),
                         rho_p - half, rho_p + half])
        if max_corridors is not None:
            if len(rows) > max_corridors:
                return None
            rows = rows + [rows[0]] * (max_corridors - len(rows))
        return np.asarray(rows, np.float32).reshape(-1, 4)


def tracks_as_peaks(tracks: Sequence[Track]) -> tuple[np.ndarray, np.ndarray]:
    """(M, 2) peaks + all-true valid mask from reported tracks — the
    adapter between a tracker's per-frame report and the (peaks, valid)
    interface of ``core.metrics.score_frame``."""
    peaks = np.array([[t.rho, t.theta] for t in tracks],
                     np.float32).reshape(-1, 2)
    return peaks, np.ones(peaks.shape[0], bool)


class TrackedFrame(NamedTuple):
    result: DetectionResult     # raw detector output for the frame
    tracks: list[Track]         # reported (smoothed) tracks
    gated: bool                 # True iff the frame ran the gated sweep
    steering: Optional[object] = None   # the controller's command, when
                                        # one is attached

    @property
    def control_peaks(self) -> tuple[np.ndarray, np.ndarray]:
        """The (peaks, valid) a controller should steer from: smoothed
        tracks when the tracker reports any, the frame's raw detections
        otherwise (cold start / track loss)."""
        if self.tracks:
            return tracks_as_peaks(self.tracks)
        return (self.result.peaks.cpu().numpy().reshape(-1, 2),
                self.result.valid.cpu().numpy().reshape(-1))


class TrackingPipeline:
    """The per-session frame loop: prediction-gated detect -> track.

    Holds one full-sweep plan and (when ``theta_band`` is set) its gated
    twin for a fixed resolution.  Each ``process(frame)``:

      1. asks the tracker for the prediction gate; confirmed tracks yield
         a theta-bin vector and the *gated* plan runs, otherwise the full
         plan runs (cold start and track loss fall back to the full sweep),
      2. advances the tracker on the frame's detections,
      3. returns the raw result, the smoothed reported tracks, and which
         path ran.

    ``fused_corridors`` (requires ``cfg.hough.compact=True`` and a theta
    band) also builds the fused twin of the gated plan
    (``DetectionPlan.with_fused``): a frame whose tracker yields both a
    healthy gate and healthy rho corridors runs the ``fused_detect``
    kernel; any health failure falls back to the gated, then the full
    sweep.  ``gated_frames`` / ``full_frames`` / ``fused_frames`` count
    the split (a fused frame is a gated frame too).

    ``device`` follows the port's rule: the card unless ``"cpu"``.
    """

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 tracker: TrackerConfig = TrackerConfig(), *,
                 height: int = 240, width: int = 320,
                 theta_band: Optional[int] = 40,
                 fused_corridors: Optional[int] = None, device=None):
        if cfg.hough.theta_band is not None:
            raise ValueError(
                "pass the gate width via theta_band=, not through the "
                "config: the pipeline derives the gated plan itself"
            )
        if cfg.hough.corridors is not None or cfg.fused:
            raise ValueError(
                "pass the corridor count via fused_corridors=, not "
                "through the config: the pipeline derives the fused plan "
                "itself"
            )
        if fused_corridors is not None and theta_band is None:
            raise ValueError(
                "fused_corridors requires a theta_band: the fused plan "
                "is the gated plan's twin"
            )
        self._plans = PlanCache(cfg, device=device)
        self.device = self._plans.device
        self.full_plan = self._plans.plan_for(height, width)
        self.gated_plan = (
            self.full_plan.with_theta_band(theta_band)
            if theta_band is not None else None
        )
        # with_fused raises unless cfg.hough.compact=True
        self.fused_plan = (
            self.gated_plan.with_fused(fused_corridors)
            if fused_corridors is not None else None
        )
        self.n_theta = cfg.hough.n_theta
        self.theta_band = theta_band
        self.fused_corridors = fused_corridors
        self.tracker = LaneTracker(tracker)
        self.gated_frames = 0
        self.full_frames = 0
        self.fused_frames = 0

    def process(self, frame, controller=None) -> TrackedFrame:
        """Detect + track one frame.  ``controller`` is any object with a
        ``command(peaks, valid)`` method; when given, the frame's steering
        command comes from ``TrackedFrame.control_peaks``."""
        img = self._plans.put(load_frame(frame))
        bins = None
        if self.gated_plan is not None:
            bins = self.tracker.gate_bins(self.n_theta,
                                          band=self.theta_band)
        if bins is None:
            res = self.full_plan.run(img)
            self.full_frames += 1
        else:
            cors = (self.tracker.corridors(self.fused_corridors)
                    if self.fused_plan is not None else None)
            if cors is not None:
                res = self.fused_plan.run(img, bins, cors)
                self.fused_frames += 1
            else:
                res = self.gated_plan.run(img, bins)
            self.gated_frames += 1
        # the tracker is host code: one copy of the peaks back per frame
        tracks = self.tracker.step(res.peaks.cpu().numpy(),
                                   res.valid.cpu().numpy())
        out = TrackedFrame(res, tracks, bins is not None)
        if controller is not None:
            out = out._replace(
                steering=controller.command(*out.control_peaks)
            )
        return out
