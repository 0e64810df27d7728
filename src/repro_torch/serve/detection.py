"""Deadline-aware continuous-batching detection service
(``repro/serve/detection.py``), on the card.

The LM engine (``serve/engine.py``) serves token traffic with a fixed slot
grid; this module applies the same slot/bucket design to the line-detection
stack — and, because the paper's deployment is an AV control loop where a
*late* detection is a *useless* detection, layers an explicit QoS policy on
top of the plan-cache throughput machinery:

  * **Resolution buckets** — requests carry frames of heterogeneous
    resolutions; each frame pads (tapered edge replication, top-left
    anchored) to the smallest registered bucket that holds it, and results
    crop back bit-exact (``pad_to_bucket`` / ``crop_result``).
  * **Fixed batch slots** — every bucket owns a grid of ``batch_size``
    slots; a dispatch always runs the full grid (empty slots carry zero
    frames the frame-independent kernels ignore), so each bucket runs
    exactly one plan per render binding.
  * **Backpressure** — the admission queue is bounded (``max_queue``):
    submits beyond the bound are *rejected* with
    ``RequestStatus.QUEUE_FULL`` instead of silently stretching the tail,
    and queued requests that are expired — or *hopeless*, their remaining
    budget below a queue-depth-aware completion horizon (everything ahead
    of them in EDF order dispatches first, ``batch_size`` per wave) —
    are *shed* with ``RequestStatus.DEADLINE_EXCEEDED`` before they waste
    a slot.
    Every request terminates with an explicit status; nothing blows up
    latency silently, and doomed work never dominoes feasible work.
  * **QoS scheduling** — requests may carry a ``deadline_s`` budget and a
    ``priority`` class.  Admission within a bucket is strict-priority,
    earliest-deadline-first within a class (uniform-priority traffic is
    therefore pure EDF); dispatch ranks occupied grids the same way —
    highest class aboard, then tightest deadline — and
    *closes a batch early* (dispatches a partial grid) when waiting for
    more traffic would bust that deadline, given a per-bucket service-time
    estimate (EMA of measured dispatch times).  With no deadlines anywhere
    admitted the scheduler falls back to full-grid-first round-robin
    throughput mode — same traffic, bit-identical results.
  * **Prefetch staging** — host-side staging (grayscale decode + taper
    pad) runs ahead on a ``PrefetchStager`` worker thread: frame N+1
    stages while the device computes batch N.  The worker touches only
    numpy; the single pinned, non-blocking copy per dispatch
    (``PlanCache.put``) stays on the scheduler thread, so the post-warmup
    hot loop still runs under ``torch.cuda.set_sync_debug_mode("error")``.
  * **Session-stateful streaming** — requests sharing a ``session_id``
    are frames of one camera stream: the service keeps a per-session
    :class:`~repro_torch.core.tracking.LaneTracker`, advances it as each
    frame's result completes (slot order == admission order and one batch
    is in flight per grid, so a session's frames arrive at its tracker in
    stream order), and attaches the smoothed reported tracks to the
    request — temporal continuity across the batching machinery, per
    stream, without giving up cross-stream batching.
  * **Per-request rendering** — ``DetectionRequest(render_output=True)``
    returns the paper's phase-3 overlay for that request only, cropped
    back to the native resolution bit-exact; the grid flips to the plan's
    render binding (``DetectionPlan.with_render``) only when someone in
    the batch asked.
  * **Injectable clock** — every timestamp and every deadline/backpressure
    decision reads ``self.clock()`` (default ``time.perf_counter``).
    Passing a :class:`VirtualClock` makes the whole policy deterministic:
    traffic driven on virtual time makes the same decisions on the card
    and on the CPU, whatever the host's load.

  * **Degradation ladder** — under overload the service *downgrades*
    requests instead of shedding them, one rung at a time, driven by a
    :class:`LoadController` that reads queue depth, the per-bucket
    service-time EMA, and deadline slack.  Rung order (a request falls
    only as far as it must, and per-request :class:`DegradationPolicy`
    can forbid each rung):

      1. **Resolution downshift** (``DEGRADED_DOWNSHIFT``) — a hopeless
         request re-stages into a smaller registered bucket (2x mean-pool
         per halving, ``core.plan.downshift_frame``) where its deadline is
         feasible; the low-res result scales back to native coordinates
         in closed form (``upscale_result``), never below the policy's
         ``floor`` resolution.
      2. **Tracking coast** (``DEGRADED_COAST``) — a session request
         answers from its ``LaneTracker``'s k-step prediction
         (``predict_tracks``) with ZERO Hough dispatches; eligibility and
         budget are the tracker's own coast rules, so a session can never
         coast longer than it would survive a real camera blackout.
      3. **Priority-tiered shed** — the last rung: expired/unsalvageable
         work sheds with ``DEADLINE_EXCEEDED``, and a full queue evicts
         the worst strictly-lower-tier entry (largest ``priority`` value)
         before rejecting a higher-tier newcomer.

    Per-session SLO accounting (:class:`SessionSLO`) tracks
    full/downshift/coast/refused/late per stream.
  * **Fault injection** — every ladder rung is exercisable
    deterministically: a ``runtime.faults.ServiceFaultInjector`` can kill
    the prefetch worker mid-stream (the stager surfaces
    ``WorkerFailure`` to callers — never a silent hang — and the service
    restarts it up to ``max_stager_restarts`` before falling back to
    synchronous staging, with per-incarnation ``Heartbeat`` liveness on
    the service clock), fail or stall dispatches (``FAILED`` /
    late-complete with the EMA protected), jump the ``VirtualClock``
    forward (whole EDF waves expire in one step), and NaN-poison frames
    (``INVALID_FRAME``, or a coast answer when the session can back one).
    Every injected fault resolves to an explicit terminal status.

Plans come from ``core/plan.py``: one frozen ``DetectionPlan`` per bucket
(plus its render-bound twin on demand).

**The device seams.**  The scheduling policy is numpy on the injected
clock, line for line the reference's; the port differs only where a
batch meets the device (``device=``: ``None`` is the card and raises
without one, ``"cpu"`` runs the plain versions; there is no fallback):

  * *Shipping.*  One pinned, non-blocking copy a dispatch
    (``PlanCache.put``) from the scheduler thread; the union theta gate
    and rho corridors go through the same path.  The slot buffer is
    replaced after each dispatch, so a copy in flight never sees its
    source rewritten.
  * *The hot-loop guard.*  A warm dispatch (a (shape, render, band,
    fused) key already run once) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a hidden host sync
    raises instead of stalling.  A cold one (its first use builds
    kernels and library handles) retires the previous batch first and
    stays out of the service-time EMA.
  * *The reap.*  Each dispatch records a ``torch.cuda.Event`` after
    ``plan.run``; ``_reap`` polls ``event.query()``.  On the CPU there is
    no event: a result is ready once ``run`` returns.
  * *Completion.*  ``event.synchronize()``, then the batch's ``peaks``
    and ``valid`` come to the host once, for the trackers and the
    controllers.  A ``DONE`` request's ``result`` keeps the cropped
    tensors on the service's device; a ``DEGRADED_DOWNSHIFT`` result's
    fields are host numpy arrays (``upscale_result`` maps them on the
    host, as the reference does).
  * *Waits.*  A prefetched frame is waited for at most
    ``STAGE_TIMEOUT_S``; a worker that misses it is declared dead and the
    frame stages synchronously.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import heapq
import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Callable, Iterable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.control import (
    ControlConfig, LateralController, SteeringCommand,
)
from repro_torch.core.geometry import CameraConfig, CameraGeometry
from repro_torch.core.plan import (
    DetectionPlan, DetectionResult, PipelineConfig, PlanCache,
    downshift_frame, load_frame,
)
from repro_torch.core.tracking import (
    LaneTracker, Track, TrackerConfig, tracks_as_peaks,
)
from repro_torch.runtime.heartbeat import Heartbeat
from repro_torch.runtime.supervisor import WorkerFailure

# The longest wait for a prefetched frame (seconds): past it the worker
# is hung, and the frame stages on the scheduler thread instead.
STAGE_TIMEOUT_S = 30.0

# Default resolution ladder: QQVGA-ish up to the paper's camera frame.
DEFAULT_BUCKETS: tuple[tuple[int, int], ...] = (
    (120, 160), (240, 320), (480, 640),
)


class RequestStatus(enum.Enum):
    """Terminal disposition of a request (plus the initial PENDING).

    Classification goes through the properties below (and through
    ``DetectionRequest.is_terminal`` / ``.served`` / ``.degraded``), never
    through hand-enumerated status tuples: a new status added here is
    classified in exactly one place instead of silently falling through
    every call site's private list.
    """
    PENDING = "pending"
    DONE = "done"                          # full-fidelity result delivered
    # degradation ladder: served, but not at full fidelity
    DEGRADED_DOWNSHIFT = "degraded_downshift"  # served from a smaller bucket
    DEGRADED_COAST = "degraded_coast"      # served from tracker prediction
    # refusals: explicit terminal answers with no result
    QUEUE_FULL = "queue_full"              # rejected/evicted (backpressure)
    DEADLINE_EXCEEDED = "deadline_exceeded"  # shed before dispatch
    INVALID_FRAME = "invalid_frame"        # NaN/corrupt frame at admission
    FAILED = "failed"                      # dispatch fault (injected/real)

    @property
    def terminal(self) -> bool:
        """The request has its final answer (anything but PENDING)."""
        return self is not RequestStatus.PENDING

    @property
    def served(self) -> bool:
        """An answer was delivered (full fidelity or degraded)."""
        return self in (RequestStatus.DONE,
                        RequestStatus.DEGRADED_DOWNSHIFT,
                        RequestStatus.DEGRADED_COAST)

    @property
    def degraded(self) -> bool:
        return self in (RequestStatus.DEGRADED_DOWNSHIFT,
                        RequestStatus.DEGRADED_COAST)

    @property
    def refused(self) -> bool:
        """Terminal without an answer (shed/rejected/failed/invalid)."""
        return self.terminal and not self.served


class VirtualClock:
    """Deterministic monotonic clock: advances only when told to.

    Inject as ``DetectionService(..., clock=VirtualClock())`` to make every
    deadline/backpressure/early-close decision — and every latency stamp —
    a pure function of the driven schedule.  The unit for ``advance`` is
    seconds, same as ``time.perf_counter``.  Monotonicity is a hard
    contract (the EDF heaps, the EMA, and every ``latency_s`` depend on
    it): backward motion raises instead of corrupting the schedule, which
    is also what makes the fault harness's *forward* clock jumps
    (``ServiceFaultInjector.clock_jump_at_step``) safe to inject —
    a jump is indistinguishable from a long stall, expiring whole EDF
    waves in one step, never un-expiring anything.
    """

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        assert dt >= 0.0, f"clock cannot run backward (dt={dt})"
        self.t += float(dt)
        return self.t

    def jump_to(self, t: float) -> float:
        """Jump to absolute time ``t`` (>= now); backward jumps raise."""
        if t < self.t:
            raise ValueError(
                f"backward clock jump rejected: {t} < {self.t}"
            )
        self.t = float(t)
        return self.t


class PrefetchStager:
    """Single worker thread staging host-side work ahead of the device.

    ``stage(fn, *args)`` enqueues ``fn(*args)`` and returns a
    ``concurrent.futures.Future``; the service resolves it at admission
    time, by which point the worker has usually finished — frame N+1 pads
    while the device computes batch N.  The worker runs numpy only
    (grayscale decode + taper pad); the copy to the device stays on the
    scheduler thread.  Staging is deterministic, so the threaded stream
    is bit-for-bit the synchronous one.

    **Worker death is loud.**  A task exception resolves its future and
    the worker lives on (same contract as an executor).  A
    ``WorkerFailure`` — raised by the optional ``fault_hook`` (the fault
    harness's injected thread death) or by the task itself — kills the
    worker: the fatal task's future carries the exception, every queued
    future is failed with it, and subsequent ``stage`` calls raise
    ``WorkerFailure`` immediately.  No caller can ever block on a future
    the dead worker will never run (the submit/death race is closed by
    re-draining after enqueue).  With a ``heartbeat_registry`` the worker
    beats once per task on the injected clock, so a
    ``HeartbeatMonitor`` detects the death deterministically.
    """

    def __init__(self, *, fault_hook: Optional[Callable[[], None]] = None,
                 heartbeat_registry: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic,
                 worker_id: str = "detection-prefetch"):
        self.worker_id = worker_id
        self._tasks: "queue.SimpleQueue[Optional[tuple]]" = (
            queue.SimpleQueue()
        )
        self._dead = threading.Event()
        self._fault_hook = fault_hook
        self.heartbeat = (
            Heartbeat(worker_id, heartbeat_registry, clock=clock)
            if heartbeat_registry is not None else None
        )
        self._thread = threading.Thread(
            target=self._worker, name=worker_id, daemon=True
        )
        self._thread.start()

    @property
    def alive(self) -> bool:
        return not self._dead.is_set()

    def stage(self, fn, *args) -> Future:
        """Enqueue ``fn(*args)``; raises ``WorkerFailure`` if the worker
        is dead (an explicit error at the submit site, not a future that
        silently never resolves)."""
        if self._dead.is_set():
            raise WorkerFailure(
                f"prefetch worker {self.worker_id!r} is dead"
            )
        fut: Future = Future()
        self._tasks.put((fut, fn, args))
        if self._dead.is_set():
            # the worker died while we enqueued: its drain may have run
            # before our put landed, so drain again — both drains are
            # idempotent, and the future is guaranteed resolved either way
            self._fail_pending()
        return fut

    def _fail_pending(self) -> None:
        """Fail every queued future with ``WorkerFailure`` (idempotent —
        callable from the dying worker AND from a racing ``stage``)."""
        while True:
            try:
                item = self._tasks.get_nowait()
            except queue.Empty:
                return
            if item is None:
                continue
            fut = item[0]
            try:
                fut.set_exception(
                    WorkerFailure("prefetch worker died before this task")
                )
            except InvalidStateError:
                pass   # the other drainer (or the worker) got there first

    def _worker(self) -> None:
        while True:
            item = self._tasks.get()
            if item is None:
                return                     # orderly close()
            fut, fn, args = item
            if self.heartbeat is not None:
                self.heartbeat.beat()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                if self._fault_hook is not None:
                    self._fault_hook()     # injected thread death
                fut.set_result(fn(*args))
            except WorkerFailure as e:     # fatal: the thread dies
                self._dead.set()
                try:
                    fut.set_exception(e)
                except InvalidStateError:
                    pass
                self._fail_pending()
                return
            except BaseException as e:     # task error: worker survives
                fut.set_exception(e)

    def abandon(self) -> None:
        """Declare a hung worker dead: every queued future fails with
        ``WorkerFailure``, later ``stage`` calls raise, and the thread, if
        it ever wakes, finishes its task and exits."""
        self._dead.set()
        self._fail_pending()
        self._tasks.put(None)

    def close(self) -> None:
        if not self._dead.is_set():
            self._tasks.put(None)
        self._thread.join(timeout=5.0)
        self._dead.set()
        if self.heartbeat is not None:
            self.heartbeat.stop()


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Per-request contract with the degradation ladder.

    The default allows every rung — the service degrades rather than
    sheds whenever it can.  A safety-critical caller that would rather
    get an explicit refusal than a low-res or predicted answer forbids
    the rungs it cannot act on; ``floor`` bounds how far the resolution
    may fall (the smallest bucket the downshift rung may target).
    """
    allow_downshift: bool = True
    allow_coast: bool = True
    floor: Optional[tuple[int, int]] = None  # min (H, W) bucket allowed


DEFAULT_POLICY = DegradationPolicy()
SHED_ONLY = DegradationPolicy(allow_downshift=False, allow_coast=False)


@dataclasses.dataclass
class SessionSLO:
    """Per-session service-level accounting (one per ``session_id``).

    ``miss_rate`` counts explicit refusals plus late full answers —
    the fraction of the stream's frames the vehicle could not steer by.
    ``degraded_rate`` is the fidelity cost the ladder paid to keep the
    miss rate down.
    """
    submitted: int = 0
    served_full: int = 0
    served_downshift: int = 0
    served_coast: int = 0
    refused: int = 0        # shed / rejected / failed / invalid
    late: int = 0           # served, but after the deadline

    @property
    def served(self) -> int:
        return self.served_full + self.served_downshift + self.served_coast

    @property
    def degraded_rate(self) -> float:
        s = self.served
        return (self.served_downshift + self.served_coast) / s if s else 0.0

    @property
    def miss_rate(self) -> float:
        n = self.submitted
        return (self.refused + self.late) / n if n else 0.0


@dataclasses.dataclass
class DetectionRequest:
    """One frame in, one ``DetectionResult`` (or explicit refusal) out."""
    uid: int
    frame: np.ndarray                       # (H, W) or (H, W, 3)
    deadline_s: Optional[float] = None      # latency budget from submit
    priority: int = 0                       # strict class: lower admits first
    render_output: bool = False             # per-request phase-3 overlay
    # Session-stateful streaming: requests sharing a ``session_id`` are
    # frames of one camera stream.  The service keeps a LaneTracker per
    # session, advances it as each frame's result lands, and attaches the
    # smoothed reported tracks to the request (``tracks``).  Frames of a
    # session must be submitted in stream order and share one resolution
    # bucket — within a bucket, completion follows dispatch order (one
    # batch in flight per grid), so the tracker sees the stream in order.
    session_id: Optional[str] = None
    policy: DegradationPolicy = DEFAULT_POLICY
    # filled by the service.  ``result``: tensors on the service's device
    # for DONE (views of the batch, cropped), host numpy arrays for
    # DEGRADED_DOWNSHIFT (mapped back to native coordinates on the host)
    result: Optional[DetectionResult] = None
    tracks: Optional[list[Track]] = None    # smoothed tracks (sessions only)
    steering: Optional[SteeringCommand] = None  # lateral command (sessions
                                                # with steering enabled):
                                                # fresh on served answers,
                                                # a decayed hold on refusals
    status: RequestStatus = RequestStatus.PENDING
    bucket: Optional[tuple[int, int]] = None
    downshift: int = 1                      # resolution divisor served at
    submitted_at: float = 0.0
    finished_at: float = 0.0
    deadline_at: Optional[float] = None     # absolute, on the service clock
    _staged: Optional[Union[Future, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    _ds_shape: Optional[tuple[int, int]] = dataclasses.field(
        default=None, repr=False, compare=False
    )   # downshifted content shape inside the target bucket

    @property
    def latency_s(self) -> float:
        return self.finished_at - self.submitted_at

    @property
    def is_terminal(self) -> bool:
        """The request has its final answer — THE status check every
        other predicate routes through (new statuses classify once, in
        ``RequestStatus``, instead of falling through call-site lists)."""
        return self.status.terminal

    @property
    def done(self) -> bool:
        """Alias of ``is_terminal`` (pre-ladder name, kept for callers)."""
        return self.is_terminal

    @property
    def ok(self) -> bool:
        """Full-fidelity result delivered (degraded answers are *served*
        but not ``ok`` — callers gate fidelity-sensitive paths on this)."""
        return self.status is RequestStatus.DONE

    @property
    def served(self) -> bool:
        """An answer usable for steering was delivered (full or degraded:
        a downshifted result or a coast prediction)."""
        return self.status.served

    @property
    def degraded(self) -> bool:
        return self.status.degraded

    @property
    def missed_deadline(self) -> bool:
        """Refused (shed/rejected/failed/invalid), or served late."""
        if self.deadline_at is None:
            return False
        if self.status.refused:
            return True
        return self.is_terminal and self.finished_at > self.deadline_at


class _InFlight(NamedTuple):
    """A dispatched batch awaiting completion.

    ``warm=False`` marks a cold dispatch whose wall time must not feed the
    service-time EMA; ``stall_s > 0`` an injected dispatch stall
    (completion lands late, EMA untouched).  ``event`` is recorded on the
    current stream after ``plan.run`` (None on the CPU, where the result
    is ready once ``run`` returns).  ``plan``, ``images``, ``theta_bins``
    and ``corridors`` are what ran, on the device: the batch can be run
    again to check the answer.
    """
    reqs: list
    result: DetectionResult
    t_dispatch: float
    warm: bool
    stall_s: float
    event: Optional[object]
    plan: DetectionPlan
    images: torch.Tensor
    theta_bins: Optional[torch.Tensor]
    corridors: Optional[torch.Tensor]


class _BucketGrid:
    """Slot grid + staging state for one resolution bucket."""

    def __init__(self, shape: tuple[int, int], batch_size: int,
                 plan: DetectionPlan, est_s: float):
        self.shape = shape
        self.plan = plan
        self.est_s = est_s      # EMA service-time estimate for one dispatch
        self.est_measured = False   # True once a real dispatch fed the EMA
        self.slots: list[Optional[DetectionRequest]] = [None] * batch_size
        self.staged = np.zeros((batch_size, *shape), np.float32)
        self.in_flight: Optional[_InFlight] = None

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def tightest_deadline(self) -> float:
        """Earliest deadline among slotted requests (inf if none)."""
        ds = [r.deadline_at for r in self.slots
              if r is not None and r.deadline_at is not None]
        return min(ds) if ds else math.inf


# Pad decay horizon (pixels): the diffused pad reaches the flat fill level
# by this depth regardless of pad size.
_PAD_TAPER = 32


def _diffuse_pad(border: np.ndarray, n: int, fill: np.float32
                 ) -> np.ndarray:
    """Continue a border line outward for ``n`` steps, diffusing as it
    fades: each step blurs the previous line ([1, 2, 1]/4) and decays it
    toward ``fill``.  The blur spreads any stroke crossing the border so
    its transverse contrast collapses within a few steps (no extruded bar
    for Hough to vote up), while the decay's along-step slope stays under
    the Canny low threshold (no edge along the taper itself).

    ``border``: (W,) the outermost content line.  Returns (n, W).
    """
    rows = np.empty((n, border.shape[0]), np.float32)
    prev = border.astype(np.float32)
    for i in range(n):
        blurred = prev.copy()
        blurred[1:-1] = (
            0.25 * prev[:-2] + 0.5 * prev[1:-1] + 0.25 * prev[2:]
        )
        k = max(0.0, 1.0 - (i + 1.0) / _PAD_TAPER)
        prev = fill + (blurred - fill) * np.float32(k)
        rows[i] = prev
    return rows


def pad_to_bucket(frame: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Grayscale-load ``frame`` and pad it (top-left anchored) to the
    bucket shape with a *diffusing* edge continuation: the boundary
    row/column carries on (no synthetic step at the content border) while
    blurring and fading to the frame mean.  Plain replication would
    extrude every stroke touching the border into a long axis-aligned
    bright bar — strong enough to vote up spurious near-vertical/
    horizontal lines and to inflate the peak the relative threshold
    normalizes by.  Diffusion kills the bar's transverse contrast within
    a few pixels and the fade slope stays below the Canny thresholds, so
    the pad region contributes (nearly) no edges at any pad size."""
    img = load_frame(frame)
    H, W = img.shape
    bh, bw = shape
    assert H <= bh and W <= bw, (img.shape, shape)
    if (H, W) == (bh, bw):
        return img
    fill = np.float32(img.mean())
    out = np.empty((bh, bw), np.float32)
    out[:H, :W] = img
    if bh > H:
        out[H:, :W] = _diffuse_pad(img[H - 1, :], bh - H, fill)
    if bw > W:
        # columns diffuse from the full left part (content + row pad), so
        # the corner continues both tapers consistently
        out[:, W:] = _diffuse_pad(out[:, W - 1], bw - W, fill).T
    return out


def crop_result(res: DetectionResult, height: int, width: int
                ) -> DetectionResult:
    """Un-pad one frame's result: (rho, theta) peaks are already in
    original coordinates (top-left anchoring) and ``lines`` endpoints
    parameterize the same infinite lines (out-of-frame endpoints are
    normal — the unbatched detector produces them too); raster fields
    (edges, the rendered overlay) crop to (H, W)."""
    return DetectionResult(
        res.lines, res.valid, res.peaks,
        res.edges[..., :height, :width],
        None if res.rendered is None
        else res.rendered[..., :height, :width, :],
    )


def upscale_result(res: DetectionResult, factor: int,
                   height: int, width: int) -> DetectionResult:
    """Map a downshifted frame's (already cropped) result back to native
    coordinates.

    The 2x mean-pool chain maps native pixel centers ``x`` to downshifted
    centers ``(x - c) / factor`` with ``c = (factor - 1) / 2`` (the
    pool's phase offset), so the inverse is exact on line parameters:
    endpoints scale as ``p_native = factor * p + c`` and a (rho, theta)
    peak — theta is scale-invariant — as
    ``rho_native = factor * rho + c * (cos theta + sin theta)``.
    Raster fields (edges, the overlay) nearest-neighbour upsample and
    crop to the native (H, W): blocky, but honest about the fidelity the
    answer was computed at — this is a *degraded* response, flagged
    ``DEGRADED_DOWNSHIFT``, not a reconstruction.

    The fields may be tensors on any device or numpy arrays; the mapping
    runs on the host (numpy, the reference's arithmetic) and returns host
    arrays.
    """
    c = (factor - 1) / 2.0
    peaks = np.array(_host(res.peaks), np.float32).reshape(-1, 2).copy()
    th = peaks[:, 1]
    peaks[:, 0] = factor * peaks[:, 0] + c * (np.cos(th) + np.sin(th))
    lines = factor * np.array(_host(res.lines), np.float32) + c
    valid = _host(res.valid)
    edges = _host(res.edges)
    edges = edges.repeat(factor, axis=-2).repeat(factor, axis=-1)
    edges = edges[..., :height, :width]
    rendered = None
    if res.rendered is not None:
        rendered = _host(res.rendered)
        rendered = rendered.repeat(factor, axis=-3).repeat(factor, axis=-2)
        rendered = rendered[..., :height, :width, :]
    return DetectionResult(lines, valid, peaks, edges, rendered)


def _host(x) -> np.ndarray:
    """A result field as a host numpy array (a copy from the device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """On the card, make any host sync raise (``set_sync_debug_mode``
    "error") for the block, and restore the caller's mode after it."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _nan_poison(frame: np.ndarray) -> np.ndarray:
    """Corrupt a frame the way a DMA tear or truncated capture does:
    load it to the service's canonical f32 grayscale and stamp a NaN
    block over the top-left tile.  Used by the fault injector at submit
    so the admission finiteness check (not downstream kernel math) is
    what fields the corruption."""
    img = np.array(load_frame(frame), np.float32, copy=True)
    img[:8, :8] = np.nan
    return img


class BucketLoad(NamedTuple):
    """One bucket's load snapshot (see :class:`LoadController`)."""
    shape: tuple[int, int]
    queued: int                 # EDF queue depth
    active: int                 # occupied slots
    est_s: float                # service-time EMA (one dispatch)
    est_measured: bool          # a real warm dispatch grounded the EMA
    horizon_s: float            # time to drain slotted + queued work
    tightest_slack_s: float     # min(deadline - now) over queued+slotted

    @property
    def overloaded(self) -> bool:
        """The tightest deadline cannot survive the drain horizon."""
        return (math.isfinite(self.tightest_slack_s)
                and self.horizon_s > self.tightest_slack_s)


class LoadController:
    """The ladder's sensor + decision helper: reads queue depth, the
    per-bucket service-time EMA, and deadline slack; answers "can this
    deadline still be met here?" and "which smaller bucket should this
    request fall to?".

    Feasibility is the same queue-depth-aware horizon the shed rule uses
    (``waves * est_s`` with ``waves = ahead // batch_size + 1``), and it
    only *engages* once the bucket's estimate is measured — the ladder
    inherits the shed rule's no-latch discipline: an unvalidated prior
    must not downshift (or refuse) an entirely feasible workload.
    """

    def __init__(self, service: "DetectionService"):
        self._svc = service

    def est_s(self, shape: tuple[int, int]) -> float:
        """The bucket's EMA, or 0.0 while unmeasured (optimism by
        design: see the no-latch note in the class docstring)."""
        g = self._svc.grids[shape]
        return g.est_s if g.est_measured else 0.0

    def waves(self, shape: tuple[int, int], ahead: int) -> int:
        return ahead // len(self._svc.grids[shape].slots) + 1

    def horizon_s(self, shape: tuple[int, int], ahead: int) -> float:
        """Completion horizon for a request queued behind ``ahead``
        entries in ``shape``'s bucket."""
        return self.waves(shape, ahead) * self.est_s(shape)

    def feasible(self, shape: tuple[int, int],
                 deadline_at: Optional[float], now: float,
                 ahead: int) -> bool:
        """Can a request with this absolute deadline still make it?"""
        if deadline_at is None:
            return True
        est = self.est_s(shape)
        if est <= 0.0:              # unmeasured: only expiry is certain
            return deadline_at > now
        return deadline_at >= now + self.horizon_s(shape, ahead)

    def load(self, shape: tuple[int, int], now: float) -> BucketLoad:
        """Introspection snapshot of one bucket (for operators)."""
        svc = self._svc
        g = svc.grids[shape]
        q = svc.queues[shape]
        slacks = [k - now for (_, k, _, _) in q if math.isfinite(k)]
        slacks += [
            r.deadline_at - now for r in g.slots
            if r is not None and r.deadline_at is not None
        ]
        return BucketLoad(
            shape, len(q), g.active, g.est_s, g.est_measured,
            self.horizon_s(shape, g.active + len(q)),
            min(slacks) if slacks else math.inf,
        )

    def downshift_target(self, req: DetectionRequest, now: float
                         ) -> Optional[tuple[int, int]]:
        """Largest registered bucket below the request's current one, at
        or above its policy ``floor``, where its deadline is feasible
        given that bucket's current depth — or None (rung exhausted)."""
        svc = self._svc
        idx = svc.buckets.index(req.bucket)
        floor = req.policy.floor
        for target in reversed(svc.buckets[:idx]):
            if floor is not None and (target[0] < floor[0]
                                      or target[1] < floor[1]):
                continue
            ahead = svc.grids[target].active + len(svc.queues[target])
            if self.feasible(target, req.deadline_at, now, ahead):
                return target
        return None


class DetectionService:
    """Request-level line detection with backpressure + QoS over fixed
    per-bucket batch slots.

    ``submit`` enqueues (or rejects) requests; ``step`` sheds expired work,
    admits earliest-deadline-first, dispatches one bucket grid — closing a
    batch early when the tightest admitted deadline can't wait — and
    completes the previously dispatched one (double-buffering); ``run``
    drains everything.  ``detect_many`` is the convenience loop the
    benchmarks use.

    QoS knobs:
      * ``max_queue`` — bound on the admission queue (None = unbounded);
        submits beyond it return ``RequestStatus.QUEUE_FULL`` (with the
        ladder on, a strictly-lower-tier queued request is evicted first).
      * ``est_dispatch_s`` / ``est_smoothing`` — initial per-bucket
        service-time estimate and its EMA factor; the early-close rule
        dispatches a partial grid when ``deadline - now <= est``.
      * ``clock`` — injectable monotonic clock (see :class:`VirtualClock`).
      * ``prefetch`` — stage frames on a :class:`PrefetchStager` worker
        thread (True, default) or synchronously at admission (False);
        results are bit-identical either way.
      * ``device`` — where the plans run: ``None`` is the card (and raises
        on a host without one), ``"cpu"`` the plain versions.

    Robustness knobs (the degradation ladder + fault harness):
      * ``ladder`` — enable the degradation ladder (default True; False
        is the pre-ladder shed-only service, the fleet benchmark's
        baseline arm).
      * ``validate_frames`` — finiteness-check staged frames at admission
        (a NaN frame would silently poison its whole batch's reduction
        stages); invalid frames coast if their session can back it, else
        refuse with ``INVALID_FRAME``.
      * ``faults`` — a ``runtime.faults.ServiceFaultInjector`` wired into
        the stager / dispatch / clock / frame paths (None in production).
      * ``max_stager_restarts`` — supervision budget for prefetch-worker
        deaths: each death restarts a fresh worker (new ``Heartbeat``
        incarnation in ``self.heartbeats``) until the budget is spent,
        then staging falls back to synchronous (prefetch off) — degraded
        throughput, never a wrong answer.
    """

    def __init__(self, cfg: PipelineConfig = PipelineConfig(), *,
                 buckets: Sequence[tuple[int, int]] = DEFAULT_BUCKETS,
                 batch_size: int = 4,
                 max_queue: Optional[int] = None,
                 est_dispatch_s: float = 0.05,
                 est_smoothing: float = 0.3,
                 clock: Callable[[], float] = time.perf_counter,
                 prefetch: bool = True,
                 tracker: TrackerConfig = TrackerConfig(),
                 ladder: bool = True,
                 validate_frames: bool = True,
                 faults: Optional[object] = None,
                 max_stager_restarts: int = 3,
                 gate_band: Optional[int] = 40,
                 fused_corridors: Optional[int] = None,
                 steering: Optional[ControlConfig] = None,
                 camera: Optional[CameraConfig] = None,
                 device: Optional[object] = None):
        if cfg.hough.theta_band is not None:
            raise ValueError(
                "pass the gate width via gate_band=, not through the "
                "config: the service derives gated plans itself"
            )
        if cfg.hough.corridors is not None or cfg.fused:
            raise ValueError(
                "pass the corridor count via fused_corridors=, not "
                "through the config: the service derives fused plans "
                "itself"
            )
        if fused_corridors is not None:
            if gate_band is None:
                raise ValueError(
                    "fused_corridors requires gate_band: the fused plan "
                    "is the gated plan's twin"
                )
            if not cfg.hough.compact:
                raise ValueError(
                    "fused_corridors requires hough.compact=True: the "
                    "fused kernel's output IS the compacted edge list"
                )
        self.cfg = cfg
        self.batch_size = batch_size
        self.tracker_cfg = tracker
        self.sessions: dict[str, LaneTracker] = {}
        # Steering surface: with a ControlConfig, every *session* request
        # leaves the service carrying a SteeringCommand — a fresh
        # pure-pursuit command on served answers (full, downshifted, or
        # coast), a decayed hold on refusals — so a vehicle consuming
        # the stream always has a lateral command, degradation included.
        # One LateralController per session, on the service clock; the
        # camera model is one fixed rig rescaled to each session's
        # native resolution (CameraConfig.for_image).
        self.steering_cfg = steering
        self.camera_cfg = camera if camera is not None else CameraConfig()
        self.controllers: dict[str, LateralController] = {}
        self.buckets = tuple(sorted(buckets))
        self.max_queue = max_queue
        self.est_smoothing = est_smoothing
        self.clock = clock
        self.prefetch = prefetch
        self.ladder = ladder
        self.validate_frames = validate_frames
        self.faults = faults
        self.max_stager_restarts = max_stager_restarts
        self.gate_band = gate_band
        self.fused_corridors = fused_corridors
        self.load_controller = LoadController(self)
        # one PlanCache per service, pinned to one device (the card unless
        # device="cpu"; raises with no card): plans and the per-dispatch
        # pinned copy go there
        self.plans = PlanCache(cfg, device=device)
        self.device = self.plans.device
        self.grids = {
            shape: _BucketGrid(
                shape, batch_size,
                self.plans.plan_for(*shape, batch=batch_size),
                est_dispatch_s,
            )
            for shape in self.buckets
        }
        # Admission queues: heap of (priority, deadline, seq, request) —
        # strict priority classes, earliest-deadline-first within a class
        # (all-equal-priority traffic is therefore pure EDF, the pre-tier
        # behavior; a safety tier is never queued behind bulk work)
        self.queues: dict[
            tuple[int, int],
            list[tuple[int, float, int, DetectionRequest]],
        ] = {shape: [] for shape in self.buckets}
        self._seq = 0
        self._rr = 0            # round-robin cursor (throughput mode)
        self._steps = 0
        # (shape, render, theta_band, fused) plan bindings already run once
        self._warmed: set[
            tuple[tuple[int, int], bool, Optional[int], bool]
        ] = set()
        self._loader: Optional[PrefetchStager] = None
        self.heartbeats: dict[str, float] = {}   # stager liveness registry
        self.slo: dict[str, SessionSLO] = {}     # per-session accounting
        self._session_coasts: dict[str, int] = {}  # consecutive coasts
        self.dispatches = 0
        self.completed = 0
        self.rejected_queue_full = 0
        self.shed_deadline = 0
        self.completed_late = 0
        # ladder + fault counters
        self.downshifted = 0          # requests moved to a smaller bucket
        self.pre_downshifted = 0      # ...of which at admission time
        self.served_downshift = 0     # completed at reduced resolution
        self.served_coast = 0         # answered from tracker prediction
        self.gated_dispatches = 0     # dispatches under a union theta gate
        self.fused_dispatches = 0     # ...of which ran the fused hot path
        self.evicted = 0              # lower-tier evictions (in rejected_*)
        self.rejected_invalid = 0     # NaN/corrupt frames refused
        self.dispatch_faults = 0      # requests failed by dispatch faults
        self.stager_deaths = 0        # prefetch-worker deaths observed
        # (shape, active slots, render) per dispatch — introspection for
        # callers; bounded so a long-running service cannot
        # accrete it without limit
        self.dispatch_log: deque[tuple[tuple[int, int], int, bool]] = (
            deque(maxlen=4096)
        )

    # --- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Stop the prefetch worker (idempotent)."""
        if self._loader is not None:
            self._loader.close()
            self._loader = None

    # --- sessions -------------------------------------------------------
    def session_tracks(self, session_id: str) -> list[Track]:
        """Current live tracks of a streaming session ([] if unknown)."""
        tracker = self.sessions.get(session_id)
        return tracker.tracks if tracker is not None else []

    def end_session(self, session_id: str) -> None:
        """Drop a session's tracker state (idempotent; SLO stats are kept
        — accounting outlives the stream it measured)."""
        self.sessions.pop(session_id, None)
        self._session_coasts.pop(session_id, None)
        self.controllers.pop(session_id, None)

    def _controller(self, req: DetectionRequest
                    ) -> Optional[LateralController]:
        """The per-session lateral controller (None unless steering is
        enabled and the request belongs to a session)."""
        if self.steering_cfg is None or req.session_id is None:
            return None
        ctl = self.controllers.get(req.session_id)
        if ctl is None:
            H, W = req.frame.shape[:2]
            ctl = LateralController(
                CameraGeometry(self.camera_cfg.for_image(H, W)),
                self.steering_cfg, clock=self.clock,
            )
            self.controllers[req.session_id] = ctl
        return ctl

    def session_slo(self, session_id: str) -> SessionSLO:
        """The session's SLO accounting (zeros if never seen)."""
        return self.slo.get(session_id, SessionSLO())

    def _slo(self, session_id: str) -> SessionSLO:
        s = self.slo.get(session_id)
        if s is None:
            s = self.slo[session_id] = SessionSLO()
        return s

    @property
    def stager_alive(self) -> bool:
        """Is the current prefetch worker live (True when prefetch is
        synchronous — there is no worker to die)."""
        return self._loader is None or self._loader.alive

    def __enter__(self) -> "DetectionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- bucketing -----------------------------------------------------
    def bucket_for(self, frame: np.ndarray) -> tuple[int, int]:
        """Smallest registered bucket that holds ``frame``."""
        H, W = frame.shape[:2]
        for bh, bw in self.buckets:
            if H <= bh and W <= bw:
                return (bh, bw)
        raise ValueError(
            f"frame {frame.shape} exceeds every bucket {self.buckets}"
        )

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self.queues.values())

    # --- request lifecycle ---------------------------------------------
    def submit(self, req: DetectionRequest, *,
               force_bucket: Optional[tuple[int, int]] = None
               ) -> RequestStatus:
        """Enqueue ``req`` — or reject it with ``QUEUE_FULL`` when the
        bounded admission queue is at capacity (backpressure: the caller
        learns *now*, instead of every queued request learning late).
        With the ladder on, a full queue first tries to evict the worst
        strictly-lower-tier queued request (priority-tiered shedding:
        tier-0 traffic displaces tier-2, never a peer).

        ``force_bucket`` downshifts the request into that (smaller,
        registered) bucket unconditionally at admission — the
        speculative-offload local tier (``serve/fleet.py``), whose
        low-res pass is a downshift *by design*, not a reaction to
        load."""
        req.bucket = self.bucket_for(req.frame)
        now = self.clock()
        req.submitted_at = now
        if req.deadline_s is not None:
            req.deadline_at = now + req.deadline_s
        if req.session_id is not None:
            self._slo(req.session_id).submitted += 1
        if self.faults is not None and self.faults.corrupts(req.uid):
            req.frame = _nan_poison(req.frame)
        if self.max_queue is not None and self.queued >= self.max_queue:
            if not (self.ladder and self._evict_for(req, now)):
                # before refusing outright, a session newcomer may still
                # be answered from its tracker — a degraded answer under
                # backpressure beats an explicit refusal (same rung
                # order the queue police applies)
                if self.ladder and self._try_coast(req, now):
                    return req.status
                self._refuse(req, RequestStatus.QUEUE_FULL, now)
                self.rejected_queue_full += 1
                return req.status
        if force_bucket is not None and force_bucket != req.bucket:
            assert force_bucket in self.buckets, (force_bucket,
                                                  self.buckets)
            self._downshift_into(req, force_bucket)
        # Pre-downshift at admission: when the bucket's measured backlog
        # already makes this deadline infeasible, rung 1 engages NOW —
        # queueing at the native bucket first would burn the little slack
        # the request has left before the queue police notices it is
        # hopeless (one whole scheduler step later, after which even the
        # smaller bucket may no longer save it).
        if (self.ladder and req.deadline_at is not None
                and req.policy.allow_downshift):
            grid = self.grids[req.bucket]
            ahead = grid.active + len(self.queues[req.bucket])
            if not self.load_controller.feasible(
                    req.bucket, req.deadline_at, now, ahead):
                target = self.load_controller.downshift_target(req, now)
                if target is not None and self._downshift_into(req, target):
                    self.pre_downshifted += 1
        # Prefetch pays only when staging does real work (luma conversion
        # or taper padding).  A grayscale frame already at bucket shape is
        # a pass-through: shipping it to the worker would add one thread
        # round-trip of pure overhead per request.
        needs_staging = (
            req.frame.ndim == 3 or req.frame.shape[:2] != req.bucket
            or req.frame.dtype != np.float32
        )
        if self.prefetch and needs_staging and req._staged is None:
            self._stage_supervised(req)
        self._seq += 1
        key = req.deadline_at if req.deadline_at is not None else math.inf
        heapq.heappush(
            self.queues[req.bucket], (req.priority, key, self._seq, req)
        )
        return RequestStatus.PENDING

    # --- refusals + SLO --------------------------------------------------
    def _refuse(self, req: DetectionRequest, status: RequestStatus,
                now: float) -> None:
        """Terminate ``req`` without an answer (explicit refusal)."""
        req.status = status
        req.finished_at = now
        req._staged = None
        if req.session_id is not None:
            self._slo(req.session_id).refused += 1
            ctl = self._controller(req)
            if ctl is not None:
                # no answer still needs a lateral command: the vehicle
                # holds the last one, decayed toward straight
                req.steering = ctl.hold()

    def _evict_for(self, req: DetectionRequest, now: float) -> bool:
        """Priority-tiered backpressure: free one queue slot for ``req``
        by shedding the worst queued request of a STRICTLY lower tier
        (larger ``priority`` value; ties broken latest-deadline, then
        latest-arrival).  Equal-tier traffic is never displaced — within
        a tier the original reject-the-newcomer contract stands, so a
        tier cannot starve itself by churning."""
        worst_rank: Optional[tuple[int, float, int]] = None
        worst: Optional[tuple[tuple[int, int], tuple]] = None
        for shape, q in self.queues.items():
            for entry in q:
                prio, key, seq, _ = entry
                if prio <= req.priority:
                    continue
                rank = (prio, key, seq)
                if worst_rank is None or rank > worst_rank:
                    worst_rank, worst = rank, (shape, entry)
        if worst is None:
            return False
        shape, entry = worst
        q = self.queues[shape]
        q.remove(entry)
        heapq.heapify(q)
        victim = entry[3]
        # the victim leaves the queue either way; a session victim whose
        # tracker can back a coast gets a degraded answer instead of a
        # refusal (rung 2 before rung 3, same as the queue police)
        if not self._try_coast(victim, now):
            self._refuse(victim, RequestStatus.QUEUE_FULL, now)
            self.rejected_queue_full += 1   # still a backpressure refusal
        self.evicted += 1
        return True

    # --- prefetch supervision -------------------------------------------
    def _make_stager(self) -> PrefetchStager:
        hook = (self.faults.check_stage
                if self.faults is not None else None)
        return PrefetchStager(
            fault_hook=hook, heartbeat_registry=self.heartbeats,
            clock=self.clock,
            worker_id=f"detection-prefetch-{self.stager_deaths}",
        )

    def _note_stager_death(self) -> None:
        """Account a dead prefetch worker and decide restart vs fallback:
        within the ``max_stager_restarts`` budget the next staging call
        starts a fresh worker (a new heartbeat incarnation); past it,
        prefetch turns off and staging runs synchronously at admission —
        results are bit-identical either way, only overlap is lost.

        One real death can surface more than once (the fatal task's
        future AND every queued future carry ``WorkerFailure``), so the
        death is only charged while the dead worker is still the current
        one — a stale failure from an already-replaced worker is not a
        second death."""
        if self._loader is None or self._loader.alive:
            return
        self.stager_deaths += 1
        self._loader = None
        if self.stager_deaths > self.max_stager_restarts:
            self.prefetch = False

    def _stage_supervised(self, req: DetectionRequest) -> None:
        """Stage on the prefetch worker; on ``WorkerFailure`` (the death
        the stager surfaces *explicitly* at the submit site) restart once
        within budget, else leave ``req`` unstaged — admission stages it
        synchronously.  Either way the request is answered; a dead thread
        costs overlap, never correctness."""
        for _ in range(2):
            if not self.prefetch:
                return
            if self._loader is None:
                self._loader = self._make_stager()
            try:
                req._staged = self._loader.stage(
                    pad_to_bucket, req.frame, req.bucket
                )
                return
            except WorkerFailure:
                self._note_stager_death()

    def _shed_or_degrade(self) -> None:
        """Police every queue: expired or *hopeless* entries leave it —
        but with the ladder on, a hopeless (not yet expired) request is
        walked DOWN the degradation ladder before the shed rung fires:

          1. downshift into a smaller bucket where its deadline is
             feasible (policy + ``LoadController.downshift_target``),
          2. else answer from the session tracker's coast prediction,
          3. else shed with the explicit ``DEADLINE_EXCEEDED`` the
             admission contract promises.

        Hopeless means: cannot finish in time even if everything goes
        well — running it anyway is the EDF overload pathology (doomed
        work dominoes feasible work into lateness).  An already *expired*
        entry goes straight to the shed rung: any answer, degraded or
        not, would land after the deadline it exists to meet.

        Feasibility is *queue-depth-aware*: a request at EDF position k in
        its bucket queues behind ``active`` slotted requests and the k
        tighter-deadline entries kept ahead of it, all of which dispatch
        first, ``batch_size`` per wave — so its completion horizon is
        ``now + waves * est_s`` with ``waves = ahead // batch_size + 1``,
        not the single-dispatch optimism of one ``est_s``.  A deep queue
        therefore sheds a mid-pack budget that a shallow queue would
        keep; for the shallow
        case (``ahead < batch_size``) the horizon reduces to exactly the
        old one-dispatch rule.  Entries that shed OR degrade out of the
        queue do not count toward ``ahead`` — leaving frees their wave
        for the survivors.

        The hopeless test only engages once the grid's estimate is
        *measured* (a real dispatch fed the EMA): acting on an
        unvalidated prior could latch into degrading/refusing an entirely
        feasible workload forever, since the estimate only corrects on
        completions.  Pop order is the admission order — priority class
        first, EDF within a class — so ``ahead`` counts exactly what
        really dispatches first, including no-deadline entries of a
        higher class; no-deadline entries themselves (``inf`` keys) are
        never shed.

        Buckets are policed largest-first: a request downshifted out of a
        large bucket lands in a smaller queue that is policed later in
        the SAME pass, so a downshift that turns out hopeless at the
        target too (the target saturated this step) still coasts or
        sheds this step — it cannot hide for a step in a doomed queue.
        """
        now = self.clock()
        for shape in reversed(self.buckets):
            q = self.queues[shape]
            if not q:
                continue
            grid = self.grids[shape]
            est = grid.est_s if grid.est_measured else 0.0
            worst_waves = (grid.active + len(q) - 1) // len(grid.slots) + 1
            tightest = min(e[1] for e in q)
            if tightest > now + worst_waves * est:
                continue
            keep = []
            ahead = grid.active          # slotted work dispatches first
            for entry in sorted(q):      # pop order: (prio, key, seq)
                _, key, _, req = entry
                waves = ahead // len(grid.slots) + 1
                doomed = (key <= now
                          or (est > 0.0 and key < now + waves * est))
                if not doomed:
                    keep.append(entry)
                    ahead += 1
                    continue
                expired = key <= now
                if not expired and self._try_downshift(req, now):
                    continue
                if not expired and self._try_coast(req, now):
                    continue
                self._refuse(req, RequestStatus.DEADLINE_EXCEEDED, now)
                self.shed_deadline += 1
            q[:] = keep
            heapq.heapify(q)

    # --- the ladder rungs -----------------------------------------------
    def _downshift_into(self, req: DetectionRequest,
                        target: tuple[int, int]) -> bool:
        """Re-stage ``req`` for the smaller ``target`` bucket (shared by
        the queue-police rung and the admission-time pre-downshift; the
        caller enqueues).  The frame mean-pools by 2x per halving
        (host-side, ``core.plan.downshift_frame``) and the result scales
        back to native coordinates at completion (``upscale_result``).
        Staging is synchronous, now: the downshift exists to make an
        imminent deadline, so the pooled pad must be slot-ready the
        moment the target grid admits (host work, same cost class as the
        synchronous staging path)."""
        img, factor = downshift_frame(req.frame, target)
        if factor <= req.downshift:
            return False   # no actual resolution drop: nothing gained
        req._staged = pad_to_bucket(img, target)
        req._ds_shape = img.shape
        req.downshift = factor
        req.bucket = target
        self.downshifted += 1
        return True

    def _try_downshift(self, req: DetectionRequest, now: float) -> bool:
        """Rung 1: re-stage ``req`` into a smaller bucket where its
        deadline is feasible — a lower-fidelity answer in time beats a
        perfect answer late."""
        if not self.ladder or not req.policy.allow_downshift:
            return False
        target = self.load_controller.downshift_target(req, now)
        if target is None:
            return False
        if not self._downshift_into(req, target):
            return False
        self._seq += 1
        key = req.deadline_at if req.deadline_at is not None else math.inf
        heapq.heappush(
            self.queues[target], (req.priority, key, self._seq, req)
        )
        return True

    def _try_coast(self, req: DetectionRequest, now: float) -> bool:
        """Rung 2: answer a session request from its tracker's k-step
        coast prediction — ZERO detection dispatches, the near-free local
        answer that always meets the deadline.  Eligibility and budget
        are the tracker's own coast rules (``LaneTracker.predict_tracks``
        with ``steps`` = consecutive coasts served + 1): a session that
        coasted its way past ``max_misses`` gets no further coasts until
        a real frame completes and re-grounds the tracker, exactly like a
        camera blackout of the same length."""
        if not self.ladder or not req.policy.allow_coast:
            return False
        if req.session_id is None:
            return False
        tracker = self.sessions.get(req.session_id)
        if tracker is None:
            return False
        steps = self._session_coasts.get(req.session_id, 0) + 1
        tracks = tracker.predict_tracks(steps)
        if not tracks:
            return False
        req.tracks = tracks
        req.status = RequestStatus.DEGRADED_COAST
        req.finished_at = now
        req._staged = None
        ctl = self._controller(req)
        if ctl is not None:
            # a coast answer still steers: the command comes from the
            # tracker's predicted lanes, exactly like a served frame
            req.steering = ctl.command(*tracks_as_peaks(tracks))
        self._session_coasts[req.session_id] = steps
        self.served_coast += 1
        self._slo(req.session_id).served_coast += 1
        return True

    def _resolve_staged(self, req: DetectionRequest,
                        shape: tuple[int, int]) -> np.ndarray:
        """Produce the slot-ready padded frame for ``req``.

        Downshifted requests carry their pooled pad as a plain array
        (staged synchronously by the ladder).  Prefetched requests carry
        a ``Future``; if the worker died mid-task the ``WorkerFailure``
        surfaces here — the service notes the death (restart budget) and
        falls back to staging synchronously, so an injected stager death
        degrades prefetch, never correctness.  A worker that leaves the
        future unresolved past ``STAGE_TIMEOUT_S`` is declared dead the
        same way (a hang is a death, never a blocked scheduler)."""
        staged = req._staged
        req._staged = None
        if isinstance(staged, np.ndarray):
            return staged
        if staged is not None:            # a prefetch Future
            try:
                return staged.result(timeout=STAGE_TIMEOUT_S)
            except FutureTimeout:
                if self._loader is not None:
                    self._loader.abandon()
                self._note_stager_death()
            except WorkerFailure:
                self._note_stager_death()
        return pad_to_bucket(req.frame, shape)

    def _admit(self) -> None:
        """Fill free slots in strict priority classes within each bucket,
        earliest-deadline-first within a class (no-deadline requests
        order FIFO after their class's deadlined ones).  Staged frames
        come from the prefetch worker when enabled — admission only copies
        the finished pad into the slot buffer.

        Admission is also the frame-validity gate: a non-finite pad (NaN
        Inf — sensor corruption, injected or real) must never reach the
        device, where it would poison the whole batch's reduction math.
        A corrupt session frame falls to the coast rung (the tracker's
        prediction is exactly the right answer to one bad capture);
        otherwise the request refuses with ``INVALID_FRAME``.  Either
        way the slot stays free for the next queue entry."""
        for shape in self.buckets:
            grid = self.grids[shape]
            q = self.queues[shape]
            while q:
                slot = grid.free_slot()
                if slot is None:
                    break
                _, _, _, req = heapq.heappop(q)
                # resolve staging BEFORE taking the slot: if the prefetch
                # worker raised, the exception surfaces here with the
                # request un-slotted (still PENDING) — never a DONE result
                # silently computed from the slot's zeroed frame
                staged = self._resolve_staged(req, grid.shape)
                if self.validate_frames and not np.isfinite(staged).all():
                    if not self._try_coast(req, self.clock()):
                        self._refuse(req, RequestStatus.INVALID_FRAME,
                                     self.clock())
                        self.rejected_invalid += 1
                    continue
                grid.slots[slot] = req
                grid.staged[slot] = staged

    def _reap(self) -> None:
        """Retire any in-flight batch whose result is already ready.

        Keeps ``latency_s`` honest (a result is delivered as soon as the
        device finishes, not when its grid next refills) without ever
        blocking — ``event.query()`` is a non-blocking poll; on the CPU
        (no event) a result is ready once ``run`` returned.
        """
        for g in self.grids.values():
            f = g.in_flight
            if f is None:
                continue
            if f.event is None or f.event.query():
                # the device finished some unknown time ago (we only just
                # polled), so dispatch->now includes idle gap, not service
                # time — deliver the results but keep it out of the EMA
                self._complete(g, update_est=False)

    def drain(self) -> None:
        """Block until every in-flight batch has completed and resolved
        back onto its requests (deterministic completion stamping for
        virtual-clock callers — no ``event.query()`` poll races).

        Like ``_reap``, drain's timing samples are idle-contaminated upper
        bounds, so they can lower the service-time estimate but never
        raise it: one long idle gap must not push the estimate past every
        offered deadline (hopeless-shed livelock).  Only back-to-back
        dispatches — the previous batch still in flight when the next one
        landed — can raise it."""
        for g in self.grids.values():
            self._complete(g, update_est=False)

    def _complete(self, grid: _BucketGrid, *, update_est: bool = True
                  ) -> None:
        """Resolve the grid's in-flight batch back onto its requests.

        The dispatch->completion sample ``dt`` feeds the grid's EMA
        service-time estimate (which drives early close + hopeless shed)
        under an asymmetric rule.  ``update_est=True`` — the dispatch-
        completes-previous path in ``step``, where the previous batch was
        still occupying the device — may move the estimate either way.
        ``update_est=False`` — ``_reap`` and ``drain``, whose samples
        include however long the batch sat finished before anyone asked —
        may only ratchet it *down or hold it* (an idle-contaminated sample
        is an upper bound on the true service time, so a sample at or
        below the estimate is still evidence, while a sample above it must
        never inflate the estimate into shedding feasible work).
        Cold dispatches are excluded entirely: a first use builds kernels
        and library handles in seconds, and a seconds-scale estimate would
        shed every sub-second budget.

        The batch's ``peaks`` and ``valid`` come to the host once, after
        the dispatch's event, for the trackers and the controllers."""
        f = grid.in_flight
        if f is None:
            return
        grid.in_flight = None
        reqs, res, t_disp = f.reqs, f.result, f.t_dispatch
        was_warm, stall_s = f.warm, f.stall_s
        if f.event is not None:
            f.event.synchronize()
        peaks_h = res.peaks.cpu().numpy()
        valid_h = res.valid.cpu().numpy()
        if stall_s > 0.0 and hasattr(self.clock, "advance"):
            # an injected dispatch stall: the device "took" stall_s extra
            # seconds — model it on the virtual clock so the batch lands
            # late, but keep the sample out of the EMA (a one-off stall is
            # not evidence about steady-state service time)
            self.clock.advance(stall_s)
            was_warm = False
        now = self.clock()
        dt = now - t_disp
        if was_warm and dt > 0.0 and (update_est or dt <= grid.est_s):
            a = self.est_smoothing
            grid.est_s = (1.0 - a) * grid.est_s + a * dt
            grid.est_measured = True
        for i, req in enumerate(reqs):
            if req is None:
                continue
            assert not req.is_terminal, f"request {req.uid} answered twice"
            H, W = req.frame.shape[:2]
            want = req.render_output or self.cfg.render_output
            rendered = (
                res.rendered[i]
                if want and res.rendered is not None else None
            )
            per = DetectionResult(
                res.lines[i], res.valid[i], res.peaks[i], res.edges[i],
                rendered,
            )
            if req.downshift > 1:
                # the batch ran at the downshifted bucket: crop to the
                # pooled content shape, then map back to native coords
                dh, dw = req._ds_shape
                req.result = upscale_result(
                    crop_result(per, dh, dw), req.downshift, H, W,
                )
                req.status = RequestStatus.DEGRADED_DOWNSHIFT
                self.served_downshift += 1
            else:
                req.result = crop_result(per, H, W)
                req.status = RequestStatus.DONE
            if req.session_id is not None:
                tracker = self.sessions.get(req.session_id)
                if tracker is None:
                    tracker = LaneTracker(self.tracker_cfg)
                    self.sessions[req.session_id] = tracker
                # slot order == admission order, and one batch is in
                # flight per grid, so a session's frames advance its
                # tracker in stream order (see DetectionRequest docstring).
                # scale= widens the rho association gate for downshifted
                # frames: the upscaled coarse detections must re-ground
                # the existing tracks, not birth quantized twins —
                # tracker state persists across resolution downshifts
                if req.downshift > 1:
                    peaks_i, valid_i = req.result.peaks, req.result.valid
                else:
                    peaks_i, valid_i = peaks_h[i], valid_h[i]
                req.tracks = tracker.step(peaks_i, valid_i,
                                          scale=req.downshift)
                ctl = self._controller(req)
                if ctl is not None:
                    # steer from the smoothed tracks when the tracker
                    # reports any, from the frame's raw detections
                    # otherwise (session warmup) — the same fallback as
                    # TrackedFrame.control_peaks
                    if req.tracks:
                        req.steering = ctl.command(
                            *tracks_as_peaks(req.tracks)
                        )
                    else:
                        req.steering = ctl.command(peaks_i, valid_i)
                # a real frame re-grounds the tracker: the coast budget
                # resets (see _try_coast)
                self._session_coasts.pop(req.session_id, None)
                slo = self._slo(req.session_id)
                if req.downshift > 1:
                    slo.served_downshift += 1
                else:
                    slo.served_full += 1
            req.finished_at = now
            if req.deadline_at is not None and now > req.deadline_at:
                self.completed_late += 1
                if req.session_id is not None:
                    self._slo(req.session_id).late += 1
            self.completed += 1

    # --- union theta gate -----------------------------------------------
    def _union_gate(self, grid: _BucketGrid) -> Optional[np.ndarray]:
        """Union theta-band gate for one dispatched grid, or None (full
        sweep).

        The single-session ``TrackingPipeline`` realizes the 1.59x
        prediction-gated speedup; batching frames whose gates differ
        needs the *union* of the member sessions' bands.  Gating engages
        only when EVERY occupied slot is covered — each request belongs
        to a session whose tracker is healthy (``gate_bins`` non-None:
        confirmed tracks, none coasting, no open rescan window) — and
        the union fits the static ``gate_band`` budget; otherwise the
        grid full-sweeps, so gating is never a correctness dependence
        (same fallback contract as the pipeline path).  At full
        coverage the gated result is bit-exact with the full sweep
        (tested): theta is scale-invariant, so downshifted members gate
        identically.
        """
        if self.gate_band is None:
            return None
        n_theta = self.cfg.hough.n_theta
        bins: set[int] = set()
        for req in grid.slots:
            if req is None:
                continue
            if req.session_id is None:
                return None
            tracker = self.sessions.get(req.session_id)
            if tracker is None:
                return None
            b = tracker.gate_bins(n_theta)
            if b is None:
                return None
            bins.update(int(x) for x in b)
        if not bins or len(bins) > self.gate_band:
            return None           # empty grid or band-budget overflow
        out = sorted(bins)
        out += [out[0]] * (self.gate_band - len(out))
        return np.asarray(out, np.int32)

    # --- union rho corridors (fused hot path) ---------------------------
    def _union_corridors(self, grid: _BucketGrid) -> Optional[np.ndarray]:
        """Union rho-corridor set for one dispatched grid, or None (stay
        on the staged path).

        The corridor twin of :meth:`_union_gate`, with one extra
        admission rule: corridors are rho windows in *native* pixel
        coordinates, so every occupied slot must be serving at native
        resolution (``req.downshift == 1``) — a downshifted member's rho
        scale differs and its session's windows would filter the wrong
        pixels.  Beyond that, same contract: every slot needs a session
        whose tracker yields healthy (unpadded) corridors, the union must
        fit the static ``fused_corridors`` budget, and any failure means
        the grid runs the staged (gated or full-sweep) path — the fused
        dispatch is a perf hook, never a correctness dependence.
        """
        if self.fused_corridors is None:
            return None
        rows: list[np.ndarray] = []
        for req in grid.slots:
            if req is None:
                continue
            if req.session_id is None or req.downshift != 1:
                return None
            tracker = self.sessions.get(req.session_id)
            if tracker is None:
                return None
            c = tracker.corridors()
            if c is None:
                return None
            rows.append(c)
        if not rows:
            return None
        out = np.concatenate(rows, axis=0)
        if out.shape[0] > self.fused_corridors:
            return None           # corridor-budget overflow
        pad = np.tile(out[:1], (self.fused_corridors - out.shape[0], 1))
        return np.concatenate([out, pad], axis=0).astype(np.float32)

    # --- scheduling -----------------------------------------------------
    def _deadline_mode(self) -> bool:
        """QoS scheduling engages iff any *admitted* request carries a
        deadline; otherwise the service is exactly the plain throughput
        scheduler (full-grid-first round-robin)."""
        return any(
            r is not None and r.deadline_at is not None
            for g in self.grids.values() for r in g.slots
        )

    def _next_grid_throughput(self, flush: bool) -> Optional[_BucketGrid]:
        """Round-robin over buckets: FULL grids first (a dispatch always
        computes ``batch_size`` frames, so partial grids waste slots), then
        — only when flushing — any occupied grid."""
        n = len(self.buckets)
        for want_full in (True, False) if flush else (True,):
            for k in range(n):
                shape = self.buckets[(self._rr + k) % n]
                grid = self.grids[shape]
                if grid.active == len(grid.slots) or (
                    not want_full and grid.active
                ):
                    self._rr = (self._rr + k + 1) % n
                    return grid
        return None

    def _next_grid_deadline(self, flush: bool, now: float
                            ) -> Optional[_BucketGrid]:
        """Priority-major, earliest-deadline-first over occupied grids.

        Grids rank by the highest priority class aboard, then tightest
        deadline (uniform-priority traffic is therefore pure EDF over
        grids, the pre-tier behavior bit-exact).  When total queued work
        exceeds the slack — someone must be late — this is what makes
        the lateness land on the lowest class instead of whichever
        bucket sorted first.  A grid dispatches when it is full, when it
        must close early (``tightest deadline - now <= est_s``: one more
        wait would bust it), or when flushing.  A lower-ranked grid may
        only jump ahead of the first waiting one if its own dispatch
        fits inside that grid's slack — EDF with admission control, not
        strict EDF, so throughput traffic still flows around a slack
        deadline."""
        order = sorted(
            (g for g in self.grids.values() if g.active),
            key=lambda g: (
                min(r.priority for r in g.slots if r is not None),
                g.tightest_deadline(),
                self.buckets.index(g.shape),
            ),
        )
        guard: Optional[tuple[float, float]] = None  # (deadline, est) held
        for g in order:
            d = g.tightest_deadline()
            full = g.active == len(g.slots)
            urgent = math.isfinite(d) and (d - now) <= g.est_s
            if full or urgent or flush:
                if guard is not None:
                    gd, gest = guard
                    if gd - now - g.est_s < gest:
                        continue   # would bust the tighter waiting grid
                return g
            if guard is None and math.isfinite(d):
                guard = (d, g.est_s)
        return None

    def step(self, *, flush: bool = False) -> bool:
        """Shed/degrade -> admit (EDF) -> dispatch one bucket grid ->
        free its slots for the next admission wave; completion of the
        *previous* dispatch on that grid happens just before the new one
        lands (one batch in flight per bucket).  Without deadlines only
        full grids dispatch unless ``flush``; with deadlines the tightest
        grid may close early.  Returns True if any work remains."""
        k_step = self._steps
        self._steps += 1
        if self.faults is not None and hasattr(self.clock, "advance"):
            jump = self.faults.clock_jump_for_step(k_step)
            if jump > 0.0:
                # an injected clock jump: time lurches forward before the
                # scheduler looks at anything — every queued deadline the
                # jump crossed expires in this one step's shed pass
                self.clock.advance(jump)
        self._reap()
        self._shed_or_degrade()
        self._admit()
        if self._deadline_mode():
            grid = self._next_grid_deadline(flush, self.clock())
        else:
            grid = self._next_grid_throughput(flush)
        if grid is None:
            # nothing dispatchable: drain whatever is still in flight
            self.drain()
            return bool(self.queued) or any(
                g.active for g in self.grids.values()
            )
        want_render = any(
            r is not None and r.render_output for r in grid.slots
        )
        plan = grid.plan.with_render(True) if want_render else grid.plan
        theta_bins = self._union_gate(grid)
        corridors = None
        if theta_bins is not None:
            plan = plan.with_theta_band(self.gate_band)
            # fused only under an engaged theta gate: both gates read the
            # same tracker health, so a corridor-eligible grid is already
            # gated — the fused plan is the gated plan's twin
            corridors = self._union_corridors(grid)
            if corridors is not None:
                plan = plan.with_fused(self.fused_corridors)
        reqs = list(grid.slots)
        if self.faults is not None and self.faults.fails_dispatch(
                self.dispatches):
            # injected dispatch failure: the batch never reaches the
            # device.  Retire the grid's previous batch first (its result
            # is real), then fail THIS batch's requests explicitly —
            # FAILED, never a hang, never a silent retry-with-zeros.  The
            # failed dispatch gets no log entry and does not advance the
            # dispatch counter: it never happened, device-wise.
            self._complete(grid)
            now = self.clock()
            for req in reqs:
                if req is not None:
                    self._refuse(req, RequestStatus.FAILED, now)
            self.dispatch_faults += 1
            grid.slots = [None] * self.batch_size
            grid.staged = np.zeros_like(grid.staged)
            return True
        # one pinned, non-blocking copy each: the batch, and the gate and
        # corridors it shares (plan.run's as_tensor is then a no-op, not
        # a pageable copy that would sync)
        imgs = self.plans.put(grid.staged)
        bins_d = (None if theta_bins is None
                  else self.plans.put(theta_bins))
        cors_d = (None if corridors is None
                  else self.plans.put(corridors))
        warm_key = (grid.shape, plan.cfg.render_output,
                    plan.cfg.hough.theta_band, plan.cfg.fused)
        was_warm = warm_key in self._warmed
        if was_warm:
            with _no_host_sync(self.device):
                # async dispatch, batch k
                res = plan.run(imgs, bins_d, cors_d)
        else:
            # a first use builds kernels and handles in seconds: retire the
            # previous batch BEFORE it, so the blocking-path EMA sample
            # below cannot absorb the build (there is no overlap to
            # preserve), and est_s cannot inflate into shedding feasible
            # traffic
            self._complete(grid)
            res = plan.run(imgs, bins_d, cors_d)
            self._warmed.add(warm_key)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        if theta_bins is not None:
            self.gated_dispatches += 1
        if corridors is not None:
            self.fused_dispatches += 1
        # on the CPU the shipped tensor aliases the numpy buffer, and on
        # the card the copy is in flight: hand the old buffer to the
        # in-flight batch and stage the next wave into a fresh one rather
        # than mutating shared memory.  Only
        # AFTER a successful dispatch — if plan.run raised, the slots still
        # hold their requests and a retry must re-ship the real frames,
        # not a zeroed buffer.
        grid.staged = np.zeros_like(grid.staged)
        # batch k-1 retires while k computes; if the dispatch above raised,
        # it is still in_flight and a later step/run() drains it
        self._complete(grid)
        stall = (self.faults.stall_for_dispatch(self.dispatches)
                 if self.faults is not None else 0.0)
        grid.in_flight = _InFlight(reqs, res, self.clock(), was_warm, stall,
                                   event, plan, imgs, bins_d, cors_d)
        self.dispatches += 1
        self.dispatch_log.append((grid.shape, grid.active, want_render))
        grid.slots = [None] * self.batch_size   # slots free immediately
        return True

    def run(self, max_steps: int = 10_000) -> None:
        """Drive until the queues, slots, and in-flight batches drain
        (flushing: partial grids dispatch rather than wait for traffic)."""
        while max_steps > 0:
            busy = self.step(flush=True)
            pending = any(
                g.active or g.in_flight is not None
                for g in self.grids.values()
            )
            if not busy and not pending and not self.queued:
                return
            max_steps -= 1

    # --- convenience ----------------------------------------------------
    def detect_many(self, frames: Iterable[np.ndarray]
                    ) -> list[DetectionRequest]:
        """Submit one request per frame, drain, return in submit order."""
        reqs = [DetectionRequest(uid=i, frame=np.asarray(f))
                for i, f in enumerate(frames)]
        for r in reqs:
            self.submit(r)
        self.run()
        assert all(r.done for r in reqs)
        return reqs
