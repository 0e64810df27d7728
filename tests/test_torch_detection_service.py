"""The port's ``DetectionService`` against ``repro.serve.detection`` on the
same traffic, both on a ``VirtualClock``, the port with ``device="cpu"``.

Every traffic loop drains the service after each step before the clock
moves, so completion stamps are the same whether a batch was retired by
the reap or by the next dispatch (the port's CPU results are ready at once, the
reference's XLA dispatch may not be); nothing here reads the reap's
timing.  Compared after each drive: every request's status, bucket,
downshift, stamps, result (peaks, validity and edges bit for bit; lines
within 1e-3, the ulps of ``cos`` / ``sin``), session tracks and steering
command; the dispatch log, every counter and the per-session SLOs.  The
traffic covers the fixed interleavings of the reference's deadline tests,
sessions with the union gate and the fused corridors, each rung of the
degradation ladder and the fault matrix, with prefetch on and off; small
buckets (96x128, 120x160), batches of 2.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import HoughConfig as JHough  # noqa: E402
from repro.core import PipelineConfig as JPipeline  # noqa: E402
from repro.core.control import ControlConfig as JControl  # noqa: E402
from repro.core.plan import DetectionResult as JResult  # noqa: E402
from repro.data import make_drive_cycle, make_scenario  # noqa: E402
from repro.runtime import ServiceFaultInjector as JFaults  # noqa: E402
from repro.serve import detection as jdet  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ControlConfig, HoughConfig, PipelineConfig,
)
from repro_torch.core.plan import DetectionResult  # noqa: E402
from repro_torch.runtime import ServiceFaultInjector  # noqa: E402
from repro_torch.serve import detection as tdet  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BUCKETS = ((96, 128), (120, 160))
TIMEOUT = 10.0
COUNTERS = (
    "dispatches", "completed", "rejected_queue_full", "shed_deadline",
    "completed_late", "downshifted", "pre_downshifted", "served_downshift",
    "served_coast", "gated_dispatches", "fused_dispatches", "evicted",
    "rejected_invalid", "dispatch_faults", "stager_deaths",
)
# each package's classes, by the role they play in a drive
REF = dict(mod=jdet, cfg=JPipeline(hough=JHough(compact=True,
                                                max_edges="auto")),
           control=JControl, faults=JFaults, device={})
PORT = dict(mod=tdet, cfg=PipelineConfig(hough=HoughConfig(
    compact=True, max_edges="auto")), control=ControlConfig,
            faults=ServiceFaultInjector, device={"device": "cpu"})


def _frame(h, w, seed=0, family="straight"):
    return make_scenario(family, h, w, seed=seed).image


def _rgb(img):
    return np.repeat(img[..., None], 3, axis=2)


def _make(pkg, clock, *, steering=False, faults=None, **kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("batch_size", 2)
    kw.setdefault("prefetch", False)
    return pkg["mod"].DetectionService(
        pkg["cfg"], clock=clock,
        steering=pkg["control"]() if steering else None,
        faults=None if faults is None else pkg["faults"](**faults),
        **pkg["device"], **kw)


def _pump(svc, max_steps=200):
    """``run()`` with a drain after every step (deterministic stamps)."""
    for _ in range(max_steps):
        busy = svc.step(flush=True)
        svc.drain()
        if not (busy or svc.queued
                or any(g.active for g in svc.grids.values())):
            return
    raise AssertionError("service did not drain")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tracks(tracks):
    return None if tracks is None else [dataclasses.astuple(t)
                                        for t in tracks]


def _assert_same(ref, port):
    """Both drives (service, requests) ended the same way."""
    (jsvc, jreqs), (tsvc, treqs) = ref, port
    assert len(jreqs) == len(treqs)
    for a, b in zip(jreqs, treqs):
        assert b.status.value == a.status.value, (a.uid, a.status, b.status)
        assert (b.bucket, b.downshift, b.submitted_at, b.finished_at,
                b.deadline_at) == (a.bucket, a.downshift, a.submitted_at,
                                   a.finished_at, a.deadline_at), a.uid
        assert (b.result is None) == (a.result is None), a.uid
        if a.result is not None:
            for f in ("peaks", "valid", "edges"):
                np.testing.assert_array_equal(
                    _np(getattr(b.result, f)), _np(getattr(a.result, f)),
                    err_msg=f"uid {a.uid} {f}")
            np.testing.assert_allclose(_np(b.result.lines),
                                       _np(a.result.lines), rtol=0,
                                       atol=1e-3)
            assert (b.result.rendered is None) == (a.result.rendered is None)
            if a.result.rendered is not None:
                np.testing.assert_array_equal(_np(b.result.rendered),
                                              _np(a.result.rendered))
        assert _tracks(b.tracks) == _tracks(a.tracks), a.uid
        assert (None if b.steering is None else tuple(b.steering)) == \
            (None if a.steering is None else tuple(a.steering)), a.uid
    assert list(tsvc.dispatch_log) == list(jsvc.dispatch_log)
    assert ({k: getattr(tsvc, k) for k in COUNTERS}
            == {k: getattr(jsvc, k) for k in COUNTERS})
    assert ({s: dataclasses.astuple(v) for s, v in tsvc.slo.items()}
            == {s: dataclasses.astuple(v) for s, v in jsvc.slo.items()})
    for sid in jsvc.sessions:
        assert (_tracks(tsvc.session_tracks(sid))
                == _tracks(jsvc.session_tracks(sid)))
    assert tsvc.queued == jsvc.queued == 0


def _both(drive, **kw):
    """Run ``drive(pkg, clock) -> (service, requests)`` on both packages."""
    out = []
    for pkg in (REF, PORT):
        svc, reqs = drive(pkg, pkg["mod"].VirtualClock(), **kw)
        svc.close()
        assert all(r.is_terminal for r in reqs)
        out.append((svc, reqs))
    return out


# --- the device rule and the helpers -----------------------------------------


def test_service_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        svc = tdet.DetectionService(buckets=BUCKETS)
        assert svc.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdet.DetectionService(buckets=BUCKETS)
    svc = tdet.DetectionService(buckets=BUCKETS, device="cpu")
    assert svc.device.type == "cpu" and svc.plans.device.type == "cpu"
    svc.close()


@pytest.mark.parametrize("shape,bucket", [
    ((96, 128), (96, 128)), ((80, 100), (96, 128)), ((41, 57), (120, 160)),
    ((120, 100), (120, 160)), ((70, 160), (120, 160)),
])
def test_pad_and_crop_match_reference(shape, bucket):
    """The tapered pad (grey and RGB), and the crop of a result back."""
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 255, shape).astype(np.float32)
    for frame in (img, _rgb(img).astype(np.uint8)):
        np.testing.assert_array_equal(tdet.pad_to_bucket(frame, bucket),
                                      jdet.pad_to_bucket(frame, bucket))
    k = 5
    lines = rng.normal(0, 50, (k, 4)).astype(np.float32)
    valid = rng.uniform(size=k) < 0.5
    peaks = rng.normal(0, 50, (k, 2)).astype(np.float32)
    edges = (rng.uniform(size=bucket) < 0.1).astype(np.uint8) * 255
    rendered = rng.integers(0, 255, (*bucket, 3)).astype(np.uint8)
    got = tdet.crop_result(DetectionResult(*map(torch.from_numpy, (
        lines, valid, peaks, edges, rendered))), *shape)
    want = jdet.crop_result(JResult(lines, valid, peaks, edges, rendered),
                            *shape)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("factor", [2, 4])
def test_upscale_result_matches_reference(factor):
    """Downshifted results back to native coordinates: peaks and rasters
    equal, endpoints within the ulps of cos / sin; from host arrays and
    from tensors alike."""
    rng = np.random.default_rng(factor)
    k, (h, w) = 6, (96 // factor, 128 // factor)
    lines = rng.normal(0, 30, (k, 4)).astype(np.float32)
    valid = rng.uniform(size=k) < 0.5
    peaks = np.column_stack([rng.normal(0, 30, k), rng.uniform(0, math.pi, k)]
                            ).astype(np.float32)
    edges = (rng.uniform(size=(h, w)) < 0.2).astype(np.uint8) * 255
    rendered = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    want = jdet.upscale_result(JResult(lines, valid, peaks, edges, rendered),
                               factor, 95, 127)
    for fields in ((lines, valid, peaks, edges, rendered),
                   tuple(map(torch.from_numpy, (lines, valid, peaks, edges,
                                                rendered)))):
        got = tdet.upscale_result(DetectionResult(*fields), factor, 95, 127)
        for name in ("valid", "peaks", "edges", "rendered"):
            assert isinstance(getattr(got, name), np.ndarray)
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)))
        np.testing.assert_allclose(got.lines, want.lines, rtol=0, atol=1e-3)


def test_status_classes_and_clock_match_reference():
    for s in tdet.RequestStatus:
        j = jdet.RequestStatus(s.value)
        assert (s.terminal, s.served, s.degraded, s.refused) == \
            (j.terminal, j.served, j.degraded, j.refused)
    assert [s.value for s in tdet.RequestStatus] == \
        [s.value for s in jdet.RequestStatus]
    clock = tdet.VirtualClock(1.0)
    assert clock.advance(0.5) == 1.5 and clock.jump_to(2.0) == 2.0
    with pytest.raises(ValueError):
        clock.jump_to(1.0)
    with pytest.raises(AssertionError):
        clock.advance(-0.1)
    slo = tdet.SessionSLO(submitted=5, served_full=2, served_coast=1,
                          refused=1, late=1)
    jslo = jdet.SessionSLO(**dataclasses.asdict(slo))
    assert (slo.served, slo.degraded_rate, slo.miss_rate) == \
        (jslo.served, jslo.degraded_rate, jslo.miss_rate)
    assert tdet.DEFAULT_BUCKETS == jdet.DEFAULT_BUCKETS
    assert dataclasses.asdict(tdet.SHED_ONLY) == \
        dataclasses.asdict(jdet.SHED_ONLY)


# --- traffic: the reference's fixed interleavings ----------------------------

_SHAPES = ((80, 100), (96, 128), (100, 144), (120, 160))
_DEADLINES = (None, 0.02, 0.08, 10.0)
_FIXED_INTERLEAVINGS = [
    # same-bucket burst, mixed deadlines, shed via the 40ms advance
    [(1, 3, 0, False), (1, 1, 5, True), (0, 0, 0, False), (1, 2, 10, True),
     (1, 1, 40, False)],
    # cross-bucket with backpressure (max_queue=3) and a late drain
    [(3, 1, 0, False), (0, 1, 0, False), (2, 3, 0, False), (1, 0, 0, False),
     (0, 0, 50, True), (3, 3, 5, True)],
    # steady drip, no deadlines: pure throughput mode under the loop
    [(2, 0, 0, True), (2, 0, 1, True), (2, 0, 1, True), (2, 0, 1, False)],
]


def _interleaving(pkg, clock, ops, seed, prefetch):
    rng = np.random.default_rng(seed)
    frames = [rng.uniform(0.0, 255.0, _SHAPES[si]).astype(np.float32)
              for si, _, _, _ in ops]
    svc = _make(pkg, clock, prefetch=prefetch, est_dispatch_s=0.01,
                max_queue=3)
    reqs = []
    for i, (si, di, adv_ms, step_after) in enumerate(ops):
        clock.advance(adv_ms / 1000.0)
        r = pkg["mod"].DetectionRequest(uid=i, frame=frames[i],
                                        deadline_s=_DEADLINES[di])
        svc.submit(r)
        reqs.append(r)
        if step_after:
            svc.step()
            svc.drain()
    _pump(svc)
    return svc, reqs


@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
@pytest.mark.parametrize("case", range(len(_FIXED_INTERLEAVINGS)))
def test_fixed_interleavings_match_reference(case, prefetch):
    _assert_same(*_both(_interleaving, ops=_FIXED_INTERLEAVINGS[case],
                        seed=case, prefetch=prefetch))


# --- traffic: sessions, the union gate, the fused corridors, steering --------


_CYCLES = {sid: make_drive_cycle("converging", 10, 96, 128, seed=s).images()
           for sid, s in (("cam0", 0), ("cam1", 1))}


def _sessions(pkg, clock, fused, prefetch):
    """Two interleaved camera sessions (one RGB, so staging works) and
    one-off frames in the other bucket, with a rendered request."""
    svc = _make(pkg, clock, steering=True, prefetch=prefetch,
                gate_band=40, fused_corridors=8 if fused else None)
    reqs = []

    def submit(frame, **kw):
        reqs.append(pkg["mod"].DetectionRequest(uid=len(reqs), frame=frame,
                                                deadline_s=0.3, **kw))
        svc.submit(reqs[-1])

    for t in range(10):
        for sid, cyc in _CYCLES.items():
            submit(_rgb(cyc[t]) if sid == "cam1" else cyc[t], session_id=sid)
        if t % 3 == 0:
            submit(_frame(110, 150, seed=t), render_output=t == 3)
        svc.step()
        clock.advance(1 / 30)
        svc.drain()
    _pump(svc)
    return svc, reqs


@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
@pytest.mark.parametrize("fused", [False, True], ids=["gated", "fused"])
def test_sessions_gate_and_steering_match_reference(fused, prefetch):
    ref, port = _both(_sessions, fused=fused, prefetch=prefetch)
    _assert_same(ref, port)
    svc = port[0]
    assert svc.gated_dispatches > 0
    assert (svc.fused_dispatches > 0) == fused
    assert all(r.steering is not None for r in port[1] if r.session_id)


# --- traffic: the degradation ladder -----------------------------------------


def _ground(svc, pkg, clock, shape, dt, uid0):
    """Warm dispatches at ``dt`` apart, each drained after the clock moved:
    the EMA is measured the same way in both packages."""
    for u in range(3):
        svc.submit(pkg["mod"].DetectionRequest(uid=uid0 + u,
                                               frame=_frame(*shape, seed=u)))
        svc.step(flush=True)
        clock.advance(dt)
        svc.drain()


def _downshift(pkg, clock, prefetch):
    """Rung 1: hopeless at 120x160, feasible at 96x128 (at admission and
    in the queue police), with the policy's floor and SHED_ONLY refusing
    it."""
    mod = pkg["mod"]
    svc = _make(pkg, clock, prefetch=prefetch,
                est_dispatch_s=1.0)
    _ground(svc, pkg, clock, (120, 160), 0.2, uid0=900)
    reqs = [mod.DetectionRequest(uid=0, frame=_frame(120, 160),
                                 deadline_s=0.05),
            mod.DetectionRequest(uid=1, frame=_rgb(_frame(120, 160, 1)),
                                 deadline_s=0.05),
            mod.DetectionRequest(uid=2, frame=_frame(120, 160, 2),
                                 deadline_s=0.05, policy=mod.SHED_ONLY),
            mod.DetectionRequest(uid=3, frame=_frame(120, 160, 3),
                                 deadline_s=0.05,
                                 policy=mod.DegradationPolicy(
                                     floor=(120, 160))),
            mod.DetectionRequest(uid=4, frame=_frame(120, 160, 4),
                                 deadline_s=0.3)]
    for r in reqs:
        svc.submit(r)
    _pump(svc)
    return svc, reqs


@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
def test_downshift_rung_matches_reference(prefetch):
    ref, port = _both(_downshift, prefetch=prefetch)
    _assert_same(ref, port)
    svc, reqs = port
    assert svc.downshifted >= 2 and svc.served_downshift >= 2
    assert [r.status.value for r in reqs[2:4]] == ["deadline_exceeded"] * 2
    assert reqs[0].result.edges.shape == (120, 160)
    assert isinstance(reqs[0].result.peaks, np.ndarray)    # host arrays


def _coast(pkg, clock, ladder):
    """Rung 2 and the holds: a warm steering session, then an estimate no
    deadline survives; coasts carry fresh commands, refusals holds."""
    mod = pkg["mod"]
    svc = _make(pkg, clock, steering=True, ladder=ladder,
                buckets=((96, 128),))
    img = _frame(96, 128)
    reqs = []
    for t in range(8):
        clock.advance(0.1)
        reqs.append(mod.DetectionRequest(uid=t, frame=img, deadline_s=0.5,
                                         session_id="ego"))
        svc.submit(reqs[-1])
        svc.step(flush=True)
        clock.advance(0.02)
        svc.drain()
    grid = svc.grids[(96, 128)]
    grid.est_s, grid.est_measured = 5.0, True
    for t in range(8, 14):
        clock.advance(0.1)
        reqs.append(mod.DetectionRequest(uid=t, frame=img, deadline_s=0.1,
                                         session_id="ego"))
        svc.submit(reqs[-1])
        svc.step()
        svc.drain()
    _pump(svc)
    svc.end_session("ego")
    return svc, reqs


@pytest.mark.parametrize("ladder", [True, False], ids=["ladder", "shed_only"])
def test_coast_rung_and_holds_match_reference(ladder):
    ref, port = _both(_coast, ladder=ladder)
    _assert_same(ref, port)
    svc, reqs = port
    assert (svc.served_coast > 0) == ladder
    assert all(r.steering is not None for r in reqs)
    assert "ego" not in svc.controllers


def _tiers(pkg, clock, ladder):
    """Rung 3: a full queue evicts the worst strictly-lower tier; peers
    are refused; under an estimate no deadline survives, priority
    classes shed in order."""
    mod = pkg["mod"]
    svc = _make(pkg, clock, max_queue=2, ladder=ladder,
                buckets=((96, 128),))
    reqs = [mod.DetectionRequest(uid=i, frame=_frame(96, 128, seed=i),
                                 priority=p, deadline_s=d)
            for i, (p, d) in enumerate([(2, None), (1, 5.0), (0, None),
                                        (0, 1.0), (2, 0.5), (1, None)])]
    for r in reqs:
        svc.submit(r)
    _pump(svc)
    _ground(svc, pkg, clock, (96, 128), 0.4, uid0=900)
    late = [mod.DetectionRequest(uid=10 + i, frame=_frame(96, 128, seed=i),
                                 priority=p, deadline_s=d)
            for i, (p, d) in enumerate([(1, 0.3), (0, 0.9), (2, 2.0)])]
    for r in late:
        svc.submit(r)
    _pump(svc)
    return svc, reqs + late


@pytest.mark.parametrize("ladder", [True, False], ids=["ladder", "shed_only"])
def test_priority_shed_and_eviction_match_reference(ladder):
    ref, port = _both(_tiers, ladder=ladder)
    _assert_same(ref, port)
    svc, _ = port
    assert (svc.evicted > 0) == ladder
    assert svc.rejected_queue_full > 0


# --- traffic: the fault matrix -----------------------------------------------


# Dispatch and step ordinals count from the end of the warm-up (8 frames
# of a session, where a NaN frame needs a session to coast on; none
# elsewhere); staged-task ordinals from the first RGB request.
_FAULTS = {
    "stager_death": dict(kill_stager_at=(1,)),
    "dispatch_failure": dict(fail_dispatch_at=(1,)),
    "stall": dict(stall_dispatch_at=(2,), stall_s=1.0),
    "nan_frames": dict(corrupt_frame_uids=(3, 7)),
    "clock_jump": dict(clock_jump_at_step=(3,), clock_jump_s=0.5),
    "storm": dict(kill_stager_at=(1,), fail_dispatch_at=(2,),
                  stall_dispatch_at=(4,), corrupt_frame_uids=(3, 7),
                  clock_jump_at_step=(6,), clock_jump_s=0.5),
}


def _faulted(pkg, clock, faults, prefetch):
    """Twelve requests (odd ones RGB, so staging works; every third with
    a deadline; uid 7 of the warm session, if any, so that its NaN frame
    coasts)."""
    mod = pkg["mod"]
    warm = 8 if "corrupt_frame_uids" in faults else 0
    faults = {k: tuple(x + warm for x in v)
              if k in ("fail_dispatch_at", "stall_dispatch_at",
                       "clock_jump_at_step") else v
              for k, v in faults.items()}
    svc = _make(pkg, clock, faults=faults, prefetch=prefetch,
                buckets=((96, 128),), max_stager_restarts=1)
    for t in range(warm):
        svc.submit(mod.DetectionRequest(uid=100 + t, frame=_frame(96, 128),
                                        session_id="cam"))
        svc.step(flush=True)
        svc.drain()
    reqs = []
    for i in range(12):
        f = _frame(96, 128, seed=i % 3)
        if i % 2:
            f = _rgb(f)
        reqs.append(mod.DetectionRequest(
            uid=i, frame=f, deadline_s=2.0 if i % 3 == 0 else None,
            session_id="cam" if i == 7 else None))
    for r in reqs:
        svc.submit(r)
    _pump(svc)
    return svc, reqs


@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_fault_matrix_matches_reference(fault, prefetch):
    ref, port = _both(_faulted, faults=_FAULTS[fault], prefetch=prefetch)
    _assert_same(ref, port)
    svc, reqs = port
    for r in reqs:
        assert r.served != r.status.refused
    if "fail_dispatch_at" in _FAULTS[fault]:
        assert svc.dispatch_faults == 1
    if "corrupt_frame_uids" in _FAULTS[fault]:
        assert reqs[3].status.value == "invalid_frame"
        assert reqs[7].status.value == "degraded_coast"
    if prefetch and "kill_stager_at" in _FAULTS[fault]:
        assert svc.stager_deaths == 1
