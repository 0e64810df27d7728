"""The port's ``DetectionService`` on the card (its device seams).

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU (the detector's kernels have no CPU mode).  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_service.py

This file imports nothing of the JAX package.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_lines import DEPLOY_HW  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ControlConfig, HoughConfig, PipelineConfig,
)
from repro_torch.data import make_drive_cycle, scenario_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import detection  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    DetectionRequest, DetectionService, RequestStatus, VirtualClock,
)

CFG = PipelineConfig(hough=HoughConfig(compact=True, max_edges="auto"))
BUCKETS = ((240, 320), DEPLOY_HW)


@pytest.fixture
def card():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the detector's kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


class _Recorded(DetectionService):
    """The service, keeping every batch it retires."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.retired = []

    def _complete(self, grid, *, update_est=True):
        if grid.in_flight is not None:
            self.retired.append(grid.in_flight)
        super()._complete(grid, update_est=update_est)


def _drive(svc, clock, n=12):
    """Two sessions on one 720x1280 cycle plus one-off 240x320 frames, a
    tick a step, each batch drained after the tick."""
    cycle = make_drive_cycle("converging", n, *DEPLOY_HW, seed=0).images()
    small, _ = scenario_batch(("straight", "night", "rain", "dashed"),
                              *BUCKETS[0], seed=1)
    reqs = []
    for t in range(n):
        frames = [(cycle[t], "cam0"), (cycle[t], "cam1")]
        if t < len(small):
            frames.append((small[t], None))
        for frame, sid in frames:
            reqs.append(DetectionRequest(uid=len(reqs), frame=frame,
                                         session_id=sid, deadline_s=0.3))
            svc.submit(reqs[-1])
        svc.step()
        clock.advance(1 / 30)
        svc.drain()
    svc.run()
    return reqs


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_service_answers_equal_plan_run_on_the_same_batch(card, fused):
    """Each DONE request at 720x1280 (and 240x320) equals the batch run
    again through its plan on the card, bit for bit; the fused config
    reaches the fused kernel."""
    clock = VirtualClock()
    svc = _Recorded(CFG, buckets=BUCKETS, batch_size=4, clock=clock,
                    gate_band=40, fused_corridors=8 if fused else None,
                    steering=ControlConfig())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    reqs = _drive(svc, clock)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    svc.close()
    assert svc.device.type == "cuda"
    assert all(r.status is RequestStatus.DONE for r in reqs)
    checked = 0
    for rec in svc.retired:
        again = rec.plan.run(rec.images, rec.theta_bins, rec.corridors)
        assert rec.images.is_cuda
        for i, req in enumerate(rec.reqs):
            if req is None:
                continue
            h, w = req.frame.shape[:2]
            assert req.result.peaks.is_cuda
            assert torch.equal(req.result.peaks, again.peaks[i])
            assert torch.equal(req.result.valid, again.valid[i])
            assert torch.equal(req.result.edges, again.edges[i][:h, :w])
            checked += 1
    assert checked == len(reqs)
    assert svc.gated_dispatches > 0
    assert counts["fused_detect"] == svc.fused_dispatches
    assert (svc.fused_dispatches > 0) == fused
    assert counts["hough_vote"] == svc.dispatches
    assert counts["conv2d_gemm"] == 2 * (svc.dispatches
                                         - svc.fused_dispatches)


@pytest.mark.cuda
def test_event_reap_delivers_each_batch_once(card):
    """A batch queued behind a sleeping kernel is not reaped while its
    event is pending; once the event completes one reap delivers it, and
    later reaps and drains deliver nothing again."""
    svc = DetectionService(CFG, buckets=BUCKETS[:1], batch_size=2,
                           clock=VirtualClock())
    small, _ = scenario_batch(("straight", "night"), *BUCKETS[0], seed=2)
    warm = DetectionRequest(uid=0, frame=small[0])
    svc.submit(warm)
    svc.run()                           # the cold dispatch
    reqs = [DetectionRequest(uid=1 + i, frame=f) for i, f in
            enumerate(small)]
    for r in reqs:
        svc.submit(r)
    torch.cuda._sleep(200_000_000)      # ~0.1 s of device work ahead
    svc.step()
    f = svc.grids[BUCKETS[0]].in_flight
    assert f is not None and f.event is not None and f.warm
    svc._reap()
    if not f.event.query():             # still behind the sleep: pending
        assert all(r.status is RequestStatus.PENDING for r in reqs)
        assert svc.grids[BUCKETS[0]].in_flight is f
    f.event.synchronize()
    svc._reap()
    assert svc.grids[BUCKETS[0]].in_flight is None
    assert all(r.status is RequestStatus.DONE for r in reqs)
    done = svc.completed
    svc._reap()
    svc.drain()
    svc.run()
    assert svc.completed == done == 3
    assert svc.dispatches == 2
    svc.close()


@pytest.mark.cuda
def test_warm_loop_makes_no_host_sync(card):
    """Every warm dispatch (full, gated and fused keys) runs under
    ``set_sync_debug_mode("error")``, and the mode is live there: a host
    sync inside it raises; the caller's mode is restored after."""
    with detection._no_host_sync(card):
        with pytest.raises(RuntimeError):
            torch.ones(1, device=card).item()
    assert torch.cuda.get_sync_debug_mode() == 0
    clock = VirtualClock()
    svc = DetectionService(CFG, buckets=BUCKETS, batch_size=4, clock=clock,
                           gate_band=40, fused_corridors=8)
    _drive(svc, clock)                  # warms every key on its way
    warmed = set(svc._warmed)
    d0 = svc.dispatches
    reqs = _drive(svc, clock)           # the same traffic, every key warm
    svc.close()
    assert svc._warmed == warmed        # every dispatch above was warm
    assert svc.dispatches > d0
    assert {k[3] for k in warmed} == {False, True}   # fused and staged
    assert all(r.is_terminal for r in reqs)
    assert torch.cuda.get_sync_debug_mode() == 0
