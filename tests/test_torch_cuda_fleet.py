"""The port's ``ShardedDetectionService`` on the card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU (the detector's kernels have no CPU mode).  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_fleet.py

On one card every replica shares ``cuda:0`` and its current stream.  This
file imports nothing of the JAX package.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    ControlConfig, HoughConfig, PipelineConfig,
)
from repro_torch.core.network import NetworkConfig  # noqa: E402
from repro_torch.core.offload import SpeculativeConfig  # noqa: E402
from repro_torch.data import make_drive_cycle, make_scenario  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import ServiceFaultInjector  # noqa: E402
from repro_torch.serve import fleet  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    DetectionRequest, DetectionService, RequestStatus, VirtualClock,
)

CFG = PipelineConfig(hough=HoughConfig(compact=True, max_edges="auto"))
BUCKETS = ((96, 128), (120, 160))
KILL_STEP = 5


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


class _Settled(fleet.ShardedDetectionService):
    """The fleet, waiting before each router step for every live
    replica's in-flight batches: each step's reap then retires what it
    retires on the CPU, where a result is ready once ``run`` returns."""

    def step(self, **kw):
        for rep in self.alive_replicas:
            for g in rep.service.grids.values():
                if g.in_flight is not None and g.in_flight.event is not None:
                    g.in_flight.event.synchronize()
        return super().step(**kw)


def _frame(seed=0, h=120, w=160, family="straight"):
    return make_scenario(family, h, w, seed=seed).image


def _traffic(device):
    """Two interleaved 16-frame sessions at 120x160 and 8 one-offs at
    96x128 under 300 ms deadlines, a 20 ms tick a router step; replica 0
    killed by the schedule with a batch in flight; a replica added; then
    8 speculative races on the seeded lossy link, race 2's uplink and
    race 5's downlink forced lost."""
    clock = VirtualClock()
    svc = _Settled(
        CFG, n_replicas=2, device=device, clock=clock, buckets=BUCKETS,
        batch_size=2, prefetch=False, gate_band=40, fused_corridors=8,
        steering=ControlConfig(),
        faults=ServiceFaultInjector(kill_replica_at=((KILL_STEP, 0),),
                                    lose_uplink_races=(2,),
                                    lose_downlink_races=(5,)),
        speculative=SpeculativeConfig(
            local_shape=BUCKETS[0],
            network=NetworkConfig(seed=0, rtt_median_s=0.03,
                                  jitter_sigma=0.5, loss=0.1)))
    cycles = {sid: make_drive_cycle(sid, 16, 120, 160, seed=0).images()
              for sid in ("converging", "rain")}
    families = ("straight", "night", "glare", "dashed")
    reqs, in_flight = [], None
    for t in range(16):
        arrivals = [(cycles[sid][t], sid) for sid in cycles]
        if t < 8:
            arrivals.append((_frame(t, 96, 128, families[t % 4]), None))
        for frame, sid in arrivals:
            reqs.append(DetectionRequest(uid=len(reqs), frame=frame,
                                         deadline_s=0.3, session_id=sid))
            svc.submit(reqs[-1])
        if svc._steps == KILL_STEP:
            in_flight = [g.in_flight is not None for g in
                         svc.replicas[0].service.grids.values()]
        svc.step()
        clock.advance(0.02)
    svc.run()
    new = svc.add_replica()
    for i in range(8):
        reqs.append(DetectionRequest(uid=len(reqs), frame=_frame(i),
                                     deadline_s=0.3))
        svc.submit_speculative(reqs[-1])
        svc.step()
        clock.advance(0.02)
    svc.run()
    svc.close()
    return svc, reqs, (in_flight, new)


COUNTERS = (
    "routed", "session_migrations", "session_failovers", "requeued",
    "failed_on_death", "speculative_races", "speculative_upgrades",
    "speculative_timeouts", "uplink_lost_total", "downlink_lost_total",
    "scale_up_migrations", "host_kills", "dispatches", "gated_dispatches",
)


@pytest.mark.cuda
def test_card_fleet_equals_its_cpu_run(card):
    """The same traffic on the card and with ``device="cpu"``: statuses,
    buckets, stamps, results (peaks, validity, edges bit for bit), tracks,
    steering, each replica's dispatch log, every counter, every race."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    gpu, greqs, gnotes = _traffic(None)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    cpu, creqs, cnotes = _traffic("cpu")
    assert gnotes == cnotes == ([True, False], 2)
    assert {r.service.device.type for r in gpu.replicas} == {"cuda"}
    for a, b in zip(greqs, creqs):
        assert a.is_terminal
        assert (a.status, a.bucket, a.downshift, a.submitted_at,
                a.finished_at) == (b.status, b.bucket, b.downshift,
                                   b.submitted_at, b.finished_at), a.uid
        assert (a.result is None) == (b.result is None)
        if a.result is not None:
            for f in ("peaks", "valid", "edges"):
                assert torch.equal(torch.as_tensor(getattr(a.result, f))
                                   .cpu(),
                                   torch.as_tensor(getattr(b.result, f))), \
                    (a.uid, f)
        assert [dataclasses.astuple(t) for t in a.tracks or ()] == \
            [dataclasses.astuple(t) for t in b.tracks or ()]
        assert a.steering == b.steering
    assert ({k: getattr(gpu, k) for k in COUNTERS}
            == {k: getattr(cpu, k) for k in COUNTERS})
    assert gpu.session_failovers == 1 and gpu.failed_on_death > 0
    assert gpu._session_replica == cpu._session_replica
    for g, c in zip(gpu.replicas, cpu.replicas):
        assert list(g.service.dispatch_log) == list(c.service.dispatch_log)
    assert [dataclasses.astuple(t.decision) for t in gpu._tickets] == \
        [dataclasses.astuple(t.decision) for t in cpu._tickets]
    fused = sum(r.service.fused_dispatches for r in gpu.replicas)
    assert fused > 0
    assert counts["fused_detect"] == fused
    assert counts["hough_vote"] == gpu.dispatches


@pytest.mark.cuda
def test_replica_killed_with_a_batch_in_flight_on_the_card(card,
                                                          monkeypatch):
    """A batch queued behind device work dies with its replica: its
    requests end FAILED at once, no CUDA error follows, and the survivor's
    later answers equal the batch run again through its plan."""
    monkeypatch.setattr(fleet, "DetectionService", _Recorded)
    svc = fleet.ShardedDetectionService(
        CFG, n_replicas=2, clock=VirtualClock(), buckets=BUCKETS,
        batch_size=2, prefetch=False)
    for r in range(2):      # one cold dispatch a replica
        req = DetectionRequest(uid=-1 - r, frame=_frame(9))
        svc.replicas[r].service.submit(req)
        svc.replicas[r].service.run()
    doomed = [DetectionRequest(uid=i, frame=_frame(i), session_id="ego")
              for i in range(2)]
    for r in doomed:
        svc.submit(r)
    pin = svc.session_location("ego")
    torch.cuda._sleep(200_000_000)      # ~0.1 s of device work ahead
    svc.step()
    f = svc.replicas[pin].service.grids[BUCKETS[1]].in_flight
    assert f is not None and f.event is not None
    svc.kill_replica(pin)               # no wait: the batch is in flight
    assert all(r.status is RequestStatus.FAILED for r in doomed)
    assert svc.failed_on_death == 2
    later = [DetectionRequest(uid=10 + i, frame=_frame(10 + i),
                              session_id="ego" if i % 2 else None)
             for i in range(6)]
    for r in later:
        svc.submit(r)
    svc.run()
    torch.cuda.synchronize()            # raises on a CUDA error
    survivor = svc.replicas[1 - pin].service
    assert all(r.status is RequestStatus.DONE for r in later)
    checked = 0
    for rec in survivor.retired:
        again = rec.plan.run(rec.images, rec.theta_bins, rec.corridors)
        for i, req in enumerate(rec.reqs):
            if req is None or req.uid < 10:
                continue
            h, w = req.frame.shape[:2]
            assert torch.equal(req.result.peaks, again.peaks[i])
            assert torch.equal(req.result.valid, again.valid[i])
            assert torch.equal(req.result.edges, again.edges[i][:h, :w])
            checked += 1
    assert checked == len(later)
    svc.close()


@pytest.mark.cuda
def test_add_replica_on_a_card_fleet_lands_on_the_card(card):
    svc = fleet.ShardedDetectionService(
        CFG, n_replicas=1, clock=VirtualClock(), buckets=BUCKETS,
        batch_size=1, prefetch=False)
    assert svc.add_replica() == 1
    assert [r.service.device.type for r in svc.replicas] == ["cuda"] * 2
    reqs = [DetectionRequest(uid=i, frame=_frame(i)) for i in range(2)]
    for r in reqs:
        svc.submit(r)
    svc.run()
    assert all(r.ok for r in reqs)
    assert [r.service.dispatches for r in svc.replicas] == [1, 1]
    svc.close()
