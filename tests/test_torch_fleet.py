"""The port's ``ShardedDetectionService`` against ``repro.serve.fleet`` on the
same traffic, both on a ``VirtualClock``, the port with ``device="cpu"``.

Each scenario is one of the reference's in-process fleet tests
(``tests/test_mesh.py``), driven the same way on both packages: routing,
affinity and its ablation, session churn, migration, replica death (queued,
in flight, scheduled, all of them), a dropout storm, the speculative race
on the fixed-rtt path and on the seeded network (lost uplink, lost
downlink, the race timeout, the cross-host local), migration onto a
replica dying in the same step, scale-up, and host death.  Compared after
each drive: every request's status, bucket, downshift, stamps and result
(peaks, validity and edges bit for bit; lines within 1e-3, the ulps of
``cos`` / ``sin``), tracks and steering; each replica's liveness, dispatch
log, counters, sessions and SLOs; each session's location, tracks and
aggregated SLO; every fleet counter; every race's legs and decision.

The port's CPU result is ready once ``run`` returns; the reference's XLA
dispatch may not be, and its reap only polls.  So every reference
replica's service step first blocks on its in-flight batch (in this test
process only): both reaps then retire the same batches at the same
stamps.  Blocking happens inside a step, never between a dispatch and the
kill that is meant to catch it in flight.  Small buckets (96x128,
120x160), batches of 1, one torch thread.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import HoughConfig as JHough  # noqa: E402
from repro.core import PipelineConfig as JPipeline  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core.control import ControlConfig as JControl  # noqa: E402
from repro.core import offload as joff  # noqa: E402
from repro.data import make_drive_cycle, make_scenario  # noqa: E402
from repro.runtime import ServiceFaultInjector as JFaults  # noqa: E402
from repro.serve import detection as jdet  # noqa: E402
from repro.serve import fleet as jfleet  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ControlConfig, HoughConfig, PipelineConfig,
)
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import offload as toff  # noqa: E402
from repro_torch.launch.mesh import replica_devices  # noqa: E402
from repro_torch.runtime import ServiceFaultInjector  # noqa: E402
from repro_torch.serve import detection as tdet  # noqa: E402
from repro_torch.serve import fleet as tfleet  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_replicas_block_before_each_step(monkeypatch):
    """Each reference service step first waits for its in-flight batches
    (``benchmarks/mesh_suite.py`` does the same), so its non-blocking
    reap retires them in that step, as the port's CPU reap does."""
    step = jdet.DetectionService.step

    def blocking_step(self, *args, **kw):
        for g in self.grids.values():
            if g.in_flight is not None:
                jax.block_until_ready(g.in_flight[1].lines)
        return step(self, *args, **kw)

    monkeypatch.setattr(jdet.DetectionService, "step", blocking_step)


BUCKETS = ((96, 128), (120, 160))
COUNTERS = (
    "dispatches", "completed", "rejected_queue_full", "shed_deadline",
    "completed_late", "downshifted", "pre_downshifted", "served_downshift",
    "served_coast", "gated_dispatches", "fused_dispatches", "evicted",
    "rejected_invalid", "dispatch_faults", "stager_deaths",
)
FLEET_COUNTERS = (
    "routed", "session_migrations", "session_failovers", "requeued",
    "failed_on_death", "speculative_races", "speculative_upgrades",
    "speculative_timeouts", "uplink_lost_total", "downlink_lost_total",
    "scale_up_migrations", "host_kills", "dispatches", "gated_dispatches",
)
# each package's modules and classes, by the role they play in a drive
REF = dict(fleet=jfleet, det=jdet, net=jnet, off=joff, faults=JFaults,
           control=JControl,
           cfg=JPipeline(hough=JHough(compact=True, max_edges="auto")),
           device={})
PORT = dict(fleet=tfleet, det=tdet, net=tnet, off=toff,
            faults=ServiceFaultInjector, control=ControlConfig,
            cfg=PipelineConfig(hough=HoughConfig(compact=True,
                                                 max_edges="auto")),
            device={"device": "cpu"})


def _frame(h: int = 120, w: int = 160, seed: int = 0) -> np.ndarray:
    return make_scenario("straight", h, w, seed=seed).image


def _fleet(pkg, n=2, *, faults=None, **kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("batch_size", 1)
    kw.setdefault("clock", pkg["det"].VirtualClock())
    kw.setdefault("prefetch", False)
    return pkg["fleet"].ShardedDetectionService(
        pkg["cfg"], n_replicas=n,
        faults=None if faults is None else pkg["faults"](**faults),
        **pkg["device"], **kw)


def _req(pkg, uid, frame, **kw):
    return pkg["det"].DetectionRequest(uid=uid, frame=frame, **kw)


# --- the scenarios: each returns (fleet, requests, notes) ---------------------


def spread(pkg):
    svc = _fleet(pkg, 3)
    reqs = [_req(pkg, i, _frame(seed=i)) for i in range(6)]
    for r in reqs:
        svc.submit(r)
    svc.run()
    return svc, reqs, []


def affinity(pkg):
    svc = _fleet(pkg, 3)
    reqs = []
    for t in range(9):
        filler = _req(pkg, 100 + t, _frame(seed=t))
        req = _req(pkg, t, _frame(seed=t), session_id="ego")
        svc.submit(filler)
        svc.submit(req)
        svc.run()
        reqs += [filler, req]
    return svc, reqs, []


def affinity_off(pkg):
    svc = _fleet(pkg, 3, affinity=False)
    reqs, uid = [], 100
    for t in range(9):
        for _ in range(t % 3):
            reqs.append(_req(pkg, uid, _frame(seed=t)))
            svc.submit(reqs[-1])
            uid += 1
        reqs.append(_req(pkg, t, _frame(seed=t), session_id="ego"))
        svc.submit(reqs[-1])
        svc.run()
    return svc, reqs, []


def churn(pkg):
    svc = _fleet(pkg, 3)
    reqs, notes, uid = [], [], 0
    for wave in range(4):
        for s in range(3):
            for _ in range(2):
                reqs.append(_req(pkg, uid, _frame(seed=uid),
                                 session_id=f"s{wave}-{s}"))
                svc.submit(reqs[-1])
                uid += 1
            svc.run()
        if wave:
            gone = f"s{wave - 1}-0"
            pin = svc.session_location(gone)
            notes.append(pin)
            svc.replicas[pin].service.end_session(gone)
            del svc._session_replica[gone]
    return svc, reqs, notes


def migrate(pkg):
    svc = _fleet(pkg, 2)
    reqs = []
    for t in range(4):
        reqs.append(_req(pkg, t, _frame(seed=0), session_id="ego"))
        svc.submit(reqs[-1])
        svc.run()
    src = svc.session_location("ego")
    tracker = svc.replicas[src].service.sessions["ego"]
    notes = [src, svc.migrate_session("ego", 1 - src),
             svc.replicas[1 - src].service.sessions["ego"] is tracker]
    reqs.append(_req(pkg, 99, _frame(seed=0), session_id="ego"))
    svc.submit(reqs[-1])
    svc.run()
    return svc, reqs, notes


def migrate_to_dead(pkg):
    svc = _fleet(pkg, 2)
    reqs = [_req(pkg, 0, _frame(), session_id="ego")]
    svc.submit(reqs[0])
    svc.run()
    svc.kill_replica(1 - svc.session_location("ego"))
    return svc, reqs, [svc.migrate_session(
        "ego", 1 - svc.session_location("ego"))]


def death_requeue(pkg):
    clock = pkg["det"].VirtualClock()
    svc = _fleet(pkg, 2, clock=clock, max_queue=16)
    reqs = [_req(pkg, i, _frame(seed=i), deadline_s=5.0) for i in range(6)]
    for r in reqs:
        svc.submit(r)
    clock.advance(0.5)
    svc.kill_replica(0)
    notes = [r.deadline_at for r in reqs]
    svc.run()
    return svc, reqs, notes


def death_in_flight(pkg):
    svc = _fleet(pkg, 2)
    warm = _req(pkg, 0, _frame(), session_id="ego")
    svc.submit(warm)
    svc.run()
    pin = svc.session_location("ego")
    doomed = _req(pkg, 1, _frame(), session_id="ego")
    svc.submit(doomed)
    svc.step()          # dispatches on the pinned replica
    in_flight = [g.in_flight is not None
                 for g in svc.replicas[pin].service.grids.values()]
    svc.kill_replica(pin)
    nxt = _req(pkg, 2, _frame(), session_id="ego")
    svc.submit(nxt)
    svc.run()
    return svc, [warm, doomed, nxt], [pin, in_flight]


def death_scheduled(pkg):
    svc = _fleet(pkg, 2, faults=dict(kill_replica_at=((1, 0),)))
    reqs = [_req(pkg, i, _frame(seed=i)) for i in range(4)]
    for r in reqs:
        svc.submit(r)
    svc.run()
    return svc, reqs, []


def all_dead(pkg):
    svc = _fleet(pkg, 2)
    reqs = [_req(pkg, i, _frame(seed=i)) for i in range(3)]
    for r in reqs:
        svc.submit(r)
    svc.kill_replica(0)
    svc.kill_replica(1)
    try:
        svc.submit(_req(pkg, 9, _frame()))
        raised = None
    except RuntimeError as e:
        raised = str(e)
    return svc, reqs, [raised]


def dropout_storm(pkg):
    cycle = make_drive_cycle("straight", 18, 120, 160, seed=0,
                             dropout_frames=(10, 11, 12))
    clock = pkg["det"].VirtualClock()
    svc = _fleet(pkg, 2, clock=clock)
    reqs = []
    for fr in cycle.frames:
        reqs.append(_req(pkg, fr.t, fr.scene.image, session_id="ego"))
        svc.submit(reqs[-1])
        svc.run()
        clock.advance(0.01)
    return svc, reqs, []


def _compat(pkg, rtt_s, clock):
    return _fleet(pkg, 2, clock=clock, remote_replica=1,
                  speculative=pkg["off"].SpeculativeConfig(
                      rtt_s=rtt_s, local_shape=(96, 128)))


def compat_upgrade(pkg, rtt_s=0.02, deadline_s=1.0, wait=0.10):
    clock = pkg["det"].VirtualClock()
    svc = _compat(pkg, rtt_s, clock)
    req = _req(pkg, 0, _frame(), deadline_s=deadline_s)
    ticket = svc.submit_speculative(req)
    svc.replicas[0].service.run()
    clock.advance(wait)
    svc.replicas[1].service.run()
    svc.resolve_speculative(ticket)
    return svc, [req], []


def compat_local_wins(pkg):
    return compat_upgrade(pkg, rtt_s=0.5, deadline_s=0.2, wait=0.05)


def compat_dead_remote(pkg):
    svc = _compat(pkg, 0.01, pkg["det"].VirtualClock())
    svc.kill_replica(1)
    req = _req(pkg, 0, _frame(), deadline_s=1.0)
    svc.submit_speculative(req)
    svc.run()
    return svc, [req], []


def _net(pkg, clock, *, seed=0, loss=0.0, sigma=0.0, rtt=0.03,
         race_timeout_s=None, faults=None, n=2, hosts=None):
    return _fleet(
        pkg, n, clock=clock, remote_replica=n - 1, faults=faults, hosts=hosts,
        speculative=pkg["off"].SpeculativeConfig(
            local_shape=(96, 128), race_timeout_s=race_timeout_s,
            network=pkg["net"].NetworkConfig(
                seed=seed, rtt_median_s=rtt, jitter_sigma=sigma,
                loss=loss)))


def network_uplink(pkg):
    svc = _net(pkg, pkg["det"].VirtualClock())
    req = _req(pkg, 0, _frame(), deadline_s=0.1)
    ticket = svc.submit_speculative(req)
    notes = [ticket.remote_submitted, ticket.remote_submit_at]
    svc.run()
    return svc, [req], notes


def network_stream(pkg):
    svc = _net(pkg, pkg["det"].VirtualClock(), seed=11, loss=0.2, sigma=0.6)
    reqs = []
    for i in range(6):
        reqs.append(_req(pkg, i, _frame(seed=i), deadline_s=0.1))
        svc.submit_speculative(reqs[-1])
        svc.run()
    return svc, reqs, []


def lost_uplink(pkg, deadline_s=0.1, **kw):
    svc = _net(pkg, pkg["det"].VirtualClock(),
               faults=dict(lose_uplink_races=(0,)), **kw)
    req = _req(pkg, 0, _frame(), deadline_s=deadline_s)
    svc.submit_speculative(req)
    svc.run()
    return svc, [req], [svc.clock()]


def lost_downlink(pkg):
    svc = _net(pkg, pkg["det"].VirtualClock(),
               faults=dict(lose_downlink_races=(0,)))
    req = _req(pkg, 0, _frame(), deadline_s=0.2)
    svc.submit_speculative(req)
    svc.run()
    return svc, [req], []


def race_timeout(pkg):
    return lost_uplink(pkg, deadline_s=None, race_timeout_s=0.5)


def cross_host_local(pkg):
    svc = _fleet(pkg, 4, hosts=(0, 0, 1, 1), remote_replica=3,
                 speculative=pkg["off"].SpeculativeConfig(
                     local_shape=(96, 128)))
    req = _req(pkg, 0, _frame(), deadline_s=1.0)
    svc.submit_speculative(req)
    notes = [r.service.queued for r in svc.replicas]
    svc.run()
    return svc, [req], notes


def migrate_to_dying(pkg):
    svc = _fleet(pkg, 3)
    reqs = []
    for t in range(3):
        reqs.append(_req(pkg, t, _frame(seed=0), session_id="ego"))
        svc.submit(reqs[-1])
        svc.run()
    dst = (svc.session_location("ego") + 1) % 3
    notes = [svc.migrate_session("ego", dst)]
    svc.kill_replica(dst)   # the tracker just moved onto a corpse
    notes.append(svc.session_location("ego"))
    reqs.append(_req(pkg, 99, _frame(seed=0), session_id="ego"))
    svc.submit(reqs[-1])
    svc.run()
    return svc, reqs, notes


def scale_up(pkg):
    svc = _fleet(pkg, 2)
    reqs = []
    for s in range(6):
        for t in range(2):
            reqs.append(_req(pkg, s * 10 + t, _frame(seed=s),
                             session_id=f"s{s}"))
            svc.submit(reqs[-1])
            svc.run()
    new = svc.add_replica()
    notes = [new, {shape: (g.est_s, g.est_measured) for shape, g in
                   svc.replicas[new].service.grids.items()}]
    for s in range(6):
        reqs.append(_req(pkg, 100 + s, _frame(seed=s), session_id=f"s{s}"))
        svc.submit(reqs[-1])
        svc.run()
    return svc, reqs, notes


def host_kill(pkg):
    clock = pkg["det"].VirtualClock()
    svc = _fleet(pkg, 4, clock=clock, hosts=(0, 0, 1, 1), max_queue=16)
    reqs = [_req(pkg, i, _frame(seed=i), deadline_s=5.0) for i in range(8)]
    for r in reqs:
        svc.submit(r)
    clock.advance(0.5)
    svc.kill_host(0)
    svc.run()
    return svc, reqs, []


def host_kill_scheduled(pkg):
    svc = _fleet(pkg, 4, faults=dict(kill_host_at=((1, 0),)),
                 hosts=(0, 0, 1, 1))
    reqs = [_req(pkg, i, _frame(seed=i)) for i in range(6)]
    for r in reqs:
        svc.submit(r)
    svc.run()
    return svc, reqs, []


def saturated_pin(pkg):
    """A pinned session whose replica's backlog (an in-flight batch
    included) makes its next deadline infeasible moves to the idle
    replica (``_maybe_migrate``)."""
    clock = pkg["det"].VirtualClock()
    svc = _fleet(pkg, 2, clock=clock)
    reqs = []
    for t, steps in enumerate((1, 1, 0, 0, 1, 1)):
        reqs.append(_req(pkg, t, _frame(), session_id="ego",
                         deadline_s=0.12))
        svc.submit(reqs[-1])
        if steps:
            svc.step()
            clock.advance(0.01)
    svc.run()
    return svc, reqs, []


TRAFFIC_KILL_STEP = 5


def traffic(pkg):
    """The smoke run's fleet traffic at small size: two interleaved
    16-frame sessions ("converging", "rain") at 120x160 with 8 sessionless
    96x128 one-offs, 300 ms deadlines, batch 2, the union gate and the
    fused corridors, steering; a 20 ms tick a router step; replica 0
    killed by the schedule at a step where it has a batch in flight; a
    replica added; then 8 speculative races at 120x160 on the seeded
    lossy link (the local tier at 96x128), race 2's uplink and race 5's
    downlink forced lost."""
    det = pkg["det"]
    clock = det.VirtualClock()
    svc = _fleet(
        pkg, 2, clock=clock, batch_size=2, gate_band=40, fused_corridors=8,
        steering=pkg["control"](),
        faults=dict(kill_replica_at=((TRAFFIC_KILL_STEP, 0),),
                    lose_uplink_races=(2,), lose_downlink_races=(5,)),
        speculative=pkg["off"].SpeculativeConfig(
            local_shape=BUCKETS[0],
            network=pkg["net"].NetworkConfig(
                seed=0, rtt_median_s=0.03, jitter_sigma=0.5, loss=0.1)))
    cycles = {sid: make_drive_cycle(sid, 16, 120, 160, seed=0).images()
              for sid in ("converging", "rain")}
    families = ("straight", "night", "glare", "dashed")
    reqs, notes = [], []
    for t in range(16):
        arrivals = [(cycles[sid][t], sid) for sid in cycles]
        if t < 8:
            arrivals.append((make_scenario(families[t % 4], 96, 128,
                                           seed=t).image, None))
        for frame, sid in arrivals:
            reqs.append(det.DetectionRequest(
                uid=len(reqs), frame=frame, deadline_s=0.3, session_id=sid))
            svc.submit(reqs[-1])
        if svc._steps == TRAFFIC_KILL_STEP:
            notes.append([g.in_flight is not None for g in
                          svc.replicas[0].service.grids.values()])
        svc.step()
        clock.advance(0.02)
    svc.run()
    notes.append(svc.add_replica())
    for i in range(8):
        reqs.append(det.DetectionRequest(
            uid=len(reqs), frame=_frame(seed=i), deadline_s=0.3))
        svc.submit_speculative(reqs[-1])
        svc.step()
        clock.advance(0.02)
    svc.run()
    return svc, reqs, notes


SCENARIOS = (
    spread, affinity, affinity_off, churn, migrate, migrate_to_dead,
    death_requeue, death_in_flight, death_scheduled, all_dead,
    dropout_storm, compat_upgrade, compat_local_wins, compat_dead_remote,
    network_uplink, network_stream, lost_uplink, lost_downlink,
    race_timeout, cross_host_local, migrate_to_dying, scale_up, host_kill,
    host_kill_scheduled, saturated_pin, traffic,
)


# --- comparison ---------------------------------------------------------------


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tracks(tracks):
    return None if tracks is None else [dataclasses.astuple(t)
                                        for t in tracks]


def _astuple(x):
    return None if x is None else dataclasses.astuple(x)


def _same_request(a, b):
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
        np.testing.assert_allclose(_np(b.result.lines), _np(a.result.lines),
                                   rtol=0, atol=1e-3)
    assert _tracks(b.tracks) == _tracks(a.tracks), a.uid
    assert (None if b.steering is None else tuple(b.steering)) == \
        (None if a.steering is None else tuple(a.steering)), a.uid


def _assert_same(ref, port):
    """Both drives (fleet, requests, notes) ended the same way."""
    (jf, jreqs, jnotes), (tf, treqs, tnotes) = ref, port
    assert tnotes == jnotes
    assert len(treqs) == len(jreqs)
    for a, b in zip(jreqs, treqs):
        _same_request(a, b)
    assert tf.clock() == jf.clock()
    assert ({k: getattr(tf, k) for k in FLEET_COUNTERS}
            == {k: getattr(jf, k) for k in FLEET_COUNTERS})
    assert tf._session_replica == jf._session_replica
    assert len(tf.replicas) == len(jf.replicas)
    for jr, tr in zip(jf.replicas, tf.replicas):
        js, ts = jr.service, tr.service
        assert (tr.index, tr.alive, tr.host) == (jr.index, jr.alive, jr.host)
        assert list(ts.dispatch_log) == list(js.dispatch_log)
        assert ({k: getattr(ts, k) for k in COUNTERS}
                == {k: getattr(js, k) for k in COUNTERS})
        assert ({s: dataclasses.astuple(v) for s, v in ts.slo.items()}
                == {s: dataclasses.astuple(v) for s, v in js.slo.items()})
        assert sorted(ts.sessions) == sorted(js.sessions)
        for sid in js.sessions:
            assert (_tracks(ts.session_tracks(sid))
                    == _tracks(js.session_tracks(sid)))
        assert ts.queued == js.queued
        # the service-time estimators (routing reads them; add_replica
        # warms a newcomer's from a veteran)
        assert ([(g.est_s, g.est_measured) for g in ts.grids.values()]
                == [(g.est_s, g.est_measured) for g in js.grids.values()])
    sids = {r.session_id for r in jreqs if r.session_id is not None}
    for sid in sorted(sids):
        assert tf.session_location(sid) == jf.session_location(sid)
        assert _tracks(tf.session_tracks(sid)) == \
            _tracks(jf.session_tracks(sid))
        assert dataclasses.astuple(tf.session_slo(sid)) == \
            dataclasses.astuple(jf.session_slo(sid))
    assert len(tf._tickets) == len(jf._tickets)
    for jt, tt in zip(jf._tickets, tf._tickets):
        assert _astuple(tt.decision) == _astuple(jt.decision)
        assert _astuple(tt.uplink) == _astuple(jt.uplink)
        assert _astuple(tt.downlink) == _astuple(jt.downlink)
        assert (tt.remote_submit_at, tt.remote_submitted, tt.created_at,
                tt.race_idx) == (jt.remote_submit_at, jt.remote_submitted,
                                 jt.created_at, jt.race_idx)
        _same_request(jt.local, tt.local)
        _same_request(jt.remote, tt.remote)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_fleet_equals_reference(scenario):
    out = []
    for pkg in (REF, PORT):
        fleet, reqs, notes = scenario(pkg)
        fleet.close()
        out.append((fleet, reqs, notes))
    _assert_same(*out)
    tf, treqs, _ = out[1]
    assert all(r.is_terminal for r in treqs)
    assert all(t.resolved for t in tf._tickets)
    assert {r.service.device.type for r in tf.replicas} == {"cpu"}


def test_scenarios_reach_what_they_name():
    """The drives above reach the fleet's paths (on the port)."""
    svc, reqs, notes = death_in_flight(PORT)
    assert notes[1] == [False, True] and reqs[1].status.name == "FAILED"
    assert svc.failed_on_death == 1 and svc.session_failovers == 1
    svc, _, _ = scale_up(PORT)
    assert svc.scale_up_migrations > 0
    svc, reqs, _ = network_stream(PORT)
    assert svc.uplink_lost_total + svc.downlink_lost_total > 0
    assert 0 < svc.speculative_upgrades < len(reqs)
    svc, _, notes = race_timeout(PORT)
    assert svc.speculative_timeouts == 1 and notes[0] >= 0.5
    svc, _, notes = cross_host_local(PORT)
    assert notes == [1, 0, 0, 1]      # local on host 0, remote on 3
    svc, reqs, _ = host_kill(PORT)
    assert svc.host_kills == 1 and svc.requeued > 0
    assert sum(r.ok for r in reqs) + svc.failed_on_death == len(reqs)
    svc, _, _ = saturated_pin(PORT)
    assert svc.session_migrations == 1
    svc, reqs, notes = traffic(PORT)
    # replica 0 died with its 96x128 batch in flight; the newcomer is 2
    assert notes == [[True, False], 2]
    assert svc.failed_on_death > 0 and svc.session_failovers == 1
    assert svc.uplink_lost_total >= 1 and svc.downlink_lost_total >= 1
    assert svc.speculative_timeouts >= 1 and svc.speculative_upgrades > 0
    assert sum(r.service.fused_dispatches for r in svc.replicas) > 0
    assert all(r.is_terminal for r in reqs)


# --- the device rule (the port only) ----------------------------------------


def test_fleet_runs_on_the_card_unless_asked_for_the_cpu():
    cfg = PORT["cfg"]
    if torch.cuda.is_available():
        svc = tfleet.ShardedDetectionService(cfg, n_replicas=2,
                                             buckets=BUCKETS)
        assert {r.service.device.type for r in svc.replicas} == {"cuda"}
        svc.close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfleet.ShardedDetectionService(cfg, n_replicas=2,
                                           buckets=BUCKETS)
    svc = tfleet.ShardedDetectionService(cfg, n_replicas=2, buckets=BUCKETS,
                                         device="cpu")
    assert [r.service.device for r in svc.replicas] == \
        [torch.device("cpu")] * 2
    svc.close()


def test_replica_devices_follow_the_device_rule():
    assert replica_devices(3, "cpu") == [torch.device("cpu")] * 3
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert replica_devices(5) == [torch.device("cuda", i % n)
                                      for i in range(5)]
        assert replica_devices(2, "cuda") == replica_devices(2)
    else:
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                replica_devices(2, device)


@pytest.mark.parametrize("built_with", ["device", "devices"])
def test_add_replica_on_a_cpu_fleet_stays_on_the_cpu(built_with):
    kw = ({"device": "cpu"} if built_with == "device"
          else {"devices": replica_devices(2, "cpu")})
    svc = tfleet.ShardedDetectionService(
        PORT["cfg"], n_replicas=2, buckets=BUCKETS, batch_size=1,
        clock=tdet.VirtualClock(), prefetch=False, **kw)
    assert svc.add_replica() == 2
    assert svc.add_replica(host=0) == 3
    assert [r.service.device.type for r in svc.replicas] == ["cpu"] * 4
    assert [r.host for r in svc.replicas] == [0, 1, 2, 0]
    req = tdet.DetectionRequest(uid=0, frame=_frame())
    svc.submit(req)
    svc.run()
    assert req.ok
    svc.close()
