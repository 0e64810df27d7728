"""The port's runtime (heartbeats, worker failures, the service fault
injector) and its prefetch stager against the JAX package's.

Everything runs on injected clocks and explicit schedules: no wall-clock
sleep, and every thread join and ``Future.result`` has a timeout.
"""

import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

import repro.runtime as jruntime  # noqa: E402
from repro.runtime import faults as jfaults  # noqa: E402
from repro.serve import detection as jdetection  # noqa: E402
import repro_torch.runtime as runtime  # noqa: E402
from repro_torch.runtime import faults, heartbeat, supervisor  # noqa: E402
from repro_torch.serve import detection  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIMEOUT = 10.0


def test_runtime_exports_the_reference_names_but_the_restart_loop():
    want = {n for n in dir(jruntime) if not n.startswith("_")
            and n not in ("run_with_restarts", "supervisor", "faults",
                          "heartbeat")}
    got = {n for n in dir(runtime) if not n.startswith("_")
           and n not in ("supervisor", "faults", "heartbeat")}
    assert got == want
    assert issubclass(runtime.WorkerFailure, RuntimeError)
    assert not hasattr(runtime, "run_with_restarts")


# --- heartbeats on an injected clock -----------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _heartbeat_trace(mod):
    """Beats and monitor verdicts of three workers over a fixed schedule."""
    clock, reg, dead_seen = _Clock(), {}, []
    beats = {w: mod.Heartbeat(w, reg, clock=clock) for w in ("a", "b", "c")}
    mon = mod.HeartbeatMonitor(reg, timeout_s=0.25, clock=clock,
                               on_dead=dead_seen.append)
    out = [dict(reg), mon.all_alive()]
    for t, beating in ((0.1, "abc"), (0.3, "ab"), (0.5, "a"), (0.6, ""),
                       (0.9, "b"), (1.4, "abc")):
        clock.t = t
        for w in beating:
            beats[w].beat()
        out.append((t, dict(reg), sorted(mon.dead_workers()),
                    mon.all_alive()))
    for b in beats.values():
        b.stop()
    out.append(dead_seen)
    return out


def test_heartbeat_and_monitor_match_reference():
    assert _heartbeat_trace(heartbeat) == _heartbeat_trace(jruntime.heartbeat)


def test_heartbeat_registers_at_construction_and_stops_without_a_thread():
    reg = {}
    hb = heartbeat.Heartbeat("w", reg, clock=lambda: 7.0)
    assert reg == {"w": 7.0} and hb._thread is None
    hb.stop()
    assert hb._stop.is_set()


# --- injectors ---------------------------------------------------------------


def test_fault_injector_fires_once_like_the_reference():
    def trace(mod):
        inj = mod.FaultInjector(fail_at_steps=(2, 5))
        out = []
        for step in (0, 1, 2, 2, 3, 5, 5, 6):
            try:
                inj.check(step)
                out.append((step, None))
            except mod.WorkerFailure as e:
                out.append((step, str(e)))
        return out
    assert trace(supervisor) == trace(jruntime.supervisor)


_SCHEDULE = dict(
    kill_stager_at=(1, 4), fail_dispatch_at=(0, 3), stall_dispatch_at=(2,),
    stall_s=0.75, corrupt_frame_uids=(5, 9), clock_jump_at_step=(1, 6),
    clock_jump_s=3.5, kill_replica_at=((2, 0), (2, 1), (4, 0)),
    kill_host_at=((3, 1),), lose_uplink_races=(0, 2),
    lose_downlink_races=(1,),
)


def _injector_trace(mod):
    inj = mod.ServiceFaultInjector(**_SCHEDULE)
    out = []
    for k in range(8):
        try:
            inj.check_stage()
            out.append(("stage", k, None))
        except Exception as e:       # the package's own WorkerFailure
            out.append(("stage", k, type(e).__name__, str(e)))
        out.append(("dispatch", k, inj.fails_dispatch(k),
                    inj.fails_dispatch(k)))
        out.append(("stall", k, inj.stall_for_dispatch(k),
                    inj.stall_for_dispatch(k)))
        out.append(("corrupt", k, inj.corrupts(k), inj.corrupts(k + 5)))
        out.append(("clock", k, inj.clock_jump_for_step(k),
                    inj.clock_jump_for_step(k)))
        out.append(("replica", k, inj.replicas_to_kill(k),
                    inj.replicas_to_kill(k)))
        out.append(("host", k, inj.hosts_to_kill(k), inj.hosts_to_kill(k)))
        out.append(("net", k, inj.loses_uplink(k), inj.loses_downlink(k),
                    inj.loses_uplink(k)))
    out.append(sorted(map(repr, inj._fired)))
    return out


def test_service_fault_injector_matches_reference():
    """Every trigger of the schedule fires once, at the same ordinals, in
    both packages; the fields are the reference's."""
    assert _injector_trace(faults) == _injector_trace(jfaults)
    assert ([f.name for f in dataclasses.fields(faults.ServiceFaultInjector)]
            == [f.name for f in
                dataclasses.fields(jfaults.ServiceFaultInjector)])


# --- the prefetch stager (the service's worker) ------------------------------


def _stager_death_trace(mod, failure):
    """Kill the worker at its second task: the fatal future and every
    queued one resolve with WorkerFailure, later stage() calls raise."""
    calls, release = [], threading.Event()

    def hook():
        calls.append(1)
        if len(calls) == 1:
            release.wait(TIMEOUT)     # hold the worker until all is queued
        if len(calls) == 2:
            raise failure("injected death")

    st = mod.PrefetchStager(fault_hook=hook)
    out = []
    try:
        futs = [st.stage(lambda x: x + 1, i) for i in range(4)]
        release.set()
        for f in futs:
            try:
                out.append(("ok", f.result(timeout=TIMEOUT)))
            except failure as e:
                out.append(("failed", str(e)))
        st._thread.join(timeout=TIMEOUT)
        out.append(("alive", st.alive, st._thread.is_alive()))
        try:
            st.stage(lambda: 0)
            out.append("accepted")
        except failure:
            out.append("refused")
    finally:
        st.close()
    return out


def test_stager_death_surfaces_like_the_reference():
    assert (_stager_death_trace(detection, supervisor.WorkerFailure)
            == _stager_death_trace(jdetection, jruntime.WorkerFailure)
            == [("ok", 1), ("failed", "injected death"),
                ("failed", "prefetch worker died before this task"),
                ("failed", "prefetch worker died before this task"),
                ("alive", False, False), "refused"])


def test_stager_task_error_keeps_the_worker_and_beats():
    clock, reg = _Clock(), {}
    st = detection.PrefetchStager(heartbeat_registry=reg, clock=clock,
                                  worker_id="w0")
    try:
        clock.t = 2.0
        bad = st.stage(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            bad.result(timeout=TIMEOUT)
        assert st.stage(lambda: 42).result(timeout=TIMEOUT) == 42
        assert st.alive and reg["w0"] == 2.0
        mon = heartbeat.HeartbeatMonitor(reg, timeout_s=1.0, clock=clock)
        assert mon.all_alive()
        clock.t = 5.0                  # silence past the liveness deadline
        assert mon.dead_workers() == ["w0"]
    finally:
        st.close()
    assert not st.alive and not st._thread.is_alive()


def test_abandoned_stager_fails_its_queue_and_refuses_work():
    """A hung worker declared dead: queued futures fail at once, stage()
    raises, and the thread exits once it wakes."""
    started, gate = threading.Event(), threading.Event()

    def hang():
        started.set()
        return gate.wait(TIMEOUT)

    st = detection.PrefetchStager()
    try:
        hung = st.stage(hang)
        assert started.wait(TIMEOUT)   # the worker holds the hung task
        queued = st.stage(lambda: 1)
        st.abandon()
        assert not st.alive
        with pytest.raises(supervisor.WorkerFailure):
            queued.result(timeout=TIMEOUT)
        with pytest.raises(supervisor.WorkerFailure):
            st.stage(lambda: 2)
        gate.set()
        assert hung.result(timeout=TIMEOUT) is True
    finally:
        st.close()
    assert not st._thread.is_alive()
