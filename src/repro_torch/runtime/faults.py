"""Deterministic fault injection for the detection service path
(``repro/runtime/faults.py``).

``supervisor.FaultInjector`` schedules step-indexed worker failures for
a step loop; this module is its serving-side twin: a one-shot, fully
deterministic schedule of the fault classes exercised against
:class:`repro_torch.serve.detection.DetectionService`:

  * **stager death** — the ``check_stage`` hook runs inside the
    ``PrefetchStager`` worker thread, once per staged task; at a
    scheduled ordinal it raises :class:`WorkerFailure`, killing the
    worker mid-stream (the stager surfaces the death to callers as an
    explicit error — never a silent hang — and the service restarts it).
  * **dispatch failure** — ``fails_dispatch(k)`` fires at scheduled
    dispatch ordinals; the service resolves the whole would-be batch to
    ``RequestStatus.FAILED`` instead of running the plan.
  * **dispatch stall** — ``stall_for_dispatch(k)`` returns extra seconds
    of modeled service time for scheduled dispatches; the batch
    completes late (the EMA never sees the stalled sample).
  * **corrupt frames** — ``corrupts(uid)`` marks request uids whose
    frames the service NaN-poisons at submit; the finiteness check at
    admission turns them into coast answers or ``INVALID_FRAME``.
  * **clock jumps** — ``clock_jump_for_step(k)`` returns seconds to jump
    the service's :class:`VirtualClock` forward before scheduled
    scheduler steps (a large jump expires a whole EDF wave at once).
  * **replica death** — ``replicas_to_kill(k)`` returns the replica
    indices scheduled to die before router step ``k`` of a sharded
    fleet (the reference's ``serve/fleet.py``, not ported yet); the router
    fails the dead replica's in-flight work, re-routes its queue to
    survivors, and drops its session pins (trackers die with the
    replica — failover is explicit, never silent).
  * **host death** — ``hosts_to_kill(k)`` is the same schedule one
    failure domain up: a host id whose *entire replica group* dies
    before router step ``k`` (``ShardedDetectionService.kill_host``
    marks the whole group dead first, then fails/re-routes, so no
    victim's queue can land on a dying same-host sibling).
  * **message loss** — ``loses_uplink(i)`` / ``loses_downlink(i)``
    force-drop the named leg of speculative race ``i`` (the race
    ordinal, 0-based).  The ``NetworkModel`` already loses messages
    probabilistically; these make the lost-uplink / lost-downlink
    harness arms *exact* instead of fishing for a lossy seed.

Every trigger fires exactly once (the ``_fired`` set), so an injected
fault can never livelock a bounded loop, and every schedule is a
plain tuple — the harness's fault matrix is reproducible bit-for-bit.
"""

from __future__ import annotations

import dataclasses

from .supervisor import WorkerFailure


@dataclasses.dataclass
class ServiceFaultInjector:
    """One-shot deterministic fault schedule for ``DetectionService``."""

    kill_stager_at: tuple[int, ...] = ()     # staged-task ordinals
    fail_dispatch_at: tuple[int, ...] = ()   # dispatch ordinals
    stall_dispatch_at: tuple[int, ...] = ()  # dispatch ordinals
    stall_s: float = 1.0                     # extra seconds per stall
    corrupt_frame_uids: tuple[int, ...] = () # request uids to NaN-poison
    clock_jump_at_step: tuple[int, ...] = () # scheduler-step ordinals
    clock_jump_s: float = 10.0               # forward jump per trigger
    # (router step, replica index) pairs: replica dies before that step
    kill_replica_at: tuple[tuple[int, int], ...] = ()
    # (router step, host id) pairs: the host's whole group dies
    kill_host_at: tuple[tuple[int, int], ...] = ()
    # speculative-race ordinals whose named leg is force-dropped
    lose_uplink_races: tuple[int, ...] = ()
    lose_downlink_races: tuple[int, ...] = ()
    _stage_calls: int = 0
    _fired: set = dataclasses.field(default_factory=set)

    def _once(self, kind: str, k: int, schedule: tuple[int, ...]) -> bool:
        if k in schedule and (kind, k) not in self._fired:
            self._fired.add((kind, k))
            return True
        return False

    # -- stager (called from the worker thread, one thread at a time) ----
    def check_stage(self) -> None:
        """Per-staged-task hook; raises ``WorkerFailure`` on schedule.

        The ordinal counts staged tasks across the service's lifetime —
        stager restarts do not reset it, so a schedule like ``(0, 5)``
        kills the restarted worker too.
        """
        k = self._stage_calls
        self._stage_calls += 1
        if self._once("stage", k, self.kill_stager_at):
            raise WorkerFailure(f"injected stager death at staged task {k}")

    # -- dispatch --------------------------------------------------------
    def fails_dispatch(self, k: int) -> bool:
        return self._once("dispatch", k, self.fail_dispatch_at)

    def stall_for_dispatch(self, k: int) -> float:
        """Extra modeled seconds for dispatch ``k`` (0.0 = no stall)."""
        if self._once("stall", k, self.stall_dispatch_at):
            return float(self.stall_s)
        return 0.0

    # -- frames ----------------------------------------------------------
    def corrupts(self, uid: int) -> bool:
        return self._once("corrupt", uid, self.corrupt_frame_uids)

    # -- clock -----------------------------------------------------------
    def clock_jump_for_step(self, k: int) -> float:
        """Seconds to jump the clock before scheduler step ``k``."""
        if self._once("clock", k, self.clock_jump_at_step):
            return float(self.clock_jump_s)
        return 0.0

    # -- replicas (fleet router) -----------------------------------------
    def replicas_to_kill(self, k: int) -> tuple[int, ...]:
        """Replica indices scheduled to die before router step ``k``
        (one-shot per (step, replica) pair, like every other trigger)."""
        out = []
        for step, replica in self.kill_replica_at:
            if step == k and self._once("replica", (k, replica),
                                        ((k, replica),)):
                out.append(replica)
        return tuple(out)

    # -- hosts (fleet front tier) ----------------------------------------
    def hosts_to_kill(self, k: int) -> tuple[int, ...]:
        """Host ids scheduled to die before router step ``k`` — a whole
        failure domain at once (one-shot per (step, host) pair)."""
        out = []
        for step, host in self.kill_host_at:
            if step == k and self._once("host", (k, host), ((k, host),)):
                out.append(host)
        return tuple(out)

    # -- network (speculative race legs) ---------------------------------
    def loses_uplink(self, race: int) -> bool:
        """Force-drop race ``race``'s request leg (one-shot)."""
        return self._once("uplink", race, self.lose_uplink_races)

    def loses_downlink(self, race: int) -> bool:
        """Force-drop race ``race``'s response leg (one-shot)."""
        return self._once("downlink", race, self.lose_downlink_races)
