"""Sharded detection fleet: multi-replica dispatch with session affinity
(``repro/serve/fleet.py``; the policy line for line).

The paper's premise is that one general-purpose core cannot meet AV
real-time requirements alone; ``DetectionService`` scaled the stack to
one device, this module scales it past one.  A
:class:`ShardedDetectionService` fronts N :class:`DetectionService`
replicas, each on its own device (``launch.mesh.replica_devices``: the
card unless the fleet is given ``device="cpu"``; on one H100 every
replica shares ``cuda:0`` and its current stream) with its own
:class:`~repro_torch.core.plan.PlanCache`, admission queues, service-time
EMAs, and session trackers:

  * **Replica-aware routing** — a sessionless request routes to the
    replica with the shortest projected completion horizon for its
    bucket (per-replica queue depth x per-replica per-bucket EMA — the
    same ``LoadController`` arithmetic each replica's admission police
    uses, so the router and the ladder agree about what "busy" means),
    ties broken by total queue depth then index.
  * **Session affinity** — sessions carry tracker state: a session
    request pins to the replica holding its tracker, because a tracker
    split across replicas is two half-blind trackers (each sees every
    other frame, coasts constantly, and births twin tracks).
    ``affinity=False`` disables pinning (the ablation arm);
    ``migrate_session`` moves the tracker + SLO + coast budget to
    another replica explicitly — affinity is a routing *invariant*, not
    a cage.
  * **Replica + host death, failover** — ``runtime.faults`` schedules
    ``kill_replica_at`` (step, replica) pairs: the dead replica's
    in-flight and slotted work fails explicitly (``FAILED`` — the
    batch died with the device), its queue re-routes to survivors with
    original deadlines preserved, and its session pins drop (the
    tracker died with it; the next frame re-pins wherever routing
    lands and rebuilds — the warm-start coast rule shortens the blind
    window).  Replicas group into *host* failure domains
    (``hosts=``); ``kill_host`` / ``kill_host_at`` kill a whole group
    at once, marked dead before any teardown so no victim's backlog
    lands on a dying same-host sibling.  Nothing hangs; every request
    still terminates.  A batch in flight on the card when its replica
    dies is dropped, not waited for: its kernels finish on the stream,
    and the caching allocators reuse its device and pinned host memory
    only after them, in stream order.
  * **Elastic scale-up** — ``add_replica`` grows the fleet at runtime
    (on the fleet's kind of device): the newcomer joins with a warmed
    service-time estimator and pinned sessions above the post-growth
    fair share migrate onto it via ``migrate_session`` (the scale-up
    dual of the death path; one tracker per session throughout).
  * **Speculative local/remote offload** (Schafhalter et al.,
    PAPERS.md; policy in ``core.offload``, link model in
    ``core.network``) — ``submit_speculative`` races a fast low-res
    *local* pass (forced downshift, preferring a different host than
    the remote: the deadline guarantee) against a full-res *remote*
    pass on a designated replica.  With
    ``SpeculativeConfig.network`` the link is honest: a seeded
    lognormal *uplink* delays the remote's start (lost uplink — the
    remote never runs), a seeded *downlink* delays the response (lost
    downlink — no upgrade), and a race whose remote is still pending
    at the deadline resolves to the local answer with
    ``timed_out=True``.  Without it, the compatibility path charges
    ``rtt_s`` once on the response.  On the shared
    :class:`VirtualClock` the race is a pure function of
    (schedule, seed) — deterministic to test, like every policy here.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.network import Delivery, NetworkModel, force_lost
from repro_torch.core.offload import (
    RaceDecision, SpeculativeConfig, decide_race,
)
from repro_torch.core.plan import PipelineConfig
from repro_torch.core.tracking import Track
from repro_torch.launch.mesh import replica_devices
from repro_torch.serve.detection import (
    SHED_ONLY, DegradationPolicy, DetectionRequest, DetectionService,
    RequestStatus, SessionSLO,
)


@dataclasses.dataclass
class _Replica:
    index: int
    service: DetectionService
    alive: bool = True
    host: int = 0               # failure domain (host death kills the group)


@dataclasses.dataclass
class SpeculativeTicket:
    """One speculative race in flight: the caller's request plus its two
    racing clones (resolved by ``resolve_speculative`` / ``run``).

    Under the honest network (``SpeculativeConfig.network``) both legs
    are sampled at race creation — ``uplink``/``downlink`` — so the
    race's fate is fixed at submit regardless of when it resolves.  The
    remote clone is *not* submitted until the uplink lands
    (``remote_submit_at``, ``inf`` for a lost uplink — the remote pass
    then never runs and the race resolves by timeout)."""
    request: DetectionRequest
    local: DetectionRequest
    remote: DetectionRequest
    decision: Optional[RaceDecision] = None
    uplink: Optional[Delivery] = None
    downlink: Optional[Delivery] = None
    remote_submit_at: Optional[float] = None
    remote_submitted: bool = True   # compat path submits immediately
    created_at: float = 0.0
    race_idx: int = 0

    @property
    def resolved(self) -> bool:
        return self.decision is not None


class ShardedDetectionService:
    """N ``DetectionService`` replicas behind one routing front.

    Every replica keeps the full single-device contract (bounded
    admission, priority-major/EDF, degradation ladder, fault injection,
    session streaming); this class only decides *which* replica each
    request reaches — and proves the decisions (affinity, failover, the
    speculative race) deterministically on the shared clock.

    ``devices`` defaults to ``launch.mesh.replica_devices(n_replicas,
    device)``: by the port's device rule the card (``device=None``;
    one card per replica when the host has them, cycling otherwise, so
    on one H100 every replica shares ``cuda:0``), or the CPU with
    ``device="cpu"``; there is no fallback, so a fleet asked for the
    card on a host without one raises.
    ``faults`` here is the *router's* injector (``kill_replica_at``);
    per-replica service faults belong to the replicas' own injectors.
    """

    def __init__(self, cfg: PipelineConfig = PipelineConfig(), *,
                 n_replicas: int = 2,
                 devices: Optional[Sequence] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 affinity: bool = True,
                 speculative: Optional[SpeculativeConfig] = None,
                 remote_replica: Optional[int] = None,
                 hosts: Optional[Sequence[int]] = None,
                 faults: Optional[object] = None,
                 device: Optional[object] = None,
                 **svc_kw):
        assert n_replicas >= 1
        if devices is None:
            devices = replica_devices(n_replicas, device)
        assert len(devices) == n_replicas, (len(devices), n_replicas)
        if hosts is None:
            # default: every replica its own failure domain (replica
            # death IS host death)
            hosts = tuple(range(n_replicas))
        assert len(hosts) == n_replicas, (len(hosts), n_replicas)
        self.cfg = cfg
        self.clock = clock
        self.affinity = affinity
        self.speculative = speculative
        self.remote_replica = (
            remote_replica if remote_replica is not None else n_replicas - 1
        )
        self.faults = faults
        self._svc_kw = dict(svc_kw)
        self.network = (
            NetworkModel(speculative.network)
            if speculative is not None and speculative.network is not None
            else None
        )
        self.replicas = [
            _Replica(i, DetectionService(
                cfg, clock=clock, device=devices[i], **svc_kw,
            ), host=hosts[i])
            for i in range(n_replicas)
        ]
        self._session_replica: dict[str, int] = {}
        self._tickets: list[SpeculativeTicket] = []
        self._steps = 0
        # routing + failover + race counters
        self.routed = 0
        self.session_migrations = 0    # saturated pins moved explicitly
        self.session_failovers = 0     # pins dropped by a replica death
        self.requeued = 0              # queued work re-routed off a corpse
        self.failed_on_death = 0       # in-flight/slotted work that died
        self.speculative_races = 0
        self.speculative_upgrades = 0
        self.speculative_timeouts = 0  # races resolved with remote pending
        self.uplink_lost_total = 0
        self.downlink_lost_total = 0
        self.scale_up_migrations = 0   # sessions rebalanced by add_replica
        self.host_kills = 0

    # --- introspection --------------------------------------------------
    @property
    def alive_replicas(self) -> list[_Replica]:
        return [r for r in self.replicas if r.alive]

    @property
    def dispatches(self) -> int:
        return sum(r.service.dispatches for r in self.replicas)

    @property
    def gated_dispatches(self) -> int:
        return sum(r.service.gated_dispatches for r in self.replicas)

    def session_location(self, session_id: str) -> Optional[int]:
        """Replica index the session is pinned to (None if unpinned)."""
        return self._session_replica.get(session_id)

    def session_tracks(self, session_id: str) -> list[Track]:
        i = self._session_replica.get(session_id)
        if i is not None:
            return self.replicas[i].service.session_tracks(session_id)
        for r in self.replicas:
            ts = r.service.session_tracks(session_id)
            if ts:
                return ts
        return []

    def session_slo(self, session_id: str) -> SessionSLO:
        """Aggregated SLO across every replica the session touched
        (affinity keeps that to one; the ablation arm and failover
        don't)."""
        total = SessionSLO()
        for r in self.replicas:
            s = r.service.slo.get(session_id)
            if s is None:
                continue
            for f in dataclasses.fields(SessionSLO):
                setattr(total, f.name,
                        getattr(total, f.name) + getattr(s, f.name))
        return total

    # --- routing --------------------------------------------------------
    def _route_cost(self, rep: _Replica, shape: tuple[int, int]
                    ) -> tuple[float, int, int]:
        svc = rep.service
        grid = svc.grids[shape]
        ahead = grid.active + len(svc.queues[shape])
        horizon = svc.load_controller.horizon_s(shape, ahead)
        return (horizon, svc.queued, rep.index)

    @staticmethod
    def _busy_extra_s(rep: _Replica, shape: tuple[int, int]) -> float:
        """Seconds the device is still occupied by a batch already in
        flight — the wave arithmetic counts queued + slotted work but
        forgets the batch computing right now, which delays everything
        behind it by up to one service time."""
        svc = rep.service
        grid = svc.grids[shape]
        if grid.in_flight is None:
            return 0.0
        return svc.load_controller.est_s(shape)

    def _route(self, req: DetectionRequest) -> int:
        """Pick a replica: affinity pin first, else the shortest
        projected completion horizon for the request's bucket."""
        alive = self.alive_replicas
        if not alive:
            raise RuntimeError("no live replicas")
        sid = req.session_id
        if sid is not None and self.affinity:
            pinned = self._session_replica.get(sid)
            if pinned is not None:
                if self.replicas[pinned].alive:
                    target = self._maybe_migrate(req, pinned)
                    return pinned if target is None else target
                # the pinned replica died: the tracker is gone, so the
                # stream re-pins wherever routing sends it (explicitly
                # accounted — a failover, not silent drift)
                del self._session_replica[sid]
                self.session_failovers += 1
        shape = alive[0].service.bucket_for(req.frame)
        best = min(alive, key=lambda r: self._route_cost(r, shape))
        if sid is not None and self.affinity:
            self._session_replica[sid] = best.index
        return best.index

    def _maybe_migrate(self, req: DetectionRequest,
                       pinned: int) -> Optional[int]:
        """Explicit migration escape hatch for a saturated pin.

        Affinity is an invariant about *where the tracker lives*, not a
        cage: when the pinned replica's measured backlog makes this
        request's deadline infeasible and another replica could still
        meet it, the SESSION moves there — tracker, SLO, coast budget —
        via :meth:`migrate_session`, so the stream stays whole on the
        new replica instead of missing deadlines on the old one.
        Returns the new replica index, or None (keep the pin).
        """
        if req.deadline_s is None:
            return None
        svc = self.replicas[pinned].service
        shape = svc.bucket_for(req.frame)
        now = self.clock()
        deadline_at = now + req.deadline_s
        grid = svc.grids[shape]
        ahead = grid.active + len(svc.queues[shape])
        # the in-flight batch holds the device for up to one more
        # service time before anything queued can start: charge it
        # against the deadline on both sides of the comparison
        if svc.load_controller.feasible(
                shape,
                deadline_at - self._busy_extra_s(self.replicas[pinned],
                                                 shape),
                now, ahead):
            return None
        best = min(self.alive_replicas,
                   key=lambda r: self._route_cost(r, shape))
        if best.index == pinned:
            return None
        b = best.service
        b_ahead = (b.grids[shape].active + len(b.queues[shape]))
        if not b.load_controller.feasible(
                shape,
                deadline_at - self._busy_extra_s(best, shape),
                now, b_ahead):
            return None             # nowhere better: the ladder's problem
        self.migrate_session(req.session_id, best.index)
        self.session_migrations += 1
        return best.index

    def submit(self, req: DetectionRequest) -> RequestStatus:
        status = self.replicas[self._route(req)].service.submit(req)
        self.routed += 1
        return status

    def migrate_session(self, session_id: str, to_replica: int) -> bool:
        """Explicitly move a session's tracker + SLO + coast budget to
        ``to_replica`` (the sanctioned way to rebalance a pinned stream;
        returns False if the session has no state anywhere or the target
        is dead).  The tracker object moves — stream continuity (track
        ids, hit counts, the warm-start grounding) survives the hop."""
        if not self.replicas[to_replica].alive:
            return False
        src = self._session_replica.get(session_id)
        if src is None:
            src = next(
                (r.index for r in self.replicas
                 if session_id in r.service.sessions), None,
            )
        if src is None:
            return False
        if src != to_replica:
            s_svc = self.replicas[src].service
            d_svc = self.replicas[to_replica].service
            tracker = s_svc.sessions.pop(session_id, None)
            if tracker is not None:
                d_svc.sessions[session_id] = tracker
            slo = s_svc.slo.pop(session_id, None)
            if slo is not None:
                # merge, not overwrite: the target may have history from
                # a pre-affinity or failover era
                d = d_svc._slo(session_id)
                for f in dataclasses.fields(SessionSLO):
                    setattr(d, f.name,
                            getattr(d, f.name) + getattr(slo, f.name))
            coasts = s_svc._session_coasts.pop(session_id, None)
            if coasts is not None:
                d_svc._session_coasts[session_id] = coasts
        self._session_replica[session_id] = to_replica
        return True

    # --- replica/host death + failover ----------------------------------
    def kill_replica(self, index: int) -> None:
        """Kill one replica: in-flight and slotted work dies with the
        device (``FAILED``), queued work re-routes to survivors with its
        original deadlines, session pins drop (trackers are gone)."""
        self._kill_replicas((index,))

    def kill_host(self, host: int) -> None:
        """Kill a whole failure domain: every live replica with this
        ``host`` id dies at once.  The group is marked dead *before* any
        teardown, so no victim's queue can re-route onto a dying sibling
        on the same host — survivors on other hosts absorb the re-routed
        work with its original deadlines."""
        victims = tuple(
            r.index for r in self.replicas if r.alive and r.host == host
        )
        if not victims:
            return
        self.host_kills += 1
        self._kill_replicas(victims)

    def _kill_replicas(self, indices: Sequence[int]) -> None:
        """Shared death path: mark every victim dead FIRST (so
        ``_resubmit`` routing only sees true survivors), then tear each
        down, then re-route the merged queue backlog in arrival order."""
        dead: list[_Replica] = []
        for i in indices:
            rep = self.replicas[i]
            if rep.alive:
                rep.alive = False
                dead.append(rep)
        if not dead:
            return
        requeue: list[DetectionRequest] = []
        for rep in dead:
            requeue += self._teardown_replica(rep)
        gone = {rep.index for rep in dead}
        survivors = {
            s: r for s, r in self._session_replica.items() if r not in gone
        }
        self.session_failovers += (
            len(self._session_replica) - len(survivors)
        )
        self._session_replica = survivors
        # re-route in arrival order (the seq was part of the heap key)
        for req in sorted(requeue, key=lambda r: r.submitted_at):
            self._resubmit(req)

    def _teardown_replica(self, rep: _Replica) -> list[DetectionRequest]:
        """Fail a dead replica's in-flight/slotted work and return its
        queued backlog for re-routing (caller owns the resubmit)."""
        svc = rep.service
        now = svc.clock()
        victims: list[DetectionRequest] = []
        for g in svc.grids.values():
            if g.in_flight is not None:
                victims += [r for r in g.in_flight[0] if r is not None]
                g.in_flight = None
            victims += [r for r in g.slots if r is not None]
            g.slots = [None] * len(g.slots)
            g.staged = np.zeros_like(g.staged)
        for r in victims:
            if not r.is_terminal:
                svc._refuse(r, RequestStatus.FAILED, now)
                self.failed_on_death += 1
        requeue: list[DetectionRequest] = []
        for q in svc.queues.values():
            requeue += [entry[3] for entry in q]
            q.clear()
        svc.close()
        return requeue

    # --- elastic scale-up ------------------------------------------------
    def add_replica(self, *, device=None, host: Optional[int] = None
                    ) -> int:
        """Grow the fleet by one replica and rebalance pinned sessions
        onto it (the scale-up dual of ``kill_replica`` — until now only
        death was handled).

        The newcomer gets the next device of the fleet's kind (the card,
        or the CPU for a fleet built on it: growth never changes the
        kind) and its own fresh failure domain by default.  Its
        per-bucket service-time estimator is warmed from a live
        veteran — routing is
        horizon-based, and a cold EMA would make the newcomer look
        infinitely fast and swallow the whole fleet's traffic.  Pinned
        sessions above the post-growth fair share migrate over via
        :meth:`migrate_session` (tracker + SLO + coast budget move
        atomically, counted in ``scale_up_migrations``), so the
        one-tracker-per-session invariant survives the rebalance.
        Returns the new replica's index."""
        n_new = len(self.replicas) + 1
        if device is None:
            kind = self.replicas[0].service.device.type
            device = replica_devices(n_new, kind)[n_new - 1]
        if host is None:
            host = max(r.host for r in self.replicas) + 1
        svc = DetectionService(
            self.cfg, clock=self.clock, device=device, **self._svc_kw,
        )
        rep = _Replica(len(self.replicas), svc, host=host)
        donor = next((r for r in self.replicas if r.alive), None)
        if donor is not None:
            for shape, g in svc.grids.items():
                dg = donor.service.grids.get(shape)
                if dg is not None:
                    g.est_s = dg.est_s
                    g.est_measured = dg.est_measured
        self.replicas.append(rep)
        self._rebalance_onto(rep)
        return rep.index

    def _rebalance_onto(self, rep: _Replica) -> None:
        """Drain pins above the post-growth fair share into replicas
        below it, the newcomer first (deterministic: donors, sessions,
        and receivers all visit in sorted order)."""
        if not self.affinity or not self._session_replica:
            return
        alive = self.alive_replicas
        fair = math.ceil(len(self._session_replica) / len(alive))
        counts = {r.index: 0 for r in alive}
        by_rep: dict[int, list[str]] = {}
        for sid in sorted(self._session_replica):
            idx = self._session_replica[sid]
            by_rep.setdefault(idx, []).append(sid)
            counts[idx] = counts.get(idx, 0) + 1
        for idx in sorted(by_rep):
            sids = by_rep[idx]
            k = 0
            while counts[idx] > fair and k < len(sids):
                sid = sids[k]
                k += 1
                recv = min(
                    (r for r in alive if counts[r.index] < fair),
                    key=lambda r: (r.index != rep.index,
                                   counts[r.index], r.index),
                    default=None,
                )
                if recv is None:
                    return
                if self.migrate_session(sid, recv.index):
                    counts[idx] -= 1
                    counts[recv.index] += 1
                    self.scale_up_migrations += 1

    def _resubmit(self, req: DetectionRequest) -> None:
        """Re-route one queued request off a dead replica, preserving
        its original submit stamp and ABSOLUTE deadline (the failover
        must not hand it a fresh budget)."""
        sub, dl = req.submitted_at, req.deadline_at
        req._staged = None
        req._ds_shape = None
        req.downshift = 1
        req.bucket = None
        try:
            target = self._route(req)
        except RuntimeError:
            req.status = RequestStatus.FAILED
            req.finished_at = sub
            return
        svc = self.replicas[target].service
        svc.submit(req)
        req.submitted_at, req.deadline_at = sub, dl
        if req.session_id is not None:
            # submit() charged the stream a second arrival; the frame
            # was offered once — undo the double count
            svc._slo(req.session_id).submitted -= 1
        self.requeued += 1

    # --- speculative offload (local/remote race) ------------------------
    def submit_speculative(self, req: DetectionRequest
                           ) -> SpeculativeTicket:
        """Race a low-res local pass against a full-res remote pass.

        The *local* clone force-downshifts into
        ``SpeculativeConfig.local_shape`` (default: the smallest
        registered bucket) on the best non-remote replica — small enough
        that its answer always lands inside the deadline (the
        guarantee), preferring a replica on a *different host* than the
        remote so one host death cannot take both racers.  The *remote*
        clone runs full-res, shed-only (a degraded remote answer is
        pointless: the local tier already covers degraded) on the
        designated remote replica.

        With ``SpeculativeConfig.network`` set both legs are sampled
        here: the remote clone is submitted only when the uplink *lands*
        (a lost uplink means it never runs — the sender cannot observe
        the loss, so the race resolves through the deadline timeout),
        and the sampled downlink is charged on the response.  Without a
        network config (the compatibility path) the remote is submitted
        immediately and ``rtt_s`` is charged once on the response.
        ``run`` (or an explicit ``resolve_speculative``) applies
        :func:`repro_torch.core.offload.decide_race` and stamps the winner
        onto ``req``.  Clones are sessionless by construction — a
        tracker must see ONE stream, not a race's two interleaved
        copies.
        """
        if self.speculative is None:
            raise ValueError("no SpeculativeConfig on this service")
        spec = self.speculative
        alive = self.alive_replicas
        if not alive:
            raise RuntimeError("no live replicas")
        remote_rep = self.replicas[self.remote_replica]
        locals_ = [r for r in alive if r.index != self.remote_replica]
        cross_host = [r for r in locals_ if r.host != remote_rep.host]
        if cross_host:
            locals_ = cross_host
        local_rep = locals_[0] if locals_ else alive[0]
        if len(locals_) > 1:
            shape = local_rep.service.bucket_for(req.frame)
            local_rep = min(
                locals_, key=lambda r: self._route_cost(r, shape),
            )
        buckets = local_rep.service.buckets
        local_shape = spec.local_shape or buckets[0]
        local = DetectionRequest(
            uid=req.uid, frame=req.frame, deadline_s=req.deadline_s,
            priority=req.priority, render_output=req.render_output,
            policy=DegradationPolicy(allow_coast=False),
        )
        remote = DetectionRequest(
            uid=req.uid, frame=req.frame, deadline_s=req.deadline_s,
            priority=req.priority, render_output=req.render_output,
            policy=SHED_ONLY,
        )
        now = self.clock()
        race_idx = self.speculative_races
        ticket = SpeculativeTicket(req, local, remote,
                                   created_at=now, race_idx=race_idx)
        local_rep.service.submit(local, force_bucket=local_shape)
        if self.network is None:
            # compatibility path: free uplink, remote starts immediately
            if remote_rep.alive:
                remote_rep.service.submit(remote)
            else:
                remote.status = RequestStatus.FAILED
                remote.finished_at = now
        else:
            up, down = self.network.uplink(), self.network.downlink()
            if self.faults is not None:
                if getattr(self.faults, "loses_uplink",
                           lambda i: False)(race_idx):
                    up = force_lost(up)
                if getattr(self.faults, "loses_downlink",
                           lambda i: False)(race_idx):
                    down = force_lost(down)
            self.uplink_lost_total += up.lost
            self.downlink_lost_total += down.lost
            ticket.uplink, ticket.downlink = up, down
            ticket.remote_submit_at = up.arrives_at(now)
            ticket.remote_submitted = False
            if ticket.remote_submit_at <= now:
                self._submit_remote(ticket)
        self._tickets.append(ticket)
        self.speculative_races += 1
        return ticket

    def _submit_remote(self, ticket: SpeculativeTicket) -> None:
        """The uplink landed: submit the remote clone (or fail it if the
        remote replica died while the request was in flight).  The clone
        keeps the race's ORIGINAL absolute deadline — the uplink delay
        must not hand the remote pass a fresh budget."""
        ticket.remote_submitted = True
        rep = self.replicas[self.remote_replica]
        if not rep.alive:
            ticket.remote.status = RequestStatus.FAILED
            ticket.remote.finished_at = self.clock()
            return
        rep.service.submit(ticket.remote)
        if ticket.local.deadline_at is not None:
            ticket.remote.deadline_at = ticket.local.deadline_at

    def _pump_speculative(self) -> None:
        """Submit every deferred remote clone whose uplink has landed
        (no-op on the compat path — remotes submit at race creation)."""
        if self.network is None:
            return
        now = self.clock()
        for t in self._tickets:
            if (not t.resolved and not t.remote_submitted
                    and t.remote_submit_at is not None
                    and t.remote_submit_at <= now):
                self._submit_remote(t)

    def _race_timeout_at(self, ticket: SpeculativeTicket
                         ) -> Optional[float]:
        """When this race gives up on a still-pending remote: the
        request's own absolute deadline (past it the remote cannot win
        anyway), else ``created_at + race_timeout_s`` for deadline-less
        races, else None (no timeout configured)."""
        if ticket.local.deadline_at is not None:
            return ticket.local.deadline_at
        if self.speculative.race_timeout_s is not None:
            return ticket.created_at + self.speculative.race_timeout_s
        return None

    def resolve_speculative(self, ticket: SpeculativeTicket
                            ) -> Optional[RaceDecision]:
        """Apply the race policy and stamp the winning answer onto the
        caller's request.  Resolves when both clones are terminal — or,
        with the remote still pending (never submitted, lost response,
        stalled dispatch), once the race's timeout passes: the local
        answer then wins with ``timed_out=True`` (the unresolvable-race
        fix — a dead network must never leave the caller without the
        answer the local tier guaranteed).  Returns None while the race
        is genuinely still open."""
        if ticket.resolved:
            return ticket.decision
        self._pump_speculative()
        local, remote, req = ticket.local, ticket.remote, ticket.request
        if not local.is_terminal:
            return None
        remote_pending = not (ticket.remote_submitted
                              and remote.is_terminal)
        if remote_pending:
            timeout_at = self._race_timeout_at(ticket)
            if timeout_at is None or self.clock() < timeout_at:
                return None
            decision = decide_race(
                local.finished_at, None, local.deadline_at,
                rtt_s=self.speculative.rtt_s, timed_out=True,
            )
            self.speculative_timeouts += 1
        else:
            downlink_s = None
            if ticket.downlink is not None:
                downlink_s = (math.inf if ticket.downlink.lost
                              else ticket.downlink.delay_s)
            decision = decide_race(
                local.finished_at,
                remote.finished_at if remote.ok else None,
                local.deadline_at,
                rtt_s=self.speculative.rtt_s,
                downlink_s=downlink_s,
            )
        win = remote if decision.upgraded else local
        req.result = win.result
        req.status = win.status
        req.bucket = win.bucket
        req.downshift = win.downshift
        req.submitted_at = local.submitted_at
        req.deadline_at = local.deadline_at
        req.finished_at = (
            decision.remote_ready_at if decision.upgraded
            else local.finished_at
        )
        if decision.upgraded:
            self.speculative_upgrades += 1
        ticket.decision = decision
        return decision

    # --- scheduling -----------------------------------------------------
    def step(self, *, flush: bool = False) -> bool:
        """One router step: injected replica/host deaths fire first,
        then deferred speculative remotes whose uplink has landed are
        submitted, then every live replica takes one scheduler step.
        Returns True while any replica still has work."""
        k = self._steps
        self._steps += 1
        if self.faults is not None:
            for victim in self.faults.replicas_to_kill(k):
                self.kill_replica(victim)
            hosts = getattr(self.faults, "hosts_to_kill", None)
            if hosts is not None:
                for host in hosts(k):
                    self.kill_host(host)
        self._pump_speculative()
        busy = False
        for rep in self.replicas:
            if rep.alive:
                busy = rep.service.step(flush=flush) or busy
        return busy

    def _drain(self, max_steps: int) -> None:
        while max_steps > 0:
            busy = self.step(flush=True)
            pending = any(
                g.active or g.in_flight is not None
                for rep in self.alive_replicas
                for g in rep.service.grids.values()
            )
            queued = any(r.service.queued for r in self.alive_replicas)
            if not busy and not pending and not queued:
                break
            max_steps -= 1

    def run(self, max_steps: int = 10_000) -> None:
        """Drive every replica until the fleet drains, then resolve the
        speculative tickets.  A ticket that cannot resolve yet because
        its clock hasn't reached a known event — a deferred remote's
        uplink arrival, a race's timeout — advances a jumpable clock
        (``VirtualClock.jump_to``) to the next such event and re-drains,
        so every race with a timeout resolves; only a deadline-less race
        with no ``race_timeout_s`` and a dead remote leg stays open
        (there is nothing to wait for — the config opted out)."""
        guard = 4 * len(self._tickets) + 4
        while True:
            self._drain(max_steps)
            for t in self._tickets:
                self.resolve_speculative(t)
            open_ = [t for t in self._tickets if not t.resolved]
            jump = getattr(self.clock, "jump_to", None)
            if not open_ or jump is None or guard <= 0:
                break
            now = self.clock()
            events = []
            for t in open_:
                if (not t.remote_submitted
                        and t.remote_submit_at is not None
                        and math.isfinite(t.remote_submit_at)):
                    events.append(t.remote_submit_at)
                timeout_at = self._race_timeout_at(t)
                if timeout_at is not None and math.isfinite(timeout_at):
                    events.append(timeout_at)
            events = [e for e in events if e > now]
            if not events:
                break
            jump(min(events))
            guard -= 1

    def close(self) -> None:
        for rep in self.replicas:
            rep.service.close()

    def __enter__(self) -> "ShardedDetectionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
