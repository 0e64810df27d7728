"""Heterogeneous placement planning and the speculative local/remote race
(``repro/core/offload.py``), in the card's terms.

The paper decides *which stages go to the accelerator* by profiling and by
an implicit cost model: offload pays only if

    t_core(stage) > t_accel(stage) + t_transfer(operands)

On the paper's platform t_transfer is real (RoCC + scratchpad mvin/mvout)
and the Hough stage's serial dependencies make t_accel ~ t_core, so only
Canny's GEMMs move.  On an H100 the "accelerator" is the **tensor cores**
and the "core" the **CUDA cores** (the SMs' f32 FMA pipes); both read the
same registers and shared memory inside one kernel, so t_transfer ~ 0 and
the rule reduces to: *GEMM-expressible and faster there -> tensor cores;
element-wise / control / memory-bound -> CUDA cores; host only for I/O*.
The units map onto the JAX package's: ``"tensor_cores"`` for its
``"mxu"``, ``"cuda_cores"`` for its ``"vpu"``, ``"host"`` as before.  The
rule is the reference's, comparison and strict ``<`` alike; only the
constants are the card's (below).

**Speculative local/remote offload** (Schafhalter et al., "Leveraging
Cloud Computing to Make Autonomous Vehicles Safer", PAPERS.md): the same
offload calculus one tier up, between the vehicle and a remote replica
across a network.  A fast low-res *local* pass guarantees the deadline; a
high-res *remote* pass races it across the network and upgrades the
answer when it wins.  :class:`SpeculativeConfig` + :func:`decide_race`
are the pure deterministic policy — completion times in, winner out, no
clock or RNG — so the serving layer
(:meth:`repro_torch.serve.fleet.ShardedDetectionService.submit_speculative`)
and its tests model the race exactly on a ``VirtualClock``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

from .network import NetworkConfig
from .profiling import StageCost

# Published peaks of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power
# limit (NVIDIA's data sheet, dense rates), the figures chip_smoke.py's
# bounds use.
HBM_BYTES_PER_S = 3.35e12            # device memory
F32_CUDA_CORE_FLOPS_PER_S = 67e12    # f32 outside the tensor cores
BF16_TENSOR_CORE_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores


@dataclasses.dataclass(frozen=True)
class Placement:
    stage: str
    unit: str        # "tensor_cores" | "cuda_cores" | "host"
    reason: str
    est_time_s: float


def place(stage: StageCost, *, transfer_bytes: float = 0.0,
          link_bw: float = HBM_BYTES_PER_S) -> Placement:
    """Place one stage: the paper's rule with the card's constants."""
    t_transfer = transfer_bytes / link_bw
    t_tensor = stage.flops * stage.matmul_fraction / (
        BF16_TENSOR_CORE_FLOPS_PER_S) + (
        stage.flops * (1 - stage.matmul_fraction) / F32_CUDA_CORE_FLOPS_PER_S
    )
    t_mem = stage.bytes_moved / HBM_BYTES_PER_S
    t_cuda = max(stage.flops / F32_CUDA_CORE_FLOPS_PER_S, t_mem)

    if stage.matmul_fraction >= 0.5:
        t_accel = max(t_tensor, t_mem) + t_transfer
        if t_accel < t_cuda:
            return Placement(
                stage.name, "tensor_cores",
                f"GEMM-dominant (AI={stage.arithmetic_intensity:.1f}); "
                f"t_tensor={t_accel:.2e}s < t_cuda={t_cuda:.2e}s", t_accel,
            )
    return Placement(
        stage.name, "cuda_cores",
        "element-wise/control- or memory-bound; the tensor cores gain "
        "nothing (the paper's Hough-on-core decision)", t_cuda,
    )


def plan(stages: Iterable[StageCost]) -> list[Placement]:
    return [place(s) for s in stages]


def plan_line_detection(H: int, W: int, *, fused: bool = False
                        ) -> list[Placement]:
    from .profiling import line_detection_costs

    return plan(line_detection_costs(H, W, fused=fused))


# --- speculative local/remote offload (Schafhalter et al.) ------------------

@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Modeled network for the local/remote race.

    Two modes:

    * ``network`` set (:class:`repro_torch.core.network.NetworkConfig`):
      the honest model.  The uplink leg is charged *before* the remote
      replica's submit (the remote pass cannot start until the request
      lands), the downlink leg on the response, each independently
      jittered and droppable; ``rtt_s`` is ignored.
    * ``network=None`` (the compatibility path): ``rtt_s`` is the full
      round trip charged **once, on the response** — the uplink is *not*
      modeled and the remote clone is submitted with zero delay, so
      remote starts are optimistic by one uplink.  Kept so the fixed-rtt
      race gates stay meaningful; new call sites should pass a
      ``network``.

    Either way "remote wins" means the *upgraded answer is in the
    vehicle's hands* before the deadline — not merely computed
    somewhere.  ``local_shape`` is the low-res bucket the guaranteed
    local pass runs at (None = the service's smallest bucket).

    ``race_timeout_s`` bounds deadline-less races: a race whose remote
    is still pending ``race_timeout_s`` after submit resolves to the
    local answer with ``timed_out=True``.  Deadlined races need no
    extra knob — their own ``deadline_at`` is the timeout (past it the
    remote can no longer upgrade, so waiting longer is pointless)."""
    rtt_s: float = 0.03
    local_shape: Optional[tuple[int, int]] = None
    network: Optional["NetworkConfig"] = None
    race_timeout_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class RaceDecision:
    """Deterministic outcome of one speculative race (pure data)."""
    local_done_at: float        # when the local low-res answer landed
    remote_ready_at: float      # remote completion + downlink delay
    deadline_at: Optional[float]
    upgraded: bool              # remote answer replaces the local one
    local_met_deadline: bool    # the guarantee the local tier exists for
    timed_out: bool = False     # resolved by timeout, remote still pending

    @property
    def winner(self) -> str:
        return "remote" if self.upgraded else "local"


def decide_race(local_done_at: float, remote_done_at: Optional[float],
                deadline_at: Optional[float], *, rtt_s: float,
                downlink_s: Optional[float] = None,
                timed_out: bool = False) -> RaceDecision:
    """Pick the answer of one local/remote speculative race.

    The local pass is authoritative by default — it is the deadline
    guarantee.  The remote high-res answer upgrades it iff the remote
    replica actually completed (``remote_done_at`` not None: a shed,
    refused, or dead-replica remote pass never upgrades anything) and
    its answer, after the response leg, is in hand by the deadline.
    The response leg is ``downlink_s`` when given (the honest
    ``NetworkModel`` path: one sampled downlink, ``math.inf`` for a
    lost one — a lost response never upgrades), else the compat
    ``rtt_s`` (the whole round trip charged here, uplink unmodeled).
    With no deadline a *delivered* remote answer always upgrades once
    complete — there is nothing to race.  ``timed_out`` is a
    passthrough stamp: the caller resolved this race by timeout with
    the remote still pending (a timeout can never flip a correct
    upgrade — past the deadline the remote cannot win anyway).
    """
    leg = rtt_s if downlink_s is None else downlink_s
    remote_ready = (math.inf if remote_done_at is None
                    else remote_done_at + leg)
    upgraded = remote_ready <= (
        deadline_at if deadline_at is not None else math.inf
    ) if remote_done_at is not None else False
    if remote_done_at is not None and deadline_at is None:
        upgraded = math.isfinite(remote_ready)
    return RaceDecision(
        local_done_at=local_done_at,
        remote_ready_at=remote_ready,
        deadline_at=deadline_at,
        upgraded=upgraded,
        local_met_deadline=(deadline_at is None
                            or local_done_at <= deadline_at),
        timed_out=timed_out,
    )
