"""Deterministic seeded network model for the cross-host fleet tier
(``repro/core/network.py``, line for line).

Schafhalter et al. ("Leveraging Cloud Computing to Make Autonomous
Vehicles Safer", PAPERS.md) measure real cellular links between a
vehicle and a remote datacenter: round-trip latency is heavy-tailed
(lognormal-shaped LTE/5G distributions with medians in the tens of
milliseconds and a long tail past the deadline), messages are *lost*,
and the uplink leg — shipping the full-resolution frame up — is as real
as the downlink that returns the answer.  A single fixed ``rtt_s``
charged once on the response (``SpeculativeConfig``'s compatibility
path) can delay an upgrade but can never hurt; this module models the
link honestly:

  * **Two independent legs** — every race sends a request *uplink*
    (the remote replica cannot start before it lands) and a response
    *downlink* (the upgrade is not in hand before it lands).  The RTT
    budget splits ``uplink_fraction`` / ``1 - uplink_fraction``.
  * **Lognormal jitter** — each leg's delay is
    ``median * exp(jitter_sigma * z)`` with ``z ~ N(0, 1)``: the
    multiplicative lognormal form Schafhalter et al. fit to measured
    cellular RTTs (median-parameterized, so ``jitter_sigma=0`` recovers
    the fixed-delay model *bit-exactly*).
  * **Per-message loss** — each leg is independently lost with
    probability ``loss``; a lost uplink means the remote pass never
    runs, a lost downlink means the computed answer never arrives.
    Both resolve through the race's deadline timeout — never a hang.
  * **Determinism** — no wall clock, no global RNG.  Every message
    draws from ``np.random.default_rng((seed, message_index))``: the
    sample stream is a pure function of the config seed and the send
    sequence, so every race replays bit-exact, and equals the JAX
    package's stream for the same config and send sequence.

The model is *passive*: it samples delays and loss, the serving layer
(:meth:`repro_torch.serve.fleet.ShardedDetectionService.submit_speculative`)
charges them on the shared clock.  It stays numpy: there is nothing here
for the card to do.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Parameters of the modeled vehicle<->remote link.

    ``rtt_median_s`` is the *median* round trip (both legs, no loss);
    ``uplink_fraction`` splits it into the request leg (uplink median =
    ``rtt_median_s * uplink_fraction``) and the response leg (the
    rest).  ``uplink_fraction=0.0`` with ``jitter_sigma=0.0`` and
    ``loss=0.0`` is the **uplink-compat mode**: a free uplink and the
    whole RTT charged on the response — bit-exact with the
    ``SpeculativeConfig.rtt_s``-only arithmetic, kept as a regression
    gate, not as an honest model.  ``jitter_sigma`` is the lognormal
    sigma of each leg's multiplicative jitter; ``loss`` is the
    independent per-message loss probability of each leg.  ``seed``
    makes every sample stream replayable bit-exact.
    """
    seed: int = 0
    rtt_median_s: float = 0.03
    uplink_fraction: float = 0.5
    jitter_sigma: float = 0.0
    loss: float = 0.0

    def __post_init__(self):
        assert self.rtt_median_s >= 0.0, self.rtt_median_s
        assert 0.0 <= self.uplink_fraction <= 1.0, self.uplink_fraction
        assert self.jitter_sigma >= 0.0, self.jitter_sigma
        assert 0.0 <= self.loss <= 1.0, self.loss

    @property
    def uplink_median_s(self) -> float:
        return self.rtt_median_s * self.uplink_fraction

    @property
    def downlink_median_s(self) -> float:
        return self.rtt_median_s * (1.0 - self.uplink_fraction)


@dataclasses.dataclass(frozen=True)
class Delivery:
    """One message's fate: sampled one-way delay, or lost (pure data).

    ``arrives_at(sent_at)`` is the only arithmetic: a lost message
    arrives at ``inf`` — it never arrives, and whatever waits on it
    must resolve through a timeout, never by blocking.
    """
    kind: str          # "uplink" | "downlink"
    msg_id: int        # position in the model's send sequence
    delay_s: float     # sampled one-way delay (valid even when lost)
    lost: bool

    def arrives_at(self, sent_at: float) -> float:
        return math.inf if self.lost else sent_at + self.delay_s


class NetworkModel:
    """Seeded sampler of per-message deliveries (see module docstring).

    Each ``uplink()`` / ``downlink()`` call consumes one message id;
    message ``k`` draws from ``default_rng((seed, k))`` in a fixed
    order (loss uniform first, then the jitter normal), so the stream
    is bit-reproducible for a given send sequence and two models with
    the same config replay identically.
    """

    def __init__(self, cfg: NetworkConfig):
        self.cfg = cfg
        self._msg = 0
        self.sent = 0
        self.lost = 0

    def _sample(self, kind: str, median_s: float) -> Delivery:
        msg = self._msg
        self._msg += 1
        rng = np.random.default_rng((self.cfg.seed, msg))
        lost = bool(rng.random() < self.cfg.loss)
        z = float(rng.standard_normal())
        # sigma=0 -> exp(0*z) == 1.0 exactly: the fixed-delay model is
        # recovered bit-exact, not approximately (the compat gate)
        delay = median_s * math.exp(self.cfg.jitter_sigma * z)
        self.sent += 1
        self.lost += lost
        return Delivery(kind, msg, delay, lost)

    def uplink(self) -> Delivery:
        """Sample the request leg (vehicle -> remote)."""
        return self._sample("uplink", self.cfg.uplink_median_s)

    def downlink(self) -> Delivery:
        """Sample the response leg (remote -> vehicle)."""
        return self._sample("downlink", self.cfg.downlink_median_s)


def force_lost(d: Delivery) -> Delivery:
    """The fault harness's hook: the same sampled message, forcibly
    lost (``runtime.faults`` schedules per-race forced losses so the
    lost-uplink / lost-downlink arms are exact, not probabilistic)."""
    return dataclasses.replace(d, lost=True)


def expected_rtt_s(cfg: NetworkConfig) -> float:
    """Mean round trip implied by the config (no loss): each lognormal
    leg's mean is ``median * exp(sigma^2 / 2)``.  Diagnostics only —
    the race charges sampled legs, never this expectation."""
    scale = math.exp(cfg.jitter_sigma ** 2 / 2.0)
    return (cfg.uplink_median_s + cfg.downlink_median_s) * scale
