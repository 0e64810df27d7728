"""Device handles for the detection fleet's replicas
(``repro/launch/mesh.py::replica_devices``).

The reference's other functions build JAX meshes for training and wait
for the port of the sharding layer.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def replica_devices(n: int, device=None) -> list[torch.device]:
    """``n`` device handles for ``n`` service replicas.

    ``device`` names the kind, by the port's device rule: ``None`` (or
    ``"cuda"``) is the card, cycling over the host's cards when there are
    fewer than ``n`` — on one H100 every replica shares ``cuda:0`` (the
    policy layer still shards queues, trackers and plan caches; only the
    physical placement collapses) — and raises on a host without one;
    ``"cpu"`` is ``n`` CPU devices."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]
