"""Mesh construction (``repro/launch/mesh.py``) and the detection fleet's
replica devices.

Mesh shapes:
  single-pod: (16, 16)      axes ("data", "model")
  multi-pod:  (2, 16, 16)   axes ("pod", "data", "model")

``data`` is the FSDP/DP axis, ``model`` the TP/EP axis, ``pod`` the slow
cross-pod axis carrying only batch DP.  No machine of the port has those
256 or 512 cards, and the sharding rules read only a mesh's names and
sizes, so :func:`make_production_mesh` gives a shape-only mesh.
:func:`make_host_mesh` and :func:`make_replica_mesh` build real
``DeviceMesh``es over the process group's ranks (one rank a device): on
one H100, (1, 1) and (1,).
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.partition import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def _device_mesh(device, shape_of_world, names):
    """A ``DeviceMesh`` of ``device``'s type over the process group.  With
    no group yet, the process makes a world-size-1 one on an in-memory
    ``HashStore`` (no TCP rendezvous, no environment read or written): nccl
    for the card, gloo for the CPU.  ``shape_of_world(world_size)`` gives
    the mesh's shape."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    shape = shape_of_world(dist.get_world_size())
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_replica_mesh(n: int | None = None, *, device=None):
    """1-D ``("replica",)`` mesh over (up to) ``n`` devices, the card's
    unless ``device="cpu"`` (raises on a host without one).

    The detection fleet's mesh: each replica of the sharded
    :class:`~repro_torch.serve.fleet.ShardedDetectionService` pins its
    plans and dispatches to one device along this axis."""
    return _device_mesh(device, lambda world: (min(n or world, world),),
                        ("replica",))


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


def _squarest(n: int) -> int:
    """The largest divisor of ``n`` at most its square root."""
    return max(s for s in range(1, math.isqrt(n) + 1) if n % s == 0)


def make_host_mesh(*, multi_pod: bool = False, n: int | None = None,
                   device=None):
    """Small mesh over the devices there are (the card's unless
    ``device="cpu"``): single-pod (n // d, d), multi-pod (2, rest // d, d)
    with rest = n // 2 when n >= 8, d the squarest factor."""
    def shape(world):
        m = n or world
        if not multi_pod:
            d = _squarest(m)
            return (m // d, d)
        if m < 8 or m % 2:
            raise ValueError(f"a multi-pod host mesh needs an even count of "
                             f"at least 8 devices, not {m}")
        rest = m // 2
        d = _squarest(rest)
        return (2, rest // d, d)

    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device, shape, names)
