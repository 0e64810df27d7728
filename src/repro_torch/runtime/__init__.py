"""Fault-tolerant runtime (``repro/runtime``): heartbeats, restart
supervision and fault injection."""

from .faults import ServiceFaultInjector  # noqa: F401
from .heartbeat import Heartbeat, HeartbeatMonitor  # noqa: F401
from .supervisor import (  # noqa: F401
    WorkerFailure,
    FaultInjector,
    run_with_restarts,
)
