"""Fault-tolerant runtime: heartbeats, worker failures, fault injection
(``repro/runtime``, without ``run_with_restarts``, which waits for a
checkpoint store)."""

from .faults import ServiceFaultInjector  # noqa: F401
from .heartbeat import Heartbeat, HeartbeatMonitor  # noqa: F401
from .supervisor import WorkerFailure, FaultInjector  # noqa: F401
