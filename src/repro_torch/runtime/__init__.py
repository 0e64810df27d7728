"""Fault-tolerant runtime (``repro/runtime``): heartbeats, worker failures
and fault injection.  The restart loop, ``run_with_restarts``, is in
``runtime.supervisor`` beside them; the package does not re-export it."""

from .faults import ServiceFaultInjector  # noqa: F401
from .heartbeat import Heartbeat, HeartbeatMonitor  # noqa: F401
from .supervisor import WorkerFailure, FaultInjector  # noqa: F401
