"""Heartbeats: workers report liveness; a monitor flags the silent ones
(``repro/runtime/heartbeat.py``).

An in-process implementation: the detection service's prefetch worker
beats once per staged task, and a monitor on the same clock flags a
worker that went silent.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Heartbeat:
    """Worker side: beat() regularly (or let the auto-thread do it).

    ``clock`` is injectable (default ``time.monotonic``) so the serving
    path can beat on the same
    :class:`~repro_torch.serve.detection.VirtualClock` the scheduler runs
    on — liveness decisions then become deterministic functions of the
    driven schedule, not of wall time.
    """

    def __init__(self, worker_id: str, registry: dict, *,
                 interval_s: float = 0.05, auto: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        self.worker_id = worker_id
        self.registry = registry
        self.interval_s = interval_s
        self.clock = clock
        self._stop = threading.Event()
        self.beat()
        self._thread = None
        if auto:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def beat(self):
        self.registry[self.worker_id] = self.clock()

    def _loop(self):
        while not self._stop.is_set():
            self.beat()
            time.sleep(self.interval_s)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)


class HeartbeatMonitor:
    """Controller side: which workers missed their deadline?"""

    def __init__(self, registry: dict, *, timeout_s: float = 0.25,
                 on_dead: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.timeout_s = timeout_s
        self.on_dead = on_dead
        self.clock = clock

    def dead_workers(self) -> list[str]:
        now = self.clock()
        dead = [
            w for w, t in self.registry.items()
            if now - t > self.timeout_s
        ]
        if self.on_dead:
            for w in dead:
                self.on_dead(w)
        return dead

    def all_alive(self) -> bool:
        return not self.dead_workers()
