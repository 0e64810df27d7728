"""Worker-failure signalling (``repro/runtime/supervisor.py``).

``WorkerFailure`` is the error a dead worker surfaces (the detection
service's prefetch stager raises it on an injected or real thread death);
``FaultInjector`` is the step-indexed schedule that raises it.  The
reference's ``run_with_restarts`` (checkpoint / restart supervision)
needs a checkpoint store and comes with the training slice.
"""

from __future__ import annotations

import dataclasses


class WorkerFailure(RuntimeError):
    """A (simulated) node loss / hang escalated by the heartbeat monitor."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault schedule: fail when step hits each trigger once."""

    fail_at_steps: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")
