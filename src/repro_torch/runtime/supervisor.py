"""Restart supervision (``repro/runtime/supervisor.py``): checkpoint and
restart with bounded retries.

``WorkerFailure`` is the error a dead worker surfaces (the detection
service's prefetch stager raises it on an injected or real thread death,
a training step on a lost worker); ``FaultInjector`` is the step-indexed
schedule that raises it.  ``run_with_restarts`` drives a step function
under that fault model: a ``WorkerFailure`` rolls the loop back to the
last checkpoint of the port's store and goes on, up to ``max_restarts``.
The step function receives the restored state and the step index to
resume from, so with the step-indexed token pipeline the trajectory after
a restart is the uninterrupted one, bit for bit.

Elasticity: the restore goes into ``state_template`` when one is given
(``meta`` tensors will do, as ``train_state_specs`` gives them), else into
the live state, and places its leaves by ``shardings``, or without them as
the template's leaves are (checkpoint/store.py).  ``on_restart(restarts)``
may return a new shardings tree, for the mesh the run goes on with; the
checkpoints know no mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.checkpoint import CheckpointManager, latest_step


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


def run_with_restarts(
    *,
    init_state: Any,
    step_fn: Callable[[Any, int], Any],     # (state, step) -> state
    n_steps: int,
    ckpt: CheckpointManager,
    ckpt_every: int = 10,
    max_restarts: int = 3,
    state_template: Optional[Any] = None,
    shardings: Any = None,
    on_restart: Optional[Callable[[int], Any]] = None,
) -> tuple[Any, dict]:
    """Returns (final_state, stats {restarts, completed_steps,
    resumed_from})."""
    state = init_state
    step = 0
    restarts = 0
    resumed_from: list[int] = []
    ckpt.save_sync(state, step)

    while step < n_steps:
        try:
            state = step_fn(state, step)
            step += 1
            if step % ckpt_every == 0:
                ckpt.save_async(state, step)
        except WorkerFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                new = on_restart(restarts)
                if new is not None:
                    shardings = new
            ckpt.wait()
            template = state_template if state_template is not None else state
            state = ckpt.restore_latest(template, shardings=shardings)
            step = latest_step(ckpt.directory)
            resumed_from.append(step)
    ckpt.wait()
    return state, {
        "restarts": restarts,
        "completed_steps": step,
        "resumed_from": resumed_from,
    }
