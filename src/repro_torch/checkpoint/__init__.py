"""Checkpointing (``repro/checkpoint``): atomic and async saves of tensor
trees, manifest, restore onto the target's devices, retention."""

from .store import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore,
    save,
)
