"""Logical-axis sharding rules (``repro/sharding``): DP/FSDP/TP/EP/SP and
the multi-pod axis, on ``DeviceMesh`` and DTensor placements.

Every parameter and activation is annotated with logical axis names, and a
rule table maps those names onto mesh axes with divisibility-checked
fallbacks.  ``shard_map`` runs a function manual over mesh axes, one
process a device (the pod-compressed train step runs under it).
"""

from .partition import (  # noqa: F401
    AxisRules,
    DEFAULT_RULES,
    DECODE_RULES,
    SP_RULES,
    activate,
    logical_to_spec,
    named_sharding,
    shardings_for_tree,
    constrain,
    rules_for_shape,
    shard_map,
)
