"""Named configurations of the port: the detector's (``paper_lines``) and
the LM stack's (``base``: ``get(name)`` full size, ``get_smoke(name)`` a
family-preserving reduced config for CPU tests)."""

from .base import (  # noqa: F401
    ARCHS,
    PORTED,
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    get,
    get_smoke,
    shapes_for,
)
