"""Serving: the LM's continuous-batching ``Engine`` and token sampling, and
the line detector's deadline-aware ``DetectionService`` (resolution
buckets, fixed batch slots, backpressure, EDF / priority scheduling,
per-session tracking and steering, the degradation ladder, fault
handling; ``serve/detection.py``)."""

from .detection import (  # noqa: F401
    DEFAULT_POLICY,
    SHED_ONLY,
    BucketLoad,
    DegradationPolicy,
    DetectionRequest,
    DetectionService,
    LoadController,
    PrefetchStager,
    RequestStatus,
    SessionSLO,
    VirtualClock,
    crop_result,
    pad_to_bucket,
    upscale_result,
)
from .engine import Engine, Request  # noqa: F401
from .sampling import sample  # noqa: F401
