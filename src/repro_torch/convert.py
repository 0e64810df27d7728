"""Configurations of the reference package, as the port's.

The reference detector has no learned weights: its parameters are its
frozen configs (and the mask constants, which both packages compute the
same way).  ``pipeline_config_from_reference`` takes
``dataclasses.asdict`` of a ``repro`` ``PipelineConfig`` (plain dicts, so
this module never imports the reference) and builds the port's config.
"""

from __future__ import annotations

from repro_torch.core.canny import CannyConfig
from repro_torch.core.hough import HoughConfig
from repro_torch.core.lines import LinesConfig
from repro_torch.core.plan import PipelineConfig

# The reference picks among its own execution modes of one kernel with
# ``impl``; in the port the tensor's device picks, so these all mean "the
# conv kernel" (None).  "stencil" is the paper's baseline in both.
_REFERENCE_KERNEL_MODES = ("pallas", "interpret", "xla")


def _impl(value):
    return None if value in _REFERENCE_KERNEL_MODES else value


def pipeline_config_from_reference(d: dict) -> PipelineConfig:
    """The port's ``PipelineConfig`` for ``dataclasses.asdict(reference)``.

    Unknown fields raise (TypeError from the dataclass), so a config the
    port cannot express is never dropped silently.  The reference's
    ``HoughConfig.impl`` (a kernel mode) has no field in the port: a kernel
    mode is dropped, and anything else raises.
    """
    d = dict(d)
    canny = dict(d.pop("canny"))
    canny["impl"] = _impl(canny.get("impl"))
    hough = dict(d.pop("hough"))
    impl = _impl(hough.pop("impl", None))
    if impl is not None:
        raise ValueError(f"the port's vote has no impl {impl!r}")
    return PipelineConfig(
        canny=CannyConfig(**canny),
        hough=HoughConfig(**hough),
        lines=LinesConfig(**d.pop("lines")),
        **d,
    )
