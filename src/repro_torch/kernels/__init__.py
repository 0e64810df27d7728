"""The port's kernels: hand CUDA kernels for the card (``csrc/``), their
plain PyTorch versions (``ref``), and the device dispatch (``ops``).

The package exports what ``repro.kernels`` exports: ``ops``, ``ref`` and
the kernels' entry points, ``fused_detect`` among them.  Each entry point's
name is also the module of that kernel's wrapper and plain version, so the
module answers the call: ``kernels.flash_attention(q, k, v)`` is
``ops.flash_attention(q, k, v)`` (the plain version on a CPU tensor, the
kernel on a CUDA one), while ``kernels.flash_attention.MAX_HEAD_DIM``
still reads the module.  The reference's ``resolve_impl`` and
``set_default_impl`` have no counterpart: the tensor's device picks.
Importing the package builds nothing and needs no card.
"""

import sys
import types

from . import ops, ref  # noqa: F401

ENTRY_POINTS = ("conv2d_gemm", "flash_attention", "fused_detect",
                "hough_vote", "ssd_scan", "tiled_matmul")


class _EntryPoint(types.ModuleType):
    """A kernel's module that, called, runs ``ops``' entry point of its
    name."""

    def __call__(self, *args, **kwargs):
        return getattr(ops, self.__name__.rpartition(".")[2])(*args, **kwargs)


for _name in ENTRY_POINTS:
    sys.modules[f"{__name__}.{_name}"].__class__ = _EntryPoint
