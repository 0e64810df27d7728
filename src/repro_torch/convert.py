"""Configurations and parameters of the reference package, as the port's.

The reference detector has no learned weights: its parameters are its
frozen configs (and the mask constants, which both packages compute the
same way).  ``pipeline_config_from_reference`` takes
``dataclasses.asdict`` of a ``repro`` ``PipelineConfig`` (plain dicts, so
this module never imports the reference) and builds the port's config.

For the LM stack, ``model_config_from_reference`` does the same for a
``ModelConfig``, ``lm_params_from_reference`` takes the reference's
parameter pytree as numpy arrays, ``train_state_from_reference`` its
``TrainState`` (step, parameters, AdamW moments, compression residuals),
and ``lm_quantized_params_from_reference`` its ``quantize_weights_int8``
trees (int8 values and scales).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
from repro_torch.models import layers
from repro_torch.models.transformer import param_specs

from repro_torch.core.canny import CannyConfig
from repro_torch.core.hough import HoughConfig
from repro_torch.core.lines import LinesConfig
from repro_torch.core.plan import PipelineConfig
from repro_torch.train.state import TrainState

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


def model_config_from_reference(d: dict) -> ModelConfig:
    """The port's ``ModelConfig`` for ``dataclasses.asdict(reference)``
    (unknown fields raise, as above, in the ``moe`` and ``ssm`` sub-configs
    too)."""
    d = dict(d)
    if d.get("moe") is not None:
        d["moe"] = MoEConfig(**d["moe"])
    if d.get("ssm") is not None:
        d["ssm"] = SSMConfig(**d["ssm"])
    return ModelConfig(**d)


def lm_params_from_reference(cfg: ModelConfig, params) -> dict:
    """The reference's LM parameters (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's, on the CPU.

    The port keeps the reference's layout, stacked ``blocks``/``tail``
    leaves included (layer ``i`` is the view ``leaf[i]``), so each leaf is
    carried across as it is; the tree must match ``param_specs(cfg)`` key
    for key and shape for shape, or this raises.
    """
    specs = dict(layers.tree_items(param_specs(cfg)))
    given = dict(layers.tree_items(params))
    if specs.keys() != given.keys():
        raise ValueError(
            f"parameter trees differ: missing {sorted(specs.keys() - given)}"
            f", unexpected {sorted(given.keys() - specs)}")
    for path, spec in specs.items():
        if tuple(np.shape(given[path])) != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape "
                             f"{np.shape(given[path])} != {spec.shape}")
    return layers.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)), params)


def train_state_from_reference(cfg: ModelConfig, state) -> TrainState:
    """The reference's ``TrainState`` (``step``, ``params``, ``opt`` with
    moments ``m`` and ``v``, and the compression residuals ``err`` or
    ``None``; leaves as numpy arrays, e.g. ``jax.tree.map(np.asarray,
    state)``) as the port's, on the CPU.  The parameters, both moments and
    each ``err`` leaf are checked against ``param_specs(cfg)`` as
    :func:`lm_params_from_reference` checks them; ``err`` is made f32."""
    err = None
    if state.err is not None:
        err = layers.tree_map(lambda t: t.to(torch.float32),
                              lm_params_from_reference(cfg, state.err))
    return TrainState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        params=lm_params_from_reference(cfg, state.params),
        opt={k: lm_params_from_reference(cfg, state.opt[k])
             for k in ("m", "v")},
        err=err)


def lm_quantized_params_from_reference(cfg: ModelConfig, qs: dict) -> dict:
    """The reference's ``quantize_weights_int8`` output, ``{"q": values,
    "s": scales}`` as nested dicts of numpy arrays, as the port's.

    The values take the parameters' own layout (checked against
    ``param_specs(cfg)`` as :func:`lm_params_from_reference` checks them);
    each scale must broadcast over its leaf: one value per output column,
    kept in every other axis, for a floating leaf of two or more axes, and
    ``()`` for the rest.
    """
    q = lm_params_from_reference(cfg, qs["q"])
    s = layers.tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True)),
        qs["s"])
    scales = dict(layers.tree_items(s))
    specs = dict(layers.tree_items(param_specs(cfg)))
    if scales.keys() != specs.keys():
        raise ValueError(
            f"scale tree differs: missing {sorted(specs.keys() - scales)}, "
            f"unexpected {sorted(scales.keys() - specs)}")
    for path, spec in specs.items():
        per_column = spec.dtype.startswith(("float", "bfloat")) and len(
            spec.shape) > 1
        want = ((1,) * (len(spec.shape) - 1) + spec.shape[-1:]
                if per_column else ())
        got = scales.get(path)
        if got is None or tuple(got.shape) != tuple(want):
            raise ValueError(f"{'/'.join(path)}: scale shape "
                             f"{None if got is None else tuple(got.shape)} "
                             f"!= {tuple(want)}")
    return {"q": q, "s": s}
