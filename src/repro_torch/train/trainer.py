"""Train- and eval-step builders (``repro/train/trainer.py``).

``make_train_step(model, opt_cfg, n_micro=)`` returns a pure
``(state, batch) -> (state, metrics)``: the loss and the gradient of every
parameter leaf (``torch.autograd.grad`` on detached copies, so the state's
tensors never require grad), accumulated over ``n_micro`` microbatches
(the batch split along its rows, the gradients summed in f32 and scaled
by ``1 / n_micro``), then one AdamW update.  Every metric is a device
tensor; the step reads nothing back to the host.  A placed state and
batch (``distribute_tree`` on a one-device mesh) run on their local
tensors, and the new state comes back placed as the old one was.

``make_train_step_pod_compressed(model, opt_cfg, mesh, n_micro=)`` is the
step whose cross-pod gradient reduction is int8-compressed: it runs under
``sharding.shard_map`` manual over ``pod``, one process a pod, each on its
rows of the global batch; the gradients' mean over the pods comes from
``compression.compressed_allreduce_tree`` (the only collective of the
gradients), and every pod applies the same update.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.layers import tree_map
from repro_torch.sharding.partition import (
    PartitionSpec as PS, local_tree, placed_like, shard_map,
)

from . import compression as comp
from .optim import AdamWConfig, _div, adamw_update
from .state import TrainState


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """(B, ...) -> n batches of B/n rows, in order."""
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch leaf {k!r} has {x.shape[0]} rows, not "
                             f"a multiple of n_micro={n}")
    return [{k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def _value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``, detached; a
    leaf the loss does not reach gets a zero gradient."""
    flat = []

    def leaf(p):
        flat.append(p.detach().requires_grad_())
        return flat[-1]

    leaves = tree_map(leaf, params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                         materialize_grads=True))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), leaves))


def _mean_grads(loss_fn, params, batch, n_micro: int):
    """Accumulated (loss, metrics, grads) over ``n_micro`` microbatches."""
    if n_micro <= 1:
        return _value_and_grad(loss_fn, params, batch)
    loss = None
    for mb in _split_microbatches(batch, n_micro):
        l_i, m_i, g_i = _value_and_grad(loss_fn, params, mb)
        if loss is None:
            loss = torch.zeros((), dtype=torch.float32, device=l_i.device)
            metrics = {k: torch.zeros_like(v) for k, v in m_i.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        loss = loss + l_i
        metrics = {k: metrics[k] + m_i[k] for k in metrics}
        grads = tree_map(torch.add, grads, g_i)
    inv = 1.0 / n_micro
    return (loss * inv, {k: m * inv for k, m in metrics.items()},
            tree_map(lambda g: g * inv, grads))


def make_train_step(model, opt_cfg: AdamWConfig, *, n_micro: int = 1
                    ) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """``(state, batch) -> (state, metrics)`` with metrics ``ce``,
    ``moe_aux``, ``grad_norm``, ``lr`` and ``loss`` (device tensors)."""

    def train_step(state: TrainState, batch: dict):
        placed, state, batch = state, local_tree(state), local_tree(batch)
        loss, metrics, grads = _mean_grads(model.loss, state.params, batch,
                                           n_micro)
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, state.step, opt_cfg)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return placed_like(TrainState(state.step + 1, new_params, new_opt,
                                      state.err), placed), metrics

    return train_step


def _pmean(values: dict, group) -> dict:
    """Each scalar of ``values`` averaged over ``group``'s ranks
    (``jax.lax.pmean``): one all-gather of them all, summed from the first
    rank to the last and divided once, so that every rank gets the same
    bits."""
    import torch.distributed as dist

    keys = list(values)
    mine = torch.stack([values[k].to(torch.float32).reshape(())
                        for k in keys])
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    mean = _div(total, len(parts))
    return {k: mean[i] for i, k in enumerate(keys)}


def make_train_step_pod_compressed(
    model, opt_cfg: AdamWConfig, mesh, *, n_micro: int = 1,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Train step whose cross-pod gradient reduction is int8-compressed.

    ``shard_map`` manual over ``pod``: each pod (one process) computes the
    mean gradient of its rows of the global batch, contributes an int8
    payload, and applies the identical update, so the parameters and
    moments stay the same bits on every pod.  Loss and metrics are their
    means over the pods.  Requires ``state.err``
    (``init_train_state(compression=True)``); each pod keeps its own
    residuals there, as each of the reference's devices does under its
    replicated spec.  A state placed on a one-device mesh runs on its
    local tensors and comes back placed.
    """
    names = tuple(mesh.mesh_dim_names or ())
    if "pod" not in names:
        raise ValueError("the pod-compressed step needs a 'pod' mesh axis; "
                         f"the mesh has {names}")

    def per_pod(state: TrainState, batch: Any):
        if state.err is None:
            raise ValueError("the pod-compressed step needs state.err: "
                             "init_train_state(compression=True)")
        loss, metrics, grads = _mean_grads(model.loss, state.params, batch,
                                           n_micro)
        pods = mesh.get_group("pod")
        grads, new_cstate = comp.compressed_allreduce_tree(
            grads, comp.CompressionState(state.err), pods)
        means = _pmean({**metrics, "loss": loss}, pods)
        loss = means.pop("loss")
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, state.step, opt_cfg)
        metrics = {**means, **opt_metrics, "loss": loss}
        return TrainState(state.step + 1, new_params, new_opt,
                          new_cstate.err), metrics

    # the state replicated over pod (params and opt the same on every pod,
    # err each pod's own); the batch split over pod on dim 0
    step = shard_map(per_pod, mesh=mesh, in_specs=(PS(), PS("pod")),
                     out_specs=(PS(), PS()), axis_names={"pod"},
                     check_vma=False)

    def train_step(state: TrainState, batch: Any):
        new, metrics = step(local_tree(state), local_tree(batch))
        return placed_like(new, state), metrics

    return train_step


def make_eval_step(model) -> Callable[[Any, Any], dict]:
    """``(params, batch) -> {"ce", "moe_aux", "loss"}``, with no graph."""

    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
        return {**metrics, "loss": loss}

    return eval_step
