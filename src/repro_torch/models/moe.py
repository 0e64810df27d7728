"""Mixture-of-Experts: top-k routing with capacity-bounded dispatch
(``repro/models/moe.py``).

Two dispatch strategies of the same semantics:

  * ``sort`` (serving) — each (token, k) assignment takes the next free
    position of its expert by a running count over the flattened
    assignment list, token-major; an assignment whose position reaches the
    capacity is dropped (weight 0, the residual passes through).  Dispatch
    and combine are gathers: no (T, E, C) one-hot exists.
  * ``onehot`` (the semantics of record, GShard-style) — explicit dispatch
    and combine one-hot products in f32, quadratic in the token count;
    tests and ``chip_smoke.py`` hold ``sort`` to it.

The capacity ``C = max(int(capacity_factor * k * T / E), k)`` counts every
token of the call (a prefill's bucket pads, every slot of a decode step),
so an MoE layer's output depends on the batch.  ``C`` comes from shapes
alone: neither dispatch reads a device value on the host.  The expert
FFN is three batched products in the compute dtype (``torch.bmm``; the
reference computes them as einsums outside any Pallas kernel).

``ep`` (:func:`moe_ep`, the default of every model pass) is expert
parallelism under ``sharding.shard_map``, manual over every axis of the
mesh made active by ``sharding.activate``: experts over ``model``, each
data shard's tokens routed, dispatched and combined where they are, with
the capacity counted per shard; one f32 psum gives the output.  With no
active mesh it is ``moe_sort``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.sharding import constrain, partition, shard_map

from .layers import P


def moe_spec(cfg) -> Any:
    m = cfg.moe
    return {
        "router": P((cfg.d_model, m.n_experts), ("embed", "experts"),
                    scale=cfg.d_model ** -0.5),
        "wi_gate": P((m.n_experts, cfg.d_model, m.d_ff),
                     ("experts", "embed", "mlp"), fan_in_dims=(1,)),
        "wi_up": P((m.n_experts, cfg.d_model, m.d_ff),
                   ("experts", "embed", "mlp"), fan_in_dims=(1,)),
        "wo": P((m.n_experts, m.d_ff, cfg.d_model),
                ("experts", "mlp", "embed"), fan_in_dims=(1,)),
    }


def _route(params, x2d: torch.Tensor, m):
    """Router probabilities (T, E) and the top-k choice, all f32: weights
    (T, k) renormalised to sum to 1, experts (T, k) int64, descending."""
    logits = torch.matmul(x2d.to(torch.float32),
                          params["router"].to(torch.float32)) * m.router_scale
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return probs, top_w, top_e


def _capacity(T: int, m) -> int:
    """Slots an expert, from the call's token count ``T`` (the reference's
    float expression, so the floor is the same)."""
    c = int(m.capacity_factor * m.top_k * T / m.n_experts)
    return max(c, m.top_k)


def _ep_capacity(T_loc: int, m) -> int:
    """:func:`moe_ep`'s slots an expert, per data shard of ``T_loc``
    tokens: floored so that a handful of tokens (a decode step) never
    contends for C = 1 slots."""
    return max(int(m.capacity_factor * m.top_k * T_loc / m.n_experts),
               m.top_k, min(T_loc * m.top_k, 32))


def _positions(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(T*k,) each assignment's position within its expert: the running
    count over the flattened (token, k) list, token-major, minus one.
    The count runs along the last axis of an (E, T*k) one-hot: a scan
    along the first axis of a (T*k, E) one runs one thread an expert
    (1.15 ms of a moonshot layer's 1.9 at T = 1024 on an H100)."""
    flat_e = top_e.reshape(-1)
    experts = torch.arange(n_experts, device=flat_e.device)
    count = torch.cumsum(flat_e[None, :] == experts[:, None], dim=1) - 1
    return count.gather(0, flat_e[None, :])[0]


def _expert_ffn(params, xs: torch.Tensor, dtype, *,
                annotate: bool = True) -> torch.Tensor:
    """xs: (E, C, D) -> (E, C, D); SwiGLU an expert as three stacked
    products in ``dtype``.  ``annotate=False`` inside a manual region,
    where the expert axis is already local."""
    g = torch.bmm(xs, params["wi_gate"].to(dtype))
    u = torch.bmm(xs, params["wi_up"].to(dtype))
    h = F.silu(g) * u
    if annotate:
        h = constrain(h, ("experts", "expert_cap", "mlp"))
    return torch.bmm(h, params["wo"].to(dtype))


def moe_sort(params, x: torch.Tensor, cfg) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Sort-based capacity dispatch.  x: (B, S, D) -> (out, aux_loss).

    The token ids are scattered into ``E*C`` slots plus one sink row that
    takes every dropped assignment (the reference's ``mode="drop"``); an
    empty slot gathers token 0.  A dropped assignment gathers slot
    ``e*C`` back at weight 0.  Combine weights are cast to ``x.dtype``
    before the product and the sum over k runs in ``x.dtype``.
    """
    m = cfg.moe
    B, S, D = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    x2d = x.reshape(T, D)
    probs, top_w, top_e = _route(params, x2d, m)
    C = _capacity(T, m)

    flat_e = top_e.reshape(-1)
    pos = _positions(top_e, E)
    keep = pos < C
    slot = flat_e * C + torch.where(keep, pos, 0)        # in [0, E*C)

    token_of_assign = torch.arange(T * k, device=x.device) // k
    slot_token = torch.zeros(E * C + 1, dtype=torch.int64, device=x.device)
    slot_token.scatter_(0, torch.where(keep, slot, E * C), token_of_assign)
    xs = torch.index_select(x2d, 0, slot_token[:E * C]).reshape(E, C, D)
    xs = constrain(xs, ("experts", "expert_cap", None))

    ys = _expert_ffn(params, xs, x.dtype).reshape(E * C, D)

    gathered = torch.index_select(ys, 0, slot).reshape(T, k, D)
    w = (top_w.reshape(-1) * keep).reshape(T, k, 1).to(x.dtype)
    out = (gathered * w).sum(dim=1).reshape(B, S, D)
    return out, _load_balance_loss(probs, top_e, m)


def moe_onehot(params, x: torch.Tensor, cfg) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """GShard-style one-hot dispatch and combine products in f32 (the
    semantics of record)."""
    m = cfg.moe
    B, S, D = x.shape
    T, E = B * S, m.n_experts
    x2d = x.reshape(T, D)
    probs, top_w, top_e = _route(params, x2d, m)
    C = _capacity(T, m)

    pos = _positions(top_e, E).reshape(T, m.top_k)
    dispatch = torch.zeros((T, E, C), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    for j in range(m.top_k):
        keep = pos[:, j] < C
        oh = (F.one_hot(top_e[:, j], E).to(torch.float32)[:, :, None]
              * F.one_hot(torch.where(keep, pos[:, j], 0), C).to(
                  torch.float32)[:, None, :]
              * keep[:, None, None])
        dispatch = dispatch + oh
        combine = combine + oh * top_w[:, j][:, None, None]

    xs = torch.einsum("tec,td->ecd", dispatch, x2d.to(torch.float32))
    ys = _expert_ffn(params, xs.to(x.dtype), x.dtype)
    out = torch.einsum("tec,ecd->td", combine, ys.to(torch.float32))
    return (out.to(x.dtype).reshape(B, S, D),
            _load_balance_loss(probs, top_e, m))


def _load_balance_loss(probs: torch.Tensor, top_e: torch.Tensor, m
                       ) -> torch.Tensor:
    """Switch-style aux loss, E * sum_e f_e * p_e, with f_e the share of
    tokens whose first choice is e."""
    f = F.one_hot(top_e[:, 0], m.n_experts).to(torch.float32).mean(dim=0)
    return m.n_experts * torch.sum(f * probs.mean(dim=0))


def moe_ep(params, x: torch.Tensor, cfg) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Fully-manual 2D expert parallelism: data-local dispatch, no token
    movement.  x: (B, S, D) -> (out, aux_loss).

    Rank (d, m) holds data shard d's tokens (replicated over ``model``)
    and expert slice m.  Routing, the capacity, dispatch, the expert
    products and the weighted combine are local; the collectives a layer
    are the FSDP all-gather of the expert weights over ``data`` (when the
    active rules put ``embed`` there) and one f32 psum of the output over
    ``model``; the aux loss is the pmean of the shards' over the data
    axes.  The capacity is per (data shard, expert), floored for small
    token counts: ``C = max(int(cf k T_loc / E), k, min(T_loc k, 32))``
    (:func:`_ep_capacity`).

    Falls back to :func:`moe_sort` with no active mesh, no ``model`` axis,
    an expert count the ``model`` axis does not divide, or a batch the
    data axes do not divide.
    """
    active = partition._ACTIVE.get()
    m = cfg.moe
    if active is None:
        return moe_sort(params, x, cfg)
    mesh, active_rules = active
    sizes = partition.mesh_axes(mesh)
    if "model" not in sizes or m.n_experts % sizes["model"] != 0:
        return moe_sort(params, x, cfg)
    # FSDP-shard the expert weights over `data` only where the active rule
    # table says so (training); decode rules replicate them
    fsdp = any(c == "data" or (isinstance(c, tuple) and "data" in c)
               for c in active_rules.get("embed", ()))
    E, k = m.n_experts, m.top_k
    e_local = E // sizes["model"]
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = math.prod(sizes[a] for a in dp_axes)

    B, S, D = x.shape
    if B % dp != 0:
        return moe_sort(params, x, cfg)
    B_loc = B // dp
    T_loc = B_loc * S
    C = _ep_capacity(T_loc, m)
    dtype = x.dtype

    def local(router, wi_gate, wi_up, wo, x_f32):
        x2d = x_f32.to(dtype).reshape(T_loc, D)
        if fsdp:    # FSDP-unshard over `data` (replicated over `pod`)
            wi_gate = partition.all_gather(wi_gate, mesh, "data", 1)
            wi_up = partition.all_gather(wi_up, mesh, "data", 1)
            wo = partition.all_gather(wo, mesh, "data", 2)
        probs, top_w, top_e = _route({"router": router}, x2d, m)
        lo = mesh.get_local_rank("model") * e_local

        pos = _positions(top_e, E)
        local_e = top_e.reshape(-1) - lo
        mine = (local_e >= 0) & (local_e < e_local) & (pos < C)
        slot = torch.where(mine, local_e * C + pos, e_local * C)

        token_of_assign = torch.arange(T_loc * k, device=x2d.device) // k
        slot_token = torch.zeros(e_local * C + 1, dtype=torch.int64,
                                 device=x2d.device)
        slot_token.scatter_(0, slot, token_of_assign)
        xs = torch.index_select(x2d, 0, slot_token[:e_local * C])
        ys = _expert_ffn({"wi_gate": wi_gate, "wi_up": wi_up, "wo": wo},
                         xs.reshape(e_local, C, D), dtype, annotate=False)
        # the out-of-range slot gathers a zero row
        ys = torch.cat([ys.reshape(e_local * C, D), ys.new_zeros(1, D)])
        gathered = torch.index_select(ys, 0, slot).reshape(T_loc, k, D)
        w = (top_w.reshape(-1) * mine).reshape(T_loc, k, 1).to(dtype)
        partial = (gathered * w).sum(dim=1).reshape(B_loc, S, D)
        out = partition.psum(partial.to(torch.float32), mesh,
                             "model").to(dtype)
        aux = _load_balance_loss(probs, top_e, m)
        if dp_axes:
            aux = partition.psum(aux, mesh, dp_axes) / dp
        return out, aux

    PS = partition.PartitionSpec
    dp_spec = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes
                                                else None)
    wi_spec = PS("model", "data") if fsdp else PS("model")
    wo_spec = PS("model", None, "data") if fsdp else PS("model")
    return shard_map(
        local, mesh=mesh,
        in_specs=(PS(), wi_spec, wi_spec, wo_spec, PS(dp_spec)),
        out_specs=(PS(dp_spec), PS()),
        axis_names=set(("model",) + dp_axes), check_vma=False,
    )(params["router"], params["wi_gate"], params["wi_up"], params["wo"],
      x.to(torch.float32))


def apply_moe(params, x, cfg, *, strategy: str = "sort"):
    """``onehot`` takes :func:`moe_onehot`, ``ep`` :func:`moe_ep` (which is
    :func:`moe_sort` with no active mesh), anything else
    :func:`moe_sort`."""
    if strategy == "onehot":
        return moe_onehot(params, x, cfg)
    if strategy == "ep":
        return moe_ep(params, x, cfg)
    return moe_sort(params, x, cfg)
