"""Logical axes -> PartitionSpec with divisibility-checked fallbacks
(``repro/sharding/partition.py``), placed with ``torch.distributed``'s
``DeviceMesh`` and DTensor placements.

Every model parameter / activation / cache tensor carries a tuple of logical
axis names (e.g. ``("embed", "heads", "head_dim")``).  A rule table maps each
logical name to an ordered list of *candidate* mesh placements; the first
candidate whose mesh-axis product divides the dimension size — and whose mesh
axes are not already taken by an earlier dimension of the same tensor — wins.
``None`` (replicate) is always a legal last resort.  The tables and the
algorithm are the reference's, kept as data and code of the port's own.

The rules read only a mesh's axis names and sizes, so they take a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``shape``) or the shape-only :class:`AbstractMesh` (the production meshes,
which no machine of the port has, ``launch/mesh.py``).  A spec becomes
DTensor placements through :attr:`NamedSharding.placements`, one per mesh
dim.  Tensors are placed only on a mesh of one device: there
:func:`distribute_tree` wraps each leaf with ``DTensor.from_local`` (no
copy) and :func:`local_tree` gives the local tensors back to the port's
kernels.  Placing tensors on a mesh of more than one device needs
collectives, which wait with the collectives slice (ROADMAP.md §1 item 7).
:func:`shard_map` runs a function manual over mesh axes, one process a
device: each rank takes its block of every input cut along a manual axis,
and outputs cut along one are all-gathered back to the global array;
gradients cross it, and its body's collectives (:func:`psum`,
:func:`all_gather`) carry them with the reference's transposes.  The
int8 error-feedback reduction (``train.compression.compressed_allreduce``)
all-gathers over a ``ProcessGroup`` or an axis of the mesh made active
here (:func:`active_mesh`), on any number of ranks.

Mesh conventions (launch/mesh.py):
  * single-pod: ``("data", "model")`` = (16, 16)
  * multi-pod:  ``("pod", "data", "model")`` = (2, 16, 16); the ``pod`` axis
    carries only *batch* (pure DP).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch

Candidate = Union[None, str, tuple]
AxisRules = Mapping[str, Sequence[Candidate]]

# --- rule tables -----------------------------------------------------------

# Training / prefill defaults: FSDP over `data`, TP over `model`, DP over
# (`pod`, `data`).
DEFAULT_RULES: AxisRules = {
    # activations
    "batch": (("pod", "data"),),
    "seq": (None,),
    "embed_act": (None,),
    # params: a param's dims are tried in tensor order — fallbacks engage
    # only when an earlier dim failed
    "vocab": ("model", None),
    "embed": ("data", None),            # FSDP axis
    "mlp": ("model", None),             # Megatron column/row split
    "heads": ("model", None),
    "kv_heads": ("model", None),
    "head_dim": ("model", None),        # engaged when heads/kv_heads fail
    "qkv": (None,),                     # fused-qkv minor dims
    "experts": ("model", None),         # expert parallelism
    "expert_mlp": (None,),
    "expert_cap": (("pod", "data"), None),  # dispatched token slots
    "state": (None,),                   # SSM state dim (small: 16..128)
    "inner": ("model", None),           # SSM d_inner (channel TP)
    "inner_heads": ("model", None),     # Mamba-2 head axis
    "conv_k": (None,),
    "dt_rank": (None,),
    "layers": (None,),                  # stacked-layer leading dim
    "img_seq": (None,),
    "frames": (None,),
    "norm": (None,),
    # KV-cache timeline: TP shards kv_heads when they divide, else the
    # sequence (split-KV)
    "cache_seq": ("model", None),
    # Full-sequence attention activations (B, H, L, hd): heads carry TP
    # when they divide, otherwise the sequence does
    "attn_seq": ("model", None),
}

# Sequence parallelism (32k prefill / long-context): activations carry their
# sequence dim on `model` between blocks.
SP_RULES: AxisRules = {
    **DEFAULT_RULES,
    "seq": ("model", None),
}

# Decode: the KV cache is the resident tensor.  Batch over DP; cache heads
# over TP, falling back to sequence sharding of the cache when kv heads
# don't divide (granite kv=1, h2o kv=8).  Dim order (batch, kv_heads, seq,
# head_dim) encodes the chain.  Weights are replicated across `data`.
DECODE_RULES: AxisRules = {
    **DEFAULT_RULES,
    "batch": (("pod", "data"), None),
    "cache_seq": ("model", None),
    "kv_heads": ("model", None),
    "embed": (None,),
}

# The detection service's slot grids are (slots, H, W) batches: only the
# slot axis shards, over the 1-D ("replica",) mesh of
# launch.mesh.make_replica_mesh; rows and columns stay whole (the Canny
# halo and the Hough vote read whole frames).
DETECTION_RULES: AxisRules = {
    "slots": ("replica", None),
    "row": (None,),
    "col": (None,),
}

_COLLECTIVES = "the collectives slice (ROADMAP.md §1 item 7)"


# --- meshes and specs ------------------------------------------------------

class AbstractMesh:
    """A shape-only mesh: axis names and sizes, no devices (the counterpart
    of ``jax.sharding.AbstractMesh``).  It reads as a ``DeviceMesh`` does
    (``mesh_dim_names``, ``shape``, ``size()``), so the rules take
    either."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(names)} differ in length")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(self.shape)

    def size(self) -> int:
        return math.prod(self.shape)

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in
                         zip(self.mesh_dim_names, self.shape))
        return f"AbstractMesh({axes})"


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError(f"{mesh!r} has no axis names; the rules need them")
    return dict(zip(names, mesh.shape))


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh axis name, or a
    tuple of names (one dim over several mesh axes, the first major).  A
    plain tuple of the entries, so it equals the reference's
    ``PartitionSpec`` entry for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes_in_mesh(cand: Candidate, names) -> tuple:
    """Normalize a candidate to a tuple of axes present in this mesh."""
    if cand is None:
        return ()
    if isinstance(cand, str):
        cand = (cand,)
    return tuple(a for a in cand if a in names)


def logical_to_spec(
    axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: AxisRules = DEFAULT_RULES,
) -> PartitionSpec:
    """Map one tensor's logical axes to a PartitionSpec on ``mesh``."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {tuple(axes)} do not match shape "
                         f"{tuple(shape)}")
    sizes = mesh_axes(mesh)
    taken: set = set()
    out = []
    for name, size in zip(axes, shape):
        pick = None
        for cand in rules.get(name, (None,)) if name is not None else (None,):
            mesh_axes_ = _axes_in_mesh(cand, sizes)
            if not mesh_axes_:      # None candidate or axis absent: replicate
                pick = None
                break
            if any(a in taken for a in mesh_axes_):
                continue
            n = math.prod(sizes[a] for a in mesh_axes_)
            if n and size % n == 0:
                pick = mesh_axes_ if len(mesh_axes_) > 1 else mesh_axes_[0]
                taken.update(mesh_axes_)
                break
        out.append(pick)
    # strip trailing None for tidy specs
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(d)`` where tensor
        dim ``d`` names that mesh axis, else ``Replicate()``.  A dim over
        several mesh axes shards on each of them; DTensor splits it in mesh
        dim order, the first axis major, as the reference's composite
        entries are (``("pod", "data")``), so such an entry must name its
        axes in mesh order."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_axes(self.mesh))
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            group = (entry,) if isinstance(entry, str) else tuple(entry)
            dims = [names.index(a) for a in group]
            if dims != sorted(dims):
                raise ValueError(
                    f"spec entry {entry!r} names its mesh axes out of the "
                    f"mesh's order {tuple(names)}: DTensor splits a dim "
                    "over several mesh dims in mesh order")
            for m in dims:
                out[m] = Shard(d)
        return tuple(out)


def named_sharding(
    axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: AxisRules = DEFAULT_RULES,
) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(axes, shape, mesh, rules))


# --- trees -----------------------------------------------------------------

def _is_axes_leaf(x) -> bool:
    """A logical-axes tuple: plain tuple of names/None (not a NamedTuple)."""
    return (
        isinstance(x, tuple)
        and not hasattr(x, "_fields")
        and all(e is None or isinstance(e, str) for e in x)
    )


def _map(fn, tree, *rest, is_leaf=lambda x: False):
    """``fn`` leaf by leaf over trees of dicts, lists, tuples and
    NamedTuples of the same structure; ``None`` is an empty subtree."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def _shape_of(leaf) -> tuple:
    """A tensor's (meta or not) shape, or the shape of a ``(shape, dtype)``
    pair (``model_zoo.input_specs``)."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    shape, _ = leaf
    return tuple(shape)


def shardings_for_tree(
    axes_tree: Any,
    shape_tree: Any,
    mesh,
    rules: AxisRules = DEFAULT_RULES,
) -> Any:
    """NamedSharding tree for (axes tree, shape tree).

    ``axes_tree`` leaves are tuples of logical names; tuples are leaves here
    (matched positionally against the shape tree, whose leaves are tensors,
    meta tensors or ``(shape, dtype)`` pairs).
    """
    return _map(lambda a, s: named_sharding(a, _shape_of(s), mesh, rules),
                axes_tree, shape_tree, is_leaf=_is_axes_leaf)


def _one_device(mesh) -> None:
    if mesh.size() > 1:
        raise NotImplementedError(
            f"{mesh!r} has {mesh.size()} devices: placing tensors or running "
            f"the port there needs collectives, which wait with "
            f"{_COLLECTIVES}")
    if isinstance(mesh, AbstractMesh):
        raise ValueError(f"{mesh!r} is shape-only: it has no device to "
                         "place tensors on")


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """``tree`` placed by ``shardings`` (``jax.device_put(tree,
    shardings)``): each leaf moved to the mesh's device (no copy when it is
    there already) and wrapped with ``DTensor.from_local`` under its
    sharding's placements, sharing the leaf's storage.  Only a mesh of one
    device places; a larger one raises."""
    from torch.distributed.tensor import DTensor

    def place(t, sharding):
        _one_device(sharding.mesh)
        return DTensor.from_local(t.to(_mesh_device(sharding.mesh)),
                                  sharding.mesh, sharding.placements,
                                  run_check=False)

    return _map(place, tree, shardings, is_leaf=torch.is_tensor)


def local_tree(tree: Any) -> Any:
    """The local tensors of a placed tree, the tensors the port's kernels
    take (DTensor leaves on a one-device mesh; any other leaf as it is).
    A DTensor on a larger mesh raises: running the model there waits with
    the collectives slice."""
    from torch.distributed.tensor import DTensor

    def local(t):
        if not isinstance(t, DTensor):
            return t
        _one_device(t.device_mesh)
        return t.to_local()

    return _map(local, tree, is_leaf=torch.is_tensor)


def placed_like(tree: Any, like: Any) -> Any:
    """``tree``'s tensors placed as the matching leaves of ``like`` are (the
    same mesh and placements, no copy) where those are DTensors; the rest
    as they are.  A step on a placed state returns a placed state."""
    from torch.distributed.tensor import DTensor

    def place(t, ref):
        if not isinstance(ref, DTensor):
            return t
        return DTensor.from_local(t, ref.device_mesh, ref.placements,
                                  run_check=False)

    return _map(place, tree, like, is_leaf=torch.is_tensor)


# --- activation-constraint context ------------------------------------------
#
# Model code annotates activations by logical axes unconditionally (the
# reference's calls in attention, MoE and the transformer's passes); the
# constraint engages only inside ``activate(mesh, rules)`` and is a no-op
# outside it.  ``moe.moe_ep`` reads the active mesh and rules too.

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_active", default=None
)


@contextlib.contextmanager
def activate(mesh, rules: AxisRules = DEFAULT_RULES):
    token = _ACTIVE.set((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The mesh of the innermost ``activate(...)`` region, or ``None``
    outside one."""
    active = _ACTIVE.get()
    return None if active is None else active[0]


# the mesh axes that are manual in the innermost shard_map body running
_MANUAL_AXES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_manual_axes", default=frozenset()
)


def _strip(spec: PartitionSpec, manual) -> PartitionSpec:
    """``spec`` without the mesh axes in ``manual``."""
    def strip(entry):
        if entry is None:
            return None
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        kept = tuple(n for n in names if n not in manual)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return PartitionSpec(*(strip(e) for e in spec))


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]],
              rules: Optional[AxisRules] = None) -> torch.Tensor:
    """``x`` laid out by its logical axes on the active mesh.

    A no-op outside an ``activate(...)`` region.  Inside, a DTensor is
    redistributed to the spec's placements, and a plain tensor is returned
    as it is where the mesh's axes that are not manual all have size 1;
    elsewhere a plain tensor raises (placing it there needs collectives).
    Inside a :func:`shard_map` body the axes that are manual there are
    dropped from the spec: they are physically fixed.
    """
    active = _ACTIVE.get()
    if active is None:
        return x
    mesh, active_rules = active
    manual = _MANUAL_AXES.get()
    spec = _strip(logical_to_spec(axes, x.shape, mesh, rules or active_rules),
                  manual)
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh, NamedSharding(mesh, spec).placements)
    if math.prod(n for a, n in mesh_axes(mesh).items()
                 if a not in manual) == 1:
        return x
    raise NotImplementedError(
        f"constraining a plain tensor on {mesh!r} ({mesh.size()} devices) "
        f"needs collectives, which wait with {_COLLECTIVES}")


# --- shard_map --------------------------------------------------------------

def _spec_map(fn, specs, tree, what: str):
    """``fn(leaf, spec)`` over ``tree``, ``specs`` a tree prefix of it: a
    :class:`PartitionSpec` covers the whole subtree below it."""
    if isinstance(specs, PartitionSpec):
        return _map(lambda t: fn(t, specs), tree, is_leaf=torch.is_tensor)
    if isinstance(specs, dict) and isinstance(tree, dict):
        if set(specs) != set(tree):
            raise ValueError(f"{what} specs {sorted(specs)} do not match "
                             f"the keys {sorted(tree)}")
        return {k: _spec_map(fn, specs[k], tree[k], what) for k in tree}
    if (isinstance(specs, (list, tuple)) and isinstance(tree, (list, tuple))
            and len(specs) == len(tree)):
        out = [_spec_map(fn, s, t, what) for s, t in zip(specs, tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    raise ValueError(f"{what} specs {specs!r} are not a prefix of the tree")


def _manual_dims(leaf, spec: PartitionSpec, manual) -> list:
    """(dim, its manual axes, the first major) for each dim of ``leaf``
    that ``spec`` puts on a manual axis."""
    out = []
    for d, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        cut = tuple(a for a in names if a in manual)
        if cut:
            out.append((d, cut))
    if out and not (torch.is_tensor(leaf) and len(spec) <= leaf.dim()):
        raise ValueError(f"{spec!r} cannot cut {leaf!r}")
    return out


def _block(t: torch.Tensor, cuts, sizes, mesh) -> torch.Tensor:
    """The rank's block of ``t`` along each cut dim (``_manual_dims``), at
    its coordinate on the dim's manual axes, the first major: a view."""
    for d, axes in cuts:
        n = math.prod(sizes[a] for a in axes)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"into {n} blocks over {axes}")
        i = 0
        for a in axes:
            i = i * sizes[a] + mesh.get_local_rank(a)
        size = t.shape[d] // n
        t = t.narrow(d, i * size, size)
    return t


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    """A copy of ``t`` summed over the ranks of each group in turn."""
    import torch.distributed as dist

    t = t.clone(memory_format=torch.contiguous_format)
    for group in groups:
        dist.all_reduce(t, group=group)
    return t


def _gather_blocks(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``dim`` in rank
    order."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _Cut(torch.autograd.Function):
    """An input's block; backward: the block's cotangent placed at its
    offset in zeros of the input's shape (where the block is not the whole
    input) and summed over ``groups`` (every manual axis), so every rank
    holds the global gradient."""

    @staticmethod
    def forward(ctx, leaf, cuts, sizes, mesh, groups):
        ctx.shape, ctx.spec = leaf.shape, (cuts, sizes, mesh)
        ctx.groups = groups
        return _block(leaf, cuts, sizes, mesh)

    @staticmethod
    def backward(ctx, ct):
        full = ct
        if ct.shape != ctx.shape:
            full = ct.new_zeros(ctx.shape)
            _block(full, *ctx.spec).copy_(ct)
        return _all_reduce(full, ctx.groups), None, None, None, None


class _Gather(torch.autograd.Function):
    """An output's blocks gathered over the manual axes its spec names;
    backward: the rank's block of the cotangent over ``unnamed``, the
    product of the manual axes the spec leaves out (every rank computes
    the same global loss, as in the reference's transpose)."""

    @staticmethod
    def forward(ctx, leaf, cuts, sizes, mesh, unnamed):
        ctx.spec, ctx.unnamed = (cuts, sizes, mesh), unnamed
        for d, axes in cuts:
            for a in reversed(axes):        # the minor axis first
                leaf = _gather_blocks(leaf, mesh.get_group(a), d)
        return leaf

    @staticmethod
    def backward(ctx, ct):
        ct = _block(ct, *ctx.spec)
        if ctx.unnamed > 1:
            ct = ct / ctx.unnamed
        return ct, None, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.groups), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, rank):
        ctx.dim, ctx.group, ctx.rank = dim, group, rank
        ctx.size = x.shape[dim]
        return _gather_blocks(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        total = _all_reduce(ct, [ctx.group])
        return (total.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None,
                None, None)


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``jax.lax.psum`` in a :func:`shard_map` body: ``x`` summed over the
    ranks of the mesh axis ``axes`` (a name, or a tuple of names).  Its
    backward sums the cotangent alike, the reference's transpose under
    ``check_vma=False``: a body output replicated over an axis it does not
    name gets a share of the cotangent a rank (:func:`shard_map`)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return _Psum.apply(x, [mesh.get_group(a) for a in axes])


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)`` in a
    :func:`shard_map` body: the blocks of ``axis``'s ranks concatenated
    along ``dim``.  Its backward sums the cotangent over the axis and keeps
    the rank's block (``psum_scatter``)."""
    return _AllGather.apply(x, mesh.get_group(axis), dim,
                            mesh.get_local_rank(axis))


def shard_map(f, *, mesh, in_specs, out_specs, axis_names=None,
              check_vma: bool = False):
    """``f`` run manual over ``axis_names`` (every axis of the mesh when
    ``None``), one process a device (``jax.shard_map``).

    Inputs are global: a leaf whose spec puts dim ``d`` on a manual axis is
    cut along ``d``, and the rank keeps the block at its own coordinate on
    that axis (``mesh.get_local_rank``; several axes on one dim, the first
    major); a leaf under ``PartitionSpec()`` is passed as it is.  Specs are
    tree prefixes: one ``PartitionSpec()`` covers a whole ``TrainState``.
    An output leaf whose spec puts a dim on a manual axis is all-gathered
    over that axis's group and concatenated along the dim, which gives the
    global array; one under ``PartitionSpec()`` comes back as the rank's
    own value.  As in the reference under ``check_vma=False``, nothing
    checks that the ranks agree.  While ``f`` runs, the manual axes are
    recorded for :func:`constrain`.  An axis that is not manual must have
    size 1: placing tensors within a manual block waits with the
    collectives slice.

    Gradients cross the map where a leaf requires them, with the
    reference's semantics for a loss that every rank computes alike from
    the global outputs.  An output's cotangent gives the rank its own
    block, divided by the size of the manual axes the output's spec does
    not name (the body computes such an output once a rank of them, or
    sums it there with :func:`psum`, whose backward sums the cotangent
    back).  An input's gradient is the rank's block placed at its offset
    in zeros of the input's shape and summed over the ranks of every
    manual axis, so each rank holds the global gradient.  A leaf that
    does not require grad, or a call under ``torch.no_grad``, takes no
    autograd node: the forward's tensors and bits are the same.
    """
    sizes = mesh_axes(mesh)
    manual = (frozenset(sizes) if axis_names is None
              else frozenset(axis_names))
    if not manual <= set(sizes):
        raise ValueError(f"{mesh!r} has no axes "
                         f"{sorted(manual - set(sizes))}")
    auto = {a: n for a, n in sizes.items() if a not in manual and n > 1}
    if auto:
        raise NotImplementedError(
            f"shard_map manual over {sorted(manual)} leaves {auto} "
            f"automatic on {mesh!r}: placing tensors within a manual block "
            f"needs collectives, which wait with {_COLLECTIVES}")
    if isinstance(mesh, AbstractMesh):
        raise ValueError(f"{mesh!r} is shape-only: it has no ranks")
    axes_in_order = [a for a in sizes if a in manual]

    def differentiable(leaf) -> bool:
        return (torch.is_tensor(leaf) and leaf.requires_grad
                and torch.is_grad_enabled())

    def cut(leaf, spec):
        cuts = _manual_dims(leaf, spec, manual)
        if differentiable(leaf):
            return _Cut.apply(leaf, cuts, sizes, mesh,
                              [mesh.get_group(a) for a in axes_in_order])
        return _block(leaf, cuts, sizes, mesh) if cuts else leaf

    def gather(leaf, spec):
        cuts = _manual_dims(leaf, spec, manual)
        named = {a for _, axes in cuts for a in axes}
        unnamed = math.prod(sizes[a] for a in manual - named)
        if not cuts and not (differentiable(leaf) and unnamed > 1):
            return leaf
        return _Gather.apply(leaf, cuts, sizes, mesh, unnamed)

    def mapped(*args):
        specs = (tuple(in_specs for _ in args)
                 if isinstance(in_specs, PartitionSpec) else tuple(in_specs))
        local = _spec_map(cut, specs, args, "in")
        token = _MANUAL_AXES.set(_MANUAL_AXES.get() | manual)
        try:
            out = f(*local)
        finally:
            _MANUAL_AXES.reset(token)
        return _spec_map(gather, out_specs, out, "out")

    return mapped


# --- detection fleet (replica mesh) -----------------------------------------

def slot_sharding(mesh, n_slots: int) -> NamedSharding:
    """NamedSharding splitting a (slots, H, W) grid's slot axis over the
    replica mesh (replicated fallback when slots don't divide it)."""
    return named_sharding(
        ("slots", "row", "col"), (n_slots, 1, 1), mesh, DETECTION_RULES,
    )


def shard_slots(batch, mesh) -> torch.Tensor:
    """Place a host-side (slots, H, W) batch slot-sharded on ``mesh``: the
    one explicit transfer of a detection dispatch (the frame-independent
    kernels then run on each replica's frames with no collective)."""
    t = batch if torch.is_tensor(batch) else torch.from_numpy(
        np.ascontiguousarray(batch))
    return distribute_tree(t, slot_sharding(mesh, t.shape[0]))


def rules_for_shape(shape_kind: str) -> AxisRules:
    """Pick the rule table for a workload shape class.

    train_*   -> DEFAULT (FSDP+TP, batch DP)
    prefill_* -> SP (sequence-sharded activations between blocks)
    decode_* / long_* -> DECODE (cache-resident layout)
    """
    if shape_kind.startswith("prefill"):
        return SP_RULES
    if shape_kind.startswith(("decode", "long")):
        return DECODE_RULES
    return DEFAULT_RULES
