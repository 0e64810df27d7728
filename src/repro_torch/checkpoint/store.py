"""Filesystem checkpoint store for trees of torch tensors
(``repro/checkpoint/store.py``), in the reference's layout:

    <dir>/step_<N>/manifest.json     tree keys, shapes, dtypes
    <dir>/step_<N>/<leaf_key>.npy    one array per leaf
    <dir>/step_<N>.tmp/...           staging (atomic rename on completion)

A tree is nested dicts (keys sorted) and NamedTuples (a field ``f``
keyed ``.f``; a ``None`` field has no leaf) with tensors as leaves; keys
are the reference's, so either package reads the other's checkpoints.
bf16 is stored as a uint16 view with the logical dtype in the manifest.
A placed tree (DTensor leaves on a one-device mesh, ``distribute_tree``)
is written as its full values: the files and the manifest know no mesh.

  * **atomic**: a checkpoint directory appears only after every leaf is
    written (tmp dir + rename), so a crash mid-save never leaves a half
    checkpoint that restore would trust;
  * **async**: ``CheckpointManager.save_async`` copies the tensors to host
    memory at once and writes them on a background thread while training
    goes on;
  * **elastic restore**: every leaf's shape and dtype is checked against
    the target (tensors, or ``meta`` tensors as ``Model.abstract_params``
    and ``train_state_specs`` give them) before any is placed; then each
    is placed by ``shardings`` (a matching tree of ``NamedSharding``, on
    whatever mesh the caller has now) or, without it, as its target leaf
    is;
  * **retention**: the last ``keep`` checkpoints are kept.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.partition import (
    distribute_tree, local_tree, placed_like,
)

# numpy has no bf16: store it as a same-width integer view
_EXOTIC_VIEW = {"bfloat16": (torch.int16, np.uint16)}


def _flatten_with_paths(tree: Any, prefix: tuple = ()) -> list:
    """(key, leaf) pairs in the reference's order and key format."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple):                      # a NamedTuple
        return [kv for f in tree._fields
                for kv in _flatten_with_paths(getattr(tree, f),
                                              prefix + ("." + f,))]
    return [("/".join(prefix), tree)]


def _rebuild(target: Any, leaves) -> Any:
    """``target``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if target is None:
        return None
    if isinstance(target, dict):
        out = {k: _rebuild(target[k], leaves) for k in sorted(target)}
        return {k: out[k] for k in target}
    if isinstance(target, tuple):                    # a NamedTuple
        return type(target)(*(_rebuild(getattr(target, f), leaves)
                              for f in target._fields))
    return next(leaves)


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).removeprefix("torch.")


def _host(leaf, *, copy: bool = False) -> torch.Tensor:
    """A leaf's full value on the host: a DTensor's local tensor by
    ``local_tree``'s one-device rule (a larger mesh raises), then a copy
    on the CPU where ``copy`` is set (or the leaf is elsewhere)."""
    t = local_tree(leaf).detach()
    return t.to("cpu", copy=True) if copy else t.cpu()


def _place(t: torch.Tensor, leaf, sharding, meta_device) -> torch.Tensor:
    """A loaded host tensor placed for its target ``leaf``: by
    ``sharding`` when one is given, else as the leaf is (a DTensor's mesh
    and placements, a tensor's device, and ``meta_device`` for a ``meta``
    leaf)."""
    from torch.distributed.tensor import DTensor

    if sharding is not None:
        return distribute_tree(t, sharding)
    if isinstance(leaf, DTensor):
        return placed_like(t.to(local_tree(leaf).device), leaf)
    return t.to(meta_device if leaf.device.type == "meta" else leaf.device)


def save(state: Any, directory: str, step: int) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for key, leaf in _flatten_with_paths(state):
        t = _host(leaf)
        logical = _dtype_name(t)
        if logical in _EXOTIC_VIEW:
            tview, nview = _EXOTIC_VIEW[logical]
            arr = t.contiguous().view(tview).numpy().view(nview)
        else:
            arr = t.numpy()
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, target: Any, step: Optional[int] = None,
            shardings: Any = None) -> Any:
    """Load into the structure of ``target``, a tree of tensors or of
    ``meta`` tensors.  Every leaf's shape and dtype is checked against the
    target leaf's before any leaf is read or placed.  ``shardings``, an
    optional tree of ``NamedSharding`` matching ``target``, places each
    leaf on its mesh with its placements (``distribute_tree``: a DTensor
    on a one-device mesh).  Without it a leaf is placed as its target leaf
    is: a DTensor's mesh and placements, a tensor's device, and for a
    ``meta`` leaf the card (the port's device rule: where there is none,
    this raises).  ``step=None`` takes the latest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}

    leaves = _flatten_with_paths(target)
    if shardings is None:
        flat_shard = [None] * len(leaves)
    else:
        pairs = _flatten_with_paths(shardings)
        if [k for k, _ in pairs] != [k for k, _ in leaves]:
            raise ValueError("shardings do not match the target's leaves")
        flat_shard = [s for _, s in pairs]
    meta_device = None
    for (key, leaf), shard in zip(leaves, flat_shard):
        entry = by_key.get(key)
        if entry is None:
            raise ValueError(f"checkpoint {path} has no leaf {key}")
        if tuple(entry["shape"]) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key} shape "
                             f"{tuple(entry['shape'])} != target "
                             f"{tuple(leaf.shape)}")
        if entry["dtype"] != _dtype_name(leaf):
            raise ValueError(f"checkpoint leaf {key} dtype {entry['dtype']}"
                             f" != target {_dtype_name(leaf)}")
        if shard is None and leaf.device.type == "meta" \
                and meta_device is None:
            meta_device = resolve_device(None)

    out = []
    for (key, leaf), shard in zip(leaves, flat_shard):
        entry = by_key[key]
        arr = np.load(os.path.join(path, entry["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != "
                             f"target {tuple(leaf.shape)}")
        if entry["dtype"] in _EXOTIC_VIEW:
            tview, nview = _EXOTIC_VIEW[entry["dtype"]]
            t = torch.from_numpy(arr.view(nview)).view(tview).view(
                leaf.dtype)
        else:
            t = torch.from_numpy(arr)
        out.append(_place(t, leaf, shard, meta_device))
    return _rebuild(target, iter(out))


class CheckpointManager:
    """Async save + retention."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, state: Any, step: int):
        """Copy to host now; write to disk in the background."""
        self.wait()
        host = _rebuild(state, iter([
            _host(leaf, copy=True) for _, leaf in _flatten_with_paths(state)]))

        def work():
            try:
                save(host, self.directory, step)
                self._gc()
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, state: Any, step: int) -> str:
        self.wait()
        path = save(state, self.directory, step)
        self._gc()
        return path

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, target: Any, shardings: Any = None) -> Any:
        self.wait()
        return restore(self.directory, target, shardings=shardings)
