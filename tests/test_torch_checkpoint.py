"""The port's checkpoint store against the JAX package's, on the CPU:
round trips of tensor trees and train states (bf16 stored as a uint16
view), shape and dtype validation, async saves with retention, atomicity,
and each package reading the other's checkpoints (the same layout and
keys)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.checkpoint import save as jsave  # noqa: E402
from repro.train.state import TrainState as JTrainState  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, latest_step, restore, save,
)
from repro_torch.train import TrainState, init_train_state  # noqa: E402


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32)
                                  ).to(torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(t):
    from repro_torch.checkpoint.store import _flatten_with_paths
    return _flatten_with_paths(t)


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, k
        assert torch.equal(x, y), k


def test_save_restore_roundtrip(tmp_path):
    state = tree()
    save(state, str(tmp_path), 7)
    assert latest_step(str(tmp_path)) == 7
    got = restore(str(tmp_path), tree(1))
    _assert_same(got, state)


def test_train_state_roundtrip_keys_and_layout(tmp_path):
    """A TrainState's leaves are keyed ``.step``, ``.params/...``,
    ``.opt/m/...`` as the reference keys them; ``err=None`` has none."""
    st = init_train_state({"a": {"w": torch.randn(3, 2)},
                           "b": torch.randn(4).to(torch.bfloat16)})
    st = st._replace(step=torch.tensor(5, dtype=torch.int32))
    path = save(st, str(tmp_path), 5)
    assert sorted(os.listdir(path)) == sorted(
        [".opt__m__a__w.npy", ".opt__m__b.npy", ".opt__v__a__w.npy",
         ".opt__v__b.npy", ".params__a__w.npy", ".params__b.npy",
         ".step.npy", "manifest.json"])
    assert np.load(os.path.join(path, ".params__b.npy")).dtype == np.uint16
    got = restore(str(tmp_path), init_train_state(
        {"a": {"w": torch.zeros(3, 2)},
         "b": torch.zeros(4, dtype=torch.bfloat16)}))
    assert isinstance(got, TrainState) and got.err is None
    _assert_same(got, st)


def test_restore_validates_shapes_and_dtypes(tmp_path):
    save(tree(), str(tmp_path), 1)
    bad = tree()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), bad)
    bad = tree()
    bad["params"]["b"] = torch.zeros(8)
    with pytest.raises(ValueError, match="dtype"):
        restore(str(tmp_path), bad)
    bad = tree()
    bad["params"]["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="no leaf"):
        restore(str(tmp_path), bad)
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), tree())


def test_async_manager_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30, 40):
        mgr.save_async(tree(step), step)
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [30, 40]
    _assert_same(mgr.restore_latest(tree()), tree(40))


def test_atomicity_no_tmp_left(tmp_path):
    save(tree(), str(tmp_path), 5)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save_async(tree(), 6)
    mgr.save_sync(tree(), 7)
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert latest_step(str(tmp_path)) == 7


def test_async_snapshot_survives_in_place_updates(tmp_path):
    """``save_async`` copies each tensor before it returns: zeroing the
    state in place afterwards does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = tree(1)
    mgr.save_async(state, 1)
    for _, leaf in _leaves(state):
        leaf.zero_()
    mgr.wait()
    _assert_same(mgr.restore_latest(tree()), tree(1))


def test_async_error_surfaces_on_wait(tmp_path, monkeypatch):
    """A write that fails on the background thread raises on the next
    ``wait`` (and so on the next save), once."""
    from repro_torch.checkpoint import store

    def broken(state, directory, step):
        raise OSError(f"disk gone at step {step}")

    mgr = CheckpointManager(str(tmp_path), keep=3)
    monkeypatch.setattr(store, "save", broken)
    mgr.save_async({"x": torch.zeros(2)}, 2)
    with pytest.raises(OSError, match="step 2"):
        mgr.wait()
    mgr.wait()
    monkeypatch.undo()
    mgr.save_async({"x": torch.ones(2)}, 3)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 3


def _jstate(seed=0):
    rng = np.random.default_rng(seed)
    p = {"a": {"w": jnp.asarray(rng.normal(size=(3, 2)), jnp.float32)},
         "b": jnp.asarray(rng.normal(size=(4,)), jnp.bfloat16)}
    z = jax.tree.map(jnp.zeros_like, p)
    return JTrainState(jnp.int32(9), p, {"m": p, "v": z}, None)


def _tstate(js):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True))
    t = jax.tree.map(conv, js)
    return TrainState(t.step, t.params, t.opt, None)


def test_the_port_reads_the_references_checkpoints(tmp_path):
    js = _jstate()
    jsave(js, str(tmp_path), 9)
    got = restore(str(tmp_path), _tstate(_jstate(1)))
    _assert_same(got, _tstate(js))


def test_the_reference_reads_the_ports_checkpoints(tmp_path):
    js = _jstate()
    save(_tstate(js), str(tmp_path), 9)
    got = jrestore(str(tmp_path), _jstate(1))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
