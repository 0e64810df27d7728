"""Elastic checkpoint / restart on one device: the port's ``restore(...,
shardings=)``, ``CheckpointManager.restore_latest(shardings=)`` and
``run_with_restarts(state_template=, shardings=, on_restart=)`` against
the JAX package's, on the CPU.

Checkpoints cross between the packages placed both ways (the reference's
``test_elastic_checkpoint_resharding`` at one device): the reference's save
of a SMOKE yi-9b parameter tree placed on a one-device ``jax.make_mesh``
restores in the port into ``Model.abstract_params()`` (``meta``) on the
host mesh and on the replica mesh, and the port's save of a placed tree
restores in the reference with ``shardings=``.  Both packages'
supervisors, driven by one deterministic step function, agree on stats,
final leaves and ``on_restart`` calls; the port's SMOKE zamba2-1.2b step
under a fault schedule, restored into ``meta`` specs and moved to the
replica mesh by the hook, ends bit-equal to its uninterrupted run.

The meshes are world-size-1 gloo ``DeviceMesh``es on an in-memory
``HashStore``, made by ``launch.mesh`` and destroyed by the
``gloo_group`` fixture.  One torch thread, SMOKE shapes, no spawned rank,
no sleep.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import runtime as jruntime  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.sharding import shardings_for_tree as jshardings_for_tree  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, restore, save  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import TokenPipelineConfig, TokenStream  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.runtime import supervisor  # noqa: E402
from repro_torch.runtime.supervisor import (  # noqa: E402
    FaultInjector, WorkerFailure, run_with_restarts,
)
from repro_torch.sharding import shardings_for_tree  # noqa: E402
from repro_torch.sharding.partition import (  # noqa: E402
    NamedSharding, PartitionSpec, distribute_tree, local_tree, placed_like,
)
from repro_torch.train import (  # noqa: E402
    AdamWConfig, init_train_state, make_train_step, train_state_shardings,
    train_state_specs,
)

MESHES = ("host", "replica")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gloo_group():
    """No process group before the test; the one ``launch.mesh`` makes is
    destroyed after it, and none is left."""
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()


def _mesh(kind):
    if kind == "host":
        return mesh_lib.make_host_mesh(device="cpu")
    return mesh_lib.make_replica_mesh(1, device="cpu")


def _leaves(tree):
    return store._flatten_with_paths(tree)


def _np_of(t):
    """A port tensor's bits as numpy (bf16 as its uint16 view)."""
    t = local_tree(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _np_of_jax(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_placed(tree, shardings):
    """Every leaf a DTensor on its sharding's mesh with its placements."""
    got, want = _leaves(tree), _leaves(shardings)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, t), (_, sh) in zip(got, want):
        assert isinstance(t, DTensor), key
        assert t.device_mesh is sh.mesh, key
        assert t.placements == sh.placements, key
        assert t.to_local().device.type == "cpu", key


# --- signatures -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["restore", "restore_latest",
                                  "run_with_restarts"])
def test_signatures_match_the_reference(name):
    """Parameter names, kinds and defaults equal the reference's."""
    got, want = {
        "restore": (restore, jckpt.restore),
        "restore_latest": (CheckpointManager.restore_latest,
                           jckpt.CheckpointManager.restore_latest),
        "run_with_restarts": (run_with_restarts,
                              jruntime.run_with_restarts),
    }[name]

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(got) == params(want)


# --- checkpoints across the packages, placed both ways ---------------------------


def _yi_pair(dtype):
    jcfg = jget_smoke("yi-9b")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(get_smoke("yi-9b"), device="cpu")
    target = m.abstract_params()
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
        target = tree_map(lambda t: t.to(torch.bfloat16), target)
    return jm, jp, m, target


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_port_restores_the_references_placed_checkpoint(
        tmp_path, gloo_group, dtype):
    """The reference saves SMOKE yi-9b's parameters placed on a one-device
    (1, 1) mesh; the port restores them into ``meta`` targets with
    shardings on the host mesh and then on the replica mesh: bit-equal
    values, each leaf a DTensor with its sharding's placements (on the
    replica mesh every placement is ``Replicate``: ``"replica"`` matches
    no rule)."""
    jm, jp, m, target = _yi_pair(dtype)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jsave_tree = jax.device_put(jp, jshardings_for_tree(
        jm.param_axes(), jm.abstract_params(), jmesh))
    jckpt.save(jsave_tree, str(tmp_path), 1)
    want = {k: _np_of_jax(v) for k, v in
            jckpt.store._flatten_with_paths(jp)}
    assert all(t.device.type == "meta" for _, t in _leaves(target))
    for kind in MESHES:
        mesh = _mesh(kind)
        sh = shardings_for_tree(m.param_axes(), target, mesh)
        got = restore(str(tmp_path), target, shardings=sh)
        _assert_placed(got, sh)
        assert [k for k, _ in _leaves(got)] == list(want)
        for key, t in _leaves(got):
            assert str(t.dtype) == f"torch.{dtype}", key
            np.testing.assert_array_equal(_np_of(t), want[key], err_msg=key)
        if kind == "replica":
            assert all(s.placements == (Replicate(),)
                       for _, s in _leaves(sh))
        else:
            assert any(s.placements != (Replicate(), Replicate())
                       for _, s in _leaves(sh))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_reference_restores_the_ports_placed_checkpoint(
        tmp_path, gloo_group, dtype):
    """The port saves a tree placed on the host mesh (DTensor leaves); the
    reference restores it with ``shardings=`` on a one-device mesh, bit
    for bit, and the files know no mesh (the same keys, shapes and dtypes
    as an unplaced save)."""
    jm, _, m, target = _yi_pair(dtype)
    params = tree_map(lambda t: t.to(getattr(torch, dtype)),
                      m.init_master(torch.Generator().manual_seed(3)))
    mesh = _mesh("host")
    placed = distribute_tree(params, shardings_for_tree(
        m.param_axes(), target, mesh))
    path = save(placed, str(tmp_path / "placed"), 2)
    plain = save(params, str(tmp_path / "plain"), 2)
    for name in sorted(p.name for p in (tmp_path / "plain" /
                                        "step_00000002").iterdir()):
        a = open(f"{path}/{name}", "rb").read()
        assert a == open(f"{plain}/{name}", "rb").read(), name

    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jabs = jm.abstract_params()
    if dtype == "bfloat16":
        jabs = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16), jabs)
    jsh = jshardings_for_tree(jm.param_axes(), jabs, jmesh)
    got = jckpt.restore(str(tmp_path / "placed"), jabs, shardings=jsh)
    for (key, a), (_, sh), (_, t) in zip(
            jckpt.store._flatten_with_paths(got),
            jckpt.store._flatten_with_paths(jsh), _leaves(params)):
        assert a.sharding == sh, key
        assert str(a.dtype) == dtype, key
        np.testing.assert_array_equal(_np_of_jax(a), _np_of(t), err_msg=key)


# --- restore into placed and abstract targets -----------------------------------


def _small(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(6,)).astype(np.float32)
                                  ).to(torch.bfloat16),
            "step": torch.tensor(seed, dtype=torch.int32)}


def _meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _replicated(tree, mesh):
    return tree_map(lambda t: NamedSharding(mesh, PartitionSpec()), tree)


def test_restore_into_a_placed_target_keeps_its_mesh(tmp_path, gloo_group):
    """Without ``shardings`` a DTensor target leaf gives its mesh and
    placements to the restored leaf, and a plain target leaf its device;
    each restored leaf owns its storage."""
    mesh = _mesh("host")
    save(_small(1), str(tmp_path), 1)
    like = distribute_tree(_small(0), _replicated(_small(0), mesh))
    got = restore(str(tmp_path), like)
    _assert_placed(got, _replicated(_small(0), mesh))
    for (key, t), (_, w) in zip(_leaves(got), _leaves(_small(1))):
        assert torch.equal(t.to_local(), w), key
    plain = restore(str(tmp_path), _small(0))
    for (key, t), (_, target) in zip(_leaves(plain), _leaves(_small(0))):
        assert not isinstance(t, DTensor) and t.device.type == "cpu", key
        assert t.data_ptr() != target.data_ptr()


def test_restore_latest_passes_shardings_through(tmp_path, gloo_group):
    """``restore_latest(meta target, shardings=)`` on the replica mesh: the
    bf16, f32 and int32 leaves come back bit-equal and placed."""
    mesh = _mesh("replica")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save_async(_small(5), 5)
    sh = _replicated(_small(0), mesh)
    got = mgr.restore_latest(_meta(_small(0)), shardings=sh)
    _assert_placed(got, sh)
    for (key, t), (_, w) in zip(_leaves(got), _leaves(_small(5))):
        assert t.dtype == w.dtype and torch.equal(t.to_local(), w), key


def test_async_save_of_a_placed_tree_is_a_copy(tmp_path, gloo_group):
    """``distribute_tree`` shares storage with its input; ``save_async``
    copies each leaf before it returns, so zeroing the placed state's
    local tensors in place does not reach the checkpoint."""
    mesh = _mesh("host")
    state = _small(2)
    placed = distribute_tree(state, _replicated(state, mesh))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save_async(placed, 2)
    for _, t in _leaves(state):
        t.zero_()
    got = mgr.restore_latest(_small(0))
    for (key, t), (_, w) in zip(_leaves(got), _leaves(_small(2))):
        assert torch.equal(t, w), key


def test_meta_target_without_shardings_raises_without_a_card(tmp_path):
    """A ``meta`` leaf with no sharding goes where the device rule sends
    an entry point: the card, so a host without one raises and nothing
    comes back ``meta`` or silently on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the leaves go to it")
    save(_small(1), str(tmp_path), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore(str(tmp_path), _meta(_small(0)))


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_a_mismatch_raises_before_any_leaf_is_placed(tmp_path, gloo_group,
                                                    monkeypatch, bad):
    """The last leaf in key order (``w``) is wrong; the first two are right:
    the restore raises before it reads or places any leaf."""
    mesh = _mesh("host")
    save(_small(1), str(tmp_path), 1)
    target = _meta(_small(0))
    target["w"] = (torch.empty((6, 4), device="meta") if bad == "shape"
                   else torch.empty((4, 6), dtype=torch.bfloat16,
                                    device="meta"))
    touched = []
    monkeypatch.setattr(store, "_place",
                        lambda *a: touched.append(a) or a[0])
    monkeypatch.setattr(store.np, "load",
                        lambda *a, **k: touched.append(a) or None)
    with pytest.raises(ValueError, match=bad):
        restore(str(tmp_path), target, shardings=_replicated(target, mesh))
    assert touched == []


def test_a_dtensor_on_a_larger_mesh_refuses_to_save(tmp_path, gloo_group):
    """Saving a leaf placed on a 2-device mesh needs its shards gathered,
    which waits with the collectives slice."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard

    _mesh("replica")
    two = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("replica",),
                     _init_backend=False)
    d = DTensor.from_local(torch.zeros(2, 3), two, [Shard(0)],
                           run_check=False)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 7"):
        save({"x": d}, str(tmp_path), 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 7"):
        CheckpointManager(str(tmp_path)).save_async({"x": d}, 1)


# --- run_with_restarts against the reference ------------------------------------


def _drive_both(tmp_path, hook: bool):
    """Both packages' ``run_with_restarts`` on ``{"step", "x"}`` with
    ``x <- x * 0.5 + (step + 1)`` (the halving is exact, so one rounding a
    step in either package), a ``state_template`` and, with ``hook``, an
    ``on_restart`` that returns one-device shardings at the first restart
    and ``None`` after.  The port's template is ``meta``: its restores
    need the hook's shardings.  Returns each side's (final, stats, hook
    calls, the placement each port step saw)."""
    x0 = np.arange(8, dtype=np.float32) * 3.0
    out = {}

    jinit = {"step": jnp.int32(0), "x": jnp.asarray(x0)}
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jsh = jax.tree.map(lambda _: jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec()), jinit)
    jinj, jcalls = jruntime.FaultInjector(fail_at_steps=(4, 9)), []

    def jstep(state, step):
        jinj.check(step)
        return {"step": state["step"] + 1,
                "x": state["x"] * 0.5 + jnp.float32(step + 1)}

    def jhook(restarts):
        jcalls.append(restarts)
        return jsh if restarts == 1 else None

    out["ref"] = jruntime.run_with_restarts(
        init_state=jinit, step_fn=jstep, n_steps=12,
        ckpt=jckpt.CheckpointManager(str(tmp_path / "ref"), keep=3),
        ckpt_every=3,
        state_template=jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jinit),
        on_restart=jhook if hook else None) + (jcalls,)

    init = {"step": torch.tensor(0, dtype=torch.int32),
            "x": torch.from_numpy(x0.copy())}
    inj, calls, seen = FaultInjector(fail_at_steps=(4, 9)), [], []
    mesh = _mesh("replica") if hook else None

    def step_fn(state, step):
        inj.check(step)
        seen.append(getattr(state["x"], "device_mesh", None))
        s = local_tree(state)
        return placed_like({"step": s["step"] + 1,
                            "x": s["x"] * 0.5 + float(step + 1)}, state)

    def on_restart(restarts):
        calls.append(restarts)
        return _replicated(init, mesh) if restarts == 1 else None

    out["port"] = run_with_restarts(
        init_state=init, step_fn=step_fn, n_steps=12,
        ckpt=CheckpointManager(str(tmp_path / "port"), keep=3),
        ckpt_every=3,
        state_template=_meta(init) if hook else tree_map(torch.zeros_like,
                                                          init),
        on_restart=on_restart if hook else None) + (calls, seen, mesh)
    return out


@pytest.mark.parametrize("hook", [False, True])
def test_run_with_restarts_agrees_with_the_reference(tmp_path, gloo_group,
                                                      hook):
    out = _drive_both(tmp_path, hook)
    jfinal, jstats, jcalls = out["ref"]
    final, stats, calls, seen, mesh = out["port"]
    assert stats == jstats == {"restarts": 2, "completed_steps": 12,
                               "resumed_from": [3, 9]}
    assert calls == jcalls == ([1, 2] if hook else [])
    for key in ("step", "x"):
        np.testing.assert_array_equal(_np_of(final[key]),
                                      np.asarray(jfinal[key]), err_msg=key)
    if hook:
        # steps 0-3 on the unplaced state; every step after the first
        # restart on the replica mesh, the mesh the hook returned
        assert seen[:4] == [None] * 4 and len(seen) == 13
        assert all(m is mesh for m in seen[4:])
        _assert_placed(final, _replicated(final, mesh))
    else:
        assert seen == [None] * 13
        assert not isinstance(final["x"], DTensor)


def test_the_restart_budget_raises_after_the_same_hook_calls(tmp_path):
    """Three failures against ``max_restarts=2``: both packages call the
    hook at restarts 1 and 2, then raise ``WorkerFailure``."""
    jinj = jruntime.FaultInjector(fail_at_steps=(1, 2, 3))
    jcalls, calls = [], []

    def jstep(state, step):
        jinj.check(step)
        return state

    with pytest.raises(jruntime.WorkerFailure):
        jruntime.run_with_restarts(
            init_state={"x": jnp.zeros(2)}, step_fn=jstep, n_steps=5,
            ckpt=jckpt.CheckpointManager(str(tmp_path / "j"), keep=2),
            max_restarts=2, on_restart=jcalls.append)
    inj = FaultInjector(fail_at_steps=(1, 2, 3))

    def step(state, s):
        inj.check(s)
        return state

    with pytest.raises(WorkerFailure):
        run_with_restarts(
            init_state={"x": torch.zeros(2)}, step_fn=step, n_steps=5,
            ckpt=CheckpointManager(str(tmp_path / "p"), keep=2),
            max_restarts=2, on_restart=calls.append)
    assert calls == jcalls == [1, 2]


# --- the port's train step under restarts ---------------------------------------


def test_zamba2_restarts_onto_the_replica_mesh_end_bit_equal(tmp_path,
                                                             gloo_group):
    """SMOKE zamba2-1.2b, placed on the host mesh by
    ``train_state_shardings``, under failures at steps 4 and 9 with
    checkpoints every 3 steps; ``state_template`` is the ``meta`` state of
    ``train_state_specs`` and the hook moves the run to the replica mesh
    at the first restart.  The final state equals the uninterrupted
    placed run's bit for bit, and sits on the replica mesh with its
    shardings' placements (all ``Replicate``)."""
    cfg = get_smoke("zamba2-1.2b")
    m = build(cfg, device="cpu")
    host, replica = _mesh("host"), _mesh("replica")
    _, host_sh = train_state_shardings(m, host)
    _, replica_sh = train_state_shardings(m, replica)
    state0 = distribute_tree(init_train_state(
        m.init_master(torch.Generator().manual_seed(0))), host_sh)
    step_fn = make_train_step(m, AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                             decay_steps=50))
    stream = TokenStream(TokenPipelineConfig(vocab=cfg.vocab, seq_len=16,
                                             global_batch=2, seed=3))

    def drive(state, step):
        batch = {k: torch.from_numpy(v)
                 for k, v in stream.batch_at(step).items()}
        return step_fn(state, batch)[0]

    want = state0
    for s in range(12):
        want = drive(want, s)
    inj, calls = FaultInjector(fail_at_steps=(4, 9)), []

    def faulty(state, step):
        inj.check(step)
        return drive(state, step)

    def on_restart(restarts):
        calls.append(restarts)
        return replica_sh if restarts == 1 else None

    final, stats = run_with_restarts(
        init_state=state0, step_fn=faulty, n_steps=12,
        ckpt=CheckpointManager(str(tmp_path), keep=3), ckpt_every=3,
        state_template=train_state_specs(m)[0], on_restart=on_restart)
    assert stats == {"restarts": 2, "completed_steps": 12,
                     "resumed_from": [3, 9]}
    assert calls == [1, 2]
    _assert_placed(final, replica_sh)
    assert all(s.placements == (Replicate(),) for _, s in _leaves(replica_sh))
    _assert_placed(want, host_sh)
    got, ref = _leaves(local_tree(final)), _leaves(local_tree(want))
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (key, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), key
    assert supervisor.latest_step(str(tmp_path)) == 12
