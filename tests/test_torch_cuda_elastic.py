"""Elastic restore on the card at SMOKE size: a zamba2-1.2b TrainState
placed on ``make_host_mesh()`` is saved and restored into the ``meta``
state of ``train_state_specs`` with shardings on the host mesh and on
``make_replica_mesh(1)``: every leaf equal bit for bit, a DTensor on the
card with its sharding's placements.  A step from each restored state
equals the step from the saved one, with the same launches of
``flash_attention`` and ``ssd_scan``; ``run_with_restarts`` with a fault,
a ``meta`` template and a hook that moves the run to the replica mesh ends
equal to the uninterrupted run, its launches the steps run times the
launches a step.  The meshes' process group is nccl on an in-memory
``HashStore``, destroyed after each test.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_elastic.py

This file imports nothing of the JAX package.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, restore, save  # noqa: E402
from repro_torch.checkpoint.store import _flatten_with_paths  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import TokenPipelineConfig, TokenStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_replica_mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.runtime import FaultInjector, run_with_restarts  # noqa: E402
from repro_torch.sharding.partition import local_tree  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig, distribute_tree, init_train_state, make_train_step,
    train_state_shardings, train_state_specs,
)

KERNELS = ("flash_attention", "ssd_scan")


@pytest.fixture
def card():
    """The card, with a process group made by ``launch.mesh`` and
    destroyed after the test; skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels have no CPU "
                    "mode)")
    assert not dist.is_initialized()
    try:
        yield torch.device("cuda", torch.cuda.current_device())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()


def _setup(card):
    cfg = get_smoke("zamba2-1.2b")
    m = build(cfg)
    stream = TokenStream(TokenPipelineConfig(vocab=cfg.vocab, seq_len=64,
                                             global_batch=2, seed=3))
    step_fn = make_train_step(m, AdamWConfig(peak_lr=1e-3, warmup_steps=0,
                                             decay_steps=20))

    def drive(state, step):
        batch = {k: torch.from_numpy(v).to(card)
                 for k, v in stream.batch_at(step).items()}
        return step_fn(state, batch)[0]

    state = init_train_state(m.init_master(torch.Generator(card)
                                           .manual_seed(0)))
    return m, state, drive


def _assert_equal_and_placed(got, want, shardings, card):
    from torch.distributed.tensor import DTensor

    g, w, s = (_flatten_with_paths(t) for t in (got, want, shardings))
    assert [k for k, _ in g] == [k for k, _ in w] == [k for k, _ in s]
    for (key, a), (_, b), (_, sh) in zip(g, w, s):
        assert isinstance(a, DTensor), key
        assert a.device_mesh is sh.mesh and a.placements == sh.placements
        assert a.to_local().device == card, key
        assert torch.equal(a.to_local(), local_tree(b)), key


def _step_launches(drive, state, step):
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    new = drive(state, step)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    return new, {k: counts[k] for k in KERNELS}


@pytest.mark.cuda
def test_placed_state_restores_on_both_meshes(card, tmp_path):
    m, state, drive = _setup(card)
    host, replica = make_host_mesh(), make_replica_mesh(1)
    _, host_sh = train_state_shardings(m, host)
    placed = distribute_tree(state, host_sh)
    save(placed, str(tmp_path), 0)
    want, want_launches = _step_launches(drive, placed, 0)
    assert all(v > 0 for v in want_launches.values())
    for mesh in (host, replica):
        _, sh = train_state_shardings(m, mesh)
        got = restore(str(tmp_path), train_state_specs(m)[0], shardings=sh)
        _assert_equal_and_placed(got, placed, sh, card)
        new, launches = _step_launches(drive, got, 0)
        assert launches == want_launches
        _assert_equal_and_placed(new, want, sh, card)


@pytest.mark.cuda
def test_restarts_onto_the_replica_mesh_keep_the_launches(card, tmp_path):
    m, state, drive = _setup(card)
    host, replica = make_host_mesh(), make_replica_mesh(1)
    _, host_sh = train_state_shardings(m, host)
    _, replica_sh = train_state_shardings(m, replica)
    state = distribute_tree(state, host_sh)
    _, per_step = _step_launches(drive, state, 0)
    want = state
    for s in range(6):
        want = drive(want, s)
    inj, steps_run = FaultInjector(fail_at_steps=(3,)), []

    def faulty(s, step):
        inj.check(step)
        steps_run.append(step)
        return drive(s, step)

    ops.reset_launch_counts()
    final, stats = run_with_restarts(
        init_state=state, step_fn=faulty, n_steps=6,
        ckpt=CheckpointManager(str(tmp_path), keep=2), ckpt_every=2,
        state_template=train_state_specs(m)[0],
        on_restart=lambda r: replica_sh)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert stats == {"restarts": 1, "completed_steps": 6,
                     "resumed_from": [2]}
    assert steps_run == [0, 1, 2, 2, 3, 4, 5]
    assert {k: counts[k] for k in KERNELS} == {
        k: len(steps_run) * v for k, v in per_step.items()}
    _assert_equal_and_placed(final, want, replica_sh, card)
