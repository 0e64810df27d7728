"""The sharding layer on the card: each user's path placed on a one-device
``DeviceMesh`` against the same path unplaced, bit for bit, at SMOKE size.

(a) a zamba2-1.2b train step from a state placed by
``train_state_shardings`` (the batch by the batch shardings) on
``make_host_mesh()``; (b) a prefill and 4 decode steps with the parameters
and the cache placed under DECODE_RULES through ``Model.cache_spec``; (c) a
``shard_slots`` batch on ``make_replica_mesh(1)`` through
``DetectionPlan.run``, staged and fused.  The meshes' process group is
nccl on an in-memory ``HashStore``, destroyed after each test.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sharding.py

This file imports nothing of the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ShapeSpec, get_smoke  # noqa: E402
from repro_torch.core import HoughConfig, PipelineConfig  # noqa: E402
from repro_torch.core.plan import DetectionPlan  # noqa: E402
from repro_torch.data import scenario_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_replica_mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.models.layers import tree_items  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    DECODE_RULES, DEFAULT_RULES, activate, shardings_for_tree,
)
from repro_torch.sharding.partition import shard_slots  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig, distribute_tree, init_train_state, make_train_step,
    train_state_shardings,
)


@pytest.fixture
def card():
    """The card, with a process group made by the mesh builders and
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


def _leaves(state) -> dict:
    out = {("step",): state.step}
    for name, tree in (("params", state.params), ("m", state.opt["m"]),
                       ("v", state.opt["v"])):
        out.update({(name,) + p: t for p, t in tree_items(tree)})
    return out


@pytest.mark.cuda
def test_placed_train_step_equals_the_unplaced_step_on_card(card):
    cfg = get_smoke("zamba2-1.2b")
    m = build(cfg)
    state = init_train_state(m.init_master(torch.Generator(card)
                                           .manual_seed(0)))
    shape = ShapeSpec("smoke", 64, 2, "train")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, s, np.int32))
             .to(card) for k, (s, _) in zoo.input_specs(cfg, shape).items()}
    step = make_train_step(m, AdamWConfig(peak_lr=1e-3, warmup_steps=0,
                                          decay_steps=10))
    ops.reset_launch_counts()
    want, want_met = step(state, batch)
    plain = ops.launch_counts()

    mesh = make_host_mesh()
    assert mesh.device_type == "cuda" and mesh.shape == (1, 1)
    _, shardings = train_state_shardings(m, mesh, DEFAULT_RULES)
    placed = distribute_tree(state, shardings)
    placed_batch = distribute_tree(batch, shardings_for_tree(
        zoo.batch_axes(cfg, "train"), zoo.input_specs(cfg, shape), mesh))
    ops.reset_launch_counts()
    with activate(mesh, DEFAULT_RULES):
        got, got_met = step(placed, placed_batch)
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    assert launched == plain
    assert launched["flash_attention"] > 0 and launched["ssd_scan"] > 0
    for k in ("loss", "grad_norm"):
        assert torch.equal(got_met[k], want_met[k]), k
    g, s = _leaves(got), _leaves(shardings)
    for p, w in _leaves(want).items():
        assert g[p].placements == s[p].placements, p
        assert torch.equal(g[p].to_local(), w), p


@pytest.mark.cuda
def test_placed_decode_equals_the_unplaced_decode_on_card(card):
    cfg = get_smoke("zamba2-1.2b")
    m = build(cfg)
    params = m.init(torch.Generator(card).manual_seed(0))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 33), np.int32)).to(card)

    def run(p, cache):
        ops.reset_launch_counts()
        logits, cache = m.prefill(p, {"tokens": tokens}, cache)
        out = [logits]
        for i in range(4):
            pos = torch.full((4,), tokens.shape[1] + i, dtype=torch.int32,
                             device=card)
            logits, cache = m.decode_step(
                p, out[-1].argmax(-1).to(torch.int32), cache, pos)
            out.append(logits)
        torch.cuda.synchronize()
        return out, cache, ops.launch_counts()

    want, want_cache, plain = run(params, m.init_cache(4, 48))
    mesh = make_host_mesh()
    spec, axes = m.cache_spec(4, 48)
    cache = distribute_tree(m.init_cache(4, 48),
                            shardings_for_tree(axes, spec, mesh,
                                               DECODE_RULES))
    placed = distribute_tree(params, shardings_for_tree(
        m.param_axes(), m.abstract_params(), mesh, DECODE_RULES))
    with activate(mesh, DECODE_RULES):
        got, got_cache, launched = run(placed, cache)
    assert launched == plain and launched["ssd_scan"] > 0
    assert got_cache is cache
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (p, a), (_, b) in zip(tree_items(got_cache), tree_items(want_cache)):
        assert torch.equal(a.to_local(), b), p


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_slot_sharded_detector_batch_equals_the_unplaced_on_card(card,
                                                                 fused):
    frames, _ = scenario_batch(["straight", "curved", "night", "rain"], 120,
                               160, seed=0)
    mesh = make_replica_mesh(1)
    placed = shard_slots(frames, mesh)
    assert placed.device.type == "cuda"
    plan = DetectionPlan.build(
        PipelineConfig(hough=HoughConfig(compact=True, max_edges="auto")),
        120, 160, batch=4)
    plan = plan.with_fused() if fused else plan
    want = plan.run(torch.from_numpy(frames).to(card))
    ops.reset_launch_counts()
    got = plan.run(placed)
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    assert launched["hough_vote"] == 1
    assert launched["fused_detect" if fused else "conv2d_gemm"] > 0
    for name, a, b in zip(want._fields, got, want):
        if b is not None:
            assert torch.equal(a, b), name
