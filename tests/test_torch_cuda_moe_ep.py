"""Expert parallelism on the card (``models/moe.py::moe_ep`` under the
port's ``sharding.shard_map``), against the port's plain dispatch.

One moonshot-v1-16b-a3b SMOKE layer on the card's world-size-1 nccl
``(1, 1)`` host mesh against ``moe_sort`` (equal capacity), forward and
backward bit for bit; the SMOKE model's prefill and decode step under
``activate`` against its unplaced runs; two spawned ranks on ``cuda:0``
over gloo (NCCL puts no two ranks of one group on one card) at mesh
shapes (1, 2) and (2, 1), each against the plain version in its own
process.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_moe_ep.py

This file imports nothing of the JAX package.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch import sharding  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import build, moe  # noqa: E402
from repro_torch.models.layers import materialize, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "moonshot-v1-16b-a3b"


@pytest.fixture
def card():
    """The card, with the plain products in full f32; a process group made
    in the test is destroyed after it.  Skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the LM kernels have no CPU mode)")
    assert not dist.is_initialized()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda", torch.cuda.current_device())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()


def _grads(run, params, x, cot):
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    xx = x.detach().requires_grad_()
    y, aux = run(p, xx)
    g = torch.autograd.grad((y.float() * cot).sum() + 3.0 * aux,
                            [*p.values(), xx])
    return [y.detach(), aux.detach(), *g]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rules", ["default", "decode"])
def test_moe_ep_on_one_card_equals_moe_sort(card, dtype, rules):
    """The SMOKE layer on 4 x 256 tokens (C = 320 in both, assignments
    dropped): moe_ep under ``activate`` on the card's (1, 1) mesh is
    moe_sort, output, aux loss and every gradient bit for bit, with
    ``torch.use_deterministic_algorithms`` on (the gradient of a gather
    adds a token's slots with atomics otherwise)."""
    cfg = get_smoke(ARCH)
    gen = torch.Generator(card).manual_seed(0)
    params = tree_map(lambda t: t.to(dtype), materialize(
        gen, moe.moe_spec(cfg), device=card))
    x = torch.randn(4, 256, cfg.d_model, generator=gen, device=card)
    x = (x + 0.5 * x[:1, :1]).to(dtype)
    cot = torch.randn(4, 256, cfg.d_model, generator=gen, device=card)
    mesh = make_host_mesh()
    assert mesh.device_type == "cuda" and mesh.shape == (1, 1)
    table = {"default": sharding.DEFAULT_RULES,
             "decode": sharding.DECODE_RULES}[rules]

    def ep(p, xx):
        with sharding.activate(mesh, table):
            return moe.moe_ep(p, xx, cfg)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = _grads(ep, params, x, cot)
        want = _grads(lambda p, xx: moe.moe_sort(p, xx, cfg), params, x, cot)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(got, want):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.cuda
def test_smoke_model_under_activate_on_the_card(card):
    """The SMOKE model (bf16, 2 layers): a 2 x 128 prefill under
    ``activate(make_host_mesh(), DECODE_RULES)`` (C = 80 in both) gives
    the unplaced logits and cache bit for bit with one flash_attention
    launch a layer; a 2-slot decode step (moe_ep's C = 4 = k T) gives the
    unplaced step's at lifted capacity bit for bit."""
    cfg = get_smoke(ARCH)
    m = build(cfg)
    params = m.init(torch.Generator(card).manual_seed(0))
    toks = torch.randint(1, cfg.vocab, (2, 128), device=card,
                         generator=torch.Generator(card).manual_seed(1),
                         dtype=torch.int32)
    mesh = make_host_mesh()
    cu, cp = m.init_cache(2, 129), m.init_cache(2, 129)
    want, _ = m.prefill(params, {"tokens": toks}, cu)
    ops.reset_launch_counts()
    with sharding.activate(mesh, sharding.DECODE_RULES):
        got, _ = m.prefill(params, {"tokens": toks}, cp)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    assert torch.equal(got, want)
    for k in cu["blocks"]:
        for n in cu["blocks"][k]:
            assert torch.equal(cu["blocks"][k][n], cp["blocks"][k][n])
    tok = want.argmax(-1).to(torch.int32)
    pos = torch.full((2,), 128, dtype=torch.int32, device=card)
    lift = build(cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts))))
    want, _ = lift.decode_step(params, tok, cu, pos)
    with sharding.activate(mesh, sharding.DECODE_RULES):
        got, _ = m.decode_step(params, tok, cp, pos)
    assert torch.equal(got, want)


RANK = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import sharding
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe
    from repro_torch.models.layers import materialize

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, out = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group(
        "gloo", store=dist.FileStore(out + "/store", 2), rank=rank,
        world_size=2)
    try:
        cfg = get_smoke("moonshot-v1-16b-a3b").replace(
            compute_dtype="float32")
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
        dev = torch.device("cuda", 0)
        gen = torch.Generator(dev).manual_seed(0)
        params = materialize(gen, moe.moe_spec(cfg), device=dev)
        x = torch.randn(2, 64, cfg.d_model, generator=gen, device=dev)
        cot = torch.randn(2, 64, cfg.d_model, generator=gen, device=dev)

        def grads(run):
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            xx = x.detach().requires_grad_()
            y, aux = run(p, xx)
            g = torch.autograd.grad((y * cot).sum() + 3.0 * aux,
                                    [*p.values(), xx])
            return [y.detach(), aux.detach(), *g]

        def plain(p, xx, dp):
            y, _ = moe.moe_sort(p, xx, cfg)
            auxes = [moe._load_balance_loss(*moe._route(
                         p, s.reshape(-1, s.shape[-1]), cfg.moe)[::2],
                         cfg.moe) for s in xx.chunk(dp)]
            return y, torch.stack(auxes).sum() / dp

        res = {}
        for shape, rules in (((1, 2), sharding.DECODE_RULES),
                             ((2, 1), sharding.DEFAULT_RULES)):
            mesh = init_device_mesh("cuda", shape,
                                    mesh_dim_names=("data", "model"))

            def ep(p, xx):
                with sharding.activate(mesh, rules):
                    return moe.moe_ep(p, xx, cfg)

            got = grads(ep)
            want = grads(lambda p, xx: plain(p, xx, shape[0]))
            flat = torch.cat([t.reshape(-1).float() for t in got])
            both = [torch.empty_like(flat) for _ in range(2)]
            dist.all_gather(both, flat)
            res[str(shape)] = {
                "ranks_equal": bool(torch.equal(both[0], both[1])),
                "on_the_card": all(t.is_cuda for t in got),
                "rel": [float((a.float() - b.float()).norm()
                              / b.float().norm()) for a, b in zip(got, want)]}
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(res, f)
        assert "jax" not in sys.modules and "repro" not in sys.modules
    finally:
        dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_two_ranks_on_the_card_against_the_plain_version(card, tmp_path):
    """Two gloo ranks on ``cuda:0`` run the SMOKE layer (f32, capacity
    factor 8) at (1, 2) under DECODE_RULES and (2, 1) under DEFAULT_RULES:
    both ranks hold the same output, aux loss and gradients, bit for bit,
    each within 1e-5 of its norm of the plain version (moe_sort on the
    whole batch, the aux loss the mean of the data shards')."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    for shape in ("(1, 2)", "(2, 1)"):
        for r in ranks:
            row = r[shape]
            assert row["ranks_equal"] and row["on_the_card"], shape
            assert max(row["rel"]) <= 1e-5, (shape, row["rel"])
