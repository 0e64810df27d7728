"""The int8 error-feedback compression on the card, against the port's
CPU run of the same inputs, bit for bit.

The quantizer's cases (half-to-even steps, the scale's floor, tiny and
large scales), the 20-step error-feedback loop, and the mean and residual
of ``compressed_allreduce`` over a one-card ``("pod",)`` mesh (nccl on an
in-memory ``HashStore``, destroyed after each test) and of the tree form
over a SMOKE zamba2-1.2b gradient tree, each equal to the CPU's.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_compression.py

This file imports nothing of the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.layers import tree_items, tree_map  # noqa: E402
from repro_torch.sharding import activate  # noqa: E402
from repro_torch.train import (  # noqa: E402
    compress_decompress, compressed_allreduce, compressed_allreduce_tree,
    init_compression,
)
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train.trainer import _mean_grads  # noqa: E402

CASES = ("normal", "zeros", "single", "half_steps", "tiny", "large")


@pytest.fixture
def card():
    """The card; a process group made in the test is destroyed after it.
    Skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert not dist.is_initialized()
    try:
        yield torch.device("cuda", torch.cuda.current_device())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()


def _pod_mesh():
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    return init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))


def _case(name, n=4099, seed=0):
    rng = np.random.default_rng(seed)
    err = np.zeros(n)
    if name == "normal":
        x, err = rng.normal(size=n), 0.01 * rng.normal(size=n)
    elif name == "zeros":
        x = np.zeros(n)
    elif name == "single":
        x = np.zeros(n)
        x[n // 3] = -2.75
    elif name == "half_steps":
        x = rng.integers(-126, 126, size=n) + 0.5 * np.sign(
            rng.normal(size=n))
        x[0] = 127.0
    elif name == "tiny":
        x, err = 1e-6 * rng.normal(size=n), 1e-8 * rng.normal(size=n)
    else:
        x, err = 1e3 * rng.normal(size=n), 10.0 * rng.normal(size=n)
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(err.astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_quantizer_on_the_card_equals_the_cpu(card, name):
    x, err = _case(name)
    for got, want in zip(comp._quantize((x + err).to(card)),
                         comp._quantize(x + err)):
        assert torch.equal(got.cpu(), want)
    for got, want in zip(compress_decompress(x.to(card), err.to(card)),
                         compress_decompress(x, err)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_error_feedback_loop_on_the_card_equals_the_cpu(card):
    x, _ = _case("normal", 256)
    e_card, e_cpu = torch.zeros(256, device=card), torch.zeros(256)
    for _ in range(20):
        d_card, e_card = compress_decompress(x.to(card), e_card)
        d_cpu, e_cpu = compress_decompress(x, e_cpu)
        assert torch.equal(d_card.cpu(), d_cpu)
        assert torch.equal(e_card.cpu(), e_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["normal", "half_steps", "large"])
def test_one_card_mean_equals_the_cpu_round_trip(card, name):
    x, err = _case(name)
    with activate(_pod_mesh()):
        mean, new_err = compressed_allreduce(x.to(card), err.to(card), "pod")
    deq, want_err = compress_decompress(x, err)
    assert mean.device.type == "cuda"
    assert torch.equal(mean.cpu(), deq)
    assert torch.equal(new_err.cpu(), want_err)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 3, 8])
def test_gathered_sum_on_the_card_equals_the_cpu(card, P):
    rng = np.random.default_rng(P)
    pairs = [comp._quantize(torch.from_numpy(
        (rng.normal(size=1025) * 10.0 ** rng.uniform(-3, 2))
        .astype(np.float32))) for _ in range(P)]
    qs = torch.stack([q for q, _ in pairs])
    ss = torch.stack([s for _, s in pairs])
    got = comp._gathered_sum(ss.to(card), qs.to(card))
    assert torch.equal(got.cpu(), comp._gathered_sum(ss, qs))


@pytest.mark.cuda
def test_tree_of_smoke_gradients_on_the_card_equals_the_cpu(card):
    """SMOKE zamba2-1.2b's gradients of one batch (on the card, through
    the kernels), reduced over the one-card pod mesh with the residuals of
    one earlier round: every leaf's mean and residual equal the CPU's on
    the same gradients and residuals."""
    cfg = get_smoke("zamba2-1.2b")
    m = build(cfg)
    params = m.init_master(torch.Generator(card).manual_seed(0))
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 65))
    batch = {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
             "targets": torch.from_numpy(tok[:, 1:].astype(np.int32))}
    batch = {k: v.to(card) for k, v in batch.items()}
    _, _, grads = _mean_grads(m.loss, params, batch, 1)
    err = tree_map(lambda g: compress_decompress(g, torch.zeros_like(g))[1],
                   grads)
    st = init_compression(grads)._replace(err=err)
    with activate(_pod_mesh()):
        mean, new = compressed_allreduce_tree(grads, st, "pod")
    for (path, g), (_, e), (_, mu), (_, ne) in zip(
            tree_items(grads), tree_items(err), tree_items(mean),
            tree_items(new.err)):
        want_mean, want_err = compress_decompress(g.cpu(), e.cpu())
        assert torch.equal(mu.cpu(), want_mean), path
        assert torch.equal(ne.cpu(), want_err), path
