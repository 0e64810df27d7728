"""The pod-compressed train step on the card, against the port's CPU run
of the same inputs.

A SMOKE zamba2-1.2b pod step at P = 1 on the card (a world-size-1 nccl
``("pod", "data", "model")`` mesh) against the same step on the CPU (a
world-size-1 gloo one); two spawned ranks on ``cuda:0`` over gloo (NCCL
puts no two ranks of one group on one card), each a pod of half the
rows, whose parameters and moments are the same bits after every step.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_pod.py

This file imports nothing of the JAX package.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.layers import tree_items, tree_map  # noqa: E402
from repro_torch.train import AdamWConfig, init_train_state  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    _mean_grads, make_train_step_pod_compressed,
)

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)


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


def _smoke():
    cfg = get_smoke("zamba2-1.2b").replace(compute_dtype="float32")
    params = build(cfg, device="cpu").init_master(
        torch.Generator().manual_seed(0))
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (4, 97))
    batch = {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
             "targets": torch.from_numpy(tok[:, 1:].astype(np.int32))}
    return cfg, params, batch


@pytest.mark.cuda
def test_p1_pod_step_on_the_card_equals_the_cpu(card):
    """SMOKE zamba2-1.2b at f32, 2 pod steps from the same parameters and
    batch on the card and on the CPU: loss within 1e-5 relative,
    grad_norm within 1e-4, every parameter within 2 lr with at most 1% of
    the elements past 1e-6 (the criteria of the plain step's card test);
    each residual within 1e-2 of its leaf's scale but at most 1e-3 of the
    elements (the quantizer's ties, where the two devices' gradients put
    ``y / scale`` on the two sides of a half step), and those within one
    scale; each kernel launched as in the plain step.  The residuals
    are compared after each step, in units of the CPU's scale there."""
    cfg, params, batch = _smoke()
    opt = AdamWConfig(**OPT)
    out = {}
    for dev in ("cpu", card):
        m = build(cfg, device=dev)
        step = make_train_step_pod_compressed(m, opt,
                                              train_cli._pod_mesh(dev))
        state = init_train_state(tree_map(lambda t: t.to(dev), params),
                                 compression=True)
        b = {k: v.to(dev) for k, v in batch.items()}
        ops.reset_launch_counts()
        rows, errs, scales = [], [], []
        for _ in range(2):
            _, _, g = _mean_grads(m.loss, state.params, b, 1)
            scales.append(dict(tree_items(tree_map(
                lambda a, e: float(comp._quantize(a + e)[1]), g,
                state.err))))
            state, met = step(state, b)
            rows.append({k: float(v) for k, v in met.items()})
            errs.append({p: t.cpu() for p, t in tree_items(state.err)})
        counts = ops.launch_counts()
        out[str(dev)] = (state, rows, errs, scales)
        dist.destroy_process_group()
    s_cpu, r_cpu, e_cpu, scales = out["cpu"]
    s_card, r_card, e_card, _ = out[str(card)]
    n_super = cfg.n_layers // cfg.share_every
    n_mamba = n_super * cfg.share_every + (cfg.n_layers % cfg.share_every) ** 2
    per_call = 2 if cfg.remat else 1
    # 2 steps, and the gradients taken beside each for the scales
    assert counts["flash_attention"] == 4 * per_call * n_super
    assert counts["ssd_scan"] == 4 * per_call * n_mamba
    for a, b in zip(r_card, r_cpu):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    beyond = total = 0
    for (path, a), (_, b) in zip(tree_items(s_card.params),
                                 tree_items(s_cpu.params)):
        assert a.is_cuda, path
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2 * opt.peak_lr, path
        beyond += int((d > 1e-6).sum())
        total += d.numel()
    assert beyond <= 0.01 * total, (beyond, total)
    for i in range(2):
        ties = 0
        for path, e in e_card[i].items():
            d = (e - e_cpu[i][path]).abs() / max(scales[i][path], 1e-30)
            assert float(d.max()) <= 1.01, (i, path)
            ties += int((d > 1e-2).sum())
        assert ties <= 1e-3 * total, (i, ties, total)


RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build
    from repro_torch.models.layers import tree_items
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train.trainer import make_train_step_pod_compressed

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, out = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group(
        "gloo", store=dist.FileStore(out + "/store", 2), rank=rank,
        world_size=2)
    try:
        cfg = get_smoke("zamba2-1.2b").replace(compute_dtype="float32")
        mesh = train_cli._pod_mesh("cuda")
        model = build(cfg)
        state = init_train_state(model.init_master(
            torch.Generator(model.device).manual_seed(0)), compression=True)
        step = make_train_step_pod_compressed(
            model, AdamWConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10),
            mesh)
        tok = np.random.default_rng(1).integers(0, cfg.vocab, (4, 97))
        batch = {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
                 "targets": torch.from_numpy(tok[:, 1:].astype(np.int32))}
        batch = {k: v.to(model.device) for k, v in batch.items()}
        steps = []
        for _ in range(2):
            state, met = step(state, batch)
            assert all(t.is_cuda for _, t in tree_items(state.params))
            steps.append({"params": {"/".join(p): t.cpu() for p, t in
                                     tree_items(state.params)},
                          "opt": {"/".join(p): t.cpu() for p, t in
                                  tree_items(state.opt)},
                          "metrics": {k: float(v) for k, v in met.items()}})
        torch.save(steps, f"{out}/rank{rank}.pt")
        assert "jax" not in sys.modules and "repro" not in sys.modules
    finally:
        dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_two_ranks_on_the_card_keep_the_same_bits(card, tmp_path):
    """Two gloo ranks on ``cuda:0``, each a pod of 2 of the 4 rows, take 2
    SMOKE zamba2-1.2b pod steps: their parameters, moments and metrics
    are equal bit for bit after each step, and the parameters moved."""
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
    a, b = (torch.load(tmp_path / f"rank{r}.pt") for r in range(2))
    cfg, params, _ = _smoke()
    for sa, sb in zip(a, b):
        assert sa["metrics"] == sb["metrics"]
        for tree in ("params", "opt"):
            assert sa[tree].keys() == sb[tree].keys()
            for k in sa[tree]:
                assert torch.equal(sa[tree][k], sb[tree][k]), (tree, k)
    assert not torch.equal(a[-1]["params"]["final_norm/w"],
                           params["final_norm"]["w"])
