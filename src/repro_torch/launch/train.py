"""Training entry point: the train loop on a host mesh with checkpoints
and resume (``repro/launch/train.py``, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch zamba2-1.2b --preset smoke --steps 100 \\
        --ckpt /path/to/ckpt --device cpu

The default arch is yi-9b, as in the reference; ``--arch`` takes any arch
of ``repro_torch.configs.PORTED`` but the vlm and encdec families, whose
batches need image embeddings or frames that the token pipeline does not
make (``Model.loss`` takes them, from ``models.model_zoo.
materialize_inputs``).  It runs on the card unless ``--device cpu``.
Parameters are drawn from seed 0 in the param dtype (the f32 master), and
the state is placed by ``train_state_shardings`` on ``make_host_mesh``
over the device there is, then trained under ``activate(mesh,
DEFAULT_RULES)``.  The step-indexed token pipeline feeds the device
through a prefetch thread, and checkpoints are written asynchronously
every ``--ckpt-every`` steps and once at the end, unless the last one
already holds that step.  With ``--resume`` the loop restarts from the
latest checkpoint under ``--ckpt``, restored into the placed state.  A
process group that ``make_host_mesh`` made for the run is destroyed when
the run ends; the returned state's leaves stay DTensors on the mesh, and
``local_tree`` gives their tensors.

``--compress-pod`` trains with the int8 error-feedback compression of the
cross-pod gradient reduction (``train.trainer.
make_train_step_pod_compressed``), as the reference's flag does, on an
unplaced state with ``err``.  Its mesh is ``("pod", "data", "model")`` of
shape (world size, 1, 1) over the process group there is (one rank a pod;
without a group, the usual world-size-1 one), where the reference's
``make_host_mesh(multi_pod=True)`` takes 8 devices or more.  Every rank
builds the same global batch, and the step cuts each rank's rows.  Only
rank 0 writes checkpoints; every rank restores from them.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import ModelConfig, get, get_smoke
from repro_torch.data import PrefetchLoader, TokenPipelineConfig, TokenStream
from repro_torch.launch.mesh import _device_mesh, make_host_mesh
from repro_torch.models import build
from repro_torch.sharding import DEFAULT_RULES, activate
from repro_torch.sharding.partition import local_tree
from repro_torch.train import (
    AdamWConfig, distribute_tree, init_train_state, make_train_step,
    train_state_shardings,
)
from repro_torch.train.trainer import make_train_step_pod_compressed


def preset_config(arch: str, preset: str) -> ModelConfig:
    if preset == "full":
        return get(arch)
    cfg = get_smoke(arch)
    if preset == "100m":
        # ~100M params in the arch's family shape
        return cfg.replace(
            n_layers=max(4, cfg.n_layers), d_model=512,
            n_heads=8, n_kv_heads=max(1, min(8, cfg.n_kv_heads or 8)),
            d_ff=2048, vocab=8192, remat=False,
        )
    return cfg


def optimizer_config(args: argparse.Namespace) -> AdamWConfig:
    """The reference CLI's schedule: warmup over 1/20 of the steps (at
    least 5), cosine decay to the last step."""
    return AdamWConfig(peak_lr=args.lr,
                       warmup_steps=max(args.steps // 20, 5),
                       decay_steps=args.steps)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-pod", action="store_true",
                    help="int8 error-feedback cross-pod grad reduction "
                         "(one rank a pod: a (world, 1, 1) pod mesh)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the loop; returns (final TrainState, placed on the host mesh;
    the logged steps: step, loss, lr, grad_norm, tok_per_s, and
    ms_per_step since the previous logged step, on the host clock, each
    logged step read back)."""
    args = parse_args(argv)
    cfg = preset_config(args.arch, args.preset)
    if cfg.family in ("vlm", "encdec"):
        raise NotImplementedError(
            f"{args.arch} ({cfg.family}) needs image embeddings or frames "
            "beside its tokens; the token pipeline makes tokens only")
    model = build(cfg, device=args.device)
    created_group = not dist.is_initialized()
    try:
        mesh = (_pod_mesh(args.device) if args.compress_pod
                else make_host_mesh(device=args.device))
        print(f"arch={args.arch} preset={args.preset} "
              f"params={model.param_count()/1e6:.1f}M device={model.device} "
              f"mesh={tuple(mesh.shape)}", flush=True)
        with activate(mesh, DEFAULT_RULES):
            return _train(args, cfg, model, mesh)
    finally:
        if created_group and dist.is_initialized():
            dist.destroy_process_group()


def _pod_mesh(device):
    """``("pod", "data", "model")`` of shape (world size, 1, 1): one rank
    a pod, over the process group there is."""
    return _device_mesh(device, lambda world: (world, 1, 1),
                        ("pod", "data", "model"))


def _train(args, cfg, model, mesh):
    dev = model.device
    params = model.init_master(torch.Generator(dev).manual_seed(0))
    if args.compress_pod:
        # as the reference's branch: an unplaced state with err
        state = init_train_state(params, compression=True)
        step_fn = make_train_step_pod_compressed(
            model, optimizer_config(args), mesh, n_micro=args.n_micro)
    else:
        _, state_sh = train_state_shardings(model, mesh)
        state = distribute_tree(init_train_state(params), state_sh)
        step_fn = make_train_step(model, optimizer_config(args),
                                  n_micro=args.n_micro)

    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    writes = dist.get_rank() == 0       # every rank restores; rank 0 saves
    start, saved = 0, None            # saved: the step the store holds
    if args.resume and args.ckpt and latest_step(args.ckpt) is not None:
        state = mgr.restore_latest(state)
        start = saved = int(local_tree(state.step))
        print(f"resumed from step {start}", flush=True)

    stream = TokenStream(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.global_batch))
    loader = PrefetchLoader(stream, depth=2, start_step=start)
    history = []
    t0 = t_last = time.perf_counter()
    i_last = start
    tokens_seen = 0
    try:
        for i in range(start, args.steps):
            _, batch = loader.get()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            tokens_seen += args.global_batch * args.seq
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                loss = float(metrics["loss"])
                now = time.perf_counter()
                rec = {"step": i + 1, "loss": loss,
                       "lr": float(metrics["lr"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "tok_per_s": tokens_seen / (now - t0),
                       "ms_per_step": (now - t_last) * 1e3 / (i + 1 - i_last)}
                t_last, i_last = now, i + 1
                history.append(rec)
                print(f"step {i+1:5d}  loss {loss:7.4f}  "
                      f"lr {rec['lr']:.2e}  "
                      f"grad_norm {rec['grad_norm']:.3f}  "
                      f"{rec['tok_per_s']:,.0f} tok/s", flush=True)
            if mgr and writes and (i + 1) % args.ckpt_every == 0:
                mgr.save_async(state, i + 1)
                saved = i + 1
    finally:
        loader.close()
        if mgr and writes:
            final = int(local_tree(state.step))
            if saved == final:
                mgr.wait()
            else:
                mgr.save_sync(state, final)
    return state, history


if __name__ == "__main__":
    main()
