#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Builds the hand CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
the git-ignored ``build/``), holds each kernel against its plain PyTorch
version (``fused_detect`` bit for bit, on a CPU copy, and against the
card's own staged Canny -> threshold -> corridor -> compaction), and drives
the port's main paths at the deployment resolution 720x1280, each checked
against the port's own CPU run of the same frames with the launch counts
zeroed just before it and read just after:

  * the staged detector, ``LineDetector.detect_batch`` on 8 frames, for the
    f32 ("boom") and integer ("boom+gemmini") Canny;
  * the batched fused detector, ``PipelineConfig(fused=True)``, 8 frames;
  * the tracking slice, ``TrackingPipeline(theta_band=40,
    fused_corridors=8)`` on the 32-frame "converging" drive cycle, each
    frame on its path (fused, gated or full sweep).

It also holds the fused kernel's f16 and int8 gradient tiers to the
card's staged path bit for bit (int8 to the CPU too), and a hysteresis
past the tile's shared memory (the fewest passes
``fused_detect.hysteresis_schedule`` sends through device memory, 60 and
100) in every tier to the plain version with its launch schedule traced
(``fused_long_hysteresis``), gates per-family F1
at 240x320 against ``benchmarks/baselines/f1_baseline.json`` (the f32
detector, and the f16 / int8 tiers staged and fused against its
"quantized" section), streams under
``torch.cuda.set_sync_debug_mode("error")``, and times each kernel beside
its bound, its plain version and one PyTorch library call where one
computes the same function, the fused plan against the gated staged plan,
and the tracking loop.

Then the LM slice on zamba2-1.2b at full width (``lm_phases``): the
attention and SSD kernels against their plain versions (bf16 attention
on the tensor cores, p split into two bf16 halves; the SSD scan in three
passes, its products as 3xTF32 on the tensor cores, each pass's kernel
counted in a traced prefill), a full-width f32
cut against the CPU, the full model serving 8 requests through ``Engine``
in bf16 (and f32), the same traffic on ``quantize_weights_int8`` weights
dequantized to bf16, and the float -> int rewrite's GEMM
(``matmul_phases``): the matmul kernel (int8 on the tensor cores, in its
tile and split-K decode forms; bf16 / f16 on ``wgmma``) against its plain
version and ``quantized_matmul`` at the model's full-width GEMMs, with
device times beside ``torch._int_mm``'s and ``torch.mm``'s and profiler
traces of each; the LM kernels'
times beside SDPA and their bounds, and one attention launch profiled
(device time, TFLOP/s, registers, blocks an SM).  ``--parent DIR`` (an
unpacked ``git archive`` of the parent commit) builds that tree's conv,
vote, SSD and ``fused_detect`` kernels and times each beside this tree's
on the same inputs (the conv at every launch of the staged Canny, bit for
bit, ``conv_shape_times``; the vote at each main-path shape, bit for bit,
``vote_shape_times``); the fused detector's batch and the tracking loop are timed in
turns with the parent's fused kernel swapped in (parent, this, this,
parent, three times), and its profiled window runs once on it.

The detector's serving path (``service_phases``): ``DetectionService``
at 240x320 / 480x640 / 720x1280, batch 4, staged and with
``fused_corridors=8``, on two interleaved 32-frame drive-cycle sessions
and 16 one-off frames under the paper's 300 ms deadline: latency per
bucket, misses, frames/s on the real clock (warm dispatches under
``set_sync_debug_mode("error")``), every DONE answer against
``DetectionPlan.run`` on the same batch, device time and GPU activities
of a dispatch, the same traffic on a virtual clock equal on the card and
on the CPU, and a fault pass (stager death, failed and stalled dispatch,
NaN frames) that must end every request.  The detection fleet
(``fleet_phases``): ``ShardedDetectionService`` over such replicas, all
on ``cuda:0``; on a virtual clock, 2 replicas through a replica killed
with a batch in flight, ``add_replica()`` and 8 speculative races on a
seeded lossy link, equal on the card and on the CPU (``fleet_virtual``);
on the real clock, the service's traffic at 1, 2 and 4 replicas
(``fleet``): latency, misses, frames/s, dispatches a replica, GPU
activities and device-busy share, every DONE answer against
``DetectionPlan.run``.

The closed loop (``closed_loop_phases``): the drive suite's arms at
240x320, 48 frames of "straight", "rain", "night" and "glare" (blind,
per_frame, tracked, tracked_fused; on "straight" the ``DetectionService``
session with the degradation ladder on and off under forced overload),
each card trajectory against the port's CPU run of the same arm, the
suite's gates and ``benchmarks/baselines/drive_baseline.json``; each
tracked frame's host-clock ms against the paper's 300 ms, launches and
GPU activities a frame.  The paper's platform matrix
(``paper_platform_phases``): stage times of rocket (stencil Canny and the
serial ``hough_paper_loop``), gemm, gemm+hough, +fused and +int on one
240x320 frame, speedups against rocket, the serial loop's votes against
the vote kernel's and its CPU run.

The training slice (``train_phases``): the two LM kernels' gradients
through ``kernels.ops`` (the kernel forward, a plain backward) against
the plain versions' autograd on the card (``train_kernel_grads``);
zamba2-1.2b at full width cut to 10 Mamba-2 layers, f32, two train steps
on the card against the port's CPU (``train_vs_cpu``); and
``launch.train.main`` at full width and depth, bf16 over the f32 master,
its state placed on the card's (1, 1) host mesh, 8 steps of 8 x 512
tokens with a checkpoint at step 4 and a ``--resume`` from it
(``train``): losses, every leaf of the returned and the resumed state a
DTensor with ``train_state_shardings``' placements, ms a warm step,
tokens/s, peak memory, each kernel's launches a step (twice the
forward's with remat) and one step traced, and the two LM kernels'
forward launch at the step's shapes beside their bounds
(``train_shape_times``).

The sharding layer (``sharding_phases``, phase ``sharding``): on
``launch.mesh``'s one-device meshes of the card (a world-size-1 nccl
group on an in-memory store), zamba2-1.2b's full TrainState placed by
``train_state_shardings`` takes one ``make_train_step`` under
``activate(mesh, DEFAULT_RULES)``, equal bit for bit to one step from the
same state unplaced (loss, grad norm, every parameter and moment; 12
attention and 80 SSD launches; peak memory within 1 GB of ``train``'s);
a placed 4-slot decode cache (``Model.cache_spec`` under DECODE_RULES)
takes a prefill and 4 decode steps, equal to the unplaced run; and the
8-frame 720x1280 batch, ``shard_slots``-placed on the replica mesh, goes
through ``DetectionPlan.run`` staged and fused, equal to the unplaced
batch (edges, votes, peaks).

Elastic restarts (``elastic_phase``, phase ``elastic``): zamba2-1.2b at
full width cut to one super-block (a ~4.2 GB checkpoint of parameters
and moments), placed on the host mesh, 8 steps of 8 x 512 tokens under
``run_with_restarts`` with failures at steps 3 and 6, checkpoints every 2
steps, the ``meta`` state of ``train_state_specs`` as the template and a
hook that moves the run to ``make_replica_mesh(1)``: the stats, every
leaf on the mesh in force before each step, the final state bit-equal to
the uninterrupted placed run, both kernels' launches the steps run times
the launches a step; restore ms and GB/s, each ``save_async``'s host
copy.

Int8 error-feedback compression (``compression_phase``, phase
``compression``): the gradient tree of one zamba2-1.2b step at the
``train`` phase's width, depth and shape (12 attention and 80 SSD
launches), reduced by ``compressed_allreduce_tree`` over a one-card
``("pod",)`` mesh twice (from zero residuals, then from the first round's):
the largest leaf, a norm and two bias-like leaves' q, scale, mean and
residual equal the CPU's bit for bit, every mean within max|g| / 127 of
its gradient; a compression train state takes 2 steps with ``err``
unchanged; the reduction's device ms beside its byte bound, one call
traced, and the int8 wire bytes against an f32 ring all-reduce's.

The pod-compressed train step (``pod_compressed_phase``, phase
``pod_compressed``): (a) ``launch.train.main`` with the ``train`` phase's
argv and ``--compress-pod`` on a world-size-1 nccl ``(1, 1, 1)`` pod mesh
(12 attention and 80 SSD launches a step, the first 3 losses within rtol
2e-2 of ``train``'s, the checkpoint holding ``err``, ms a warm step, peak
memory); (b) two spawned gloo ranks on ``cuda:0``, each a pod of 4 of the
8 rows, 3 steps of the elastic phase's cut (params and moments the same
bits after every step, losses within rtol 2e-2 of a plain step on the
whole batch, the reduction's ms a step, the wire bytes).

The remaining dense families, Mamba-1 and the MoE family
(``lm_family_phases``): yi-9b (48 layers), granite-34b (88), qwen1.5-32b
(60 of 64), falcon-mamba-7b (64), moonshot-v1-16b-a3b (48) and
llama4-scout-17b-a16e (16 of 48), each at full width in bf16 with seed-0
weights drawn on the card, serving the LM traffic through
``Engine(n_slots=4, max_len=1152)`` (prefill ms by length, decode ms a
step, tokens/s, peak memory, attention launches a prefill and a decode
step, finite logits, decode logits against fresh prefills of the same
tokens, falcon's again in f32; the MoE archs' gap reported at the
published capacity, again in bf16 at lifted capacity, and held in f32 at
lifted capacity at a cut depth, with one prefill and one decode step
traced and one MoE layer's sort dispatch held to the one-hot form and
timed); each at full width cut to 2 layers, f32, served on the card and
the CPU from the same parameters (equal tokens, logits within 1e-4 of
max|logit|); the attention kernel at each attention arch's head geometry
(D = 128; GQA 32/4, MQA 48/1, MHA 40/40, GQA 40/8, MHA 16/16) and the
prefill buckets' lengths held against the plain version under the bf16
rule and timed beside SDPA and the bound; one layer of falcon's plain
Mamba-1 scan traced.

Expert parallelism (``moe_ep_phase``, phase ``moe_ep``): moonshot-v1-16b-a3b
at full width on the card's (1, 1) host mesh.  One layer at T = 1024:
``moe_ep`` under ``activate`` against ``moe_sort`` (equal capacity),
output, aux loss and gradients bit for bit in f32 (TF32 off) and bf16,
under both rule tables, and the bf16 device ms of both; the whole model
(48 layers, bf16) through ``Model.prefill`` and ``decode_step`` under
``activate(make_host_mesh(), DECODE_RULES)``: prefills of 1 x 1024 and 4 x
512 tokens bit for bit with the unplaced ones (48 attention launches
each), a 4-slot decode step bit for bit with the unplaced step at lifted
capacity, the gaps at 1 x 128 tokens and to the published-capacity step
reported; two gloo ranks on ``cuda:0`` at mesh shapes (1, 2) and (2, 1):
the layer's output, aux loss and gradients against the plain version at
capacity factor 8, both ranks the same bits, each collective's ms and
bytes.

The cross-attention families (``lm_context_phases``, phase
``lm_context_families``): llama-3.2-vision-11b (40 layers, a cross layer
every 5, 1600 patch tokens through the adapter) and whisper-large-v3 (32
encoder layers over 1500 frames, 32 decoder layers), each at full width
and depth in bf16 with seed-0 weights drawn on the card, serving two
batches of 4 requests (prompts of 128 and 1000 tokens, each request its
own context) through ``Model.prefill`` and greedy ``Model.decode_step``
(the engine takes tokens only): prefill ms by length, decode ms a step,
tokens/s, peak memory, attention launches a prefill (40 / 96) and a
decode step (0), finite logits, decode logits against fresh prefills of
the same tokens and context; each cut in depth, f32, served on the card
and the CPU from the same parameters; the attention kernel in its
non-causal and cross-length forms (the VLM's cross shape over 1600
patches, whisper's encoder over 1500 frames and its cross shape, the
decoders' causal self shapes) held to the plain version under the bf16
rule and timed beside SDPA and the bound.

Every phase prints one JSON line; any failure raises and exits non-zero.
The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEPLOY_BATCH = 8
MAIN_FAMILIES = ("straight", "converging", "dashed", "curved", "night",
                 "glare", "rain", "multilane")
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): HBM bytes/s,
# f32 FLOP/s outside the tensor cores, and the dense tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the given rate (f32 unless named), whichever is
    larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tracker_corridors(truth, n: int, half: float = 25.0):
    """(n, 4) rows ``[cos, sin, rho - half, rho + half]`` around each truth
    line, padded by repeating the first, as ``LaneTracker.corridors``
    builds them around its predictions."""
    import numpy as np

    rows = [[math.cos(th), math.sin(th), rho - half, rho + half]
            for rho, th in truth]
    rows += [rows[0]] * (n - len(rows))
    return np.asarray(rows, np.float32)


def one_launch_ms(run, spin: int = 10_000_000) -> float:
    """Device time of one call of ``run``: CUDA events around it, queued
    behind a kernel that sleeps ``spin`` cycles (~5 ms by default) so that
    the host's launch time (up to that) is hidden."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_ms(run, n: int = 10, spin: int = 10_000_000) -> float:
    """Device time of one call of ``run``, the least of ``n``
    (``one_launch_ms``) after one call to warm up."""
    run()
    return min(one_launch_ms(run, spin) for _ in range(n))


PRIMER_SPINS = 64
# host calls that put work on the device: each has one device record
LAUNCH_CALL = re.compile(r"cu(da)?(LaunchKernel|LaunchCooperativeKernel"
                         r"|Memset|Memcpy)")
# every gpu_trace of the run: its name, the process's age, each try's losses
TRACES: list[dict] = []
STARTED = time.perf_counter()


def fence_trace(n: int) -> None:
    """``n`` empty spin kernels, then a synchronize: the fences around the
    work of a profiler trace."""
    import torch

    for _ in range(n):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def gpu_trace(run, name: str, n_runs: int, focus=()):
    """Profile ``run`` called ``n_runs`` times (torch.profiler, CPU and
    CUDA activities); every GPU activity of the trace summed by name, the
    busy time and the span from the first activity to the last, and for
    each substring of ``focus`` the calls and ms of the activities whose
    name holds it.

    On H100 runs the profiler dropped device records of a trace while it
    kept the host's launch records: the first records, more of them the
    longer the process had run, now and then many more, the last record,
    or a run of records in the middle.  So ``PRIMER_SPINS`` spin kernels
    open the trace, where the first losses fall, and one closes it, each
    burst synchronized; a trace is whole when every launch of the work
    between them that the host recorded (a kernel launch, a memset or a
    copy) has its device record, matched by correlation id.  A trace that
    is not whole is taken again, up to four times, with four times the
    primer each time.  The spins are left out of every count;
    ``losses`` records each try's primer, the spins of it lost, whether the
    closing spin was lost, and the launches without a device record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace_path = ROOT / "build" / f"trace_{name}.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    losses = []
    for tries in range(1, 5):
        primer = PRIMER_SPINS * 4 ** (tries - 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fence_trace(primer)
            t0 = time.perf_counter()
            for _ in range(n_runs):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            fence_trace(1)
        prof.export_chrome_trace(str(trace_path))
        events = json.loads(trace_path.read_text())["traceEvents"]
        acts = sorted((e for e in events if e.get("cat") in (
            "kernel", "gpu_memset", "gpu_memcpy")), key=lambda e: e["ts"])
        spin = ["spin_kernel" in e["name"] for e in acts]
        gpu = [e for e, s in zip(acts, spin) if not s]
        lead = spin.index(False) if gpu else len(spin)
        recorded = {e.get("args", {}).get("correlation") for e in acts}
        # the host's launches in order, the fences' left out
        launches = sorted((e for e in events
                           if e.get("cat") in ("cuda_runtime", "cuda_driver")
                           and LAUNCH_CALL.match(e["name"])),
                          key=lambda e: e["ts"])[primer:-1]
        unmatched = sum(e.get("args", {}).get("correlation") not in recorded
                        for e in launches)
        losses.append({"primer": primer,
                       "primer_spins_lost": primer - min(lead, primer),
                       "closing_spin_lost": not acts or not spin[-1],
                       "launches": len(launches),
                       "launches_without_device_record": unmatched})
        whole = unmatched == 0 and (bool(launches) or not gpu)
        if whole:
            break
    TRACES.append({"name": name, "age_s": time.perf_counter() - STARTED,
                   "whole": whole, "losses": losses})
    by_name: dict[str, list[float]] = {}
    for e in gpu:
        by_name.setdefault(e["name"], []).append(e["dur"] / 1e3)
    busy_ms = sum(sum(v) for v in by_name.values())
    span_ms = ((max(e["ts"] + e["dur"] for e in gpu)
                - min(e["ts"] for e in gpu)) / 1e3) if gpu else 0.0
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    picked = {f: [d for k, v in by_name.items() if f in k for d in v]
              for f in focus}
    return {"gpu_activities": len(gpu), "device_busy_ms": busy_ms,
            "focus": {f: {"calls": len(v), "ms": sum(v)}
                      for f, v in picked.items()},
            "device_span_ms": span_ms,
            "device_busy_share_of_span": busy_ms / span_ms if span_ms else None,
            "traced_wall_ms": wall_ms,
            "top": [{"name": k[:90], "calls": len(v), "ms": sum(v)}
                    for k, v in top],
            "trace": str(trace_path.relative_to(ROOT)), "runs": n_runs,
            "tries": tries, "whole": whole, "losses": losses}


def traced(run, name: str) -> dict:
    """Ten calls of ``run`` under the profiler: each device kernel by name
    with its mean time over the activities recorded, and whether the trace
    held both its fences (``gpu_trace``)."""
    t = gpu_trace(run, name, 10)
    return {"calls": t["runs"], "whole": t["whole"], "tries": t["tries"],
            "kernels": [{"name": e["name"], "activities": e["calls"],
                         "ms_an_activity": e["ms"] / e["calls"]}
                        for e in t["top"]]}


def parent_ssd_kernel(tree: Path):
    """The parent commit's SSD kernel, built from ``tree`` (an unpacked
    ``git archive`` of that commit) with this tree's nvcc flags, as
    ``run(x, dt, A, B, C) -> (y, state)``: this tree's wrapper launching
    the parent's library, whose C entry must be this tree's (the
    three-pass ``ssd_scan_f32`` and its ``ssd_scan_plan``).  The wrapper
    counts the parent's launches too."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd_mod

    src = Path(tree) / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu"
    out = ROOT / "build" / "parent_kernels" / "libssd_scan_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    lib.ssd_scan_f32.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p])
    lib.ssd_scan_f32.restype = ctypes.c_int
    lib.ssd_scan_plan.argtypes = [ctypes.c_int] * 8
    lib.ssd_scan_plan.restype = ctypes.c_longlong
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p

    def run(x, dt, A, B, C):
        own = ssd_mod._lib
        ssd_mod._lib = lambda: lib
        try:
            return ssd_mod.ssd_scan(x, dt, A, B, C)
        finally:
            ssd_mod._lib = own

    return run


def parent_conv_kernel(tree: Path):
    """The parent commit's conv kernel, built from ``tree`` (an unpacked
    ``git archive`` of that commit) with this tree's nvcc flags, as
    ``run(image, masks)`` with the wrapper's shapes and types, through its
    own C entries, which take the instance as this tree's do."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d_gemm import instance
    from repro_torch.kernels.tiles import acc_dtype

    src = (Path(tree) / "src" / "repro_torch" / "kernels" / "csrc"
           / "conv2d.cu")
    out = ROOT / "build" / "parent_kernels" / "libconv2d_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    entry = {torch.float32: "conv2d_f32", torch.float16: "conv2d_f16",
             torch.int32: "conv2d_i32", torch.int8: "conv2d_i8"}
    for name in entry.values():
        getattr(lib, name).argtypes = [P, P, P, I, I, I, I, I, I, I, P]
        getattr(lib, name).restype = I

    def run(image, masks):
        img = image[None] if image.ndim == 2 else image
        N, H, W = img.shape
        M, kh, kw = masks.shape
        m = masks.to(acc_dtype(image.dtype)).contiguous()
        res = torch.empty((N, M, H, W), dtype=m.dtype, device=img.device)
        rc = getattr(lib, entry[img.dtype])(
            img.data_ptr(), m.data_ptr(), res.data_ptr(), N, H, W, M, kh, kw,
            instance(kh, kw), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the parent's conv kernel: CUDA error {rc}")
        return res[0] if image.ndim == 2 else res

    return run


def parent_vote_kernel(tree: Path):
    """The parent commit's vote kernel, built from ``tree`` (an unpacked
    ``git archive`` of that commit) with this tree's nvcc flags, as
    ``run(xy, w, trig, n_rho, counts) -> votes`` on the wrapper's checked
    shapes (``w`` (N, P)): its C entry ``hough_vote_f32`` with the parent
    wrapper's arguments, into an output zeroed first, as that wrapper
    did.  The launch count does not see these launches."""
    import torch

    from repro_torch.kernels import _build

    src = (Path(tree) / "src" / "repro_torch" / "kernels" / "csrc"
           / "hough_vote.cu")
    out = ROOT / "build" / "parent_kernels" / "libhough_vote_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hough_vote_f32.argtypes = [P, L, P, L, P, P, P, I, I, I, I, I, P]
    lib.hough_vote_f32.restype = I

    def run(xy, w, trig, n_rho, counts):
        N, n_pix = w.shape
        C, T = trig.shape
        res = torch.zeros((N, n_rho, T), dtype=torch.float32, device=w.device)
        rc = lib.hough_vote_f32(
            xy.data_ptr(), xy.stride(0) if xy.ndim == 3 else 0,
            w.data_ptr(), w.stride(0),
            None if counts is None else counts.data_ptr(), trig.data_ptr(),
            res.data_ptr(), N, n_pix, C, T, n_rho,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the parent's vote kernel: CUDA error {rc}")
        return res

    return run


def vote_shapes(frames_dev, truths) -> dict:
    """The vote's main-path operands on the card, by name: ``(xy, w, trig,
    n_rho, counts)`` with ``w`` (N, P) and ``counts`` (N,) or None, as the
    wrapper hands them to its C entry.  From the 8 deployment frames: the
    staged batch's compacted edges ("boom" f32 and "boom+gemmini" integer
    Canny), the fused batch (``fused_detect``, no corridors), one
    full-sweep tracking frame (T 180, the staged path's compaction of frame
    1), one fused tracking frame (frame 1 through ``fused_detect`` with 8
    corridors around its lines, the 40-bin theta band around its first
    line); and the dense shared raster (``counts=None``): the "boom" batch's
    edge maps over all 8 x 720 x 1280 pixels (the default
    ``HoughConfig(compact=False)``), and four 240x320 frames."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_lines import DEPLOY_HW, FRAME_HW, PLATFORMS
    from repro_torch.core import CannyConfig, HoughConfig, canny
    from repro_torch.core.hough import _device_raster, hough_trig, rho_bins
    from repro_torch.data import scenario_batch, scenario_names
    from repro_torch.kernels import ops
    from repro_torch.kernels import fused_detect as fused_mod

    dev = frames_dev.device
    H, W = DEPLOY_HW
    N = frames_dev.shape[0]
    cap = ops.default_max_edges(H * W)
    trig = torch.from_numpy(hough_trig(H, W, HoughConfig())).to(dev)
    n_rho = rho_bins(H, W, HoughConfig())
    raster = _device_raster(H, W, dev)
    shapes = {}
    for name, platform in (("boom_batch", "boom"),
                           ("boom+gemmini_batch", "boom+gemmini")):
        edges = canny(frames_dev, PLATFORMS[platform].canny)
        w = (edges.reshape(N, -1) >= 250).float()
        cxy, cw, cnt = ops.compact_edges(raster, w, max_edges=cap)
        shapes[name] = (cxy, cw, trig, n_rho, cnt)
        if platform == "boom":
            shapes["dense_8x720x1280"] = (raster, w, trig, n_rho, None)
            one = ops.compact_edges(raster, w[1], max_edges=cap)
            shapes["frame_t180"] = (one[0], one[1][None], trig, n_rho,
                                    one[2].reshape(1))
    cxy, cw, cnt = fused_mod.fused_detect(
        frames_dev, None, cfg=CannyConfig(), edge_threshold=250.0,
        max_edges=cap)
    shapes["fused_batch"] = (cxy, cw, trig, n_rho, cnt)
    cor = torch.from_numpy(tracker_corridors(truths[1], 8)).to(dev)
    cxy, cw, cnt = fused_mod.fused_detect(
        frames_dev[1], cor, cfg=CannyConfig(), edge_threshold=250.0,
        max_edges=cap)
    centre = round(math.degrees(truths[1][0][1])) % trig.shape[1]
    band = (torch.arange(40, device=dev) + centre - 20) % trig.shape[1]
    shapes["band_t40"] = (cxy, cw[None], trig[:, band].contiguous(), n_rho,
                          cnt.reshape(1))
    hs, ws = FRAME_HW
    small, _ = scenario_batch(scenario_names()[:4], hs, ws, seed=1)
    w = (canny(torch.from_numpy(np.asarray(small)).to(dev), CannyConfig())
         .reshape(4, -1) >= 250).float()
    shapes["dense_4x240x320"] = (
        _device_raster(hs, ws, dev), w,
        torch.from_numpy(hough_trig(hs, ws, HoughConfig())).to(dev),
        rho_bins(hs, ws, HoughConfig()), None)
    return shapes


def vote_bound(xy, w, trig, n_rho, counts) -> tuple[float, str, int]:
    """The vote's bound on these operands, and its edge rows (rows of
    nonzero weight inside the counts): each counted row's (x, y, z) and
    weight read once (with no counts, every weight and the edge rows'
    coordinates), the counts and trig, the (N, n_rho, T) f32 output
    written once; 6 operations a (edge row, theta)."""
    import torch

    N, P = w.shape
    C, T = trig.shape
    live = w != 0
    if counts is not None:
        live &= torch.arange(P, device=w.device) < counts[:, None]
        n_bytes = int(counts.clamp(0, P).sum()) * (C * 4 + 4) + N * 4
    else:
        n_bytes = N * P * 4
    rows = int(live.sum())
    if counts is None:
        n_bytes += rows * C * 4
    n_bytes += trig.numel() * 4 + N * n_rho * T * 4
    b, by = bound_ms(n_bytes, rows * T * 6.0)
    return b, by, rows


def parent_fused_kernel(tree: Path):
    """The parent commit's ``fused_detect`` kernel, built from ``tree`` (an
    unpacked ``git archive`` of that commit) with this tree's nvcc flags,
    as ``run(x, corridors, cfg, max_edges) -> (cxy, cw, counts)``: this
    tree's wrapper launching the parent's library, whose C entries must be
    this tree's (the masks by value from host memory, the launch plan).
    The launch count does not see these launches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_detect as fused_mod

    src = (Path(tree) / "src" / "repro_torch" / "kernels" / "csrc"
           / "fused_detect.cu")
    out = ROOT / "build" / "parent_kernels" / "libfused_detect_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, timeout=600)
    lib = fused_mod.bind(ctypes.CDLL(str(out)))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    wrapper = fused_mod.fused_detect

    def run(x, cor, cfg, max_edges, edge_threshold=250.0):
        own, count = fused_mod._lib, fused_mod.launches
        fused_mod._lib = lambda: lib
        try:
            return wrapper(x, cor, cfg=cfg, edge_threshold=edge_threshold,
                           max_edges=max_edges)
        finally:
            fused_mod._lib, fused_mod.launches = own, count

    return run


def kernel_phases(trace: dict, runs: int) -> dict:
    """The device kernels of a ``gpu_trace`` by bare name (template
    arguments dropped), ms a run."""
    phases: dict[str, float] = {}
    for e in trace["top"]:
        name = (e["name"].replace("(anonymous namespace)::", "")
                .removeprefix("void ").split("(")[0].split("<")[0])
        phases[name] = phases.get(name, 0.0) + e["ms"] / runs
    return phases


# The slice's serving traffic: 8 greedy requests of these prompt lengths,
# 32 new tokens each, through 4 slots of 1152 positions.
SERVE_PROMPTS = (97, 128, 200, 255, 384, 513, 777, 1000)
SERVE_NEW, SERVE_SLOTS, SERVE_MAX_LEN = 32, 4, 1152


class Probe:
    """The model, with the launch counts zeroed just before each prefill
    and decode step and read just after (host clock, to synchronize on the
    card, around each), and each active slot's decode logits."""

    def __init__(self, m):
        self.m, self.engine = m, None
        self.prefills, self.decodes, self.logits = [], [], {}

    def __getattr__(self, name):
        return getattr(self.m, name)

    def _timed(self, fn):
        import torch

        from repro_torch.kernels import ops

        def sync():
            if self.m.device.type == "cuda":
                torch.cuda.synchronize()

        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3, ops.launch_counts()

    def prefill(self, params, batch, cache, *, positions=None):
        import torch

        out, ms, counts = self._timed(lambda: self.m.prefill(
            params, batch, cache, positions=positions))
        self.prefills.append({
            "tokens": int(batch["tokens"].shape[1]), "ms": ms,
            "launches": counts,
            "finite": bool(torch.isfinite(out[0]).all())})
        return out

    def decode_step(self, params, token, cache, pos, *, ring=False):
        import torch

        active = [(i, r) for i, r in enumerate(self.engine.slots) if r]
        out, ms, counts = self._timed(lambda: self.m.decode_step(
            params, token, cache, pos, ring=ring))
        lg = out[0]
        self.decodes.append({
            "active": len(active), "ms": ms, "launches": counts,
            "finite": bool(torch.isfinite(lg[[i for i, _ in active]])
                           .all())})
        for i, r in active:
            self.logits[(r.uid, len(r.output))] = lg[i].float().cpu()
        return out


def serve_traffic(model, params, prompts, new_tokens, *,
                  n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, device="cuda",
                  **engine_kw):
    """One Engine run of the traffic through a ``Probe``: (probe, engine,
    requests, seconds on the host clock to synchronize)."""
    import torch

    from repro_torch.serve import Engine, Request

    on_card = torch.device(device).type == "cuda"
    probe = Probe(model)
    eng = Engine(probe, params, n_slots=n_slots, max_len=max_len,
                 device=device, **engine_kw)
    probe.engine = eng
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    if on_card:
        torch.cuda.synchronize()
    return probe, eng, reqs, time.perf_counter() - t0


def launch_faults(probe, per_prefill):
    """Prefills whose launches differ from ``per_prefill`` (every other
    kernel 0), and decode steps that launched any kernel."""
    bad_p = [c for c in probe.prefills
             if c["launches"] != {**{k: 0 for k in c["launches"]},
                                  **per_prefill}]
    return bad_p, [c for c in probe.decodes if any(c["launches"].values())]


def mean_row(rows) -> dict:
    """The mean of timing rows' ms, plain_ms, bound_ms and library_ms
    (None if a row has none); bound by bytes if every row is."""
    out = {k: sum(r[k] for r in rows) / len(rows)
           for k in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in rows]
    out["library_ms"] = None if None in lib else sum(lib) / len(lib)
    out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                      for r in rows) else "operations")
    return out


def attention_bound(B, Hq, Hkv, L, D, itemsize, ops_per_s, *, Lkv=None,
                    causal=True):
    """``bound_ms`` of attention of L query rows over ``Lkv`` keys (L by
    default): q and the output (L rows), k and v (Lkv rows) moved once;
    4 * D FLOP for each unmasked (q, k) pair at ``ops_per_s``: L (L + 1)
    / 2 pairs causal (Lkv = L), L * Lkv without the mask."""
    Lkv = L if Lkv is None else Lkv
    pairs = L * (L + 1) // 2 if causal else L * Lkv
    return bound_ms(itemsize * B * D * (2 * Hq * L + 2 * Hkv * Lkv),
                    B * Hq * pairs * 4.0 * D, ops_per_s)


def bf16_rule(got, want, v) -> tuple:
    """The bf16 attention rule: every element of ``got`` within one bf16
    ulp of the larger of the two magnitudes plus 1e-5 of max|v| of
    ``want`` (both round an f32 value once; the f32 values differ by their
    summation order).  Returns (ok, max abs error, elements past 1 ulp)."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    tol = ulp + 1e-5 * float(v.float().abs().max())
    return bool((d <= tol).all()), float(d.max()), int((d > ulp).sum())


def logit_gaps(pairs) -> dict:
    """(want, got) logits, f32 on the CPU, each one or more rows over the
    vocabulary: the largest |want - got|, the largest |want|, the largest
    ||want - got|| / ||want|| of a row, the rows whose argmax agrees and
    the rows compared."""
    err = scale = rel = 0.0
    agree = n = 0
    for want, got in pairs:
        err = max(err, float((want - got).abs().max()))
        scale = max(scale, float(want.abs().max()))
        rel = max(rel, float(((want - got).norm(dim=-1)
                              / want.norm(dim=-1)).max()))
        agree += int((want.argmax(-1) == got.argmax(-1)).sum())
        n += want[..., 0].numel()
    return {"max_abs_err": err, "max_abs_logit": scale, "max_rel_l2": rel,
            "top1_agree": agree, "compared": n}


def anchor_verdict(tokens_card, tokens_cpu, pairs, expected) -> dict:
    """The CPU anchor's verdict on (CPU, card) decode logits ``pairs``
    (``logit_gaps``): the tokens equal, ``expected`` logit rows compared,
    every one within 1e-4 of the CPU's largest |logit|."""
    g = logit_gaps(pairs)
    ok = (tokens_card == tokens_cpu and g["compared"] == expected
          and g["max_abs_err"] <= 1e-4 * g["max_abs_logit"])
    return {"tokens_card": tokens_card, "tokens_cpu": tokens_cpu,
            "tokens_equal": tokens_card == tokens_cpu,
            "decode_logits_compared": g["compared"],
            "max_abs_err": g["max_abs_err"],
            "max_abs_logit": g["max_abs_logit"], "tol": "1e-4 of max|logit|",
            "ok": bool(ok)}


def teacher_forced(model, params, probe, reqs) -> dict:
    """Each request's decode-path logits at its first, middle and last
    step (as ``probe`` logged them in the Engine's run) against a fresh
    prefill of the same tokens at their exact length, on the model's
    device (``logit_gaps``)."""
    import torch

    def pairs():
        for r in reqs:
            seq = r.prompt + r.output
            for k in (0, SERVE_NEW // 2 - 1, SERVE_NEW - 1):
                lg, _ = model.prefill(
                    params, {"tokens": torch.tensor(
                        [seq[:len(r.prompt) + k]], device=model.device)},
                    model.init_cache(1, SERVE_MAX_LEN))
                yield lg[0].float().cpu(), probe.logits[(r.uid, k)]

    return logit_gaps(pairs())


def ssd_work(b, L, H, P, N, G, chunk=128):
    """The SSD scan's work for x (b, L, H, P), B and C (b, L, G, N), f32:
    (FLOP, FLOP with C B^T charged to every head, bytes).  The chunks'
    products are counted on their lower triangles, C B^T once per group
    (G r(r+1) N + H r(r+1) P + 4 H r N P a chunk of r real rows), plus x *
    dt; the bytes read x, dt, A, B, C and write y and the state once."""
    flops = flops_per_head = 0.0
    for c0 in range(0, L, chunk):
        r = min(chunk, L - c0)
        flops += (G * r * (r + 1) * N + H * r * (r + 1) * P
                  + 4.0 * H * r * N * P)
        flops_per_head += H * (r * (r + 1) * (N + P) + 4.0 * r * N * P)
    flops += L * H * P                            # x * dt
    flops_per_head += L * H * P
    n_bytes = 4 * (b * (2 * L * H * P + L * H + 2 * L * G * N + H * N * P)
                   + H)
    return b * flops, b * flops_per_head, n_bytes


def lm_phases(cuda_ms, parent=None) -> list:
    """The LM serving slice: zamba2-1.2b through the continuous-batching
    Engine, both LM kernels against their plain versions on the card, a
    full-width f32 run held against the port's CPU run, the full model in
    bf16 with its launches read per prefill and per decode step, and the
    kernels' times beside their bounds (the SSD kernel's beside the
    parent's, built from the tree ``parent``, where one is given).
    Returns the two kernels' entries of the ``kernels`` line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get
    from repro_torch.core import quantize_weights_int8
    from repro_torch.kernels import flash_attention as attn_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.models import build
    from repro_torch.models.layers import tree_items
    from repro_torch.serve import Engine, Request

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                * scale).to(dev, dtype)

    # --- lm_kernels_vs_plain ---------------------------------------------
    # bf16 attention: both round an f32 value once, so one bf16 ulp apart,
    # plus the f32 values' own difference (1e-5 of max|v|, the summation
    # order), which shows only where an output cancels to near 0.  f32
    # attention: 1e-5.  SSD (f32): 1e-4 relative to the chunked plain
    # version at the same chunk, 2e-3 to the sequential oracle
    # (tests/test_kernels.py).
    # The bf16 kernel runs on the tensor cores with p split in two bf16
    # halves for PV (attn_mod.FORM); its cases cover D = 8, 16, 128 (D
    # padded to 16), a ragged Lq, fully masked rows and q scaled by 4.
    checks = []
    bf16, f32 = torch.bfloat16, torch.float32
    attn_cases = [((1, 32, 32, L, L, 64), True, None, 0, bf16, 1.0)
                  for L in (127, 513, 1000)]
    attn_cases += [((1, 32, 8, 300, 700, 80), True, 256, 400, bf16, 1.0),
                   ((1, 8, 8, 37, 37, 8), True, None, 0, bf16, 1.0),
                   ((1, 8, 2, 37, 200, 16), True, None, 163, bf16, 1.0),
                   ((1, 4, 4, 24, 16, 128), False, 1, 0, bf16, 1.0),
                   ((1, 32, 32, 999, 999, 64), True, None, 0, bf16, 4.0),
                   ((1, 4, 1, 130, 130, 128), True, 64, 0, bf16, 4.0),
                   ((2, 4, 2, 100, 100, 64), True, 24, 0, f32, 1.0),
                   ((1, 4, 4, 37, 37, 16), False, None, 0, f32, 1.0),
                   ((1, 4, 1, 3, 200, 128), True, None, 197, f32, 1.0)]
    # the families' prefill geometry at D = 128 (lm_family_phases): yi-9b
    # GQA 32/4, granite-34b MQA 48/1, qwen1.5-32b MHA 40/40,
    # llama4-scout-17b-a16e GQA 40/8 (a group of 5), moonshot-v1-16b-a3b
    # MHA 16/16
    attn_cases += [((1, Hq, Hkv, L, L, 128), True, None, 0, bf16, 1.0)
                   for Hq, Hkv in ((32, 4), (48, 1), (40, 40), (40, 8),
                                   (16, 16))
                   for L in (127, 1000)]
    attn_err = 0.0
    for (B, Hq, Hkv, Lq, Lkv, D), causal, window, off, dt, qs in attn_cases:
        q = randn(B, Hq, Lq, D, scale=qs).to(dt)
        k, v = (randn(B, Hkv, Lkv, D, dtype=dt) for _ in range(2))
        got = attn_mod.flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=off)
        torch.cuda.synchronize()
        want = ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
        if dt == torch.bfloat16:
            ok, err, beyond_ulp = bf16_rule(got, want, v)
            rule = "1 bf16 ulp + 1e-5*max|v|"
        else:
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
            beyond_ulp = None
            rule = "rtol=atol=1e-5"
        attn_err = max(attn_err, err)
        checks.append({"kernel": "flash_attention",
                       "shape": [B, Hq, Hkv, Lq, Lkv, D], "causal": causal,
                       "window": window, "q_offset": off, "q_scale": qs,
                       "dtype": str(dt).removeprefix("torch."),
                       "form": attn_mod.FORM[dt],
                       "max_abs_err": err, "elements_beyond_1_ulp": beyond_ulp,
                       "tol": rule, "ok": ok})
    ssd_cases = [(1, L, 64, 64, 64, 1) for L in (97, 128, 999, 1000)]
    ssd_cases += [(2, 1, 4, 16, 8, 2), (2, 80, 4, 16, 8, 2)]
    ssd_err = 0.0
    for b, L, H, P, N, G in ssd_cases:
        x = randn(b, L, H, P, scale=0.1)
        dt_ = torch.from_numpy(rng.uniform(0.01, 0.1, (b, L, H))
                               .astype(np.float32)).to(dev)
        A = torch.from_numpy(-rng.uniform(0.5, 1.5, (H,))
                             .astype(np.float32)).to(dev)
        Bm, C = randn(b, L, G, N), randn(b, L, G, N)
        y, h = ssd_mod.ssd_scan(x, dt_, A, Bm, C)
        torch.cuda.synchronize()
        yc, hc = ref.ssd_scan_chunked(x, dt_, A, Bm, C)
        ys, hs = ref.ssd_scan(x, dt_, A, Bm, C)
        rel_c = max(float((y - yc).abs().max() / yc.abs().max()),
                    float((h - hc).abs().max() / hc.abs().max()))
        err = max(float((y - yc).abs().max()), float((h - hc).abs().max()))
        ok = (rel_c <= 1e-4 and torch.allclose(y, ys, rtol=2e-3, atol=2e-3)
              and torch.allclose(h, hs, rtol=2e-3, atol=2e-3))
        ssd_err = max(ssd_err, err)
        checks.append({"kernel": "ssd_scan", "shape": [b, L, H, P, N, G],
                       "chunk": min(128, L), "form": ssd_mod.FORM,
                       "max_abs_err": err,
                       "max_rel_err_vs_chunked_plain": rel_c,
                       "max_abs_err_vs_sequential": max(
                           float((y - ys).abs().max()),
                           float((h - hs).abs().max())),
                       "tol": "1e-4 rel vs chunked, 2e-3 vs sequential",
                       "ok": bool(ok)})
    emit({"phase": "lm_kernels_vs_plain", "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise SystemExit(f"LM kernel checks failed: {bad}")

    # --- serve_cpu_anchor: full width, 8 layers, f32, TF32 off ------------
    t_anchor = time.perf_counter()
    cfg8 = get("zamba2-1.2b").replace(n_layers=8, compute_dtype="float32")
    cpu_model, gpu_model = build(cfg8, device="cpu"), build(cfg8)
    params8 = cpu_model.init(torch.Generator().manual_seed(0))
    arng = np.random.default_rng(1)
    prompts8 = [[int(t) for t in arng.integers(1, cfg8.vocab, n)]
                for n in (9, 17, 24, 33)]

    def serve8(model, params, device):
        eng = Engine(model, params, n_slots=2, max_len=64, device=device)
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=4)
                for i, p in enumerate(prompts8)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.output for r in reqs]

    out_card = serve8(gpu_model, params8, None)
    out_cpu = serve8(cpu_model, params8, "cpu")
    worst = 0.0
    for prompt, toks, toks_cpu in zip(prompts8, out_card, out_cpu):
        if toks == toks_cpu:
            continue        # each card token is the CPU's own largest logit
        # teacher-forced on the CPU: each token the card emitted must have
        # a CPU logit within tau = 1e-3 * max|logit| of the CPU's largest
        cache = cpu_model.init_cache(1, 64)
        cpu_model.prefill(params8, {"tokens": torch.tensor([prompt[:-1]])},
                          cache)
        tok = prompt[-1]
        for i, e in enumerate(toks):
            lg, cache = cpu_model.decode_step(
                params8, torch.tensor([tok]), cache,
                torch.tensor([len(prompt) - 1 + i]))
            gap = float(lg[0].max() - lg[0, e]) / float(lg[0].abs().max())
            worst = max(worst, gap)
            tok = e
    anchor_s = time.perf_counter() - t_anchor
    anchor_ok = worst <= 1e-3
    emit({"phase": "serve_cpu_anchor", "config": "zamba2-1.2b, n_layers=8 "
          "(one superblock of 6 and the tail, 10 Mamba-2 layers as the "
          "reference stacks it), f32 compute, TF32 off",
          "prompt_lengths": [len(p) for p in prompts8], "new_tokens": 4,
          "tokens_card": out_card, "tokens_cpu": out_cpu,
          "requests_equal": [a == b for a, b in zip(out_card, out_cpu)],
          "worst_gap_of_card_token_rel_max_logit": worst, "tau": 1e-3,
          "seconds": anchor_s, "ok": anchor_ok})
    del params8, cpu_model, gpu_model
    if not anchor_ok:
        raise SystemExit(f"full-width f32 serving: a card token is {worst} "
                         "of the largest logit below the CPU's best")

    # --- serve: zamba2-1.2b at full width and depth ------------------------
    from repro_torch.models.transformer import pattern_for

    cfg = get("zamba2-1.2b")
    pattern, n_super, tail, n_tail = pattern_for(cfg)
    # The reference stacks its tail pattern of `tail` layers `tail` times,
    # so zamba2's 38 configured layers run as 6 x 6 + 2 x 2 = 40 Mamba-2
    # layers (ROADMAP.md, faults); one shared-block application a
    # superblock.
    n_mamba = n_super * pattern.count("mamba2") + n_tail * tail.count("mamba2")
    per_prefill = {"flash_attention": n_super, "ssd_scan": n_mamba}
    srng = np.random.default_rng(0)
    prompts = [[int(t) for t in srng.integers(1, cfg.vocab, n)]
               for n in SERVE_PROMPTS]

    # bf16, the deployment: times, launches, finite logits
    model = build(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    serve_traffic(model, params, prompts[:2], 2)   # warm-up
    probe, eng, reqs, run_s = serve_traffic(model, params, prompts, SERVE_NEW)
    done = all(r.done and len(r.output) == SERVE_NEW for r in reqs)
    finite = all(c["finite"] for c in probe.prefills + probe.decodes)
    bad_prefill, bad_decode = launch_faults(probe, per_prefill)
    tf = teacher_forced(model, params, probe, reqs)
    tf_bf16, scale_bf16 = tf["max_abs_err"], tf["max_abs_logit"]
    n_tok = sum(len(r.output) for r in reqs)
    full = [c["ms"] for c in probe.decodes if c["active"] == SERVE_SLOTS]
    launches = {"flash_attention": 0, "ssd_scan": 0}
    for c in probe.prefills + probe.decodes:
        for name in launches:
            launches[name] += c["launches"][name]
    # one prefill (the 1000-token prompt) and one decode step with every
    # slot active, profiled
    runs = {}
    long_prompt = prompts[-1][:-1]
    runs["prefill_999"] = gpu_trace(lambda: model.prefill(
        params, {"tokens": torch.tensor([long_prompt], device=dev)},
        model.init_cache(1, SERVE_MAX_LEN)), "zamba2_prefill", 1,
        focus=("flash_attention", "ssd_scan"))
    pos = torch.tensor([300, 500, 700, 1000], device=dev)
    tok = torch.tensor([1, 2, 3, 4], device=dev)
    runs["decode_step_4_slots"] = gpu_trace(lambda: model.decode_step(
        params, tok, eng.cache, pos), "zamba2_decode", 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del eng

    # --- serve_int8_weights: the paper's float -> int rewrite on the weights
    # quantize_weights_int8 on the card, each leaf held against the CPU's
    # quantization of the same leaf; dequantized to bf16, the same traffic
    # through the Engine (the matmul kernel stays off this path: the int8
    # weights are dequantized once, as the reference serves them); then
    # tests/test_serving_extras.py's teacher-forced measure, 12 decode
    # steps of 2 rows with both weight sets.
    t0 = time.perf_counter()
    qw, dequant = quantize_weights_int8(params, compute_dtype=cfg.cdtype)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    leaves = differ = 0
    for (path, p), (_, qv), (_, sv) in zip(tree_items(params),
                                           tree_items(qw["q"]),
                                           tree_items(qw["s"])):
        on_cpu, _ = quantize_weights_int8({"p": p.cpu()})
        leaves += 1
        if not (torch.equal(qv.cpu(), on_cpu["q"]["p"])
                and torch.equal(sv.cpu(), on_cpu["s"]["p"])):
            differ += 1
    cpu_check_s = time.perf_counter() - t0
    params_q = dequant(qw["q"], qw["s"])
    del qw
    weight_err = max(
        float((a.float() - b.float()).norm() / b.float().norm().clamp_min(
            1e-30)) for (_, a), (_, b) in zip(tree_items(params_q),
                                              tree_items(params)))
    probe_q, _, reqs_q, run_q_s = serve_traffic(model, params_q, prompts,
                                                SERVE_NEW)
    done_q = all(r.done and len(r.output) == SERVE_NEW for r in reqs_q)
    finite_q = all(c["finite"] for c in probe_q.prefills + probe_q.decodes)
    bad_pq, bad_dq = launch_faults(probe_q, per_prefill)
    same_tok = sum(a == b for r, rq in zip(reqs, reqs_q)
                   for a, b in zip(r.output, rq.output))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 12))).to(dev)
    caches = [model.init_cache(2, 24), model.init_cache(2, 24)]
    tf_errs, tf_la, tf_match = [], [], 0
    for t in range(12):
        pos = torch.full((2,), t, device=dev)
        la, caches[0] = model.decode_step(params, toks[:, t], caches[0], pos)
        lb, caches[1] = model.decode_step(params_q, toks[:, t], caches[1],
                                          pos)
        tf_errs.append(float((la - lb).abs().max()))
        tf_la.append(la)
        tf_match += int((la.argmax(-1) == lb.argmax(-1)).sum())
    tf_std = float(torch.stack(tf_la).std(correction=0))
    del params_q, caches
    int8_ok = (differ == 0 and done_q and finite_q and not bad_pq
               and not bad_dq)
    emit({"phase": "serve_int8_weights", "model": "zamba2-1.2b",
          "weights": "quantize_weights_int8 (int8, one f32 scale per output "
                     "column), dequantized to bf16",
          "leaves": leaves, "leaves_differing_from_cpu": differ,
          "weight_rel_err_max_over_leaves": weight_err,
          "quantize_seconds_on_card": quant_s,
          "cpu_check_seconds": cpu_check_s,
          "requests_done": sum(r.done for r in reqs_q),
          "all_logits_finite": finite_q,
          "expected_launches_per_prefill": per_prefill,
          "launches_per_prefill": [
              {k: c["launches"][k] for k in ("flash_attention", "ssd_scan",
                                             "tiled_matmul")}
              for c in probe_q.prefills],
          "prefills_with_wrong_launches": len(bad_pq),
          "decode_steps_launching_a_kernel": len(bad_dq),
          "engine_run_seconds": run_q_s,
          "tokens_per_s": sum(len(r.output) for r in reqs_q) / run_q_s,
          "tokens_equal_to_bf16_run": same_tok,
          "tokens_compared": SERVE_NEW * len(reqs),
          "requests_equal_to_bf16_run": sum(r.output == rq.output
                                            for r, rq in zip(reqs, reqs_q)),
          "teacher_forced_max_abs_err_over_std": max(tf_errs) / tf_std,
          "teacher_forced_top1_agree": tf_match,
          "teacher_forced_tokens": 24,
          "reference_criteria": "max|d| < 0.5 std, top-1 >= 70% "
                                "(tests/test_serving_extras.py; reported)",
          "ok": int8_ok})
    if not int8_ok:
        raise SystemExit(
            f"int8-weight serving failed: {differ} leaves differ from the "
            f"CPU, done={done_q} finite={finite_q} prefill launches "
            f"{bad_pq[:2]} decode launches {bad_dq[:2]}")

    matmul_entry = matmul_phases(cuda_ms, params)
    del params

    # f32 compute, the same traffic: the decode path against teacher-forced
    # prefills.  In bf16 the two paths round differently (decode rounds p
    # to bf16, as the reference does; the GEMMs of 1 and of L rows sum in
    # other orders) and a 40-layer random model amplifies the difference
    # with depth, so the 5e-2 of tests/test_models.py is held at f32, where
    # it tests the engine (cache, slots, state) and not the rounding; the
    # bf16 gap is reported beside it.
    model32 = build(cfg.replace(compute_dtype="float32"))
    params32 = model32.init(torch.Generator(dev).manual_seed(0))
    probe32, _, reqs32, run32_s = serve_traffic(model32, params32, prompts,
                                                SERVE_NEW)
    done32 = all(r.done and len(r.output) == SERVE_NEW for r in reqs32)
    bad_p32, bad_d32 = launch_faults(probe32, per_prefill)
    tf = teacher_forced(model32, params32, probe32, reqs32)
    tf_f32, scale_f32 = tf["max_abs_err"], tf["max_abs_logit"]
    del params32
    ssd_traced = runs["prefill_999"]["focus"]["ssd_scan"]["calls"]
    serve_ok = (done and finite and not bad_prefill and not bad_decode
                and done32 and not bad_p32 and not bad_d32
                and tf_f32 <= 5e-2
                and ssd_traced == n_mamba * ssd_mod.PASSES)
    emit({"phase": "serve", "model": "zamba2-1.2b",
          "configured_layers": cfg.n_layers, "mamba2_layers_run": n_mamba,
          "shared_block_applications": n_super, "d_model": cfg.d_model,
          "compute_dtype": cfg.compute_dtype,
          "params": model.param_count(), "n_slots": SERVE_SLOTS,
          "max_len": SERVE_MAX_LEN, "prompt_lengths": list(SERVE_PROMPTS),
          "new_tokens": SERVE_NEW, "requests_done": sum(r.done for r in reqs),
          "all_logits_finite": finite,
          "prefill_ms_by_prompt_length": {
              str(c["tokens"] + 1): c["ms"] for c in probe.prefills},
          "expected_launches_per_prefill": per_prefill,
          "launches_per_prefill": [
              {k: c["launches"][k] for k in launches}
              for c in probe.prefills],
          "decode_steps": len(probe.decodes),
          "decode_steps_launching_a_kernel": len(bad_decode),
          "launches_in_run": launches,
          "ssd_kernels_in_traced_prefill_999": ssd_traced,
          "ssd_kernels_expected": n_mamba * ssd_mod.PASSES,
          "decode_step_ms_4_slots_median": (float(np.median(full))
                                            if full else None),
          "decode_step_ms_4_slots_min": min(full) if full else None,
          "decode_steps_4_slots": len(full),
          "engine_run_seconds": run_s, "tokens_generated": n_tok,
          "tokens_per_s": n_tok / run_s,
          "teacher_forced_bf16_max_abs_err": tf_bf16,
          "teacher_forced_bf16_max_abs_logit": scale_bf16,
          "f32_run": {"requests_done": sum(r.done for r in reqs32),
                      "engine_run_seconds": run32_s,
                      "prefills_with_wrong_launches": len(bad_p32),
                      "decode_steps_launching_a_kernel": len(bad_d32),
                      "teacher_forced_max_abs_err": tf_f32,
                      "teacher_forced_max_abs_logit": scale_f32,
                      "bound": 5e-2},
          "profiled": runs, "peak_memory_gb": peak_gb, "ok": serve_ok})
    if not serve_ok:
        raise SystemExit(
            f"serving slice failed: done={done}/{done32} finite={finite} "
            f"prefill launches {bad_prefill[:2]} {bad_p32[:2]} decode "
            f"launches {bad_decode[:2]} {bad_d32[:2]} f32 teacher-forced "
            f"err {tf_f32}, {ssd_traced} SSD kernels traced in a prefill "
            f"(want {n_mamba * ssd_mod.PASSES})")

    # --- lm_times: each kernel per launch at the serving shapes ----------
    # Every time here (kernel, plain version, library call) is the device
    # time of one call, the least of 10 (`device_ms`): at these lengths 20
    # calls back to back would time the host's launches.  Attention: the
    # shared block's prefill, (1, 32, L, 64) bf16, L = each serving prompt
    # length - 1; bound: q, k, v read and out written once, against 4 * D
    # FLOP for each unmasked (q, k) pair at the bf16 tensor-core rate;
    # beside it, in the rows only, the bound of the kernel's own form, 6 * D
    # FLOP a pair (the split PV's second product), and at L = 999 the f32
    # FMA kernel (f32 operands) against its bound at the f32 rate, and ten
    # traced calls of the kernel and of SDPA (their device kernels by name,
    # from the profiler).  SSD: a Mamba-2 prefill, H = P = N = 64, G = 1,
    # f32 (the reference casts its inputs so), every pass of a call in its
    # one-launch time; bound: x, dt, A, B, C read and y and the state
    # written once, against the chunks' products at the f32 rate, C B^T
    # counted once per group (G r(r+1) N + H r(r+1) P + 4 H r N P a chunk of
    # r real rows: lower triangles only); beside it the count that charged
    # C B^T to every head, the same operations at the TF32 rate, and the
    # kernel's own form's bound (3 products at the TF32 rate); the blocks of
    # each pass; at L = 999 ten calls traced (each pass's kernel by name);
    # and the parent's kernel on the same inputs where a tree is given.
    parent_run = parent_ssd_kernel(parent) if parent else None
    attn_rows, ssd_rows = [], []
    for n in SERVE_PROMPTS:
        L = n - 1
        q, k, v = (randn(1, 32, L, 64, dtype=torch.bfloat16)
                   for _ in range(3))
        pairs = L * (L + 1) // 2
        b_ms, b_by = bound_ms(4 * 32 * L * 64 * 2, 32 * pairs * 4.0 * 64,
                              BF16_FLOPS_PER_S)

        def kernel():
            return attn_mod.flash_attention(q, k, v, causal=True)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        attn_rows.append({
            "L": L, "ms": device_ms(kernel),
            "plain_ms": device_ms(lambda: ref.attention(q, k, v, causal=True),
                                  n=3),
            "library_ms": device_ms(sdpa),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_split_pv": bound_ms(4 * 32 * L * 64 * 2,
                                          32 * pairs * 6.0 * 64,
                                          BF16_FLOPS_PER_S)[0]})
        if L == 999:
            # the achieved rate of the row's one-launch time; the kernel's
            # occupancy; the profiler's device time of the kernel and SDPA
            one_ms = attn_rows[-1]["ms"]
            occ = attn_mod.bf16_kernel_attributes(64)
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            attn_profile = {
                "L": L, "device_ms_one_launch": one_ms,
                "tflop_per_s": 32 * pairs * 4.0 * 64 / one_ms / 1e9,
                "tflop_per_s_split_pv": 32 * pairs * 6.0 * 64 / one_ms / 1e9,
                "grid_blocks": 32 * ((L + 63) // 64), "sms": n_sm,
                "warps_per_sm": 4 * occ["blocks_per_sm"], **occ,
                "kernel_traced": traced(kernel, "attn_kernel_999"),
                "sdpa_traced": traced(sdpa, "attn_sdpa_999")}
            q32, k32, v32 = (x.float() for x in (q, k, v))
            attn_f32 = {
                "L": L, "form": attn_mod.FORM[torch.float32],
                "ms": device_ms(lambda: attn_mod.flash_attention(
                    q32, k32, v32, causal=True)),
                "bound_ms": bound_ms(4 * 32 * L * 64 * 4,
                                     32 * pairs * 4.0 * 64)[0],
                "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                    q32, k32, v32, is_causal=True))}
        H = P = N = 64
        G = 1
        x = randn(1, L, H, P, scale=0.1)
        dt_ = torch.full((1, L, H), 0.05, device=dev)
        A = -torch.ones(H, device=dev)
        Bm, C = randn(1, L, G, N), randn(1, L, G, N)
        flops, flops_per_head, n_bytes = ssd_work(1, L, H, P, N, G)
        s_ms, s_by = bound_ms(n_bytes, flops)
        plan = ssd_mod.plan(1, L, H, G, N, P, min(128, L))
        blocks = {k.removeprefix("blocks_"): v for k, v in plan.items()
                  if k.startswith("blocks_")}

        def ssd_kernel():
            return ssd_mod.ssd_scan(x, dt_, A, Bm, C)

        row = {
            "L": L, "ms": device_ms(ssd_kernel),
            "plain_ms": device_ms(lambda: ref.ssd_scan_chunked(
                x, dt_, A, Bm, C), n=3),
            "library_ms": None, "bound_ms": s_ms, "bound_by": s_by,
            "gflop": flops / 1e9,
            "bound_ms_at_tf32_rate": bound_ms(n_bytes, flops,
                                              TF32_FLOPS_PER_S)[0],
            "bound_ms_3xtf32_form": bound_ms(n_bytes, 3 * flops,
                                             TF32_FLOPS_PER_S)[0],
            "gflop_cb_per_head": flops_per_head / 1e9,
            "bound_ms_cb_per_head": bound_ms(n_bytes, flops_per_head)[0],
            "blocks": blocks, "widest_pass_blocks": max(blocks.values())}
        if parent_run is not None:
            row["parent_ms"] = device_ms(lambda: parent_run(x, dt_, A, Bm, C))
        if L == 999:
            yk, hk = ssd_kernel()
            ssd_profile = {"L": L, "form": ssd_mod.FORM,
                           "passes": ssd_mod.PASSES, "blocks": blocks,
                           "smem_bytes": {k: plan[k] for k in (
                               "smem_chunk", "smem_output")},
                           "kernel_traced": traced(ssd_kernel,
                                                   "ssd_kernel_999")}
            if parent_run is not None:
                yp, hp = parent_run(x, dt_, A, Bm, C)
                ssd_profile["parent_tree"] = str(parent)
                ssd_profile["parent_max_abs_diff"] = max(
                    float((yk - yp).abs().max()), float((hk - hp).abs().max()))
                ssd_profile["parent_traced"] = traced(
                    lambda: parent_run(x, dt_, A, Bm, C), "ssd_parent_999")
        ssd_rows.append(row)

    attn_mean, ssd_mean = mean_row(attn_rows), mean_row(ssd_rows)
    if parent_run is not None:
        ssd_mean["parent_ms"] = (sum(r["parent_ms"] for r in ssd_rows)
                                 / len(ssd_rows))
    emit({"phase": "lm_times", "note": "device ms of one launch, the least "
          "of 10; the means are over the 8 serving prefill lengths, each "
          "launched 6 (attention) or 40 (SSD) times a prefill; no PyTorch "
          "call computes the SSD scan",
          "flash_attention": {"form": attn_mod.FORM[torch.bfloat16],
                              "by_length": attn_rows, "mean": attn_mean,
                              "f32_fma_kernel": attn_f32,
                              "profile_one_launch": attn_profile},
          "ssd_scan": {"form": ssd_mod.FORM, "passes": ssd_mod.PASSES,
                       "by_length": ssd_rows, "mean": ssd_mean,
                       "profile_one_launch": ssd_profile}})
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:97",
         "path": "zamba2_serve", "launches": launches["flash_attention"],
         "form": attn_mod.FORM[torch.bfloat16],
         "max_abs_err": attn_err, **attn_mean},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:72",
         "path": "zamba2_serve", "launches": launches["ssd_scan"],
         "form": ssd_mod.FORM, "passes": ssd_mod.PASSES,
         "max_abs_err": ssd_err, **ssd_mean},
        matmul_entry,
    ]


# The training slice: the CLI's run at full width and depth, and its cut
TRAIN_ARGV = ("--arch", "zamba2-1.2b", "--preset", "full", "--global-batch",
              "8", "--seq", "512", "--steps", "8", "--ckpt-every", "4",
              "--log-every", "1")
TRAIN_RESUME_AT = 4


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _grads_of(fn, inputs, cot):
    """``fn``'s outputs and the gradients of every input against ``cot``."""
    import torch

    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    return outs, torch.autograd.grad(outs, leaves, cot)


KERNEL_KINDS = (("ssd_scan", ("ssd_scan",)),
                ("flash_attention", ("flash_attention",)),
                ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                ("reduce", ("reduce_kernel",)),
                ("copy", ("copy_kernel", "CatArrayBatched")),
                ("elementwise", ("elementwise_kernel",)))


def trace_by_kind(path: Path) -> dict:
    """A saved trace's GPU activities summed by kind (the first of
    ``KERNEL_KINDS`` whose substring the name holds; memsets and copies
    by their category; "other" for the rest): calls and ms of each."""
    events = json.loads(path.read_text())["traceEvents"]
    out: dict[str, dict] = {}
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memset", "gpu_memcpy"):
            continue
        if "spin_kernel" in e["name"]:
            continue
        kind = ("copy" if cat != "kernel" else next(
            (k for k, subs in KERNEL_KINDS
             if any(x in e["name"] for x in subs)), "other"))
        row = out.setdefault(kind, {"calls": 0, "ms": 0.0})
        row["calls"] += 1
        row["ms"] += e["dur"] / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def train_phases() -> dict:
    """The training slice (``repro_torch.train``, ``launch/train.py``):
    the two LM kernels' gradients through ``kernels.ops`` against the
    plain versions' autograd on the card (``train_kernel_grads``);
    zamba2-1.2b at full width, cut to the serving anchor's 10 Mamba-2
    layers, f32, two steps on the card against the port's CPU
    (``train_vs_cpu``); and ``launch.train.main`` at full width and depth
    in bf16 over the f32 master, 8 steps of 8 x 512 tokens with a
    checkpoint at step 4, then ``--resume`` from it (``train``): losses,
    ms a warm step, tokens/s, peak memory, each kernel's launches a step,
    and one step traced.  Returns the kernels' launches in that run and in
    one step."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.data import TokenPipelineConfig, TokenStream
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build
    from repro_torch.models.layers import tree_items, tree_map
    from repro_torch.sharding.partition import local_tree
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train.optim import adamw_update

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(
            dtype)

    # --- train_kernel_grads ------------------------------------------------
    # Attention: the kernel's forward, the plain blockwise backward (lse
    # from the plain pass) against autograd of the dense plain version on
    # the card.  f32: 1e-4 of max|g|; bf16: 1e-2 of max|g| (both round an
    # f32 gradient to bf16 once; the backward's row sums read the kernel's
    # bf16 output, within a bf16 ulp of the plain one).  SSD: the kernel's
    # forward, the chunked plain form recomputed for the backward, against
    # autograd of the chunked plain form: 1e-5 of max|g| (the same ops),
    # y within 1e-4 (3xTF32); dt = softplus(N(0, 1)), whose 128-step sums
    # pass 88 (the masked exponent, ROADMAP.md §3).  The first rows are
    # the train path's own shapes.
    t_grads = time.perf_counter()
    checks = []
    bf16, f32 = torch.bfloat16, torch.float32
    attn_cases = [((8, 32, 32, 512, 64), True, None, bf16),
                  ((8, 32, 32, 512, 64), True, None, f32),
                  ((1, 32, 8, 300, 64), True, 128, bf16),
                  ((1, 4, 1, 130, 128), True, 64, bf16),
                  ((2, 8, 2, 200, 64), False, None, f32)]
    for (B, Hq, Hkv, L, D), causal, window, dt in attn_cases:
        q = randn(B, Hq, L, D, dtype=dt)
        k, v = (randn(B, Hkv, L, D, dtype=dt) for _ in range(2))
        do = randn(B, Hq, L, D, dtype=dt)
        kw = dict(causal=causal, window=window)
        ops.reset_launch_counts()
        (out,), got = _grads_of(
            lambda a, b, c: ops.flash_attention(a, b, c, **kw), (q, k, v),
            (do,))
        torch.cuda.synchronize()
        launched = ops.launch_counts()["flash_attention"]
        (want_out,), want = _grads_of(
            lambda a, b, c: ref.attention(a, b, c, **kw), (q, k, v), (do,))
        tol = 1e-4 if dt == f32 else 1e-2
        out_tol = 1e-5 if dt == f32 else 1e-2
        errs = {n: _rel_err(g, w) for n, g, w in zip("qkv", got, want)}
        out_err = _rel_err(out, want_out)
        checks.append({
            "kernel": "flash_attention", "shape": [B, Hq, Hkv, L, D],
            "causal": causal, "window": window,
            "dtype": str(dt).removeprefix("torch."),
            "launches": launched,
            "out_rel_err": out_err,
            "grad_rel_err": errs,
            "tol": f"{tol} of max|g|, out {out_tol} of max|out|",
            "ok": bool(launched == 1 and max(errs.values()) <= tol
                       and out_err <= out_tol
                       and all(torch.isfinite(g).all() for g in got))})
    for b, L, G in ((8, 512, 1), (2, 128, 1), (2, 128, 2), (2, 999, 1),
                    (2, 999, 2), (2, 512, 2)):
        H = P = N = 64
        x = randn(b, L, H, P, scale=0.1)
        dt_ = torch.nn.functional.softplus(randn(b, L, H))
        A = -torch.rand(H, generator=gen, device=dev) - 0.5
        Bm, C = randn(b, L, G, N), randn(b, L, G, N)
        dy, dh = randn(b, L, H, P), randn(b, H, N, P)
        ops.reset_launch_counts()
        (y, h), got = _grads_of(ops.ssd_scan, (x, dt_, A, Bm, C), (dy, dh))
        torch.cuda.synchronize()
        launched = ops.launch_counts()["ssd_scan"]
        (yw, hw), want = _grads_of(ref.ssd_scan_chunked, (x, dt_, A, Bm, C),
                                   (dy, dh))
        errs = {n: _rel_err(g, w)
                for n, g, w in zip(("x", "dt", "A", "B", "C"), got, want)}
        y_err = max(_rel_err(y, yw), _rel_err(h, hw))
        checks.append({
            "kernel": "ssd_scan", "shape": [b, L, H, P, N, G],
            "launches": launched, "y_rel_err": y_err,
            "max_decay_sum_in_a_chunk": float(
                (dt_ * -A).unflatten(1, (-1, min(128, L))).sum(2).max())
            if L % min(128, L) == 0 else None,
            "grad_rel_err": errs, "tol": "1e-5 of max|g|, y 1e-4",
            "ok": bool(launched == 1 and max(errs.values()) <= 1e-5
                       and y_err <= 1e-4
                       and all(torch.isfinite(g).all() for g in got))})
    emit({"phase": "train_kernel_grads", "checks": checks,
          "seconds": time.perf_counter() - t_grads})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise SystemExit(f"LM kernel gradients failed: {bad}")

    # --- train_vs_cpu: full width, 10 Mamba-2 layers, f32 ------------------
    # Two steps from the same parameters and batches on the card and on
    # the port's CPU.  loss within 1e-4 relative, grad_norm within 1e-3;
    # each parameter within 2 lr (an update is lr times a ratio of the
    # moments, about 1 for a first step, so a gradient at rounding level
    # may flip it), no more than 1% of the elements past 1e-6, and the
    # card's change of the parameters within 0.1 of the CPU's in norm (a
    # skipped update reads 1, one of the wrong sign 2).
    t_anchor = time.perf_counter()
    cfg8 = get("zamba2-1.2b").replace(n_layers=8, compute_dtype="float32")
    params8 = build(cfg8, device="cpu").init_master(
        torch.Generator().manual_seed(0))
    stream8 = TokenStream(TokenPipelineConfig(vocab=cfg8.vocab, seq_len=128,
                                              global_batch=2, seed=0))
    opt8 = AdamWConfig(peak_lr=1e-4, warmup_steps=0, decay_steps=10)

    def two_steps(device):
        m = build(cfg8, device=device)
        state = init_train_state(tree_map(lambda t: t.to(device), params8))
        step = make_train_step(m, opt8)
        rows = []
        t0 = time.perf_counter()
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in stream8.batch_at(i).items()}
            state, met = step(state, batch)
            rows.append({k: float(met[k]) for k in ("loss", "grad_norm",
                                                    "lr")})
        return state, rows, time.perf_counter() - t0

    ops.reset_launch_counts()
    card_state, card_rows, card_s = two_steps(dev)
    card_launches = ops.launch_counts()
    cpu_state, cpu_rows, cpu_s = two_steps("cpu")
    p_err = beyond = total = 0
    gap_sq = step_sq = 0.0
    for (_, a), (_, b), (_, p0) in zip(tree_items(card_state.params),
                                       tree_items(cpu_state.params),
                                       tree_items(params8)):
        a = a.cpu()
        d = (a - b).abs()
        p_err = max(p_err, float(d.max()))
        beyond += int((d > 1e-6).sum())
        total += d.numel()
        gap_sq += float(d.double().square().sum())
        step_sq += float((b - p0).double().square().sum())
    update_rel = (gap_sq / step_sq) ** 0.5 if step_sq else float("inf")
    loss_rel = max(abs(a["loss"] / b["loss"] - 1)
                   for a, b in zip(card_rows, cpu_rows))
    gn_rel = max(abs(a["grad_norm"] / b["grad_norm"] - 1)
                 for a, b in zip(card_rows, cpu_rows))
    anchor_ok = (loss_rel <= 1e-4 and gn_rel <= 1e-3
                 and p_err <= 2 * opt8.peak_lr and beyond <= 0.01 * total
                 and update_rel <= 0.1
                 and all(np.isfinite(r["loss"]) for r in card_rows))
    emit({"phase": "train_vs_cpu", "config": "zamba2-1.2b, n_layers=8 (one "
          "superblock of 6 and the tail: 10 Mamba-2 layers), f32 compute, "
          "remat, TF32 off", "batch": 2, "seq": 128, "steps": 2,
          "params": build(cfg8, device="cpu").param_count(),
          "card": card_rows, "cpu": cpu_rows,
          "card_launches": card_launches,
          "loss_rel_err": loss_rel, "grad_norm_rel_err": gn_rel,
          "param_max_abs_err": p_err, "param_bound": 2 * opt8.peak_lr,
          "param_elements_past_1e-6": beyond, "param_elements": total,
          "param_elements_past_1e-6_limit": 0.01 * total,
          "update_rel_err": update_rel, "update_rel_bound": 0.1,
          "card_seconds": card_s, "cpu_seconds": cpu_s,
          "seconds": time.perf_counter() - t_anchor, "ok": anchor_ok})
    del card_state, cpu_state, params8
    if not anchor_ok:
        raise SystemExit("full-width f32 train steps: the card left the CPU "
                         f"(loss {loss_rel}, grad_norm {gn_rel}, params "
                         f"{p_err}, {beyond} past 1e-6, update "
                         f"{update_rel})")

    # --- train: launch.train.main at full width and depth ------------------
    # bf16 compute over the f32 master, remat, checkpoints every 4 steps
    # under build/; the step-8 checkpoint is removed and --resume runs
    # steps 5-8 from step 4's.  Step 5's loss is the forward of the same
    # restored parameters on the same batch: equal within 1e-6 relative.
    t_train = time.perf_counter()
    # earlier phases' tensors held only by reference cycles are freed
    # here, so that the run's peak is its own (the rest is reported)
    gc.collect()
    torch.cuda.empty_cache()
    allocated_before_gb = torch.cuda.memory_allocated() / 1e9
    ckpt_root = ROOT / "build"
    ckpt_root.mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=ckpt_root))
    argv = [*TRAIN_ARGV, "--ckpt", str(ckpt)]
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = train_cli.main(argv)
        run_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = int(local_tree(state.step))
        args = train_cli.parse_args(argv)
        cfg = train_cli.preset_config(args.arch, args.preset)
        model = build(cfg)
        placement = {"run": host_mesh_placement(model, state)}
        del state
        shutil.rmtree(ckpt / f"step_{steps:08d}")
        t0 = time.perf_counter()
        state, hist_r = train_cli.main(argv + ["--resume"])
        resume_s = time.perf_counter() - t0
        placement["resumed"] = host_mesh_placement(model, state)
        state = local_tree(state)
        ckpt_mb = sum(f.stat().st_size for f in ckpt.rglob("*")) / 1e6
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    step_fn = make_train_step(model, train_cli.optimizer_config(args))
    stream = TokenStream(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.global_batch))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(steps).items()}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, met = step_fn(state, batch)
    torch.cuda.synchronize()
    one_step_ms = (time.perf_counter() - t0) * 1e3
    per_step = ops.launch_counts()
    traced_step = gpu_trace(lambda: step_fn(state, batch), "train_step", 1,
                            focus=("flash_attention", "ssd_scan"))
    by_kind = trace_by_kind(ROOT / traced_step["trace"])
    # the update alone: AdamW over the full state with the parameters as
    # gradients, behind a ~50 ms spin that hides its ~1000 launches
    update_ms = device_ms(lambda: adamw_update(
        state.params, state.opt, state.params, state.step,
        AdamWConfig(peak_lr=args.lr)), n=3, spin=100_000_000)
    del state, met
    first = {h["step"]: h["loss"] for h in hist}
    resumed = {h["step"]: h["loss"] for h in hist_r}
    warm = [h["ms_per_step"] for h in hist[1:]]
    ms_warm = float(np.median(warm))
    tokens = args.global_batch * args.seq
    n_super = cfg.n_layers // cfg.share_every
    n_mamba = n_super * cfg.share_every + (cfg.n_layers % cfg.share_every) ** 2
    want_step = {"flash_attention": 2 * n_super, "ssd_scan": 2 * n_mamba}
    step5_rel = abs(resumed[TRAIN_RESUME_AT + 1]
                    / first[TRAIN_RESUME_AT + 1] - 1)
    train_ok = (all(np.isfinite(h["loss"]) for h in hist + hist_r)
                and sorted(resumed) == list(range(TRAIN_RESUME_AT + 1,
                                                  steps + 1))
                and step5_rel <= 1e-6
                and {k: per_step[k] for k in want_step} == want_step
                and {k: launches[k] for k in want_step}
                == {k: steps * v for k, v in want_step.items()}
                and all(p["ok"] for p in placement.values()))
    emit({"phase": "train", "argv": argv[:-2] + ["--ckpt", "<tmp>"],
          "placement": placement,
          "model": cfg.name, "params": model.param_count(),
          "compute_dtype": cfg.compute_dtype, "param_dtype": cfg.param_dtype,
          "remat": cfg.remat, "tokens_per_step": tokens,
          "losses": first, "losses_resumed": resumed,
          "step5_loss_rel_diff": step5_rel, "step5_tol": 1e-6,
          "resumed_loss_rel_diff": {
              s: abs(resumed[s] / first[s] - 1) for s in resumed},
          "grad_norms": {h["step"]: h["grad_norm"] for h in hist},
          "lrs": {h["step"]: h["lr"] for h in hist},
          "ms_per_step": {h["step"]: h["ms_per_step"] for h in hist},
          "ms_per_warm_step_median": ms_warm,
          "tokens_per_s": tokens / ms_warm * 1e3,
          "one_step_ms_after_the_runs": one_step_ms,
          "peak_memory_gb": peak_gb,
          "allocated_before_the_run_gb": allocated_before_gb,
          "launches_in_run": {k: launches[k] for k in want_step},
          "launches_per_step": per_step, "expected_per_step": want_step,
          "checkpoint_mb": ckpt_mb, "run_seconds": run_s,
          "resume_seconds": resume_s, "profiled_step": traced_step,
          "device_ms_by_kind": by_kind,
          "device_busy_ms_over_unprofiled_step_ms":
              traced_step["device_busy_ms"] / one_step_ms,
          "adamw_update_device_ms": update_ms,
          "seconds": time.perf_counter() - t_train, "ok": train_ok})
    if not train_ok:
        raise SystemExit(f"training failed: losses {first} / {resumed}, "
                         f"launches a step {per_step}, in the run "
                         f"{launches}")
    return {"launches": {k: launches[k] for k in want_step},
            "per_step": {k: per_step[k] for k in want_step},
            "peak_memory_gb": peak_gb, "losses": first, "ms_warm": ms_warm}


def misplaced_leaves(state, shardings) -> list:
    """Paths of a TrainState's leaves that are not DTensors on the card on
    their sharding's mesh with its placements."""
    got, want = _state_leaves(state), _state_leaves(shardings)
    return [".".join(p) for p, sh in want.items()
            if getattr(got[p], "device_mesh", None) is not sh.mesh
            or got[p].placements != sh.placements
            or got[p].to_local().device.type != "cuda"]


def host_mesh_placement(model, state) -> dict:
    """Whether every leaf of a TrainState returned by ``launch.train.main``
    is a DTensor on the card's (1, 1) ("data", "model") host mesh with the
    placements that ``train_state_shardings`` gives there (computed on the
    state's own mesh)."""
    from torch.distributed.tensor import Shard

    from repro_torch.train import train_state_shardings

    mesh = getattr(state.step, "device_mesh", None)
    if mesh is None:
        return {"ok": False, "mesh": None}
    _, shardings = train_state_shardings(model, mesh)
    want = _state_leaves(shardings)
    wrong = misplaced_leaves(state, shardings)
    shape = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
             "device_type": mesh.device_type}
    return {"ok": not wrong and shape == {"shape": [1, 1],
                                          "names": ["data", "model"],
                                          "device_type": "cuda"},
            "mesh": shape, "leaves": len(want), "leaves_misplaced": wrong,
            "sharded_leaves": sum(any(isinstance(pl, Shard)
                                      for pl in sh.placements)
                                  for sh in want.values())}


def train_shape_times() -> dict:
    """The two LM kernels at the train step's shapes (``train``: zamba2-1.2b,
    8 x 512 tokens), one forward launch each: device ms (least of 10),
    the plain version's and, for attention, SDPA's beside the bound.
    Attention (8, 32, 512, 64) bf16, causal (``attention_bound``); SSD x
    (8, 512, 64, 64), B and C (8, 512, 1, 64), f32, chunk 128
    (``ssd_work`` at the f32 rate)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as attn_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_mod

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(
            dtype)

    B, H, L, D = 8, 32, 512, 64
    q, k, v = (randn(B, H, L, D, dtype=torch.bfloat16) for _ in range(3))
    a_ms, a_by = attention_bound(B, H, H, L, D, 2, BF16_FLOPS_PER_S)
    attn = {"shape": [B, H, H, L, D], "dtype": "bfloat16",
            "ms": device_ms(lambda: attn_mod.flash_attention(q, k, v)),
            "plain_ms": device_ms(lambda: ref.attention(q, k, v), n=3),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)),
            "bound_ms": a_ms, "bound_by": a_by}
    b, Hs, P, N, G = 8, 64, 64, 64, 1
    x = randn(b, L, Hs, P, scale=0.1)
    dt_ = torch.full((b, L, Hs), 0.05, device=dev)
    A = -torch.ones(Hs, device=dev)
    Bm, C = randn(b, L, G, N), randn(b, L, G, N)
    flops, _, n_bytes = ssd_work(b, L, Hs, P, N, G)
    s_ms, s_by = bound_ms(n_bytes, flops)
    ssd = {"shape": [b, L, Hs, P, N, G], "dtype": "float32",
           "ms": device_ms(lambda: ssd_mod.ssd_scan(x, dt_, A, Bm, C)),
           "plain_ms": device_ms(lambda: ref.ssd_scan_chunked(
               x, dt_, A, Bm, C), n=3),
           "library_ms": None, "bound_ms": s_ms, "bound_by": s_by}
    emit({"phase": "train_shape_times", "note": "one forward launch at the "
          "train step's shapes, device ms, least of 10",
          "flash_attention": attn, "ssd_scan": ssd})
    return {"flash_attention": attn, "ssd_scan": ssd}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _state_leaves(state) -> dict:
    """path -> tensor of a TrainState (step, parameters, moments)."""
    from repro_torch.models.layers import tree_items

    out = {("step",): state.step}
    for name, tree in (("params", state.params), ("m", state.opt["m"]),
                       ("v", state.opt["v"])):
        out.update({(name,) + p: t for p, t in tree_items(tree)})
    return out


def sharding_phases(train_peak_gb: float) -> dict:
    """The sharding layer on the card (phase ``sharding``): each user's
    path placed on a one-device mesh (``repro_torch.sharding``,
    ``launch/mesh.py``) against the same path unplaced, bit for bit.

    (a) zamba2-1.2b at full width and depth, the ``train`` phase's workload
    (8 x 512 tokens, bf16 over the f32 master, remat): its TrainState
    placed by ``train_state_shardings`` and its batch by the batch
    shardings on ``make_host_mesh()`` (no copy), one ``make_train_step``
    under ``activate(mesh, DEFAULT_RULES)`` against one step from the same
    state unplaced: loss, grad norm, step, every parameter and moment
    equal; the kernels' launches a step; the placed step's peak memory
    within 1 GB of the ``train`` phase's.  The unplaced step's new state
    waits on the host while the placed step runs.  (b) zamba2-1.2b bf16
    serving: parameters and a 4-slot cache placed under DECODE_RULES
    (``param_axes``, ``Model.cache_spec``), a prefill of 4 x 128 tokens
    and 4 greedy decode steps against the same unplaced: every logit and
    token equal.  (c) the 8-frame 720x1280 batch ``shard_slots``-placed on
    ``make_replica_mesh(1)``, through ``DetectionPlan.run`` staged and
    fused: the result's fields and the votes ``get_lines`` reads equal the
    unplaced batch's.  Returns each kernel's launches on the placed
    paths."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeSpec, get
    from repro_torch.core import HoughConfig, PipelineConfig
    from repro_torch.core.plan import DetectionPlan
    from repro_torch.data import (
        TokenPipelineConfig, TokenStream, scenario_batch,
    )
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh, make_replica_mesh
    from repro_torch.models import build
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.layers import tree_items
    from repro_torch.sharding import (
        DECODE_RULES, DEFAULT_RULES, activate, shardings_for_tree,
    )
    from repro_torch.sharding.partition import shard_slots
    from repro_torch.train import (
        AdamWConfig, distribute_tree, init_train_state, make_train_step,
        train_state_shardings,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    created_group = not dist.is_initialized()
    mesh = make_host_mesh()
    replica_mesh = make_replica_mesh(1)
    for m in (mesh, replica_mesh):
        if m.device_type != "cuda":
            raise SystemExit(f"the sharding phase's mesh {m} is not on the "
                             "card")
    gc.collect()
    torch.cuda.empty_cache()
    allocated_before_gb = torch.cuda.memory_allocated() / 1e9

    def same_storage(placed, plain) -> bool:
        return all(placed[p].to_local().data_ptr() == t.data_ptr()
                   for p, t in plain.items())

    # --- (a) a placed train step --------------------------------------------
    t_train = time.perf_counter()
    args = train_cli.parse_args([*TRAIN_ARGV])
    cfg = train_cli.preset_config(args.arch, args.preset)
    model = build(cfg)
    # warmup 0: the first step's lr is the peak, so the step moves every
    # parameter
    step_fn = make_train_step(model, AdamWConfig(
        peak_lr=args.lr, warmup_steps=0, decay_steps=args.steps))
    state = init_train_state(
        model.init_master(torch.Generator(dev).manual_seed(0)))
    stream = TokenStream(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.global_batch))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(0).items()}
    n_super = cfg.n_layers // cfg.share_every
    n_mamba = n_super * cfg.share_every + (cfg.n_layers % cfg.share_every) ** 2
    per_call = 2 if cfg.remat else 1
    want_step = {"flash_attention": per_call * n_super,
                 "ssd_scan": per_call * n_mamba}

    def one_step(s, b):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        new, met = step_fn(s, b)
        torch.cuda.synchronize()
        return (new, met, (time.perf_counter() - t0) * 1e3,
                ops.launch_counts(),
                torch.cuda.max_memory_allocated() / 1e9)

    new, met, plain_ms, plain_launches, plain_peak = one_step(state, batch)
    want = {p: t.cpu() for p, t in _state_leaves(new).items()}
    want_met = {k: met[k].cpu() for k in ("loss", "grad_norm")}
    del new, met
    gc.collect()

    _, shardings = train_state_shardings(model, mesh, DEFAULT_RULES)
    placed = distribute_tree(state, shardings)
    shape = ShapeSpec("train", args.seq, args.global_batch, "train")
    placed_batch = distribute_tree(batch, shardings_for_tree(
        zoo.batch_axes(cfg, "train"), zoo.input_specs(cfg, shape), mesh,
        DEFAULT_RULES))
    no_copy = (same_storage(_state_leaves(placed), _state_leaves(state))
               and same_storage(placed_batch, batch))
    with activate(mesh, DEFAULT_RULES):
        got, got_met, placed_ms, launches, peak_gb = one_step(placed,
                                                              placed_batch)
    got_leaves, before = _state_leaves(got), _state_leaves(state)
    expected = _state_leaves(shardings)
    unequal = [".".join(p) for p, w in want.items()
               if not torch.equal(got_leaves[p].to_local(), w.to(dev))]
    misplaced = [".".join(p) for p, s in expected.items()
                 if got_leaves[p].placements != s.placements]
    moved = sum(not torch.equal(got_leaves[p].to_local(), before[p])
                for p in want if p[0] == "params")
    metrics_equal = all(torch.equal(got_met[k].cpu(), want_met[k])
                        for k in want_met)
    train = {
        "model": cfg.name, "params": model.param_count(),
        "tokens": args.global_batch * args.seq,
        "mesh": {"shape": list(mesh.shape),
                 "names": list(mesh.mesh_dim_names),
                 "device_type": mesh.device_type},
        "placements_sample": {".".join(p): str(s.placements)
                              for p, s in list(expected.items())[:4]},
        "placed_without_copy": no_copy,
        "loss": float(want_met["loss"]),
        "grad_norm": float(want_met["grad_norm"]),
        "metrics_bit_equal": metrics_equal,
        "leaves": len(want), "leaves_unequal": unequal,
        "leaves_misplaced": misplaced,
        "parameter_leaves_moved_by_the_step": moved,
        "launches_placed": {k: launches[k] for k in want_step},
        "launches_unplaced": {k: plain_launches[k] for k in want_step},
        "expected_launches": want_step,
        "step_ms_unplaced": plain_ms, "step_ms_placed": placed_ms,
        "peak_memory_gb_placed": peak_gb,
        "peak_memory_gb_unplaced": plain_peak,
        "train_phase_peak_memory_gb": train_peak_gb,
        "peak_limit_gb": train_peak_gb + 1.0,
        "allocated_before_gb": allocated_before_gb,
        "seconds": time.perf_counter() - t_train}
    train["ok"] = bool(
        no_copy and metrics_equal and not unequal and not misplaced
        and moved > 0
        and train["launches_placed"] == want_step
        and train["launches_unplaced"] == want_step
        and peak_gb <= train_peak_gb + 1.0)
    del state, placed, got, got_leaves, before, want, batch, placed_batch
    gc.collect()
    torch.cuda.empty_cache()

    # --- (b) a placed decode ------------------------------------------------
    t_decode = time.perf_counter()
    serve_cfg = get("zamba2-1.2b")
    smodel = build(serve_cfg)
    params = smodel.init(torch.Generator(dev).manual_seed(0))
    n_slots, prompt, new_tokens, max_len = 4, 128, 4, 256
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, serve_cfg.vocab, (n_slots, prompt), dtype=np.int32)).to(dev)

    def decode_run(p, cache):
        ops.reset_launch_counts()
        logits, cache = smodel.prefill(p, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        prefill_launches = ops.launch_counts()
        out, toks = [logits], []
        ops.reset_launch_counts()
        for i in range(new_tokens):
            toks.append(out[-1].argmax(-1).to(torch.int32))
            pos = torch.full((n_slots,), prompt + i, dtype=torch.int32,
                             device=dev)
            logits, cache = smodel.decode_step(p, toks[-1], cache, pos)
            out.append(logits)
        torch.cuda.synchronize()
        return out, toks, cache, prefill_launches, ops.launch_counts()

    want_logits, want_toks, want_cache, _, _ = decode_run(
        params, smodel.init_cache(n_slots, max_len))
    want_cache = {p: t.clone() for p, t in tree_items(want_cache)}
    spec, axes = smodel.cache_spec(n_slots, max_len)
    cache_sh = shardings_for_tree(axes, spec, mesh, DECODE_RULES)
    plain_cache = smodel.init_cache(n_slots, max_len)
    cache = distribute_tree(plain_cache, cache_sh)
    placed_params = distribute_tree(params, shardings_for_tree(
        smodel.param_axes(), smodel.abstract_params(), mesh, DECODE_RULES))
    decode_no_copy = (
        same_storage(dict(tree_items(cache)), dict(tree_items(plain_cache)))
        and same_storage(dict(tree_items(placed_params)),
                         dict(tree_items(params))))
    with activate(mesh, DECODE_RULES):
        logits, toks, got_cache, pre_l, dec_l = decode_run(placed_params,
                                                           cache)
    logits_equal = all(torch.equal(g, w) for g, w in zip(logits,
                                                         want_logits))
    tokens_equal = all(torch.equal(g, w) for g, w in zip(toks, want_toks))
    cache_equal = all(torch.equal(t.to_local(), want_cache[p])
                      for p, t in tree_items(got_cache))
    decode = {
        "model": serve_cfg.name, "compute_dtype": serve_cfg.compute_dtype,
        "slots": n_slots, "prompt": prompt, "decode_steps": new_tokens,
        "max_len": max_len,
        "cache_placements_sample": {
            ".".join(p): [str(s.spec), str(s.placements)]
            for p, s in list(tree_items(cache_sh))[:3]},
        "placed_without_copy": decode_no_copy,
        "logits_bit_equal": logits_equal, "tokens_bit_equal": tokens_equal,
        "cache_bit_equal": cache_equal, "cache_returned_placed":
            got_cache is cache,
        "tokens": [t.tolist() for t in toks],
        "launches_prefill_placed": {k: pre_l[k] for k in want_step},
        "launches_decode_placed": {k: dec_l[k] for k in want_step},
        "seconds": time.perf_counter() - t_decode}
    decode["ok"] = bool(
        decode_no_copy and logits_equal and tokens_equal and cache_equal
        and got_cache is cache
        and decode["launches_prefill_placed"] == {
            k: v // per_call for k, v in want_step.items()}
        and not any(dec_l[k] for k in want_step))
    del smodel, params, placed_params, cache, plain_cache, got_cache
    del want_cache, want_logits, logits
    gc.collect()
    torch.cuda.empty_cache()

    # --- (c) a slot-sharded detector batch ----------------------------------
    t_det = time.perf_counter()
    H, W = 720, 1280
    frames, _ = scenario_batch(MAIN_FAMILIES, H, W, seed=0)
    plain = torch.from_numpy(frames).to(dev)
    slotted = shard_slots(frames, replica_mesh)
    auto = HoughConfig(compact=True, max_edges="auto")
    staged = DetectionPlan.build(PipelineConfig(hough=auto), H, W,
                                 batch=DEPLOY_BATCH)
    # core/__init__ exports a function named ``plan``: take the module
    plan_mod = importlib.import_module("repro_torch.core.plan")
    votes: list = []
    own_get_lines = plan_mod.get_lines

    def recording_get_lines(v, **kw):
        votes.append(v)
        return own_get_lines(v, **kw)

    detector = {"batch": [DEPLOY_BATCH, H, W],
                "families": list(MAIN_FAMILIES),
                "slot_placements": str(slotted.placements),
                "on_card": slotted.device.type == "cuda"}
    det_launches = {}
    with swapped(plan_mod, "get_lines", recording_get_lines):
        for name, plan in (("staged", staged), ("fused", staged.with_fused())):
            votes.clear()
            want_res = plan.run(plain)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            got_res = plan.run(slotted)
            torch.cuda.synchronize()
            det_launches[name] = ops.launch_counts()
            fields = {f: bool(torch.equal(g, w))
                      for f, g, w in zip(want_res._fields, got_res, want_res)
                      if w is not None}
            fields["votes"] = bool(len(votes) == 2
                                   and torch.equal(votes[0], votes[1]))
            detector[name] = {"bit_equal": fields,
                              "launches_placed": det_launches[name],
                              "valid_lines": int(want_res.valid.sum())}
    detector["seconds"] = time.perf_counter() - t_det
    detector["ok"] = bool(
        detector["on_card"] and str(slotted.placements) == "(Shard(dim=0),)"
        and all(all(detector[n]["bit_equal"].values())
                for n in ("staged", "fused"))
        and det_launches["staged"]["conv2d_gemm"] == 2
        and det_launches["staged"]["hough_vote"] == 1
        and det_launches["fused"]["fused_detect"] == 1
        and det_launches["fused"]["hough_vote"] == 1)
    del plain, slotted, votes
    if created_group:
        dist.destroy_process_group()

    seconds = time.perf_counter() - t_phase
    ok = train["ok"] and decode["ok"] and detector["ok"]
    emit({"phase": "sharding", "card": card_line(), "train": train,
          "decode": decode, "detector": detector, "seconds": seconds,
          "seconds_limit": 60, "ok": ok})
    if not ok:
        raise SystemExit(
            f"sharding: a placed path left its unplaced run (train "
            f"{train['ok']}, decode {decode['ok']}, detector "
            f"{detector['ok']})")
    launches = {k: {"train_step": train["launches_placed"][k],
                    "prefill": decode["launches_prefill_placed"][k]}
                for k in want_step}
    for name, counts in det_launches.items():
        for k, n in counts.items():
            if n:
                launches.setdefault(k, {})[f"detector_{name}"] = n
    return launches



# The elastic phase: zamba2-1.2b at full width, cut in depth to one
# super-block (6 Mamba-2 layers and the shared attention block, no tail)
# so that a checkpoint of parameters and both moments is ~4.2 GB, not the
# whole model's 14.7 GB; the train phase's batch (8 x 512 tokens, bf16
# over the f32 master, remat); 8 steps, failures at steps 3 and 6,
# checkpoints every 2 steps
ELASTIC_DEPTH = {"n_layers": 6, "share_every": 6}
ELASTIC_STEPS, ELASTIC_EVERY, ELASTIC_FAILS = 8, 2, (3, 6)


def elastic_phase() -> dict:
    """Elastic restarts on the card (phase ``elastic``):
    ``run_with_restarts`` drives the cut zamba2-1.2b's train step from a
    state placed on ``make_host_mesh()`` by ``train_state_shardings``,
    with ``state_template`` the ``meta`` state of ``train_state_specs`` and
    an ``on_restart`` hook that returns shardings on
    ``make_replica_mesh(1)`` at the first restart and ``None`` at the
    second.  Checked: the stats; every leaf, after each restart, on the
    mesh in force with its placements; the final state against an
    uninterrupted placed run of the same steps on the host mesh, bit for
    bit; both kernels' launches = steps run x launches a step.  Timed
    (host clock, synchronized): each restore (files written in this run,
    so the read is warm), each ``save_async``'s host copy, and the wait
    for the write before it.  Returns each kernel's launches."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get
    from repro_torch.data import TokenPipelineConfig, TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh, make_replica_mesh
    from repro_torch.models import build
    from repro_torch.runtime import FaultInjector, run_with_restarts
    from repro_torch.sharding.partition import local_tree
    from repro_torch.train import (
        AdamWConfig, distribute_tree, init_train_state, make_train_step,
        train_state_shardings, train_state_specs,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    created_group = not dist.is_initialized()
    host, replica = make_host_mesh(), make_replica_mesh(1)
    args = train_cli.parse_args([*TRAIN_ARGV])
    full = get(args.arch)
    cfg = full.replace(**ELASTIC_DEPTH)
    model = build(cfg)
    dev = model.device
    _, host_sh = train_state_shardings(model, host)
    _, replica_sh = train_state_shardings(model, replica)
    template = train_state_specs(model)[0]
    state0 = distribute_tree(init_train_state(model.init_master(
        torch.Generator(dev).manual_seed(0))), host_sh)
    step_fn = make_train_step(model, AdamWConfig(
        peak_lr=args.lr, warmup_steps=0, decay_steps=ELASTIC_STEPS))
    stream = TokenStream(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.global_batch))
    n_super = cfg.n_layers // cfg.share_every
    n_mamba = n_super * cfg.share_every + (cfg.n_layers % cfg.share_every) ** 2
    per_call = 2 if cfg.remat else 1
    want_step = {"flash_attention": per_call * n_super,
                 "ssd_scan": per_call * n_mamba}
    n_bytes = sum(t.numel() * t.element_size()
                  for t in _state_leaves(local_tree(state0)).values())

    def drive(state, step):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(step).items()}
        return step_fn(state, batch)[0]

    # the uninterrupted placed run on the host mesh
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    want = state0
    for s in range(ELASTIC_STEPS):
        want = drive(want, s)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_launches = {k: ops.launch_counts()[k] for k in want_step}

    class TimedManager(CheckpointManager):
        """The store, with each restore and each save's host copy timed
        apart from the wait for the write before it."""

        def __init__(self, directory):
            super().__init__(directory, keep=2)
            self.saves, self.restores = [], []

        def save_async(self, state, step):
            t0 = time.perf_counter()
            self.wait()
            t1 = time.perf_counter()
            super().save_async(state, step)
            self.saves.append({"step": step,
                               "wait_ms": (t1 - t0) * 1e3,
                               "host_copy_ms":
                                   (time.perf_counter() - t1) * 1e3})

        def restore_latest(self, target, shardings=None):
            self.wait()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().restore_latest(target, shardings=shardings)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            self.restores.append({"ms": sec * 1e3, "gb_per_s":
                                  n_bytes / sec / 1e9})
            return out

    inj = FaultInjector(fail_at_steps=ELASTIC_FAILS)
    hook_calls, steps_run, in_force = [], [], [host_sh]
    misplaced = {}

    def on_restart(restarts):
        hook_calls.append(restarts)
        if restarts == 1:
            in_force.append(replica_sh)
            return replica_sh
        return None

    def faulty(state, step):
        inj.check(step)
        bad = misplaced_leaves(state, in_force[-1])
        if bad:
            misplaced[len(steps_run)] = bad[:4]
        steps_run.append(step)
        return drive(state, step)

    ckpt_root = ROOT / "build"
    ckpt_root.mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="elastic_ckpt_", dir=ckpt_root))
    try:
        mgr = TimedManager(str(ckpt))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        final, stats = run_with_restarts(
            init_state=state0, step_fn=faulty, n_steps=ELASTIC_STEPS,
            ckpt=mgr, ckpt_every=ELASTIC_EVERY, state_template=template,
            on_restart=on_restart)
        torch.cuda.synchronize()
        faulty_s = time.perf_counter() - t0
        launches = {k: ops.launch_counts()[k] for k in want_step}
        step_dir = ckpt / f"step_{ELASTIC_STEPS:08d}"
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    final_misplaced = misplaced_leaves(final, replica_sh)
    got, ref = _state_leaves(local_tree(final)), _state_leaves(
        local_tree(want))
    unequal = [".".join(p) for p, w in ref.items()
               if not torch.equal(got[p], w)]
    moved = sum(not torch.equal(ref[p], t) for p, t in
                _state_leaves(local_tree(state0)).items() if p[0] == "params")
    replicated = all(sh.placements == (Replicate(),)
                     for sh in _state_leaves(replica_sh).values())
    want_stats = {"restarts": 2, "completed_steps": ELASTIC_STEPS,
                  "resumed_from": [2, 6]}
    ok = bool(stats == want_stats and hook_calls == [1, 2]
              and not misplaced and not final_misplaced and replicated
              and not unequal and moved > 0
              and plain_launches == {k: ELASTIC_STEPS * v
                                     for k, v in want_step.items()}
              and launches == {k: len(steps_run) * v
                               for k, v in want_step.items()})
    del final, want, state0, got, ref
    if created_group:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "elastic", "card": card_line(), "model": cfg.name,
          "cut": f"n_layers {full.n_layers} -> {cfg.n_layers}, share_every "
                 f"{cfg.share_every}: one super-block ({n_mamba} Mamba-2 "
                 "layers and the shared attention block), no tail; full "
                 "width",
          "params": model.param_count(),
          "compute_dtype": cfg.compute_dtype, "param_dtype": cfg.param_dtype,
          "remat": cfg.remat, "tokens_per_step": args.global_batch * args.seq,
          "state_bytes": n_bytes, "checkpoint_bytes": ckpt_bytes,
          "steps": ELASTIC_STEPS, "ckpt_every": ELASTIC_EVERY,
          "fail_at": list(ELASTIC_FAILS), "stats": stats,
          "expected_stats": want_stats, "on_restart_calls": hook_calls,
          "steps_run": steps_run,
          "meshes": {"host": list(host.shape), "replica": list(replica.shape)},
          "misplaced_before_a_step": misplaced,
          "final_misplaced": final_misplaced,
          "replica_placements_all_replicate": replicated,
          "leaves": len(_state_leaves(template)),
          "leaves_unequal_to_the_uninterrupted_run": unequal,
          "parameter_leaves_moved": moved,
          "launches_per_step_expected": want_step,
          "launches_uninterrupted": plain_launches,
          "launches_faulty_run": launches,
          "restores": mgr.restores, "saves": mgr.saves,
          "uninterrupted_seconds": plain_s, "faulty_run_seconds": faulty_s,
          "seconds": seconds, "seconds_limit": 60, "ok": ok})
    if not ok:
        raise SystemExit(f"elastic: stats {stats}, hook {hook_calls}, "
                         f"misplaced {misplaced} / {final_misplaced}, "
                         f"{len(unequal)} leaves unequal, launches "
                         f"{launches} for {len(steps_run)} steps")
    return {k: {"launches": launches[k], "steps_run": len(steps_run),
                "launches_per_step": want_step[k]} for k in want_step}


# The int8 error-feedback compression (``compression_phase``): the leaves
# held to the CPU bit for bit, each named by its tree path
COMPRESSION_LEAVES = (("blocks", "0_mamba2", "ssm", "in_proj"),   # largest
                      ("final_norm", "w"),                        # a norm
                      ("blocks", "0_mamba2", "ssm", "dt_b"),      # biases
                      ("blocks", "0_mamba2", "ssm", "conv_b"))
COMPRESSION_RUNS = 5
# element-wise operations a gradient element takes: y = g + err, |y|, the
# max, y / scale, round, clip (2), deq = q * scale, y - deq, the sum's
# product, the mean's division
COMPRESSION_OPS = 11


def _ulp_gap(got, want) -> int:
    """The largest gap in ulps (int8: in steps) between two tensors of one
    dtype, on the host."""
    import torch

    got, want = got.cpu(), want.cpu()
    if not got.dtype.is_floating_point:
        return int((got.int() - want.int()).abs().max()) if got.numel() else 0

    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(got) - ordered(want)).abs().max())


def compression_phase() -> dict:
    """Int8 error-feedback gradient compression on the card (phase
    ``compression``): the gradient tree of one zamba2-1.2b step at full
    width and depth, the ``train`` phase's config and shape (8 x 512
    tokens, bf16 over the f32 master, remat), through
    ``trainer._mean_grads``, reduced by ``compressed_allreduce_tree`` over
    a one-card ``("pod",)`` ``DeviceMesh`` (a world-size-1 nccl group on an
    in-memory store) from an ``init_compression`` state, then again from
    the residuals it left.  Checked: on the leaves of
    ``COMPRESSION_LEAVES``, the second round's q, scale, mean and residual
    equal the CPU's on the same gradient and residual, bit for bit; over
    every leaf, the first round's mean within max|g| / 127 of the
    gradient; ``init_train_state(compression=True)`` on the card gives f32
    zeros like every parameter, and a state carrying the first round's
    residuals takes 2 ``make_train_step``s with ``err`` bit-unchanged.
    Timed: ms of the tree's reduction (CUDA events around a synchronized
    call, median of ``COMPRESSION_RUNS``; the host's launches included),
    its device time queued behind a spin that hides them (least of 3),
    both beside its bound (the bytes it must move at the HBM rate), one
    call traced (GPU activities, busy ms); the wire bytes
    against an f32 ring all-reduce as the reference's docstring counts
    them.  Returns the kernels' launches in the gradient step."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import TokenPipelineConfig, TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build
    from repro_torch.models.layers import tree_items
    from repro_torch.sharding import activate
    from repro_torch.train import (
        AdamWConfig, compress_decompress, compressed_allreduce_tree,
        init_compression, init_train_state, make_train_step,
    )
    from repro_torch.train import compression as comp
    from repro_torch.train.trainer import _mean_grads

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda", 0)
    created_group = not dist.is_initialized()
    if created_group:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
    P = mesh.size()
    args = train_cli.parse_args([*TRAIN_ARGV])
    cfg = train_cli.preset_config(args.arch, args.preset)
    model = build(cfg)
    params = model.init_master(torch.Generator(dev).manual_seed(0))
    stream = TokenStream(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.global_batch))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch_at(s).items()} for s in range(2)]
    n_super = cfg.n_layers // cfg.share_every
    n_mamba = n_super * cfg.share_every + (cfg.n_layers % cfg.share_every) ** 2
    per_call = 2 if cfg.remat else 1
    want_step = {"flash_attention": per_call * n_super,
                 "ssd_scan": per_call * n_mamba}

    # --- the gradients of one step -----------------------------------------
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss, _, grads = _mean_grads(model.loss, params, batches[0], 1)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    launches = {k: ops.launch_counts()[k] for k in want_step}
    flat = dict(tree_items(grads))
    n_elems = sum(g.numel() for g in flat.values())

    # --- two rounds of the reduction -----------------------------------------
    st0 = init_compression(grads)
    zeros_ok = all(e.dtype == torch.float32 and e.device == dev
                   and e.shape == flat[p].shape and not e.any()
                   for p, e in tree_items(st0.err))
    with activate(mesh):
        mean1, st1 = compressed_allreduce_tree(grads, st0, "pod")
        mean2, st2 = compressed_allreduce_tree(grads, st1, "pod")
    torch.cuda.synchronize()
    del st0
    m1, e1 = dict(tree_items(mean1)), dict(tree_items(st1.err))
    m2, e2 = dict(tree_items(mean2)), dict(tree_items(st2.err))
    # over every leaf: the first round's mean within max|g| / 127
    worst = max(((float((m1[p] - g).abs().max())
                  / max(float(g.abs().max()) / 127.0, 1e-30)), p)
                for p, g in flat.items())
    residual_nonzero = sum(bool(e.any()) for e in e1.values())
    del mean1, m1
    # the named leaves against the CPU (second round: a nonzero residual)
    leaves = {}
    for p in COMPRESSION_LEAVES:
        g, e = flat[p], e1[p]
        q, s = comp._quantize(g + e)
        g_cpu, e_cpu = g.cpu(), e.cpu()
        q_cpu, s_cpu = comp._quantize(g_cpu + e_cpu)
        deq_cpu, err_cpu = compress_decompress(g_cpu, e_cpu)
        gaps = {"q": _ulp_gap(q, q_cpu), "scale": _ulp_gap(s, s_cpu),
                "mean": _ulp_gap(m2[p], deq_cpu),
                "residual": _ulp_gap(e2[p], err_cpu)}
        leaves[".".join(p)] = {
            "shape": list(g.shape), "max_abs_grad": float(g.abs().max()),
            "scale": float(s), "ulp_gaps": gaps,
            "bit_equal": not any(gaps.values())}
    del mean2, st2, m2, e2

    # --- time: the tree's reduction from the residuals of round 1 ----------
    def reduce_tree():
        with activate(mesh):
            return compressed_allreduce_tree(grads, st1, "pod")

    ms = []
    for _ in range(COMPRESSION_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = reduce_tree()
        end.record()
        end.synchronize()
        ms.append({"events_ms": start.elapsed_time(end),
                   "host_ms": (time.perf_counter() - t0) * 1e3})
        del out
    # the device's own time: the call queued behind a ~0.2 s spin that
    # hides the host's ~2000 launches
    spun_ms = device_ms(lambda: reduce_tree(), n=3, spin=400_000_000)
    traced_call = gpu_trace(lambda: reduce_tree(), "compression", 1,
                            focus=("nccl", "elementwise", "reduce"))
    # the bytes it must move: grad + err read (f32), mean + err written
    # (f32), the int8 payload written, and the P = 1 gather (the payload
    # read and written once more); each leaf's f32 scale in and out
    n_leaves = len(flat)
    moved = {"f32_in": 8 * n_elems, "f32_out": 8 * n_elems,
             "int8_payload": n_elems, "gather": 2 * P * n_elems,
             "scales": 3 * 4 * P * n_leaves}
    n_bytes = sum(moved.values())
    bound, bound_by = bound_ms(n_bytes, COMPRESSION_OPS * n_elems)
    events = [r["events_ms"] for r in ms]
    median_ms = float(np.median(events))
    # wire bytes as the reference's docstring counts them: P x (n/4 + 4)
    # for the int8 gather, ~2n for an f32 ring all-reduce (n f32 bytes)
    wire = {f"P={p}": {"int8_all_gather": p * (n_elems + 4 * n_leaves),
                       "f32_ring_all_reduce": 2 * 4 * n_elems}
            for p in (P, 2)}
    for v in wire.values():
        v["ratio"] = v["f32_ring_all_reduce"] / v["int8_all_gather"]

    # --- the err leaf through two train steps on the card -------------------
    del grads, flat
    gc.collect()
    state = init_train_state(params, compression=True)
    init_ok = all(
        e.dtype == torch.float32 and e.device == dev and e.shape == p.shape
        and not e.any()
        for (_, e), (_, p) in zip(tree_items(state.err), tree_items(params)))
    state = state._replace(err=st1.err)
    step_fn = make_train_step(model, AdamWConfig(
        peak_lr=args.lr, warmup_steps=0, decay_steps=args.steps))
    new = state
    losses = []
    for b in batches:
        new, met = step_fn(new, b)
        losses.append(float(met["loss"]))
    torch.cuda.synchronize()
    err_unequal = [".".join(p) for p, e in tree_items(new.err)
                   if not torch.equal(e, e1[p])]
    new_params = dict(tree_items(new.params))
    moved_params = sum(not torch.equal(new_params[p], t)
                       for p, t in tree_items(params))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state, new, st1, e1, params
    gc.collect()
    torch.cuda.empty_cache()
    if created_group:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t_phase
    ok = bool(launches == want_step and zeros_ok and init_ok
              and worst[0] <= 1.0 and residual_nonzero > 0
              and all(v["bit_equal"] for v in leaves.values())
              and not err_unequal and moved_params > 0
              and all(np.isfinite(losses)) and np.isfinite(float(loss)))
    emit({"phase": "compression", "card": card_line(), "model": cfg.name,
          "params": model.param_count(), "tokens": args.global_batch
          * args.seq, "compute_dtype": cfg.compute_dtype,
          "remat": cfg.remat, "mesh": {"shape": list(mesh.shape),
                                       "names": list(mesh.mesh_dim_names),
                                       "backend": "nccl"},
          "leaves": n_leaves, "elements": n_elems,
          "grad_step_s": grad_s, "loss": float(loss),
          "launches_in_the_gradient_step": launches,
          "expected_launches": want_step,
          "init_compression_zero_f32": zeros_ok,
          "worst_mean_error_over_max_g_by_127": worst[0],
          "worst_leaf": ".".join(worst[1]),
          "leaves_with_a_nonzero_residual": residual_nonzero,
          "against_the_cpu": leaves,
          "runs": ms, "ms": median_ms, "ms_runs": events,
          "device_ms_behind_a_spin": spun_ms,
          "device_ms_behind_a_spin_over_bound": spun_ms / bound,
          "traced_call": {k: traced_call[k] for k in (
              "gpu_activities", "device_busy_ms", "device_span_ms",
              "device_busy_share_of_span", "focus", "top", "whole",
              "trace")},
          "bytes_moved": moved, "bytes": n_bytes, "bound_ms": bound,
          "bound_by": bound_by, "ms_over_bound": median_ms / bound,
          "busy_ms_over_bound": traced_call["device_busy_ms"] / bound,
          "wire_bytes": wire,
          "init_train_state_err_zero_f32": init_ok,
          "train_steps_losses": losses,
          "err_leaves_changed_by_the_steps": err_unequal,
          "parameter_leaves_moved": moved_params,
          "peak_memory_gb": peak_gb, "seconds": seconds, "ok": ok})
    if not ok:
        bad = {k: v["ulp_gaps"] for k, v in leaves.items()
               if not v["bit_equal"]}
        raise SystemExit(f"compression: launches {launches}, card vs CPU "
                         f"gaps {bad}, worst mean error {worst}, err "
                         f"changed by a step {err_unequal[:4]}")
    return {k: {"launches": launches[k], "launches_per_step": want_step[k]}
            for k in want_step}


# The pod-compressed train step (``pod_compressed_phase``): (a) the CLI's
# run of ``train`` with ``--compress-pod`` at P = 1, one checkpoint at its
# last step; (b) two gloo ranks on the one card at the elastic phase's cut
POD_STEPS = 3                  # steps held to the plain run's losses
POD_RANK_TIMEOUT_S = 300
POD_RANK = r'''
import json
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get
from repro_torch.data import TokenPipelineConfig, TokenStream
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.models.layers import tree_items
from repro_torch.train import AdamWConfig, init_train_state
from repro_torch.train import trainer

torch.backends.cuda.matmul.allow_tf32 = False
rank, out, spec = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
dist.init_process_group("gloo", store=dist.FileStore(out + "/store", 2),
                        rank=rank, world_size=2)
try:
    mesh = train_cli._pod_mesh("cuda")
    model = build(get(spec["arch"]).replace(**spec["cut"]))
    dev = model.device
    state = init_train_state(model.init_master(
        torch.Generator(dev).manual_seed(0)), compression=True)
    step_fn = trainer.make_train_step_pod_compressed(
        model, AdamWConfig(**spec["opt"]), mesh)
    stream = TokenStream(TokenPipelineConfig(
        vocab=model.cfg.vocab, seq_len=spec["seq"],
        global_batch=spec["global_batch"]))
    reduce_ms = []
    reduce_tree = trainer.comp.compressed_allreduce_tree

    def timed_reduce(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = reduce_tree(*a, **k)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return r

    trainer.comp.compressed_allreduce_tree = timed_reduce
    group = mesh.get_group("pod")

    def leaves():
        return [(name + "/" + "/".join(path), t)
                for name, tree in (("params", state.params),
                                   ("m", state.opt["m"]),
                                   ("v", state.opt["v"]))
                for path, t in tree_items(tree)]

    def fingerprints():
        """Two 64-bit random linear sketches of each leaf's bits, the same
        weights on both ranks: a difference escapes both with probability
        below 2^-64."""
        out = []
        for i, (_, t) in enumerate(leaves()):
            bits = t.reshape(-1).view(torch.int32).to(torch.int64)
            for j in range(2):
                gen = torch.Generator(dev).manual_seed(2 * i + j)
                w = torch.randint(-2 ** 62, 2 ** 62, bits.shape,
                                  generator=gen, device=dev,
                                  dtype=torch.int64)
                out.append((bits * w).sum())
        return torch.stack(out)

    rows, unequal, step_ms, check_ms = [], [], [], []
    ops.reset_launch_counts()
    for s in range(spec["steps"]):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(s).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        rows.append({k: float(v) for k, v in met.items()})
        # params and moments against the other rank's: the fingerprints
        # after every step, every bit after the last
        t0 = time.perf_counter()
        mine = fingerprints()
        both = [torch.empty_like(mine) for _ in range(2)]
        dist.all_gather(both, mine, group=group)
        names = [n for n, _ in leaves()]
        bad = [names[i // 2] for i in
               torch.nonzero(both[0] != both[1]).flatten().tolist()]
        if s == spec["steps"] - 1:
            for name, t in leaves():
                both = [torch.empty_like(t) for _ in range(2)]
                dist.all_gather(both, t, group=group)
                if not torch.equal(both[0], both[1]):
                    bad.append(name)
        unequal.append(sorted(set(bad)))
        check_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: ops.launch_counts()[k]
                for k in ("flash_attention", "ssd_scan")}
    elements = sum(t.numel() for _, t in tree_items(state.params))
    leaves = len(list(tree_items(state.params)))
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump({"metrics": rows, "unequal": unequal, "step_ms": step_ms,
                   "reduce_ms": reduce_ms, "equality_check_ms": check_ms,
                   "launches": launches, "elements": elements,
                   "leaves": leaves, "device": str(dev),
                   "on_the_card": all(t.is_cuda for _, t in
                                      tree_items(state.err)),
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "backend": dist.get_backend(group),
                   "mesh": list(mesh.shape),
                   "jax_or_repro_imported": any(
                       m == "jax" or m == "repro" or m.startswith("repro.")
                       for m in sys.modules)}, f)
finally:
    dist.destroy_process_group()
'''


def pod_compressed_phase(train: dict) -> dict:
    """The pod-compressed train step on the card (phase
    ``pod_compressed``).  (a) ``launch.train.main`` with the ``train``
    phase's argv and ``--compress-pod`` (zamba2-1.2b at full width and
    depth, bf16 over the f32 master, remat, 8 steps of 8 x 512 tokens) on
    a world-size-1 nccl ``(1, 1, 1)`` pod mesh, one checkpoint at its last
    step (``--ckpt-every`` 8, which leaves the schedule as it is): 12
    attention and 80 SSD launches a step, losses and grad norms finite,
    the first ``POD_STEPS`` losses within rtol 2e-2 of ``train``'s logged
    losses at the same steps, the checkpoint holding ``err``; ms a warm
    step beside ``train``'s, peak memory.  (b) Two spawned gloo ranks on
    ``cuda:0``, each a pod of 4 of the 8 rows, take ``POD_STEPS`` steps
    of the elastic phase's one-super-block cut: their params and moments
    the same bits after every step (two 64-bit random linear sketches of
    each leaf's bits gathered over gloo after every step, every leaf
    gathered and compared on the card after the last), losses within rtol 2e-2 of a plain ``make_train_step`` on
    the whole batch in this process; the reduction's ms a step
    (synchronized) and the wire bytes.  Returns each kernel's launches on
    both paths."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get
    from repro_torch.data import TokenPipelineConfig, TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build
    from repro_torch.models.layers import tree_items
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    kinds = ("flash_attention", "ssd_scan")

    # --- (a) P = 1: the CLI at full width and depth --------------------------
    args = train_cli.parse_args([*TRAIN_ARGV])
    cfg = train_cli.preset_config(args.arch, args.preset)
    n_super = cfg.n_layers // cfg.share_every
    n_mamba = n_super * cfg.share_every + (cfg.n_layers % cfg.share_every) ** 2
    per_call = 2 if cfg.remat else 1
    want_step = {"flash_attention": per_call * n_super,
                 "ssd_scan": per_call * n_mamba}
    ckpt_root = ROOT / "build"
    ckpt_root.mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="pod_ckpt_", dir=ckpt_root))
    argv = [*TRAIN_ARGV, "--compress-pod", "--ckpt", str(ckpt),
            "--ckpt-every", str(args.steps)]
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = train_cli.main(argv)
        run_s = time.perf_counter() - t0
        launches = {k: ops.launch_counts()[k] for k in kinds}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        err_leaves = [p for p, _ in tree_items(state.err)]
        err_on_card = all(t.is_cuda and t.dtype == torch.float32
                          for _, t in tree_items(state.err))
        steps = int(state.step)
        manifest = json.loads((ckpt / f"step_{steps:08d}"
                               / "manifest.json").read_text())
        saved = [leaf["key"] for leaf in manifest["leaves"]]
        ckpt_gb = sum(f.stat().st_size for f in ckpt.rglob("*")) / 1e9
        del state
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    losses = {h["step"]: h["loss"] for h in hist}
    rel = {s: abs(losses[s] / train["losses"][s] - 1)
           for s in range(1, POD_STEPS + 1)}
    warm = [h["ms_per_step"] for h in hist[1:]]
    ms_warm = float(np.median(warm))
    err_saved = sum(k.startswith(".err/") for k in saved)
    p1_ok = bool(launches == {k: steps * v for k, v in want_step.items()}
                 and all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                         for h in hist)
                 and max(rel.values()) <= 2e-2
                 and err_on_card and err_saved == len(err_leaves) > 0)

    # --- (b) P = 2: two gloo ranks on the one card ---------------------------
    t_p2 = time.perf_counter()
    cut = get(args.arch).replace(**ELASTIC_DEPTH)
    opt = {"peak_lr": args.lr, "warmup_steps": 0, "decay_steps": POD_STEPS}
    dev = torch.device("cuda", 0)
    model = build(cut)
    plain = make_train_step(model, AdamWConfig(**opt))
    stream = TokenStream(TokenPipelineConfig(
        vocab=cut.vocab, seq_len=args.seq, global_batch=args.global_batch))
    st = init_train_state(model.init_master(
        torch.Generator(dev).manual_seed(0)))
    plain_losses = []
    for s in range(POD_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(s).items()}
        st, met = plain(st, batch)
        plain_losses.append(float(met["loss"]))
    del st, met, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    spec = {"arch": args.arch, "cut": ELASTIC_DEPTH, "opt": opt,
            "steps": POD_STEPS, "seq": args.seq,
            "global_batch": args.global_batch}
    out = Path(tempfile.mkdtemp(prefix="pod_ranks_", dir=ckpt_root))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", POD_RANK, str(r), str(out), json.dumps(spec)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=POD_RANK_TIMEOUT_S) for p in procs]
        codes = [p.returncode for p in procs]
        ranks = ([json.loads((out / f"rank{r}.json").read_text())
                  for r in range(2)] if codes == [0, 0] else [])
    finally:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(out, ignore_errors=True)
    if codes != [0, 0]:
        raise SystemExit(f"pod_compressed (b): ranks exited {codes}: "
                         + " | ".join(e[-2000:] for _, e in outs))
    cut_super = cut.n_layers // cut.share_every
    cut_mamba = (cut_super * cut.share_every
                 + (cut.n_layers % cut.share_every) ** 2)
    want_cut = {"flash_attention": per_call * cut_super,
                "ssd_scan": per_call * cut_mamba}
    pod_losses = [m["loss"] for m in ranks[0]["metrics"]]
    p2_rel = [abs(a / b - 1) for a, b in zip(pod_losses, plain_losses)]
    n_elems, n_leaves = ranks[0]["elements"], ranks[0]["leaves"]
    wire = {"int8_all_gather": 2 * (n_elems + 4 * n_leaves),
            "f32_ring_all_reduce": 2 * 4 * n_elems}
    wire["ratio"] = wire["f32_ring_all_reduce"] / wire["int8_all_gather"]
    p2_ok = bool(all(not any(r["unequal"]) for r in ranks)
                 and ranks[0]["metrics"] == ranks[1]["metrics"]
                 and max(p2_rel) <= 2e-2
                 and all(r["launches"] == {k: POD_STEPS * v
                                           for k, v in want_cut.items()}
                         for r in ranks)
                 and all(r["on_the_card"] and not r["jax_or_repro_imported"]
                         and r["backend"] == "gloo" for r in ranks)
                 and all(np.isfinite(pod_losses)))
    p2_s = time.perf_counter() - t_p2
    seconds = time.perf_counter() - t_phase
    ok = p1_ok and p2_ok
    emit({"phase": "pod_compressed", "card": card_line(),
          "p1": {"argv": argv[:-4] + ["--ckpt", "<tmp>", "--ckpt-every",
                                      str(args.steps)],
                 "model": cfg.name, "mesh": [1, 1, 1], "backend": "nccl",
                 "losses": losses,
                 "train_losses": {s: train["losses"][s]
                                  for s in range(1, POD_STEPS + 1)},
                 "loss_rel_diff_to_train": rel, "rtol": 2e-2,
                 "grad_norms": {h["step"]: h["grad_norm"] for h in hist},
                 "lrs": {h["step"]: h["lr"] for h in hist},
                 "ms_per_step": {h["step"]: h["ms_per_step"] for h in hist},
                 "ms_per_warm_step_median": ms_warm,
                 "train_ms_per_warm_step_median": train["ms_warm"],
                 "tokens_per_s": args.global_batch * args.seq / ms_warm * 1e3,
                 "peak_memory_gb": peak_gb,
                 "train_peak_memory_gb": train["peak_memory_gb"],
                 "launches_in_run": launches,
                 "launches_per_step_expected": want_step,
                 "err_leaves": len(err_leaves),
                 "err_leaves_in_checkpoint": err_saved,
                 "checkpoint_gb": ckpt_gb, "run_seconds": run_s,
                 "ok": p1_ok},
          "p2": {"model": cut.name, "cut": ELASTIC_DEPTH,
                 "ranks": 2, "backend": "gloo", "device": "cuda:0",
                 "rows_per_rank": args.global_batch // 2, "seq": args.seq,
                 "steps": POD_STEPS, "opt": opt,
                 "losses": pod_losses, "plain_losses": plain_losses,
                 "loss_rel_diff_to_plain": p2_rel, "rtol": 2e-2,
                 "unequal_leaves_by_step": [r["unequal"] for r in ranks],
                 "metrics_equal": ranks[0]["metrics"] == ranks[1]["metrics"],
                 "step_ms": [r["step_ms"] for r in ranks],
                 "reduce_ms": [r["reduce_ms"] for r in ranks],
                 "reduce_ms_median": float(np.median(
                     ranks[0]["reduce_ms"] + ranks[1]["reduce_ms"])),
                 "equality_check_ms": [r["equality_check_ms"]
                                       for r in ranks],
                 "launches": [r["launches"] for r in ranks],
                 "launches_per_step_expected": want_cut,
                 "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
                 "elements": n_elems, "leaves": n_leaves,
                 "wire_bytes": wire, "seconds": p2_s, "ok": p2_ok},
          "seconds": seconds, "ok": ok})
    if not ok:
        raise SystemExit(
            f"pod_compressed: P = 1 launches {launches}, loss gaps {rel}, "
            f"err saved {err_saved}/{len(err_leaves)}; P = 2 unequal "
            f"{[r['unequal'] for r in ranks]}, loss gaps {p2_rel}, launches "
            f"{[r['launches'] for r in ranks]}")
    return {k: {"p1": {"launches": launches[k],
                       "launches_per_step": want_step[k]},
                "p2": {"launches_per_rank": [r["launches"][k]
                                             for r in ranks],
                       "launches_per_step": want_cut[k]}}
            for k in kinds}


# The remaining dense families, Mamba-1 and MoE (``lm_family_phases``):
# each arch at full width, at full depth but qwen1.5-32b's and
# llama4-scout-17b-a16e's (``Model.init`` draws a
# stacked leaf a layer at a time, so drawing adds one layer's f32 values to
# the weights; granite-34b's 88 layers are ~68 GB of bf16).  qwen1.5-32b's
# 64 layers are 70.4 GB of bf16 beside 6.0 GB of cache for 4 x 1152
# positions and a 3.1 GB f32 head while computing logits: ~81 of the
# H100's 85.0 GB before what the script's earlier phases hold.  It serves
# 60 (1.15 GB of weights and cache a layer).  The MoE archs
# (reference ``param_count``): moonshot-v1-16b-a3b's 28.06 B parameters are
# 56.1 GB of bf16 beside 1.8 GB of cache and a 1.3 GB f32 head, and run
# whole; llama4-scout-17b-a16e's 101.73 B are 2.08 B a layer (4.15 GB of
# bf16) plus a 4.14 GB untied embedding and head: 16 of 48 layers are
# ~70.6 GB of weights, a 4.14 GB f32 head on top while computing logits,
# and the untied table's 4.14 GB f32 draw: a peak near 75-77 GB, qwen's
# margin.
LM_FAMILIES = (("yi-9b", None), ("granite-34b", None), ("qwen1.5-32b", 60),
               ("falcon-mamba-7b", None), ("moonshot-v1-16b-a3b", None),
               ("llama4-scout-17b-a16e", 16))
# the attention archs' prefill buckets: every serving prompt fits one
FAMILY_BUCKETS = (128, 256, 512, 1024)
# Decode logits against a fresh prefill of the same tokens
# (``teacher_forced``).  In bf16 the two paths round in other orders (GEMMs
# of 1 and of L rows, p rounded to bf16 in decode) and the gap grows with
# depth; an attention fault at a whole-tile bucket length corrupts the
# cache that decode reads, and logits unrelated to the prefill's are ~1.4
# apart in norm.  The dense archs read 0.020-0.024 of the prefill's norm
# on an H100: their limit is 0.1.  falcon-mamba-7b's bf16 gap (0.56 on the
# H100) is no test of its path: a bf16 Mamba-1 stack's gap grows with
# depth in the JAX package alike, while the f32 gap stays small.  So
# falcon is held in f32, at the f32 serving bound of the zamba2 phase
# (5e-2 of a logit, tests/test_models.py).
TF_BF16_REL_L2 = 0.1
TF_F32_ABS = 5e-2
# An MoE layer's capacity C = max(int(1.25 k T / E), k) counts every token
# of the call: a prefill's bucket pads, all 4 slots of a decode step, idle
# ones too.  A fresh prefill at exact length has another T, so the two
# paths drop other assignments, in the reference alike (llama4 decodes at
# C = 1 an expert, moonshot at 6): the bf16 gap at the published capacity
# is reported, not gated.  The decode path is held at lifted capacity
# (factor n_experts: C = k T, no assignment drops) in f32, at a depth that
# fits: bf16's other rounding in the two paths flips router choices, and a
# flip at top-1 changes a token's whole FFN output.
MOE_TF_NOTE = ("not gated: the capacity counts every token of a call "
               "(bucket pads, idle slots), so decode and a fresh prefill "
               "drop other assignments at the published capacity, in the "
               "reference too; the decode path is held at lifted capacity "
               "in f32 (f32_lifted_capacity_run)")
MOE_F32_DEPTH = {"moonshot-v1-16b-a3b": 16, "llama4-scout-17b-a16e": 4}
# one MoE layer at full width: tokens, and the f32 rule of the reference's
# own sort-vs-onehot test (tests/test_models.py), taken of max|y|
MOE_LAYER_TOKENS = 1024
MOE_SORT_VS_ONEHOT = 2e-3
# the CPU anchor: f32, 2 layers, prompts past falcon's chunk of 64 and not
# a multiple of it
ANCHOR_LAYERS, ANCHOR_PROMPTS, ANCHOR_NEW = 2, (100, 128), 8


def family_cpu_anchor(cfg, dev) -> dict:
    """``cfg`` served on ``dev`` and on the CPU from the same parameters,
    drawn on ``dev`` and copied: ``ANCHOR_PROMPTS`` greedy requests of
    ``ANCHOR_NEW`` tokens through ``Engine(n_slots=2)``.  The tokens must
    be equal, and every decode step's logits within 1e-4 of the CPU's
    largest |logit|."""
    import numpy as np
    import torch

    from repro_torch.models import build
    from repro_torch.models.layers import tree_map

    t0 = time.perf_counter()
    card = build(cfg, device=dev)
    params = card.init(torch.Generator(dev).manual_seed(0))
    cpu = build(cfg, device="cpu")
    params_cpu = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, n)]
               for n in ANCHOR_PROMPTS]
    kw = {} if cfg.family == "ssm" else {"prefill_buckets": (128,)}
    runs = [serve_traffic(m, p, prompts, ANCHOR_NEW, n_slots=2, max_len=160,
                          device=m.device, **kw)
            for m, p in ((card, params), (cpu, params_cpu))]
    (p_card, _, r_card, card_s), (p_cpu, _, r_cpu, cpu_s) = runs
    keys = sorted(p_card.logits.keys() & p_cpu.logits.keys())
    verdict = anchor_verdict(
        [r.output for r in r_card], [r.output for r in r_cpu],
        [(p_cpu.logits[k], p_card.logits[k]) for k in keys],
        len(prompts) * ANCHOR_NEW)
    return {"layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
            "tf32": False, "prompt_lengths": list(ANCHOR_PROMPTS),
            "new_tokens": ANCHOR_NEW, **verdict,
            "card_seconds": card_s, "cpu_seconds": cpu_s,
            "seconds": time.perf_counter() - t0}


# substrings of the device kernels' names that a traced prefill and
# decode step sum (``serve_family(trace=True)``, ``serve_context_family``):
# cuBLAS GEMMs ("gemm"; "nvjet" names its Hopper GEMM kernels), the
# attention kernel, element-wise, reductions, gathers / scatters, scans
TRACE_FOCUS = ("gemm", "nvjet", "flash_attention", "elementwise", "reduce",
               "index", "scatter", "scan", "sort")


def serve_family(cfg, dev, prompts, tf_gate=None, trace=False) -> dict:
    """``cfg`` in its compute dtype with seed-0 weights drawn on ``dev``,
    serving ``prompts`` (``SERVE_NEW`` new tokens each, greedy) through
    ``Engine(n_slots=4, max_len=1152)`` after a 2-request warm-up, each
    prefill's and decode step's launches counted: one attention launch a
    prefill per attention layer, none a decode step, no SSD launch.  Then
    each request's decode logits at three steps against fresh prefills of
    the same tokens (``teacher_forced``), held to ``tf_gate`` = (measure,
    limit) where one is given.  With ``trace``, one prefill of the largest
    bucket and one 4-slot decode step are traced (``gpu_trace``)."""
    import dataclasses
    import gc
    import math

    import numpy as np
    import torch

    from repro_torch.models import build
    from repro_torch.models.layers import tree_items
    from repro_torch.models.transformer import pattern_for

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    weights_gb = sum(t.numel() * t.element_size()
                     for _, t in tree_items(params)) / 1e9
    # Model.init draws each stacked leaf a layer slice at a time in f32
    largest_f32_gb = max(
        math.prod(p.shape[1:] if p.axes[:1] == ("layers",) else p.shape)
        for _, p in tree_items(model.param_specs)) * 4 / 1e9
    torch.cuda.empty_cache()
    pattern, n_super, _, _ = pattern_for(cfg)
    per_prefill = {"flash_attention": n_super * pattern.count("attn"),
                   "ssd_scan": 0}
    kw = {} if cfg.family == "ssm" else {"prefill_buckets": FAMILY_BUCKETS}
    serve_traffic(model, params, prompts[:2], 2, **kw)       # warm-up
    gc.collect()            # its engine and probe (a cycle) and their cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    probe, eng, reqs, run_s = serve_traffic(model, params, prompts,
                                            SERVE_NEW, **kw)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    probe.engine = eng = None        # the engine's cache, before the checks
    gc.collect()
    torch.cuda.empty_cache()
    profiled = None
    if trace:
        L = FAMILY_BUCKETS[-1]
        tg = torch.Generator(dev).manual_seed(1)
        toks = torch.randint(1, cfg.vocab, (1, L), generator=tg, device=dev)
        one = model.init_cache(1, SERVE_MAX_LEN)
        slots = model.init_cache(SERVE_SLOTS, SERVE_MAX_LEN)
        step = toks[0, :SERVE_SLOTS].contiguous()
        pos = torch.full((SERVE_SLOTS,), L, dtype=torch.int32, device=dev)
        profiled = {
            f"prefill_{L}": gpu_trace(lambda: model.prefill(
                params, {"tokens": toks}, one), f"{cfg.name}_prefill", 1,
                focus=TRACE_FOCUS),
            "decode_step_4_slots": gpu_trace(lambda: model.decode_step(
                params, step, slots, pos), f"{cfg.name}_decode", 1,
                focus=TRACE_FOCUS)}
        del one, slots
    t0 = time.perf_counter()
    tf = teacher_forced(model, params, probe, reqs)
    tf["seconds"] = time.perf_counter() - t0
    tf["gate"] = tf_gate and {"measure": tf_gate[0], "limit": tf_gate[1]}
    done = all(r.done and len(r.output) == SERVE_NEW for r in reqs)
    finite = all(c["finite"] for c in probe.prefills + probe.decodes)
    bad_prefill, bad_decode = launch_faults(probe, per_prefill)
    full = [c["ms"] for c in probe.decodes if c["active"] == SERVE_SLOTS]
    n_tok = sum(len(r.output) for r in reqs)
    launches = {k: sum(c["launches"][k] for c in probe.prefills
                       + probe.decodes) for k in per_prefill}
    ok = (done and finite and not bad_prefill and not bad_decode
          and tf["compared"] == 3 * len(reqs)
          and (tf_gate is None or tf[tf_gate[0]] <= tf_gate[1]))
    return {"model": cfg.name, "family": cfg.family,
            "layers_run": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.hd if cfg.n_heads else None,
            "d_ff": cfg.d_ff, "act": cfg.act, "qkv_bias": cfg.qkv_bias,
            "ssm": None if cfg.ssm is None else dataclasses.asdict(cfg.ssm),
            "moe": None if cfg.moe is None else dataclasses.asdict(cfg.moe),
            "vocab": cfg.vocab, "compute_dtype": cfg.compute_dtype,
            "params": model.param_count(), "weights_gb": weights_gb,
            "largest_f32_draw_gb": largest_f32_gb, "init_seconds": init_s,
            "init_peak_memory_gb": init_peak_gb, "n_slots": SERVE_SLOTS,
            "max_len": SERVE_MAX_LEN, "prefill_buckets": kw.get(
                "prefill_buckets", "exact length"),
            "prompt_lengths": [len(p) for p in prompts],
            "new_tokens": SERVE_NEW,
            "requests_done": sum(r.done for r in reqs),
            "all_logits_finite": finite,
            "prefill_ms_by_prompt_length": {
                str(len(p)): {"tokens": c["tokens"], "ms": c["ms"]}
                for p, c in zip(prompts, probe.prefills)},
            "expected_launches_per_prefill": per_prefill,
            "launches_per_prefill": [
                {k: c["launches"][k] for k in per_prefill}
                for c in probe.prefills],
            "prefills_with_wrong_launches": len(bad_prefill),
            "decode_steps": len(probe.decodes),
            "decode_steps_launching_a_kernel": len(bad_decode),
            "launches_in_run": launches,
            "decode_step_ms_4_slots_median": (float(np.median(full))
                                              if full else None),
            "decode_step_ms_4_slots_min": min(full) if full else None,
            "engine_run_seconds": run_s, "tokens_generated": n_tok,
            "tokens_per_s": n_tok / run_s, "peak_memory_gb": peak_gb,
            "decode_vs_teacher_forced_prefill": tf, "profiled": profiled,
            "ok": bool(ok)}


@contextlib.contextmanager
def router_margins():
    """Record, for every routing of ``models.moe`` while open, the gap
    between each token's k-th and (k+1)-th router probability (f32): the
    least gap and the routings within 1e-6, kept on the card until read
    (no host sync a call)."""
    import torch

    from repro_torch.models import moe as moe_lib

    route = moe_lib._route
    rec = {"calls": 0, "least": [], "near_ties": []}

    def recorded(params, x2d, m):
        probs, top_w, top_e = route(params, x2d, m)
        top = torch.topk(probs, m.top_k + 1, dim=-1).values
        gap = top[:, -2] - top[:, -1]
        rec["calls"] += 1
        rec["least"].append(gap.min())
        rec["near_ties"].append((gap < 1e-6).sum())
        return probs, top_w, top_e

    moe_lib._route = recorded
    try:
        yield rec
    finally:
        moe_lib._route = route


def moe_layer_check(cfg, dev) -> dict:
    """One MoE layer of ``cfg`` at full width, seed-0 weights drawn on
    ``dev``, on ``MOE_LAYER_TOKENS`` tokens that share a component of half
    their scale (as a residual stream's do, so the router favours some
    experts and the published capacity drops assignments): ``moe_sort`` against
    ``moe_onehot`` in f32 with TF32 off, within ``MOE_SORT_VS_ONEHOT`` of
    max|y|, the aux losses within 1e-5; the dropped assignments counted.
    Then the same layer in bf16: device ms of ``moe_sort``, of its expert
    FFN alone (the three batched GEMMs on the dispatched (E, C, D)) and of
    ``moe_onehot`` (the plain form), beside the bound: the expert weights,
    the router, x and the output moved once, and 6 D F FLOP a kept
    assignment at the bf16 rate.  No PyTorch call computes the layer."""
    import torch

    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import materialize, tree_map

    t0 = time.perf_counter()
    m, T, D = cfg.moe, MOE_LAYER_TOKENS, cfg.d_model
    gen = torch.Generator(dev).manual_seed(0)
    params = materialize(gen, moe_lib.moe_spec(cfg), device=dev)
    x = (torch.randn(1, T, D, generator=gen, device=dev)
         + 0.5 * torch.randn(1, 1, D, generator=gen, device=dev))
    f32 = cfg.replace(compute_dtype="float32")
    y_sort, a_sort = moe_lib.moe_sort(params, x, f32)
    y_oh, a_oh = moe_lib.moe_onehot(params, x, f32)
    err = float((y_sort - y_oh).abs().max())
    scale = float(y_oh.abs().max())
    aux_rel = abs(float(a_sort) - float(a_oh)) / abs(float(a_oh))
    _, _, top_e = moe_lib._route(params, x.reshape(T, D), m)
    C = moe_lib._capacity(T, m)
    dropped = int((moe_lib._positions(top_e, m.n_experts) >= C).sum())
    load = torch.bincount(top_e.reshape(-1), minlength=m.n_experts)
    del y_sort, y_oh

    bf = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    xb = x.to(torch.bfloat16)
    xs = torch.randn(m.n_experts, C, D, generator=gen, device=dev).to(
        torch.bfloat16)
    ms = device_ms(lambda: moe_lib.moe_sort(bf, xb, cfg))
    ffn_ms = device_ms(lambda: moe_lib._expert_ffn(bf, xs, torch.bfloat16))
    plain_ms = device_ms(lambda: moe_lib.moe_onehot(bf, xb, cfg), n=3)
    kept = T * m.top_k - dropped
    n_bytes = 2 * (3 * m.n_experts * D * m.d_ff + D * m.n_experts + 2 * T * D)
    b_ms, b_by = bound_ms(n_bytes, 6.0 * D * m.d_ff * kept, BF16_FLOPS_PER_S)
    ok = (err <= MOE_SORT_VS_ONEHOT * scale and aux_rel <= 1e-5
          and math.isfinite(scale))
    return {"tokens": T, "n_experts": m.n_experts, "top_k": m.top_k,
            "d_ff": m.d_ff, "capacity": C, "capacity_factor":
            m.capacity_factor, "assignments": T * m.top_k,
            "dropped_assignments": dropped,
            "drop_path_exercised": dropped > 0,
            "tokens_an_expert_least_most": [int(load.min()),
                                            int(load.max())],
            "f32_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "sort_vs_onehot_max_abs_err": err, "max_abs_y": scale,
            "tol": f"{MOE_SORT_VS_ONEHOT} of max|y|; aux 1e-5 relative",
            "aux_sort": float(a_sort), "aux_onehot": float(a_oh),
            "aux_rel_err": aux_rel,
            "bf16_moe_sort_ms": ms, "bf16_expert_ffn_ms": ffn_ms,
            "expert_gemm_share": ffn_ms / ms,
            "bf16_moe_onehot_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "expert_weights_gb": 2 * 3 * m.n_experts * D * m.d_ff / 1e9,
            "times": "device ms of one call, least of 10 (onehot 3)",
            "seconds": time.perf_counter() - t0, "ok": bool(ok)}


def lm_family_phases() -> dict:
    """yi-9b, granite-34b, qwen1.5-32b, falcon-mamba-7b,
    moonshot-v1-16b-a3b and llama4-scout-17b-a16e on the card
    (``LM_FAMILIES``), each after the previous one is freed: the CPU
    anchor at ``ANCHOR_LAYERS`` layers, f32 (``family_cpu_anchor``); the
    serving traffic in bf16 (``serve_family``); for an MoE arch the same
    traffic in f32 at lifted capacity (``MOE_F32_DEPTH`` layers, router
    gaps recorded) and one layer's dispatch (``moe_layer_check``); for an
    attention arch the kernel at its prefill geometry and the buckets'
    lengths beside the plain version, SDPA and the bound; for
    falcon-mamba-7b one layer's Mamba-1 scan at L = 999 (plain PyTorch: no
    TPU kernel runs it), traced.  One ``lm_families`` line an arch, then
    the phase's seconds.  Returns each attention arch's attention launches
    and times for the ``kernels`` line."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get
    from repro_torch.kernels import flash_attention as attn_mod
    from repro_torch.kernels import ref
    from repro_torch.models import ssm as ssm_lib

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    srng = np.random.default_rng(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    entries, failed = {}, []
    for arch, depth in LM_FAMILIES:
        t_arch = time.perf_counter()
        gc.collect()             # the last arch's engine and probe: a cycle
        torch.cuda.empty_cache()
        full = get(arch)
        anchor = family_cpu_anchor(
            full.replace(n_layers=ANCHOR_LAYERS, compute_dtype="float32"),
            dev)
        cfg = full if depth is None else full.replace(n_layers=depth)
        prompts = [[int(t) for t in srng.integers(1, cfg.vocab, n)]
                   for n in SERVE_PROMPTS]
        dense = cfg.family != "ssm"
        moe = cfg.family == "moe"
        line = serve_family(cfg, dev, prompts, tf_gate=(
            ("max_rel_l2", TF_BF16_REL_L2) if dense and not moe else None),
            trace=moe)
        if moe:     # the decode path held in f32 at lifted capacity
            line["decode_vs_teacher_forced_prefill"]["note"] = MOE_TF_NOTE
            lift = dataclasses.replace(full.moe, capacity_factor=float(
                full.moe.n_experts))
            # the bf16 gap at lifted capacity, reported: router flips only
            bf16 = serve_family(cfg.replace(moe=lift), dev, prompts)
            line["bf16_lifted_capacity_gap"] = {
                "capacity_factor": lift.capacity_factor,
                **{k: bf16[k] for k in (
                    "requests_done", "all_logits_finite",
                    "prefills_with_wrong_launches",
                    "decode_steps_launching_a_kernel", "peak_memory_gb",
                    "ok")},
                "note": "reported, not gated: bf16 rounds the decode and "
                        "prefill paths differently and that flips router "
                        "choices",
                **{k: bf16["decode_vs_teacher_forced_prefill"][k] for k in (
                    "max_abs_err", "max_abs_logit", "max_rel_l2",
                    "top1_agree", "compared")}}
            del bf16
            lifted = full.replace(n_layers=MOE_F32_DEPTH[arch],
                                  compute_dtype="float32", moe=lift)
            with router_margins() as gaps:
                f32 = serve_family(lifted, dev, prompts,
                                   tf_gate=("max_abs_err", TF_F32_ABS))
            line["f32_lifted_capacity_run"] = {
                "layers_run": lifted.n_layers,
                "capacity_factor": lifted.moe.capacity_factor,
                "router_calls": gaps["calls"],
                "least_kth_gap": float(torch.stack(gaps["least"]).min()),
                "tokens_within_1e-6_of_a_tie": int(torch.stack(
                    gaps["near_ties"]).sum()),
                **{k: f32[k] for k in (
                    "compute_dtype", "params", "requests_done",
                    "all_logits_finite", "prefills_with_wrong_launches",
                    "decode_steps_launching_a_kernel", "engine_run_seconds",
                    "tokens_per_s", "peak_memory_gb",
                    "decode_vs_teacher_forced_prefill", "ok")}}
            del f32
            line["moe_layer"] = moe_layer_check(full, dev)
            line["ok"] = (line["ok"] and line["bf16_lifted_capacity_gap"]["ok"]
                          and line["f32_lifted_capacity_run"]["ok"]
                          and line["moe_layer"]["ok"])
        if not dense:           # the decode path held in f32 (TF_F32_ABS)
            f32 = serve_family(cfg.replace(compute_dtype="float32"), dev,
                               prompts, tf_gate=("max_abs_err", TF_F32_ABS))
            line["f32_run"] = {k: f32[k] for k in (
                "compute_dtype", "requests_done", "all_logits_finite",
                "prefills_with_wrong_launches",
                "decode_steps_launching_a_kernel", "engine_run_seconds",
                "tokens_per_s", "peak_memory_gb",
                "decode_vs_teacher_forced_prefill", "ok")}
            line["ok"] = line["ok"] and f32["ok"]
        line = {"phase": "lm_families", "model": arch,
                "configured_layers": full.n_layers,
                "cut": (None if depth is None else
                        f"depth: {depth} of {full.n_layers} layers, full "
                        "width"), **line, "cpu_anchor": anchor}
        if cfg.family == "ssm":
            s = cfg.ssm
            L = SERVE_PROMPTS[-1] - 1
            u = randn(1, L, s.d_inner)
            dt_ = torch.nn.functional.softplus(randn(1, L, s.d_inner) - 2.0)
            A = -torch.exp(randn(s.d_inner, s.d_state))
            Bm, C = randn(1, L, s.d_state), randn(1, L, s.d_state)
            h0 = torch.zeros(1, s.d_inner, s.d_state, device=dev)

            def scan():
                return ssm_lib._mamba1_scan(u, dt_, A, Bm, C, h0, s.chunk)

            scan()
            host = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scan()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            t = gpu_trace(scan, "mamba1_scan_999", 1)
            # the scan's own bytes (u, dt, B, C, A, h0 read, y and the state
            # written) and ~6 f32 operations a (step, channel, state)
            n_bytes = 4 * (3 * L * s.d_inner + 2 * L * s.d_state
                           + 3 * s.d_inner * s.d_state)
            b_ms, b_by = bound_ms(n_bytes, 6.0 * L * s.d_inner * s.d_state)
            line["mamba1_scan_one_layer"] = {
                "L": L, "chunk": s.chunk, "d_inner": s.d_inner,
                "d_state": s.d_state, "form": "plain PyTorch, "
                "Hillis-Steele doubling inside each chunk, carry across",
                "host_ms_to_sync": sorted(host),
                "device_busy_ms": t["device_busy_ms"],
                "device_span_ms": t["device_span_ms"],
                "gpu_activities": t["gpu_activities"],
                "bound_ms": b_ms, "bound_by": b_by,
                "trace_whole": t["whole"]}
        else:
            Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
            rows = []
            for L in FAMILY_BUCKETS:
                q = randn(1, Hq, L, D, dtype=torch.bfloat16)
                k, v = (randn(1, Hkv, L, D, dtype=torch.bfloat16)
                        for _ in range(2))
                b_ms, b_by = attention_bound(1, Hq, Hkv, L, D, 2,
                                             BF16_FLOPS_PER_S)
                got = attn_mod.flash_attention(q, k, v, causal=True)
                torch.cuda.synchronize()
                ok, err, past = bf16_rule(
                    got, ref.attention(q, k, v, causal=True), v)
                del got
                rows.append({
                    "L": L, "max_abs_err": err,
                    "elements_beyond_1_ulp": past,
                    "tol": "1 bf16 ulp + 1e-5*max|v|", "ok": ok,
                    "ms": device_ms(lambda: attn_mod.flash_attention(
                        q, k, v, causal=True)),
                    "plain_ms": device_ms(lambda: ref.attention(
                        q, k, v, causal=True), n=3),
                    "library_ms": device_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True, enable_gqa=True)),
                    "bound_ms": b_ms, "bound_by": b_by})
            timing = {"shape": [1, Hq, Hkv, "L", D], "dtype": "bfloat16",
                      "form": attn_mod.FORM[torch.bfloat16],
                      "by_length": rows, "mean": mean_row(rows)}
            line["flash_attention_at_prefill_shapes"] = timing
            line["ok"] = line["ok"] and all(r["ok"] for r in rows)
            entries[arch] = {
                "launches": line["launches_in_run"]["flash_attention"],
                "launches_per_prefill":
                    line["expected_launches_per_prefill"]["flash_attention"],
                "shape": timing["shape"], **timing["mean"],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "by_length": rows}
        line["seconds"] = time.perf_counter() - t_arch
        line["ok"] = bool(line["ok"] and anchor["ok"])
        emit(line)
        if not line["ok"]:
            failed.append(arch)
    emit({"phase": "lm_families_seconds",
          "seconds": time.perf_counter() - t_phase})
    if failed:
        raise SystemExit(f"the LM families failed on the card: {failed}")
    return entries


# Expert parallelism (``moe_ep_phase``, phase ``moe_ep``):
# moonshot-v1-16b-a3b at full width under ``activate`` on the card's
# (1, 1) host mesh, where ``moe_ep`` is the default strategy of every
# model pass.  One layer at T = 1024 (``MOE_LAYER_TOKENS``), where moe_ep's
# per-shard capacity C = max(int(1.25 k T / E), k, min(T k, 32)) = 120 is
# ``moe_sort``'s; the whole model's prefills at the lengths where the two
# capacities agree (and at 128 tokens, where moe_ep's floor of 32 keeps what
# moe_sort's C = 15 drops: reported) and a 4-slot decode step (C = 24 =
# k T: moe_ep drops nothing, as the step at lifted capacity); two gloo
# ranks on ``cuda:0`` at mesh shapes (1, 2) under DECODE_RULES (experts
# split, one psum) and (2, 1) under DEFAULT_RULES (data split, the
# experts' FSDP gather, the aux loss's pmean), at capacity factor 8.
MOE_EP_ARCH = "moonshot-v1-16b-a3b"
MOE_EP_PREFILLS = ((1, 1024), (4, 512))      # (requests, length), gated
MOE_EP_SHORT = (1, 128)                      # reported
MOE_EP_AUX_COEF = 3.0        # the aux loss's weight in the differentiated sum
MOE_EP_RANK_CASES = (((1, 2), "decode"), ((2, 1), "default"))
MOE_EP_RANK_TIMEOUT_S = 240
# the two ranks against the plain version in f32 (TF32 off): outputs within
# MOE_EP_RANK_TOL of max|y|, the aux loss within it relative, gradients
# within it of their norms (the rank's sums run in another order)
MOE_EP_RANK_TOL = 1e-5
MOE_EP_RANK = r'''
import json
import sys

import chip_smoke

chip_smoke.moe_ep_rank(int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3]))
'''


def moe_layer_inputs(cfg, dev, B, S):
    """One MoE layer of ``cfg`` at its width, seed-0 weights drawn on
    ``dev`` in f32, B x S tokens sharing a component of half their scale
    (``moe_layer_check``'s) and a cotangent of their shape."""
    import torch

    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import materialize

    gen = torch.Generator(dev).manual_seed(0)
    params = materialize(gen, moe_lib.moe_spec(cfg), device=dev)
    D = cfg.d_model
    x = (torch.randn(B, S, D, generator=gen, device=dev)
         + 0.5 * torch.randn(1, 1, D, generator=gen, device=dev))
    return params, x, torch.randn(B, S, D, generator=gen, device=dev)


def moe_grads(run, params, x, cot):
    """``run(params, x)`` -> (y, aux) and the gradients of ``sum(y cot) +
    MOE_EP_AUX_COEF aux`` by x and each weight, all detached."""
    import torch

    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    xx = x.detach().requires_grad_()
    y, aux = run(p, xx)
    grads = torch.autograd.grad(
        (y.float() * cot).sum() + MOE_EP_AUX_COEF * aux, [*p.values(), xx])
    return y.detach(), aux.detach(), dict(zip([*p, "x"], grads))


def plain_ep(params, x, cfg, dp: int):
    """The plain version of ``moe_ep`` on ``dp`` data shards of x's rows
    where neither drops an assignment: ``moe_sort``'s output on the whole
    batch, and the mean of the shards' load-balance losses."""
    import torch

    from repro_torch.models import moe as moe_lib

    y, _ = moe_lib.moe_sort(params, x, cfg)
    auxes = []
    for xs in x.chunk(dp):
        probs, _, top_e = moe_lib._route(params, xs.reshape(-1, x.shape[-1]),
                                         cfg.moe)
        auxes.append(moe_lib._load_balance_loss(probs, top_e, cfg.moe))
    return y, torch.stack(auxes).sum() / dp


def moe_drops(params, x, cfg, C: int) -> int:
    """Assignments of x's tokens past position ``C`` of their expert."""
    from repro_torch.models import moe as moe_lib

    _, _, top_e = moe_lib._route(params, x.reshape(-1, x.shape[-1]), cfg.moe)
    return int((moe_lib._positions(top_e, cfg.moe.n_experts) >= C).sum())


def sketch(t):
    """Two 64-bit random linear sketches of ``t``'s bits (seeded weights,
    the same on every rank)."""
    import torch

    bits = t.reshape(-1).view(torch.int32).to(torch.int64)
    out = []
    for j in range(2):
        gen = torch.Generator(t.device).manual_seed(j)
        w = torch.randint(-2 ** 62, 2 ** 62, bits.shape, generator=gen,
                          device=t.device, dtype=torch.int64)
        out.append((bits * w).sum())
    return torch.stack(out)


def moe_ep_rank(rank: int, out: str, spec: dict) -> None:
    """One of two gloo ranks of the phase's case (c): for each (mesh
    shape, rules) of ``spec["cases"]`` the layer's ``moe_ep`` forward and
    backward on a ``DeviceMesh`` of that shape over both ranks, against
    ``plain_ep`` in this process; every collective's payload, group size
    and synchronized ms recorded.  Writes ``rank<r>.json`` under ``out``."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import sharding
    from repro_torch.configs import get
    from repro_torch.models import moe as moe_lib
    from repro_torch.sharding import partition

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(out + "/store", 2),
                            rank=rank, world_size=2)
    try:
        dev = torch.device("cuda", 0)
        cfg = get(spec["arch"])
        cfg = cfg.replace(compute_dtype="float32", moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
        params, x, cot = moe_layer_inputs(cfg, dev, 2, spec["tokens"] // 2)
        calls, stage = [], {"now": None}
        reduce_, gather_ = partition._all_reduce, partition._gather_blocks

        def timed(op, fn, size):
            def run(t, group, *a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(t, group, *a)
                torch.cuda.synchronize()
                groups = group if isinstance(group, list) else [group]
                calls.append({"op": op, "stage": stage["now"],
                              "bytes": t.numel() * t.element_size(),
                              "ranks": [dist.get_world_size(g)
                                        for g in groups],
                              "wire_bytes": size(t, groups),
                              "ms": (time.perf_counter() - t0) * 1e3})
                return r
            return run

        def ring_reduce(t, groups):
            n = t.numel() * t.element_size()
            return sum(2 * (w - 1) * n // w for w in
                       (dist.get_world_size(g) for g in groups))

        def ring_gather(t, groups):
            return ((dist.get_world_size(groups[0]) - 1) * t.numel()
                    * t.element_size())

        partition._all_reduce = timed("all_reduce", reduce_, ring_reduce)
        partition._gather_blocks = timed("all_gather", gather_, ring_gather)
        rows = []
        for shape, rules_name in spec["cases"]:
            mesh = init_device_mesh("cuda", tuple(shape),
                                    mesh_dim_names=("data", "model"))
            rules = {"default": sharding.DEFAULT_RULES,
                     "decode": sharding.DECODE_RULES}[rules_name]
            dp = shape[0]
            calls.clear()

            def run(p, xx):
                stage["now"] = "forward"
                with sharding.activate(mesh, rules):
                    out = moe_lib.moe_ep(p, xx, cfg)
                stage["now"] = "backward"
                return out

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, aux, g = moe_grads(run, params, x, cot)
            torch.cuda.synchronize()
            total_ms = (time.perf_counter() - t0) * 1e3
            py, paux, pg = moe_grads(
                lambda p, xx: plain_ep(p, xx, cfg, dp), params, x, cot)
            T_loc = x.shape[0] * x.shape[1] // dp
            C = moe_lib._ep_capacity(T_loc, cfg.moe)
            drops = sum(moe_drops(params, xs, cfg, C) for xs in x.chunk(dp))
            mine = torch.cat([sketch(y), sketch(aux.reshape(1))]
                             + [sketch(g[k]) for k in sorted(g)])
            both = [torch.empty_like(mine) for _ in range(2)]
            dist.all_gather(both, mine)
            scale = float(py.abs().max())
            rows.append({
                "mesh": list(shape), "rules": rules_name, "capacity": C,
                "tokens_a_data_shard": T_loc, "dropped_assignments": drops,
                "ranks_equal": bool(torch.equal(both[0], both[1])),
                "y_max_abs_err": float((y - py).abs().max()),
                "max_abs_y": scale,
                "aux": float(aux), "plain_aux": float(paux),
                "aux_rel_err": abs(float(aux) / float(paux) - 1),
                "grad_rel_err": {k: float((g[k] - pg[k]).norm()
                                          / pg[k].norm()) for k in g},
                "forward_and_backward_ms": total_ms,
                "collectives": list(calls)})
            del y, aux, g, py, paux, pg
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump({"rows": rows, "backend": dist.get_backend(),
                       "device": str(dev),
                       "peak_memory_gb":
                           torch.cuda.max_memory_allocated() / 1e9,
                       "jax_or_repro_imported": any(
                           m == "jax" or m == "repro"
                           or m.startswith("repro.") for m in sys.modules)},
                      f)
    finally:
        dist.destroy_process_group()


def moe_ep_layer_check(cfg, dev, mesh) -> dict:
    """Case (a): one layer of ``cfg`` at full width on ``MOE_LAYER_TOKENS``
    tokens (``moe_layer_inputs``), where moe_ep's capacity is moe_sort's.
    In f32 (the caller turns TF32 off) and in bf16, under DEFAULT_RULES
    (FSDP: the experts cross a gather of one rank) and DECODE_RULES:
    moe_ep under ``activate(mesh, rules)`` against moe_sort, the output,
    the aux loss and the gradients of x and the four weights bit for bit,
    with ``torch.use_deterministic_algorithms`` on (the gradient of a
    gather adds a token's slots with atomics otherwise); without it, the
    largest gap of moe_ep to moe_sort and of moe_sort to itself."""
    import torch

    from repro_torch import sharding
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import tree_map

    T = MOE_LAYER_TOKENS
    f32 = cfg.replace(compute_dtype="float32")
    params, x, cot = moe_layer_inputs(f32, dev, 1, T)
    C = moe_lib._ep_capacity(T, cfg.moe)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        p = tree_map(lambda t: t.to(dtype), params)
        xd = x.to(dtype)
        for name, rules in (("default", sharding.DEFAULT_RULES),
                            ("decode", sharding.DECODE_RULES)):
            def ep(q, xx):
                with sharding.activate(mesh, rules):
                    return moe_lib.moe_ep(q, xx, cfg)

            def sort(q, xx):
                return moe_lib.moe_sort(q, xx, cfg)

            def gaps(a, b):
                return max([float((a[0].float() - b[0].float()).abs().max()),
                            abs(float(a[1]) - float(b[1]))]
                           + [float((a[2][k].float() - b[2][k].float())
                                    .abs().max()) for k in a[2]])

            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                a, b = (moe_grads(f, p, xd, cot) for f in (ep, sort))
            finally:
                torch.use_deterministic_algorithms(False)
            equal = {"y": torch.equal(a[0], b[0]),
                     "aux": torch.equal(a[1], b[1]),
                     **{f"grad_{k}": torch.equal(a[2][k], b[2][k])
                        for k in a[2]}}
            del a, b
            a, b, b2 = (moe_grads(f, p, xd, cot) for f in (ep, sort, sort))
            rows.append({"dtype": str(dtype).split(".")[-1], "rules": name,
                         "bit_equal": equal,
                         "nondeterministic_max_gap_ep_to_sort": gaps(a, b),
                         "nondeterministic_max_gap_sort_to_itself":
                             gaps(b, b2),
                         "ok": all(equal.values())})
            del a, b, b2
    return {"tokens": T, "capacity_moe_ep": C,
            "capacity_moe_sort": moe_lib._capacity(T, cfg.moe),
            "dropped_assignments": moe_drops(params, x, cfg, C),
            "rows": rows,
            "ok": (C == moe_lib._capacity(T, cfg.moe)
                   and all(r["ok"] for r in rows))}


@contextlib.contextmanager
def moe_calls():
    """Count the calls of ``models.moe``'s moe_ep and moe_sort while
    open."""
    from repro_torch.models import moe as moe_lib

    counts = {"moe_ep": 0, "moe_sort": 0}
    real = {k: getattr(moe_lib, k) for k in counts}

    def counted(name):
        def run(*a, **k):
            counts[name] += 1
            return real[name](*a, **k)
        return run

    for k in counts:
        setattr(moe_lib, k, counted(k))
    try:
        yield counts
    finally:
        for k, f in real.items():
            setattr(moe_lib, k, f)


def moe_ep_model_check(cfg, dev, mesh) -> dict:
    """Case (b): ``cfg`` whole in its compute dtype with seed-0 weights
    drawn on ``dev``, through ``Model.prefill`` and ``decode_step`` (default
    strategy ``"ep"``) under ``activate(mesh, DECODE_RULES)`` against the
    same calls with no mesh (``moe_sort``): each prefill of
    ``MOE_EP_PREFILLS`` gives the unplaced logits and cache bit for bit,
    one moe_ep call and no moe_sort call a layer, one flash_attention
    launch a layer; a 4-slot decode step on the (4, 512) caches gives the
    unplaced step's logits at lifted capacity (factor n_experts) bit for
    bit; the gap to the unplaced step at the published capacity and that
    capacity's drops are recorded, as is ``MOE_EP_SHORT``'s prefill gap
    (moe_ep's floor keeps what moe_sort drops).  Each call runs twice; the
    second is timed (host ms to a synchronize) and counted."""
    import dataclasses

    import torch

    from repro_torch import sharding
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import pattern_for

    model = build(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    pattern, n_super, _, _ = pattern_for(cfg)
    per_prefill = n_super * pattern.count("attn")
    n_moe = n_super * pattern.count("moe")
    gen = torch.Generator(dev).manual_seed(1)

    def timed(fn):
        # a call first: the first pays lazy set-up (the size-1 groups'
        # communicators); a prefill or step again writes the same keys and
        # values to the cache
        fn()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with moe_calls() as calls:
            out = fn()
        torch.cuda.synchronize()
        return out, {"host_ms": (time.perf_counter() - t0) * 1e3,
                     "flash_attention": ops.launch_counts()[
                         "flash_attention"], **calls}

    def placed(fn):
        def run():
            with sharding.activate(mesh, sharding.DECODE_RULES):
                return fn()
        return run

    prefills, flash = [], 0
    caches = None
    for B, L in (*MOE_EP_PREFILLS, MOE_EP_SHORT):
        toks = torch.randint(1, cfg.vocab, (B, L), generator=gen, device=dev,
                             dtype=torch.int32)
        cu, cp = model.init_cache(B, L + 1), model.init_cache(B, L + 1)
        (lu, _), plain = timed(lambda: model.prefill(
            params, {"tokens": toks}, cu))
        (lp, _), ep = timed(placed(lambda: model.prefill(
            params, {"tokens": toks}, cp)))
        T = B * L
        gated = (B, L) != MOE_EP_SHORT
        row = {"requests": B, "length": L,
               "capacity_moe_ep": moe_lib._ep_capacity(T, cfg.moe),
               "capacity_moe_sort": moe_lib._capacity(T, cfg.moe),
               "logits_bit_equal": torch.equal(lu, lp),
               "max_abs_gap": float((lu - lp).abs().max()),
               "cache_bit_equal": all(
                   torch.equal(cu["blocks"][k][n], cp["blocks"][k][n])
                   for k in cu["blocks"] for n in cu["blocks"][k]),
               "unplaced": plain, "placed": ep, "gated": gated}
        row["ok"] = bool(
            torch.isfinite(lp).all()
            and ep["flash_attention"] == per_prefill
            and ep["moe_ep"] == n_moe and ep["moe_sort"] == 0
            and (not gated or (row["logits_bit_equal"]
                               and row["cache_bit_equal"]
                               and row["capacity_moe_ep"]
                               == row["capacity_moe_sort"])))
        flash += ep["flash_attention"]
        prefills.append(row)
        if (B, L) == (4, 512):
            caches, last = (cu, cp), (lu, L)
        del cu, cp
    (cu, cp), (lu, L) = caches, last
    tok = lu.argmax(-1).to(torch.int32)
    pos = torch.full((4,), L, dtype=torch.int32, device=dev)
    lift = build(cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts))), device=dev)
    (dp, _), ep = timed(placed(lambda: model.decode_step(params, tok, cp,
                                                         pos)))
    (dl, _), lifted = timed(lambda: lift.decode_step(params, tok, cu, pos))
    (dq, _), published = timed(lambda: model.decode_step(params, tok, cu,
                                                         pos))
    drops = []
    route = moe_lib._route

    def recorded(p, x2d, m):
        out = route(p, x2d, m)
        C = moe_lib._capacity(x2d.shape[0], m)
        drops.append((moe_lib._positions(out[2], m.n_experts) >= C).sum())
        return out

    moe_lib._route = recorded
    try:
        model.decode_step(params, tok, cu, pos)
    finally:
        moe_lib._route = route
    decode = {
        "slots": 4, "position": L,
        "capacity_moe_ep": moe_lib._ep_capacity(4, cfg.moe),
        "capacity_lifted": moe_lib._capacity(4, lift.cfg.moe),
        "capacity_published": moe_lib._capacity(4, cfg.moe),
        "logits_bit_equal_to_lifted": torch.equal(dp, dl),
        "max_abs_gap_to_published": float((dp - dq).abs().max()),
        "rel_l2_gap_to_published": float((dp - dq).norm() / dq.norm()),
        "published_dropped_assignments": int(torch.stack(drops).sum()),
        "placed": ep, "lifted": lifted, "published": published}
    decode["ok"] = bool(decode["logits_bit_equal_to_lifted"]
                        and decode["capacity_moe_ep"]
                        == decode["capacity_lifted"]
                        and ep["flash_attention"] == 0
                        and ep["moe_ep"] == n_moe and ep["moe_sort"] == 0)
    return {"model": cfg.name, "layers": cfg.n_layers,
            "compute_dtype": cfg.compute_dtype, "params": model.param_count(),
            "mesh": list(mesh.shape), "rules": "DECODE_RULES",
            "prefills": prefills, "decode_step": decode,
            "flash_attention_launches": flash,
            "flash_attention_per_prefill": per_prefill,
            "ok": all(r["ok"] for r in prefills) and decode["ok"]}


def moe_ep_layer_times(cfg, dev, mesh) -> dict:
    """bf16 device ms of one layer on ``MOE_LAYER_TOKENS`` tokens: moe_ep
    under ``activate(mesh, DECODE_RULES)`` and moe_sort, forward and
    forward + backward, least of 10; GPU activities of one forward of each
    (the size-1 psum, pmean and gathers are moe_ep's extra); the bound:
    ``moe_layer_check``'s."""
    import torch

    from repro_torch import sharding
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import tree_map

    T, m, D = MOE_LAYER_TOKENS, cfg.moe, cfg.d_model
    params, x, cot = moe_layer_inputs(cfg.replace(compute_dtype="float32"),
                                      dev, 1, T)
    bf = tree_map(lambda t: t.to(torch.bfloat16), params)
    xb = x.to(torch.bfloat16)

    def ep(q, xx):
        with sharding.activate(mesh, sharding.DECODE_RULES):
            return moe_lib.moe_ep(q, xx, cfg)

    def sort(q, xx):
        return moe_lib.moe_sort(q, xx, cfg)

    out = {}
    for name, f in (("moe_ep", ep), ("moe_sort", sort)):
        out[name] = {
            "forward_ms": device_ms(lambda: f(bf, xb)),
            "forward_backward_ms": device_ms(
                lambda: moe_grads(f, bf, xb, cot)),
            "forward_gpu_activities": gpu_trace(
                lambda: f(bf, xb), f"{name}_layer", 1)["gpu_activities"]}
    kept = T * m.top_k - moe_drops(params, x, cfg, moe_lib._capacity(T, m))
    n_bytes = 2 * (3 * m.n_experts * D * m.d_ff + D * m.n_experts + 2 * T * D)
    b_ms, b_by = bound_ms(n_bytes, 6.0 * D * m.d_ff * kept, BF16_FLOPS_PER_S)
    return {"tokens": T, "dtype": "bfloat16", "rules": "DECODE_RULES",
            **out, "extra_gpu_activities_of_moe_ep": (
                out["moe_ep"]["forward_gpu_activities"]
                - out["moe_sort"]["forward_gpu_activities"]),
            "forward_bound_ms": b_ms, "bound_by": b_by,
            "times": "device ms of one call, least of 10"}


def moe_ep_phase() -> dict:
    """Expert parallelism on the card (phase ``moe_ep``): moonshot-v1-16b-a3b
    at full width on the card's (1, 1) host mesh.  (a) one layer's moe_ep
    against moe_sort bit for bit, forward and backward, f32 (TF32 off) and
    bf16 (``moe_ep_layer_check``), and bf16 device ms of both
    (``moe_ep_layer_times``); (b) the whole model's prefills and a decode
    step under ``activate`` against its unplaced runs
    (``moe_ep_model_check``); (c) two gloo ranks on ``cuda:0`` at (1, 2)
    and (2, 1): the layer's outputs, aux loss and gradients against
    ``plain_ep`` (capacity factor 8), both ranks the same bits, each
    collective's ms and bytes.  Returns flash_attention's launches on (b)
    for the ``kernels`` line."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = get(MOE_EP_ARCH)
    created_group = not dist.is_initialized()
    mesh = make_host_mesh()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        layer = moe_ep_layer_check(cfg, dev, mesh)
        layer["times"] = moe_ep_layer_times(cfg, dev, mesh)
        layer["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()

        # (c) before the whole model, so the ranks have the card's memory
        t0 = time.perf_counter()
        spec = {"arch": MOE_EP_ARCH, "tokens": MOE_LAYER_TOKENS,
                "cases": [list(c) for c in MOE_EP_RANK_CASES]}
        out = Path(tempfile.mkdtemp(prefix="moe_ep_ranks_"))
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        procs = [subprocess.Popen(
            [sys.executable, "-c", MOE_EP_RANK, str(r), str(out),
             json.dumps(spec)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=MOE_EP_RANK_TIMEOUT_S)
                    for p in procs]
            codes = [p.returncode for p in procs]
            ranks = ([json.loads((out / f"rank{r}.json").read_text())
                      for r in range(2)] if codes == [0, 0] else [])
        finally:
            for p in procs:
                p.kill()
                p.wait()
            shutil.rmtree(out, ignore_errors=True)
        if codes != [0, 0]:
            raise SystemExit(f"moe_ep (c): ranks exited {codes}: "
                             + " | ".join(e[-2000:] for _, e in outs))
        rows = ranks[0]["rows"]
        for r in rows:
            r["ok"] = bool(
                r["ranks_equal"] and r["dropped_assignments"] == 0
                and r["y_max_abs_err"] <= MOE_EP_RANK_TOL * r["max_abs_y"]
                and r["aux_rel_err"] <= MOE_EP_RANK_TOL
                and max(r["grad_rel_err"].values()) <= MOE_EP_RANK_TOL)
        two = {"ranks": 2, "backend": ranks[0]["backend"],
               "device": ranks[0]["device"], "capacity_factor": 8.0,
               "tol": f"{MOE_EP_RANK_TOL} of max|y|, relative for aux, of "
                      "each gradient's norm",
               "rows": rows,
               "second_rank_rows": [{k: r[k] for k in (
                   "ranks_equal", "y_max_abs_err", "aux_rel_err",
                   "grad_rel_err", "forward_and_backward_ms")}
                   for r in ranks[1]["rows"]],
               "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
               "jax_or_repro_imported": any(r["jax_or_repro_imported"]
                                            for r in ranks),
               "seconds": time.perf_counter() - t0}
        two["ok"] = bool(all(r["ok"] for r in rows)
                         and not two["jax_or_repro_imported"]
                         and two["backend"] == "gloo")
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        model = moe_ep_model_check(cfg, dev, mesh)
        model["seconds"] = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        if created_group:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    ok = layer["ok"] and model["ok"] and two["ok"]
    emit({"phase": "moe_ep", "card": card_line(), "model": cfg.name,
          "width": {"d_model": cfg.d_model, "n_experts": cfg.moe.n_experts,
                    "top_k": cfg.moe.top_k, "d_ff": cfg.moe.d_ff},
          "layer": layer, "whole_model": model, "two_ranks": two,
          "seconds": time.perf_counter() - t_phase, "ok": bool(ok)})
    if not ok:
        raise SystemExit("moe_ep: layer "
                         f"{[r['bit_equal'] for r in layer['rows']]}, model "
                         f"{[r['ok'] for r in model['prefills']]} decode "
                         f"{model['decode_step']['ok']}, ranks "
                         f"{[r['ok'] for r in rows]}")
    return {"flash_attention": {
        "launches": model["flash_attention_launches"],
        "launches_per_prefill": model["flash_attention_per_prefill"]}}


# The cross-attention families (``lm_context_families``), at full width
# and depth in bf16 with seed-0 weights drawn on the card
# (reference ``param_count``): llama-3.2-vision-11b's 9.78 B parameters
# are 19.6 GB of bf16, whisper-large-v3's 1.54 B 3.1 GB.  The engine
# takes tokens only, as the reference's does, so each serves its traffic
# through ``Model.prefill`` with the batch's context and greedy
# ``Model.decode_step``s: a batch of ``SERVE_SLOTS`` requests at each
# prompt length, each request with its own context, N(0, 1) in the
# compute dtype (``materialize_inputs``' 0.02 scale would leave the VLM's
# adapted context, which no norm rescales, too small for its cross layers
# to move a logit).  The CPU anchor cuts depth only: the VLM to one self
# and one cross layer (``pattern_for`` asserts n_layers % cross_every ==
# 0, so 2 layers need cross_every = 2), whisper to 2 decoder and 2
# encoder layers.
CONTEXT_FAMILIES = (
    ("llama-3.2-vision-11b", {"n_layers": 2, "cross_every": 2}),
    ("whisper-large-v3", {"n_layers": 2, "encoder_layers": 2}),
)
CONTEXT_PROMPTS = (128, 1000)


def context_inputs(cfg, gen, n_prompt, batch):
    """A batch of ``batch`` greedy requests of ``n_prompt`` tokens in [1,
    vocab) and each request's context (``image_embeds`` or ``frames``),
    N(0, 1) cast to the compute dtype, drawn from ``gen`` on its
    device."""
    import torch

    dev = gen.device
    toks = torch.randint(1, cfg.vocab, (batch, n_prompt), generator=gen,
                         device=dev, dtype=torch.int32)
    if cfg.family == "vlm":
        key, shape = "image_embeds", (batch, cfg.n_img_tokens, cfg.d_vision)
    else:
        key, shape = "frames", (batch, cfg.n_frames, cfg.d_model)
    ctx = {key: torch.randn(shape, generator=gen, device=dev).to(cfg.cdtype)}
    return toks, ctx


def context_serve(model, params, toks, ctx, new_tokens, max_len, keep=()):
    """One batch served as a user of the model serves it: ``prefill`` of
    each request's first n - 1 tokens with its context, then greedy
    ``decode_step``s from token n - 1, all requests at one position.  The
    launch counts are zeroed just before each call and read just after,
    with the device synchronized around it (host clock).  Returns the
    prefill's record, the decode steps' records, the new tokens (B,
    new_tokens) and the f32 logits (on the CPU) of the decode steps in
    ``keep``."""
    import torch

    from repro_torch.kernels import ops

    B, n = toks.shape
    dev = model.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3, ops.launch_counts()

    with torch.no_grad():
        cache = model.init_cache(B, max_len)
        (lg, _), ms, counts = timed(lambda: model.prefill(
            params, {"tokens": toks[:, :n - 1], **ctx}, cache))
        pre = {"tokens": n - 1, "batch": B, "ms": ms, "launches": counts,
               "finite": bool(torch.isfinite(lg).all())}
        tok, steps, out, kept = toks[:, n - 1], [], [], {}
        for i in range(new_tokens):
            pos = torch.full((B,), n - 1 + i, dtype=torch.int32, device=dev)
            (lg, _), ms, counts = timed(lambda: model.decode_step(
                params, tok, cache, pos))
            steps.append({"ms": ms, "launches": counts,
                          "finite": bool(torch.isfinite(lg).all())})
            if i in keep:
                kept[i] = lg.float().cpu()
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            out.append(tok)
    return pre, steps, torch.stack(out, dim=1), kept


TF_STEPS = (0, SERVE_NEW // 2 - 1, SERVE_NEW - 1)


def context_teacher_forced(model, params, toks, ctx, out, kept, max_len):
    """The decode logits at ``TF_STEPS`` against a fresh prefill of the
    same tokens (prompt + the new tokens before the step) and context
    (``logit_gaps``)."""
    import torch

    seq = torch.cat([toks, out], dim=1)
    n = toks.shape[1]

    def pairs():
        for k in TF_STEPS:
            lg, _ = model.prefill(params, {"tokens": seq[:, :n + k], **ctx},
                                  model.init_cache(seq.shape[0], max_len))
            yield lg.float().cpu(), kept[k]

    with torch.no_grad():
        return {"steps": list(TF_STEPS), **logit_gaps(pairs())}


def context_cpu_anchor(cfg, dev) -> dict:
    """``cfg`` (f32, cut in depth) on ``dev`` and on the CPU from the same
    parameters, drawn on ``dev`` and copied: a request at each of
    ``ANCHOR_PROMPTS`` with its own context, ``ANCHOR_NEW`` greedy tokens
    (``context_serve``).  The tokens must be equal, and every decode
    step's logits within 1e-4 of the CPU's largest |logit|."""
    import torch

    from repro_torch.models import build
    from repro_torch.models.layers import tree_map

    t0 = time.perf_counter()
    card = build(cfg, device=dev)
    params = card.init(torch.Generator(dev).manual_seed(0))
    cpu = build(cfg, device="cpu")
    params_cpu = tree_map(lambda t: t.cpu(), params)
    gen = torch.Generator(dev).manual_seed(1)
    keep = tuple(range(ANCHOR_NEW))
    toks_card, toks_cpu, pairs = [], [], []
    secs = {"card": 0.0, "cpu": 0.0}
    for n in ANCHOR_PROMPTS:
        toks, ctx = context_inputs(cfg, gen, n, 1)
        runs = {}
        for name, m, p, put in (("card", card, params, lambda t: t),
                                ("cpu", cpu, params_cpu, lambda t: t.cpu())):
            t1 = time.perf_counter()
            runs[name] = context_serve(
                m, p, put(toks), {k: put(v) for k, v in ctx.items()},
                ANCHOR_NEW, 160, keep)
            secs[name] += time.perf_counter() - t1
        (_, _, out_card, lg_card), (_, _, out_cpu, lg_cpu) = (
            runs["card"], runs["cpu"])
        toks_card.append(out_card[0].tolist())
        toks_cpu.append(out_cpu[0].tolist())
        pairs += [(lg_cpu[k], lg_card[k]) for k in keep]
    return {"layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
            "cross_every": cfg.cross_every,
            "compute_dtype": cfg.compute_dtype, "tf32": False,
            "prompt_lengths": list(ANCHOR_PROMPTS), "new_tokens": ANCHOR_NEW,
            **anchor_verdict(toks_card, toks_cpu, pairs,
                             len(ANCHOR_PROMPTS) * ANCHOR_NEW),
            "card_seconds": secs["card"], "cpu_seconds": secs["cpu"],
            "seconds": time.perf_counter() - t0}


def attention_row(q, k, v, causal, use) -> dict:
    """The attention kernel on bf16 (q, k, v) against ``ref.attention``
    under the bf16 rule, timed beside the plain version, SDPA
    (``enable_gqa=True``) and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as attn_mod
    from repro_torch.kernels import ref

    B, Hq, L, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    b_ms, b_by = attention_bound(B, Hq, Hkv, L, D, 2, BF16_FLOPS_PER_S,
                                 Lkv=T, causal=causal)
    got = attn_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ok, err, past = bf16_rule(got, ref.attention(q, k, v, causal=causal), v)
    del got
    return {
        "use": use, "B": B, "L": L, "Lkv": T, "causal": causal,
        "ragged_q_tile": L % 64 != 0, "ragged_kv_tile": T % 64 != 0,
        "max_abs_err": err, "elements_beyond_1_ulp": past,
        "tol": "1 bf16 ulp + 1e-5*max|v|", "ok": ok,
        "ms": device_ms(lambda: attn_mod.flash_attention(
            q, k, v, causal=causal)),
        "plain_ms": device_ms(lambda: ref.attention(
            q, k, v, causal=causal), n=3),
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by}


def context_attention_rows(cfg, dev, gen, name, Lkv, causal, lengths):
    """``attention_row`` at ``cfg``'s head geometry, (1, Hq, Hkv, L | Lkv,
    D) bf16 drawn from ``gen`` for each L of ``lengths`` (``Lkv`` None:
    self-attention over L)."""
    import torch

    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rows = []
    for L in lengths:
        T = L if Lkv is None else Lkv

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(
                torch.bfloat16)

        rows.append(attention_row(randn(1, Hq, L, D), randn(1, Hkv, T, D),
                                  randn(1, Hkv, T, D), causal, name))
    return rows


def served_attention_rows(model, params, batches) -> list:
    """``attention_row`` on the inputs the served prefills give the kernel:
    one more prefill of each batch of ``batches`` ((tokens, context), as
    served: the first n - 1 tokens) with ``ops.flash_attention`` recorded,
    the first call of each form (the caller, q's and k's shapes) kept,
    that is, the first encoder, self and cross layer's q, k and v."""
    import sys

    import torch

    from repro_torch.kernels import ops

    # the caller in models.attention: in a prefill, self_attention is
    # whisper's encoder
    use_of = {"self_attention": "encoder", "prefill_attention": "self",
              "cross_attention": "cross"}
    seen = {}
    flash = ops.flash_attention

    def record(q, k, v, *, causal=True, **kw):
        key = (use_of[sys._getframe(1).f_code.co_name], tuple(q.shape),
               tuple(k.shape), causal)
        if key not in seen:
            seen[key] = (q.clone(), k.clone(), v.clone())
        return flash(q, k, v, causal=causal, **kw)

    with torch.no_grad(), swapped(ops, "flash_attention", record):
        for toks, ctx in batches:
            B, n = toks.shape
            model.prefill(params, {"tokens": toks[:, :n - 1], **ctx},
                          model.init_cache(B, SERVE_MAX_LEN))
    rows = []
    for (use, _, _, causal), (q, k, v) in seen.items():
        rows.append(attention_row(q, k, v, causal, use))
    return rows


def serve_context_family(cfg, dev) -> dict:
    """``cfg`` in bf16 with seed-0 weights drawn on ``dev``: a warm-up,
    then a batch of ``SERVE_SLOTS`` requests at each of
    ``CONTEXT_PROMPTS`` (``SERVE_NEW`` greedy tokens each, cache
    ``SERVE_MAX_LEN``): prefill ms by length, decode ms a step, tokens/s,
    peak memory, every prefill's and decode step's launches (one
    attention launch a prefill per self, cross and encoder layer; none a
    decode step, whose cross-attention is the plain product), finite
    logits, and the decode logits at ``TF_STEPS`` against fresh prefills
    (relative L2 within ``TF_BF16_REL_L2``).  Then the attention kernel on
    the served prefills' own inputs (``served_attention_rows``), and one
    prefill of the longest batch and one decode step traced
    (``gpu_trace``)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.models import build
    from repro_torch.models.layers import tree_items
    from repro_torch.models.transformer import pattern_for

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    weights_gb = sum(t.numel() * t.element_size()
                     for _, t in tree_items(params)) / 1e9
    n_params = model.param_count()
    pattern, n_super, _, _ = pattern_for(cfg)
    per_prefill = {"flash_attention": n_super * (pattern.count("attn")
                                                 + pattern.count("cross"))
                   + cfg.encoder_layers, "ssd_scan": 0}
    gen = torch.Generator(dev).manual_seed(2)
    batches = [context_inputs(cfg, gen, n, SERVE_SLOTS)
               for n in CONTEXT_PROMPTS]
    context_serve(model, params, *batches[0], 2, SERVE_MAX_LEN)  # warm-up
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    prefills, decodes, runs = [], [], []
    for toks, ctx in batches:
        pre, steps, out, kept = context_serve(
            model, params, toks, ctx, SERVE_NEW, SERVE_MAX_LEN, TF_STEPS)
        prefills.append(pre)
        decodes += steps
        runs.append((toks, ctx, out, kept))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    t1 = time.perf_counter()
    tfs = [context_teacher_forced(model, params, toks, ctx, out, kept,
                                  SERVE_MAX_LEN)
           for toks, ctx, out, kept in runs]
    tf = {"steps": list(TF_STEPS),
          **{k: max(t[k] for t in tfs) for k in (
              "max_abs_err", "max_abs_logit", "max_rel_l2")},
          **{k: sum(t[k] for t in tfs) for k in ("top1_agree", "compared")},
          "gate": {"measure": "max_rel_l2", "limit": TF_BF16_REL_L2},
          "seconds": time.perf_counter() - t1}
    served = served_attention_rows(model, params, batches)
    # one prefill of the longest batch and one decode step after it, traced
    toks, ctx = batches[-1]
    B, n = toks.shape
    cache = model.init_cache(B, SERVE_MAX_LEN)
    pos = torch.full((B,), n - 1, dtype=torch.int32, device=dev)
    with torch.no_grad():
        profiled = {
            f"prefill_{n - 1}_batch_{B}": gpu_trace(
                lambda: model.prefill(params, {"tokens": toks[:, :n - 1],
                                               **ctx}, cache),
                f"{cfg.name}_prefill", 1, focus=TRACE_FOCUS),
            f"decode_step_{B}_slots": gpu_trace(
                lambda: model.decode_step(params, toks[:, n - 1], cache, pos),
                f"{cfg.name}_decode", 1, focus=TRACE_FOCUS)}
    del cache
    for t in profiled.values():
        t["device_idle_share_of_wall"] = (1 - t["device_busy_ms"]
                                          / t["traced_wall_ms"])
    bad_prefill = [c for c in prefills if c["launches"] != {
        **{k: 0 for k in c["launches"]}, **per_prefill}]
    bad_decode = [c for c in decodes if any(c["launches"].values())]
    finite = all(c["finite"] for c in prefills + decodes)
    n_tok = sum(out.numel() for _, _, out, _ in runs)
    run_s = sum(c["ms"] for c in prefills + decodes) / 1e3
    step_ms = [c["ms"] for c in decodes]
    ok = (finite and not bad_prefill and not bad_decode
          and len(decodes) == SERVE_NEW * len(batches)
          and tf["compared"] == len(TF_STEPS) * SERVE_SLOTS * len(batches)
          and tf["max_rel_l2"] <= TF_BF16_REL_L2
          and all(r["ok"] for r in served))
    return {"model": cfg.name, "family": cfg.family,
            "layers_run": cfg.n_layers,
            "encoder_layers_run": cfg.encoder_layers,
            "cross_every": cfg.cross_every, "pattern": list(pattern),
            "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
            "d_ff": cfg.d_ff, "act": cfg.act, "norm": cfg.norm,
            "vocab": cfg.vocab, "context_tokens": (
                cfg.n_img_tokens if cfg.family == "vlm" else cfg.n_frames),
            "context_width": (cfg.d_vision if cfg.family == "vlm"
                              else cfg.d_model),
            "compute_dtype": cfg.compute_dtype,
            "params": n_params,
            "weights_gb": weights_gb, "init_seconds": init_s,
            "init_peak_memory_gb": init_peak_gb,
            "requests": SERVE_SLOTS * len(CONTEXT_PROMPTS),
            "batch": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
            "prompt_lengths": list(CONTEXT_PROMPTS),
            "new_tokens": SERVE_NEW,
            "path": "Model.prefill with the context, then greedy "
                    "Model.decode_step (Engine refuses these families)",
            "all_logits_finite": finite,
            "prefill_ms_by_prompt_length": {
                str(n): {"tokens": c["tokens"], "batch": c["batch"],
                         "ms": c["ms"]}
                for n, c in zip(CONTEXT_PROMPTS, prefills)},
            "expected_launches_per_prefill": per_prefill,
            "launches_per_prefill": [
                {k: c["launches"][k] for k in per_prefill}
                for c in prefills],
            "prefills_with_wrong_launches": len(bad_prefill),
            "decode_steps": len(decodes),
            "decode_steps_launching_a_kernel": len(bad_decode),
            "launches_in_run": {k: sum(c["launches"][k] for c in
                                       prefills + decodes)
                                for k in per_prefill},
            "decode_step_ms_4_slots_median": float(np.median(step_ms)),
            "decode_step_ms_4_slots_min": min(step_ms),
            "run_seconds": run_s, "tokens_generated": n_tok,
            "tokens_per_s": n_tok / run_s, "peak_memory_gb": peak_gb,
            "decode_vs_teacher_forced_prefill": tf,
            "flash_attention_served_shapes": served, "profiled": profiled,
            "ok": bool(ok)}


def lm_context_phases() -> dict:
    """llama-3.2-vision-11b and whisper-large-v3 on the card
    (``CONTEXT_FAMILIES``), each after the previous one is freed: the CPU
    anchor in f32 cut in depth (``context_cpu_anchor``), the serving
    traffic at full width and depth in bf16 (``serve_context_family``),
    and the attention kernel at every form the two archs launch it in
    (the VLM's causal self shape, GQA 32/8, and its cross shape over 1600
    patch tokens at the buckets' lengths; whisper's non-causal encoder
    over 1500 frames, its causal decoder self shape and its cross shape
    over 1500 frames at the buckets' lengths: ``context_attention_rows``;
    and at the served shapes, batch 4, on the served prefills' inputs:
    ``served_attention_rows``) held to the plain version under the bf16
    rule and timed beside SDPA and the bound.  One ``lm_context_families`` line an arch, then the
    phase's seconds.  Returns each arch's attention launches and times for
    the ``kernels`` line."""
    import gc

    import torch

    from repro_torch.configs import get

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    entries, failed = {}, []
    for arch, cut in CONTEXT_FAMILIES:
        t_arch = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        full = get(arch)
        anchor = context_cpu_anchor(
            full.replace(compute_dtype="float32", **cut), dev)
        line = serve_context_family(full, dev)
        served = line["flash_attention_served_shapes"]
        if full.family == "vlm":
            rows = (context_attention_rows(full, dev, gen, "self", None,
                                           True, FAMILY_BUCKETS)
                    + context_attention_rows(full, dev, gen, "cross",
                                             full.n_img_tokens, False,
                                             FAMILY_BUCKETS))
        else:
            rows = (context_attention_rows(full, dev, gen, "encoder", None,
                                           False, (full.n_frames,))
                    + context_attention_rows(full, dev, gen, "self", None,
                                             True, FAMILY_BUCKETS)
                    + context_attention_rows(full, dev, gen, "cross",
                                             full.n_frames, False,
                                             FAMILY_BUCKETS))
        timing = {"shape": [1, full.n_heads, full.n_kv_heads, "L | Lkv",
                            full.hd],
                  "dtype": "bfloat16", "by_shape": rows,
                  "mean": mean_row(rows)}
        line = {"phase": "lm_context_families", "model": arch,
                "configured_layers": full.n_layers,
                "cut": "none: full width and depth (the CPU anchor: "
                       + ", ".join(f"{k}={v}" for k, v in cut.items())
                       + ", f32)",
                **line, "flash_attention_new_forms": timing,
                "cpu_anchor": anchor}
        line["seconds"] = time.perf_counter() - t_arch
        line["ok"] = bool(line["ok"] and anchor["ok"]
                          and all(r["ok"] for r in rows))
        emit(line)
        if not line["ok"]:
            failed.append(arch)
        entries[arch] = {
            "launches": line["launches_in_run"]["flash_attention"],
            "launches_per_prefill":
                line["expected_launches_per_prefill"]["flash_attention"],
            "shape": timing["shape"], **timing["mean"],
            "max_abs_err": max(r["max_abs_err"] for r in rows + served),
            "by_shape": rows, "served_shapes": served}
    emit({"phase": "lm_context_families_seconds",
          "seconds": time.perf_counter() - t_phase})
    if failed:
        raise SystemExit(f"the cross-attention families failed on the card: "
                         f"{failed}")
    return entries


def matmul_phases(cuda_ms, params) -> dict:
    """The float -> int rewrite's GEMM: the matmul kernel against its plain
    version on the card (``matmul_vs_plain``), ``quantized_matmul`` at
    zamba2-1.2b's full-width GEMMs with the launches read around each call
    (``quantized_matmul``, the slice's main path), and the kernel's times
    beside its bound and the library's (``matmul_times``).  ``params`` are
    the seeded model's; the weights are layer 0's leaves.  Returns the
    kernel's entry of the ``kernels`` line."""
    import numpy as np
    import torch

    from repro_torch.core import quantize, quantized_matmul
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tiled_matmul as mm_mod

    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(14)
    weights = {   # name: (leaf, K, N)
        "mamba2_in_proj": params["blocks"]["0_mamba2"]["ssm"]["in_proj"][0],
        "mamba2_out_proj": params["blocks"]["0_mamba2"]["ssm"]["out_proj"][0],
        "shared_mlp_wo": params["shared"]["mlp"]["wo"],
        "head": params["embed"]["unembed"],
    }
    ROWS = (999, 4)     # the 1000-token prefill; a decode step of 4 slots

    def normal(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev, dtype)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-128, 128, shape)
                                .astype(np.int8)).to(dev)

    # --- matmul_vs_plain ------------------------------------------------
    # int8: bit-exact with the plain version on the card (float64 products,
    # exact below 2^53) and, where small enough, on the CPU (int64).
    # Floats: the kernel's f32 sums (the f32 output, or out_dtype=f32 for
    # bf16 / f16 operands), their largest error against a float64 product
    # relative to |x| @ |y| within twice the plain f32 product's own; a
    # bf16 / f16 output is its f32 sum rounded once to nearest even.  Those
    # two bound a bf16 / f16 output to one output ulp of the plain version
    # plus 3x the plain's f32 error; the elements past one ulp, outputs
    # that cancel to near 0, where the two f32 sums differ by more than the
    # ulp, are counted.
    # int8 runs in two forms (mm_mod.plan: decode for M <= 16, tile
    # above); the sweep crosses both with K and N on and off the 16-byte
    # load path and ragged column strips, and the extremes fill the int32
    # accumulator: K = 131071 of -128 x -128 (2^31 - 16384) or 127 x -128.
    checks = []
    odd = [(33, 129, 65), (100, 70, 50), (37, 1, 45), (4, 2048, 8384)]
    full = [(m, w.shape[0], w.shape[1]) for w in weights.values()
            for m in ROWS]
    sweep = [(m, k, n) for m in (1, 4, 16, 17, 128, 129)
             for k in (1, 31, 32, 33, 129, 2048, 8192) for n in (130, 272)]
    for m, k, n in odd + full + sweep:
        x, y = ints(m, k), ints(k, n)
        got = mm_mod.tiled_matmul(x, y)
        torch.cuda.synchronize()
        same = torch.equal(got, ref.tiled_matmul(x, y))
        c = {"kernel": "tiled_matmul", "dtype": "int8", "shape": [m, k, n],
             "form": mm_mod.plan(m, n, k).form,
             "bit_exact_vs_card_plain": same}
        if m * k * n <= 10 ** 8:
            same_cpu = torch.equal(got.cpu(), ref.tiled_matmul(x.cpu(),
                                                               y.cpu()))
            c["bit_exact_vs_cpu_plain"] = same_cpu
            same = same and same_cpu
        checks.append({**c, "max_abs_err": 0.0 if same else float(
            (got.double() - ref.tiled_matmul(x, y).double()).abs().max()),
            "ok": same})
    for m in (4, 33):
        for vx, vy in ((-128, -128), (127, -128)):
            k, n = 131071, 5
            x = torch.full((m, k), vx, dtype=torch.int8, device=dev)
            y = torch.full((k, n), vy, dtype=torch.int8, device=dev)
            got = mm_mod.tiled_matmul(x, y)
            torch.cuda.synchronize()
            same = (torch.equal(got, ref.tiled_matmul(x, y))
                    and int(got[0, 0]) == k * vx * vy)
            checks.append({"kernel": "tiled_matmul", "dtype": "int8",
                           "shape": [m, k, n], "extreme": [vx, vy],
                           "form": mm_mod.plan(m, n, k).form,
                           "sum": int(got[0, 0]),
                           "bit_exact_vs_card_plain": same,
                           "max_abs_err": 0.0 if same else float("inf"),
                           "ok": same})
    for m, k, n in [(32, 48, 16)] + odd:
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
        y = torch.from_numpy((rng.normal(size=(k, n)) * 0.02)
                             .astype(np.float32))
        got = quantized_matmul(x.to(dev), y.to(dev))
        same = torch.equal(got.cpu(), quantized_matmul(x, y))
        checks.append({"kernel": "quantized_matmul", "shape": [m, k, n],
                       "bit_exact_vs_cpu": same, "ok": same})
    float_err, f32 = 0.0, torch.float32

    def float_check(x, y, **tags):
        nonlocal float_err
        dt = x.dtype
        (m, k), n = x.shape, y.shape[1]
        got = mm_mod.tiled_matmul(x, y)
        want = ref.tiled_matmul(x, y)
        k32 = got if dt == f32 else mm_mod.tiled_matmul(x, y,
                                                        out_dtype=f32)
        p32 = want if dt == f32 else ref.tiled_matmul(x, y,
                                                      out_dtype=f32)
        x64, y64 = x.double(), y.double()
        exact = x64 @ y64
        scale = (x64.abs() @ y64.abs()).clamp_min(1e-300)
        e_k = float(((k32.double() - exact).abs() / scale).max())
        e_p = float(((p32.double() - exact).abs() / scale).max())
        g, w = got.double(), want.double()
        err = float((g - w).abs().max())
        c = {"kernel": "tiled_matmul", "dtype": str(dt)[6:],
             "shape": [m, k, n], **tags, "max_abs_err_vs_plain": err,
             "f32_sum_rel_err_vs_f64": e_k,
             "plain_f32_sum_rel_err_vs_f64": e_p,
             "ratio_to_plain_err": (e_k / e_p if e_p else
                                    0.0 if e_k == 0 else math.inf),
             "tol": "f32 sums within 2x the plain's error vs f64"}
        ok = e_k <= 2.0 * e_p + 1e-12
        if dt != f32:
            mant = 7 if dt == torch.bfloat16 else 10
            mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
            once = torch.equal(got, k32.to(dt))
            c.update(output_is_its_f32_sum_rounded_once=once,
                     elements_beyond_1_output_ulp=int(
                         ((g - w).abs() > ulp).sum()),
                     elements=g.numel())
            c["tol"] += "; output = its f32 sum rounded to nearest even"
            ok = ok and once
        c["ok"] = ok
        float_err = max(float_err, err)
        checks.append(c)

    for dt in (f32, torch.bfloat16, torch.float16):
        for m, k, n in odd + [(999, 2048, 8384)]:
            float_check(normal(m, k, dtype=dt), normal(k, n, dtype=dt))
    # bf16 / f16 run on the tensor cores (wgmma, chains of
    # mm_mod.F16_CHAIN_K k): the int8 sweep's shapes, and zamba2's
    # full-width GEMMs on the model's own layer-0 weights
    for dt in (torch.bfloat16, torch.float16):
        for m, k, n in sweep:
            float_check(normal(m, k, dtype=dt), normal(k, n, dtype=dt),
                        case="sweep")
        for name, w in weights.items():
            for m in ROWS:
                float_check(normal(m, w.shape[0], dtype=dt), w.to(dt),
                            case=name)
    emit({"phase": "matmul_vs_plain", "f16_chain_k": mm_mod.F16_CHAIN_K,
          "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise SystemExit(f"matmul kernel checks failed: {bad}")

    # --- quantized_matmul: the main path at zamba2-1.2b's GEMMs ------------
    rows, launches = [], 0
    for name, w in weights.items():
        K, N = w.shape
        w32 = w.float()
        for m in ROWS:
            x = normal(m, K)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            out = quantized_matmul(x, w32)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            launches += counts["tiled_matmul"]
            qx, qw = quantize(x), quantize(w32)
            plain = (ref.tiled_matmul(qx.values, qw.values).float()
                     * (qx.scale * qw.scale))
            exact = x @ w32
            rows.append({
                "gemm": name, "shape": [m, K, N], "launches": counts,
                "bit_exact_vs_plain": torch.equal(out, plain),
                "finite": bool(torch.isfinite(out).all()),
                "rel_err_vs_f32_product": float(
                    (out - exact).abs().max() / exact.abs().max()),
                "ms": cuda_ms(lambda: quantized_matmul(x, w32), reps=5)})
    emit({"phase": "quantized_matmul", "model": "zamba2-1.2b",
          "weights": "layer 0's leaves of the model drawn from seed 0 (bf16,"
                     " upcast to f32); activations seeded normals",
          "rows": rows})
    want_counts = {k: 0 for k in ops.launch_counts()} | {"tiled_matmul": 1}
    bad = [r for r in rows if r["launches"] != want_counts
           or not r["bit_exact_vs_plain"] or not r["finite"]]
    if bad:
        raise SystemExit(f"quantized_matmul failed: {bad}")

    # --- matmul_times -------------------------------------------------------
    # Every time is the device time of one call, the least of 10
    # (`device_ms`), for the kernel, its plain version (3) and the library
    # call alike.  int8: the bound is the larger of each operand read once
    # and the int32 product written once, and 2MNK operations at the int8
    # tensor-core rate; the library call is torch._int_mm (it needs M > 16
    # and K, N multiples of 8, so none at M = 4); beside them the form the
    # C entry takes, its registers, shared memory and blocks an SM, and the
    # kernel's TOPS.  At in_proj, M = 999, ten calls of the kernel and of
    # torch._int_mm are traced (their device kernels by name), and at
    # M = 4 and 16 ten of the kernel (its decode form and the memset
    # before it; M sets the decode form's atomics, not its reads).
    # The timer's floor is the device time of one launch of a one-element
    # fill.  bf16 / f16 at every GEMM and M (the wgmma kernel, on the
    # model's layer-0 weights): torch.mm beside them, the bf16 tensor-core
    # rate, the C entry's tile, chain, grid, registers and shared memory,
    # TFLOP/s; at in_proj ten calls of the kernel and of torch.mm traced,
    # the kernel's launch (grid, block, registers, shared memory as the
    # profiler records them) held to the attribute query.  f32 at in_proj:
    # torch.mm (TF32 off) and the f32 rate.
    times, int8_traced = [], {}
    one = torch.zeros(1, device=dev)
    timer_floor_ms = device_ms(lambda: one.fill_(1.0))
    for name, w in weights.items():
        K, N = w.shape
        for m in ROWS:
            x, y = ints(m, K), ints(K, N)
            b, by = bound_ms(m * K + K * N + 4 * m * N, 2.0 * m * N * K,
                             INT8_OPS_PER_S)
            row = {"gemm": name, "dtype": "int8", "shape": [m, K, N],
                   "ms": device_ms(lambda: mm_mod.tiled_matmul(x, y)),
                   "plain_ms": device_ms(lambda: ref.tiled_matmul(x, y),
                                         n=3),
                   "library_ms": (device_ms(lambda: torch._int_mm(x, y))
                                  if m > 16 else None),
                   "library": "torch._int_mm" if m > 16 else "none",
                   "bound_ms": b, "bound_by": by,
                   **mm_mod.int8_kernel_attributes(m, N, K)}
            row["tops"] = 2.0 * m * N * K / row["ms"] / 1e9
            times.append(row)
            if name == "mamba2_in_proj":
                int8_traced[f"M={m}"] = {
                    "shape": [m, K, N],
                    "kernel": traced(lambda: mm_mod.tiled_matmul(x, y),
                                     f"int8_mm_kernel_{m}")}
                if m > 16:
                    int8_traced[f"M={m}"]["int_mm"] = traced(
                        lambda: torch._int_mm(x, y), f"int8_mm_int_mm_{m}")
    K, N = weights["mamba2_in_proj"].shape
    x, y = ints(16, K), ints(K, N)
    int8_traced["M=16"] = {"shape": [16, K, N], "kernel": traced(
        lambda: mm_mod.tiled_matmul(x, y), "int8_mm_kernel_16")}
    def launch_seen(trace_name):
        """The wgmma kernel's launches in a trace that ``traced`` wrote:
        grid blocks, threads, registers and dynamic shared memory, as the
        profiler recorded them (None where it records none)."""
        path = ROOT / "build" / f"trace_{trace_name}.json"
        seen = set()
        for e in json.loads(path.read_text())["traceEvents"]:
            a = e.get("args", {})
            if e.get("cat") == "kernel" and "wg::mma_kernel" in e["name"]:
                seen.add((math.prod(a["grid"]) if "grid" in a else None,
                          math.prod(a["block"]) if "block" in a else None,
                          a.get("registers per thread"),
                          a.get("dynamic shared memory",
                                a.get("shared memory"))))
        return [list(v) for v in sorted(seen, key=str)]

    f16_traced, bad = {}, []
    for dt in (torch.bfloat16, torch.float16):
        for name, w in weights.items():
            K, N = w.shape
            for m in ROWS:
                x, y = normal(m, K, dtype=dt), w.to(dt)
                b, by = bound_ms(2 * (m * K + K * N + m * N),
                                 2.0 * m * N * K, BF16_FLOPS_PER_S)
                row = {"gemm": name, "dtype": str(dt)[6:],
                       "shape": [m, K, N],
                       "ms": device_ms(lambda: mm_mod.tiled_matmul(x, y)),
                       "plain_ms": device_ms(
                           lambda: ref.tiled_matmul(x, y), n=3),
                       "library_ms": device_ms(lambda: torch.mm(x, y)),
                       "library": "torch.mm", "bound_ms": b, "bound_by": by,
                       **mm_mod.f16_kernel_attributes(m, N, K)}
                row["tflops"] = 2.0 * m * N * K / row["ms"] / 1e9
                times.append(row)
                if name != "mamba2_in_proj":
                    continue
                key = f"{row['dtype']} M={m}"
                f16_traced[key] = {
                    "shape": [m, K, N],
                    "kernel": traced(lambda: mm_mod.tiled_matmul(x, y),
                                     f"f16_mm_kernel_{key[:4]}_{m}"),
                    "torch_mm": traced(lambda: torch.mm(x, y),
                                       f"f16_mm_torch_mm_{key[:4]}_{m}"),
                    "launches_seen": launch_seen(
                        f"f16_mm_kernel_{key[:4]}_{m}")}
                want = [row["grid_blocks"], row["threads_per_block"],
                        row["registers_per_thread"],
                        row["smem_bytes_per_block"]]
                if any(v != want for v in f16_traced[key]["launches_seen"]
                       if None not in v) or not f16_traced[key][
                           "launches_seen"]:
                    bad.append(key)
    K, N = weights["mamba2_in_proj"].shape
    x, y = normal(999, K), normal(K, N)
    b, by = bound_ms(4 * (999 * K + K * N + 999 * N), 2.0 * 999 * N * K,
                     F32_FLOPS_PER_S)
    times.append({
        "gemm": "mamba2_in_proj", "dtype": "float32", "shape": [999, K, N],
        "ms": device_ms(lambda: ops.tiled_matmul(x, y)),
        "plain_ms": device_ms(lambda: ref.tiled_matmul(x, y), n=3),
        "library_ms": device_ms(lambda: torch.mm(x, y)),
        "library": "torch.mm", "bound_ms": b, "bound_by": by})
    emit({"phase": "matmul_times", "note": "device ms of one launch, the "
          "least of 10 (the plain version's of 3); the plain version "
          "multiplies int8 in float64 and floats in f32 (TF32 off)",
          "timer_floor_ms": timer_floor_ms, "rows": times,
          "int8_traced": int8_traced, "f16_traced": f16_traced})
    if bad:
        raise SystemExit(f"the bf16 / f16 launch differs from its attribute "
                         f"query: {bad}")
    main = times[0]     # int8 at in_proj, M = 999: the 1000-token prefill
    return {"name": "tiled_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tiled_matmul.cu",
            "replaces": "src/repro/kernels/tiled_matmul.py:57",
            "path": "quantized_matmul", "launches": launches,
            "form": main["form"],
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c.get("dtype") == "int8"),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "float_max_abs_err_vs_plain": float_err,
            "by_shape": [{k: r[k] for k in ("gemm", "dtype", "shape", "ms",
                                             "bound_ms", "library_ms")}
                         for r in times]}


SERVICE_BUCKETS = ((240, 320), (480, 640), (720, 1280))
SERVICE_TICK_S = 1.0 / 30.0   # the camera's frame period (virtual clock)
SERVICE_COUNTERS = (
    "dispatches", "completed", "rejected_queue_full", "shed_deadline",
    "completed_late", "downshifted", "pre_downshifted", "served_downshift",
    "served_coast", "gated_dispatches", "fused_dispatches", "evicted",
    "rejected_invalid", "dispatch_faults", "stager_deaths")


def recorded_service():
    """``DetectionService``, keeping every batch it retires (what ran, on
    the device, and for which requests) in ``retired``."""
    from repro_torch.serve import DetectionService

    class Recorded(DetectionService):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.retired = []

        def _complete(self, grid, *, update_est=True):
            if grid.in_flight is not None:
                self.retired.append(grid.in_flight)
            super()._complete(grid, update_est=update_est)

    return Recorded


def against_plan(records):
    """Each DONE request of each retired batch against the batch run again
    through its plan on the card: (checked, differing uids)."""
    import torch

    from repro_torch.serve import RequestStatus

    checked, bad = 0, []
    for rec in records:
        again = rec.plan.run(rec.images, rec.theta_bins, rec.corridors)
        for i, req in enumerate(rec.reqs):
            if req is None or req.status is not RequestStatus.DONE:
                continue
            h, w = req.frame.shape[:2]
            checked += 1
            if not (torch.equal(req.result.peaks, again.peaks[i])
                    and torch.equal(req.result.valid, again.valid[i])
                    and torch.equal(req.result.edges,
                                    again.edges[i][:h, :w])):
                bad.append(req.uid)
    return checked, bad


def latency_by_bucket(bucket_for, reqs) -> dict:
    """Latency p50 / p99 (ms) of the served requests of each bucket."""
    import numpy as np

    out = {}
    for shape in SERVICE_BUCKETS:
        lat = [r.latency_s * 1e3 for r in reqs
               if r.served and bucket_for(r.frame) == shape]
        out[f"{shape[0]}x{shape[1]}"] = {
            "served": len(lat),
            "p50_ms": float(np.percentile(lat, 50)) if lat else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat else None}
    return out


def statuses(reqs) -> dict:
    out = {}
    for r in reqs:
        out[r.status.name] = out.get(r.status.name, 0) + 1
    return out


@contextlib.contextmanager
def swapped(module, name: str, value):
    """``module.name`` replaced by ``value`` inside the block."""
    own = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, own)


def service_phases() -> dict:
    """The detector's serving path on the card: ``DetectionService``
    (``serve/detection.py``) with buckets 240x320, 480x640 and 720x1280
    (``DEPLOY_HW``), 4 slots a bucket, ``max_edges="auto"`` compaction,
    the default steering and camera, a 40-bin union theta gate; once
    staged and once with ``fused_corridors=8``.  The traffic: two
    sessions, each the 32-frame "converging" drive cycle at 720x1280,
    interleaved frame by frame, and 16 one-off frames (the 8 families at
    240x320 and at 480x640), each request with the paper's 300 ms
    deadline; the service steps once a camera tick.

    For each configuration:

      * on the real clock, after a warm-up (one request a bucket, then a
        10-frame session that engages the gated and fused plans), the
        traffic offered as fast as the service steps, the launch counts
        zeroed just before it and read just after: latency p50 / p99 a
        bucket, misses at 300 ms, frames/s.  Every dispatch of the
        traffic is warm, so the service ran it under
        ``set_sync_debug_mode("error")``; a hidden host sync raises;
      * every batch the service dispatched is run again through its
        ``DetectionPlan`` on the card: each DONE request's peaks, validity
        and edges equal bit for bit;
      * the device time of one warm dispatch for each bucket and path
        (CUDA events), and the traffic again under the profiler
        (``gpu_trace``): GPU activities a dispatch, device-busy share;
      * the traffic on a ``VirtualClock`` (a tick a step, each batch
        drained before the next tick) on the card and with
        ``device="cpu"``: the same statuses, dispatch log, counters,
        session tracks, steering commands and results.

    Then a fault pass on the card (virtual clock, prefetch on, RGB
    frames): a prefetch worker killed mid-stream, a failed dispatch, a
    stalled dispatch and two NaN frames; every request must end in a
    terminal status within a timeout.  Any failure raises.  Returns each
    configuration's launch counts for the ``kernels`` line."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from repro_torch.configs.paper_lines import DEPLOY_HW, REALTIME_BUDGET_S
    from repro_torch.core import ControlConfig, HoughConfig, PipelineConfig
    from repro_torch.data import make_drive_cycle, scenario_batch
    from repro_torch.kernels import ops
    from repro_torch.runtime import ServiceFaultInjector
    from repro_torch.serve import DetectionRequest, VirtualClock

    H, W = DEPLOY_HW
    assert SERVICE_BUCKETS[-1] == DEPLOY_HW
    cfg = PipelineConfig(hough=HoughConfig(compact=True, max_edges="auto"))
    cycle = make_drive_cycle("converging", 32, H, W, seed=0).images()
    small = [scenario_batch(MAIN_FAMILIES, h, w, seed=2 + j)[0]
             for j, (h, w) in enumerate(SERVICE_BUCKETS[:2])]
    one_offs = [small[t % 2][t // 2] for t in range(16)]

    Recorded = recorded_service()

    def make(fused, clock, device=None, **kw):
        return Recorded(cfg, buckets=SERVICE_BUCKETS, batch_size=4,
                        clock=clock, gate_band=40,
                        fused_corridors=8 if fused else None,
                        steering=ControlConfig(), device=device, **kw)

    def traffic(svc, clock, sessions=("cam0", "cam1"), uid0=0):
        reqs = []
        for t in range(32):
            arrivals = [(cycle[t], sid) for sid in sessions]
            if t < len(one_offs):
                arrivals.append((one_offs[t], None))
            for frame, sid in arrivals:
                r = DetectionRequest(uid=uid0 + len(reqs), frame=frame,
                                     deadline_s=REALTIME_BUDGET_S,
                                     session_id=sid)
                svc.submit(r)
                reqs.append(r)
            svc.step()
            if isinstance(clock, VirtualClock):
                clock.advance(SERVICE_TICK_S)
                svc.drain()
        svc.run()
        return reqs

    def counters(svc):
        return {k: getattr(svc, k) for k in SERVICE_COUNTERS}

    def path_of(rec):
        c = rec.plan.cfg
        return ("fused" if c.fused else
                "gated" if c.hough.theta_band is not None else "full")

    # the hot-loop guard is live: a host sync inside it raises
    from repro_torch.serve import detection as det_mod

    try:
        with det_mod._no_host_sync(torch.device("cuda", 0)):
            torch.ones(1, device="cuda").item()
        guard_raises = False
    except RuntimeError:
        guard_raises = True
    failures = [] if guard_raises else ["sync_guard"]
    launches = {}
    for name, fused in (("staged", False), ("fused", True)):
        # --- the real clock: warm up, then the timed traffic
        svc = make(fused, time.perf_counter)
        for frame in (one_offs[0], one_offs[1], cycle[0]):
            svc.submit(DetectionRequest(uid=-1, frame=frame))
            svc.run()
        for t in range(10):
            svc.submit(DetectionRequest(uid=-1, frame=cycle[t],
                                        session_id="warm"))
            svc.run()
        svc.end_session("warm")
        warmed = set(svc._warmed)
        before = counters(svc)
        n_log, n_retired = len(svc.dispatch_log), len(svc.retired)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = traffic(svc, time.perf_counter)
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        log = [[f"{s[0]}x{s[1]}", n] for s, n, _ in
               list(svc.dispatch_log)[n_log:]]
        launches[name] = counts
        after = counters(svc)
        delta = {k: after[k] - before[k] for k in SERVICE_COUNTERS}
        records = svc.retired[n_retired:]
        all_warm = svc._warmed == warmed
        d, f = delta["dispatches"], delta["fused_dispatches"]
        want_counts = {k: 0 for k in counts}
        want_counts.update(conv2d_gemm=2 * (d - f), hough_vote=d,
                           fused_detect=f)
        served = sum(r.served for r in reqs)
        terminal = all(r.is_terminal for r in reqs)
        checked, differ = against_plan(records)
        # device time of one warm dispatch per bucket and path
        dispatch_ms = {}
        for rec in records:
            key = f"{rec.plan.height}x{rec.plan.width}/{path_of(rec)}"
            if key not in dispatch_ms:
                # behind a ~30 ms spin: a staged dispatch makes hundreds
                # of launches, whose host time the spin must hide
                dispatch_ms[key] = device_ms(
                    lambda rec=rec: rec.plan.run(rec.images, rec.theta_bins,
                                                 rec.corridors),
                    n=5, spin=60_000_000)
        # the same traffic on fresh sessions under the profiler
        d0 = svc.dispatches
        tr = gpu_trace(lambda: traffic(svc, time.perf_counter,
                                       sessions=("cam2", "cam3"),
                                       uid0=1000),
                       f"detection_service_{name}", 1)
        traced_dispatches = svc.dispatches - d0
        svc.close()
        # --- the virtual clock: the card against the CPU
        runs = {}
        for where, device in (("card", None), ("cpu", "cpu")):
            clock = VirtualClock()
            vsvc = make(fused, clock, device)
            t1 = time.perf_counter()
            vreqs = traffic(vsvc, clock)
            vsvc.close()
            runs[where] = (vsvc, vreqs, time.perf_counter() - t1)
        (csvc, creqs, card_s), (hsvc, hreqs, cpu_s) = runs["card"], runs["cpu"]
        v_checked, v_differ = against_plan(csvc.retired)
        req_differ = []
        lines_err = 0.0
        for a, b in zip(creqs, hreqs):
            same = (a.status is b.status and a.bucket == b.bucket
                    and a.finished_at == b.finished_at
                    and (a.steering is None) == (b.steering is None)
                    and (a.steering is None or tuple(a.steering)
                         == tuple(b.steering))
                    and [dataclasses.astuple(t) for t in a.tracks or ()]
                    == [dataclasses.astuple(t) for t in b.tracks or ()])
            if same and a.result is not None:
                ra = [torch.as_tensor(x).cpu() for x in a.result[:4]]
                rb = [torch.as_tensor(x).cpu() for x in b.result[:4]]
                same = all(torch.equal(x, y) for x, y in zip(ra[1:], rb[1:]))
                lines_err = max(lines_err,
                                (ra[0] - rb[0]).abs().max().item())
            if not same:
                req_differ.append(a.uid)
        virtual = {
            "statuses": statuses(creqs),
            "dispatch_log": [[f"{s[0]}x{s[1]}", n] for s, n, _ in
                             csvc.dispatch_log],
            "counters": counters(csvc),
            "counters_equal_cpu": counters(csvc) == counters(hsvc),
            "dispatch_log_equal_cpu": (list(csvc.dispatch_log)
                                       == list(hsvc.dispatch_log)),
            "requests_differing_from_cpu": req_differ,
            "lines_max_abs_err_vs_cpu": lines_err,
            "done_checked_against_plan_run": v_checked,
            "done_differing_from_plan_run": v_differ,
            "card_s": card_s, "cpu_s": cpu_s}
        ok = (terminal and not differ and not v_differ and counts
              == want_counts and min(counts["hough_vote"],
                                     counts["conv2d_gemm"]) > 0
              and (not fused or counts["fused_detect"] > 0)
              and all(r.is_terminal for r in creqs + hreqs)
              and virtual["counters_equal_cpu"]
              and virtual["dispatch_log_equal_cpu"] and not req_differ
              and lines_err < 1e-2)
        emit({"phase": "detection_service", "config": name,
              "buckets": [list(b) for b in SERVICE_BUCKETS], "batch": 4,
              "gate_band": 40, "fused_corridors": 8 if fused else None,
              "deadline_s": REALTIME_BUDGET_S,
              "requests": len(reqs), "statuses": statuses(reqs),
              "all_terminal": terminal, "counters": delta,
              "dispatch_log": log,
              "every_dispatch_warm_and_guarded": all_warm,
              "sync_debug_mode_on_warm_dispatches": "error",
              "guard_raises_on_a_host_sync": guard_raises,
              "wall_s": wall_s, "frames_per_s": served / wall_s,
              "misses_at_deadline": sum(r.missed_deadline for r in reqs),
              "latency_ms_by_bucket": latency_by_bucket(svc.bucket_for,
                                                        reqs),
              "launches": counts, "launches_expected": want_counts,
              "done_checked_against_plan_run": checked,
              "done_differing_from_plan_run": differ,
              "dispatch_device_ms": dispatch_ms,
              "traced": {"dispatches": traced_dispatches,
                         "gpu_activities": tr["gpu_activities"],
                         "gpu_activities_per_dispatch":
                             tr["gpu_activities"] / max(traced_dispatches, 1),
                         "device_busy_ms": tr["device_busy_ms"],
                         "device_span_ms": tr["device_span_ms"],
                         "device_busy_share_of_span":
                             tr["device_busy_share_of_span"],
                         "traced_wall_ms": tr["traced_wall_ms"],
                         "whole": tr["whole"], "top": tr["top"][:8],
                         "trace": tr["trace"]},
              "virtual_clock": virtual, "ok": ok})
        if not ok:
            failures.append(name)

    # --- the fault pass: every request terminal, no wait without a bound
    def fault_pass():
        faults = ServiceFaultInjector(
            kill_stager_at=(2,), fail_dispatch_at=(1,),
            stall_dispatch_at=(3,), corrupt_frame_uids=(3, 7))
        clock = VirtualClock()
        svc = make(False, clock, faults=faults, prefetch=True)
        reqs = []
        for i in range(24):
            rgb = np.repeat(one_offs[i % 16][..., None], 3, axis=2)
            reqs.append(DetectionRequest(uid=i, frame=rgb, deadline_s=0.5))
        for i, r in enumerate(reqs):
            svc.submit(r)
            if i % 4 == 3:
                svc.step()
                clock.advance(SERVICE_TICK_S)
        svc.run()
        svc.close()
        return svc, reqs

    box = {}

    def guarded():
        try:
            box["out"] = fault_pass()
        except BaseException as e:   # re-raised on the main thread
            box["error"] = e

    th = threading.Thread(target=guarded, daemon=True)
    th.start()
    th.join(timeout=300.0)
    if th.is_alive():
        raise SystemExit("detection service fault pass hung (300 s)")
    if "error" in box:
        raise box["error"]
    fsvc, freqs = box["out"]
    fc = counters(fsvc)
    fault_ok = (all(r.is_terminal for r in freqs)
                and fc["dispatch_faults"] == 1 and fc["stager_deaths"] >= 1
                and fc["rejected_invalid"] == 2 and fc["completed_late"] >= 1
                and all(r.served != r.status.refused for r in freqs))
    emit({"phase": "detection_service_faults", "requests": len(freqs),
          "statuses": statuses(freqs), "counters": fc,
          "all_terminal": all(r.is_terminal for r in freqs), "ok": fault_ok})
    if not fault_ok:
        failures.append("faults")
    if failures:
        raise SystemExit(f"detection service checks failed: {failures}")
    return launches


FLEET_TICK_S = 0.02        # the virtual clock's advance a router step
FLEET_REPLICAS = (1, 2, 4)


def fleet_phases() -> dict:
    """The detection fleet on the card: ``ShardedDetectionService``
    (``serve/fleet.py``) over replicas configured as in the service phase
    (buckets 240x320 / 480x640 / 720x1280, batch 4, ``gate_band=40``,
    ``fused_corridors=8``, steering, auto compaction), every replica on
    ``cuda:0`` and its current stream.

      * ``fleet_virtual``: 2 replicas on a ``VirtualClock`` advanced 20 ms
        a router step, on the card and with ``device="cpu"``.  Two
        16-frame 720x1280 sessions ("converging", "rain") interleaved with
        8 one-offs, 300 ms deadlines; replica 0 killed by
        ``kill_replica_at``, armed for the first router step from the
        sixth on where it has a batch in flight; ``add_replica()``, the
        newcomer made the remote; 8 speculative races of 720x1280 frames
        (the local tier at 240x320) on
        ``NetworkConfig(seed=0, rtt_median_s=0.03, jitter_sigma=0.5,
        loss=0.1)``, race 2's uplink and race 5's downlink forced lost.
        Before each router step the traffic loop waits for every live
        replica's in-flight batch, so each step's reap retires what the
        CPU's does.  Every request terminal; each request's status,
        bucket, downshift, stamps and replica, each session's location
        and tracks, every fleet and replica counter and every race's
        decision equal on the card and the CPU, peaks, validity and edges
        bit for bit; a session's frames on one replica but across the one
        failover; every DONE answer on the card equal to its batch run
        again through its plan.
      * ``fleet``: the service phase's traffic (two interleaved 32-frame
        720x1280 sessions and 16 one-offs, 300 ms deadlines) as fast as
        the fleet steps, on the real clock, at 1, 2 and 4 replicas, after
        every replica's plans are warmed; the launch counts zeroed just
        before the traffic and read just after.  Latency p50 / p99 a
        bucket, misses, frames/s, dispatches a replica; the same traffic
        again on fresh sessions under the profiler (``gpu_trace``): GPU
        activities a dispatch, device-busy share.  Every request
        terminal, every dispatch warm (so run under
        ``set_sync_debug_mode("error")``), every DONE answer equal to its
        batch run again through its plan, each session on one replica.

    Any failure raises.  Returns each run's launch counts for the
    ``kernels`` line."""
    import dataclasses

    import torch

    from repro_torch.configs.paper_lines import DEPLOY_HW, REALTIME_BUDGET_S
    from repro_torch.core import ControlConfig, HoughConfig, PipelineConfig
    from repro_torch.core.network import NetworkConfig
    from repro_torch.core.offload import SpeculativeConfig
    from repro_torch.data import make_drive_cycle, scenario_batch
    from repro_torch.kernels import ops
    from repro_torch.runtime import ServiceFaultInjector
    from repro_torch.serve import DetectionRequest, VirtualClock
    from repro_torch.serve import fleet as fleet_mod

    t_phase = time.perf_counter()
    H, W = DEPLOY_HW
    cfg = PipelineConfig(hough=HoughConfig(compact=True, max_edges="auto"))
    small = [scenario_batch(MAIN_FAMILIES, h, w, seed=2 + j)[0]
             for j, (h, w) in enumerate(SERVICE_BUCKETS[:2])]
    one_offs = [small[t % 2][t // 2] for t in range(16)]
    race_frames = scenario_batch(MAIN_FAMILIES, H, W, seed=0)[0]
    fleet_counters = (
        "routed", "session_migrations", "session_failovers", "requeued",
        "failed_on_death", "speculative_races", "speculative_upgrades",
        "speculative_timeouts", "uplink_lost_total", "downlink_lost_total",
        "scale_up_migrations", "host_kills")
    kw = dict(buckets=SERVICE_BUCKETS, batch_size=4, gate_band=40,
              fused_corridors=8, steering=ControlConfig())

    class Settled(fleet_mod.ShardedDetectionService):
        """The fleet, waiting before each router step for every live
        replica's in-flight batch (the card's counterpart of a CPU result,
        ready once ``run`` returns)."""

        def step(self, **step_kw):
            for rep in self.alive_replicas:
                for g in rep.service.grids.values():
                    if (g.in_flight is not None
                            and g.in_flight.event is not None):
                        g.in_flight.event.synchronize()
            return super().step(**step_kw)

    def ran_on(svc) -> dict:
        """id(request) -> the replica whose batch ran it."""
        return {id(r): rep.index for rep in svc.replicas
                for rec in rep.service.retired for r in rec.reqs
                if r is not None}

    def virtual_run(device):
        cycles = {sid: make_drive_cycle(sid, 16, H, W, seed=0).images()
                  for sid in ("converging", "rain")}
        clock = VirtualClock()
        faults = ServiceFaultInjector(lose_uplink_races=(2,),
                                      lose_downlink_races=(5,))
        svc = Settled(cfg, n_replicas=2, device=device, clock=clock,
                      faults=faults, speculative=SpeculativeConfig(
                          local_shape=SERVICE_BUCKETS[0],
                          network=NetworkConfig(
                              seed=0, rtt_median_s=0.03, jitter_sigma=0.5,
                              loss=0.1)), **kw)
        reqs, kill_step = [], None
        for t in range(16):
            arrivals = [(cycles[sid][t], sid) for sid in cycles]
            if t < 8:
                arrivals.append((one_offs[t], None))
            for frame, sid in arrivals:
                reqs.append(DetectionRequest(
                    uid=len(reqs), frame=frame, session_id=sid,
                    deadline_s=REALTIME_BUDGET_S))
                svc.submit(reqs[-1])
            if kill_step is None and svc._steps >= 6 and any(
                    g.in_flight is not None
                    for g in svc.replicas[0].service.grids.values()):
                kill_step = svc._steps
                faults.kill_replica_at = ((kill_step, 0),)
            svc.step()
            clock.advance(FLEET_TICK_S)
        svc.run()
        svc.remote_replica = svc.add_replica()
        for frame in race_frames:
            reqs.append(DetectionRequest(uid=len(reqs), frame=frame,
                                         deadline_s=REALTIME_BUDGET_S))
            svc.submit_speculative(reqs[-1])
            svc.step()
            clock.advance(FLEET_TICK_S)
        svc.run()
        svc.close()
        return svc, reqs, kill_step

    def request_row(req, where):
        return (req.status.name, req.bucket, req.downshift, req.submitted_at,
                req.finished_at, req.deadline_at, where.get(id(req)))

    failures = []
    launches = {}
    with swapped(fleet_mod, "DetectionService", recorded_service()):
        # --- (a) the virtual clock: the card against the CPU
        runs = {}
        for where, device in (("card", None), ("cpu", "cpu")):
            if device is None:
                torch.cuda.synchronize()
                ops.reset_launch_counts()
            t0 = time.perf_counter()
            runs[where] = (*virtual_run(device), time.perf_counter() - t0)
            if device is None:
                torch.cuda.synchronize()
                launches["virtual"] = ops.launch_counts()
        (gsvc, greqs, gkill, card_s), (csvc, creqs, ckill, cpu_s) = (
            runs["card"], runs["cpu"])
        gwhere, cwhere = ran_on(gsvc), ran_on(csvc)
        # every request and each race's two clones (a remote clone whose
        # uplink was lost never runs: it stays pending, and equal)
        gall = greqs + [r for t in gsvc._tickets for r in (t.local, t.remote)]
        call = creqs + [r for t in csvc._tickets for r in (t.local, t.remote)]
        differ, lines_err = [], 0.0
        for i, (a, b) in enumerate(zip(gall, call)):
            same = (request_row(a, gwhere) == request_row(b, cwhere)
                    and (a.steering is None) == (b.steering is None)
                    and (a.steering is None
                         or tuple(a.steering) == tuple(b.steering))
                    and [dataclasses.astuple(t) for t in a.tracks or ()]
                    == [dataclasses.astuple(t) for t in b.tracks or ()]
                    and (a.result is None) == (b.result is None))
            if same and a.result is not None:
                ra = [torch.as_tensor(x).cpu() for x in a.result[:4]]
                rb = [torch.as_tensor(x).cpu() for x in b.result[:4]]
                same = all(torch.equal(x, y) for x, y in zip(ra[1:], rb[1:]))
                lines_err = max(lines_err,
                                (ra[0] - rb[0]).abs().max().item())
            if not same:
                differ.append(i)
        sessions = {}
        for r in greqs:
            if r.session_id is not None and id(r) in gwhere:
                sessions.setdefault(r.session_id, set()).add(gwhere[id(r)])
        replica_counters = [
            {k: getattr(rep.service, k) for k in SERVICE_COUNTERS}
            for rep in gsvc.replicas]
        equal = {
            "kill_step": gkill == ckill,
            "fleet_counters": (
                {k: getattr(gsvc, k) for k in fleet_counters}
                == {k: getattr(csvc, k) for k in fleet_counters}),
            "replica_counters": replica_counters == [
                {k: getattr(rep.service, k) for k in SERVICE_COUNTERS}
                for rep in csvc.replicas],
            "dispatch_logs": [list(r.service.dispatch_log)
                              for r in gsvc.replicas]
            == [list(r.service.dispatch_log) for r in csvc.replicas],
            "session_locations_and_tracks": all(
                gsvc.session_location(s) == csvc.session_location(s)
                and [dataclasses.astuple(t) for t in gsvc.session_tracks(s)]
                == [dataclasses.astuple(t) for t in csvc.session_tracks(s)]
                for s in ("converging", "rain")),
            "race_decisions": (
                [dataclasses.astuple(t.decision) for t in gsvc._tickets]
                == [dataclasses.astuple(t.decision) for t in csvc._tickets]),
            "requests": not differ,
        }
        checked, plan_differ = against_plan(
            [rec for rep in gsvc.replicas for rec in rep.service.retired])
        d = sum(rep.service.dispatches for rep in gsvc.replicas)
        f = sum(rep.service.fused_dispatches for rep in gsvc.replicas)
        want = {k: 0 for k in launches["virtual"]}
        want.update(conv2d_gemm=2 * (d - f), hough_vote=d, fused_detect=f)
        two_replica_sessions = sum(len(v) > 1 for v in sessions.values())
        ok = (all(equal.values()) and gkill is not None
              and all(r.is_terminal for r in greqs + creqs)
              and all(t.resolved for t in gsvc._tickets)
              and not plan_differ and lines_err < 1e-2
              and launches["virtual"] == want and f > 0
              and two_replica_sessions <= gsvc.session_failovers == 1
              and all(len(v) <= 2 for v in sessions.values()))
        emit({"phase": "fleet_virtual", "replicas": 2, "added": 1,
              "tick_s": FLEET_TICK_S, "deadline_s": REALTIME_BUDGET_S,
              "kill_step": gkill, "requests": len(greqs),
              "statuses": statuses(greqs),
              "counters": {k: getattr(gsvc, k) for k in fleet_counters},
              "replica_counters": replica_counters,
              "sessions_replicas": {s: sorted(v)
                                    for s, v in sessions.items()},
              "races": [{"decision": dataclasses.asdict(t.decision),
                         "uplink_lost": t.uplink.lost,
                         "downlink_lost": t.downlink.lost}
                        for t in gsvc._tickets],
              "equal_card_cpu": equal, "requests_differing": differ,
              "lines_max_abs_err_vs_cpu": lines_err,
              "done_checked_against_plan_run": checked,
              "done_differing_from_plan_run": plan_differ,
              "launches": launches["virtual"], "launches_expected": want,
              "card_s": card_s, "cpu_s": cpu_s, "ok": ok})
        if not ok:
            failures.append("virtual")
        del runs, gsvc, csvc, gall, call

        # --- (b) the real clock, the card alone, at 1, 2 and 4 replicas
        cycle = make_drive_cycle("converging", 32, H, W, seed=0).images()

        def traffic(svc, sessions, uid0):
            reqs = []
            for t in range(32):
                arrivals = [(cycle[t], sid) for sid in sessions]
                if t < len(one_offs):
                    arrivals.append((one_offs[t], None))
                for frame, sid in arrivals:
                    reqs.append(DetectionRequest(
                        uid=uid0 + len(reqs), frame=frame, session_id=sid,
                        deadline_s=REALTIME_BUDGET_S))
                    svc.submit(reqs[-1])
                svc.step()
            svc.run()
            return reqs

        for n in FLEET_REPLICAS:
            svc = fleet_mod.ShardedDetectionService(cfg, n_replicas=n, **kw)
            for rep in svc.replicas:
                # every plan of every replica built and run once
                s = rep.service
                for frame in (one_offs[0], one_offs[1], cycle[0]):
                    s.submit(DetectionRequest(uid=-1, frame=frame))
                    s.run()
                for t in range(10):
                    s.submit(DetectionRequest(uid=-1, frame=cycle[t],
                                              session_id="warm"))
                    s.run()
                s.end_session("warm")
            warmed = [set(r.service._warmed) for r in svc.replicas]
            d0 = [r.service.dispatches for r in svc.replicas]
            f0 = [r.service.fused_dispatches for r in svc.replicas]
            n_ret = [len(r.service.retired) for r in svc.replicas]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            reqs = traffic(svc, ("cam0", "cam1"), 0)
            wall_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            launches[f"{n}_replicas"] = counts
            per_rep = [r.service.dispatches - d for r, d in
                       zip(svc.replicas, d0)]
            fused = sum(r.service.fused_dispatches - f for r, f in
                        zip(svc.replicas, f0))
            records = [rec for r, k in zip(svc.replicas, n_ret)
                       for rec in r.service.retired[k:]]
            checked, plan_differ = against_plan(records)
            where = {id(q): r.index for r, k in zip(svc.replicas, n_ret)
                     for rec in r.service.retired[k:] for q in rec.reqs
                     if q is not None}
            on = {sid: sorted({where[id(q)] for q in reqs
                               if q.session_id == sid and id(q) in where})
                  for sid in ("cam0", "cam1")}
            all_warm = [set(r.service._warmed) for r in svc.replicas] == warmed
            want = {k: 0 for k in counts}
            want.update(conv2d_gemm=2 * (sum(per_rep) - fused),
                        hough_vote=sum(per_rep), fused_detect=fused)
            # the same traffic on fresh sessions under the profiler
            dt0 = svc.dispatches
            tr = gpu_trace(lambda: traffic(svc, ("cam2", "cam3"), 1000),
                           f"fleet_{n}_replicas", 1)
            traced_dispatches = svc.dispatches - dt0
            svc.close()
            served = sum(r.served for r in reqs)
            ok = (all(r.is_terminal for r in reqs) and not plan_differ
                  and checked > 0 and all_warm and counts == want
                  and all(len(v) == 1 for v in on.values())
                  and svc.session_migrations == svc.session_failovers == 0)
            emit({"phase": "fleet", "replicas": n, "device": "cuda:0",
                  "requests": len(reqs), "statuses": statuses(reqs),
                  "all_terminal": all(r.is_terminal for r in reqs),
                  "wall_s": wall_s, "frames_per_s": served / wall_s,
                  "misses_at_deadline": sum(r.missed_deadline for r in reqs),
                  "latency_ms_by_bucket": latency_by_bucket(
                      svc.replicas[0].service.bucket_for, reqs),
                  "dispatches_by_replica": per_rep,
                  "fused_dispatches": fused,
                  # each replica's service-time estimate a bucket after the
                  # traffic (ms; measured or still the initial guess): on
                  # one stream a replica's samples include its neighbours'
                  # work queued before its own
                  "est_ms_by_replica": [
                      {f"{g.shape[0]}x{g.shape[1]}":
                       [g.est_s * 1e3, g.est_measured]
                       for g in r.service.grids.values()}
                      for r in svc.replicas],
                  "sessions_replicas": on,
                  "every_dispatch_warm_and_guarded": all_warm,
                  "sync_debug_mode_on_warm_dispatches": "error",
                  "launches": counts, "launches_expected": want,
                  "done_checked_against_plan_run": checked,
                  "done_differing_from_plan_run": plan_differ,
                  "traced": {
                      "dispatches": traced_dispatches,
                      "gpu_activities": tr["gpu_activities"],
                      "gpu_activities_per_dispatch":
                          tr["gpu_activities"] / max(traced_dispatches, 1),
                      "device_busy_ms": tr["device_busy_ms"],
                      "device_span_ms": tr["device_span_ms"],
                      "device_busy_share_of_span":
                          tr["device_busy_share_of_span"],
                      "traced_wall_ms": tr["traced_wall_ms"],
                      "whole": tr["whole"], "trace": tr["trace"]},
                  "ok": ok})
            if not ok:
                failures.append(f"{n}_replicas")
            del svc, records
    emit({"phase": "fleet_seconds", "seconds": time.perf_counter() - t_phase})
    if failures:
        raise SystemExit(f"fleet checks failed: {failures}")
    return launches


# The drive suite's constants (benchmarks/drive_suite.py): the closed
# loop's cycle length (pinned, never cut), the service arm's deadline,
# model cost a dispatch and forced overload windows, the tracked arm's
# max cross-track floors.
DRIVE_FAMILIES = ("straight", "rain", "night", "glare")
DRIVE_FRAMES = 48
DRIVE_DEADLINE_S = 0.08
DRIVE_MODEL_COST_S = 0.02
DRIVE_OVERLOAD_EST_S = 1.0
DRIVE_OVERLOAD_WINDOWS = (range(8, 14), range(28, 34))
DRIVE_FLOOR_M = 0.40


def drive_arm(arm: str, family: str, device=None) -> dict:
    """One arm of the drive suite on ``standard_closed_loop(family, 48)``
    at 240x320, seed 0, on the card (``device=None``) or the CPU: the
    trajectory, each frame's command, the peaks and validity each
    controller steered from, and the host-clock ms of each frame through
    the vehicle's stack (detect, track, steer; not the world's render).
    ``arm``: "blind", "per_frame", "tracked", "tracked_fused",
    "service_ladder_on" or "service_ladder_off"."""
    import numpy as np

    from repro_torch.configs.paper_lines import FRAME_HW
    from repro_torch.core import (
        ControlConfig, HoughConfig, LateralController, LineDetector,
        PipelineConfig, TrackingPipeline,
    )
    from repro_torch.data import standard_closed_loop
    from repro_torch.serve import (
        DetectionRequest, DetectionService, VirtualClock,
    )

    H, W = FRAME_HW
    cfg = PipelineConfig(hough=HoughConfig(compact=True, max_edges="auto"))
    cyc = standard_closed_loop(family, DRIVE_FRAMES, H, W, seed=0)
    ctl = LateralController(clock=lambda: float(cyc.t))
    out = {"commands": [], "seen": [], "frame_ms": [], "statuses": []}
    if arm == "blind":
        for _ in range(DRIVE_FRAMES):
            cyc.observe()
            cyc.advance(None)
    elif arm == "per_frame":
        det = LineDetector(cfg, device=device)
        for _ in range(DRIVE_FRAMES):
            img = np.asarray(cyc.observe().scene.image, np.float32)
            t0 = time.perf_counter()
            res = det.detect(img)
            seen = (res.peaks.cpu().numpy(), res.valid.cpu().numpy())
            cmd = ctl.command(*seen)
            out["frame_ms"].append((time.perf_counter() - t0) * 1e3)
            out["seen"].append(seen)
            out["commands"].append(tuple(cmd))
            cyc.advance(cmd.curvature)
    elif arm in ("tracked", "tracked_fused"):
        kw = (dict(theta_band=40, fused_corridors=8)
              if arm == "tracked_fused" else {})
        tp = TrackingPipeline(cfg, height=H, width=W, device=device, **kw)
        for _ in range(DRIVE_FRAMES):
            img = cyc.observe().scene.image
            t0 = time.perf_counter()
            tf = tp.process(img, controller=ctl)
            out["frame_ms"].append((time.perf_counter() - t0) * 1e3)
            out["seen"].append(tf.control_peaks)
            out["commands"].append(tuple(tf.steering))
            cyc.advance(tf.steering.curvature)
        out["frames_split"] = {"full": tp.full_frames,
                               "gated": tp.gated_frames,
                               "fused": tp.fused_frames}
    else:
        clock = VirtualClock()
        svc = DetectionService(
            cfg, buckets=((H, W),), batch_size=1, prefetch=False,
            ladder=arm == "service_ladder_on", steering=ControlConfig(),
            clock=clock, device=device)
        grid = svc.grids[(H, W)]
        try:
            for t in range(DRIVE_FRAMES):
                clock.advance(cyc.cfg.frame_dt_s)
                overload = any(t in w for w in DRIVE_OVERLOAD_WINDOWS)
                grid.est_s = (DRIVE_OVERLOAD_EST_S if overload
                              else DRIVE_MODEL_COST_S)
                grid.est_measured = True
                req = DetectionRequest(uid=t, frame=cyc.observe().scene.image,
                                       deadline_s=DRIVE_DEADLINE_S,
                                       session_id="ego")
                t0 = time.perf_counter()
                svc.submit(req)
                svc.step()
                if grid.in_flight is not None:
                    clock.advance(DRIVE_MODEL_COST_S)
                    svc.drain()
                for _ in range(4):
                    if req.is_terminal:
                        break
                    svc.step()
                    svc.drain()
                out["frame_ms"].append((time.perf_counter() - t0) * 1e3)
                if not req.is_terminal:
                    raise SystemExit(f"closed loop {arm} {family}: frame {t} "
                                     f"not terminal ({req.status})")
                out["statuses"].append(req.status.name)
                cmd = req.steering
                out["commands"].append(None if cmd is None else tuple(cmd))
                cyc.advance(None if cmd is None else cmd.curvature)
            out["dispatches"] = svc.dispatches
        finally:
            svc.close()
    out.update(trajectory=list(cyc.trajectory),
               max_cross_track_m=cyc.max_cross_track_m,
               mean_cross_track_m=cyc.mean_cross_track_m,
               final_cross_track_m=abs(cyc.trajectory[-1][1]))
    if not arm.startswith("service"):   # the service steers on its own
        out.update(fresh_commands=ctl.fresh_commands,
                   held_commands=ctl.held_commands)
    return out


def first_difference(card: dict, cpu: dict) -> dict | None:
    """Where a card run of an arm first leaves the CPU run: the first
    frame whose plant state differs, the first frame whose steered-from
    peaks differ and the first such peak, the first command."""
    import numpy as np

    def first(xs, ys):
        return next((i for i, (x, y) in enumerate(zip(xs, ys)) if x != y),
                    None)

    peak = None
    for t, ((pa, va), (pb, vb)) in enumerate(zip(card["seen"], cpu["seen"])):
        if pa.shape != pb.shape or not (np.array_equal(pa, pb)
                                        and np.array_equal(va, vb)):
            k = next((k for k in range(min(len(pa), len(pb)))
                      if not (np.array_equal(pa[k], pb[k])
                              and va[k] == vb[k])), None)
            peak = {"frame": t, "peak": k,
                    "card": None if k is None else [*pa[k].tolist(),
                                                    bool(va[k])],
                    "cpu": None if k is None else [*pb[k].tolist(),
                                                   bool(vb[k])]}
            break
    diff = {"trajectory_frame": first(card["trajectory"], cpu["trajectory"]),
            "command_frame": first(card["commands"], cpu["commands"]),
            "status_frame": first(card["statuses"], cpu["statuses"]),
            "first_peak": peak}
    return None if all(v is None for v in diff.values()) else diff


def closed_loop_phases() -> dict:
    """The closed loop on the card, the drive suite's arms
    (``benchmarks/drive_suite.py``) at 240x320 (``FRAME_HW``), 48 frames,
    seed 0, on "straight", "rain", "night" and "glare": blind,
    per_frame (``LineDetector`` -> ``LateralController``), tracked
    (``TrackingPipeline.process(frame, controller=)``), tracked_fused
    (``theta_band=40, fused_corridors=8``), and on "straight" the
    ``DetectionService`` session arm with the degradation ladder on and
    off under two forced overload windows.

    Each arm on the card is run with the launch counts zeroed just before
    it and read just after, and again with ``device="cpu"``: the card's
    trajectory, commands and statuses must equal the CPU's (the first
    frame and peak that differ are printed).  Then the suite's gates
    (tracked max <= 0.40 m; tracked mean <= per_frame mean on the noisy
    families; ladder on < off on max and mean; tracked max < half the
    blind max; a second tracked run the same) and the committed baseline
    (``benchmarks/baselines/drive_baseline.json``: the tracked and
    ladder-on max and mean, tolerance 0, as ``scripts/check_drive.py``).
    Printed beside them: each tracked frame's host-clock ms against the
    paper's 300 ms, launches a frame, GPU activities a frame
    (``gpu_trace``).  Any failure raises.  Returns each arm's launch
    counts for the ``kernels`` line."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_lines import FRAME_HW, REALTIME_BUDGET_S
    from repro_torch.data import NOISY_FAMILIES
    from repro_torch.kernels import ops

    arms = ("blind", "per_frame", "tracked", "tracked_fused")
    runs = [(arm, fam) for fam in DRIVE_FAMILIES for arm in arms]
    runs += [("service_ladder_on", "straight"),
             ("service_ladder_off", "straight")]
    # one short tracked run first: the plans' first launches and the
    # kernels' first loads stay out of the timed frames
    drive_arm("tracked_fused", "straight")
    card, cpu, launches, failures = {}, {}, {}, []
    for arm, fam in runs:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        card[arm, fam] = drive_arm(arm, fam)
        torch.cuda.synchronize()
        launches[arm, fam] = ops.launch_counts()
        cpu[arm, fam] = drive_arm(arm, fam, device="cpu")
    rows = []
    for arm, fam in runs:
        a, b, n = card[arm, fam], cpu[arm, fam], launches[arm, fam]
        diff = first_difference(a, b)
        split = a.get("frames_split", {})
        steps = (a.get("dispatches", 0) if arm.startswith("service")
                 else 0 if arm == "blind" else DRIVE_FRAMES)
        fused = split.get("fused", 0)
        want = {k: 0 for k in n}
        want.update(conv2d_gemm=2 * (steps - fused), hough_vote=steps,
                    fused_detect=fused)
        ms = a["frame_ms"]
        row = {"arm": arm, "family": fam,
               "max_cross_track_m": a["max_cross_track_m"],
               "mean_cross_track_m": a["mean_cross_track_m"],
               "final_cross_track_m": a["final_cross_track_m"],
               "fresh_commands": a.get("fresh_commands"),
               "held_commands": a.get("held_commands"),
               "equal_cpu": diff is None, "first_difference_vs_cpu": diff,
               "launches": n, "launches_expected": want,
               "launches_per_frame": {k: v / DRIVE_FRAMES
                                      for k, v in n.items() if v},
               "frame_ms_p50": float(np.percentile(ms, 50)) if ms else None,
               "frame_ms_p99": float(np.percentile(ms, 99)) if ms else None}
        if split:
            row["frames_split"] = split
        if a["statuses"]:
            row["statuses"] = {s: a["statuses"].count(s)
                               for s in sorted(set(a["statuses"]))}
            row["dispatches"] = a["dispatches"]
        rows.append(row)
        if diff is not None or n != want:
            failures.append(f"{arm}/{fam}")
    by = {(r["arm"], r["family"]): r for r in rows}

    def m(arm, fam, key="max_cross_track_m"):
        return by[arm, fam][key]

    rerun = drive_arm("tracked", DRIVE_FAMILIES[0])
    on, off = "service_ladder_on", "service_ladder_off"
    gates = {
        "tracked_under_floor": all(m("tracked", f) <= DRIVE_FLOOR_M
                                   for f in DRIVE_FAMILIES),
        "tracked_le_per_frame_on_noisy": all(
            m("tracked", f, "mean_cross_track_m")
            <= m("per_frame", f, "mean_cross_track_m")
            for f in DRIVE_FAMILIES if f in NOISY_FAMILIES),
        "ladder_on_beats_off": (
            m(on, "straight") < m(off, "straight")
            and m(on, "straight", "mean_cross_track_m")
            < m(off, "straight", "mean_cross_track_m")),
        "controlled_beats_blind": all(
            m("tracked", f) < 0.5 * m("blind", f) for f in DRIVE_FAMILIES),
        "deterministic_replay": (rerun["trajectory"]
                                 == card["tracked", DRIVE_FAMILIES[0]][
                                     "trajectory"]),
    }
    base = json.loads((ROOT / "benchmarks" / "baselines"
                       / "drive_baseline.json").read_text())
    pinned = {f"tracked/{f}": (by["tracked", f], b)
              for f, b in base["tracked"].items()}
    pinned["service_ladder_on/straight"] = (by[on, "straight"],
                                            base["service_ladder_on"])
    vs_baseline = {
        k: {key: {"port": r[key], "baseline": b[key],
                  "port_minus_baseline": r[key] - b[key]}
            for key in ("max_cross_track_m", "mean_cross_track_m")}
        for k, (r, b) in pinned.items()}
    baseline_ok = all(v["port_minus_baseline"] <= 0.0
                      for d in vs_baseline.values() for v in d.values())
    # the tracked arms' frames through the vehicle's stack on the card
    frame_ms = {a: [t for f in DRIVE_FAMILIES for t in card[a, f]["frame_ms"]]
                for a in ("per_frame", "tracked", "tracked_fused")}
    times = {a: {"frames": len(v), "p50_ms": float(np.percentile(v, 50)),
                 "p99_ms": float(np.percentile(v, 99)), "max_ms": max(v),
                 "over_budget": sum(t > REALTIME_BUDGET_S * 1e3 for t in v)}
             for a, v in frame_ms.items()}
    traced = {}
    for arm in ("per_frame", "tracked", "tracked_fused"):
        t = gpu_trace(lambda arm=arm: drive_arm(arm, "rain"),
                      f"closed_loop_{arm}", 1)
        traced[arm] = {"gpu_activities_per_frame":
                       t["gpu_activities"] / DRIVE_FRAMES,
                       "device_busy_ms_per_frame":
                       t["device_busy_ms"] / DRIVE_FRAMES,
                       "device_busy_share_of_span":
                       t["device_busy_share_of_span"],
                       "traced_wall_ms_per_frame":
                       t["traced_wall_ms"] / DRIVE_FRAMES,
                       "whole": t["whole"], "top": t["top"][:6],
                       "trace": t["trace"]}
    ok = not failures and all(gates.values()) and baseline_ok
    emit({"phase": "closed_loop", "hw": list(FRAME_HW),
          "frames": DRIVE_FRAMES, "seed": 0,
          "families": list(DRIVE_FAMILIES),
          "hough": "compact=True, max_edges='auto'",
          "service": {"deadline_s": DRIVE_DEADLINE_S,
                      "model_cost_s": DRIVE_MODEL_COST_S,
                      "overload_est_s": DRIVE_OVERLOAD_EST_S,
                      "overload_frames": [t for w in DRIVE_OVERLOAD_WINDOWS
                                          for t in w]},
          "arms": rows, "gates": gates, "vs_baseline": vs_baseline,
          "baseline_tolerance_m": 0.0, "at_or_below_baseline": baseline_ok,
          "frame_ms_on_card": times,
          "realtime_budget_ms": REALTIME_BUDGET_S * 1e3,
          "traced_rain": traced, "arms_differing_from_cpu": failures,
          "ok": ok})
    if not ok:
        raise SystemExit(f"closed loop failed: arms {failures}, gates "
                         f"{gates}, at or below the baseline {baseline_ok}")
    return {f"{arm}_{fam}": launches[arm, fam] for arm, fam in runs}


# The paper's platform matrix (Table 7), as benchmarks/paper_tables.py
# runs it: each configuration's Canny and Hough, then get_lines.
PAPER_CONFIGS = (
    ("rocket", {"impl": "stencil"}, False),
    ("gemm", {}, False),
    ("gemm+hough", {}, True),
    ("+fused", {"fused": True}, True),
    ("+int", {"integer": True}, True),
)


def paper_platform_phases(cuda_ms) -> dict:
    """The paper's Table 6 / 7 analogue on the card at ``FRAME_HW``
    (240x320), one frame of "straight" at seed 0: stage times (Canny,
    Hough, get_lines) for "rocket" (the stencil Canny, plain torch, and
    the serial ``hough_paper_loop``), "gemm" (the conv kernel's Canny and
    the serial loop), "gemm+hough" (the conv kernel and the vote kernel,
    ``hough_transform`` with ``HoughConfig()``), "+fused" (the (3,7,7)
    masks) and "+int" (the integer rewrite); speedups against rocket.

    A stage's time is the host clock around one call that ends in a
    synchronize, as the paper times a stage on its core: the serial loop
    once warm and then once timed (``paper_tables.py`` repeats it twice),
    the other stages the median of 10 after a warm call, with their device
    time (CUDA events, ``cuda_ms``) beside it.  Launch counts are zeroed
    just before each configuration's pass and read just after.  Checks: on
    the card the serial loop's votes equal the vote kernel's on the same
    edges (atol 1e-3, as ``tests/test_core.py``) and the port's CPU loop
    bit for bit; the stencil Canny's Gauss and Sobel stages equal the conv
    kernel's within the float conv tolerance (1e-4), and the edge pixels
    where the two Canny edge maps differ are counted.  Any failure raises.
    Returns each configuration's launch counts for the ``kernels`` line."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_lines import FRAME_HW
    from repro_torch.core import (
        CannyConfig, HoughConfig, LinesConfig, canny, get_lines,
        hough_paper_loop, hough_transform,
    )
    from repro_torch.core.canny import device_masks
    from repro_torch.data import make_scenario
    from repro_torch.kernels import ops, ref

    H, W = FRAME_HW
    dev = torch.device("cuda", 0)
    img = torch.from_numpy(make_scenario("straight", H, W, seed=0)
                           .image.astype(np.float32)).to(dev)
    hcfg, lcfg = HoughConfig(), LinesConfig()

    def host_ms(fn, reps, warm=True):
        """Host-clock ms of ``fn`` to a synchronize: one warm call unless
        ``warm`` is false, then the median of ``reps``; the last result."""
        if warm:
            fn()
            torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts)), ts, out

    rows, launches, loops = {}, {}, {}
    for name, ckw, vote_kernel in PAPER_CONFIGS:
        ccfg = CannyConfig(**ckw)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        edges = canny(img, ccfg)
        votes = (hough_transform(edges, hcfg) if vote_kernel
                 else hough_paper_loop(edges, hcfg))
        get_lines(votes, height=H, width=W, cfg=lcfg)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches[name] = ops.launch_counts()
        canny_ms, _, edges = host_ms(lambda: canny(img, ccfg), 10)
        if vote_kernel:
            hough_ms, _, votes = host_ms(
                lambda: hough_transform(edges, hcfg), 10)
            hough_runs = None
        else:
            # the serial loop: the counted pass above warmed it
            hough_ms, hough_runs, votes = host_ms(
                lambda: hough_paper_loop(edges, hcfg), 1, warm=False)
            loops[name] = (edges, votes)
        lines_ms, _, _ = host_ms(
            lambda: get_lines(votes, height=H, width=W, cfg=lcfg), 10)
        rows[name] = {
            "canny": ccfg.impl or ("fused_7x7" if ccfg.fused else
                                   "integer" if ccfg.integer else "f32"),
            "hough": "vote kernel" if vote_kernel else "hough_paper_loop",
            "canny_ms": canny_ms, "hough_ms": hough_ms,
            "get_lines_ms": lines_ms,
            "total_ms": canny_ms + hough_ms + lines_ms,
            "device_ms": {
                "canny": cuda_ms(lambda: canny(img, ccfg), reps=10),
                "get_lines": cuda_ms(lambda: get_lines(
                    votes, height=H, width=W, cfg=lcfg), reps=10),
                **({"hough": cuda_ms(lambda: hough_transform(edges, hcfg),
                                     reps=10)} if vote_kernel else {})},
            "launches": {k: v for k, v in launches[name].items() if v},
            "edge_pixels": int((edges >= hcfg.edge_threshold).sum()),
            "votes": float(votes.sum()),
            # the counted first pass, each stage's first call included
            "first_pass_ms": first_ms}
        if hough_runs is not None:
            rows[name]["hough_paper_loop_iterations"] = H * W
    base = rows["rocket"]
    for r in rows.values():
        r["speedup_vs_rocket"] = {
            s: base[f"{s}_ms"] / r[f"{s}_ms"]
            for s in ("canny", "hough", "get_lines", "total")}
    # the serial loop against the vote kernel and the CPU loop
    checks = []
    for name, (edges, votes) in loops.items():
        vote = hough_transform(edges, hcfg)
        on_cpu = hough_paper_loop(edges.cpu(), hcfg)
        err = (votes - vote).abs().max().item()
        checks.append({"config": name, "loop_vs_vote_kernel_max_abs_err": err,
                       "loop_equal_cpu_loop": torch.equal(votes.cpu(),
                                                          on_cpu),
                       "ok": err <= 1e-3 and torch.equal(votes.cpu(),
                                                         on_cpu)})
    # the stencil Canny against the conv kernel's, stage by stage
    stages = []
    for which, masks in enumerate(device_masks(CannyConfig(), dev)):
        x = img if which == 0 else ops.conv2d_gemm(img, device_masks(
            CannyConfig(), dev)[0])[0]
        got, want = ref.conv2d_stencil(x, masks), ops.conv2d_gemm(x, masks)
        stages.append({"stage": ("gauss_1x5x5", "sobel_2x3x3")[which],
                       "max_abs_err": (got - want).abs().max().item(),
                       "ok": torch.allclose(got, want, rtol=1e-4,
                                            atol=1e-4)})
    e_st = canny(img, CannyConfig(impl="stencil"))
    e_gm = canny(img, CannyConfig())
    stencil = {"stages": stages,
               "edge_pixels_differing": int((e_st != e_gm).sum()),
               "edge_pixels": int((e_gm >= 250).sum())}
    checks.append({"config": "rocket_canny_vs_conv_kernel", **stencil,
                   "ok": all(s["ok"] for s in stages)})
    kernel_use = all(
        (launches[n]["conv2d_gemm"] > 0) == (ckw.get("impl") is None)
        and (launches[n]["hough_vote"] > 0) == vote_kernel
        and launches[n]["fused_detect"] == 0
        for n, ckw, vote_kernel in PAPER_CONFIGS)
    ok = all(c["ok"] for c in checks) and kernel_use
    emit({"phase": "paper_platforms", "hw": [H, W],
          "frame": "straight, seed 0", "hough": "HoughConfig()",
          "note": "host-clock ms of one call to a synchronize; the serial "
                  "loop timed once after a warm call",
          "configs": rows, "checks": checks,
          "launches_as_configured": kernel_use, "ok": ok})
    if not ok:
        raise SystemExit(f"paper platforms failed: {checks}, kernels "
                         f"{launches}")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--parent", type=Path, default=None,
        help="an unpacked tree of the parent commit (git archive): its conv, "
             "vote, SSD and fused_detect kernels are built and timed beside "
             "this tree's (conv_shape_times; vote_shape_times; lm_times; "
             "fused_times, "
             "fused_tier_times, and the fused detector and tracking loop "
             "run on the parent's kernel)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on the GPU", file=sys.stderr)
        return 2

    import numpy as np

    import dataclasses

    from repro_torch.configs.paper_lines import DEPLOY_HW, FRAME_HW, PLATFORMS
    from repro_torch.core import (
        CannyConfig, HoughConfig, LineDetector, PipelineConfig,
        TrackingPipeline, aggregate_scores, canny, full_corridors,
        score_batch,
    )
    from repro_torch.core.canny import GAUSS_NORM, device_masks
    from repro_torch.core.hough import _device_raster, hough_trig, rho_bins
    from repro_torch.data import (
        make_drive_cycle, scenario_batch, scenario_names, scenario_stream,
    )
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import conv2d_gemm as conv_mod
    from repro_torch.kernels import fused_detect as fused_mod
    from repro_torch.kernels import hough_vote as vote_mod

    # the plain versions run on the card here: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cpu = torch.device("cpu")

    def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    # --- 1. build ---------------------------------------------------------
    seconds = _build.build()
    emit({"phase": "build", "seconds": seconds,
          "libraries": [str(_build.library_path(n).relative_to(ROOT))
                        for n in _build.SOURCES]})

    H, W = DEPLOY_HW
    auto = HoughConfig(compact=True, max_edges="auto")
    cfg_boom = PipelineConfig(canny=PLATFORMS["boom"].canny, hough=auto)
    cfg_int = PipelineConfig(canny=PLATFORMS["boom+gemmini"].canny, hough=auto)
    frames, truths = scenario_batch(MAIN_FAMILIES, H, W, seed=0)
    frames_dev = torch.from_numpy(frames).to(dev)

    # --- 2. kernels against their plain versions on the card -------------
    # each mask set: whether it is the fused 7x7 set, which of the
    # config's mask tensors it is
    mask_sets = {"gauss": (False, 0), "sobel": (False, 1), "fused": (True, 0)}
    tiers = {
        "float32": {}, "float16": {"grad_dtype": "f16"},
        "int32": {"integer": True}, "int8": {"grad_dtype": "int8"},
    }
    conv_err = 0.0
    checks = []
    rng = np.random.default_rng(0)
    cases = [((3, 45, 70), name, dt) for name in mask_sets for dt in tiers]
    cases += [((1, 21, 19), name, dt) for name in mask_sets for dt in tiers]
    # at the main path's own shapes: the masks and types it runs
    cases += [((DEPLOY_BATCH, H, W), name, dt)
              for name in ("gauss", "sobel") for dt in ("float32", "int32")]
    for shape, name, dtype in cases:
        img_f = (torch.from_numpy(frames) if shape[1] == H else
                 torch.from_numpy(rng.uniform(0, 255, shape)
                                  .astype(np.float32)))
        fused, which = mask_sets[name]
        m = device_masks(CannyConfig(fused=fused, **tiers[dtype]), dev)[which]
        if dtype == "int8":
            x = (img_f - 128).round().clamp(-128, 127).to(torch.int8)
        else:
            x = img_f.to(getattr(torch, dtype))
        got = conv_mod.conv2d_gemm(x.to(dev), m).cpu()
        want = ref.conv2d_gemm(x, m.cpu())
        err = (got.float() - want.float()).abs().max().item()
        if dtype in ("int32", "int8"):
            tol = 0.0
            ok = torch.equal(got, want)
        elif dtype == "float32":
            tol = 1e-4
            ok = torch.allclose(got, want, rtol=1e-4, atol=1e-4)
            conv_err = max(conv_err, err)
        else:
            # f16 accumulates in f16 here and in another order there: four
            # f16 ulps of the largest partial sum, sum|mask| * max|x|
            peak = (m.float().abs().sum(dim=(1, 2)).max()
                    * x.float().abs().max()).item()
            tol = 4.0 * 2.0 ** (math.floor(math.log2(peak)) - 10)
            ok = err <= tol
        checks.append({"kernel": "conv2d_gemm", "shape": list(shape),
                       "masks": name, "dtype": dtype, "max_abs_err": err,
                       "tol": tol, "ok": bool(ok)})
    # Against the plain version on the same card (cuBLAS / cuDNN inside).
    gm = device_masks(CannyConfig(), dev)[0]
    got, want = conv_mod.conv2d_gemm(frames_dev, gm), ref.conv2d_gemm(frames_dev, gm)
    conv_card_err = (got - want).abs().max().item()
    conv_err = max(conv_err, conv_card_err)
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise SystemExit(f"conv kernel vs plain on the card: {conv_card_err}")

    trig_c = torch.from_numpy(hough_trig(H, W, HoughConfig()))
    n_rho = rho_bins(H, W, HoughConfig())
    # real edge maps of the main path (the port's CPU Canny)
    edges_main = canny(torch.from_numpy(frames), CannyConfig())
    w_main = (edges_main.reshape(DEPLOY_BATCH, -1) >= 250).float()
    xy_c = _device_raster(H, W, cpu)
    cap = ops.default_max_edges(H * W)
    cxy_c, cw_c, cnt_c = ops.compact_edges(xy_c, w_main, max_edges=cap)
    vote_cases = {
        "compacted_per_frame_xy": (cxy_c, cw_c, cnt_c, trig_c, n_rho),
    }
    # one tracking frame: full sweep (T 180) and a fused frame's band
    # (T 40; its edges inside 8 corridors around the frame's lines)
    vote_cases["frame_t180"] = (cxy_c[1], cw_c[1], cnt_c[1], trig_c, n_rho)
    keep = ref.corridor_keep(xy_c, torch.from_numpy(
        tracker_corridors(truths[1], 8)))
    one = ops.compact_edges(xy_c, w_main[1] * keep, max_edges=cap)
    centre = round(math.degrees(truths[1][0][1])) % trig_c.shape[1]
    band = (torch.arange(40) + centre - 20) % trig_c.shape[1]
    vote_cases["band_t40"] = (*one, trig_c[:, band].contiguous(), n_rho)
    hs, ws = FRAME_HW
    small, _ = scenario_batch(scenario_names()[:4], hs, ws, seed=1)
    w_small = (canny(torch.from_numpy(small), CannyConfig())
               .reshape(4, -1) >= 250).float()
    vote_cases["dense_shared_xy"] = (
        _device_raster(hs, ws, cpu), w_small, None,
        torch.from_numpy(hough_trig(hs, ws, HoughConfig())),
        rho_bins(hs, ws, HoughConfig()))
    cublas_diff = None
    vote_err = 0.0
    for name, (xy, w, cnt, trig, nr) in vote_cases.items():
        got = vote_mod.hough_vote(
            xy.to(dev), w.to(dev), trig.to(dev), n_rho=nr,
            counts=None if cnt is None else cnt.to(dev)).cpu()
        want = ref.hough_vote(xy, w, trig, n_rho=nr)
        same = torch.equal(got, want)
        vote_err = max(vote_err, (got - want).abs().max().item())
        checks.append({"kernel": "hough_vote", "case": name,
                       "shape": list(w.shape), "votes": float(want.sum()),
                       "differ": int((got != want).sum()),
                       "max_abs_err": (got - want).abs().max().item(),
                       "bit_exact_vs_cpu_plain": same, "ok": same})
        if name == "compacted_per_frame_xy":
            card_plain = ref.hough_vote(xy.to(dev), w.to(dev), trig.to(dev),
                                        n_rho=nr).cpu()
            cublas_diff = int((card_plain != want).sum())
    emit({"phase": "kernels_vs_plain", "checks": checks,
          "conv_f32_vs_plain_on_card_max_abs_err": conv_card_err,
          "vote_plain_on_card_cells_differing_from_cpu_plain": cublas_diff})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel checks failed: {bad}")

    # fused_detect: bit-exact against its plain version run on the card
    # (the staged canny -> threshold -> corridor -> compact_edges, with the
    # conv kernel's arithmetic), and against the plain version on a CPU
    # copy wherever the plain version's own card and CPU runs agree.  They
    # can disagree only through the conv's summation order (im2col einsum
    # on the CPU, an FMA chain on the card); each check counts the edge
    # pixels where they do.
    real_cor = tracker_corridors(truths[1], 8)   # the converging frame
    fused_cases = [
        ("main", (DEPLOY_BATCH, H, W), CannyConfig(), None, cap),
        ("main", (DEPLOY_BATCH, H, W), CannyConfig(), real_cor, cap),
        ("main", (DEPLOY_BATCH, H, W), CannyConfig(), full_corridors(8), cap),
        ("main", (DEPLOY_BATCH, H, W), CannyConfig(), real_cor, 512),
        ("main", (DEPLOY_BATCH, H, W), CannyConfig(integer=True), None, cap),
        ("main", (DEPLOY_BATCH, H, W), CannyConfig(fused=True), None, cap),
        ("main", (DEPLOY_BATCH, H, W), CannyConfig(variant="paper"), None,
         cap),
    ]
    for shape in ((3, 45, 70), (1, 21, 19)):
        for cfg_small in (CannyConfig(), CannyConfig(integer=True),
                          CannyConfig(fused=True),
                          CannyConfig(variant="paper"),
                          CannyConfig(hysteresis_iters=30, border=0)):
            fused_cases.append(("random", shape, cfg_small,
                                np.array([[0.6, 0.8, 5.0, 40.0]] * 2,
                                         np.float32), 256))
            fused_cases.append(("random", shape, cfg_small, None, 64))
    fused_checks, fused_err = [], 0.0
    for source, shape, ccfg, cor, me in fused_cases:
        x = (torch.from_numpy(frames) if source == "main" else
             torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)))
        cor_t = None if cor is None else torch.from_numpy(cor)
        got = fused_mod.fused_detect(
            x.to(dev), None if cor_t is None else cor_t.to(dev), cfg=ccfg,
            edge_threshold=250.0, max_edges=me)
        torch.cuda.synchronize()
        got = [t.cpu() for t in got]
        want = ref.fused_detect(x, cfg=ccfg, edge_threshold=250.0,
                                max_edges=me, corridors=cor_t)
        w_card = ref.fused_weights(x.to(dev), cfg=ccfg, edge_threshold=250.0,
                                   corridors=None if cor_t is None
                                   else cor_t.to(dev))
        staged = [t.cpu() for t in ops.compact_edges(
            _device_raster(shape[1], shape[2], dev), w_card, max_edges=me)]
        w_cpu = ref.fused_weights(x, cfg=ccfg, edge_threshold=250.0,
                                  corridors=cor_t)
        plain_differ = int((w_card.cpu() != w_cpu).sum())
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        same_staged = all(torch.equal(a, b) for a, b in zip(got, staged))
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, staged))
        fused_err = max(fused_err, err)
        fused_checks.append({
            "kernel": "fused_detect", "frames": source, "shape": list(shape),
            "cfg": {k: v for k, v in dataclasses.asdict(ccfg).items()
                    if v != getattr(CannyConfig(), k)},
            "corridors": None if cor is None else len(cor),
            "max_edges": me, "counts": got[2].tolist(),
            "bit_exact_vs_card_plain": same_staged,
            "bit_exact_vs_cpu_plain": same,
            "plain_edge_pixels_differing_card_vs_cpu": plain_differ,
            "max_abs_err": err,
            "ok": same_staged and (same or plain_differ > 0)})
    emit({"phase": "fused_vs_plain", "checks": fused_checks})
    bad = [c for c in fused_checks if not c["ok"]]
    if bad:
        raise SystemExit(f"fused_detect checks failed: {bad}")

    # The gradient tiers, f16 and int8, on the same cases.  int8: bit-exact
    # with the card's staged path (its plain version), with the plain
    # version on a CPU copy (integer convs are exact in any order, and the
    # scales round once on both), and so with the staged int8 detector at
    # full coverage.  f16: bit-exact with the card's staged f16 path (the
    # conv kernel's __hfma chains, tap for tap); against the CPU the f16
    # sums run in another order, and the edge pixels that differ are
    # counted.
    tier_checks = []
    tier_cases = [(src, shape, dataclasses.replace(c, grad_dtype=g), cor, me)
                  for g in ("f16", "int8")
                  for src, shape, c, cor, me in fused_cases
                  if not c.integer and c.variant == "full"
                  and c.hysteresis_iters == 8 and me != 512]
    for source, shape, ccfg, cor, me in tier_cases:
        x = (torch.from_numpy(frames) if source == "main" else
             torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)))
        cor_t = None if cor is None else torch.from_numpy(cor)
        got = [t.cpu() for t in fused_mod.fused_detect(
            x.to(dev), None if cor_t is None else cor_t.to(dev), cfg=ccfg,
            edge_threshold=250.0, max_edges=me)]
        torch.cuda.synchronize()
        w_card = ref.fused_weights(x.to(dev), cfg=ccfg, edge_threshold=250.0,
                                   corridors=None if cor_t is None
                                   else cor_t.to(dev))
        staged = [t.cpu() for t in ops.compact_edges(
            _device_raster(shape[1], shape[2], dev), w_card, max_edges=me)]
        w_cpu = ref.fused_weights(x, cfg=ccfg, edge_threshold=250.0,
                                  corridors=cor_t)
        same_staged = all(torch.equal(a, b) for a, b in zip(got, staged))
        c = {"kernel": "fused_detect", "grad_dtype": ccfg.grad_dtype,
             "frames": source, "shape": list(shape), "fused_masks": ccfg.fused,
             "corridors": None if cor is None else len(cor), "max_edges": me,
             "counts": got[2].tolist(),
             "bit_exact_vs_card_plain": same_staged,
             "edge_pixels_card_vs_cpu_plain": int((w_card.cpu()
                                                   != w_cpu).sum())}
        if ccfg.grad_dtype == "int8":
            want = ref.compact_raster(w_cpu, width=shape[2], max_edges=me)
            c["bit_exact_vs_cpu_plain"] = all(torch.equal(a, b)
                                              for a, b in zip(got, want))
        c["ok"] = same_staged and c.get("bit_exact_vs_cpu_plain", True)
        tier_checks.append(c)
    # why the port's quantization divides by a device tensor: a CUDA tensor
    # divided by a Python number is multiplied by its reciprocal instead
    qv = torch.from_numpy(np.random.default_rng(159).uniform(
        0, 300, 100000).astype(np.float32)).to(dev)
    twice = int((qv / GAUSS_NORM
                 != qv / torch.full((), GAUSS_NORM, device=dev)).sum())
    emit({"phase": "fused_tiers_vs_plain", "checks": tier_checks,
          "quotients_by_159_of_100000_differing_python_number_vs_tensor":
              twice})
    bad = [c for c in tier_checks if not c["ok"]]
    if bad:
        raise SystemExit(f"fused_detect tier checks failed: {bad}")

    # A hysteresis longer than the tile's shared memory holds runs through
    # two planes in device memory: in every tier, at the fewest passes that
    # fused_mod.hysteresis_schedule sends there, at 60 and at 100, on the 8
    # main frames, the kernel is one launch, bit-exact with its plain
    # version on the card; one traced call shows the launch schedule the
    # card ran (the tile kernel, then the schedule's hysteresis launches,
    # the keep kernel, the compaction), and the 8-pass default keeps its
    # single tile kernel.  Times: device ms of one call.
    compaction = ("compact_kernel",)

    def fused_schedule(lcfg, name):
        t = gpu_trace(lambda: fused_mod.fused_detect(
            frames_dev, cfg=lcfg, edge_threshold=250.0, max_edges=cap),
            name, 1, focus=("canny_tile_kernel", "hysteresis_kernel",
                            "keep_kernel", *compaction))
        return {k: v["calls"] for k, v in t["focus"].items()}

    def first_planes(**kw):
        """The fewest passes the tile kernel does not hold."""
        return next(i for i in range(1, 100) if fused_mod.hysteresis_schedule(
            CannyConfig(hysteresis_iters=i, **kw)))

    long_checks = []
    default_cfg = CannyConfig()
    default_kernels = fused_schedule(default_cfg, "fused_hysteresis_8")
    default_ok = default_kernels == {
        "canny_tile_kernel": 1, "hysteresis_kernel": 0, "keep_kernel": 0,
        **{k: 1 for k in compaction}}
    for tier_name, kw in (("f32", {}), ("integer", {"integer": True}),
                          ("f16", {"grad_dtype": "f16"}),
                          ("int8", {"grad_dtype": "int8"}),
                          ("f32_fused_masks", {"fused": True})):
        first = first_planes(**kw)
        for iters in sorted({first, max(first, 60), 100}):
            lcfg = CannyConfig(hysteresis_iters=iters, **kw)
            schedule = fused_mod.hysteresis_schedule(lcfg)
            before = fused_mod.launches
            got = fused_mod.fused_detect(frames_dev, cfg=lcfg,
                                         edge_threshold=250.0, max_edges=cap)
            torch.cuda.synchronize()
            n_launch = fused_mod.launches - before
            want = ref.fused_detect(frames_dev, cfg=lcfg,
                                    edge_threshold=250.0, max_edges=cap)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            kernels = fused_schedule(lcfg, f"fused_hysteresis_{tier_name}_"
                                           f"{iters}")
            ran = {"canny_tile_kernel": 1,
                   "hysteresis_kernel": len(schedule),
                   "keep_kernel": 1 if schedule else 0,
                   **{k: 1 for k in compaction}}
            long_checks.append({
                "kernel": "fused_detect", "tier": tier_name,
                "hysteresis_iters": iters,
                "path": "planes" if schedule else "tile",
                "passes_a_launch": schedule, "kernels_traced": kernels,
                "launches": n_launch, "counts": got[2].tolist(),
                "bit_exact_vs_card_plain": same,
                "ms": device_ms(lambda c=lcfg: fused_mod.fused_detect(
                    frames_dev, cfg=c, edge_threshold=250.0,
                    max_edges=cap)),
                "ok": same and n_launch == 1 and kernels == ran
                and bool(schedule)})
    emit({"phase": "fused_long_hysteresis", "hw": [H, W],
          "batch": DEPLOY_BATCH, "note": "device ms of one call, the least "
          "of 10; counts: edges kept a frame",
          "default_8_passes": {
              "kernels_traced": default_kernels,
              "ms": device_ms(lambda: fused_mod.fused_detect(
                  frames_dev, cfg=default_cfg, edge_threshold=250.0,
                  max_edges=cap)),
              "ok": default_ok},
          "checks": long_checks})
    bad = [c for c in long_checks if not c["ok"]]
    if bad or not default_ok:
        raise SystemExit(f"fused_detect long hysteresis failed: {bad}, "
                         f"default path {default_kernels}")

    # --- 3. the main path at 720x1280, batch 8 -----------------------------
    # Each path runs with the launch counts zeroed just before it and read
    # just after: one batch is two conv launches (Gauss, then the Sobel
    # pair) and one vote launch, on the f32 and the integer path alike.
    det_boom = LineDetector(cfg_boom)
    det_int = LineDetector(cfg_int)
    res, launches = {}, {}
    for name, det in (("boom", det_boom), ("boom+gemmini", det_int)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res[name] = det.detect_batch(frames)
        torch.cuda.synchronize()
        launches[name] = ops.launch_counts()
    main = {}
    for name, cfg in (("boom", cfg_boom), ("boom+gemmini", cfg_int)):
        want = LineDetector(cfg, device="cpu").detect_batch(frames)
        got = res[name]
        edges_eq = torch.equal(got.edges.cpu(), want.edges)
        peaks_eq = torch.equal(got.peaks.cpu(), want.peaks)
        valid_eq = torch.equal(got.valid.cpu(), want.valid)
        lines_err = (got.lines.cpu() - want.lines).abs().max().item()
        scores = aggregate_scores(score_batch(got.peaks.cpu().numpy(),
                                              got.valid.cpu().numpy(), truths))
        main[name] = {"edges_equal_cpu": edges_eq, "peaks_equal_cpu": peaks_eq,
                      "valid_equal_cpu": valid_eq,
                      "lines_max_abs_err_vs_cpu": lines_err,
                      "edge_pixels": int((want.edges > 0).sum()),
                      "max_edges_per_frame": int(
                          (want.edges > 0).reshape(DEPLOY_BATCH, -1)
                          .sum(-1).max()),
                      "lines_valid": int(want.valid.sum()),
                      "f1": scores["f1"]}
        if not (edges_eq and peaks_eq and valid_eq and lines_err < 1e-2):
            raise SystemExit(f"main path {name} differs from its CPU run: "
                             f"{main[name]}")
    emit({"phase": "main_path", "hw": [H, W], "batch": DEPLOY_BATCH,
          "families": list(MAIN_FAMILIES), "launches_by_path": launches,
          "results": main})

    # --- 3b. the batched fused detector at 720x1280, batch 8 -------------
    cfg_fused = PipelineConfig(hough=auto, fused=True)
    det_fused = LineDetector(cfg_fused)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res_fused = det_fused.detect_batch(frames)
    torch.cuda.synchronize()
    launches["fused_detector"] = ops.launch_counts()
    want = LineDetector(cfg_fused, device="cpu").detect_batch(frames)
    fused_main = {
        "peaks_equal_cpu": torch.equal(res_fused.peaks.cpu(), want.peaks),
        "valid_equal_cpu": torch.equal(res_fused.valid.cpu(), want.valid),
        "peaks_equal_staged_boom": torch.equal(res_fused.peaks,
                                               res["boom"].peaks),
        "valid_equal_staged_boom": torch.equal(res_fused.valid,
                                               res["boom"].valid),
        "lines_max_abs_err_vs_cpu": (res_fused.lines.cpu()
                                     - want.lines).abs().max().item(),
        "lines_valid": int(want.valid.sum()),
    }
    emit({"phase": "fused_detector", "hw": [H, W], "batch": DEPLOY_BATCH,
          "launches": launches["fused_detector"], "results": fused_main})
    if not all(v for k, v in fused_main.items() if k.endswith(("_cpu",
                                                               "_boom"))):
        raise SystemExit(f"fused detector differs: {fused_main}")

    # --- 3c. the tracking slice: a 32-frame drive cycle at 720x1280 ------
    cycle = make_drive_cycle("converging", 32, H, W, seed=0)
    track_cfg = PipelineConfig(hough=auto)

    def track_run(device):
        tp = TrackingPipeline(track_cfg, height=H, width=W, theta_band=40,
                              fused_corridors=8, device=device)
        frames_out = []
        for f in cycle:
            fused_before = tp.fused_frames
            if device is None:
                torch.cuda.synchronize()
                ops.reset_launch_counts()
            out = tp.process(f.scene.image)
            path = ("fused" if tp.fused_frames > fused_before
                    else "gated" if out.gated else "full")
            counts = None
            if device is None:
                torch.cuda.synchronize()
                counts = ops.launch_counts()
            frames_out.append((path, out.result.peaks.cpu(),
                               out.result.valid.cpu(),
                               [dataclasses.astuple(t) for t in out.tracks],
                               counts))
        return tp, frames_out

    tp_card, on_card = track_run(None)
    tp_cpu, on_cpu = track_run("cpu")
    differ = [i for i, (a, b) in enumerate(zip(on_card, on_cpu))
              if a[0] != b[0] or not torch.equal(a[1], b[1])
              or not torch.equal(a[2], b[2]) or a[3] != b[3]]
    track_launches = {}
    for path, *_, counts in on_card:
        track_launches.setdefault(path, []).append(counts)
    n_split = {"fused": tp_card.fused_frames, "gated": tp_card.gated_frames,
               "full": tp_card.full_frames}
    emit({"phase": "tracking", "cycle": "converging", "frames": len(cycle),
          "hw": [H, W], "theta_band": 40, "fused_corridors": 8,
          "frames_split": n_split,
          "frames_split_cpu": {"fused": tp_cpu.fused_frames,
                               "gated": tp_cpu.gated_frames,
                               "full": tp_cpu.full_frames},
          "frames_differing_from_cpu": differ,
          "launches_per_frame_by_path": {
              p: sorted({json.dumps(c, sort_keys=True) for c in cs})
              for p, cs in track_launches.items()}})
    if differ or tp_card.fused_frames != 22:
        raise SystemExit(f"tracking slice: frames {differ} differ from the "
                         f"CPU run; split {n_split} (22 fused expected)")

    # --- 4. F1 gate at 240x320 against the committed baseline -------------
    baseline = json.loads(
        (ROOT / "benchmarks" / "baselines" / "f1_baseline.json").read_text()
    )["scenarios"]
    det = LineDetector(PipelineConfig(hough=auto))
    f1 = {}
    for name in scenario_names():
        imgs, tr = scenario_batch([name] * 8, hs, ws, seed=0)
        r = det.detect_batch(imgs)
        f1[name] = aggregate_scores(
            score_batch(r.peaks.cpu().numpy(), r.valid.cpu().numpy(), tr)
        )["f1"]
    f1_bad = {n: (f1[n], baseline[n]["f1"]) for n in f1
              if f1[n] != baseline[n]["f1"]}
    emit({"phase": "f1_gate", "hw": [hs, ws], "seeds": 8, "f1": f1,
          "equal_to_baseline": not f1_bad})
    if f1_bad:
        raise SystemExit(f"per-family F1 differs from the baseline: {f1_bad}")

    # The quantized gradient tiers, staged and fused (scenario_suite.py's
    # quantized rows): int8 must equal the baseline's F1, f16 reach each
    # family's floor (its sums run in another order than the CPU's).  The
    # launch counts of each path's first batch are zeroed just before it
    # and read just after.
    qbase = json.loads((ROOT / "benchmarks" / "baselines"
                        / "f1_baseline.json").read_text())["quantized"]
    qf1, q_bad = {}, {}
    for grad in ("f16", "int8"):
        for fused in (False, True):
            path = f"{'fused' if fused else 'staged'}_{grad}"
            qdet = LineDetector(PipelineConfig(
                canny=CannyConfig(grad_dtype=grad), hough=auto, fused=fused))
            qf1[path] = {}
            for i, name in enumerate(scenario_names()):
                imgs, tr = scenario_batch([name] * 8, hs, ws, seed=0)
                if i == 0:
                    torch.cuda.synchronize()
                    ops.reset_launch_counts()
                r = qdet.detect_batch(imgs)
                if i == 0:
                    torch.cuda.synchronize()
                    launches[f"quantized_{path}"] = ops.launch_counts()
                f = aggregate_scores(score_batch(
                    r.peaks.cpu().numpy(), r.valid.cpu().numpy(), tr))["f1"]
                b = qbase[f"{name}/{grad}"]
                qf1[path][name] = {"f1": f, "baseline": b["f1"],
                                   "floor": b["f1_floor"],
                                   "minus_baseline": f - b["f1"]}
                if (f != b["f1"]) if grad == "int8" else (f < b["f1_floor"]):
                    q_bad[f"{path}/{name}"] = qf1[path][name]
    emit({"phase": "quantized_f1_gate", "hw": [hs, ws], "seeds": 8,
          "rule": "int8 equals the baseline's f1; f16 reaches f1_floor",
          "f1": qf1, "failures": q_bad})
    if q_bad:
        raise SystemExit(f"quantized F1 gate failed: {q_bad}")

    # --- 5. warm streaming with no host sync --------------------------------
    scenes = list(scenario_stream("mixed", 20, hs, ws, seed=5))
    stream_det = LineDetector(PipelineConfig(hough=auto))
    out = list(stream_det.detect_stream([s.image for s in scenes],
                                        batch_size=8))
    torch.cuda.synchronize()
    ref_batch = stream_det.detect_batch(
        np.stack([s.image for s in scenes[:8]]).astype(np.float32))
    stream_eq = all(torch.equal(out[i].peaks, ref_batch.peaks[i])
                    for i in range(8))
    emit({"phase": "stream", "frames": len(out), "batch": 8,
          "sync_debug_mode": "error", "peaks_equal_batch": stream_eq})
    if len(out) != 20 or not stream_eq:
        raise SystemExit("detect_stream disagrees with detect_batch")

    # --- 5b. the detector's serving path: DetectionService, the fleet -----
    service_launches = service_phases()
    fleet_launches = fleet_phases()

    # --- 5c. the closed loop; the paper's platform matrix ----------------
    loop_launches = closed_loop_phases()
    paper_launches = paper_platform_phases(cuda_ms)

    # --- 6. each main path went through its kernels -----------------------
    no_lm = {"flash_attention": 0, "ssd_scan": 0, "tiled_matmul": 0}
    staged_call = {"conv2d_gemm": 2, "fused_detect": 0, "hough_vote": 1,
                   **no_lm}
    fused_call = {"conv2d_gemm": 0, "fused_detect": 1, "hough_vote": 1,
                  **no_lm}
    expected = {"boom": staged_call, "boom+gemmini": staged_call,
                "fused_detector": fused_call}
    for grad in ("f16", "int8"):
        expected[f"quantized_staged_{grad}"] = staged_call
        expected[f"quantized_fused_{grad}"] = fused_call
    wrong = {p: c for p, c in launches.items() if c != expected[p]}
    per_frame = {"fused": fused_call, "gated": staged_call,
                 "full": staged_call}
    for path, cs in track_launches.items():
        if any(c != per_frame[path] for c in cs):
            wrong[f"tracking_{path}_frame"] = cs
    emit({"phase": "main_path_launches", "launches_by_path": launches,
          "expected_per_path": expected,
          "tracking_expected_per_frame": per_frame,
          "tracking_frames_checked": {p: len(cs)
                                      for p, cs in track_launches.items()}})
    if wrong:
        raise SystemExit(f"main path launches differ from the contract: "
                         f"{wrong}")

    # --- 7. times at the main-path shapes ------------------------------------
    import torch.nn.functional as F

    # Each path's own launches: its conv type and masks, its edge maps.
    # int32 operations are counted at the f32 rate (the peak table has no
    # int32 rate); every conv launch here is bounded by its bytes either way.
    trig = trig_c.to(dev)
    T = trig.shape[1]
    conv_times, vote_times = {}, {}
    for path, cfg in (("boom", cfg_boom), ("boom+gemmini", cfg_int)):
        integer = cfg.canny.integer
        masks = device_masks(cfg.canny, dev)
        x = frames_dev.to(torch.int32) if integer else frames_dev
        g = conv_mod.conv2d_gemm(x, masks[0])[:, 0]
        nr = (g // int(GAUSS_NORM) if integer else g).contiguous()
        stages = []
        for stage, inp, m in (("gauss_1x5x5", x, masks[0]),
                              ("sobel_2x3x3", nr, masks[1])):
            M, kh, kw = m.shape
            px = inp.numel()
            n_bytes = (px * inp.element_size() + px * M * 4
                       + m.numel() * m.element_size())
            b, by = bound_ms(n_bytes, 2.0 * px * M * kh * kw)
            w4 = m[:, None].contiguous()
            stages.append({
                "stage": stage, "shape": list(inp.shape),
                "dtype": str(inp.dtype).removeprefix("torch."),
                "ms": device_ms(lambda: conv_mod.conv2d_gemm(inp, m)),
                "plain_ms": cuda_ms(lambda: ref.conv2d_gemm(inp, m), reps=5),
                # cuDNN has no integer convolution
                "library_ms": None if integer else cuda_ms(lambda: F.conv2d(
                    inp[:, None], w4, padding=(kh // 2, kw // 2))),
                "bound_ms": b, "bound_by": by,
                "bytes": n_bytes, "flops": 2.0 * px * M * kh * kw,
            })
        conv_times[path] = stages

        edges_dev = res[path].edges.reshape(DEPLOY_BATCH, -1)
        w_dev = (edges_dev >= 250).float()
        cxy, cw, cnt = ops.compact_edges(_device_raster(H, W, dev), w_dev,
                                         max_edges=cap)
        vb, vby, edge_rows = vote_bound(cxy, cw, trig, n_rho, cnt)
        binv = torch.floor(ref.rho_product(cxy, trig)).long()
        rows = (torch.arange(cap, device=dev)[None, :, None]
                < cnt[:, None, None])
        keep = rows & (cw[..., None] > 0) & (binv >= 0) & (binv < n_rho)
        flat = (torch.arange(DEPLOY_BATCH, device=dev)[:, None, None]
                * (n_rho * T) + binv * T + torch.arange(T, device=dev))[keep]
        ones = torch.ones_like(flat, dtype=torch.float32)
        vote_times[path] = {
            "ms": device_ms(lambda: vote_mod.hough_vote(
                cxy, cw, trig, n_rho=n_rho, counts=cnt)),
            "plain_ms": cuda_ms(lambda: ref.hough_vote(
                cxy, cw, trig, n_rho=n_rho), reps=5),
            "library_ms": cuda_ms(lambda: torch.bincount(
                flat, weights=ones, minlength=DEPLOY_BATCH * n_rho * T)),
            "bound_ms": vb, "bound_by": vby, "edge_rows": edge_rows,
            "edge_rows_per_frame": cnt.tolist(),
            "votes_cast": int(flat.numel()), "cap_rows": cap,
            "n_rho": n_rho, "n_theta": T,
        }
    emit({"phase": "conv_times", "by_path": conv_times})
    emit({"phase": "vote_times", "by_path": vote_times})

    # The vote at each main-path shape (vote_shapes): the device time of
    # one wrapper call (device_ms; its zeroed output, where its plan needs
    # one, included) beside the bound, with the launch plan; with --parent
    # the parent commit's kernel on the same operands (its zeroed output
    # included), in turns (parent, this, this, parent), and whether the two
    # agree bit for bit.
    parent_vote = parent_vote_kernel(args.parent) if args.parent else None
    vote_rows = []
    for name, (xy, w, trig_s, nr, cnt) in vote_shapes(frames_dev,
                                                       truths).items():
        N, P = w.shape
        b, by, rows = vote_bound(xy, w, trig_s, nr, cnt)
        plan = vote_mod.launch_plan(
            N, P, trig_s.shape[1], nr,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        run = (lambda xy=xy, w=w, t=trig_s, nr=nr, c=cnt:
               vote_mod.hough_vote(xy, w, t, n_rho=nr, counts=c))
        row = {"shape": name, "frames": N, "rows": P,
               "n_theta": trig_s.shape[1], "n_rho": nr,
               "edge_rows": rows,
               "edge_rows_per_frame": (cnt.tolist() if cnt is not None else
                                       (w != 0).sum(dim=1).tolist()),
               "bound_ms": b, "bound_by": by,
               "plan": {k: plan[k] for k in ("bt", "splits", "rho_ranges",
                                             "blocks", "smem_bytes",
                                             "zeroed")},
               "gather_blocks": plan["gather_blocks"] if cnt is None else 0}
        if parent_vote is None:
            row["ms"] = device_ms(run)
        else:
            prun = (lambda xy=xy, w=w, t=trig_s, nr=nr, c=cnt:
                    parent_vote(xy, w, t, nr, c))
            turns = [device_ms(f) for f in (prun, run, run, prun)]
            row.update(ms=min(turns[1:3]), parent_ms=min(turns[0], turns[3]),
                       ms_turns=turns[1:3],
                       parent_ms_turns=[turns[0], turns[3]],
                       bit_exact_vs_parent=torch.equal(run(), prun()))
        vote_rows.append(row)
    emit({"phase": "vote_shape_times", "rows": vote_rows})
    differ = [r["shape"] for r in vote_rows
              if not r.get("bit_exact_vs_parent", True)]
    if differ:
        raise SystemExit(f"hough_vote differs from the parent's kernel: "
                         f"{differ}")

    # Every conv launch of the staged Canny (each tier's Gauss and Sobel at
    # 8x720x1280, the fused 7x7 set, one gated tracking frame's pair), as
    # the main path gives it: recorded from a canny() call.  Device time of
    # one launch (device_ms); with --parent the parent commit's kernel on
    # the same inputs, in turns (parent, this, this, parent), and whether
    # the two agree bit for bit.  Bound as in conv_times; beside it the
    # device time of one torch clone that moves the launch's bytes (half
    # read, half written): the memory rate the card reaches on the same
    # traffic.
    parent_conv = parent_conv_kernel(args.parent) if args.parent else None

    def canny_convs(x, cfg):
        seen = []
        own = conv_mod.conv2d_gemm

        def spy(image, masks, **kw):
            seen.append((image, masks))
            return own(image, masks, **kw)

        conv_mod.conv2d_gemm = spy
        try:
            canny(x, cfg)
        finally:
            conv_mod.conv2d_gemm = own
        return seen

    conv_rows = []
    for label, x, cfg in (
            ("f32", frames_dev, CannyConfig()),
            ("int32", frames_dev, CannyConfig(integer=True)),
            ("f16", frames_dev, CannyConfig(grad_dtype="f16")),
            ("int8", frames_dev, CannyConfig(grad_dtype="int8")),
            ("fused_f32", frames_dev, CannyConfig(fused=True)),
            ("frame_f32", frames_dev[1], CannyConfig())):
        for inp, m in canny_convs(x, cfg):
            M, kh, kw = m.shape
            px = inp.numel()
            acc_size = 2 if inp.dtype == torch.float16 else 4
            n_bytes = (px * inp.element_size() + px * M * acc_size
                       + m.numel() * m.element_size())
            b, by = bound_ms(n_bytes, 2.0 * px * M * kh * kw)
            run = (lambda inp=inp, m=m: conv_mod.conv2d_gemm(inp, m))
            same_bytes = torch.empty(n_bytes // 2, dtype=torch.uint8,
                                     device=dev)
            row = {"tier": label, "shape": list(inp.shape),
                   "masks": list(m.shape),
                   "dtype": str(inp.dtype).removeprefix("torch."),
                   "instance": conv_mod.instance(kh, kw),
                   "bound_ms": b, "bound_by": by,
                   "copy_same_bytes_ms": device_ms(same_bytes.clone)}
            if parent_conv is None:
                row["ms"] = device_ms(run)
            else:
                prun = (lambda inp=inp, m=m: parent_conv(inp, m))
                turns = [device_ms(f) for f in (prun, run, run, prun)]
                row.update(ms=min(turns[1:3]),
                           parent_ms=min(turns[0], turns[3]),
                           ms_turns=turns[1:3],
                           parent_ms_turns=[turns[0], turns[3]],
                           bit_exact_vs_parent=torch.equal(run(), prun()))
            conv_rows.append(row)
    emit({"phase": "conv_shape_times", "rows": conv_rows,
          "pair_ms": {t: sum(r["ms"] for r in conv_rows if r["tier"] == t)
                      for t in ("f32", "int32", "f16", "int8", "frame_f32")},
          "parent_pair_ms": None if parent_conv is None else {
              t: sum(r["parent_ms"] for r in conv_rows if r["tier"] == t)
              for t in ("f32", "int32", "f16", "int8", "frame_f32")}})
    differ = [r for r in conv_rows if not r.get("bit_exact_vs_parent", True)]
    if differ:
        raise SystemExit(f"conv2d_gemm differs from the parent's kernel: "
                         f"{differ}")

    # fused_detect at its two main-path shapes: the batched detector's
    # (8 frames, no corridors) and a tracking frame's (1 frame, 8 real
    # corridors).  Bound: the frame read once, the whole output buffer
    # written once; operations: per pixel the Gauss and Sobel FMAs (2 x 43)
    # and 7 for magnitude and direction, plus 3 per corridor row for each
    # edge pixel (the kernel tests corridors on edges only).  No PyTorch
    # call computes this function, so no library time.  The kernel's time
    # is the device time of one call (device_ms); the plain version's, 5
    # calls back to back (cuda_ms: its host launches outlast device_ms's
    # sleep).  With --parent, the parent commit's kernel on the same
    # frames, timed in turns with this one.
    parent_fused = parent_fused_kernel(args.parent) if args.parent else None

    @contextlib.contextmanager
    def parent_kernel_swapped():
        """``fused_mod.fused_detect`` replaced by the parent's kernel (with
        its wrapper's shape handling), so that a whole detector or tracking
        loop runs on it; the launch counts do not see it."""
        def run(image, corridors=None, *, cfg, edge_threshold, max_edges):
            squeeze = image.ndim == 2
            img = (image[None] if squeeze else image).to(
                torch.float32).contiguous()
            cor = (None if corridors is None
                   else corridors.to(torch.float32).contiguous())
            out = parent_fused(img, cor, cfg, max_edges, edge_threshold)
            return tuple(t[0] for t in out) if squeeze else out

        own = fused_mod.fused_detect
        fused_mod.fused_detect = run
        try:
            yield
        finally:
            fused_mod.fused_detect = own

    def fused_vs_parent(run, prun, name):
        """Device time of one call of ``run`` and its device kernels from a
        profiled window of three calls; with the parent's kernel ``prun``
        the same for it, timed in turns (parent, this, this, parent), and
        whether the two give the same outputs."""
        row = {"phases_ms_per_launch": kernel_phases(gpu_trace(run, name, 3),
                                                     3)}
        if prun is None:
            row["ms"] = device_ms(run)
            return row
        turns = [device_ms(f) for f in (prun, run, run, prun)]
        row.update(ms=min(turns[1:3]), parent_ms=min(turns[0], turns[3]),
                   ms_turns=turns[1:3], parent_ms_turns=[turns[0], turns[3]])
        row["bit_exact_vs_parent"] = all(
            torch.equal(a, b) for a, b in zip(run(), prun()))
        row["parent_phases_ms_per_launch"] = kernel_phases(
            gpu_trace(prun, f"{name}_parent", 3), 3)
        return row

    fused_times = {}
    cor_dev = torch.from_numpy(real_cor).to(dev)
    for name, x, c in (("fused_detector", frames_dev, None),
                       ("tracking_frame", frames_dev[1:2], cor_dev)):
        n_img = x.shape[0]
        cxy, cw, cnt = fused_mod.fused_detect(
            x, c, cfg=CannyConfig(), edge_threshold=250.0, max_edges=cap)
        edge_px = int((ref.fused_weights(x, cfg=CannyConfig(),
                                         edge_threshold=250.0) > 0).sum())
        n_cor = 0 if c is None else c.shape[0]
        fb, fby = bound_ms(x.numel() * 4 + n_cor * 16
                           + n_img * cap * 16 + n_img * 4,
                           x.numel() * 93.0 + edge_px * 3.0 * n_cor)
        fused_times[name] = {
            "frames": n_img, "corridors": n_cor, "edge_pixels": edge_px,
            "rows_kept": int(cnt.sum()), "max_edges": cap,
            **fused_vs_parent(
                lambda: fused_mod.fused_detect(
                    x, c, cfg=CannyConfig(), edge_threshold=250.0,
                    max_edges=cap),
                None if parent_fused is None else
                (lambda: parent_fused(x, c, CannyConfig(), cap)),
                f"fused_detect_{name}"),
            # the plain version on the card: torch ops, with the Canny
            # conv stages through the conv kernel
            "plain_ms": cuda_ms(lambda: ref.fused_detect(
                x, cfg=CannyConfig(), edge_threshold=250.0, max_edges=cap,
                corridors=c), reps=5),
            "library_ms": None, "bound_ms": fb, "bound_by": fby,
        }
    emit({"phase": "fused_times", "by_shape": fused_times})

    # The gradient tiers at the batched detector's shape, beside the f32
    # tier: the device time of one call, and each of the kernel's phases
    # (int8's pre-pass, the tile, the compaction) from one profiled window
    # of three calls; the parent's beside them with --parent.  The bound
    # is the f32 tier's: the frames read once and the buffer written once,
    # the operations counted at the f32 rate (the peak table has no f16
    # FMA or int32 rate).
    tier_times = {}
    for grad in ("f32", "f16", "int8"):
        tcfg = CannyConfig(grad_dtype=grad)
        tier_times[grad] = {
            **fused_vs_parent(
                lambda c=tcfg: fused_mod.fused_detect(
                    frames_dev, cfg=c, edge_threshold=250.0, max_edges=cap),
                None if parent_fused is None else
                (lambda c=tcfg: parent_fused(frames_dev, None, c, cap)),
                f"fused_detect_{grad}"),
            "plain_ms": cuda_ms(lambda c=tcfg: ref.fused_detect(
                frames_dev, cfg=c, edge_threshold=250.0, max_edges=cap),
                reps=5),
            "library_ms": None,
            "bound_ms": fused_times["fused_detector"]["bound_ms"],
            "bound_by": fused_times["fused_detector"]["bound_by"]}
    emit({"phase": "fused_tier_times", "hw": [H, W], "batch": DEPLOY_BATCH,
          "by_grad_dtype": tier_times})
    differ = [k for k, r in [*fused_times.items(), *tier_times.items()]
              if not r.get("bit_exact_vs_parent", True)]
    if differ:
        raise SystemExit(f"fused_detect differs from the parent's kernel: "
                         f"{differ}")

    # the fused plan against the gated staged plan on one tracked frame,
    # same bins and corridors, host clock to synchronize (in turns)
    tp = TrackingPipeline(track_cfg, height=H, width=W, theta_band=40,
                          fused_corridors=8)
    bins = cors = None
    for f in cycle:
        bins = tp.tracker.gate_bins(tp.n_theta, band=40)
        cors = tp.tracker.corridors(8)
        if bins is not None and cors is not None:
            break
        tp.process(f.scene.image)
    img_dev = torch.from_numpy(f.scene.image.astype(np.float32)).to(dev)

    def plan_ms(run, reps=20):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    plan_cmp = {"frame": f.t, "plain_gated_ms": [], "fused_ms": []}
    orders = ("gated", "fused", "fused", "gated")
    if parent_fused is not None:
        plan_cmp["fused_ms_parent_kernel"] = []
        orders = ("gated", "parent", "fused", "fused", "parent", "gated")
    for order in orders:
        if order == "gated":
            plan_cmp["plain_gated_ms"].append(plan_ms(
                lambda: tp.gated_plan.run(img_dev, bins)))
        elif order == "fused":
            plan_cmp["fused_ms"].append(plan_ms(
                lambda: tp.fused_plan.run(img_dev, bins, cors)))
        else:
            with parent_kernel_swapped():
                plan_cmp["fused_ms_parent_kernel"].append(plan_ms(
                    lambda: tp.fused_plan.run(img_dev, bins, cors)))

    def swapped(parent):
        return parent_kernel_swapped() if parent else contextlib.nullcontext()

    def runs_in_turns(measure):
        """``measure(parent)`` three times over, in turns (parent, this,
        this, parent) with --parent, else four runs of this tree's: the
        runs of each, in order."""
        turns = (False,) * 4 if parent_fused is None else (
            (True, False, False, True) * 3)
        runs = {False: [], True: []}
        for parent in turns:
            with swapped(parent):
                runs[parent].append(measure(parent))
        return runs

    def spread(xs):
        return {"runs": xs, "median": float(np.median(xs)), "min": min(xs),
                "max": max(xs)}

    def loop_fps(parent):
        t0 = time.perf_counter()
        track_run(None)
        return len(cycle) / (time.perf_counter() - t0)

    loop = runs_in_turns(loop_fps)
    plan_cmp["tracking_loop"] = {
        "frames": len(cycle), "frames_per_s": spread(loop[False]),
        "note": "launch counting syncs each frame; the tracker reads each "
                "frame's peaks back to the host anyway"}
    if parent_fused is not None:
        plan_cmp["tracking_loop_parent_kernel"] = {
            "frames": len(cycle), "frames_per_s": spread(loop[True])}
    emit({"phase": "fused_plan_vs_gated_plan", "hw": [H, W], **plan_cmp})

    def batch_ms(d):
        d.detect_batch(frames_dev)
        torch.cuda.synchronize()
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            d.detect_batch(frames_dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def batch_numbers(ms):
        return {"ms_per_batch": spread(ms),
                "frames_per_s": DEPLOY_BATCH / float(np.median(ms)) * 1e3}

    e2e = {name: batch_numbers([batch_ms(d)]) for name, d in (
        ("boom", det_boom), ("boom+gemmini", det_int))}
    # the fused detector in turns with the parent's kernel (--parent)
    fused_runs = runs_in_turns(lambda parent: batch_ms(det_fused))
    e2e["fused_detector"] = batch_numbers(fused_runs[False])
    if parent_fused is not None:
        e2e["fused_detector_parent_kernel"] = batch_numbers(fused_runs[True])
    emit({"phase": "end_to_end", "hw": [H, W], "batch": DEPLOY_BATCH,
          "input": "device-resident batch, host clock to synchronize",
          "results": e2e})

    # --- 8. where the time goes in a main-path batch ----------------------
    # "boom": stage times on the stream by CUDA events (gaps where the card
    # waits for the host's launches included); then, for "boom" and the
    # fused detector, one profiled window each.
    from repro_torch.core.hough import hough_transform_tiered
    from repro_torch.core.lines import get_lines

    plan = det_boom.plan_for(H, W, batch=DEPLOY_BATCH)
    edges8 = canny(frames_dev, plan.cfg.canny)
    votes8 = hough_transform_tiered(edges8, plan.cfg.hough, plan.tiers,
                                    scatter=False)
    stage_ms = {
        "canny": cuda_ms(lambda: canny(frames_dev, plan.cfg.canny), reps=10),
        "hough": cuda_ms(lambda: hough_transform_tiered(
            edges8, plan.cfg.hough, plan.tiers, scatter=False), reps=10),
        "get_lines": cuda_ms(lambda: get_lines(
            votes8, height=H, width=W, cfg=plan.cfg.lines), reps=10),
    }
    def profiled(det, config, name, extra):
        """One profiled window of three batches: every GPU activity of the
        trace, summed by name."""
        n_traced = 3
        t = gpu_trace(lambda: det.detect_batch(frames_dev), name, n_traced)
        emit({"phase": "where_the_time_goes", "config": config, **extra,
              "traced_batches": n_traced,
              "gpu_activities": t["gpu_activities"],
              "gpu_activities_per_batch": t["gpu_activities"] / n_traced,
              "device_busy_ms_per_batch": t["device_busy_ms"] / n_traced,
              "device_span_ms_per_batch": t["device_span_ms"] / n_traced,
              "device_busy_share_of_span": t["device_busy_share_of_span"],
              "traced_wall_ms_per_batch": t["traced_wall_ms"] / n_traced,
              "top": [{"name": e["name"],
                       "calls_per_batch": e["calls"] / n_traced,
                       "ms_per_batch": e["ms"] / n_traced}
                      for e in t["top"]],
              "trace": t["trace"]})

    profiled(det_boom, "boom, auto compact", "main_path",
             {"stage_ms": stage_ms})
    profiled(det_fused, "fused detector, auto compact", "fused_detector", {})
    if parent_fused is not None:
        with parent_kernel_swapped():
            profiled(det_fused, "fused detector, auto compact, the parent's "
                     "fused_detect kernel", "fused_detector_parent_kernel", {})

    def conv_numbers(path):
        st = conv_times[path]     # the path's two launches of one batch
        lib = [c["library_ms"] for c in st]
        return {"ms": sum(c["ms"] for c in st),
                "plain_ms": sum(c["plain_ms"] for c in st),
                "bound_ms": sum(c["bound_ms"] for c in st),
                "bound_by": ("bytes" if all(c["bound_by"] == "bytes"
                                            for c in st) else "operations"),
                "library_ms": None if None in lib else sum(lib)}

    def vote_numbers(path):
        return {k: vote_times[path][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # Each staged kernel's launches and times are those of the "boom" (f32)
    # main path, fused_detect's those of the batched fused detector;
    # "by_path" gives every path's own, each read from its own run.
    paths = ("boom", "boom+gemmini")
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "path": "boom",
         "launches": launches["boom"][name], "max_abs_err": err,
         **numbers("boom"),
         "by_path": {p: {"launches": launches[p][name], **numbers(p)}
                     for p in paths}}
        for name, source, replaces, err, numbers in (
            ("conv2d_gemm", "src/repro_torch/kernels/csrc/conv2d.cu",
             "src/repro/kernels/conv2d_gemm.py:87", conv_err, conv_numbers),
            ("hough_vote", "src/repro_torch/kernels/csrc/hough_vote.cu",
             "src/repro/kernels/hough_vote.py:108", vote_err, vote_numbers),
        )
    ]
    kernels.append({
        "name": "fused_detect", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_detect.cu",
        "replaces": "src/repro/kernels/fused_detect.py:83",
        "path": "fused_detector",
        "launches": launches["fused_detector"]["fused_detect"],
        "max_abs_err": fused_err,
        **{k: fused_times["fused_detector"][k] for k in keys},
        "by_path": {
            "fused_detector": {
                "launches": launches["fused_detector"]["fused_detect"],
                **{k: fused_times["fused_detector"][k] for k in keys}},
            "tracking_fused_frame": {
                "launches": per_frame["fused"]["fused_detect"],
                "frames": tp_card.fused_frames,
                **{k: fused_times["tracking_frame"][k] for k in keys}},
            **{f"fused_detector_{g}": {
                "launches": launches[f"quantized_fused_{g}"]["fused_detect"],
                **{k: tier_times[g][k] for k in keys}}
               for g in ("f16", "int8")},
        }})
    # the serving path's launches, from its own runs (counts zeroed just
    # before each configuration's traffic and read just after)
    for k in kernels:
        for name, counts in service_launches.items():
            k["by_path"][f"detection_service_{name}"] = {
                "launches": counts[k["name"]]}
        for name, counts in fleet_launches.items():
            k["by_path"][f"fleet_{name}"] = {"launches": counts[k["name"]]}
        # the closed loop's arms, 48 frames each, and the paper's
        # platforms, one frame each, counted the same way
        for name, counts in loop_launches.items():
            k["by_path"][f"closed_loop_{name}"] = {
                "launches": counts[k["name"]]}
        for name, counts in paper_launches.items():
            k["by_path"][f"paper_platform_{name}"] = {
                "launches": counts[k["name"]]}
    kernels += lm_phases(cuda_ms, args.parent)
    # the training slice's launches, from its own run (counts zeroed just
    # before launch.train.main and read just after) and from one step
    train = train_phases()
    for k in kernels:
        if k["name"] in train["launches"]:
            k["by_path"] = {
                "zamba2_serve": {"launches": k["launches"]},
                "train": {"launches": train["launches"][k["name"]],
                          "launches_per_step": train["per_step"][k["name"]]}}
    # the sharding layer: the train step, a decode and the detector batch
    # placed on one-device meshes, each against its unplaced run
    for name, by_path in sharding_phases(train["peak_memory_gb"]).items():
        entry = next(k for k in kernels if k["name"] == name)
        entry.setdefault("by_path", {})["sharding"] = by_path
    # elastic restarts: the cut zamba2-1.2b's faulty supervised run, the
    # counts zeroed just before run_with_restarts and read just after
    for name, by_path in elastic_phase().items():
        entry = next(k for k in kernels if k["name"] == name)
        entry["by_path"]["elastic"] = by_path
    # int8 error-feedback compression: the gradients of one train step (the
    # counts zeroed just before it and read just after), reduced over a
    # one-card pod mesh
    for name, by_path in compression_phase().items():
        entry = next(k for k in kernels if k["name"] == name)
        entry["by_path"]["compression"] = by_path
    # the pod-compressed step: the CLI's --compress-pod run (counts zeroed
    # just before launch.train.main and read just after) and two ranks on
    # the card (each rank's counts from its own steps)
    for name, by_path in pod_compressed_phase(train).items():
        entry = next(k for k in kernels if k["name"] == name)
        entry["by_path"]["pod_compressed"] = by_path["p1"]
        entry["by_path"]["pod_compressed_p2"] = by_path["p2"]
    train_times = train_shape_times()
    for k in kernels:
        if k["name"] in train_times:
            k["by_path"]["train"]["forward_launch_at_train_shape"] = \
                train_times[k["name"]]
    # the remaining dense families, Mamba-1 and MoE, each from its own run
    attn_entry = next(k for k in kernels if k["name"] == "flash_attention")
    for arch, entry in lm_family_phases().items():
        attn_entry["by_path"][f"lm_families_{arch}"] = entry
    # expert parallelism: moonshot's prefills under activate, the counts
    # zeroed just before each and read just after
    attn_entry["by_path"]["moe_ep"] = moe_ep_phase()["flash_attention"]
    # the cross-attention families: the kernel's non-causal and
    # cross-length forms, each from its own run
    for arch, entry in lm_context_phases().items():
        attn_entry["by_path"][f"lm_context_families_{arch}"] = entry
    emit({"phase": "trace_fences", "note": "gpu_trace's checks: traces "
          "taken, whole, taken again; tries that lost primer spins, the "
          "closing spin, or a launch's device record; launches in the "
          "traces kept; by the process's age, the first try's primer "
          "spins lost, closing spin lost, launches unrecorded",
          "traces": len(TRACES),
          "whole": sum(t["whole"] for t in TRACES),
          "taken_again": sum(len(t["losses"]) > 1 for t in TRACES),
          "tries": sum(len(t["losses"]) for t in TRACES),
          "tries_losing_primer_spins": sum(
              f["primer_spins_lost"] > 0 for t in TRACES
              for f in t["losses"]),
          "most_primer_spins_lost": max(
              (f["primer_spins_lost"] for t in TRACES for f in t["losses"]),
              default=0),
          "tries_losing_closing_spin": sum(
              f["closing_spin_lost"] for t in TRACES for f in t["losses"]),
          "tries_with_launches_unrecorded": sum(
              f["launches_without_device_record"] > 0 for t in TRACES
              for f in t["losses"]),
          "launches_traced": sum(t["losses"][-1]["launches"]
                                 for t in TRACES),
          "first_try_by_age": [
              [round(t["age_s"], 1), t["losses"][0]["primer_spins_lost"],
               t["losses"][0]["closing_spin_lost"],
               t["losses"][0]["launches_without_device_record"]]
              for t in TRACES],
          "not_whole": [t["name"] for t in TRACES if not t["whole"]]})
    emit({"phase": "wall", "seconds": time.perf_counter() - STARTED,
          "seconds_limit": 1200})
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
