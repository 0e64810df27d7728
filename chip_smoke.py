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
NaN frames) that must end every request.

Every phase prints one JSON line; any failure raises and exits non-zero.
The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
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
    attn_err = 0.0
    for (B, Hq, Hkv, Lq, Lkv, D), causal, window, off, dt, qs in attn_cases:
        q = randn(B, Hq, Lq, D, scale=qs).to(dt)
        k, v = (randn(B, Hkv, Lkv, D, dtype=dt) for _ in range(2))
        got = attn_mod.flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=off)
        torch.cuda.synchronize()
        want = ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
        g, w = got.float(), want.float()
        err = float((g - w).abs().max())
        if dt == torch.bfloat16:
            mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            tol = ulp + 1e-5 * float(v.float().abs().max())
            ok = bool(((g - w).abs() <= tol).all())
            beyond_ulp = int(((g - w).abs() > ulp).sum())
            rule = "1 bf16 ulp + 1e-5*max|v|"
        else:
            ok = bool(torch.allclose(g, w, rtol=1e-5, atol=1e-5))
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
    class Probe:
        """The model, with the launch counts zeroed just before each
        prefill and decode step and read just after (host clock to
        synchronize around each), and each active slot's decode logits."""

        def __init__(self, m):
            self.m, self.engine = m, None
            self.prefills, self.decodes, self.logits = [], [], {}

        def __getattr__(self, name):
            return getattr(self.m, name)

        def _timed(self, fn):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3, ops.launch_counts()

        def prefill(self, params, batch, cache, *, positions=None):
            out, ms, counts = self._timed(lambda: self.m.prefill(
                params, batch, cache, positions=positions))
            self.prefills.append({
                "tokens": int(batch["tokens"].shape[1]), "ms": ms,
                "launches": counts,
                "finite": bool(torch.isfinite(out[0]).all())})
            return out

        def decode_step(self, params, token, cache, pos, *, ring=False):
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

    def serve_traffic(model, params, prompts, new_tokens):
        """One Engine run of the traffic through the probe."""
        probe = Probe(model)
        eng = Engine(probe, params, n_slots=SERVE_SLOTS,
                     max_len=SERVE_MAX_LEN, device="cuda")
        probe.engine = eng
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=new_tokens)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        return probe, eng, reqs, time.perf_counter() - t0

    def teacher_forced(model, params, probe, reqs):
        """Each request's decode-path logits (its first, middle and last
        step) against a fresh prefill of the same tokens on the card: the
        largest difference and the largest |logit|."""
        err = scale = 0.0
        for r in reqs:
            seq = r.prompt + r.output
            for k in (0, SERVE_NEW // 2 - 1, SERVE_NEW - 1):
                n = len(r.prompt) + k
                lg, _ = model.prefill(
                    params, {"tokens": torch.tensor([seq[:n]], device=dev)},
                    model.init_cache(1, SERVE_MAX_LEN))
                want = lg[0].float().cpu()
                err = max(err, float((want - probe.logits[(r.uid, k)])
                                     .abs().max()))
                scale = max(scale, float(want.abs().max()))
        return err, scale

    def launch_faults(probe, per_prefill):
        """Prefills whose launches differ from ``per_prefill`` (every other
        kernel 0), and decode steps that launched any kernel."""
        bad_p = [c for c in probe.prefills
                 if c["launches"] != {**{k: 0 for k in c["launches"]},
                                      **per_prefill}]
        return bad_p, [c for c in probe.decodes if any(c["launches"].values())]

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
    tf_bf16, scale_bf16 = teacher_forced(model, params, probe, reqs)
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
    tf_f32, scale_f32 = teacher_forced(model32, params32, probe32, reqs32)
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
        flops = flops_per_head = 0.0
        for c0 in range(0, L, 128):
            r = min(128, L - c0)
            flops += (G * r * (r + 1) * N + H * r * (r + 1) * P
                      + 4.0 * H * r * N * P)
            flops_per_head += H * (r * (r + 1) * (N + P) + 4.0 * r * N * P)
        flops += L * H * P                            # x * dt
        flops_per_head += L * H * P
        n_bytes = 4 * (2 * L * H * P + L * H + H + 2 * L * G * N + H * N * P)
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

    def mean_row(rows):
        out = {k: sum(r[k] for r in rows) / len(rows)
               for k in ("ms", "plain_ms", "bound_ms")}
        lib = [r["library_ms"] for r in rows]
        out["library_ms"] = None if None in lib else sum(lib) / len(lib)
        out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                          for r in rows) else "operations")
        return out

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
    from repro_torch.serve import (
        DetectionRequest, DetectionService, RequestStatus, VirtualClock,
    )

    H, W = DEPLOY_HW
    assert SERVICE_BUCKETS[-1] == DEPLOY_HW
    cfg = PipelineConfig(hough=HoughConfig(compact=True, max_edges="auto"))
    cycle = make_drive_cycle("converging", 32, H, W, seed=0).images()
    small = [scenario_batch(MAIN_FAMILIES, h, w, seed=2 + j)[0]
             for j, (h, w) in enumerate(SERVICE_BUCKETS[:2])]
    one_offs = [small[t % 2][t // 2] for t in range(16)]

    class Recorded(DetectionService):
        """The service, keeping every batch it retires (what ran, on the
        device, and for which requests)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.retired = []

        def _complete(self, grid, *, update_est=True):
            if grid.in_flight is not None:
                self.retired.append(grid.in_flight)
            super()._complete(grid, update_est=update_est)

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

    counter_names = (
        "dispatches", "completed", "rejected_queue_full", "shed_deadline",
        "completed_late", "downshifted", "pre_downshifted",
        "served_downshift", "served_coast", "gated_dispatches",
        "fused_dispatches", "evicted", "rejected_invalid",
        "dispatch_faults", "stager_deaths")

    def counters(svc):
        return {k: getattr(svc, k) for k in counter_names}

    def path_of(rec):
        c = rec.plan.cfg
        return ("fused" if c.fused else
                "gated" if c.hough.theta_band is not None else "full")

    def against_plan(records):
        """Each DONE request of each retired batch against the batch run
        again through its plan on the card: (checked, differing uids)."""
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

    def latency_by_bucket(svc, reqs):
        out = {}
        for shape in SERVICE_BUCKETS:
            lat = [r.latency_s * 1e3 for r in reqs if r.served
                   and svc.bucket_for(r.frame) == shape]
            out[f"{shape[0]}x{shape[1]}"] = {
                "served": len(lat),
                "p50_ms": float(np.percentile(lat, 50)) if lat else None,
                "p99_ms": float(np.percentile(lat, 99)) if lat else None}
        return out

    def statuses(reqs):
        out = {}
        for r in reqs:
            out[r.status.name] = out.get(r.status.name, 0) + 1
        return out

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
        delta = {k: after[k] - before[k] for k in counter_names}
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
              "latency_ms_by_bucket": latency_by_bucket(svc, reqs),
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

    # --- 5b. the detector's serving path: DetectionService ---------------
    service_launches = service_phases()

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
    kernels += lm_phases(cuda_ms, args.parent)
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
    emit({"phase": "wall", "seconds": time.perf_counter() - STARTED})
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
