#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

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

It also gates per-family F1 at 240x320 against
``benchmarks/baselines/f1_baseline.json``, streams under
``torch.cuda.set_sync_debug_mode("error")``, and times each kernel beside
its bound, its plain version and one PyTorch library call where one
computes the same function, the fused plan against the gated staged plan,
and the tracking loop.

Every phase prints one JSON line; any failure raises and exits non-zero.
The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEPLOY_BATCH = 8
MAIN_FAMILIES = ("straight", "converging", "dashed", "curved", "night",
                 "glare", "rain", "multilane")
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
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


def main() -> int:
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

    # --- 6. each main path went through its kernels -----------------------
    staged_call = {"conv2d_gemm": 2, "fused_detect": 0, "hough_vote": 1}
    fused_call = {"conv2d_gemm": 0, "fused_detect": 1, "hough_vote": 1}
    expected = {"boom": staged_call, "boom+gemmini": staged_call,
                "fused_detector": fused_call}
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
                "ms": cuda_ms(lambda: conv_mod.conv2d_gemm(inp, m)),
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
        n_votes = int(cnt.sum())
        vb, vby = bound_ms(n_votes * (3 * 4 + 4) + DEPLOY_BATCH * 4
                           + trig.numel() * 4 + DEPLOY_BATCH * n_rho * T * 4,
                           n_votes * T * 6.0)
        binv = torch.floor(ref.rho_product(cxy, trig)).long()
        rows = (torch.arange(cap, device=dev)[None, :, None]
                < cnt[:, None, None])
        keep = rows & (cw[..., None] > 0) & (binv >= 0) & (binv < n_rho)
        flat = (torch.arange(DEPLOY_BATCH, device=dev)[:, None, None]
                * (n_rho * T) + binv * T + torch.arange(T, device=dev))[keep]
        ones = torch.ones_like(flat, dtype=torch.float32)
        vote_times[path] = {
            "ms": cuda_ms(lambda: vote_mod.hough_vote(
                cxy, cw, trig, n_rho=n_rho, counts=cnt)),
            "plain_ms": cuda_ms(lambda: ref.hough_vote(
                cxy, cw, trig, n_rho=n_rho), reps=5),
            "library_ms": cuda_ms(lambda: torch.bincount(
                flat, weights=ones, minlength=DEPLOY_BATCH * n_rho * T)),
            "bound_ms": vb, "bound_by": vby, "edge_rows": n_votes,
            "votes_cast": int(flat.numel()), "cap_rows": cap,
            "n_rho": n_rho, "n_theta": T,
        }
    emit({"phase": "conv_times", "by_path": conv_times})
    emit({"phase": "vote_times", "by_path": vote_times})

    # fused_detect at its two main-path shapes: the batched detector's
    # (8 frames, no corridors) and a tracking frame's (1 frame, 8 real
    # corridors).  Bound: the frame read once, the whole output buffer
    # written once; operations: per pixel the Gauss and Sobel FMAs (2 x 43)
    # and 7 for magnitude and direction, plus 3 per corridor row for each
    # edge pixel (the kernel tests corridors on edges only).  No PyTorch
    # call computes this function, so no library time.
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
            "ms": cuda_ms(lambda: fused_mod.fused_detect(
                x, c, cfg=CannyConfig(), edge_threshold=250.0,
                max_edges=cap)),
            # the plain version on the card: torch ops, with the Canny
            # conv stages through the conv kernel
            "plain_ms": cuda_ms(lambda: ref.fused_detect(
                x, cfg=CannyConfig(), edge_threshold=250.0, max_edges=cap,
                corridors=c), reps=5),
            "library_ms": None, "bound_ms": fb, "bound_by": fby,
        }
    emit({"phase": "fused_times", "by_shape": fused_times})

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
    for order in ("gated", "fused", "fused", "gated"):
        if order == "gated":
            plan_cmp["plain_gated_ms"].append(plan_ms(
                lambda: tp.gated_plan.run(img_dev, bins)))
        else:
            plan_cmp["fused_ms"].append(plan_ms(
                lambda: tp.fused_plan.run(img_dev, bins, cors)))
    t0 = time.perf_counter()
    tp_timed, _ = track_run(None)
    loop_s = time.perf_counter() - t0
    plan_cmp["tracking_loop"] = {
        "frames": len(cycle), "seconds": loop_s,
        "frames_per_s": len(cycle) / loop_s,
        "note": "launch counting syncs each frame; the tracker reads each "
                "frame's peaks back to the host anyway"}
    emit({"phase": "fused_plan_vs_gated_plan", "hw": [H, W], **plan_cmp})

    e2e = {}
    for name, d in (("boom", det_boom), ("boom+gemmini", det_int),
                    ("fused_detector", det_fused)):
        d.detect_batch(frames_dev)
        torch.cuda.synchronize()
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            r = d.detect_batch(frames_dev)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / reps
        e2e[name] = {"ms_per_batch": sec * 1e3,
                     "frames_per_s": DEPLOY_BATCH / sec}
    del r
    emit({"phase": "end_to_end", "hw": [H, W], "batch": DEPLOY_BATCH,
          "input": "device-resident batch, host clock to synchronize",
          "results": e2e})

    # --- 8. where the time goes in a main-path batch ----------------------
    # "boom": stage times on the stream by CUDA events (gaps where the card
    # waits for the host's launches included); then, for "boom" and the
    # fused detector, one profiled window each.
    from torch.profiler import ProfilerActivity, profile

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
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_traced):
                det.detect_batch(frames_dev)
            torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3
        trace_path = ROOT / "build" / f"trace_{name}.json"
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
        gpu = [e for e in json.loads(trace_path.read_text())["traceEvents"]
               if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
        by_name: dict[str, list[float]] = {}
        for e in gpu:
            by_name.setdefault(e["name"], []).append(e["dur"] / 1e3)
        busy_ms = sum(sum(v) for v in by_name.values())
        span_ms = ((max(e["ts"] + e["dur"] for e in gpu)
                    - min(e["ts"] for e in gpu)) / 1e3) if gpu else 0.0
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
        emit({"phase": "where_the_time_goes", "config": config, **extra,
              "traced_batches": n_traced, "gpu_activities": len(gpu),
              "gpu_activities_per_batch": len(gpu) / n_traced,
              "device_busy_ms_per_batch": busy_ms / n_traced,
              "device_span_ms_per_batch": span_ms / n_traced,
              "device_busy_share_of_span": (busy_ms / span_ms if span_ms
                                            else None),
              "traced_wall_ms_per_batch": traced_wall_ms / n_traced,
              "top": [{"name": k[:90], "calls_per_batch": len(v) / n_traced,
                       "ms_per_batch": sum(v) / n_traced} for k, v in top],
              "trace": str(trace_path.relative_to(ROOT))})

    profiled(det_boom, "boom, auto compact", "main_path",
             {"stage_ms": stage_ms})
    profiled(det_fused, "fused detector, auto compact", "fused_detector", {})

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
        }})
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
