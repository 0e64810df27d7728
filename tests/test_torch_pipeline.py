"""The port's detector end to end against the JAX package, and its rules.

Slice-level parity: ``LineDetector(device="cpu")`` and the JAX
``LineDetector`` on the same frames (all 12 scenario families at 240x320,
one seed) and the same configuration, converted with
``repro_torch.convert``.  Plus the port's own rules: the device rule, the
import rule, and the plan layer's batching and streaming contracts.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_lines import PLATFORMS as JPLATFORMS  # noqa: E402
from repro.core import HoughConfig as JHough  # noqa: E402
from repro.core import LineDetector as JLineDetector  # noqa: E402
from repro.core import PipelineConfig as JPipeline  # noqa: E402
from repro.core import aggregate_scores, score_batch  # noqa: E402
from repro.core.metrics import score_frame as jscore_frame  # noqa: E402
from repro.data import scenario_batch, scenario_names  # noqa: E402
from repro_torch.configs.paper_lines import PLATFORMS  # noqa: E402
from repro_torch.convert import pipeline_config_from_reference  # noqa: E402
from repro_torch.core import (  # noqa: E402
    HoughConfig, LineDetector, PipelineConfig, PhaseProfiler, full_corridors,
)
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core.plan import DetectionPlan  # noqa: E402
from repro_torch.data import scenarios as tscenarios  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
H, W = 240, 320
AUTO = JPipeline(hough=JHough(compact=True, max_edges="auto"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return scenario_batch(list(scenario_names()), H, W, seed=0)


def _per_family_f1(peaks, valid, truths):
    return [aggregate_scores(score_batch(peaks[i:i + 1], valid[i:i + 1],
                                         truths[i:i + 1]))["f1"]
            for i in range(len(truths))]


@pytest.mark.parametrize("jcfg", [
    dataclasses.replace(JPLATFORMS["boom"], hough=AUTO.hough),
    dataclasses.replace(JPLATFORMS["boom+gemmini"], hough=AUTO.hough),
    AUTO,
    JPipeline(hough=JHough(compact=True)),
], ids=["boom", "boom+gemmini", "auto-compact", "hand-compact"])
def test_slice_matches_reference(frames, jcfg):
    """Equal peaks, validity and edges, and equal per-family F1."""
    imgs, truths = frames
    want = JLineDetector(jcfg).detect_batch(jnp.asarray(imgs))
    det = LineDetector(pipeline_config_from_reference(dataclasses.asdict(jcfg)),
                       device="cpu")
    got = det.detect_batch(imgs)
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    np.testing.assert_allclose(got.lines.numpy(), np.asarray(want.lines),
                               rtol=0, atol=1e-3)
    f1 = _per_family_f1(got.peaks.numpy(), got.valid.numpy(), truths)
    assert f1 == _per_family_f1(np.asarray(want.peaks),
                                np.asarray(want.valid), truths)
    assert min(f1) > 0.5


def test_platforms_round_trip():
    """Every reference platform converts to the port's config and back."""
    assert set(PLATFORMS) == set(JPLATFORMS)
    for name, jcfg in JPLATFORMS.items():
        d = dataclasses.asdict(jcfg)
        cfg = pipeline_config_from_reference(d)
        # the port's HoughConfig has no kernel mode
        want = {**d, "hough": dict(d["hough"])}
        assert want["hough"].pop("impl") is None, name
        assert want["hough"]["corridors"] is None, name
        assert dataclasses.asdict(cfg) == want, name
        assert cfg == PLATFORMS[name], name


def test_conversion_maps_kernel_modes_and_rejects_unknown_fields():
    d = dataclasses.asdict(JPipeline())
    d["canny"]["impl"] = "xla"
    d["hough"]["impl"] = "pallas"
    assert pipeline_config_from_reference(d).canny.impl is None
    d["hough"]["corridors"] = 2
    assert pipeline_config_from_reference(d).hough.corridors == 2
    d["hough"]["corridors"] = None
    d["canny"]["shiny"] = True
    with pytest.raises(TypeError):
        pipeline_config_from_reference(d)


def test_fused_path_not_ported_yet(frames):
    """The fused path converts, plans and runs: a fused reference config
    maps to the port's, whose plan at full corridor coverage gives the
    staged plan's peaks; a staged config has no fused twin without
    compaction."""
    d = dataclasses.asdict(JPipeline(hough=JHough(compact=True)))
    d["fused"] = True
    cfg = pipeline_config_from_reference(d)
    assert cfg.fused and cfg.hough.compact
    imgs, _ = frames
    staged = DetectionPlan.build(dataclasses.replace(cfg, fused=False), H, W)
    fused = staged.with_fused(2)
    got = fused.run(torch.from_numpy(imgs[1]), corridors=full_corridors(2))
    want = staged.run(torch.from_numpy(imgs[1]))
    np.testing.assert_array_equal(got.peaks.numpy(), want.peaks.numpy())
    assert not got.edges.any()
    with pytest.raises(ValueError, match="compact"):
        DetectionPlan.build(PipelineConfig(), H, W).with_fused(2)


def test_device_rule_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LineDetector()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LineDetector(device="cuda")
    assert LineDetector(device="cpu").device.type == "cpu"


def test_detector_refuses_tensor_on_other_device(frames):
    det = LineDetector(device="cpu")
    with pytest.raises(ValueError):
        det._on_device(torch.zeros(2, 2, device="meta"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_port_data_makes_the_reference_frames():
    names = list(scenario_names())
    assert tscenarios.scenario_names() == tuple(names)
    a, ta = scenario_batch(names, 48, 64, seed=3)
    b, tb = tscenarios.scenario_batch(names, 48, 64, seed=3)
    np.testing.assert_array_equal(a, b)
    for x, y in zip(ta, tb):
        np.testing.assert_array_equal(x, y)
    peaks = np.array([[10.0, 0.5], [-3.0, 3.1]], np.float32)
    truth = np.array([[9.0, 0.49], [3.0, 0.02]], np.float32)
    for valid in ([True, True], [True, False], [False, False]):
        np.testing.assert_equal(
            dataclasses.astuple(tmetrics.score_frame(peaks, valid, truth)),
            dataclasses.astuple(jscore_frame(peaks, valid, truth)),
        )


def test_batch_equals_per_frame_and_padding(frames):
    imgs, _ = frames
    det = LineDetector(PipelineConfig(hough=HoughConfig(
        compact=True, max_edges="auto")), device="cpu")
    batch = det.detect_batch(imgs[:3])          # pads to the bucket of 4
    assert batch.peaks.shape == (3, 16, 2)
    assert det.plan_for(H, W, batch=4).batch == 4
    for i in range(3):
        one = det.detect(imgs[i])
        np.testing.assert_array_equal(one.peaks.numpy(),
                                      batch.peaks[i].numpy())
        np.testing.assert_array_equal(one.edges.numpy(),
                                      batch.edges[i].numpy())


def test_stream_equals_batch(frames):
    imgs, _ = frames
    det = LineDetector(PipelineConfig(hough=HoughConfig(
        compact=True, max_edges="auto")), device="cpu")
    want = det.detect_batch(imgs[:5])
    out = list(det.detect_stream(list(imgs[:5].astype(np.uint8)),
                                 batch_size=2))
    assert len(out) == 5
    for i, r in enumerate(out):
        np.testing.assert_array_equal(r.peaks.numpy(), want.peaks[i].numpy())
        np.testing.assert_array_equal(r.valid.numpy(), want.valid[i].numpy())


def test_gated_plan_at_full_band_equals_full_sweep(frames):
    imgs, _ = frames
    det = LineDetector(PipelineConfig(hough=HoughConfig(
        compact=True, max_edges="auto")), device="cpu")
    plan = det.plan_for(H, W, batch=4)
    full = plan.run(torch.from_numpy(imgs[:4]))
    gated = plan.with_theta_band(180).run(torch.from_numpy(imgs[:4]),
                                          theta_bins=np.arange(180))
    np.testing.assert_array_equal(gated.peaks.numpy(), full.peaks.numpy())
    assert plan.with_theta_band(None) is plan
    assert plan.with_render(False) is plan


def test_render_and_profiled_phases(frames):
    imgs, _ = frames
    det = LineDetector(PipelineConfig(
        hough=HoughConfig(compact=True, max_edges="auto"),
        render_output=True), device="cpu")
    rgb = np.repeat(imgs[1].astype(np.uint8)[..., None], 3, axis=-1)
    res, prof = det.detect_profiled(rgb)
    assert res.rendered.shape == (H, W, 3)
    assert [n for n, _, _ in prof.table()] == [
        "image_load", "line_detection", "image_generation"]
    stages = det.detect_stage_profiled(imgs[:2])
    assert [n for n, _, _ in stages.table()] == [
        "canny", "hough", "get_coordinates"]
    assert "total" in PhaseProfiler().report()
    cfg = det.resolve_config(imgs[:2])
    assert cfg.hough.max_edges in (512, 1024, 2048, 4096)
