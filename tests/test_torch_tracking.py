"""The port's temporal layer against the JAX package.

Drive cycles made by both packages from the same seeds; the lane tracker
fed identical peak sequences (fixed-seed sweeps and analytic trajectories);
and ``TrackingPipeline`` with the fused path on, frame for frame against
the reference's on the same cycles: peaks, validity, the gate taken, the
reported tracks and the fused / gated / full counts.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import HoughConfig as JHough  # noqa: E402
from repro.core import PipelineConfig as JPipeline  # noqa: E402
from repro.core import tracking as jtracking  # noqa: E402
from repro.data import scenarios as jscenarios  # noqa: E402
from repro_torch.core import HoughConfig, PipelineConfig  # noqa: E402
from repro_torch.core import tracking  # noqa: E402
from repro_torch.data import scenarios  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


AUTO = dict(compact=True, max_edges="auto")


def _rng_peaks(rng, n):
    return np.column_stack([
        rng.uniform(-250.0, 250.0, n),
        rng.uniform(-0.5, math.pi + 0.5, n),
    ]) if n else np.empty((0, 2))


def _states(tr):
    return [dataclasses.astuple(t) for t in tr.tracks]


# --- drive cycles ---------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda m: m.make_drive_cycle("straight", 6, 96, 128, seed=1, sway_px=8.0,
                                 sway_period=10.0, surge_px=2.0,
                                 lane_change_at=3, lane_change_len=4),
    lambda m: m.standard_drive_cycle("rain", 12, 96, 128, seed=3),
    lambda m: m.standard_drive_cycle("multilane", 9, 72, 100, seed=2),
], ids=["sway-surge-lane-change", "rain-dropout-burst", "multilane"])
def test_drive_cycles_equal_the_reference(make):
    a, b = make(scenarios), make(jscenarios)
    assert a.family == b.family and len(a) == len(b)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa.scene.image, fb.scene.image)
        np.testing.assert_array_equal(fa.scene.lines_rho_theta,
                                      fb.scene.lines_rho_theta)
        assert (fa.t, fa.dropout, fa.noise_burst, fa.dx_px, fa.yaw_deg,
                fa.dy_px) == (fb.t, fb.dropout, fb.noise_burst, fb.dx_px,
                              fb.yaw_deg, fb.dy_px)
    assert scenarios.NOISY_FAMILIES == jscenarios.NOISY_FAMILIES


def test_transform_rho_theta_equals_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        rho, theta = rng.uniform(-300, 300), rng.uniform(0, math.pi)
        kw = dict(yaw_rad=rng.uniform(-7, 7), dx=rng.uniform(-30, 30),
                  dy=rng.uniform(-30, 30), cx=111.5, cy=83.5)
        assert (scenarios.transform_rho_theta(rho, theta, **kw)
                == jscenarios.transform_rho_theta(rho, theta, **kw))


# --- the tracker on identical peak sequences ---------------------------------------


def test_tracker_helpers_equal_the_reference():
    rng = np.random.default_rng(7)
    for _ in range(200):
        det = (rng.uniform(-200, 200), rng.uniform(-1, math.pi + 1))
        ref = (rng.uniform(-200, 200), rng.uniform(0, math.pi))
        assert (tracking.signed_residual(det, ref)
                == jtracking.signed_residual(det, ref))
        assert (tracking.wrap_canonical(*det)
                == jtracking.wrap_canonical(*det))
    for n in (0, 1, 5, 9):
        peaks = _rng_peaks(rng, n)
        peaks[1::3] = peaks[::3][:len(peaks[1::3])] + [3.0, 0.01]
        for tol in ((8.0, 2.5), (30.0, 10.0)):
            np.testing.assert_array_equal(
                tracking.merge_peaks(peaks, tol_rho=tol[0],
                                     tol_theta_deg=tol[1]),
                jtracking.merge_peaks(peaks, tol_rho=tol[0],
                                      tol_theta_deg=tol[1]))


@pytest.mark.parametrize("seed,cfg", [
    (42, {}),
    (43, {"alpha": 1.0, "beta": 0.0, "merge_rho": 0.0}),
    (44, {"confirm_hits": 3, "max_misses": 1, "rescan_frames": 2}),
], ids=["default", "alpha1-no-merge", "short-lifecycle"])
def test_tracker_sweep_equals_the_reference(seed, cfg):
    """Random detection sets, some frames empty, several frames each: equal
    reported tracks, live states, theta gates and corridors, step by step."""
    rng = np.random.default_rng(seed)
    for _ in range(15):
        a = tracking.LaneTracker(tracking.TrackerConfig(**cfg))
        b = jtracking.LaneTracker(jtracking.TrackerConfig(**cfg))
        base = _rng_peaks(rng, int(rng.integers(0, 6)))
        for _ in range(int(rng.integers(1, 9))):
            if rng.random() < 0.2:
                dets = np.empty((0, 2))
            else:  # a drifting set with jitter, sometimes one extra
                base = base + rng.normal(0, [2.0, 0.01], base.shape)
                dets = np.concatenate([base, _rng_peaks(
                    rng, int(rng.random() < 0.3))])
            valid = rng.random(dets.shape[0]) < 0.9
            ra, rb = a.step(dets, valid), b.step(dets, valid)
            assert ([dataclasses.astuple(t) for t in ra]
                    == [dataclasses.astuple(t) for t in rb])
            assert _states(a) == _states(b)
            for band in (None, 40, 12):
                ga = a.gate_bins(180, band=band)
                gb = b.gate_bins(180, band=band)
                assert (ga is None) == (gb is None)
                if ga is not None:
                    np.testing.assert_array_equal(ga, gb)
            for n in (None, 8, 2):
                ca, cb = a.corridors(n), b.corridors(n)
                assert (ca is None) == (cb is None)
                if ca is not None:
                    np.testing.assert_array_equal(ca, cb)
            assert (a.can_coast(2), a.grounded_frames) == (
                b.can_coast(2), b.grounded_frames)
            assert ([dataclasses.astuple(t) for t in a.predict_tracks(2)]
                    == [dataclasses.astuple(t) for t in b.predict_tracks(2)])


def test_tracker_on_analytic_trajectories_equals_the_reference():
    """Perfect detections of a lane-change cycle with a dropout: the two
    trackers coast, re-acquire and gate identically."""
    cyc = scenarios.make_drive_cycle("straight", 30, 240, 320, seed=0,
                                     lane_change_at=15,
                                     dropout_frames=(10, 11, 12))
    a, b = tracking.LaneTracker(), jtracking.LaneTracker()
    gated = 0
    for f in cyc:
        dets = np.empty((0, 2)) if f.dropout else f.scene.lines_rho_theta
        assert ([dataclasses.astuple(t) for t in a.step(dets)]
                == [dataclasses.astuple(t) for t in b.step(dets)])
        ga, gb = a.gate_bins(band=40), b.gate_bins(band=40)
        assert (ga is None) == (gb is None)
        if ga is not None:
            gated += 1
            np.testing.assert_array_equal(ga, gb)
            np.testing.assert_array_equal(a.corridors(8), b.corridors(8))
    assert gated > 10
    peaks, valid = tracking.tracks_as_peaks(a.tracks)
    want = jtracking.tracks_as_peaks(b.tracks)
    np.testing.assert_array_equal(peaks, want[0])
    np.testing.assert_array_equal(valid, want[1])


# --- the tracking pipeline, fused path on ----------------------------------------


def _pipelines(hw, **kw):
    got = tracking.TrackingPipeline(
        PipelineConfig(hough=HoughConfig(**AUTO)), height=hw[0],
        width=hw[1], device="cpu", **kw)
    want = jtracking.TrackingPipeline(
        JPipeline(hough=JHough(**AUTO)), height=hw[0], width=hw[1], **kw)
    return got, want


def _assert_same_run(cycle, got, want):
    for f in cycle:
        a, b = got.process(f.scene.image), want.process(f.scene.image)
        np.testing.assert_array_equal(a.result.peaks.numpy(),
                                      np.asarray(b.result.peaks))
        np.testing.assert_array_equal(a.result.valid.numpy(),
                                      np.asarray(b.result.valid))
        assert a.gated == b.gated, f.t
        assert ([dataclasses.astuple(t) for t in a.tracks]
                == [dataclasses.astuple(t) for t in b.tracks]), f.t
    counts = (got.fused_frames, got.gated_frames, got.full_frames)
    assert counts == (want.fused_frames, want.gated_frames, want.full_frames)
    return counts


def test_fused_tracking_pipeline_equals_the_reference():
    cyc = scenarios.make_drive_cycle("straight", 12, 120, 160, seed=0)
    got, want = _pipelines((120, 160), theta_band=40, fused_corridors=8)
    fused, gated, full = _assert_same_run(cyc, got, want)
    assert fused > 0 and full > 0


@pytest.mark.parametrize("family", ["rain", "night"])
def test_fused_tracking_on_noisy_harness_cycles(family):
    """The 168x224 harness cycle of a noisy family (dropout and noise
    burst): the fused, gated and full paths all run, frame for frame equal
    to the reference."""
    cyc = scenarios.standard_drive_cycle(family, 18, 168, 224, seed=0)
    got, want = _pipelines((168, 224), theta_band=40, fused_corridors=8)
    fused, gated, full = _assert_same_run(cyc, got, want)
    assert fused > 0 and full > 0


def test_tracking_pipeline_rules_and_controller():
    cfg = PipelineConfig(hough=HoughConfig(**AUTO))
    with pytest.raises(ValueError, match="fused_corridors"):
        tracking.TrackingPipeline(
            PipelineConfig(hough=HoughConfig(compact=True, corridors=4)),
            theta_band=40, device="cpu")
    with pytest.raises(ValueError, match="theta_band"):
        tracking.TrackingPipeline(cfg, theta_band=None, fused_corridors=4,
                                  device="cpu")
    with pytest.raises(ValueError, match="theta_band"):
        tracking.TrackingPipeline(
            PipelineConfig(hough=HoughConfig(theta_band=40)), device="cpu")

    class Recorder:
        def __init__(self):
            self.calls = []

        def command(self, peaks, valid):
            self.calls.append((peaks.shape, valid.shape))
            return len(self.calls)

    rec = Recorder()
    tp = tracking.TrackingPipeline(cfg, height=96, width=128, device="cpu")
    scene = scenarios.make_scenario("straight", 96, 128)
    out = [tp.process(scene.image, rec) for _ in range(3)]
    assert [o.steering for o in out] == [1, 2, 3]
    # smoothed tracks when any are reported, else the raw detections
    assert out[-1].tracks
    for o, (peaks_shape, valid_shape) in zip(out, rec.calls):
        assert peaks_shape[0] == valid_shape[0] == (len(o.tracks) or 16)


def test_tracking_pipeline_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tracking.TrackingPipeline()
    assert tracking.TrackingPipeline(device="cpu").device.type == "cpu"
