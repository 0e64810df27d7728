"""The port's bird's-eye geometry and lane-keeping control against the JAX
package's (both numpy host code).

Fixed-seed sweeps of image peaks, ground lines and pixels go through
``repro.core.geometry`` / ``repro.core.control`` and their copies in
``repro_torch.core``: every output equal, every refusal (a pixel above the
horizon, a line that maps to infinity) raised by both, and the lateral
controller's command / hold sequence equal command for command on an
injected clock.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import control as jcontrol  # noqa: E402
from repro.core import geometry as jgeometry  # noqa: E402
from repro.core import tracking as jtracking  # noqa: E402
from repro.data import make_scenario  # noqa: E402
from repro_torch.core import control, geometry, tracking  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = (0, 1, 2, 3)
SIZES = ((240, 320), (120, 160), (720, 1280))


def _peaks(rng, n, h=240, w=320):
    """Image peaks as the detector emits them: rho within the diagonal,
    theta in [0, pi), as f32."""
    diag = math.hypot(h, w)
    return np.column_stack([rng.uniform(-diag, diag, n),
                            rng.uniform(0.0, math.pi, n)]).astype(np.float32)


def _call(fn, *args):
    """The value, or the refusal's type (ValueError) as a marker."""
    try:
        return fn(*args)
    except ValueError:
        return "ValueError"


def _cam(mod, hw):
    return mod.CameraGeometry(mod.CameraConfig().for_image(*hw))


# --- geometry ----------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_canonical_rho_theta_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for rho, theta in zip(rng.uniform(-500, 500, 64),
                          rng.uniform(-4 * math.pi, 4 * math.pi, 64)):
        assert (geometry.canonical_rho_theta(rho, theta)
                == jgeometry.canonical_rho_theta(rho, theta))
    for k in range(-6, 7):           # exact multiples of pi: the float edge
        assert (geometry.canonical_rho_theta(40.0, k * math.pi)
                == jgeometry.canonical_rho_theta(40.0, k * math.pi))


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_camera_and_homography_match_reference(hw):
    cfg, jcfg = geometry.CameraConfig().for_image(*hw), \
        jgeometry.CameraConfig().for_image(*hw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.principal == jcfg.principal
    g, jg = geometry.CameraGeometry(cfg), jgeometry.CameraGeometry(jcfg)
    np.testing.assert_array_equal(g.G, jg.G)
    np.testing.assert_array_equal(g.M, jg.M)
    assert g.horizon_v == jg.horizon_v
    assert geometry.DEFAULT_CAMERA == geometry.CameraConfig()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_points_and_lines_match_reference(seed, hw):
    """Pixels (some above the horizon), ground points and image / ground
    lines of a seeded sweep: the same values, the same refusals."""
    rng = np.random.default_rng(seed)
    g, jg = _cam(geometry, hw), _cam(jgeometry, hw)
    h, w = hw
    for u, v in zip(rng.uniform(0, w, 32), rng.uniform(0, h, 32)):
        assert (_call(g.pixel_to_ground, u, v)
                == _call(jg.pixel_to_ground, u, v))
    for x, y in zip(rng.uniform(-3, 3, 32), rng.uniform(-1, 12, 32)):
        assert (_call(g.ground_to_pixel, x, y)
                == _call(jg.ground_to_pixel, x, y))
    for rho, theta in _peaks(rng, 48, h, w):
        lg = _call(g.line_to_ground, float(rho), float(theta))
        assert lg == _call(jg.line_to_ground, float(rho), float(theta))
        if lg != "ValueError":
            assert (_call(g.line_to_image, *lg)
                    == _call(jg.line_to_image, *lg))
    horizon_row = (0.0, math.pi / 2)     # v = 0 at theta = pi / 2
    assert (_call(g.line_to_ground, g.horizon_v, horizon_row[1])
            == _call(jg.line_to_ground, jg.horizon_v, horizon_row[1]))


@pytest.mark.parametrize("seed", SEEDS)
def test_lines_to_ground_and_boundaries_match_reference(seed):
    rng = np.random.default_rng(seed)
    g, jg = _cam(geometry, (240, 320)), _cam(jgeometry, (240, 320))
    peaks = _peaks(rng, 16)
    for valid in (None, rng.uniform(size=16) < 0.6, np.zeros(16, bool)):
        np.testing.assert_array_equal(g.lines_to_ground(peaks, valid),
                                      jg.lines_to_ground(peaks, valid))
        for cfg in (control.ControlConfig(),
                    control.ControlConfig(max_heading_deg=20.0)):
            jcfg = jcontrol.ControlConfig(**dataclasses.asdict(cfg))
            assert (control.ground_boundaries(peaks, valid, g, cfg)
                    == jcontrol.ground_boundaries(peaks, valid, jg, jcfg))


def _truth_peaks(family, seed, hw=(240, 320)):
    scene = make_scenario(family, *hw, seed=seed)
    return np.asarray(scene.lines_rho_theta, np.float32).reshape(-1, 2)


@pytest.mark.parametrize("family", ["straight", "converging", "curved",
                                    "multilane"])
def test_extract_waypoints_matches_reference(family):
    """Waypoints from analytic lanes (a pair), from each single boundary,
    and from noise-perturbed and empty peak sets."""
    g, jg = _cam(geometry, (240, 320)), _cam(jgeometry, (240, 320))
    rng = np.random.default_rng(7)
    for seed in (0, 1):
        truth = _truth_peaks(family, seed)
        sets = [truth, truth[:1], truth[-1:], np.zeros((0, 2), np.float32),
                truth + rng.normal(0, [2.0, 0.02], truth.shape)
                .astype(np.float32)]
        for peaks in sets:
            got = control.extract_waypoints(peaks, None, g)
            want = jcontrol.extract_waypoints(peaks, None, jg)
            np.testing.assert_array_equal(got.points, want.points)
            assert got[1:] == want[1:]
            assert got.found == want.found


class _Clock:
    """An injected clock stepping by a fixed period a read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.05
        return self.t


def _drive(mod, geom, peaks_seq, cfg):
    ctl = mod.LateralController(geom, cfg, clock=_Clock())
    out = []
    for peaks in peaks_seq:
        if peaks is None:
            out.append(tuple(ctl.hold()))
        else:
            out.append(tuple(ctl.command(peaks)))
            wp = ctl.waypoints       # None until a first fresh command
            out.append(None if wp is None else (
                wp.source, wp.offset_m, wp.slope, wp.points.tobytes()))
    out.append((ctl.fresh_commands, ctl.held_commands, ctl._ref,
                sorted(ctl._deltas.items())))
    ctl.reset()
    out.append((ctl.last, ctl.waypoints, ctl._ref, ctl._deltas))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_lateral_controller_sequence_matches_reference(seed):
    """A stream of pairs, single boundaries (the remembered deltas), empty
    frames and holds past the budget: every command, every waypoint set,
    the counters and the memory equal."""
    rng = np.random.default_rng(seed)
    truth = _truth_peaks("converging", seed)
    seq = []
    for k in range(30):
        r = rng.uniform()
        jitter = rng.normal(0, [1.5, 0.01], truth.shape).astype(np.float32)
        if r < 0.5:
            seq.append(truth + jitter)
        elif r < 0.7:
            seq.append((truth + jitter)[rng.integers(len(truth))][None])
        elif r < 0.8:
            seq.append(np.zeros((0, 2), np.float32))
        else:
            seq.append(None)
    seq += [None] * 14                   # past hold_frames: command straight
    for cfg in (control.ControlConfig(),
                control.ControlConfig(lookahead_m=1.5, max_curvature=0.5,
                                      hold_frames=3)):
        jcfg = jcontrol.ControlConfig(**dataclasses.asdict(cfg))
        assert (_drive(control, _cam(geometry, (240, 320)), seq, cfg)
                == _drive(jcontrol, _cam(jgeometry, (240, 320)), seq, jcfg))


def test_controller_takes_tracks_as_the_reference_does():
    """Tracker ``Track`` objects (anything with .rho / .theta) and
    ``tracks_as_peaks`` steer as their peaks do, in both packages."""
    truth = _truth_peaks("straight", 0)
    tr, jtr = tracking.LaneTracker(), jtracking.LaneTracker()
    for k in range(4):
        tr.step(truth + np.float32(0.5 * k))
        jtr.step(truth + np.float32(0.5 * k))
    assert tr.tracks and [dataclasses.astuple(t) for t in tr.tracks] == \
        [dataclasses.astuple(t) for t in jtr.tracks]
    ctl = control.LateralController(clock=lambda: 1.0)
    jctl = jcontrol.LateralController(clock=lambda: 1.0)
    assert ctl.command(tr.tracks) == jctl.command(jtr.tracks)
    assert (ctl.command(*tracking.tracks_as_peaks(tr.tracks))
            == jctl.command(*jtracking.tracks_as_peaks(jtr.tracks)))
    assert ctl.command([]) == jctl.command([])     # nothing: the hold
    np.testing.assert_array_equal(control._as_peaks(tr.tracks),
                                  jcontrol._as_peaks(jtr.tracks))
