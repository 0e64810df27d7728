"""The port's closed loop and the paper's serial Hough loop against the JAX
package.

The closed loop (``repro_torch.data.ClosedLoopCycle``): frames rendered
from the plant's state, bit for bit, and trajectories under fixed command
sequences, under the oracle and blind arms, and with the detector in the
loop (``TrackingPipeline.process(frame, controller=)`` on the CPU, and a
``DetectionService`` session on a virtual clock under forced overload),
each against the reference's own arm on the same seeds.  The arms are
the drive suite's (``benchmarks/drive_suite.py``), written once over
either package.

The serial loop (``repro_torch.core.hough_paper_loop``): its votes against
the JAX loop's, where a vote may move one rho bin (the reference's XLA
build fuses ``j*cos + i*sin`` into one multiply-add and takes XLA's
``cos`` / ``sin``), and against the port's ``hough_transform`` within
1e-3, as ``tests/test_core.py`` holds the reference's two.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.serve import detection as jdet  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch.serve import detection as tdet  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HW = (240, 320)
# the drive suite's service constants (benchmarks/drive_suite.py)
DEADLINE_S = 0.08
MODEL_COST_S = 0.02
OVERLOAD_EST_S = 1.0
OVERLOAD_WINDOWS = (range(8, 14), range(28, 34))

# each package's modules, by the role they play in a drive
REF = dict(core=jcore, data=jdata, det=jdet, device={},
           frame=lambda img: jnp.asarray(img, jnp.float32),
           host=np.asarray)
PORT = dict(core=tcore, data=tdata, det=tdet, device={"device": "cpu"},
            frame=lambda img: np.asarray(img, np.float32),
            host=lambda t: t.cpu().numpy())


def _cfg(pkg):
    c = pkg["core"]
    return c.PipelineConfig(hough=c.HoughConfig(compact=True,
                                                max_edges="auto"))


def _controller(pkg, cyc):
    return pkg["core"].LateralController(clock=lambda: float(cyc.t))


def _frames(a, b):
    """Two ``DriveCycleFrame`` records are the same, the image bit for
    bit."""
    assert a.scene.image.dtype == b.scene.image.dtype == np.uint8
    np.testing.assert_array_equal(a.scene.image, b.scene.image)
    np.testing.assert_array_equal(a.scene.lines_rho_theta,
                                  b.scene.lines_rho_theta)
    assert a.scene.lines_rho_theta.dtype == b.scene.lines_rho_theta.dtype
    assert (a.t, a.dropout, a.noise_burst, a.dx_px, a.yaw_deg, a.dy_px) == (
        b.t, b.dropout, b.noise_burst, b.dx_px, b.yaw_deg, b.dy_px)


def _same_drive(ref, port):
    assert port.trajectory == ref.trajectory
    np.testing.assert_array_equal(port.cross_track, ref.cross_track)
    assert port.max_cross_track_m == ref.max_cross_track_m
    assert port.mean_cross_track_m == ref.mean_cross_track_m
    assert (port.t, port.e_m, port.psi_rad) == (ref.t, ref.e_m, ref.psi_rad)


# --- the cycle itself: frames, plant, schedules --------------------------------

# a command sequence with holds, a clamp-hitting command and sign changes
COMMANDS = (0.3, None, -0.8, 5.0, None, None, -3.0, 0.05, None, 1.2, -0.4,
            None)


def test_observe_frames_bit_equal_on_rain_with_dropout_and_burst():
    """12 frames of "rain": dropouts at 6-10, the noise burst at 8-11, the
    pose moved by the commands between frames."""
    ref = jdata.standard_closed_loop("rain", 12, *HW, seed=0)
    port = tdata.standard_closed_loop("rain", 12, *HW, seed=0)
    kinds = set()
    for cmd in COMMANDS:
        a, b = ref.observe(), port.observe()
        _frames(a, b)
        kinds.add((a.dropout, a.noise_burst))
        ref.advance(cmd)
        port.advance(cmd)
    assert {(False, False), (True, False), (True, True),
            (False, True)} <= kinds
    _same_drive(ref, port)


@pytest.mark.parametrize("family", ["straight", "rain", "curved"])
@pytest.mark.parametrize("seed", [0, 3])
def test_fixed_command_sequence_gives_the_reference_trajectory(family, seed):
    cfg_kw = dict(gust_mps=0.35, surge_px=5.0, max_heading_rad=0.3)
    ref = jdata.ClosedLoopCycle(family, 24, 96, 128, seed=seed,
                                cfg=jdata.ClosedLoopConfig(**cfg_kw),
                                e0_m=-0.4, psi0_rad=0.1,
                                dropout_frames=(2, 3),
                                noise_burst_frames=(5,))
    port = tdata.ClosedLoopCycle(family, 24, 96, 128, seed=seed,
                                 cfg=tdata.ClosedLoopConfig(**cfg_kw),
                                 e0_m=-0.4, psi0_rad=0.1,
                                 dropout_frames=(2, 3),
                                 noise_burst_frames=(5,))
    for t in range(24):
        _frames(ref.observe(), port.observe())
        cmd = COMMANDS[t % len(COMMANDS)]
        ref.advance(cmd)
        port.advance(cmd)
        assert port.pose() == ref.pose()
    _same_drive(ref, port)


@pytest.mark.parametrize("family", ["rain", "night", "glare", "straight",
                                    "converging"])
@pytest.mark.parametrize("n", [12, 48])
def test_standard_closed_loop_schedules_match(family, n):
    ref = jdata.standard_closed_loop(family, n, *HW, seed=0)
    port = tdata.standard_closed_loop(family, n, *HW, seed=0)
    assert port._dropout == ref._dropout
    assert port._burst == ref._burst
    assert (port._dropout != set()) == (family in tdata.NOISY_FAMILIES)
    assert port.n_frames == ref.n_frames == n
    assert port._fill == ref._fill
    assert (port.e_m, port.psi_rad, port._burst_frac) == (
        ref.e_m, ref.psi_rad, ref._burst_frac)


def test_closed_loop_config_defaults_match():
    import dataclasses

    assert (dataclasses.asdict(tdata.ClosedLoopConfig())
            == dataclasses.asdict(jdata.ClosedLoopConfig()))


def test_advance_none_holds_decayed_and_clamps_like_the_reference():
    """``tests/test_drive.py``'s hold decay and curvature clamp, on both
    packages, plus the heading clamp."""
    for mod in (jdata, tdata):
        cyc = mod.ClosedLoopCycle("straight", 8, *HW, seed=0)
        cyc.advance(0.5)
        assert cyc.trajectory[-1][3] == pytest.approx(0.5)
        cyc.advance(None)
        assert cyc.trajectory[-1][3] == pytest.approx(
            0.5 * cyc.cfg.hold_decay)
        cyc.advance(None)
        assert cyc.trajectory[-1][3] == pytest.approx(
            0.5 * cyc.cfg.hold_decay ** 2)
        cyc = mod.ClosedLoopCycle("straight", 4, *HW, seed=0)
        cyc.advance(99.0)
        assert cyc.trajectory[-1][3] == cyc.cfg.max_curvature
        cyc.advance(-99.0)
        assert cyc.trajectory[-1][3] == -cyc.cfg.max_curvature
        for _ in range(3):
            cyc.advance(99.0)
        assert cyc.psi_rad == cyc.cfg.max_heading_rad
    ref = jdata.ClosedLoopCycle("straight", 6, *HW, seed=0)
    port = tdata.ClosedLoopCycle("straight", 6, *HW, seed=0)
    for cmd in (0.5, None, None, 99.0, None, -99.0):
        ref.advance(cmd)
        port.advance(cmd)
    _same_drive(ref, port)


# --- the arms of the drive suite, over either package --------------------------


def _oracle(pkg, family, n):
    """Truth -> ``LateralController``; a dropout frame holds."""
    cyc = pkg["data"].standard_closed_loop(family, n, *HW, seed=0)
    ctl = _controller(pkg, cyc)
    for _ in range(n):
        fr = cyc.observe()
        cmd = (ctl.hold() if fr.dropout
               else ctl.command(fr.scene.lines_rho_theta))
        cyc.advance(cmd.curvature)
    return cyc, ctl


def _blind(pkg, family, n):
    cyc = pkg["data"].standard_closed_loop(family, n, *HW, seed=0)
    for _ in range(n):
        cyc.observe()
        cyc.advance(None)
    return cyc, None


def _per_frame(pkg, family, n):
    cyc = pkg["data"].standard_closed_loop(family, n, *HW, seed=0)
    det = pkg["core"].LineDetector(_cfg(pkg), **pkg["device"])
    ctl = _controller(pkg, cyc)
    for _ in range(n):
        res = det.detect(pkg["frame"](cyc.observe().scene.image))
        cmd = ctl.command(pkg["host"](res.peaks), pkg["host"](res.valid))
        cyc.advance(cmd.curvature)
    return cyc, ctl


def _tracked(pkg, family, n, **kw):
    cyc = pkg["data"].standard_closed_loop(family, n, *HW, seed=0)
    ctl = _controller(pkg, cyc)
    tp = pkg["core"].TrackingPipeline(_cfg(pkg), height=HW[0], width=HW[1],
                                      **kw, **pkg["device"])
    paths = []
    for _ in range(n):
        tf = tp.process(cyc.observe().scene.image, controller=ctl)
        paths.append(tf.gated)
        cyc.advance(tf.steering.curvature)
    return cyc, ctl, paths, (tp.full_frames, tp.gated_frames,
                             tp.fused_frames)


@pytest.mark.parametrize("family", ["straight", "rain"])
@pytest.mark.parametrize("arm", [_oracle, _blind], ids=["oracle", "blind"])
def test_oracle_and_blind_loops_give_the_reference_trajectory(arm, family):
    (ref, rctl), (port, pctl) = arm(REF, family, 48), arm(PORT, family, 48)
    _same_drive(ref, port)
    if rctl is not None:
        assert (pctl.fresh_commands, pctl.held_commands) == (
            rctl.fresh_commands, rctl.held_commands)
        assert tuple(pctl.last) == tuple(rctl.last)


def test_per_frame_loop_gives_the_reference_trajectory():
    (ref, rctl), (port, pctl) = (_per_frame(REF, "rain", 12),
                                 _per_frame(PORT, "rain", 12))
    _same_drive(ref, port)
    assert (pctl.fresh_commands, pctl.held_commands) == (
        rctl.fresh_commands, rctl.held_commands)


@pytest.mark.parametrize("fused", [False, True], ids=["tracked",
                                                      "tracked_fused"])
def test_tracked_loop_with_the_controller_gives_the_reference_trajectory(
        fused):
    """``TrackingPipeline.process(frame, controller=)`` on
    ``standard_closed_loop("rain", 12)``: the dropout at 6-10 is coasted
    through on the tracks, and the commands steer the next frame."""
    kw = dict(theta_band=40, fused_corridors=8) if fused else {}
    ref = _tracked(REF, "rain", 12, **kw)
    port = _tracked(PORT, "rain", 12, **kw)
    _same_drive(ref[0], port[0])
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert (port[1].fresh_commands, port[1].held_commands) == (
        ref[1].fresh_commands, ref[1].held_commands)
    assert port[3][1] > 0
    if fused:
        assert port[3][2] > 0


def test_control_peaks_and_steering_match_the_reference():
    """Each frame's ``TrackedFrame.control_peaks`` and the command steered
    from them: two blank frames first (no track: the raw peaks), then the
    tracked frames."""
    cyc = tdata.standard_closed_loop("straight", 6, *HW, seed=0)
    frames = [np.full(HW, 90, np.uint8)] * 2
    for _ in range(6):
        frames.append(cyc.observe().scene.image)
        cyc.advance(None)
    outs = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        tp = pkg["core"].TrackingPipeline(_cfg(pkg), height=HW[0],
                                          width=HW[1], **pkg["device"])
        ctl = pkg["core"].LateralController(clock=lambda: 0.0)
        outs[name] = [tp.process(f, controller=ctl) for f in frames]
    raw = 0
    for a, b in zip(outs["ref"], outs["port"]):
        raw += not a.tracks
        for x, y in zip(a.control_peaks, b.control_peaks):
            np.testing.assert_array_equal(x, y)
        assert tuple(b.steering) == tuple(a.steering)
    assert 0 < raw < len(frames)


def _service(pkg, family, n, *, ladder):
    """The drive suite's service arm: a session on a virtual clock, a
    frame a period, two overload windows forced through the grid's
    latency estimate."""
    det = pkg["det"]
    clock = det.VirtualClock()
    svc = det.DetectionService(
        _cfg(pkg), buckets=(HW,), batch_size=1, prefetch=False,
        ladder=ladder, steering=pkg["core"].ControlConfig(), clock=clock,
        **pkg["device"])
    grid = svc.grids[HW]
    cyc = pkg["data"].standard_closed_loop(family, n, *HW, seed=0)
    statuses = []
    try:
        for t in range(n):
            clock.advance(cyc.cfg.frame_dt_s)
            overload = any(t in w for w in OVERLOAD_WINDOWS)
            grid.est_s = OVERLOAD_EST_S if overload else MODEL_COST_S
            grid.est_measured = True
            req = det.DetectionRequest(uid=t, frame=cyc.observe().scene.image,
                                       deadline_s=DEADLINE_S,
                                       session_id="ego")
            svc.submit(req)
            svc.step()
            if grid.in_flight is not None:
                clock.advance(MODEL_COST_S)
                svc.drain()
            for _ in range(4):
                if req.is_terminal:
                    break
                svc.step()
                svc.drain()
            assert req.is_terminal
            statuses.append(req.status.name)
            cmd = req.steering
            cyc.advance(None if cmd is None else cmd.curvature)
    finally:
        svc.close()
    return cyc, statuses


@pytest.mark.parametrize("ladder", [True, False], ids=["ladder_on",
                                                       "ladder_off"])
def test_service_arm_gives_the_reference_statuses_and_trajectory(ladder):
    """16 frames of "straight", covering the first overload window (8-13):
    ladder on, the session coasts there; ladder off, it is refused."""
    ref, rs = _service(REF, "straight", 16, ladder=ladder)
    port, ps = _service(PORT, "straight", 16, ladder=ladder)
    assert ps == rs
    _same_drive(ref, port)
    assert ps.count("DONE") >= 8
    assert any(s != "DONE" for s in ps[8:14])


# --- the paper's serial loop ---------------------------------------------------


def _edges(kind, h, w):
    if kind == "synthetic":
        rng = np.random.default_rng(h * w)
        return np.where(rng.uniform(size=(h, w)) < 0.3, 255.0,
                        rng.uniform(0.0, 249.0, (h, w))).astype(np.float32)
    img = tdata.make_scenario("straight", h, w, seed=0).image
    return tcore.canny(torch.from_numpy(img.astype(np.float32)),
                       tcore.CannyConfig()).numpy()


def _one_bin_moves(got, want):
    """The votes of ``got`` moved against ``want``, checking that every
    difference is a vote moved by one rho bin in its theta column: each
    column's total is the same, and the least transport that turns one
    into the other (the sum of the cumulative differences' magnitudes)
    moves each differing vote by exactly one bin."""
    diff = got.astype(np.int64) - want.astype(np.int64)
    np.testing.assert_array_equal(diff.sum(axis=0), 0)
    moved = int(np.abs(diff).sum()) // 2
    assert int(np.abs(np.cumsum(diff, axis=0)).sum()) == moved
    return moved


SHAPES = [(24, 32), (48, 64)]


@pytest.mark.parametrize("kind", ["synthetic", "canny"])
@pytest.mark.parametrize("n_theta", [90, 180])
@pytest.mark.parametrize("hw", SHAPES, ids=["24x32", "48x64"])
def test_paper_loop_equals_the_jax_loop_up_to_one_bin_moves(hw, n_theta,
                                                            kind):
    edges = _edges(kind, *hw)
    got = tcore.hough_paper_loop(torch.from_numpy(edges),
                                 tcore.HoughConfig(n_theta=n_theta)).numpy()
    want = np.asarray(jcore.hough_paper_loop(
        jnp.asarray(edges), jcore.HoughConfig(n_theta=n_theta)))
    assert got.shape == want.shape and got.dtype == np.float32
    assert got.sum() == want.sum() == (edges >= 250).sum() * n_theta
    # a vote moves only when its rho lies within an ulp (2^-14 below
    # 2^10) of a bin edge: far fewer than 1e-4 of the votes cast
    assert _one_bin_moves(got, want) <= 1e-4 * got.sum()


@pytest.mark.parametrize("kind", ["synthetic", "canny"])
@pytest.mark.parametrize("n_theta", [90, 180])
@pytest.mark.parametrize("hw", SHAPES, ids=["24x32", "48x64"])
def test_paper_loop_equals_hough_transform(hw, n_theta, kind):
    """``tests/test_core.py::test_hough_gemm_equals_paper_loop`` on the
    port's two."""
    edges = torch.from_numpy(_edges(kind, *hw))
    cfg = tcore.HoughConfig(n_theta=n_theta)
    fast = tcore.hough_transform(edges, cfg)
    slow = tcore.hough_paper_loop(edges, cfg)
    np.testing.assert_allclose(fast.numpy(), slow.numpy(), atol=1e-3)


def test_paper_loop_moves_votes_only_by_one_bin_on_a_dense_raster():
    """Every pixel an edge at 64x96: the rasters where the rounding of
    ``j*cos + i*sin`` matters most.  Against the JAX loop and the port's
    ``hough_transform`` alike, every difference is a one-bin move."""
    edges = np.full((64, 96), 255.0, np.float32)
    cfg = tcore.HoughConfig()
    got = tcore.hough_paper_loop(torch.from_numpy(edges), cfg).numpy()
    want = np.asarray(jcore.hough_paper_loop(jnp.asarray(edges),
                                             jcore.HoughConfig()))
    fast = tcore.hough_transform(torch.from_numpy(edges), cfg).numpy()
    for other in (want, fast):
        assert _one_bin_moves(got, other) <= 1e-4 * got.sum()
