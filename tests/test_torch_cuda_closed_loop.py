"""The port's closed loop and the paper's serial Hough loop on the card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU (the detector's kernels have no CPU mode).  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_closed_loop.py

This file imports nothing of the JAX package: the card is held to the
port's own CPU run of the same arm.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    CannyConfig, HoughConfig, LateralController, PipelineConfig,
    TrackingPipeline, canny, hough_paper_loop, hough_transform,
)
from repro_torch.data import make_scenario, standard_closed_loop  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

HW = (240, 320)
CFG = PipelineConfig(hough=HoughConfig(compact=True, max_edges="auto"))


@pytest.fixture
def card():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the detector's kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _tracked(device, n, **kw):
    """The drive suite's tracked arm on ``standard_closed_loop("rain")``:
    the trajectory, each frame's command and the frame split."""
    cyc = standard_closed_loop("rain", n, *HW, seed=0)
    ctl = LateralController(clock=lambda: float(cyc.t))
    tp = TrackingPipeline(CFG, height=HW[0], width=HW[1], device=device,
                          **kw)
    commands = []
    for _ in range(n):
        tf = tp.process(cyc.observe().scene.image, controller=ctl)
        commands.append(tuple(tf.steering))
        cyc.advance(tf.steering.curvature)
    return (cyc.trajectory, commands,
            (tp.full_frames, tp.gated_frames, tp.fused_frames))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(theta_band=40, fused_corridors=8)],
                         ids=["tracked", "tracked_fused"])
def test_tracked_arm_on_the_card_equals_the_cpu(card, kw):
    ops.reset_launch_counts()
    on_card = _tracked(None, 12, **kw)
    counts = ops.launch_counts()
    on_cpu = _tracked("cpu", 12, **kw)
    assert on_card == on_cpu
    assert counts["hough_vote"] == 12
    assert counts["conv2d_gemm"] == 2 * (12 - on_card[2][2])
    assert counts["fused_detect"] == on_card[2][2]
    if kw:
        assert on_card[2][2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_theta", [90, 180])
def test_paper_loop_on_the_card_equals_the_cpu(card, n_theta):
    img = make_scenario("straight", 48, 64, seed=0).image
    edges = canny(torch.from_numpy(img.astype(np.float32)), CannyConfig())
    edges[::7] = 255.0          # rows of extra edges: more votes at stake
    cfg = HoughConfig(n_theta=n_theta)
    got = hough_paper_loop(edges.to(card), cfg)
    assert got.device.type == "cuda"
    want = hough_paper_loop(edges, cfg)
    assert torch.equal(got.cpu(), want)
    vote = hough_transform(edges.to(card), cfg).cpu()
    np.testing.assert_allclose(vote.numpy(), want.numpy(), atol=1e-3)
