"""The port's fleet policy modules against the JAX package's:
``repro_torch.core.network`` (the seeded link) and ``repro_torch.core.offload``
(the speculative race and the paper's placement rule).

Pure policy, no service and no device: the delivery streams and race
decisions must equal the reference's bit for bit.  The placement rule is
the reference's with the card's constants; held to the reference with its
constants set to the card's (in this process only), and the port's own
placements pinned under them.
"""

import dataclasses
import itertools
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import network as jnet  # noqa: E402
from repro.core import offload as joff  # noqa: E402
from repro.core import profiling as jprof  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import offload as toff  # noqa: E402
from repro_torch.core import profiling as tprof  # noqa: E402

# the port's unit names for the reference's
UNITS = {"mxu": "tensor_cores", "vpu": "cuda_cores", "host": "host"}
CONFIGS = [
    # the uplink-compat mode: a free uplink, the whole RTT on the response
    dict(rtt_median_s=0.03, uplink_fraction=0.0),
    dict(rtt_median_s=0.03, jitter_sigma=0.5),
    dict(rtt_median_s=0.05, uplink_fraction=0.3, jitter_sigma=0.5,
         loss=0.1),
    dict(rtt_median_s=0.02, loss=1.0),
]


def _sends(seed: int, n: int = 48) -> str:
    """A seeded interleaving of uplinks and downlinks."""
    rng = np.random.default_rng(1000 + seed)
    return "".join("u" if b else "d" for b in rng.random(n) < 0.5)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kw", CONFIGS)
def test_delivery_stream_equals_reference(seed, kw):
    jm = jnet.NetworkModel(jnet.NetworkConfig(seed=seed, **kw))
    tm = tnet.NetworkModel(tnet.NetworkConfig(seed=seed, **kw))
    for leg in _sends(seed):
        a = jm.uplink() if leg == "u" else jm.downlink()
        b = tm.uplink() if leg == "u" else tm.downlink()
        assert (b.kind, b.msg_id, b.lost) == (a.kind, a.msg_id, a.lost)
        # bit for bit: the same draws in the same order, the same exp
        assert b.delay_s.hex() == a.delay_s.hex(), (b.msg_id, b, a)
        assert b.arrives_at(0.25) == a.arrives_at(0.25)
        lb, la = tnet.force_lost(b), jnet.force_lost(a)
        assert dataclasses.astuple(lb) == dataclasses.astuple(la)
        assert lb.lost and lb.arrives_at(0.25) == math.inf
    assert (tm.sent, tm.lost) == (jm.sent, jm.lost)
    if kw.get("loss") == 1.0:
        assert tm.lost == tm.sent
    tcfg = tnet.NetworkConfig(seed=seed, **kw)
    jcfg = jnet.NetworkConfig(seed=seed, **kw)
    assert tnet.expected_rtt_s(tcfg) == jnet.expected_rtt_s(jcfg)
    assert (tcfg.uplink_median_s, tcfg.downlink_median_s) == \
        (jcfg.uplink_median_s, jcfg.downlink_median_s)


def test_config_defaults_and_checks_equal_reference():
    assert dataclasses.asdict(tnet.NetworkConfig()) == \
        dataclasses.asdict(jnet.NetworkConfig())
    t, j = toff.SpeculativeConfig(), joff.SpeculativeConfig()
    assert (t.rtt_s, t.local_shape, t.network, t.race_timeout_s) == \
        (j.rtt_s, j.local_shape, j.network, j.race_timeout_s)
    for bad in (dict(rtt_median_s=-1.0), dict(uplink_fraction=1.5),
                dict(jitter_sigma=-0.1), dict(loss=2.0)):
        with pytest.raises(AssertionError):
            tnet.NetworkConfig(**bad)


@pytest.mark.parametrize("downlink", [None, 0.0, 0.01, 0.1, math.inf])
def test_decide_race_equals_reference(downlink):
    for local, remote, deadline, timed_out in itertools.product(
            (0.02, 0.25),                # local_done_at
            (None, 0.05, 0.2, 0.31),     # remote_done_at
            (None, 0.1, 0.3),            # deadline_at
            (False, True)):              # timed_out
        kw = dict(rtt_s=0.03, downlink_s=downlink, timed_out=timed_out)
        t = toff.decide_race(local, remote, deadline, **kw)
        j = joff.decide_race(local, remote, deadline, **kw)
        assert dataclasses.astuple(t) == dataclasses.astuple(j), kw
        assert t.winner == j.winner


def _stages():
    """Hand-made stages across the rule's branches: GEMM-dominant on
    either side of the tie, at the 0.5 boundary, element-wise, empty."""
    return [
        ("gemm_compute", 1e12, 1e6, 1.0),
        ("gemm_bytes", 1e6, 1e9, 1.0),
        ("gemm_half", 5e10, 1e8, 0.5),
        ("mostly_elementwise", 5e10, 1e8, 0.49),
        ("elementwise", 2e9, 4e9, 0.0),
        ("empty", 0.0, 0.0, 1.0),
    ]


@pytest.fixture
def reference_on_card_constants(monkeypatch):
    """The reference's module constants set to the card's (this test
    process only; the JAX package's files are untouched)."""
    monkeypatch.setattr(joff, "PEAK_FLOPS_BF16",
                        toff.BF16_TENSOR_CORE_FLOPS_PER_S)
    monkeypatch.setattr(joff, "PEAK_FLOPS_VPU",
                        toff.F32_CUDA_CORE_FLOPS_PER_S)
    monkeypatch.setattr(joff, "HBM_BW", toff.HBM_BYTES_PER_S)


def _same_placement(t, j):
    assert (t.stage, t.unit) == (j.stage, UNITS[j.unit])
    assert math.isclose(t.est_time_s, j.est_time_s, rel_tol=1e-12,
                        abs_tol=0.0), (t, j)


@pytest.mark.parametrize("transfer", [0.0, 1e6, 1e9])
def test_place_equals_reference_under_card_constants(
        reference_on_card_constants, transfer):
    # the reference's default link_bw was bound at its definition (the
    # TPU's HBM), so the link is passed explicitly
    for name, flops, nbytes, frac in _stages():
        t = toff.place(tprof.StageCost(name, flops, nbytes, frac),
                       transfer_bytes=transfer,
                       link_bw=toff.HBM_BYTES_PER_S)
        j = joff.place(jprof.StageCost(name, flops, nbytes, frac),
                       transfer_bytes=transfer,
                       link_bw=toff.HBM_BYTES_PER_S)
        _same_placement(t, j)


@pytest.mark.parametrize("hw", [(240, 320), (720, 1280), (96, 128)])
@pytest.mark.parametrize("fused", [False, True])
def test_plan_line_detection_equals_reference_under_card_constants(
        reference_on_card_constants, hw, fused):
    tc = tprof.line_detection_costs(*hw, fused=fused)
    jc = jprof.line_detection_costs(*hw, fused=fused)
    assert [dataclasses.astuple(c) for c in tc] == \
        [dataclasses.astuple(c) for c in jc]
    got = toff.plan_line_detection(*hw, fused=fused)
    want = joff.plan_line_detection(*hw, fused=fused)
    assert len(got) == len(want) == 5
    for t, j in zip(got, want):
        _same_placement(t, j)


# The port's placements under the card's published peaks.  The staged
# Canny conv pair moves px * 16 bytes for 150 flops a pixel: its time on
# the tensor cores and on the CUDA cores is the same memory time, and the
# rule's strict < keeps it on the CUDA cores.  The fused (3,7,7) set is
# one pass (half the bytes) of twice the flops: the CUDA cores' f32 time
# passes its memory time, so it goes to the tensor cores.  The JAX
# package's TPU constants put both conv stages on the MXU.
PINNED = {
    False: ("cuda_cores", "cuda_cores", "tensor_cores", "cuda_cores",
            "cuda_cores"),
    True: ("tensor_cores", "cuda_cores", "tensor_cores", "cuda_cores",
           "cuda_cores"),
}


@pytest.mark.parametrize("hw", [(240, 320), (720, 1280)])
@pytest.mark.parametrize("fused", [False, True])
def test_port_placement_is_pinned_under_card_constants(hw, fused):
    got = toff.plan_line_detection(*hw, fused=fused)
    assert [p.stage for p in got] == [
        "canny_conv_gemm", "canny_elementwise", "hough_rho_gemm",
        "hough_votes", "get_coordinates"]
    assert tuple(p.unit for p in got) == PINNED[fused]
    conv = tprof.line_detection_costs(*hw, fused=fused)[0]
    t_mem = conv.bytes_moved / toff.HBM_BYTES_PER_S
    if not fused:
        # the tie: both sides are the memory time, exactly
        assert conv.flops / toff.F32_CUDA_CORE_FLOPS_PER_S < t_mem
        assert got[0].est_time_s == t_mem
    else:
        assert got[0].est_time_s == t_mem < (
            conv.flops / toff.F32_CUDA_CORE_FLOPS_PER_S)
    # the reference's own TPU constants place the conv on the MXU
    assert joff.plan_line_detection(*hw, fused=fused)[0].unit == "mxu"
