"""The port's Canny, Hough and get_lines against the JAX package.

Both packages get the same numpy frames (all 12 scenario families at
240x320, one seed each) and the same configuration; the JAX side runs its
module-level ``xla`` path on the CPU, the port its plain versions.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hough as jhough  # noqa: E402
from repro.core import lines as jlines  # noqa: E402
from repro.core.canny import CannyConfig as JCanny  # noqa: E402
from repro.core.canny import _gradients as jgradients  # noqa: E402
from repro.core.canny import canny as jcanny  # noqa: E402
from repro.core.canny import estimate_edge_count as jestimate  # noqa: E402
from repro.core.canny import gradient_masks as jmasks  # noqa: E402
from repro.core.metrics import aggregate_scores, score_batch  # noqa: E402
from repro.core.quantize import quantize_frames as jquantize  # noqa: E402
from repro.data import scenario_batch, scenario_names  # noqa: E402
from repro_torch.core import hough as though  # noqa: E402
from repro_torch.core import lines as tlines  # noqa: E402
from repro_torch.core.quantize import quantize_frames  # noqa: E402

# the package re-exports the function ``canny``, so fetch the module by name
tcanny_mod = importlib.import_module("repro_torch.core.canny")

H, W = 240, 320


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
    imgs, truths = scenario_batch(list(scenario_names()), H, W, seed=0)
    return imgs, truths


def _canny_cfg(jcfg):
    d = dataclasses.asdict(jcfg)
    d["impl"] = None
    return tcanny_mod.CannyConfig(**d)


@pytest.mark.parametrize("jcfg", [
    JCanny(), JCanny(variant="paper"), JCanny(integer=True),
    JCanny(fused=True),
], ids=["full", "paper", "integer", "fused"])
def test_canny_equal_edge_maps_on_all_families(frames, jcfg):
    imgs, _ = frames
    want = np.asarray(jcanny(jnp.asarray(imgs), jcfg))
    got = tcanny_mod.canny(torch.from_numpy(imgs), _canny_cfg(jcfg))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


@pytest.mark.parametrize("grad_dtype,fused", [
    ("f16", False), ("f16", True), ("int8", False), ("int8", True),
])
def test_low_precision_tiers(frames, grad_dtype, fused):
    """f16 gradients within one f16 ulp of the reference (its CPU einsum
    accumulates in another order), int8 exact; equal edge maps and F1."""
    imgs, truths = frames
    jcfg = JCanny(grad_dtype=grad_dtype, fused=fused)
    tcfg = _canny_cfg(jcfg)
    want = jgradients(jnp.asarray(imgs), jcfg)
    got = tcanny_mod._gradients(torch.from_numpy(imgs), tcfg)
    for w, g in zip(want, got):
        if grad_dtype == "int8":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                       rtol=2.0 ** -10, atol=2.0 ** -10)
    je = np.asarray(jcanny(jnp.asarray(imgs), jcfg))
    te = tcanny_mod.canny(torch.from_numpy(imgs), tcfg).numpy()
    np.testing.assert_array_equal(te, je)
    # equal edges => equal votes => equal peaks and F1 downstream
    jv = jhough.hough_transform(jnp.asarray(je), jhough.HoughConfig(compact=True))
    jres = jlines.get_lines(jv, height=H, width=W)
    tv = though.hough_transform(torch.from_numpy(te),
                                though.HoughConfig(compact=True))
    tres = tlines.get_lines(tv, height=H, width=W)
    f1 = [aggregate_scores(score_batch(np.asarray(r[2]), np.asarray(r[1]),
                                       truths))["f1"] for r in (jres, tres)]
    assert f1[0] == f1[1]


def test_gradient_masks_and_quantize_agree(rng):
    for kw in ({}, {"integer": True}, {"fused": True},
               {"integer": True, "fused": True}, {"grad_dtype": "f16"},
               {"grad_dtype": "int8"}, {"grad_dtype": "int8", "fused": True}):
        for a, b in zip(jmasks(JCanny(**kw)),
                        tcanny_mod.gradient_masks(tcanny_mod.CannyConfig(**kw))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    x = (rng.normal(size=(3, 17, 19)) * 40).astype(np.float32)
    q = quantize_frames(torch.from_numpy(x))
    jq = jquantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))


def test_edge_count_estimate_matches(frames):
    imgs, _ = frames
    for cfg in (JCanny(), JCanny(low=10.0)):
        assert tcanny_mod.estimate_edge_count(
            torch.from_numpy(imgs), _canny_cfg(cfg)
        ) == jestimate(jnp.asarray(imgs), cfg)


def test_hough_tables_and_tiers_match():
    for hw in ((240, 320), (720, 1280), (37, 52)):
        jc, tc = jhough.HoughConfig(), though.HoughConfig()
        assert though.rho_bins(*hw, tc) == jhough.rho_bins(*hw, jc)
        np.testing.assert_array_equal(though.hough_trig(*hw, tc),
                                      jhough.hough_trig(*hw, jc))
        assert though.max_edge_tiers(*hw) == jhough.max_edge_tiers(*hw)
        for n in (0, 600, 2733, 10**6):
            assert (though.auto_max_edges(n, *hw)
                    == jhough.auto_max_edges(n, *hw))
    assert though.max_edge_tiers(720, 1280)[-1] == 57600
    np.testing.assert_array_equal(though.full_corridors(3),
                                  jhough.full_corridors(3))


@pytest.mark.parametrize("compact,max_edges", [
    (False, None), (True, None), (True, 512), (True, "auto"),
])
def test_hough_transform_bit_exact(frames, compact, max_edges):
    imgs, _ = frames
    edges = np.asarray(jcanny(jnp.asarray(imgs), JCanny()))
    if not compact:  # the dense vote covers every pixel: a few frames do
        edges = edges[:3]
    jc = jhough.HoughConfig(compact=compact, max_edges=max_edges)
    tc = though.HoughConfig(compact=compact, max_edges=max_edges)
    want = np.asarray(jhough.hough_transform(jnp.asarray(edges), jc))
    got = though.hough_transform(torch.from_numpy(edges.copy()), tc)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("density", [0.02, 0.2])
def test_cap_buffer_vote_equals_tiered_reference(rng, density):
    """Compacting into the cap tier and voting by the device-held count
    equals the reference's tiered dispatch, bit for bit: on sparse maps
    (a small tier) and on maps past the cap (the cap drops the same
    trailing edges)."""
    hw = (48, 64)  # cap tier 256: the dense maps overflow it
    edges = np.where(rng.uniform(size=(3,) + hw) < density, 255,
                     0).astype(np.uint8)
    edges[0] = 0  # an empty frame in the batch
    jc = jhough.HoughConfig(compact=True, max_edges="auto")
    tc = though.HoughConfig(compact=True, max_edges="auto")
    for band in (None, np.arange(40, 100, dtype=np.int32)):
        jcb = dataclasses.replace(jc, theta_band=None if band is None
                                  else len(band))
        tcb = dataclasses.replace(tc, theta_band=jcb.theta_band)
        want = np.asarray(jhough.hough_transform_tiered(
            jnp.asarray(edges), jcb,
            theta_bins=None if band is None else jnp.asarray(band)))
        got = though.hough_transform_tiered(
            torch.from_numpy(edges), tcb,
            theta_bins=None if band is None else torch.from_numpy(band))
        np.testing.assert_array_equal(got.numpy(), want)


def test_get_lines_equal_on_same_votes(frames):
    imgs, _ = frames
    edges = np.asarray(jcanny(jnp.asarray(imgs), JCanny()))
    votes = np.asarray(jhough.hough_transform(jnp.asarray(edges),
                                              jhough.HoughConfig()))
    jl, jv, jp = jlines.get_lines(jnp.asarray(votes), height=H, width=W)
    tl, tv, tp = tlines.get_lines(torch.from_numpy(votes), height=H, width=W)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # endpoints go through cos/sin, whose f32 results differ from XLA's in
    # the last ulp for some angles: a few ulps of a ~1000 px coordinate
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-3)


@pytest.mark.parametrize("cfg_kw", [
    {}, {"threshold_rel": None, "threshold": 3.0}, {"neighborhood": 4},
    {"min_votes": 2.0, "max_lines": 40},
])
def test_get_lines_ties_and_options(cfg_kw):
    """Equal scores keep the reference's order (lower flat index first),
    and every threshold / window option agrees."""
    votes = np.zeros((2, 30, 12), np.float32)
    votes[0, 3, 1] = votes[0, 9, 5] = votes[0, 20, 2] = votes[0, 25, 10] = 5.0
    votes[0, 14, 7] = 3.0
    votes[0, 14, 9] = 3.0
    votes[1] = np.random.default_rng(1).integers(0, 6, (30, 12))
    jcfg = jlines.LinesConfig(n_theta=12, **cfg_kw)
    tcfg = tlines.LinesConfig(n_theta=12, **cfg_kw)
    band = np.array([0, 2, 3, 5, 7, 8, 9, 11, 11, 1, 4, 6], np.int32)
    for tb in (None, band):
        want = jlines.get_lines(jnp.asarray(votes), height=20, width=20,
                                cfg=jcfg, theta_bins=None if tb is None
                                else jnp.asarray(tb))
        got = tlines.get_lines(torch.from_numpy(votes), height=20, width=20,
                               cfg=tcfg, theta_bins=None if tb is None
                               else torch.from_numpy(tb))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-4)
    # the tie case really is one: torch.topk would order it differently
    flat = np.where(votes[0] > 0, votes[0], -1).ravel()
    assert (flat == 5.0).sum() == 4


def test_render_lines_matches_reference(rng):
    img = rng.integers(0, 255, (2, 24, 30)).astype(np.uint8)
    lines = rng.uniform(-5, 35, (2, 3, 4)).astype(np.float32)
    valid = np.array([[True, False, True], [False, False, True]])
    want = np.asarray(jlines.render_lines(jnp.asarray(img), jnp.asarray(lines),
                                          jnp.asarray(valid)))
    got = tlines.render_lines(torch.from_numpy(img), torch.from_numpy(lines),
                              torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
