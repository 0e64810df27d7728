"""The port's float -> int rewrite against the JAX package, on the CPU.

``core.quantize`` (``quantize``, ``dequantize``, ``quantize_frames``,
``quantize_weights_int8``, ``quantized_matmul``) bit for bit with
``repro.core.quantize`` on shared numpy inputs; the matmul seam's plain
version (``ops.tiled_matmul`` on a CPU tensor) against the reference's
oracle and its Pallas body in interpret mode, with tests/test_kernels.py's
sweep and tolerances; the reference's int8-serving criteria
(tests/test_serving_extras.py) on the port's SMOKE decode.  The matmul
kernel itself runs on the card in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.tiled_matmul import tiled_matmul as jtiled  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_reference, lm_quantized_params_from_reference,
    model_config_from_reference,
)
from repro_torch.core import (  # noqa: E402
    dequantize, quantize, quantize_frames, quantize_weights_int8,
    quantized_matmul,
)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import tiled_matmul as mm_mod  # noqa: E402
from repro_torch.models import build, layers  # noqa: E402

# the module, which repro.core's own ``quantize`` function shadows
jq = importlib.import_module("repro.core.quantize")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# --- quantize / dequantize ----------------------------------------------------


@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1), (-2, -1)],
                         ids=["tensor", "axis0", "axis1", "axes01", "frame"])
def test_quantize_and_dequantize_bit_exact(rng, bits, axis):
    x = (rng.normal(size=(3, 17, 29)) * rng.uniform(0.1, 50, (3, 1, 1))
         ).astype(np.float32)
    x[1, 0, :4] = 0.5 * np.max(np.abs(x[1])) / (2 ** (bits - 1) - 1)  # ~half a step
    x[2] = 0.0          # a zero slice takes the 1e-12 floor
    got, want = quantize(_t(x), bits=bits, axis=axis), jq.quantize(
        jnp.asarray(x), bits=bits, axis=axis)
    _equal(got.values, want.values)
    _equal(got.scale, want.scale)
    _equal(dequantize(got), jq.dequantize(want))


def test_quantize_saturates_at_32_bits_as_the_reference():
    """At 32 bits the clip bound 2^31 - 1 rounds to 2^31 in f32: XLA's
    cast saturates it to 2^31 - 1, torch's own cast would wrap it."""
    x = np.array([3.0, -1.5, 0.25], np.float32)
    got = quantize(_t(x), bits=32)
    assert int(got.values[0]) == 2 ** 31 - 1
    _equal(got.values, jq.quantize(jnp.asarray(x), bits=32).values)


def test_quantize_frames_bit_exact(rng):
    imgs = rng.uniform(0, 255, (4, 24, 40)).astype(np.float32)
    imgs[1] *= 0.1     # a dark frame keeps its own range
    got, want = quantize_frames(_t(imgs)), jq.quantize_frames(
        jnp.asarray(imgs))
    assert tuple(got.scale.shape) == (4, 1, 1)
    _equal(got.values, want.values)
    _equal(got.scale, want.scale)


# --- quantize_weights_int8 ----------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "h2o-danube-1.8b"])
def test_quantize_weights_int8_matches_the_reference_leaf_for_leaf(arch):
    jcfg = jget_smoke(arch)
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    jqs, jdequant = jq.quantize_weights_int8(jp, compute_dtype=jcfg.cdtype)
    want = lm_quantized_params_from_reference(cfg, _np(jqs))
    got, dequant = quantize_weights_int8(
        lm_params_from_reference(cfg, _np(jp)), compute_dtype=cfg.cdtype)
    n = 0
    for part in ("q", "s"):
        g, w = dict(layers.tree_items(got[part])), dict(
            layers.tree_items(want[part]))
        assert g.keys() == w.keys()
        for path in g:
            assert g[path].dtype == w[path].dtype, path
            assert torch.equal(g[path], w[path]), path
            n += 1
    assert n == 2 * len(list(layers.tree_items(jp)))
    deq = dict(layers.tree_items(dequant(got["q"], got["s"])))
    for path, leaf in layers.tree_items(_np(jdequant(jqs["q"], jqs["s"]))):
        _equal(deq[path].float(), np.asarray(leaf, np.float32))
        assert deq[path].dtype == cfg.cdtype


def test_stacked_leaf_shares_one_scale_per_column_across_layers(rng):
    """A stacked (L, D, F) leaf reduces over (0, 1): one scale per output
    column for all L layers, not one per layer."""
    w = rng.normal(size=(3, 8, 5)).astype(np.float32)
    w[0] *= 10.0       # layer 0 sets the range of every column
    got, _ = quantize_weights_int8({"blocks": {"w": _t(w)}})
    s = got["s"]["blocks"]["w"]
    assert tuple(s.shape) == (1, 1, 5)
    np.testing.assert_array_equal(
        s.numpy()[0, 0],
        np.maximum(np.abs(w).max(axis=(0, 1)), 1e-12) / np.float32(127))
    per_layer = np.abs(w).max(axis=1)                    # (3, 5)
    assert (per_layer[1:] < per_layer[0]).all()
    assert int(got["q"]["blocks"]["w"][1:].abs().max()) < 127
    jqs, _ = jq.quantize_weights_int8({"blocks": {"w": jnp.asarray(w)}})
    _equal(s, jqs["s"]["blocks"]["w"])
    _equal(got["q"]["blocks"]["w"], jqs["q"]["blocks"]["w"])


def test_integer_leaves_pass_through(rng):
    tree = {"ids": np.arange(6, dtype=np.int32).reshape(2, 3),
            "norm": rng.normal(size=(7,)).astype(np.float32)}
    got, dequant = quantize_weights_int8(
        {k: _t(v) for k, v in tree.items()}, compute_dtype=torch.float32)
    jqs, jdequant = jq.quantize_weights_int8(
        {k: jnp.asarray(v) for k, v in tree.items()},
        compute_dtype=jnp.float32)
    assert torch.equal(got["q"]["ids"], _t(tree["ids"]))
    _equal(got["s"]["ids"], jqs["s"]["ids"])
    assert got["s"]["ids"].shape == () and float(got["s"]["ids"]) == 1.0
    assert got["s"]["norm"].shape == ()          # a 1-D leaf: one scale
    _equal(got["q"]["norm"], jqs["q"]["norm"])
    # as the reference, dequant turns every signed-integer leaf into the
    # compute dtype, the passed-through one too
    deq, jdeq = dequant(got["q"], got["s"]), jdequant(jqs["q"], jqs["s"])
    for k in tree:
        _equal(deq[k], jdeq[k])


def test_quantized_tree_conversion_checks_the_scales():
    jcfg = jget_smoke("zamba2-1.2b")
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    jqs, _ = jq.quantize_weights_int8(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    qs = _np(jqs)
    qs["s"]["final_norm"]["w"] = np.ones((1, 3), np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        lm_quantized_params_from_reference(cfg, qs)
    qs["s"]["final_norm"] = {"w": np.ones((), np.float32),
                             "extra": np.ones((), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        lm_quantized_params_from_reference(cfg, qs)


# --- quantized_matmul ------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(32, 48, 16), (33, 129, 65), (100, 70, 50),
                                   (1, 1, 1), (4, 300, 7)])
def test_quantized_matmul_bit_exact(rng, m, k, n):
    x = rng.normal(size=(m, k)).astype(np.float32)
    y = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    got = quantized_matmul(_t(x), _t(y))
    _equal(got, jq.quantized_matmul(jnp.asarray(x), jnp.asarray(y)))
    if (m, k, n) == (32, 48, 16):    # tests/test_core.py's bound
        want = x @ y
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 0.05


# --- the matmul seam's plain version ----------------------------------------------


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (100, 70, 50), (128, 128, 128),
                                   (33, 129, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_matmul_float_matches_the_reference(rng, m, k, n, dtype):
    x = rng.normal(size=(m, k)).astype(np.float32)
    y = rng.normal(size=(k, n)).astype(np.float32)
    jx, jy = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    ty = _t(np.asarray(jy.astype(jnp.float32))).to(getattr(torch, dtype))
    got = ops.tiled_matmul(tx, ty)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (jref.tiled_matmul(jx, jy),
                 jtiled(jx, jy, interpret=True, bm=32, bn=32, bk=32)):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
            atol=tol)


@pytest.mark.parametrize("m,k,n", [(16, 32, 16), (64, 48, 32)])
def test_tiled_matmul_int8_exact(rng, m, k, n):
    x = rng.integers(-127, 127, (m, k), dtype=np.int8)
    y = rng.integers(-127, 127, (k, n), dtype=np.int8)
    got = ops.tiled_matmul(_t(x), _t(y))
    assert got.dtype == torch.int32
    _equal(got, jref.tiled_matmul(jnp.asarray(x), jnp.asarray(y)))
    _equal(got, jtiled(jnp.asarray(x), jnp.asarray(y), interpret=True,
                       bm=16, bn=16, bk=16))


def test_tiled_matmul_int8_does_not_wrap_where_int8_mm_would():
    """torch.mm of two int8 tensors returns int8 and wraps on the CPU; the
    plain version accumulates exactly, to the reference's int32."""
    x = np.full((3, 257), -128, np.int8)
    y = np.full((257, 2), -128, np.int8)
    assert int(torch.mm(_t(x), _t(y))[0, 0]) != 257 * 128 * 128
    got = ops.tiled_matmul(_t(x), _t(y))
    assert int(got[0, 0]) == 257 * 128 * 128
    _equal(got, jref.tiled_matmul(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.int32])
def test_tiled_matmul_out_dtype(rng, out_dtype):
    x = rng.integers(-127, 127, (5, 9), dtype=np.int8)
    y = rng.integers(-127, 127, (9, 4), dtype=np.int8)
    got = ops.tiled_matmul(_t(x), _t(y), out_dtype=out_dtype)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.int32
    _equal(got, jref.tiled_matmul(jnp.asarray(x), jnp.asarray(y),
                                  out_dtype=jdt))
    xf = rng.normal(size=(6, 10)).astype(np.float32)
    yf = rng.normal(size=(10, 3)).astype(np.float32)
    got16 = ops.tiled_matmul(_t(xf).half(), _t(yf).half(),
                             out_dtype=torch.float32)
    assert got16.dtype == torch.float32   # f16 accumulates in f32 here
    np.testing.assert_allclose(
        got16.numpy(), np.asarray(jref.tiled_matmul(
            jnp.asarray(xf, jnp.float16), jnp.asarray(yf, jnp.float16),
            out_dtype=jnp.float32)), rtol=1e-5, atol=1e-5)


def test_cpu_matmul_launches_no_kernel_and_the_kernel_refuses(rng):
    ops.reset_launch_counts()
    x = _t(rng.normal(size=(6, 5)).astype(np.float32))
    quantized_matmul(x, x.T.contiguous())
    ops.tiled_matmul(x, x.T.contiguous())
    assert ops.launch_counts()["tiled_matmul"] == 0
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        mm_mod.tiled_matmul(a, a.T.contiguous())
    with pytest.raises(TypeError, match="share"):
        mm_mod.tiled_matmul(a, a.T.float())
    with pytest.raises(TypeError, match="do not give"):
        mm_mod.tiled_matmul(a, a.T.contiguous(), out_dtype=torch.float32)
    with pytest.raises(TypeError, match="share"):
        mm_mod.tiled_matmul(a.int(), a.T.int())
    with pytest.raises(ValueError, match="contiguous"):
        mm_mod.tiled_matmul(a, a.T)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        mm_mod.tiled_matmul(a, a)
    assert ops.launch_counts()["tiled_matmul"] == 0


# --- int8 weight serving ---------------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "h2o-danube-1.8b"])
def test_int8_weight_serving_accuracy(arch):
    """tests/test_serving_extras.py's criteria on the port's SMOKE decode:
    teacher-forced, int8 weights (dequantized to the compute dtype) keep
    every logit within 0.5 std of the bf16 weights' and 70% of the top-1
    tokens."""
    cfg = get_smoke(arch)
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    q, dequant = quantize_weights_int8(params, compute_dtype=cfg.cdtype)
    params_q = dequant(q["q"], q["s"])
    B, L, steps = 2, 24, 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, steps)))
    cache_a, cache_b = m.init_cache(B, L), m.init_cache(B, L)
    errs, la_all, matches = [], [], 0
    for t in range(steps):
        pos = torch.full((B,), t)
        la, cache_a = m.decode_step(params, toks[:, t], cache_a, pos)
        lb, cache_b = m.decode_step(params_q, toks[:, t], cache_b, pos)
        errs.append(float((la - lb).abs().max()))
        la_all.append(la)
        matches += int((la.argmax(-1) == lb.argmax(-1)).sum())
    std = float(torch.stack(la_all).std(correction=0))   # jnp.std
    assert max(errs) < 0.5 * std, (max(errs), std)
    assert matches >= int(0.7 * B * steps), matches
