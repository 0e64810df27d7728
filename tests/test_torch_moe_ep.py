"""The port's expert parallelism (``models/moe.py::moe_ep``) and the
gradients of its ``sharding.shard_map`` against the JAX package, on the
CPU.

Both packages run ``moe_ep`` under ``activate`` on a mesh: the port's a
world-size-1 gloo ``DeviceMesh`` (``make_host_mesh(device="cpu")``), the
reference's a ``jax.make_mesh`` of ``AxisType.Auto`` axes (jax 0.9.0's
default ``Explicit`` axes make the reference's ``constrain`` raise).  On a
(1, 1) mesh: one MoE layer of each MoE arch's SMOKE config at decode
(4 x 1) and train (16 x 8) sizes, outputs, the aux loss and ``jax.grad``
through it under ``DEFAULT_RULES`` (FSDP) and ``DECODE_RULES``; the
fault this slice repairs (``apply_moe(strategy="ep")`` took ``moe_sort``
under a mesh); the whole moonshot SMOKE model's forward, prefill and
decode step.  The fallbacks to ``moe_sort`` are the reference's.  One
spawned case: two gloo ranks on a ``FileStore`` under ``tmp_path`` run
the mesh shapes (1, 2) and (2, 1) in turn, beside the reference on two
host devices in one JAX subprocess.

Random routers sit near ties: every comparison first asserts that both
packages chose the same experts.  One torch thread, SMOKE shapes.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import sharding as jsharding  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.model_zoo import materialize_inputs  # noqa: E402
from repro.configs import ShapeSpec  # noqa: E402

from repro_torch import sharding  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_reference, model_config_from_reference,
)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import build, moe, transformer  # noqa: E402
from repro_torch.sharding import partition as part  # noqa: E402
from repro_torch.sharding.partition import PartitionSpec as PS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ("llama4-scout-17b-a16e", "moonshot-v1-16b-a3b")
RULES = {"default": (sharding.DEFAULT_RULES, jsharding.DEFAULT_RULES),
         "decode": (sharding.DECODE_RULES, jsharding.DECODE_RULES)}
AUX_COEF = 3.0       # the aux loss's weight in the differentiated scalar
# With top-1 routing the combine weight w / sum(w) is exactly 1, and the
# router's gradient through it is the rounding residue of 1/w - w/w^2,
# which the two packages round differently: their moe_sort gradients lie
# 1.5e-4 apart in norm on the 16 x 8 input here, as their moe_ep ones do.
# That leaf is held to TOP1_ROUTER_TOL of its norm, every other to 1e-5.
TOP1_ROUTER_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh():
    """The port's (1, 1) gloo host mesh; its process group is destroyed
    after the test, and none is left."""
    assert not dist.is_initialized()
    try:
        yield make_host_mesh(device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()


def _jmesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _cfgs(arch, compute_dtype="float32", **moe_kw):
    jcfg = jget_smoke(arch).replace(compute_dtype=compute_dtype)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
    return jcfg, model_config_from_reference(dataclasses.asdict(jcfg))


def _layer(jcfg, B, S, seed=0):
    """One MoE layer's parameters drawn by the reference (numpy), an input
    (B, S, D) and a cotangent of its shape, from ``seed``."""
    jp = jax.tree.map(np.asarray, jlayers.materialize(
        jax.random.PRNGKey(seed), jmoe.moe_spec(jcfg)))
    rng = np.random.default_rng(seed + 1)
    x, cot = (rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
              for _ in range(2))
    return jp, x, cot


def _reference(jp, x, cot, jcfg, jmesh, rules):
    """The reference's ``moe_ep`` under ``activate(jmesh, rules)``: y, aux
    and the gradients of ``sum(y * cot) + AUX_COEF * aux`` by the
    parameters and x, as numpy."""
    def loss(p, x):
        y, aux = jmoe.moe_ep(p, x, jcfg)
        return jnp.sum(y * cot) + AUX_COEF * aux, (y, aux)

    with jsharding.activate(jmesh, rules):
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
                jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    return (np.asarray(y), float(aux),
            {**jax.tree.map(np.asarray, gp), "x": np.asarray(gx)})


def _port(jp, x, cot, cfg, mesh, rules):
    """The port's ``moe_ep`` under ``activate(mesh, rules)``, as
    :func:`_reference`."""
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    with sharding.activate(mesh, rules):
        y, aux = moe.moe_ep(tp, tx, cfg)
    ((y * torch.from_numpy(cot)).sum() + AUX_COEF * aux).backward()
    return (y.detach().numpy(), float(aux.detach()),
            {**{k: t.grad.numpy() for k, t in tp.items()},
             "x": tx.grad.numpy()})


def _same_experts(jp, x, jcfg, cfg):
    """Both packages' top-k experts of ``x``'s tokens, asserted equal."""
    x2d = x.reshape(-1, x.shape[-1])
    _, _, want = jmoe._route(jax.tree.map(jnp.asarray, jp),
                             jnp.asarray(x2d), jcfg.moe)
    _, _, got = moe._route({"router": torch.from_numpy(jp["router"].copy())},
                           torch.from_numpy(x2d), cfg.moe)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_close(got, want, top_k, what=""):
    """y within 1e-5 of max|y|, aux within 1e-5 relative, each gradient
    within 1e-5 of its norm (a top-1 router's ``TOP1_ROUTER_TOL``)."""
    (y, aux, g), (wy, waux, wg) = got, want
    assert np.abs(y - wy).max() <= 1e-5 * np.abs(wy).max(), what
    assert aux == pytest.approx(waux, rel=1e-5), what
    assert g.keys() == wg.keys()
    for k in wg:
        tol = TOP1_ROUTER_TOL if (k, top_k) == ("router", 1) else 1e-5
        assert np.linalg.norm(g[k] - wg[k]) <= \
            tol * np.linalg.norm(wg[k]), (what, k)


# --- one layer on a one-device mesh -------------------------------------------


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("B,S", [(4, 1), (16, 8)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ep_matches_the_reference_on_one_device(mesh, arch, B, S, rules):
    """A (1, 1) mesh in both packages, f32: outputs within 1e-5 of max|y|,
    the aux loss within 1e-5 relative, and the gradients of x and the four
    weights within 1e-5 of their norms; under ``DEFAULT_RULES`` the expert
    weights cross an FSDP gather of one rank."""
    jcfg, cfg = _cfgs(arch)
    jp, x, cot = _layer(jcfg, B, S)
    _same_experts(jp, x, jcfg, cfg)
    port_rules, ref_rules = RULES[rules]
    _assert_close(_port(jp, x, cot, cfg, mesh, port_rules),
                  _reference(jp, x, cot, jcfg, _jmesh((1, 1)), ref_rules),
                  cfg.moe.top_k)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_ep_under_a_mesh_is_the_references_moe_ep(mesh, arch):
    """The fault pin: under ``activate`` on (1, 1), ``apply_moe(strategy=
    "ep")`` at 4 tokens is the reference's ``moe_ep``, whose per-shard
    capacity is floored at ``min(T k, 32)``; ``moe_sort``'s ``C = k``
    drops assignments there, so the two lie far apart."""
    jcfg, cfg = _cfgs(arch)
    jp, x, _ = _layer(jcfg, 4, 1)
    _same_experts(jp, x, jcfg, cfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    tx = torch.from_numpy(x)
    with sharding.activate(mesh):
        got, aux = moe.apply_moe(tp, tx, cfg, strategy="ep")
    with jsharding.activate(_jmesh((1, 1))):
        want, want_aux = jmoe.apply_moe(jax.tree.map(jnp.asarray, jp),
                                        jnp.asarray(x), jcfg, strategy="ep")
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    sort, _ = moe.moe_sort(tp, tx, cfg)
    assert float((got - sort).abs().max()) > 0.1
    # outside a mesh, "ep" is moe_sort in both packages
    assert moe.apply_moe(tp, tx, cfg, strategy="ep")[0].equal(sort)


class _Mesh:
    """What ``moe_ep`` reads of a JAX mesh before it falls back, and the
    context the reference's ``activate`` enters."""

    def __init__(self, shape, names):
        self.axis_names, self.shape = names, dict(zip(names, shape))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("shape,names,B", [
    (None, None, 4),                              # no active mesh
    ((1,), ("data",), 4),                         # no model axis
    ((1, 3), ("data", "model"), 4),               # 8 experts % 3
    ((3, 1), ("data", "model"), 4),               # B % dp
    ((1, 2, 1), ("pod", "data", "model"), 3),     # B % (pod x data)
])
def test_falls_back_to_moe_sort_where_the_reference_does(monkeypatch, shape,
                                                         names, B):
    """Both packages' ``moe_ep`` call their ``moe_sort`` in the same five
    cases (meshes read by shape only)."""
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b")
    calls = []
    monkeypatch.setattr(moe, "moe_sort", lambda *a: calls.append("port"))
    monkeypatch.setattr(jmoe, "moe_sort", lambda *a: calls.append("ref"))
    x = np.zeros((B, 1, jcfg.d_model), np.float32)
    if shape is None:
        moe.moe_ep({}, torch.from_numpy(x), cfg)
        jmoe.moe_ep({}, x, jcfg)
    else:
        with sharding.activate(part.AbstractMesh(shape, names)):
            moe.moe_ep({}, torch.from_numpy(x), cfg)
        with jsharding.activate(_Mesh(shape, names)):
            jmoe.moe_ep({}, x, jcfg)
    assert calls == ["port", "ref"]


# --- the whole model under activate ---------------------------------------------


def _bulk(got, want):
    """``tests/test_distributed.py::test_moe_ep_matches_reference``'s
    bounds: MoE routing is discontinuous, so bf16 noise can flip a
    borderline token's expert between paths."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.quantile(diff, 0.99) < 3e-2, np.quantile(diff, 0.99)
    assert diff.mean() < 5e-3, diff.mean()
    assert diff.max() < 1.0, diff.max()


def test_whole_model_under_activate_matches_the_reference(mesh):
    """moonshot SMOKE (bf16, published capacity) under ``activate`` on
    (1, 1) in both packages, strategy ``"ep"`` by default: the forward's
    logits at 16 x 8 (``DEFAULT_RULES``), then a 4 x 8 prefill and two
    decode steps (``DECODE_RULES``, where ``moe_ep``'s floored capacity
    keeps what ``moe_sort`` drops), held to the reference within
    ``test_distributed.py``'s bulk bounds."""
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b", compute_dtype="bfloat16")
    jm = jbuild(jcfg)
    key = jax.random.PRNGKey(0)
    jp = jm.init(key)
    m = build(cfg, device="cpu")
    params = m.load(lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, jp)))
    batch = materialize_inputs(key, jcfg, ShapeSpec("t", 16, 8, "train"))
    jmesh = _jmesh((1, 1))
    with jsharding.activate(jmesh):
        want, _ = jax.jit(lambda p, b: jtransformer.forward(p, b, jcfg))(
            jp, batch)
    with sharding.activate(mesh):
        got, _ = transformer.forward(
            params, {k: torch.from_numpy(np.array(v))
                     for k, v in batch.items()}, cfg)
    _bulk(got.float().numpy(), np.asarray(want, np.float32))

    tokens = np.random.default_rng(2).integers(
        1, jcfg.vocab, (4, 8)).astype(np.int32)
    with jsharding.activate(jmesh, jsharding.DECODE_RULES):
        jlog, jcache = jax.jit(jm.prefill)(
            jp, {"tokens": jnp.asarray(tokens)}, jm.init_cache(4, 16))
        ref = [np.asarray(jlog)]
        step = jax.jit(jm.decode_step)
        for i in range(2):
            tok = jnp.asarray(np.argmax(ref[-1], -1).astype(np.int32))
            pos = jnp.full((4,), 8 + i, jnp.int32)
            jlog, jcache = step(jp, tok, jcache, pos)
            ref.append(np.asarray(jlog))
    with sharding.activate(mesh, sharding.DECODE_RULES):
        cache = m.init_cache(4, 16)
        logits, cache = m.prefill(params, {"tokens": torch.from_numpy(
            tokens)}, cache)
        out = [logits]
        for i in range(2):
            # the reference's tokens, so a flipped argmax does not fork
            tok = torch.from_numpy(np.argmax(ref[i], -1).astype(np.int32))
            pos = torch.full((4,), 8 + i, dtype=torch.int32)
            logits, cache = m.decode_step(params, tok, cache, pos)
            out.append(logits)
    for g, w in zip(out, ref):
        _bulk(g.float().numpy(), w)


# --- gradients across shard_map -------------------------------------------------


def test_gradients_cross_shard_map_at_world_size_1(mesh):
    """On the (1, 1) mesh, gradients reach the inputs through a cut input
    and a gathered output (``PS("data")`` in and out) and a whole input
    and output (``PS()``); under ``torch.no_grad`` no autograd node is
    added and the forward is the same."""
    x = torch.arange(12.0).reshape(4, 3).requires_grad_()
    w = torch.tensor([1.0, -2.0, 0.5]).requires_grad_()

    def body(a, b):
        y = a * b
        return y, (y * y).sum()

    f = sharding.shard_map(body, mesh=mesh, in_specs=(PS("data"), PS()),
                           out_specs=(PS("data"), PS()))
    y, s = f(x, w)
    (y.sum() + s).backward()
    assert torch.allclose(x.grad, (w * (1 + 2 * x * w)).detach())
    assert torch.allclose(w.grad, (x * (1 + 2 * x * w)).sum(0).detach())
    with torch.no_grad():
        y2, _ = f(x, w)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


def test_body_collectives_carry_gradients_at_world_size_1(mesh):
    """``psum`` and the FSDP ``all_gather`` in a body, on ranks of one:
    their values and their gradients are the plain product's."""
    x = torch.arange(12.0).reshape(4, 3).requires_grad_()
    w = torch.tensor([1.0, -2.0, 0.5]).requires_grad_()

    def body(a, b):
        return part.psum(a * part.all_gather(b, mesh, "data", 0), mesh,
                         ("data", "model"))

    y = sharding.shard_map(body, mesh=mesh, in_specs=(PS("data"), PS()),
                           out_specs=PS("data"))(x, w)
    assert torch.equal(y, (x * w).detach())
    (y * y).sum().backward()
    assert torch.allclose(x.grad, (2 * x * w * w).detach())
    assert torch.allclose(w.grad, (2 * x * x * w).sum(0).detach())


# --- two spawned gloo ranks beside the reference on two devices -------------------

ARCH = "moonshot-v1-16b-a3b"
SHAPES = ((1, 2), (2, 1))
B, S = 4, 8

RANK = textwrap.dedent("""
    import dataclasses, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    from repro_torch import sharding
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe

    rank, out = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group(
        "gloo", store=dist.FileStore(out + "/store", 2), rank=rank,
        world_size=2)
    try:
        inp = torch.load(out + "/inputs.pt")
        cfg = get_smoke(inp["arch"]).replace(compute_dtype="float32")
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
        res = {}
        for shape in inp["shapes"]:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            for name in ("default", "decode"):
                rules = {"default": sharding.DEFAULT_RULES,
                         "decode": sharding.DECODE_RULES}[name]
                p = {k: v.clone().requires_grad_()
                     for k, v in inp["params"].items()}
                x = inp["x"].clone().requires_grad_()
                with sharding.activate(mesh, rules):
                    y, aux = moe.moe_ep(p, x, cfg)
                ((y * inp["cot"]).sum() + inp["aux_coef"] * aux).backward()
                res[f"{shape}/{name}"] = {
                    "y": y.detach(), "aux": aux.detach(),
                    "grads": {**{k: t.grad for k, t in p.items()},
                              "x": x.grad}}
        torch.save(res, f"{out}/rank{rank}.pt")
        assert "jax" not in sys.modules and "repro" not in sys.modules
    finally:
        dist.destroy_process_group()
""")

JAX_REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType

    from repro import sharding
    from repro.configs import get_smoke
    from repro.models import moe

    out = sys.argv[1]
    assert len(jax.devices()) == 2
    inp = dict(np.load(out + "/inputs.npz"))
    cfg = get_smoke(str(inp.pop("arch"))).replace(compute_dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    x, cot, coef = inp.pop("x"), inp.pop("cot"), float(inp.pop("aux_coef"))
    params = {k: jnp.asarray(v) for k, v in inp.items()}

    def loss(p, x, fn):
        y, aux = fn(p, x, cfg)
        return jnp.sum(y * cot) + coef * aux, (y, aux)

    rec = {}
    for shape in ((1, 2), (2, 1)):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        for name, rules in (("default", sharding.DEFAULT_RULES),
                            ("decode", sharding.DECODE_RULES)):
            with sharding.activate(mesh, rules):
                (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    lambda p, x: loss(p, x, moe.moe_ep), argnums=(0, 1),
                    has_aux=True))(params, jnp.asarray(x))
            key = f"{shape}/{name}"
            rec[f"{key}/y"], rec[f"{key}/aux"] = np.asarray(y), np.asarray(aux)
            for k, g in {**gp, "x": gx}.items():
                rec[f"{key}/grads/{k}"] = np.asarray(g)
    (_, (y, aux)), _ = jax.value_and_grad(
        lambda p, x: loss(p, x, moe.moe_sort), has_aux=True)(
            params, jnp.asarray(x))
    rec["sort/aux"] = np.asarray(aux)
    np.savez(out + "/reference.npz", **rec)
""")


def test_two_spawned_ranks_against_the_reference_on_two_devices(tmp_path):
    """Two gloo ranks run the moonshot SMOKE layer (f32, capacity factor 8)
    on meshes (1, 2) and (2, 1) under both rule tables, beside the
    reference on (1, 2) and (2, 1) Auto meshes of two host devices in one
    JAX subprocess (120 s each).  Both ranks hold the same global outputs
    and gradients, bit for bit; outputs within 1e-5 of max|y| of the
    reference's, gradients within 1e-5 of their norms, and the aux loss,
    a pmean over the data shards, within 1e-5 relative of the reference's
    at the same shape.  At (2, 1) that pmean lies away from the unsharded
    aux by the reference's own gap, which the port reproduces.  No rank
    imported JAX or the JAX package."""
    jcfg, cfg = _cfgs(ARCH, capacity_factor=8.0)
    jp, x, cot = _layer(jcfg, B, S)
    _same_experts(jp, x, jcfg, cfg)
    torch.save({"arch": ARCH, "shapes": SHAPES, "aux_coef": AUX_COEF,
                "params": {k: torch.from_numpy(v) for k, v in jp.items()},
                "x": torch.from_numpy(x), "cot": torch.from_numpy(cot)},
               tmp_path / "inputs.pt")
    np.savez(tmp_path / "inputs.npz", arch=ARCH, x=x, cot=cot,
             aux_coef=AUX_COEF, **jp)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    jenv = {**env, "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    procs = [subprocess.Popen([sys.executable, "-c", JAX_REFERENCE,
                               str(tmp_path)], env=jenv,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                                str(tmp_path)], env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    ref = dict(np.load(tmp_path / "reference.npz"))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for shape in SHAPES:
        for name in sorted(RULES):
            key = f"{shape}/{name}"
            a, b = ranks[0][key], ranks[1][key]
            assert torch.equal(a["y"], b["y"]) and torch.equal(a["aux"],
                                                               b["aux"])
            for k, g in a["grads"].items():
                assert torch.equal(g, b["grads"][k]), (key, k)
            got = (a["y"].numpy(), float(a["aux"]),
                   {k: g.numpy() for k, g in a["grads"].items()})
            want = (ref[f"{key}/y"], float(ref[f"{key}/aux"]),
                    {k: ref[f"{key}/grads/{k}"] for k in got[2]})
            _assert_close(got, want, cfg.moe.top_k, key)
    # the data shards' pmean: the reference's own gap, the port's too
    gap = float(ref["(2, 1)/default/aux"]) - float(ref["sort/aux"])
    assert abs(gap) > 1e-3
    got_gap = float(ranks[0]["(2, 1)/default"]["aux"]) - float(ref["sort/aux"])
    assert got_gap == pytest.approx(gap, rel=1e-4)
