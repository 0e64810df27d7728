"""The port's pod-compressed train step and its ``shard_map`` against the
JAX package, on the CPU.

``repro_torch.sharding.shard_map``: tree-prefix specs, blocks cut along a
manual axis at the rank's coordinate, outputs gathered back, the
manual-axis context (``constrain`` strips those axes as the reference's
does), the refusal of an automatic axis above size 1.
``repro_torch.train.trainer.make_train_step_pod_compressed``: at P = 1 on a
world-size-1 gloo ``("pod", "data", "model")`` mesh against the
reference's own step on a ``(1, 1, 1)`` mesh of Auto axes, step by step;
against the port's plain step under ``tests/test_distributed.py``'s
criteria; a placed state; its refusals; ``launch/train.py --compress-pod``
and its resume.  One spawned case: two gloo ranks on a ``FileStore``
under ``tmp_path`` beside the reference's step in one JAX subprocess on a
``(2, 1, 1)`` Auto mesh of two host devices.

Quantizer ties: where the port's gradient and the reference's differ in
their last bits, an element whose ``y / scale`` sits on a half step can
round to the other int8 value, which moves its residual by one scale.
Such elements are found (their residuals apart by more than 1e-2 of the
leaf's scale), checked to sit within 1e-3 of a half step and to have moved
by one scale within 1e-2, counted and bounded; every other element is held
to the tight tolerances.  One torch thread, SMOKE shapes.
"""

import dataclasses
import inspect
import math
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AxisType  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro import sharding as jsharding  # noqa: E402
from repro.configs import ShapeSpec  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.model_zoo import materialize_inputs  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro.train.state import init_train_state as jinit_train_state  # noqa: E402

import repro_torch.train as train_pkg  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.checkpoint.store import _flatten_with_paths  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_reference, model_config_from_reference,
    train_state_from_reference,
)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.layers import tree_items  # noqa: E402
from repro_torch.sharding import partition as part  # noqa: E402
from repro_torch.sharding.partition import (  # noqa: E402
    PartitionSpec as PS, distribute_tree,
)
from repro_torch.train import (  # noqa: E402
    AdamWConfig, init_train_state, make_train_step, train_state_shardings,
)
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    _mean_grads, make_train_step_pod_compressed,
)

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=100)
SHAPE = ShapeSpec("t", 16, 8, "train")
# quantizer ties (module docstring): the residual moved by more than
# TIE_MOVED of the leaf's scale; such an element lies within TIE_NEAR of a
# half step and moved by one scale within TIE_STEP; at most TIE_SHARE of a
# step's elements (measured: 0-2 of 106,816 a step)
TIE_MOVED, TIE_NEAR, TIE_STEP, TIE_SHARE = 1e-2, 1e-3, 1e-2, 1e-4
# the spawned case's parameters past 1e-6 of the reference's (its docstring)
PAST_SHARE = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers beside tests that are sensitive to wall-clock load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gloo_group():
    """No process group before the test; the one it makes is destroyed
    after it, and none is left."""
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _setup(compute_dtype="float32"):
    """SMOKE yi-9b in both packages (the reference test's config, here at
    ``compute_dtype``), the reference's seed-0 parameters, its batch of
    ``ShapeSpec("t", 16, 8, "train")`` and the port's model."""
    jcfg = jget_smoke("yi-9b").replace(compute_dtype=compute_dtype)
    cfg = model_config_from_reference(dataclasses.asdict(jcfg))
    jm = jbuild(jcfg)
    key = jax.random.PRNGKey(0)
    jp = jm.init(key)
    batch = materialize_inputs(key, jcfg, SHAPE)
    return jcfg, jm, jp, batch, cfg, build(cfg, device="cpu")


def _jmesh(shape):
    return jax.make_mesh(shape, ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)


class _StubMesh:
    """What ``shard_map`` reads of a mesh to cut its inputs: axis names,
    sizes, and this rank's coordinate on each axis."""

    def __init__(self, shape, names, coords):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)
        self._coords = dict(zip(names, coords))

    def size(self):
        return math.prod(self.shape)

    def get_local_rank(self, axis):
        return self._coords[axis]


# --- shard_map ---------------------------------------------------------------


def test_signatures_and_exports_are_the_references():
    for got, want in ((sharding.shard_map, jsharding.shard_map),
                      (make_train_step_pod_compressed,
                       jtrainer.make_train_step_pod_compressed)):
        a, b = inspect.signature(got), inspect.signature(want)
        assert [(p.name, p.kind, p.default) for p in a.parameters.values()] \
            == [(p.name, p.kind, p.default) for p in b.parameters.values()]
    assert sharding.shard_map is part.shard_map
    # as the reference's train/__init__.py, the package does not export
    # the pod step
    assert not hasattr(train_pkg, "make_train_step_pod_compressed")
    assert not hasattr(__import__("repro.train").train,
                       "make_train_step_pod_compressed")


def test_prefix_specs_pass_whole_leaves_as_they_are(gloo_group):
    """One ``PS()`` covers a whole ``TrainState`` (its ``None`` err too),
    in and out: the body sees the same tensors and they come back."""
    mesh = train_cli._pod_mesh("cpu")
    st = init_train_state({"w": torch.ones(3), "b": {"c": torch.zeros(2)}})
    seen = {}

    def body(state, extra):
        seen["state"], seen["extra"] = state, extra
        return state, {"n": extra["n"]}

    f = sharding.shard_map(body, mesh=mesh, in_specs=(PS(), PS()),
                           out_specs=PS(), axis_names={"pod"})
    extra = {"n": torch.tensor(2.0)}
    out, met = f(st, extra)
    assert type(out) is type(st) and out.err is None
    for (p, a), (_, b) in zip(tree_items(out.params), tree_items(st.params)):
        assert a is b, p
    assert seen["state"].params["w"] is st.params["w"]
    assert met["n"] is extra["n"]
    with pytest.raises(ValueError, match="not a prefix"):
        sharding.shard_map(body, mesh=mesh, in_specs=(PS(),),
                           out_specs=PS())(st, extra)


@pytest.mark.parametrize("shape,coords,axis_names,spec,rows", [
    ((2, 1, 1), (1, 0, 0), {"pod"}, PS("pod"), slice(4, 8)),
    ((2, 1, 1), (0, 0, 0), {"pod"}, PS("pod"), slice(0, 4)),
    # one dim over two manual axes, the first major
    ((2, 2, 1), (1, 0, 0), None, PS(("pod", "data")), slice(4, 6)),
    ((2, 2, 1), (1, 1, 0), None, PS(("pod", "data")), slice(6, 8)),
    # the rows' dim is not cut, the columns' is
    ((2, 1, 1), (1, 0, 0), {"pod"}, PS(None, "pod"), None),
])
def test_inputs_are_cut_at_the_ranks_coordinate(shape, coords, axis_names,
                                                spec, rows):
    """A leaf whose spec names a manual axis is cut along that dim; the
    rank keeps the block at its coordinate (``get_local_rank``)."""
    x = torch.arange(8 * 6).reshape(8, 6)
    mesh = _StubMesh(shape, ("pod", "data", "model"), coords)
    f = sharding.shard_map(lambda a, b: (a, b), mesh=mesh,
                           in_specs=(spec, PS()), out_specs=PS(),
                           axis_names=axis_names)
    got, whole = f(x, x)
    assert whole is x
    want = x[rows] if rows is not None else x[:, 3:6]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not split"):
        f(x[:7, :5], x)


def test_outputs_named_on_a_manual_axis_are_gathered(gloo_group):
    """On a one-rank pod axis, ``PS("pod")`` in and out round-trips the
    global array (the gather of one block), a fresh tensor."""
    mesh = train_cli._pod_mesh("cpu")
    x = torch.arange(12.0).reshape(4, 3)
    f = sharding.shard_map(lambda a: a * 2, mesh=mesh, in_specs=PS("pod"),
                           out_specs=PS("pod"), axis_names={"pod"})
    y = f(x)
    assert torch.equal(y, x * 2)
    g = sharding.shard_map(lambda a: a, mesh=mesh, in_specs=PS(None, "pod"),
                           out_specs=PS(None, "pod"), axis_names={"pod"})
    out = g(x)
    assert torch.equal(out, x) and out is not x


def test_manual_axes_context(gloo_group):
    """While the body runs, the map's axes are manual (nested maps add
    theirs); outside, none is, even after the body raised."""
    mesh = train_cli._pod_mesh("cpu")
    seen = []

    def inner(a):
        seen.append(set(part._MANUAL_AXES.get()))
        return a

    def outer(a):
        seen.append(set(part._MANUAL_AXES.get()))
        return sharding.shard_map(inner, mesh=mesh, in_specs=PS(),
                                  out_specs=PS(), axis_names={"data"})(a)

    x = torch.ones(2)
    sharding.shard_map(outer, mesh=mesh, in_specs=PS(), out_specs=PS(),
                       axis_names={"pod"})(x)
    assert seen == [{"pod"}, {"pod", "data"}]
    assert part._MANUAL_AXES.get() == frozenset()

    def fails(a):
        raise RuntimeError("body")

    with pytest.raises(RuntimeError, match="body"):
        sharding.shard_map(fails, mesh=mesh, in_specs=PS(), out_specs=PS(),
                           axis_names={"pod"})(x)
    assert part._MANUAL_AXES.get() == frozenset()


@pytest.mark.parametrize("axes,shape", [
    (("batch", "seq", "embed_act"), (4, 8, 16)),
    (("expert_cap", "embed"), (8, 16)),
    (("embed", "mlp"), (16, 32)),
])
def test_constrain_strips_the_manual_axes_as_the_reference(
        gloo_group, monkeypatch, axes, shape):
    """Inside a map manual over ``pod``, ``constrain`` drops ``pod`` from
    the spec, as the reference's: the placements a DTensor gets there are
    those of the spec the reference passes to ``with_sharding_constraint``
    on its (1, 1, 1) Auto mesh with ``pod`` manual; outside, the full
    spec's."""
    mesh = train_cli._pod_mesh("cpu")
    jmesh = _jmesh((1, 1, 1))
    specs = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: specs.append(tuple(spec)) or x)
    with jsharding.activate(jmesh):
        jx = np.zeros(shape, np.float32)
        jpart.constrain(jx, axes)
        token = jpart._MANUAL_AXES.set(frozenset({"pod"}))
        try:
            jpart.constrain(jx, axes)
        finally:
            jpart._MANUAL_AXES.reset(token)
    outside, inside = (part.NamedSharding(mesh, PS(*s)).placements
                       for s in specs)
    x = DTensor.from_local(torch.zeros(shape), mesh,
                           (Replicate(),) * 3, run_check=False)
    got = {}
    with sharding.activate(mesh):
        got["outside"] = sharding.constrain(x, axes).placements

        def body(a):
            got["inside"] = sharding.constrain(a, axes).placements
            got["plain"] = sharding.constrain(torch.zeros(shape), axes)
            return a

        sharding.shard_map(body, mesh=mesh, in_specs=PS(), out_specs=PS(),
                           axis_names={"pod"})(x)
    assert got["outside"] == outside and got["inside"] == inside
    assert torch.is_tensor(got["plain"])
    if axes[0] in ("batch", "expert_cap"):
        assert outside[0] == Shard(0) and inside[0] == Replicate()


def test_an_automatic_axis_above_size_1_is_refused():
    """Placing within a manual block waits with the collectives slice;
    unknown axes and shape-only meshes are refused too."""
    stub = _StubMesh((2, 2, 1), ("pod", "data", "model"), (0, 0, 0))
    with pytest.raises(NotImplementedError, match="collectives slice"):
        sharding.shard_map(lambda a: a, mesh=stub, in_specs=PS(),
                           out_specs=PS(), axis_names={"pod"})
    sharding.shard_map(lambda a: a, mesh=stub, in_specs=PS(),
                       out_specs=PS(), axis_names={"pod", "data"})
    with pytest.raises(ValueError, match="no axes"):
        sharding.shard_map(lambda a: a, mesh=stub, in_specs=PS(),
                           out_specs=PS(), axis_names={"replica"})
    with pytest.raises(ValueError, match="shape-only"):
        sharding.shard_map(lambda a: a, in_specs=PS(), out_specs=PS(),
                           mesh=part.AbstractMesh((1, 1), ("pod", "data")))


# --- the pod step at P = 1 against the reference's -----------------------------


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _against_the_reference(st, new, ref, grads, lr):
    """``new`` (the port's step from ``st``) against ``ref`` (the
    reference's next state), with the quantizer ties found from the
    port's own ``y = grads + st.err``.  Returns the tie count; asserts
    every tolerance."""
    ties = total = 0
    for path, e0 in tree_items(st.err):
        y = _leaf(grads, path) + e0
        s = float(comp._quantize(y)[1])
        r = (y / s).abs().numpy()
        near_half = np.abs(r - np.floor(r) - 0.5) <= TIE_NEAR
        d_err = np.abs(_leaf(new.err, path).numpy()
                       - _leaf(ref.err, path)) / s
        moved = d_err > TIE_MOVED
        assert near_half[moved].all(), path
        assert (np.abs(d_err[moved] - 1) <= TIE_STEP).all(), path
        assert (d_err[~moved] <= 1e-3).all(), path
        d_p = np.abs(_leaf(new.params, path).numpy()
                     - _leaf(ref.params, path))
        assert (d_p[~moved] <= 1e-6).all(), path
        assert (d_p[moved] <= 2 * lr).all(), path
        for k in ("m", "v"):
            want = _leaf(ref.opt[k], path)
            d = np.abs(_leaf(new.opt[k], path).numpy() - want)
            assert (d[~moved] <= 1e-5 * max(np.abs(want).max(), 1e-30)
                    ).all(), (k, path)
        ties += int(moved.sum())
        total += moved.size
    assert ties <= TIE_SHARE * total, (ties, total)
    return ties


@pytest.mark.parametrize("n_micro", [1, 2])
def test_p1_step_matches_the_references_step(gloo_group, n_micro):
    """3 steps of the reference's own pod step (``(1, 1, 1)`` Auto mesh,
    f32 compute); from each of its states, carried over by ``convert``,
    the port takes the same step on a world-size-1 gloo pod mesh.  loss,
    ce, grad_norm and lr within 1e-5 relative; params within 1e-6, m and
    v within 1e-5 of their max, err within 1e-3 of the leaf's scale, but
    at the quantizer ties (module docstring), counted."""
    jcfg, jm, jp, batch, cfg, m = _setup()
    jmesh = _jmesh((1, 1, 1))
    opt = AdamWConfig(**OPT)
    step = make_train_step_pod_compressed(m, opt, train_cli._pod_mesh("cpu"),
                                          n_micro=n_micro)
    tb = _tb(batch)
    ties = []
    with jsharding.activate(jmesh):
        jstep = jax.jit(jtrainer.make_train_step_pod_compressed(
            jm, joptim.AdamWConfig(**OPT), jmesh, n_micro=n_micro))
        js = jinit_train_state(jp, compression=True)
        for i in range(3):
            st = train_state_from_reference(cfg, _np(js))
            _, _, grads = _mean_grads(m.loss, st.params, tb, n_micro)
            js, jmet = jstep(js, batch)
            new, met = step(st, tb)
            assert int(new.step) == i + 1
            for k in ("loss", "ce", "grad_norm", "lr"):
                assert float(met[k]) == pytest.approx(float(jmet[k]),
                                                      rel=1e-5), (i, k)
            assert set(met) == set(jmet)
            ties.append(_against_the_reference(st, new, _np(js), grads,
                                               OPT["peak_lr"]))
    assert sum(ties) <= 8, ties


def test_pod_step_tracks_the_plain_step(gloo_group):
    """``test_distributed.py::test_pod_compressed_train_step``'s criteria
    on its config (SMOKE yi-9b, bf16 compute): 3 steps of the pod step and
    of the port's plain step on the same batch; loss within rtol 2e-2,
    ``final_norm`` within rtol 5e-2 and atol 1e-4."""
    _, _, jp, batch, cfg, m = _setup("bfloat16")
    params = lm_params_from_reference(cfg, _np(jp))
    opt = AdamWConfig(**OPT)
    pod = make_train_step_pod_compressed(m, opt, train_cli._pod_mesh("cpu"))
    plain = make_train_step(m, opt)
    s_c = init_train_state(params, compression=True)
    s_r = init_train_state(params)
    tb = _tb(batch)
    for _ in range(3):
        s_c, met_c = pod(s_c, tb)
        s_r, met_r = plain(s_r, tb)
    np.testing.assert_allclose(float(met_c["loss"]), float(met_r["loss"]),
                               rtol=2e-2)
    np.testing.assert_allclose(s_c.params["final_norm"]["w"].numpy(),
                               s_r.params["final_norm"]["w"].numpy(),
                               rtol=5e-2, atol=1e-4)
    assert not torch.equal(s_c.params["final_norm"]["w"],
                           params["final_norm"]["w"])


def test_a_placed_state_comes_back_placed(gloo_group):
    """On the one-device pod mesh, a state placed by
    ``train_state_shardings(compression=True)`` takes 2 steps on its local
    tensors, bit for bit the unplaced run, and comes back placed."""
    _, _, jp, batch, cfg, m = _setup()
    params = lm_params_from_reference(cfg, _np(jp))
    mesh = train_cli._pod_mesh("cpu")
    step = make_train_step_pod_compressed(m, AdamWConfig(**OPT), mesh)
    _, sh = train_state_shardings(m, mesh, compression=True)
    plain = init_train_state(params, compression=True)
    placed = distribute_tree(plain, sh)
    tb = _tb(batch)
    for _ in range(2):
        plain, met_a = step(plain, tb)
        placed, met_b = step(placed, tb)
    assert float(met_a["loss"]) == float(met_b["loss"])
    got, want = _flatten_with_paths(placed), _flatten_with_paths(plain)
    assert [k for k, _ in got] == [k for k, _ in want]
    shardings = dict(_flatten_with_paths(sh))
    for (k, a), (_, b) in zip(got, want):
        assert isinstance(a, DTensor), k
        assert a.placements == shardings[k].placements, k
        assert torch.equal(a.to_local(), b), k


def test_refusals(gloo_group):
    """A mesh with no ``pod`` axis (the reference asserts), a state with no
    residuals."""
    jcfg, jm, jp, batch, cfg, m = _setup()
    opt = AdamWConfig(**OPT)
    with pytest.raises(AssertionError):
        jtrainer.make_train_step_pod_compressed(
            jm, joptim.AdamWConfig(**OPT),
            jax.make_mesh((1, 1), ("data", "model")))
    with pytest.raises(ValueError, match="'pod'.*\\('data', 'model'\\)"):
        make_train_step_pod_compressed(m, opt, make_host_mesh(device="cpu"))
    dist.destroy_process_group()
    step = make_train_step_pod_compressed(m, opt, train_cli._pod_mesh("cpu"))
    params = lm_params_from_reference(cfg, _np(jp))
    with pytest.raises(ValueError, match="state.err"):
        step(init_train_state(params), _tb(batch))


# --- the CLI ---------------------------------------------------------------------


def _cli(*args):
    return ["--device", "cpu", "--arch", "zamba2-1.2b", "--preset", "smoke",
            "--log-every", "1", "--compress-pod", *map(str, args)]


def test_cli_compress_pod_trains_saves_err_and_resumes(capsys):
    """``--compress-pod --device cpu``: 3 steps with a checkpoint holding
    ``err``, then ``--steps 5 --resume`` from it; the resumed run's losses
    and final state (``err`` too) are the uninterrupted 5-step run's, bit
    for bit.  The state is unplaced (no DTensor), on the (1, 1, 1) pod
    mesh; no process group is left."""
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="pod_cli_", dir=ROOT / "build"))
    try:
        ck = tmp / "ck"
        state_a, hist_a = train_cli.main(_cli("--steps", 3, "--ckpt", ck))
        assert "mesh=(1, 1, 1)" in capsys.readouterr().out
        assert latest_step(str(ck)) == 3
        keys = [k for k, _ in _flatten_with_paths(state_a)]
        assert any(k.startswith(".err/") for k in keys)
        manifest = (ck / "step_00000003" / "manifest.json").read_text()
        assert all(k in manifest for k in keys)
        state_b, hist_b = train_cli.main(_cli("--steps", 5, "--ckpt", ck,
                                              "--resume"))
        assert "resumed from step 3" in capsys.readouterr().out
        assert [h["step"] for h in hist_b] == [4, 5]
        state_c, hist_c = train_cli.main(_cli("--steps", 5))
        assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist_c[3:]]
        assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                   for h in hist_c)
        assert latest_step(str(ck)) == 5
        got, want = _flatten_with_paths(state_b), _flatten_with_paths(state_c)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, a), (_, b) in zip(got, want):
            assert not isinstance(a, DTensor), k
            assert torch.equal(a, b), k
        assert not dist.is_initialized()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- two spawned gloo ranks beside the reference's step on two devices --------

RANK = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build
    from repro_torch.models.layers import tree_map
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import compression as comp
    from repro_torch.train.trainer import (
        _mean_grads, make_train_step_pod_compressed)

    rank, out = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group(
        "gloo", store=dist.FileStore(out + "/store", 2), rank=rank,
        world_size=2)
    try:
        inp = torch.load(out + "/inputs.pt")
        model = build(get_smoke("yi-9b").replace(compute_dtype="float32"),
                      device="cpu")
        mesh = train_cli._pod_mesh("cpu")
        assert tuple(mesh.shape) == (2, 1, 1)
        step = make_train_step_pod_compressed(
            model, AdamWConfig(**inp["opt"]), mesh)
        state = init_train_state(inp["params"], compression=True)
        rows = {k: v[4 * rank:4 * rank + 4] for k, v in inp["batch"].items()}
        steps = []
        for _ in range(2):
            _, _, g = _mean_grads(model.loss, state.params, rows, 1)
            scales = tree_map(lambda a, e: comp._quantize(a + e)[1], g,
                              state.err)
            state, met = step(state, inp["batch"])
            steps.append({"params": state.params, "opt": state.opt,
                          "err": state.err, "scales": scales,
                          "metrics": {k: float(v) for k, v in met.items()}})
        torch.save(steps, f"{out}/rank{rank}.pt")
        assert "jax" not in sys.modules and "repro" not in sys.modules
    finally:
        dist.destroy_process_group()
""")

JAX_REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from jax.sharding import AxisType

    from repro import sharding
    from repro.configs import ShapeSpec, get_smoke
    from repro.models import build
    from repro.models.model_zoo import materialize_inputs
    from repro.train import AdamWConfig
    from repro.train.state import init_train_state
    from repro.train.trainer import make_train_step_pod_compressed

    out = sys.argv[1]
    assert len(jax.devices()) == 2
    cfg = get_smoke("yi-9b").replace(compute_dtype="float32")
    m = build(cfg)
    key = jax.random.PRNGKey(0)
    batch = materialize_inputs(key, cfg, ShapeSpec("t", 16, 8, "train"))
    mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    devices = list(mesh.devices.flat)

    def flat(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {"/".join(k.key for k in p): v for p, v in leaves}

    rec = {f"batch/{k}": np.asarray(v) for k, v in batch.items()}
    with sharding.activate(mesh):
        step = jax.jit(make_train_step_pod_compressed(
            m, AdamWConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=100),
            mesh))
        state = init_train_state(m.init(key), compression=True)
        for i in range(2):
            state, met = step(state, batch)
            for k, v in met.items():
                rec[f"{i}/metrics/{k}"] = np.asarray(v)
            for k, v in flat({"params": state.params,
                              "opt": state.opt}).items():
                rec[f"{i}/{k}"] = np.asarray(v)
            # each device holds its own pod's residuals
            for k, v in flat(state.err).items():
                shards = {s.device: s.data for s in v.addressable_shards}
                for p, d in enumerate(devices):
                    rec[f"{i}/err{p}/{k}"] = np.asarray(shards[d])
    np.savez(out + "/reference.npz", **rec)
""")


def _flat(tree, prefix=""):
    return {prefix + "/".join(p): t for p, t in tree_items(tree)}


def test_two_spawned_ranks_against_the_references_step_on_two_devices(
        tmp_path):
    """Two gloo ranks, each a pod of 4 of the 8 rows, take 2 pod steps
    from the reference's parameters (f32 compute); beside them the
    reference's step runs on a (2, 1, 1) Auto mesh of two host devices in
    one JAX subprocess (120 s each).  The ranks' params and opt are the
    same bits after each step, as are their metrics; loss, ce, grad_norm
    and lr within 1e-5 relative of the reference's; each rank's err
    within 1e-3 of its scale of the reference's own shard for that pod
    after the first step, 3e-3 after the second (which starts from the
    parameters the first step's ties moved), and m and v within 1e-5 of
    their max, but at the quantizer ties (module docstring; at the second
    step also the elements they moved, within one scale); every
    parameter within 2 lr, and at most
    ``PAST_SHARE`` of them past 1e-6.  Those are where the pods' terms
    nearly cancel: the mean's few ulps of difference are then a large
    share of it, and AdamW's first steps, which divide it by its own size
    plus 1e-8, pass that on (measured: 3 and 4 elements of 106,816).  No
    rank imported JAX or the JAX package."""
    jcfg, jm, jp, batch, cfg, m = _setup()
    torch.save({"params": lm_params_from_reference(cfg, _np(jp)),
                "batch": _tb(batch), "opt": OPT}, tmp_path / "inputs.pt")
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
    for k, v in batch.items():
        np.testing.assert_array_equal(ref[f"batch/{k}"], np.asarray(v))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    lr = OPT["peak_lr"]
    ties = total = past = n_params = 0
    for i in range(2):
        a, b = ranks[0][i], ranks[1][i]
        assert a["metrics"] == b["metrics"]
        for tree in ("params", "opt"):
            fa, fb = _flat(a[tree]), _flat(b[tree])
            assert fa.keys() == fb.keys()
            for k in fa:
                assert torch.equal(fa[k], fb[k]), (i, tree, k)
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert a["metrics"][k] == pytest.approx(
                float(ref[f"{i}/metrics/{k}"]), rel=1e-5), (i, k)
        params, opt = _flat(a["params"]), _flat(a["opt"])
        moved_any = {}
        for p, rank in enumerate(ranks):
            scales, errs = _flat(rank[i]["scales"]), _flat(rank[i]["err"])
            for k, e in errs.items():
                s = float(scales[k])
                d = np.abs(e.numpy() - ref[f"{i}/err{p}/{k}"]) / s
                moved = d > TIE_MOVED
                # a residual lies within half a scale of zero in both
                # packages; at the first step a moved one is a tie
                assert (d[moved] <= 1 + TIE_STEP).all(), (i, p, k)
                if i == 0:
                    assert (np.abs(d[moved] - 1) <= TIE_STEP).all(), (p, k)
                assert (d[~moved] <= (1e-3, 3e-3)[i]).all(), (i, p, k)
                moved_any[k] = moved_any.get(k, False) | moved
                ties += int(moved.sum())
                total += moved.size
        for k, t in params.items():
            d = np.abs(t.numpy() - ref[f"{i}/params/{k}"])
            assert (d <= 2 * lr).all(), (i, k)
            past += int((d > 1e-6).sum())
            n_params += d.size
            for mv in ("m", "v"):
                want = ref[f"{i}/opt/{mv}/{k}"]
                d = np.abs(opt[f"{mv}/{k}"].numpy() - want)
                assert (d[~moved_any[k]] <= 1e-5 * max(np.abs(want).max(),
                                                        1e-30)).all(), \
                    (i, mv, k)
    assert ties <= TIE_SHARE * total, (ties, total)
    assert past <= PAST_SHARE * n_params, (past, n_params)
