"""The port's sharding layer against the JAX package.

``repro_torch.sharding`` (the rule tables, ``logical_to_spec``, the
shardings of trees, ``activate`` / ``constrain``, the detection helpers),
``repro_torch.launch.mesh``'s builders, ``Model.abstract_params`` /
``param_axes`` / ``cache_spec``, ``train_state_shardings`` and the batch
shardings, each held spec for spec and tree path for tree path to the
reference's on the same shape-only meshes: the production (16, 16) and
(2, 16, 16), a (4, 2) host mesh and (1, 1).  The JAX side uses
``jax.sharding.AbstractMesh``, as ``tests/test_sharding.py`` does; the
port's side its own ``AbstractMesh``.  Models are taken at full size, as
``meta`` tensors and ``ShapeDtypeStruct``s: nothing is allocated.

The tests that place tensors build a real world-size-1 ``DeviceMesh`` on
the CPU: the process group is gloo on an in-memory ``HashStore`` (no TCP
rendezvous, no ``MASTER_*`` variable), made by the mesh builder and
destroyed by the ``gloo_group`` fixture, which checks that none is left.
Everything runs on one torch thread in this process: no subprocess, no
spawned rank.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

import repro.sharding as jsharding  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro.train.state import train_state_shardings as jtrain_shardings  # noqa: E402

import repro_torch.sharding as sharding  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCHS, SHAPES, ShapeSpec, get, get_smoke, shapes_for,
)
from repro_torch.core import HoughConfig, PipelineConfig  # noqa: E402
from repro_torch.core.plan import DetectionPlan  # noqa: E402
from repro_torch.data import scenario_batch  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.models.layers import tree_items  # noqa: E402
from repro_torch.sharding import partition as part  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig, distribute_tree, init_train_state, make_train_step,
    train_state_shardings, train_state_specs,
)


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
    """No process group before the test; the one the mesh builders make is
    destroyed after it, and none is left."""
    assert not dist.is_initialized()
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()


def _jmesh(shape, names):
    # shape-only stand-in mesh, as tests/test_sharding.py builds it
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(shape, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, shape)))


MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
RULES = ("DEFAULT_RULES", "SP_RULES", "DECODE_RULES", "DETECTION_RULES")


def _meshes(name):
    shape, names = MESHES[name]
    return part.AbstractMesh(shape, names), _jmesh(shape, names)


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jleaves(tree, is_leaf) -> dict:
    """path -> leaf of a JAX tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(_key(k) for k in path): leaf for path, leaf in flat}


def _leaves(tree, is_leaf, prefix=()) -> dict:
    """path -> leaf of a port tree (dicts, NamedTuples, ``None`` empty)."""
    if tree is None:
        return {}
    if is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_leaves(v, is_leaf, prefix + (str(k),)))
    return out


def _specs(port_tree, ref_tree):
    """(port, reference) path -> spec entries of two sharding trees."""
    got = {p: tuple(s.spec) for p, s in _leaves(
        port_tree, lambda x: isinstance(x, part.NamedSharding)).items()}
    want = {p: tuple(s.spec) for p, s in _jleaves(
        ref_tree, lambda x: isinstance(x, JNamedSharding)).items()}
    assert got and want
    return got, want


def _ref_shardings(axes, shapes, jmesh, rules):
    return jpart.shardings_for_tree(axes, shapes, jmesh, rules)


# --- the rule tables: every case of tests/test_sharding.py -----------------

RULE_CASES = [
    # (axes, shape, mesh, rules, spec)
    (("embed", "mlp"), (4096, 11008), "16x16", "DEFAULT_RULES",
     ("data", "model")),
    (("vocab", "embed"), (51866, 1280), "16x16", "DEFAULT_RULES",
     (None, "data")),
    (("vocab", "embed"), (202048, 5120), "16x16", "DEFAULT_RULES",
     ("model", "data")),
    (("embed", "kv_heads", "head_dim"), (6144, 1, 128), "16x16",
     "DEFAULT_RULES", ("data", None, "model")),
    (("embed", "heads", "head_dim"), (5120, 40, 128), "16x16",
     "DEFAULT_RULES", ("data", None, "model")),
    (("embed", "heads", "head_dim"), (4096, 32, 128), "16x16",
     "DEFAULT_RULES", ("data", "model")),
    (("batch", "seq"), (256, 4096), "2x16x16", "DEFAULT_RULES",
     (("pod", "data"),)),
    (("batch", "seq"), (1, 524288), "2x16x16", "DECODE_RULES", ()),
    (("batch", "kv_heads", "cache_seq", "head_dim"), (128, 8, 32768, 80),
     "16x16", "DECODE_RULES", ("data", None, "model")),
    (("batch", "kv_heads", "cache_seq", "head_dim"), (1, 32, 524288, 64),
     "16x16", "DECODE_RULES", (None, "model")),
    (("experts", "embed", "mlp"), (64, 2048, 1408), "16x16",
     "DEFAULT_RULES", ("model", "data")),
    (("embed", "embed"), (1280, 4096), "16x16", "DEFAULT_RULES",
     ("data",)),
    (("batch", "seq", "embed_act"), (32, 32768, 4096), "16x16", "SP_RULES",
     ("data", "model")),
    (("batch", "frames", None), (32, 1500, 1280), "16x16", "SP_RULES",
     ("data",)),
]


@pytest.mark.parametrize("case", RULE_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[3]}" for c in RULE_CASES])
def test_logical_to_spec_matches_the_reference_cases(case):
    """Each case of ``tests/test_sharding.py`` (the adversarial archs'
    fallbacks: whisper's vocab, granite's kv = 1, qwen's 40 heads, batch 1,
    split-KV, no mesh axis used twice, SP) gives the reference's spec on
    the port's mesh."""
    axes, shape, mesh, rules, spec = case
    pm, jm = _meshes(mesh)
    got = part.logical_to_spec(axes, shape, pm, getattr(part, rules))
    want = jpart.logical_to_spec(axes, shape, jm, getattr(jpart, rules))
    assert got == spec == tuple(want) and want == JP(*spec)
    used = [a for e in got if e is not None
            for a in ((e,) if isinstance(e, str) else e)]
    assert len(set(used)) == len(used)


def test_rule_tables_are_the_reference_data():
    for name in RULES:
        got, want = getattr(part, name), getattr(jpart, name)
        assert dict(got) == dict(want), name


def test_unit_mesh_shards_every_dimension_as_the_reference_does():
    """On (1, 1) every size divides, so the spec names mesh axes (it is not
    all-replicated), as the reference's."""
    pm, jm = _meshes("1x1")
    got = part.logical_to_spec(("embed", "mlp"), (4096, 11008), pm)
    assert got == ("data", "model") == tuple(
        jpart.logical_to_spec(("embed", "mlp"), (4096, 11008), jm))


def test_rules_for_shape():
    for kind, rules in (("train_4k", "DEFAULT_RULES"),
                        ("prefill_32k", "SP_RULES"),
                        ("decode_32k", "DECODE_RULES"),
                        ("long_500k", "DECODE_RULES")):
        assert part.rules_for_shape(kind) is getattr(part, rules)
        assert jpart.rules_for_shape(kind) is getattr(jpart, rules)


def test_exports_are_the_references_but_shard_map():
    """The package exports the reference's names, ``shard_map`` included
    (the test's name dates from before the port had it)."""
    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")} - {"partition"}

    assert names(sharding) == names(jsharding)
    assert "shard_map" in names(sharding)


# --- placements --------------------------------------------------------------

def test_placements_one_per_mesh_dim():
    pm, _ = _meshes("2x16x16")
    ns = part.named_sharding(("batch", "seq", "embed"), (256, 4096, 4096),
                             pm)
    assert ns.spec == (("pod", "data"),)
    assert ns.placements == (Shard(0), Shard(0), Replicate())
    ns = part.named_sharding(("embed", "heads", "head_dim"),
                             (5120, 40, 128), pm)
    assert ns.placements == (Replicate(), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="mesh's order"):
        part.NamedSharding(pm, part.PartitionSpec(("data", "pod"))).placements


def test_composite_entry_splits_pod_major_as_the_reference():
    """A dim over ("pod", "data"): DTensor's shard of each device (its
    global offset under the placements) is the reference's tile (XLA's
    tile assignment of the same spec), on a (2, 2, 2) mesh."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset,
    )

    shape, names = (2, 2, 2), ("pod", "data", "model")
    spec = (("pod", "data"), "model")
    pm = part.AbstractMesh(shape, names)
    placements = part.NamedSharding(pm, part.PartitionSpec(*spec)).placements
    hlo = JNamedSharding(_jmesh(shape, names), JP(*spec)) \
        ._to_xla_hlo_sharding(2)
    tiles = list(hlo.tile_assignment_devices())
    assert list(hlo.tile_assignment_dimensions()) == [4, 2]
    glob = (8, 4)
    for dev in range(8):
        coord = [int(c) for c in np.unravel_index(dev, shape)]
        local, offset = _compute_local_shape_and_global_offset(
            glob, shape, coord, placements)
        assert tuple(local) == (2, 2)
        row, col = divmod(tiles.index(dev), 2)
        assert tuple(offset) == (row * 2, col * 2), (coord, offset)


# --- whole models: parameters, train state, caches, batches ----------------

def _both(arch):
    return build(get(arch), device="cpu"), jbuild(jget(arch))


def _is_axes(x):
    return part._is_axes_leaf(x)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_the_reference(arch, rules):
    """Every parameter leaf of the full-size model, by tree path: the
    logical axes and ``meta`` shapes and dtypes equal the reference's, and
    so does its spec under ``rules`` on each mesh."""
    m, jm = _both(arch)
    axes, jaxes = m.param_axes(), jm.param_axes()
    assert _leaves(axes, _is_axes) == _jleaves(jaxes, _is_axes)
    ab = _leaves(m.abstract_params(), torch.is_tensor)
    jab = _jleaves(jm.abstract_params(), None)
    assert ab.keys() == jab.keys()
    for p, t in ab.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == jab[p].shape, p
        assert str(t.dtype).removeprefix("torch.") == jab[p].dtype.name, p
    for mesh in MESHES:
        pm, jmesh = _meshes(mesh)
        got, want = _specs(
            part.shardings_for_tree(axes, m.abstract_params(), pm,
                                    getattr(part, rules)),
            _ref_shardings(jaxes, jm.abstract_params(), jmesh,
                           getattr(jpart, rules)))
        assert got == want, (mesh, {p: (got[p], want[p]) for p in got
                                    if got[p] != want[p]})


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_shardings_match_the_reference(arch):
    """The TrainState's specs by tree path, with and without the
    compression residuals (``err``, the parameters' specs), equal the
    reference's on each mesh under DEFAULT_RULES and SP_RULES."""
    m, jm = _both(arch)
    for compression in (False, True):
        for mesh in MESHES:
            pm, jmesh = _meshes(mesh)
            for rules in ("DEFAULT_RULES", "SP_RULES"):
                abs_state, got = train_state_shardings(
                    m, pm, getattr(part, rules), compression=compression)
                _, want = jtrain_shardings(jm, jmesh, getattr(jpart, rules),
                                           compression=compression)
                got, want = _specs(got, want)
                assert got == want, (mesh, rules, compression)
                assert got[("step",)] == ()
                assert any(p[0] == "err" for p in got) == compression
        assert abs_state.step.dtype == torch.int32
    assert train_state_specs(m)[0].err is None
    abs_state, axes = train_state_specs(m, compression=True)
    assert abs_state.err is abs_state.params and axes.err is axes.params


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_and_decode_shardings_match_the_reference(arch):
    """``Model.cache_spec`` at every decode shape assigned to the arch (and
    at a ring cache where the arch has a window): the ``meta`` shapes and
    dtypes, the axes, and the DECODE_RULES specs on each mesh, by tree
    path, equal the reference's."""
    m, jm = _both(arch)
    cfg = get(arch)
    cells = [(SHAPES[s].global_batch, SHAPES[s].seq_len, False)
             for s in shapes_for(cfg) if SHAPES[s].kind == "decode"]
    cells += [(4, 1152, True)] if cfg.window else []
    for batch, max_len, ring in cells:
        spec, axes = m.cache_spec(batch, max_len, ring=ring)
        jspec, jaxes = jm.cache_spec(batch, max_len, ring=ring)
        assert _leaves(axes, _is_axes) == _jleaves(jaxes, _is_axes)
        got_ab = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                  for p, t in _leaves(spec, torch.is_tensor).items()}
        want_ab = {p: (s.shape, s.dtype.name)
                   for p, s in _jleaves(jspec, None).items()}
        assert got_ab == want_ab
        for mesh in MESHES:
            pm, jmesh = _meshes(mesh)
            got, want = _specs(
                part.shardings_for_tree(axes, spec, pm, part.DECODE_RULES),
                _ref_shardings(jaxes, jspec, jmesh, jpart.DECODE_RULES))
            assert got == want, (batch, max_len, mesh)


def test_decode_cache_fallbacks_granite_and_whisper():
    """granite-34b's kv = 1 cache takes the sequence on ``model``
    (split-KV); whisper-large-v3's 20 kv heads do not divide 16, so its
    self-attention timeline takes ``model`` too and its cross cache (1500
    frames, no rule) keeps head_dim on it."""
    pm, _ = _meshes("16x16")
    for arch, want in (("granite-34b", ("data", None, "model")),
                       ("whisper-large-v3", ("data", None, "model"))):
        m = build(get(arch), device="cpu")
        spec, axes = m.cache_spec(128, 32768)
        sh = part.shardings_for_tree(axes, spec, pm, part.DECODE_RULES)
        k = next(s for p, s in _leaves(
            sh, lambda x: isinstance(x, part.NamedSharding)).items()
            if p[-1] == "k")
        assert k.spec == (None,) + want, arch
    m = build(get("whisper-large-v3"), device="cpu")
    spec, axes = m.cache_spec(128, 32768)
    sh = part.shardings_for_tree(axes, spec, pm, part.DECODE_RULES)
    ck = sh["blocks"]["1_cross"]["ck"]
    assert ck.spec == (None, "data", None, None, "model")


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_match_the_reference(arch):
    """``shardings_for_tree(batch_axes, input_specs)`` under each assigned
    shape's rule table (``rules_for_shape``), on each mesh."""
    cfg, jcfg = get(arch), jget(arch)
    for name in shapes_for(cfg):
        shape = SHAPES[name]
        axes = zoo.batch_axes(cfg, shape.kind)
        jaxes = jzoo.batch_axes(jcfg, shape.kind)
        assert axes == jaxes
        for mesh in MESHES:
            pm, jmesh = _meshes(mesh)
            got, want = _specs(
                part.shardings_for_tree(axes, zoo.input_specs(cfg, shape),
                                        pm, part.rules_for_shape(name)),
                _ref_shardings(jaxes, jzoo.input_specs(jcfg, JSHAPES[name]),
                               jmesh, jpart.rules_for_shape(name)))
            assert got == want, (name, mesh)


def test_init_cache_allocates_what_cache_spec_describes():
    for arch in ("zamba2-1.2b", "falcon-mamba-7b", "llama-3.2-vision-11b"):
        m = build(get_smoke(arch), device="cpu")
        spec, _ = m.cache_spec(2, 16)
        cache = m.init_cache(2, 16)
        want = {p: (t.shape, t.dtype) for p, t in tree_items(spec)}
        got = {p: (t.shape, t.dtype) for p, t in tree_items(cache)}
        assert got == want
        assert all(t.device.type == "cpu" and not t.any()
                   for _, t in tree_items(cache))


# --- the detection helpers and the mesh builders -----------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_slot_sharding_on_replica_meshes(n):
    pm = part.AbstractMesh((n,), ("replica",))
    jm = _jmesh((n,), ("replica",))
    for slots in (1, 4, 6, 8, 12):
        got = part.slot_sharding(pm, slots)
        assert got.spec == tuple(jpart.slot_sharding(jm, slots).spec)
        assert got.spec == (("replica",) if slots % n == 0 else ())
        assert got.placements == ((Shard(0),) if slots % n == 0
                                  else (Replicate(),))


def test_production_mesh_is_shape_only():
    m = mesh_lib.make_production_mesh()
    assert (m.shape, m.mesh_dim_names) == ((16, 16), ("data", "model"))
    m = mesh_lib.make_production_mesh(multi_pod=True)
    assert (m.shape, m.mesh_dim_names) == ((2, 16, 16),
                                           ("pod", "data", "model"))
    assert m.size() == 512
    with pytest.raises(ValueError, match="shape-only"):
        distribute_tree(torch.zeros(2), part.NamedSharding(
            part.AbstractMesh((1,), ("replica",)), part.PartitionSpec()))
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 7"):
        distribute_tree(torch.zeros(2), part.NamedSharding(
            m, part.PartitionSpec()))


def test_mesh_builders_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the builders run on it")
    for build_mesh in (mesh_lib.make_host_mesh, mesh_lib.make_replica_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh()
    assert not dist.is_initialized()


# --- activate / constrain ----------------------------------------------------

def test_activate_nests_and_resets():
    a = part.AbstractMesh((16, 16), ("data", "model"))
    b = part.AbstractMesh((1, 1), ("data", "model"))
    assert part._ACTIVE.get() is None
    with part.activate(a):
        assert part._ACTIVE.get() == (a, part.DEFAULT_RULES)
        with part.activate(b, part.DECODE_RULES):
            assert part._ACTIVE.get() == (b, part.DECODE_RULES)
        assert part._ACTIVE.get() == (a, part.DEFAULT_RULES)
        with pytest.raises(KeyError):
            with part.activate(b):
                raise KeyError
        assert part._ACTIVE.get() == (a, part.DEFAULT_RULES)
    assert part._ACTIVE.get() is None


def test_constrain_outside_activate_is_a_no_op():
    x = torch.zeros(4, 8)
    assert part.constrain(x, ("batch", "embed_act")) is x
    with part.activate(part.AbstractMesh((1, 1), ("data", "model"))):
        assert part.constrain(x, ("batch", "embed_act")) is x
    with part.activate(part.AbstractMesh((16, 16), ("data", "model"))):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md §1 item 7"):
            part.constrain(torch.zeros(16, 8), ("batch", "embed_act"))


# --- placed paths on a world-size-1 gloo DeviceMesh ---------------------------

def test_mesh_builders_make_one_device_meshes(gloo_group):
    m = mesh_lib.make_host_mesh(device="cpu")
    assert (m.shape, m.mesh_dim_names, m.device_type) == (
        (1, 1), ("data", "model"), "cpu")
    r = mesh_lib.make_replica_mesh(8, device="cpu")
    assert (r.shape, r.mesh_dim_names) == ((1,), ("replica",))
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    with pytest.raises(ValueError, match="at least 8"):
        mesh_lib.make_host_mesh(multi_pod=True, device="cpu")
    # a DTensor takes the spec's placements inside activate; no copy on one
    # device
    x = torch.arange(32.0).reshape(4, 8)
    d = distribute_tree(x, part.named_sharding(("batch", None), x.shape, m))
    assert d.placements == (Shard(0), Replicate())
    assert d.to_local().data_ptr() == x.data_ptr()
    with part.activate(m):
        c = part.constrain(d, (None, "mlp"))
    assert c.placements == (Replicate(), Shard(1))
    assert torch.equal(c.to_local(), x)


def test_a_mesh_of_more_than_one_device_raises(gloo_group):
    """A DTensor on a 2-device mesh (built without its groups: one process
    holds one rank) cannot be run by the port: the step and the model's
    entry points raise, naming the queue."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh_lib.make_replica_mesh(device="cpu")
    two = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("replica",),
                     _init_backend=False)
    d = DTensor.from_local(torch.zeros(2, 3), two, [Shard(0)],
                           run_check=False)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 7"):
        part.local_tree({"x": d})
    cfg = get_smoke("zamba2-1.2b")
    m = build(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 7"):
        zero = torch.zeros(2, dtype=torch.int32)
        m.decode_step({"embed": {"table": d}}, zero, {}, zero)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 7"):
        distribute_tree(torch.zeros(2), part.NamedSharding(
            two, part.PartitionSpec()))


def test_placed_train_step_equals_the_unplaced_step(gloo_group):
    """zamba2-1.2b SMOKE: its TrainState placed by ``train_state_shardings``
    and its batch by the batch shardings on a (1, 1) gloo mesh, with no
    copy; one ``make_train_step`` under ``activate`` equals the unplaced
    step bit for bit (loss, grad norm, step, every parameter and moment)
    and returns a state placed as the old one was."""
    cfg = get_smoke("zamba2-1.2b")
    m = build(cfg, device="cpu")
    state = init_train_state(m.init_master(torch.Generator().manual_seed(0)))
    shape = ShapeSpec("smoke", 16, 2, "train")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, s, np.int32))
             for k, (s, _) in zoo.input_specs(cfg, shape).items()}
    step = make_train_step(m, AdamWConfig(peak_lr=1e-3, warmup_steps=0,
                                          decay_steps=10))
    want, want_met = step(state, batch)

    mesh = mesh_lib.make_host_mesh(device="cpu")
    _, shardings = train_state_shardings(m, mesh)
    placed = distribute_tree(state, shardings)
    placed_batch = distribute_tree(batch, part.shardings_for_tree(
        zoo.batch_axes(cfg, "train"), zoo.input_specs(cfg, shape), mesh))
    for (_, t), (_, d) in zip(tree_items(state.params),
                              tree_items(placed.params)):
        assert isinstance(d, DTensor)
        assert d.to_local().data_ptr() == t.data_ptr()
    with part.activate(mesh, part.DEFAULT_RULES):
        got, got_met = step(placed, placed_batch)

    for k in ("loss", "grad_norm"):
        assert torch.equal(got_met[k], want_met[k]), k
    assert isinstance(got.step, DTensor)
    assert torch.equal(got.step.to_local(), want.step)
    flat = _leaves(got, torch.is_tensor)
    sh = _leaves(shardings, lambda x: isinstance(x, part.NamedSharding))
    assert flat.keys() == _leaves(want, torch.is_tensor).keys() == sh.keys()
    for p, w in _leaves(want, torch.is_tensor).items():
        assert flat[p].placements == sh[p].placements, p
        assert torch.equal(flat[p].to_local(), w), p


def test_placed_decode_equals_the_unplaced_decode(gloo_group):
    """zamba2-1.2b SMOKE, 4 slots: parameters and the cache placed under
    DECODE_RULES through ``param_axes`` and ``Model.cache_spec``; a prefill
    and 4 greedy decode steps give the unplaced run's logits and tokens
    bit for bit, and the placed cache holds the unplaced cache's
    entries."""
    cfg = get_smoke("zamba2-1.2b")
    m = build(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 9), np.int32))
    max_len = 16

    def run(params, cache):
        logits, cache = m.prefill(params, {"tokens": tokens}, cache)
        out = [logits]
        for i in range(4):
            tok = out[-1].argmax(-1).to(torch.int32)
            pos = torch.full((4,), tokens.shape[1] + i, dtype=torch.int32)
            logits, cache = m.decode_step(params, tok, cache, pos)
            out.append(logits)
        return out, cache

    want, want_cache = run(params, m.init_cache(4, max_len))
    mesh = mesh_lib.make_host_mesh(device="cpu")
    rules = part.DECODE_RULES
    spec, axes = m.cache_spec(4, max_len)
    cache = distribute_tree(m.init_cache(4, max_len),
                            part.shardings_for_tree(axes, spec, mesh, rules))
    placed_params = distribute_tree(params, part.shardings_for_tree(
        m.param_axes(), m.abstract_params(), mesh, rules))
    with part.activate(mesh, rules):
        got, got_cache = run(placed_params, cache)
    assert got_cache is cache
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for (p, g), (_, w) in zip(tree_items(got_cache), tree_items(want_cache)):
        assert isinstance(g, DTensor) and torch.equal(g.to_local(), w), p


def test_slot_sharded_detector_batch_equals_the_unplaced_batch(gloo_group):
    """A (4, 60, 80) batch ``shard_slots``-placed on a one-device replica
    mesh (no copy of a CPU batch) runs through ``DetectionPlan.run``,
    staged and fused, to the unplaced batch's result bit for bit."""
    frames, _ = scenario_batch(["straight", "curved", "night", "rain"], 60,
                               80, seed=0)
    mesh = mesh_lib.make_replica_mesh(1, device="cpu")
    t = torch.from_numpy(frames)
    placed = part.shard_slots(t, mesh)
    assert placed.placements == (Shard(0),)
    assert placed.to_local().data_ptr() == t.data_ptr()
    assert torch.equal(part.shard_slots(frames, mesh).to_local(), t)
    auto = HoughConfig(compact=True, max_edges="auto")
    staged = DetectionPlan.build(PipelineConfig(hough=auto), 60, 80, batch=4)
    for plan in (staged, staged.with_fused()):
        want = plan.run(t)
        got = plan.run(placed)
        for name, g, w in zip(want._fields, got, want):
            if w is None:
                assert g is None
            else:
                assert torch.equal(g, w), name
