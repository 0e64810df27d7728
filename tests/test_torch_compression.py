"""The port's int8 error-feedback gradient compression against the JAX
package, on the CPU.

``repro_torch.train.compression``: ``_quantize`` and
``compress_decompress`` bit for bit with the reference's on the same f32
arrays (half-to-even steps, the scale's floor, tiny and large scales, a
20-step error-feedback loop); the pods' sum (``_gathered_sum``) against
the reference's ``jnp.tensordot`` on the same gathered payloads at
P = 1, 2, 3 and 8; ``compressed_allreduce`` over a world-size-1 gloo
``("pod",)`` mesh (in-memory ``HashStore``, destroyed by the
``gloo_group`` fixture) and over two spawned gloo ranks, the only
subprocesses here (a ``FileStore`` under ``tmp_path``, one torch thread a
rank, no JAX in the ranks); the ``err`` leaf through ``init_train_state``,
``make_train_step`` (placed and not), ``train_state_from_reference`` and
checkpoints read by either package.  One torch thread, SMOKE shapes.
"""

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
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train.state import init_train_state as jinit_train_state  # noqa: E402
from repro.train.state import train_state_specs as jtrain_state_specs  # noqa: E402

import repro_torch.train as train_pkg  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.checkpoint.store import _flatten_with_paths  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import train_state_from_reference  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.layers import tree_items, tree_map  # noqa: E402
from repro_torch.sharding import activate  # noqa: E402
from repro_torch.sharding.partition import (  # noqa: E402
    distribute_tree, local_tree,
)
from repro_torch.train import (  # noqa: E402
    AdamWConfig, CompressionState, compress_decompress, compressed_allreduce,
    compressed_allreduce_tree, init_compression, init_train_state,
    make_train_step, train_state_shardings, train_state_specs,
)
from repro_torch.train import compression as comp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EPS = float(np.finfo(np.float32).eps)


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


def _pod_mesh():
    """A world-size-1 ``("pod",)`` CPU mesh over gloo on an in-memory
    store (no TCP rendezvous)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    return init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _case(name, n=257, seed=0):
    """(x, err) f32 arrays of one quantizer case."""
    rng = np.random.default_rng(seed)
    err = np.zeros(n, np.float32)
    if name == "normal":
        x = rng.normal(size=n)
        err = 0.01 * rng.normal(size=n)
    elif name == "zeros":                    # the scale's 1e-30 floor
        x = np.zeros(n)
    elif name == "single":
        x = np.zeros(n)
        x[n // 3] = -2.75
    elif name == "half_steps":
        # amax 127: the scale is 1 and y / scale lands on k + 0.5 exactly
        k = rng.integers(-126, 126, size=n)
        x = k + 0.5 * np.sign(rng.normal(size=n))
        x[0] = 127.0
    elif name == "tiny":
        x = 1e-6 * rng.normal(size=n)
        err = 1e-8 * rng.normal(size=n)
    elif name == "large":
        x = 1e3 * rng.normal(size=n)
        err = 10.0 * rng.normal(size=n)
    return x.astype(np.float32), err.astype(np.float32)


CASES = ("normal", "zeros", "single", "half_steps", "tiny", "large")


# --- the quantizer, bit for bit ---------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_quantize_and_round_trip_bit_for_bit(name):
    x, err = _case(name)
    y = x + err
    q, s = comp._quantize(_t(y))
    jq, js = jcomp._quantize(jnp.asarray(y))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    deq, new_err = compress_decompress(_t(x), _t(err))
    jdeq, jerr = jcomp.compress_decompress(jnp.asarray(x), jnp.asarray(err))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))
    if name == "half_steps":    # round half to even, as jnp.round
        np.testing.assert_array_equal(q.numpy(), np.round(y).astype(np.int8))
        assert set(np.abs(q.numpy()[1:]) % 2) == {0}


def test_error_feedback_loop_matches_the_reference_every_step():
    """``tests/test_train.py``'s loop: 20 round trips of one tensor keep the
    sum of what was sent within 2 quantization steps of 20 x; each step's
    deq and residual equal the reference's."""
    x = np.random.default_rng(0).normal(size=(256,)).astype(np.float32)
    err, jerr = torch.zeros(256), jnp.zeros(256, jnp.float32)
    sent = torch.zeros(256)
    for step in range(20):
        deq, err = compress_decompress(_t(x), err)
        jdeq, jerr = jcomp.compress_decompress(jnp.asarray(x), jerr)
        np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq),
                                      err_msg=str(step))
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr),
                                      err_msg=str(step))
        sent = sent + deq
    drift = float((sent - 20 * _t(x)).abs().max())
    assert drift <= 2 * float(np.abs(x).max()) / 127.0


def test_init_compression_is_zero_f32_like_the_grads():
    grads = {"a": {"w": torch.ones(3, 2, dtype=torch.bfloat16)},
             "b": torch.ones(4)}
    st = init_compression(grads)
    assert isinstance(st, CompressionState)
    want = jcomp.init_compression({"a": {"w": jnp.ones((3, 2), jnp.bfloat16)},
                                   "b": jnp.ones(4)})
    for (path, e), (_, w) in zip(tree_items(st.err), tree_items(want.err)):
        assert e.dtype == torch.float32 and tuple(e.shape) == w.shape, path
        assert not e.any(), path


# --- the pods' sum, with no ranks --------------------------------------------


def _payloads(P, n=515, seed=0):
    """P pods' (q, scale) of rows of magnitudes 1e-3 to 1e2."""
    rng = np.random.default_rng(seed)
    ys = [(10.0 ** rng.uniform(-3, 2)) * rng.normal(size=n)
          for _ in range(P)]
    pairs = [comp._quantize(_t(y)) for y in ys]
    return (torch.stack([q for q, _ in pairs]),
            torch.stack([s for _, s in pairs]))


@pytest.mark.parametrize("P", [1, 2, 3, 8])
def test_gathered_sum_against_the_references_tensordot(P):
    """The port's sum of ``scale_p * q_p`` over P pods against the
    reference's ``jnp.tensordot`` on the same stacks: within
    ``P * eps * sum_p |scale_p * q_p|`` elementwise, and bit for bit at
    P = 1, where the sum is one product."""
    qs, ss = _payloads(P)
    got = comp._gathered_sum(ss, qs).numpy()
    want = np.asarray(jnp.tensordot(
        jnp.asarray(ss.numpy()),
        jnp.asarray(qs.numpy()).astype(jnp.float32).reshape(P, -1), axes=1))
    mag = np.abs(ss.numpy()[:, None] * qs.numpy().astype(np.float32)).sum(0)
    assert (np.abs(got - want) <= P * EPS * mag).all()
    if P == 1:
        np.testing.assert_array_equal(got, want)


# --- compressed_allreduce on a world-size-1 pod mesh --------------------------


@pytest.mark.parametrize("name", ["normal", "half_steps", "zeros"])
def test_allreduce_on_one_pod_is_the_round_trip(gloo_group, name):
    """Over a one-rank ``("pod",)`` mesh the mean is
    ``compress_decompress``'s deq and the residual its residual, bit for
    bit; a ``ProcessGroup`` passed directly gives the same."""
    x, err = _case(name)
    mesh = _pod_mesh()
    with activate(mesh):
        mean, new_err = compressed_allreduce(_t(x), _t(err), "pod")
    deq, want_err = compress_decompress(_t(x), _t(err))
    assert torch.equal(mean, deq) and torch.equal(new_err, want_err)
    mean2, err2 = compressed_allreduce(_t(x), _t(err), mesh.get_group("pod"))
    assert torch.equal(mean2, deq) and torch.equal(err2, want_err)


def test_allreduce_names_the_axis_it_cannot_resolve(gloo_group):
    x = torch.ones(4)
    with pytest.raises(ValueError, match="'pod'.*no mesh is active|no mesh "
                                         "is active.*'pod'"):
        compressed_allreduce(x, torch.zeros(4), "pod")
    mesh = _pod_mesh()
    with activate(mesh):
        with pytest.raises(ValueError, match="no axis 'data'"):
            compressed_allreduce(x, torch.zeros(4), "data")
        with pytest.raises(ValueError, match="no axis 'data'"):
            compressed_allreduce_tree({"w": x}, init_compression({"w": x}),
                                      "data")


def test_allreduce_tree_is_leaf_by_leaf(gloo_group):
    """The tree form equals the single-tensor form on every leaf, keeps
    the tree's structure, and refuses a residual tree of other leaves."""
    rng = np.random.default_rng(3)
    grads = {"w": _t(rng.normal(size=(5, 3))),
             "blk": {"b": _t(rng.normal(size=(3,))),
                     "a": _t(rng.normal(size=(2, 2, 2)))}}
    st = CompressionState(tree_map(lambda g: 0.01 * torch.ones_like(g),
                                   grads))
    with activate(_pod_mesh()):
        mean, new = compressed_allreduce_tree(grads, st, "pod")
        for path, g in tree_items(grads):
            e = dict(tree_items(st.err))[path]
            m1, e1 = compressed_allreduce(g, e, "pod")
            assert torch.equal(dict(tree_items(mean))[path], m1), path
            assert torch.equal(dict(tree_items(new.err))[path], e1), path
        assert list(mean) == ["w", "blk"] and list(mean["blk"]) == ["b", "a"]
        with pytest.raises(ValueError, match="residual tree"):
            compressed_allreduce_tree(
                grads, CompressionState({"w": st.err["w"]}), "pod")


def test_placed_leaves_stay_placed(gloo_group):
    """On a one-device mesh, ``init_compression`` of DTensor leaves gives
    DTensor zeros with their placements, and the reduction of placed
    leaves returns them placed as they came, with the plain values."""
    mesh = mesh_lib.make_host_mesh(device="cpu")
    m = build(get_smoke("yi-9b"), device="cpu")
    _, sh = train_state_shardings(m, mesh)
    grads = m.init_master(torch.Generator().manual_seed(1))["embed"]
    placed = distribute_tree(grads, sh.params["embed"])
    st = init_compression(placed)
    assert isinstance(st.err["table"], DTensor)
    assert st.err["table"].placements == placed["table"].placements
    with activate(mesh):
        mean, new = compressed_allreduce_tree(placed, st, "data")
    want_mean, want_err = compress_decompress(
        grads["table"], torch.zeros_like(grads["table"]))
    for t, want in ((mean["table"], want_mean), (new.err["table"], want_err)):
        assert isinstance(t, DTensor)
        assert t.placements == placed["table"].placements
        assert torch.equal(t.to_local(), want)


# --- two spawned gloo ranks -----------------------------------------------------

RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    from repro_torch.sharding import activate
    from repro_torch.train import compressed_allreduce

    rank, out = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group(
        "gloo", store=dist.FileStore(out + "/store", 2), rank=rank,
        world_size=2)
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
        x = torch.from_numpy(np.load(out + "/x.npy")[rank])
        with activate(mesh):
            mean, err = compressed_allreduce(x, torch.zeros_like(x), "pod")
        np.save(f"{out}/mean{rank}.npy", mean.numpy())
        np.save(f"{out}/err{rank}.npy", err.numpy())
        assert "jax" not in sys.modules and "repro" not in sys.modules
    finally:
        dist.destroy_process_group()
""")


def test_two_spawned_ranks_agree_with_the_references_arithmetic(tmp_path):
    """``test_distributed.py::test_compressed_allreduce_exactness``'s
    inputs cut to 2 ranks: each gloo rank reduces its row; both means are
    the same bits, within the sum's ulp bound of the reference's
    ``tensordot`` on the same payloads and within ``max|x| / 127`` of the
    exact mean; each residual is the reference's, bit for bit."""
    x = np.arange(2 * 32, dtype=np.float32).reshape(2, 32) / np.float32(17)
    np.save(tmp_path / "x.npy", x)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    means = [np.load(tmp_path / f"mean{r}.npy") for r in range(2)]
    errs = [np.load(tmp_path / f"err{r}.npy") for r in range(2)]
    assert means[0].tobytes() == means[1].tobytes()

    pairs = [jcomp._quantize(jnp.asarray(row)) for row in x]
    qs = jnp.stack([q for q, _ in pairs])
    ss = jnp.stack([s for _, s in pairs])
    want = np.asarray(jnp.tensordot(ss, qs.astype(jnp.float32), axes=1)) / 2
    mag = np.abs(np.asarray(ss)[:, None]
                 * np.asarray(qs).astype(np.float32)).sum(0) / 2
    assert (np.abs(means[0] - want) <= 2 * EPS * mag).all()
    assert np.abs(means[0] - x.mean(0)).max() <= np.abs(x).max() / 127.0
    for r in range(2):
        _, jerr = jcomp.compress_decompress(jnp.asarray(x[r]),
                                            jnp.zeros(32, jnp.float32))
        np.testing.assert_array_equal(errs[r], np.asarray(jerr))


# --- the err leaf through the train state ------------------------------------


@pytest.mark.parametrize("arch", ["yi-9b", "zamba2-1.2b"])
def test_init_train_state_with_compression_matches_the_reference(arch):
    """``err`` is zero f32 like every parameter, the reference's tree path
    for path, and the rest of the state is the state without it."""
    m = build(get_smoke(arch), device="cpu")
    params = m.init_master(torch.Generator().manual_seed(0))
    st = init_train_state(params, compression=True)
    jm = jbuild(jget_smoke(arch))
    js = jinit_train_state(jm.init(jax.random.PRNGKey(0)), compression=True)
    got, want = list(tree_items(st.err)), _jleaves(js.err)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, e), (_, w), (_, p) in zip(got, want, tree_items(params)):
        assert e.dtype == torch.float32 and str(w.dtype) == "float32", path
        assert tuple(e.shape) == w.shape == tuple(p.shape), path
        assert not e.any() and not np.asarray(w).any(), path
    plain = init_train_state(params)
    assert plain.err is None and st.params is params
    assert [k for k, _ in _flatten_with_paths(st._replace(err=None))] == \
        [k for k, _ in _flatten_with_paths(plain)]


def _jleaves(tree):
    """(path, leaf) of a reference dict tree in ``tree_items``' order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(k.key for k in path), leaf) for path, leaf in flat]


def _random_err(params, seed):
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda p: torch.randn(p.shape, generator=gen), params)


@pytest.mark.parametrize("placed", [False, True], ids=["plain", "placed"])
def test_err_passes_through_train_steps_unchanged(gloo_group, placed):
    """``make_train_step`` hands ``err`` through, as the reference's step
    does: after 2 steps it is the same bits (placed on the host mesh as it
    came, when placed), while the parameters moved."""
    cfg = get_smoke("h2o-danube-1.8b")
    m = build(cfg, device="cpu")
    params = m.init_master(torch.Generator().manual_seed(0))
    st = init_train_state(params, compression=True)
    st = st._replace(err=_random_err(params, 1))
    want = {p: t.clone() for p, t in tree_items(st.err)}
    if placed:
        _, sh = train_state_shardings(m, mesh_lib.make_host_mesh(
            device="cpu"), compression=True)
        st = distribute_tree(st, sh)
    step = make_train_step(m, AdamWConfig(peak_lr=1e-3, warmup_steps=0,
                                          decay_steps=10))
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9))
    batch = {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
             "targets": torch.from_numpy(tok[:, 1:].astype(np.int32))}
    new = st
    for _ in range(2):
        new, _ = step(new, batch)
    assert int(local_tree(new.step)) == 2
    for path, e in tree_items(new.err):
        assert isinstance(e, DTensor) == placed, path
        if placed:
            assert e.placements == dict(tree_items(sh.err))[path].placements
        assert torch.equal(local_tree(e), want[path]), path
    assert not torch.equal(local_tree(new.params["final_norm"]["w"]),
                           params["final_norm"]["w"])


def test_train_state_from_reference_refuses_a_wrong_err_leaf():
    cfg = get_smoke("yi-9b")
    jm = jbuild(jget_smoke("yi-9b"))
    js = jax.tree.map(np.asarray, jinit_train_state(
        jm.init(jax.random.PRNGKey(0)), compression=True))
    err = dict(js.err)
    err["final_norm"] = {"w": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="final_norm/w: shape"):
        train_state_from_reference(cfg, js._replace(err=err))
    err.pop("final_norm")
    with pytest.raises(ValueError, match="parameter trees differ"):
        train_state_from_reference(cfg, js._replace(err=err))


# --- checkpoints across the packages -----------------------------------------


def _yi_states():
    """SMOKE yi-9b's compression state in the port (random residuals, step
    3) and the reference's own (its init, residuals scaled params)."""
    m = build(get_smoke("yi-9b"), device="cpu")
    params = m.init_master(torch.Generator().manual_seed(0))
    st = init_train_state(params, compression=True)._replace(
        step=torch.tensor(3, dtype=torch.int32), err=_random_err(params, 5))
    jm = jbuild(jget_smoke("yi-9b"))
    js = jinit_train_state(jm.init(jax.random.PRNGKey(0)), compression=True)
    js = js._replace(err=jax.tree.map(lambda p: p * 0.25, js.params))
    return m, st, jm, js


def _bits(leaves):
    return {k: np.asarray(local_tree(v) if torch.is_tensor(v) else v)
            for k, v in leaves}


def test_the_ports_compression_checkpoint_restores_in_both_packages(
        tmp_path, gloo_group):
    """The port's save restores in the port into the ``meta`` template of
    ``train_state_specs(compression=True)`` placed on the host mesh, and
    in the reference into its own compression state: every leaf, ``err``
    included, bit for bit."""
    m, st, jm, js = _yi_states()
    save(st, str(tmp_path), 3)
    want = _bits(_flatten_with_paths(st))
    assert any(k.startswith(".err/") for k in want)
    template = train_state_specs(m, compression=True)[0]
    _, sh = train_state_shardings(m, mesh_lib.make_host_mesh(device="cpu"),
                                  compression=True)
    got = restore(str(tmp_path), template, shardings=sh)
    assert _bits(_flatten_with_paths(got)).keys() == want.keys()
    for k, v in _bits(_flatten_with_paths(got)).items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    jgot = jckpt.restore(str(tmp_path), js)
    for k, v in jckpt.store._flatten_with_paths(jgot):
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)


def test_the_references_compression_checkpoint_restores_in_the_port(
        tmp_path):
    m, st, jm, js = _yi_states()
    jckpt.save(js, str(tmp_path), 7)
    got = restore(str(tmp_path), st)
    want = dict(jckpt.store._flatten_with_paths(js))
    leaves = _flatten_with_paths(got)
    assert [k for k, _ in leaves] == list(want)
    assert got.err is not None and int(got.step) == 0
    for k, v in leaves:
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), k
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_specs_and_init_agree_on_errs_dtype(param_dtype):
    """``train_state_specs`` gives ``err`` the parameters' specs and
    ``init_train_state`` makes it f32.  The two agree, in both packages:
    the parameter specs are f32 whatever ``param_dtype`` says (neither
    package's model reads it), so the specs' template takes the init's
    checkpoint.  A state of parameters cast to bf16 has f32 residuals in
    both packages."""
    cfg = get_smoke("yi-9b").replace(param_dtype=param_dtype)
    m = build(cfg, device="cpu")
    jm = jbuild(jget_smoke("yi-9b").replace(param_dtype=param_dtype))
    spec = [str(t.dtype) for _, t in tree_items(
        train_state_specs(m, compression=True)[0].err)]
    jspec = [str(t.dtype) for _, t in _jleaves(
        jtrain_state_specs(jm, compression=True)[0].err)]
    assert set(spec) == {"torch.float32"} and set(jspec) == {"float32"}
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      m.init_master(torch.Generator().manual_seed(0)))
    jst = jinit_train_state(jax.tree.map(
        lambda p: p.astype(jnp.bfloat16), jm.init(jax.random.PRNGKey(0))),
        compression=True)
    st = init_train_state(params, compression=True)
    assert {str(t.dtype) for _, t in tree_items(st.err)} == {"torch.float32"}
    assert {str(t.dtype) for _, t in _jleaves(jst.err)} == {"float32"}


def test_the_package_exports_the_references_names():
    for name in ("CompressionState", "compress_decompress",
                 "compressed_allreduce", "init_compression"):
        assert getattr(train_pkg, name) is getattr(comp, name)
        assert hasattr(jcomp, name)
    assert train_pkg.compressed_allreduce_tree is comp.compressed_allreduce_tree
