"""The LM launch path's sharding rules of the port (`sharding.py`'s LM
half, `launch/mesh.py`, `launch/serve.py`'s and `launch/train.py`'s
shardings) against the reference's `PartitionSpec`s, field by field, on
every arch of the registry and the meshes (16, 16), (2, 16, 16), (1, 1),
(2, 2), (1, 4) and (4, 1).

The reference builds its shardings on a JAX mesh; these tests give it an
`AbstractMesh` (no devices), and the port a `launch.mesh.MeshShape`, which
carries the same axis names and sizes. A spec compares as a tuple with one
entry a dim (the reference's padded with None to the leaf's rank).

The port keeps a segment's layers as separate tensors where the reference
stacks them on a leading layer axis: the port's spec of a layer is the
reference's spec of the stacked leaf with that layer entry dropped (after
the client axis of a train state's leaves). The reference's FSDP and
ZeRO-1 rules may put "data" (or ("data", "model")) on that layer axis
where no other dim divides; the port then holds the layer whole over it.
`test_layer_axis_shards_are_the_only_difference` counts those leaves.
"""
import dataclasses
import functools

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from torch.distributed.tensor import Replicate, Shard

from repro import sharding as jsharding
from repro.configs import get_arch as jget_arch, get_shape as jget_shape
from repro.launch import serve as jserve, train as jtrain
from repro_torch import sharding
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.launch import dryrun, mesh as lmesh, serve, train

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "1x1": (("data", "model"), (1, 1)),
          "2x2": (("data", "model"), (2, 2)),
          "1x4": (("data", "model"), (1, 4)),
          "4x1": (("data", "model"), (4, 1))}
STRATEGIES = ("tp", "dp_only", "zero1")
ARCH_IDS = sorted(ARCHS)


def meshes(key):
    names, sizes = MESHES[key]
    return AbstractMesh(sizes, names), lmesh.MeshShape(names, sizes)


@pytest.fixture(autouse=True)
def no_hints():
    yield
    jsharding.set_hints(mesh=None, moe_ep=False, moe_dp=False)
    sharding.set_hints(mesh=None, moe_ep=False, moe_dp=False)


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def ref_specs(shardings, shapes):
    """path -> the reference's spec as a tuple padded to the leaf's rank."""
    flat = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    dims = {"/".join(_key(k) for k in kp): len(l.shape) for kp, l in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    out = {}
    for kp, sh in flat:
        path = "/".join(_key(k) for k in kp)
        spec = tuple(sh.spec)
        out[path] = spec + (None,) * (dims[path] - len(spec))
    return out


def port_specs(tree, specs):
    """[(path in the reference's layout, layers of its list or 0, spec)]."""
    info = []
    sharding.map_params(lambda path, leaf, n: info.append((path, n)), tree)
    pairs = dryrun._spec_leaves(tree, specs)
    assert len(info) == len(pairs)
    return [(p, n, tuple(s)) for (p, n), (_, s) in zip(info, pairs)]


def by_path(tree, specs, at=""):
    """path -> spec of a tree whose structure the reference's shares (a
    cache): dict keys and list and tuple indices, as JAX names them."""
    if isinstance(tree, dict):
        items = [(k, tree[k], specs[k]) for k in tree]
    elif isinstance(tree, (list, tuple)):
        items = [(i, t, sp) for i, (t, sp) in enumerate(zip(tree, specs))]
    else:
        return {at: tuple(specs)}
    out = {}
    for k, t, sp in items:
        out.update(by_path(t, sp, f"{at}/{k}" if at else str(k)))
    return out


def same_specs(tree, specs, want, lead=0, what=""):
    """Every port leaf's spec equals the reference's for its stacked leaf,
    the layer entry (after `lead` client entries) dropped. -> the leaves
    whose dropped entry was not None."""
    dropped = 0
    for path, n, spec in port_specs(tree, specs):
        ref = want[path]
        if n:
            dropped += ref[lead] is not None
            ref = ref[:lead] + ref[lead + 1:]
        assert spec == ref, (what, path, spec, ref)
    return dropped


@functools.lru_cache(maxsize=None)
def jstate(arch, n):
    return jtrain.init_state_shapes(jget_arch(arch), n)


@functools.lru_cache(maxsize=None)
def tstate(arch, n):
    return train.init_state_shapes(get_arch(arch), n)


@functools.lru_cache(maxsize=None)
def jparams(arch):
    return jserve.params_shapes(jget_arch(arch))


@functools.lru_cache(maxsize=None)
def tparams(arch):
    return serve.params_shapes(get_arch(arch))


# ---------------------------------------------------------------------------
# the small rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_axis_rules_match_the_reference(mesh_key):
    jm, tm = meshes(mesh_key)
    assert sharding.dp_axes(tm) == jsharding.dp_axes(jm)
    assert sharding.dp_size(tm) == jsharding.dp_size(jm)
    for name in ("pod", "data", "model", "clients"):
        assert sharding.axis_size(tm, name) == jsharding.axis_size(jm, name)
    for batch in (1, 2, 4, 6, 16, 32, 128, 256, 512):
        assert (sharding.batch_spec(tm, batch, None, None)
                == tuple(jsharding.batch_spec(jm, batch, None, None)))
    assert lmesh.describe(tm) == "x".join(f"{n}:{jm.shape[n]}"
                                          for n in jm.axis_names)


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
def test_maybe_and_head_axis_plan_match_the_reference(tp):
    for dim in (1, 2, 3, 16, 32, 37, 64, 100):
        for axis in ("model", None):
            assert sharding.maybe(axis, dim, tp) == jsharding.maybe(
                axis, dim, tp)
    for heads in (1, 2, 4, 12, 16, 28, 32, 40, 64):
        for hd in (32, 64, 80, 100, 128):
            assert (sharding.head_axis_plan(heads, hd, tp)
                    == jsharding.head_axis_plan(heads, hd, tp))


def test_production_and_host_meshes():
    assert lmesh.make_production_mesh() == lmesh.MeshShape(
        ("data", "model"), (16, 16))
    pod = lmesh.make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model") and pod.size() == 512
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert lmesh.make_host_mesh().sizes == (1, 1)
    assert lmesh.describe(pod) == "pod:2xdata:16xmodel:16"


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_param_spec_matches_the_reference(arch, mesh_key):
    """`param_spec` itself on every reference leaf's path and stacked shape,
    with and without FSDP and the expert-parallel hint."""
    jm, tm = meshes(mesh_key)
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jparams(arch))[0]:
        path = "/".join(_key(k) for k in kp)
        for ep in (False, True):
            jsharding.set_hints(moe_ep=ep)
            sharding.set_hints(moe_ep=ep)
            for fsdp in (False, True):
                assert sharding.param_spec(path, leaf.shape, tm, fsdp=fsdp) \
                    == tuple(jsharding.param_spec(path, leaf.shape, jm,
                                                  fsdp=fsdp)), (path, ep)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_params_shardings_and_tree_param_specs_match_the_reference(
        arch, mesh_key):
    """Serving's `params_shardings` (no FSDP), and `tree_param_specs` with
    FSDP on and off against the reference's `param_spec` at each leaf,
    leaf by leaf."""
    jm, tm = meshes(mesh_key)
    jp, tp = jparams(arch), tparams(arch)
    want = ref_specs(jserve.params_shardings(jp, jget_arch(arch), jm), jp)
    same_specs(tp, serve.params_shardings(tp, get_arch(arch), tm), want)
    for fsdp in (False, True):
        # the reference's `tree_param_specs` computes `param_spec` at each
        # leaf's path; its rebuild of the tree takes dicts only and raises
        # KeyError on an LM's list of segments, so the leaves are read here
        want = {}
        for kp, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            path = "/".join(_key(k) for k in kp)
            want[path] = tuple(jsharding.param_spec(path, leaf.shape, jm,
                                                    fsdp=fsdp))
        same_specs(tp, sharding.tree_param_specs(tp, tm, fsdp=fsdp), want,
                   what=f"fsdp {fsdp}")


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_cache_and_serve_batch_shardings_match_the_reference(arch, mesh_key):
    """`cache_shardings` at both decode shapes and `batch_shardings` at
    every shape."""
    jm, tm = meshes(mesh_key)
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    for name in SHAPES:
        jshape, shape = jget_shape(name), get_shape(name)
        jb = jserve.serve_batch_specs(jcfg, jshape)
        tb = serve.serve_batch_specs(cfg, shape)
        want = ref_specs(jserve.batch_shardings(jb, jm), jb)
        got = serve.batch_shardings(tb, tm)
        assert {k: tuple(v) for k, v in got.items()} == want, name
        if shape.mode != "decode" or dryrun.should_skip(cfg, shape):
            continue
        jc = jserve.cache_shapes(jcfg, jshape)
        tc = serve.cache_shapes(cfg, shape)
        want = ref_specs(jserve.cache_shardings(jc, jcfg, jm, jshape), jc)
        got = by_path(tc, serve.cache_shardings(tc, cfg, tm, shape))
        assert got == want, name


@pytest.mark.parametrize("n_clients", [1, 2])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_state_and_batch_shardings_match_the_reference(mesh_key, arch,
                                                       strategy, n_clients):
    """`state_shardings` (params, Adam's m, v and step, the ProtoState, the
    step) with FSDP on and off, and the train `batch_shardings`."""
    jm, tm = meshes(mesh_key)
    js, ts = jstate(arch, n_clients), tstate(arch, n_clients)
    for fsdp in (False, True):
        jcfg = dataclasses.replace(jget_arch(arch), fsdp=fsdp)
        cfg = dataclasses.replace(get_arch(arch), fsdp=fsdp)
        jsh = jtrain.state_shardings(js, jcfg, jm, n_clients,
                                     strategy=strategy)
        tsh = train.state_shardings(ts, cfg, tm, n_clients,
                                    strategy=strategy)
        for field in ("params", "m", "v"):
            jt = js.params if field == "params" else getattr(js.opt, field)
            tt = ts.params if field == "params" else getattr(ts.opt, field)
            jx = jsh.params if field == "params" else getattr(jsh.opt, field)
            tx = tsh.params if field == "params" else getattr(tsh.opt, field)
            same_specs(tt, tx, ref_specs(jx, jt), lead=1,
                       what=f"{field} fsdp {fsdp}")
        pad = lambda sh, nd: tuple(sh.spec) + (None,) * (nd - len(sh.spec))
        assert tsh.opt.step == pad(jsh.opt.step, 1)
        assert tsh.step == pad(jsh.step, 0)
        assert tuple(tsh.proto) == (pad(jsh.proto.sum, 2),
                                    pad(jsh.proto.count, 1))
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    jb = jtrain.train_batch_specs(jcfg, jget_shape("train_4k"), n_clients)
    tb = train.train_batch_specs(cfg, get_shape("train_4k"), n_clients)
    want = ref_specs(jtrain.batch_shardings(jb, jm, n_clients,
                                            strategy=strategy), jb)
    got = train.batch_shardings(tb, tm, n_clients, strategy=strategy)
    assert {k: tuple(v) for k, v in got.items()} == want


@pytest.mark.parametrize("n_clients", [1, 2])
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_round_sync_shardings_match_the_reference(mesh_key, n_clients):
    """Resolved through each package's own `relay/placement.resolve`: the
    port's DTensor placements are the reference's specs' placements."""
    jm, tm = meshes(mesh_key)
    for j, t in zip(jtrain.round_sync_shardings(jm, n_clients),
                    train.round_sync_shardings(tm, n_clients)):
        assert t == sharding.placements(tuple(j.spec), tm)


def test_layer_axis_shards_are_the_only_difference():
    """Where the reference shards a stacked leaf's layer axis (FSDP's
    "data" at (16, 16) finds no other dim on some leaves, ZeRO-1 the
    layer count of a deep model), the port's layer spec is the rest of the
    reference's: counted here, so a change to that rule shows."""
    jm, tm = meshes("2x2")
    js, ts = jstate("tinyllama-1.1b", 1), tstate("tinyllama-1.1b", 1)
    jcfg = dataclasses.replace(jget_arch("tinyllama-1.1b"), fsdp=True)
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b"), fsdp=True)
    jsh = jtrain.state_shardings(js, jcfg, jm, 1, strategy="tp")
    tsh = train.state_shardings(ts, cfg, tm, 1, strategy="tp")
    n = same_specs(ts.params, tsh.params, ref_specs(jsh.params, js.params),
                   lead=1)
    # the norms' (22, 2048) stacked scales: FSDP shards 2048 over "data"
    assert n == 0
    jsh = jtrain.state_shardings(js, jcfg, AbstractMesh((2, 11), (
        "data", "model")), 1, strategy="zero1")
    tsh = train.state_shardings(ts, cfg, lmesh.MeshShape(("data", "model"),
                                                         (2, 11)), 1,
                                strategy="zero1")
    n = same_specs(ts.opt.m, tsh.opt.m, ref_specs(jsh.opt.m, js.opt.m),
                   lead=1)
    assert n > 0        # 22 layers over the 22 ranks of (data, model)


# ---------------------------------------------------------------------------
# specs to DTensor placements
# ---------------------------------------------------------------------------
def test_placements_of_a_spec():
    tm = lmesh.MeshShape(("pod", "data", "model"), (2, 2, 2))
    R = Replicate()
    assert sharding.placements((None, "model"), tm) == (R, R, Shard(1))
    assert sharding.placements((("pod", "data"), None, "model"), tm) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements(("pod", ("data", "model")), tm) == (
        Shard(0), Shard(1), Shard(1))
    assert sharding.placements((), tm) == (R, R, R)
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sharding.placements((("model", "data"),), tm)
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(("data", "data"), tm)
    with pytest.raises(ValueError, match="names axis"):
        sharding.placements(("clients",), tm)


def test_constrain_is_the_identity_without_a_hinted_mesh_or_a_dtensor():
    import torch
    x = torch.ones(4, 2)
    assert sharding.constrain(x, "data", None) is x
    sharding.set_hints(mesh=lmesh.make_host_mesh())
    assert sharding.constrain(x, ("data", "model"), None) is x
