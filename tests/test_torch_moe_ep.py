"""Expert-parallel MoE ("moe_ep") in the port's sharding rules, against the
reference's, on Granite and DeepSeek-V2-Lite at full width.

Under the hint the reference's `param_spec` puts "model" on dim 0 of an
expert leaf (`..._e`); on its stacked (L, E, d, f) leaf that dim is the
layer axis, which the port's per-layer tensors do not have. The port
reads an expert leaf inside a layer list on its own (E, d, f) shape
instead (`sharding.layer_spec`), so "model" lands on the experts: the
spec is the reference's rule on the per-layer leaf. Every other leaf
keeps the reference's stacked spec with the layer entry dropped, in
`tree_param_specs`, serving's `params_shardings` and `state_shardings`
under every strategy ("dp_only" and "zero1" replicate the parameters,
so their expert leaves keep the stacked reading too). The dry-run then
reckons each rank's expert bytes on the 16 x 16 mesh at 1/16 of the
whole, as under "tp", where the ffn dim splits.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import sharding as jsharding
from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve, train as jtrain
from repro_torch import sharding
from repro_torch.configs import get_arch, get_shape
from repro_torch.launch import dryrun, serve, train
from test_torch_launch_specs import (_key, jparams, jstate, meshes,
                                     port_specs, ref_specs, tparams, tstate)

ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b")
MESH_KEYS = ("16x16", "2x2", "2x16x16")


@pytest.fixture(autouse=True)
def moe_ep_hint():
    jsharding.set_hints(mesh=None, moe_ep=True, moe_dp=False)
    sharding.set_hints(mesh=None, moe_ep=True, moe_dp=False)
    yield
    jsharding.set_hints(mesh=None, moe_ep=False, moe_dp=False)
    sharding.set_hints(mesh=None, moe_ep=False, moe_dp=False)


def check_ep_specs(tree, specs, want, jm, *, lead=0, fsdp=False,
                   split=True):
    """Every expert leaf of a layer list: with `split`, "model" on its
    expert dim and the rest the reference's rule on the per-layer leaf;
    without, and every other leaf, the reference's stacked spec with the
    layer entry dropped. -> the number of expert leaves."""
    n_e = 0
    for path, n, spec in port_specs(tree, specs):
        ref = want[path]
        if n:
            ref = ref[:lead] + ref[lead + 1:]
        if n and path.endswith("_e"):
            n_e += 1
            if split:
                shape = tuple(_shape(tree, path))
                own = tuple(jsharding.param_spec(path, shape, jm, fsdp=fsdp))
                own += (None,) * (len(shape) - len(own))
                assert spec[lead] == "model", (path, spec)
                assert spec[lead:] == own, (path, spec, own)
                assert spec[:lead] == ref[:lead], (path, spec, ref)
                continue
        assert spec == ref, (path, spec, ref)
    return n_e


def _shape(tree, path):
    """The per-layer shape of the first leaf at `path` (client axis
    dropped)."""
    found = []
    sharding.map_params(lambda p, leaf, n: found.append(leaf.shape)
                        if p == path else None, tree)
    return found[0][-3:]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_key", MESH_KEYS)
def test_expert_leaves_split_on_experts_in_params_specs(arch, mesh_key):
    jm, tm = meshes(mesh_key)
    jp, tp = jparams(arch), tparams(arch)
    want = ref_specs(jserve.params_shardings(jp, jget_arch(arch), jm), jp)
    assert check_ep_specs(tp, serve.params_shardings(tp, get_arch(arch), tm),
                          want, jm) > 0
    for fsdp in (False, True):
        want = {}
        for kp, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            path = "/".join(_key(k) for k in kp)
            want[path] = tuple(jsharding.param_spec(path, leaf.shape, jm,
                                                    fsdp=fsdp))
            want[path] += (None,) * (len(leaf.shape) - len(want[path]))
        check_ep_specs(tp, sharding.tree_param_specs(tp, tm, fsdp=fsdp),
                       want, jm, fsdp=fsdp)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_key", MESH_KEYS)
@pytest.mark.parametrize("strategy", ["tp", "dp_only", "zero1"])
def test_expert_leaves_split_on_experts_in_state_shardings(arch, mesh_key,
                                                           strategy):
    jm, tm = meshes(mesh_key)
    n_clients = 2 if "pod" in tm.axis_names else 1
    js, ts = jstate(arch, n_clients), tstate(arch, n_clients)
    for fsdp in (False, True):
        jcfg = dataclasses.replace(jget_arch(arch), fsdp=fsdp)
        cfg = dataclasses.replace(get_arch(arch), fsdp=fsdp)
        jsh = jtrain.state_shardings(js, jcfg, jm, n_clients,
                                     strategy=strategy)
        tsh = train.state_shardings(ts, cfg, tm, n_clients,
                                    strategy=strategy)
        for field in ("params", "m", "v"):
            pick = lambda s: s.params if field == "params" else getattr(
                s.opt, field)
            assert check_ep_specs(pick(ts), pick(tsh),
                                  ref_specs(pick(jsh), pick(js)), jm,
                                  lead=1, fsdp=fsdp,
                                  split=strategy == "tp") > 0


def _expert_bytes(arch, shape_name, moe_ep):
    """Each rank's bytes of the expert leaves, at most over the ranks, and
    their whole, as `dryrun.build` places them on the 16 x 16 mesh."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    with sharding.hints_restored():
        _, trees = dryrun.build(get_arch(arch), get_shape(shape_name), mesh,
                                mode="cors", n_clients=1, moe_ep=moe_ep)
    held, whole = np.zeros((16, 16), np.int64), 0
    for tree, specs in trees.values():
        paths = [p for p, _, _ in port_specs(tree, specs)]
        for path, (t, spec) in zip(paths, dryrun._spec_leaves(tree, specs)):
            if path.endswith("_e"):
                held += dryrun.leaf_bytes(tuple(t.shape), t.element_size(),
                                          spec, mesh)
                whole += t.numel() * t.element_size()
    return int(held.max()), whole


@pytest.mark.parametrize("shape_name", ["prefill_32k", "train_4k"])
def test_dryrun_reckons_a_sixteenth_of_the_experts_a_rank(shape_name):
    arch = "granite-moe-1b-a400m"
    cfg = get_arch(arch)
    ep, whole = _expert_bytes(arch, shape_name, True)
    tp, whole_tp = _expert_bytes(arch, shape_name, False)
    n_expert = cfg.num_layers * cfg.num_experts * 3 * cfg.d_model * \
        cfg.moe_d_ff
    assert n_expert == 24 * 32 * 3 * 1024 * 512
    assert whole == whole_tp and whole % n_expert == 0
    assert ep == tp == whole // 16
    rec = {ep_: dryrun.reckon_one(arch, shape_name, multi_pod=False,
                                  moe_ep=ep_) for ep_ in (True, False)}
    assert rec[True]["status"] == rec[False]["status"] == "ok"
    assert rec[True]["per_rank_bytes"] == rec[False]["per_rank_bytes"]
