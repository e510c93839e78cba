"""The LM launch path on a one-rank mesh, in this process (a gloo group of
one rank, tests/torch_dist.py): serving and training on trees placed by
the serve and train shardings (`sharding.place`) bit-equal to the
unsharded port, for TinyLlama and the MoE family and every strategy; the
dry-run's real-mesh step; the kernel wrappers' DTensor placements
(`ops.flash_attention`, `ops.proto_accum` through `local_map`) and the
DTensor helpers of `sharding.py`; and the remat policy "dots" against
"full", "none" and the reference's "dots". The four-rank runs are in
tests/test_torch_lm_mesh.py.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jget_arch
from repro.models import blocks as jblocks, lm as jlm
from repro_torch import convert, serve_lm, sharding
from repro_torch.configs import get_arch, get_shape
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, mesh as lmesh, serve, train
from repro_torch.models import blocks, lm
from repro_torch.tree import leaves, tree_map
from repro_torch.types import CollabConfig
from torch_dist import one_rank_mesh

ARCHES = ("tinyllama-1.1b", "granite-moe-1b-a400m")
STRATEGIES = ("tp", "dp_only", "zero1")


@pytest.fixture(scope="module")
def mesh():
    torch.set_num_threads(1)
    with one_rank_mesh():
        yield lmesh.device_mesh(lmesh.make_host_mesh())


@pytest.fixture(autouse=True)
def no_hints():
    yield
    sharding.set_hints(mesh=None, moe_ep=False, moe_dp=False)


def test_device_mesh_needs_the_group_size(mesh):
    assert mesh.mesh_dim_names == ("data", "model")
    assert lmesh.mesh_shape(mesh) == lmesh.make_host_mesh()
    assert lmesh.describe(mesh) == "data:1xmodel:1"
    with pytest.raises(ValueError, match="needs 4 ranks"):
        lmesh.device_mesh(lmesh.MeshShape(("data", "model"), (2, 2)))


@pytest.mark.parametrize("arch", ARCHES)
def test_placed_serving_is_bit_equal(mesh, arch):
    """The serving twin on parameters, batches and caches placed by the
    serve shardings: logits, tokens and caches bit-equal to unsharded."""
    cfg = get_arch(arch).reduced()
    p = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = serve_lm.make_prompts(cfg, 4, 16)
    with torch.no_grad():
        want = serve_lm.serve(p, cfg, prompts, 4)
        placed = sharding.place(p, serve.params_shardings(p, cfg, mesh),
                                mesh)
        got = serve_lm.serve(placed, cfg, prompts, 4, mesh=mesh)
    assert all(sharding.is_dtensor(t) for t in leaves(placed))
    assert torch.equal(got["ids"], want["ids"])
    assert torch.equal(got["logits"], want["logits"])
    for a, b in zip(leaves(got["caches"]), leaves(want["caches"])):
        assert sharding.is_dtensor(a) and torch.equal(sharding.full(a), b)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHES)
def test_placed_train_steps_are_bit_equal(mesh, arch, strategy):
    """Two cors steps of `make_train_step` on a TrainState and batches
    placed by `state_shardings` and `batch_shardings`: metrics and the
    whole state bit-equal to unsharded, placed as it was given."""
    cfg = get_arch(arch).reduced()
    ccfg = CollabConfig(mode="cors", num_classes=cfg.vocab_size,
                        d_feature=cfg.d_feature, num_negatives=15)
    N = 2
    g = torch.Generator().manual_seed(1)
    batches = [{k: torch.randint(0, cfg.vocab_size, (N, 2, 16), generator=g,
                                 dtype=torch.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    negs = [train.draw_negatives(g, cfg, ccfg, N) for _ in range(2)]
    step = train.make_train_step(cfg, ccfg, n_clients=N)
    st = train.init_state(cfg, torch.Generator().manual_seed(0), N,
                          device="cpu")
    sharding.set_hints(mesh=mesh, moe_dp=strategy != "tp")
    specs = train.state_shardings(st, cfg, mesh, N, strategy=strategy)
    placed = sharding.place(st, specs, mesh)
    want_pl = [t.placements for t in leaves(placed)]
    for b, neg in zip(batches, negs):
        st, m = step(st, b, neg)
        placed, pm = step(placed, sharding.place(b, train.batch_shardings(
            b, mesh, N, strategy=strategy), mesh), neg)
        assert {k: float(sharding.full(v)) for k, v in pm.items()} == {
            k: float(v) for k, v in m.items()}
    for a, b, pl in zip(leaves(placed), leaves(st), want_pl):
        assert a.placements == pl
        assert torch.equal(sharding.full(a), b)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dryrun_runs_one_step_on_a_real_mesh(mesh, shape):
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    sh = dryrun.run_shape(get_shape(shape), mesh, 1)
    assert (sh.seq_len, sh.global_batch) == (32, 2)
    out = dryrun.run_one(cfg, sh, mesh)
    vals = [sharding.full(t) for t in leaves(out)]
    assert vals and all(bool(torch.isfinite(v.float()).all())
                        for v in vals if v.is_floating_point())
    assert sharding.hint("mesh") is None


# ---------------------------------------------------------------------------
# the kernels' wrappers on DTensors
# ---------------------------------------------------------------------------
def test_flash_attention_runs_declared_dtensors_on_local_shards(mesh):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 4, 32, generator=g)
    k = torch.randn(2, 16, 2, 32, generator=g)
    v = torch.randn(2, 16, 2, 32, generator=g)
    want = ref.flash_attention(q, k, v, causal=True)
    for pl in ((Shard(0), Shard(2)), (Replicate(), Shard(2)),
               (Shard(0), Replicate())):
        d = [distribute_tensor(t, mesh, pl) for t in (q, k, v)]
        got = ops.flash_attention(*d, causal=True)
        assert got.placements == pl and torch.equal(sharding.full(got), want)
    seq = [distribute_tensor(t, mesh, (Shard(1), Replicate()))
           for t in (q, k, v)]
    with pytest.raises(ValueError, match="placed alike"):
        ops.flash_attention(*seq)
    with pytest.raises(ValueError, match="mixed DTensor"):
        ops.flash_attention(distribute_tensor(q, mesh, (Replicate(),) * 2),
                            k, v)


def test_proto_accum_runs_declared_dtensors_on_local_shards(mesh):
    g = torch.Generator().manual_seed(0)
    f = torch.randn(2, 40, 8, generator=g)
    y = torch.randint(-2, 12, (2, 40), generator=g)
    want = ref.proto_accum(f, y, 10)
    df = distribute_tensor(f, mesh, (Shard(1), Replicate()))
    dy = distribute_tensor(y, mesh, (Shard(1), Replicate()))
    s, c = ops.proto_accum(df, dy, 10)
    # rows split on "data": partial sums; "model" (one rank) whole
    assert s.placements == c.placements == (Partial(), Replicate())
    assert torch.equal(sharding.full(s), want[0]) and torch.equal(sharding.full(c), want[1])
    with pytest.raises(ValueError, match="row dim"):
        ops.proto_accum(distribute_tensor(f, mesh, (Shard(2), Replicate())),
                        dy, 10)


def test_lookup_constrain_and_rows_like(mesh):
    g = torch.Generator().manual_seed(0)
    table = torch.randn(12, 4, generator=g)
    ids = torch.randint(0, 12, (3, 5), generator=g)
    for pl in ((Replicate(), Shard(0)), (Replicate(), Replicate())):
        dt = distribute_tensor(table, mesh, pl)
        got = sharding.lookup(dt, distribute_tensor(ids, mesh, (
            Shard(0), Replicate())))
        assert torch.equal(sharding.full(got), table[ids])
    assert torch.equal(sharding.lookup(table, ids), table[ids])
    x = distribute_tensor(torch.ones(4, 6), mesh, (Replicate(), Replicate()))
    assert sharding.constrain(x, "data", "model") is x        # no hint
    sharding.set_hints(mesh=mesh)
    c = sharding.constrain(x, "data", "model")
    assert c.placements == (Shard(0), Shard(1))
    assert sharding.constrain(x, "pod", "model").placements == (
        Replicate(), Shard(1))
    pos = sharding.rows_like(torch.arange(4), c)
    assert pos.placements == (Shard(0), Replicate())
    assert sharding.rows_like(torch.arange(4), torch.ones(4)).dim() == 1


# ---------------------------------------------------------------------------
# remat "dots"
# ---------------------------------------------------------------------------
class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
BMM = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)

REMAT_ARCHES = ("tinyllama-1.1b", "granite-moe-1b-a400m",
                "deepseek-v2-lite-16b", "zamba2-1.2b", "xlstm-125m")


def _grads(cfg, p, toks, policy, monkeypatch):
    monkeypatch.setattr(blocks, "REMAT_POLICY", policy)
    q = tree_map(lambda a: a.detach().clone().requires_grad_(True), p)
    out = lm.forward(q, cfg, {"tokens": toks})
    loss = out["logits"].square().mean() + 0.01 * out["aux"]
    with OpCount() as c:
        loss.backward()
    return [a.grad for a in leaves(q)], c.n


@pytest.mark.parametrize("arch", REMAT_ARCHES)
def test_remat_dots_saves_products_with_a_weight(arch, monkeypatch):
    """"dots" gives "full"'s and "none"'s gradients, and its backward
    recomputes the layers' batched products as "full" does (attention's
    scores and values, MoE's expert einsums: `aten.bmm`) and no product
    with a weight (`aten.mm` / `aten.addmm`: saved), which "full"
    recomputes. (zamba2's shared block runs outside the layers' remat, as
    in the reference.)"""
    cfg = get_arch(arch).reduced()
    p = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    with OpCount() as fwd:
        lm.forward(p, cfg, {"tokens": toks})
    none, n_none = _grads(cfg, p, toks, "none", monkeypatch)
    full, n_full = _grads(cfg, p, toks, "full", monkeypatch)
    dots, n_dots = _grads(cfg, p, toks, "dots", monkeypatch)
    for a, b, c in zip(dots, full, none):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-9)
        assert torch.allclose(a, c, rtol=1e-6, atol=1e-9)
    # the backward's ops beyond "none"'s are the recomputation
    again = lambda n, ops_: sum(n[o] - n_none[o] for o in ops_)
    assert again(n_dots, MM) == 0
    assert again(n_dots, BMM) == again(n_full, BMM)
    assert again(n_full, MM) > 0
    if arch in ("tinyllama-1.1b", "granite-moe-1b-a400m"):
        # every batched product is inside a layer's remat
        assert again(n_dots, BMM) == sum(fwd.n[o] for o in BMM) > 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m"])
def test_remat_dots_gradients_match_the_reference(arch, monkeypatch):
    """The reference's "dots" (`dots_with_no_batch_dims_saveable`) and the
    port's on the reference's weights: tests/test_torch_train.py's gradient
    tolerance, 1e-4 relative + 1e-5 x max|g|."""
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    p = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    monkeypatch.setattr(jblocks, "REMAT_POLICY", "dots")

    def jloss(q):
        out = jlm.forward(q, jcfg, {"tokens": jnp.asarray(toks)})
        return jnp.mean(jnp.square(out["logits"])) + 0.01 * out["aux"]

    want = jax.tree.map(np.asarray, jax.grad(jloss)(jp))
    got, _ = _grads(cfg, p, torch.from_numpy(toks), "dots", monkeypatch)
    it = iter(got)
    got = convert.lm_params_to_numpy(tree_map(lambda _: next(it), p))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * max(scale, 1e-3))
