"""Placement on a client mesh (`repro_torch/relay/placement.py`,
`repro_torch/sharding.py`): the twins of tests/test_placement_api.py's
placement tests, `psum_merge` against the reference's under a 1-device
`shard_map` (tests/test_prototypes.py), and the port's vectorized engine on
a one-rank client mesh against itself without one: the twins of the
reference's 1-device mesh runs (tests/test_vec_collab.py's placement path
and hetero buckets, tests/test_async_relay.py's and
tests/test_download_lag.py's compositions with a mesh) and the other fleet
compositions, 3 rounds each, with records, relay state and parameters
bit-equal (a one-rank exchange is a copy) and one exchange a round.

A module fixture opens a one-rank gloo group in this process for the file
and destroys it after (tests/torch_dist.py). The four-rank runs are in
tests/test_torch_multidevice.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import relay as jrelay, sharding as jsharding
from repro.core import client as jclient, collab as jcollab
from repro.core import prototypes as jprototypes
from repro.data import partition, synthetic
from repro.models import mlp as jmlp
from repro.obs import metrics as jmetrics
from repro.relay import events as jevents, history as jhistory
from repro.types import CollabConfig as JCollabConfig
from repro.types import FleetConfig as JFleetConfig
from repro.types import TrainConfig as JTrainConfig
from repro_torch import relay as trelay, sharding
from repro_torch.core import client as tclient, collab as tcollab
from repro_torch.core import prototypes as tprototypes, vec_collab as tvec
from repro_torch.models import mlp as tmlp
from repro_torch.obs import metrics as tmetrics
from repro_torch.relay import events as tevents, history as thistory
from repro_torch.relay import placement
from repro_torch.tree import leaves
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
from torch_dist import one_rank_mesh

POLICIES = ["flat", "per_class", "staleness", "sharded:flat,2",
            "sharded:per_class,3"]


@pytest.fixture(scope="module")
def mesh():
    torch.set_num_threads(1)
    with one_rank_mesh() as m:
        yield m


def by_field(tree, at=""):
    """A declaration's tags by field path: NamedTuple fields by name, other
    tuples and lists by index, dicts by key."""
    if tree is None or isinstance(tree, str):
        return {at: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(by_field(v, f"{at}.{k}" if at else str(k)))
    return out


# ---------------------------------------------------------------------------
# placement primitives
# ---------------------------------------------------------------------------
def test_like_tags_every_leaf():
    tree = {"a": torch.zeros(2), "b": (torch.zeros(()), torch.ones(3, 4)),
            "c": None}
    tags = placement.like(tree, placement.REPLICATED)
    assert by_field(tags) == {"a": "replicated", "b.0": "replicated",
                              "b.1": "replicated", "c": None}
    assert placement.tags(tags) == {placement.REPLICATED}
    with pytest.raises(ValueError, match="unknown placement"):
        placement.like(tree, "diagonal")


def test_resolve_maps_tags_to_placements(mesh):
    assert placement.resolve(placement.REPLICATED, mesh) == (Replicate(),)
    assert placement.resolve(placement.CLIENT_SHARDED, mesh) == (Shard(0),)
    rs = placement.resolve({"a": placement.REPLICATED,
                            "b": placement.CLIENT_SHARDED}, mesh)
    assert rs == {"a": (Replicate(),), "b": (Shard(0),)}
    assert rs["b"][0].is_shard() and not rs["a"][0].is_shard()
    assert mesh.mesh_dim_names == (placement.CLIENT_AXIS,)
    assert sharding.axis_size(mesh, "clients") == 1
    assert sharding.axis_size(mesh, "model") == 1
    with pytest.raises(ValueError, match="no axis"):
        sharding.leading_axis(mesh, "model")
    assert placement.rank_block(mesh, 8) == (0, 8)
    assert placement.rank_block(None, 8) == (0, 8)


def test_exchange_is_the_identity_off_mesh_and_a_copy_on_one_rank(mesh):
    g = torch.Generator().manual_seed(0)
    x = {"f": torch.randn(4, 3, generator=g), "b": torch.rand(4, generator=g) > 0.5,
         "i": torch.arange(4, dtype=torch.int32), "l": torch.arange(8).reshape(4, 2),
         "h": torch.randn(4, 5, generator=g).to(torch.bfloat16), "none": None,
         "e": torch.zeros(4, 0, 3)}
    placement.reset_exchanges()
    assert placement.exchange(x, None) is x               # structurally free
    out = placement.exchange(x, mesh)
    assert placement.EXCHANGES["exchange"] == 2
    assert out["none"] is None
    for k in x:
        if x[k] is not None:
            assert out[k].dtype == x[k].dtype and out[k].shape == x[k].shape
            assert torch.equal(out[k], x[k]), k
    # replicated leaves and blocks of a replicated stack pass as they are
    rep = placement.exchange(x["f"], mesh, placement.REPLICATED)
    assert rep is x["f"]
    blocks = placement.Blocks([(placement.CLIENT_SHARDED, 1),
                               (placement.REPLICATED, 3)])
    assert torch.equal(placement.exchange(x["f"], mesh, blocks), x["f"])
    with pytest.raises(ValueError, match="blocks of"):
        placement.exchange(torch.zeros(5), mesh, blocks)
    assert placement.gather(x, None) is x
    assert placement.EXCHANGES == {"exchange": 5, "gather": 1}


@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_declares_what_the_reference_declares(policy):
    """The relay IS the paper's shared pool: every policy's state is
    REPLICATED, field for field as the reference declares it."""
    jpol, tpol = jrelay.get_policy(policy), trelay.get_policy(policy)
    jst = jpol.init_state(JCollabConfig(num_classes=4, d_feature=3), 3, seed=0,
                          n_clients=4)
    tst = tpol.init_state(CollabConfig(num_classes=4, d_feature=3), 3, seed=0,
                          n_clients=4, device="cpu")
    want, got = by_field(jpol.out_spec(jst)), by_field(tpol.out_spec(tst))
    assert got == want and set(got.values()) == {"replicated"}


@pytest.mark.parametrize("fd", [False, True])
def test_pending_history_and_telemetry_declarations(fd):
    """The pending buffer is CLIENT_SHARDED leaf for leaf, the history ring
    and the round telemetry REPLICATED, as in the reference."""
    jp = jevents.init_pending(4, 2, 1, 4, 3, fd=fd)
    tp = tevents.init_pending(4, 2, 1, 4, 3, fd=fd, device="cpu")
    assert by_field(tevents.out_spec(tp)) == by_field(jevents.out_spec(jp))
    assert placement.tags(tevents.out_spec(tp)) == {placement.CLIENT_SHARDED}
    jst = jrelay.get_policy("flat").init_state(
        JCollabConfig(num_classes=4, d_feature=3), 3, seed=0)
    tst = trelay.get_policy("flat").init_state(
        CollabConfig(num_classes=4, d_feature=3), 3, seed=0, device="cpu")
    assert (by_field(thistory.out_spec(thistory.init(tst, 2)))
            == by_field(jhistory.out_spec(jhistory.init(jst, 2))))
    z = torch.zeros(())
    tt = tmetrics.RoundTelemetry(*([z] * len(tmetrics.RoundTelemetry._fields)))
    jt = jmetrics.RoundTelemetry(*([jnp.zeros(())]
                                   * len(jmetrics.RoundTelemetry._fields)))
    assert by_field(tmetrics.out_spec(tt)) == by_field(jmetrics.out_spec(jt))
    assert placement.tags(tmetrics.out_spec(tt)) == {placement.REPLICATED}


def test_psum_merge_matches_the_reference(mesh):
    """One rank: the all-reduce is the identity, as the reference's psum on
    a 1-device `shard_map`; sums and counts equal to the reference's."""
    g = np.random.default_rng(0)
    feats = g.normal(size=(6, 3)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 1], np.int32)
    jst = jprototypes.accumulate(jprototypes.init_state(2, 3),
                                 jnp.asarray(feats), jnp.asarray(labels))
    want = jsharding.shard_map(
        lambda s: jprototypes.psum_merge(s, "i"),
        mesh=jax.make_mesh((1,), ("i",)),
        in_specs=jax.sharding.PartitionSpec(),
        out_specs=jax.sharding.PartitionSpec())(jst)
    tst = tprototypes.accumulate(tprototypes.init_state(2, 3, "cpu"),
                                 torch.as_tensor(feats),
                                 torch.as_tensor(labels))
    for group in (mesh, mesh.get_group("clients")):
        got = tprototypes.psum_merge(tst, group)
        np.testing.assert_allclose(got.sum.numpy(), np.asarray(want.sum),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got.count.numpy(),
                                      np.asarray(want.count))


# ---------------------------------------------------------------------------
# the engines: seq refuses a mesh in the reference's words, vec takes it
# ---------------------------------------------------------------------------
T_SPEC = tclient.ClientSpec(apply=tmlp.apply,
                            head=lambda p: (p["head_w"], p["head_b"]))
T_SPEC_B = tclient.ClientSpec(apply=tmlp.apply,
                              head=lambda p: (p["head_w"], p["head_b"]))


def _fleet(n=4, hetero=False, mode="cors"):
    x, y = synthetic.class_images(48 * n, seed=0, noise=0.4)
    parts = partition.uniform_split(x, y, n, seed=1)
    g = torch.Generator().manual_seed(0)
    hid = [96 if hetero and i % 2 else 64 for i in range(n)]
    specs = [T_SPEC_B if h == 96 else T_SPEC for h in hid]
    params = [tmlp.init_mlp(g, hidden=h, device="cpu") for h in hid]
    ccfg = CollabConfig(mode=mode, num_classes=10, d_feature=84,
                        lambda_kd=2.0, lambda_disc=1.0)
    return (specs, params, parts, synthetic.class_images(64, seed=9), ccfg,
            TrainConfig(batch_size=16))


def test_sequential_engine_refuses_a_mesh_in_the_reference_words(mesh):
    jspec = jclient.ClientSpec(apply=jmlp.apply,
                               head=lambda p: (p["head_w"], p["head_b"]))
    x, y = synthetic.class_images(64, seed=0)
    parts = partition.uniform_split(x, y, 2, seed=1)
    jparams = [jmlp.init_mlp(k) for k in jax.random.split(
        jax.random.PRNGKey(0), 2)]
    with pytest.raises(ValueError) as want:
        jcollab.CollabTrainer([jspec] * 2, jparams, parts, (x, y),
                              JCollabConfig(), JTrainConfig(),
                              fleet=JFleetConfig(mesh=jsharding.client_mesh(1)))
    with pytest.raises(ValueError, match="sequential oracle.*host-side") as got:
        tcollab.CollabTrainer(*_fleet(2), fleet=FleetConfig(mesh=mesh),
                              device="cpu")
    assert str(got.value) == str(want.value)


# (name, fleet, mode, hetero, telemetry): the reference's 1-device mesh runs
# first (tests/test_vec_collab.py:94 and :127, test_async_relay.py:188,
# test_download_lag.py:187), then the other compositions
ONE_RANK = [
    ("placement_path", {}, "cors", False, False),
    ("hetero_buckets", {}, "cors", True, False),
    ("async_staleness", dict(policy="staleness", clock="lognormal:2"), "cors",
     False, False),
    ("download_lag_flat", dict(download_clock="lognormal:2"), "cors", False,
     False),
    ("static_k", dict(participation="uniform_k:3"), "cors", False, False),
    ("bernoulli", dict(participation="bernoulli:0.5"), "cors", False, False),
    ("fd", {}, "fd", False, False),
    ("il", {}, "il", False, False),
    ("fedavg", {}, "fedavg", False, False),
    ("fedavg_static_k", dict(participation="uniform_k:2"), "fedavg", False,
     False),
    ("telemetry_async", dict(policy="staleness", clock="lognormal:2"), "cors",
     False, True),
    ("telemetry_compacted_lag", dict(participation="uniform_k:2",
                                     download_clock="periodic:2,3"), "cors",
     False, True),
    ("composed", dict(clock="lognormal:2", download_clock="lognormal:2"),
     "cors", False, False),
    ("sharded_relay", dict(policy="sharded:flat,2"), "cors", False, False),
    ("stream", dict(arrivals="stream:2,2.0,0.3,10,0"), "cors", False, False),
    ("hetero_async_telemetry", dict(clock="lognormal:2",
                                    download_clock="lognormal:1"), "fd", True,
     True),
]


@pytest.mark.parametrize("name,fleet,mode,hetero,telemetry", ONE_RANK,
                         ids=[c[0] for c in ONE_RANK])
def test_one_rank_mesh_equals_the_unsharded_engine(mesh, name, fleet, mode,
                                                   hetero, telemetry):
    """A one-rank mesh runs the unsharded round body with every exchange a
    copy: records, relay state, history ring and parameters bit-equal for 3
    rounds, and one exchange a round (none in il, which exchanges nothing
    without telemetry)."""
    build = lambda m: tvec.VectorizedCollabTrainer(
        *_fleet(hetero=hetero, mode=mode), seed=0, device="cpu",
        fleet=FleetConfig(mesh=m, **fleet), telemetry=telemetry or None)
    plain, meshed = build(None), build(mesh)
    assert meshed.mesh is mesh and meshed.hetero == hetero
    placement.reset_exchanges()
    for _ in range(3):
        assert meshed.run_round() == plain.run_round()
    rounds = 0 if mode == "il" and not telemetry else 3
    assert placement.EXCHANGES["exchange"] == 2 * rounds
    for a, b in zip(leaves(plain.relay_state), leaves(meshed.relay_state)):
        assert torch.equal(a, b)
    if plain._lagged:
        for a, b in zip(leaves(plain.hist), leaves(meshed.hist)):
            assert torch.equal(a, b)
    if plain._async:
        for a, b in zip(leaves(plain.pending), leaves(meshed.pending)):
            assert torch.equal(a, b)
    for i in range(plain.n_clients):
        pa, pb = plain.client_params(i), meshed.client_params(i)
        assert all(torch.equal(pa[k], pb[k]) for k in pa), i


def test_twin_runs_a_client_mesh_of_cpu_ranks(tmp_path):
    """The example twin's `--ranks 2` on the CPU: two gloo ranks (the twin
    takes NCCL only on CUDA with a card a rank) run one LeNet round of 4
    clients, and rank 0 writes every client's checkpoint."""
    from repro_torch import collab_image_classification as twin
    assert twin._backend("cpu", 2) == "gloo"
    twin.main(["--device", "cpu", "--ranks", "2", "--clients", "4",
               "--rounds", "1", "--out", str(tmp_path)])
    for i in range(4):
        assert (tmp_path / f"client{i}.npz").exists(), i
