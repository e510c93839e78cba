"""Population scale in the port: cohort-sharded relays
(`repro_torch.relay.shards`) and streaming arrivals
(`repro_torch.sim.population`) against the reference's; the port of
tests/test_population_shards.py.

- `shard_of`, in its three forms (a torch tensor, a numpy array, an int),
  bit-equal to the reference's uint32 mix on ids 0..2**16, ids next to
  2**31 - 1, and SEED_OWNER -1 / EMPTY_OWNER -2, for S in {1, 2, 3, 4, 7}.
- The copy of `CohortTable`: every `RoundView` field, `dropped` and
  `nbytes` over many rounds, and the replay from any round, equal to the
  reference's; the arrival and `sharded:` spec parsing and validation.
- `ShardedRelay` function by function on seeded inputs through both
  packages (append routing, the draws from the reference's keys, the
  reduction at S = 1 and 4, the merge with its gossip cadence and frozen
  quiet shards, eviction, stamps): integer leaves exactly, floats within
  1e-6 (the per-shard sums are an einsum in both, summed in another
  order); `evict_owners` of flat, per_class and staleness likewise.
- Both port engines against the reference's sequential engine on the
  fleet of tests/test_torch_async_relay.py (4 MLP clients, 192 samples,
  batch 16, the reference's draws; `run_three`'s bounds: records, ledger,
  ring integers, ages and `merges` exactly, floats and weights within
  1e-4, accuracies within 2e-2): `sharded:flat,4` under uniform_k:2, fd
  on `sharded:flat,2`, `sharded:flat,2` under an upload clock and under a
  download clock, and a streaming fleet of 3 seats over 8 rounds with
  evictions and dropped arrivals, its cohort tables equal round by round.
- Port-only, exact: `sharded:<inner>,1` evolves `<inner>`'s state and
  weights bit for bit in the vectorized engine; a round with no
  participant leaves the relay untouched; the composition guards raise
  the reference's `ValueError`s, word for word.

The {flat, per_class, staleness} x S in {1, 4} matrix and a streaming run
on the unsharded staleness relay carry the registered `slow` marker. The
fixtures `shared_reference_jits` and `one_torch_thread` of
tests/test_torch_async_relay.py apply (that file says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import relay as jrelay
from repro.core import collab as jcollab
from repro.core import prototypes as jp
from repro.models import mlp as jmlp
from repro.relay import shards as jshards
from repro.sim import population as jpop
from repro.types import CollabConfig as JCollabConfig
from repro.types import FleetConfig as JFleetConfig
from repro.types import TrainConfig as JTrainConfig
from repro_torch import convert, relay as trelay, sim as tsim
from repro_torch.core import collab as tcollab
from repro_torch.core import prototypes as tp, vec_collab as tvec
from repro_torch.relay import shards as tshards
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
from test_torch_async_relay import (J_SPECS, T_SPECS, _data, _kw,  # noqa: F401
                                    build_three, delayed_commits,
                                    one_torch_thread, run_three,
                                    shared_reference_jits)
from test_torch_download_lag import run_lagged, stale_reads
from torch_dist import one_rank_mesh
from test_torch_relay_policies import (client_weights, relay_state,
                                       state_fields)

INNERS = ["flat", "per_class", "staleness"]
INT_FIELDS = ("ptr", "owner", "valid", "stamp", "clock", "valid_g", "age",
              "merges")
TOL = 1e-6
C, D_FEAT = 4, 3
STREAM = "stream:2,1.5,0.3,7,0"


def _t(a):
    return torch.from_numpy(np.array(a))


def same_state(js, ts, tol=TOL):
    a, b = state_fields(js), state_fields(ts)
    assert list(a) == list(b)
    for f in a:
        if f in INT_FIELDS:
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
        else:
            np.testing.assert_allclose(b[f], a[f], atol=tol, rtol=0,
                                       err_msg=f)


# ---------------------------------------------------------------------------
# shard_of and the cohort table copy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 2, 3, 4, 7])
def test_shard_of_equals_reference(S):
    ids = np.concatenate([np.arange(2 ** 16 + 1),
                          np.arange(2 ** 31 - 4097, 2 ** 31),
                          [-1, -2]]).astype(np.int64)
    want = np.asarray(jshards.shard_of(jnp.asarray(ids.astype(np.int32)), S))
    got = tshards.shard_of(torch.from_numpy(ids), S)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    host = tshards.shard_of(ids, S)
    assert host.dtype == np.int32
    np.testing.assert_array_equal(host, want)
    for i in (0, 1, 2 ** 31 - 1, -1, -2):
        assert int(tshards.shard_of(i, S)) == int(jshards.shard_of(i, S))
    if S > 1:                       # the mix spreads ids over every shard
        assert set(np.unique(host)) == set(range(S))


@pytest.mark.parametrize("spec,seats", [("stream:2,1.5,0.3,7,0", 5),
                                        ("stream:2,1.5,0.3,7,0", 3),
                                        ("stream:8,8.0,0.3,1000000,0", 32),
                                        ("stream:3,2.5,0.5,50,4", 4)])
def test_cohort_table_equals_reference(spec, seats):
    """Every RoundView field over 40 rounds, `dropped` and `nbytes`, and a
    fresh table replayed from any round."""
    want = jpop.get_arrivals(spec).table(seats)
    got = tsim.get_arrivals(spec).table(seats)
    for r in range(40):
        a, b = want.round(r), got.round(r)
        assert type(b).__name__ == "RoundView" and b._fields == a._fields
        for f in a._fields:
            assert getattr(b, f).dtype == getattr(a, f).dtype, f
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                          err_msg=(r, f))
        assert got.dropped == want.dropped
    assert got.nbytes() == want.nbytes() > 0
    for r in (0, 7, 23, 39):
        late = tsim.get_arrivals(spec).table(seats).round(r)
        for f in late._fields:
            np.testing.assert_array_equal(getattr(late, f),
                                          getattr(want.round(r), f))


def test_arrival_spec_parsing_and_validation():
    for spec in ("stream:3,1.5,0.2,1000,7", "stream", "stream:4",
                 "stream:2,0,0.5"):
        assert tsim.get_arrivals(spec) == tsim.StreamingPopulation(
            **jpop.get_arrivals(spec).__dict__)
    pop = tsim.get_arrivals("stream:3,1.5,0.2,1000,7")
    assert (pop.k, pop.rate, pop.p_leave, pop.population, pop.seed) == \
        (3, 1.5, 0.2, 1000, 7)
    assert tsim.get_arrivals(None) is None
    assert tsim.get_arrivals(pop) is pop
    for bad in (dict(k=0), dict(p_leave=1.5), dict(population=0),
                dict(rate=-1.0)):
        with pytest.raises(ValueError):
            tsim.StreamingPopulation(**bad)
    with pytest.raises(ValueError) as got:
        tsim.get_arrivals("nope:1")
    with pytest.raises(ValueError) as want:
        jpop.get_arrivals("nope:1")
    assert str(got.value) == str(want.value)


def test_sharded_policy_spec_parsing_and_validation():
    for spec in ("sharded:staleness,4,2", "sharded:per_class,4,2",
                 "sharded:flat,3", "sharded"):
        p, q = trelay.get_policy(spec), jrelay.get_policy(spec)
        assert isinstance(p, trelay.ShardedRelay)
        assert (p.shards, p.gossip_every, p.inner.name) == \
            (q.shards, q.gossip_every, q.inner.name)
    assert isinstance(trelay.get_policy("sharded:staleness,4,2").inner,
                      trelay.StalenessRelay)
    for bad in (dict(shards=0), dict(gossip_every=0),
                dict(inner=tshards.ShardedRelay())):
        with pytest.raises(ValueError):
            tshards.ShardedRelay(**bad)


def test_free_seat_matches_empty_owner_sentinel():
    assert tsim.FREE_SEAT == trelay.EMPTY_OWNER == jpop.FREE_SEAT


# ---------------------------------------------------------------------------
# ShardedRelay and evict_owners, function by function
# ---------------------------------------------------------------------------
def _pair(spec, capacity=5):
    kw = dict(num_classes=C, d_feature=D_FEAT, m_down=2)
    jpol, tpol = jrelay.get_policy(spec), trelay.get_policy(spec)
    return (jpol, tpol,
            jpol.init_state(JCollabConfig(**kw), D_FEAT, seed=0,
                            capacity=capacity),
            tpol.init_state(CollabConfig(**kw), D_FEAT, seed=0,
                            capacity=capacity, device="cpu"))


def _ids_on_distinct_shards(S, want=2):
    out, seen = [], set()
    for i in range(1000):
        s = int(tshards.shard_of(i, S))
        if s not in seen:
            seen.add(s)
            out.append(i)
        if len(out) == want:
            return out
    raise AssertionError("the hash did not cover the shards")


def _same_teachers(jpol, tpol, js, ts, ids, m_down, seed):
    """Each client's teacher from the reference's key (its noise of the
    port's `noise_shape`) through both packages."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(ids))
    shape = tpol.noise_shape(ts, m_down)
    noise, picks = [], []
    for k in keys:
        k_sample, k_pick = jax.random.split(k)
        noise.append(np.array(jax.random.gumbel(k_sample, shape)))
        picks.append(int(jax.random.randint(k_pick, (), 0, m_down)))
    got = tpol.sample_teachers(ts, _t(np.array(ids, np.int32)), m_down,
                               _t(np.stack(noise)), _t(picks))
    for n, (cid, k) in enumerate(zip(ids, keys)):
        want = jpol.sample_teacher(js, jnp.int32(cid), m_down, k)
        assert sorted(want) == sorted(got)
        for f in want:
            a, b = np.asarray(want[f]), got[f][n].numpy()
            if a.dtype == np.float32:       # merged means: another order
                np.testing.assert_allclose(b, a, atol=TOL, rtol=0, err_msg=f)
            else:                           # the draws: exact
                np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("S", [1, 4])
def test_sharded_relay_equals_reference(inner, S):
    """Three rounds of appends (a row mask, owners over every shard, birth
    stamps in round 1), the per-shard reduction and merge (with logit sums
    in round 2), an eviction and every client's draws, through both
    packages; the state after every call, the stamps and the teachers."""
    spec = f"sharded:{inner},{S}"
    jpol, tpol, js, ts = _pair(spec)
    same_state(js, ts)
    rng = np.random.default_rng(5 + S)
    owners = np.array([0, 1, 2, 3, 4, 5, 1000003, 2 ** 31 - 2], np.int32)
    k = owners.size
    for r in range(3):
        obs = rng.standard_normal((k, C, D_FEAT)).astype(np.float32)
        valid = rng.random((k, C)) > 0.3
        mask = rng.random(k) > 0.25
        stamps = (rng.integers(0, 2, k).astype(np.int32) if r == 1
                  else None)
        js = jpol.append(js, obs, valid, owners, jnp.asarray(mask),
                         None if stamps is None else jnp.asarray(stamps))
        ts = tpol.append(ts, _t(obs), _t(valid), _t(owners), _t(mask),
                         None if stamps is None else _t(stamps))
        same_state(js, ts)
        psum = rng.standard_normal((k, C, D_FEAT)).astype(np.float32)
        pcnt = rng.integers(0, 3, (k, C)).astype(np.float32)
        w = mask.astype(np.float32)
        jproto = jpol.reduce_uploads(jnp.asarray(psum), jnp.asarray(pcnt),
                                     jnp.asarray(w), jnp.asarray(owners))
        tproto = tpol.reduce_uploads(_t(psum), _t(pcnt), _t(w), _t(owners))
        assert tproto.sum.shape == (S, C, D_FEAT)
        same_state(jproto, tproto)
        jlogit = tlogit = None
        if r == 2:
            lsum = rng.standard_normal((k, C, C)).astype(np.float32)
            jlogit = jpol.reduce_uploads(jnp.asarray(lsum), jnp.asarray(pcnt),
                                         jnp.asarray(w), jnp.asarray(owners))
            tlogit = tpol.reduce_uploads(_t(lsum), _t(pcnt), _t(w),
                                         _t(owners))
        js = jpol.merge_round(js, jproto, jlogit)
        ts = tpol.merge_round(ts, tproto, tlogit)
        same_state(js, ts)
        evicted = np.array([owners[r], trelay.EMPTY_OWNER], np.int32)
        js = jpol.evict_owners(js, jnp.asarray(evicted))
        ts = tpol.evict_owners(ts, _t(evicted))
        same_state(js, ts)
        assert not (ts.owner == int(owners[r])).any()
        want = np.asarray(jpol.stamp_now(js, jnp.asarray(owners)))
        got = tpol.stamp_now(ts, _t(owners))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tpol.host_stamps(ts, owners.tolist()),
            jpol.host_stamps(js, owners.tolist()))
        _same_teachers(jpol, tpol, js, ts, [0, 1, 3, 1000003, 7], 2, r)
    assert int(ts.merges) == 3


def test_single_shard_reduction_is_the_engines_sum():
    """S = 1: the engines' own weighted sum, op for op, bit for bit."""
    pol = tshards.ShardedRelay(shards=1)
    g = torch.Generator().manual_seed(0)
    psum, pcnt = torch.randn(5, C, D_FEAT, generator=g), torch.rand(5, C)
    w = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])
    got = pol.reduce_uploads(psum, pcnt, w, torch.arange(5))
    assert torch.equal(got.sum[0], (psum * w[:, None, None]).sum(0))
    assert torch.equal(got.count[0], (pcnt * w[:, None]).sum(0))


def test_quiet_shards_are_frozen_and_gossip_is_nan_free():
    """One committing cohort: only its shard merges and ticks; the gossip
    mean stays finite though 3 of 4 shards brought nothing; the same in
    the reference."""
    jpol, tpol, js, ts = _pair("sharded:flat,4")
    owner = _ids_on_distinct_shards(4, want=1)[0]
    s0 = int(tshards.shard_of(owner, 4))
    args = (np.ones((1, C, D_FEAT), np.float32), np.ones((1, C), np.float32),
            np.ones((1,), np.float32), np.array([owner], np.int32))
    tproto = tpol.reduce_uploads(*(_t(a) for a in args))
    jproto = jpol.reduce_uploads(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(tproto.count.sum(1).numpy() > 0,
                                  np.arange(4) == s0)
    ts2 = tpol.merge_round(ts, tproto)
    same_state(jpol.merge_round(js, jproto), ts2)
    clocks = ts2.clock.numpy()
    assert clocks[s0] == 1 and (np.delete(clocks, s0) == 0).all()
    assert torch.isfinite(ts2.global_protos).all()
    for f, before in state_fields(ts.shards).items():
        after = state_fields(ts2.shards)[f]
        for s in range(4):
            if s != s0:
                np.testing.assert_array_equal(before[s], after[s],
                                              err_msg=f)
    assert int(ts2.merges) == 1


def test_gossip_cadence_and_cross_shard_mean():
    """gossip_every = 2: the first merge keeps each shard's mean, the second
    gives the active shards the cross-shard mean."""
    jpol, tpol, js, ts = _pair("sharded:flat,2,2")
    a, b = _ids_on_distinct_shards(2)
    owners = np.array([a, b], np.int32)
    psum = np.stack([np.full((C, D_FEAT), 2.0, np.float32),
                     np.full((C, D_FEAT), 6.0, np.float32)])
    args = (psum, np.ones((2, C), np.float32), np.ones((2,), np.float32),
            owners)
    tproto = tpol.reduce_uploads(*(_t(x) for x in args))
    jproto = jpol.reduce_uploads(*(jnp.asarray(x) for x in args))
    sa, sb = (int(tshards.shard_of(i, 2)) for i in (a, b))
    ts1, js1 = tpol.merge_round(ts, tproto), jpol.merge_round(js, jproto)
    same_state(js1, ts1)
    np.testing.assert_allclose(ts1.global_protos[sa].numpy(), 2.0)
    np.testing.assert_allclose(ts1.global_protos[sb].numpy(), 6.0)
    ts2, js2 = tpol.merge_round(ts1, tproto), jpol.merge_round(js1, jproto)
    same_state(js2, ts2)
    np.testing.assert_allclose(ts2.global_protos[sa].numpy(), 4.0)
    np.testing.assert_allclose(ts2.global_protos[sb].numpy(), 4.0)


def test_append_routes_rows_to_owner_shard_only():
    _, tpol, _, ts = _pair("sharded:flat,4")
    a, b = _ids_on_distinct_shards(4)
    ts2 = tpol.append(ts, torch.ones(2, C, D_FEAT),
                      torch.ones(2, C, dtype=torch.bool),
                      torch.tensor([a, b], dtype=torch.int32))
    owner = ts2.owner.numpy()                                   # (S, cap)
    for cid in (a, b):
        s = int(tshards.shard_of(cid, 4))
        assert (owner[s] == cid).sum() == 1
        assert (np.delete(owner, s, axis=0) == cid).sum() == 0
    moved = ts2.ptr.numpy() != ts.ptr.numpy()
    np.testing.assert_array_equal(
        moved, np.isin(np.arange(4), [int(tshards.shard_of(i, 4))
                                      for i in (a, b)]))


@pytest.mark.parametrize("spec", INNERS + ["sharded:per_class,2"])
def test_evict_owners_equals_reference(spec):
    """Eviction empties exactly the evicted owners' slots (owner, valid,
    stamp, age); other owners, seeds, ptr and clock are untouched; the
    same state as the reference's."""
    jpol, tpol, js, ts = _pair(spec, capacity=6)
    proto = (jp.ProtoState(jnp.ones((C, D_FEAT)), jnp.ones((C,))),
             tp.ProtoState(torch.ones(C, D_FEAT), torch.ones(C)))
    rows = (np.ones((3, C, D_FEAT), np.float32), np.ones((3, C), bool),
            np.array([5, 9, 5], np.int32))
    sharded = spec.startswith("sharded")
    for _ in range(2):
        js = jpol.append(js, *rows)
        ts = tpol.append(ts, *(_t(a) for a in rows))
        if not sharded:                    # ages and clocks move on
            js = jpol.merge_round(js, proto[0])
            ts = tpol.merge_round(ts, proto[1])
    same_state(js, ts)
    evicted = np.array([5, trelay.EMPTY_OWNER, 77], np.int32)
    js2 = jpol.evict_owners(js, jnp.asarray(evicted))
    ts2 = tpol.evict_owners(ts, _t(evicted))
    same_state(js2, ts2)
    before, after = state_fields(ts), state_fields(ts2)
    hit = before["owner"] == 5
    assert hit.any() and not (after["owner"] == 5).any()
    assert (after["owner"][hit] == trelay.EMPTY_OWNER).all()
    np.testing.assert_array_equal(after["owner"][~hit], before["owner"][~hit])
    assert (after["owner"] == 9).sum() == (before["owner"] == 9).sum() > 0
    for f in ("ptr", "clock"):
        np.testing.assert_array_equal(after[f], before[f], err_msg=f)
    # evicting again, or padding with EMPTY_OWNER, changes nothing
    same_state(ts2, tpol.evict_owners(ts2, _t(evicted)))


def test_sharded_evict_hits_every_shard():
    _, tpol, _, ts = _pair("sharded:flat,2")
    a, b = _ids_on_distinct_shards(2)
    ts = tpol.append(ts, torch.ones(2, C, D_FEAT),
                     torch.ones(2, C, dtype=torch.bool),
                     torch.tensor([a, b], dtype=torch.int32))
    ts2 = tpol.evict_owners(ts, torch.tensor([a, b], dtype=torch.int32))
    assert not ((ts2.owner == a) | (ts2.owner == b)).any()
    assert int((ts.owner >= 0).sum()) == 2


# ---------------------------------------------------------------------------
# both engines against the reference's sequential engine
# ---------------------------------------------------------------------------
def _same_cohorts(ref, seq, vec, rounds):
    for r in range(rounds):
        want = ref._cohort.round(r)
        for t in (seq, vec):
            got = t._cohort.round(r)
            for f in want._fields:
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
    assert seq._cohort.dropped == vec._cohort.dropped == ref._cohort.dropped


def test_sharded_engines_match_reference():
    trainers = build_three("sharded:flat,4", schedule="uniform_k:2")
    assert trainers[2]._k_active == 2                  # compacted
    run_three(trainers)
    assert len(set(relay_state(trainers[2])["clock"].tolist())) > 1


def test_sharded_fd_logit_reduction():
    """fd's logit sums go through `reduce_uploads` too."""
    trainers = build_three("sharded:flat,2", schedule="uniform_k:2",
                           mode="fd")
    run_three(trainers)
    assert np.abs(relay_state(trainers[2])["mean_logits"]).max() > 0


def test_sharded_under_an_upload_clock():
    """Parked contributions segmented by their position's owner
    (`commit_and_park`'s reduction), stamps from each owner's shard."""
    trainers = build_three("sharded:flat,2", clock="lognormal:2")
    assert delayed_commits(run_three(trainers))


def test_sharded_under_a_download_clock():
    """The history ring carries the sharded state, leaves (H, S, ...)."""
    trainers = build_three("sharded:flat,2", download_clock="periodic:2,3")
    run_lagged(trainers)
    assert stale_reads(trainers[2])
    assert trainers[2].hist.snaps.owner.shape[:2] == (2 + 1, 2)


def test_streaming_engines_match_reference_with_evictions_and_drops():
    """3 seats, a population of 7 ids: departures, LRU evictions and
    dropped arrivals all occur, and the engines agree every round."""
    trainers = build_three("sharded:flat,2", n_clients=3, arrivals=STREAM)
    ref, seq, vec = trainers
    assert vec._k_active == 3 and seq.schedule is None
    run_three(trainers, rounds=8)
    _same_cohorts(ref, seq, vec, 8)
    assert sum(seq._cohort.round(r).evicted.size for r in range(8)) > 0
    assert seq._cohort.dropped > 0
    per_client = (seq.ccfg.m_up + 1) * seq.ccfg.num_classes * \
        seq.ccfg.d_feature
    for r, rec in enumerate(seq.history):          # billing follows the mask
        assert rec["comm_up"] == per_client * int(
            seq._cohort.round(r).mask.sum())


@pytest.mark.parametrize("inner", INNERS)
def test_single_shard_is_bit_identical_to_plain(inner):
    """sharded:<inner>,1 evolves <inner>'s state and weights bit for bit in
    the vectorized engine, over 3 compacted rounds."""
    plain = build_three(inner, schedule="uniform_k:2", reference=False)[1]
    one = build_three(f"sharded:{inner},1", schedule="uniform_k:2",
                      reference=False)[1]
    for _ in range(3):
        plain.run_round()
        one.run_round()
    ps, ss = relay_state(plain), relay_state(one)
    assert int(ss.pop("merges")) == 3
    assert sorted(ps) == sorted(ss)
    for f in ps:
        np.testing.assert_array_equal(ps[f], ss[f][0], err_msg=f)
    for i in range(4):
        wa, wb = client_weights(plain, i), client_weights(one, i)
        for k in wa:
            np.testing.assert_array_equal(wa[k], wb[k], err_msg=(i, k))


@pytest.mark.parametrize("engine", [0, 1])
def test_streaming_empty_cohort_rounds_are_relay_noops(engine):
    """rate 0: nobody arrives, every round has no participant, and the
    relay state stays as it was, billing nothing."""
    tr = build_three("sharded:flat,2", n_clients=2, arrivals="stream:2,0,0.5",
                     reference=False)[engine]
    state0 = relay_state(tr)
    for _ in range(2):
        rec = tr.run_round()
        assert rec["participants"] == [] and rec["commits"] == []
        assert rec["comm_up"] == rec["comm_down"] == 0.0
    state1 = relay_state(tr)
    for f in state0:
        np.testing.assert_array_equal(state0[f], state1[f], err_msg=f)


def _trainer(which, fleet, mode="cors", hetero=False, n=2):
    """One trainer of the reference's ("ref") or the port's ("seq", "vec")
    on a small MLP fleet (mixed widths with `hetero`)."""
    parts, test = _data(n)
    kinds = [i % 2 if hetero else 0 for i in range(n)]
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jparams = [jmlp.init_mlp(k, hidden=96 if kind else 64)
               for kind, k in zip(kinds, keys)]
    if which == "ref":
        return jcollab.CollabTrainer(
            [J_SPECS[k] for k in kinds], jparams, parts, test,
            JCollabConfig(**_kw(mode)), JTrainConfig(batch_size=16),
            fleet=JFleetConfig(**fleet))
    tparams = [convert.params_from_jax(
        {k: np.asarray(v) for k, v in p.items()}, "mlp", device="cpu")
        for p in jparams]
    cls = tcollab.CollabTrainer if which == "seq" else \
        tvec.VectorizedCollabTrainer
    return cls([T_SPECS[k] for k in kinds], tparams, parts, test,
               CollabConfig(**_kw(mode)), TrainConfig(batch_size=16),
               fleet=FleetConfig(**fleet), device="cpu")


@pytest.mark.parametrize("fleet,mode,hetero", [
    (dict(participation="uniform_k:2"), "cors", False),
    (dict(clock="lognormal:2"), "cors", False),
    (dict(download_clock="lognormal:1"), "cors", False),
    ({}, "il", False),
    ({}, "cors", True)])
def test_streaming_composition_guards(fleet, mode, hetero):
    """The reference's five refusals, in both port engines, word for word;
    an upload clock with D_max = 0 is the synchronous fleet and runs."""
    fleet = dict(fleet, policy="flat", arrivals="stream:2")
    with pytest.raises(ValueError) as want:
        _trainer("ref", fleet, mode, hetero)
    for which in ("seq", "vec"):
        with pytest.raises(ValueError) as got:
            _trainer(which, fleet, mode, hetero)
        assert str(got.value) == str(want.value)


def test_streaming_accepts_a_delay0_clock_and_refuses_a_mesh():
    """As in the reference: the sequential engine refuses a mesh, in the
    reference's words, and the vectorized one runs a streaming fleet on a
    client mesh (here one rank), record for record as without it."""
    for which in ("seq", "vec"):
        t = _trainer(which, dict(arrivals="stream:2", clock="homogeneous:0"))
        t.run_round()
    with one_rank_mesh() as mesh:
        with pytest.raises(ValueError, match="sequential oracle.*host-side"):
            _trainer("seq", dict(arrivals="stream:2", mesh=mesh))
        plain = _trainer("vec", dict(arrivals="stream:2"))
        meshed = _trainer("vec", dict(arrivals="stream:2", mesh=mesh))
        for _ in range(2):
            assert plain.run_round() == meshed.run_round()


@pytest.mark.slow
@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("S", [1, 4])
def test_sharded_full_matrix(inner, S):
    run_three(build_three(f"sharded:{inner},{S}", schedule="uniform_k:2"))


@pytest.mark.slow
def test_streaming_unsharded_policy():
    """Arrivals do not need shards: a plain relay evicts as well."""
    trainers = build_three("staleness", n_clients=3,
                           arrivals="stream:2,2.0,0.4,5,1")
    run_three(trainers, rounds=6)
    _same_cohorts(*trainers, 6)
