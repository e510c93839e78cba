"""Asynchrony in the port: bounded-delay uploads committed in event order
(`repro_torch.relay.events`) in both of the port's engines, against the
reference's sequential engine; the port of tests/test_async_relay.py.

The fleet is that file's: 4 MLP clients, 192 samples, batch 16, 3 rounds
(mixed fleets: widths 64 and 96 interleaved, two buckets). The port draws
from the reference's key schedule (`JaxDraws`). Checked every round:
participants, commit lists ([birth, client] in event order), the ledger
and, after each round, the vectorized engine's live pending slots against
the sequential engines' queues, exactly; accuracies within 2e-2, metrics
rtol 1e-3 (atol 1e-4). At the end: ring integers (ptr, owner, valid,
stamp, clock, valid_g, age) exactly, observations, prototypes and mean
logits within 1e-4, weights within 1e-4.

Tier-1 runs each policy and each clock once (zipped); the full policy x
clock matrix carries the registered `slow` marker, which tier-1
deselects. Two module fixtures keep the file fast beside other test
processes: the reference's sequential engine jits one local update a
client and one upload function a trainer, and `shared_reference_jits`
hands every trainer of this process the same jitted functions for the
same (spec, configs), so each compiles once (the same programs, fewer
compilations); `one_torch_thread` runs the port's small CPU ops on one
thread, since idle intra-op threads spinning in several processes at
once slowed this file some tenfold. The port-only tests need no tolerance: a D_max = 0 clock (and
a clock forcing the pending buffer with every delay 0) is bit-identical
to no clock; a round with no commit leaves the relay as it was.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import relay as jrelay
from repro.core import client as jclient, collab as jcollab
from repro.core import prototypes as jp
from repro.data import partition, synthetic
from repro.models import mlp as jmlp
from repro.types import CollabConfig as JCollabConfig
from repro.types import FleetConfig as JFleetConfig
from repro.types import TrainConfig as JTrainConfig
from repro_torch import convert, relay as trelay, sim as tsim
from repro_torch.core import client as tclient, collab as tcollab
from repro_torch.core import prototypes as tp, vec_collab as tvec
from repro_torch.models import mlp as tmlp
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
from test_torch_collab import JaxDraws
from test_torch_relay_policies import (client_weights, relay_state,
                                       same_records, same_relay)

POLICIES = ["flat", "per_class", "staleness"]
CLOCKS = ["homogeneous:1", "lognormal:2", "periodic:2,3"]
N_CLIENTS = 4
TOL = 1e-4
HEAD = lambda p: (p["head_w"], p["head_b"])       # noqa: E731
# distinct spec objects for the two models of a mixed fleet
J_SPECS = [jclient.ClientSpec(apply=lambda p, x: jmlp.apply(p, x), head=HEAD)
           for _ in range(2)]
T_SPECS = [tclient.ClientSpec(apply=lambda p, x: tmlp.apply(p, x), head=HEAD)
           for _ in range(2)]


@pytest.fixture(autouse=True, scope="module")
def shared_reference_jits():
    with pytest.MonkeyPatch.context() as mp:
        for name in ("make_local_update", "make_compute_uploads"):
            mp.setattr(jclient, name,
                       functools.lru_cache(None)(getattr(jclient, name)))
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(n_clients):
    x, y = synthetic.class_images(192, seed=0, noise=0.4)
    tx, ty = synthetic.class_images(96, seed=9, noise=0.4)
    return partition.uniform_split(x, y, n_clients, seed=1), (tx, ty)


def _kw(mode):
    return dict(mode=mode, num_classes=10, d_feature=84, lambda_kd=2.0,
                lambda_disc=1.0 if mode == "cors" else 0.0)


def build_three(policy, clock=None, download_clock=None, schedule=None,
                mode="cors", hetero=False, n_clients=N_CLIENTS, seed=0,
                reference=True, arrivals=None):
    """(reference seq, port seq, port vec) on one MLP fleet, the port
    drawing from the reference's keys; without `reference`, the port's two
    engines only, with their own draws."""
    parts, test = _data(n_clients)
    kinds = [i % 2 if hetero else 0 for i in range(n_clients)]
    keys = jax.random.split(jax.random.PRNGKey(seed), n_clients)
    jparams = [jmlp.init_mlp(k, hidden=96 if kind else 64)
               for kind, k in zip(kinds, keys)]
    tparams = [convert.params_from_jax(
        {k: np.asarray(v) for k, v in p.items()}, "mlp", device="cpu")
        for p in jparams]
    fleet = dict(policy=policy, participation=schedule, clock=clock,
                 download_clock=download_clock, arrivals=arrivals)
    ports = [cls([T_SPECS[k] for k in kinds], tparams, parts, test,
                 CollabConfig(**_kw(mode)), TrainConfig(batch_size=16),
                 seed=seed, fleet=FleetConfig(**fleet), device="cpu",
                 draws=JaxDraws(seed, n_clients) if reference else None)
             for cls in (tcollab.CollabTrainer, tvec.VectorizedCollabTrainer)]
    if not reference:
        return ports
    ref = jcollab.CollabTrainer(
        [J_SPECS[k] for k in kinds], jparams, parts, test,
        JCollabConfig(**_kw(mode)), JTrainConfig(batch_size=16), seed=seed,
        fleet=JFleetConfig(**fleet))
    return [ref] + ports


def live_pending(vec):
    return int(vec.pending.live.sum()) if vec._async else 0


def run_three(trainers, rounds=3):
    """Runs the three engines side by side; -> the reference's records."""
    ref, seq, vec = trainers
    for _ in range(rounds):
        rj, rs, rv = (t.run_round() for t in trainers)
        same_records(rj, rs)
        same_records(rj, rv)
        assert live_pending(vec) == len(seq._queue) == len(ref._queue)
    for t in (seq, vec):
        assert t.ledger.by_round == ref.ledger.by_round
        assert t.ledger.total_bytes == ref.ledger.total_bytes
        same_relay(relay_state(ref), relay_state(t))
        for i in range(len(ref.clients)):
            wa, wb = client_weights(ref, i), client_weights(t, i)
            for k in wa:
                np.testing.assert_allclose(wb[k], wa[k], atol=TOL,
                                           err_msg=(i, k))
    return ref.history


def delayed_commits(records):
    return [c for h in records for c in h["commits"]
            if c[0] < h["round"] - 1]


@pytest.mark.parametrize("policy,clock", list(zip(POLICIES, CLOCKS)))
def test_async_engines_match_reference(policy, clock):
    """The tier-1 diagonal of the policy x clock matrix."""
    records = run_three(build_three(policy, clock))
    assert delayed_commits(records), [h["commits"] for h in records]


@pytest.mark.slow
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("clock", CLOCKS)
def test_async_full_matrix(policy, clock):
    run_three(build_three(policy, clock))


def test_async_fd_under_uniform_k_runs_full_width():
    """fd's delayed logit sums under a fixed-k schedule: the vectorized
    engine runs full width (the commits are not the participants'
    uploads) and still matches."""
    trainers = build_three("flat", "lognormal:2", schedule="uniform_k:3",
                           mode="fd")
    vec = trainers[2]
    assert vec._async and vec._k_active == N_CLIENTS
    records = run_three(trainers)
    assert delayed_commits(records)
    assert any(len(h["participants"]) == 3 for h in records)


def test_async_hetero_buckets():
    """Two interleaved buckets share ONE pending buffer, indexed by upload
    position: delayed commits land in bucket-event order."""
    trainers = build_three("staleness", "periodic:2,3", hetero=True)
    assert trainers[2].hetero
    records = run_three(trainers)
    assert delayed_commits(records)
    assert trainers[2]._upload_order == [0, 2, 1, 3]


def test_async_adaptive_schedule_is_bound_to_the_clock():
    """adaptive:0.5 boosts the stragglers of the trainer's own upload
    clock, in both engines as in the reference."""
    trainers = build_three("flat", "lognormal:2", schedule="adaptive:0.5")
    for t in trainers:
        assert t.schedule.clock is t.clock
    run_three(trainers)


def test_async_turns_compaction_off():
    """Under a fixed-k schedule an asynchronous fleet runs full width; a
    D_max = 0 clock is the synchronous fleet and stays compacted."""
    for clock, k_active in (("lognormal:2", N_CLIENTS),
                            ("homogeneous:0", 2), (None, 2)):
        seq, vec = build_three("flat", clock, schedule="uniform_k:2",
                               reference=False)
        assert vec._k_active == k_active
        assert vec._async == (k_active == N_CLIENTS)
        for _ in range(3):
            rs, rv = seq.run_round(), vec.run_round()
            assert rs["commits"] == rv["commits"]
            assert rs["participants"] == rv["participants"]
        same_relay(relay_state(seq), relay_state(vec))


def _same_runs(a, b, rounds=2):
    for _ in range(rounds):
        ra, rb = a.run_round(), b.run_round()
        for k in ("commits", "participants", "accs", "metrics", "comm_up",
                  "comm_down"):
            assert ra[k] == rb[k], k
    sa, sb = relay_state(a), relay_state(b)
    for f in sa:
        np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
    assert a.ledger.by_round == b.ledger.by_round
    for i in range(N_CLIENTS):
        wa, wb = client_weights(a, i), client_weights(b, i)
        for k in wa:
            np.testing.assert_array_equal(wa[k], wb[k], err_msg=(i, k))


@pytest.mark.parametrize("clock", [tsim.HomogeneousClock(0),
                                   tsim.HomogeneousClock(0, d_max=1)])
def test_dmax0_bit_identical_to_sync(clock):
    """A D_max = 0 clock is the synchronous fleet (no pending buffer), and
    a clock that forces the pending buffer with every delay 0 commits the
    same rows in the same order: records, ring, ledger and weights equal
    to no clock at all, bit for bit, in both engines."""
    for engine in (0, 1):
        a = build_three("staleness", clock, reference=False)[engine]
        b = build_three("staleness", None, reference=False)[engine]
        if engine:
            assert a._async == (clock.d_max > 0) and not b._async
        _same_runs(a, b)


@pytest.mark.parametrize("engine", [0, 1])
def test_zero_commit_round_is_relay_noop_and_bills_no_uplink(engine):
    """homogeneous:2 parks EVERY upload for 2 rounds: rounds 0-1 commit
    nothing (relay untouched, no uplink billed, downlink billed for the
    present clients); round 2 commits round 0's uploads."""
    tr = build_three("flat", "homogeneous:2", n_clients=3,
                     reference=False)[engine]
    state0 = relay_state(tr)
    ccfg = tr.ccfg
    down = (ccfg.m_down + 1) * ccfg.num_classes * ccfg.d_feature
    up = (ccfg.m_up + 1) * ccfg.num_classes * ccfg.d_feature
    for _ in range(2):
        rec = tr.run_round()
        assert rec["commits"] == [] and rec["comm_up"] == 0.0
        assert rec["comm_down"] == 3 * down
    state1 = relay_state(tr)
    for f in state0:
        np.testing.assert_array_equal(state0[f], state1[f], err_msg=f)
    rec = tr.run_round()
    assert rec["commits"] == [[0, 0], [0, 1], [0, 2]]
    assert rec["comm_up"] == 3 * up
    assert int(relay_state(tr)["clock"]) == 1


class NoShow(trelay.ParticipationSchedule):
    name = "noshow"

    def mask(self, round_idx, n_clients):
        return np.zeros((n_clients,), bool)


@pytest.mark.parametrize("engine", [0, 1])
def test_uplink_conserved_after_drain(engine):
    """Asynchrony moves uplink billing across rounds but never loses or
    invents floats: after the queue drains, the totals equal the
    synchronous run's."""
    a = build_three("flat", "lognormal:2", reference=False)[engine]
    b = build_three("flat", None, reference=False)[engine]
    for _ in range(4):
        a.run_round()
        b.run_round()
    a.schedule = NoShow()                  # no new births, only commits
    drained = 0
    while (len(a._queue) if engine == 0 else live_pending(a)):
        a.run_round()
        drained += 1
    assert 0 < drained <= a.clock.d_max
    assert a.ledger.up_floats == b.ledger.up_floats
    assert a.ledger.down_floats == b.ledger.down_floats


@pytest.mark.parametrize("policy", ["staleness", "per_class"])
def test_delayed_commit_arrives_preaged(policy):
    """A row born at clock c that commits after further merges enters with
    age = clock - c, not 0, and keeps its birth stamp; the same in the
    reference."""
    ccfg = dict(num_classes=3, d_feature=2, m_down=1)
    jpol, tpol = jrelay.get_policy(policy), trelay.get_policy(policy)
    js = jpol.init_state(JCollabConfig(**ccfg), 2, capacity=4)
    ts = tpol.init_state(CollabConfig(**ccfg), 2, capacity=4, device="cpu")
    jproto = jp.ProtoState(jnp.ones((3, 2)), jnp.ones((3,)))
    tproto = tp.ProtoState(torch.ones(3, 2), torch.ones(3))
    for _ in range(2):                               # clock 2
        js, ts = jpol.merge_round(js, jproto), tpol.merge_round(ts, tproto)
    row = (np.ones((1, 3, 2), np.float32), np.ones((1, 3), bool),
           np.array([7], np.int32), np.array([0], np.int32))   # born at 0
    js = jpol.append(js, *row[:3], stamp_rows=jnp.asarray(row[3]))
    ts = tpol.append(ts, *(torch.from_numpy(a) for a in row[:3]),
                     stamp_rows=torch.from_numpy(row[3]))
    at = (1,) if policy == "staleness" else (0, 1)   # the slot written
    assert int(ts.age[at]) == int(np.asarray(js.age)[at]) == 2
    js, ts = jpol.merge_round(js, jproto), tpol.merge_round(ts, tproto)
    assert int(ts.age[at]) == int(np.asarray(js.age)[at]) == 3
    assert int(ts.stamp[at]) == 0
    np.testing.assert_array_equal(ts.age.numpy(), np.asarray(js.age))
