"""Download lag in the port: clients read stale relay snapshots out of the
history ring (`repro_torch.relay.history`) in both of the port's engines,
against the reference's sequential engine; the port of
tests/test_download_lag.py.

The fleet and tolerances are tests/test_torch_async_relay.py's (4 MLP
clients, 192 samples, batch 16, 3 rounds, the reference's draws):
participants, commit lists, ledger, ring integers (and ages) exactly;
observations, prototypes and mean logits within 1e-4, weights within
1e-4, accuracies within 2e-2, metrics rtol 1e-3. After every lagged run
the vectorized engine's ring is held against the sequential engines'
snapshot lists at every depth, by the same bounds.

Tier-1 runs each policy and each download clock once (zipped); the full
policy x download clock x upload clock matrix carries the registered
`slow` marker, which tier-1 deselects. The fixtures
`shared_reference_jits` and `one_torch_thread` of
tests/test_torch_async_relay.py apply here too (that file says why). Port-only tests need no
tolerance: a download clock of delay 0 (H_max = 1, or a deeper ring never
read stale) is bit-identical to no download clock, and downlink billing
does not depend on the delays.
"""
import numpy as np
import pytest

from repro_torch import sim as tsim
from repro_torch.convert import relay_state_to_numpy as to_np
from repro_torch.relay import history as thistory
from test_torch_async_relay import (N_CLIENTS, NoShow, POLICIES,  # noqa: F401
                                    _same_runs, build_three, live_pending,
                                    one_torch_thread, run_three,
                                    shared_reference_jits)
from test_torch_relay_policies import relay_state, same_relay, state_fields

DL_CLOCKS = ["homogeneous:1", "lognormal:2", "periodic:2,3"]


def same_ring(ref, seq, vec):
    """vec's ring at every depth (past H_max - 1 too: the clamp) against
    the snapshot lists of the port's and (given) the reference's
    sequential engines."""
    h = vec._h_max
    assert seq._h_max == h
    for d in range(h + 2):
        snap = to_np(thistory.read_at(vec.hist, d))
        same_relay(to_np(seq._snapshot(d)), snap)
        if ref is not None:
            assert ref._h_max == h
            same_relay(state_fields(ref._snapshot(d)), snap)


def run_lagged(trainers, rounds=3):
    records = run_three(trainers, rounds)
    same_ring(*trainers)
    return records


def stale_reads(trainer, rounds=3):
    """(round, client) of every present client that read a snapshot older
    than its round-start state."""
    return [(r, i) for r in range(rounds)
            for i in np.nonzero(trainer.schedule.mask(r, N_CLIENTS))[0]
            if trainer.dl_clock.delays(r, N_CLIENTS)[i] > 0]


@pytest.mark.parametrize("policy,dl_clock", list(zip(POLICIES, DL_CLOCKS)))
def test_download_lag_engines_match_reference(policy, dl_clock):
    """The tier-1 diagonal of the policy x download clock matrix."""
    trainers = build_three(policy, download_clock=dl_clock)
    run_lagged(trainers)
    assert stale_reads(trainers[2])


@pytest.mark.slow
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dl_clock", DL_CLOCKS)
@pytest.mark.parametrize("clock", [None, "lognormal:2"])
def test_download_lag_full_matrix(policy, dl_clock, clock):
    run_lagged(build_three(policy, clock, dl_clock))


def test_upload_and_download_lag_compose():
    """Late commits and stale reads in one run: a client can train against
    an old snapshot while its own upload is still in flight."""
    trainers = build_three("staleness", "lognormal:2", "lognormal:2")
    records = run_lagged(trainers)
    assert stale_reads(trainers[2])
    assert any(c[0] < h["round"] - 1 for h in records for c in h["commits"])
    assert trainers[2]._async and trainers[2]._lagged


def test_download_lag_partial_participation_and_fd():
    """A variable-count schedule with fd's logit prototypes: only present
    clients read (and are billed), the ring advances every round."""
    trainers = build_three("flat", download_clock="periodic:2,3",
                           schedule="bernoulli:0.5", mode="fd")
    records = run_lagged(trainers)
    assert any(len(h["participants"]) < N_CLIENTS for h in records)


def test_download_lag_with_static_k_compaction():
    """Unlike upload lag, download lag keeps compaction: only participants
    read, so the (k, ...) block gathers their snapshot depths too."""
    trainers = build_three("flat", download_clock="lognormal:2",
                           schedule="uniform_k:2")
    assert trainers[2]._k_active == 2 and trainers[2]._lagged
    run_lagged(trainers)
    assert stale_reads(trainers[2])


def test_download_lag_hetero_buckets():
    """Two interleaved buckets read one shared ring."""
    trainers = build_three("staleness", download_clock="periodic:2,3",
                           hetero=True)
    assert trainers[2].hetero
    run_lagged(trainers)


def test_history_ring_matches_oracle_snapshots():
    """Full participation, every delay 0 on the uplink: one merge a round,
    so the snapshot d deep holds clock rounds - d. (Every lagged run above
    holds the ring against the reference's snapshots too.)"""
    seq, vec = build_three("per_class", download_clock="homogeneous:2",
                           reference=False)
    rounds = 4
    for _ in range(rounds):
        assert seq.run_round()["commits"] == vec.run_round()["commits"]
    same_ring(None, seq, vec)
    assert vec._h_max == 3
    for d in range(vec._h_max + 2):
        want = rounds - min(d, vec._h_max - 1)
        assert int(thistory.read_at(vec.hist, d).clock) == want
        assert int(seq._snapshot(d).clock) == want


@pytest.mark.parametrize("clock", [tsim.HomogeneousClock(0),
                                   tsim.HomogeneousClock(0, d_max=2)])
def test_delay0_download_clock_bit_identical_to_no_lag(clock):
    """H_max = 1, and a ring of 3 never read stale, go through the ring
    and are bit-identical to no download clock, in both engines."""
    for engine in (0, 1):
        a = build_three("staleness", download_clock=clock,
                        reference=False)[engine]
        b = build_three("staleness", reference=False)[engine]
        assert a._lagged and not b._lagged
        assert a._h_max == clock.d_max + 1
        _same_runs(a, b)


@pytest.mark.parametrize("engine", [0, 1])
def test_downlink_billed_at_read_invariant_to_delays(engine):
    """A stale read crosses the wire when it is served: the ledger of a
    lagged run equals the round-fresh run's, bit for bit."""
    a = build_three("flat", download_clock="lognormal:3",
                    reference=False)[engine]
    b = build_three("flat", reference=False)[engine]
    for _ in range(4):
        a.run_round()
        b.run_round()
    assert a.ledger.by_round == b.ledger.by_round
    assert a.ledger.total_bytes == b.ledger.total_bytes


@pytest.mark.parametrize("hetero", [False, True])
def test_ring_advances_in_a_round_nobody_trains(hetero):
    """A zero-participant round leaves the relay as it was and still
    pushes its (unchanged) state: the ring counts rounds, not merges."""
    seq, vec = build_three("flat", download_clock="homogeneous:2",
                           hetero=hetero, reference=False)
    for t in (seq, vec):
        t.run_round()
        t.schedule = NoShow()
        before = relay_state(t)
        rec = t.run_round()
        assert rec["participants"] == [] and rec["commits"] == []
        assert rec["comm_down"] == 0.0 and live_pending(vec) == 0
        after = relay_state(t)
        for f in before:
            np.testing.assert_array_equal(before[f], after[f], err_msg=f)
    assert int(vec.hist.head) == 2
    same_ring(None, seq, vec)
