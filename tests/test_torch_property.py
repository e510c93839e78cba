"""Twins of tests/test_property.py on the port: each of the reference's 18
hypothesis properties, stated on the port's functions, for at least the
reference's 25 generated examples (`deadline=None`).

Each twin is also held equal to the reference wherever the reference has
the function: integers and booleans exactly, floats at the tolerance the
test states. Where the reference's function is plain Python or numpy
(the comm formulas and ledger, the roofline solver, the commit mirror,
the cohort table) it is called on every example. Where it runs JAX ops,
which compile anew for each new shape, it is called on the examples
listed in the test's `@example`s only (REF cases), so that the file stays
cheap; the port alone runs on the generated ones.

Inputs come from numpy (the port has no `jax.random`): where the
reference drew them with JAX keys, the twin draws the same shapes and
ranges from a numpy generator seeded by the example.
"""
import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis import example, given, settings, strategies as st

from repro import relay as jrelay
from repro.core import comm as jcomm, losses as jlosses
from repro.core import prototypes as jproto
from repro.launch import roofline as jroofline
from repro.optim import cosine_schedule as jcosine
from repro.relay import history as jhistory, shards as jshards
from repro.sim import population as jpop
from repro.types import CollabConfig as JCollab
from repro_torch import relay
from repro_torch.core import comm, losses, prototypes
from repro_torch.launch import roofline
from repro_torch.optim import cosine_schedule
from repro_torch.relay import events, history, shards
from repro_torch.sim import population as pop_lib
from repro_torch.types import CollabConfig

SET = dict(max_examples=25, deadline=None)
FLOAT_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def ref_case(cases, **kw):
    """Whether this example is one of the test's REF cases."""
    return kw in cases


def examples(cases):
    """The REF cases as hypothesis `@example`s."""
    def wrap(fn):
        for c in reversed(cases):
            fn = example(**c)(fn)
        return fn
    return wrap


def _proto_inputs(rng, n, C):
    return (rng.standard_normal((n, 4)).astype(np.float32),
            rng.integers(0, C, n).astype(np.int32))


MERGE = [dict(n1=1, n2=30, C=2, seed=0), dict(n1=17, n2=5, C=8, seed=9)]


@given(n1=st.integers(1, 30), n2=st.integers(1, 30), C=st.integers(2, 8),
       seed=st.integers(0, 2**31 - 1))
@examples(MERGE)
@settings(**SET)
def test_proto_merge_associative_commutative(n1, n2, C, seed):
    """Port: merge commutes and associates (sums within 1e-5, counts
    exact). REF cases: each accumulated state and merge equal to the
    reference's on the same inputs (sums 1e-5, counts exact)."""
    rng = np.random.default_rng(seed)
    ins = [_proto_inputs(rng, n, C) for n in (n1, n2, 5)]
    a, b, c = (prototypes.accumulate(prototypes.init_state(C, 4, "cpu"),
                                     _t(f), _t(y)) for f, y in ins)
    ab, ba = prototypes.merge(a, b), prototypes.merge(b, a)
    np.testing.assert_allclose(ab.sum, ba.sum, atol=1e-5)
    assert torch.equal(ab.count, ba.count)
    left = prototypes.merge(prototypes.merge(a, b), c)
    right = prototypes.merge(a, prototypes.merge(b, c))
    np.testing.assert_allclose(left.sum, right.sum, atol=1e-5)
    assert torch.equal(left.count, right.count)
    if ref_case(MERGE, n1=n1, n2=n2, C=C, seed=seed):
        ja, jb, jc = (jproto.accumulate(jproto.init_state(C, 4),
                                        jnp.asarray(f), jnp.asarray(y))
                      for f, y in ins)
        jl = jproto.merge(jproto.merge(ja, jb), jc)
        for got, want in ((a, ja), (b, jb), (left, jl)):
            np.testing.assert_allclose(got.sum.numpy(), np.asarray(want.sum),
                                       atol=FLOAT_TOL)
            np.testing.assert_array_equal(got.count.numpy(),
                                          np.asarray(want.count))


def _disc_inputs(rng, B, C, d, scale=1.0):
    return (rng.standard_normal((B, d)).astype(np.float32) * scale,
            rng.standard_normal((C, d)).astype(np.float32) * scale,
            rng.integers(0, C, B).astype(np.int32),
            rng.standard_normal((d, C)).astype(np.float32))


DISC = [dict(B=1, C=2, seed=1, scale=0.1), dict(B=8, C=12, seed=7,
                                                scale=5.0)]


@given(B=st.integers(1, 8), C=st.integers(2, 12),
       seed=st.integers(0, 2**31 - 1), scale=st.floats(0.1, 5.0))
@examples(DISC)
@settings(**SET)
def test_disc_loss_nonnegative_and_finite(B, C, seed, scale):
    """Port: L_disc finite and >= 0. REF cases: equal to the reference's
    within 1e-5 relative (float32, summed in another order)."""
    f, o, y, w = _disc_inputs(np.random.default_rng(seed), B, C, 6, scale)
    l = float(losses.disc_loss(_t(f), _t(o), _t(y), _t(w)))
    assert np.isfinite(l) and l >= 0.0
    if ref_case(DISC, B=B, C=C, seed=seed, scale=scale):
        want = float(jlosses.disc_loss(jnp.asarray(f), jnp.asarray(o),
                                       jnp.asarray(y), jnp.asarray(w)))
        assert abs(l - want) <= FLOAT_TOL * max(1.0, abs(want)), (l, want)


MI = [dict(B=1, C=2, seed=3), dict(B=6, C=10, seed=11)]


@given(B=st.integers(1, 6), C=st.integers(2, 10),
       seed=st.integers(0, 2**31 - 1))
@examples(MI)
@settings(**SET)
def test_mi_bound_never_exceeds_logK(B, C, seed):
    """Theorem 1 sanity on the port: log K - L_disc <= log K. REF cases:
    the bound equal to the reference's within 1e-5."""
    f, o, y, w = _disc_inputs(np.random.default_rng(seed), B, C, 4)
    l = losses.disc_loss(_t(f), _t(o), _t(y), _t(w))
    bound = float(losses.mi_lower_bound(l, C - 1))
    assert bound <= np.log(C - 1) + 1e-6
    if ref_case(MI, B=B, C=C, seed=seed):
        jl = jlosses.disc_loss(jnp.asarray(f), jnp.asarray(o),
                               jnp.asarray(y), jnp.asarray(w))
        want = float(jlosses.mi_lower_bound(jl, C - 1))
        assert abs(bound - want) <= FLOAT_TOL * max(1.0, abs(want))


@given(C=st.integers(2, 100), d=st.integers(1, 512),
       m_up=st.integers(1, 4), m_down=st.integers(1, 4),
       N=st.integers(2, 50))
@settings(**SET)
def test_comm_cors_linear_in_C_d(C, d, m_up, m_down, N):
    """Port: CoRS floats linear in C and d; equal to the reference's
    integers on every example."""
    up, down = comm.cors_round_floats(C, d, m_up, m_down, N)
    assert up == N * (m_up + 1) * C * d
    assert down == N * (m_down + 1) * C * d
    up2, _ = comm.cors_round_floats(2 * C, d, m_up, m_down, N)
    assert up2 == 2 * up
    assert (up, down) == jcomm.cors_round_floats(C, d, m_up, m_down, N)


@given(model_size=st.integers(10**4, 10**10), N=st.integers(2, 20),
       C=st.integers(2, 1000), d=st.integers(8, 4096))
@settings(**SET)
def test_cors_beats_fedavg_when_model_large(model_size, N, C, d):
    """Port: CoRS volume independent of the model size; both formulas
    equal to the reference's on every example."""
    cors_up, _ = comm.cors_round_floats(C, d, 1, 1, N)
    fl_up, _ = comm.fedavg_round_floats(model_size, N)
    if model_size > 2 * C * d:
        assert cors_up < fl_up
    assert comm.fedavg_round_floats(model_size, N) == \
        jcomm.fedavg_round_floats(model_size, N)
    assert comm.cors_round_floats(C, d, 1, 1, N) == \
        jcomm.cors_round_floats(C, d, 1, 1, N)


COSINE = [dict(step=0), dict(step=100), dict(step=5_000)]


@given(step=st.integers(0, 10_000))
@examples(COSINE)
@settings(**SET)
def test_cosine_schedule_bounds(step):
    """Port: 0 <= lr <= base. REF cases: equal to the reference's within
    1e-6 relative (float32 cos)."""
    lr = float(cosine_schedule(torch.tensor(step), base_lr=1e-3, warmup=100,
                               total=10_000))
    assert 0.0 <= lr <= 1e-3 + 1e-9
    if ref_case(COSINE, step=step):
        want = float(jcosine(jnp.asarray(step), base_lr=1e-3, warmup=100,
                             total=10_000))
        assert abs(lr - want) <= 1e-6 * want + 1e-12, (lr, want)


@given(a=st.floats(0.1, 10), b=st.floats(0.1, 10), c=st.floats(0.1, 10),
       n1=st.integers(1, 50), n2=st.integers(1, 50))
@settings(**SET)
def test_roofline_linear_solver_recovers_exact(a, b, c, n1, n2):
    """Port: the solver recovers an exact linear model; coefficients and
    the evaluation equal to the reference's (numpy both) on every
    example, within 1e-12 relative."""
    names = ["x", "y"]
    counts = [{"x": 1, "y": 1}, {"x": 2, "y": 1}, {"x": 1, "y": 2}]
    vals = [a + b * ct["x"] + c * ct["y"] for ct in counts]
    coefs = roofline.solve_linear(counts, names, vals)
    got = roofline.evaluate_linear(coefs, {"x": n1, "y": n2})
    np.testing.assert_allclose(got, a + b * n1 + c * n2, rtol=1e-6)
    jc = jroofline.solve_linear(counts, names, vals)
    assert coefs.keys() == jc.keys()
    for k in jc:
        np.testing.assert_allclose(coefs[k], jc[k], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        got, jroofline.evaluate_linear(jc, {"x": n1, "y": n2}), rtol=1e-12)


HULL = [dict(seed=2, n=2, C=2), dict(seed=5, n=40, C=6)]


@given(seed=st.integers(0, 2**31 - 1), n=st.integers(2, 40),
       C=st.integers(2, 6))
@examples(HULL)
@settings(**SET)
def test_observation_within_feature_hull(seed, n, C):
    """Port: observations are averages, inside the per-dim hull of the
    features. REF cases: with the reference's priorities (its
    `jax.random.uniform` draw of the key), obs within 1e-6 and valid
    exactly the reference's."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, 3)).astype(np.float32)
    y = rng.integers(0, C, n).astype(np.int32)
    prio = rng.random((1, n)).astype(np.float32)
    obs, valid = prototypes.observations(_t(prio), _t(f), _t(y), C, n_avg=3)
    lo, hi = f.min(axis=0), f.max(axis=0)
    v = valid.numpy()
    o = obs[0].numpy()[v]
    assert (o >= lo[None] - 1e-5).all() and (o <= hi[None] + 1e-5).all()
    if ref_case(HULL, seed=seed, n=n, C=C):
        import jax
        key = jax.random.PRNGKey(seed)
        jo, jv = jproto.observations(key, jnp.asarray(f), jnp.asarray(y), C,
                                     n_avg=3)
        jprio = np.stack([np.asarray(jax.random.uniform(k, (n,)))
                          for k in jax.random.split(key, 1)])
        to, tv = prototypes.observations(_t(jprio), _t(f), _t(y), C, n_avg=3)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


RING = [dict(cap=2, k=8, C=2, seed=0), dict(cap=8, k=5, C=5, seed=3)]


@given(cap=st.integers(2, 8), k=st.integers(1, 8), C=st.integers(2, 5),
       seed=st.integers(0, 2**31 - 1))
@examples(RING)
@settings(**SET)
def test_per_class_ring_wraparound(cap, k, C, seed):
    """Port: each class's pointer advances by its own masked write count
    mod cap_c and the writes land in consecutive slots. REF cases: the
    ring (obs, age, valid, owner, ptr) equal to the reference's after the
    same append, exactly."""
    k_in = k
    k = min(k, cap)                               # per-append contract
    rng = np.random.default_rng(seed)
    pol = relay.PerClassRelay()
    state = pol.init_state(CollabConfig(num_classes=C, d_feature=2,
                                        m_down=1), 2, seed=0, capacity=cap,
                           device="cpu")
    ptr0 = state.ptr.numpy().copy()
    valid_rows = rng.random((k, C)) < 0.7
    row_mask = rng.random((k,)) < 0.7
    obs_rows = np.arange(1, k + 1, dtype=np.float32)[:, None, None] \
        * np.ones((k, C, 2), np.float32)
    owners = np.arange(k, dtype=np.int32)
    state = pol.append(state, _t(obs_rows), _t(valid_rows), _t(owners),
                       row_mask=_t(row_mask))
    w = valid_rows & row_mask[:, None]
    np.testing.assert_array_equal(state.ptr.numpy(),
                                  (ptr0 + w.sum(axis=0)) % cap)
    obs, age, valid = (state.obs.numpy(), state.age.numpy(),
                       state.valid.numpy())
    for c in range(C):
        for j, r in enumerate(np.nonzero(w[:, c])[0]):
            slot = (ptr0[c] + j) % cap
            np.testing.assert_allclose(obs[c, slot], float(r + 1))
            assert age[c, slot] == 0 and bool(valid[c, slot])
    if ref_case(RING, cap=cap, k=k_in, C=C, seed=seed):
        jpol = jrelay.PerClassRelay()
        js = jpol.init_state(JCollab(num_classes=C, d_feature=2, m_down=1),
                             2, seed=0, capacity=cap)
        js = jpol.append(js, jnp.asarray(obs_rows), jnp.asarray(valid_rows),
                         jnp.asarray(owners), row_mask=jnp.asarray(row_mask))
        for f in ("obs", "age", "valid", "owner", "ptr"):
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(js, f)), f)


@given(n=st.integers(1, 6), d_max=st.integers(1, 5), rounds=st.integers(2, 12),
       seed=st.integers(0, 2**31 - 1))
@settings(**SET)
def test_event_log_commit_order_monotone_and_conserving(n, d_max, rounds,
                                                        seed):
    """Port's `CommitMirror`: commits in event order (ties by upload
    position), each within d_max rounds of its birth, exactly once, and
    drained; every round's commits equal the reference's mirror's on
    every example (host Python both)."""
    rng = np.random.default_rng(seed)
    mirror, jmirror = events.CommitMirror(), jrelay.events.CommitMirror()
    order = list(rng.permutation(n))
    pos = {c: i for i, c in enumerate(order)}
    born = committed = 0
    for t in range(rounds + d_max):
        active = t < rounds
        mask = rng.random(n) < 0.6 if active else np.zeros(n, bool)
        delays = rng.integers(0, d_max + 1, n)
        born += int(mask.sum()) if active else 0
        commits = mirror.step(t, mask, delays, order)
        assert commits == jmirror.step(t, mask, delays, order)
        births = [b for b, _ in commits]
        assert births == sorted(births)
        for (b1, c1), (b2, c2) in zip(commits, commits[1:]):
            if b1 == b2:
                assert pos[c1] < pos[c2]
        for b, _ in commits:
            assert t - d_max <= b <= t
        committed += len(commits)
    assert committed == born


PENDING = [dict(d_max=1, rounds=2, seed=4), dict(d_max=3, rounds=3, seed=8)]


@given(d_max=st.integers(1, 4), rounds=st.integers(1, 14),
       seed=st.integers(0, 2**31 - 1))
@examples(PENDING)
@settings(**SET)
def test_pending_buffer_wraparound_at_dmax(d_max, rounds, seed):
    """Port's `commit_and_park`: the slot about to be reused holds no entry
    still in flight beyond the round, live entries commit within D_max,
    and the buffer drains. REF cases: the pending buffer's live, commit
    and birth equal to the reference's after every round, exactly."""
    rng = np.random.default_rng(seed)
    N, C, d = 3, 2, 2
    pol = relay.FlatRelay()
    ccfg = dict(num_classes=C, d_feature=d, m_up=1, m_down=1)
    rstate = pol.init_state(CollabConfig(**ccfg), d, seed=0,
                            capacity=8 * N, device="cpu")
    pending = events.init_pending(N, d_max, 1, C, d, device="cpu")
    ref = ref_case(PENDING, d_max=d_max, rounds=rounds, seed=seed)
    if ref:
        jpol = jrelay.FlatRelay()
        js = jpol.init_state(JCollab(**ccfg), d, seed=0, capacity=8 * N)
        jpend = jrelay.events.init_pending(N, d_max, 1, C, d)
    owner = np.arange(N, dtype=np.int32)
    for t in range(rounds + d_max):
        active = t < rounds
        mask = rng.random(N) < 0.7 if active else np.zeros(N, bool)
        delays = rng.integers(0, d_max + 1, N).astype(np.int32)
        slot = t % d_max
        assert not (pending.live[:, slot]
                    & (pending.commit[:, slot] > t)).any()
        fresh = {"obs": rng.normal(size=(N, 1, C, d)).astype(np.float32),
                 "valid": np.ones((N, C), bool),
                 "psum": np.zeros((N, C, d), np.float32),
                 "pcnt": np.ones((N, C), np.float32), "owner": owner}
        rstate, pending = events.commit_and_park(
            pol, rstate, pending, {k: _t(v) for k, v in fresh.items()},
            torch.tensor(t, dtype=torch.int32), _t(delays), _t(mask))
        live, commit = pending.live.numpy(), pending.commit.numpy()
        assert (commit[live] > t).all() and (commit[live] <= t + d_max).all()
        if ref:
            js, jpend = jrelay.events.commit_and_park(
                jpol, js, jpend, {k: jnp.asarray(v) for k, v in fresh.items()},
                jnp.asarray(t, jnp.int32), jnp.asarray(delays),
                jnp.asarray(mask))
            for f in ("live", "commit", "birth"):
                np.testing.assert_array_equal(getattr(pending, f).numpy(),
                                              np.asarray(getattr(jpend, f)))
    assert not pending.live.any()


class Snap(NamedTuple):
    """A snapshot as the port's relay states are: a NamedTuple of tensors."""
    v: torch.Tensor


HIST = [dict(h_max=1, pushes=0, d=0), dict(h_max=5, pushes=12, d=8),
        dict(h_max=3, pushes=2, d=1)]


@given(h_max=st.integers(1, 5), pushes=st.integers(0, 12),
       d=st.integers(0, 8))
@examples(HIST)
@settings(**SET)
def test_history_ring_wraparound_at_hmax(h_max, pushes, d):
    """Port's history ring: `read_at(d)` is exactly the snapshot d pushes
    ago for d <= H_max - 1, clamped deeper, the init snapshot before the
    run reaches it, and the ring never grows. REF cases: the snapshot
    read equal to the reference's, exactly."""
    snap = lambda v: Snap(torch.full((2,), v, dtype=torch.float32))
    hist = history.init(snap(0.0), h_max)
    for t in range(1, pushes + 1):
        hist = history.push(hist, snap(float(t)))
    expect = max(pushes - min(d, h_max - 1), 0)
    got = history.read_at(hist, torch.tensor(d)).v.numpy()
    np.testing.assert_array_equal(got, float(expect))
    assert hist.h_max == h_max
    if ref_case(HIST, h_max=h_max, pushes=pushes, d=d):
        jsnap = lambda v: {"v": jnp.full((2,), v, jnp.float32)}
        jh = jhistory.init(jsnap(0.0), h_max)
        for t in range(1, pushes + 1):
            jh = jhistory.push(jh, jsnap(float(t)))
        np.testing.assert_array_equal(
            got, np.asarray(jhistory.read_at(jh, jnp.asarray(d))["v"]))


@given(rounds=st.integers(1, 8), N=st.integers(1, 6),
       seed=st.integers(0, 2**31 - 1))
@settings(**SET)
def test_downlink_billing_conserved_under_delay_maps(rounds, N, seed):
    """Port's ledger: downlink billed at read, so any two download-delay
    maps give bit-identical per-round ledgers and the downlink total is
    sum_t |present_t| (M_down + 1) C d'; the rounds' floats equal the
    reference's `round_floats` on every example."""
    rng = np.random.default_rng(seed)
    masks = rng.random((rounds, N)) < 0.6
    C, d, m_up, m_down = 5, 3, 1, 2
    per_down = (m_down + 1) * C * d
    ledgers = []
    for _ in range(2):
        rng.integers(0, 4, (rounds, N))           # a delay map, never billed
        led, jled = comm.CommLedger(), jcomm.CommLedger()
        for t in range(rounds):
            n_present = int(masks[t].sum())
            kw = dict(n_present=n_present, C=C, d=d, m_up=m_up,
                      m_down=m_down, n_read=n_present)
            up, down = comm.round_floats("cors", **kw)
            assert (up, down) == jcomm.round_floats("cors", **kw)
            led.log_round(up, down)
            jled.log_round(up, down)
        assert led.down_floats == per_down * int(masks.sum())
        assert led.by_round == jled.by_round
        ledgers.append(led)
    assert ledgers[0].by_round == ledgers[1].by_round


STALE = [dict(cap=1, lam=0.0, seed=0), dict(cap=32, lam=4.0, seed=6),
         dict(cap=7, lam=0.5, seed=13)]


@given(cap=st.integers(1, 32), lam=st.floats(0.0, 4.0),
       seed=st.integers(0, 2**31 - 1))
@examples(STALE)
@settings(**SET)
def test_staleness_weights_normalize(cap, lam, seed):
    """Port: the staleness distribution sums to 1 over the pool, is 0
    outside it and never weights an older slot above a fresher one. REF
    cases: equal to the reference's weights within 1e-6."""
    rng = np.random.default_rng(seed)
    age = rng.integers(0, 100, cap).astype(np.int32)
    pool = rng.random(cap) < 0.6
    if not pool.any():
        pool[rng.integers(0, cap)] = True
    w = relay.staleness_weights(_t(age), _t(pool), lam).numpy()
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-5)
    assert (w[~pool] == 0.0).all()
    inpool = np.nonzero(pool)[0]
    for i in inpool:
        for j in inpool:
            if age[i] < age[j]:
                assert w[i] >= w[j] - 1e-7
    if ref_case(STALE, cap=cap, lam=lam, seed=seed):
        want = np.asarray(jrelay.staleness_weights(
            jnp.asarray(age), jnp.asarray(pool), lam))
        np.testing.assert_allclose(w, want, atol=1e-6)


def _same_view(v, jv):
    for f in ("seat_ids", "active", "mask", "evicted"):
        np.testing.assert_array_equal(getattr(v, f), getattr(jv, f), f)


@given(seed=st.integers(0, 2**31 - 1), seats=st.integers(1, 6),
       k=st.integers(1, 4), rate=st.floats(0.0, 4.0),
       p_leave=st.floats(0.0, 1.0), population=st.integers(1, 60),
       rounds=st.integers(1, 15))
@settings(**SET)
def test_cohort_table_invariants(seed, seats, k, rate, p_leave, population,
                                 rounds):
    """Port's seat table: only active seats participate (k of the
    active), every seated id holds one seat in the id space, a free seat
    is never active, an evicted owner was seated before; every round's
    view and the drop count equal the reference's table's on every
    example (numpy both)."""
    spec = dict(k=k, rate=rate, p_leave=p_leave, population=population,
                seed=seed)
    t = pop_lib.StreamingPopulation(**spec).table(seats)
    jt = jpop.StreamingPopulation(**spec).table(seats)
    seated_ever = set()
    for r in range(rounds):
        v = t.round(r)
        _same_view(v, jt.round(r))
        assert not (v.mask & ~v.active).any()
        assert int(v.mask.sum()) == min(k, int(v.active.sum()))
        assert not v.active[v.seat_ids == pop_lib.FREE_SEAT].any()
        occ = v.seat_ids[v.seat_ids != pop_lib.FREE_SEAT]
        assert len(set(occ.tolist())) == occ.size
        assert ((occ >= 0) & (occ < population)).all()
        ev = v.evicted.tolist()
        assert len(set(ev)) == len(ev)
        for e in ev:
            assert e in seated_ever
        seated_ever.update(occ.tolist())
    assert t.dropped == jt.dropped


@given(seed=st.integers(0, 2**31 - 1), seats=st.integers(1, 5),
       k=st.integers(1, 4), rate=st.floats(0.0, 5.0),
       population=st.integers(1, 60), rounds=st.integers(1, 15))
@settings(**SET)
def test_lru_never_evicts_an_active_owner(seed, seats, k, rate, population,
                                          rounds):
    """Port: with p_leave = 0 nobody departs, so no owner is ever evicted
    and excess arrivals are dropped; views and drops equal the
    reference's on every example."""
    spec = dict(k=k, rate=rate, p_leave=0.0, population=population,
                seed=seed)
    t = pop_lib.StreamingPopulation(**spec).table(seats)
    jt = jpop.StreamingPopulation(**spec).table(seats)
    for r in range(rounds):
        v = t.round(r)
        _same_view(v, jt.round(r))
        assert v.evicted.size == 0
    assert t.dropped >= 0 and t.dropped == jt.dropped


EVICT = [dict(policy="flat", cap=2, k=6, n_ids=1, seed=0),
         dict(policy="per_class", cap=8, k=4, n_ids=5, seed=3),
         dict(policy="staleness", cap=5, k=5, n_ids=3, seed=12)]


@given(policy=st.sampled_from(["flat", "per_class", "staleness"]),
       cap=st.integers(2, 8), k=st.integers(1, 6), n_ids=st.integers(1, 5),
       seed=st.integers(0, 2**31 - 1))
@examples(EVICT)
@settings(**SET)
def test_evict_owners_conserves_other_slots(policy, cap, k, n_ids, seed):
    """Port's `evict_owners`, every ring layout: exactly the victims'
    slots freed (owner EMPTY, valid cleared), every other slot, the
    pointers and the seed slots untouched. REF cases: owner, valid and
    ptr before and after equal to the reference's, exactly."""
    k_in = k
    k = min(k, cap)
    rng = np.random.default_rng(seed)
    pol = relay.get_policy(policy)
    ccfg = dict(num_classes=3, d_feature=2, m_down=1)
    state = pol.init_state(CollabConfig(**ccfg), 2, seed=0, capacity=cap,
                           device="cpu")
    owners = rng.integers(0, n_ids, k).astype(np.int32)
    rows = rng.normal(size=(k, 3, 2)).astype(np.float32)
    state = pol.append(state, _t(rows), torch.ones(k, 3, dtype=torch.bool),
                       _t(owners))
    victims = np.unique(
        rng.integers(0, n_ids, max(1, n_ids // 2)).astype(np.int32))
    st2 = pol.evict_owners(state, _t(victims))
    o1, o2 = state.owner.numpy(), st2.owner.numpy()
    hit = np.isin(o1, victims)
    assert (o2[hit] == relay.EMPTY_OWNER).all()
    np.testing.assert_array_equal(o2[~hit], o1[~hit])
    v1, v2 = state.valid.numpy(), st2.valid.numpy()
    vhit = (hit if v1.shape == o1.shape
            else np.broadcast_to(hit[:, None], v1.shape))
    assert not v2[vhit].any()
    np.testing.assert_array_equal(v2[~vhit], v1[~vhit])
    np.testing.assert_array_equal(state.ptr.numpy(), st2.ptr.numpy())
    assert (o2 == relay.SEED_OWNER).sum() == (o1 == relay.SEED_OWNER).sum()
    if ref_case(EVICT, policy=policy, cap=cap, k=k_in, n_ids=n_ids,
                seed=seed):
        jpol = jrelay.get_policy(policy)
        js = jpol.init_state(JCollab(**ccfg), 2, seed=0, capacity=cap)
        js = jpol.append(js, jnp.asarray(rows), jnp.ones((k, 3), bool),
                         jnp.asarray(owners))
        js2 = jpol.evict_owners(js, jnp.asarray(victims))
        for got, want in ((state, js), (st2, js2)):
            for f in ("owner", "valid", "ptr"):
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              np.asarray(getattr(want, f)))


SHARD = [dict(ids=[0], S=1), dict(ids=[2**31 - 1, 5, 5, 123456789], S=16),
         dict(ids=list(range(32)), S=7)]


@given(ids=st.lists(st.integers(0, 2**31 - 1), min_size=1, max_size=32),
       S=st.integers(1, 16))
@examples(SHARD)
@settings(**SET)
def test_shard_hash_stable_in_range_and_elementwise(ids, S):
    """Port's `shard_of`: pure, in range and elementwise, on a tensor and
    on the host's ints alike. REF cases: equal to the reference's
    uint32 hash, exactly."""
    batch = torch.tensor(ids, dtype=torch.int32)
    a = shards.shard_of(batch, S).numpy()
    assert ((0 <= a) & (a < S)).all()
    np.testing.assert_array_equal(a, shards.shard_of(batch, S).numpy())
    one = np.asarray([int(shards.shard_of(torch.tensor(i, dtype=torch.int32),
                                          S)) for i in ids])
    np.testing.assert_array_equal(a, one)
    np.testing.assert_array_equal(a, shards.shard_of(np.asarray(ids), S))
    if ref_case(SHARD, ids=ids, S=S):
        np.testing.assert_array_equal(
            a, np.asarray(jshards.shard_of(jnp.asarray(ids, jnp.int32), S)))


def test_every_reference_property_has_a_twin():
    """One twin per property of tests/test_property.py, by name."""
    import os
    import re
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "test_property.py")) as f:
        ref_names = set(re.findall(r"^def (test_\w+)", f.read(), re.M))
    mine = {n for n in globals() if n.startswith("test_")}
    assert len(ref_names) == 18 and ref_names <= mine, ref_names - mine
    assert math.isfinite(SET["max_examples"]) and SET["max_examples"] >= 25
