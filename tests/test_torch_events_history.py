"""The port's asynchronous relay log (`repro_torch.relay.events`) and its
snapshot ring (`repro_torch.relay.history`) against the reference's, on the
same seeded inputs.

- `event_slot_order`: equal for every round index and depth.
- `commit_and_park`, round after round for 2 . D_max + 2 rounds (the
  pending slots wrap), for each policy (flat, per_class, staleness; flat
  also in fd, with the logit sums; cohort shards, whose per-position
  contributions go through `reduce_uploads`), D_max in {0, 1, 3}: the
  relay state's integer leaves (ptr, owner, valid, stamp, clock, valid_g,
  age, merges) and the
  pending buffer's live / birth / stamp / commit / valid exactly; their
  floats within 1e-6 (the reference sums the due parked prototypes with
  an einsum, the port with a weighted sum: another order of addition).
- `CommitMirror`: the commit lists equal the reference's, round by round.
- `stamp_now` / `host_stamps`: equal the reference's.
- `history.push` / `read_at`: every depth up to H_max + 2 (the clamp)
  equal to the reference's, before the ring has wrapped (slots still at
  the initial state) and after; a (k,) delay vector equals the
  reference's `read_at` under `vmap`. Exact: snapshots are copies.

The port's ops run on one CPU thread here (`one_torch_thread`, from
tests/test_torch_async_relay.py, which says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import relay as jrelay
from repro.core import prototypes as jp
from repro.relay import events as jevents, history as jhistory
from repro.types import CollabConfig as JCollabConfig
from repro_torch import relay as trelay
from repro_torch.core import prototypes as tp
from repro_torch.relay import events as tevents, history as thistory
from repro_torch.types import CollabConfig
from test_torch_async_relay import one_torch_thread  # noqa: F401
from test_torch_relay_policies import state_fields

INT_FIELDS = ("ptr", "owner", "valid", "stamp", "clock", "valid_g", "age",
              "merges")
PENDING_EXACT = ("live", "birth", "stamp", "commit", "valid")
C, D_FEAT, M_UP, N = 4, 6, 2, 3
UPLOAD_ORDER = np.array([2, 0, 1], np.int32)      # a mixed fleet's order
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _policies(name):
    return jrelay.get_policy(name), trelay.get_policy(name)


def _states(name, capacity=10):
    kw = dict(num_classes=C, d_feature=D_FEAT, m_up=M_UP, m_down=2)
    jpol, tpol = _policies(name)
    js = jpol.init_state(JCollabConfig(**kw), D_FEAT, seed=3,
                         capacity=capacity, n_clients=N)
    ts = tpol.init_state(CollabConfig(**kw), D_FEAT, seed=3,
                         capacity=capacity, n_clients=N, device="cpu")
    return jpol, tpol, js, ts


def same_state(js, ts, tol=TOL):
    sa, sb = state_fields(js), state_fields(ts)
    assert list(sa) == list(sb)
    for f in sa:
        a, b = sa[f], sb[f]
        if f in INT_FIELDS:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, atol=tol, rtol=0, err_msg=f)


def same_pending(jpend, tpend):
    for f in jpend._fields:
        a, b = getattr(jpend, f), getattr(tpend, f)
        if a is None:
            assert b is None, f
        elif f in PENDING_EXACT:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL,
                                       rtol=0, err_msg=f)


def _fresh(rng, fd):
    f = {"obs": rng.standard_normal((N, M_UP, C, D_FEAT)).astype(np.float32),
         "valid": rng.random((N, C)) > 0.25,
         "psum": rng.standard_normal((N, C, D_FEAT)).astype(np.float32),
         "pcnt": rng.integers(0, 5, (N, C)).astype(np.float32),
         "owner": UPLOAD_ORDER}
    if fd:
        f["lsum"] = rng.standard_normal((N, C, C)).astype(np.float32)
        f["lcnt"] = rng.integers(0, 5, (N, C)).astype(np.float32)
    return f


@pytest.mark.parametrize("d_max", [1, 3, 5])
def test_event_slot_order_equals_reference(d_max):
    for r in range(-1, 3 * d_max + 2):
        want = np.asarray(jevents.event_slot_order(jnp.int32(r), d_max))
        got = tevents.event_slot_order(torch.tensor(r, dtype=torch.int32),
                                       d_max)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert tevents.event_slot_order(r, d_max).tolist() == want.tolist()


@pytest.mark.parametrize("policy,fd", [("flat", False), ("flat", True),
                                       ("per_class", False),
                                       ("staleness", False),
                                       ("sharded:flat,2", False),
                                       ("sharded:flat,2", True),
                                       ("sharded:staleness,3", False)])
@pytest.mark.parametrize("d_max", [0, 1, 3])
def test_commit_and_park_equals_reference(policy, fd, d_max):
    """2 . D_max + 2 rounds of random uploads, delays and masks through both
    packages; the state and the pending buffer after every round."""
    jpol, tpol, js, ts = _states(policy)
    jpend = jevents.init_pending(N, d_max, M_UP, C, D_FEAT, fd=fd)
    tpend = tevents.init_pending(N, d_max, M_UP, C, D_FEAT, fd=fd,
                                 device="cpu")
    same_pending(jpend, tpend)
    rng = np.random.default_rng(11 + d_max)
    committed = 0
    for r in range(2 * d_max + 2):
        fresh = _fresh(rng, fd)
        delays = rng.integers(0, d_max + 1, N).astype(np.int32)
        mask = rng.random(N) > 0.2
        js, jpend = jevents.commit_and_park(
            jpol, js, jpend, {k: jnp.asarray(v) for k, v in fresh.items()},
            jnp.int32(r), jnp.asarray(delays), jnp.asarray(mask))
        ts, tpend = tevents.commit_and_park(
            tpol, ts, tpend, {k: _t(v) for k, v in fresh.items()},
            torch.tensor(r, dtype=torch.int32), _t(delays), _t(mask))
        same_state(js, ts)
        same_pending(jpend, tpend)
        committed = int(ts.clock.max())
    assert committed > 0
    if fd:
        assert float(ts.mean_logits.abs().max()) > 0


def test_pending_slots_wrap_without_collision():
    """Every client always delayed by D_max: round r commits exactly the
    uploads born in r - D_max, each slot is reused only after its entry
    committed, and the live count saturates at N . D_max."""
    d_max = 2
    jpol, tpol, js, ts = _states("staleness")
    jpend = jevents.init_pending(N, d_max, M_UP, C, D_FEAT)
    tpend = tevents.init_pending(N, d_max, M_UP, C, D_FEAT, device="cpu")
    rng = np.random.default_rng(0)
    delays = np.full((N,), d_max, np.int32)
    mask = np.ones((N,), bool)
    for r in range(2 * d_max + 3):
        before = tpend
        fresh = _fresh(rng, False)
        js, jpend = jevents.commit_and_park(
            jpol, js, jpend, {k: jnp.asarray(v) for k, v in fresh.items()},
            jnp.int32(r), jnp.asarray(delays), jnp.asarray(mask))
        ts, tpend = tevents.commit_and_park(
            tpol, ts, tpend, {k: _t(v) for k, v in fresh.items()},
            torch.tensor(r, dtype=torch.int32), _t(delays), _t(mask))
        same_state(js, ts)
        same_pending(jpend, tpend)
        slot = r % d_max
        # the slot written this round held the births of r - D_max, due now
        if r >= d_max:
            assert before.birth[:, slot].tolist() == [r - d_max] * N
            assert before.commit[:, slot].tolist() == [r] * N
        assert int(tpend.live.sum()) == N * min(r + 1, d_max)
        assert tpend.birth[:, slot].tolist() == [r] * N
        assert int(ts.clock) == max(0, r - d_max + 1)   # one merge a commit


def test_commit_mirror_equals_reference():
    rng = np.random.default_rng(4)
    jm, tm = jevents.CommitMirror(), tevents.CommitMirror()
    order = [2, 0, 3, 1]
    seen = 0
    for r in range(10):
        mask = rng.random(4) > 0.3
        delays = rng.integers(0, 4, 4)
        want = jm.step(r, mask, delays, order)
        got = tm.step(r, mask, delays, order)
        assert got == want
        seen += len(got)
        assert len(tm._q) == len(jm._q)
    assert seen > 0


@pytest.mark.parametrize("policy", ["flat", "per_class", "staleness"])
def test_stamps_equal_reference(policy):
    jpol, tpol, js, ts = _states(policy)
    proto = (jp.ProtoState(jnp.ones((C, D_FEAT)), jnp.ones((C,))),
             tp.ProtoState(torch.ones(C, D_FEAT), torch.ones(C)))
    for _ in range(3):
        js = jpol.merge_round(js, proto[0])
        ts = tpol.merge_round(ts, proto[1])
    owners = np.array([3, 0, 2], np.int32)
    want = np.asarray(jpol.stamp_now(js, jnp.asarray(owners)))
    got = tpol.stamp_now(ts, _t(owners))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpol.host_stamps(ts, owners.tolist()),
                                  jpol.host_stamps(js, owners.tolist()))
    assert tpol.host_stamps(ts, [1, 2]).tolist() == [3, 3]


def _merged_states(name, n_push, seed=0):
    """The initial state and `n_push` successors (an append and a merge
    each), in both packages."""
    jpol, tpol, js, ts = _states(name)
    rng = np.random.default_rng(seed)
    out = [(js, ts)]
    for r in range(n_push):
        obs = rng.standard_normal((2, C, D_FEAT)).astype(np.float32)
        valid = rng.random((2, C)) > 0.3
        own = np.array([r % N, (r + 1) % N], np.int32)
        f = rng.standard_normal((7, D_FEAT)).astype(np.float32)
        y = rng.integers(0, C, 7).astype(np.int32)
        js = jpol.merge_round(
            jpol.append(js, obs, valid, own),
            jp.accumulate(jp.init_state(C, D_FEAT), f, y))
        ts = tpol.merge_round(
            tpol.append(ts, _t(obs), _t(valid), _t(own)),
            tp.accumulate(tp.init_state(C, D_FEAT, "cpu"), _t(f), _t(y)))
        out.append((js, ts))
    return out


@pytest.mark.parametrize("policy", ["flat", "per_class", "staleness"])
@pytest.mark.parametrize("h_max", [1, 3])
def test_history_push_and_read_at_equal_reference(policy, h_max):
    states = _merged_states(policy, h_max + 3)
    jh = jhistory.init(states[0][0], h_max)
    th = thistory.init(states[0][1], h_max)
    assert th.h_max == h_max and th.head.dtype == torch.int32
    for n, (js, ts) in enumerate(states[1:], start=1):
        jh, th = jhistory.push(jh, js), thistory.push(th, ts)
        assert int(th.head) == int(jh.head)
        for d in range(h_max + 3):             # past H_max - 1: the clamp
            want = jhistory.read_at(jh, jnp.int32(d))
            for delay in (d, torch.tensor(d, dtype=torch.int32)):
                same_state(want, thistory.read_at(th, delay), tol=0.0)
            # before the ring is full, deep reads see the initial state
            if d >= n and d < h_max:
                same_state(states[0][0], thistory.read_at(th, d), tol=0.0)
        same_state(states[n][0], thistory.read_at(th, 0), tol=0.0)
        # one snapshot a client: the reference's read_at under vmap
        dl = np.array([0, h_max + 1, 1, h_max - 1, 2], np.int32)
        want = jax.vmap(lambda d: jhistory.read_at(jh, d))(jnp.asarray(dl))
        got = thistory.read_at(th, _t(dl))
        same_state(want, got, tol=0.0)
        assert got.obs.shape[0] == len(dl)


def test_history_ring_keeps_dtypes_and_refuses_zero_depth():
    (_, ts), (_, ts1) = _merged_states("staleness", 1)
    h = thistory.push(thistory.init(ts, 2), ts1)
    for f in ts._fields:
        assert getattr(h.snaps, f).dtype == getattr(ts, f).dtype, f
        assert getattr(h.snaps, f).shape == (2,) + getattr(ts, f).shape, f
    with pytest.raises(ValueError, match="depth"):
        thistory.init(ts, 0)
