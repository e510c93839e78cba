"""The port's prototypes, Adam and flat relay against the reference.

Integer relay state must match exactly and the initial ring bit for bit;
float statistics within 1e-5 (float32 sums in another order); Adam within
1e-6 over five steps (same operation order). Random draws are made with
`jax.random` from one key and handed to both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prototypes as jp
from repro.optim import optim as jopt
from repro.relay import base as jbase, flat as jflat
from repro.types import CollabConfig as JCollabConfig
from repro_torch.core import prototypes as tp
from repro_torch.optim import optim as topt
from repro_torch.relay import base as tbase, flat as tflat
from repro_torch.relay.server import RelayServer
from repro_torch.types import CollabConfig

TOL = dict(atol=1e-5, rtol=1e-5)
EXACT_FIELDS = ("ptr", "owner", "valid", "stamp", "clock")


def _t(a):
    return torch.from_numpy(np.array(a))


def _feats(n=60, d=12, C=5, seed=0, missing=None):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, C, n).astype(np.int32)
    if missing is not None:
        y[y == missing] = (missing + 1) % C
    return f, y


# -- prototypes ---------------------------------------------------------------
def test_accumulate_means_merge():
    C, d = 5, 12
    f1, y1 = _feats(seed=0, missing=3)
    f2, y2 = _feats(n=17, seed=1, missing=3)
    js = [jp.accumulate(jp.init_state(C, d), f, y) for f, y in ((f1, y1), (f2, y2))]
    ts = [tp.accumulate(tp.init_state(C, d, "cpu"), _t(f), _t(y))
          for f, y in ((f1, y1), (f2, y2))]
    jm, tm = jp.merge(*js), tp.merge(*ts)
    np.testing.assert_allclose(tm.sum.numpy(), np.asarray(jm.sum), **TOL)
    np.testing.assert_array_equal(tm.count.numpy(), np.asarray(jm.count))
    np.testing.assert_allclose(tp.means(tm).numpy(), np.asarray(jp.means(jm)),
                               **TOL)
    fb = np.full((C, d), 7.0, np.float32)
    np.testing.assert_allclose(tp.means(tm, _t(fb)).numpy(),
                               np.asarray(jp.means(jm, fb)), **TOL)


@pytest.mark.parametrize("m_up,n_avg", [(1, 10), (3, 4), (2, 50)])
def test_observations_with_reference_priorities(m_up, n_avg):
    C = 5
    f, y = _feats(seed=2, missing=4)
    key = jax.random.PRNGKey(7)
    jo, jv = jp.observations(key, jnp.asarray(f), jnp.asarray(y), C, n_avg,
                             m_up)
    prio = np.stack([np.asarray(jax.random.uniform(k, (f.shape[0],)))
                     for k in jax.random.split(key, m_up)])
    to, tv = tp.observations(_t(prio), _t(f), _t(y), C, n_avg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- Adam -------------------------------------------------------------------------
def test_adam_update_five_steps():
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 4), "b": (4,), "c": (2, 3, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jparams, jstate = params, jopt.adam_init(params)
    tparams = {k: _t(v) for k, v in params.items()}
    tstate = topt.adam_init(tparams)
    for step in range(5):
        grads = {k: (rng.standard_normal(s) * 10 ** -step).astype(np.float32)
                 for k, s in shapes.items()}
        jparams, jstate = jopt.adam_update(jparams, grads, jstate, lr=1e-2)
        tparams, tstate = topt.adam_update(tparams,
                                           {k: _t(g) for k, g in grads.items()},
                                           tstate, lr=1e-2)
    assert tstate.step == int(jstate.step) == 5
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(tstate.m[k].numpy(), np.asarray(jstate.m[k]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tstate.v[k].numpy(), np.asarray(jstate.v[k]),
                                   atol=1e-6, rtol=1e-6)


# -- flat relay -------------------------------------------------------------------
def _cfgs(**kw):
    return JCollabConfig(**kw), CollabConfig(**kw)


def _assert_state_equal(js, ts, exact_floats=False):
    for f in EXACT_FIELDS + ("valid_g",):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    cmp = (np.testing.assert_array_equal if exact_floats
           else lambda a, b: np.testing.assert_allclose(a, b, **TOL))
    for f in ("obs", "global_protos", "mean_logits"):
        cmp(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))


@pytest.mark.parametrize("kw,cap,n", [(dict(), None, 2),
                                      (dict(m_down=3, m_up=2), None, 4),
                                      (dict(m_down=5), 3, 2)])
def test_init_relay_state_bit_equal(kw, cap, n):
    jc, tc = _cfgs(**kw)
    js = jflat.init_relay_state(jc, 84, seed=3, capacity=cap, n_clients=n)
    ts = tflat.init_relay_state(tc, 84, seed=3, capacity=cap, n_clients=n,
                                device="cpu")
    assert ts.capacity == js.capacity
    assert tbase.default_capacity(tc, n) == jbase.default_capacity(jc, n)
    _assert_state_equal(js, ts, exact_floats=True)
    for f in js._fields:
        assert getattr(ts, f).dtype == getattr(torch, str(np.asarray(
            getattr(js, f)).dtype)), f


@pytest.mark.parametrize("mask", [None, [1, 0, 1, 1, 0], [0, 0, 0, 0, 0],
                                  [1, 1, 1, 1, 1]])
@pytest.mark.parametrize("ptr", [0, 3, 7])
def test_ring_indices(mask, ptr):
    cap, k = 8, 5
    jm = None if mask is None else jnp.asarray(mask, bool)
    tm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
    ji, jptr = jbase.ring_indices(jnp.asarray(ptr, jnp.int32), k, cap, jm)
    ti, tptr = tbase.ring_indices(torch.tensor(ptr, dtype=torch.int32), k,
                                  cap, tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tptr) == int(jptr) and ti.dtype == tptr.dtype == torch.int32


def _run_relay(steps, C=4, d=6, cap=6):
    """Apply the same appends and merges to both relays; return both."""
    jc, tc = _cfgs(num_classes=C, d_feature=d)
    js = jflat.init_relay_state(jc, d, seed=1, capacity=cap)
    ts = tflat.init_relay_state(tc, d, seed=1, capacity=cap, device="cpu")
    rng = np.random.default_rng(0)
    for kind, k, owner, mask, stamp in steps:
        if kind == "append":
            obs = rng.standard_normal((k, C, d)).astype(np.float32)
            valid = rng.random((k, C)) > 0.3
            own = np.full((k,), owner, np.int32)
            m = None if mask is None else np.asarray(mask, bool)
            st = None if stamp is None else np.full((k,), stamp, np.int32)
            js = jflat.buffer_append(js, obs, valid, own, m, st)
            ts = tflat.buffer_append(ts, _t(obs), _t(valid), _t(own),
                                     None if m is None else _t(m),
                                     None if st is None else _t(st))
        else:
            f = rng.standard_normal((9, d)).astype(np.float32)
            y = rng.integers(0, C - 1, 9).astype(np.int32)   # class C-1 empty
            js = jflat.merge_round(js, jp.accumulate(jp.init_state(C, d), f, y))
            ts = tflat.merge_round(ts, tp.accumulate(tp.init_state(C, d, "cpu"),
                                                     _t(f), _t(y)))
    return js, ts


def test_buffer_append_and_merge_round():
    steps = [("append", 2, 0, None, None), ("merge",) + (None,) * 4,
             ("append", 3, 1, [1, 0, 1], None), ("append", 4, 2, None, 5),
             ("merge",) + (None,) * 4, ("append", 3, 0, [0, 0, 0], None),
             ("append", 5, 1, None, None)]
    js, ts = _run_relay(steps)
    _assert_state_equal(js, ts)
    assert int(ts.clock) == 2


def _sample_both(js, ts, client_id, m_down, seed):
    key = jax.random.PRNGKey(seed)
    want = jflat.sample_teacher(js, client_id, m_down, key)
    k_sample, k_pick = jax.random.split(key)
    noise = _t(jax.random.gumbel(k_sample, (m_down, ts.capacity)))
    pick = int(jax.random.randint(k_pick, (), 0, m_down, dtype=jnp.int32))
    got = tflat.sample_teacher(ts, client_id, m_down, noise, pick)
    assert got["obs_pick"] == int(want["obs_pick"])
    np.testing.assert_array_equal(got["obs"].numpy(), np.asarray(want["obs"]))
    np.testing.assert_array_equal(got["valid_o"].numpy(),
                                  np.asarray(want["valid_o"]))
    np.testing.assert_allclose(got["global_protos"].numpy(),
                               np.asarray(want["global_protos"]), **TOL)
    return got


@pytest.mark.parametrize("client_id", [0, 1, 2, 9])
@pytest.mark.parametrize("m_down", [1, 4])
def test_sample_teacher_indices_equal_under_reference_noise(client_id, m_down):
    steps = [("append", 2, 0, None, None), ("append", 2, 1, None, None),
             ("merge",) + (None,) * 4, ("append", 1, 2, None, None)]
    js, ts = _run_relay(steps)
    for seed in range(6):
        _sample_both(js, ts, client_id, m_down, seed)


def test_sample_teacher_fallbacks():
    """Every slot the client's own -> sample from the whole filled buffer;
    an empty buffer -> a zero, invalid teacher."""
    js, ts = _run_relay([("append", 6, 0, None, None)])
    got = _sample_both(js, ts, 0, 3, seed=1)
    assert got["valid_o"].any()
    empty = dict(owner=np.full((6,), jbase.EMPTY_OWNER, np.int32))
    js, ts = js._replace(**empty), ts._replace(**{k: _t(v) for k, v in empty.items()})
    got = _sample_both(js, ts, 0, 2, seed=2)
    assert not got["valid_o"].any() and not got["obs"].any()


def test_relay_server_round():
    jc, tc = _cfgs()
    srv = RelayServer(tc, 84, seed=0, n_clients=2, device="cpu")
    f, y = _feats(n=40, d=84, C=10, seed=3)
    srv.begin_round()
    for cid in (0, 1):
        proto = tp.accumulate(tp.init_state(10, 84, "cpu"), _t(f), _t(y))
        obs, valid = tp.observations(torch.rand(1, 40), _t(f), _t(y), 10, 10)
        srv.upload(cid, {"proto": proto, "obs": obs, "valid": valid})
    srv.end_round()
    st = srv.state
    assert int(st.clock) == 1 and int(st.ptr) == 3
    np.testing.assert_array_equal(st.owner[:3].numpy(), [-1, 0, 1])
    np.testing.assert_allclose(srv.global_protos.numpy(),
                               tp.means(proto).numpy(), **TOL)
