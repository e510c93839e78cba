"""The port's relay policies (`repro_torch.relay`: flat, per_class,
staleness) against the reference's, in both engines, and their mechanics on
the reference's own inputs.

The engine test mirrors tests/test_relay_policies.py's seq/vec equivalence
over policy x mode with MLP clients and full participation (cors here; fd in
tests/test_torch_baselines.py, to keep each file short on the CPU): the
port's sequential engine is held against the reference's `CollabTrainer`,
the port's vectorized engine against the reference's
`VectorizedCollabTrainer` and against the port's sequential engine. Draws
come from the reference's key schedule (`JaxDraws`), with the noise shape
of each policy. Tolerances: ring integers (ptr, owner, valid, stamp, clock,
valid_g, and age where the policy has it) and the ledger exactly;
observations, global prototypes and mean logits within 1e-4; weights within
1e-4; metrics rtol 1e-3, atol 1e-4; accuracies within 2e-2.

The fleet is tests/test_torch_vec_collab.py's (3 clients, 192 samples,
batch 32), not the reference test's (4 clients, 256 samples, batch 16). On
the latter one weight of 50,176 (client 2's w1[366, 21], cors, flat) lands
2.7e-4 apart between the port's engines: its first gradient is a sum that
cancels to +-1.5e-9 (the other steps' are 3e-3 to 6e-3), the two engines
round it to opposite signs, and Adam's first step, lr . g / (|g| + eps),
turns each sign into a move of about lr / 8. Every other weight agrees
within 1e-5.

The unit tests are the port's counterparts of tests/test_relay_policies.py's
per-class and staleness mechanics, run on the same inputs through both
packages, with the reference's random draws handed to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import relay as jrelay
from repro.core import client as jclient, collab as jcollab
from repro.core import prototypes as jp, vec_collab as jvec
from repro.data import partition, synthetic
from repro.models import cnn as jcnn, mlp as jmlp
from repro.types import CollabConfig as JCollabConfig
from repro.types import FleetConfig as JFleetConfig
from repro.types import TrainConfig as JTrainConfig
from repro_torch import convert, relay as trelay
from repro_torch.core import client as tclient, collab as tcollab
from repro_torch.core import prototypes as tp, vec_collab as tvec
from repro_torch.models import cnn as tcnn, mlp as tmlp
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
from test_torch_collab import JaxDraws

N_CLIENTS = 3
INT_FIELDS = ("ptr", "owner", "valid", "stamp", "clock", "valid_g", "age",
              "merges")
FLOAT_FIELDS = ("obs", "global_protos", "mean_logits")
TOL = 1e-4


def build_four(policy, mode, kind="mlp", n_clients=N_CLIENTS, n=192,
               batch=32, seed=0):
    """The reference's two engines and the port's two on one fleet:
    (ref seq, ref vec, port seq, port vec)."""
    x, y = synthetic.class_images(n, seed=0, noise=0.4)
    tx, ty = synthetic.class_images(128, seed=9, noise=0.4)
    parts = partition.uniform_split(x, y, n_clients, seed=1)
    kw = dict(mode=mode, num_classes=10, d_feature=84,
              lambda_kd=2.0 if mode in ("cors", "fd") else 0.0,
              lambda_disc=1.0 if mode == "cors" else 0.0)
    jmod, tmod = (jcnn, tcnn) if kind == "cnn" else (jmlp, tmlp)
    init = jcnn.init_cnn if kind == "cnn" else jmlp.init_mlp
    jparams = [init(k) for k in
               jax.random.split(jax.random.PRNGKey(seed), n_clients)]
    head = lambda p: (p["head_w"], p["head_b"])
    jspec = jclient.ClientSpec(apply=jmod.apply, head=head)
    tspec = tclient.ClientSpec(apply=tmod.apply, head=head)
    jargs = ([jspec] * n_clients, jparams, parts, (tx, ty),
             JCollabConfig(**kw), JTrainConfig(batch_size=batch))
    refs = [cls(*jargs, seed=seed, fleet=JFleetConfig(policy=policy))
            for cls in (jcollab.CollabTrainer, jvec.VectorizedCollabTrainer)]
    tparams = [convert.params_from_jax(
        {k: np.asarray(v) for k, v in p.items()}, kind, device="cpu")
        for p in jparams]
    targs = ([tspec] * n_clients, tparams, parts, (tx, ty),
             CollabConfig(**kw), TrainConfig(batch_size=batch))
    ports = [cls(*targs, seed=seed, fleet=FleetConfig(policy=policy),
                 draws=JaxDraws(seed, n_clients), device="cpu")
             for cls in (tcollab.CollabTrainer, tvec.VectorizedCollabTrainer)]
    return refs + ports


def relay_state(trainer):
    st = (trainer.server.state if hasattr(trainer, "server")
          else trainer.relay_state)
    return state_fields(st)


def state_fields(st):
    """A relay state of either package -> {field: numpy array}; a sharded
    state's inner fields come out flat, each (S, ...), beside `merges`."""
    out = {}
    for f in st._fields:
        v = getattr(st, f)
        if isinstance(v, tuple):
            out.update(state_fields(v))
        else:
            out[f] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v))
    return out


def client_weights(trainer, i, kind="mlp"):
    if hasattr(trainer, "clients"):
        p = trainer.clients[i].params
    else:
        p = trainer.client_params(i)
    if isinstance(next(iter(p.values())), torch.Tensor):
        return convert.params_to_numpy(p, kind)
    return {k: np.asarray(v) for k, v in p.items()}


def same_records(ra, rb, grad_rtol=1e-3):
    assert ra["participants"] == rb["participants"]
    assert ra["commits"] == rb["commits"]
    assert (ra["comm_up"], ra["comm_down"]) == (rb["comm_up"], rb["comm_down"])
    np.testing.assert_allclose(ra["accs"], rb["accs"], atol=2e-2)
    for ma, mb in zip(ra["metrics"], rb["metrics"]):
        assert sorted(ma) == sorted(mb)
        for k in ma:
            np.testing.assert_allclose(
                ma[k], mb[k], rtol=grad_rtol if k == "grad_norm" else 1e-3,
                atol=1e-4, err_msg=k)


def same_relay(a, b, tol=TOL):
    assert sorted(a) == sorted(b)
    for f in INT_FIELDS:
        if f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(a[f], b[f], atol=tol, err_msg=f)


STRICT = {"weights": TOL, "relay": TOL, "grad_rtol": 1e-3}


def run_and_compare(trainers, rounds=2, kind="mlp", tol=STRICT):
    """Runs the four engines side by side and holds port seq against ref
    seq, port vec against ref vec and against port seq."""
    jseq, jv, tseq, tv = trainers
    pairs = ((jseq, tseq), (jv, tv), (tseq, tv))
    for _ in range(rounds):
        recs = {id(t): t.run_round() for t in trainers}
        for a, b in pairs:
            same_records(recs[id(a)], recs[id(b)], tol["grad_rtol"])
    for a, b in pairs:
        assert a.ledger.by_round == b.ledger.by_round
        assert a.ledger.total_bytes == b.ledger.total_bytes
        if a.ccfg.mode in ("cors", "fd"):
            same_relay(relay_state(a), relay_state(b), tol["relay"])
        for i in range(len(a.history[0]["accs"])):
            wa, wb = client_weights(a, i, kind), client_weights(b, i, kind)
            for k in wa:
                np.testing.assert_allclose(wa[k], wb[k], atol=tol["weights"],
                                           err_msg=k)


POLICIES = ["flat", "per_class", "staleness"]


@pytest.mark.parametrize("policy", POLICIES)
def test_cors_engines_match_reference_under_every_policy(policy):
    """cors under each policy; fd's half of the matrix is in
    tests/test_torch_baselines.py."""
    run_and_compare(build_four(policy, "cors"))


# ---------------------------------------------------------------------------
# the batched draws against the reference's per-client sample_teacher
# ---------------------------------------------------------------------------
def _pair(policy_name, C=3, d=2, cap=4, m_down=1, **kw):
    jpol = jrelay.get_policy(policy_name, **kw)
    tpol = trelay.get_policy(policy_name, **kw)
    js = jpol.init_state(JCollabConfig(num_classes=C, d_feature=d,
                                       m_down=m_down), d, capacity=cap)
    ts = tpol.init_state(CollabConfig(num_classes=C, d_feature=d,
                                      m_down=m_down), d, capacity=cap,
                         device="cpu")
    return jpol, tpol, js, ts


def _set(js, ts, **fields):
    """The same field values in both states."""
    js = js._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = ts._replace(**{k: torch.from_numpy(np.asarray(v)) for k, v in
                        fields.items()})
    return js, ts


def _draws_of(key, shape, m_down):
    k_sample, k_pick = jax.random.split(key)
    return (np.asarray(jax.random.gumbel(k_sample, shape)),
            int(jax.random.randint(k_pick, (), 0, m_down, dtype=jnp.int32)))


def _sample_both(jpol, tpol, js, ts, ids, m_down, seed):
    """Each id's reference teacher, and the port's batched teachers under
    the reference's draws -> (list of reference dicts, port dict)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(ids))
    shape = tpol.noise_shape(ts, m_down)
    want, noise, picks = [], [], []
    for i, k in zip(ids, keys):
        want.append(jpol.sample_teacher(js, i, m_down, k))
        n, p = _draws_of(k, shape, m_down)
        noise.append(n)
        picks.append(p)
    got = tpol.sample_teachers(ts, torch.tensor(ids), m_down,
                               torch.from_numpy(np.stack(noise)),
                               torch.tensor(picks))
    return want, got


def _assert_teachers_equal(want, got, ids):
    assert sorted(got) == sorted(trelay.TEACHER_KEYS)
    for j in range(len(ids)):
        for k in trelay.TEACHER_KEYS:
            np.testing.assert_array_equal(got[k][j].numpy(),
                                          np.asarray(want[j][k]), err_msg=k)


def _filled_pair(policy_name, m_down, cap=6, C=3, d=2, seed=0, **kw):
    """A ring written through both packages' appends: owners 0..2, with
    partly valid rows, and one merge."""
    jpol, tpol, js, ts = _pair(policy_name, C=C, d=d, cap=cap,
                               m_down=m_down, **kw)
    rng = np.random.default_rng(seed)
    for owner, k in ((0, 2), (1, 1), (2, 2)):
        obs = rng.standard_normal((k, C, d)).astype(np.float32)
        valid = rng.random((k, C)) > 0.3
        own = np.full((k,), owner, np.int32)
        js = jpol.append(js, jnp.asarray(obs), jnp.asarray(valid),
                         jnp.asarray(own))
        ts = tpol.append(ts, torch.from_numpy(obs), torch.from_numpy(valid),
                         torch.from_numpy(own))
    s = rng.standard_normal((C, d)).astype(np.float32)
    c = np.array([2.0, 0.0, 1.0], np.float32)[:C]
    js = jpol.merge_round(js, jp.ProtoState(jnp.asarray(s), jnp.asarray(c)))
    ts = tpol.merge_round(ts, tp.ProtoState(torch.from_numpy(s),
                                            torch.from_numpy(c)))
    return jpol, tpol, js, ts


@pytest.mark.parametrize("policy", ["per_class", "staleness"])
@pytest.mark.parametrize("m_down", [1, 3, 8])
def test_batched_draw_equals_reference_per_client(policy, m_down):
    """Every client's teacher from one batched draw equals the reference's
    `sample_teacher` under its own key, on a ring both packages wrote; m_down
    8 exceeds the staleness ring's capacity and every pool."""
    jpol, tpol, js, ts = _filled_pair(policy, m_down)
    same_relay({f: np.asarray(getattr(js, f)) for f in js._fields},
               convert.relay_state_to_numpy(ts), tol=0)
    ids = [0, 1, 2, 5]
    for seed in range(4):
        want, got = _sample_both(jpol, tpol, js, ts, ids, m_down, seed)
        _assert_teachers_equal(want, got, ids)


# ---------------------------------------------------------------------------
# per-class ring mechanics (tests/test_relay_policies.py's, on both packages)
# ---------------------------------------------------------------------------
def test_per_class_append_routes_rows_to_class_rings():
    jpol, tpol, js, ts = _pair("per_class", cap=4)
    assert ts.ptr.tolist() == [1, 1, 1]                 # one seed per class
    valid = np.array([[True, False, True], [True, True, False]])
    own = np.array([7, 8], np.int32)
    js = jpol.append(js, jnp.ones((2, 3, 2)), jnp.asarray(valid),
                     jnp.asarray(own))
    ts = tpol.append(ts, torch.ones(2, 3, 2), torch.from_numpy(valid),
                     torch.from_numpy(own))
    np.testing.assert_array_equal(ts.ptr.numpy(), [3, 2, 2])
    owner = ts.owner.numpy()
    assert owner[0, 1] == 7 and owner[0, 2] == 8
    assert owner[1, 1] == 8 and owner[2, 1] == 7
    assert owner[1, 2] == trelay.EMPTY_OWNER
    assert owner[0, 0] == trelay.SEED_OWNER
    same_relay({f: np.asarray(getattr(js, f)) for f in js._fields},
               convert.relay_state_to_numpy(ts), tol=0)


@pytest.mark.parametrize("ptr", [0, 2, 3])               # 2, 3: writes wrap
@pytest.mark.parametrize("mask,stamp", [(None, None), ([1, 0, 1, 1], None),
                                        ([0, 0, 0, 0], 5), (None, 2)])
def test_per_class_masked_append_equals_reference(ptr, mask, stamp):
    """Masked rows consume no slot in any class ring, and the writes wrap
    each ring at its own pointer, as the reference's dropping scatter."""
    jpol, tpol, js, ts = _pair("per_class", cap=4)
    js, ts = _set(js, ts, ptr=np.array([ptr, (ptr + 1) % 4, 0], np.int32),
                  clock=np.array(3, np.int32))
    rng = np.random.default_rng(ptr)
    obs = rng.standard_normal((4, 3, 2)).astype(np.float32)
    valid = rng.random((4, 3)) > 0.3
    own = np.arange(4, dtype=np.int32) + 10
    m = None if mask is None else np.array(mask, bool)
    st = None if stamp is None else np.full((4,), stamp, np.int32)
    js = jpol.append(js, jnp.asarray(obs), jnp.asarray(valid), jnp.asarray(own),
                     None if m is None else jnp.asarray(m),
                     None if st is None else jnp.asarray(st))
    ts = tpol.append(ts, torch.from_numpy(obs), torch.from_numpy(valid),
                     torch.from_numpy(own),
                     None if m is None else torch.from_numpy(m),
                     None if st is None else torch.from_numpy(st))
    same_relay({f: np.asarray(getattr(js, f)) for f in js._fields},
               convert.relay_state_to_numpy(ts), tol=0)


def test_per_class_sampling_excludes_own_and_respects_class_pools():
    jpol, tpol, js, ts = _pair("per_class", cap=4)
    obs = np.zeros((3, 4, 2), np.float32)
    obs[1, 1] = 5.0
    js, ts = _set(
        js, ts, obs=obs,
        valid=np.array([[True, False, False, False],
                        [True, True, False, False],
                        [False, False, False, False]]),
        owner=np.array([[0, -2, -2, -2], [0, 1, -2, -2], [-2, -2, -2, -2]],
                       np.int32))
    for s in range(6):
        want, got = _sample_both(jpol, tpol, js, ts, [0], 2, s)
        _assert_teachers_equal(want, got, [0])
        np.testing.assert_allclose(got["obs"][0, :, 1].numpy(), 5.0)
        assert bool(got["valid_o"][0, 0])            # own slot, pool exhausted
        assert not bool(got["valid_o"][0, 2])        # empty ring
        np.testing.assert_allclose(got["obs"][0, :, 2].numpy(), 0.0)


def test_per_class_merge_ages_valid_slots_only():
    jpol, tpol, js, ts = _pair("per_class", cap=3)
    js = jpol.merge_round(js, jp.ProtoState(jnp.ones((3, 2)), jnp.ones((3,))))
    ts = tpol.merge_round(ts, tp.ProtoState(torch.ones(3, 2), torch.ones(3)))
    age, valid = ts.age.numpy(), ts.valid.numpy()
    assert (age[valid] == 1).all() and (age[~valid] == 0).all()
    np.testing.assert_array_equal(age, np.asarray(js.age))


# ---------------------------------------------------------------------------
# staleness mechanics
# ---------------------------------------------------------------------------
def test_staleness_age_lifecycle():
    """Slots age by 1 a merge; overwriting a slot resets it to 0."""
    jpol, tpol, js, ts = _pair("staleness:1.0", cap=3)
    jproto = jp.ProtoState(jnp.ones((3, 2)), jnp.ones((3,)))
    tproto = tp.ProtoState(torch.ones(3, 2), torch.ones(3))

    def both(op, *args):
        nonlocal js, ts
        if op == "append":
            val, owner = args
            js = jpol.append(js, jnp.full((1, 3, 2), val), jnp.ones((1, 3), bool),
                             jnp.asarray([owner], jnp.int32))
            ts = tpol.append(ts, torch.full((1, 3, 2), val),
                             torch.ones(1, 3, dtype=torch.bool),
                             torch.tensor([owner], dtype=torch.int32))
        else:
            js, ts = jpol.merge_round(js, jproto), tpol.merge_round(ts, tproto)
        np.testing.assert_array_equal(ts.age.numpy(), np.asarray(js.age))
        return ts.age.tolist()

    both("append", 1.0, 0)
    both("merge")
    assert both("merge") == [2, 2, 0]
    assert both("append", 9.0, 1) == [2, 2, 0]      # overwrites slot 2
    assert both("merge") == [3, 3, 1]


def test_staleness_sampling_prefers_fresh_slots():
    jpol, tpol, js, ts = _pair("staleness:8.0", cap=6)
    js, ts = _set(js, ts,
                  obs=np.arange(6, dtype=np.float32)[:, None, None]
                  * np.ones((6, 3, 2), np.float32),
                  valid=np.ones((6, 3), bool),
                  owner=np.ones((6,), np.int32),
                  age=np.array([0, 5, 5, 5, 5, 5], np.int32))
    want, got = _sample_both(jpol, tpol, js, ts, [0] * 40, 1, 0)
    _assert_teachers_equal(want, got, [0] * 40)
    assert (got["obs"].amax((1, 2, 3)) == 0).float().mean() > 0.9


def test_staleness_tolerates_m_down_beyond_pool_and_capacity():
    """m_down 8 > capacity 4 > pool 2: the in-pool picks are recycled, the
    teacher is valid and holds only client 1's slots, however torch.topk
    orders the -inf scores."""
    jpol, tpol, js, ts = _pair("staleness:1.0", cap=4)
    js, ts = _set(js, ts, valid=np.ones((4, 3), bool),
                  owner=np.array([0, 0, 1, 1], np.int32),
                  obs=np.arange(4, dtype=np.float32)[:, None, None]
                  * np.ones((4, 3, 2), np.float32))
    for s in range(4):
        want, got = _sample_both(jpol, tpol, js, ts, [0, 1], 8, s)
        _assert_teachers_equal(want, got, [0, 1])
        assert got["obs"].shape == (2, 8, 3, 2)
        assert bool(got["valid_o"].all())
        assert set(got["obs"][0, :, 0, 0].tolist()) <= {2.0, 3.0}


def test_staleness_lam_zero_is_uniform_over_pool():
    jpol, tpol, js, ts = _pair("staleness:0.0", cap=4)
    js, ts = _set(js, ts, valid=np.ones((4, 3), bool),
                  owner=np.array([0, 1, 1, 1], np.int32),
                  age=np.array([0, 0, 50, 100], np.int32),
                  obs=np.arange(4, dtype=np.float32)[:, None, None]
                  * np.ones((4, 3, 2), np.float32))
    want, got = _sample_both(jpol, tpol, js, ts, [0] * 60, 1, 0)
    _assert_teachers_equal(want, got, [0] * 60)
    seen = set(got["obs"][:, 0, 0, 0].tolist())
    assert 0.0 not in seen and seen == {1.0, 2.0, 3.0}
    w = trelay.staleness_weights(torch.tensor([0, 0, 50, 100]),
                                 torch.tensor([False, True, True, True]), 0.0)
    np.testing.assert_allclose(w.numpy(), np.asarray(jrelay.staleness_weights(
        jnp.asarray([0, 0, 50, 100]), jnp.asarray([False, True, True, True]),
        0.0)), atol=1e-7)


def test_get_policy_specs():
    assert isinstance(trelay.get_policy(None), trelay.FlatRelay)
    assert trelay.get_policy("staleness:0.25").lam == 0.25
    assert trelay.get_policy("staleness").lam == jrelay.get_policy("staleness").lam
    p = trelay.PerClassRelay()
    assert trelay.get_policy(p) is p
    with pytest.raises(ValueError, match="unknown relay policy"):
        trelay.get_policy("nope")
    p = trelay.get_policy("sharded:flat,2")
    assert isinstance(p, trelay.ShardedRelay) and p.shards == 2
    assert isinstance(p.inner, trelay.FlatRelay)
