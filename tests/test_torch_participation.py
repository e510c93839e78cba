"""Participation schedules in the port (`repro_torch.relay.participation`)
against the reference's, and both of the port's engines under them against
the reference's sequential engine.

- Masks: every spec, seeds {0, 5}, rounds 0-9, N in {5, 8}, equal element
  for element; adaptive also bound to each package's own `lognormal:4`
  clock (the port's copy of `sim/clocks.py`, whose delays are held equal
  here too).
- `freeze_absent` and the per-client Adam step: bit-identical, no
  tolerance. Under full participation the (N,) step gives weights
  bit-equal to the scalar step it replaced, in both engines.
- Engines: the port's sequential and vectorized engines against the
  reference's `CollabTrainer` for cors under uniform_k:2 (compacted in the
  vectorized engine), cyclic:2 (compacted) and bernoulli:0.5 (full width,
  masked), each with the flat and the staleness relay, and for fd and
  fedavg under bernoulli:0.5. The fleet and tolerances are
  tests/test_torch_relay_policies.py's (3 MLP clients, 192 samples, batch
  32; its helpers): ring integers (and ages), participants, commits and
  ledger exactly; observations, prototypes, mean logits and weights within
  1e-4; metrics rtol 1e-3, atol 1e-4; accuracies within 2e-2.
- A zero-participant round: a relay no-op in both engines, billed 0, every
  client's parameters and Adam state unchanged.
- Compaction: `_k_active == k`, absent clients' parameters and Adam state
  bit-identical across the round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import relay as jrelay, sim as jsim
from repro.core import client as jclient, collab as jcollab
from repro.data import partition, synthetic
from repro.models import mlp as jmlp
from repro.optim import optim as jopt
from repro.types import CollabConfig as JCollabConfig
from repro.types import FleetConfig as JFleetConfig
from repro.types import TrainConfig as JTrainConfig
from repro_torch import convert, relay as trelay, sim as tsim
from repro_torch.core import client as tclient, collab as tcollab
from repro_torch.core import vec_collab as tvec
from repro_torch.models import mlp as tmlp
from repro_torch.optim import optim as topt
from repro_torch.relay import participation as tpart
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
from test_torch_collab import JaxDraws
from test_torch_relay_policies import (client_weights, relay_state,
                                       same_records, same_relay)

SPECS = ["full", "uniform_k:2", "uniform_k:5", "cyclic:3", "bernoulli:0.5",
         "bernoulli_p:0.2", "adaptive:0.5", "adaptive:0.4,2"]
ROUNDS = range(10)
N_CLIENTS = 3
TOL = 1e-4


# ---------------------------------------------------------------------------
# the schedules' masks and the clocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("spec", SPECS)
def test_masks_equal_reference(spec, seed, n):
    js = jrelay.get_schedule(spec, seed=seed)
    ts = trelay.get_schedule(spec, seed=seed)
    assert ts.name == js.name and ts.fixed_k == js.fixed_k
    for r in ROUNDS:
        want = js.mask(r, n)
        got = ts.mask(r, n)
        assert got.dtype == np.bool_ and got.shape == (n,)
        np.testing.assert_array_equal(got, want, err_msg=f"round {r}")
    # the masks depend on the round alone: asked again, out of order
    for r in (7, 2):
        np.testing.assert_array_equal(ts.mask(r, n), js.mask(r, n))


@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("seed", [0, 5])
def test_adaptive_masks_equal_reference_under_a_bound_clock(seed, n):
    """Each package's schedule bound to its own lognormal:4 clock: the
    observed delays are the clock's, so the boosted masks must agree."""
    jc = jsim.get_clock("lognormal:4", seed=seed)
    tc = tsim.get_clock("lognormal:4", seed=seed)
    js = jrelay.get_schedule("adaptive:0.5,2", seed=seed, clock=jc)
    ts = trelay.get_schedule("adaptive:0.5,2", seed=seed, clock=tc)
    assert ts.clock is tc
    for r in ROUNDS:
        np.testing.assert_array_equal(ts.mask(r, n), js.mask(r, n),
                                      err_msg=f"round {r}")
    np.testing.assert_array_equal(ts._ema, js._ema)
    unbound = trelay.get_schedule("adaptive:0.5,2", seed=seed)
    assert any((unbound.mask(r, n) != ts.mask(r, n)).any() for r in ROUNDS)


@pytest.mark.parametrize("spec", ["none", "homogeneous:2", "lognormal:4",
                                  "lognormal:3,0.5", "periodic:2,3"])
def test_clocks_equal_reference(spec):
    for seed in (0, 5):
        for get in ("get_clock", "get_download_clock"):
            jc = getattr(jsim, get)(spec, seed=seed)
            tc = getattr(tsim, get)(spec, seed=seed)
            if jc is None:
                assert tc is None
                continue
            assert type(tc).__name__ == type(jc).__name__
            assert tc.d_max == jc.d_max
            for r in range(6):
                np.testing.assert_array_equal(tc.delays(r, 7),
                                              jc.delays(r, 7))


def test_get_schedule_errors_and_pass_through():
    with pytest.raises(ValueError) as got:
        trelay.get_schedule("nope")
    with pytest.raises(ValueError) as want:
        jrelay.get_schedule("nope")
    assert str(got.value) == str(want.value)
    assert isinstance(trelay.get_schedule(None), trelay.FullParticipation)
    s = trelay.Cyclic(k=2)
    assert trelay.get_schedule(s) is s
    # out-of-range arguments: the reference asserts, the port raises
    # ValueError, both when the mask is drawn
    for spec in ("uniform_k:0", "uniform_k:6", "cyclic:6", "bernoulli:1.5"):
        with pytest.raises(ValueError, match=spec.split(":")[0]):
            trelay.get_schedule(spec).mask(0, 5)
        with pytest.raises(AssertionError):
            jrelay.get_schedule(spec).mask(0, 5)
    with pytest.raises(ValueError, match="adaptive"):
        trelay.get_schedule("adaptive:0")
    a = trelay.get_schedule("adaptive:0.5")
    a.mask(0, 4)
    with pytest.raises(ValueError, match="bind_clock"):
        a.bind_clock(tsim.get_clock("lognormal:4"))
    # a bound instance keeps its clock; an unbound one takes the given one
    clock = tsim.get_clock("lognormal:4")
    b = trelay.AdaptiveParticipation(p=0.5)
    assert trelay.get_schedule(b, clock=clock) is b and b.clock is clock


# ---------------------------------------------------------------------------
# freeze_absent and the per-client Adam step
# ---------------------------------------------------------------------------
def test_freeze_absent_is_bit_identical_to_reference():
    rng = np.random.default_rng(0)
    mask = np.array([True, False, True, False])
    new = {"w": rng.standard_normal((4, 3, 2)).astype(np.float32),
           "b": rng.standard_normal((4,)).astype(np.float32)}
    old = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in new.items()}
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
    tnew = topt.AdamState(torch.tensor([3, 3, 3, 3], dtype=torch.int32),
                          t(new), t(old))
    told = topt.AdamState(torch.tensor([2, 1, 2, 1], dtype=torch.int32),
                          t(old), t(new))
    got = tpart.freeze_absent(torch.from_numpy(mask), tnew, told)
    assert isinstance(got, topt.AdamState)
    want = jrelay.participation.freeze_absent(
        jnp.asarray(mask),
        jopt.AdamState(jnp.asarray([3, 3, 3, 3], jnp.int32), new, old),
        jopt.AdamState(jnp.asarray([2, 1, 2, 1], jnp.int32), old, new))
    np.testing.assert_array_equal(got.step.numpy(), np.asarray(want.step))
    for part in ("m", "v"):
        for k in new:
            np.testing.assert_array_equal(getattr(got, part)[k].numpy(),
                                          np.asarray(getattr(want, part)[k]))
    for i in (1, 3):                              # absent: the old bits
        assert torch.equal(got.m["w"][i], told.m["w"][i])
        assert int(got.step[i]) == int(told.step[i])
    # a relay state (a NamedTuple with 0-d leaves) under keep_if
    ts = trelay.FlatRelay().init_state(CollabConfig(), 84, device="cpu")
    ts2 = ts._replace(clock=ts.clock + 1, ptr=ts.ptr + 3)
    for flag, want_state in ((True, ts2), (False, ts)):
        kept = tpart.keep_if(torch.tensor(flag), ts2, ts)
        for f in ts._fields:
            assert torch.equal(getattr(kept, f), getattr(want_state, f)), f


def _scalar_step_adam(params, grads, state, *, lr=1e-3, b1=0.9, b2=0.999,
                      eps=1e-8):
    """Adam as the port computed it with one Python int step for the whole
    stack: the bias corrections read to the host, as Python floats."""
    step = int(state.step.reshape(-1)[0]) + 1
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = (1 - b1 ** t).item()
    bc2 = (1 - b2 ** t).item()
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m = b1 * state.m[k] + (1 - b1) * g
        v = b2 * state.v[k] + (1 - b2) * torch.square(g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p[k] = (p.float() - lr * u).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, topt.AdamState(state.step + 1, new_m, new_v)


def test_per_client_step_equals_scalar_step_and_freezes_absent_clients():
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 6, 4, generator=g),
              "b": torch.randn(3, 4, generator=g)}
    st_new = st_old = topt.adam_init(params, clients=3)
    assert st_new.step.shape == (3,) and st_new.step.dtype == torch.int32
    p_new = p_old = params
    for s in range(5):
        grads = {k: torch.randn(v.shape, generator=g) * 10.0 ** -s
                 for k, v in params.items()}
        p_new, st_new = topt.adam_update(p_new, grads, st_new, lr=1e-2)
        p_old, st_old = _scalar_step_adam(p_old, grads, st_old, lr=1e-2)
        for k in params:
            assert torch.equal(p_new[k], p_old[k]), (s, k)
            assert torch.equal(st_new.m[k], st_old.m[k])
            assert torch.equal(st_new.v[k], st_old.v[k])
    assert st_new.step.tolist() == [5, 5, 5]
    # one masked step: client 1 absent keeps its parameters, moments and
    # step count bit for bit; the others take their own bias corrections
    mask = torch.tensor([True, False, True])
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    p2, st2 = topt.adam_update(p_new, grads, st_new)
    p2 = tpart.freeze_absent(mask, p2, p_new)
    st2 = tpart.freeze_absent(mask, st2, st_new)
    assert st2.step.tolist() == [6, 5, 6]
    for k in params:
        assert torch.equal(p2[k][1], p_new[k][1])
        assert torch.equal(st2.m[k][1], st_new.m[k][1])
        assert torch.equal(st2.v[k][1], st_new.v[k][1])
    # the next step of client 1 uses t = 6 and the others t = 7: each equals
    # the one-client update at its own count
    p3, _ = topt.adam_update(p2, grads, st2)
    for i in range(3):
        one = topt.AdamState(st2.step[i], {k: v[i] for k, v in st2.m.items()},
                             {k: v[i] for k, v in st2.v.items()})
        pi, _ = topt.adam_update({k: v[i] for k, v in p2.items()},
                                 {k: v[i] for k, v in grads.items()}, one)
        for k in params:
            assert torch.equal(p3[k][i], pi[k]), (i, k)


# ---------------------------------------------------------------------------
# the engines against the reference's sequential engine
# ---------------------------------------------------------------------------
def _fleet(n_clients=N_CLIENTS, n=192):
    x, y = synthetic.class_images(n, seed=0, noise=0.4)
    tx, ty = synthetic.class_images(128, seed=9, noise=0.4)
    return partition.uniform_split(x, y, n_clients, seed=1), (tx, ty)


def _kw(mode):
    return dict(mode=mode, num_classes=10, d_feature=84,
                lambda_kd=2.0 if mode in ("cors", "fd") else 0.0,
                lambda_disc=1.0 if mode == "cors" else 0.0)


def build_three(mode, policy, schedule, n_clients=N_CLIENTS, seed=0):
    """(reference seq, port seq, port vec) on one MLP fleet under one
    policy and schedule, the port drawing from the reference's keys."""
    parts, test = _fleet(n_clients)
    jparams = [jmlp.init_mlp(k) for k in
               jax.random.split(jax.random.PRNGKey(seed), n_clients)]
    head = lambda p: (p["head_w"], p["head_b"])
    ref = jcollab.CollabTrainer(
        [jclient.ClientSpec(apply=jmlp.apply, head=head)] * n_clients,
        jparams, parts, test, JCollabConfig(**_kw(mode)),
        JTrainConfig(batch_size=32), seed=seed,
        fleet=JFleetConfig(policy=policy, participation=schedule))
    tparams = [convert.params_from_jax(
        {k: np.asarray(v) for k, v in p.items()}, "mlp", device="cpu")
        for p in jparams]
    ports = [cls([tclient.ClientSpec(apply=tmlp.apply, head=head)] * n_clients,
                 tparams, parts, test, CollabConfig(**_kw(mode)),
                 TrainConfig(batch_size=32), seed=seed,
                 fleet=FleetConfig(policy=policy, participation=schedule),
                 draws=JaxDraws(seed, n_clients), device="cpu")
             for cls in (tcollab.CollabTrainer, tvec.VectorizedCollabTrainer)]
    return [ref] + ports


def run_three(trainers, rounds=3):
    ref, seq, vec = trainers
    for _ in range(rounds):
        rj, rs, rv = (t.run_round() for t in trainers)
        same_records(rj, rs)
        same_records(rj, rv)
    n = len(ref.clients)
    for t in (seq, vec):
        assert t.ledger.by_round == ref.ledger.by_round
        assert t.ledger.total_bytes == ref.ledger.total_bytes
        if ref.ccfg.mode in ("cors", "fd"):
            same_relay(relay_state(ref), relay_state(t))
        for i in range(n):
            wa, wb = client_weights(ref, i), client_weights(t, i)
            for k in wa:
                np.testing.assert_allclose(wb[k], wa[k], atol=TOL,
                                           err_msg=k)
    return [h["participants"] for h in ref.history]


@pytest.mark.parametrize("policy", ["flat", "staleness"])
@pytest.mark.parametrize("schedule", ["uniform_k:2", "cyclic:2",
                                      "bernoulli:0.5"])
def test_cors_engines_match_reference_under_schedules(schedule, policy):
    trainers = build_three("cors", policy, schedule)
    parts = run_three(trainers)
    assert any(len(p) < N_CLIENTS for p in parts), parts
    vec = trainers[2]
    assert vec._k_active == (2 if schedule != "bernoulli:0.5" else N_CLIENTS)


@pytest.mark.parametrize("mode", ["fd", "fedavg"])
def test_baseline_engines_match_reference_under_bernoulli(mode):
    trainers = build_three(mode, "flat", "bernoulli:0.5")
    parts = run_three(trainers)
    assert any(0 < len(p) < N_CLIENTS for p in parts), parts
    if mode == "fedavg":             # present clients hold one average
        for t in trainers[1:]:
            p = [client_weights(t, i) for i in parts[-1]]
            for k in p[0]:
                assert all(np.array_equal(p[0][k], q[k]) for q in p[1:]), k


def _port_pair(mode="cors", policy="flat", schedule="full", n_clients=3):
    parts, test = _fleet(n_clients)
    g = torch.Generator().manual_seed(0)
    ps = [tmlp.init_mlp(g, device="cpu") for _ in range(n_clients)]
    head = lambda p: (p["head_w"], p["head_b"])
    return [cls([tclient.ClientSpec(apply=tmlp.apply, head=head)] * n_clients,
                ps, parts, test, CollabConfig(**_kw(mode)),
                TrainConfig(batch_size=32), seed=0,
                fleet=FleetConfig(policy=policy, participation=schedule),
                device="cpu")
            for cls in (tcollab.CollabTrainer, tvec.VectorizedCollabTrainer)]


@pytest.mark.parametrize("engine", ["seq", "vec"])
def test_per_client_step_gives_scalar_step_weights_in_each_engine(
        engine, monkeypatch):
    """Full participation, cors, two rounds: the engine with the per-client
    step and with the scalar step it replaced end bit-equal."""
    def run():
        t = _port_pair()[engine == "vec"]
        t.run(2)
        return [client_weights(t, i) for i in range(3)]
    new = run()
    monkeypatch.setattr(tclient, "adam_update", _scalar_step_adam)
    old = run()
    for a, b in zip(new, old):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class NoShow(trelay.ParticipationSchedule):
    name = "noshow"

    def mask(self, round_idx, n_clients):
        return np.zeros((n_clients,), bool)


def _client_state(t, i):
    """(parameters, Adam m, v, step) of client i, as numpy."""
    if hasattr(t, "clients"):
        p, o = t.clients[i].params, t.clients[i].opt_state
        return ({k: v.numpy().copy() for k, v in p.items()},
                {k: v.numpy().copy() for k, v in o.m.items()},
                {k: v.numpy().copy() for k, v in o.v.items()},
                int(o.step))
    return ({k: v[i].numpy().copy() for k, v in t.params.items()},
            {k: v[i].numpy().copy() for k, v in t.opt_state.m.items()},
            {k: v[i].numpy().copy() for k, v in t.opt_state.v.items()},
            int(t.opt_state.step[i]))


def _same_client_state(a, b):
    for x, y in zip(a[:3], b[:3]):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert a[3] == b[3]


@pytest.mark.parametrize("policy", ["flat", "staleness"])
def test_zero_participant_round_is_a_relay_noop(policy):
    for t in _port_pair(policy=policy, schedule=NoShow()):
        st = relay_state(t)
        before = [_client_state(t, i) for i in range(3)]
        rec = t.run_round()
        assert rec["participants"] == [] and rec["commits"] == []
        assert rec["comm_up"] == rec["comm_down"] == 0.0
        assert all(v == 0.0 for m in rec["metrics"] for v in m.values())
        after = relay_state(t)
        for f in st:
            np.testing.assert_array_equal(st[f], after[f], err_msg=f)
        assert int(after["clock"]) == 0
        for a, b in zip(before, [_client_state(t, i) for i in range(3)]):
            _same_client_state(a, b)


@pytest.mark.parametrize("schedule,k", [("cyclic:2", 2), ("uniform_k:1", 1)])
def test_compaction_freezes_absent_clients(schedule, k):
    seq, vec = _port_pair(schedule=schedule, n_clients=4)
    assert vec._k_active == k
    for _ in range(3):
        before = [_client_state(vec, i) for i in range(4)]
        rec = vec.run_round()
        rs = seq.run_round()
        assert rec["participants"] == rs["participants"]
        assert len(rec["participants"]) == k
        for i in range(4):
            now = _client_state(vec, i)
            if i in rec["participants"]:
                assert now[3] == before[i][3] + 1       # one local step
                assert not np.array_equal(now[0]["w1"], before[i][0]["w1"])
            else:
                _same_client_state(before[i], now)
                assert all(v == 0.0 for v in rec["metrics"][i].values())
    for f in ("ptr", "owner", "valid", "stamp", "clock"):
        assert torch.equal(getattr(seq.server.state, f),
                           getattr(vec.relay_state, f)), f
    assert seq.ledger.by_round == vec.ledger.by_round
