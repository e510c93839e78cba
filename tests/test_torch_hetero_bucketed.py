"""Mixed fleets in the port: the bucketed vectorized engine
(`repro_torch.core.vec_collab`) against the reference's bucketed engine and
against the port's sequential engine; the port of
tests/test_hetero_bucketed.py.

The fleet is that file's: 4 clients, interleaved, even ids an MLP of width
64 and odd ids one of width 96 (two distinct spec objects), optionally the
last client a LeNet (a third bucket), 256 samples; batch 32 (that file's
16 doubles the steps on the CPU). The port draws from the reference's key
schedule (`JaxDraws`), indexed by client id, so bucketing changes no
client's draws. Tolerances, as tests/test_torch_relay_policies.py: ring
integers (and ages), participants, commits and ledger exactly;
observations, prototypes, mean logits and MLP weights within 1e-4; metrics
rtol 1e-3, atol 1e-4; accuracies within 2e-2. With the LeNet client, the
LeNet bounds of tests/test_torch_vec_collab.py (weights 5e-3, relay floats
2e-2, grad_norm rtol 1e-2): its max-pool near-ties route gradients by
rounding.

One weight of a leaf may stand apart, by less than lr = 1e-3: the
mechanism tests/test_torch_relay_policies.py's docstring reads on this
fleet, a first gradient that cancels to about 1e-9, rounded to opposite
signs by two summation orders, which Adam's early steps, about lr . g /
|g| each, turn into a move of up to lr. Every pair of engines shows it
here, the reference's against the port's sequential one too. Readings
after two rounds (per_class, uniform_k:2): one element of client 1's w2
3.8e-4 apart between the port's engines, 2.5e-4 between the two packages'
sequential engines, 1.2e-4 between the two vectorized ones; at batch 16,
one element of client 2's w1 3.1e-4 apart (the weight that file names);
every other weight within 2e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro import relay as jrelay
from repro.core import client as jclient, vec_collab as jvec
from repro.data import partition, synthetic
from repro.models import cnn as jcnn, mlp as jmlp
from repro.types import CollabConfig as JCollabConfig
from repro.types import FleetConfig as JFleetConfig
from repro.types import TrainConfig as JTrainConfig
from repro_torch import convert, relay as trelay
from repro_torch.core import client as tclient, collab as tcollab
from repro_torch.core import vec_collab as tvec
from repro_torch.models import cnn as tcnn, mlp as tmlp
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
from test_torch_collab import JaxDraws
from test_torch_relay_policies import (client_weights, relay_state,
                                       same_records, same_relay)

N = 4
BATCH = 32
HEAD = lambda p: (p["head_w"], p["head_b"])       # noqa: E731
# distinct spec objects per model, in each package
J_SPECS = {"a": jclient.ClientSpec(apply=lambda p, x: jmlp.apply(p, x), head=HEAD),
           "b": jclient.ClientSpec(apply=lambda p, x: jmlp.apply(p, x), head=HEAD),
           "cnn": jclient.ClientSpec(apply=lambda p, x: jcnn.apply(p, x), head=HEAD)}
T_SPECS = {"a": tclient.ClientSpec(apply=lambda p, x: tmlp.apply(p, x), head=HEAD),
           "b": tclient.ClientSpec(apply=lambda p, x: tmlp.apply(p, x), head=HEAD),
           "cnn": tclient.ClientSpec(apply=lambda p, x: tcnn.apply(p, x), head=HEAD)}
STRICT = {"weights": 1e-4, "relay": 1e-4, "grad_rtol": 1e-3}
LR = 1e-3                  # TrainConfig's Adam step: a lone weight's bound
LENET = {"weights": 5e-3, "relay": 2e-2, "grad_rtol": 1e-2}


def _kinds(n_clients, with_cnn):
    return ["cnn" if with_cnn and i == n_clients - 1 else "ab"[i % 2]
            for i in range(n_clients)]


def build(policy, schedule, mode="cors", n_clients=N, with_cnn=False,
          seed=0, jschedule=None):
    """(reference vec, port seq, port vec) on the mixed fleet; `jschedule`:
    the reference's schedule where `schedule` is an instance of the
    port's."""
    x, y = synthetic.class_images(256, seed=0, noise=0.4)
    tx, ty = synthetic.class_images(128, seed=9, noise=0.4)
    parts = partition.uniform_split(x, y, n_clients, seed=1)
    kinds = _kinds(n_clients, with_cnn)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_clients)
    jparams = [jcnn.init_cnn(k) if kind == "cnn"
               else jmlp.init_mlp(k, hidden=64 if kind == "a" else 96)
               for kind, k in zip(kinds, keys)]
    kw = dict(mode=mode, num_classes=10, d_feature=84, lambda_kd=2.0,
              lambda_disc=1.0 if mode == "cors" else 0.0)
    ref = jvec.VectorizedCollabTrainer(
        [J_SPECS[k] for k in kinds], jparams, parts, (tx, ty),
        JCollabConfig(**kw), JTrainConfig(batch_size=BATCH), seed=seed,
        fleet=JFleetConfig(policy=policy, participation=jschedule or schedule))
    tparams = [convert.params_from_jax({k: np.asarray(v) for k, v in p.items()},
                                       "cnn" if kind == "cnn" else "mlp",
                                       device="cpu")
               for kind, p in zip(kinds, jparams)]
    ports = [cls([T_SPECS[k] for k in kinds], tparams, parts, (tx, ty),
                 CollabConfig(**kw), TrainConfig(batch_size=BATCH), seed=seed,
                 fleet=FleetConfig(policy=policy, participation=schedule),
                 draws=JaxDraws(seed, n_clients), device="cpu")
             for cls in (tcollab.CollabTrainer, tvec.VectorizedCollabTrainer)]
    return [ref] + ports


def run_three(trainers, rounds=2, tol=STRICT, kinds=None):
    ref, seq, vec = trainers
    for _ in range(rounds):
        rj, rs, rv = (t.run_round() for t in trainers)
        same_records(rj, rv, tol["grad_rtol"])
        same_records(rs, rv, tol["grad_rtol"])
    for a in (ref, seq):
        assert a.ledger.by_round == vec.ledger.by_round
        assert a.ledger.total_bytes == vec.ledger.total_bytes
        same_relay(relay_state(a), relay_state(vec), tol["relay"])
        for i, kind in enumerate(kinds or _kinds(N, False)):
            kk = "cnn" if kind == "cnn" else "mlp"
            wa, wb = client_weights(a, i, kk), client_weights(vec, i, kk)
            for k in wa:
                d = np.abs(wb[k] - wa[k])
                assert (d > tol["weights"]).sum() <= 1, (i, k, d.max())
                assert d.max() < LR, (i, k, d.max())


@pytest.mark.parametrize("policy", ["flat", "per_class", "staleness"])
@pytest.mark.parametrize("schedule", ["full", "uniform_k:2", "bernoulli:0.5"])
def test_hetero_engines_match_reference(policy, schedule):
    trainers = build(policy, schedule)
    vec = trainers[2]
    assert vec.hetero and len(vec.buckets) == 2
    assert [b.ids.tolist() for b in vec.buckets] == [[0, 2], [1, 3]]
    run_three(trainers)


def test_hetero_three_buckets_fd_mode():
    """fd with a third, LeNet bucket: the cross-bucket prototype and logit
    merges match both engines."""
    trainers = build("flat", "full", mode="fd", with_cnn=True)
    assert len(trainers[2].buckets) == 3
    run_three(trainers, tol=LENET, kinds=_kinds(N, True))
    ml = relay_state(trainers[2])["mean_logits"]
    assert np.abs(ml).max() > 0 and np.isfinite(ml).all()


class NoShow(trelay.ParticipationSchedule):
    name = "noshow"

    def mask(self, round_idx, n_clients):
        return np.zeros((n_clients,), bool)


class JNoShow(jrelay.ParticipationSchedule):
    name = "noshow"

    def mask(self, round_idx, n_clients):
        return np.zeros((n_clients,), bool)


def test_hetero_zero_participant_round_is_a_relay_noop():
    _, seq, vec = build("staleness", NoShow(), jschedule=JNoShow())
    before = relay_state(vec)
    params = [{k: v.clone() for k, v in b.params.items()} for b in vec.buckets]
    steps = [b.opt.step.clone() for b in vec.buckets]
    for t in (seq, vec):
        rec = t.run_round()
        assert rec["participants"] == [] and rec["commits"] == []
        assert rec["comm_up"] == rec["comm_down"] == 0.0
    after = relay_state(vec)
    for f in before:
        np.testing.assert_array_equal(before[f], after[f], err_msg=f)
    same_relay(relay_state(seq), after, tol=0)
    for b, p, s in zip(vec.buckets, params, steps):
        assert torch.equal(b.opt.step, s)
        for k in p:
            assert torch.equal(b.params[k], p[k]), k


def test_bucketize_groups_by_spec_and_shape():
    g = torch.Generator().manual_seed(0)
    spec = T_SPECS["a"]
    params = [tmlp.init_mlp(g, hidden=64 if i in (0, 3) else 96, device="cpu")
              for i in range(4)]
    buckets = tclient.bucketize([spec] * 4, params)
    assert [ids for _, ids in buckets] == [[0, 3], [1, 2]]
    same = [tmlp.init_mlp(g, device="cpu") for _ in range(4)]
    assert [ids for _, ids in tclient.bucketize([spec] * 4, same)] == \
        [[0, 1, 2, 3]]


def test_hetero_upload_order_and_client_params_round_trip():
    ref, seq, vec = build("flat", "full")
    assert seq._upload_order == vec._upload_order == [0, 2, 1, 3]
    assert vec._client_slot == {0: (0, 0), 2: (0, 1), 1: (1, 0), 3: (1, 1)}
    for i in range(N):
        p = vec.client_params(i)
        assert p["w1"].shape[-1] == (64 if i % 2 == 0 else 96)
        want = {k: np.asarray(v) for k, v in ref.client_params(i).items()}
        got = convert.params_to_numpy(p, "mlp")
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # views into the bucket's stack
    b, j = vec._client_slot[3]
    assert vec.client_params(3)["w1"].data_ptr() == \
        vec.buckets[b].params["w1"][j].data_ptr()


def test_hetero_fedavg_is_refused():
    x, y = synthetic.class_images(64, seed=0)
    parts = partition.uniform_split(x, y, 2, seed=1)
    g = torch.Generator().manual_seed(0)
    ps = [tmlp.init_mlp(g, device="cpu") for _ in range(2)]
    for cls in (tcollab.CollabTrainer, tvec.VectorizedCollabTrainer):
        with pytest.raises(ValueError, match="fedavg"):
            cls([T_SPECS["a"], T_SPECS["b"]], ps, parts, (x, y),
                CollabConfig(mode="fedavg"), TrainConfig(), device="cpu")
