"""The paper's Table 1 baselines in the port (fd, fedavg, il, cl) against the
reference, in both engines, and the pieces they add: `losses.fd_loss`,
`baselines.fedavg_aggregate` and `num_params`, the own copy of
`specs.parse_spec`, and the twin's new modes.

The engine tests hold, as tests/test_torch_relay_policies.py does (its
helpers and tolerances), the port's sequential engine against the
reference's `CollabTrainer`, the port's vectorized engine against the
reference's `VectorizedCollabTrainer` and against the port's sequential
engine, with MLP clients: fd under every relay policy (fd's half of the
reference's policy x mode matrix), and fedavg, il and cl (il on one client
holding all the data). Ring integers and ledger exactly; observations,
global prototypes, mean logits and weights within 1e-4; accuracies within
2e-2. fedavg's two engines average in different forms, each its reference
engine's: the sequential one as a Python sum of w . p with w = 1/n, the
vectorized one as sum(p) / n in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import specs as jspecs
from repro.core import baselines as jbase, losses as jlosses
from repro.data import synthetic
from repro_torch import specs as tspecs
from repro_torch.core import baselines as tbase, client as tclient
from repro_torch.core import collab as tcollab, losses as tlosses
from repro_torch.models import mlp as tmlp
from repro_torch.types import CollabConfig, TrainConfig
from test_torch_relay_policies import (POLICIES, build_four, relay_state,
                                       run_and_compare)


@pytest.mark.parametrize("policy", POLICIES)
def test_fd_engines_match_reference_under_every_policy(policy):
    trainers = build_four(policy, "fd")
    run_and_compare(trainers)
    ml = relay_state(trainers[3])["mean_logits"]
    assert np.abs(ml).max() > 0 and np.isfinite(ml).all()


@pytest.mark.parametrize("mode,n_clients", [("fedavg", 3), ("il", 3),
                                            ("cl", 1)])
def test_baseline_engines_match_reference(mode, n_clients):
    trainers = build_four("flat", mode, n_clients=n_clients)
    run_and_compare(trainers)
    if mode == "fedavg":
        for t in trainers[2:]:                 # every client holds the average
            p = [t.clients[i].params if hasattr(t, "clients")
                 else t.client_params(i) for i in range(n_clients)]
            for k in p[0]:
                assert all(torch.equal(p[0][k], q[k]) for q in p[1:]), k
        seq = trainers[2]                       # and its own tensors
        ptrs = {v.data_ptr() for c in seq.clients for v in c.params.values()}
        assert len(ptrs) == n_clients * len(seq.clients[0].params)
        rec = seq.history[-1]
        size = tbase.num_params(seq.clients[0].params)
        assert rec["comm_up"] == rec["comm_down"] == n_clients * size


def test_fd_loss_matches_reference():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((3, 32, 10)).astype(np.float32)
    ml = rng.standard_normal((3, 10, 10)).astype(np.float32)
    y = rng.integers(0, 10, (3, 32)).astype(np.int32)
    valid = rng.random((3, 10)) > 0.3
    for v in (None, valid):
        got = tlosses.fd_loss(torch.from_numpy(lg), torch.from_numpy(ml),
                              torch.from_numpy(y),
                              None if v is None else torch.from_numpy(v))
        for i in range(3):
            want = jlosses.fd_loss(jnp.asarray(lg[i]), jnp.asarray(ml[i]),
                                   jnp.asarray(y[i]),
                                   None if v is None else jnp.asarray(v[i]))
            one = tlosses.fd_loss(torch.from_numpy(lg[i]),
                                  torch.from_numpy(ml[i]),
                                  torch.from_numpy(y[i]),
                                  None if v is None else torch.from_numpy(v[i]))
            np.testing.assert_allclose(float(got[i]), float(want), rtol=1e-6)
            assert torch.equal(one, got[i])
    none = tlosses.fd_loss(torch.from_numpy(lg[0]), torch.from_numpy(ml[0]),
                           torch.from_numpy(y[0]), torch.zeros(10, dtype=torch.bool))
    assert float(none) == 0.0              # no valid class: 0, not nan


@pytest.mark.parametrize("weights", [None, [0.5, 0.25, 0.25]])
def test_fedavg_aggregate_matches_reference(weights):
    rng = np.random.default_rng(1)
    ps = [{"w": rng.standard_normal((4, 5)).astype(np.float32),
           "b": rng.standard_normal((5,)).astype(np.float32)} for _ in range(3)]
    tps = [{k: torch.from_numpy(v.copy()) for k, v in p.items()} for p in ps]
    got = tbase.fedavg_aggregate(tps, weights)
    want = jbase.fedavg_aggregate([{k: jnp.asarray(v) for k, v in p.items()}
                                   for p in ps], weights)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert all(got[k].data_ptr() != p[k].data_ptr() for p in tps)
    for p, t in zip(ps, tps):                  # inputs untouched
        for k in p:
            np.testing.assert_array_equal(t[k].numpy(), p[k])
    assert tbase.num_params(tps[0]) == jbase.num_params(
        {k: jnp.asarray(v) for k, v in ps[0].items()}) == 25


@pytest.mark.parametrize("spec", ["flat", "staleness:0.25", "staleness:",
                                  "staleness:1,2,", "sharded:flat,4,2",
                                  "per-class", "nope:3", "", None, 7])
def test_parse_spec_equals_reference(spec):
    names = ("flat", "per_class", "staleness", "sharded")
    aliases = {"per-class": "per_class"}
    for kw in ({}, {"aliases": aliases}):
        try:
            want = jspecs.parse_spec(spec, "relay policy", names, **kw)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tspecs.parse_spec(spec, "relay policy", names, **kw)
            assert str(got.value) == str(e)
        else:
            assert tspecs.parse_spec(spec, "relay policy", names, **kw) == want


def test_fedavg_refuses_a_mixed_fleet():
    x, y = synthetic.class_images(64, seed=0)
    specs = [tclient.ClientSpec(apply=tmlp.apply,
                                head=lambda p: (p["head_w"], p["head_b"]))
             for _ in range(2)]                 # two buckets
    g = torch.Generator().manual_seed(0)
    ps = [tmlp.init_mlp(g, device="cpu") for _ in range(2)]
    with pytest.raises(ValueError, match="fedavg"):
        tcollab.CollabTrainer(specs, ps, [(x, y), (x, y)], (x, y),
                              CollabConfig(mode="fedavg"), TrainConfig(),
                              device="cpu")


@pytest.mark.parametrize("mode", ["fd", "fedavg"])
def test_twin_runs_the_new_modes(mode, capsys):
    from repro_torch import collab_image_classification as twin
    twin.main(["--rounds", "1", "--clients", "2", "--device", "cpu",
               "--engine", "seq", "--mode", mode,
               "--relay-policy", "staleness:0.5"])
    out = capsys.readouterr().out
    assert f"mode={mode}" in out and "relay=staleness:0.5" in out
    assert "round   1 acc" in out and "best mean accuracy" in out


def test_twin_builds_cl_on_one_client():
    from repro_torch import collab_image_classification as twin
    t = twin.build_trainer(1, "cl", device="cpu")
    rec = t.run_round()
    assert len(rec["accs"]) == 1 and t.ledger.total_bytes == 0.0
    assert 0.0 <= rec["acc_mean"] <= 1.0


@pytest.mark.parametrize("engine", ["seq", "vec"])
def test_twin_runs_late_uploads_and_stale_downloads(engine, capsys):
    """--clock-model parks every upload a round (round 1 commits nothing,
    round 2 commits round 1's births) and --download-clock binds a ring."""
    from repro_torch import collab_image_classification as twin
    twin.main(["--rounds", "2", "--clients", "2", "--device", "cpu",
               "--engine", engine, "--clock-model", "homogeneous:1",
               "--download-clock", "homogeneous:1"])
    out = capsys.readouterr().out
    assert "clock=homogeneous:1, download clock=homogeneous:1" in out
    assert "commits []" in out and "commits [[0, 0], [0, 1]]" in out
    t = twin.build_trainer(2, "cors", device="cpu", engine=engine,
                           clock="lognormal:2", download_clock="periodic:2,3")
    assert t.clock.d_max == 2 and t._lagged and t.dl_clock.d_max == 2
