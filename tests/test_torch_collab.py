"""The port's sequential CollabTrainer against the JAX reference's, round by
round, on the same partitions, converted weights and random draws.

The draws come from the reference's own key schedule (`collab.round_keys`):
Gumbel noise and the observation pick for each teacher
(`relay/flat.py:147-156`), uniform priorities for each upload's observation
draw (`core/prototypes.py:90`). Ring bookkeeping and the ledger must match
exactly; observations and prototypes within 1e-4 (float32 sums in another
order, through two local-update rounds); accuracies within the 2e-2 that
tests/test_vec_collab.py allows between two engines of the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jclient, collab as jcollab
from repro.data import partition, synthetic
from repro.models import cnn as jcnn, mlp as jmlp
from repro.types import CollabConfig as JCollabConfig
from repro.types import TrainConfig as JTrainConfig
from repro_torch import convert
from repro_torch.core import client as tclient, collab as tcollab
from repro_torch.models import cnn as tcnn, mlp as tmlp
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig

EXACT_FIELDS = ("ptr", "owner", "valid", "stamp", "clock")


class JaxDraws:
    """The reference trainer's random numbers, drawn from its key schedule
    and handed to the port."""

    def __init__(self, seed: int, n_clients: int):
        self.key = jax.random.PRNGKey(seed)
        self.n = n_clients
        self.rounds = []

    def _round(self, r):
        while len(self.rounds) <= r:
            self.key, relay_ks, _, upl_ks = jcollab.round_keys(self.key, self.n)
            self.rounds.append((relay_ks, upl_ks))
        return self.rounds[r]

    def teacher(self, r, i, m_down, shape):
        """Gumbel noise of the policy's `noise_shape` from the relay key's
        sample half, the pick from its other half, as every reference
        policy splits it."""
        k_sample, k_pick = jax.random.split(self._round(r)[0][i])
        noise = jax.random.gumbel(k_sample, tuple(shape))
        pick = jax.random.randint(k_pick, (), 0, m_down, dtype=jnp.int32)
        return torch.from_numpy(np.array(noise)), int(pick)

    def priorities(self, r, i, m_up, n):
        keys = jax.random.split(self._round(r)[1][i], m_up)
        return torch.from_numpy(np.stack(
            [np.array(jax.random.uniform(k, (n,))) for k in keys]))


def _build(kind, mode, n_clients=3, n=192, seed=0):
    x, y = synthetic.class_images(n, seed=0, noise=0.4)
    tx, ty = synthetic.class_images(128, seed=9, noise=0.4)
    parts = partition.uniform_split(x, y, n_clients, seed=1)
    kw = dict(mode=mode, num_classes=10, d_feature=84,
              lambda_kd=2.0 if mode == "cors" else 0.0,
              lambda_disc=1.0 if mode == "cors" else 0.0)
    jmod, tmod = (jcnn, tcnn) if kind == "cnn" else (jmlp, tmlp)
    init = jcnn.init_cnn if kind == "cnn" else jmlp.init_mlp
    jparams = [init(k) for k in
               jax.random.split(jax.random.PRNGKey(seed), n_clients)]
    jspec = jclient.ClientSpec(apply=jmod.apply,
                               head=lambda p: (p["head_w"], p["head_b"]))
    tspec = tclient.ClientSpec(apply=tmod.apply,
                               head=lambda p: (p["head_w"], p["head_b"]))
    ref = jcollab.CollabTrainer([jspec] * n_clients, jparams, parts, (tx, ty),
                                JCollabConfig(**kw), JTrainConfig(batch_size=32),
                                seed=seed)
    tparams = [convert.params_from_jax(
        {k: np.asarray(v) for k, v in p.items()}, kind, device="cpu")
        for p in jparams]
    port = tcollab.CollabTrainer([tspec] * n_clients, tparams, parts,
                                 (tx, ty), CollabConfig(**kw),
                                 TrainConfig(batch_size=32), seed=seed,
                                 draws=JaxDraws(seed, n_clients), device="cpu")
    return ref, port


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
@pytest.mark.parametrize("mode", ["cors", "il"])
def test_port_trainer_matches_reference(kind, mode):
    ref, port = _build(kind, mode)
    for _ in range(2):
        rj, rt = ref.run_round(), port.run_round()
        assert rj["participants"] == rt["participants"]
        assert rj["commits"] == rt["commits"]
        np.testing.assert_allclose(rj["accs"], rt["accs"], atol=2e-2)
        for mj, mt in zip(rj["metrics"], rt["metrics"]):
            assert sorted(mj) == sorted(mt)
            for k in mj:
                np.testing.assert_allclose(mj[k], mt[k], rtol=1e-3, atol=1e-4,
                                           err_msg=k)
    assert ref.ledger.by_round == port.ledger.by_round
    assert ref.ledger.total_bytes == port.ledger.total_bytes
    sj, st = ref.server.state, port.server.state
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      getattr(st, f).numpy(), err_msg=f)
    np.testing.assert_allclose(np.asarray(sj.obs), st.obs.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(sj.global_protos),
                               st.global_protos.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(sj.valid_g), st.valid_g.numpy())


def test_port_trainer_rejects_what_it_does_not_run():
    x, y = synthetic.class_images(64, seed=0)
    spec = tclient.ClientSpec(apply=tmlp.apply,
                              head=lambda p: (p["head_w"], p["head_b"]))
    p = [tmlp.init_mlp(torch.Generator().manual_seed(0), device="cpu")]
    args = ([spec], p, [(x, y)], (x, y))
    with pytest.raises(ValueError, match="unknown mode"):
        tcollab.CollabTrainer(*args, CollabConfig(mode="fl"), TrainConfig(),
                              device="cpu")
    for fleet in (FleetConfig(policy="sharded:flat,2"),
                  FleetConfig(clock="lognormal:4"),
                  FleetConfig(download_clock="periodic:3,4"),
                  FleetConfig(arrivals="stream:2,1,0.1,100,0"),
                  FleetConfig(mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcollab.CollabTrainer(*args, CollabConfig(), TrainConfig(),
                                  fleet=fleet, device="cpu")


def test_port_trainer_default_draws_are_deterministic():
    """Two runs of one seed with the default torch draws agree exactly."""
    x, y = synthetic.class_images(96, seed=0, noise=0.4)
    parts = partition.uniform_split(x, y, 2, seed=1)
    spec = tclient.ClientSpec(apply=tmlp.apply,
                              head=lambda p: (p["head_w"], p["head_b"]))

    def run():
        g = torch.Generator().manual_seed(3)
        ps = [tmlp.init_mlp(g, device="cpu") for _ in range(2)]
        t = tcollab.CollabTrainer([spec] * 2, ps, parts, (x, y),
                                  CollabConfig(lambda_kd=2.0), TrainConfig(),
                                  seed=5, device="cpu")
        t.run(2)
        return t
    a, b = run(), run()
    for f in a.server.state._fields:
        assert torch.equal(getattr(a.server.state, f),
                           getattr(b.server.state, f)), f
    assert a.history[-1]["accs"] == b.history[-1]["accs"]
