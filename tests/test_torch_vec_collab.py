"""The port's vectorized engine (`repro_torch.core.vec_collab`) against the
JAX reference's `VectorizedCollabTrainer` (one device, no mesh) and against
the port's own sequential engine, round by round, on the same partitions,
converted weights and random draws; and the pieces it adds: the batched
teacher draw, the fixed-shape ring write, stacked parameter conversion and
the fleet features it refuses.

The draws come from the reference's key schedule (`JaxDraws` of
tests/test_torch_collab.py). Tolerances, as tests/test_torch_collab.py holds
the sequential engine: ring integers and ledger exactly; observations and
global prototypes within 1e-4; metrics rtol 1e-3, atol 1e-4; accuracies
within 2e-2. Weights after two rounds: within 1e-4 of the reference's and
of the sequential engine's for the MLP (float32 sums in another order).

LeNet is held looser, for a reason the readings show: the stacked model's
grouped convolutions round differently from per-client ones, and where a
2 x 2 max-pool window holds values equal up to those roundings, the two
engines route the gradient to different positions. On this data that
happens for one client in the first step (conv and fc1 gradients differ by
up to 8e-3 while the loss agrees to 1e-7), and Adam's first step turns each
gradient entry into +-lr, so a flipped sign moves a weight by 2 lr = 2e-3.
That client's uploads then move with its weights. Readings after two
rounds: weights 2.6e-3 apart, grad_norm 4.0e-3 relative, observations
8.3e-3 and global prototypes 4.1e-3 apart; bounds 5e-3, 1e-2 and 2e-2.
The reference's two engines happen to break those ties alike (weights
2.4e-6 and observations 7.3e-7 apart).

`test_vec_step_with_the_model_looped_per_client_equals_seq` settles that
reason: with the model applied client by client in a loop over the stack
instead of under `vmap`, and nothing else of the vectorized step changed,
the LeNet weights, observations and prototypes after two rounds are
bit-equal to the sequential engine's (and 1.2e-6 from the reference's). So
the stacked step adds no error of its own, and the gap above is the
grouped convolutions' rounding alone: the bounds stand.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import client as jclient, vec_collab as jvec
from repro.data import partition, synthetic
from repro.models import cnn as jcnn, mlp as jmlp
from repro.relay import base as jbase, flat as jflat
from repro.types import CollabConfig as JCollabConfig
from repro.types import TrainConfig as JTrainConfig
from repro_torch import convert
from repro_torch.core import client as tclient, collab as tcollab
from repro_torch.core import vec_collab as tvec
from repro_torch.models import cnn as tcnn, mlp as tmlp
from repro_torch.relay import flat as tflat
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
from test_torch_collab import EXACT_FIELDS, JaxDraws

N_CLIENTS = 3
WEIGHT_TOL = {"mlp": 1e-4, "cnn": 5e-3}
GRAD_NORM_RTOL = {"mlp": 1e-3, "cnn": 1e-2}
OBS_TOL = {"mlp": 1e-4, "cnn": 2e-2}      # observations, global prototypes


def _build(kind, mode, seed=0):
    x, y = synthetic.class_images(192, seed=0, noise=0.4)
    tx, ty = synthetic.class_images(128, seed=9, noise=0.4)
    parts = partition.uniform_split(x, y, N_CLIENTS, seed=1)
    kw = dict(mode=mode, num_classes=10, d_feature=84,
              lambda_kd=2.0 if mode == "cors" else 0.0,
              lambda_disc=1.0 if mode == "cors" else 0.0)
    jmod, tmod = (jcnn, tcnn) if kind == "cnn" else (jmlp, tmlp)
    init = jcnn.init_cnn if kind == "cnn" else jmlp.init_mlp
    jparams = [init(k) for k in
               jax.random.split(jax.random.PRNGKey(seed), N_CLIENTS)]
    jspec = jclient.ClientSpec(apply=jmod.apply,
                               head=lambda p: (p["head_w"], p["head_b"]))
    tspec = tclient.ClientSpec(apply=tmod.apply,
                               head=lambda p: (p["head_w"], p["head_b"]))
    ref = jvec.VectorizedCollabTrainer(
        [jspec] * N_CLIENTS, jparams, parts, (tx, ty), JCollabConfig(**kw),
        JTrainConfig(batch_size=32), seed=seed)
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    tparams = [convert.params_from_jax(p, kind, device="cpu")
               for p in np_params]
    args = ([tspec] * N_CLIENTS, tparams, parts, (tx, ty), CollabConfig(**kw),
            TrainConfig(batch_size=32))
    vec = tvec.VectorizedCollabTrainer(*args, seed=seed,
                                       draws=JaxDraws(seed, N_CLIENTS),
                                       device="cpu")
    seq = tcollab.CollabTrainer(*args, seed=seed,
                                draws=JaxDraws(seed, N_CLIENTS), device="cpu")
    stacked = convert.stacked_params_from_jax(np_params, kind, device="cpu")
    for k, v in stacked.items():          # both engines start from one stack
        assert torch.equal(vec.params[k], v), k
    return ref, vec, seq


def _same_round(ra, rb, kind):
    assert ra["participants"] == rb["participants"]
    assert ra["commits"] == rb["commits"]
    assert (ra["comm_up"], ra["comm_down"]) == (rb["comm_up"], rb["comm_down"])
    np.testing.assert_allclose(ra["accs"], rb["accs"], atol=2e-2)
    for ma, mb in zip(ra["metrics"], rb["metrics"]):
        assert sorted(ma) == sorted(mb)
        for k in ma:
            rtol = GRAD_NORM_RTOL[kind] if k == "grad_norm" else 1e-3
            np.testing.assert_allclose(ma[k], mb[k], rtol=rtol, atol=1e-4,
                                       err_msg=k)


def _same_relay(a, b, kind):
    """a: the reference's state (numpy-like), b: the port's."""
    for f in EXACT_FIELDS + ("valid_g",):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy(), err_msg=f)
    np.testing.assert_allclose(np.asarray(a.obs), b.obs.numpy(),
                               atol=OBS_TOL[kind])
    np.testing.assert_allclose(np.asarray(a.global_protos),
                               b.global_protos.numpy(), atol=OBS_TOL[kind])


@pytest.mark.parametrize("kind,mode", [("mlp", "cors"), ("mlp", "il"),
                                       ("cnn", "cors")])
def test_vec_engine_matches_reference_and_seq_engine(kind, mode):
    ref, vec, seq = _build(kind, mode)
    for _ in range(2):
        rj, rv, rs = ref.run_round(), vec.run_round(), seq.run_round()
        _same_round(rj, rv, kind)
        _same_round(rs, rv, kind)
    for other in (ref, seq):
        assert other.ledger.by_round == vec.ledger.by_round
        assert other.ledger.total_bytes == vec.ledger.total_bytes
    _same_relay(ref.relay_state, vec.relay_state, kind)
    _same_relay(seq.server.state, vec.relay_state, kind)
    for i in range(N_CLIENTS):
        got = convert.params_to_numpy(vec.client_params(i), kind)
        want_ref = {k: np.asarray(v) for k, v in ref.client_params(i).items()}
        want_seq = convert.params_to_numpy(seq.clients[i].params, kind)
        for k in got:
            np.testing.assert_allclose(got[k], want_ref[k], atol=WEIGHT_TOL[kind])
            np.testing.assert_allclose(got[k], want_seq[k], atol=WEIGHT_TOL[kind])


def _looped(spec, stacked):
    """`client._apply` with the stacked model run client by client, in a
    loop over the stack, instead of under `torch.func.vmap`."""
    if not stacked:
        return spec.apply

    def run(params, x):
        outs = [spec.apply({k: v[i] for k, v in params.items()}, x[i])
                for i in range(x.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))

    return run


def test_vec_step_with_the_model_looped_per_client_equals_seq(monkeypatch):
    """LeNet cors, two rounds: the vectorized step with the model looped per
    client against the sequential engine, within 1e-4 (the MLP's bound)."""
    monkeypatch.setattr(tclient, "_apply", _looped)
    _, vec, seq = _build("cnn", "cors")
    for _ in range(2):
        _same_round(vec.run_round(), seq.run_round(), "mlp")
    _same_relay(seq.server.state, vec.relay_state, "mlp")
    for i in range(N_CLIENTS):
        got = convert.params_to_numpy(vec.client_params(i), "cnn")
        want = convert.params_to_numpy(seq.clients[i].params, "cnn")
        for k in got:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def _ring(C=4, d=6, cap=8, seed=0):
    """A port ring and the reference's, equal, with owners 0..2, a seed slot
    and empty slots."""
    jc = JCollabConfig(num_classes=C, d_feature=d)
    tc = CollabConfig(num_classes=C, d_feature=d)
    js = jflat.init_relay_state(jc, d, seed=seed, capacity=cap)
    ts = tflat.init_relay_state(tc, d, seed=seed, capacity=cap, device="cpu")
    rng = np.random.default_rng(seed)
    for owner, k in ((0, 2), (1, 1), (2, 2)):
        obs = rng.standard_normal((k, C, d)).astype(np.float32)
        valid = rng.random((k, C)) > 0.3
        own = np.full((k,), owner, np.int32)
        js = jflat.buffer_append(js, obs, valid, own)
        ts = tflat.buffer_append(ts, torch.from_numpy(obs),
                                 torch.from_numpy(valid), torch.from_numpy(own))
    return js, ts


@pytest.mark.parametrize("m_down", [1, 3])
@pytest.mark.parametrize("ring", ["mixed", "one owner", "empty"])
def test_batched_teacher_draw_equals_per_client(m_down, ring):
    """The batched draw's indices equal the port's per-client draw and the
    reference's `flat.sample_teacher` for every client, under the
    reference's own noise; the fallbacks (every slot a client's own, an
    empty ring) hold per client."""
    js, ts = _ring()
    if ring != "mixed":
        own = np.full((ts.capacity,), 0 if ring == "one owner" else
                      jbase.EMPTY_OWNER, np.int32)
        js, ts = js._replace(owner=own), ts._replace(owner=torch.from_numpy(own))
    ids = [0, 1, 2, 3, 7]
    for seed in range(4):
        keys = jax.random.split(jax.random.PRNGKey(seed), len(ids))
        noise, picks, want = [], [], []
        for i, k in zip(ids, keys):
            want.append(jflat.sample_teacher(js, i, m_down, k))
            k_sample, k_pick = jax.random.split(k)
            noise.append(np.asarray(jax.random.gumbel(k_sample, (m_down, ts.capacity))))
            picks.append(int(jax.random.randint(k_pick, (), 0, m_down)))
        got = tflat.sample_teachers(ts, torch.tensor(ids), m_down,
                                    torch.tensor(np.stack(noise)),
                                    torch.tensor(picks))
        for j, i in enumerate(ids):
            one = tflat.sample_teacher(ts, i, m_down, torch.tensor(noise[j]),
                                       picks[j])
            for k in ("obs", "valid_o", "global_protos", "valid_g"):
                assert torch.equal(got[k][j], one[k]), k
                np.testing.assert_array_equal(got[k][j].numpy(),
                                              np.asarray(want[j][k]), err_msg=k)
            assert int(got["obs_pick"][j]) == one["obs_pick"] == int(want[j]["obs_pick"])


def _append_by_boolean_index(state, obs_rows, valid_rows, owner_rows,
                             row_mask=None, stamp_rows=None):
    """The ring write as the sequential engine first had it: the kept rows
    picked by boolean indexing (which waits on the card)."""
    from repro_torch.relay import base
    k = obs_rows.shape[0]
    idx, new_ptr = base.ring_indices(state.ptr, k, state.capacity, row_mask)
    stamps = base.stamps_or_now(state, k, stamp_rows)
    keep = idx < state.capacity
    idx = idx[keep].long()

    def put(buf, rows):
        out = buf.clone()
        out[idx] = rows[keep].to(buf.dtype)
        return out

    return state._replace(obs=put(state.obs, obs_rows.float()),
                          valid=put(state.valid, valid_rows),
                          owner=put(state.owner, owner_rows),
                          stamp=put(state.stamp, stamps), ptr=new_ptr)


@pytest.mark.parametrize("k,mask,stamp", [
    (3, None, None), (5, [1, 0, 1, 1, 0], None), (4, [0, 0, 0, 0], 7),
    (8, None, 2),                       # a whole ring's worth
    (6, [1, 1, 0, 1, 1, 1], None)])
@pytest.mark.parametrize("ptr", [0, 5, 7])          # 5, 7: the write wraps
def test_fixed_shape_ring_write_equals_boolean_index_form(k, mask, stamp, ptr):
    _, ts = _ring()
    ts = ts._replace(ptr=torch.tensor(ptr, dtype=torch.int32))
    g = torch.Generator().manual_seed(k + ptr)
    obs = torch.randn(k, 4, 6, generator=g)
    valid = torch.rand(k, 4, generator=g) > 0.3
    own = torch.arange(k, dtype=torch.int32) + 10
    m = None if mask is None else torch.tensor(mask, dtype=torch.bool)
    st = None if stamp is None else torch.full((k,), stamp, dtype=torch.int32)
    got = tflat.buffer_append(ts, obs, valid, own, m, st)
    want = _append_by_boolean_index(ts, obs, valid, own, m, st)
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and torch.equal(a, b), f


def test_stacked_params_round_trip():
    """Stacked reference parameters keep their client axis through both
    conversions, conv weights transposed after it."""
    jparams = [jcnn.init_cnn(k) for k in
               jax.random.split(jax.random.PRNGKey(1), 4)]
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    stacked = convert.stacked_params_from_jax(np_params, "cnn", device="cpu")
    for i, p in enumerate(np_params):
        one = convert.params_from_jax(p, "cnn", device="cpu")
        for k in one:
            assert torch.equal(stacked[k][i], one[k]), k
    back = convert.params_to_numpy(stacked, "cnn")
    for k in back:
        np.testing.assert_array_equal(back[k], np.stack([p[k] for p in np_params]))


class _FourRankMesh:
    """A stand-in with a DeviceMesh's axis surface: "clients" over 4 ranks
    (the fleet-size guard runs before anything needs a process group)."""
    mesh_dim_names = ("clients",)

    def size(self, dim=None):
        return 4


def test_vec_engine_rejects_what_it_does_not_run():
    x, y = synthetic.class_images(64, seed=0)
    parts = partition.uniform_split(x, y, 2, seed=1)
    spec = tclient.ClientSpec(apply=tmlp.apply,
                              head=lambda p: (p["head_w"], p["head_b"]))
    g = torch.Generator().manual_seed(0)
    p = [tmlp.init_mlp(g, device="cpu") for _ in range(2)]
    args = ([spec] * 2, p, parts, (x, y))
    with pytest.raises(ValueError, match="unknown mode"):
        tvec.VectorizedCollabTrainer(*args, CollabConfig(mode="fl"),
                                     TrainConfig(), device="cpu")
    # a mesh must be a DeviceMesh with a "clients" axis, whose size divides
    # the fleet (the reference's guard, in its words); the mesh runs are in
    # tests/test_torch_placement.py and tests/test_torch_multidevice.py
    with pytest.raises(ValueError, match="DeviceMesh with a 'clients' axis"):
        tvec.VectorizedCollabTrainer(*args, CollabConfig(), TrainConfig(),
                                     fleet=FleetConfig(mesh=object()),
                                     device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        tvec.VectorizedCollabTrainer(*args, CollabConfig(), TrainConfig(),
                                     fleet=FleetConfig(mesh=_FourRankMesh()),
                                     device="cpu")
    for fleet in (FleetConfig(policy="sharded:flat,2"),
                  FleetConfig(arrivals="stream:2,1,0.1,100,0")):
        tvec.VectorizedCollabTrainer(*args, CollabConfig(), TrainConfig(),
                                     fleet=fleet, device="cpu")
    assert tvec.VectorizedCollabTrainer(*args, CollabConfig(), TrainConfig(),
                                        telemetry=True, device="cpu")._telem
    with pytest.raises(TypeError, match="telemetry"):
        tvec.VectorizedCollabTrainer(*args, CollabConfig(), TrainConfig(),
                                     telemetry="yes", device="cpu")
    other = tclient.ClientSpec(apply=tmlp.apply,
                               head=lambda p: (p["head_w"], p["head_b"]))
    with pytest.raises(ValueError, match="fedavg"):
        tvec.VectorizedCollabTrainer([spec, other], p, parts, (x, y),
                                     CollabConfig(mode="fedavg"),
                                     TrainConfig(), device="cpu")
