"""LM training of the port (`repro_torch.launch.train`, `optim`,
`losses.disc_loss_sampled`, `data.synthetic.lm_batches`) against the
reference's, on the CPU.

The reduced TinyLlama (2 layers, d 64, vocab 64, float32) starts from the
reference's `init_state` through `convert.train_state_from_jax`; batches
(2 clients x B 2 x S 32) come from a numpy seed; the negative classes are
the reference's own draws (`randint(split(key_i)[0], (K,), 0, C)` for each
client's key), passed to the port. Tolerances:
- losses and metrics: 1e-5 relative (float32 math summed in another order);
- gradients before Adam: 1e-4 relative + 1e-5 x max|g| (a recurrent
  model's float32 sums cancel);
- parameters and Adam moments after 2 steps: Adam's first steps move an
  element by about lr whatever its gradient's size, so one whose gradient
  is ~0 in float32 may move either way: |d| <= 2 lr a step (4e-3), and at
  most 1% of the elements beyond 1e-5;
- ProtoState: counts equal, sums within 1e-4 x max(1, |sum|);
- round syncs, SGD, clipping, the cosine schedule and Adam on a nested
  tree: 1e-6 (the same float32 operations);
- `lm_batches`: bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import ARCHS as JARCHS, get_arch as jget_arch
from repro.core import losses as jlosses, prototypes as jproto
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.optim import optim as joptim
from repro.types import CollabConfig as JCollab
from repro_torch import convert
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_arch
from repro_torch.core import losses, prototypes
from repro_torch.data import synthetic
from repro_torch.launch import train
from repro_torch.optim import optim
from repro_torch.tree import leaves, tree_map
from repro_torch.types import CollabConfig

V, D, N, K, LR = 64, 64, 2, 16, 1e-3
STEPS, DISC_T = 2, 40
TIGHT = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch="tinyllama-1.1b"):
    return (get_arch(arch).reduced(vocab_size=V, d_model=D),
            jget_arch(arch).reduced(vocab_size=V, d_model=D))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed, B=2, S=32):
    toks = np.random.default_rng(seed).integers(0, V, (N, B, S + 1)
                                                ).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _negatives(key, n=N, k=K, c=V):
    """The reference's draw inside `make_loss_fn`, one row a client."""
    return np.stack([np.asarray(jax.random.randint(
        jax.random.split(ki)[0], (k,), 0, c)) for ki in jax.random.split(key, n)])


def _close_adam(got, want, steps=STEPS, what=""):
    """A client-stacked LM (or encoder-decoder) tree of the port against the
    reference's, leaf by leaf under the checkpoint keys."""
    conv = (convert.encdec_params_to_numpy if "enc_layers" in got
            else convert.lm_params_to_numpy)
    g = tio._paths(conv(got, clients=True))
    w = jio._paths(want)
    assert sorted(g) == sorted(w), what
    far = total = 0
    for k in w:
        d = np.abs(g[k].astype(np.float64) - np.asarray(w[k]))
        assert d.max() <= 2 * LR * steps, (what, k, d.max())
        far += int((d > 1e-5).sum())
        total += d.size
    assert far <= 0.01 * total, (what, far, total)


def _ccfgs(mode, momentum=0.0):
    kw = dict(mode=mode, num_classes=V, d_feature=D, num_negatives=K,
              proto_momentum=momentum)
    return CollabConfig(**kw), JCollab(**kw)


def _start(jcfg):
    js = jtrain.init_state(jcfg, jax.random.PRNGKey(0), N)
    return js, convert.train_state_from_jax(_np(js), device="cpu")


# -- the train step -------------------------------------------------------
CASES = [("cors", True, None, 0.0), ("cors", False, None, 0.0),
         ("cors", True, (True, False), 0.0), ("cors", True, None, 0.5),
         ("fd", True, None, 0.0), ("fd", False, (False, True), 0.0),
         ("il", True, None, 0.0), ("il", True, (True, False), 0.0),
         ("fedavg", True, None, 0.0), ("fedavg", True, (False, True), 0.0)]


@pytest.mark.parametrize("mode,sync,mask,momentum", CASES)
def test_train_step_matches_reference(mode, sync, mask, momentum):
    """Two steps of `make_train_step` in both packages: metrics every step,
    then parameters, Adam state, ProtoState and steps."""
    cfg, jcfg = _cfgs()
    ccfg, jccfg = _ccfgs(mode, momentum)
    js, ts = _start(jcfg)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jccfg, n_clients=N,
                                           disc_tokens=DISC_T,
                                           sync_in_step=sync))
    tstep = train.make_train_step(cfg, ccfg, n_clients=N, disc_tokens=DISC_T,
                                  sync_in_step=sync)
    part = None if mask is None else np.array(mask)
    for s in range(STEPS):
        b = _batch(10 + s)
        key = jax.random.PRNGKey(100 + s)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()}, key,
                       None if part is None else jnp.asarray(part))
        ts, tm = tstep(ts, {k: _t(v) for k, v in b.items()},
                       _t(_negatives(key)),
                       None if part is None else torch.from_numpy(part))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {s} {k}")
    jn = _np(js)
    _close_adam(ts.params, jn.params, what="params")
    _close_adam(ts.opt.m, jn.opt.m, what="m")
    _close_adam(ts.opt.v, jn.opt.v, what="v")
    np.testing.assert_array_equal(ts.opt.step.numpy(), jn.opt.step)
    assert int(ts.step) == int(jn.step) == STEPS
    np.testing.assert_array_equal(ts.proto.count.numpy(), jn.proto.count)
    np.testing.assert_allclose(ts.proto.sum.numpy(), jn.proto.sum, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(jn.proto.sum).max()))
    if mask is not None:                 # absent clients froze bit for bit
        i = mask.index(False)
        start = convert.train_state_from_jax(
            _np(jtrain.init_state(jcfg, jax.random.PRNGKey(0), N)),
            device="cpu")
        for a, b in zip(leaves(ts.params), leaves(start.params)):
            assert torch.equal(a[i], b[i])
        assert int(ts.opt.step[i]) == 0


def test_proto_accum_runs_once_a_step_where_the_step_merges():
    """The upload stats go through prototypes.accumulate with the client
    axis in cors and fd with sync_in_step, and not elsewhere."""
    cfg, jcfg = _cfgs()
    _, ts = _start(jcfg)
    b = {k: _t(v) for k, v in _batch(3).items()}
    neg = _t(_negatives(jax.random.PRNGKey(3)))
    calls = []
    real = prototypes.accumulate

    def spy(state, f, y):
        calls.append(tuple(f.shape))
        return real(state, f, y)

    prototypes.accumulate = spy
    try:
        for mode, sync, want in (("cors", True, 1), ("fd", True, 1),
                                 ("cors", False, 0), ("il", True, 0),
                                 ("fedavg", True, 0)):
            calls.clear()
            ccfg, _ = _ccfgs(mode)
            train.make_train_step(cfg, ccfg, n_clients=N, disc_tokens=DISC_T,
                                  sync_in_step=sync)(ts, b, neg)
            assert len(calls) == want, (mode, sync)
            if want:
                assert calls[0] == (N, 2 * 32, D)
    finally:
        prototypes.accumulate = real


@pytest.mark.parametrize("mode", ["cors", "fd", "il", "fedavg"])
def test_loss_and_gradients_match_reference(mode, monkeypatch,
                                            arch="tinyllama-1.1b"):
    """Each mode's gradients before Adam: those `make_train_step` hands to
    `adam_update`, every client's, against jax.value_and_grad of the
    reference's `make_loss_fn` under the keys its step splits, with
    non-empty prototypes; the step's metrics against the clients' mean,
    and one client's `make_loss_fn` metrics against the reference's (the
    xLSTM's: tests/test_torch_xlstm.py)."""
    cfg, jcfg = _cfgs(arch)
    ccfg, jccfg = _ccfgs(mode)
    js, ts = _start(jcfg)
    rng = np.random.default_rng(4)
    ps = rng.standard_normal((V, D)).astype(np.float32)
    pc = rng.integers(0, 3, V).astype(np.float32)
    js = js._replace(proto=jproto.ProtoState(jnp.asarray(ps), jnp.asarray(pc)))
    ts = ts._replace(proto=prototypes.ProtoState(_t(ps), _t(pc)))
    means = jproto.means(js.proto)
    b = _batch(5)
    key = jax.random.PRNGKey(7)
    (_, (jm, _, _)), jg = jax.jit(jax.vmap(jax.value_and_grad(
        jtrain.make_loss_fn(jcfg, jccfg, disc_tokens=DISC_T), has_aux=True),
        in_axes=(0, 0, None, 0)))(
            js.params, {k: jnp.asarray(v) for k, v in b.items()}, means,
            jax.random.split(key, N))
    seen = []
    real = train.adam_update

    def spy(params, grads, opt, **kw):
        seen.append(grads)
        return real(params, grads, opt, **kw)

    monkeypatch.setattr(train, "adam_update", spy)
    neg = _t(_negatives(key))
    tb = {k: _t(v) for k, v in b.items()}
    _, tm = train.make_train_step(cfg, ccfg, n_clients=N,
                                  disc_tokens=DISC_T)(ts, tb, neg)
    assert len(seen) == 1 and sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jnp.mean(jm[k])),
                                   rtol=1e-5, err_msg=k)
    _, m0, feats, _ = train.client_grads(
        train.make_loss_fn(cfg, ccfg, disc_tokens=DISC_T),
        tree_map(lambda a: a[0], ts.params), {k: v[0] for k, v in tb.items()},
        _t(np.asarray(means)), neg[0])
    for k in jm:
        np.testing.assert_allclose(float(m0[k]), float(jm[k][0]), rtol=1e-5,
                                   err_msg=k)
    assert feats.shape == (2, 32, D) and not feats.requires_grad
    got = tio._paths(convert.lm_params_to_numpy(seen[0], clients=True))
    want = jio._paths(_np(jg))
    assert sorted(got) == sorted(want)
    for path in want:
        w = np.asarray(want[path])
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * max(scale, 1e-3), err_msg=path)


def test_fedavg_and_participation_means():
    """fedavg leaves every client with the same weights; metrics under a
    mask are means over the present clients."""
    cfg, jcfg = _cfgs()
    _, ts = _start(jcfg)
    ccfg, _ = _ccfgs("fedavg")
    b = {k: _t(v) for k, v in _batch(6).items()}
    new, m = train.make_train_step(cfg, ccfg, n_clients=N)(ts, b)
    for a in leaves(new.params):
        assert torch.equal(a[0], a[1])
    ccfg, _ = _ccfgs("il")
    step = train.make_train_step(cfg, ccfg, n_clients=N)
    _, full = step(ts, b)
    _, only0 = step(ts, b, participation=torch.tensor([True, False]))
    _, only1 = step(ts, b, participation=torch.tensor([False, True]))
    np.testing.assert_allclose(
        float(full["ce"]), (float(only0["ce"]) + float(only1["ce"])) / 2,
        rtol=1e-6)


# -- round syncs ----------------------------------------------------------
def _protos(rng, lead=()):
    s = rng.standard_normal(lead + (V, D)).astype(np.float32)
    c = rng.integers(0, 4, lead + (V,)).astype(np.float32)
    return s, c


def _jstate(s, c):
    return jtrain.TrainState(None, None, jproto.ProtoState(jnp.asarray(s),
                                                            jnp.asarray(c)),
                             jnp.zeros((), jnp.int32))


def _tstate(s, c):
    return train.TrainState(None, None, prototypes.ProtoState(_t(s), _t(c)),
                            torch.zeros((), dtype=torch.int32))


def _same_proto(t, j, what=""):
    np.testing.assert_allclose(t.sum.numpy(), np.asarray(j.sum), rtol=TIGHT,
                               atol=TIGHT, err_msg=what)
    np.testing.assert_allclose(t.count.numpy(), np.asarray(j.count),
                               rtol=TIGHT, atol=TIGHT, err_msg=what)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_round_sync_matches_reference(momentum):
    rng = np.random.default_rng(0)
    ccfg, jccfg = _ccfgs("cors", momentum)
    s, c = _protos(rng)
    buckets = [_protos(rng, (2,)), _protos(rng, (3,))]
    want = jtrain.make_round_sync(jccfg)(
        _jstate(s, c), *[jproto.ProtoState(jnp.asarray(a), jnp.asarray(b))
                         for a, b in buckets])
    got = train.make_round_sync(ccfg)(
        _tstate(s, c), *[prototypes.ProtoState(_t(a), _t(b))
                         for a, b in buckets])
    _same_proto(got.proto, want.proto)


@pytest.mark.parametrize("d_max", [0, 2])
def test_async_round_sync_matches_reference_with_out_of_range_delays(d_max):
    """Delays past d_max and below -(d_max+1) are dropped, negative ones
    in range count from the end, as the reference's scatter with
    mode="drop" does; pending and proto equal every round."""
    rng = np.random.default_rng(1)
    ccfg, jccfg = _ccfgs("cors", 0.5)
    j_init, j_sync = jtrain.make_async_round_sync(jccfg, d_max)
    t_init, t_sync = train.make_async_round_sync(ccfg, d_max)
    jp, tp = j_init(V, D), t_init(V, D, device="cpu")
    s, c = _protos(rng)
    js, ts = _jstate(s, c), _tstate(s, c)
    for delays in ([5, -1, 0], [-4, 2, 1], [1, 1, 3], [0, -7, 2]):
        b1 = _protos(rng, (3,))
        b2 = _protos(rng, (2,))
        d2 = [0, 1]
        js, jp = j_sync(js, jp, jnp.asarray(delays, jnp.int32),
                        jproto.ProtoState(*map(jnp.asarray, b1)),
                        jnp.asarray(d2, jnp.int32),
                        jproto.ProtoState(*map(jnp.asarray, b2)))
        ts, tp = t_sync(ts, tp, torch.tensor(delays), prototypes.ProtoState(
            *map(_t, b1)), torch.tensor(d2), prototypes.ProtoState(
            *map(_t, b2)))
        _same_proto(ts.proto, js.proto, f"proto {delays}")
        _same_proto(tp, jp, f"pending {delays}")
        assert tuple(tp.sum.shape) == (d_max, V, D)


def test_download_lag_round_sync_matches_reference():
    rng = np.random.default_rng(2)
    ccfg, jccfg = _ccfgs("cors")
    j_init, j_sync, j_read = jtrain.make_download_lag_round_sync(jccfg, 3)
    t_init, t_sync, t_read = train.make_download_lag_round_sync(ccfg, 3)
    jh, th = j_init(V, D), t_init(V, D, device="cpu")
    s, c = _protos(rng)
    js, ts = _jstate(s, c), _tstate(s, c)
    for r in range(4):
        b = _protos(rng, (2,))
        js, jh = j_sync(js, jh, jproto.ProtoState(*map(jnp.asarray, b)))
        ts, th = t_sync(ts, th, prototypes.ProtoState(*map(_t, b)))
        _same_proto(ts.proto, js.proto, f"round {r}")
        for d in (0, 1, 2, 5):
            _same_proto(t_read(th, d), j_read(jh, d), f"round {r} read {d}")
        _same_proto(t_read(th, torch.tensor([2, 0, 1])),
                    j_read(jh, jnp.asarray([2, 0, 1])), f"round {r} vector")
    assert int(th.head) == int(jh.head)


def test_proto_round_telemetry_matches_reference():
    rng = np.random.default_rng(3)
    a, b = _protos(rng), _protos(rng)
    want = jtrain.proto_round_telemetry(
        jproto.ProtoState(*map(jnp.asarray, a)),
        jproto.ProtoState(*map(jnp.asarray, b)))
    got = train.proto_round_telemetry(prototypes.ProtoState(*map(_t, a)),
                                      prototypes.ProtoState(*map(_t, b)))
    assert sorted(got) == sorted(want)
    assert got["classes_seen"] == want["classes_seen"]
    for k in ("proto_drift", "proto_mass"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


# -- optimizers -----------------------------------------------------------
def _tree(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": f(3, 4), "segments": [{"a": f(2)}, {"a": f(2), "b": f(5)}]}


def _both(tree, bf16=False):
    jt = jax.tree.map(jnp.asarray, tree)
    tt = tree_map(_t, tree)
    if bf16:
        jt["w"] = jt["w"].astype(jnp.bfloat16)
        tt["w"] = tt["w"].to(torch.bfloat16)
    return jt, tt


def _same_tree(got, want):
    g, w = tio._paths(got), jio._paths(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = g[k], w[k]
        assert a.dtype == getattr(torch, str(b.dtype)), (k, a.dtype, b.dtype)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=TIGHT,
                                   atol=TIGHT, err_msg=k)


@pytest.mark.parametrize("bf16", [False, True])
def test_adam_walks_a_nested_tree_like_the_reference(bf16):
    rng = np.random.default_rng(4)
    jp, tp = _both(_tree(rng), bf16)
    jg, tg = _both(_tree(rng), bf16)
    jo, to = joptim.adam_init(jp), optim.adam_init(tp)
    for _ in range(3):
        jp, jo = joptim.adam_update(jp, jg, jo, lr=0.01)
        tp, to = optim.adam_update(tp, tg, to, lr=0.01)
    _same_tree(tp, jp)
    _same_tree(to.m, jo.m)
    _same_tree(to.v, jo.v)
    assert int(to.step) == int(jo.step) == 3
    assert all(a.dtype == torch.float32 for a in leaves(to.m))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    rng = np.random.default_rng(5)
    jp, tp = _both(_tree(rng), True)
    jg, tg = _both(_tree(rng), True)
    js, ts = joptim.sgd_init(jp, momentum), optim.sgd_init(tp, momentum)
    assert (ts.momentum is None) == (js.momentum is None)
    for _ in range(3):
        jp, js = joptim.sgd_update(jp, jg, js, lr=0.05, momentum=momentum)
        tp, ts = optim.sgd_update(tp, tg, ts, lr=0.05, momentum=momentum)
    _same_tree(tp, jp)
    if momentum:
        _same_tree(ts.momentum, js.momentum)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(6)
    jg, tg = _both(_tree(rng))
    jc, jn = joptim.clip_by_global_norm(jg, max_norm)
    tc, tn = optim.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TIGHT)
    _same_tree(tc, jc)


def test_cosine_schedule_matches_reference():
    steps = np.array([0, 1, 5, 10, 11, 50, 99, 100, 150], np.int32)
    for warmup, total in ((10, 100), (0, 100), (10, 10)):
        want = joptim.cosine_schedule(jnp.asarray(steps), base_lr=3e-4,
                                      warmup=warmup, total=total)
        got = optim.cosine_schedule(torch.from_numpy(steps), base_lr=3e-4,
                                    warmup=warmup, total=total)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TIGHT,
                                   atol=1e-12)


# -- data and the sampled L_disc ------------------------------------------
def test_lm_batches_bit_equal():
    stream = jsyn.token_stream(5000, vocab=V, seed=2)
    np.testing.assert_array_equal(
        stream, synthetic.token_stream(5000, vocab=V, seed=2))
    for a, b in zip(jsyn.lm_batches(stream, 4, 16, 5, seed=9),
                    synthetic.lm_batches(stream, 4, 16, 5, seed=9)):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("with_logits", [False, True])
def test_disc_loss_sampled_and_its_gradient(with_logits):
    """The value and the gradient into the features (or the student logits),
    head_w and head_b; the prototypes are constants. The negatives are the
    reference's draw from its key."""
    rng = np.random.default_rng(7)
    B, C, d = 12, 20, 8
    f = rng.standard_normal((B, d)).astype(np.float32)
    protos = rng.standard_normal((C, d)).astype(np.float32)
    y = rng.integers(0, C, B).astype(np.int32)
    w = (rng.standard_normal((d, C)) * 0.5).astype(np.float32)
    hb = rng.standard_normal(C).astype(np.float32)
    z = rng.standard_normal((B, C)).astype(np.float32) * 2
    key = jax.random.PRNGKey(11)
    neg = np.asarray(jax.random.randint(key, (7,), 0, C))
    assert (neg[:, None] == y[None, :]).any()         # a masked false negative

    def jl(f, w, hb, z):
        return jlosses.disc_loss_sampled(key, f, jnp.asarray(protos),
                                         jnp.asarray(y), w, hb, 7,
                                         z if with_logits else None)
    want, jgrads = jax.jit(jax.value_and_grad(jl, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (f, w, hb, z)))
    args = [_t(a).requires_grad_(True) for a in (f, w, hb, z)]
    got = losses.disc_loss_sampled(_t(neg), args[0], _t(protos), _t(y),
                                   args[1], args[2],
                                   args[3] if with_logits else None)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for a, g in zip(args, jgrads):
        tg = (a.grad if a.grad is not None else torch.zeros_like(a)).numpy()
        np.testing.assert_allclose(tg, np.asarray(g), rtol=1e-5, atol=1e-7)


def test_sample_negatives_draws_on_the_generator_device():
    g = torch.Generator().manual_seed(0)
    ids = losses.sample_negatives(g, 9, 50, (3,))
    assert ids.shape == (3, 9) and int(ids.min()) >= 0 and int(ids.max()) < 50
    cfg, _ = _cfgs()
    ccfg, _ = _ccfgs("cors")
    assert train.num_negatives(cfg, ccfg) == K
    assert train.num_negatives(cfg, CollabConfig()) == V - 1
    assert train.draw_negatives(g, cfg, ccfg, 2).shape == (2, K)


# -- state construction ---------------------------------------------------
def _ref_layout(tree, path=""):
    """{checkpoint key: (shape, dtype)} of the port's tree in the reference's
    layout: a segment's per-layer list stacked on a layer axis after the
    clients'."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if tree is None:
        return {}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: v for f in tree._fields
                for k, v in _ref_layout(getattr(tree, f), join("." + f)).items()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "segments":
                for i, seg in enumerate(v):
                    out.update(_stacked_layout(seg, join(f"{k}/{i}")))
            elif k in ("enc_layers", "dec_layers"):
                out.update(_stacked_layout(v, join(k)))
            else:
                out.update(_ref_layout(v, join(k)))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _stacked_layout(layers, path):
    """A per-layer list under `path`, stacked on a layer axis after the
    clients'."""
    return {p: ((s[0], len(layers)) + s[1:], dt)
            for p, (s, dt) in _ref_layout(layers[0], path).items()}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-125m",
                                  "whisper-small", "granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "minicpm3-4b",
                                  "zamba2-1.2b"])
def test_full_width_state_shapes_equal_eval_shape(arch):
    """The full-width TrainState of 2 clients as meta tensors (nothing
    allocated) against `jax.eval_shape` of `init_state_shapes(cfg, 2)`,
    leaf by leaf under the reference's checkpoint keys."""
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jio._paths(
        jtrain.init_state_shapes(jget_arch(arch), 2)).items()}
    got = train.init_state_shapes(get_arch(arch), 2)
    assert all(t.device.type == "meta" for t in leaves(got))
    assert _ref_layout(got) == want


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_train_batch_specs_match_reference(arch):
    """train_batch_specs of every arch at train_4k over 4 clients, as meta
    tensors, against the reference's ShapeDtypeStructs."""
    from repro.configs import get_shape as jget_shape
    from repro_torch.configs import get_shape
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    got = train.train_batch_specs(cfg, get_shape("train_4k"), 4)
    want = jtrain.train_batch_specs(jcfg, jget_shape("train_4k"), 4)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.is_meta and tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k


def test_init_state_stacks_clients():
    cfg, _ = _cfgs("xlstm-125m")
    st = train.init_state(cfg, torch.Generator().manual_seed(0), 3,
                          device="cpu")
    assert tuple(st.opt.step.shape) == (3,) and st.step.dim() == 0
    assert st.params["segments"][0][0]["mlstm"]["wq"].shape[0] == 3
    assert not torch.equal(st.params["embed"][0], st.params["embed"][1])
    assert tuple(st.proto.sum.shape) == (V, D)
