"""Training of the decoder-only families that serve since the previous
slice, against the reference, on the CPU, in float32: Granite (MoE),
DeepSeek-V2-Lite (MLA with MoE), MiniCPM3 (MLA with compressed queries)
and Zamba2 (mamba with the shared attention block, 4 layers: two
applications of the block), each at the reference's `reduced()` sizes with
vocabulary and width 64, as tests/test_torch_train.py's TinyLlama.

Weights come from the reference's `init_state` through
`convert.train_state_from_jax`; batches (2 clients x B 2 x S 32) from a
numpy seed; the negative classes are the reference's own draws. The
tolerances are tests/test_torch_train.py's: losses and metrics 1e-5
relative; gradients before Adam 1e-4 relative + 1e-5 x max|g|; parameters
and Adam moments after 2 steps |d| <= 2 lr a step with at most 1% of the
elements beyond 1e-5; ProtoState counts equal, sums within 1e-4 x max(1,
|sum|). MoE's balance loss equals the reference's to 1e-5 relative under
both remat policies, and "full" and "none" give the same gradients to
1e-6 (the same float32 operations, run again).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.models import blocks, lm
from repro_torch.tree import leaves, tree_map
from test_torch_train import (DISC_T, N, STEPS, V, D, _ccfgs, _close_adam,
                              _negatives, _np, _t,
                              one_torch_thread)  # noqa: F401

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b", "minicpm3-4b",
         "zamba2-1.2b"]
MOE = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"]


def _cfgs(arch):
    kw = dict(num_layers=4 if arch == "zamba2-1.2b" else 2, vocab_size=V,
              d_model=D)
    cfg, jcfg = get_arch(arch).reduced(**kw), jget_arch(arch).reduced(**kw)
    assert cfg.__dict__ == jcfg.__dict__
    return cfg, jcfg


def _batch(cfg, seed, B=2, S=32):
    """One (N, B, S) batch of tokens and labels; an encoder-decoder's also
    frames (N, B, encoder_seq, d)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, (N, B, S + 1)).astype(np.int32)
    b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.is_encoder_decoder:
        b["frames"] = rng.standard_normal(
            (N, B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _start(jcfg):
    js = jtrain.init_state(jcfg, jax.random.PRNGKey(0), N)
    return js, convert.train_state_from_jax(_np(js), device="cpu")


def check_train_step(arch_cfgs, mode="cors", sync=True):
    """Two steps of `make_train_step` in both packages: metrics every step,
    then parameters, Adam state, ProtoState and steps."""
    cfg, jcfg = arch_cfgs
    ccfg, jccfg = _ccfgs(mode)
    js, ts = _start(jcfg)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jccfg, n_clients=N,
                                           disc_tokens=DISC_T,
                                           sync_in_step=sync))
    tstep = train.make_train_step(cfg, ccfg, n_clients=N, disc_tokens=DISC_T,
                                  sync_in_step=sync)
    for s in range(STEPS):
        b = _batch(cfg, 10 + s)
        key = jax.random.PRNGKey(100 + s)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()}, key)
        ts, tm = tstep(ts, {k: _t(v) for k, v in b.items()},
                       _t(_negatives(key)))
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


def _grads_after(monkeypatch, tstep, ts, tb, neg):
    """The gradients `tstep` hands to `adam_update`, and its metrics."""
    seen = []
    real = train.adam_update

    def spy(params, grads, opt, **kw):
        seen.append(grads)
        return real(params, grads, opt, **kw)

    monkeypatch.setattr(train, "adam_update", spy)
    _, tm = tstep(ts, tb, neg)
    monkeypatch.setattr(train, "adam_update", real)
    assert len(seen) == 1
    return seen[0], tm


def check_gradients(arch_cfgs, monkeypatch, mode="cors"):
    """The gradients before Adam, every client's, against jax.value_and_grad
    of the reference's `make_loss_fn` under the keys its step splits, with
    non-empty prototypes; the step's metrics against the clients' mean.
    Returns the port's gradients."""
    from repro.core import prototypes as jproto
    from repro_torch.core import prototypes
    cfg, jcfg = arch_cfgs
    ccfg, jccfg = _ccfgs(mode)
    js, ts = _start(jcfg)
    rng = np.random.default_rng(4)
    ps = rng.standard_normal((V, D)).astype(np.float32)
    pc = rng.integers(0, 3, V).astype(np.float32)
    js = js._replace(proto=jproto.ProtoState(jnp.asarray(ps), jnp.asarray(pc)))
    ts = ts._replace(proto=prototypes.ProtoState(_t(ps), _t(pc)))
    b = _batch(cfg, 5)
    key = jax.random.PRNGKey(7)
    (_, (jm, _, _)), jg = jax.jit(jax.vmap(jax.value_and_grad(
        jtrain.make_loss_fn(jcfg, jccfg, disc_tokens=DISC_T), has_aux=True),
        in_axes=(0, 0, None, 0)))(
            js.params, {k: jnp.asarray(v) for k, v in b.items()},
            jproto.means(js.proto), jax.random.split(key, N))
    tstep = train.make_train_step(cfg, ccfg, n_clients=N, disc_tokens=DISC_T)
    grads, tm = _grads_after(monkeypatch, tstep, ts,
                             {k: _t(v) for k, v in b.items()},
                             _t(_negatives(key)))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jnp.mean(jm[k])),
                                   rtol=1e-5, err_msg=k)
    got = _paths(grads)
    want = _jpaths(_np(jg))
    assert sorted(got) == sorted(want)
    for path in want:
        w = np.asarray(want[path])
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * max(scale, 1e-3), err_msg=path)
    return grads


def _paths(tree):
    """A client-stacked tree of the port under the reference's checkpoint
    keys, as numpy."""
    from repro_torch.checkpoint import io as tio
    conv = (convert.encdec_params_to_numpy if "enc_layers" in tree
            else convert.lm_params_to_numpy)
    return tio._paths(conv(tree, clients=True))


def _jpaths(tree):
    from repro.checkpoint import io as jio
    return jio._paths(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, monkeypatch):
    check_gradients(_cfgs(arch), monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(_cfgs(arch))


@pytest.mark.parametrize("arch", MOE)
def test_moe_aux_reaches_the_loss_under_both_remat_policies(arch,
                                                            monkeypatch):
    """lm.forward's train-mode aux (the layers' balance losses, each out of
    its remat) equals the reference's under "full" and "none"; the loss
    total carries 0.01 x aux."""
    cfg, jcfg = _cfgs(arch)
    js, ts = _start(jcfg)
    b = _batch(cfg, 6)
    jp = jax.tree.map(lambda a: a[0], js.params)
    want = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(b["tokens"][0])},
                       mode="train")
    p0 = tree_map(lambda a: a[0].detach().requires_grad_(True), ts.params)
    ccfg, _ = _ccfgs("il")
    loss_fn = train.make_loss_fn(cfg, ccfg, disc_tokens=DISC_T)
    tb = {k: _t(v[0]) for k, v in b.items()}
    for policy in ("full", "none"):
        monkeypatch.setattr(blocks, "REMAT_POLICY", policy)
        out = lm.forward(p0, cfg, tb, mode="train")
        assert out["aux"].requires_grad, policy
        np.testing.assert_allclose(float(out["aux"].detach()),
                                   float(want["aux"]),
                                   rtol=1e-5, err_msg=policy)
        total, (m, _, _) = loss_fn(p0, tb, None)
        np.testing.assert_allclose(float((total - m["ce"]).detach()),
                                   0.01 * float(want["aux"]), rtol=1e-4,
                                   err_msg=policy)
    assert float(want["aux"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_none(arch, monkeypatch):
    """One cors step's gradients with every layer rematerialised against
    none: the same operations run again, so they agree to 1e-6."""
    cfg, jcfg = _cfgs(arch)
    _, ts = _start(jcfg)
    ccfg, _ = _ccfgs("cors")
    b = {k: _t(v) for k, v in _batch(cfg, 8).items()}
    neg = _t(_negatives(jax.random.PRNGKey(8)))
    tstep = train.make_train_step(cfg, ccfg, n_clients=N, disc_tokens=DISC_T)
    got = {}
    for policy in ("full", "none"):
        monkeypatch.setattr(blocks, "REMAT_POLICY", policy)
        got[policy] = _grads_after(monkeypatch, tstep, ts, b, neg)
    (gf, mf), (gn, mn) = got["full"], got["none"]
    for k in mf:
        np.testing.assert_allclose(float(mf[k]), float(mn[k]), rtol=1e-6,
                                   err_msg=k)
    for a, c in zip(leaves(gf), leaves(gn)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6,
                                   atol=1e-6 * max(1e-3, float(c.abs().max())))


@pytest.mark.parametrize("dt_lo", [0.05, 0.7])
def test_ssd_gradient_stays_finite_where_the_reference_overflows(dt_lo):
    """The chunked SSD at Zamba2's chunk of 128: forward equal to the
    reference's within 1e-4 x max|y|. Its gradient equals jax.grad's at
    small dt; at dt >= 0.7 the upper triangle's exp overflows, the
    reference's gradient (mask after the exp) is NaN, and the port's
    (mask before it) stays finite."""
    from repro.nn import ssm as jssm
    from repro_torch.nn import ssm
    rng = np.random.default_rng(9)
    B, S, H, P, N, Q = 1, 256, 4, 8, 16, 128
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    dt = (dt_lo + 0.3 * rng.random((B, S, H))).astype(np.float32)
    A = -np.ones(H, np.float32)
    ins = [_t(a).requires_grad_(True) for a in (xh, Bm, Cm, dt)]
    y, _ = ssm.ssd_chunked(*ins, _t(A), Q)
    jloss = lambda *a: jssm.ssd_chunked(*a, jnp.asarray(A), Q)[0].sum()
    want = np.asarray(jssm.ssd_chunked(xh, Bm, Cm, dt, jnp.asarray(A), Q)[0])
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    y.sum().backward()
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(xh, Bm, Cm, dt)
    for a, g in zip(ins, jg):
        assert bool(torch.isfinite(a.grad).all())
        g = np.asarray(g)
        if dt_lo < 0.5:
            np.testing.assert_allclose(a.grad.numpy(), g, rtol=1e-4,
                                       atol=1e-5 * np.abs(g).max())
    if dt_lo >= 0.5:
        assert not all(np.isfinite(np.asarray(g)).all() for g in jg)
