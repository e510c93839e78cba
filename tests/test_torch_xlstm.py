"""The port's xLSTM family (`repro_torch.nn.xlstm`, the mlstm and slstm
kinds of `models/blocks.py`, `configs/xlstm_125m.py`) against the
reference's, on the CPU, in train mode.

Weights come from the reference's init functions; inputs from a numpy
seed. Tolerances: blocks and the reduced LM forward 1e-5 relative + 1e-5
absolute (float32 products summed in another order, the sLSTM through 32
recurrent steps); gradients 1e-4 relative + 1e-5 x max|g| (the chunked
mLSTM's exponentials and the recurrence's cancellations in float32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.nn import xlstm as jx
from repro.types import CollabConfig as JCollab
from repro_torch import convert
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.models import blocks, lm
from repro_torch.nn import xlstm
from repro_torch.tree import leaves, tree_map
from repro_torch.types import CollabConfig

TOL = 1e-5
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**kw):
    return (get_arch("xlstm-125m").reduced(**kw),
            jget_arch("xlstm-125m").reduced(**kw))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _close_grad(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-3),
                               err_msg=what)


def test_config_is_the_reference_config():
    assert get_arch("xlstm-125m").__dict__ == jget_arch("xlstm-125m").__dict__
    cfg, jcfg = _cfgs()
    assert cfg.__dict__ == jcfg.__dict__
    assert cfg.block_pattern == ("mlstm", "slstm")


def test_conv_silu_matches_reference():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    _close(xlstm._conv_silu(_t(w), _t(b), _t(x)), jx._conv_silu(w, b, x))


@pytest.mark.parametrize("S,Q", [(32, 8), (32, 32), (48, 16)])
def test_mlstm_chunked_matches_reference(S, Q):
    rng = np.random.default_rng(S + Q)
    B, H, P = 2, 3, 8
    q, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32)
               for _ in range(3))
    logf = -np.abs(rng.standard_normal((B, S, H))).astype(np.float32)
    logi = rng.standard_normal((B, S, H)).astype(np.float32)
    y, C = jx.mlstm_chunked(q, k, v, logf, logi, Q)
    ty, tC = xlstm.mlstm_chunked(*map(_t, (q, k, v, logf, logi)), Q)
    _close(ty, y)
    _close(tC, C)
    assert tuple(tC.shape) == (B, H, P + 1, P)


@pytest.mark.parametrize("logf,logi", [(-0.1, 0.5), (-5.0, 10.0)])
def test_mlstm_gradient_stays_finite_where_the_reference_overflows(logf, logi):
    """The chunked mLSTM at a chunk of 64, with every gate at one value:
    forward equal to the reference's at the module's tolerance. At logf
    -0.1 its gradient equals jax.grad's (the gradient tolerance above); at
    logf -5, logi 10 the upper triangle's exp overflows, the reference's
    gradient (mask after the exp) is not finite, and the port's (mask
    before it) is."""
    rng = np.random.default_rng(64)
    B, S, H, P, Q = 1, 64, 2, 8, 64
    q, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32)
               for _ in range(3))
    lf = np.full((B, S, H), logf, np.float32)
    li = np.full((B, S, H), logi, np.float32)
    ins = [_t(a, True) for a in (q, k, v, lf, li)]
    y, C = xlstm.mlstm_chunked(*ins, Q)
    jy, jC = jx.mlstm_chunked(q, k, v, lf, li, Q)
    _close(y, jy)
    _close(C, jC)
    (y.sum() + C.sum()).backward()
    jloss = lambda *a: sum(o.sum() for o in jx.mlstm_chunked(*a, Q))
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(q, k, v, lf, li)
    for name, a, g in zip("q k v logf logi".split(), ins, jg):
        assert bool(torch.isfinite(a.grad).all()), name
        if logf > -1:
            _close_grad(a.grad, g, name)
    if logf <= -1:
        assert not all(np.isfinite(np.asarray(g)).all() for g in jg)


def _block_params(kind, jcfg, seed):
    init = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, {k: _t(np.asarray(v), True) if not isinstance(v, dict)
                else {kk: _t(np.asarray(vv), True) for kk, vv in v.items()}
                for k, v in jp.items()}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_and_its_gradient_match_reference(kind):
    """mlstm_block / slstm_block forward, and the gradient of a weighted
    sum of the output into every weight and the input."""
    cfg, jcfg = _cfgs(d_model=64)
    jp, tp = _block_params(kind, jcfg, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    jfn = jx.mlstm_block if kind == "mlstm" else jx.slstm_block
    tfn = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    loss = lambda p, xx: jnp.sum(jfn(p, jcfg, xx) * w)
    y = jfn(jp, jcfg, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = _t(x, True)
    ty = tfn(tp, cfg, tx)
    _close(ty, y)
    (ty * _t(w)).sum().backward()
    _close_grad(tx.grad, gx, "x")
    for name, leaf in jax.tree_util.tree_flatten_with_path(gp)[0]:
        keys = [k.key for k in name]
        t = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
        _close_grad(t.grad, leaf, "/".join(keys))


def test_slstm_scan_keeps_the_stabiliser_state():
    """slstm_scan's final (c, n, m, h) against the reference's, from the
    block's -30.0 initial m."""
    cfg, jcfg = _cfgs(d_model=64)
    rng = np.random.default_rng(3)
    B, S, d, H = 2, 16, cfg.d_model, cfg.num_heads
    gx = rng.standard_normal((B, S, 4, d)).astype(np.float32)
    r = (rng.standard_normal((4, H, d // H, d // H)) * 0.3).astype(np.float32)
    z = np.zeros((B, d), np.float32)
    state = (z, z, np.full((B, d), -30.0, np.float32), z)
    hs, st = jx.slstm_scan(jnp.asarray(gx), jnp.asarray(r),
                           tuple(map(jnp.asarray, state)))
    ths, tst = xlstm.slstm_scan(_t(gx), _t(r), tuple(map(_t, state)))
    _close(ths, hs)
    for a, b in zip(tst, st):
        assert a.dtype == torch.float32
        _close(a, b)


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfgs(vocab_size=64, d_model=64)
    jp = jlm.init_lm(KEY, jcfg)
    return cfg, jcfg, jp, convert.lm_params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


def test_lm_forward_matches_reference(model):
    cfg, jcfg, jp, tp = model
    toks = np.random.default_rng(4).integers(0, 64, (2, 32)).astype(np.int32)
    want = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    for k in ("features", "logits"):
        _close(got[k], want[k])
    assert got["caches"] is None


def test_lm_loss_and_gradients_match_reference(model):
    """The cors loss of `launch/train.py` on the reduced xLSTM LM and one
    client's gradients before Adam, with non-empty prototypes."""
    cfg, jcfg, jp, tp = model
    kw = dict(mode="cors", num_classes=64, d_feature=64, num_negatives=16)
    rng = np.random.default_rng(5)
    means = rng.standard_normal((64, 64)).astype(np.float32)
    toks = rng.integers(0, 64, (2, 33)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    key = jax.random.PRNGKey(6)
    (_, (jm, _, _)), jg = jax.jit(jax.value_and_grad(
        jtrain.make_loss_fn(jcfg, JCollab(**kw), disc_tokens=40),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in b.items()},
                       jnp.asarray(means), key)
    neg = torch.from_numpy(np.array(jax.random.randint(
        jax.random.split(key)[0], (16,), 0, 64)))
    tg, tm, _, _ = train.client_grads(
        train.make_loss_fn(cfg, CollabConfig(**kw), disc_tokens=40), tp,
        {k: torch.from_numpy(v) for k, v in b.items()},
        torch.from_numpy(means), neg)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   err_msg=k)
    want = convert.lm_params_from_jax(jax.tree.map(np.asarray, jg),
                                      device="cpu")
    for a, b in zip(leaves(tg), leaves(want)):
        _close_grad(a, b.numpy())


def test_remat_policies_give_the_same_gradients(model, monkeypatch):
    """Per-layer remat ("full", the default) recomputes each layer in the
    backward, "dots" recomputes all but the products with a weight: the
    same gradients as "none"."""
    cfg, _, _, tp = model
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 64, (2, 16)).astype(np.int64))

    def grads():
        p = tree_map(lambda a: a.detach().requires_grad_(True), tp)
        lm.forward(p, cfg, {"tokens": toks})["logits"].square().mean().backward()
        return [a.grad for a in leaves(p)]

    full = grads()
    monkeypatch.setattr(blocks, "REMAT_POLICY", "none")
    for a, b in zip(full, grads()):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-9)
    monkeypatch.setattr(blocks, "REMAT_POLICY", "dots")
    for a, b in zip(full, grads()):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-9)


def test_serving_an_xlstm_raises(model, monkeypatch):
    """Serving an xLSTM no longer raises (it did until the port had the
    serving half of the blocks): prefill gives each segment its recurrent
    cache, `init_cache` the same layout, and a window, which no xLSTM block
    reads, changes nothing. A plain forward without remat still trains."""
    cfg, _, _, tp = model
    toks = torch.zeros(1, 8, dtype=torch.long)
    with torch.no_grad():
        out = lm.forward(tp, cfg, {"tokens": toks}, mode="prefill")
        again = lm.forward(tp, cfg, {"tokens": toks}, mode="prefill",
                           window=4)
    assert torch.equal(out["logits"], again["logits"])
    empty = lm.init_cache(cfg, 1, 8, device="cpu")
    for a, b in zip(leaves(out["caches"]), leaves(empty)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert float(empty["segments"][1][2].max()) == -30.0    # sLSTM's m
    monkeypatch.setattr(blocks, "REMAT_POLICY", "none")
    x = torch.zeros(1, 8, cfg.d_model)
    y, _, _ = blocks.run_segment(tp["segments"][0], cfg, "mlstm", x, None,
                                 window=0, mode="train")
    assert y.shape == x.shape


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_and_decode_match_reference(kind):
    """Each block's prefill (`return_cache`) and three one-token decode
    steps from that cache, output and cache against the reference's."""
    cfg, jcfg = _cfgs(d_model=64)
    jp, tp = _block_params(kind, jcfg, 7)
    tp = tree_map(lambda a: a.detach(), tp)
    jfn = jx.mlstm_block if kind == "mlstm" else jx.slstm_block
    tfn = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    jy, jc = jfn(jp, jcfg, jnp.asarray(x), return_cache=True)
    ty, tc = tfn(tp, cfg, _t(x), return_cache=True)
    _close(ty, jy)
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        assert tuple(a.shape) == b.shape
        _close(a, b)
    for _ in range(3):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jfn(jp, jcfg, jnp.asarray(x1), cache=jc, decode=True)
        ty, tc = tfn(tp, cfg, _t(x1), cache=tc, decode=True)
        _close(ty, jy)
        for a, b in zip(tc, jc):
            _close(a, b)


def test_init_matches_the_reference_layout():
    """The port's init draws other numbers, in the reference's shapes and
    dtypes, layer kind by layer kind."""
    cfg, jcfg = _cfgs(vocab_size=64, d_model=64)
    jp = jax.tree.map(np.asarray, jlm.init_lm(KEY, jcfg))
    tp = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    conv = convert.lm_params_from_jax(jp, device="cpu")
    assert [[sorted(lp) for lp in seg] for seg in tp["segments"]] == \
        [[sorted(lp) for lp in seg] for seg in conv["segments"]]
    got, want = tio._paths(tp), tio._paths(conv)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    assert all(a.dtype == torch.bfloat16 for a in leaves(
        lm.init_lm(torch.Generator().manual_seed(0), bf, device="cpu")))
