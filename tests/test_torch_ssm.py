"""The port's Mamba2 block (`repro_torch.nn.ssm`) against the reference's
(`repro/nn/ssm.py`), on the CPU, in float32, at the reduced Zamba2 config
(4 heads of 128 dims, state 16, chunk 16).

Weights come from the reference's `init_mamba2`, with `A_log`, `dt_bias`,
`D` and the conv bias moved off their constant init by a numpy seed, so
that every term of the recurrence counts; inputs from a numpy seed too.
Floats: max |port - reference| <= 1e-4 x max(1, max|reference|), float32
products and exponentials summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.nn import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.nn import ssm

TOL = 1e-4
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def block():
    cfg = get_arch("zamba2-1.2b").reduced()
    jcfg = jget_arch("zamba2-1.2b").reduced()
    assert cfg.__dict__ == jcfg.__dict__
    jp = jax.tree.map(np.asarray, jssm.init_mamba2(KEY, jcfg, jnp.float32))
    rng = np.random.default_rng(0)
    H = cfg.mamba_heads
    jp["A_log"] = rng.uniform(-1.0, 1.0, H).astype(np.float32)
    jp["dt_bias"] = rng.uniform(-2.0, 0.5, H).astype(np.float32)
    jp["D"] = rng.uniform(0.5, 1.5, H).astype(np.float32)
    jp["conv_b"] = (0.1 * rng.standard_normal(jp["conv_b"].shape)).astype(
        np.float32)
    return cfg, jcfg, jp, jax.tree.map(_t, jp)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S,Q", [(64, 16), (48, 16), (16, 32)])
def test_ssd_chunked_matches_reference(with_h0, S, Q):
    """Over 4, 3 and 1 chunks, from zeros or a given state."""
    rng = np.random.default_rng(S + Q)
    B, H, P, N = 2, 3, 8, 5
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.1, 2.0, H).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if with_h0 else None)
    jy, jh = jssm.ssd_chunked(xh, Bm, Cm, dt, A, Q, h0=h0)
    y, h = ssm.ssd_chunked(_t(xh), _t(Bm), _t(Cm), _t(dt), _t(A), Q,
                           h0=None if h0 is None else _t(h0))
    _close(y, jy)
    _close(h, jh)


def test_mamba2_block_and_its_cache_match_reference(block):
    cfg, jcfg, jp, tp = block
    x = np.random.default_rng(1).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)          # 3 chunks of 16
    jy, (jconv, jh) = jssm.mamba2_block(jp, jcfg, x, return_cache=True)
    y, (conv, h) = ssm.mamba2_block(tp, cfg, _t(x), return_cache=True)
    assert tuple(conv.shape) == jconv.shape == (
        2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    assert tuple(h.shape) == jh.shape and h.dtype == torch.float32
    _close(y, jy)
    _close(conv, jconv)
    _close(h, jh)
    _close(ssm.mamba2_block(tp, cfg, _t(x)), jy)


def test_mamba2_decode_matches_reference(block):
    """Three decode steps from a prefill's cache, each against the
    reference's step from the same cache."""
    cfg, jcfg, jp, tp = block
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    _, jcache = jssm.mamba2_block(jp, jcfg, x, return_cache=True)
    cache = tuple(_t(a) for a in jcache)
    for step in range(3):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = jssm.mamba2_decode(jp, jcfg, x1, jcache)
        y, cache = ssm.mamba2_decode(tp, cfg, _t(x1), cache)
        _close(y, jy)
        for a, b in zip(cache, jcache):
            _close(a, b)


def test_decode_continues_the_prefill(block):
    """The port alone: prefill(S) then one decode step equals prefill(S+1)
    at the last position, and its cache equals prefill(S+1)'s (the input
    projection of one token and of 16 summed in another order: 1e-5)."""
    cfg, _, _, tp = block
    x = _t(np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    _, cache = ssm.mamba2_block(tp, cfg, x[:, :15], return_cache=True)
    y1, (conv1, h1) = ssm.mamba2_decode(tp, cfg, x[:, 15:], cache)
    y, (conv, h) = ssm.mamba2_block(tp, cfg, x, return_cache=True)
    torch.testing.assert_close(y1[:, 0], y[:, -1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(conv1, conv, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h1, h, rtol=1e-4, atol=1e-4)


def test_init_matches_the_reference_layout(block):
    cfg, _, jp, _ = block
    tp = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg,
                         torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    for name, a in tp.items():
        if isinstance(a, dict):
            a, want = a["scale"], jp[name]["scale"]
        else:
            want = jp[name]
        assert tuple(a.shape) == want.shape, name
        f32 = name in ("A_log", "dt_bias", "D")
        assert a.dtype == (torch.float32 if f32 else torch.bfloat16), name
