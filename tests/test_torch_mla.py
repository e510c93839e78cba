"""The port's Multi-head Latent Attention (`repro_torch.nn.mla`) against the
reference's (`repro/nn/mla.py`), on the CPU, in float32, at the reduced
DeepSeek-V2-Lite (no query compression) and MiniCPM3 (q_lora_rank > 0)
configs: query/key head dim 80, value dim 64.

Weights come from the reference's `init_mla`; inputs from a numpy seed.
Floats: max |port - reference| <= 1e-4 x max(1, max|reference|), float32
products summed in another order. The expanded prefill reaches
`ops.flash_attention` at MLA's split head dims, whose plain version runs
on the CPU (held here against the reference's `full_attention`, which
takes a value dim of its own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.nn import attention as jattention, mla as jmla
from repro.nn import rope as jrope
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.nn import mla, rope

TOL = 1e-4
KEY = jax.random.PRNGKey(0)
ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b"]


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


def _setup(arch):
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    assert cfg.__dict__ == jcfg.__dict__
    jp = jax.tree.map(np.asarray, jmla.init_mla(KEY, jcfg, jnp.float32))
    return cfg, jcfg, jp, jax.tree.map(_t, jp)


def _x(cfg, B=2, S=12, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_block_and_its_cache_match_reference(arch):
    cfg, jcfg, jp, tp = _setup(arch)
    assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) == (80, 64)
    x = _x(cfg)
    pos = np.asarray(jrope.default_positions(2, 12, "rope"))
    jy, jc = jmla.mla_block(jp, jcfg, x, pos, return_cache=True)
    y, c = mla.mla_block(tp, cfg, _t(x), _t(pos), return_cache=True)
    assert tuple(c.shape) == jc.shape == (2, 12, cfg.kv_lora_rank
                                          + cfg.qk_rope_dim)
    _close(y, jy)
    _close(c, jc)
    assert torch.equal(mla.mla_block(tp, cfg, _t(x), _t(pos)), y)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("masked", [True, False])
def test_mla_decode_matches_reference(arch, masked):
    """The absorbed form against a prefilled latent cache of 16 slots, 10 of
    them written; the new entry goes to slot 10."""
    cfg, jcfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(1)
    cache = rng.standard_normal(
        (2, 16, cfg.kv_lora_rank + cfg.qk_rope_dim)).astype(np.float32)
    cache[:, 10:] = 0.0
    x = _x(cfg, S=1, seed=2)
    pos = np.asarray(jrope.default_positions(2, 1, "rope", offset=10))
    kw = dict(cache_index=10, masked=True) if masked else {}
    jy, jc = jmla.mla_decode(jp, jcfg, x, cache, pos, **kw)
    tc = _t(cache)
    y, c = mla.mla_decode(tp, cfg, _t(x), tc, _t(pos), **kw)
    assert c is tc                          # written in place
    _close(y, jy)
    _close(c, jc)


def test_mla_raises_for_a_sliding_window():
    """A sliding window no longer raises in prefill (the flash kernel takes
    it, and the windowed block equals the reference's); only a window the
    kernel cannot take does, a negative one."""
    cfg, jcfg, jp, tp = _setup(ARCHS[0])
    x = _x(cfg, S=6, seed=3)
    pos = np.asarray(jrope.default_positions(2, 6, "rope"))
    _close(mla.mla_block(tp, cfg, _t(x), _t(pos), window=2),
           jmla.mla_block(jp, jcfg, x, pos, window=2))
    with pytest.raises(ValueError, match="window"):
        mla.mla_block(tp, cfg, _t(x), _t(pos), window=-1)


@pytest.mark.parametrize("hd,hv", [(80, 64), (96, 64), (192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_mla_dims_matches_reference(hd, hv, causal):
    """ops.flash_attention on CPU tensors (its plain version) at MLA's pairs
    against the reference's full_attention, which keeps v's width."""
    rng = np.random.default_rng(hd + hv)
    q = rng.standard_normal((2, 9, 4, hd)).astype(np.float32)
    k = rng.standard_normal((2, 9, 4, hd)).astype(np.float32)
    v = rng.standard_normal((2, 9, 4, hv)).astype(np.float32)
    want = jattention.full_attention(q, k, v, causal=causal)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert tuple(got.shape) == (2, 9, 4, hv)
    _close(got, want)


def test_flash_attention_rejects_other_value_dims():
    q = torch.zeros(1, 4, 2, 80)
    with pytest.raises(ValueError, match="value dim"):
        ops.flash_attention(q, q, torch.zeros(1, 4, 2, 48))
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, torch.zeros(1, 5, 2, 64))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_reference_layout(arch):
    cfg, _, jp, _ = _setup(arch)
    tp = mla.init_mla(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    for name, a in tp.items():
        if isinstance(a, dict):
            a, want = a["scale"], jp[name]["scale"]
        else:
            want = jp[name]
        assert tuple(a.shape) == want.shape, name
        assert a.dtype == torch.bfloat16
