"""The port's attention against the reference's, on the CPU.

- `kernels/ref.flash_attention` (the plain version of the flash kernel, what
  `ops.flash_attention` runs for CPU tensors) against the reference's Pallas
  kernel in interpret mode and its jnp oracle, at tests/test_kernels.py's
  shapes in f32 and bf16; tolerance 2e-5 / 2e-2 (atol and rtol), the
  reference's own for its kernel. A ragged shape (lengths no block divides)
  against the jnp oracle only: the Pallas wrapper asserts whole blocks.
- The bf16 tensor-core kernel's arithmetic (`csrc/flash_attention.cu`),
  emulated here tile by tile: within one bf16 step of the plain version and
  of the jnp oracle, element by element (|got - want| <= 1e-4 + 2^-7 |want|,
  the card's check), and the same walk with P rounded to bf16 once outside
  that limit.
- `full_attention`, `chunked_attention`, `gqa_block` and `gqa_decode`
  (masked with a cache_index, and unmasked) against `repro.nn.attention` on
  the same numpy inputs and weights, f32, within 1e-5: the same float32
  math, summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.nn import attention as jatt
from repro.nn import rope as jrope
from repro_torch.kernels import ops, ref
from repro_torch.nn import attention, rope

FLASH_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 8, 8, 128),
                (2, 128, 128, 4, 1, 32)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ATT_TOL = 1e-5


def _qkv(B, Sq, Sk, H, G, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, G, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, G, hd)).astype(np.float32))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("B,Sq,Sk,H,G,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_pallas_and_oracle(B, Sq, Sk, H, G, hd, causal,
                                               dtype):
    q, k, v = _qkv(B, Sq, Sk, H, G, hd)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = ref.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, Sq, H, hd)
    got = got.float().numpy()
    pallas = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                 block_k=64, interpret=True)
    oracle = jref.flash_attention(jq, jk, jv, causal=causal)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, _f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, _f32(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,G,hd", [(2, 100, 100, 4, 2, 64),
                                            (1, 77, 130, 8, 2, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_on_cpu_matches_oracle_at_ragged_shapes(B, Sq, Sk, H, G, hd,
                                                          causal):
    q, k, v = _qkv(B, Sq, Sk, H, G, hd, seed=1)
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal).numpy()
    assert ops.LAUNCHES == before                 # the plain version on CPU
    want = np.asarray(jref.flash_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_ops_flash_raises_on_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 2, 48))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)                       # head_dim 48
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 3, 64))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)                       # 4 % 3 != 0
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 2, 64))
    with pytest.raises(ValueError):
        ops.flash_attention(q.double(), k.double(), v.double())


# -- the bf16 kernel's tile walk, emulated --------------------------------------
LOG2E = 1.4426950408889634
BF16_ATOL, BF16_RTOL = 1e-4, 2.0 ** -7
WALK_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 100, 100, 8, 2, 128),
               (2, 77, 130, 4, 1, 32)]


def _tile_walk(q, k, v, causal, split):
    """The bf16 kernel's arithmetic in plain torch: key tiles of BK (64 at
    hd 128, else 128), scores q.k in float32 scaled by float32(hd^-0.5 log2 e)
    and exponentiated with exp2, float32 running max, sum and accumulator,
    P V from P_hi = bf16(p) and P_lo = bf16(p - P_hi) (`split`), or from
    P_hi alone (P rounded to bf16 once, as FlashAttention-2/3)."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], k.shape[2]
    bk = 64 if hd == 128 else 128
    c = torch.tensor(LOG2E / np.sqrt(hd), dtype=torch.float32)
    qf = q.float().reshape(B, Sq, G, H // G, hd)
    m = torch.full((B, G, Sq, H // G, 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros(B, G, Sq, H // G, hd)
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, bk):
        kt, vt = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk].float()
        s = torch.einsum("bqghd,bkgd->bgqhk", qf, kt) * c
        if causal:
            k_pos = torch.arange(k0, k0 + kt.shape[1])
            s = s.masked_fill(~(q_pos >= k_pos)[None, None, :, None, :], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p, alpha = torch.exp2(s - m_new), torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = torch.einsum("bgqhk,bkgd->bgqhd", p_hi, vt)
        if split:
            p_lo = (p - p_hi).bfloat16().float()
            pv = pv + torch.einsum("bgqhk,bkgd->bgqhd", p_lo, vt)
        o, m = o * alpha + pv, m_new
    o = o / l.clamp_min(1e-30)
    return o.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd).bfloat16()


def _bf16_excess(got, want):
    """Largest |got - want| over 1e-4 + 2^-7 |want|, element by element."""
    d = (got.float() - want.float()).abs()
    return float((d / (BF16_ATOL + BF16_RTOL * want.float().abs())).max())


def _walk_case(B, Sq, Sk, H, G, hd, causal):
    """bf16 inputs from numpy (seed 9), the plain version's output, and the
    jnp oracle's on the same values in float32, rounded to bf16 once (on bf16
    arrays the oracle scales q in bf16, which the kernel's contract does
    not: ref.py computes q * hd^-0.5 in q's dtype)."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(B, Sq, Sk, H, G, hd, seed=9))
    plain = ref.flash_attention(q, k, v, causal=causal)
    oracle = jref.flash_attention(*(t.float().numpy() for t in (q, k, v)),
                                  causal=causal)
    return (q, k, v), plain, torch.from_numpy(np.array(oracle)).bfloat16()


@pytest.mark.parametrize("B,Sq,Sk,H,G,hd", WALK_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_walk_is_within_one_bf16_step(B, Sq, Sk, H, G, hd,
                                                  causal):
    qkv, plain, oracle = _walk_case(B, Sq, Sk, H, G, hd, causal)
    got = _tile_walk(*qkv, causal, split=True)
    assert _bf16_excess(got, plain) <= 1
    assert _bf16_excess(got, oracle) <= 1


@pytest.mark.parametrize("B,Sq,Sk,H,G,hd", WALK_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_p_rounded_to_bf16_once_breaks_the_limit(B, Sq, Sk, H, G, hd,
                                                  causal):
    qkv, plain, oracle = _walk_case(B, Sq, Sk, H, G, hd, causal)
    got = _tile_walk(*qkv, causal, split=False)
    assert _bf16_excess(got, plain) > 1
    assert _bf16_excess(got, oracle) > 1


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (False, 0, 0),
                                                    (True, 24, 0),
                                                    (True, 0, 16)])
def test_full_and_chunked_attention_match_reference(causal, window, q_offset):
    q, k, v = _qkv(2, 48, 64, 4, 2, 32, seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = np.asarray(jatt.full_attention(q, k, v, **kw))
    got = attention.full_attention(tq, tk, tv, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=ATT_TOL, rtol=ATT_TOL)
    want_c = np.asarray(jatt.chunked_attention(q, k, v, chunk=16, **kw))
    got_c = attention.chunked_attention(tq, tk, tv, chunk=16, **kw).numpy()
    np.testing.assert_allclose(got_c, want_c, atol=ATT_TOL, rtol=ATT_TOL)


def _gqa_params(D, H, G, hd, seed=3):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (D, H * hd), "wk": (D, G * hd), "wv": (D, G * hd),
              "wo": (H * hd, D)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


KW = dict(num_heads=4, num_kv_heads=2, head_dim=32, rope_kind="rope",
          rope_theta=10000.0)


@pytest.mark.parametrize("S", [1, 17, 64])
def test_gqa_block_matches_reference(S):
    p = _gqa_params(64, 4, 2, 32)
    x = np.random.default_rng(4).standard_normal((2, S, 64)).astype(np.float32)
    pos = jrope.default_positions(2, S, "rope")
    y, (k, v) = jatt.gqa_block(p, x, pos, return_kv=True, **KW)
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    ty, (tk, tv) = attention.gqa_block(
        tp, torch.from_numpy(x), rope.default_positions(2, S, "rope"),
        return_kv=True, **KW)
    for a, b in ((ty, y), (tk, k), (tv, v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATT_TOL,
                                   rtol=ATT_TOL)


def test_gqa_block_raises_outside_the_kernel_path():
    p = {n: torch.from_numpy(a) for n, a in _gqa_params(64, 4, 2, 32).items()}
    x = torch.zeros(1, 8, 64)
    pos = rope.default_positions(1, 8, "rope")
    with pytest.raises(NotImplementedError):
        attention.gqa_block(p, x, pos, window=4, **KW)
    with pytest.raises(NotImplementedError):
        attention.gqa_block(p, x, pos, kv=(torch.zeros(1, 8, 2, 32),) * 2,
                            **KW)


def test_gqa_block_gradient_on_cpu_matches_reference():
    """On the CPU `ops.flash_attention` runs its plain version, which is
    differentiable: the weights' gradients through attention equal
    jax.grad of the reference (the card raises instead, having no backward
    kernel yet)."""
    import jax
    p = _gqa_params(64, 4, 2, 32)
    x = np.random.default_rng(7).standard_normal((2, 17, 64)).astype(np.float32)
    w = np.random.default_rng(8).standard_normal((2, 17, 64)).astype(np.float32)
    pos = jrope.default_positions(2, 17, "rope")
    want = jax.grad(lambda q: jnp.sum(jatt.gqa_block(q, x, pos, **KW) * w))(p)
    tp = {n: torch.from_numpy(a).requires_grad_(True) for n, a in p.items()}
    y = attention.gqa_block(tp, torch.from_numpy(x),
                            rope.default_positions(2, 17, "rope"), **KW)
    (y * torch.from_numpy(w)).sum().backward()
    for n in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(want[n]),
                                   atol=ATT_TOL, rtol=ATT_TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_gqa_decode_matches_reference(masked):
    p = _gqa_params(64, 4, 2, 32)
    rng = np.random.default_rng(5)
    Sc, idx = 12, 7
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    ck = rng.standard_normal((2, Sc, 2, 32)).astype(np.float32)
    cv = rng.standard_normal((2, Sc, 2, 32)).astype(np.float32)
    cache_index = idx if masked else None
    off = idx if masked else Sc - 1
    pos = jrope.default_positions(2, 1, "rope", offset=off)
    y, k, v = jatt.gqa_decode(
        p, x, ck, cv, pos, masked=masked,
        cache_index=None if cache_index is None else jnp.asarray(idx), **KW)
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ty, tk, tv = attention.gqa_decode(
        tp, torch.from_numpy(x), tck, tcv,
        rope.default_positions(2, 1, "rope", offset=off),
        cache_index=cache_index, masked=masked, **KW)
    assert tk is tck and tv is tcv                      # written in place
    for a, b in ((ty, y), (tk, k), (tv, v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATT_TOL,
                                   rtol=ATT_TOL)


def test_prefill_attention_swap_is_scoped():
    p = {n: torch.from_numpy(a) for n, a in _gqa_params(64, 4, 2, 32).items()}
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 9, 64)).astype(np.float32))
    pos = rope.default_positions(1, 9, "rope")
    calls = []

    def plain(q, k, v, causal):
        calls.append(q.shape)
        return ref.flash_attention(q, k, v, causal=causal)

    with attention.prefill_attention(plain):
        y1 = attention.gqa_block(p, x, pos, **KW)
    y2 = attention.gqa_block(p, x, pos, **KW)
    assert calls == [(1, 9, 4, 32)]
    torch.testing.assert_close(y1, y2, atol=0, rtol=0)

