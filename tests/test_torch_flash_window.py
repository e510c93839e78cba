"""Sliding-window prefill in the port, on the CPU, against the reference.

- `kernels/ref.flash_attention(window=W)` (the plain version of the flash
  kernel, which `ops.flash_attention` runs for CPU tensors) against the
  reference's `full_attention` and `chunked_attention` with the same window,
  causal and not, W in {1, 3, 8, S}, at equal head dims and at an MLA pair:
  float32 within 1e-5 (atol and rtol), the same math summed in another
  order. W >= S is bit-equal to no window, and W = 1 under the causal mask
  returns v's rows exactly.
- The windowed tile walk of both CUDA kernels (`csrc/flash_attention.cu`),
  emulated in float32 numpy: the first key tile of a block, the tiles a
  warpgroup skips, the tiles it masks (a tile it does not mask must need no
  mask), against the plain version within 1e-5; and rows whose first
  visited tile is wholly masked come out bit-equal to a walk that skips
  such tiles row by row.
- `gqa_block` and `mla_block` in prefill mode with a window, and the port's
  `lm.forward(mode="prefill", window=W)` on reduced TinyLlama, reduced
  DeepSeek-V2-Lite (MLA) and reduced Zamba2 (the shared attention block),
  against the reference's on the reference's weights: logits, features
  and every cache leaf within 1e-4 x max(1, max|reference|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import lm as jlm
from repro.nn import attention as jatt, mla as jmla, rope as jrope
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.nn import attention, mla, rope
from repro_torch.tree import leaves

ATT_TOL = 1e-5
LM_TOL = 1e-4
S = 16
KW = dict(num_heads=4, num_kv_heads=2, head_dim=32, rope_kind="rope",
          rope_theta=10000.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _qkv(B, Sq, Sk, H, G, hd, hv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, G, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, G, hv)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("hd,hv", [(32, 32), (96, 64)])
@pytest.mark.parametrize("window", [1, 3, 8, S])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_window_matches_full_and_chunked_attention(hd, hv, window,
                                                         causal):
    q, k, v = _qkv(2, S, S, 4, 2, hd, hv, seed=window)
    got = ref.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window).numpy()
    via_ops = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  window=window).numpy()
    np.testing.assert_array_equal(via_ops, got)
    full = jatt.full_attention(q, k, v, causal=causal, window=window)
    chunked = jatt.chunked_attention(q, k, v, causal=causal, window=window,
                                     chunk=4)
    for want in (full, chunked):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATT_TOL,
                                   rtol=ATT_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_window_past_the_sequence_is_no_window_and_one_is_v(causal):
    q, k, v = (_t(a) for a in _qkv(2, S, S, 4, 2, 32, 32, seed=3))
    none = ops.flash_attention(q, k, v, causal=causal)
    for w in (S, S + 1, 1000):
        assert torch.equal(ops.flash_attention(q, k, v, causal=causal,
                                               window=w), none)
    if causal:                       # each row sees its own key alone
        one = ops.flash_attention(q, k, v, causal=True, window=1)
        assert torch.equal(one, v.repeat_interleave(2, dim=2))


def test_a_window_that_leaves_a_row_no_key_raises():
    q, k, v = (_t(a) for a in _qkv(1, 12, 4, 2, 1, 32, 32))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, causal=False, window=8)   # 12 >= 4 + 8
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1], window=-1)
    ops.flash_attention(q, k, v, causal=False, window=9)       # 12 < 4 + 9


def kernel_walk(q, k, v, *, causal, window, BQ, BK, wg_rows, tensor_cores,
                skip_masked_rows=False):
    """One head of `flash_attention.cu`'s tile walk in float32 numpy: q
    (Sq, hd), k (Sk, hd), v (Sk, hv) -> (Sq, hv). The tensor-core kernel
    (`tensor_cores`) gives each warpgroup of `wg_rows` rows the block's
    tiles from t_first (rounded down to a multiple of 4 tiles, 2 STAGES),
    skips those above the diagonal or left of its window, and masks only
    the edge tiles, by the kernel's unsigned range test, checked here
    against the mask's definition; the CUDA-core kernel masks every score
    of every tile from t_first. `skip_masked_rows` leaves a row's state
    alone on a tile that is wholly masked for it."""
    Sq, Sk = len(q), len(k)
    W = window if window > 0 else 1 << 30
    scale = np.float32(q.shape[1] ** -0.5)
    neg = np.float32(-1e30)
    kp = np.concatenate([k, np.zeros((BK, k.shape[1]), np.float32)])
    vp = np.concatenate([v, np.zeros((BK, v.shape[1]), np.float32)])
    qp = np.concatenate([q, np.zeros((BQ, q.shape[1]), np.float32)])
    out = np.zeros((Sq, v.shape[1]), np.float32)
    for q0 in range(0, Sq, BQ):
        k_end = min(Sk, q0 + BQ) if causal else Sk
        t_first = max(0, q0 - W + 1) // BK
        if tensor_cores:
            t_first = t_first // 4 * 4
        n_tiles = max(0, -(-k_end // BK) - t_first)
        for first in range(q0, q0 + BQ, wg_rows):
            rows = np.arange(first, first + wg_rows)
            m = np.full(wg_rows, neg, np.float32)
            l = np.zeros(wg_rows, np.float32)
            acc = np.zeros((wg_rows, v.shape[1]), np.float32)
            for i in range(n_tiles):
                k0 = (t_first + i) * BK
                keys = np.arange(k0, k0 + BK)
                bad = ((keys[None] >= Sk) | (rows[:, None] - keys[None] >= W)
                       | (causal & (keys[None] > rows[:, None])))
                if tensor_cores:
                    last = first + wg_rows - 1
                    if not ((not causal or k0 <= last)
                            and first - (k0 + BK - 1) < W):
                        assert bad.all()        # a skipped tile adds nothing
                        continue
                    edge = ((causal and k0 + BK - 1 > first) or k0 + BK > Sk
                            or last - k0 >= W)
                    if not edge:
                        assert not bad.any()    # no mask needed
                    else:                       # the kernel's range test
                        lo = rows - W + 1
                        hi = (np.minimum(rows, Sk - 1) if causal
                              else np.full_like(rows, Sk - 1))
                        test = ((keys[None] - lo[:, None]).astype(np.uint32)
                                > (hi - lo).astype(np.uint32)[:, None])
                        real = rows < Sq        # padding rows: never stored
                        assert (test == bad)[real].all()
                s = (qp[rows] * scale) @ kp[k0:k0 + BK].T
                s = np.where(bad, neg, s).astype(np.float32)
                live = ~bad.all(1) if skip_masked_rows else np.ones(
                    wg_rows, bool)
                m_new = np.maximum(m, s.max(1))
                alpha = np.exp(m - m_new)
                p = np.exp(s - m_new[:, None])
                l_new = l * alpha + p.sum(1)
                acc_new = acc * alpha[:, None] + p @ vp[k0:k0 + BK]
                m = np.where(live, m_new, m)
                l = np.where(live, l_new, l)
                acc = np.where(live[:, None], acc_new, acc)
            keep = rows < Sq
            out[rows[keep]] = (acc / np.maximum(l, 1e-30)[:, None])[keep]
    return out


WALKS = {"tensor_cores": dict(BQ=128, BK=64, wg_rows=64, tensor_cores=True),
         "tensor_cores_bk128": dict(BQ=128, BK=128, wg_rows=64,
                                    tensor_cores=True),
         "cuda_cores": dict(BQ=64, BK=32, wg_rows=64, tensor_cores=False)}


@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("window,causal,Sq", [
    (0, True, 300), (1, True, 300), (63, True, 300), (64, True, 256),
    (65, True, 300), (1000, True, 300), (300, True, 300), (63, False, 300),
    (65, False, 200)])
def test_windowed_tile_walk_matches_the_plain_version(walk, window, causal,
                                                      Sq):
    q, k, v = _qkv(1, Sq, Sq, 1, 1, 32, 32, seed=window + Sq)
    q, k, v = q[0, :, 0], k[0, :, 0], v[0, :, 0]
    want = ref.flash_attention(*(_t(a)[None, :, None] for a in (q, k, v)),
                               causal=causal, window=window)[0, :, 0].numpy()
    got = kernel_walk(q, k, v, causal=causal, window=window, **WALKS[walk])
    np.testing.assert_allclose(got, want, atol=ATT_TOL, rtol=ATT_TOL)
    skipped = kernel_walk(q, k, v, causal=causal, window=window,
                          skip_masked_rows=True, **WALKS[walk])
    np.testing.assert_array_equal(got, skipped)


def test_gqa_block_prefill_with_a_window_matches_reference():
    rng = np.random.default_rng(11)
    jp = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for n, s in (("wq", (64, 128)), ("wk", (64, 64)), ("wv", (64, 64)),
                       ("wo", (128, 64)))}
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    tp = {n: _t(a) for n, a in jp.items()}
    for window in (1, 5, S):
        y, (k, v) = jatt.gqa_block(jp, x, jrope.default_positions(2, S, "rope"),
                                   window=window, return_kv=True, **KW)
        ty, (tk, tv) = attention.gqa_block(
            tp, _t(x), rope.default_positions(2, S, "rope"), window=window,
            return_kv=True, **KW)
        for a, b in ((ty, y), (tk, k), (tv, v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=ATT_TOL, rtol=ATT_TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minicpm3-4b"])
def test_mla_block_prefill_with_a_window_matches_reference(arch):
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    jp = jax.tree.map(np.asarray, jmla.init_mla(jax.random.PRNGKey(0), jcfg,
                                                jnp.float32))
    tp = jax.tree.map(_t, jp)
    x = np.random.default_rng(4).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    pos = np.asarray(jrope.default_positions(2, S, "rope"))
    jy, jc = jmla.mla_block(jp, jcfg, x, pos, window=5, return_cache=True)
    y, c = mla.mla_block(tp, cfg, _t(x), _t(pos), window=5,
                         return_cache=True)
    for a, b in ((y, jy), (c, jc)):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= LM_TOL * max(1.0, float(np.abs(b).max())), err


def _lm_close(got, want, what):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= LM_TOL * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.mark.parametrize("arch,layers", [("tinyllama-1.1b", 2),
                                         ("deepseek-v2-lite-16b", 2),
                                         ("zamba2-1.2b", 4)])
def test_lm_prefill_with_a_window_matches_reference(arch, layers):
    """Two SSD chunks of tokens (32), windows of 5 and 13 keys."""
    cfg = get_arch(arch).reduced(num_layers=layers)
    jcfg = jget_arch(arch).reduced(num_layers=layers)
    assert cfg.swa_window == jcfg.swa_window
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    n = 2 * cfg.ssm_chunk
    toks = np.random.default_rng(len(arch)).integers(
        0, cfg.vocab_size, (2, n)).astype(np.int32)
    for window in (5, 13):
        want = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           mode="prefill", window=window)
        with torch.no_grad():
            got = lm.forward(tp, cfg, {"tokens": _t(toks)}, mode="prefill",
                             window=window)
        _lm_close(got["logits"], want["logits"], "logits")
        _lm_close(got["features"], want["features"], "features")
        jl, tl = jax.tree.leaves(want["caches"]), leaves(got["caches"])
        assert len(tl) == len(jl)
        for i, (a, w) in enumerate(zip(tl, jl)):
            _lm_close(a, w, f"cache leaf {i}")
        # the window changes the answer: not the full causal prefill
        full = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           mode="prefill")
        assert not np.allclose(np.asarray(full["logits"]),
                               np.asarray(want["logits"]))
