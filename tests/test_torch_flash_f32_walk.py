"""CPU emulation of the float32 flash kernel on the tensor cores
(`flash_attention_tf32x3_kernel`, `src/repro_torch/kernels/csrc/
flash_attention.cu`), held against the port's plain version
(`kernels/ref.flash_attention`), a float64 softmax attention, and the JAX
reference (`repro.kernels.ref.flash_attention`, and the Pallas kernel in
interpret mode where Sq and Sk divide its blocks).

The kernel runs only on the card. These tests check its arithmetic and its
order of work in numpy:

- `cvt.rna.tf32.f32` by bit arithmetic on float32 words (round to nearest,
  ties away from zero, the low 13 bits cleared);
- both products split into three TF32 products, small terms first:
  S = Q_s K_b + Q_b K_s + Q_b K_b, and a tile's P V = P_s V_b + P_b V_s +
  P_b V_b on an accumulator of its own, added to O by one fma, O = alpha O
  + P V; each TF32 x TF32 product is exact in float32 and summed in
  float32, as the tensor cores accumulate;
- P taken from the accumulator's registers as the A fragment of m64k8,
  whose columns t and t + 4 hold a thread's keys 2t and 2t + 1, and V^T
  stored with the keys of each group of 8 in the order 0 2 4 6 1 3 5 7 to
  match (the walk multiplies in that storage order);
- the tile walk: BQ query rows a block in warpgroups of 64, BK keys a tile
  (the kernel's `Cfg` per (hd, hv)), the block's tiles from the one holding
  row q0's lowest visible key, a warpgroup skipping tiles above the
  diagonal, left of its window or wholly past Sq, and masking only edge
  tiles by the unsigned range test;
- the key split: the block's tiles cut in runs (`splits`, the kernel's rule
  from the shape and the SM count), each run's (acc, m, l), and the last
  block's combine, rescaled to the common max and added in split order.

Tolerance: FLASH_F32_TOL = 2e-5 x max(1, max|want|), the card check's
float32 limit (`chip_smoke.py`), against the float64 attention, the port's
plain version and the JAX reference alike. A single TF32 product per
matrix product misses that limit at a shape where the split stays under
0.2 of it: the reason for the split.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import ref

FLASH_F32_TOL = 2e-5
NEG = np.float32(-1e30)
NO_WINDOW = 1 << 30
SMS = 132                               # the H100's SMs
# the kernel's Cfg: (hd, hv) -> consumer warpgroups, keys a tile
CFG = {(32, 32): (2, 64), (64, 64): (2, 32), (128, 128): (1, 32),
       (192, 128): (1, 32), (96, 64): (2, 32)}
# storage position c of a group of 8 keys holds key PERM[c]
PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tf32(x):
    """cvt.rna.tf32.f32: float32 x to 10 mantissa bits, to nearest, ties
    away from zero, as a float32 with the low 13 bits clear."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """-> (big, small): tf32(x) and tf32(x - big)."""
    x = np.asarray(x, np.float32)
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a, b):
    """a @ b in split TF32, small terms first, float32 sums."""
    ab, as_ = split(a)
    bb, bs = split(b)
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for x, y in ((as_, bb), (ab, bs), (ab, bb)):
        out = (out + x @ y).astype(np.float32)
    return out


def mm1(a, b):
    """a @ b in one TF32 product (the control)."""
    return (tf32(a) @ tf32(b)).astype(np.float32)


def stored_keys(BK):
    """The key each storage position of V^T holds, by the producer's
    formula: unit u of a 32-key chunk holds keys 8 (u / 2) + (u % 2) + 2e
    at positions 4u + e."""
    keys = np.empty(BK, int)
    for kc in range(BK // 32):
        for u in range(8):
            for e in range(4):
                keys[32 * kc + 4 * u + e] = 32 * kc + 8 * (u // 2) + u % 2 + 2 * e
    return keys


def splits(B, Sq, Sk, H, hd, hv, causal, window, sms=SMS):
    """The kernel's key split (`x3::splits`)."""
    nc, BK = CFG[(hd, hv)]
    BQ = 64 * nc
    W = window if window > 0 else NO_WINDOW
    nq = -(-Sq // BQ)
    tiles = B * H * nq
    if tiles >= sms:
        return 1
    q0 = (nq - 1) * BQ
    k_end = min(Sk, q0 + BQ) if causal else Sk
    n_kt = -(-k_end // BK) - max(0, q0 - W + 1) // BK
    return max(1, min(sms // tiles, n_kt // 2))


def kernel_head(q, k, v, *, causal, window, n_split, product=mm3):
    """One (batch, head) of the kernel in float32 numpy: q (Sq, hd), k (Sk,
    hd), v (Sk, hv) -> (Sq, hv)."""
    Sq, hd = q.shape
    Sk, hv = v.shape
    nc, BK = CFG[(hd, hv)]
    BQ = 64 * nc
    W = window if window > 0 else NO_WINDOW
    scale_log2 = np.float32(1.4426950408889634 / np.sqrt(hd))
    kp = np.concatenate([k, np.zeros((BK, hd), np.float32)])  # TMA's zero fill
    vp = np.concatenate([v, np.zeros((BK, hv), np.float32)])
    qp = np.concatenate([q, np.zeros((BQ, hd), np.float32)])
    order = stored_keys(BK)
    out = np.zeros((Sq, hv), np.float32)
    for q0 in range(0, Sq, BQ):
        k_end = min(Sk, q0 + BQ) if causal else Sk
        t_lo, t_hi = max(0, q0 - W + 1) // BK, -(-k_end // BK)
        per = -(-(t_hi - t_lo) // n_split)
        for first in range(q0, q0 + BQ, 64):
            rows = np.arange(first, first + 64)
            parts = []
            for sp in range(n_split):
                t_begin = min(t_hi, t_lo + sp * per)
                n = min(t_hi, t_begin + per) - t_begin
                m = np.full(64, NEG, np.float32)
                l = np.zeros(64, np.float32)
                acc = np.zeros((64, hv), np.float32)
                for i in range(n):
                    k0 = (t_begin + i) * BK
                    keys = np.arange(k0, k0 + BK)
                    bad = ((keys[None] >= Sk) | (rows[:, None] - keys[None] >= W)
                           | (causal & (keys[None] > rows[:, None])))
                    if not (first < Sq and (not causal or k0 <= first + 63)
                            and first - (k0 + BK - 1) < W):
                        assert bad[rows < Sq].all()   # a skipped tile adds nothing
                        continue
                    s = product(qp[rows], kp[k0:k0 + BK].T) * scale_log2
                    edge = ((causal and k0 + BK - 1 > first) or k0 + BK > Sk
                            or first + 63 - k0 >= W)
                    if edge:                          # the kernel's range test
                        lo = rows - W + 1
                        hi = (np.minimum(rows, Sk - 1) if causal
                              else np.full_like(rows, Sk - 1))
                        test = ((keys[None] - lo[:, None]).astype(np.uint32)
                                > (hi - lo).astype(np.uint32)[:, None])
                        assert (test == bad)[rows < Sq].all()
                        s = np.where(test, NEG, s)
                    else:
                        assert not bad[rows < Sq].any()
                    s = s.astype(np.float32)
                    m_new = np.maximum(m, s.max(1))
                    alpha = np.exp2(m - m_new)
                    p = np.exp2(s - m_new[:, None]).astype(np.float32)
                    l = (l * alpha + p.sum(1)).astype(np.float32)
                    # the tile's P V on its own accumulator, P's columns and
                    # V^T's rows in V^T's storage order; then O = alpha O +
                    # the tile by one fma
                    pv = product(p[:, order], vp[k0 + order])
                    acc = (acc.astype(np.float64) * alpha[:, None]
                           + pv).astype(np.float32)
                    m = m_new
                parts.append((acc, m, l))
            if n_split == 1:
                acc, _, l = parts[0]
                o = acc / np.maximum(l, np.float32(1e-30))[:, None]
            else:                                     # the last block's combine
                mu = np.max([pm for _, pm, _ in parts], axis=0)
                lsum = np.zeros(64, np.float32)
                o = np.zeros((64, hv), np.float32)
                for pa, pm, pl in parts:
                    w = np.exp2(pm - mu).astype(np.float32)
                    lsum = (lsum + pl * w).astype(np.float32)
                    o = (o + pa * w[:, None]).astype(np.float32)
                o = o * (np.float32(1) / np.maximum(lsum, np.float32(1e-30)))[:, None]
            keep = rows < Sq
            out[rows[keep]] = o[keep]
    return out


def kernel(q, k, v, *, causal, window=0, n_split=None, product=mm3):
    """The launch: q (B, Sq, H, hd), k (B, Sk, G, hd), v (B, Sk, G, hv) ->
    (B, Sq, H, hv), query head h on KV head h / (H / G); the key split the
    kernel would choose unless `n_split` says."""
    B, Sq, H, hd = q.shape
    Sk, G, hv = k.shape[1], k.shape[2], v.shape[3]
    if n_split is None:
        n_split = splits(B, Sq, Sk, H, hd, hv, causal, window)
    out = np.zeros((B, Sq, H, hv), np.float32)
    for b in range(B):
        for h in range(H):
            g = h // (H // G)
            out[b, :, h] = kernel_head(q[b, :, h], k[b, :, g], v[b, :, g],
                                       causal=causal, window=window,
                                       n_split=n_split, product=product)
    return out


def attention64(q, k, v, causal, window=0):
    """Softmax attention in float64, the contract's mask."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // G, axis=2)
    vv = np.repeat(v.astype(np.float64), H // G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(hd)
    diff = np.arange(Sq)[:, None] - np.arange(Sk)[None]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


def _qkv(B, Sq, Sk, H, G, hd, hv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, G, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, G, hv)).astype(np.float32))


def excess(got, want):
    """max |got - want| over FLASH_F32_TOL x max(1, max|want|)."""
    want = np.asarray(want, np.float64)
    lim = FLASH_F32_TOL * max(1.0, float(np.abs(want).max()))
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / lim


def _port_plain(q, k, v, causal, window=0):
    return ref.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window).numpy()


def test_tf32_rounds_to_nearest_ties_away_and_clears_the_low_bits():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                     # TF32's step at 1
    x = np.array([one + ulp / 2, one + ulp / 2 - np.float32(2.0 ** -23),
                  -(one + ulp / 2), one + ulp * 1.5, 3.14159265,
                  np.float32(1e-30), 0.0], np.float32)
    got = tf32(x)
    want = np.array([one + ulp, one, -(one + ulp), one + 2 * ulp,
                     np.float32(3.140625), got[5], 0.0], np.float32)
    np.testing.assert_array_equal(got, want)
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()
    # big + small keeps 21 bits or more of every float32
    rng = np.random.default_rng(0)
    a = rng.standard_normal(10000).astype(np.float32) * 10.0 ** rng.integers(
        -6, 6, 10000)
    big, small = split(a)
    rel = np.abs((big.astype(np.float64) + small) - a) / np.abs(a)
    assert rel.max() < 2.0 ** -21, rel.max()


def test_p_fragment_keys_match_the_stored_key_order():
    """The m64nN accumulator gives thread t (lane % 4) keys 8j + 2t and
    8j + 2t + 1 of slice j; the m64k8 tf32 A fragment puts a0/a1 in column
    t and a2/a3 in column t + 4. V^T's storage order must hold, at position
    c of each group of 8, the key the fragment's column c carries."""
    for t in range(4):
        held = (2 * t, 2 * t + 1)                    # accumulator columns
        cols = (t, t + 4)                            # a0/a1, a2/a3
        for key, c in zip(held, cols):
            assert PERM[c] == key
    for BK in (32, 64):
        order = stored_keys(BK)
        np.testing.assert_array_equal(
            order, (np.arange(BK) // 8) * 8 + PERM[np.arange(BK) % 8])
        assert sorted(order) == list(range(BK))      # a permutation of the tile


def test_split_rule():
    # Whisper's cross attention and decode, and (1, 256, 8, 8, 128), take a
    # split; the serving shape fills the card without one
    assert splits(4, 32, 1500, 12, 64, 64, False, 0) == 2
    assert splits(4, 1, 1500, 12, 64, 64, False, 0) == 2
    assert splits(1, 256, 256, 8, 128, 128, True, 0) == 4
    assert splits(1, 256, 256, 8, 128, 128, False, 0) == 4
    assert splits(4, 1024, 1024, 32, 64, 64, True, 0) == 1
    assert splits(4, 256, 256, 16, 192, 128, True, 0) == 1
    assert splits(4, 32, 32, 12, 64, 64, True, 0) == 1   # one key tile


# small versions of phase 4's float32 shapes (B, Sq, Sk, H, G, hd, hv,
# causal, window, splits or None for the rule's)
WALK_CASES = [
    (1, 130, 130, 4, 2, 64, 64, True, 0, None),        # ragged, two q tiles
    (1, 100, 100, 4, 2, 64, 64, False, 0, None),
    (1, 70, 70, 2, 1, 32, 32, True, 0, None),
    (1, 100, 100, 2, 2, 128, 128, True, 0, None),      # split 4 by the rule
    (1, 77, 130, 2, 2, 192, 128, True, 0, None),       # MLA, DeepSeek-V2-Lite
    (1, 77, 130, 2, 2, 192, 128, False, 0, None),
    (1, 77, 130, 2, 2, 96, 64, True, 0, None),         # MLA, MiniCPM3
    (1, 32, 300, 2, 2, 64, 64, False, 0, None),        # Whisper cross
    (2, 1, 300, 2, 2, 64, 64, False, 0, 3),            # decode, three splits
    (1, 1, 257, 2, 1, 128, 128, False, 0, 5),
    (1, 200, 200, 2, 2, 64, 64, True, 33, None),       # a window
    (1, 160, 160, 2, 2, 192, 128, True, 65, 2),        # a window, split
    (1, 100, 150, 2, 2, 64, 64, False, 70, 2),
]


@pytest.mark.parametrize("B,Sq,Sk,H,G,hd,hv,causal,window,ns", WALK_CASES)
def test_walk_matches_the_plain_version(B, Sq, Sk, H, G, hd, hv, causal,
                                        window, ns):
    q, k, v = _qkv(B, Sq, Sk, H, G, hd, hv, seed=Sq + Sk + hd + window)
    got = kernel(q, k, v, causal=causal, window=window, n_split=ns)
    assert excess(got, attention64(q, k, v, causal, window)) < 1
    assert excess(got, _port_plain(q, k, v, causal, window)) < 1
    if hv == hd and not window:
        want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), causal=causal))
        assert excess(got, want) < 1


@pytest.mark.parametrize("causal", [True, False])
def test_walk_matches_the_pallas_kernel(causal):
    q, k, v = _qkv(1, 256, 256, 2, 1, 64, 64, seed=3)
    want = np.asarray(jax.jit(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, interpret=True))(q, k, v))
    assert excess(kernel(q, k, v, causal=causal), want) < 1


def test_key_split_combines_in_split_order():
    """A split result stays within the limit of the unsplit one and of the
    float64 attention, and the combine is the same in every run: its
    order is fixed."""
    q, k, v = _qkv(1, 1, 600, 2, 2, 64, 64, seed=5)
    one = kernel(q, k, v, causal=False, n_split=1)
    want = attention64(q, k, v, False)
    for ns in (2, 4):
        got = kernel(q, k, v, causal=False, n_split=ns)
        assert excess(got, want) < 1 and excess(got, one) < 1
        np.testing.assert_array_equal(
            got, kernel(q, k, v, causal=False, n_split=ns))


def test_one_tf32_product_misses_the_limit_the_split_keeps():
    q, k, v = _qkv(1, 128, 128, 2, 2, 128, 128, seed=7)
    want = attention64(q, k, v, False)
    split_ex = excess(kernel(q, k, v, causal=False, n_split=1), want)
    one_ex = excess(kernel(q, k, v, causal=False, n_split=1, product=mm1),
                    want)
    assert split_ex < 0.2, split_ex
    assert one_ex > 1, one_ex
