"""CPU emulations of the order of work of the port's proto_accum and
disc_loss CUDA kernels (`src/repro_torch/kernels/csrc/`), held against the
port's plain versions (`kernels/ref.py`) and the JAX reference
(`repro.kernels.ref`, the Pallas kernels in interpret mode, `jax.grad`).

The kernels run only on the card; these tests check on the CPU that the
walks they take (row chunks added in chunk order, class tiles with a running
max, teacher-row tiles whose BCE sums are added in order, the one-launch
backward's tiles) compute the contract, at the main path's shapes and at
shapes one off a tile or chunk. Each emulation adds in float32 in the
kernel's order; the tile sizes are the kernels' constants.

Tolerances: against the port's plain versions 1e-5 x max(1, max|plain|)
(+ 1e-5 relative), the card check's limit, float32 sums in another order;
against the JAX reference 2e-4, as the reference's own Pallas tests; counts
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import disc_loss as jdl, proto_accum as jpa
from repro.kernels import ref as jref
from repro_torch.kernels import ref

EPS = np.float32(1e-7)
# the kernels' tiles (csrc/disc_loss.cu, csrc/proto_accum.cu)
FB_M, FB_N, FB_K = 128, 128, 32      # forward: rows, teacher rows, classes
BB_R, BB_C, BB_M = 32, 64, 256       # backward: rows, classes, teacher rows


def _close_plain(got, want):
    want = np.asarray(want, np.float64)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)


def _close_ref(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4)


# -- proto_accum --------------------------------------------------------------
def proto_walk(f, lab, C, K):
    """K row chunks of ceil(n / K) rows; each adds its rows in row order into
    per-class float32 accumulators; the K partials are added in chunk order
    (the cluster's or the last block's second pass)."""
    n, d = f.shape
    chunk = -(-n // K) if n else 0
    parts, counts = [], []
    for k in range(K):
        acc = np.zeros((C, d), np.float32)
        cnt = np.zeros(C, np.int64)
        for i in range(min(n, k * chunk), min(n, (k + 1) * chunk)):
            if 0 <= lab[i] < C:
                acc[lab[i]] += f[i]
                cnt[lab[i]] += 1
        parts.append(acc)
        counts.append(cnt)
    tot = parts[0].copy()
    for p in parts[1:]:
        tot += p
    return tot, np.sum(counts, 0).astype(np.float32)


@pytest.mark.parametrize("n,d,C,K", [
    (240, 84, 10, 8),        # the main path: 8 chunks of 30 rows
    (241, 84, 10, 8),        # one row past a whole chunk
    (239, 84, 10, 8),
    (1024, 84, 10, 16),      # a cluster of 16
    (1000, 64, 300, 3),      # class tiles of 32 (sparse walk)
    (130, 129, 33, 3),       # one class past a tile, one column past a chunk
    (7, 16, 17, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proto_accum_chunk_walk(n, d, C, K, dtype):
    rng = np.random.default_rng(n + d + C)
    f = rng.standard_normal((n, d)).astype(np.float32)
    lab = rng.integers(-1, C + 1, n).astype(np.int32)      # some out of range
    ft = torch.from_numpy(f).to(getattr(torch, dtype))
    fe = ft.float().numpy()                                # the values staged
    s, c = proto_walk(fe, lab, C, K)
    rs, rc = ref.proto_accum(ft, torch.from_numpy(lab), C)
    _close_plain(s, rs.numpy())
    np.testing.assert_array_equal(c, rc.numpy())
    fj = jnp.asarray(f, getattr(jnp, dtype))
    js, jc = jref.proto_accum(fj, lab, C)
    _close_ref(s, js)
    np.testing.assert_array_equal(c, np.asarray(jc))
    ok = (lab >= 0) & (lab < C)          # the Pallas kernel takes labels in range
    ps, pc = jpa.proto_accum(fj[ok], lab[ok], C, block_n=128, block_c=64,
                             interpret=True)
    _close_ref(s, ps)
    np.testing.assert_array_equal(c, np.asarray(pc))


# -- disc_loss forward ---------------------------------------------------------
def fwd_splits(B, C, M):
    """The forward's split of the class axis (`fwd_plan` in disc_loss.cu):
    about one block an SM -> (splits, class tiles a split)."""
    n_mb = -(-M // FB_N) if M > FB_N else 1
    tiles, nt = n_mb * -(-B // FB_M), -(-C // FB_K)
    S = max(1, min((132 + tiles // 2) // tiles, nt, 8))
    tps = -(-nt // S) if nt else 0
    return (-(-nt // tps) if tps else 1), tps


def disc_fwd_walk(s, q, y, v):
    """Row tiles of FB_M, teacher-row tiles of FB_N, the class axis split in
    `fwd_splits` parts, each walked in tiles of FB_K with a running max (a
    row still at -inf uses 0 in its place); the parts rescaled to their
    common max and added in order, h = acc / z; each teacher-row tile's BCE
    row sums, then those added in tile order."""
    B, C = s.shape
    M = q.shape[0]
    S, tps = fwd_splits(B, C, M)
    v = np.ones(M, np.float32) if v is None else v.astype(np.float32)
    h_raw = np.zeros((B, M), np.float32)
    loss = np.zeros(B, np.float32)
    row_max = np.zeros(B, np.float32)
    log_z = np.zeros(B, np.float32)
    for r0 in range(0, B, FB_M):
        sr = s[r0:r0 + FB_M]
        parts = []
        for n0 in range(0, max(M, 1), FB_N):
            qn = q[n0:n0 + FB_N]
            split = []
            for k in range(S):
                m = np.full(len(sr), -np.inf, np.float32)
                z = np.zeros(len(sr), np.float32)
                acc = np.zeros((len(sr), len(qn)), np.float32)
                for k0 in range(k * tps * FB_K, min(C, (k + 1) * tps * FB_K), FB_K):
                    x = sr[:, k0:k0 + FB_K]
                    m_new = np.maximum(m, x.max(1))
                    m_use = np.where(m_new == -np.inf, 0, m_new).astype(np.float32)
                    al = np.exp(m - m_use)
                    e = np.exp(x - m_use[:, None])
                    z = z * al + e.sum(1, dtype=np.float32)
                    acc = acc * al[:, None] + e @ qn[:, k0:k0 + FB_K].T
                    m = m_new
                split.append((m, z, acc))
            m = np.max([p[0] for p in split], 0)
            mu = np.where(m == -np.inf, 0, m).astype(np.float32)
            z = np.zeros(len(sr), np.float32)
            acc = np.zeros((len(sr), len(qn)), np.float32)
            for mk, zk, ak in split:
                sc = np.exp(mk - mu)
                z += zk * sc
                acc += ak * sc[:, None]
            hr = (acc / z[:, None]).astype(np.float32)
            h_raw[r0:r0 + FB_M, n0:n0 + FB_N] = hr
            h = np.clip(hr, EPS, 1 - EPS)
            mids = np.arange(n0, n0 + len(qn))
            pos = mids[None, :] == y[r0:r0 + FB_M, None]
            per = np.where(pos, -np.log(h), -np.log1p(-h)) * v[None, n0:n0 + FB_N]
            parts.append(per.sum(1, dtype=np.float32))
            row_max[r0:r0 + FB_M], log_z[r0:r0 + FB_M] = m, np.log(z)
        tot = parts[0].copy()
        for p in parts[1:]:
            tot += p
        loss[r0:r0 + FB_M] = tot
    return loss, row_max, log_z, h_raw


def _disc_inputs(B, C, M, seed, with_valid):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((B, C)) * 2).astype(np.float32)
    q = np.asarray(jax.nn.softmax(
        (rng.standard_normal((M, C)) * 2).astype(np.float32), axis=-1))
    y = rng.integers(0, M, B).astype(np.int32)
    v = (np.arange(M) % 3 != 1) if with_valid else None
    return s, q, y, v


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


DISC_WALK_SHAPES = [(32, 10, 10),      # the main path: one block, one tile
                    (65, 33, 129),     # one past a row, class and M tile
                    (63, 31, 127),     # one short of each
                    (64, 64, 300),     # three teacher-row tiles, two splits
                    (100, 777, 33),    # eight splits of the class axis
                    (256, 1000, 256)]  # the LM shape's tiling, cut in rows


@pytest.mark.parametrize("B,C,M", DISC_WALK_SHAPES)
@pytest.mark.parametrize("with_valid", [False, True])
def test_disc_loss_forward_tile_walk(B, C, M, with_valid):
    s, q, y, v = _disc_inputs(B, C, M, B + C + M, with_valid)
    got = disc_fwd_walk(s, q, y, v)
    want = ref.disc_loss_fwd(_t(s), _t(q), _t(y), _t(v))
    for a, b in zip(got, want):
        _close_plain(a, b.numpy())
    _close_ref(got[0], jref.disc_loss(s, q, y, v))
    vv = np.ones((M,), bool) if v is None else v
    _close_ref(got[0], jdl.disc_loss(s, q, y, vv, block_b=32, block_c=256,
                                     interpret=True))


def test_disc_loss_forward_walk_masked_class_tiles():
    """Whole class tiles of -inf logits (a masked vocabulary) leave the
    running max at -inf for a while: no NaN, the plain result."""
    s, q, y, v = _disc_inputs(8, 100, 12, 7, False)
    s[:, :40] = -np.inf
    s[3, 50:] = -np.inf
    got = disc_fwd_walk(s, q, y, v)
    for a, b in zip(got, ref.disc_loss_fwd(_t(s), _t(q), _t(y), None)):
        assert np.isfinite(a).all()
        _close_plain(a, b.numpy())


# -- disc_loss backward ---------------------------------------------------------
def bwd_splits(B, C, M):
    """The backward's row splits (`bwd_plan` in disc_loss.cu): about one
    block an SM -> rows a split."""
    n_ct, nrt = -(-C // BB_C), -(-B // BB_R)
    S = max(1, (132 + n_ct // 2) // n_ct)
    S = min(S, max(1, nrt)) if M > 0 else 1
    return -(-nrt // S) * BB_R


def disc_bwd_walk(g, s, q, y, v, row_max, log_z, h_raw):
    """Blocks of (class tile of BB_C, row split): teacher rows in tiles of
    BB_M, the split's rows in tiles of BB_R; G and gh per row tile from
    h_raw; G q as eight parts of the teacher rows added in order; ds
    accumulates p (G q - gh) of each teacher-row tile in order; dq of a
    teacher-row tile accumulates G^T p over the row tiles in order, split
    over 4 row groups (rows j, j + 4, ... of each tile) added in group order
    when the tile has at most 64 teacher rows; the row splits' dq added in
    split order."""
    B, C = s.shape
    M = q.shape[0]
    v = np.ones(M, np.float32) if v is None else v.astype(np.float32)
    ds = np.zeros((B, C), np.float32)
    rows_per = bwd_splits(B, C, M)
    dq_splits = []
    for b0 in range(0, B, rows_per):
        dq = np.zeros((M, C), np.float32)
        for c0 in range(0, C, BB_C):
            cs = slice(c0, c0 + BB_C)
            for m0 in range(0, max(M, 1), BB_M):
                ms = slice(m0, m0 + BB_M)
                mcnt = len(range(M)[ms])
                mcnt4 = -(-mcnt // 4) * 4
                mq = max(4, (mcnt4 // 4 + 7) // 8 * 4)   # a warp's teacher rows
                groups = 4 if mcnt <= 64 else 1
                dq_g = np.zeros((groups, mcnt, len(range(C)[cs])), np.float32)
                for r0 in range(b0, min(B, b0 + rows_per), BB_R):
                    rs = slice(r0, min(r0 + BB_R, b0 + rows_per))
                    hr = h_raw[rs, ms]
                    kappa = (hr > EPS) & (hr < 1 - EPS)
                    pos = np.arange(m0, m0 + mcnt)[None, :] == y[rs, None]
                    with np.errstate(divide="ignore"):
                        fac = np.where(pos, -(np.float32(1) / hr),
                                       np.float32(1) / (np.float32(1) - hr))
                    G = np.where(kappa, g[rs, None] * v[None, ms] * fac,
                                 0).astype(np.float32)
                    gh = (G * hr).sum(1, dtype=np.float32)
                    p = np.exp((s[rs, cs] - row_max[rs, None]) - log_z[rs, None])
                    Gq = np.zeros((G.shape[0], p.shape[1]), np.float32)
                    for w in range(8):
                        Gq += G[:, w * mq:(w + 1) * mq] @ q[ms, cs][w * mq:(w + 1) * mq]
                    t = p * (Gq - gh[:, None])
                    ds[rs, cs] = t if m0 == 0 else ds[rs, cs] + t
                    for j in range(groups):
                        dq_g[j] += G[j::groups].T @ p[j::groups]
                tot = dq_g[0].copy()
                for part in dq_g[1:]:
                    tot += part
                dq[ms, cs] = tot
        dq_splits.append(dq)
    dq = dq_splits[0].copy()
    for part in dq_splits[1:]:
        dq += part
    return ds, dq


@pytest.mark.parametrize("B,C,M", [(32, 10, 10), (33, 65, 257), (129, 40, 70),
                                   (16, 64, 600), (100, 777, 33), (320, 10, 10)])
@pytest.mark.parametrize("with_valid", [False, True])
def test_disc_loss_backward_tile_walk(B, C, M, with_valid):
    s, q, y, v = _disc_inputs(B, C, M, 2 + B + C + M, with_valid)
    g = np.random.default_rng(3).standard_normal(B).astype(np.float32)
    _, row_max, log_z, h_raw = ref.disc_loss_fwd(_t(s), _t(q), _t(y), _t(v))
    got = disc_bwd_walk(g, s, q, y, v, row_max.numpy(), log_z.numpy(),
                        h_raw.numpy())
    want = ref.disc_loss_bwd(_t(g), _t(s), _t(q), _t(y), _t(v), row_max,
                             log_z, h_raw)
    for a, b in zip(got, want):
        _close_plain(a, b.numpy())
    f = lambda ss, qq: jnp.sum(g * jref.disc_loss(ss, qq, y, v))
    for a, b in zip(got, jax.grad(f, argnums=(0, 1))(s, q)):
        _close_ref(a, b)


# -- the client axis: workspace and counters a client ----------------------------
# A launch of N clients gives each client a slice of the workspace (the plan's
# floats for one client) and of the counters (the plan's counters for one
# client), at client * size; every block moves its pointers there first
# (`at_client` in disc_loss.cu, the client prologue of proto_accum_kernel).
# The emulation below runs every block of every client in a random order over
# one shared workspace and counter array, as the card may: each block writes
# its partial into its region of its client's slice and bumps its tile's
# counter; the last to arrive adds the tile's partials in order and resets the
# counter. Any region or counter outside its client's slice, or shared by two
# tiles, breaks the sums or leaves a counter set.
PA_CT_DENSE, PA_CT, PA_COLS, PA_CLUSTER = 16, 32, 128, 16


def fwd_plan(B, C, M):
    """`fwd_plan` of disc_loss.cu -> (regions a tile, workspace floats,
    counters) for one client: the class-axis splits' partials (one tile a
    (row tile, M tile)) and the M tiles' row sums (one tile a row tile)."""
    n_mb = -(-M // FB_N) if M > FB_N else 1
    n_rb = -(-B // FB_M)
    S, _ = fwd_splits(B, C, M)
    tiles = n_mb * n_rb
    per = FB_M * (FB_N + 2)
    part = -(-(n_mb * B) // 4) * 4 if n_mb > 1 else 0
    regions = []
    if S > 1:
        regions += [(t, [part + (ks * tiles + t) * per + np.arange(per)
                         for ks in range(S)]) for t in range(tiles)]
    if n_mb > 1:
        base = tiles if S > 1 else 0
        regions += [(base + rb, [mb * B + rb * FB_M + np.arange(min(FB_M, B - rb * FB_M))
                                 for mb in range(n_mb)]) for rb in range(n_rb)]
    ws = part + (S * tiles * per if S > 1 else 0)
    cnt = (tiles if S > 1 else 0) + (n_rb if n_mb > 1 else 0)
    return regions, ws, cnt


def bwd_plan(B, C, M):
    """`bwd_plan` of disc_loss.cu: each row split's dq of a class tile, in
    the split's (M, C) slice of the workspace; one counter a class tile."""
    rows = bwd_splits(B, C, M)
    S = -(-B // rows)
    n_ct = -(-C // BB_C)
    if S == 1:
        return [], 0, 0
    cols = lambda ct: np.arange(ct * BB_C, min(C, (ct + 1) * BB_C))
    regions = [(ct, [(k * M + np.arange(M)[:, None]) * C + cols(ct)[None, :]
                     for k in range(S)]) for ct in range(n_ct)]
    return regions, S * M * C, n_ct


def proto_plan(n, d, C):
    """`proto_accum_plan` and the workspace pass of proto_accum.cu (K > 16):
    each chunk's sums and counts of a (class tile, column chunk)."""
    ct = C if C <= PA_CT_DENSE else PA_CT
    n_t, n_c = -(-C // ct), -(-d // PA_COLS)
    K = min(-(-n // 32), n // C, -(-2 * 132 // (n_t * n_c)))
    if n <= 4096 and K > PA_CLUSTER:
        K = PA_CLUSTER
    K = max(K, 1)
    if K <= PA_CLUSTER:
        return K, [], 0, 0
    regions = []
    for t in range(n_t):
        cls = np.arange(t * ct, min(C, (t + 1) * ct))
        for cc in range(n_c):
            col = np.arange(cc * PA_COLS, min(d, (cc + 1) * PA_COLS))
            parts = []
            for k in range(K):
                r = ((k * C + cls[:, None]) * d + col[None, :]).ravel()
                if cc == 0:                              # the counts ride along
                    r = np.concatenate([r, K * C * d + k * C + cls])
                parts.append(r)
            regions.append((t * n_c + cc, parts))
    return K, regions, K * C * (d + 1), n_t * n_c


def emulate_client_grid(N, regions, ws_client, cnt_client, seed):
    rng = np.random.default_rng(seed)
    ws = np.full(N * ws_client, np.nan, np.float32)
    cnt = np.zeros(N * cnt_client, np.int64)
    parts = {(c, t, p): rng.standard_normal(len(r.ravel())).astype(np.float32)
             for c in range(N) for t, (_, rs) in enumerate(regions)
             for p, r in enumerate(rs)}
    order = list(parts)
    rng.shuffle(order)
    done = {}
    for c, t, p in order:
        counter, rs = regions[t]
        idx = rs[p].ravel()
        assert idx.min() >= 0 and idx.max() < ws_client and counter < cnt_client
        ws[c * ws_client + idx] = parts[(c, t, p)]
        cnt[c * cnt_client + counter] += 1
        if cnt[c * cnt_client + counter] == len(rs):       # the last block
            tot = np.zeros(len(idx), np.float32)
            for r in rs:
                tot += ws[c * ws_client + r.ravel()]
            done[(c, t)] = tot
            cnt[c * cnt_client + counter] = 0
    assert not cnt.any()                                   # reset for the next launch
    for (c, t), got in done.items():
        want = np.zeros_like(got)
        for p in range(len(regions[t][1])):
            want += parts[(c, t, p)]
        np.testing.assert_array_equal(got, want)
    assert len(done) == N * len(regions)


@pytest.mark.parametrize("N", [1, 2, 5])
@pytest.mark.parametrize("kernel,shape", [
    ("fwd", (100, 777, 33)),      # seven class-axis splits
    ("fwd", (64, 64, 300)),       # three M tiles and two splits
    ("fwd", (256, 1000, 256)),    # the LM shape's tiling, cut in rows
    ("bwd", (100, 777, 33)),      # four row splits of 13 class tiles
    ("bwd", (320, 10, 10)),
    ("proto", (5000, 84, 10)),    # 157 chunks: the workspace pass
    ("proto", (6000, 130, 40)),   # two class tiles, two column chunks
])
def test_client_axis_workspace_and_counters(N, kernel, shape):
    plan = {"fwd": fwd_plan, "bwd": bwd_plan,
            "proto": lambda *a: proto_plan(*a)[1:]}[kernel]
    regions, ws, cnt = plan(*shape)
    assert regions, "the shape must take the cross-block pass"
    # every floats and counter of a client's slice is some tile's, once
    covered = np.concatenate([r.ravel() for _, rs in regions for r in rs])
    assert len(np.unique(covered)) == len(covered) <= ws
    assert sorted({c for c, _ in regions}) == list(range(cnt))
    for seed in range(3):
        emulate_client_grid(N, regions, ws, cnt, seed)


@pytest.mark.parametrize("n,d,C", [(240, 84, 10), (5000, 84, 10)])
def test_proto_accum_client_axis_is_one_walk_a_client(n, d, C):
    """The N clients' sums are each client's own chunk walk."""
    K = proto_plan(n, d, C)[0]
    rng = np.random.default_rng(n)
    f = rng.standard_normal((3, n, d)).astype(np.float32)
    lab = rng.integers(-1, C + 1, (3, n)).astype(np.int32)
    rs, rc = ref.proto_accum(torch.from_numpy(f), torch.from_numpy(lab), C)
    for i in range(3):
        s, c = proto_walk(f[i], lab[i], C, K)
        _close_plain(s, rs[i].numpy())
        np.testing.assert_array_equal(c, rc[i].numpy())
