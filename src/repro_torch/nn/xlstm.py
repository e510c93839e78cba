"""xLSTM blocks, the port of `repro/nn/xlstm.py`: mLSTM (matrix memory,
chunk-parallel) and sLSTM (scalar memory, sequential), in train mode and
serving (prefill with `return_cache`, one-token `decode` against a cache).

mLSTM recurrence (per head, state C: (P_v, P_k), normalizer n: (P_k,)):
    C_t = f_t C_{t-1} + i_t v_t k_t^T
    n_t = f_t n_{t-1} + i_t k_t
    y_t = (C_t q_t) / max(|n_t . q_t|, 1)
run as the reference runs it: dense products inside a chunk, a short
recurrence across chunks, the normalizer as an appended ones column of v.
The reference's `lax.scan`s become Python loops: the inter-chunk scan of
`mlstm_chunked` and `slstm_scan` over time. The sLSTM keeps the
reference's stabiliser (m_t = max(f_pre + m_{t-1}, i_pre)), its -30.0
initial m and its float32 state. The mLSTM's cache is (conv_state (B,
cw-1, 2d), C (B, H, P+1, P) float32), the sLSTM's its (c, n, m, h) state;
decode returns new tensors.

On a mesh (DTensor parameters) the projections are DTensor ops and the
rest runs through `sharding.local_axes` (`local_map`), each on the block
of the rows, heads or channels that its inputs' placements give a rank:
the up projection's halves (its even split over "model" falls at the
halves' boundary, so the output is made whole first), the causal conv
(channel-local: on the conv state's split of channels in decode; `F.pad`
has no plan in PyTorch 2.11), the mLSTM cell (`mlstm_chunked` or the
decode step on the rank's heads; its forget gate's log-sigmoid inside,
as DTensor has no strategy for `aten.log_sigmoid_backward` in 2.11 or
2.13, and its mask and ones column are plain tensors, which DTensor
refuses beside DTensors), the whole sLSTM scan of S steps under one
`local_map` (DTensor's dispatch would be paid at every step; on the
state's split of heads in decode, as `serve.cache_shardings` places it,
else on the rows) and the out norms, which normalise over every channel,
so that y is made whole over "model" there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.nn import layers


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(gen, cfg, dtype):
    d = cfg.d_model
    di = 2 * d                      # projection factor 2 (xLSTM paper)
    dev = layers.gen_device(gen)
    return {
        "w_up": layers.dense_init(gen, d, 2 * di, dtype),
        "conv_w": (torch.randn(cfg.ssm_conv, di, generator=gen, device=dev)
                   * 0.2).to(dtype),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "wq": layers.dense_init(gen, di, di, dtype),
        "wk": layers.dense_init(gen, di, di, dtype),
        "wv": layers.dense_init(gen, di, di, dtype),
        "w_gates": layers.dense_init(gen, di, 2 * cfg.num_heads, dtype),
        "out_norm": layers.init_rmsnorm(di, dtype, dev),
        "w_down": layers.dense_init(gen, di, d, dtype),
    }


def _conv_silu(w, b, x):
    """Causal depthwise conv over the sequence axis of x (B, S, C), then
    SiLU; the taps summed in the reference's order."""
    cw = w.shape[0]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(cw))
    return F.silu(out + b[None, None, :])


def _conv_step(w, b, conv_state, x_new):
    """One decode step of `_conv_silu`: conv_state (B, cw-1, C) holds the
    last cw - 1 pre-conv inputs, x_new (B, 1, C) -> (conv (B, 1, C), the new
    conv_state)."""
    window = torch.cat([conv_state, x_new], dim=1)            # (B,cw,C)
    conv = F.silu(torch.einsum("bwc,wc->bc", window, w) + b)[:, None, :]
    return conv, window[:, 1:, :]


def mlstm_chunked(q, k, v, logf, logi, Q: int, state=None):
    """q,k,v (B,S,H,P); logf,logi (B,S,H). Returns y (B,S,H,P) f32, state.

    state = C (B,H,P+1,P), whose row P is the normalizer.
    """
    B, S, H, P = q.shape
    f32 = torch.float32
    Q = min(Q, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q
    ones = torch.ones(B, S, H, 1, dtype=f32, device=q.device)
    va = torch.cat([v.float(), ones], dim=-1)                 # (B,S,H,P+1)
    scale = P ** -0.5

    qc = (q.float() * scale).reshape(B, nc, Q, H, P)
    kc = k.float().reshape(B, nc, Q, H, P)
    vc = va.reshape(B, nc, Q, H, P + 1)
    ic = logi.float().reshape(B, nc, Q, H)
    fc = logf.float().reshape(B, nc, Q, H)
    cums = torch.cumsum(fc, dim=2)
    total = cums[:, :, -1, :]

    Gm = torch.einsum("bcihp,bcjhp->bcijh", qc, kc)           # (B,nc,Q,Q,H)
    Ld = cums[:, :, :, None, :] - cums[:, :, None, :, :] + ic[:, :, None, :, :]
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=q.device))
    # masked before the exp (the reference masks after it): the upper
    # triangle's Ld grows with the forget gate's decay between i and j and
    # overflows under a strongly forgetting gate (logf about -5 over a chunk
    # of 64), where a mask after the exp passes a gradient of 0 x inf = NaN;
    # the forward values are the same
    W = Gm * torch.exp(Ld.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, vc)

    decay_to_end = torch.exp(total[:, :, None, :] - cums + ic)  # (B,nc,Q,H)
    Sc = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", decay_to_end, vc, kc)

    C = (torch.zeros(B, H, P + 1, P, dtype=f32, device=q.device)
         if state is None else state)
    enter = []
    for c in range(nc):                    # the reference's lax.scan
        enter.append(C)
        C = torch.exp(total[:, c])[:, :, None, None] * C + Sc[:, c]
    C_enter = torch.stack(enter, dim=1)                       # (B,nc,H,P+1,P)
    y_inter = torch.einsum("bcihn,bcih,bchpn->bcihp",
                           qc, torch.exp(cums), C_enter)
    ya = (y_intra + y_inter).reshape(B, S, H, P + 1)
    y = ya[..., :P] / torch.clamp(torch.abs(ya[..., P:]), min=1.0)
    return y, C


def _mlstm_step(q, k, v, logf, logi, C):
    """The mLSTM's O(1) recurrent update: q, k, v (B,1,H,P), logf, logi
    (B,1,H), C (B,H,P+1,P) -> y (B,1,H,P) f32, the new C."""
    B, _, H, P = q.shape
    ones = torch.ones(B, H, 1, dtype=torch.float32, device=q.device)
    va = torch.cat([v[:, 0].float(), ones], dim=-1)           # (B,H,P+1)
    C_new = (torch.exp(logf[:, 0])[:, :, None, None] * C
             + torch.exp(logi[:, 0])[:, :, None, None]
             * torch.einsum("bhp,bhn->bhpn", va, k[:, 0].float()))
    ya = torch.einsum("bhn,bhpn->bhp", q[:, 0].float() * P ** -0.5, C_new)
    return (ya[..., :P] / torch.clamp(torch.abs(ya[..., P:]), min=1.0)
            )[:, None], C_new


def _gated_norm(y, z, norm_scale, eps):
    """y * silu(z), then the out norm over all of its channels."""
    return layers.rmsnorm({"scale": norm_scale}, y.to(z.dtype) * F.silu(z),
                          eps)


def _halves(up, n: int):
    return up[..., :n], up[..., n:]


def mlstm_block(p, cfg, x, *, return_cache: bool = False, cache=None,
                decode: bool = False):
    """x (B,S,d) -> y, or (y, cache) with `return_cache` (prefill) or
    `decode` (one token against `cache`). On a mesh (see the module's
    docstring) the conv runs on each rank's rows and channels, the cell on
    its rows and heads, the norm on its rows."""
    B, S, d = x.shape
    H = cfg.num_heads
    di = 2 * d
    P = di // H
    xm, z = sharding.local_axes(lambda u: _halves(u, di), ("b..",),
                                ("b..", "b.."), x @ p["w_up"])
    if decode:
        conv_state, C = cache
        conv, new_conv_state = sharding.local_axes(
            lambda s, xn, w, b: _conv_step(w, b, s, xn),
            ("b.c", "b.c", ".c", "c"), ("b.c", "b.c"),
            conv_state, xm, p["conv_w"], p["conv_b"])
    else:
        conv = sharding.local_axes(
            lambda xx, w, b: _conv_silu(w, b, xx), ("b.c", ".c", "c"),
            ("b.c",), xm, p["conv_w"], p["conv_b"])
    q = (conv @ p["wq"]).reshape(B, S, H, P)
    k = (conv @ p["wk"]).reshape(B, S, H, P)
    v = (xm @ p["wv"]).reshape(B, S, H, P)
    gates = (conv @ p["w_gates"]).float()
    # the forget gate's log-sigmoid is taken inside the cell's function
    # (DTensor has no rule for its backward)
    logi, fpre = gates[..., :H], gates[..., H:]
    heads = {"h": H}
    new_cache = None
    if decode:                             # the O(1) recurrent update
        y, C_new = sharding.local_axes(
            lambda c, q, k, v, f, i: _mlstm_step(q, k, v, F.logsigmoid(f),
                                                 i, c),
            ("bh..", "b.h.", "b.h.", "b.h.", "b.h", "b.h"),
            ("b.h.", "bh.."), C, q, k, v, fpre, logi, units=heads)
        new_cache = (new_conv_state, C_new)
    else:
        y, C_final = sharding.local_axes(
            lambda q, k, v, f, i: mlstm_chunked(q, k, v, F.logsigmoid(f), i,
                                                cfg.ssm_chunk),
            ("b.h.", "b.h.", "b.h.", "b.h", "b.h"), ("b.h.", "bh.."),
            q, k, v, fpre, logi, units=heads)
        if return_cache:
            new_cache = (xm[:, -(cfg.ssm_conv - 1):, :], C_final)
    y = sharding.local_axes(
        lambda *a: _gated_norm(*a, cfg.norm_eps), ("b..", "b..", "."),
        ("b..",), y.reshape(B, S, di), z, p["out_norm"]["scale"])
    y = y @ p["w_down"]
    if return_cache or decode:
        return y, new_cache
    return y


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(gen, cfg, dtype):
    d = cfg.d_model
    H = cfg.num_heads
    P = d // H
    dev = layers.gen_device(gen)
    return {
        "w_gates": layers.dense_init(gen, d, 4 * d, dtype),   # i,f,z,o per cell
        "r_gates": (torch.randn(4, H, P, P, generator=gen, device=dev)
                    / math.sqrt(P)).to(dtype),                # block-diag recurrence
        "out_norm": layers.init_rmsnorm(d, dtype, dev),
        "w_up": layers.dense_init(gen, d, 2 * d, dtype),      # GLU ffn
        "w_down": layers.dense_init(gen, d, d, dtype),
    }


def slstm_scan(gx, r, state):
    """gx (B,S,4,d) input gate pre-activations; r (4,H,P,P) recurrence.

    state = (c, n, m, h), each (B,d) float32. Returns h_seq (B,S,d), state.
    """
    B, S, four, d = gx.shape
    H, P = r.shape[1], r.shape[2]
    r32 = r.float()
    c, n, m, h = state
    hs = []
    for t in range(S):                     # the reference's lax.scan
        hh = h.reshape(B, H, P)
        rec = torch.einsum("ghpq,bhq->bghp", r32, hh).reshape(B, four, d)
        g = gx[:, t].float() + rec
        i_pre, f_pre, z_pre, o_pre = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        m_new = torch.maximum(f_pre + m, i_pre)
        i = torch.exp(i_pre - m_new)
        f = torch.exp(f_pre + m - m_new)
        c = f * c + i * torch.tanh(z_pre)
        n = f * n + i
        m = m_new
        h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


def _flat_scan(gx, r, state):
    hs, state = slstm_scan(gx, r, state)
    return (hs, *state)


def slstm_block(p, cfg, x, *, return_cache: bool = False, cache=None,
                decode: bool = False):
    """x (B,S,d) -> y, or (y, state) with `return_cache` or `decode`; the
    scan starts from `cache` when one is given, else from zeros with m at
    -30. On a mesh (see the module's docstring) the whole scan runs on each
    rank's rows, and on its block of heads where the state is split so."""
    B, S, d = x.shape
    gx = (x @ p["w_gates"]).reshape(B, S, 4, d)
    heads = {"h": cfg.num_heads}
    outs = ("b.h",) + ("bh",) * 4
    if cache is None:
        def fresh(g, r):
            z = torch.zeros(g.shape[0], g.shape[3], dtype=torch.float32,
                            device=g.device)
            return _flat_scan(g, r, (z, z, torch.full_like(z, -30.0), z))
        hs, *state = sharding.local_axes(
            fresh, ("b..h", ".h.."), outs, gx, p["r_gates"], units=heads)
    else:
        hs, *state = sharding.local_axes(
            lambda c, n, m, h, g, r: _flat_scan(g, r, (c, n, m, h)),
            ("bh",) * 4 + ("b..h", ".h.."), outs, *cache, gx, p["r_gates"],
            units=heads)
    state = tuple(state)
    hs = sharding.local_axes(
        lambda a, s: layers.rmsnorm({"scale": s}, a, cfg.norm_eps),
        ("b..", "."), ("b..",), hs.to(x.dtype), p["out_norm"]["scale"])
    up = hs @ p["w_up"]
    g, u = sharding.local_axes(lambda t: _halves(t, d), ("b..",),
                               ("b..", "b.."), up)
    y = (F.silu(g) * u) @ p["w_down"]
    if return_cache or decode:
        return y, state
    return y
