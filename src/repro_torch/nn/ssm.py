"""Mamba2 block by the chunked SSD algorithm, the port of `repro/nn/ssm.py`.

Intra-chunk work is dense (Q x Q) . (Q x P) products; the inter-chunk
state is a short recurrence over S/Q affine steps, the reference's
`lax.scan` written as a loop over chunks that emits the state *entering*
each chunk. Recurrence (per head h, scalar A):

    h_t = exp(A dt_t) h_{t-1} + dt_t B_t (x) x_t      (state: (P, N))
    y_t = C_t . h_t + D * x_t

Decode keeps (conv_state, ssm_state) in the cache and does the O(1)
update; the conv state is the last cw - 1 *pre-conv* inputs. Train mode
runs `mamba2_block` under autograd; nothing here writes in place into a
tensor autograd saved, and the intra-chunk decay is masked before its exp
so that its gradient stays finite at full width (`ssd_chunked`).

On a mesh (DTensor parameters) the two projections are DTensor ops, and
the block between them runs through `sharding.local_axes` (`local_map`)
on each rank's batch rows: DTensor has no rule for the SSD's mask and
ones (plain tensors beside DTensors, refused in PyTorch 2.11 and 2.13
alike) nor a plan for the conv's `F.pad` in 2.11, and one `local_map`
spares the chunk loop DTensor's dispatch op by op. Its channels are made
whole there over "model" (an all-gather of the projection's output, of
its gradient in train mode): `w_in`'s even split over "model" does not
fall on the uneven boundaries of z, xBC and dt, B and C feed every head's
state, and the out norm normalises over all of d_inner. Decode keeps the
state (B, H, P, N) where `serve.cache_shardings` places it, split on P
(or H) over "model": each rank updates its own block (`_state_update`,
elementwise in H and P), and only the one-token inputs, the conv state's
cw - 1 rows and the new token's y are made whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.nn import layers, xlstm

# the reference keeps two copies of one depthwise causal conv + SiLU
# (`ssm._causal_conv`, `xlstm._conv_silu`); the port keeps one
_causal_conv = xlstm._conv_silu


def init_mamba2(gen, cfg, dtype):
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, cw = cfg.mamba_heads, cfg.ssm_conv
    conv_ch = di + 2 * N
    dev = layers.gen_device(gen)
    return {
        "w_in": layers.dense_init(gen, d, 2 * di + 2 * N + H, dtype),
        "conv_w": (torch.randn(cw, conv_ch, generator=gen, device=dev)
                   * 0.2).to(dtype),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=dev),
        "A_log": torch.zeros(H, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(H, dtype=torch.float32, device=dev),
        "D": torch.ones(H, dtype=torch.float32, device=dev),
        "out_norm": layers.init_rmsnorm(di, dtype, dev),
        "w_out": layers.dense_init(gen, di, d, dtype),
    }


def _split(zxbcdt, cfg):
    """The input projection's output -> z, xBC, dt: uneven slices of its
    channels."""
    di, N = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
            zxbcdt[..., 2 * di + 2 * N:])                     # z, xbc, dt (B,S,H)


def ssd_chunked(xh, Bm, Cm, dt, A, Q: int, h0=None):
    """Chunked SSD scan.

    xh (B,S,H,P); Bm/Cm (B,S,N); dt (B,S,H) (post-softplus); A (H,) negative.
    Returns y (B,S,H,P) float32 and the final state (B,H,P,N).
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(Q, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q

    a = dt.float() * A[None, None, :]                         # (B,S,H) negative
    xh = xh.float().reshape(Bsz, nc, Q, H, P)
    Bc = Bm.float().reshape(Bsz, nc, Q, N)
    Cc = Cm.float().reshape(Bsz, nc, Q, N)
    dtc = dt.float().reshape(Bsz, nc, Q, H)
    cums = torch.cumsum(a.reshape(Bsz, nc, Q, H), dim=2)      # inclusive
    total = cums[:, :, -1, :]                                 # (B,nc,H)

    # intra-chunk (dense)
    Gm = torch.einsum("bcin,bcjn->bcij", Cc, Bc)              # (B,nc,Q,Q)
    Ld = cums[:, :, :, None, :] - cums[:, :, None, :, :]      # (B,nc,Q,Q,H) i,j
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    # masked before the exp (the reference masks after it): the upper
    # triangle's Ld is positive, up to Q dt |A|, and overflows at full width
    # (Zamba2: Q 128, dt about 0.7), where a mask after the exp passes a
    # gradient of 0 x inf = NaN; the forward values are the same
    L = torch.exp(Ld.masked_fill(~causal[None, None, :, :, None],
                                 float("-inf")))
    W = Gm[..., None] * L * dtc[:, :, None, :, :]             # weight (i,j,h)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xh)

    # chunk summary states
    decay_to_end = torch.exp(total[:, :, None, :] - cums)     # (B,nc,Q,H)
    Sc = torch.einsum("bcjh,bcjn,bcjhp->bchpn", dtc * decay_to_end, Bc, xh)

    # inter-chunk recurrence (the reference's lax.scan)
    h = (torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    enter = []
    for c in range(nc):
        enter.append(h)                                       # state entering chunk c
        h = torch.exp(total[:, c])[:, :, None, None] * h + Sc[:, c]
    h_enter = torch.stack(enter, dim=1)                       # (B,nc,H,P,N)

    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", Cc, torch.exp(cums),
                           h_enter)
    return (y_intra + y_inter).reshape(Bsz, S, H, P), h


def _gated(y, xs, z, D, norm_scale, cfg):
    """D skip, the z gate and the out norm (prefill and decode alike): y, xs
    (B,S,H,P) -> (B,S,di) in z's dtype, before `w_out`."""
    B, S = y.shape[:2]
    y = y + D[None, None, :, None] * xs.float()
    y = y.reshape(B, S, cfg.d_inner).to(z.dtype) * F.silu(z)
    return layers.rmsnorm({"scale": norm_scale}, y, cfg.norm_eps)


def _block_core(zxbcdt, conv_w, conv_b, dt_bias, A_log, D, norm_scale, *,
                cfg, return_cache: bool):
    """The block between its two projections, on whole channels: the
    split into z, xBC and dt, the conv, the SSD and `_gated` -> y
    (B,S,di) [, the conv state (B,cw-1,C), the final state (B,H,P,N)]."""
    B, S, _ = zxbcdt.shape
    di, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.mamba_heads,
                   cfg.mamba_head_dim)
    z, xbc, dt = _split(zxbcdt, cfg)
    xbc_conv = _causal_conv(conv_w, conv_b, xbc)
    xs = xbc_conv[..., :di].reshape(B, S, H, P)
    dt = F.softplus(dt.float() + dt_bias[None, None, :])
    y, h_final = ssd_chunked(xs, xbc_conv[..., di:di + N],
                             xbc_conv[..., di + N:], dt, -torch.exp(A_log),
                             cfg.ssm_chunk)
    y = _gated(y, xs, z, D, norm_scale, cfg)
    if return_cache:
        return y, xbc[:, -(cfg.ssm_conv - 1):, :], h_final
    return y


def _params(p):
    return (p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], p["D"],
            p["out_norm"]["scale"])


def mamba2_block(p, cfg, x, *, return_cache: bool = False):
    """x (B,S,d) -> y (B,S,d) [, cache=(conv_state, ssm_state)]. On a mesh
    the block's core runs on each rank's batch rows, its channels whole
    (see the module's docstring)."""
    fn = lambda *a: _block_core(*a, cfg=cfg, return_cache=return_cache)
    out = sharding.local_axes(
        fn, ("b..",) + (".",) * 6,
        ("b..", "b..", "b...") if return_cache else ("b..",),
        x @ p["w_in"], *_params(p))
    if return_cache:
        y, conv_state, h_final = out
        return y @ p["w_out"], (conv_state, h_final)
    return out @ p["w_out"]


def _decode_in(zxbcdt, conv_state, conv_w, conv_b, dt_bias, A_log, *, cfg):
    """Decode's inputs to the state update from the new token's projection
    (B,1,.) and the conv state: z, xs (B,1,H,P), dt and the decay (B,H),
    B and C (B,N), and the new conv state."""
    B = zxbcdt.shape[0]
    di, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.mamba_heads,
                   cfg.mamba_head_dim)
    z, xbc, dt = _split(zxbcdt, cfg)
    conv, new_conv_state = xlstm._conv_step(conv_w, conv_b, conv_state, xbc)
    xs = conv[..., :di].reshape(B, 1, H, P)
    dt = F.softplus(dt[:, 0, :].float() + dt_bias[None, :])     # (B,H)
    decay = torch.exp(dt * -torch.exp(A_log)[None, :])         # (B,H)
    return (z, xs, dt, decay, conv[:, 0, di:di + N].float(),
            conv[:, 0, di + N:].float(), new_conv_state)


def _state_update(h, xs, dt, decay, Bm, Cm):
    """h (B,H,P,N) -> (the new state, y (B,1,H,P)): elementwise in H and
    P, so a rank updates its own block of the state."""
    h_new = (decay[:, :, None, None] * h
             + torch.einsum("bh,bn,bhp->bhpn", dt, Bm, xs[:, 0].float()))
    return h_new, torch.einsum("bn,bhpn->bhp", Cm, h_new)[:, None]


def mamba2_decode(p, cfg, x, cache):
    """One-token decode. x (B,1,d); cache=(conv_state (B,cw-1,C), h
    (B,H,P,N) float32) -> (y, (new conv_state, new h)), new tensors. On a
    mesh the state is updated on the block of H or P its placement gives
    each rank; the one-token inputs are whole (see the module's
    docstring)."""
    conv_state, h = cache
    z, xs, dt, decay, Bm, Cm, new_conv_state = sharding.local_axes(
        lambda *a: _decode_in(*a, cfg=cfg), ("b..", "b..", "..", ".", ".",
                                             "."),
        ("b..", "b...", "b.", "b.", "b.", "b.", "b.."),
        x @ p["w_in"], conv_state, p["conv_w"], p["conv_b"], p["dt_bias"],
        p["A_log"])
    H = cfg.mamba_heads
    h_new, y = sharding.local_axes(
        _state_update, ("bhp.", "b.hp", "bh", "bh", "b.", "b."),
        ("bhp.", "b.hp"), h, xs, dt, decay, Bm, Cm,
        units={"h": H, "p": cfg.mamba_head_dim})
    y = sharding.local_axes(
        lambda *a: _gated(*a, cfg), ("b...", "b...", "b..", ".", "."),
        ("b..",), y, xs, z, p["D"], p["out_norm"]["scale"])
    return y @ p["w_out"], (new_conv_state, h_new)
