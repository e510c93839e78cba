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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _split_proj(p, cfg, x):
    di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["w_in"]
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


def _gate_out(p, cfg, y, xs, z, x_dtype):
    """D skip, the z gate, the out norm and projection (prefill and
    decode alike): y, xs (B,S,H,P) -> (B,S,d)."""
    B, S = y.shape[:2]
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, S, cfg.d_inner).to(x_dtype) * F.silu(z)
    y = layers.rmsnorm(p["out_norm"], y, cfg.norm_eps)
    return y @ p["w_out"]


def mamba2_block(p, cfg, x, *, return_cache: bool = False):
    """x (B,S,d) -> y (B,S,d) [, cache=(conv_state, ssm_state)]."""
    B, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.mamba_heads, cfg.mamba_head_dim
    z, xbc, dt = _split_proj(p, cfg, x)
    xbc_conv = _causal_conv(p["conv_w"], p["conv_b"], xbc)
    xs = xbc_conv[..., :di].reshape(B, S, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    y, h_final = ssd_chunked(xs, xbc_conv[..., di:di + N],
                             xbc_conv[..., di + N:], dt, -torch.exp(p["A_log"]),
                             cfg.ssm_chunk)
    y = _gate_out(p, cfg, y, xs, z, x.dtype)
    if return_cache:
        conv_state = xbc[:, -(cfg.ssm_conv - 1):, :]          # last cw-1 inputs
        return y, (conv_state, h_final)
    return y


def mamba2_decode(p, cfg, x, cache):
    """One-token decode. x (B,1,d); cache=(conv_state (B,cw-1,C), h
    (B,H,P,N) float32) -> (y, (new conv_state, new h)), new tensors."""
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.mamba_heads, cfg.mamba_head_dim
    conv_state, h = cache
    z, xbc, dt = _split_proj(p, cfg, x)                       # (B,1,.)
    conv, new_conv_state = xlstm._conv_step(p["conv_w"], p["conv_b"],
                                            conv_state, xbc)
    xs = conv[..., :di].reshape(B, 1, H, P)
    Bm = conv[:, 0, di:di + N].float()
    Cm = conv[:, 0, di + N:].float()
    dt = F.softplus(dt[:, 0, :].float() + p["dt_bias"][None, :])  # (B,H)
    decay = torch.exp(dt * -torch.exp(p["A_log"])[None, :])   # (B,H)
    h_new = (decay[:, :, None, None] * h
             + torch.einsum("bh,bn,bhp->bhpn", dt, Bm, xs[:, 0].float()))
    y = torch.einsum("bn,bhpn->bhp", Cm, h_new)[:, None]      # (B,1,H,P)
    return _gate_out(p, cfg, y, xs, z, x.dtype), (new_conv_state, h_new)
