"""Rotary position embeddings, the port of `repro/nn/rope.py`: standard,
2D-partial (ChatGLM) and M-RoPE (Qwen2-VL).

Inputs use the half-split convention: x[..., :r/2] and x[..., r/2:] form the
rotation pairs (llama convention). `positions` is (B, S) int for rope/rope2d
and (B, S, 3) [t, h, w] for mrope. cos/sin and the rotation run in float32;
the result is cast to x's dtype.
"""
from __future__ import annotations

import torch

# M-RoPE frequency-band split across (t, h, w), in units of freq indices of
# the half-dim, scaled to the actual rot_dim at call time.
MROPE_FRACTIONS = (0.25, 0.375, 0.375)


def _freqs(rot_half: int, theta: float, device):
    i = torch.arange(rot_half, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     -2.0 * i / (2.0 * rot_half))


def _cos_sin(positions, theta: float, rot_half: int, kind: str):
    """-> cos, sin of shape (B, S, rot_half) float32."""
    inv = _freqs(rot_half, theta, positions.device)
    if kind == "mrope":
        assert positions.dim() == 3 and positions.shape[-1] == 3
        n_t = int(round(MROPE_FRACTIONS[0] * rot_half))
        n_h = int(round(MROPE_FRACTIONS[1] * rot_half))
        sect = torch.cat([
            torch.zeros(n_t, dtype=torch.long),
            torch.ones(n_h, dtype=torch.long),
            torch.full((rot_half - n_t - n_h,), 2, dtype=torch.long)]
        ).to(positions.device)
        pos = positions.float()[..., sect]                     # (B,S,rot_half)
        ang = pos * inv
    else:
        ang = positions.float()[..., None] * inv               # (B,S,rot_half)
    return torch.cos(ang), torch.sin(ang)


def rot_dim_for(kind: str, head_dim: int) -> int:
    if kind == "rope2d":
        return head_dim // 2            # ChatGLM: rotary on half the dims
    return head_dim


def apply_rope(x, positions, *, theta: float, kind: str):
    """x: (B, S, H, D). Returns the same shape and dtype with rotary
    applied."""
    if kind == "none":
        return x
    d = x.shape[-1]
    r = rot_dim_for(kind, d)
    half = r // 2
    cos, sin = _cos_sin(positions, theta, half, kind)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xr = x[..., :r].float()
    x1, x2 = xr[..., :half], xr[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)
    return torch.cat([rot, x[..., r:]], -1) if r < d else rot


def default_positions(batch: int, seq: int, kind: str, offset: int = 0,
                      device=None):
    pos = (offset + torch.arange(seq, dtype=torch.int32, device=device)
           )[None, :].expand(batch, seq)
    if kind == "mrope":
        return pos[..., None].expand(batch, seq, 3)
    return pos
