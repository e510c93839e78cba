"""Operand rounding for the references' controls: each product's inputs,
and in the backward the gradient that reaches them, rounded to a lower
precision than the configuration states (TF32's 10-bit mantissa for a
float32 configuration, float8 e4m3 for a bfloat16 one), while the sums
stay in float32. Plain PyTorch: the same on the CPU and on the card."""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away from
    zero), as the tensor cores read TF32 operands."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """-> the nearest float8 e4m3 value, scaled per tensor so that its
    largest magnitude sits at the format's top (448), back in float32."""
    x = x.float()
    amax = x.abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


ROUNDERS = {"float32": None, "tf32": round_tf32, "fp8": round_fp8}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x as a product reads it at `precision` ("float32": unchanged)."""
    fn = ROUNDERS[precision]
    if fn is None:
        return x
    return _Round.apply(x, fn)
