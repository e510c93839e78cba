"""Basic functional layers, the port of `repro/nn/layers.py`: init helpers,
norms and MLPs on plain dicts of tensors.

Dense weights keep the reference's (in, out) layout, so `x @ w` is its
`einsum("...d,df->...f")` and `convert.lm_params_from_jax` copies them as
they are. Init draws from a `torch.Generator` (the reference's
distributions, other numbers) on the generator's device, then casts. The
norms compute in float32 and cast back to x's dtype, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn(d_in, d_out, generator=gen, device=gen.device)
            * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (torch.randn(vocab, d, generator=gen, device=gen.device)
            * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_rmsnorm(d: int, dtype, device=None):
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype, device=None):
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def init_norm(kind: str, d: int, dtype, device=None):
    return (init_rmsnorm(d, dtype, device) if kind == "rmsnorm"
            else init_layernorm(d, dtype, device))


def apply_norm(kind: str, params, x, eps: float):
    return rmsnorm(params, x, eps) if kind == "rmsnorm" \
        else layernorm(params, x, eps)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    return {"w_gate": dense_init(gen, d_model, d_ff, dtype),
            "w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype)}


def swiglu(params, x):
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    dev = gen.device
    return {"w_up": dense_init(gen, d_model, d_ff, dtype),
            "b_up": torch.zeros(d_ff, dtype=dtype, device=dev),
            "w_down": dense_init(gen, d_ff, d_model, dtype),
            "b_down": torch.zeros(d_model, dtype=dtype, device=dev)}


def gelu_mlp(params, x):
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
    return h @ params["w_down"] + params["b_down"]


def init_mlp(kind: str, gen: torch.Generator, d_model: int, d_ff: int, dtype):
    return (init_swiglu(gen, d_model, d_ff, dtype) if kind == "swiglu"
            else init_gelu_mlp(gen, d_model, d_ff, dtype))


def apply_mlp(kind: str, params, x):
    return swiglu(params, x) if kind == "swiglu" else gelu_mlp(params, x)
