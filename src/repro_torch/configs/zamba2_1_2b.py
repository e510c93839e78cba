"""Zamba2-1.2B [arXiv:2411.15242] — hybrid: 38 Mamba2 blocks (state 64) with
one *shared-weight* full-attention block (MHA kv=32, d_ff 8192) applied every
6 layers. Attention-free backbone scan -> long_500k runs natively.
The port's copy of `repro/configs/zamba2_1_2b.py`."""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    block_pattern=tuple(["mamba"] * 38),
    shared_attn_period=6,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=128,
    rope_kind="rope",
    mlp_kind="swiglu",
    long_context_mode="native",
)
