"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] — MoE,
32 experts top-8, expert d_ff 512 (d_ff column of the assignment = per-expert
ffn width), GQA kv=8.
The port's copy of `repro/configs/granite_moe_1b_a400m.py`."""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    rope_kind="rope",
    mlp_kind="swiglu",
    long_context_mode="swa",
)
