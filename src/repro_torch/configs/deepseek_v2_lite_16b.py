"""DeepSeek-V2-Lite-16B [arXiv:2405.04434] — MoE with MLA: kv_lora 512
compressed latent cache, 64 routed experts top-6 + 2 shared, per-expert
d_ff 1408. (The assignment note's "160 routed" is the full V2; Lite per
the paper is 64 routed — we follow the 64e top-6 numbers given.)
The port's copy of `repro/configs/deepseek_v2_lite_16b.py`."""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    attn_kind="mla",
    q_lora_rank=0,               # V2-Lite: no query compression
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    num_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    num_shared_experts=2,
    rope_kind="rope",
    mlp_kind="swiglu",
    long_context_mode="swa",
)
