"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — dense with MLA (q_lora 768,
kv_lora 256, qk_nope 64 + qk_rope 32, v_head 64), 62 layers, 40 heads.
The port's copy of `repro/configs/minicpm3_4b.py`."""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_rope_dim=32,
    qk_nope_dim=64,
    v_head_dim=64,
    head_dim=64,
    rope_kind="rope",
    mlp_kind="swiglu",
    long_context_mode="swa",
)
