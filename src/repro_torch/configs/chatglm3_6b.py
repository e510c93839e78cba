"""ChatGLM3-6B [arXiv:2406.12793] — dense, RoPE-2D (rotary on half the head
dims), GQA with 2 KV heads.
The port's copy of `repro/configs/chatglm3_6b.py`."""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_kind="rope2d",
    mlp_kind="swiglu",
    long_context_mode="swa",
)
