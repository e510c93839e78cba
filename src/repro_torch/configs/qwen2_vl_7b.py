"""Qwen2-VL-7B [arXiv:2409.12191] — VLM backbone: M-RoPE (t/h/w sections),
GQA kv=4. Vision frontend (ViT + projector) is the allowed STUB:
input_specs provides precomputed patch embeddings (B, S, d_model); positions
are the (B, S, 3) multimodal rope ids.
The port's copy of `repro/configs/qwen2_vl_7b.py`."""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope_kind="mrope",
    mlp_kind="swiglu",
    input_kind="embeddings",
    long_context_mode="swa",
)
