"""TinyLlama-1.1B [arXiv:2401.02385] — llama2-arch small, GQA kv=4; the
port's copy of `repro/configs/tinyllama_1_1b.py`."""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    rope_kind="rope",
    mlp_kind="swiglu",
    long_context_mode="swa",
)
