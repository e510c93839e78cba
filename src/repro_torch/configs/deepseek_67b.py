"""DeepSeek-67B [arXiv:2401.02954] — dense llama-arch, 95 layers, GQA kv=8.
Largest assigned model: FSDP param sharding over the data axis.
The port's copy of `repro/configs/deepseek_67b.py`."""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope_kind="rope",
    mlp_kind="swiglu",
    fsdp=True,
    long_context_mode="swa",
)
