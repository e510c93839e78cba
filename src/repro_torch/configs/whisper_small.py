"""Whisper-small [arXiv:2212.04356] — encoder-decoder, 12+12 layers, MHA,
GELU MLP, LayerNorm, sinusoidal positions; the port's copy of
`repro/configs/whisper_small.py`. The mel + conv frontend is a stub: a
batch brings (B, 1500, d_model) frame embeddings. The decoder's positions
stop at 448, which bounds the decode regime (no 500k-token shape)."""
from repro_torch.types import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    is_encoder_decoder=True,
    num_encoder_layers=12,
    encoder_seq=1500,
    rope_kind="none",
    norm_kind="layernorm",
    mlp_kind="gelu",
    long_context_mode="skip",
)
