"""xLSTM-125M [arXiv:2405.04517] — sLSTM + mLSTM blocks (1 sLSTM per 6),
4 heads, d_ff=0 (blocks carry their own projections); the port's copy of
`repro/configs/xlstm_125m.py`. The port trains and serves it."""
from repro_torch.types import ModelConfig

_PATTERN = tuple("slstm" if i % 6 == 3 else "mlstm" for i in range(12))

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_PATTERN,
    ssm_conv=4,
    ssm_chunk=256,
    rope_kind="none",
    long_context_mode="native",
)
