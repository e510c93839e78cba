"""Architecture registry of the port: --arch <id> -> ModelConfig, and the
assigned input shapes (`get_shape`).

The port holds every architecture of the reference's registry
(`repro/configs/__init__.py`): the nine decoder-only ones and Whisper-small,
the encoder-decoder (`models/encdec.py`).
"""
from __future__ import annotations

from repro_torch.configs import (chatglm3_6b, deepseek_67b,
                                 deepseek_v2_lite_16b, granite_moe_1b_a400m,
                                 minicpm3_4b, qwen2_vl_7b, tinyllama_1_1b,
                                 whisper_small, xlstm_125m, zamba2_1_2b)
from repro_torch.configs.shapes import SHAPES
from repro_torch.types import ModelConfig, ShapeConfig

ARCHS = {
    c.CONFIG.name: c.CONFIG
    for c in (chatglm3_6b, deepseek_67b, qwen2_vl_7b, granite_moe_1b_a400m,
              whisper_small, xlstm_125m, tinyllama_1_1b, zamba2_1_2b,
              deepseek_v2_lite_16b, minicpm3_4b)
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]
