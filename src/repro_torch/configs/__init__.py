"""Architecture registry of the port: --arch <id> -> ModelConfig.

The port serves the architectures whose modules it has. Every other id of
the reference's registry (`repro/configs/__init__.py`) raises `KeyError`
naming the ROADMAP queue that brings its family.
"""
from __future__ import annotations

from repro_torch.configs import tinyllama_1_1b
from repro_torch.types import ModelConfig

ARCHS = {c.CONFIG.name: c.CONFIG for c in (tinyllama_1_1b,)}

# the reference's other architectures: their families come in later slices
NOT_PORTED = ("chatglm3-6b", "deepseek-67b", "qwen2-vl-7b",
              "granite-moe-1b-a400m", "xlstm-125m", "zamba2-1.2b",
              "deepseek-v2-lite-16b", "whisper-small", "minicpm3-4b")


def get_arch(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP.md, queue 1: "
                       f"other LM families); available: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
