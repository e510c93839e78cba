"""The card the run uses: the check that it is there, its name, and the
published peaks every share is taken against."""
from __future__ import annotations

from typing import Dict

# Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
# 700 W limit): FLOP/s by the dtype a configuration computes in, and HBM
# bytes/s. float32 is outside the tensor cores (TF32 off).
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


class NoChip(RuntimeError):
    """The run found fewer cards than its cell needs."""


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoChip("no CUDA device: the benchmark measures the card and "
                     "does not fall back to the CPU")
    have = torch.cuda.device_count()
    if have < n:
        raise NoChip(f"the cell needs {n} cards, this machine has {have}")


def describe(count: int) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}

