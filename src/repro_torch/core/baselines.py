"""Baselines the paper compares against (Table 1): FedAvg's weight average
and the model size it bills; the port of `repro/core/baselines.py`. IL and
CL need no code of their own: they are trainer modes with no exchange."""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def fedavg_aggregate(params_list: Sequence[Dict[str, torch.Tensor]],
                     weights=None) -> Dict[str, torch.Tensor]:
    """McMahan et al. 17: the weighted sum of homogeneous models' parameters,
    w = 1/n by default, in the reference's order (a Python sum over the
    clients). Returns new tensors; the inputs are not modified."""
    n = len(params_list)
    if weights is None:
        weights = [1.0 / n] * n
    return {k: sum(w * p[k] for w, p in zip(weights, params_list))
            for k in params_list[0]}


def num_params(params: Dict[str, torch.Tensor]) -> int:
    return sum(int(p.numel()) for p in params.values())
