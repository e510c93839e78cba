"""Configuration dataclasses of the port: own copies of the reference's
`CollabConfig`, `FleetConfig` and `TrainConfig` (repro/types.py), field for
field, so a config built for one package reads the same in the other."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class CollabConfig:
    """Hyper-parameters of the paper's technique (CoRS)."""
    lambda_kd: float = 10.0          # paper Fig.3 chosen value
    lambda_disc: float = 1.0
    n_avg: int = 10                  # samples per observation average
    m_up: int = 1                    # observations uploaded per class/round
    m_down: int = 1                  # observations downloaded per class/round
    num_classes: int = 10
    d_feature: int = 84
    num_negatives: int = 0           # 0 -> K = C-1 (paper); >0 -> sampled (LM)
    proto_momentum: float = 0.0      # 0 = per-round recompute (paper); >0 EMA
    mode: str = "cors"               # cors | il | fedavg | fd | cl


@dataclass(frozen=True)
class FleetConfig:
    """Who the fleet is and how it behaves (relay policy, participation,
    clocks, mesh, arrivals). The port's sequential trainer runs the flat
    relay with full, synchronous participation; any other value raises
    `NotImplementedError` naming the ROADMAP slice that brings it."""
    policy: Any = None
    participation: Any = None
    clock: Any = None
    download_clock: Any = None
    mesh: Any = None
    arrivals: Any = None


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3      # paper default
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    batch_size: int = 32
    local_epochs: int = 1            # E in Algorithm 2
    rounds: int = 20
    seed: int = 0
    optimizer: str = "adam"
    warmup_steps: int = 0
    schedule: str = "constant"       # constant | cosine
