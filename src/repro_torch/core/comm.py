"""Exact communication accounting (paper section Communication); an own copy
of `repro/core/comm.py`.

Per round and per client, in floats (x4 bytes fp32 on the wire):
  CoRS uplink   : (M_up + 1) C d'        (observations + averaged reps)
  CoRS downlink : (M_down + 1) C d'      (observations + global prototypes)
  FD            : C C each way           (mean logits)
  FedAvg        : D each way             (the whole model)
"""
from __future__ import annotations

from dataclasses import dataclass, field

BYTES = 4


@dataclass
class CommLedger:
    up_floats: float = 0.0
    down_floats: float = 0.0
    by_round: list = field(default_factory=list)

    def log_round(self, up: float, down: float):
        self.up_floats += up
        self.down_floats += down
        self.by_round.append((up, down))

    @property
    def total_bytes(self) -> float:
        return BYTES * (self.up_floats + self.down_floats)


def cors_round_floats(C: int, d: int, m_up: int, m_down: int, n_clients: int):
    up = n_clients * (m_up + 1) * C * d
    down = n_clients * (m_down + 1) * C * d
    return up, down


def fd_round_floats(C: int, n_clients: int):
    return n_clients * C * C, n_clients * C * C


def fedavg_round_floats(model_size: int, n_clients: int):
    return n_clients * model_size, n_clients * model_size


def round_floats(mode: str, *, n_present: int, C: int = 0, d: int = 0,
                 m_up: int = 0, m_down: int = 0, model_size: int = 0,
                 n_commit=None, n_read=None):
    """Per-round (up, down) floats for any mode, billing only the clients
    that exchanged bytes this round: uplink at commit (`n_commit`), downlink
    at read (`n_read`); None means the synchronous fleet, where both equal
    `n_present`."""
    if n_commit is None:
        n_commit = n_present
    if n_read is None:
        n_read = n_present
    if mode == "fedavg":
        return fedavg_round_floats(model_size, n_present)
    if mode == "cors":
        up, _ = cors_round_floats(C, d, m_up, m_down, n_commit)
        _, down = cors_round_floats(C, d, m_up, m_down, n_read)
        return up, down
    if mode == "fd":
        up, _ = fd_round_floats(C, n_commit)
        _, down = fd_round_floats(C, n_read)
        return up, down
    return 0.0, 0.0
