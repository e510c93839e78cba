"""Stateful relay for the sequential `CollabTrainer`; the port of
`repro/relay/server.py` for the flat relay.

`RelayServer` binds the flat relay's pure functions to a live state and
exposes the upload / relay / merge cadence of paper Algorithm 1.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.core import prototypes
from repro_torch.relay import flat
from repro_torch.types import CollabConfig


class RelayServer:
    def __init__(self, ccfg: CollabConfig, d_feature: int, seed: int = 0,
                 capacity: Optional[int] = None, n_clients: int = 2,
                 device=None):
        self.state = flat.init_relay_state(ccfg, d_feature, seed, capacity,
                                           n_clients, device=device)
        self.round_states: List[prototypes.ProtoState] = []

    # -- uplink ------------------------------------------------------------
    def begin_round(self):
        self.round_states = []

    def upload(self, client_id: int, payload: Dict):
        """Append one client's upload, born at the current clock."""
        self.round_states.append(payload["proto"])
        obs = payload["obs"]                                  # (M_up, C, d')
        m = obs.shape[0]
        dev = obs.device
        self.state = flat.buffer_append(
            self.state, obs, payload["valid"].expand(m, -1),
            torch.full((m,), int(client_id), dtype=torch.int32, device=dev))

    def end_round(self):
        if not self.round_states:
            return
        self.state = flat.merge_round(self.state,
                                      prototypes.merge(*self.round_states))

    # -- downlink ----------------------------------------------------------
    def relay(self, client_id: int, m_down: int, noise=None,
              obs_pick: int = 0) -> Dict:
        """Sample a teacher for `client_id` from the live state."""
        return flat.sample_teacher(self.state, client_id, m_down, noise,
                                   obs_pick)

    @property
    def global_protos(self) -> torch.Tensor:
        return self.state.global_protos
