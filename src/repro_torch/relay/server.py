"""Stateful relay for the sequential `CollabTrainer`; the port of
`repro/relay/server.py`.

`RelayServer` binds a relay policy (`relay/base.py`) to a live state and
exposes the upload / relay / merge cadence of paper Algorithm 1. The
vectorized engine calls the policy's functions directly; both evolve the
same state because the call order (appends in upload order, then one merge)
is the same.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.core import prototypes
from repro_torch.relay import base, flat
from repro_torch.types import CollabConfig


class RelayServer:
    def __init__(self, ccfg: CollabConfig, d_feature: int, seed: int = 0,
                 capacity: Optional[int] = None, n_clients: int = 2,
                 device=None, policy: Optional[base.RelayPolicy] = None):
        self.policy = policy if policy is not None else flat.FlatRelay()
        self.state = self.policy.init_state(ccfg, d_feature, seed, capacity,
                                            n_clients, device=device)
        self.round_states: List[prototypes.ProtoState] = []
        self.round_logit_states: List[prototypes.ProtoState] = []

    # -- uplink ------------------------------------------------------------
    def begin_round(self):
        self.round_states = []
        self.round_logit_states = []

    def upload(self, client_id: int, payload: Dict):
        """Append one client's upload, born at the current clock; its
        per-class logit sums (fd mode) are kept for the merge."""
        self.round_states.append(payload["proto"])
        if "logit_proto" in payload:
            self.round_logit_states.append(payload["logit_proto"])
        obs = payload["obs"]                                  # (M_up, C, d')
        m = obs.shape[0]
        dev = obs.device
        self.state = self.policy.append(
            self.state, obs, payload["valid"].expand(m, -1),
            torch.full((m,), int(client_id), dtype=torch.int32, device=dev))

    def end_round(self):
        if not self.round_states:
            return
        logit = (prototypes.merge(*self.round_logit_states)
                 if self.round_logit_states else None)
        self.state = self.policy.merge_round(
            self.state, prototypes.merge(*self.round_states), logit)

    # -- downlink ----------------------------------------------------------
    def relay(self, client_id: int, m_down: int, noise,
              obs_pick: int = 0) -> Dict:
        """Sample a teacher for `client_id` from the live state; noise of
        the policy's `noise_shape(state, m_down)`."""
        return self.policy.sample_teacher(self.state, client_id, m_down,
                                          noise, obs_pick)

    # -- introspection -----------------------------------------------------
    @property
    def global_protos(self) -> torch.Tensor:
        return self.state.global_protos

    @property
    def mean_logits(self) -> torch.Tensor:
        return self.state.mean_logits
