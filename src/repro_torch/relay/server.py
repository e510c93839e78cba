"""Stateful relay for the sequential `CollabTrainer`; the port of
`repro/relay/server.py`.

`RelayServer` binds a relay policy (`relay/base.py`) to a live state and
exposes the upload / relay / merge cadence of paper Algorithm 1. It records
each round's upload owners, so that a policy with its own reduction
(`reduce_uploads`: the sharded relay's per-shard sums) can segment the
round's prototype and logit sums by owner. The vectorized engine calls the
policy's functions directly; both evolve the same state because the call
order (appends in upload order, then one merge) is the same.
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
        self.round_owners: List[int] = []

    # -- uplink ------------------------------------------------------------
    def begin_round(self):
        self.round_states = []
        self.round_logit_states = []
        self.round_owners = []

    def upload(self, client_id: int, payload: Dict, stamp=None):
        """Append one client's upload; its per-class logit sums (fd mode)
        are kept for the merge. `stamp` (int or None) is the upload's birth
        clock, the server clock when it was produced: None is born now (the
        synchronous case); the asynchronous event log passes the true birth
        clock, so a delayed commit arrives pre-aged."""
        self.round_states.append(payload["proto"])
        self.round_owners.append(int(client_id))
        if "logit_proto" in payload:
            self.round_logit_states.append(payload["logit_proto"])
        obs = payload["obs"]                                  # (M_up, C, d')
        m = obs.shape[0]
        dev = obs.device
        self.state = self.policy.append(
            self.state, obs, payload["valid"].expand(m, -1),
            torch.full((m,), int(client_id), dtype=torch.int32, device=dev),
            stamp_rows=(None if stamp is None else torch.full(
                (m,), int(stamp), dtype=torch.int32, device=dev)))

    def end_round(self):
        if not self.round_states:
            return
        if self.policy.reduce_uploads is None:
            merged = prototypes.merge(*self.round_states)
            logit = (prototypes.merge(*self.round_logit_states)
                     if self.round_logit_states else None)
        else:
            # the policy's own reduction (per-shard sums): the uploads'
            # contributions stacked, segmented by owner; every staged upload
            # commits, so the weights are 1
            dev = self.round_states[0].sum.device
            owners = torch.tensor(self.round_owners, dtype=torch.int32,
                                  device=dev)
            w = torch.ones(len(self.round_owners), device=dev)
            reduce = lambda states: self.policy.reduce_uploads(
                torch.stack([p.sum for p in states]),
                torch.stack([p.count for p in states]), w, owners)
            merged = reduce(self.round_states)
            logit = (reduce(self.round_logit_states)
                     if self.round_logit_states else None)
        self.state = self.policy.merge_round(self.state, merged, logit)

    # -- downlink ----------------------------------------------------------
    def relay(self, client_id: int, m_down: int, noise,
              obs_pick: int = 0, state=None) -> Dict:
        """Sample a teacher for `client_id` from the live state, or from
        `state`, a snapshot of it (the download-lag replay of
        `core/collab.py`); noise of the policy's `noise_shape(state,
        m_down)`, which a snapshot shares with the live state."""
        return self.policy.sample_teacher(
            self.state if state is None else state, client_id, m_down,
            noise, obs_pick)

    # -- introspection -----------------------------------------------------
    @property
    def global_protos(self) -> torch.Tensor:
        return self.state.global_protos

    @property
    def valid_g(self) -> torch.Tensor:
        return self.state.valid_g

    @property
    def mean_logits(self) -> torch.Tensor:
        return self.state.mean_logits

    @property
    def obs_buffer(self) -> List[Dict]:
        """The filled slots as a list of entry dicts, every one with an
        "owner" key (seeded and fallback entries included)."""
        return self.debug_entries()

    def debug_entries(self):
        """The live slots of the state as the policy's entry dicts."""
        return self.policy.debug_entries(self.state)
