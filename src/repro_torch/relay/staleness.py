"""Staleness-weighted relay, age-decayed sampling over the flat ring; the
port of `repro/relay/staleness.py`.

Each slot keeps its birth clock (`stamp`) and `merge_round` recomputes
age = clock - stamp for live slots. Teachers are drawn with probability
proportional to exp(-lam . age) over the eligible pool by a Gumbel top-k:
Gumbel noise plus the masked log-weights (-lam . age over the pool, -inf
outside), and the m_down highest scores; an exact draw without replacement,
with fixed shapes. lam = 0 is uniform over the pool without replacement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.relay import base, flat
from repro_torch.relay.base import EMPTY_OWNER
from repro_torch.types import CollabConfig


class StalenessRelayState(NamedTuple):
    """The flat ring (`relay/flat.py`) plus age (cap,) int32, equal to
    clock - stamp for live slots and 0 for empty ones."""
    obs: torch.Tensor
    valid: torch.Tensor
    owner: torch.Tensor
    age: torch.Tensor
    ptr: torch.Tensor
    global_protos: torch.Tensor
    valid_g: torch.Tensor
    mean_logits: torch.Tensor
    stamp: torch.Tensor
    clock: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]


def staleness_logweights(age, pool, lam: float):
    """Masked log-weights: -lam . age over the pool, -inf outside."""
    return torch.where(pool, -lam * age.to(torch.float32), float("-inf"))


def staleness_weights(age, pool, lam: float):
    """The sampling distribution over the slots: the softmax of the masked
    log-weights (sums to 1 when the pool is not empty, 0 outside it)."""
    return torch.softmax(staleness_logweights(age, pool, lam), -1)


@dataclass(frozen=True)
class StalenessRelay(base.RelayPolicy):
    lam: float = 0.5
    name: str = "staleness"

    def init_state(self, ccfg: CollabConfig, d_feature: int, seed: int = 0,
                   capacity: Optional[int] = None, n_clients: int = 2,
                   device=None) -> StalenessRelayState:
        """The flat ring's init and age 0 everywhere."""
        s = flat.init_relay_state(ccfg, d_feature, seed, capacity, n_clients,
                                  device)
        return StalenessRelayState(age=torch.zeros_like(s.owner),
                                   **s._asdict())

    def append(self, state: StalenessRelayState, obs_rows, valid_rows,
               owner_rows, row_mask=None,
               stamp_rows=None) -> StalenessRelayState:
        """The flat ring's append; written slots start at age clock - birth
        stamp (0 for rows born this round)."""
        k = obs_rows.shape[0]
        idx, _ = base.ring_indices(state.ptr, k, state.capacity, row_mask)
        stamps = base.stamps_or_now(state, k, stamp_rows)
        state = flat.buffer_append(state, obs_rows, valid_rows, owner_rows,
                                   row_mask, stamp_rows)
        return state._replace(age=base.scatter_drop(
            state.age, (idx.long(),), state.clock - stamps))

    def noise_shape(self, state, m_down):
        return (state.capacity,)

    def sample_teachers(self, state: StalenessRelayState, client_ids,
                        m_down: int, noise, picks) -> Dict:
        """Gumbel top-k of m_down slots, proportional to exp(-lam . age), for
        N clients at once, excluding each requester's own uploads (the flat
        policy's pool and fallbacks). noise (N, cap). When the pool (or the
        ring) holds fewer than m_down slots, the in-pool picks are recycled
        round-robin, never an out-of-pool slot: only the first min(pool,
        k) of the top k are read, so how ties among the -inf scores are
        ordered does not matter."""
        dev = state.obs.device
        ids = client_ids.to(device=dev, dtype=torch.int32)
        N = ids.shape[0]
        cap = state.capacity
        usable = state.owner != EMPTY_OWNER                            # (cap,)
        others = usable[None] & (state.owner[None] != ids[:, None])    # (N, cap)
        pool = torch.where(others.any(-1, keepdim=True), others, usable[None])
        any_pool = pool.any(-1)                                        # (N,)
        logw = staleness_logweights(state.age[None], pool, self.lam)
        kk = min(m_down, cap)
        idx_k = torch.topk(logw + noise.to(torch.float32), kk, -1).indices
        p = pool.to(torch.int32).sum(-1)                               # (N,)
        take = (torch.arange(m_down, device=dev)[None]
                % torch.clamp(torch.clamp(p, max=kk), min=1)[:, None])
        idx = torch.where(any_pool[:, None],
                          torch.take_along_dim(idx_k, take.long(), -1), 0)
        obs = torch.where(any_pool[:, None, None, None], state.obs[idx], 0.0)
        in_pool = torch.take_along_dim(pool, idx, -1)                  # (N, M)
        valid_o = any_pool[:, None] & (state.valid[idx]
                                       & in_pool[..., None]).all(1)
        C = state.valid_g.shape[0]
        return {"global_protos": state.global_protos.expand(N, -1, -1),
                "valid_g": state.valid_g.expand(N, C),
                "obs": obs, "valid_o": valid_o,
                "obs_pick": picks.to(device=dev, dtype=torch.long),
                "mean_logits": state.mean_logits.expand(N, -1, -1)}

    def merge_round(self, state, proto, logit=None):
        """Prototype merge and clock tick; the age of every live slot
        recomputed from its stamp."""
        state = base.merge_protos(state, proto, logit)
        live = state.owner != EMPTY_OWNER
        return state._replace(age=torch.where(
            live, (state.clock - state.stamp).to(torch.int32), state.age))

    def evict_owners(self, state, owners):
        return flat.evict_slots(state, owners)      # resets age too

    def debug_entries(self, state):
        owner, age = state.owner.tolist(), state.age.tolist()
        return [{"obs": state.obs[i], "valid": state.valid[i], "owner": o,
                 "age": age[i]}
                for i, o in enumerate(owner) if o != EMPTY_OWNER]
