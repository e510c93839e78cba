"""Flat ring relay, one global ring with uniform with-replacement sampling;
the port of `repro/relay/flat.py`.

A single (cap, C, d') observation ring with per-slot validity, owner and
birth stamp, sampled uniformly over other clients' slots. The state is a
NamedTuple of tensors on one device; every function returns a new state and
leaves its input untouched, as the reference's pure functions do.
`FlatRelay` binds them to the policy contract of `relay/base.py`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prototypes
from repro_torch.device import resolve_device
from repro_torch.relay import base
from repro_torch.relay.base import EMPTY_OWNER, SEED_OWNER, default_capacity
from repro_torch.types import CollabConfig


class RelayState(NamedTuple):
    """obs (cap, C, d') f32, valid (cap, C) bool, owner (cap,) int32,
    ptr () int32, global_protos (C, d') f32, valid_g (C,) bool,
    mean_logits (C, C) f32, stamp (cap,) int32 (birth clock of the slot),
    clock () int32 (merges performed)."""
    obs: torch.Tensor
    valid: torch.Tensor
    owner: torch.Tensor
    ptr: torch.Tensor
    global_protos: torch.Tensor
    valid_g: torch.Tensor
    mean_logits: torch.Tensor
    stamp: torch.Tensor
    clock: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]


def init_relay_state(ccfg: CollabConfig, d_feature: int, seed: int = 0,
                     capacity: Optional[int] = None, n_clients: int = 2,
                     device=None) -> RelayState:
    """Paper Algorithm 1: random initial prototypes and seed observations,
    drawn with numpy exactly as the reference does, so the initial ring is
    bit-equal to `repro.relay.flat.init_relay_state`'s."""
    device = resolve_device(device)
    C = ccfg.num_classes
    cap = default_capacity(ccfg, n_clients) if capacity is None else capacity
    if cap <= 0:
        raise ValueError("relay buffer capacity must be positive")
    n_seed = min(cap, max(1, ccfg.m_down))
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(C, d_feature)).astype(np.float32) * 0.01
    obs = np.zeros((cap, C, d_feature), np.float32)
    obs[:n_seed] = rng.normal(size=(n_seed, C, d_feature)).astype(np.float32) * 0.01
    valid = np.zeros((cap, C), bool)
    valid[:n_seed] = True
    owner = np.full((cap,), EMPTY_OWNER, np.int32)
    owner[:n_seed] = SEED_OWNER
    t = lambda a: torch.from_numpy(a).to(device)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return RelayState(obs=t(obs), valid=t(valid), owner=t(owner),
                      ptr=i32(n_seed % cap), global_protos=t(protos),
                      valid_g=torch.ones(C, dtype=torch.bool, device=device),
                      mean_logits=torch.zeros(C, C, device=device),
                      stamp=torch.zeros(cap, dtype=torch.int32, device=device),
                      clock=i32(0))


def buffer_append(state: RelayState, obs_rows, valid_rows, owner_rows,
                  row_mask=None, stamp_rows=None) -> RelayState:
    """Write k observation rows into the ring (oldest-first overwrite).

    obs_rows (k, C, d'), valid_rows (k, C), owner_rows (k,) int,
    row_mask (k,) bool or None: rows with row_mask False are dropped without
    consuming a ring slot. stamp_rows (k,) int or None (= born now). At most
    `capacity` rows may be masked in.

    Fixed shapes throughout, so the write never waits on the card: the
    dropped rows (index `capacity`) land in a scratch slot past the ring's
    end (`base.scatter_drop`)."""
    k = obs_rows.shape[0]
    cap = state.capacity
    idx, new_ptr = base.ring_indices(state.ptr, k, cap, row_mask)
    stamps = base.stamps_or_now(state, k, stamp_rows)
    idx = (idx.long(),)
    put = lambda buf, rows: base.scatter_drop(buf, idx, rows)
    return state._replace(obs=put(state.obs, obs_rows.float()),
                          valid=put(state.valid, valid_rows),
                          owner=put(state.owner, owner_rows),
                          stamp=put(state.stamp, stamps), ptr=new_ptr)


def merge_round(state: RelayState, proto: prototypes.ProtoState,
                logit: Optional[prototypes.ProtoState] = None) -> RelayState:
    """Inter-client aggregation (Alg. 1): recompute t-bar^c (and, in fd
    mode, the mean logits) from the merged per-class sums and tick the
    clock."""
    return base.merge_protos(state, proto, logit)


def evict_slots(state, owners):
    """Invalidates the live slots of the evicted `owners` in a flat-ring
    state (flat and staleness): owner EMPTY_OWNER, valid False, stamp 0,
    and age 0 where the state has one. ptr and clock are untouched."""
    hit = base.owner_hits(state.owner, owners)                    # (cap,)
    zero = torch.zeros_like(state.stamp)
    state = state._replace(
        owner=torch.where(hit, EMPTY_OWNER, state.owner),
        valid=state.valid & ~hit[:, None],
        stamp=torch.where(hit, zero, state.stamp))
    if hasattr(state, "age"):
        state = state._replace(age=torch.where(hit, zero, state.age))
    return state


def sample_teachers(state: RelayState, client_ids, m_down: int, noise,
                    obs_picks) -> Dict:
    """Observations of OTHER users, chosen at random (paper section 4), for
    N clients at once: the counterpart of `jax.vmap` over the reference's
    `sample_teacher`, with no host read.

    Uniform with-replacement sampling over the ring slots not owned by each
    client, as argmax(where(pool, 0, -inf) + noise) with Gumbel noise
    (N, m_down, cap): the form `jax.random.categorical` takes, so the
    reference's own noise reproduces its indices. A client falls back to the
    whole filled buffer when every slot is its own, and to a zero, invalid
    teacher when the buffer is empty. client_ids (N,) int; obs_picks (N,)
    int: which of the m_down observations each client's loss uses.

    Returns a teacher dict whose every entry has the leading client axis."""
    dev = state.obs.device
    ids = client_ids.to(torch.int32)
    N = ids.shape[0]
    usable = state.owner != EMPTY_OWNER                               # (cap,)
    others = usable & (state.owner[None, :] != ids[:, None])          # (N, cap)
    pool = torch.where(others.any(-1, keepdim=True), others, usable)
    any_pool = pool.any(-1)                                           # (N,)
    scores = noise.to(torch.float32).masked_fill(~pool[:, None, :], float("-inf"))
    idx = torch.where(any_pool[:, None], scores.argmax(-1), 0)        # (N, M)
    obs = torch.where(any_pool[:, None, None, None], state.obs[idx], 0.0)
    valid_o = any_pool[:, None] & state.valid[idx].all(1)             # (N, C)
    C = state.valid_g.shape[0]
    return {"global_protos": state.global_protos.expand(N, -1, -1),
            "valid_g": state.valid_g.expand(N, C),
            "obs": obs, "valid_o": valid_o,
            "obs_pick": obs_picks.to(device=dev, dtype=torch.long),
            "mean_logits": state.mean_logits.expand(N, -1, -1)}


def sample_teacher(state: RelayState, client_id: int, m_down: int,
                   noise=None, obs_pick: int = 0) -> Dict:
    """One client's teacher (see `sample_teachers`): noise (m_down, cap), or
    drawn here; `obs_pick` an int."""
    if noise is None:
        noise = base.gumbel((m_down, state.capacity))
    return FlatRelay().sample_teacher(state, client_id, m_down, noise,
                                      obs_pick)


@dataclass(frozen=True)
class FlatRelay(base.RelayPolicy):
    """The policy over this module's functions."""
    name: str = "flat"

    def init_state(self, ccfg, d_feature, seed=0, capacity=None,
                   n_clients=2, device=None):
        return init_relay_state(ccfg, d_feature, seed, capacity, n_clients,
                                device)

    def append(self, state, obs_rows, valid_rows, owner_rows, row_mask=None,
               stamp_rows=None):
        return buffer_append(state, obs_rows, valid_rows, owner_rows,
                             row_mask, stamp_rows)

    def noise_shape(self, state, m_down):
        return (m_down, state.capacity)

    def sample_teachers(self, state, client_ids, m_down, noise, picks):
        return sample_teachers(state, client_ids, m_down, noise, picks)

    def merge_round(self, state, proto, logit=None):
        return merge_round(state, proto, logit)

    def evict_owners(self, state, owners):
        return evict_slots(state, owners)

    def debug_entries(self, state):
        owner = state.owner.tolist()
        return [{"obs": state.obs[i], "valid": state.valid[i], "owner": o}
                for i, o in enumerate(owner) if o != EMPTY_OWNER]
